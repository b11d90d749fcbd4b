"""Unified telemetry: metrics registry, collective spans, trace export.

The port of ``torchmpi_tpu/telemetry``:

1. **Metrics** (:data:`metrics`): thread-safe labelled counters / gauges /
   fixed-bucket histograms, exported as a JSON snapshot and as Prometheus
   text (:func:`prometheus_text`). ``utils.tracing.wire_stats`` (the
   logical-vs-wire byte accounting of the compressed wires, recorded by
   every plan of a ring or kernel transport) is registered as a snapshot
   collector, so every dump carries it.
2. **Spans** (:func:`span`): a low-overhead timed-region context manager
   recording into a bounded ring buffer, exported as Chrome
   ``trace_event`` JSON loadable in Perfetto / chrome://tracing
   (:func:`export_trace`), with ``torch.profiler.record_function``
   pass-through so the same names appear in ``torch.profiler`` traces.
3. **Flight recorder** (:mod:`.flightrecorder`): the per-communicator
   journal of collectives, each stamped with its schedule plan's
   ``plan_id``.
4. **Audit log** (:func:`audit`): a small bounded journal of discrete
   decisions (autotuner knob choices, tuning-cache loads) included in
   every snapshot.

Beside the core: the hang watchdog (:mod:`.watchdog`) and the live
telemetry plane (:mod:`.live`), armed from the environment at the end of
this module; the offline analyzer (:mod:`.analyze`, ``python -m
torchmpi_tpu_torch.telemetry.analyze DIR``), the causal critical path and
overlap ledger (:mod:`.criticalpath`), the measured cost-model
calibration (:mod:`.calibrate`) and the live console (:mod:`.top`).

Gating: telemetry is OFF unless ``TORCHMPI_TPU_TELEMETRY`` is truthy or
:func:`enable` is called. Instrumented hot paths pay exactly one branch
when disabled, and ``span()`` returns a shared no-op singleton — no
allocation per disabled call. Setting ``TORCHMPI_TPU_TELEMETRY_DUMP`` to a
path enables telemetry AND registers an atexit dump there.

This package imports only the standard library (the ``wire_stats``
collector imports ``utils.tracing`` when a snapshot is taken).
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from ..analysis import lockmon as _lockmon
from collections import deque
from pathlib import Path
from typing import List, Optional

from .registry import (  # noqa: F401 - re-exported
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from .spans import NOOP_SPAN, Span, SpanRecorder
from . import flightrecorder
from .flightrecorder import FlightRecorder  # noqa: F401 - re-exported


def _env_true(name: str, default: str = "") -> bool:
    return os.environ.get(name, default).lower() in ("1", "true", "yes", "on")


_enabled = _env_true("TORCHMPI_TPU_TELEMETRY")

#: process-global metrics registry
metrics = MetricsRegistry()

#: process-global span ring buffer
spans = SpanRecorder(
    capacity=int(os.environ.get("TORCHMPI_TPU_TELEMETRY_SPANS", "4096") or 4096)
)

# decision audit journal (autotuner choices etc.) — tiny and always on:
# decisions are rare and must be reconstructable even when the metric hot
# paths were disabled at the time
_audit_lock = _lockmon.make_lock("telemetry:_audit_lock")
_audit: deque = deque(maxlen=256)


def enabled() -> bool:
    """Whether the instrumented hot paths record. One branch per call
    site; the env var ``TORCHMPI_TPU_TELEMETRY`` sets the initial state."""
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True
    flightrecorder._sync_telemetry(True)


def disable() -> None:
    global _enabled
    _enabled = False
    flightrecorder._sync_telemetry(False)


def span(name: str, **attrs):
    """Timed-region context manager. Disabled -> a shared no-op object
    (zero allocation); enabled -> records wall time + ``attrs`` into the
    ring buffer and passes through as a ``torch.profiler.record_function``.

    Hot paths that build attrs dicts should guard the whole call with
    ``if telemetry.enabled():`` so the disabled path stays one branch.
    """
    if not _enabled:
        return NOOP_SPAN
    return Span(spans, name, attrs or None)


# --- clock-sync record (written by runtime_state.start()) -------------------
# One (wall_time, perf_counter, monotonic) triple captured at the same
# instant. Span timestamps are perf_counter-based and rank-local; this
# record is the per-rank offset handshake the offline analyzer uses to put
# every rank's events on one wall-clock axis (telemetry/analyze.py).
_clock_sync: Optional[dict] = None


def record_clock_sync(**fields) -> None:
    """Capture the wall/perf/monotonic clock triple (plus caller-provided
    identity fields like rank/host); included in every snapshot."""
    global _clock_sync
    _clock_sync = {
        "wall_time": time.time(),
        "perf_counter": time.perf_counter(),
        "monotonic": time.monotonic(),
    }
    _clock_sync.update(fields)


def clock_sync() -> Optional[dict]:
    return _clock_sync


def refresh_clock_sync() -> Optional[dict]:
    """Re-capture the clock triple, preserving the identity fields of the
    original record. A single start()-time sample lets wall-vs-perf drift
    (NTP steps, thermal clock skew) accumulate for the whole run and bend
    the analyzer's cross-rank alignment; the live exporter calls this on
    every heartbeat frame so the merger always aligns with the freshest
    triple. No-op (returns None) before the first record_clock_sync."""
    global _clock_sync
    if _clock_sync is None:
        return None
    identity = {
        k: v for k, v in _clock_sync.items()
        if k not in ("wall_time", "perf_counter", "monotonic")
    }
    _clock_sync = {
        "wall_time": time.time(),
        "perf_counter": time.perf_counter(),
        "monotonic": time.monotonic(),
    }
    _clock_sync.update(identity)
    return _clock_sync


def audit(event: str, **fields) -> None:
    """Append one decision record to the bounded audit journal."""
    rec = {"event": event, "time": time.time()}
    rec.update(fields)
    with _audit_lock:
        _audit.append(rec)


def audit_log() -> List[dict]:
    with _audit_lock:
        return list(_audit)


def snapshot() -> dict:
    """One JSON-serializable view of everything: metrics (+ collector
    producers like ``wire_stats``), the audit journal, span-buffer
    occupancy (``dropped`` > 0 = truncated trace), the flight recorder,
    and the clock-sync record the cross-rank analyzer aligns with."""
    return {
        "enabled": _enabled,
        "pid": os.getpid(),
        "time": time.time(),
        "clock_sync": _clock_sync,
        "metrics": metrics.snapshot(),
        "audit": audit_log(),
        "spans": {
            "buffered": len(spans),
            "recorded": spans.total_recorded,
            "capacity": spans.capacity,
            "dropped": spans.dropped,
        },
        "flight_recorder": flightrecorder.recorder.snapshot(),
    }


def prometheus_text() -> str:
    """Prometheus text exposition of the typed metrics."""
    return metrics.prometheus()


def trace_events() -> list:
    """The span buffer as a Chrome ``trace_event`` list."""
    return spans.trace_events()


def export_trace(path) -> Path:
    """Write the span buffer as Perfetto-loadable trace JSON."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    spans.export(path)
    return path


def trace_path_for(path) -> Path:
    """The trace file that rides along with a snapshot at ``path``:
    ``foo.json`` -> ``foo.trace.json``."""
    path = Path(path)
    suffix = path.suffix or ".json"
    return path.with_name(f"{path.stem}.trace{suffix}")


def dump(path) -> List[Path]:
    """Write the metrics snapshot JSON to ``path`` and the span trace to
    :func:`trace_path_for` ``(path)``; returns both paths. Safe to call
    with telemetry disabled (dumps whatever was recorded)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
    tmp.write_text(json.dumps(snapshot(), indent=2, default=str))
    os.replace(tmp, path)
    trace = export_trace(trace_path_for(path))
    return [path, trace]


def reset() -> None:
    """Clear recorded series, spans, flight-recorder entries, and audit
    entries (metric objects and collectors stay registered)."""
    metrics.reset()
    spans.reset()
    flightrecorder.recorder.reset()
    with _audit_lock:
        _audit.clear()


# ---------------------------------------------------------------------------
# wire_stats producer: the logical-vs-wire byte counters ride along in
# every snapshot. Lazy import: tracing imports torch, which this package
# does not need until a snapshot is taken inside a framework process.
# ---------------------------------------------------------------------------


def _wire_stats_collector() -> dict:
    from ..utils import tracing

    return tracing.wire_stats.snapshot()


metrics.register_collector("wire_stats", _wire_stats_collector)


# the flight recorder mirrors the master switch (one module-global read on
# its hot path instead of a cross-module call)
flightrecorder._sync_telemetry(_enabled)


# ---------------------------------------------------------------------------
# per-rank dump on exit (the launcher's --telemetry-dir sets the env var) —
# including ABNORMAL exit: a SIGTERM'd (launcher teardown) or crashed rank
# must still leave its flight-recorder/span dump behind, because the hung
# or killed rank is exactly the one whose evidence matters.
# ---------------------------------------------------------------------------


def fault_path_for(path) -> Path:
    """The faulthandler sidecar for a snapshot at ``path``:
    ``foo.json`` -> ``foo.fault.txt``."""
    path = Path(path)
    return path.with_name(f"{path.stem}.fault.txt")


def _install_abnormal_exit_handlers(path: str) -> None:
    import faulthandler
    import signal

    # hard faults (SIGSEGV/SIGFPE/SIGABRT/SIGBUS): all-thread C-level
    # stacks into a sidecar file — the JSON dump can't run from a
    # corrupted interpreter, a raw fd write can
    try:
        fault_file = open(fault_path_for(path), "w")  # noqa: SIM115 - must
        # outlive this function (faulthandler holds the fd)
        faulthandler.enable(file=fault_file, all_threads=True)
    except OSError:
        pass

    def _dump_and_reraise(signum, frame):
        try:
            dump(path)
        except Exception:  # noqa: BLE001 - dying anyway; dump best-effort
            pass
        if signum == signal.SIGINT:
            # preserve Ctrl-C semantics: the dump is banked, then the
            # interrupt proceeds as KeyboardInterrupt so user cleanup /
            # checkpoint-on-interrupt code still runs
            signal.signal(signum, signal.default_int_handler)
            raise KeyboardInterrupt
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)  # preserve the 128+signum exit code

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            existing = signal.getsignal(sig)
            # never displace a user-installed handler; the interpreter
            # defaults (SIG_DFL / KeyboardInterrupt) are what we upgrade
            if existing in (signal.SIG_DFL, signal.default_int_handler):
                signal.signal(sig, _dump_and_reraise)
        except (ValueError, OSError):
            pass  # non-main thread / unsupported platform: atexit remains


_DUMP_PATH = os.environ.get("TORCHMPI_TPU_TELEMETRY_DUMP", "")
if _DUMP_PATH:
    _enabled = True
    flightrecorder._sync_telemetry(True)

    def _dump_at_exit(path: str = _DUMP_PATH) -> None:
        try:
            dump(path)
        except Exception:  # noqa: BLE001 - never break interpreter exit
            pass

    atexit.register(_dump_at_exit)
    _install_abnormal_exit_handlers(_DUMP_PATH)


# hang watchdog: TORCHMPI_TPU_WATCHDOG=<seconds> arms it as soon as
# telemetry loads, so even a hang during start() is caught (start() also
# arms it when the watchdog_timeout_seconds constant is set)
from . import watchdog  # noqa: E402 - needs the module fully initialized

watchdog._maybe_start_from_env()

# live telemetry plane: TORCHMPI_TPU_TELEMETRY_LIVE=host:port (standalone
# socket exporter) or TORCHMPI_TPU_TELEMETRY_LIVE_VIA=heartbeat (frames
# piggyback on an elastic member's coordinator heartbeat); armed at import
# like the watchdog so streaming starts before start()
from . import live  # noqa: E402 - needs the module fully initialized

live._maybe_start_from_env()
