"""Structured spans: a bounded ring buffer of wall-time events with Chrome
``trace_event`` export (loadable in Perfetto / chrome://tracing).

A span is one timed region of host-side work — an eager collective
dispatch, an engine step, a PS RPC. Recording is designed for the hot
path: one ``perf_counter`` pair, one tuple append into a ``deque(maxlen)``
under a lock, no I/O until :meth:`SpanRecorder.export`. Each span also
enters a ``torch.profiler.record_function`` of its name, so the same
names appear in a ``torch.profiler`` trace of the process (the JAX
package's ``jax.profiler.TraceAnnotation``). The environment switch keeps
its JAX name, ``TORCHMPI_TPU_TELEMETRY_XLA`` (0 turns the annotation off).

The disabled path never reaches this module: ``telemetry.span`` returns a
shared no-op singleton (:data:`NOOP_SPAN`), so a disabled call site costs
one branch and zero allocation.
"""

from __future__ import annotations

import os
import threading
from ..analysis import lockmon as _lockmon
import time
from collections import deque
from typing import Optional

# torch.profiler.record_function, resolved lazily at the first span, so
# importing this module imports no torch
_TRACE_ANNOTATION = None
_TRACE_ANNOTATION_RESOLVED = False


def _trace_annotation_cls():
    global _TRACE_ANNOTATION, _TRACE_ANNOTATION_RESOLVED
    if not _TRACE_ANNOTATION_RESOLVED:
        _TRACE_ANNOTATION_RESOLVED = True
        if os.environ.get(
            "TORCHMPI_TPU_TELEMETRY_XLA", "1"
        ).lower() in ("1", "true", "yes", "on"):
            try:
                import torch.profiler

                _TRACE_ANNOTATION = torch.profiler.record_function
            except Exception:  # noqa: BLE001 - no profiler: skip
                _TRACE_ANNOTATION = None
    return _TRACE_ANNOTATION


class SpanRecorder:
    """Bounded ring buffer of completed spans (oldest evicted first)."""

    def __init__(self, capacity: int = 4096):
        self._lock = _lockmon.make_lock("spans.py:SpanRecorder._lock")
        self._buf: deque = deque(maxlen=int(capacity))
        self.total_recorded = 0
        # spans evicted by ring wrap-around: > 0 means the exported trace
        # is TRUNCATED (detectable instead of silent — snapshot()["spans"]
        # ["dropped"] and the trace's "spanDropped" field both carry it)
        self.dropped = 0

    @property
    def capacity(self) -> int:
        return self._buf.maxlen or 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def record(self, name: str, ts_us: float, dur_us: float,
               attrs: Optional[dict] = None) -> None:
        tid = threading.get_ident() & 0xFFFFFFFF
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append((name, ts_us, dur_us, tid, attrs))
            self.total_recorded += 1

    def reset(self) -> None:
        with self._lock:
            self._buf.clear()
            self.total_recorded = 0
            self.dropped = 0

    def trace_events(self) -> list:
        """Chrome ``trace_event`` list: one complete ('X') event per span
        (``ph``/``ts``/``dur``/``name``/``pid``/``tid`` + ``args``), plus a
        process-name metadata event so Perfetto labels the track."""
        pid = os.getpid()
        with self._lock:
            spans = list(self._buf)
        events = [
            {
                "ph": "M",
                "ts": 0,
                "name": "process_name",
                "pid": pid,
                "tid": 0,
                "args": {"name": f"torchmpi_tpu pid {pid}"},
            }
        ]
        for name, ts_us, dur_us, tid, attrs in spans:
            ev = {
                "ph": "X",
                "name": name,
                "cat": "torchmpi_tpu",
                "ts": round(ts_us, 3),
                "dur": round(dur_us, 3),
                "pid": pid,
                "tid": tid,
            }
            if attrs:
                ev["args"] = {k: _jsonable(v) for k, v in attrs.items()}
            events.append(ev)
        return events

    def export(self, path) -> None:
        """Write ``{"traceEvents": [...]}`` JSON — the object form of the
        Chrome trace format, loadable in Perfetto / chrome://tracing."""
        import json

        with open(path, "w") as f:
            json.dump(
                {"traceEvents": self.trace_events(),
                 "displayTimeUnit": "ms",
                 # extra top-level keys are legal in the Chrome trace
                 # object form; > 0 flags a truncated (ring-wrapped) trace
                 "spanDropped": self.dropped},
                f,
            )


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


class Span:
    """Context manager timing one region into ``recorder``; enters a
    ``torch.profiler.record_function`` of the same name (so spans also
    land on ``torch.profiler`` timelines)."""

    __slots__ = ("_recorder", "name", "attrs", "_t0", "_ann")

    def __init__(self, recorder: SpanRecorder, name: str,
                 attrs: Optional[dict] = None):
        self._recorder = recorder
        self.name = name
        self.attrs = attrs
        self._ann = None

    def __enter__(self):
        cls = _trace_annotation_cls()
        if cls is not None:
            try:
                self._ann = cls(self.name)
                self._ann.__enter__()
            except Exception:  # noqa: BLE001 - annotation is best-effort
                self._ann = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        if self._ann is not None:
            try:
                self._ann.__exit__(exc_type, exc, tb)
            except Exception:  # noqa: BLE001
                pass
        self._recorder.record(
            self.name, self._t0 * 1e6, (t1 - self._t0) * 1e6, self.attrs
        )
        return False


class _NoopSpan:
    """Shared do-nothing span: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NOOP_SPAN = _NoopSpan()
