"""Tracing, profiling and logging utilities.

The port of ``torchmpi_tpu/utils/tracing.py``. Reference analogs
(SURVEY.md §5):

- the nvprof window between fixed steps (``sgdengine.lua:38-63``,
  ``wrap.sh`` NVPROF=1) -> :class:`ProfilerWindow` around a
  ``torch.profiler`` trace (the engine wires it through ``profile_dir`` /
  ``profile_window``);
- the ``VLOG_1``/``VLOG_2`` debug macros with thread ids
  (``resources.h:43-53``) -> :func:`vlog`, gated by the
  ``TORCHMPI_TPU_DEBUG`` environment variable (0/1/2);
- per-rank log redirection ``LOG_TO_FILE=1`` (``wrap.sh:70-77``) ->
  :func:`redirect_logs_per_process`;
- ``torch.Timer`` benchmark timing (``tester.lua``) -> :class:`Timer`;
- logical-vs-on-wire byte accounting for the compressed wires ->
  :class:`WireByteCounters` and its process-global :data:`wire_stats`,
  which every plan of a ring or kernel transport records into
  (``collectives.eager._wire_recorder``) and every telemetry snapshot
  carries (the ``wire_stats`` collector).
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ..analysis import lockmon as _lockmon

_DEBUG_LEVEL = int(os.environ.get("TORCHMPI_TPU_DEBUG", "0") or 0)


def debug_level() -> int:
    return _DEBUG_LEVEL


def set_debug_level(level: int) -> None:
    global _DEBUG_LEVEL
    _DEBUG_LEVEL = int(level)


def vlog(level: int, msg: str) -> None:
    """VLOG-style leveled debug logging with thread id (resources.h:43-53)."""
    if _DEBUG_LEVEL >= level:
        tid = threading.get_ident() & 0xFFFF
        print(f"[tm:{level}][t{tid:04x}] {msg}", file=sys.stderr, flush=True)


class Timer:
    """torch.Timer-alike: lap timing for benchmark loops."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()

    def time(self) -> float:
        return time.perf_counter() - self._t0


class ProfilerWindow:
    """A ``torch.profiler`` trace of steps [begin, end), the engine's
    nvprof-window analog, usable standalone:

        win = ProfilerWindow('/tmp/trace', 3, 8, device=comm.device)
        try:
            for step in ...:
                win.step(step)   # starts/stops the trace at the boundaries
        finally:
            win.close()          # loops shorter than the window, and
                                 # exception exits, must still stop it

    It records host activity, and the card's kernels when ``device`` is a
    CUDA device. When the trace stops it is written to ``log_dir`` as a
    Chrome trace (``trace_path``), loadable in Perfetto."""

    def __init__(self, log_dir: str, begin: int = 3, end: int = 8, device=None):
        begin, end = int(begin), int(end)
        if begin < 0 or end <= begin:
            # a [begin, end) window with end <= begin would start a trace
            # it stops one step late (or never, if the loop ends first)
            raise ValueError(
                f"profiler window must satisfy 0 <= begin < end, got "
                f"[{begin}, {end})"
            )
        self.log_dir = log_dir
        self.begin = begin
        self.end = end
        self.device = None if device is None else torch.device(device)
        self.trace_path: Optional[Path] = None
        self._prof = None

    @property
    def active(self) -> bool:
        """Whether a trace is open (callers should synchronise the device
        before the stopping ``step``/``close`` so the traced kernels'
        tails land in the trace)."""
        return self._prof is not None

    def step(self, step: int) -> None:
        if step == self.begin and self._prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device is not None and self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
        elif step >= self.end and self._prof is not None:
            self._stop()

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        out = Path(self.log_dir)
        out.mkdir(parents=True, exist_ok=True)
        self.trace_path = out / f"trace_{os.getpid()}_steps{self.begin}-{self.end}.json"
        prof.export_chrome_trace(str(self.trace_path))

    def close(self) -> None:
        if self._prof is not None:
            self._stop()


def redirect_logs_per_process(directory: str = "/tmp", prefix: str = "tm_") -> Path:
    """Redirect this process's stdout/stderr to ``<dir>/<prefix><rank>``
    (wrap.sh LOG_TO_FILE analog), ``rank`` the process's index in the job
    (0 in one process). Returns the log path."""
    from .. import runtime_state

    plane = runtime_state.plane()
    path = Path(directory) / f"{prefix}{plane.index if plane is not None else 0}"
    f = open(path, "a", buffering=1)
    os.dup2(f.fileno(), sys.stdout.fileno())
    os.dup2(f.fileno(), sys.stderr.fileno())
    return path


@contextlib.contextmanager
def annotate(name: str):
    """Named trace annotation (a ``torch.profiler.record_function`` range,
    shown in the profiler timeline)."""
    with torch.profiler.record_function(name):
        yield


class WireByteCounters:
    """Logical-vs-on-wire byte accounting for the bandwidth-path
    collectives: per-rank payload bytes (``logical``) against the bytes
    the wire encoding puts on each hop (``wire``: int8 values padded to
    whole blocks plus one f32 scale a block; bf16 half; full the same).
    ``compression_ratio()`` is logical over wire. Thread-safe; counts
    accumulate until :meth:`reset`. An accounting model computed from the
    static encoding, not a packet capture."""

    def __init__(self):
        self._lock = _lockmon.make_lock("tracing.py:WireByteCounters._lock")
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.calls = 0
            self.logical_bytes = 0
            self.wire_bytes = 0
            # (op, wire_format) -> [calls, logical, wire]
            self.by_format: Dict[Tuple[str, str], list] = {}

    def record(self, op: str, wire_format: str, logical: int, wire: int) -> None:
        with self._lock:
            self.calls += 1
            self.logical_bytes += int(logical)
            self.wire_bytes += int(wire)
            ent = self.by_format.setdefault((op, wire_format), [0, 0, 0])
            ent[0] += 1
            ent[1] += int(logical)
            ent[2] += int(wire)

    def compression_ratio(self) -> float:
        """logical/wire over everything recorded (1.0 when nothing is)."""
        with self._lock:
            if not self.wire_bytes:
                return 1.0
            return self.logical_bytes / self.wire_bytes

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "calls": self.calls,
                "logical_bytes": self.logical_bytes,
                "wire_bytes": self.wire_bytes,
                "compression_ratio": (
                    self.logical_bytes / self.wire_bytes if self.wire_bytes else 1.0
                ),
                "by_format": {
                    f"{op}:{fmt}": tuple(v) for (op, fmt), v in self.by_format.items()
                },
            }


#: process-global wire-format byte counters (see :class:`WireByteCounters`)
wire_stats = WireByteCounters()
