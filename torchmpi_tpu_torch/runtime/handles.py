"""Synchronization handles for async collectives and offloaded host work.

The port of ``torchmpi_tpu/runtime/handles.py`` (the reference's
``SynchronizationHandle``, ``lib/resources.h:230-253``,
``lib/resources.cpp:1173-1242``), a tagged union of two variants:

- a result and a CUDA event: an async collective on a CUDA communicator
  runs on a side stream, and :meth:`SyncHandle.wait` makes the caller's
  current stream wait on the event recorded after it, so the host does
  not block (unless the flight recorder is on: see
  :meth:`SyncHandle.wait`). On the CPU every collective has finished when it returns, and
  the handle holds the result alone.
- a ``concurrent.futures.Future`` from the offload pools (the
  parameter-server clients): :meth:`SyncHandle.wait` blocks on the
  future. When its result is a :class:`StreamResult` (work enqueued on
  another thread's stream), the caller's current stream then waits on
  that result's event too, and ``wait`` returns the value.

Handles are registered in a table, so ``sync_all()`` (and ``stop()``)
drains every outstanding one (``resources.cpp:463-481``) and
``num_async_collectives_in_flight`` bounds how many are unwaited.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..telemetry import flightrecorder as _flight


class StreamResult(NamedTuple):
    """A value produced on some CUDA stream, and the event recorded on that
    stream after it (``None`` on the CPU)."""

    value: Any
    event: Optional[torch.cuda.Event]


def _order_after(value: Any, event: Optional[torch.cuda.Event]) -> None:
    """Make the caller's current stream wait on ``event``; a tensor
    ``value`` was allocated on the other stream, so its memory must not be
    handed out again until this stream is done with it."""
    if event is None:
        return
    if isinstance(value, torch.Tensor):
        stream = torch.cuda.current_stream(value.device)
        stream.wait_event(event)
        value.record_stream(stream)
    else:
        torch.cuda.current_stream().wait_event(event)


class SyncHandle:
    """The result of async work, ready once :meth:`wait` returns: either
    ``result`` (with the CUDA ``event`` of its side stream) or a
    ``future``, exactly one of the two."""

    __slots__ = ("_result", "_event", "_future", "_done", "_table_index", "_kind")

    def __init__(self, result: Any = None, event: Optional[torch.cuda.Event] = None,
                 *, future: Optional[Future] = None):
        if future is not None and (result is not None or event is not None):
            raise ValueError("SyncHandle holds a result and event, or a future, not both")
        self._result = result
        self._event = event
        self._future = future
        self._done = False
        self._table_index: Optional[int] = None
        self._kind = ""

    def wait(self) -> Any:
        """The result, ordered before the caller's later work on its
        current stream. A future's exception is raised here. Idempotent: a
        second wait returns the same result, as the reference's freed slot
        makes later waits no-ops (``resources.cpp:1226-1242``).

        While the flight recorder is on, the wait records its own
        ``wait.<kind>`` entry (``handles.py:72``: kind ``arrays`` for a
        result, ``future`` for a future) around a host block on the
        device's completion of the work (``event.synchronize()``), as
        the JAX wait blocks: a wedged collective then leaves the entry at
        ``issued``, which the hang watchdog flags. With the recorder off
        the wait does not block the host."""
        if not self._done:
            entry = None
            if _flight.enabled():
                kind = "future" if self._future is not None else "arrays"
                entry = _flight.recorder.record("handles", f"wait.{kind}", backend=kind)
            try:
                if self._future is not None:
                    result = self._future.result()
                    if isinstance(result, StreamResult):
                        if entry is not None and result.event is not None:
                            result.event.synchronize()
                        _order_after(*result)
                        result = result.value
                    self._result = result
                else:
                    if entry is not None and self._event is not None:
                        self._event.synchronize()
                    _order_after(self._result, self._event)
            except BaseException:
                if entry is not None:
                    _flight.FlightRecorder.fail(entry)
                raise
            if entry is not None:
                _flight.FlightRecorder.complete(entry)
            self._done = True
            if self._table_index is not None:
                handles._discard(self._table_index)
                self._table_index = None
        return self._result

    @property
    def done(self) -> bool:
        """True once waited, or once the work has finished (the future has
        a result, or the device has passed the event)."""
        if self._done:
            return True
        if self._future is not None:
            return self._future.done()
        return self._event is None or self._event.query()

    def __repr__(self) -> str:
        kind = ("future" if self._future is not None
                else "cuda" if self._event is not None else "done")
        return f"SyncHandle<{kind}{', waited' if self._done else ''}>"


class _HandleTable:
    """Index-addressed handle registry (reference ``resources.cpp:545-578``
    and the future queues at ``:399-461``). A count of the outstanding
    handles of each kind is kept beside the table, so the backpressure
    check of an async issue reads one number instead of scanning it."""

    def __init__(self):
        self._lock = threading.Lock()
        # insertion-ordered: the first handle of a kind is its oldest
        self._handles: Dict[int, SyncHandle] = {}
        self._counts: Dict[str, int] = {}
        self._next = 0

    def register(self, handle: SyncHandle, kind: str = "") -> int:
        with self._lock:
            idx = self._next
            self._next = idx + 1
            self._handles[idx] = handle
            handle._table_index = idx
            handle._kind = kind
            self._counts[kind] = self._counts.get(kind, 0) + 1
            return idx

    def _pop(self, idx: int) -> Optional[SyncHandle]:
        # the caller holds the lock
        handle = self._handles.pop(idx, None)
        if handle is not None:
            self._counts[handle._kind] -= 1
        return handle

    def outstanding_kind(self, kind: str) -> int:
        """Unwaited handles registered under ``kind`` (the backpressure
        count for ``num_async_*_in_flight``)."""
        return self._counts.get(kind, 0)

    def wait_oldest(self, kind: str) -> bool:
        """Wait the oldest outstanding handle of ``kind``; False if none."""
        with self._lock:
            idx = next((i for i, h in self._handles.items() if h._kind == kind), None)
            if idx is None:
                return False
            handle = self._pop(idx)
        handle.wait()
        return True

    def _discard(self, idx: int) -> None:
        """Drop a handle that completed through its own wait()."""
        with self._lock:
            self._pop(idx)

    def wait_index(self, idx: int) -> Any:
        with self._lock:
            handle = self._pop(idx)
        if handle is None:
            return None  # already waited: a no-op, as in the reference
        return handle.wait()

    def sync_all(self) -> None:
        """Wait every outstanding handle (``resources.cpp:463-481``)."""
        with self._lock:
            pending = list(self._handles.values())
            self._handles.clear()
            self._counts.clear()
        for h in pending:
            h.wait()

    @property
    def outstanding(self) -> int:
        return len(self._handles)


handles = _HandleTable()


def wait(handle_or_index) -> Any:
    """``mpi.syncHandle``: wait on a handle or a table index."""
    if isinstance(handle_or_index, SyncHandle):
        return handle_or_index.wait()
    if isinstance(handle_or_index, int):
        return handles.wait_index(handle_or_index)
    if handle_or_index is None:
        return None
    raise TypeError(f"cannot wait on {type(handle_or_index).__name__}")


def sync_all() -> None:
    handles.sync_all()
