"""Synchronization handles for async collectives.

The port of ``torchmpi_tpu/runtime/handles.py`` (the reference's
``SynchronizationHandle``, ``lib/resources.h:230-253``,
``lib/resources.cpp:1173-1242``). The JAX handle waits on in-flight
arrays; here an async collective on a CUDA communicator runs on a side
stream, and its handle holds the result and the CUDA event recorded after
it: :meth:`SyncHandle.wait` makes the caller's current stream wait on that
event, so the host never blocks. On the CPU every collective has finished
when it returns, and the handle holds the result.

Handles are registered in a table, so ``sync_all()`` (and ``stop()``)
drains every outstanding one (``resources.cpp:463-481``) and
``num_async_collectives_in_flight`` bounds how many are unwaited.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import torch


class SyncHandle:
    """The result of an async collective, ready once :meth:`wait` returns."""

    __slots__ = ("_result", "_event", "_done", "_table_index")

    def __init__(self, result: torch.Tensor, event: Optional[torch.cuda.Event] = None):
        self._result = result
        self._event = event
        self._done = False
        self._table_index: Optional[int] = None

    def wait(self) -> torch.Tensor:
        """The collective's result, ordered before the caller's later work
        on its current stream. Idempotent: a second wait returns the same
        result, as the reference's freed slot makes later waits no-ops
        (``resources.cpp:1226-1242``)."""
        if not self._done:
            if self._event is not None:
                stream = torch.cuda.current_stream(self._result.device)
                stream.wait_event(self._event)
                # the result was allocated on the side stream: its memory
                # must not be handed out again until this stream is done
                self._result.record_stream(stream)
            self._done = True
            if self._table_index is not None:
                handles._discard(self._table_index)
                self._table_index = None
        return self._result

    @property
    def done(self) -> bool:
        """True once waited, or once the device has finished the work."""
        return self._done or self._event is None or self._event.query()

    def __repr__(self) -> str:
        kind = "cuda" if self._event is not None else "done"
        return f"SyncHandle<{kind}{', waited' if self._done else ''}>"


class _HandleTable:
    """Index-addressed handle registry (reference ``resources.cpp:545-578``
    and the future queues at ``:399-461``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._handles: Dict[int, SyncHandle] = {}
        self._kinds: Dict[int, str] = {}
        self._next = 0

    def register(self, handle: SyncHandle, kind: str = "") -> int:
        with self._lock:
            idx = self._next
            self._next += 1
            self._handles[idx] = handle
            if kind:
                self._kinds[idx] = kind
            handle._table_index = idx
            return idx

    def outstanding_kind(self, kind: str) -> int:
        """Unwaited handles registered under ``kind`` (the backpressure
        count for ``num_async_*_in_flight``)."""
        with self._lock:
            return sum(1 for i in self._handles if self._kinds.get(i) == kind)

    def wait_oldest(self, kind: str) -> bool:
        """Wait the oldest outstanding handle of ``kind``; False if none."""
        with self._lock:
            idxs = sorted(i for i in self._handles if self._kinds.get(i) == kind)
            if not idxs:
                return False
            handle = self._handles.pop(idxs[0])
            self._kinds.pop(idxs[0], None)
        handle.wait()
        return True

    def _discard(self, idx: int) -> None:
        """Drop a handle that completed through its own wait()."""
        with self._lock:
            self._handles.pop(idx, None)
            self._kinds.pop(idx, None)

    def wait_index(self, idx: int) -> Any:
        with self._lock:
            handle = self._handles.pop(idx, None)
            self._kinds.pop(idx, None)
        if handle is None:
            return None  # already waited: a no-op, as in the reference
        return handle.wait()

    def sync_all(self) -> None:
        """Wait every outstanding handle (``resources.cpp:463-481``)."""
        with self._lock:
            pending = list(self._handles.values())
            self._handles.clear()
            self._kinds.clear()
        for h in pending:
            h.wait()

    @property
    def outstanding(self) -> int:
        with self._lock:
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
