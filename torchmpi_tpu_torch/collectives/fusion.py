"""Coalescing of same-dtype allreduces and reduce-scatters into one flat
buffer.

The port of ``torchmpi_tpu/collectives/fusion.py:FusionBuffer``:
tensors submitted for an allreduce or a reduce-scatter are grouped by
``(op, dtype, wire, backend)`` (``fusion.py:221``); a group flushes as ONE
collective of a ``[p, total]`` buffer when its pending per-rank payload
reaches ``fusion_buffer_bytes``, when a caller waits on it, or on
:meth:`FusionBuffer.flush_all`, and each handle slices its tensor back
out. An allreduce flush is one plan of the schedule compiler
(``eager.run_fused``: the pack and the collective, compiled once per
layout and replayed); a reduce-scatter flush packs the group interleaved
and dispatches it synchronously through ``eager.run``, as in JAX
(``fusion.py:349-372``). A flush of fewer than ``fusion_min_tensors``
tensors dispatches them one by one, async. Routing (the small-message
cutoff, the wire) is decided on the fused total, which is what pushes many
small gradients onto the kernel path.

A tensor is fused only when it is rank-stacked with at least two dims
(``fusion.py:207-216``), and a reduce-scatter only for a ``[p, n]`` tensor
whose ``n`` divides by p; any other dispatches at once, async (across
processes, where the async collectives are ROADMAP A13's rest, at once
and synchronously; the rows there are the process's ranks'). The
reduce-scatter's interleaving: each tensor's ``[p, n_i]`` becomes
``[p, p, n_i / p]`` and the chunk axes are concatenated, so rank r's
scattered block holds every tensor's r-th chunk, and tensor i's result is
the ``[p, n_i / p]`` slice of the ``[p, total / p]`` output at offset
``sum(n_j / p, j < i)``.

Handles are registered under kind ``fusion``, so ``sync_all()`` (and
``stop()``) drain them but ``run_async``'s backpressure, which drains
kind ``collective``, never hands back a handle of a group mid-flush. Under
``overlap_schedule='reverse'`` :meth:`FusionBuffer.flush_all` flushes the
groups last submitted first. Telemetry (when enabled): tensors coalesced,
flushes by reason (``bytes`` / ``wait`` / ``explicit``), fused-vs-unfused
dispatch latency, and one ``fusion.{op}`` flight entry per flush.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

from .. import constants, telemetry as _telemetry
from ..runtime.communicator import Communicator
from ..runtime.handles import SyncHandle, handles
from ..telemetry import flightrecorder as _flight
from . import eager

_FUSABLE = ("allreduce", "reducescatter")

_MET = None


def _metric_handles():
    global _MET
    if _MET is None:
        m = _telemetry.metrics
        _MET = (
            m.counter(
                "tm_fusion_tensors_total",
                "tensors entering the fusion layer by op/wire/path "
                "(path=fused: coalesced into a flat buffer; "
                "path=unfused: dispatched individually)",
            ),
            m.counter(
                "tm_fusion_flushes_total",
                "fusion-buffer flushes by op/reason "
                "(bytes=capacity, wait=handle drain, explicit=flush_all)",
            ),
            m.histogram(
                "tm_fusion_dispatch_seconds",
                "host-side dispatch wall time per flush by op/path",
            ),
        )
    return _MET


class FusionHandle(SyncHandle):
    """Handle for one tensor submitted to a :class:`FusionBuffer`:
    :meth:`wait` flushes the owning group (reason ``wait``) if it has not
    flushed yet, then slices this tensor's segment out of the result.
    Registered under kind ``fusion`` (see the module docstring)."""

    __slots__ = ("_group", "_idx")

    def __init__(self, group: "_PendingGroup", idx: int):
        super().__init__()
        self._group = group
        self._idx = idx

    def wait(self) -> torch.Tensor:
        if self._done:
            return self._result
        self._result = self._group.result_for(self._idx)
        self._done = True
        if self._table_index is not None:
            handles._discard(self._table_index)
            self._table_index = None
        return self._result

    @property
    def done(self) -> bool:
        return self._done


class _PendingGroup:
    """Tensors awaiting one fused dispatch: same (op, dtype, wire,
    backend), each flattened to a [p, n] slab."""

    def __init__(self, buffer: "FusionBuffer", key: Tuple, op: str,
                 dtype: torch.dtype, wire: Optional[str], backend: Optional[str]):
        self.buffer = buffer
        self.key = key
        self.op = op
        self.dtype = dtype
        self.wire = wire
        self.backend = backend
        self.segments: List[Tuple[int, torch.Size]] = []  # (n, shape)
        self.flats: List[torch.Tensor] = []
        self.total = 0
        self._results: Optional[list] = None
        self._fused_buf: Optional[torch.Tensor] = None

    def add(self, flat: torch.Tensor, shape: torch.Size) -> int:
        self.segments.append((flat.shape[1], shape))
        self.flats.append(flat)
        self.total += flat.shape[1]
        return len(self.segments) - 1

    @property
    def pending_bytes(self) -> int:
        return self.total * self.dtype.itemsize

    def flushed(self) -> bool:
        return self._results is not None or self._fused_buf is not None

    def result_for(self, idx: int) -> torch.Tensor:
        if not self.flushed():
            self.buffer._flush_group(self, reason="wait")
        if self._results is not None:
            r = self._results[idx]
            if isinstance(r, SyncHandle):
                r = self._results[idx] = r.wait()
            return r
        n, shape = self.segments[idx]
        off = sum(s[0] for s in self.segments[:idx])
        if self.op == "reducescatter":
            # interleaved packing (see _dispatch_fused): rank r's fused
            # block holds each tensor's r-th chunk, so the segment comes
            # back out by offset / p
            p = self.buffer.comm.size
            return self._fused_buf[:, off // p : (off + n) // p].reshape(
                tuple(shape[:-1]) + (shape[-1] // p,))
        return self._fused_buf[:, off : off + n].reshape(shape)


class FusionBuffer:
    """Per-communicator coalescing dispatcher (get one with
    :func:`get_fusion_buffer`; dropped by ``free_collective_resources``).
    :meth:`submit` returns a handle at once; the collective launches when
    the buffer fills or the handle is waited."""

    def __init__(self, comm: Communicator):
        self.comm = comm
        self._groups: Dict[Tuple, _PendingGroup] = {}

    def submit(self, op: str, x: torch.Tensor, wire_dtype: Optional[str] = None,
               backend: Optional[str] = None) -> SyncHandle:
        """Queue one rank-stacked tensor for a fused ``op``; returns a
        handle. Falls through to an immediate unfused async dispatch when
        coalescing cannot engage (disabled, unfusable op, fewer than two
        dims, or a reduce-scatter whose last dim does not divide by the
        world size). ``wire_dtype`` is the group's wire
        (:func:`~torchmpi_tpu_torch.collectives.allreduce_tensor`)."""
        cap = constants.get("fusion_buffer_bytes")
        p = self.comm.size
        fusable = (
            cap > 0
            and op in _FUSABLE
            and x.ndim >= 2
            and x.shape[0] == self.comm.local_size
            and not (op == "reducescatter" and (x.ndim != 2 or x.shape[-1] % p))
        )
        if not fusable:
            self._count_tensor(op, wire_dtype, "unfused")
            return self._dispatch_unfused(op, x, wire_dtype, backend)
        key = (op, x.dtype, wire_dtype, backend)
        group = self._groups.get(key)
        if group is None:
            group = self._groups[key] = _PendingGroup(self, key, op, x.dtype,
                                                      wire_dtype, backend)
        idx = group.add(x if x.ndim == 2 else x.reshape(x.shape[0], -1), x.shape)
        h = FusionHandle(group, idx)
        handles.register(h, kind="fusion")
        if group.pending_bytes >= cap:
            self._flush_group(group, reason="bytes")
        return h

    def flush_all(self, reason: str = "explicit") -> None:
        """Dispatch every pending group now (handles stay waitable). Under
        ``overlap_schedule='reverse'`` the groups flush in reverse
        insertion order: gradients are submitted forward layer first, so
        the last layers, the first gradients ready in the backward pass,
        go on the wire first."""
        groups = list(self._groups.values())
        if constants.get("overlap_schedule") == "reverse":
            groups.reverse()
        for group in groups:
            if not group.flushed():
                self._flush_group(group, reason=reason)

    def flush_for(self, submitted, reason: str = "wait") -> None:
        """Dispatch only the pending groups the given handles belong to: a
        caller synchronizing its tensors must not cut short the capacity
        window of unrelated submitters sharing the buffer."""
        seen = set()
        for h in submitted:
            group = getattr(h, "_group", None)
            if group is not None and id(group) not in seen:
                seen.add(id(group))
                if not group.flushed():
                    self._flush_group(group, reason=reason)

    @property
    def pending_tensors(self) -> int:
        return sum(len(g.segments) for g in self._groups.values())

    def _count_tensor(self, op, wire, path, n: int = 1) -> None:
        if _telemetry.enabled():
            tensors, _, _ = _metric_handles()
            tensors.inc(n, op=op, wire=wire or "auto", path=path)

    def _dispatch_unfused(self, op, x, wire_dtype, backend) -> SyncHandle:
        from . import _dispatch

        t0 = time.perf_counter()
        kw = {"wire_dtype": wire_dtype} if op in eager._WIRE_OPS else {}
        if self.comm.multiprocess:
            # the async collectives across processes are ROADMAP A13's rest
            # (part 4): the unfused dispatch is synchronous there
            h = SyncHandle(_dispatch(op, x, self.comm, "sync", backend, **kw))
        else:
            h = _dispatch(op, x, self.comm, "async", backend, **kw)
        if _telemetry.enabled():
            _, _, lat = _metric_handles()
            lat.observe(time.perf_counter() - t0, op=op, path="unfused")
        return h

    def _flush_group(self, group: _PendingGroup, reason: str) -> None:
        self._groups.pop(group.key, None)
        telemetry_on = _telemetry.enabled()
        if telemetry_on:
            _, flushes, lat = _metric_handles()
            flushes.inc(op=group.op, reason=reason)
        flight_entry = None
        if _flight.enabled():
            # the flush joins the communicator's flight stream (the
            # dispatch it triggers records separately): a cross-rank
            # layout mismatch here is a desync even when the dispatches
            # agree
            flight_entry = _flight.recorder.record(
                _flight.comm_key(self.comm), f"fusion.{group.op}",
                payload=(tuple(n for n, _ in group.segments), group.dtype),
                wire=group.wire or "auto", backend=group.backend or "auto",
                routing=reason,
            )
        try:
            if len(group.segments) < max(1, constants.get("fusion_min_tensors")):
                # packing below the threshold costs more than it saves:
                # dispatch each tensor on its own
                self._count_tensor(group.op, group.wire, "unfused", len(group.segments))
                group._results = [
                    self._dispatch_unfused(group.op, flat.reshape(shape), group.wire,
                                           group.backend)
                    for flat, (_, shape) in zip(group.flats, group.segments)
                ]
                group.flats = []
            else:
                self._count_tensor(group.op, group.wire, "fused", len(group.segments))
                t0 = time.perf_counter()
                group._fused_buf = self._dispatch_fused(group)
                if telemetry_on:
                    lat.observe(time.perf_counter() - t0, op=group.op, path="fused")
        except BaseException:
            if flight_entry is not None:
                _flight.FlightRecorder.fail(flight_entry)
            raise
        if flight_entry is not None:
            _flight.FlightRecorder.complete(flight_entry)

    def _dispatch_fused(self, group: _PendingGroup) -> torch.Tensor:
        from . import _dispatch

        flats, group.flats = group.flats, []
        if group.op == "reducescatter":
            # interleave so rank r's scattered block holds every tensor's
            # r-th chunk: [p, n_i] -> [p, p, n_i / p], concatenate the chunk
            # axes, flatten back to [p, total] (each n_i divides by p,
            # gated at submit); then one synchronous reduce-scatter plan. The
            # rows are this process's ranks' (all p in one process)
            p, local = self.comm.size, self.comm.local_size
            buf = torch.cat([f.reshape(local, p, -1) for f in flats], dim=2).reshape(local, -1)
            return _dispatch(group.op, buf, self.comm, "sync", group.backend,
                             wire_dtype=group.wire)
        # allreduce: the pack and the reduction as one plan (run_fused)
        return _dispatch(group.op, flats, self.comm, "fused", group.backend,
                         wire_dtype=group.wire)


def get_fusion_buffer(comm: Optional[Communicator] = None) -> FusionBuffer:
    """The communicator's coalescing dispatcher (lazily attached)."""
    if comm is None:
        from .. import runtime_state

        comm = runtime_state.current_communicator()
    fb = getattr(comm, "_fusion_buffer", None)
    if fb is None:
        fb = comm._fusion_buffer = FusionBuffer(comm)
    return fb
