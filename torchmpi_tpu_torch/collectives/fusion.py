"""Coalescing of same-dtype allreduces and reduce-scatters into one flat
buffer.

The port of the part of ``torchmpi_tpu/collectives/fusion.py:FusionBuffer``
that ``nn.synchronize_gradients(fused=True)`` and the engine's sharded
modes use: tensors submitted for an allreduce or a reduce-scatter are
grouped by ``(op, dtype, wire, backend)`` (``fusion.py:126-136``); a group
flushes as ONE collective of a ``[p, total]`` buffer when its pending
per-rank payload reaches ``fusion_buffer_bytes`` or when a caller waits on
it, and each handle slices its tensor back out. A flush of fewer than
``fusion_min_tensors`` tensors dispatches them one by one. Routing (the
small-message cutoff) is decided on the fused total, which is what pushes
many small gradients onto the kernel path.

A reduce-scatter is fused only for a ``[p, n]`` tensor whose ``n`` divides
by p (``fusion.py:207-214``); any other dispatches at once. Its flush
interleaves the group (``fusion.py:349-364``): each tensor's ``[p, n_i]``
becomes ``[p, p, n_i / p]`` and the chunk axes are concatenated, so rank
r's scattered block holds every tensor's r-th chunk, and tensor i's result
is the ``[p, n_i / p]`` slice of the ``[p, total / p]`` output at offset
``sum(n_j / p, j < i)``. The JAX version's async dispatch and telemetry
wait for later slices.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from .. import constants
from ..runtime.communicator import Communicator

_FUSABLE = ("allreduce", "reducescatter")


class FusionHandle:
    """One submitted tensor; :meth:`wait` flushes its group if needed and
    returns the tensor's slice of the result."""

    __slots__ = ("_group", "_idx")

    def __init__(self, group: "_PendingGroup", idx: int):
        self._group = group
        self._idx = idx

    def wait(self) -> torch.Tensor:
        return self._group.result_for(self._idx)


class _Done:
    """Handle of a tensor dispatched on its own (unfusable)."""

    __slots__ = ("_result",)

    def __init__(self, result: torch.Tensor):
        self._result = result

    def wait(self) -> torch.Tensor:
        return self._result


class _PendingGroup:
    """Tensors awaiting one fused dispatch: same (op, dtype, wire,
    backend), each flattened to a [p, n] slab."""

    def __init__(self, buffer: "FusionBuffer", key: Tuple):
        self.buffer = buffer
        self.key = key
        self.shapes: List[torch.Size] = []
        self.flats: List[torch.Tensor] = []
        self.total = 0
        self.results: Optional[List[torch.Tensor]] = None

    def add(self, flat: torch.Tensor, shape: torch.Size) -> int:
        self.shapes.append(shape)
        self.flats.append(flat)
        self.total += flat.shape[1]
        return len(self.shapes) - 1

    def pending_bytes(self) -> int:
        return self.total * self.flats[0].element_size()

    def result_for(self, idx: int) -> torch.Tensor:
        if self.results is None:
            self.buffer._flush_group(self)
        return self.results[idx]


class FusionBuffer:
    """Per-communicator coalescing dispatcher (get one with
    :func:`get_fusion_buffer`)."""

    def __init__(self, comm: Communicator):
        self.comm = comm
        self._groups: Dict[Tuple, _PendingGroup] = {}

    def submit(self, op: str, x: torch.Tensor, wire_dtype: Optional[str] = None,
               backend: Optional[str] = None):
        """Queue one rank-stacked tensor for a fused ``op``; returns a
        handle. Dispatches at once when coalescing cannot engage (disabled,
        or an op the buffer does not fuse). ``wire_dtype`` is the group's
        wire (:func:`~torchmpi_tpu_torch.collectives.allreduce_tensor`)."""
        from . import _dispatch

        cap = constants.get("fusion_buffer_bytes")
        p = self.comm.size
        scatter = op == "reducescatter"
        if (cap <= 0 or op not in _FUSABLE or x.ndim < 1
                or scatter and (x.ndim != 2 or x.shape[-1] % p)):
            return _Done(
                _dispatch(op, x, self.comm, "sync", backend, wire_dtype=wire_dtype)
            )
        key = (op, x.dtype, wire_dtype, backend)
        group = self._groups.get(key)
        if group is None:
            group = self._groups[key] = _PendingGroup(self, key)
        h = FusionHandle(group, group.add(x.reshape(p, -1), x.shape))
        if group.pending_bytes() >= cap:
            self._flush_group(group)
        return h

    def flush_for(self, submitted) -> None:
        """Dispatch only the pending groups the given handles belong to."""
        for h in submitted:
            group = getattr(h, "_group", None)
            if group is not None and group.results is None:
                self._flush_group(group)

    def flush_all(self) -> None:
        """Dispatch every pending group."""
        for group in list(self._groups.values()):
            self._flush_group(group)

    def _flush_group(self, group: _PendingGroup) -> None:
        from . import _dispatch

        self._groups.pop(group.key, None)
        op, _, wire_dtype, backend = group.key
        flats, group.flats = group.flats, []
        if len(flats) < max(1, constants.get("fusion_min_tensors")):
            # packing one tensor buys nothing: dispatch it as it is
            group.results = [
                _dispatch(op, f.reshape(s), self.comm, "sync", backend,
                          wire_dtype=wire_dtype)
                for f, s in zip(flats, group.shapes)
            ]
            return
        p = self.comm.size
        if op == "reducescatter":
            # interleaved: rank r's scattered block holds every tensor's
            # r-th chunk, so tensor i's chunk sits at its offset / p
            buf = torch.cat([f.reshape(p, p, -1) for f in flats], dim=2).reshape(p, -1)
            shapes = [(p, s[1] // p) for s in group.shapes]
        else:
            buf, shapes = torch.cat(flats, dim=1), group.shapes
        out = _dispatch(op, buf, self.comm, "sync", backend, wire_dtype=wire_dtype)
        results, off = [], 0
        for s in shapes:
            n = math.prod(s[1:])
            results.append(out[:, off : off + n].reshape(s))
            off += n
        group.results = results


def get_fusion_buffer(comm: Optional[Communicator] = None) -> FusionBuffer:
    """The communicator's coalescing dispatcher (lazily attached)."""
    if comm is None:
        from .. import runtime_state

        comm = runtime_state.current_communicator()
    fb = getattr(comm, "_fusion_buffer", None)
    if fb is None:
        fb = comm._fusion_buffer = FusionBuffer(comm)
    return fb
