"""Public collectives surface of the port.

As in ``torchmpi_tpu/collectives/__init__.py``: the selector-routed
synchronous collectives at the top level take rank-stacked ``[p, ...]``
tensors and return new ones, and ``async_`` holds the variants that return
a :class:`~torchmpi_tpu_torch.runtime.handles.SyncHandle`. ``backend=``
pins a backend (``'xla'``, ``'kernel'``), which lets the CPU tests drive
the kernel path through the plain versions. This slice carries allreduce
(with its ``wire_dtype``) and broadcast.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import constants
from ..runtime.communicator import Communicator
from ..runtime.handles import SyncHandle, sync_all, wait
from . import eager, primitives
from .eager import CollectiveArgumentError
from .fusion import FusionBuffer, get_fusion_buffer
from .selector import backend_availability, selector


def _current_comm(comm: Optional[Communicator]) -> Communicator:
    if comm is not None:
        return comm
    from .. import runtime_state

    return runtime_state.current_communicator()


def _dispatch(op: str, x: torch.Tensor, comm: Optional[Communicator] = None,
              mode: str = "sync", backend: Optional[str] = None, **kw):
    """Run ``op`` on ``comm``: ``mode`` 'sync' returns the result, 'async'
    a handle. ``backend=None`` takes the selector's choice for the mode."""
    comm = _current_comm(comm)
    if backend is None:
        backend = selector.select(
            op, comm.device, multinode=comm.num_nodes() > 1, mode=mode
        )
        if backend == "kernel":
            # the selector decides vendor-vs-custom ring; which custom ring
            # runs is the ring_implementation constant, read per call
            impl = constants.get("ring_implementation")
            if impl == "ppermute":
                raise eager._not_ported("ring_implementation='ppermute'")
            if impl != "kernel":
                raise CollectiveArgumentError(
                    f"unknown ring_implementation {impl!r}; expected 'kernel' "
                    "or 'ppermute'"
                )
    if mode == "sync":
        return eager.run(op, x, comm, backend=backend, **kw)
    return eager.run_async(op, x, comm, backend=backend, **kw)


def broadcast_tensor(x: torch.Tensor, root: int = 0, comm=None,
                     backend: Optional[str] = None) -> torch.Tensor:
    return _dispatch("broadcast", x, comm, "sync", backend, root=root)


def allreduce_tensor(x: torch.Tensor, comm=None, backend: Optional[str] = None,
                     wire_dtype: Optional[str] = None) -> torch.Tensor:
    """Sum-allreduce over the rank axis. ``wire_dtype`` ('full' | 'bf16' |
    'int8') overrides the wire of the kernel ring (None = the constant);
    it engages only for f32 payloads of at least
    ``wire_quant_min_elements`` per rank."""
    return _dispatch("allreduce", x, comm, "sync", backend, wire_dtype=wire_dtype)


class _AsyncNS:
    """``mpi.async_.*``: collectives that return a handle
    (``torchmpi/init.lua:145-365``'s ``MPI.async`` namespace)."""

    def allreduce_tensor(self, x: torch.Tensor, comm=None,
                         backend: Optional[str] = None,
                         wire_dtype: Optional[str] = None) -> SyncHandle:
        return _dispatch("allreduce", x, comm, "async", backend, wire_dtype=wire_dtype)


async_ = _AsyncNS()


__all__ = [
    "CollectiveArgumentError",
    "FusionBuffer",
    "SyncHandle",
    "allreduce_tensor",
    "async_",
    "backend_availability",
    "broadcast_tensor",
    "eager",
    "get_fusion_buffer",
    "primitives",
    "selector",
    "sync_all",
    "wait",
]
