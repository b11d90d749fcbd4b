"""Public collectives surface of the port.

As in ``torchmpi_tpu/collectives/__init__.py`` (``torchmpi/init.lua:145-365``):
the selector-routed synchronous collectives at the top level take
rank-stacked ``[p, ...]`` tensors and return new ones; the per-backend
namespaces ``xla``, ``ring`` and ``kernel`` (the JAX package's ``pallas``)
pin a backend; ``async_`` holds the variants that return a
:class:`~torchmpi_tpu_torch.runtime.handles.SyncHandle`, with its own
``async_.xla``, ``async_.ring`` and ``async_.kernel``. ``backend=`` on the
top-level functions pins a backend too, which lets the CPU tests drive the
kernel path through the plain versions. The scalar collectives cross
processes and are the identity in one process, which holds every virtual
rank.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import constants
from ..runtime.communicator import Communicator
from ..runtime.handles import SyncHandle, sync_all, wait
from . import eager, primitives
from .eager import CollectiveArgumentError, free_collective_resources, precompile
from .fusion import FusionBuffer, get_fusion_buffer
from .selector import backend_availability, collective_availability, selector

# ring_implementation -> the backend that runs the selector's custom ring
_RING_IMPLEMENTATIONS = {"kernel": "kernel", "kernel_bidir": "kernel", "ppermute": "ring"}


def _current_comm(comm: Optional[Communicator]) -> Communicator:
    if comm is not None:
        return comm
    from .. import runtime_state

    return runtime_state.current_communicator()


def _resolve_backend(comm: Communicator, op: str, mode: str) -> str:
    """The selector's memoized choice for ``(op, mode)`` with the
    ``ring_implementation`` constant applied; the result is memoized too
    (``comm._backend_memo``), valid while ``constants.version()`` stands
    still, so a warm call reads one dict entry."""
    resolved_memo = comm.__dict__.setdefault("_backend_memo", {})
    resolved = resolved_memo.get((op, mode))
    version = constants.version()
    if resolved is not None and resolved[0] == version:
        return resolved[1]
    cache = comm.__dict__.setdefault("_selector_cache", {})
    backend = cache.get((op, mode))
    if backend is None:
        backend = cache[(op, mode)] = selector.select(
            op, comm.device, multinode=comm.num_nodes() > 1,
            mode="sync" if mode == "fused" else mode,
        )
    if backend in ("ring", "kernel"):
        impl = constants.get("ring_implementation")
        if impl not in _RING_IMPLEMENTATIONS:
            raise CollectiveArgumentError(
                f"unknown ring_implementation {impl!r}; expected one of "
                f"{sorted(_RING_IMPLEMENTATIONS)}"
            )
        chosen = _RING_IMPLEMENTATIONS[impl]
        avail = comm.__dict__.get("_availability")
        if avail is None:
            avail = comm.__dict__["_availability"] = backend_availability(comm.device)
        if avail.get(chosen):
            backend = chosen
    resolved_memo[(op, mode)] = (version, backend)
    return backend


def _dispatch(op: str, x: torch.Tensor, comm: Optional[Communicator] = None,
              mode: str = "sync", backend: Optional[str] = None, **kw):
    """Run ``op`` on ``comm``: ``mode`` 'sync' returns the result, 'async'
    a handle, 'fused' the result of a list of ``[p, n_i]`` slabs packed
    and reduced as one plan (:func:`~.eager.run_fused`). ``backend=None``
    takes the selector's choice for the mode (a fused dispatch takes the
    'sync' choice),
    memoized on the communicator per ``(op, mode)`` as the JAX
    ``_dispatch`` does (``collectives/__init__.py:37-52``; it lives until
    the communicator's resources are freed); where that is a custom ring,
    the ``ring_implementation`` constant says which one runs: 'kernel' and
    'kernel_bidir' the CUDA kernels, 'ppermute' the ``ring`` backend
    (:func:`_resolve_backend`)."""
    comm = _current_comm(comm)
    if backend is None:
        backend = _resolve_backend(comm, op, mode)
    if mode == "sync":
        return eager.run(op, x, comm, backend=backend, **kw)
    if mode == "fused":
        return eager.run_fused(op, x, comm, backend=backend, **kw)
    return eager.run_async(op, x, comm, backend=backend, **kw)


# --- selector-routed (default) namespace -----------------------------------
def broadcast_tensor(x: torch.Tensor, root: int = 0, comm=None,
                     backend: Optional[str] = None) -> torch.Tensor:
    return _dispatch("broadcast", x, comm, "sync", backend, root=root)


def reduce_tensor(x: torch.Tensor, root: int = 0, comm=None,
                  backend: Optional[str] = None) -> torch.Tensor:
    """Sum to ``root``; every other rank keeps its input."""
    return _dispatch("reduce", x, comm, "sync", backend, root=root)


def allreduce_tensor(x: torch.Tensor, comm=None, backend: Optional[str] = None,
                     wire_dtype: Optional[str] = None) -> torch.Tensor:
    """Sum-allreduce over the rank axis. ``wire_dtype`` ('full' | 'bf16' |
    'int8') overrides the wire of the custom rings (None = the constant);
    it engages only for f32 payloads of at least
    ``wire_quant_min_elements`` per rank."""
    return _dispatch("allreduce", x, comm, "sync", backend, wire_dtype=wire_dtype)


def allgather_tensor(x: torch.Tensor, comm=None,
                     backend: Optional[str] = None) -> torch.Tensor:
    """Every rank's block concatenated along the last dim, on every rank."""
    return _dispatch("allgather", x, comm, "sync", backend)


def sendreceive_tensor(x: torch.Tensor, src: int, dst: int, comm=None,
                       backend: Optional[str] = None) -> torch.Tensor:
    """``dst`` receives ``src``'s block; every other rank keeps its own."""
    return _dispatch("sendreceive", x, comm, "sync", backend, src=src, dst=dst)


def reducescatter_tensor(x: torch.Tensor, comm=None, backend: Optional[str] = None,
                         wire_dtype: Optional[str] = None) -> torch.Tensor:
    """Reduce-scatter over the last dim: rank r's block is slice r of the
    elementwise sum. ``wire_dtype`` as in :func:`allreduce_tensor`."""
    return _dispatch("reducescatter", x, comm, "sync", backend, wire_dtype=wire_dtype)


def alltoall_tensor(x: torch.Tensor, comm=None,
                    backend: Optional[str] = None) -> torch.Tensor:
    """Input ``[p, p, ...]`` where block ``[r, s]`` is rank r's payload for
    rank s; output block ``[r, j]`` is what rank j sent rank r."""
    return _dispatch("alltoall", x, comm, "sync", backend)


def allgatherv_tensor(blocks, comm=None, backend: str = "xla") -> torch.Tensor:
    """Variable-size allgather of one block per rank, ragged in the last
    dim (:func:`~.eager.run_allgatherv`; the reference's ``Allgatherv``,
    ``lib/collectives.cpp:245-290``)."""
    return eager.run_allgatherv(blocks, _current_comm(comm), backend=backend)


class _BackendNS:
    """``mpi.xla.*`` / ``mpi.ring.*`` / ``mpi.kernel.*``: the collectives
    pinned to one backend (``backend=None``: the selector's), in one mode
    (``_BackendNS``, ``collectives/__init__.py:126``)."""

    def __init__(self, backend: Optional[str], mode: str):
        self._backend = backend
        self._mode = mode

    def broadcast_tensor(self, x, root: int = 0, comm=None):
        return _dispatch("broadcast", x, comm, self._mode, self._backend, root=root)

    def reduce_tensor(self, x, root: int = 0, comm=None):
        return _dispatch("reduce", x, comm, self._mode, self._backend, root=root)

    def allreduce_tensor(self, x, comm=None, wire_dtype: Optional[str] = None):
        return _dispatch("allreduce", x, comm, self._mode, self._backend,
                         wire_dtype=wire_dtype)

    def allgather_tensor(self, x, comm=None):
        return _dispatch("allgather", x, comm, self._mode, self._backend)

    def sendreceive_tensor(self, x, src: int, dst: int, comm=None):
        return _dispatch("sendreceive", x, comm, self._mode, self._backend,
                         src=src, dst=dst)

    def reducescatter_tensor(self, x, comm=None, wire_dtype: Optional[str] = None):
        return _dispatch("reducescatter", x, comm, self._mode, self._backend,
                         wire_dtype=wire_dtype)

    def alltoall_tensor(self, x, comm=None):
        return _dispatch("alltoall", x, comm, self._mode, self._backend)


class _AsyncNS(_BackendNS):
    """``mpi.async_.*``: collectives that return a handle
    (``torchmpi/init.lua:145-365``'s ``MPI.async`` namespace)."""

    def __init__(self):
        super().__init__(None, "async")
        self.xla = _BackendNS("xla", "async")
        self.ring = _BackendNS("ring", "async")
        self.kernel = _BackendNS("kernel", "async")


xla = _BackendNS("xla", "sync")
ring = _BackendNS("ring", "sync")
kernel = _BackendNS("kernel", "sync")
async_ = _AsyncNS()


# --- scalar collectives (init.lua:125-134) ---------------------------------
# They cross processes; one process holds every virtual rank (multi-process
# ranks are ROADMAP A13), so each returns its input, as the JAX package's do
# in one process (collectives/__init__.py:178-237).
def broadcast_scalar(value, root: int = 0):
    """``root``'s host scalar on every process."""
    return value


def allreduce_scalar(value):
    """The sum of every process's host scalar."""
    return value


def reduce_scalar(value, root: int = 0):
    """The sum at process ``root``; every other process keeps its input."""
    return value


def sendreceive_scalar(value, src: int, dst: int):
    """Process ``dst`` gets ``src``'s host scalar; the others keep theirs."""
    return value


def barrier(comm=None) -> None:
    """Wait until every rank of ``comm`` (the current communicator by
    default) has finished its queued work (:func:`~.eager.barrier`)."""
    eager.barrier(_current_comm(comm))


__all__ = [
    "CollectiveArgumentError",
    "FusionBuffer",
    "SyncHandle",
    "allgather_tensor",
    "allgatherv_tensor",
    "allreduce_scalar",
    "allreduce_tensor",
    "alltoall_tensor",
    "async_",
    "backend_availability",
    "barrier",
    "broadcast_scalar",
    "broadcast_tensor",
    "collective_availability",
    "eager",
    "free_collective_resources",
    "get_fusion_buffer",
    "kernel",
    "precompile",
    "primitives",
    "reduce_scalar",
    "reduce_tensor",
    "reducescatter_tensor",
    "ring",
    "selector",
    "sendreceive_scalar",
    "sendreceive_tensor",
    "sync_all",
    "wait",
    "xla",
]
