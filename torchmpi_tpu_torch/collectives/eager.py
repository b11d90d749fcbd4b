"""Eager collectives on rank-stacked tensors.

The port of ``torchmpi_tpu/collectives/eager.py`` for flat plans: ``run``
validates a rank-stacked ``[p, ...]`` tensor, resolves the backend (the
size cutoff of :func:`op_route` and the kernel's dtype gates) and the wire
format (:func:`resolve_wire_dtype`), and calls the backend's function
directly; :func:`run_async` runs the same call on a side stream and
returns a :class:`~torchmpi_tpu_torch.runtime.handles.SyncHandle`. The
three backends are the JAX package's, with ``pallas`` named ``kernel``:

- ``xla`` — plain PyTorch over the rank axis (``primitives``' vendor ops);
- ``ring`` — the ``ppermute`` ring, hop by hop on the rank axis
  (``primitives.ring_*``), with its byte-bounded steps, buffers and wire;
- ``kernel`` — the hand-written CUDA ring kernels (``ops``).

The JAX package compiles each request through the schedule compiler
(``schedule/compiler.py:607``); on a flat communicator that binds the flat
lowering (``schedule/lower.py:50``) whose decisions are made here: the
bidirectional ring under ``ring_implementation='kernel_bidir'``, the ring
tuning, and the tree-or-pipeline broadcast. The other schedule families
wait for later slices (ROADMAP queue A2).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .. import constants
from ..runtime.communicator import Communicator
from ..runtime.handles import SyncHandle, handles
from . import primitives as prim

_OPS = (
    "broadcast",
    "reduce",
    "allreduce",
    "sendreceive",
    "allgather",
    "reducescatter",
    "alltoall",
)
# collectives the compressed wire formats apply to (the bandwidth-path
# reductions; data movers are lossless by contract and stay verbatim)
_WIRE_OPS = ("allreduce", "reducescatter")
_REDUCTIONS = ("allreduce", "reduce", "reducescatter")


class CollectiveArgumentError(ValueError):
    pass


def _check_rank_stacked(x: torch.Tensor, comm: Communicator) -> None:
    if x.ndim < 1 or x.shape[0] != comm.size:
        raise CollectiveArgumentError(
            f"eager collectives expect a rank-stacked tensor with leading axis "
            f"== comm.size ({comm.size}); got shape {tuple(x.shape)}"
        )
    if x.device != comm.device:
        raise CollectiveArgumentError(
            f"tensor on {x.device}, communicator on {comm.device}"
        )


def free_collective_resources(comm: Communicator) -> None:
    """The analog of the reference's ``freeCollectiveResources``
    (``torchmpi/cache.lua:19-61``), which the tester calls between sizes.
    The JAX package drops the communicator's compiled executables here; the
    port compiles nothing per size and holds no per-size resource, so there
    is nothing to free."""


def op_route(op: str, nelem: int, platform: str, requested: str = "ring") -> str:
    """Size-based latency/bandwidth routing (reference
    ``collectives.cpp:296-301``): at or below the cutoff the vendor path,
    above it the requested bandwidth backend. ``nelem`` is per rank."""
    suffix = constants.platform_suffix(platform)
    if op == "allreduce":
        cutoff = constants.get(f"small_allreduce_size_{suffix}")
    elif op == "broadcast":
        cutoff = constants.get(f"small_broadcast_size_{suffix}")
    else:
        return requested
    return "xla" if nelem <= cutoff else requested


def effective_backend(op: str, nelem: int, dtype: torch.dtype, platform: str,
                      backend: str, route_small: bool) -> str:
    """Resolve the requested backend (``schedule/compiler.py:190``): the
    small-message cutoff reroutes custom requests to the vendor path; a
    reduction whose dtype the kernels cannot carry exactly, and a complex
    payload of any op, fall to the ``ring`` backend, as in the JAX
    package."""
    effective = backend
    if backend in ("ring", "kernel") and route_small:
        effective = op_route(op, nelem, platform, backend)
    if effective == "kernel":
        from ..ops import ring_kernels

        if op in _REDUCTIONS:
            if not ring_kernels.supports_dtype(dtype):
                effective = "ring"
        elif dtype.is_complex:
            effective = "ring"
    return effective


def resolve_wire_dtype(op: str, nelem: int, dtype: torch.dtype,
                       requested: Optional[str] = None) -> str:
    """The wire format of one eager call (``eager.py:529``): the explicit
    ``wire_dtype=`` argument wins, else the ``wire_dtype`` constant; 'full'
    whenever the encoding cannot engage -- another op, a payload that is
    not f32 (ints pass uncompressed, exactness is their contract), or
    fewer than ``wire_quant_min_elements`` elements per rank."""
    wire = requested if requested is not None else constants.get("wire_dtype")
    if wire in (None, "", "full"):
        return "full"
    if wire not in ("int8", "bf16"):
        raise CollectiveArgumentError(
            f"unknown wire_dtype {wire!r}; expected 'full', 'bf16' or 'int8'"
        )
    if op not in _WIRE_OPS or dtype != torch.float32:
        return "full"
    if nelem < constants.get("wire_quant_min_elements"):
        return "full"
    return wire


def ring_tuning(platform: str) -> Tuple[int, int, int]:
    """(min_bytes, max_bytes, num_buffers) of the ring backend on the
    platform (``eager.py:337``): the reference's kMin/kMaxBufferSize and
    kNumBuffersPerCollective knobs (``lib/constants.cpp:142-150``), the
    buffers capped by ``max_num_buffers_per_collective``."""
    suffix = constants.platform_suffix(platform)
    nb = min(
        constants.get(f"num_buffers_per_collective_{suffix}"),
        constants.get("max_num_buffers_per_collective"),
    )
    return (
        constants.get(f"min_buffer_size_{suffix}"),
        constants.get(f"max_buffer_size_{suffix}"),
        nb,
    )


def broadcast_plan(nelem: int, dtype: torch.dtype, platform: str) -> Tuple[bool, int]:
    """(use_tree, pipeline_chunks) for a broadcast of ``nelem`` elements
    per rank (``eager.py:354``): the binomial tree at or below
    ``broadcast_size_tree_based`` bytes (``collectives.cpp:58-64``'s 4 MB
    switch); above it the pipelined ring, in chunks of at most
    ``max_buffer_size`` and at least ``min_buffer_size`` bytes."""
    suffix = constants.platform_suffix(platform)
    block_bytes = nelem * dtype.itemsize
    if block_bytes <= constants.get(f"broadcast_size_tree_based_{suffix}"):
        return True, 1
    minb, maxb, _ = ring_tuning(platform)
    k = max(1, -(-block_bytes // max(1, maxb)))
    k = min(k, max(1, block_bytes // max(1, minb)))
    return False, int(k)


def _reduce_scatter_lastdim(x: torch.Tensor, wire: str) -> torch.Tensor:
    """The eager reduce-scatter over each rank's last dim through the
    kernel, which scatters each rank's dim 0 (``eager.py:371``)."""
    from ..ops import ring_kernels

    out = ring_kernels.ring_reduce_scatter(x.movedim(-1, 1).contiguous(), wire)
    return out.movedim(1, -1)


def _allgather_lastdim(x: torch.Tensor) -> torch.Tensor:
    """The eager allgather, every rank's blocks concatenated along the last
    dim, through the kernel, which stacks them (``eager.py:384``)."""
    from ..ops import ring_kernels

    stacked = ring_kernels.ring_allgather(x)  # [rank, source, ..., d]
    moved = stacked.movedim(1, -2)  # [rank, ..., source, d]
    return moved.reshape(x.shape[:-1] + (x.shape[0] * x.shape[-1],))


def _kernels(op: str, backend: str, nelem: int, dtype: torch.dtype,
             platform: str, root: int = 0, src: int = 0, dst: int = 0,
             wire: str = "full") -> Callable:
    """The function of ``backend`` that runs ``op`` on a rank-stacked
    tensor (the flat part of the JAX ``_kernels`` table, with the flat
    lowering's decisions). A compressed ``wire`` pins the quantized rings
    (``eager.py:489-500``); the vendor path ships every payload
    verbatim."""
    wire_arg = None if wire == "full" else wire
    if backend == "xla":
        table = {
            "allreduce": prim.allreduce,
            "broadcast": lambda x: prim.broadcast(x, root),
            "reduce": lambda x: prim.reduce(x, root),
            "allgather": prim.allgather,
            "sendreceive": lambda x: prim.sendreceive(x, src, dst),
            "reducescatter": prim.reduce_scatter,
            "alltoall": prim.alltoall,
        }
    elif backend == "ring":
        # pipeline depth 1: the JAX schedule compiler's depth choice changes
        # no bits (primitives.ring_allreduce), and the port has no compiler
        minb, maxb, nbuf = ring_tuning(platform)
        tree, k = broadcast_plan(nelem, dtype, platform)
        table = {
            "allreduce": lambda x: prim.ring_allreduce(
                x, max_bytes_per_step=maxb, min_bytes_per_step=minb,
                num_buffers=nbuf, wire_dtype=wire_arg,
            ),
            "broadcast": (
                (lambda x: prim.tree_broadcast(x, root)) if tree
                else (lambda x: prim.ring_broadcast(x, root, num_chunks=k))
            ),
            "reduce": lambda x: prim.ring_reduce(
                x, root, max_bytes_per_step=maxb, min_bytes_per_step=minb,
                num_buffers=nbuf,
            ),
            "allgather": prim.ring_allgather,
            "sendreceive": lambda x: prim.sendreceive(x, src, dst),
            "reducescatter": lambda x: prim.ring_reduce_scatter(x, wire_dtype=wire_arg),
            "alltoall": prim.ring_alltoall,
        }
    elif backend == "kernel":
        from ..ops import ring_kernels

        if wire_arg is not None:
            allreduce = lambda x: ring_kernels.ring_allreduce_quant(x, wire_arg)  # noqa: E731
        elif constants.get("ring_implementation") == "kernel_bidir":
            # the bidirectional ring has no quant path (schedule/lower.py:63-71)
            allreduce = ring_kernels.ring_allreduce_bidir
        else:
            allreduce = ring_kernels.ring_allreduce
        tree, _ = broadcast_plan(nelem, dtype, platform)
        table = {
            "allreduce": allreduce,
            # at or below the tree cutoff the binomial tree, as the JAX
            # flat lowering routes its pallas broadcast (eager.py:430-441)
            "broadcast": (
                (lambda x: prim.tree_broadcast(x, root)) if tree
                else (lambda x: ring_kernels.ring_broadcast(x, root))
            ),
            "reduce": lambda x: ring_kernels.ring_reduce(x, root),
            "allgather": _allgather_lastdim,
            "reducescatter": lambda x: _reduce_scatter_lastdim(x, wire),
            # one point-to-point hop or one fused all-to-all: the vendor
            # path, as in the JAX pallas table
            "sendreceive": lambda x: prim.sendreceive(x, src, dst),
            "alltoall": prim.alltoall,
        }
    else:
        raise CollectiveArgumentError(f"unknown backend {backend!r}")
    return table[op]


def _validate(op: str, x: torch.Tensor, comm: Communicator, root: int,
              src: int, dst: int, wire_dtype: Optional[str]) -> torch.Tensor:
    """Argument checks shared by every backend; returns the (possibly
    lifted) input."""
    if op not in _OPS:
        raise CollectiveArgumentError(f"unknown collective {op!r}")
    _check_rank_stacked(x, comm)
    if wire_dtype not in (None, "full", "bf16", "int8"):
        # validated on every call: a typo must not pass silently because
        # this call happened to route to the vendor path
        raise CollectiveArgumentError(
            f"unknown wire_dtype {wire_dtype!r}; expected 'full', 'bf16' or 'int8'"
        )
    if op in ("broadcast", "reduce") and not 0 <= root < comm.size:
        raise CollectiveArgumentError(f"root {root} out of range")
    if op == "sendreceive" and not (0 <= src < comm.size and 0 <= dst < comm.size):
        raise CollectiveArgumentError(
            f"sendreceive src {src} / dst {dst} out of range for {comm.size} ranks"
        )
    if op == "allgather" and x.ndim == 1:
        # one scalar per rank: lift to [p, 1] so the output stays
        # rank-stacked ([p, p]: every rank's block is the gathered vector)
        x = x[:, None]
    if op == "reducescatter" and (x.ndim < 2 or x.shape[-1] % comm.size):
        raise CollectiveArgumentError(
            f"reducescatter scatters the last dim, which must exist and be "
            f"divisible by the communicator size {comm.size}; got shape "
            f"{tuple(x.shape)}"
        )
    if op == "alltoall" and (x.ndim < 2 or x.shape[1] != comm.size):
        raise CollectiveArgumentError(
            f"alltoall needs rank-stacked [p, p, ...] input (block [r, s] = "
            f"rank r's payload for rank s); got shape {tuple(x.shape)} for "
            f"p={comm.size}"
        )
    return x


def run(
    op: str,
    x: torch.Tensor,
    comm: Communicator,
    backend: str = "xla",
    root: int = 0,
    src: int = 0,
    dst: int = 0,
    route_small: bool = True,
    wire_dtype: Optional[str] = None,
) -> torch.Tensor:
    """Synchronous eager collective on a rank-stacked tensor; returns a new
    rank-stacked tensor (the input is never written). ``wire_dtype``
    ('full' | 'bf16' | 'int8'; None = the ``wire_dtype`` constant) picks
    the wire of the ring and kernel backends' allreduce and reduce-scatter
    (:func:`resolve_wire_dtype` gives the gates)."""
    x = _validate(op, x, comm, root, src, dst, wire_dtype)
    nelem = x[0].numel()
    platform = comm.device.type
    effective = effective_backend(op, nelem, x.dtype, platform, backend, route_small)
    wire = (
        resolve_wire_dtype(op, nelem, x.dtype, wire_dtype)
        if effective in ("ring", "kernel")
        else "full"
    )
    fn = _kernels(op, effective, nelem, x.dtype, platform, root, src, dst, wire)
    return fn(x.contiguous())


def _async_stream(comm: Communicator) -> torch.cuda.Stream:
    """The communicator's side stream for async collectives (made at first
    use, like the reference's per-thread collective streams,
    ``resources.cpp:1055-1094``)."""
    stream = getattr(comm, "_async_stream", None)
    if stream is None:
        stream = comm._async_stream = torch.cuda.Stream(comm.device)
    return stream


def run_async(op: str, x: torch.Tensor, comm: Communicator, **kw) -> SyncHandle:
    """Asynchronous variant of :func:`run` (``eager.py:785``); returns a
    handle at once. On a CUDA communicator the collective runs on the
    communicator's side stream, after an event recorded on the caller's
    stream, and ``x`` is kept alive until the side stream has read it; on
    the CPU it runs now and the handle holds the result. The handle is
    registered, so ``sync_all()`` and ``stop()`` drain it."""
    # backpressure: bound the unwaited async collectives
    # (kNumAsyncCollectivesInFlight, lib/constants.cpp:152-155) by waiting
    # the oldest first, as the reference's bounded queues block enqueue
    limit = constants.get("num_async_collectives_in_flight")
    while handles.outstanding_kind("collective") >= limit:
        if not handles.wait_oldest("collective"):
            break
    if comm.device.type != "cuda":
        h = SyncHandle(run(op, x, comm, **kw))
    else:
        side = _async_stream(comm)
        side.wait_stream(torch.cuda.current_stream(comm.device))
        with torch.cuda.stream(side):
            out = run(op, x, comm, **kw)
            done = torch.cuda.Event()
            done.record(side)
        x.record_stream(side)
        h = SyncHandle(out, done)
    handles.register(h, kind="collective")
    return h
