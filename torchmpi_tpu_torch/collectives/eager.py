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

import contextlib
import threading
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
# routes eager.run memoizes per communicator before it starts afresh (a
# sweep over sizes adds one per size)
_MAX_ROUTES = 256


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
    (``torchmpi/cache.lua:19-61``), which the tester calls between sizes
    and :func:`~torchmpi_tpu_torch.runtime_state.stop` calls for every stack
    level (``eager.py:246``): dispatch the fusion buffer's pending groups,
    then drop the communicator's memoized selector choices (and backend
    availability), its memoized routes and its fusion buffer. The port
    compiles nothing per size, so there is no executable to free."""
    fb = getattr(comm, "_fusion_buffer", None)
    if fb is not None:
        fb.flush_all()
    for attr in ("_selector_cache", "_availability", "_fusion_buffer", "_routes"):
        comm.__dict__.pop(attr, None)


def barrier(comm: Communicator) -> None:
    """Device barrier over the communicator (``torch_mpi.cpp:270-280``,
    ``eager.py:1052``): returns once every rank's queued work is done. The
    virtual ranks share one device, so that is the device's work, the
    async side stream's included."""
    if comm.device.type == "cuda":
        torch.cuda.synchronize(comm.device)


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


def _reduce_scatter_lastdim(x: torch.Tensor, wire: str, **kw) -> torch.Tensor:
    """The eager reduce-scatter over each rank's last dim through the
    kernel, which scatters each rank's dim 0 (``eager.py:371``)."""
    from ..ops import ring_kernels

    out = ring_kernels.ring_reduce_scatter(x.movedim(-1, 1).contiguous(), wire, **kw)
    return out.movedim(1, -1)


def _allgather_lastdim(x: torch.Tensor, **kw) -> torch.Tensor:
    """The eager allgather, every rank's blocks concatenated along the last
    dim, through the kernel, which stacks them (``eager.py:384``)."""
    from ..ops import ring_kernels

    stacked = ring_kernels.ring_allgather(x, **kw)  # [rank, source, ..., d]
    moved = stacked.movedim(1, -2)  # [rank, ..., source, d]
    return moved.reshape(x.shape[:-1] + (x.shape[0] * x.shape[-1],))


def _kernels(op: str, backend: str, nelem: int, dtype: torch.dtype,
             platform: str, root: int = 0, src: int = 0, dst: int = 0,
             wire: str = "full") -> Callable:
    """The function of ``backend`` that runs ``op`` on a rank-stacked
    tensor (the flat part of the JAX ``_kernels`` table, with the flat
    lowering's decisions). A compressed ``wire`` pins the quantized rings
    (``eager.py:489-500``); the vendor path ships every payload
    verbatim. The kernel backend's functions pass ``stream=`` (the CUDA
    stream to launch on) to the kernels."""
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

        if op == "allreduce":  # the async issue path: no table to build
            if wire_arg is not None:
                return lambda x, **kw: ring_kernels.ring_allreduce_quant(x, wire_arg, **kw)
            if constants.get("ring_implementation") == "kernel_bidir":
                # the bidirectional ring has no quant path (schedule/lower.py:63-71)
                return ring_kernels.ring_allreduce_bidir
            return ring_kernels.ring_allreduce
        tree, _ = broadcast_plan(nelem, dtype, platform)
        table = {
            # at or below the tree cutoff the binomial tree, as the JAX
            # flat lowering routes its pallas broadcast (eager.py:430-441)
            "broadcast": (
                (lambda x, **kw: prim.tree_broadcast(x, root)) if tree
                else (lambda x, **kw: ring_kernels.ring_broadcast(x, root, **kw))
            ),
            "reduce": lambda x, **kw: ring_kernels.ring_reduce(x, root, **kw),
            "allgather": _allgather_lastdim,
            "reducescatter": lambda x, **kw: _reduce_scatter_lastdim(x, wire, **kw),
            # one point-to-point hop or one fused all-to-all: the vendor
            # path, as in the JAX pallas table
            "sendreceive": lambda x, **kw: prim.sendreceive(x, src, dst),
            "alltoall": lambda x, **kw: prim.alltoall(x),
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
    stream: Optional[torch.cuda.Stream] = None,
) -> torch.Tensor:
    """Synchronous eager collective on a rank-stacked tensor; returns a new
    rank-stacked tensor (the input is never written). ``wire_dtype``
    ('full' | 'bf16' | 'int8'; None = the ``wire_dtype`` constant) picks
    the wire of the ring and kernel backends' allreduce and reduce-scatter
    (:func:`resolve_wire_dtype` gives the gates). ``stream``: the CUDA
    stream a kernel launches on (default: the current one).

    The route (the effective backend, the wire and the function) is
    memoized on the communicator per call shape until a constant changes
    or its resources are freed; the argument checks run on every call."""
    x = _validate(op, x, comm, root, src, dst, wire_dtype)
    nelem = x.numel() // x.shape[0]  # per rank; x[0] would build a view
    version = constants.version()
    memo = comm.__dict__.get("_routes")
    if memo is None or memo[0] != version or len(memo[1]) >= _MAX_ROUTES:
        memo = comm.__dict__["_routes"] = (version, {})
    key = (op, backend, nelem, x.dtype, route_small, wire_dtype, root, src, dst)
    route = memo[1].get(key)
    if route is None:
        platform = comm.device.type
        effective = effective_backend(op, nelem, x.dtype, platform, backend, route_small)
        wire = (
            resolve_wire_dtype(op, nelem, x.dtype, wire_dtype)
            if effective in ("ring", "kernel")
            else "full"
        )
        fn = _kernels(op, effective, nelem, x.dtype, platform, root, src, dst, wire)
        route = memo[1][key] = (fn, effective == "kernel")
    fn, takes_stream = route
    if stream is not None and takes_stream:
        return fn(x.contiguous(), stream=stream)
    return fn(x.contiguous())


def run_allgatherv(blocks, comm: Communicator, backend: str = "xla") -> torch.Tensor:
    """Variable-size allgather (``eager.py:698``, the reference's size
    exchange and ``MPI_Allgatherv``, ``lib/collectives.cpp:245-290``):
    ``blocks`` holds one tensor (or array) per rank, agreeing on every dim
    but the last; every rank gets them concatenated along the last dim in
    rank order. The blocks travel padded to the largest size through the
    ``xla`` or ``ring`` allgather, and each rank keeps the valid prefixes.
    Returns ``[p, ..., sum(sizes)]`` on the communicator's device."""
    if len(blocks) != comm.size:
        raise CollectiveArgumentError(
            f"allgatherv expects {comm.size} blocks (one per rank), got {len(blocks)}"
        )
    blocks = [torch.as_tensor(b, device=comm.device) for b in blocks]
    base, dtype = blocks[0].shape[:-1], blocks[0].dtype
    for i, b in enumerate(blocks):
        if b.ndim == 0 or b.shape[:-1] != base:
            raise CollectiveArgumentError(
                f"block {i} shape {tuple(b.shape)} does not match leading dims "
                f"{tuple(base)} (only the LAST dim may vary, like the reference's "
                "last-dim realloc)"
            )
        if b.dtype != dtype:
            raise CollectiveArgumentError(f"block {i} dtype {b.dtype} != {dtype}")
    if backend == "xla":
        gather = prim.allgather
    elif backend == "ring":
        gather = prim.ring_allgather
    else:
        raise CollectiveArgumentError(
            f"allgatherv backend must be 'xla' or 'ring', got {backend!r}"
        )
    sizes = [b.shape[-1] for b in blocks]
    nmax = max(sizes)
    padded = torch.stack([torch.nn.functional.pad(b, (0, nmax - s)) if s < nmax else b
                          for b, s in zip(blocks, sizes)])
    g = gather(padded.unsqueeze(1), dim=0)  # [rank, source, ..., nmax]
    return torch.cat([g[:, r, ..., :s] for r, s in enumerate(sizes)], dim=-1)


def _async_side(comm: Communicator) -> threading.local:
    """The communicator's side stream for async collectives, made at first
    use like the reference's per-thread collective streams
    (``resources.cpp:1055-1094``), with, per issuing thread, the event
    that orders it after the caller's stream (an event waited is captured
    at the wait, so one can be recorded again for the next issue).
    Attributes ``stream`` and ``order``."""
    side = comm.__dict__.get("_async_local")
    if side is None:
        side = comm.__dict__.setdefault("_async_local", threading.local())
    if not hasattr(side, "stream"):
        stream = comm.__dict__.get("_async_stream")
        if stream is None:
            stream = comm.__dict__.setdefault("_async_stream", torch.cuda.Stream(comm.device))
        side.stream, side.order = stream, torch.cuda.Event()
    return side


def run_async(op: str, x: torch.Tensor, comm: Communicator, **kw) -> SyncHandle:
    """Asynchronous variant of :func:`run` (``eager.py:785``); returns a
    handle at once. On a CUDA communicator the collective runs on the
    communicator's side stream, after an event recorded on the caller's
    stream, and ``x`` is kept alive until the side stream has read it; on
    the CPU it runs now and the handle holds the result. The handle is
    registered, so ``sync_all()`` and ``stop()`` drain it."""
    # backpressure: bound the unwaited async collectives
    # (kNumAsyncCollectivesInFlight, lib/constants.cpp:152-155) by waiting
    # the oldest first, as the reference's bounded queues block enqueue;
    # the table keeps the count, so under the bound this is one read
    limit = constants.get("num_async_collectives_in_flight")
    while handles.outstanding_kind("collective") >= limit:
        if not handles.wait_oldest("collective"):
            break
    if comm.device.type != "cuda":
        h = SyncHandle(run(op, x, comm, **kw))
    else:
        side = _async_side(comm)
        caller = torch.cuda.current_stream(comm.device)
        side.order.record(caller)
        side.stream.wait_event(side.order)
        # switch to the side stream and back by hand (a stream context
        # would look the current stream and devices up again); setting a
        # stream makes its device current, so a caller on another device
        # gets its device back from the guard
        same = torch.cuda.current_device() == comm.device.index
        with contextlib.nullcontext() if same else torch.cuda.device(comm.device):
            torch.cuda.set_stream(side.stream)
            try:
                out = run(op, x, comm, stream=side.stream, **kw)
                done = torch.cuda.Event()
                done.record(side.stream)
            finally:
                torch.cuda.set_stream(caller)
        x.record_stream(side.stream)
        h = SyncHandle(out, done)
    handles.register(h, kind="collective")
    return h


def run_group_broadcast(x: torch.Tensor, comm: Communicator, root: int = 0) -> torch.Tensor:
    """Broadcast within each *intra group* of ``comm`` from the member with
    intra rank ``root`` (``eager.py:1009``): the building block of mixed
    PS x data-parallel updates (``update.lua:104-112``). Each rank's row
    becomes its group root's row, one gather over the rank axis, for
    cartesian and ragged (tree) communicators alike."""
    _check_rank_stacked(x, comm)
    groups: dict = {}
    for r in range(comm.size):
        m = comm.member(r)
        groups.setdefault(m.intra_group, {})[m.intra_rank] = r
    src = []
    for r in range(comm.size):
        g = groups[comm.member(r).intra_group]
        if root not in g:
            raise CollectiveArgumentError(
                f"intra root {root} out of range for group of size {len(g)}"
            )
        src.append(g[root])
    return x.index_select(0, torch.tensor(src, device=x.device))
