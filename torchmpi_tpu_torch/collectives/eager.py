"""Eager collectives on rank-stacked tensors.

The port of ``torchmpi_tpu/collectives/eager.py``: :func:`run` validates a
rank-stacked ``[p, ...]`` tensor and has the schedule compiler
(:func:`~torchmpi_tpu_torch.schedule.compile_collective`) resolve the
request to a cached :class:`~torchmpi_tpu_torch.schedule.ir.Plan`: the
effective backend (the size cutoff of :func:`op_route` and the kernels'
dtype gates), the wire format (:func:`resolve_wire_dtype`), the schedule
family and the ring's pipeline depth, bound to a function of the kernel
table (:func:`_kernels`) and replayed through :func:`_dispatch`, which
stamps the plan's ``plan_id`` on telemetry spans, metrics and
flight-recorder entries. :func:`run_async` runs the same plan on a side
stream and returns a
:class:`~torchmpi_tpu_torch.runtime.handles.SyncHandle`; a warm CUDA
allreduce is issued there by one C++ call (``ops/issue.py``).
:func:`run_fused` packs and reduces a fusion buffer's flush as one plan,
and :func:`precompile` warms and pins plans before training. The three
backends are the JAX package's, with ``pallas`` named ``kernel``:

- ``xla`` — plain PyTorch over the rank axis (``primitives``' vendor ops);
- ``ring`` — the ``ppermute`` ring, hop by hop on the rank axis
  (``primitives.ring_*``), with its byte-bounded steps, buffers, wire and
  pipeline depth;
- ``kernel`` — the hand-written CUDA ring kernels (``ops``).

On a two-level communicator (``push_communicator`` with a key per
group) the compiler lowers the hierarchical, staged and tree families
(``schedule/lower.py``), as the JAX compiler does;
:func:`run_hierarchical_allreduce`, :func:`run_hierarchical_collective`
and :func:`run_tree_hierarchical_allreduce` pin them.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional, Tuple

import torch

from .. import constants, telemetry as _telemetry
from ..ops import issue as _issue
from ..runtime.communicator import Communicator
from ..runtime.handles import SyncHandle, handles
from ..telemetry import flightrecorder as _flight
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
_BACKENDS = ("xla", "ring", "kernel")

# telemetry handles, created on first instrumented dispatch (the metric
# objects are process-lived; the disabled path never touches them)
_MET = None


def _metric_handles():
    global _MET
    if _MET is None:
        m = _telemetry.metrics
        _MET = (
            m.counter(
                "tm_collective_calls_total",
                "eager collective dispatches by op/backend/wire",
            ),
            m.histogram(
                "tm_collective_dispatch_seconds",
                "host-side dispatch wall time per eager collective "
                "(CUDA launches are async: submit cost, not completion)",
            ),
        )
    return _MET


def _dispatch(fn, x, op: str, backend: str, wire: str, nelem: int,
              comm: Optional[Communicator] = None, payload=None, routing: str = "",
              plan: str = ""):
    """Run ``fn(x)``, recording the dispatch (span + metrics) when
    telemetry is enabled, plus a flight-recorder entry (per-comm seq, op,
    payload, issue/complete stamps) when the recorder is on; one branch
    each when disabled (``eager.py:91``; the port compiles no executable,
    so there is no executable-cache label). ``payload`` is the raw (shape,
    dtype) pair, stringified only at snapshot time. ``plan`` is the
    schedule compiler's stable plan_id."""
    entry = None
    if _flight.enabled() and comm is not None:
        entry = _flight.recorder.record(
            _flight.comm_key(comm), op, payload=payload, wire=wire,
            backend=backend, routing=routing, plan=plan,
        )
    if not _telemetry.enabled():
        if entry is None:
            return fn(x)
        try:
            out = fn(x)
        except BaseException:
            _flight.FlightRecorder.fail(entry)
            raise
        _flight.FlightRecorder.complete(entry)
        return out
    calls, lat = _metric_handles()
    attrs = {"backend": backend, "wire_dtype": wire, "nelem": nelem}
    if plan:
        attrs["plan"] = plan
    t0 = time.perf_counter()
    try:
        with _telemetry.span(f"collective.{op}", **attrs):
            out = fn(x)
    except BaseException:
        if entry is not None:
            _flight.FlightRecorder.fail(entry)
        raise
    if entry is not None:
        _flight.FlightRecorder.complete(entry)
    calls.inc(op=op, backend=backend, wire=wire)
    lat.observe(time.perf_counter() - t0, op=op, backend=backend)
    return out


class CollectiveArgumentError(ValueError):
    pass


def _check_rank_stacked(x: torch.Tensor, comm: Communicator) -> None:
    """The rank-stacked contract: the leading axis holds this process's
    ranks of ``comm``, in rank order (every rank in one process; in a job
    of several processes ``comm.local_size`` rows, the counterpart of a
    JAX global array's addressable shards)."""
    if x.ndim < 1 or x.shape[0] != comm.local_size:
        if comm.multiprocess:
            raise CollectiveArgumentError(
                f"eager collectives expect a rank-stacked tensor with leading axis "
                f"== this process's rank count ({comm.local_size} of the communicator's "
                f"{comm.size}, ranks {comm.local_ranks}); got shape {tuple(x.shape)}"
            )
        raise CollectiveArgumentError(
            f"eager collectives expect a rank-stacked tensor with leading axis "
            f"== comm.size ({comm.size}); got shape {tuple(x.shape)}"
        )
    if x.device != comm.device:
        raise CollectiveArgumentError(
            f"tensor on {x.device}, communicator on {comm.device}"
        )


class _LRUCache(OrderedDict):
    """Bounded cache (``eager.py:162``): get() refreshes recency, inserts
    evict the least-recently-used entry past
    ``collective_cache_max_entries``. The schedule compiler's plan cache
    and dispatch memo use it: a 2^8..2^23 tester sweep would otherwise
    accumulate an entry per size with no way back (the reference frees
    its per-size descriptors for the same reason,
    ``torchmpi/cache.lua:19-61``).

    Entries may be **pinned** (:meth:`pin`, the ``precompile`` path):
    pinned entries are never LRU-evicted, so a sweep cannot evict the
    plans a training loop declared up front. They still go away with the
    whole cache (``free_collective_resources`` / ``stop()``, a wholesale
    teardown)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._pinned = set()
        self._access_log = None  # set: records gets/inserts when armed

    def log_accesses(self, log: Optional[set]) -> None:
        """Arm (or, with None, disarm) access logging: every hit and
        insert lands in ``log``. Used by ``precompile`` to pin exactly
        the entries its dispatches touched, entries that already existed
        included."""
        self._access_log = log

    def get(self, key, default=None):
        try:
            value = super().__getitem__(key)
        except KeyError:
            return default
        self.move_to_end(key)
        if self._access_log is not None:
            self._access_log.add(key)
        return value

    def pin(self, key) -> bool:
        """Exempt ``key`` from LRU eviction; True if it was present."""
        if key in self:
            self._pinned.add(key)
            return True
        return False

    def pinned_count(self) -> int:
        return len(self._pinned)

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self.move_to_end(key)
        if self._access_log is not None:
            self._access_log.add(key)
        limit = constants.get("collective_cache_max_entries")
        while len(self) > limit:
            victim = next((k for k in self if k not in self._pinned), None)
            if victim is None:
                break  # everything pinned: the pins outrank the bound
            del self[victim]


def _dispatch_memo(comm: Communicator) -> _LRUCache:
    """The warm-dispatch memo: call signature -> bound
    :class:`~torchmpi_tpu_torch.schedule.compiler.ExecutablePlan`
    (``eager.py:232``), on the communicator."""
    memo = comm.__dict__.get("_dispatch_memo")
    if memo is None:
        memo = comm.__dict__["_dispatch_memo"] = _LRUCache()
    return memo


def free_collective_resources(comm: Communicator) -> None:
    """The analog of the reference's ``freeCollectiveResources``
    (``torchmpi/cache.lua:19-61``), which the tester calls between sizes
    and :func:`~torchmpi_tpu_torch.runtime_state.stop` calls for every stack
    level (``eager.py:246``): dispatch the fusion buffer's pending groups,
    then drop the communicator's dispatch memo and plan cache (pinned
    entries too: teardown outranks pins), its memoized selector choices
    (and backend availability) and its fusion buffer. The port compiles
    nothing per size, so there is no executable to free."""
    fb = getattr(comm, "_fusion_buffer", None)
    if fb is not None:
        try:
            fb.flush_all(reason="explicit")
        except Exception:
            pass
    for attr in ("_dispatch_memo", "_plan_cache", "_selector_cache", "_backend_memo",
                 "_availability", "_fusion_buffer"):
        comm.__dict__.pop(attr, None)


def barrier(comm: Communicator) -> None:
    """Device barrier over the communicator (``torch_mpi.cpp:270-280``,
    ``eager.py:1052``): returns once every rank's queued work is done. A
    process's virtual ranks share one device, so that is the device's
    work, the async side stream's included; across processes every
    process of the communicator then meets the others at the control
    plane's barrier (among those processes only)."""
    if comm.multiprocess:
        _plane().drain()
    if comm.device.type == "cuda":
        torch.cuda.synchronize(comm.device)
    if comm.multiprocess:
        from ..runtime.peers import processes_of

        _plane().barrier(processes_of(comm))


def _plane():
    """The control plane of the multi-process runtime."""
    from .. import runtime_state

    plane = runtime_state.plane()
    if plane is None:
        raise CollectiveArgumentError(
            "a communicator spanning processes needs the runtime started with a "
            "coordinator (start(coordinator_address=...) or the launcher)")
    return plane


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


def _wire_recorder(op: str, transport: str, routing: str, nelem: int,
                   dtype: torch.dtype, wire: str):
    """The ``utils.tracing.wire_stats`` record each execute of a plan
    makes (``eager.py:552``), or None: a wire op carried by a ring or
    kernel transport records its per-rank logical payload bytes against
    the bytes its encoding puts on the wire per hop. The staged and tree
    lowerings always carry their intra phase on a ring. The bytes are
    worked out once, when the plan is bound (a constants change rebinds
    it), so an execute pays one locked counter update."""
    if op not in _WIRE_OPS or not (
        transport in ("ring", "kernel") or routing in ("staged", "tree")
    ):
        return None
    from ..utils import tracing

    itemsize = dtype.itemsize
    block = constants.get("wire_quant_block_size")
    wire_bytes = prim.wire_encoded_bytes(nelem, itemsize, wire, block)
    return functools.partial(tracing.wire_stats.record, op, wire, nelem * itemsize,
                             wire_bytes)


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


def _allgather_lastdim(x: torch.Tensor, groups: int = 1, **kw) -> torch.Tensor:
    """The eager allgather, every rank's blocks concatenated along the last
    dim, through the kernel, which stacks them (``eager.py:384``); with
    ``groups``, every rank gets its group's blocks (the group-major rows'
    intra allgather, one launch)."""
    from ..ops import ring_kernels

    return _concat_lastdim(ring_kernels.ring_allgather(x, groups=groups, **kw), x)


def _concat_lastdim(stacked: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The stacked blocks ``[rank, source, ..., d]`` of an allgather of
    ``x`` concatenated along the last dim, ``[rank, ..., source * d]``."""
    moved = stacked.movedim(1, -2)  # [rank, ..., source, d]
    return moved.reshape(x.shape[:-1] + (stacked.shape[1] * x.shape[-1],))


def _kernels(op: str, backend: str, nelem: int, dtype: torch.dtype,
             platform: str, root: int = 0, src: int = 0, dst: int = 0,
             wire: str = "full", pipeline: int = 1) -> Callable:
    """The function of ``backend`` that runs ``op`` on a rank-stacked
    tensor (the JAX ``_kernels`` table, with the flat lowering's
    decisions). A compressed ``wire`` pins the quantized rings
    (``eager.py:489-500``); the vendor path ships every payload
    verbatim. ``pipeline`` is the plan's depth, which the ``ring``
    backend's allreduce runs. The kernel backend's functions pass
    ``stream=`` (the CUDA stream to launch on) to the kernels."""
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
        minb, maxb, nbuf = ring_tuning(platform)
        tree, k = broadcast_plan(nelem, dtype, platform)
        table = {
            "allreduce": lambda x: prim.ring_allreduce(
                x, max_bytes_per_step=maxb, min_bytes_per_step=minb,
                num_buffers=nbuf, wire_dtype=wire_arg, pipeline_depth=pipeline,
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


def _compile(op: str, x: torch.Tensor, comm: Communicator, backend: str,
             root: int, src: int, dst: int, route_small: bool,
             wire_dtype: Optional[str]):
    """Validate one call and fetch its bound plan from the schedule
    compiler (a dispatch-memo hit when warm); returns the (possibly
    lifted) input and the plan."""
    _sched = _compiler()
    x = _validate(op, x, comm, root, src, dst, wire_dtype)
    if backend not in _BACKENDS:
        raise CollectiveArgumentError(f"unknown backend {backend!r}")
    ep = _sched.compile_collective(
        op, _global_shape(x, comm), x.dtype, comm, backend=backend,
        route_small=route_small, wire_dtype=wire_dtype, root=root, src=src,
        dst=dst,
    )
    return x, ep


def _global_shape(x: torch.Tensor, comm: Communicator) -> tuple:
    """The rank-stacked shape over every rank of ``comm``, which the
    schedule compiler plans for (``x`` holds this process's rows)."""
    return (comm.size,) + tuple(x.shape[1:])


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
    rank-stacked tensor (the input is never written). The request is
    compiled by the schedule compiler (``eager.py:614``): effective
    backend, wire format and schedule are one cached plan decision, and
    the bound function replays through :func:`_dispatch` with its
    ``plan_id``; warm calls are one memo hit. ``wire_dtype`` ('full' |
    'bf16' | 'int8'; None = the ``wire_dtype`` constant) picks the wire of
    the ring and kernel backends' allreduce and reduce-scatter
    (:func:`resolve_wire_dtype` gives the gates). ``stream``: the CUDA
    stream a kernel launches on (default: the current one). The argument
    checks run on every call."""
    x, ep = _compile(op, x, comm, backend, root, src, dst, route_small, wire_dtype)
    return ep.execute(x.contiguous(), stream)


def run_fused(op: str, flats, comm: Communicator, backend: str = "xla",
              route_small: bool = True, wire_dtype: Optional[str] = None) -> torch.Tensor:
    """Coalesced multi-input dispatch (``eager.py:650``): ``flats``
    (rank-stacked ``[p, n_i]`` slabs) are packed and reduced by one plan,
    compiled once per (op, layout, dtype, routing) and replayed. Routing
    (cutoff, wire format) is decided on the total payload: coalescing is
    what pushes small tensors past the bandwidth-path and quantization
    cutoffs. Slabs of mixed dtypes are promoted to their common dtype. The
    inputs are only read. Returns the fused ``[p, total]`` result;
    callers slice their segments back out."""
    if op != "allreduce":
        raise CollectiveArgumentError(f"run_fused supports allreduce, got {op!r}")
    if backend not in _BACKENDS:
        raise CollectiveArgumentError(f"unknown backend {backend!r}")
    flats = list(flats)
    if not flats:
        raise CollectiveArgumentError("run_fused needs at least one tensor")
    for f in flats:
        _check_rank_stacked(f, comm)
        if f.ndim != 2:
            raise CollectiveArgumentError(
                f"run_fused takes [p, n] slabs; got shape {tuple(f.shape)}"
            )
    dtype = flats[0].dtype
    if any(f.dtype != dtype for f in flats):
        for f in flats[1:]:
            dtype = torch.promote_types(dtype, f.dtype)
        flats = [f.to(dtype) for f in flats]
    from ..schedule import compiler as _sched

    ep = _sched.compile_fused(
        op, tuple(f.shape[1] for f in flats), dtype, comm, backend=backend,
        route_small=route_small, wire_dtype=wire_dtype,
    )
    return ep.execute(flats)


def run_allgatherv(blocks, comm: Communicator, backend: str = "xla") -> torch.Tensor:
    """Variable-size allgather (``eager.py:698``, the reference's size
    exchange and ``MPI_Allgatherv``, ``lib/collectives.cpp:245-290``):
    ``blocks`` holds one tensor (or array) per rank, agreeing on every dim
    but the last; every rank gets them concatenated along the last dim in
    rank order. The blocks travel padded to the largest size through the
    ``xla`` or ``ring`` allgather, and each rank keeps the valid prefixes.
    Returns ``[p, ..., sum(sizes)]`` on the communicator's device.

    Across processes a process passes its own ranks' blocks (``comm.
    local_size`` of them, in rank order) and gets its rows ``[L, ...,
    sum(sizes)]``: every block's shape and dtype is exchanged over the
    control plane first (:func:`_allgatherv_across`)."""
    if backend not in ("xla", "ring"):
        raise CollectiveArgumentError(
            f"allgatherv backend must be 'xla' or 'ring', got {backend!r}"
        )
    if comm.multiprocess:
        return _allgatherv_across(blocks, comm, backend)
    if len(blocks) != comm.size:
        raise CollectiveArgumentError(
            f"allgatherv expects {comm.size} blocks (one per rank), got {len(blocks)}"
        )
    blocks = [torch.as_tensor(b, device=comm.device) for b in blocks]
    err = _allgatherv_blocks_error([tuple(b.shape) for b in blocks], [b.dtype for b in blocks])
    if err:
        raise CollectiveArgumentError(err)
    gather = prim.allgather if backend == "xla" else prim.ring_allgather
    sizes = [b.shape[-1] for b in blocks]
    nmax = max(sizes)
    padded = torch.stack([torch.nn.functional.pad(b, (0, nmax - s)) if s < nmax else b
                          for b, s in zip(blocks, sizes)])
    g = gather(padded.unsqueeze(1), dim=0)  # [rank, source, ..., nmax]
    return torch.cat([g[:, r, ..., :s] for r, s in enumerate(sizes)], dim=-1)


def _allgatherv_blocks_error(shapes, dtypes) -> Optional[str]:
    """The argument error of a variable-size allgather of blocks of
    ``shapes`` and ``dtypes`` (rank order), or None."""
    base, dtype = shapes[0][:-1], dtypes[0]
    for i, (shape, dt) in enumerate(zip(shapes, dtypes)):
        if len(shape) == 0 or shape[:-1] != base:
            return (f"block {i} shape {shape} does not match leading dims {base} (only the "
                    "LAST dim may vary, like the reference's last-dim realloc)")
        if dt != dtype:
            return f"block {i} dtype {dt} != {dtype}"
    return None


def _allgatherv_across(blocks, comm: Communicator, backend: str) -> torch.Tensor:
    """:func:`run_allgatherv` on a communicator whose ranks span
    processes: every process's block shapes and dtypes gathered over the
    control plane (the reference's size exchange), checked alike in every
    process (so an error raises in all of them), the blocks padded to the
    largest size through the backend's cross-process allgather, each
    rank's valid prefix kept."""
    from ..runtime.peers import processes_of

    blocks = [torch.as_tensor(b, device=comm.device) for b in blocks]
    procs = processes_of(comm)
    every = _plane().all_gather_object([(tuple(b.shape), str(b.dtype)) for b in blocks], procs)
    owned = [[r for r in range(comm.size) if comm.process_of(r) == q] for q in procs]
    wrong = [i for i, (m, rows) in enumerate(zip(every, owned)) if len(m) != len(rows)]
    if wrong:
        raise CollectiveArgumentError(
            f"allgatherv expects each process's blocks of its ranks: process "
            f"{procs[wrong[0]]} gave {len(every[wrong[0]])} for {len(owned[wrong[0]])} ranks")
    by_rank = [None] * comm.size
    for m, rows in zip(every, owned):
        for r, entry in zip(rows, m):
            by_rank[r] = entry
    err = _allgatherv_blocks_error([s for s, _ in by_rank], [d for _, d in by_rank])
    if err:
        raise CollectiveArgumentError(err)
    sizes = [s[-1] for s, _ in by_rank]
    nmax = max(sizes)
    padded = torch.stack([torch.nn.functional.pad(b, (0, nmax - b.shape[-1])) for b in blocks])
    g = run("allgather", padded, comm, backend=backend, route_small=False)
    g = g.reshape(padded.shape[:-1] + (comm.size, nmax))
    return torch.cat([g[..., r, :s] for r, s in enumerate(sizes)], dim=-1)


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


_SCHED = None


def _compiler():
    """The schedule compiler module, imported at first use (it imports
    this module)."""
    global _SCHED
    if _SCHED is None:
        from ..schedule import compiler

        _SCHED = compiler
    return _SCHED


def _issue_route(op: str, x: torch.Tensor, comm: Communicator, backend: str, root: int,
                 src: int, dst: int, route_small: bool, wire_dtype: Optional[str]):
    """The bound plan of an async call that goes through the C++ issue
    path, from a memo beside the dispatch memo keyed by everything the
    argument checks and the compiler read (op, backend, shape, dtype,
    device, wire, root, src, dst): a warm call repeats neither the checks
    nor the compiler's signature build, which gave the same answer on
    every call. The entry holds while ``constants.version()``, the plan
    overrides and the calibration stand still; it goes with the dispatch
    memo (``free_collective_resources``), and is neither read nor filled
    while ``precompile`` logs the memo's accesses (the compiler runs, so
    its entries are logged and pinned). Returns None where the Python
    path must run (no C++ route, or an input the checks lift)."""
    memo = _dispatch_memo(comm)
    logging = memo._access_log is not None
    sched = _compiler()
    key = (op, backend, x.shape, x.dtype, x.get_device(), wire_dtype, root, src, dst,
           route_small)
    stamp = (constants.version(), sched._OVR_EPOCH, sched._cost.calibration_epoch())
    fast = memo.__dict__.setdefault("_issue", {})
    ent = None if logging else fast.get(key)
    if ent is None or ent[0] != stamp:
        lifted, ep = _compile(op, x, comm, backend, root, src, dst, route_small, wire_dtype)
        ent = (stamp, ep if lifted is x and ep.issue is not None else None)
        if not logging:
            fast[key] = ent
    return ent[1]


def run_async(op: str, x: torch.Tensor, comm: Communicator, backend: str = "xla",
              root: int = 0, src: int = 0, dst: int = 0, route_small: bool = True,
              wire_dtype: Optional[str] = None) -> SyncHandle:
    """Asynchronous variant of :func:`run` (``eager.py:785``); returns a
    handle at once. On a CUDA communicator the collective runs on the
    communicator's side stream, after an event recorded on the caller's
    stream, and ``x`` is kept alive until the side stream has read it; on
    the CPU it runs now and the handle holds the result. The handle is
    registered, so ``sync_all()`` and ``stop()`` drain it.

    A plan with an :attr:`~torchmpi_tpu_torch.schedule.compiler.ExecutablePlan.issue`
    route (a CUDA allreduce on the vendor path or through K3) is issued by
    one C++ call (:func:`~torchmpi_tpu_torch.ops.issue.issue_async`: the
    ordering event, the stream switch, the work, the done event and
    ``record_stream``) while telemetry and the flight recorder are off,
    its plan memoized per call shape (:func:`_issue_route`); with either
    on, the Python path issues it, so every stamp is made.

    Across processes the call runs on the control plane's issue thread
    (:func:`_run_async_across`)."""
    # backpressure: bound the unwaited async collectives
    # (kNumAsyncCollectivesInFlight, lib/constants.cpp:152-155) by waiting
    # the oldest first, as the reference's bounded queues block enqueue;
    # the table keeps the count, so under the bound this is one read
    limit = constants.get("num_async_collectives_in_flight")
    while handles.outstanding_kind("collective") >= limit:
        if not handles.wait_oldest("collective"):
            break
    if comm.multiprocess:
        return _run_async_across(op, x, comm, backend, root, src, dst, route_small, wire_dtype)
    cuda = comm.device.type == "cuda"
    if cuda and not _telemetry.enabled() and not _flight.enabled():
        ep = _issue_route(op, x, comm, backend, root, src, dst, route_small, wire_dtype)
        if ep is not None:
            if ep.record_wire is not None:
                ep.record_wire()
            side = _async_side(comm)
            done = torch.cuda.Event()
            h = SyncHandle(_issue.issue_async(x, side.stream, side.order, done, ep.issue), done)
            handles.register(h, kind="collective")
            return h
    x, ep = _compile(op, x, comm, backend, root, src, dst, route_small, wire_dtype)
    if not cuda:
        h = SyncHandle(ep.execute(x.contiguous()))
        handles.register(h, kind="collective")
        return h
    side = _async_side(comm)
    caller = torch.cuda.current_stream(comm.device)
    side.order.record(caller)
    side.stream.wait_event(side.order)
    # switch to the side stream and back by hand (a stream context would
    # look the current stream and devices up again); setting a stream makes
    # its device current, so a caller on another device gets its device
    # back from the guard
    same = torch.cuda.current_device() == comm.device.index
    with contextlib.nullcontext() if same else torch.cuda.device(comm.device):
        torch.cuda.set_stream(side.stream)
        try:
            out = ep.execute(x.contiguous(), side.stream)
            done = torch.cuda.Event()
            done.record(side.stream)
        finally:
            torch.cuda.set_stream(caller)
    x.record_stream(side.stream)
    h = SyncHandle(out, done)
    handles.register(h, kind="collective")
    return h


def _run_async_across(op: str, x: torch.Tensor, comm: Communicator, backend: str,
                      root: int, src: int, dst: int, route_small: bool,
                      wire_dtype: Optional[str]) -> SyncHandle:
    """:func:`run_async` on a communicator whose ranks span processes: the
    plan compiled here, the call enqueued on the control plane's issue
    thread (``runtime/peers.py``, one FIFO a process, so every process
    posts its lane and gloo calls in program order), a handle returned at
    once. On CUDA the caller's stream records an ordering event now; the
    thread makes the communicator's side stream wait on it, runs the plan
    there (the lane's protocol included) and records the done event, and
    ``x`` stays alive until the side stream has read it. The handle's
    :meth:`~SyncHandle.wait` joins the work item (raising its error, a
    :class:`~torchmpi_tpu_torch.runtime.peers.PeerError` when a peer died
    or did not answer), then orders the caller's stream after the done
    event."""
    from ..runtime.handles import StreamResult

    x, ep = _compile(op, x, comm, backend, root, src, dst, route_small, wire_dtype)
    x = x.contiguous()
    if comm.device.type != "cuda":
        fut = _plane().issue.submit(lambda: ep.execute(x))
        h = SyncHandle(future=fut)
        handles.register(h, kind="collective")
        return h
    side = _async_side(comm)
    order, done = torch.cuda.Event(), torch.cuda.Event()
    order.record(torch.cuda.current_stream(comm.device))
    x.record_stream(side.stream)
    stream, device = side.stream, comm.device

    def work():
        # the current stream is per thread: the issue thread sets its own
        with torch.cuda.device(device):
            torch.cuda.set_stream(stream)
            stream.wait_event(order)
            out = ep.execute(x, stream)
            done.record(stream)
        return StreamResult(out, done)

    h = SyncHandle(future=_plane().issue.submit(work))
    handles.register(h, kind="collective")
    return h


def precompile(specs, comm: Optional[Communicator] = None, pin: bool = True) -> int:
    """Warm-up before training (``eager.py:807``): populate and **pin** the
    schedule compiler's plan cache and dispatch memo from declared
    collective specs, so the first training step plans no collective.

    ``specs`` is an iterable of tuples ``(op, shape, dtype)`` optionally
    extended with ``backend`` and ``wire_dtype`` (or dicts with those keys
    plus ``root``). ``shape`` is the rank-stacked shape; a shape whose
    leading axis differs from ``comm.size`` is taken as the per-rank block
    shape and the rank axis is prepended. A dict spec may instead carry
    ``layout``: a tuple of per-rank widths declaring a coalesced group,
    warmed through :func:`run_fused`, the plan a ``FusionBuffer`` flush of
    that layout replays.

    Each spec is dispatched once on a zeros payload through the production
    route (selector, schedule compiler, wire resolution), so the plan
    cache and the per-signature dispatch memo are warm afterwards; every
    entry the warm-up touches, new or already present, is pinned against
    LRU eviction (``free_collective_resources`` still frees them). The
    warm-up's launches count like any other. Returns the number of specs
    warmed. Typically called through ``start(precompile_collectives=...)``
    or ``AllReduceSGDEngine.precompile()``."""
    if comm is None:
        from .. import runtime_state

        comm = runtime_state.current_communicator()
    from ..schedule import compiler as _sched

    caches = [_dispatch_memo(comm), _sched._plan_cache(comm)]
    touched = [set(), set()]
    if pin:
        # log every hit and insert the warm-up makes, so pinning covers
        # entries that already existed
        for cache, log in zip(caches, touched):
            cache.log_accesses(log)
    try:
        warmed = _precompile_dispatch(specs, comm)
    finally:
        if pin:
            for cache in caches:
                cache.log_accesses(None)
    if comm.device.type == "cuda":
        torch.cuda.synchronize(comm.device)
    if pin:
        for cache, log in zip(caches, touched):
            for key in log:
                cache.pin(key)
    return warmed


def _precompile_dispatch(specs, comm: Communicator) -> int:
    """The spec-by-spec warm-up loop of :func:`precompile`."""
    from . import _dispatch as _ns_dispatch

    warmed = 0
    for spec in specs:
        if isinstance(spec, dict) and "layout" in spec:
            flats = [torch.zeros((comm.local_size, int(n)), dtype=spec["dtype"],
                                 device=comm.device)
                     for n in spec["layout"]]
            kw = {}
            if spec.get("wire_dtype") is not None:
                kw["wire_dtype"] = spec["wire_dtype"]
            _ns_dispatch(spec.get("op", "allreduce"), flats, comm, "fused",
                         spec.get("backend"), **kw)
            warmed += 1
            continue
        if isinstance(spec, dict):
            op, shape, dtype = spec["op"], tuple(spec["shape"]), spec["dtype"]
            backend, wire = spec.get("backend"), spec.get("wire_dtype")
            root = spec.get("root", 0)
        else:
            op, shape, dtype = spec[0], tuple(spec[1]), spec[2]
            backend = spec[3] if len(spec) > 3 else None
            wire = spec[4] if len(spec) > 4 else None
            root = 0
        if shape and shape[0] != comm.size:
            shape = (comm.size,) + shape
        # this process's rows of it
        shape = (comm.local_size,) + shape[1:]
        kw = {}
        if wire is not None and op in _WIRE_OPS:
            kw["wire_dtype"] = wire
        if op in ("broadcast", "reduce"):
            kw["root"] = root
        _ns_dispatch(op, torch.zeros(shape, dtype=dtype, device=comm.device), comm, "sync",
                     backend, **kw)
        warmed += 1
    return warmed


# ---------------------------------------------------------------------------
# generator-pinning wrappers (the hierarchical entry points)
# ---------------------------------------------------------------------------


def run_hierarchical_allreduce(x: torch.Tensor, comm: Communicator, impl: str = "ring",
                               staged_intra: str = "ring", wire: str = "full") -> torch.Tensor:
    """Two-level allreduce over a cartesian communicator (the reference's
    ``allreducep2pHierarchicalImpl``, ``collectives_cuda.cpp:501-581``;
    ``eager.py:922``): pins the ``hier`` plan with the intra transport
    ``impl`` ('xla', 'ring' or 'kernel'), or with ``impl='staged'`` the
    ``staged`` plan with ``staged_intra``. ``wire`` is taken as it is,
    not resolved again. Needs a cartesian communicator with more than
    one group of more than one rank."""
    _check_rank_stacked(x, comm)
    if not (comm.cartesian and comm.has_inter_collective and comm.has_intra_collective):
        raise CollectiveArgumentError(
            "hierarchical allreduce needs a cartesian communicator with "
            "multiple intra groups of size > 1"
        )
    from ..schedule import compiler as _sched

    generator, eff = ("staged", staged_intra) if impl == "staged" else ("hier", impl)
    ep = _sched.compile_collective(
        "allreduce", _global_shape(x, comm), x.dtype, comm, generator=generator, impl=eff,
        wire_override=wire,
    )
    return ep.execute(x.contiguous())


def run_hierarchical_collective(op: str, x: torch.Tensor, comm: Communicator, root: int = 0,
                                ring_impl: str = "ring") -> torch.Tensor:
    """Two-level broadcast, reduce or allgather on a cartesian
    communicator (``collectives_cuda.cpp:501-581,1057-1141``;
    ``eager.py:960``): pins the ``hier`` plan; ``ring_impl`` is the intra
    transport ('ring' or 'kernel')."""
    _check_rank_stacked(x, comm)
    if not (comm.cartesian and comm.has_inter_collective and comm.has_intra_collective):
        raise CollectiveArgumentError(
            "hierarchical collectives need a cartesian communicator with "
            "multiple intra groups of size > 1"
        )
    if op not in ("broadcast", "reduce", "allgather"):
        raise CollectiveArgumentError(
            f"hierarchical collective supports broadcast/reduce/allgather, got {op!r}"
        )
    if op in ("broadcast", "reduce") and not 0 <= root < comm.size:
        raise CollectiveArgumentError(f"root {root} out of range")
    from ..schedule import compiler as _sched

    ep = _sched.compile_collective(
        op, _global_shape(x, comm), x.dtype, comm, root=root, generator="hier", impl=ring_impl,
        wire_override="full",
    )
    return ep.execute(x.contiguous())


def run_tree_hierarchical_allreduce(x: torch.Tensor, comm: Communicator,
                                    wire: str = "full") -> torch.Tensor:
    """Allreduce on a ragged (non-cartesian) communicator (the reference's
    non-cartesian path, ``collectives_cuda.cpp:546-581``; ``eager.py:
    987``): pins the ``tree`` plan, binomial steps and one read of the
    total. A compressed ``wire`` encodes every exchange."""
    _check_rank_stacked(x, comm)
    if not (comm.has_inter_collective and comm.has_intra_collective):
        raise CollectiveArgumentError(
            "hierarchical allreduce needs a communicator with both levels"
        )
    from ..schedule import compiler as _sched

    ep = _sched.compile_collective(
        "allreduce", _global_shape(x, comm), x.dtype, comm, generator="tree", impl="ring",
        wire_override=wire,
    )
    return ep.execute(x.contiguous())


def run_group_broadcast(x: torch.Tensor, comm: Communicator, root: int = 0) -> torch.Tensor:
    """Broadcast within each *intra group* of ``comm`` from the member with
    intra rank ``root`` (``eager.py:1009``): the building block of mixed
    PS x data-parallel updates (``update.lua:104-112``). Each rank's row
    becomes its group root's row, one gather over the rank axis, for
    cartesian and ragged (tree) communicators alike. Across processes each
    of this process's rows is read from its root's row where it lies
    (``Lane.move``: a root's process stages it only for the other
    processes' ranks that take it)."""
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
    if comm.multiprocess:
        return _plane().lane(comm).move(x, src)
    return x.index_select(0, torch.tensor(src, device=x.device))
