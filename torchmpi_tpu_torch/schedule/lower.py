"""Lower compiled plans onto the port's executors.

A :class:`~.ir.Plan` decides *what* schedule runs; this module binds it
to the functions that run it: the hand-written CUDA ring kernels
(``ops``), the ``ring`` backend's hop-by-hop rings and the vendor path in
``collectives/primitives.py``, through the flat kernel table
``collectives.eager._kernels``.

The port of ``torchmpi_tpu/schedule/lower.py``: the flat lowerings
(:func:`lower_flat`, ``lower.py:50``; :func:`lower_fused_flat`, ``:91``),
the two-level cartesian compositions (:func:`lower_hier_allreduce`,
``:203``; :func:`lower_hier_collective`, ``:277``), the host-staged
allreduce (:func:`run_staged_hierarchical_allreduce`, ``:386``) and the
ragged binomial compositions (:func:`lower_tree_allreduce`, ``:563``;
:func:`lower_tree_broadcast`, ``:698``). The JAX lowerings compile an
executable per exact shape; the port binds a function, which the
schedule compiler's dispatch memo keeps per call signature.

A two-level composition runs on the rows permuted into group order
(``concat(comm._groups)``, :func:`_group_major`): intra group g is the
contiguous slab of rows ``[g*I, (g+1)*I)``. On the kernel backend the
intra allreduce (K3), broadcast (K7) and allgather (K3 'ag') are one
launch over every group (the wrappers' ``groups``), each group with the
chunk layout of a ring of I ranks, as the JAX kernel sees the ``intra``
mesh axis of the one program it runs over the (inter, intra) mesh; K4,
K5 and K6 still launch once per group on its ``[I, ...]`` slab
(:func:`_per_group`). The ``ring`` backend runs all groups' rings at once
(``primitives.ring_allreduce(batched=True)``) with the chunk layout and
order of adds of one ring per group.

The algebra-synthesized lowerings (:func:`lower_halve_allreduce`,
``lower.py:770``; :func:`lower_torus_allreduce`, ``:855``;
:func:`lower_striped_allreduce`, ``:899``) keep the JAX order of
operations, so their f32 results equal the JAX lowerings' bit for bit on
any payload. They run on the ``ring`` backend's plain exchanges and
batched rings whatever the request's backend, as the JAX package runs
them on its ppermute rings under ``pallas`` (label ``ring``): a
synthesized plan launches no hand kernel. That is the JAX design, not a
fallback.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import torch

from .. import constants
from ..collectives import primitives as prim


def _eager():
    # late import: eager imports the schedule compiler, which imports this
    from ..collectives import eager

    return eager


def lower_flat(comm, op: str, backend: str, shape: Tuple, dtype, wire: str,
               root: int, src: int, dst: int, pipeline: int = 1):
    """The flat function of ``(op, backend)`` for the payload: the kernel
    table's decisions (the bidirectional ring under
    ``ring_implementation='kernel_bidir'``, the ring tuning, the
    broadcast's tree or pipeline) and the plan's ``pipeline`` depth,
    which the ``ring`` backend's allreduce threads into
    ``primitives.ring_allreduce(pipeline_depth=)`` (bitwise equal at every
    depth). Returns ``(fn, takes_stream)``: ``takes_stream`` when the
    function launches a kernel and takes ``stream=``."""
    nelem = math.prod(shape[1:])
    fn = _eager()._kernels(op, backend, nelem, dtype, comm.device.type, root,
                           src, dst, wire, pipeline=pipeline)
    if comm.multiprocess:
        return _across_flat(comm, op, backend, root, src, dst, fn, wire), backend != "xla"
    return fn, backend == "kernel"


def lower_fused_flat(comm, op: str, backend: str, ns: Tuple[int, ...],
                     dtype, wire: str, pipeline: int = 1):
    """The coalesced flat function: the pack of the ``[p, n_i]`` slabs
    (one ``torch.cat``, which XLA fused into the JAX plan) followed by the
    flat function of the ``[p, sum(n_i)]`` total, bound once per
    ``(op, layout, dtype, routing)`` by the dispatch memo."""
    inner, _ = lower_flat(comm, op, backend, (comm.size, sum(ns)), dtype,
                          wire, 0, 0, 0, pipeline=pipeline)
    return lambda flats: inner(torch.cat(flats, dim=1))


def issue_route(comm, op: str, backend: str, shape: Tuple, dtype,
                wire: str) -> Optional[tuple]:
    """The route of the C++ async issue path (``ops/issue.py``) for a
    flat plan, or None where the Python path issues: an allreduce on a
    CUDA communicator of more than one rank, either on the vendor path
    (``(0, 0, 0, 0)``) or through K3 with the full wire and a dtype the
    kernel adds natively (``(1, dtype code, n, chunk elements)``, unless
    ``ring_implementation`` puts it on the bidirectional ring)."""
    if op != "allreduce" or comm.device.type != "cuda" or comm.size < 2 or comm.multiprocess:
        return None
    if backend == "xla":
        return (0, 0, 0, 0)
    if backend != "kernel" or wire != "full":
        return None
    if constants.get("ring_implementation") == "kernel_bidir":
        return None
    from ..ops import ring_kernels

    n = math.prod(shape[1:])
    if dtype not in ring_kernels.NATIVE_DTYPES or n == 0:
        return None
    return (1, ring_kernels.NATIVE_DTYPES[dtype], n,
            ring_kernels.chunk_elems(n, comm.size, dtype))


# ---------------------------------------------------------------------------
# two-level cartesian compositions
# ---------------------------------------------------------------------------


def _group_major(comm) -> Tuple[Callable, Callable, int, int]:
    """``(to_groups, to_ranks, G, I)`` of a cartesian communicator: the
    rank-stacked rows permuted into group order (``perm =
    concat(comm._groups)``, an ``index_select``) and back through
    ``argsort(perm)``; identities when the groups are contiguous ranks
    (``_hier_compile``, ``lower.py:174``)."""
    perm = [r for g in comm._groups for r in g]
    G, I = len(comm._groups), len(comm._groups[0])
    if perm == list(range(len(perm))):
        return (lambda a: a), (lambda a: a), G, I
    fwd = torch.tensor(perm, device=comm.device)
    inv = torch.argsort(fwd)
    return (lambda a: a.index_select(0, fwd)), (lambda a: a.index_select(0, inv)), G, I


def _per_group(kernel, xg: torch.Tensor, G: int, I: int) -> torch.Tensor:
    """``kernel`` on each group's contiguous ``[I, ...]`` slab of the
    group-major ``xg`` (one launch a group), the outputs stacked in
    group order."""
    return torch.cat([kernel(xg[g * I:(g + 1) * I]) for g in range(G)])


def _intra_rings(fn, xg: torch.Tensor, G: int, I: int) -> torch.Tensor:
    """``fn`` over the G intra rings of I ranks of the group-major
    ``xg``: the rank axis I first, the group as the batch axis."""
    out = fn(xg.reshape((G, I) + tuple(xg.shape[1:])).transpose(0, 1)).transpose(0, 1)
    return out.reshape((G * I,) + tuple(out.shape[2:]))


def _inter_rings(fn, xg: torch.Tensor, G: int, I: int) -> torch.Tensor:
    """``fn`` over the I inter rings of G ranks of the group-major
    ``xg``: the rank axis G first, the intra rank as the batch axis."""
    out = fn(xg.reshape((G, I) + tuple(xg.shape[1:])))
    return out.reshape((G * I,) + tuple(out.shape[2:]))


def _batched_ring(comm, wire: Optional[str], depth: int):
    """The ``ring`` backend's allreduce over B rings at once
    (``primitives.ring_allreduce(batched=True)``) with the platform's ring
    tuning, the wire and a pipeline depth: one level of a two-level
    composition."""
    minb, maxb, nbuf = _eager().ring_tuning(comm.device.type)
    return lambda v: prim.ring_allreduce(
        v, max_bytes_per_step=maxb, min_bytes_per_step=minb, num_buffers=nbuf,
        wire_dtype=wire, pipeline_depth=depth, batched=True)


def _intra_allreduce(n: int, dtype: torch.dtype, wire: Optional[str], G: int, I: int):
    """The intra allreduce of the G groups of I ranks of the group-major
    rows on the kernel backend (``_pallas_intra_ring``, ``lower.py:150``):
    K4 under a compressed wire that engages, else K5 under
    ``ring_implementation='kernel_bidir'`` with the full wire, each one
    launch a group; else K3, one launch over every group. A wire that
    does not engage (an integer payload, a payload under
    ``wire_quant_min_elements``) ships verbatim through K3, as the JAX
    wrapper resolves it. Returns ``fn(xg, **kw)``."""
    from ..ops import ring_kernels

    if wire is not None and prim.wire_engages(wire, dtype, n):
        return lambda xg, **kw: _per_group(
            lambda s: ring_kernels.ring_allreduce_quant(s, wire, **kw), xg, G, I)
    if wire is None and constants.get("ring_implementation") == "kernel_bidir":
        return lambda xg, **kw: _per_group(
            lambda s: ring_kernels.ring_allreduce_bidir(s, **kw), xg, G, I)
    return lambda xg, **kw: ring_kernels.ring_allreduce(xg, groups=G, **kw)


def lower_hier_allreduce(comm, impl: str, shape: Tuple, dtype, wire: str,
                         pipeline: int = 1):
    """Two-level allreduce over a cartesian communicator: a ring within
    each intra group, then a ring across the groups (the reference's
    ``allreducep2pHierarchicalImpl``, ``collectives_cuda.cpp:501-581``;
    ``lower.py:203``). Per ``impl``:

    - ``xla``: the sum within each group, then the sum across groups;
    - ``ring``: the batched ring on the intra level, then on the inter
      level, with the wire and the plan's pipeline depth on both;
    - ``kernel``: the intra phase on the kernels (:func:`_intra_allreduce`:
      K3 one launch over every group), the inter phase the batched
      ``ring`` with the same wire, as the JAX composition runs its
      ppermute ring over the slower fabric.

    Returns ``(fn, takes_stream)``."""
    to_groups, to_ranks, G, I = _group_major(comm)
    n = math.prod(shape[1:])
    wire_arg = None if wire == "full" else wire
    if comm.multiprocess and impl != "xla" and _process_aligned(comm):
        return _across_hier_allreduce(comm, impl, n, dtype, wire_arg, int(pipeline)), True
    if comm.multiprocess and impl == "kernel" and _grouped_k3(n, dtype, wire_arg):
        return _across_grouped_hier_allreduce(comm, wire_arg), True

    if impl == "xla":
        def levels(xg, stream=None):
            v = xg.reshape(G, I, -1)
            total = v.sum(1, dtype=xg.dtype).sum(0, dtype=xg.dtype)
            return total.expand(G * I, -1).reshape(xg.shape)
    elif impl == "ring":
        ring = _batched_ring(comm, wire_arg, int(pipeline))

        def levels(xg, stream=None):
            return _inter_rings(ring, _intra_rings(ring, xg, G, I), G, I)
    else:
        intra = _intra_allreduce(n, dtype, wire_arg, G, I)
        inter = _batched_ring(comm, wire_arg, 1)

        def levels(xg, stream=None):
            kw = {} if stream is None else {"stream": stream}
            return _inter_rings(inter, intra(xg, **kw), G, I)

    def fn(x, stream=None):
        return to_ranks(levels(to_groups(x), stream)).contiguous()

    if comm.multiprocess:
        return across(comm, impl, fn, impl == "kernel"), impl != "xla"
    return fn, impl == "kernel"


def lower_hier_collective(comm, op: str, root: int, ring_impl: str,
                          shape: Tuple, dtype):
    """Two-level broadcast, reduce or allgather on a cartesian
    communicator (``collectives_cuda.cpp:501-581,1057-1141``;
    ``lower.py:277``):

    - broadcast: the inter tree or pipelined ring from the root's group
      (``eager.broadcast_plan``), then the intra broadcast from the
      root's intra rank, one K7 launch over every group on the kernel
      backend;
    - reduce: the intra ring reduce to the root's intra rank (K6 a group
      on the kernel backend), then the inter ring reduce to the root's
      group; every rank but the root keeps its input;
    - allgather: the intra allgather (one K3 'ag' launch over every
      group on the kernel backend), then the inter ring allgather along
      the last dim, the blocks then put from group order into rank
      order.

    ``ring_impl`` picks the intra transport (``ring`` or ``kernel``); the
    inter phase always runs the ``ring`` backend. Returns ``(fn,
    takes_stream)``."""
    from ..ops import ring_kernels

    eager = _eager()
    to_groups, to_ranks, G, I = _group_major(comm)
    platform = comm.device.type
    minb, maxb, nbuf = eager.ring_tuning(platform)
    tuning = dict(max_bytes_per_step=maxb, min_bytes_per_step=minb, num_buffers=nbuf)
    g0 = comm.member(root).intra_group
    i0 = comm.member(root).intra_rank
    kernel_intra = ring_impl == "kernel"

    if op == "broadcast":
        tree, chunks = eager.broadcast_plan(math.prod(shape[1:]), dtype, platform)

        def bcast(r):
            if tree:
                return lambda v: prim.tree_broadcast(v, r)
            return lambda v: prim.ring_broadcast(v, r, num_chunks=chunks)

        def levels(xg, kw):
            y = _inter_rings(bcast(g0), xg, G, I)
            if kernel_intra:
                return ring_kernels.ring_broadcast(y, i0, groups=G, **kw)
            return _intra_rings(bcast(i0), y, G, I)
        post = None
    elif op == "reduce":
        k0 = g0 * I + i0  # the root's row in group order

        def levels(xg, kw):
            if kernel_intra:
                y = _per_group(lambda s: ring_kernels.ring_reduce(s, i0, **kw), xg, G, I)
            else:
                y = _intra_rings(
                    lambda v: prim.ring_reduce(v, i0, batched=True, **tuning), xg, G, I)
            z = _inter_rings(lambda v: prim.ring_reduce(v, g0, batched=True, **tuning), y, G, I)
            out = xg.clone()
            out[k0] = z[k0]
            return out
        post = None
    else:
        p, d = comm.size, int(shape[-1])

        def levels(xg, kw):
            if kernel_intra:
                y = eager._allgather_lastdim(xg, groups=G, **kw)
            else:
                y = _intra_rings(lambda v: prim.ring_allgather(v, dim=-1), xg, G, I)
            return _inter_rings(lambda v: prim.ring_allgather(v, dim=-1), y, G, I)

        order = torch.tensor([r for g in comm._groups for r in g], device=comm.device)
        inv = torch.argsort(order)

        def post(out):
            # the gathered blocks arrive in group order: put them in rank order
            blocks = out.reshape(out.shape[:-1] + (p, d))
            return blocks.index_select(-2, inv).reshape(out.shape)

    def fn(x, stream=None):
        kw = {} if stream is None else {"stream": stream}
        out = to_ranks(levels(to_groups(x), kw))
        return (out if post is None else post(out)).contiguous()

    if comm.multiprocess:
        if op == "broadcast" and kernel_intra and not _process_aligned(comm):
            return _across_grouped_broadcast(comm, g0, i0), True
        return across(comm, ring_impl, fn, kernel_intra), True
    return fn, kernel_intra


# ---------------------------------------------------------------------------
# host-staged inter allreduce
# ---------------------------------------------------------------------------


def run_staged_hierarchical_allreduce(x: torch.Tensor, comm, intra_impl: str = "ring",
                                      wire: str = "full", pipeline: int = 1,
                                      stream=None) -> torch.Tensor:
    """Host-staged cross-group allreduce, the path of
    ``use_staged_collectives`` (``lower.py:386``; the reference's
    ``allreducep2pCrossNodesViaCPU``, ``collectives_cuda.cpp:390-683``,
    for nodes without a direct device link between them):

    1. on the communicator's device, the allreduce within each intra
       group: the batched ``ring`` (with the plan's pipeline depth) or,
       on the kernel backend, :func:`_intra_allreduce` (K3 one launch
       over every group);
    2. on the host, the group sums (each group's first row) copied over
       and added in group order, one row after another (numpy's order
       for the JAX package's ``host.sum(axis=0)``);
    3. the total copied back to every rank.

    The host hop is the designed transport of this path, not a fallback.
    Across processes (``lower.py:472-523``) each process runs step 1 on
    the groups that hold its ranks (across processes where they span
    them), sums the representatives it owns from zeros, and the partials
    meet among the communicator's processes, summed from zeros in process
    order (:func:`_staged_across`)."""
    if comm.multiprocess:
        return _staged_across(x, comm, intra_impl, wire, pipeline, stream)
    to_groups, _, G, I = _group_major(comm)
    n = math.prod(x.shape[1:])
    wire_arg = None if wire == "full" else wire
    xg = to_groups(x)
    if intra_impl == "kernel":
        kw = {} if stream is None else {"stream": stream}
        reduced = _intra_allreduce(n, x.dtype, wire_arg, G, I)(xg, **kw)
    else:
        reduced = _intra_rings(_batched_ring(comm, wire_arg, int(pipeline)), xg, G, I)
    host = reduced[::I].cpu()  # the group representatives: each group's first row
    total = host[0].clone()
    for row in host[1:]:
        total += row
    return total.to(comm.device).expand(x.shape).contiguous()


# ---------------------------------------------------------------------------
# ranks in several processes (runtime/peers.py): a process holds its own
# rows; the plan is the one-process plan of the whole [p, ...]
# ---------------------------------------------------------------------------


def _take_local(comm) -> Callable:
    """The function that takes this process's rows out of a full
    rank-stacked tensor."""
    local = comm.local_ranks
    if local == list(range(local[0], local[0] + len(local))):
        a, b = local[0], local[0] + len(local)
        return lambda full: full[a:b]
    idx = torch.tensor(local, device=comm.device)
    return lambda full: full.index_select(0, idx)


def gather_full(comm, backend: str, x: torch.Tensor, stream=None) -> torch.Tensor:
    """Every rank's rows of ``comm`` from every process: over the control
    plane's gloo group on the vendor path (``xla``), else copied from the
    peers' slabs (the ``ring`` backend's hop across processes)."""
    from ..runtime import peers

    plane = _eager()._plane()
    if backend == "xla":
        return peers.gather_rows_host(plane, comm, x)
    return plane.lane(comm).gather(x, stream)


def across(comm, backend: str, fn: Callable, takes_stream: bool) -> Callable:
    """``fn``, a one-process lowering over the full ``[p, ...]``, run on
    this process's rows: the full tensor gathered (:func:`gather_full`),
    ``fn`` on it, this process's rows of the result. Every process runs
    the same plan on the same rows, so its rows are the one-process
    plan's, bit for bit."""
    take = _take_local(comm)

    def run(x, stream=None):
        full = gather_full(comm, backend, x, stream)
        out = fn(full, stream=stream) if takes_stream and stream is not None else fn(full)
        return take(out).contiguous()

    return run


def _across_flat(comm, op: str, backend: str, root: int, src: int, dst: int, fn: Callable,
                 wire: str = "full") -> Callable:
    """The flat function across processes: on the kernel backend the
    allreduce, the reduce-scatter and the allgather are the cross-process
    K3 in its three modes, or with a compressed ``wire`` the allreduce and
    the reduce-scatter the cross-process K4 in its two, the allreduce
    under ``ring_implementation='kernel_bidir'`` the cross-process K5, the
    reduce the cross-process K6 and the broadcast the cross-process K7,
    which read the rows from the slabs where they lie (the broadcast at
    any size: the binomial tree's hops have no counterpart when the
    root's row is one read away); the eager reduce-scatter scatters and
    the allgather concatenates the last dim, moved to dim 1 around the
    lane as the one-process kernel table moves it
    (``eager._reduce_scatter_lastdim``, ``_allgather_lastdim``). On
    ``ring`` and ``kernel`` the alltoall and the sendreceive copy only
    the blocks or the row that cross from the slabs (``Lane.alltoall``,
    ``Lane.move``). Every other pair runs :func:`across`."""

    def lane():
        return _lane(comm)

    quant = wire != "full"
    if backend != "xla" and op == "alltoall":
        return lambda x, stream=None: lane().alltoall(x, stream)
    if backend != "xla" and op == "sendreceive":
        sources = [src if r == dst else r for r in range(comm.size)]
        return lambda x, stream=None: lane().move(x, sources, stream)
    if backend == "kernel" and op == "allreduce" and quant:
        return lambda x, stream=None: lane().allreduce_quant(x, wire, stream)
    if backend == "kernel" and op == "allreduce":
        if constants.get("ring_implementation") == "kernel_bidir":
            return lambda x, stream=None: lane().allreduce_bidir(x, stream)
        return lambda x, stream=None: lane().allreduce(x, stream)
    if backend == "kernel" and op == "reduce":
        return lambda x, stream=None: lane().reduce(x, root, stream)
    if backend == "kernel" and op == "broadcast":
        return lambda x, stream=None: lane().broadcast(x, root, stream)
    if backend == "kernel" and op == "reducescatter":
        scatter = ((lambda m, stream: lane().reduce_scatter_quant(m, wire, stream)) if quant
                   else (lambda m, stream: lane().reduce_scatter(m, stream)))
        return lambda x, stream=None: scatter(x.movedim(-1, 1).contiguous(), stream).movedim(1, -1)
    if backend == "kernel" and op == "allgather":
        return lambda x, stream=None: _eager()._concat_lastdim(lane().allgather(x, stream), x)
    return across(comm, backend, fn, backend == "kernel")


def _process_aligned(comm) -> bool:
    """True when every intra group's ranks lie in one process (the
    per-node level ``start()`` pushes, or finer splits of it)."""
    return all(len({comm.process_of(r) for r in g}) == 1 for g in comm._groups)


def _local_groups(comm):
    """``(to_groups, to_ranks, G, I)`` of this process's rows: its intra
    groups in group order, as :func:`_group_major` is for every rank."""
    pos = {r: i for i, r in enumerate(comm.local_ranks)}
    groups = [g for g in comm._groups if g[0] in pos]
    perm = [pos[r] for g in groups for r in g]
    G, I = len(groups), len(comm._groups[0])
    if perm == list(range(len(perm))):
        return (lambda a: a), (lambda a: a), G, I
    fwd = torch.tensor(perm, device=comm.device)
    inv = torch.argsort(fwd)
    return (lambda a: a.index_select(0, fwd)), (lambda a: a.index_select(0, inv)), G, I


def _local_intra(comm, impl: str, n: int, dtype: torch.dtype, wire: Optional[str],
                 depth: int) -> Callable:
    """The intra phase on this process's groups: ``fn(x, stream=None)``
    taking its rows in rank order and giving each its group's sum (the
    grouped K3 of :func:`_intra_allreduce`, one launch, or the batched
    ``ring``)."""
    to_groups, to_ranks, G, I = _local_groups(comm)
    if impl == "kernel":
        intra = _intra_allreduce(n, dtype, wire, G, I)

        def run(x, stream=None):
            kw = {} if stream is None else {"stream": stream}
            return to_ranks(intra(to_groups(x), **kw)).contiguous()
    else:
        ring = _batched_ring(comm, wire, depth)

        def run(x, stream=None):
            return to_ranks(_intra_rings(ring, to_groups(x), G, I)).contiguous()
    return run


def _across_hier_allreduce(comm, impl: str, n: int, dtype: torch.dtype,
                           wire: Optional[str], depth: int) -> Callable:
    """:func:`lower_hier_allreduce` across processes whose groups are
    process-aligned: the intra phase on each process's own groups
    (:func:`_local_intra`), then the rows gathered from the slabs and the
    inter rings across the groups, this process's rows kept. The same
    adds as the one-process composition, so the same bits."""
    intra = _local_intra(comm, impl, n, dtype, wire, depth)
    to_groups, to_ranks, G, I = _group_major(comm)
    inter = _batched_ring(comm, wire, 1 if impl == "kernel" else depth)
    take = _take_local(comm)

    def fn(x, stream=None):
        full = gather_full(comm, impl, intra(x, stream), stream)
        return take(to_ranks(_inter_rings(inter, to_groups(full), G, I))).contiguous()

    return fn


def _grouped_k3(n: int, dtype: torch.dtype, wire: Optional[str]) -> bool:
    """Whether the kernel backend's intra allreduce of a two-level
    communicator is K3 (:func:`_intra_allreduce`): the full wire or one
    that does not engage, not ``ring_implementation='kernel_bidir'``. Its
    groups may then span processes (the grouped cross-process K3); K4 and
    K5 launch once a group on a group's own rows, and gather them first."""
    if wire is not None:
        return not prim.wire_engages(wire, dtype, n)
    return constants.get("ring_implementation") != "kernel_bidir"


def _lane(comm):
    return _eager()._plane().lane(comm)


def _across_grouped_hier_allreduce(comm, wire: Optional[str]) -> Callable:
    """:func:`lower_hier_allreduce` on the kernel backend across processes
    whose groups span them: the intra phase the grouped cross-process K3
    (``Lane.allreduce_groups``: each process's launch reads every row of
    each group that holds one of its ranks, where it lies, and writes its
    own rows), then the rows gathered from the slabs and the inter rings
    across the groups, this process's rows kept. The same adds as the
    one-process composition, so the same bits."""
    to_groups, to_ranks, G, I = _group_major(comm)
    inter = _batched_ring(comm, wire, 1)
    take = _take_local(comm)
    groups = [list(g) for g in comm._groups]

    def fn(x, stream=None):
        reduced = _lane(comm).allreduce_groups(x, groups, stream)
        full = gather_full(comm, "kernel", reduced, stream)
        return take(to_ranks(_inter_rings(inter, to_groups(full), G, I))).contiguous()

    return fn


def _across_grouped_broadcast(comm, g0: int, i0: int) -> Callable:
    """:func:`lower_hier_collective`'s broadcast on the kernel backend
    across processes whose groups span them: the inter phase moves root
    group ``g0``'s row of each intra rank to the same intra rank of every
    group (``Lane.move``: plain copies of the rows that cross, as the
    one-process inter broadcast moves bytes), then the intra phase is the
    grouped cross-process K7 from intra rank ``i0`` (``Lane.
    broadcast_groups``: each group's root row read from its owner's slab
    and written to this process's rows of the group)."""
    groups = [list(g) for g in comm._groups]
    src = [groups[g0][comm.member(r).intra_rank] for r in range(comm.size)]

    def fn(x, stream=None):
        lane = _lane(comm)
        return lane.broadcast_groups(lane.move(x, src, stream), groups, i0, stream)

    return fn


def _staged_across(x: torch.Tensor, comm, intra_impl: str, wire: str, pipeline: int,
                   stream) -> torch.Tensor:
    """The staged allreduce across processes (``lower.py:472-523``): the
    intra phase on the groups that hold this process's ranks (the grouped
    cross-process K3 on the kernel backend where the groups span
    processes; else the one-process intra phase on this process's own
    groups, or on the gathered rows), the representatives it owns (each group's
    first rank) summed from zeros in group order, the partials gathered
    among the communicator's processes only (the control plane's exchange
    of that set) and summed from zeros in process order, the total in
    every row."""
    from ..runtime.peers import processes_of

    n = math.prod(x.shape[1:])
    wire_arg = None if wire == "full" else wire
    if _process_aligned(comm):
        reduced = _local_intra(comm, intra_impl, n, x.dtype, wire_arg, int(pipeline))(x, stream)
    elif intra_impl == "kernel" and _grouped_k3(n, x.dtype, wire_arg):
        reduced = _lane(comm).allreduce_groups(x, [list(g) for g in comm._groups], stream)
    else:
        # the one-process intra phase on the gathered rows: K4 or K5 a
        # group on kernel, the batched ring otherwise
        to_groups, to_ranks, G, I = _group_major(comm)
        full = to_groups(gather_full(comm, intra_impl, x, stream))
        if intra_impl == "kernel":
            full = _intra_allreduce(n, x.dtype, wire_arg, G, I)(full)
        else:
            full = _intra_rings(_batched_ring(comm, wire_arg, int(pipeline)), full, G, I)
        reduced = _take_local(comm)(to_ranks(full))
    pos = {r: i for i, r in enumerate(comm.local_ranks)}
    reps = reduced[[pos[g[0]] for g in comm._groups if g[0] in pos]].cpu()
    partial = torch.zeros(x.shape[1:], dtype=x.dtype)
    for row in reps:
        partial = partial + row
    plane = _eager()._plane()
    parts = plane.all_gather_bytes(partial.reshape(-1).view(torch.uint8), processes_of(comm))
    total = torch.zeros(x.shape[1:], dtype=x.dtype)
    for part in parts:
        total = total + part.view(x.dtype).reshape(x.shape[1:])
    return total.to(comm.device).expand(x.shape).contiguous()


# ---------------------------------------------------------------------------
# algebra-synthesized compositions (schedule/algebra.py's enumerator)
# ---------------------------------------------------------------------------


def _pad_flat(flat: torch.Tensor, unit: int) -> Tuple[torch.Tensor, int]:
    """Every rank's flat row of ``flat`` (``[p, n]``) zero-padded to a
    multiple of ``unit`` (``lower.py:755``; zeros quantize and sum
    exactly, so the padding never perturbs a reduced value). Returns
    ``(padded, n)``."""
    n = flat.shape[1]
    unit = max(1, unit)
    return torch.nn.functional.pad(flat, (0, -(-n // unit) * unit - n)), n


def _xor_perm(p: int, d: int) -> list:
    return [(i, i ^ d) for i in range(p)]


def lower_halve_allreduce(comm, shape: Tuple, dtype, wire: str):
    """Recursive-halving reduce-scatter, then recursive-doubling allgather
    over the flat communicator, the ``halve~synth`` plan (``lower.py:770``,
    ``[halve.rs ; halve.ag]``): log2(p) exchange rounds each way. At
    halving distance ``d = p/2 .. 1`` rank r sends the half it does not
    keep to rank ``r xor d`` (``(r & d) == 0`` keeps the lower half) and
    adds the partner's half into the one it keeps; the doubling rounds
    run ``d = 1 .. p/2`` and glue the received segment before or after
    their own, in index order. Each rank's payload is zero-padded to a
    multiple of ``p*block`` under a compressed wire (else of p), so every
    exchanged segment is whole blocks; each hop encodes the whole segment
    from its start and a halving hop's decode-and-add rounds once
    (:func:`~torchmpi_tpu_torch.collectives.primitives.exchange`). As the
    tree lowering, an integer payload ships verbatim. Needs a power-of-two
    world, where the enumerator admits the plan. Returns ``(fn,
    takes_stream)``."""
    p = comm.size
    if p < 2 or p & (p - 1):
        raise ValueError(f"recursive halving needs a power-of-two world, got {p}")
    rounds = p.bit_length() - 1
    wire_arg = None if wire == "full" or dtype != torch.float32 else wire
    block = constants.get("wire_quant_block_size")
    n = math.prod(shape[1:])

    def fn(x, stream=None):
        ranks = torch.arange(p, device=x.device)
        buf, _ = _pad_flat(x.reshape(p, n), p * block if wire_arg else p)
        for k in range(rounds):  # halving RS: d = p/2 .. 1
            d = p >> (k + 1)
            half = buf.shape[1] // 2
            keep_lower = ((ranks & d) == 0)[:, None]
            lower, upper = buf[:, :half], buf[:, half:]
            sent = torch.where(keep_lower, upper, lower)
            kept = torch.where(keep_lower, lower, upper)
            buf = prim.exchange(sent, _xor_perm(p, d), wire_arg, block, local=kept)
        for k in range(rounds):  # doubling AG: d = 1 .. p/2
            d = 1 << k
            recv = prim.exchange(buf, _xor_perm(p, d), wire_arg, block)
            keep_lower = ((ranks & d) == 0)[:, None]
            buf = torch.where(keep_lower, torch.cat([buf, recv], 1), torch.cat([recv, buf], 1))
        return buf[:, :n].reshape(x.shape).contiguous()

    return fn, False


def lower_torus_allreduce(comm, shape: Tuple, dtype, wire: str, pipeline: int = 1):
    """2D torus allreduce on a cartesian communicator, the ``torus~synth``
    plan (``lower.py:855``, ``[scatter.ring(intra) ; ring(inter) ;
    gather.ring(intra)]``): on the group-major rows, each rank's payload
    zero-padded to a multiple of ``s*block`` under a compressed wire (else
    of s, the intra size), the batched reduce-scatter over every intra
    ring (the wire on each hop), the batched ring allreduce of each 1/s
    shard over every inter ring (the ring tuning, the wire and the plan's
    pipeline depth), and the batched allgather over every intra ring.
    Returns ``(fn, takes_stream)``."""
    to_groups, to_ranks, G, I = _group_major(comm)
    wire_arg = None if wire == "full" else wire
    block = constants.get("wire_quant_block_size")
    ring = _batched_ring(comm, wire_arg, int(pipeline))
    n = math.prod(shape[1:])

    def scatter(v):
        return prim.ring_reduce_scatter(v, dim=-1, wire_dtype=wire_arg, wire_block=block,
                                        batched=True)

    def gather(v):
        return prim.ring_allgather(v, dim=-1, batched=True)

    def fn(x, stream=None):
        flat, _ = _pad_flat(to_groups(x).reshape(G * I, n), I * block if wire_arg else I)
        shard = _inter_rings(ring, _intra_rings(scatter, flat, G, I), G, I)
        full = _intra_rings(gather, shard, G, I)
        return to_ranks(full[:, :n]).reshape(x.shape).contiguous()

    return fn, False


def lower_striped_allreduce(comm, shape: Tuple, dtype, wire: str, pipeline: int = 1):
    """Striped allreduce on a cartesian communicator, the ``stripe~synth``
    plan (``lower.py:899``, ``stripe(2)∘[[ring(intra) ; ring(inter)] ||
    [ring(inter) ; ring(intra)]]``): each rank's payload zero-padded to a
    multiple of ``2*block`` under a compressed wire (else of 2) and cut in
    halves; the lower half runs the batched intra rings, then the inter
    rings, the upper half the inter rings, then the intra rings, so the
    two fabrics' phases run in opposite order. Every ring takes the ring
    tuning, the wire and the plan's pipeline depth, as the hierarchical
    lowering's. Returns ``(fn, takes_stream)``."""
    to_groups, to_ranks, G, I = _group_major(comm)
    wire_arg = None if wire == "full" else wire
    block = constants.get("wire_quant_block_size")
    ring = _batched_ring(comm, wire_arg, int(pipeline))
    n = math.prod(shape[1:])

    def fn(x, stream=None):
        flat, _ = _pad_flat(to_groups(x).reshape(G * I, n), 2 * block if wire_arg else 2)
        half = flat.shape[1] // 2
        lo = _inter_rings(ring, _intra_rings(ring, flat[:, :half], G, I), G, I)
        hi = _intra_rings(ring, _inter_rings(ring, flat[:, half:], G, I), G, I)
        return to_ranks(torch.cat([lo, hi], 1)[:, :n]).reshape(x.shape).contiguous()

    return fn, False


# ---------------------------------------------------------------------------
# ragged (non-cartesian) compositions
# ---------------------------------------------------------------------------


def _binomial_reduce_steps(groups, p: int) -> List[List[Tuple[int, int]]]:
    """The (src, dst) pairs of each step of a binomial reduction to each
    group's first member (``lower.py:541``): member j at span s receives
    from j + s when j % 2s == 0. ``log2(max group)`` steps; every value
    is added exactly once. (The JAX schedule's receive mask is the set of
    dsts.)"""
    steps = []
    span = 1
    while True:
        pairs = [(g[j + span], g[j]) for g in groups
                 for j in range(0, len(g), 2 * span) if j + span < len(g)]
        if not pairs:
            break
        steps.append(pairs)
        span *= 2
    return steps


def _binomial_fanout_steps(root: int, targets, p: int) -> List[List[Tuple[int, int]]]:
    """The (src, dst) pairs of each round delivering ``root``'s block to
    every rank of ``targets`` (``lower.py:675``): each round every holder
    forwards to one pending target, so the holders double and the depth
    is ``ceil(log2(len(targets) + 1))``."""
    pending = [t for t in targets if t != root]
    holders = [root]
    steps = []
    while pending:
        pairs = []
        for h in holders:
            if not pending:
                break
            pairs.append((h, pending.pop(0)))
        holders = holders + [d for _, d in pairs]
        steps.append(pairs)
    return steps


def _index_pairs(steps, device) -> list:
    return [(torch.tensor([s for s, _ in pairs], device=device),
             torch.tensor([d for _, d in pairs], device=device)) for pairs in steps]


def lower_tree_allreduce(comm, shape: Tuple, dtype, wire: str, pipeline: int = 1):
    """Allreduce on a ragged (non-cartesian) communicator
    (``lower.py:563``; the reference's non-cartesian path,
    ``collectives_cuda.cpp:546-581``): a binomial reduction within each
    group to its first member, one across the group roots to the global
    root, then every rank reads the global root's total. Each step is an
    indexed gather of the senders' rows and an add into the receivers',
    in the JAX schedule's order. A compressed ``wire`` encodes every
    exchange (f32 adds); the final read ships the total verbatim. A
    pipeline depth > 1 cuts each rank's buffer into that many
    block-aligned sub-buffers, each encoded on its own: the same block
    grid, so the same bits. Runs on the ``ring`` backend, as in JAX.
    Returns ``(fn, takes_stream)``."""
    p = comm.size
    groups = [list(g) for g in comm._groups]
    roots = [g[0] for g in groups]
    steps = _index_pairs(
        _binomial_reduce_steps(groups, p) + _binomial_reduce_steps([roots], p), comm.device)
    n = math.prod(shape[1:])
    # the JAX composition encodes every f32 exchange under a compressed
    # wire, below wire_quant_min_elements too; integer payloads stay exact
    wire_arg = None if wire == "full" or dtype != torch.float32 else wire
    block = constants.get("wire_quant_block_size")
    depth = max(1, int(pipeline))
    sub = n
    if depth > 1:
        sub = -(-n // depth)
        if wire_arg:
            sub = -(-sub // block) * block
        sub = max(1, sub)
    d = max(1, -(-n // sub))

    def fn(x, stream=None):
        flat = torch.nn.functional.pad(x.reshape(p, n), (0, d * sub - n))
        segs = flat.reshape(p, d, sub)
        for src, dst in steps:
            segs[dst] = prim.wire_transfer(segs[src], wire_arg, block, segs[dst])
        total = segs[roots[0]].reshape(-1)[:n]
        return total.expand(p, n).reshape(x.shape).contiguous()

    return fn, False


def lower_tree_broadcast(comm, root: int, shape: Tuple, dtype):
    """Broadcast on a ragged communicator (``lower.py:698``): a binomial
    fan-out of the root's block to every other group's first member,
    then every member reads its group's first member (the root's own
    group reads the root). Data movement only, on the ``ring`` backend.
    Returns ``(fn, takes_stream)``."""
    p = comm.size
    groups = [list(g) for g in comm._groups]
    g_root = next(g for g in groups if root in g)
    targets = [g[0] for g in groups if g is not g_root]
    steps = _index_pairs(_binomial_fanout_steps(root, targets, p), comm.device)
    src = [0] * p
    for g in groups:
        for r in g:
            src[r] = root if g is g_root else g[0]
    gather = torch.tensor(src, device=comm.device)

    def fn(x, stream=None):
        b = x.clone()
        for s, dst in steps:
            b[dst] = b[s]
        return b.index_select(0, gather)

    return fn, False
