"""NN integration: parameter and gradient synchronization.

The port of the eager half of ``torchmpi_tpu/nn/__init__.py``
(``torchmpi/nn.lua``). A parameter or gradient "tree" is a dict of
rank-stacked tensors (name -> ``[p, ...]``, rank r's values at index r),
the port's counterpart of a rank-stacked pytree.

- :func:`synchronize_parameters` — one-shot sync before training:
  broadcast from ``root``, or allreduce and divide (``nn.lua:32-46``).
- :func:`synchronize_gradients` — sum-allreduce every gradient
  (``nn.lua:49-56``); ``average=True`` divides by the world size, and
  ``wire_dtype`` picks the wire of the kernel ring.
- :class:`GradientBuckets` — the leaves cut into buckets of about equal
  size (``BlockSequential.lua:29-89``), one async allreduce per bucket,
  waited in reverse order (``nn.lua:207-212``); ``sync_scheduled`` runs
  them under the overlap scheduler (``schedule/overlap.py``).
- :func:`check_with_allreduce` — the replica-consistency invariant
  (``init.lua:372-395``).

- the in-graph variants, the syncs a strategy's step makes over one
  named axis of a :class:`~torchmpi_tpu_torch.parallel.MeshLayout`
  (``nn/__init__.py:467-565``, psums inside ``shard_map`` in JAX):
  :func:`in_graph_synchronize_gradients` (one
  :func:`~torchmpi_tpu_torch.parallel.axis_psum`, the grouped ring
  kernel K3, a leaf), ``_flat`` (one a dtype), ``_bucketed`` (one a
  bucket and dtype; a compressed wire through the plain ring,
  ``collectives.primitives.ring_allreduce(wire_dtype=)``, as in JAX) and
  :func:`in_graph_synchronize_parameters` (a masked psum from ``root``).
  They call the kernel wrapper directly, not the selector; the engine's
  own sync is the eager path above.

Leaves are taken in sorted-name order, the order in which
``jax.tree_util`` flattens a dict, so the buckets are the JAX package's.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence

import torch

from .. import collectives, constants
from ..collectives import eager
from ..collectives import primitives as _prim
from ..collectives.axis import axis_groups, axis_psum, axis_rank, from_axis_groups
from ..ops.ring_kernels import row_scale
from ..runtime.communicator import Communicator
from ..runtime.handles import SyncHandle

Tree = Dict[str, torch.Tensor]


def _comm(comm: Optional[Communicator]) -> Communicator:
    if comm is not None:
        return comm
    from .. import runtime_state

    return runtime_state.current_communicator()


def _fused_apply(tree: Tree, p: int, sync_one: Callable) -> Tree:
    """Apply ``sync_one`` to one fused ``[p, total]`` buffer per dtype
    (``nn/__init__.py:58``): O(#dtypes) collectives, integer leaves exact."""
    by_dtype: Dict[torch.dtype, list] = {}
    for name, leaf in tree.items():
        by_dtype.setdefault(leaf.dtype, []).append(name)
    out = dict(tree)
    for names in by_dtype.values():
        buf = sync_one(torch.cat([tree[k].reshape(p, -1) for k in names], dim=1))
        off = 0
        for k in names:
            n = tree[k][0].numel()
            out[k] = buf[:, off : off + n].reshape(tree[k].shape)
            off += n
    return out


def synchronize_parameters(
    params: Tree,
    comm: Optional[Communicator] = None,
    with_allreduce: bool = False,
    root: int = 0,
    fused: bool = True,
) -> Tree:
    """Make every rank's parameters identical: broadcast from ``root`` or
    allreduce and divide by size (``nn.lua:32-46``)."""
    comm = _comm(comm)
    p = comm.size

    def sync_one(buf):
        if with_allreduce:
            return collectives.allreduce_tensor(buf, comm=comm) / p
        return collectives.broadcast_tensor(buf, root=root, comm=comm)

    if fused:
        return _fused_apply(params, p, sync_one)
    return {k: sync_one(v) for k, v in params.items()}


def synchronize_gradients(
    grads: Tree,
    comm: Optional[Communicator] = None,
    average: bool = False,
    fused: bool = True,
    wire_dtype: Optional[str] = None,
) -> Tree:
    """Sum-allreduce every gradient (``nn.lua:49-56``); ``average=True``
    divides by the world size. ``wire_dtype`` ('full' | 'bf16' | 'int8';
    None = the constant) picks the wire of the kernel ring: int8 ships
    block-quantized values and sums in f32, only for f32 buffers above the
    cutoff; integer leaves always travel exactly. ``fused=True`` goes
    through the communicator's
    :class:`~torchmpi_tpu_torch.collectives.FusionBuffer` (when
    ``fusion_buffer_bytes`` > 0): one allreduce per dtype group of a flat
    ``[p, total]`` buffer."""
    comm = _comm(comm)
    p = comm.size

    def finish(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return (buf / p).to(like.dtype) if average else buf

    def allreduce(buf: torch.Tensor) -> torch.Tensor:
        return collectives.allreduce_tensor(buf, comm=comm, wire_dtype=wire_dtype)

    if fused:
        if constants.get("fusion_buffer_bytes") > 0:
            fb = collectives.get_fusion_buffer(comm)
            handles = {
                k: fb.submit("allreduce", g, wire_dtype=wire_dtype)
                for k, g in grads.items()
            }
            fb.flush_for(handles.values())
            return {k: finish(h.wait(), grads[k]) for k, h in handles.items()}
        return _fused_apply(grads, p, lambda buf: finish(allreduce(buf), buf))
    return {k: finish(allreduce(g), g) for k, g in grads.items()}


class GradientBuckets:
    """The leaves of a parameter dict cut into ``num_buckets`` buckets of
    about equal element count, in reverse leaf order (``nn/__init__.py:
    185``): gradients become ready last layer first, so bucket 0's
    collective can go first (``BlockSequential.lua:114-151``). The JAX
    package packs each bucket into a persistent donated buffer; here a
    bucket is packed with one ``torch.cat`` per launch."""

    def __init__(self, params_template: Tree, num_buckets: int):
        # sorted names: jax.tree_util's leaf order for a dict
        self.names = sorted(params_template)
        leaves = [params_template[k] for k in self.names]
        self.sizes = [v.numel() for v in leaves]
        self.dtypes = [v.dtype for v in leaves]
        total = sum(self.sizes)
        num_buckets = max(1, min(num_buckets, len(leaves)))
        target = total / num_buckets
        # greedy contiguous partition over reversed leaf order
        self.buckets: List[List[int]] = [[]]
        acc = 0
        for idx in reversed(range(len(leaves))):
            if acc >= target and len(self.buckets) < num_buckets and self.buckets[-1]:
                self.buckets.append([])
                acc = 0
            self.buckets[-1].append(idx)
            acc += self.sizes[idx]
        self.num_buckets = len(self.buckets)
        # error-feedback residuals (wire_error_feedback), one per bucket
        # and wire grid: flush k's quantization error is added back before
        # flush k+1 is quantized (1-bit SGD / QSGD lineage)
        self._residuals: Dict[tuple, torch.Tensor] = {}
        self._launch_comm: Optional[Communicator] = None

    def bucket_leaves(self, tree: Tree, b: int) -> List[torch.Tensor]:
        return [tree[self.names[i]] for i in self.buckets[b]]

    def bucket_dtype(self, b: int) -> torch.dtype:
        """The dtype bucket ``b`` ships in: the promotion of its leaves'."""
        return functools.reduce(torch.promote_types, [self.dtypes[i] for i in self.buckets[b]])

    def pack(self, tree: Tree, b: int, p: int) -> torch.Tensor:
        """Bucket ``b``'s rank-stacked leaves as one flat ``[p, total]``
        buffer of :meth:`bucket_dtype`, in bucket order."""
        dtype = self.bucket_dtype(b)
        return torch.cat([v.reshape(p, -1).to(dtype) for v in self.bucket_leaves(tree, b)], dim=1)

    def _error_feedback(self, b: int, buf: torch.Tensor,
                        wire_dtype: Optional[str]) -> torch.Tensor:
        """Error-feedback encode of one packed bucket (``nn/__init__.py:
        280``): add the stored residual, quantize and dequantize on the
        wire's grid (per rank row, ``wire_quant_block_size`` blocks for
        int8; a bf16 round trip for bf16), store the new residual and ship
        the quantized values. The wire requantizes them exactly on its
        first hop, so the residual is the true compression error. A no-op
        whenever the wire would not engage."""
        p, n = buf.shape
        wire = eager.resolve_wire_dtype("allreduce", n, buf.dtype, wire_dtype)
        if wire not in ("int8", "bf16"):
            return buf
        block = constants.get("wire_quant_block_size")
        key = (b, p, n, wire, block)
        res = self._residuals.pop(key, None)
        comp = buf + (torch.zeros_like(buf) if res is None else res)
        if wire == "bf16":
            qv = comp.to(torch.bfloat16).to(torch.float32)
            self._residuals[key] = comp - qv
            return qv
        blocks = torch.nn.functional.pad(comp, (0, -n % block)).reshape(p, -1, block)
        scale = row_scale(blocks)
        q = torch.round(blocks / scale)
        # XLA fuses the JAX residual, comp - q * scale, into one FMA; in f64
        # the product and the difference are exact, so one rounding to f32
        # gives the same bits
        res = blocks.double() - q.double() * scale.double()
        self._residuals[key] = res.float().reshape(p, -1)[:, :n]
        return (q * scale).reshape(p, -1)[:, :n]

    def allreduce_async(
        self,
        grads: Tree,
        comm: Optional[Communicator] = None,
        backend: Optional[str] = None,
        wire_dtype: Optional[str] = None,
    ) -> List[SyncHandle]:
        """Launch one async allreduce per bucket; returns the handles in
        launch order (wait them in reverse, ``nn.lua:207-212``).
        ``backend`` pins the backend (default: the selector's async
        choice); ``wire_dtype`` is each bucket's wire
        (:func:`synchronize_gradients`)."""
        comm = _comm(comm)
        handles = []
        for b in range(self.num_buckets):
            buf = self.pack(grads, b, comm.size)
            if constants.get("wire_error_feedback"):
                buf = self._error_feedback(b, buf, wire_dtype)
            handles.append(
                collectives._dispatch(
                    "allreduce", buf, comm, "async", backend, wire_dtype=wire_dtype
                )
            )
        # the divisor of wait_and_unflatten's average defaults to this size
        self._launch_comm = comm
        return handles

    def sync_scheduled(
        self,
        grads: Tree,
        comm: Optional[Communicator] = None,
        backend: Optional[str] = None,
        wire_dtype: Optional[str] = None,
        average: bool = False,
        schedule: Optional[str] = None,
        tag: str = "grads",
    ) -> Tree:
        """Synchronous bucketed allreduce under the overlap scheduler
        (:mod:`torchmpi_tpu_torch.schedule.overlap`, ``nn/__init__.py:
        401``): ``schedule='reverse'`` dispatches every bucket async in
        reverse-layer order before any wait, ``'none'`` packs every bucket
        first, then dispatches and waits them one by one; None reads the
        ``overlap_schedule`` constant. The same collectives either way, so
        the results are bitwise identical. ``tag`` names the flush in its
        flight entries."""
        from ..schedule import overlap as _overlap

        return _overlap.run_bucketed_sync(
            self, grads, _comm(comm), backend=backend, wire_dtype=wire_dtype,
            average=average, schedule=schedule, tag=tag,
        )

    def wait_and_unflatten(
        self,
        grads: Tree,
        handles: Sequence[SyncHandle],
        average: bool = False,
        comm: Optional[Communicator] = None,
    ) -> Tree:
        """Wait the handles in reverse order and scatter the results back
        into the tree. ``average`` divides by the size of ``comm``, by
        default the communicator the matching :meth:`allreduce_async`
        launched on."""
        p = _comm(comm if comm is not None else self._launch_comm).size
        results: List[Optional[torch.Tensor]] = [None] * len(handles)
        for b in range(len(handles) - 1, -1, -1):
            results[b] = handles[b].wait()
        return self.unflatten_results(grads, results, average=average, p=p)

    def unflatten_results(self, grads: Tree, results: Sequence[torch.Tensor],
                          average: bool = False, p: int = 1) -> Tree:
        """Scatter per-bucket reduced ``[p, total]`` buffers back into the
        tree (``average`` divides by ``p``)."""
        out = dict(grads)
        for b, buf in enumerate(results):
            if average:
                buf = buf / p
            off = 0
            for i in self.buckets[b]:
                name = self.names[i]
                shape = grads[name].shape  # rank-stacked [p, ...]
                n = grads[name][0].numel()
                out[name] = buf[:, off : off + n].reshape(shape)
                off += n
        return out


# ---------------------------------------------------------------------------
# in-graph variants: the syncs over one named axis of a strategy's mesh
# ---------------------------------------------------------------------------


def in_graph_synchronize_gradients(grads: Tree, layout, axis: str = "mpi",
                                   average: bool = True) -> Tree:
    """Sum every rank-stacked leaf over ``layout``'s ``axis``, one
    :func:`~torchmpi_tpu_torch.parallel.axis_psum` (K3) a leaf, and divide
    by the axis size when ``average`` (``nn/__init__.py:467``)."""
    n = layout.size(axis)
    summed = {k: axis_psum(g, layout, axis) for k, g in grads.items()}
    return {k: g / n for k, g in summed.items()} if average else summed


def _flat_sync(leaves: Dict[str, torch.Tensor], names: Sequence[str], sync_one: Callable,
               out: Tree) -> None:
    """Pack ``names``' rank-stacked leaves (one dtype) into one ``[p,
    total]`` buffer, sync it, and cut the results back into ``out``."""
    p = leaves[names[0]].shape[0]
    buf = sync_one(torch.cat([leaves[k].reshape(p, -1) for k in names], dim=1))
    off = 0
    for k in names:
        n = leaves[k][0].numel()
        out[k] = buf[:, off:off + n].reshape(leaves[k].shape)
        off += n


def _axis_sync(layout, axis: str, average: bool, wire_dtype: Optional[str] = None) -> Callable:
    """Sync one packed ``[p, n]`` buffer over ``axis``: the compressed-wire
    ring where ``wire_dtype`` engages (the axis groups as the batched rings
    of ``primitives.ring_allreduce``), else one ``axis_psum``; divided by
    the axis size in the buffer's dtype when ``average``."""
    size = layout.size(axis)

    def sync_one(buf: torch.Tensor) -> torch.Tensor:
        if _prim.wire_engages(wire_dtype, buf.dtype, buf.shape[1]):
            rings = axis_groups(buf, layout, axis).transpose(0, 1)
            out = _prim.ring_allreduce(rings, wire_dtype=wire_dtype, batched=True)
            summed = from_axis_groups(out.transpose(0, 1), layout, axis)
        else:
            summed = axis_psum(buf, layout, axis)
        return (summed / size).to(buf.dtype) if average else summed

    return sync_one


def in_graph_synchronize_gradients_flat(grads: Tree, layout, axis: str = "mpi",
                                        average: bool = True) -> Tree:
    """One :func:`~torchmpi_tpu_torch.parallel.axis_psum` over a flat
    buffer per dtype instead of one a leaf (``nn/__init__.py:477``): the
    same sums, O(#dtypes) launches; integer leaves stay exact."""
    by_dtype: Dict[torch.dtype, list] = {}
    for k in sorted(grads):
        by_dtype.setdefault(grads[k].dtype, []).append(k)
    out = dict(grads)
    sync_one = _axis_sync(layout, axis, average)
    for names in by_dtype.values():
        _flat_sync(grads, names, sync_one, out)
    return out


def in_graph_synchronize_gradients_bucketed(grads: Tree, buckets: "GradientBuckets", layout,
                                            axis: str = "mpi", average: bool = True,
                                            wire_dtype: Optional[str] = None) -> Tree:
    """One sync per bucket and dtype (``nn/__init__.py:506``): a flat
    buffer each, through :func:`~torchmpi_tpu_torch.parallel.axis_psum`,
    or, where ``wire_dtype`` ('bf16' | 'int8') engages (f32 buffers at or
    above ``wire_quant_min_elements`` a rank), through the
    compressed-wire ring of ``collectives.primitives.ring_allreduce``."""
    out = dict(grads)
    sync_one = _axis_sync(layout, axis, average, wire_dtype)
    for b in range(buckets.num_buckets):
        by_dtype: Dict[torch.dtype, list] = {}
        for i in buckets.buckets[b]:
            name = buckets.names[i]
            by_dtype.setdefault(grads[name].dtype, []).append(name)
        for names in by_dtype.values():
            _flat_sync(grads, names, sync_one, out)
    return out


def in_graph_synchronize_parameters(params: Tree, layout, axis: str = "mpi",
                                    root: int = 0) -> Tree:
    """Every rank of an ``axis`` group gets the parameters of the group's
    rank at coordinate ``root`` (``nn/__init__.py:544``): a psum of the
    leaves masked to that rank."""
    out = {}
    for k, w in params.items():
        mine = axis_rank(layout, axis, w.device, w.shape[1:]) == root
        out[k] = axis_psum(torch.where(mine, w, torch.zeros_like(w)), layout, axis)
    return out


def check_with_allreduce(
    params: Tree, comm: Optional[Communicator] = None, tol: float = 1e-7
) -> None:
    """Assert replicas are consistent: for each rank, the allreduced
    |mean| and |var| of its flattened parameters must equal size times its
    own (``init.lua:387-394``). Cheap, and catches desync bugs early."""
    comm = _comm(comm)
    p = comm.size
    buf = torch.cat(
        [v.reshape(p, -1).to(torch.float32) for v in params.values()], dim=1
    )
    stats = torch.stack(
        [buf.mean(dim=1).abs(), buf.var(dim=1, correction=0).abs()], dim=1
    )
    reduced = collectives.allreduce_tensor(stats, comm=comm)
    local = stats.cpu()
    err = float((reduced.cpu() / p - local).abs().max())
    if err > tol * max(1.0, float(local.abs().max())):
        raise AssertionError(
            f"replica desync detected: |allreduce/p - local| = {err:.3e} "
            f"(tol {tol})"
        )
