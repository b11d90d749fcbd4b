"""Collectives over one named axis of the virtual ranks.

The port's counterpart of the ``lax`` collectives that the JAX strategies
(``parallel/tp.py``, ``pp.py``, ``ep.py``) and the ``in_graph_*``
gradient syncs call inside ``shard_map``: ``psum``, ``pmean``,
``ppermute`` and ``all_to_all`` over a mesh axis. Here every tensor is
rank-stacked, ``x[r]`` rank r's value, and a
:class:`~torchmpi_tpu_torch.parallel.MeshLayout` names the axes. They sit
here, beside the other collectives, because both the strategies
(``parallel``) and the gradient syncs (``nn``) call them.

- :func:`axis_groups` gives the rows as ``[p // size, size, ...]``, one
  group of ``axis`` a row of the leading dim (one ``index_select`` that
  makes the axis innermost; none for the innermost axis), and
  :func:`from_axis_groups` puts them back in rank order.

- :func:`axis_psum` sums over each group of ranks that differ only in
  ``axis``: the rows in :func:`axis_groups` order are summed by the
  grouped ring kernel K3, ``ops.ring_allreduce(rows, groups=p // size)``, one
  launch over every group, and permuted back. A CPU tensor takes K3's
  plain version, as every kernel wrapper does. It calls the kernel
  wrapper itself, not the selector: the JAX strategies' psums are
  in-graph, where the engine's eager sync is routed.
- :func:`axis_pmean` is that sum divided by the axis size.
- :func:`axis_ppermute` rolls the rows along the axis (no TPU kernel
  computes it: plain torch, as ``collectives/primitives.py:_shift``).
- :func:`axis_all_to_all` is the block transpose of ``lax.all_to_all``
  (split and concat on the block axis, tiled) within each group.

Gradients are the transposes JAX takes under ``check_vma=False``, the
setting of every JAX caller here: psum's is the psum of the cotangents
(an autograd function whose backward launches K3 again), the roll's the
opposite roll and the block transpose's itself (torch's own autograd of
those ops). A loss that is one value a rank, ``[p]``, then gives every
rank JAX's in-graph gradient under ``loss.sum().backward()``: the sum
gives each lane cotangent 1, as ``shard_map(grad(f))`` does.
"""

from __future__ import annotations

from functools import lru_cache
from typing import TYPE_CHECKING, Tuple

import torch

from ..ops import ring_kernels

if TYPE_CHECKING:
    from ..parallel.mesh import MeshLayout


def _check(x: torch.Tensor, layout: MeshLayout, what: str) -> None:
    if x.ndim < 1 or x.shape[0] != layout.num_ranks:
        raise ValueError(
            f"{what} expects a rank-stacked [{layout.num_ranks}, ...] tensor, got "
            f"{tuple(x.shape)}")


@lru_cache(maxsize=None)
def _orders(layout: MeshLayout, axis: str, device: torch.device):
    """The innermost permutation of ``axis`` and its inverse as index
    tensors on ``device`` (None when the axis is innermost already)."""
    order, inverse = layout.innermost(axis)
    if order is None:
        return None, None
    return torch.as_tensor(order, device=device), torch.as_tensor(inverse, device=device)


def axis_rank(layout: MeshLayout, axis: str, device, shape: Tuple[int, ...] = ()) -> torch.Tensor:
    """Each rank's coordinate along ``axis`` as a ``[p, 1, ...]`` int64
    tensor that broadcasts against ``[p, *shape]`` (``lax.axis_index``)."""
    index = torch.as_tensor(layout.axis_index(axis), device=device)
    return index.reshape((-1,) + (1,) * len(shape))


def axis_groups(x: torch.Tensor, layout: MeshLayout, axis: str) -> torch.Tensor:
    """The rank-stacked ``x`` as ``[p // size, size, *x.shape[1:]]``: entry
    ``[g, c]`` is the rank at coordinate c of ``axis`` group g (contiguous;
    a view of ``x`` when the axis is innermost)."""
    order, _ = _orders(layout, axis, x.device)
    rows = x.contiguous() if order is None else x.index_select(0, order)
    return rows.reshape((-1, layout.size(axis)) + x.shape[1:])


def from_axis_groups(g: torch.Tensor, layout: MeshLayout, axis: str) -> torch.Tensor:
    """The inverse of :func:`axis_groups`: ``[p // size, size, ...]`` back
    to rank-stacked ``[p, ...]`` in rank order."""
    rows = g.reshape((layout.num_ranks,) + g.shape[2:])
    _, inverse = _orders(layout, axis, g.device)
    return rows if inverse is None else rows.index_select(0, inverse)


def _psum(x: torch.Tensor, layout: MeshLayout, axis: str) -> torch.Tensor:
    g = axis_groups(x, layout, axis)
    out = ring_kernels.ring_allreduce(g.reshape(x.shape), groups=g.shape[0])
    return from_axis_groups(out.reshape(g.shape), layout, axis)


class _AxisPsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, axis):
        ctx.layout, ctx.axis = layout, axis
        return _psum(x, layout, axis)

    @staticmethod
    def backward(ctx, grad):
        # check_vma=False: psum's transpose psums the per-rank cotangents
        return _psum(grad, ctx.layout, ctx.axis), None, None


def axis_psum(x: torch.Tensor, layout: MeshLayout, axis: str) -> torch.Tensor:
    """Sum the rank-stacked ``x`` over ``axis`` (``lax.psum``): every rank
    gets the sum over its group, through one grouped K3 launch."""
    _check(x, layout, "axis_psum")
    if layout.size(axis) == 1:
        return x
    return _AxisPsum.apply(x, layout, axis)


def axis_pmean(x: torch.Tensor, layout: MeshLayout, axis: str) -> torch.Tensor:
    """:func:`axis_psum` divided by the axis size (``lax.pmean``)."""
    return axis_psum(x, layout, axis) / layout.size(axis)


def _grid(x: torch.Tensor, layout: MeshLayout) -> torch.Tensor:
    return x.reshape(layout.shape + x.shape[1:])


def axis_ppermute(x: torch.Tensor, layout: MeshLayout, axis: str, shift: int) -> torch.Tensor:
    """Rank at coordinate ``c`` along ``axis`` gets the value of the rank at
    ``c - shift`` (``lax.ppermute`` with the pairs ``(i, (i + shift) %
    size)``): a roll of the rows along the axis. Its gradient is the
    opposite roll."""
    _check(x, layout, "axis_ppermute")
    return torch.roll(_grid(x, layout), shift, dims=layout.dim(axis)).reshape(x.shape)


def axis_all_to_all(x: torch.Tensor, layout: MeshLayout, axis: str) -> torch.Tensor:
    """``x`` is ``[p, size, ...]``: ``x[r, j]`` is rank r's block for the
    rank at coordinate j of its ``axis`` group. Rank r gets ``[x[s_j, c]
    for j]``, ``s_j`` the rank at coordinate j of its group and ``c`` its
    own coordinate (``lax.all_to_all`` with ``split_axis=concat_axis=0``,
    tiled, on ``x[r]``). Its own transpose."""
    _check(x, layout, "axis_all_to_all")
    size = layout.size(axis)
    if x.ndim < 2 or x.shape[1] != size:
        raise ValueError(
            f"axis_all_to_all expects [p, {size}, ...] blocks over axis {axis!r}, got "
            f"{tuple(x.shape)}")
    grid = _grid(x, layout)
    return grid.transpose(layout.dim(axis), len(layout.shape)).reshape(x.shape)
