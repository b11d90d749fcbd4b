"""The per-rank products of the engine's vmap on the card, taken by the
hand-written per-rank kernels (ROADMAP C6).

Under ``torch.func.vmap`` a layer of rank-stacked weights becomes one
batched op over the ranks: a convolution becomes a grouped convolution
(the input ``[B, R*C, H, W]``, the weight ``[R*O, C, kh, kw]``,
``groups=R``), a dense layer a batched product (``aten::bmm``) for its
forward and for each of its gradients. cuDNN picks the algorithm of a
grouped convolution's weight gradient by the number of groups, and cuBLAS
a batched product's by its batch count, so a rank's gradient depended on
how many ranks its process holds: 2 processes x 4 ranks of config 1 parted
from one process of 8 at the second step, 4 processes x 2 of config 5 in
the first epoch.

:func:`rank_products` is a ``TorchDispatchMode``: it sees the physical ops
vmap's batching rules issue. For an f32 2-D ``aten.convolution_backward``
that asks for the weight gradient it takes the input and bias gradients
from the native op (their bits do not depend on the number of groups) and
the weight gradient from ``ops.conv2d_weight_grad_ranks``, one launch for
every group, the input and the output gradient passed as ``[G, B, C,
...]`` views of the grouped layout with no copy. Every f32 ``aten.bmm`` it
takes from ``ops.rank_bmm``, one launch for the stack. Each kernel sums
each rank in an order fixed by the shape alone. Other ops (another dtype,
a transposed convolution) stay native. A mode at the dispatcher costs
less host time than custom autograd functions under the vmap and grad
transforms: no Python runs per transform level.

There is no fallback: a kernel that does not build or launch raises.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import ops

_CONV_BACKWARD = torch.ops.aten.convolution_backward.default
_BMM = torch.ops.aten.bmm.default


class _RankProducts(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _BMM and not kwargs:
            a, b = args
            if a.dtype == b.dtype == torch.float32:
                return ops.rank_bmm(a, b)
        elif func is _CONV_BACKWARD and not kwargs:
            g, x, w, bias_sizes, stride, padding, dilation, transposed, out_pad, groups, mask = args
            if (mask[1] and not transposed and x.dim() == 4
                    and x.dtype == w.dtype == g.dtype == torch.float32):
                gx, _, gb = func(g, x, w, bias_sizes, stride, padding, dilation, transposed,
                                 out_pad, groups, [mask[0], False, mask[2]])
                B, GC = x.shape[:2]
                O, C = w.shape[0] // groups, GC // groups
                gw = ops.conv2d_weight_grad_ranks(
                    x.unflatten(1, (groups, C)).transpose(0, 1),
                    g.unflatten(1, (groups, O)).transpose(0, 1),
                    (O, C) + tuple(w.shape[2:]), stride, padding, dilation)
                return gx, gw.reshape(w.shape), gb
        return func(*args, **kwargs)


def rank_products() -> TorchDispatchMode:
    """A context in which each f32 2-D convolution's weight gradient comes
    from ``ops.conv2d_weight_grad_ranks`` and each f32 batched product
    from ``ops.rank_bmm``, a group or a batch entry (under vmap, a rank) at
    a time in one launch (see the module)."""
    return _RankProducts()


def by_rank_products(batched: Callable) -> Callable:
    """``batched`` (a ``torch.func.vmap`` over the ranks) run under
    :func:`rank_products`: the engine's per-rank map on the card."""

    def run(*args):
        with rank_products():
            return batched(*args)

    return run
