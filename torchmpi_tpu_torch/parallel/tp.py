"""Tensor (intra-layer model) parallelism over a named rank axis.

The port of ``torchmpi_tpu/parallel/tp.py``: the reference's
``MPLinear`` pattern (``examples/mnist/mnist_modelparallel.lua:30-61``)
splits a Linear's input dimension over ranks and sums the partial
products. The JAX module holds one device's kernel shard inside
``shard_map``; here the module holds every rank's shard, rank-stacked
``[p, in / tp, features]`` (rank r holds the shard of its coordinate
along the tp axis, the same on every rank of its other axes), and the sum
is :func:`~.axis.axis_psum`, the grouped ring kernel K3. Its backward
psums the input gradients, the reference's ``gradInput`` allreduce.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..collectives.axis import axis_psum, axis_rank
from .mesh import MeshLayout


def _lecun_normal_(value: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """flax ``lecun_normal``: a normal truncated at two standard deviations,
    variance 1/fan_in (the stddev corrected for the truncation)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(value, std=std, a=-2 * std, b=2 * std, generator=generator)


def _stacked_matmul(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Rank r's ``x[r] @ kernel[r]`` for ``x`` ``[p, ..., in]``."""
    p, inner = x.shape[0], x.shape[-1]
    out = torch.bmm(x.reshape(p, -1, inner), kernel)
    return out.reshape(x.shape[:-1] + (kernel.shape[-1],))


class MPLinear(nn.Module):
    """Input-dimension-split tensor-parallel Dense over ``layout``'s
    ``axis``. Takes each rank's input-feature shard ``x_local [p, ...,
    in_features / tp]`` (:func:`shard_input_features`) and returns the full
    ``[p, ..., features]`` output on every rank: the partial products, each
    rank adding ``bias / tp`` before the sum so the full bias appears
    once (``tp.py:54-63``), summed by one :func:`axis_psum`. The
    parameters are ``kernel [p, in / tp, features]`` and ``bias [p,
    features]``, flax's initialisation drawn per tp shard from
    ``generator`` (lecun_normal over the shard's fan-in, zero bias)."""

    def __init__(self, in_features: int, features: int, layout: MeshLayout, axis: str = "tp",
                 use_bias: bool = True, dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        tp = layout.size(axis)
        if in_features % tp:
            raise ValueError(f"feature dim {in_features} not divisible by tp={tp}")
        self.layout, self.axis, self.dtype = layout, axis, dtype
        p, local = layout.num_ranks, in_features // tp
        shards = torch.empty((tp, local, features), dtype=dtype)
        for shard in shards:
            _lecun_normal_(shard, local, generator)
        index = torch.as_tensor(layout.axis_index(axis))
        self.kernel = nn.Parameter(shards[index].to(device))
        self.bias = nn.Parameter(torch.zeros((p, features), dtype=dtype, device=device)) \
            if use_bias else None

    def forward(self, x_local: torch.Tensor) -> torch.Tensor:
        partial = _stacked_matmul(x_local.to(self.dtype), self.kernel)
        if self.bias is not None:
            bias = self.bias / self.layout.size(self.axis)
            partial = partial + bias.reshape((bias.shape[0],) + (1,) * (partial.ndim - 2) + (-1,))
        return axis_psum(partial, self.layout, self.axis)


class MPLinearOutputSplit(nn.Module):
    """Output-dimension-split Dense: each rank computes its slice of the
    output features, ``kernel [p, in, features_per_shard]`` and ``bias
    [p, features_per_shard]``; paired with an input-split layer
    (Megatron's column -> row pairing) no collective sits between the
    two."""

    def __init__(self, in_features: int, features_per_shard: int, layout: MeshLayout,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        p = layout.num_ranks
        kernel = torch.empty((p, in_features, features_per_shard), dtype=dtype)
        for shard in kernel:
            _lecun_normal_(shard, in_features, generator)
        self.kernel = nn.Parameter(kernel.to(device))
        self.bias = nn.Parameter(torch.zeros((p, features_per_shard), dtype=dtype,
                                             device=device)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = _stacked_matmul(x.to(self.dtype), self.kernel)
        if self.bias is not None:
            out = out + self.bias.reshape((out.shape[0],) + (1,) * (out.ndim - 2) + (-1,))
        return out


def shard_input_features(x: torch.Tensor, layout: MeshLayout, axis: str = "tp") -> torch.Tensor:
    """Each rank's slice of the trailing feature axis of the rank-stacked
    ``x [p, ..., n]``: rank r keeps features ``c * n / tp .. (c + 1) * n /
    tp`` for its coordinate c along ``axis`` (the caller-side half of the
    MPLinear pattern, ``mnist_modelparallel.lua:34-38``)."""
    tp = layout.size(axis)
    n = x.shape[-1]
    if n % tp != 0:
        raise ValueError(f"feature dim {n} not divisible by tp={tp}")
    per = n // tp
    index = axis_rank(layout, axis, x.device, x.shape[1:-1] + (1,)).expand(
        x.shape[:-1] + (per,))
    offsets = torch.arange(per, device=x.device)
    return x.gather(-1, index * per + offsets)
