"""6-layer MLP as a ``torch.nn`` module.

The port of ``torchmpi_tpu/models/mlp.py``: the reference's async-DP
numerics test model (``test/async.lua:63-148``) and the model of the
engine's sharded-mode tests, whose ``features`` divides by the world size
so that every kernel shards. Five dense layers of ``features`` with ReLU,
then a dense head of ``num_classes`` in f32; the input is flattened first.
Layer i is ``dense{i}``, flax's ``Dense_i``, so
:func:`~torchmpi_tpu_torch.models.convert.from_jax_params` carries the
flax weights over, and :func:`~torchmpi_tpu_torch.models.init_params`
draws flax's initialisers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class MLP6(nn.Module):
    """``in_features`` -> 5 x (``features``, ReLU) -> ``num_classes``; the
    hidden layers compute in ``dtype``, the head in f32."""

    def __init__(self, features: int = 256, num_classes: int = 10, in_features: int = 28 * 28,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        widths = [in_features] + [features] * 5
        for i in range(5):
            setattr(self, f"dense{i}", nn.Linear(widths[i], widths[i + 1]))
        self.dense5 = nn.Linear(features, num_classes)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i in range(5):
            layer = getattr(self, f"dense{i}")
            x = F.relu(F.linear(x, layer.weight.to(self.dtype), layer.bias.to(self.dtype)))
        return self.dense5(x.float())
