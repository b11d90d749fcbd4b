"""MNIST model family as ``torch.nn`` modules.

The port of ``torchmpi_tpu/models/mnist.py``. The modules take the JAX
package's input layout (``[B, 28, 28]``, ``[B, 28, 28, 1]`` or
``[B, 784]``) and compute the same function as the flax modules, so the
weights of one carry to the other through :mod:`.convert`:

- convolutions run channels-first, as PyTorch's do; LeNet moves its
  activations to channels-last before flattening, because flax flattens
  ``(h, w, c)`` before the first dense layer (``mnist.py:46``);
- flax's ``padding="SAME"`` for a 5x5 kernel is ``padding=2``;
- :func:`init_params` draws flax's default initialisation from a seeded
  ``torch.Generator``: lecun_normal kernels (a normal truncated at two
  standard deviations, variance 1/fan_in) and zero biases. The numbers
  differ from flax's for the same seed; the distribution is the same.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class LogisticRegression(nn.Module):
    """784 -> 10 linear softmax classifier (mnist_allreduce.lua's model)."""

    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.dense0 = nn.Linear(28 * 28, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense0(x.reshape(x.shape[0], -1))


class LeNet(nn.Module):
    """conv 32 -> pool -> conv 64 -> pool -> dense 256 -> dense 10, the
    JAX package's LeNet (857,738 parameters)."""

    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.conv0 = nn.Conv2d(1, 32, 5, padding=2)
        self.conv1 = nn.Conv2d(32, 64, 5, padding=2)
        self.dense0 = nn.Linear(7 * 7 * 64, 256)
        self.dense1 = nn.Linear(256, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], 1, 28, 28)
        x = F.max_pool2d(F.relu(self.conv0(x)), 2)
        x = F.max_pool2d(F.relu(self.conv1(x)), 2)
        # flatten in flax's (h, w, c) order
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.dense1(F.relu(self.dense0(x)))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, labels.long())


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).float().mean()


def make_loss_fn(model: nn.Module) -> Callable:
    """``loss_fn(params, batch) -> loss`` for the engine, ``params`` a dict
    of the module's parameters and ``batch = (x, y)``."""

    def loss_fn(params: Dict[str, torch.Tensor], batch: Tuple) -> torch.Tensor:
        x, y = batch
        logits = torch.func.functional_call(model, params, (x,))
        return cross_entropy_loss(logits, y)

    return loss_fn


def init_params(
    model: nn.Module,
    seed: int = 0,
    device: Optional[torch.device] = None,
) -> Dict[str, torch.Tensor]:
    """Flax's default initialisation of ``model``'s parameters, drawn from
    ``torch.Generator().manual_seed(seed)`` on the CPU: lecun_normal
    weights, zero biases. Returns a dict of detached tensors on ``device``
    (CPU by default)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, param in model.named_parameters():
        value = torch.zeros(param.shape, dtype=param.dtype)
        if name.endswith("weight"):
            fan_in = param[0].numel()  # in * kh * kw for a conv, in for a dense
            # flax variance_scaling(1, 'fan_in', 'truncated_normal'): the
            # stddev is corrected for the truncation at two stddevs
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            torch.nn.init.trunc_normal_(
                value, std=std, a=-2 * std, b=2 * std, generator=gen
            )
        out[name] = value.to(device) if device is not None else value
    return out
