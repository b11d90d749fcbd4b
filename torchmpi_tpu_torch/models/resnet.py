"""ResNet family (ResNet-18/50) as ``torch.nn`` modules.

The port of ``torchmpi_tpu/models/resnet.py`` (BASELINE config 4,
"ResNet-50 ImageNet data-parallel via synchronizeGradients"): bottleneck
ResNet-v1.5 (stride 2 in the 3x3 conv) and the basic-block ResNet-18, on
the JAX package's NHWC input. The modules compute the flax modules'
function, so the weights of one carry to the other through
:func:`~torchmpi_tpu_torch.models.convert.resnet_from_jax_params`:

- the input is permuted to NCHW, which keeps its NHWC memory (PyTorch's
  ``channels_last``); the head's spatial mean is over (2, 3);
- flax's ``padding='SAME'`` is asymmetric where the stride does not divide
  the padded size: a 3x3 stride-2 conv over an even input pads (0, 1), as
  does the 3x3 stride-2 max-pool (with -inf); :func:`same_pads` gives
  XLA's split, and an uneven one is padded explicitly before an unpadded
  conv or pool. The 7x7 stem pads (3, 3), as flax is told to;
- batch norm runs functionally in f32 (also under ``dtype=bfloat16``):
  in training it normalises by the batch statistics (biased variance)
  and returns the new running statistics, ``0.9 * old + 0.1 * batch`` with
  flax's variance ``E[x^2] - E[x]^2``, into the ``new_stats`` dict it is
  handed, instead of writing buffers in place; in evaluation it reads the
  running statistics. The convolutions run in ``dtype``, the dense head
  in f32.

The model runs over a parameter dict and a statistics dict (its buffers)
through ``torch.func.functional_call``, so the engine can map it over
rank-stacked copies. Given rank-stacked parameters (``[p, ...]``, one copy
a rank) and a rank-stacked batch ``[p, B, H, W, C]``, the training forward
runs the ranks together, as the JAX engine's sharded step runs one
computation over the global batch (``engine/sgd.py:517-556``): each
convolution and the head run rank by rank on the rank's own weights (a
loop inside the layer; the grouped form was 2.28x slower at ResNet-50's
width, PERF.md), and batch norm normalises over every rank's rows, (rank,
batch, H, W), before each rank's own scale and bias, the counterpart of
the per-channel sums that GSPMD all-reduces inside the forward; its new
statistics are the global ones, the same on every rank. The gradient of
the mean loss over all rows with respect to rank r's weights is then rank
r's partial gradient, and their sum over the ranks the global gradient.
:func:`make_stateful_loss_fn` gives the engine's
``loss_fn(params, state, batch) -> (loss, new_state)`` (either form) and
:func:`make_eval_fn` the evaluation's ``apply_fn(params, state, x)``.
:func:`init_resnet` draws flax's initialisers from a seeded
``torch.Generator``: lecun-normal conv and dense kernels, zero biases, BN
scale 1 (0 for each block's last BN) and bias 0, running mean 0 and
variance 1. The numbers differ from flax's for the same seed; the
distribution is the same.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Type

import torch
import torch.nn.functional as F
from torch import nn

from .mnist import cross_entropy_loss

Tree = Dict[str, torch.Tensor]
BN_MOMENTUM, BN_EPS = 0.9, 1e-5


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's ``SAME`` for one spatial dim: the
    output has ``ceil(size / stride)`` positions and the odd pad goes to
    the high side."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0):
    """``x`` [N, C, H, W] and the symmetric padding left to the conv or
    pool: an uneven ``SAME`` split is padded here, an even one is left to
    the op's own ``padding``."""
    (th, bh), (lw, rw) = (same_pads(n, kernel, stride) for n in x.shape[-2:])
    if th == bh and lw == rw:
        return x, (th, lw)
    return F.pad(x, (lw, rw, th, bh), value=value), (0, 0)


def max_pool_same(x: torch.Tensor, kernel: int = 3, stride: int = 2) -> torch.Tensor:
    """``fnn.max_pool(x, (k, k), strides=(s, s), padding='SAME')`` on NCHW."""
    x, pad = _pad_same(x, kernel, stride, -math.inf)
    return F.max_pool2d(x, kernel, stride, padding=pad)


class Conv(nn.Module):
    """flax ``Conv`` without bias: ``SAME`` padding unless ``padding`` is
    given, the input and kernel cast to ``dtype``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, device=device))
        self.kernel, self.stride, self.padding, self.dtype = kernel, stride, padding, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.padding is None:
            x, pad = _pad_same(x, self.kernel, self.stride)
        else:
            pad = self.padding
        weight = self.weight.to(self.dtype)
        if weight.ndim == 5:
            # rank-stacked: x holds the ranks' batches one after another,
            # each convolved with its own rank's weights
            return torch.cat([F.conv2d(xr, wr, stride=self.stride, padding=pad)
                              for xr, wr in zip(x.chunk(len(weight)), weight)])
        return F.conv2d(x, weight, stride=self.stride, padding=pad)


class _RankBatchNorm(torch.autograd.Function):
    """Training batch norm of rank-stacked rows: ``x`` ``[p B, C, H, W]``
    normalised over every rank's rows, then rank r's rows scaled and
    shifted by its own ``weight[r]`` and ``bias[r]`` (``[p, C]``).
    Returns ``(y, mean, invstd)``. It keeps what ATen's batch norm keeps,
    the input and the per-channel statistics, where composing the
    normalisation and the per-rank scale would keep the normalised rows
    too (a second copy of every batch norm's activations); the backward
    recomputes them."""

    @staticmethod
    def forward(x, weight, bias):
        xhat, mean, invstd = torch.ops.aten.native_batch_norm(x, None, None, None, None, True,
                                                             0.0, BN_EPS)
        shape = (len(weight), 1, -1, 1, 1)
        y = xhat.unflatten(0, (len(weight), -1)) * weight.reshape(shape) + bias.reshape(shape)
        return y.flatten(0, 1), mean, invstd

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, weight, _ = inputs
        _, mean, invstd = output
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.mark_non_differentiable(mean, invstd)

    @staticmethod
    def backward(ctx, dy, *_):
        x, weight, mean, invstd = ctx.saved_tensors
        p = len(weight)
        stat = (-1, 1, 1)
        xhat = ((x - mean.reshape(stat)) * invstd.reshape(stat)).unflatten(0, (p, -1))
        dy = dy.unflatten(0, (p, -1))
        dweight, dbias = (dy * xhat).sum(dim=(1, 3, 4)), dy.sum(dim=(1, 3, 4))
        del xhat
        dxhat = (dy * weight.reshape(p, 1, -1, 1, 1)).flatten(0, 1)
        dx = torch.ops.aten.native_batch_norm_backward(
            dxhat, x, None, None, None, mean, invstd, True, BN_EPS, [True, False, False])[0]
        return dx, dweight, dbias


class BatchNorm(nn.Module):
    """flax ``BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)`` over
    the channels of NCHW: ``weight`` is flax's ``scale``; the buffers
    ``mean`` and ``var`` are its ``batch_stats``. ``stats_name`` (the
    module's dotted name, set by :class:`ResNet`) keys the new statistics
    in the ``new_stats`` dict."""

    def __init__(self, features: int, zero_scale: bool = False, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))
        self.zero_scale = zero_scale
        self.stats_name = ""

    def forward(self, x: torch.Tensor, train: bool, new_stats: Optional[Tree]) -> torch.Tensor:
        x = x.float()
        if not train:
            # flax's _normalize: (x - mean) * (rsqrt(var + eps) * scale) + bias
            shape = (-1, 1, 1)
            mul = torch.rsqrt(self.var + BN_EPS) * self.weight
            return (x - self.mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        d = x.detach()
        mean = d.mean(dim=(0, 2, 3))
        var = ((d * d).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        new_stats[self.stats_name + "mean"] = BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean
        new_stats[self.stats_name + "var"] = BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var
        if self.weight.ndim == 1:
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, BN_EPS)
        return _RankBatchNorm.apply(x, self.weight, self.bias)[0]


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 x4, each conv followed by BN, the last
    BN zero-scaled; a 1x1 projection and BN on the residual where the shape
    changes."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        cout = features * 4
        self.conv0 = Conv(cin, features, 1, dtype=dtype, device=device)
        self.bn0 = BatchNorm(features, device=device)
        self.conv1 = Conv(features, features, 3, stride, dtype=dtype, device=device)
        self.bn1 = BatchNorm(features, device=device)
        self.conv2 = Conv(features, cout, 1, dtype=dtype, device=device)
        self.bn2 = BatchNorm(cout, zero_scale=True, device=device)
        if cin != cout or stride != 1:
            self.proj = Conv(cin, cout, 1, stride, dtype=dtype, device=device)
            self.proj_bn = BatchNorm(cout, device=device)
        else:
            self.proj = self.proj_bn = None

    def forward(self, x: torch.Tensor, train: bool, new_stats: Optional[Tree]) -> torch.Tensor:
        y = F.relu(self.bn0(self.conv0(x), train, new_stats))
        y = F.relu(self.bn1(self.conv1(y), train, new_stats))
        y = self.bn2(self.conv2(y), train, new_stats)
        if self.proj is not None:
            x = self.proj_bn(self.proj(x), train, new_stats)
        return F.relu(x + y)


class BasicBlock(nn.Module):
    """3x3 (stride) -> 3x3, each conv followed by BN, the last BN
    zero-scaled; a 1x1 projection and BN where the shape changes."""

    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv0 = Conv(cin, features, 3, stride, dtype=dtype, device=device)
        self.bn0 = BatchNorm(features, device=device)
        self.conv1 = Conv(features, features, 3, dtype=dtype, device=device)
        self.bn1 = BatchNorm(features, zero_scale=True, device=device)
        if cin != features or stride != 1:
            self.proj = Conv(cin, features, 1, stride, dtype=dtype, device=device)
            self.proj_bn = BatchNorm(features, device=device)
        else:
            self.proj = self.proj_bn = None

    def forward(self, x: torch.Tensor, train: bool, new_stats: Optional[Tree]) -> torch.Tensor:
        y = F.relu(self.bn0(self.conv0(x), train, new_stats))
        y = self.bn1(self.conv1(y), train, new_stats)
        if self.proj is not None:
            x = self.proj_bn(self.proj(x), train, new_stats)
        return F.relu(x + y)


class ResNet(nn.Module):
    """The 7x7/2 stem (pad 3) and BN, the 3x3/2 ``SAME`` max-pool, the
    stages (stride 2 at each stage's first block but the first stage's),
    the spatial mean and the dense head. ``forward(x, train, new_stats)``
    takes NHWC images; in training it fills ``new_stats`` with the new
    running statistics under their buffer names."""

    def __init__(self, stage_sizes: Sequence[int], block: Type[nn.Module] = BottleneckBlock,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv_init = Conv(3, num_filters, 7, 2, padding=3, dtype=dtype, device=device)
        self.bn_init = BatchNorm(num_filters, device=device)
        blocks, cin = [], num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block(cin, num_filters * 2**i, stride, dtype=dtype, device=device))
                cin = num_filters * 2**i * block.expansion
        self.blocks = nn.ModuleList(blocks)
        self.dense = nn.Linear(cin, num_classes, device=device)
        for name, module in self.named_modules():
            if isinstance(module, BatchNorm):
                module.stats_name = name + "."

    def forward(self, x: torch.Tensor, train: bool = True,
                new_stats: Optional[Tree] = None) -> torch.Tensor:
        if x.ndim == 5:  # rank-stacked [p, B, H, W, C]: the ranks' batches in turn
            x = x.flatten(0, 1)
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> NCHW, channels_last memory
        x = F.relu(self.bn_init(self.conv_init(x), train, new_stats))
        x = max_pool_same(x)
        for block in self.blocks:
            x = block(x, train, new_stats)
        x = x.mean(dim=(2, 3))
        weight, bias = self.dense.weight, self.dense.bias
        if weight.ndim == 3:  # rank-stacked: each rank's rows through its own head
            x = torch.baddbmm(bias[:, None], x.unflatten(0, (len(weight), -1)), weight.mT)
            return x.flatten(0, 1)
        return self.dense(x)


def ResNet18(**kw) -> ResNet:
    return ResNet(stage_sizes=[2, 2, 2, 2], block=BasicBlock, **kw)


def ResNet50(**kw) -> ResNet:
    return ResNet(stage_sizes=[3, 4, 6, 3], block=BottleneckBlock, **kw)


def init_resnet(model: ResNet, image_size: int = 224, seed: int = 0, device=None,
                generator: Optional[torch.Generator] = None) -> Tuple[Tree, Tree]:
    """``(params, batch_stats)`` of ``model`` by flax's initialisers, drawn
    in parameter order from ``generator`` (default
    ``torch.Generator().manual_seed(seed)``) on the CPU and moved to
    ``device``. ``image_size`` is the JAX signature's; the port's shapes do
    not depend on it."""
    del image_size
    gen = generator if generator is not None else torch.Generator().manual_seed(seed)
    zero_scaled = {name + ".weight" for name, m in model.named_modules()
                   if isinstance(m, BatchNorm) and m.zero_scale}
    params = {}
    for name, param in model.named_parameters():
        value = torch.zeros(param.shape, dtype=torch.float32)
        if param.ndim > 1:  # conv and dense kernels: lecun_normal
            std = math.sqrt(1.0 / param[0].numel()) / 0.87962566103423978
            torch.nn.init.trunc_normal_(value, std=std, a=-2 * std, b=2 * std, generator=gen)
        elif name.endswith(".weight") and name not in zero_scaled:
            value.fill_(1.0)  # BN scale
        params[name] = value.to(device)
    stats = {name: (torch.ones if name.endswith(".var") else torch.zeros)(
        buf.shape, dtype=torch.float32, device=device) for name, buf in model.named_buffers()}
    return params, stats


def make_stateful_loss_fn(model: ResNet) -> Callable:
    """``loss_fn(params, state, batch) -> (loss, new_state)`` for the
    engine's ``model_state`` path: the mean cross-entropy of the training
    forward and the new batch statistics. On one rank's parameters and
    batch it is that rank's loss (the replicated engine averages the
    ranks' statistics every step); on rank-stacked parameters ``[p, ...]``,
    state and batch ``([p, B, H, W, C], [p, B])`` it is the rank-stacked
    forward (see :class:`ResNet`): the mean over all ``p * B`` rows, and
    the global statistics on every rank, as the engine's sharded modes
    need."""

    def loss_fn(params: Tree, state: Tree, batch) -> Tuple[torch.Tensor, Tree]:
        x, y = batch
        new_state: Tree = {}
        logits = torch.func.functional_call(model, {**params, **state}, (x,),
                                            {"train": True, "new_stats": new_state})
        return cross_entropy_loss(logits, y.reshape(-1)), new_state

    return loss_fn


def make_eval_fn(model: ResNet) -> Callable:
    """``apply_fn(params, state, x) -> logits``: the forward on the running
    statistics (``train=False``), for ``AllReduceSGDEngine.evaluate``."""

    def apply_fn(params: Tree, state: Tree, x: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(model, {**params, **state}, (x,), {"train": False})

    return apply_fn
