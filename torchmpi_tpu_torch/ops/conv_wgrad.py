"""The weight gradient of a convolution, one per rank, for a stack of
ranks in one launch (``csrc/conv_wgrad.cu``).

It replaces no TPU kernel: the JAX package takes this gradient from XLA.
It repairs a fault of the port (ROADMAP C6): under the engine's
``rank_map='vmap'`` a convolution of rank-stacked weights becomes one
grouped convolution, and cuDNN picks its weight gradient's algorithm by the
number of groups, so a rank's gradient depended on how many ranks its
process stacked. :func:`conv2d_weight_grad_ranks` sums each rank's gradient
in an order fixed by that rank's data and the shape alone (the kernel's
slices of K come from :func:`splits`, never from R), so a rank's result is
the same bits in a stack of 8, 4 or 2. The engine's vmap routes every f32
``groups=1`` convolution's weight gradient through it on the card
(``engine/rankconv.py``).

The wrapper takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

_BM = _BN = 64  # the kernel's output tile
_BK = 16  # its depth a step: a slice of K is a multiple of it
_BLOCKS_PER_RANK = 128  # the slices of K aim at this many blocks a rank
_MAX_SPLITS = 64

launches = {"conv2d_weight_grad_ranks": 0}

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, dy, out, work, tickets, R, B, C, H, W, O, Ho, Wo, kh, kw, sh, sw,
    # ph, pw, dh, dw, kc, x's rank and image strides, dy's, stream
    "tm_conv_wgrad": [_PTR] * 5 + [_INT] * 17 + [ctypes.c_longlong] * 4 + [_PTR],
}


def _lib():
    from ._build import library

    return library("conv_wgrad", _SIGNATURES)


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        if len(v) != 2:
            raise ValueError(f"conv2d_weight_grad_ranks takes 2-D settings, got {v}")
        return int(v[0]), int(v[1])
    return int(v), int(v)


def splits(o: int, n: int, k: int) -> Tuple[int, int]:
    """``(slices, slice length)`` of K = B*Ho*Wo for an ``o`` x ``n``
    weight gradient (n = C*kh*kw): the 64 x 64 tiles of one rank times the
    slices make about 128 blocks, each slice a multiple of 16 deep, at
    most 64 slices. A function of the shape alone, so the order of adds
    never depends on how many ranks a launch holds."""
    tiles = -(-o // _BM) * -(-n // _BN)
    want = max(1, min(_MAX_SPLITS, -(-_BLOCKS_PER_RANK // tiles)))
    kc = max(_BK, -(-(-(-k // want)) // _BK) * _BK)
    return -(-k // kc), kc


def _check(x: torch.Tensor, dy: torch.Tensor, weight_shape, stride, padding, dilation):
    if x.ndim != 5 or dy.ndim != 5:
        raise ValueError(f"conv2d_weight_grad_ranks takes x [R, B, C, H, W] and dy [R, B, O, Ho, "
                         f"Wo], got {tuple(x.shape)} and {tuple(dy.shape)}")
    O, C, kh, kw = (int(d) for d in weight_shape)
    R, B, Cx, H, W = x.shape
    if dy.shape[:3] != (R, B, O) or Cx != C:
        raise ValueError(f"conv2d_weight_grad_ranks: x {tuple(x.shape)}, dy {tuple(dy.shape)} and "
                         f"the weight {tuple(weight_shape)} disagree")
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    if tuple(dy.shape[3:]) != (Ho, Wo):
        raise ValueError(f"conv2d_weight_grad_ranks: dy's positions {tuple(dy.shape[3:])} are not "
                         f"the convolution's ({Ho}, {Wo})")
    return (R, B, C, H, W, O, Ho, Wo, kh, kw, sh, sw, ph, pw, dh, dw)


def conv2d_weight_grad_ranks_plain(x: torch.Tensor, dy: torch.Tensor, weight_shape: Sequence[int],
                                   stride=1, padding=0, dilation=1) -> torch.Tensor:
    """Plain PyTorch version of :func:`conv2d_weight_grad_ranks`:
    ``torch.nn.grad.conv2d_weight`` one rank at a time. On the card it runs
    with cuDNN off (ATen's unfold and f32 GEMM): cuDNN's deterministic
    algorithm for LeNet's ``conv1`` weight gradient is 4.6e-3 of max|grad|
    away from the f64 sums, where the kernel and ATen's are within 1e-6."""
    _check(x, dy, weight_shape, stride, padding, dilation)
    with torch.backends.cudnn.flags(enabled=False):
        return torch.stack([
            torch.nn.grad.conv2d_weight(x[r], tuple(int(d) for d in weight_shape), dy[r],
                                        _pair(stride), _pair(padding), _pair(dilation))
            for r in range(x.shape[0])])


def conv2d_weight_grad_ranks(x: torch.Tensor, dy: torch.Tensor, weight_shape: Sequence[int],
                             stride=1, padding=0, dilation=1, stream=None) -> torch.Tensor:
    """Each rank's weight gradient of a ``groups=1`` convolution: ``x``
    ``[R, B, C, H, W]`` the ranks' inputs, ``dy`` ``[R, B, O, Ho, Wo]``
    their output gradients, ``weight_shape`` ``(O, C, kh, kw)``; returns
    ``[R, O, C, kh, kw]``. Each image of ``x`` and ``dy`` must be
    contiguous, the ranks and the images may lie at any stride (else they
    are copied). Rank r's result depends on rank r's rows and the shape
    alone, bit for bit, whatever R. One launch of
    ``csrc/conv_wgrad.cu`` for f32 CUDA tensors, the plain version for CPU
    ones."""
    if x.device.type == "cpu":
        return conv2d_weight_grad_ranks_plain(x, dy, weight_shape, stride, padding, dilation)
    dims = _check(x, dy, weight_shape, stride, padding, dilation)
    if x.device.type != "cuda" or dy.device != x.device:
        raise ValueError(f"conv2d_weight_grad_ranks runs on CUDA or the CPU, not {x.device} and "
                         f"{dy.device}")
    if x.dtype != torch.float32 or dy.dtype != torch.float32:
        raise ValueError(f"conv2d_weight_grad_ranks takes f32, not {x.dtype} and {dy.dtype}")
    R, B, C, H, W, O, Ho, Wo, kh, kw = dims[:10]
    # each image contiguous; the ranks and the images at any stride (a
    # grouped convolution's channels seen as ranks are read in place)
    x = x if x[0, 0].is_contiguous() else x.contiguous()
    dy = dy if dy[0, 0].is_contiguous() else dy.contiguous()
    out = torch.empty((R, O, C, kh, kw), dtype=torch.float32, device=x.device)
    n_splits, kc = splits(O, C * kh * kw, B * Ho * Wo)
    tiles = -(-O // _BM) * -(-(C * kh * kw) // _BN)
    work = tickets = None
    if n_splits > 1:
        work = torch.empty(R * tiles * n_splits * _BM * _BN, dtype=torch.float32, device=x.device)
        tickets = torch.zeros(R * tiles, dtype=torch.int32, device=x.device)
    from ._build import check, launch

    call = _lib().tm_conv_wgrad
    args = (x.data_ptr(), dy.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(),
            None if tickets is None else tickets.data_ptr(), *dims, kc,
            x.stride(0), x.stride(1), dy.stride(0), dy.stride(1))
    check(launch(x.device, lambda s: call(*args, s), stream), "tm_conv_wgrad")
    launches["conv2d_weight_grad_ranks"] += 1
    return out
