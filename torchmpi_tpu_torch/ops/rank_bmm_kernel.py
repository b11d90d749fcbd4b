"""Each rank's matrix product, for a stack of ranks in one launch
(``csrc/rank_bmm.cu``).

It replaces no TPU kernel: the JAX package takes these products from XLA.
It repairs a fault of the port (ROADMAP C6): under the engine's
``rank_map='vmap'`` a dense layer of rank-stacked weights becomes one
batched product for its forward and for each gradient, and cuBLAS picks a
batched product's algorithm by its batch count, so a rank's result
depended on how many ranks its process stacked. :func:`rank_bmm` sums each
output element in an order fixed by the shape alone (the slices of K come
from :func:`~torchmpi_tpu_torch.ops.rank_gemm.plan`, never from R), so a
rank's result is the same bits in a stack of 8, 4 or 2. The engine's vmap
routes every f32 ``bmm`` through it on the card (``engine/rankwise.py``).

The wrapper takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import rank_gemm

launches = {"rank_bmm": 0}

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # a, b, out, work, tickets, R, M, N, K, bm, bn, kc, a's rank/row/k
    # strides, b's rank/k/column strides, stream
    "tm_rank_bmm": [_PTR] * 5 + [_INT] * 7 + [_LL] * 6 + [_PTR],
}


def _lib():
    from ._build import library

    return library("rank_bmm", _SIGNATURES)


def _check(a: torch.Tensor, b: torch.Tensor):
    if a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1]:
        raise ValueError(f"rank_bmm takes a [R, M, K] and b [R, K, N], got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    return a.shape[0], a.shape[1], b.shape[2], a.shape[2]


def rank_bmm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`rank_bmm`: ``a[r] @ b[r]`` one rank
    at a time."""
    _check(a, b)
    return torch.stack([torch.mm(a[r], b[r]) for r in range(a.shape[0])])


def rank_bmm(a: torch.Tensor, b: torch.Tensor, stream=None) -> torch.Tensor:
    """Each rank's product ``a[r] @ b[r]``: ``a`` ``[R, M, K]``, ``b``
    ``[R, K, N]`` at any strides; returns ``[R, M, N]``. Rank r's result
    depends on rank r's operands and the shape alone, bit for bit, whatever
    R and the strides. One launch of ``csrc/rank_bmm.cu`` for f32 CUDA
    tensors, the plain version for CPU ones."""
    if a.device.type == "cpu":
        return rank_bmm_plain(a, b)
    R, M, N, K = _check(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"rank_bmm runs on CUDA or the CPU, not {a.device} and {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"rank_bmm takes f32, not {a.dtype} and {b.dtype}")
    out = torch.empty((R, M, N), dtype=torch.float32, device=a.device)
    p = rank_gemm.plan(M, N, K)
    from ._build import check, launch

    call = _lib().tm_rank_bmm

    def go(handle):
        work, tickets = rank_gemm.scratch(a.device, handle, R, p)
        err = call(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                   None if work is None else work.data_ptr(), tickets, R, M, N, K, p.bm, p.bn,
                   p.kc, *a.stride(), *b.stride(), handle)
        if work is not None and stream is not None:
            work.record_stream(stream)
        return err

    check(launch(a.device, go, stream), "tm_rank_bmm")
    launches["rank_bmm"] += 1
    return out
