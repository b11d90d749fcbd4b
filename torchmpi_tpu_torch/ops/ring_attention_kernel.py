"""Ring attention over virtual ranks on one CUDA card: forward, bidirectional
forward and analytic backward, each a hand-written CUDA kernel beside its
plain PyTorch version.

The port of ``torchmpi_tpu/ops/ring_attention_kernel.py``:

- :func:`ring_attention_fwd` runs ``_ring_attn_kernel`` (K8) or, with
  ``bidir=True``, ``_ring_attn_bidir_kernel`` (K9), and returns ``(o, lse)``
  as ``ring_attention_pallas(..., return_lse=True)`` does;
- :func:`ring_attention_bwd` runs ``_ring_attn_bwd_kernel`` (K10), as
  ``ring_attention_bwd_pallas``;
- :class:`RingAttention` is the ``jax.custom_vjp`` ``ring_attention``: the
  forward saves ``(q, k, v, o, lse)``, the backward is K10 when
  ``bwd_kernel`` is set, else the plain analytic ring backward (the JAX
  package's default XLA backward).

All three kernels run their products on the tensor cores, in f32
arithmetic whatever the input dtype. On f32 inputs (``csrc/ring_attention.cu``)
they are ``mma.sync`` with TF32 operands split as 3xTF32: the forward is
``fwd_mma_kernel``, the backward ``bwd_dq_mma_kernel`` then
``bwd_dkv_mma_kernel``. On bf16 inputs (``csrc/ring_attention_bf16.cu``)
they are ``wgmma`` on the bf16 tensor cores with TMA loads: S and dP exact
bf16 products summed in f32, P and dS as two bf16 terms (hi and lo), each
tile's product summed fresh and added in f32; the forward is
``fwd_wgmma_kernel``, the backward ``bwd_dq_wgmma_kernel`` then
``bwd_dkv_wgmma_kernel``.

Tensors are rank-stacked: q, k
and v are ``[sp, b, n_local, h, d]`` (rank r keeps the JAX layout
``[b, n, h, d]``; the ring is the leading axis) and ``lse`` is
``[sp, b, h, n_local]`` f32. A wrapper takes the plain version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises
(f32 and bf16, head_dim in :data:`HEAD_DIMS`). As in the JAX package,
p == 1 has no ring: the forward is full attention with its log-sum-exp
and the backward the gradient of full attention, in plain PyTorch.

The plain versions follow the JAX arithmetic block by block: per visiting
block the block max, ``exp``, the row sums and the alpha/beta merge of
``_flash_merge_cells`` in the ring order, and for the backward
``_ring_attention_bwd_xla``. The kernels merge 64-key tiles instead of
whole blocks (the forward with an online softmax) and sum their products
on the tensor cores, so the two agree to rounding, not bit for bit
(``tests/test_torch_tf32.py`` checks the kernels' 3xTF32 and bf16
arithmetic, the forward's tile walk included, against f64 on the CPU, and
``tests/test_torch_attention_bf16.py`` the bf16 arithmetic against the JAX
kernels).
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

NEG_INF = -1e30
HEAD_DIMS = (8, 16, 32, 64, 128)
# dtypes the kernels take, with their tmpi::Dtype codes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches since the last reset (ops.reset_launch_counts); the backward
# launches two kernels per call (dQ, then dK/dV), each counted
launches = {"ring_attention_fwd": 0, "ring_attention_fwd_bidir": 0, "ring_attention_bwd": 0}

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # q, k, v, o, lse, dtype, p, B, n, H, D, causal, bidir, stream
    "tm_ring_attention_fwd": [_PTR] * 5 + [_INT] * 8 + [_PTR],
    # q, k, v, o, dout, lse, delta, dq, dk, dv, dtype, p, B, n, H, D, causal, stream
    "tm_ring_attention_bwd": [_PTR] * 10 + [_INT] * 7 + [_PTR],
}
_SIGNATURES_BF16 = {
    # q, k, v, o, lse, p, B, n, H, D, causal, bidir, stream
    "tm_ring_attention_bf16_fwd": [_PTR] * 5 + [_INT] * 7 + [_PTR],
    # q, k, v, o, dout, lse, delta, dq, dk, dv, p, B, n, H, D, causal, stream
    "tm_ring_attention_bf16_bwd": [_PTR] * 10 + [_INT] * 6 + [_PTR],
}


def _lib(dtype=torch.float32):
    """The kernels' library for ``dtype``: ``csrc/ring_attention.cu`` (f32)
    or ``csrc/ring_attention_bf16.cu`` (bf16)."""
    from ._build import library

    if dtype == torch.bfloat16:
        return library("ring_attention_bf16", _SIGNATURES_BF16)
    return library("ring_attention", _SIGNATURES)


def _check(what: str, q: torch.Tensor, *others: torch.Tensor) -> None:
    if q.ndim != 5:
        raise ValueError(f"{what} expects rank-stacked [sp, b, n, h, d] tensors, got {tuple(q.shape)}")
    for t in others:
        if t.shape != q.shape:
            raise ValueError(f"{what} needs equal shapes, got {tuple(q.shape)} and {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{what} got tensors on {q.device} and {t.device}")


def _check_kernel(what: str, *tensors: torch.Tensor) -> None:
    """What the CUDA kernels take: one dtype of :data:`DTYPES`, a head dim of
    :data:`HEAD_DIMS`, contiguous tensors."""
    q = tensors[0]
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"{what} kernel takes f32 or bf16 inputs of one dtype, got "
                         f"{sorted({str(t.dtype) for t in tensors})}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head_dim in {HEAD_DIMS}, got {q.shape[-1]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} expects contiguous tensors")
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or the CPU, not {q.device}")


# ------------------------------------------------------------------ p == 1


def full_attention_with_lse(q, k, v, causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-shard attention ``[b, n, h, d]`` returning ``(out, lse[b, h, n])``
    from one f32 score matrix (``_full_attention_with_lse``)."""
    n = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    if causal:
        mask = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    w = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return out.to(q.dtype), lse


def _full_fwd(q, k, v, causal):
    out, lse = full_attention_with_lse(q[0], k[0], v[0], causal)
    return out[None], lse[None]


# ----------------------------------------------------------------- forward


def _positions(p: int, n: int, device) -> torch.Tensor:
    """Global positions ``[p, n]``: rank r holds r*n .. r*n + n - 1."""
    return torch.arange(p * n, device=device).reshape(p, n)


def ring_attention_fwd_plain(q, k, v, causal: bool = False, bidir: bool = False):
    """Plain PyTorch version of :func:`ring_attention_fwd`: the JAX kernels'
    block merges, in their visiting order. Differentiable by autograd (the
    ``'xla'`` backend of ``parallel.ring_self_attention``)."""
    _check("ring_attention_fwd", q, k, v)
    p, b, n, h, d = q.shape
    if p == 1:
        return _full_fwd(q, k, v, causal)
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    pos = _positions(p, n, q.device)
    ranks = torch.arange(p, device=q.device)
    o = torch.zeros((p, b, n, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((p, b, h, n), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((p, b, h, n), dtype=torch.float32, device=q.device)

    def merge(shift: int):
        """Merge, on every rank r, the block of rank (r - shift) mod p."""
        nonlocal o, m, l
        kb, vb = torch.roll(kf, shift, 0), torch.roll(vf, shift, 0)
        s = torch.einsum("rbqhd,rbkhd->rbhqk", qf, kb) * scale
        if causal:
            kpos = pos[(ranks - shift) % p]
            mask = pos[:, :, None] >= kpos[:, None, :]  # [p, q, k]
            s = torch.where(mask[:, None, None], s, NEG_INF)
        # the block max only keeps the exponent in range: the result does
        # not depend on it, so autograd takes no gradient through it
        mb = s.detach().amax(-1)
        pexp = torch.exp(s - mb[..., None])
        lb = pexp.sum(-1)
        ob = torch.einsum("rbhqk,rbkhd->rbqhd", pexp, vb)
        m_new = torch.maximum(m, mb)
        alpha, beta = torch.exp(m - m_new), torch.exp(mb - m_new)
        l = l * alpha + lb * beta
        o = o * alpha.transpose(2, 3)[..., None] + ob * beta.transpose(2, 3)[..., None]
        m = m_new

    if not bidir:
        for s in range(p):
            merge(s)
    else:
        # t = 0: the local block once; then the R chain's block (r - t) and,
        # while t <= nL, the L chain's (r + t). Under causal the JAX kernel
        # merges an L block only when r + t >= p; otherwise the block is from
        # a later rank, fully masked, and its merge is exact no-op (alpha 1,
        # beta 0), so merging it on every rank gives the same result.
        n_r, n_l = p // 2, (p - 1) // 2
        merge(0)
        for t in range(1, n_r + 1):
            merge(t)
            if t <= n_l:
                merge(-t)
    l = torch.clamp(l, min=1e-30)
    out = (o / l.transpose(2, 3)[..., None]).to(q.dtype)
    return out, m + torch.log(l)


def ring_attention_fwd(q, k, v, causal: bool = False, bidir: bool = False, stream=None):
    """Ring attention forward over the leading (ring) axis: ``(o, lse)``,
    ``o`` like ``q`` and ``lse`` ``[sp, b, h, n]`` f32. K8, or K9 with
    ``bidir=True``, for CUDA tensors (on ``stream``, default the current
    one); the plain version for CPU ones."""
    _check("ring_attention_fwd", q, k, v)
    if q.shape[0] == 1:
        return _full_fwd(q, k, v, causal)
    if q.device.type == "cpu":
        return ring_attention_fwd_plain(q, k, v, causal, bidir)
    _check_kernel("ring_attention_fwd", q, k, v)
    p, b, n, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((p, b, h, n), dtype=torch.float32, device=q.device)
    from ._build import check, launch

    if q.dtype == torch.bfloat16:
        call = _lib(q.dtype).tm_ring_attention_bf16_fwd
        err = launch(q.device, lambda s: call(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            p, b, n, h, d, int(causal), int(bidir), s), stream)
    else:
        call = _lib().tm_ring_attention_fwd
        err = launch(q.device, lambda s: call(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            DTYPES[q.dtype], p, b, n, h, d, int(causal), int(bidir), s), stream)
    check(err, "ring_attention_fwd")
    launches["ring_attention_fwd_bidir" if bidir else "ring_attention_fwd"] += 1
    return o, lse


# ---------------------------------------------------------------- backward


def ring_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = False):
    """Plain PyTorch version of :func:`ring_attention_bwd`
    (``_ring_attention_bwd_xla``): per ring step, rank r's gradients
    against the block of rank (r - s) mod p; each block's dK/dV sum over
    the visiting ranks in ring order, all in f32."""
    _check("ring_attention_bwd", q, k, v, o, do)
    p, b, n, h, d = q.shape
    if p == 1:
        raise ValueError("p == 1 has no ring; differentiate full attention")
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    D = torch.einsum("rbqhd,rbqhd->rbhq", dof, o.float())
    pos = _positions(p, n, q.device)
    ranks = torch.arange(p, device=q.device)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(qf)  # indexed by block: dk[j] is block j's sum
    dv = torch.zeros_like(qf)
    for s in range(p):
        kb, vb = torch.roll(kf, s, 0), torch.roll(vf, s, 0)
        sij = torch.einsum("rbqhd,rbkhd->rbhqk", qf, kb) * scale
        if causal:
            kpos = pos[(ranks - s) % p]
            mask = pos[:, :, None] >= kpos[:, None, :]
            sij = torch.where(mask[:, None, None], sij, NEG_INF)
        pij = torch.exp(sij - lse[..., None])
        dvb = torch.einsum("rbhqk,rbqhd->rbkhd", pij, dof)
        dp = torch.einsum("rbqhd,rbkhd->rbhqk", dof, vb)
        ds = pij * (dp - D[..., None])
        dq = dq + torch.einsum("rbhqk,rbkhd->rbqhd", ds, kb) * scale
        dkb = torch.einsum("rbhqk,rbqhd->rbkhd", ds, qf) * scale
        # rank r's contribution belongs to block r - s: block j takes rank j + s's
        dk = dk + torch.roll(dkb, -s, 0)
        dv = dv + torch.roll(dvb, -s, 0)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ring_attention_bwd(q, k, v, o, lse, do, causal: bool = False, stream=None):
    """Analytic ring attention backward from the forward's ``(o, lse)``:
    ``(dq, dk, dv)``. K10 (two launches: dQ, then dK/dV) for CUDA tensors
    (on ``stream``, default the current one); the plain version for CPU
    ones."""
    _check("ring_attention_bwd", q, k, v, o, do)
    if q.shape[0] == 1:
        raise ValueError("p == 1 has no ring; differentiate full attention")
    if q.device.type == "cpu":
        return ring_attention_bwd_plain(q, k, v, o, lse, do, causal)
    _check_kernel("ring_attention_bwd", q, k, v, o, do)
    p, b, n, h, d = q.shape
    if lse.shape != (p, b, h, n) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"ring_attention_bwd expects lse as contiguous f32 {(p, b, h, n)}")
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    from ._build import check, launch

    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    if q.dtype == torch.bfloat16:
        call = _lib(q.dtype).tm_ring_attention_bf16_bwd
        err = launch(q.device, lambda s: call(*ptrs, p, b, n, h, d, int(causal), s), stream)
    else:
        call = _lib().tm_ring_attention_bwd
        err = launch(q.device, lambda s: call(*ptrs, DTYPES[q.dtype], p, b, n, h, d,
                                               int(causal), s), stream)
    check(err, "ring_attention_bwd")
    launches["ring_attention_bwd"] += 2
    return dq, dk, dv


# ---------------------------------------------------------------- autograd


class RingAttention(torch.autograd.Function):
    """Differentiable ring attention (the JAX ``ring_attention`` custom VJP):
    ``RingAttention.apply(q, k, v, causal, bidir, bwd_kernel)``. The forward
    is K8 (K9 with ``bidir``) and saves ``(q, k, v, o, lse)``; the backward
    is K10 with ``bwd_kernel``, else the plain analytic ring backward. At
    p == 1 the backward is the gradient of full attention."""

    @staticmethod
    def forward(ctx, q, k, v, causal=False, bidir=False, bwd_kernel=False):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = ring_attention_fwd(q, k, v, causal, bidir)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.bwd_kernel = causal, bwd_kernel
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        if q.shape[0] == 1:
            with torch.enable_grad():
                leaves = [t[0].detach().requires_grad_() for t in (q, k, v)]
                out = full_attention_with_lse(*leaves, causal=ctx.causal)[0]
                grads = torch.autograd.grad(out, leaves, do[0])
            dq, dk, dv = (g[None] for g in grads)
        elif ctx.bwd_kernel:
            dq, dk, dv = ring_attention_bwd(q, k, v, o, lse, do, ctx.causal)
        else:
            dq, dk, dv = ring_attention_bwd_plain(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None, None, None
