"""The numeric design of the tensor-core ring attention kernels, K8/K9
(forward) and K10 (backward), checked on the CPU.

f32 inputs (``torchmpi_tpu_torch/csrc/ring_attention.cu``). K10 runs the
five products of the ring attention backward (S = Q K^T, dP = dO V^T,
dV += P^T dO, dK += dS^T Q, dQ += dS K) as ``mma.sync`` with TF32 operands
and f32 accumulators. An f32 operand x is split into ``big = tf32_rna(x)``
and ``small = tf32_rna(x - big)``, and a product takes three terms,
``a_big b_small + a_small b_big`` then ``a_big b_big`` (3xTF32).

bf16 inputs (``csrc/ring_attention_bf16.cu``) run on the bf16 tensor
cores: S and dP (both operands bf16 inputs) are bf16 x bf16 products,
exact in f32 and summed in f32; P and dS (f32, from the softmax) go in as
two bf16 terms, ``hi = bf16_rn(x)`` and ``lo = bf16_rn(x - hi)``, and a
product with V, dO, Q or K takes ``lo b`` then ``hi b``. The emulation
sums each term's products in an f32 einsum; the tensor cores truncate as
they accumulate, which the kernels bound by summing each tile's product in
a fresh accumulator added in f32.

Here ``tf32_rna`` reproduces ``cvt.rna.tf32.f32`` on f32 bits (add 0x1000,
clear the low 13 bits; inf and nan pass) and ``bf16_rn`` the conversion
``cvt.rn.bf16.f32`` (to nearest, ties to even; inf and nan pass), each
pinned on hand-picked patterns. Values within one TF32 ulp of the largest
finite f32 are left out: what the hardware gives there is not pinned here.
The emulated backward repeats ``ops.ring_attention_bwd_plain``'s einsums
with each product so split, each term an f32 einsum (a product of two TF32
or two bf16 values is exact in f32, so only the sums round), and must stay
within ``ATTN_TOL["grad"]`` of ``chip_smoke.py`` (atol and rtol 2e-4, the
limits that hold K10 to its plain version on the card) of the same
backward in f64, at the SWEEP shapes of ``tests/test_torch_attention.py``
and at [4, 1, 1024, 2, 64] causal.

Plain 1xTF32 (``a_big b_big`` only), printed by
``test_1xtf32_is_worse_than_3xtf32`` and not held to the limits: at [4, 1,
1024, 2, 64] causal its largest errors against the f64 backward are
1.07e-3, 1.48e-3 and 1.88e-3 (dq, dk, dv), each past the 2e-4 limits,
where 3xTF32 gives 6.9e-7, 1.9e-6 and 3.6e-6; that is why K10 does not use
it. One bf16 term for P and dS (``hi b`` only, FlashAttention's form),
printed by ``test_one_bf16_term_is_worse_than_two`` and not held to the
limits: at the same shape about 5.4e-3, 4.3e-3 and 7.8e-3 (dq, dk, dv) and
2.1e-3 (o), each past its limit, where hi and lo give 4.9e-6, 4.9e-6,
9.3e-6 and 3.2e-6; that is why the bf16 kernels take two terms.

The forward (``fwd_mma_kernel``) takes S = Q K^T and P V by the same rule
(3xTF32 for f32 inputs; for bf16 S one exact term and P V hi and lo) and
merges 64-key tiles with an online softmax in the log2 domain, each tile's
P V summed fresh and added in f32. ``ring_fwd`` repeats that walk, in K8's
and in K9's visiting order, and must stay within ``ATTN_TOL["o"]`` (atol
2e-5) and ``["lse"]`` (1e-4) of ``forward64`` at the same shapes. Plain
1xTF32, printed by ``test_1xtf32_forward_is_worse_than_3xtf32`` and not
held to the limits: at [4, 1, 1024, 2, 64] causal its largest errors
against the f64 forward are 9.6e-4 (o) and 3.8e-4 (lse), each past its
limit, where 3xTF32 gives 4.9e-7 and 1.1e-6.
"""

import functools
import math

import numpy as np
import pytest
import torch

from test_torch_attention import SWEEP

GRAD_TOL = (2e-4, 2e-4)  # chip_smoke.ATTN_TOL["grad"]: atol, rtol
O_TOL, LSE_TOL = 2e-5, 1e-4  # chip_smoke.ATTN_TOL["o"], ["lse"]: atol
TILE = 64  # keys per key tile of the forward kernel
BIG = (4, 1, 1024, 2, 64)  # [p, b, n_local, h, d]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round an f32 tensor to TF32 (10 mantissa bits)
    to nearest, ties away from zero; inf and nan unchanged."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def bf16_rn(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rn.bf16.f32``: round an f32 tensor to bf16 (7 mantissa bits)
    to nearest, ties to even, kept as f32; inf and nan unchanged."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    rounded = ((bits + 0x7FFF + ((bits >> 16) & 1)) & ~0xFFFF).to(torch.int32).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def _f32(bits: int) -> torch.Tensor:
    return torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(torch.float32)


@pytest.mark.parametrize("bits,want", [
    (0x3F800000, 0x3F800000),  # 1.0 is a TF32 value
    (0x3F800FFF, 0x3F800000),  # below half an ulp: down
    (0x3F801000, 0x3F802000),  # 1 + 2^-11, exactly halfway: away from zero
    (0x3F803000, 0x3F804000),  # halfway above an odd TF32 value: up, as to even
    (0x3FFFF000, 0x40000000),  # halfway below 2: the carry enters the next binade
    (0xBF801000, 0xBF802000),  # a negative halfway value: away from zero
    (0xBF800FFF, 0xBF800000),  # a negative value below half an ulp
    (0x7F7FD000, 0x7F7FE000),  # large, two TF32 ulps below the largest finite f32
])
def test_tf32_rna_pins_the_hardware_rounding(bits, want):
    got = tf32_rna(_f32(bits)).view(torch.int32)
    assert int(got) & 0xFFFFFFFF == want


def test_tf32_rna_leaves_inf_and_nan():
    x = torch.tensor([float("inf"), float("-inf"), float("nan")])
    got = tf32_rna(x)
    assert torch.equal(got[:2], x[:2]) and bool(torch.isnan(got[2]))
    # and a TF32 value (bf16 values included) is a fixed point
    v = torch.randn(1000).to(torch.bfloat16).float()
    assert torch.equal(tf32_rna(v), v)


@pytest.mark.parametrize("bits,want", [
    (0x3F800000, 0x3F800000),  # 1.0 is a bf16 value
    (0x3F807FFF, 0x3F800000),  # below half an ulp: down
    (0x3F808000, 0x3F800000),  # 1 + 2^-8, exactly halfway above an even value: down to even
    (0x3F818000, 0x3F820000),  # halfway above an odd value: up to even
    (0x3F808001, 0x3F810000),  # just above halfway: up
    (0x3FFF8000, 0x40000000),  # halfway below 2: the carry enters the next binade
    (0xBF818000, 0xBF820000),  # a negative halfway value: to even, away from zero here
    (0xBF808000, 0xBF800000),  # a negative halfway value: to even, towards zero here
    (0x00012345, 0x00010000),  # a subnormal keeps its bits above the cut
    (0x7F7F7FFF, 0x7F7F0000),  # the largest bf16 value, from below half an ulp above it
    (0x7F7F8000, 0x7F800000),  # halfway above the largest bf16 value: up to even, inf
])
def test_bf16_rn_pins_the_hardware_rounding(bits, want):
    got = bf16_rn(_f32(bits)).view(torch.int32)
    assert int(got) & 0xFFFFFFFF == want


def test_bf16_rn_leaves_inf_and_nan_and_matches_torch():
    x = torch.tensor([float("inf"), float("-inf"), float("nan")])
    got = bf16_rn(x)
    assert torch.equal(got[:2], x[:2]) and bool(torch.isnan(got[2]))
    # PyTorch's own f32 -> bf16 conversion rounds the same way
    v = torch.from_numpy(np.random.RandomState(0).randn(10000).astype(np.float32) * 100)
    assert torch.equal(bf16_rn(v), v.to(torch.bfloat16).float())
    # and the hi / lo terms of an f32 value keep about 16 of its 24 bits
    hi = bf16_rn(v)
    lo = bf16_rn(v - hi)
    assert bool(((v - hi - lo).abs() <= v.abs() * 2.0**-16).all())


def _terms(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def product(rule: str):
    """An einsum whose operand products follow the kernels' rule: ``f32``
    (3xTF32), ``bf16`` (one exact term between two inputs, P or dS as bf16
    hi and lo terms, lo first), ``bf16_1term`` (P or dS as one bf16 term)
    or ``1xtf32`` (one rounded term); ``f64`` is the exact reference."""

    def mm(eq, a, b, inputs: bool):
        if rule == "f64":
            return torch.einsum(eq, a, b)
        if rule == "1xtf32":
            return torch.einsum(eq, tf32_rna(a), tf32_rna(b))
        if rule in ("bf16", "bf16_1term"):
            assert torch.equal(bf16_rn(b), b)  # the second operand is a bf16 input
            if inputs:
                assert torch.equal(bf16_rn(a), a)
                return torch.einsum(eq, a, b)
            hi = bf16_rn(a)
            if rule == "bf16_1term":
                return torch.einsum(eq, hi, b)
            return torch.einsum(eq, bf16_rn(a - hi), b) + torch.einsum(eq, hi, b)
        (a_big, a_small), (b_big, b_small) = _terms(a), _terms(b)
        return (torch.einsum(eq, a_big, b_small) + torch.einsum(eq, a_small, b_big)
                + torch.einsum(eq, a_big, b_big))

    return mm


def ring_bwd(q, k, v, o, lse, do, causal: bool, mm):
    """``ops.ring_attention_bwd_plain``'s arithmetic, block by block in
    ring order, with every product through ``mm`` (``inputs`` when both
    operands are the inputs q, k, v, dO), in the dtype of ``q``."""
    p, b, n, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    delta = torch.einsum("rbqhd,rbqhd->rbhq", do, o)
    pos = torch.arange(p * n).reshape(p, n)
    ranks = torch.arange(p)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(q), torch.zeros_like(q)
    for s in range(p):
        kb, vb = torch.roll(k, s, 0), torch.roll(v, s, 0)
        sij = mm("rbqhd,rbkhd->rbhqk", q, kb, True) * scale
        if causal:
            mask = pos[:, :, None] >= pos[(ranks - s) % p][:, None, :]
            sij = torch.where(mask[:, None, None], sij, -1e30)
        pij = torch.exp(sij - lse[..., None])
        dvb = mm("rbhqk,rbqhd->rbkhd", pij, do, False)
        dp = mm("rbqhd,rbkhd->rbhqk", do, vb, True)
        ds = pij * (dp - delta[..., None])
        dq = dq + mm("rbhqk,rbkhd->rbqhd", ds, kb, False) * scale
        dkb = mm("rbhqk,rbqhd->rbkhd", ds, q, False) * scale
        dk = dk + torch.roll(dkb, -s, 0)
        dv = dv + torch.roll(dvb, -s, 0)
    return dq, dk, dv


def forward64(q, k, v, causal: bool):
    """o and lse of ring attention in f64: full attention over the gathered
    sequence, back in the rank-stacked layout."""
    p, b, n, h, d = q.shape
    gather = lambda t: t.permute(1, 0, 2, 3, 4).reshape(b, p * n, h, d)  # noqa: E731
    s = torch.einsum("bqhd,bkhd->bhqk", gather(q), gather(k)) / math.sqrt(d)
    if causal:
        s = s.masked_fill(~torch.ones(p * n, p * n, dtype=torch.bool).tril(), -1e30)
    lse = torch.logsumexp(s, -1)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]), gather(v))
    return (o.reshape(b, p, n, h, d).permute(1, 0, 2, 3, 4),
            lse.reshape(b, h, p, n).permute(2, 0, 1, 3))


def visits(p: int, bidir: bool):
    """The shifts s of the blocks a rank visits, in order: rank r merges
    the block of rank (r - s) mod p (the kernel's ``visit_src``)."""
    if not bidir:
        return list(range(p))
    # the local block, then for t = 1, 2, .. the R chain's (r - t) and the
    # L chain's (r + t)
    return [0] + [(i + 1) // 2 if i % 2 else -((i + 1) // 2) for i in range(1, p)]


def ring_fwd(q, k, v, causal: bool, bidir: bool, mm):
    """``fwd_mma_kernel``'s arithmetic: every rank's queries walk the visited
    blocks in ``TILE``-key tiles with the online softmax in f32, in the log2
    domain (x = s scale log2 e, m the running max of x, P = 2^(x - m)), each
    tile's P V a fresh sum added to the rescaled accumulator; every product
    through ``mm``. Masked scores are -1e30, so their P is 0, and a tile all
    masked for a row leaves it as it was (the kernel skips such tiles)."""
    p, b, n, h, d = q.shape
    c = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) * math.log2(math.e)
    pos = torch.arange(p * n).reshape(p, n)
    ranks = torch.arange(p)
    m = torch.full((p, b, h, n), -1e30)
    l = torch.zeros((p, b, h, n))
    acc = torch.zeros_like(q)
    for shift in visits(p, bidir):
        kb, vb = torch.roll(k, shift, 0), torch.roll(v, shift, 0)
        kpos = pos[(ranks - shift) % p]
        for k0 in range(0, n, TILE):
            kt, vt = kb[:, :, k0:k0 + TILE], vb[:, :, k0:k0 + TILE]
            s = mm("rbqhd,rbkhd->rbhqk", q, kt, True)
            if causal:
                mask = pos[:, :, None] >= kpos[:, None, k0:k0 + TILE]
                s = torch.where(mask[:, None, None], s, -1e30)
            m_new = torch.maximum(m, s.amax(-1) * c)
            alpha = torch.exp2(m - m_new)
            pt = torch.exp2(s * c - m_new[..., None])
            l = l * alpha + pt.sum(-1)
            acc = acc * alpha.transpose(2, 3)[..., None] + mm("rbhqk,rbkhd->rbqhd", pt, vt, False)
            m = m_new
    l = torch.clamp(l, min=1e-30)
    return acc / l.transpose(2, 3)[..., None], m * math.log(2.0) + torch.log(l)


@functools.lru_cache(maxsize=None)
def case(shape, causal: bool, bf16: bool, seed: int):
    """Inputs (bf16 values when ``bf16``), the f64 (o, lse) and the f64
    gradients."""
    rs = np.random.RandomState(seed)
    x = [torch.from_numpy(rs.randn(*shape).astype(np.float32)) for _ in range(4)]
    if bf16:
        x = [t.to(torch.bfloat16).float() for t in x]
    q, k, v, do = x
    o, lse = forward64(q.double(), k.double(), v.double(), causal)
    want = ring_bwd(q.double(), k.double(), v.double(), o, lse, do.double(), causal,
                    product("f64"))
    return (q, k, v, o.float(), lse.float(), do), (o, lse), want


def fwd_err(rule: str, shape, causal: bool, bidir: bool, bf16: bool, seed: int):
    """o and lse of the ``rule`` forward against f64: whether each is
    within its limit, and its max |error|."""
    (q, k, v, *_), want, _ = case(shape, causal, bf16, seed)
    got = ring_fwd(q, k, v, causal, bidir, product(rule))
    ok, err = [], []
    for g, w, tol in zip(got, want, (O_TOL, LSE_TOL)):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        diff = (g.double() - w).abs()
        ok.append(bool((diff <= tol).all()))
        err.append(float(diff.max()))
    return ok, err


def max_err(rule: str, shape, causal: bool, bf16: bool, seed: int):
    """Each gradient of the ``rule`` backward against f64: whether it is
    within GRAD_TOL, and its max |error|."""
    inputs, _, want = case(shape, causal, bf16, seed)
    got = ring_bwd(*inputs, causal, product(rule))
    atol, rtol = GRAD_TOL
    ok, err = [], []
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        diff = (g.double() - w).abs()
        ok.append(bool((diff <= atol + rtol * w.abs()).all()))
        err.append(float(diff.max()))
    return ok, err


SHAPES = [((p, 2, 8, 2, 8), causal) for p, causal in SWEEP.args[1]] + [(BIG, True)]


@pytest.mark.parametrize("shape,causal", SHAPES)
@pytest.mark.parametrize("rule", ["f32", "bf16"])
def test_tensor_core_backward_holds_the_f32_limits(rule, shape, causal):
    """3xTF32 (f32 inputs) and the bf16 rule within atol and rtol 2e-4 of
    the f64 backward, for dq, dk and dv."""
    ok, err = max_err(rule, shape, causal, rule == "bf16", seed=sum(shape) + causal)
    assert all(ok), f"{rule} {shape} causal={causal}: max |err| {err}"


def test_one_bf16_term_is_worse_than_two(capsys):
    """P and dS as one bf16 term at the large shape, bf16 inputs: printed
    (the docstring records it), and worse than hi and lo on every gradient
    and on o."""
    seed = sum(BIG) + 1
    _, err2 = max_err("bf16", BIG, True, True, seed)
    _, err1 = max_err("bf16_1term", BIG, True, True, seed)
    _, ferr2 = fwd_err("bf16", BIG, True, False, True, seed)
    _, ferr1 = fwd_err("bf16_1term", BIG, True, False, True, seed)
    with capsys.disabled():
        print(f"\n{list(BIG)} causal, bf16 inputs, max |err| against f64: (dq, dk, dv) one "
              f"term {err1}, hi and lo {err2}; (o, lse) one term {ferr1}, hi and lo {ferr2}")
    assert all(e1 > 10 * e2 for e1, e2 in zip(err1 + ferr1[:1], err2 + ferr2[:1]))


def test_1xtf32_is_worse_than_3xtf32(capsys):
    """Plain TF32 at the large shape: printed (the docstring records it),
    and worse than 3xTF32 on every gradient."""
    seed = sum(BIG) + 1
    _, err3 = max_err("f32", BIG, True, False, seed)
    _, err1 = max_err("1xtf32", BIG, True, False, seed)
    with capsys.disabled():
        print(f"\n{list(BIG)} causal, max |err| against f64 (dq, dk, dv): "
              f"1xTF32 {err1}, 3xTF32 {err3}")
    assert all(e1 > 10 * e3 for e1, e3 in zip(err1, err3))


@pytest.mark.parametrize("shape,causal", SHAPES)
@pytest.mark.parametrize("bidir", [False, True], ids=["k8", "k9"])
@pytest.mark.parametrize("rule", ["f32", "bf16"])
def test_tensor_core_forward_holds_the_f32_limits(rule, bidir, shape, causal):
    """The forward's 64-key tiles, online softmax, 3xTF32 (f32 inputs) and
    bf16 rule, in K8's and K9's visiting order, within atol 2e-5 (o) and
    1e-4 (lse) of the f64 forward."""
    ok, err = fwd_err(rule, shape, causal, bidir, rule == "bf16", seed=sum(shape) + causal)
    assert all(ok), f"{rule} bidir={bidir} {shape} causal={causal}: max |err| (o, lse) {err}"


def test_1xtf32_forward_is_worse_than_3xtf32(capsys):
    """Plain TF32 forward at the large shape: printed (the docstring
    records it), and worse than 3xTF32 on o and lse."""
    seed = sum(BIG) + 1
    _, err3 = fwd_err("f32", BIG, True, False, False, seed)
    _, err1 = fwd_err("1xtf32", BIG, True, False, False, seed)
    with capsys.disabled():
        print(f"\n{list(BIG)} causal, max |err| against the f64 forward (o, lse): "
              f"1xTF32 {err1}, 3xTF32 {err3}")
    assert all(e1 > 10 * e3 for e1, e3 in zip(err1, err3))
