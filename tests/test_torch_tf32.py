"""The numeric design of K10's tensor-core backward, checked on the CPU.

K10 (``torchmpi_tpu_torch/csrc/ring_attention.cu``) runs the five products
of the ring attention backward (S = Q K^T, dP = dO V^T, dV += P^T dO,
dK += dS^T Q, dQ += dS K) as ``mma.sync`` with TF32 operands and f32
accumulators. An f32 operand x is split into ``big = tf32_rna(x)`` and
``small = tf32_rna(x - big)``, and a product takes three terms,
``a_big b_small + a_small b_big`` then ``a_big b_big`` (3xTF32). A bf16
value is exact in TF32, so for bf16 inputs S and dP (both operands bf16)
take one term, and the three products with P or dS (f32) two,
``P_small b + P_big b``.

Here ``tf32_rna`` reproduces ``cvt.rna.tf32.f32`` on f32 bits (add 0x1000,
clear the low 13 bits; inf and nan pass), pinned on hand-picked patterns.
Values within one TF32 ulp of the largest finite f32 are left out: what the
hardware gives there is not pinned here. The emulated backward repeats
``ops.ring_attention_bwd_plain``'s einsums with each product so split, each
term an f32 einsum (a product of two TF32 values is exact in f32, so only
the sums round), and must stay within ``ATTN_TOL["grad"]`` of
``chip_smoke.py`` (atol and rtol 2e-4, the limits that hold K10 to its
plain version on the card) of the same backward in f64, at the SWEEP shapes
of ``tests/test_torch_attention.py`` and at [4, 1, 1024, 2, 64] causal.

Plain 1xTF32 (``a_big b_big`` only), printed by
``test_1xtf32_is_worse_than_3xtf32`` and not asserted: at [4, 1, 1024, 2,
64] causal its largest errors against the f64 backward are 1.07e-3,
1.48e-3 and 1.88e-3 (dq, dk, dv), each past the 2e-4 limits, where
3xTF32 gives 6.9e-7, 1.9e-6 and 3.6e-6; that is why K10 does not use it.
"""

import functools
import math

import numpy as np
import pytest
import torch

from test_torch_attention import SWEEP

GRAD_TOL = (2e-4, 2e-4)  # chip_smoke.ATTN_TOL["grad"]: atol, rtol
BIG = (4, 1, 1024, 2, 64)  # [p, b, n_local, h, d]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round an f32 tensor to TF32 (10 mantissa bits)
    to nearest, ties away from zero; inf and nan unchanged."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
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


def _terms(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def product(rule: str):
    """An einsum whose operand products follow K10's rule: ``f32``
    (3xTF32), ``bf16`` (one term between two inputs, two with P or dS) or
    ``1xtf32`` (one rounded term); ``f64`` is the exact reference."""

    def mm(eq, a, b, inputs: bool):
        if rule == "f64":
            return torch.einsum(eq, a, b)
        if rule == "1xtf32":
            return torch.einsum(eq, tf32_rna(a), tf32_rna(b))
        if rule == "bf16":
            assert torch.equal(tf32_rna(b), b)  # the second operand is an input
            if inputs:
                return torch.einsum(eq, a, b)
            a_big, a_small = _terms(a)
            return torch.einsum(eq, a_small, b) + torch.einsum(eq, a_big, b)
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
    return (q, k, v, o.float(), lse.float(), do), want


def max_err(rule: str, shape, causal: bool, bf16: bool, seed: int):
    """Each gradient of the ``rule`` backward against f64: whether it is
    within GRAD_TOL, and its max |error|."""
    inputs, want = case(shape, causal, bf16, seed)
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
