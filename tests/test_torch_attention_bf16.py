"""The bf16 ring attention kernels' arithmetic against the JAX kernels, on
the CPU.

``torchmpi_tpu_torch/csrc/ring_attention_bf16.cu`` runs K8/K9 and K10 on
bf16 inputs on the bf16 tensor cores: S and dP as exact bf16 products
summed in f32, P and dS as two bf16 terms (hi and lo), each tile's sum
fresh and added in f32, the forward's 64-key tiles merged by an online
softmax. ``tests/test_torch_tf32.py`` emulates that arithmetic
(``ring_fwd`` and ``ring_bwd`` under ``product("bf16")``) and holds it to
f64; here the same emulation, with the kernels' bf16 outputs, is held to
``ring_attention_pallas``, ``ring_attention_bidir_pallas`` and
``ring_attention_bwd_pallas`` run in Pallas interpret mode under
``shard_map`` on the virtual CPU mesh, as ``tests/test_torch_attention.py``
and ``tests/test_torch_attention_bwd.py`` run them.

Inputs: bf16 values made with numpy from a seed, p = 4, b = 1, n_local =
80 (a whole 64-key tile and a ragged 16), h = 2, d = 16, causal and not.
The backward takes the JAX forward's ``(o, lse)`` on both sides. Limits:
``chip_smoke.py``'s bf16 ones, atol 2^-7 of max |JAX| plus rtol 2^-7
(both sides round an f32 result to bf16 from sums taken in another
order), and a zeroed output must fail them.
"""

import functools

import ml_dtypes
import numpy as np
import pytest
import torch

from test_torch_attention import LSE, SEQ, shard_map
from test_torch_tf32 import bf16_rn, product, ring_bwd, ring_fwd
from torchmpi_tpu.ops import ring_attention_kernel as jra

P, B, N, H, D = 4, 1, 80, 2, 16
BF16_REL = 2.0**-7  # chip_smoke.BF16_REL


def stack(x) -> torch.Tensor:
    """Gathered ``[b, p*n, h, d]`` -> rank-stacked ``[p, b, n, h, d]``, f32."""
    x = np.array(x, np.float32)
    return torch.from_numpy(np.ascontiguousarray(
        x.reshape(B, P, N, H, x.shape[-1]).transpose(1, 0, 2, 3, 4)))


def stack_lse(lse) -> torch.Tensor:
    """Gathered ``[b, h, p*n]`` -> ``[p, b, h, n]``."""
    x = np.array(lse, np.float32)
    return torch.from_numpy(np.ascontiguousarray(x.reshape(B, H, P, N).transpose(2, 0, 1, 3)))


@functools.lru_cache(maxsize=None)
def jax_case(causal: bool):
    """bf16 inputs and the JAX kernels' outputs, in one jitted call: K8's
    and K9's (o, lse), and K10's gradients from K8's (o, lse)."""
    rs = np.random.RandomState(25 + causal)
    x = [rs.randn(B, P * N, H, D).astype(ml_dtypes.bfloat16) for _ in range(4)]

    def body(q, k, v, do):
        kw = dict(causal=causal, axis_size=P, interpret=True)
        o, lse = jra.ring_attention_pallas(q, k, v, "sp", return_lse=True, **kw)
        ob, lseb = jra.ring_attention_bidir_pallas(q, k, v, "sp", return_lse=True, **kw)
        grads = jra.ring_attention_bwd_pallas(q, k, v, o, lse, do, "sp", **kw)
        return o, lse, ob, lseb, grads

    out = shard_map(body, P, (SEQ,) * 4, (SEQ, LSE, SEQ, LSE, (SEQ,) * 3))(*x)
    o, lse, ob, lseb, grads = out
    return ([stack(t) for t in x], (stack(o), stack_lse(lse)), (stack(ob), stack_lse(lseb)),
            [stack(g) for g in grads])


def within(got: torch.Tensor, want: torch.Tensor) -> bool:
    """``got`` within ``chip_smoke.py``'s bf16 limits of ``want``."""
    ref = want.abs()
    limit = BF16_REL * float(ref.max()) + BF16_REL * ref
    return bool(((got - want).abs() <= limit).all())


def hold(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """The bf16 limits hold, and would not hold for zeros."""
    assert within(got, want), f"{what}: max |emulated - JAX| {float((got - want).abs().max())}"
    assert not within(torch.zeros_like(want), want), f"{what}: the limits pass zeros"


def as_bf16(x: torch.Tensor) -> torch.Tensor:
    """An f32 result stored as the kernels store it: rounded to bf16."""
    return bf16_rn(x.float())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bidir", [False, True], ids=["k8", "k9"])
def test_emulated_forward_matches_pallas(causal, bidir):
    (q, k, v, _), fwd, fwd_bidir, _ = jax_case(causal)
    want_o, want_lse = fwd_bidir if bidir else fwd
    o, lse = ring_fwd(q, k, v, causal, bidir, product("bf16"))
    hold(as_bf16(o), want_o, "o")
    # lse is f32 on both sides: the f32 limit of tests/test_torch_attention.py
    assert float((lse - want_lse).abs().max()) <= 1e-4


@pytest.mark.parametrize("causal", [False, True])
def test_emulated_backward_matches_pallas(causal):
    (q, k, v, do), (o, lse), _, want = jax_case(causal)
    got = ring_bwd(q, k, v, o, lse, do, causal, product("bf16"))
    for g, w, name in zip(got, want, "qkv"):
        hold(as_bf16(g), w, f"d{name}")

