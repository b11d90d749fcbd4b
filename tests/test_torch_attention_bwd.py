"""The port's ring attention backward (K10's plain version and
``RingAttention``) against the JAX package, on the CPU; the forward's
parity is ``tests/test_torch_attention.py``, whose helpers this file uses.

At p in {2, 3, 4}, causal and not, b=2, n_local=8, h=2, d=8, one jitted JAX
call per (p, causal) takes the forward's residuals ``(o, lse)`` from
``_ring_attention_fwd_xla`` (the JAX wrappers' own stand-in for the
kernel, the same arithmetic) and runs both branches of the
``ring_attention`` custom VJP's backward on them and a cotangent ``do``:
``ring_attention_bwd_pallas`` in Pallas interpret mode (``bwd_kernel=
True``) and ``_ring_attention_bwd_xla`` (the default). That is what
``jax.grad`` of ``ring_attention`` computes for the loss ``sum(o * do)``;
``test_ring_attention_matches_jax_grad`` runs ``jax.grad`` itself at p=2.

Tolerance: rtol and atol 2e-4 (``test_ops.py:1119-1121``); a bf16
gradient is rounded to bf16 (2^-8 relative) from f32 sums taken in another
order, so it gets atol 5e-2 and rtol 1e-2.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from test_torch_attention import (
    LSE,
    SEQ,
    SWEEP,
    H,
    N,
    close,
    inputs,
    shard_map,
    stack,
    stack_lse,
)
from torchmpi_tpu.ops import ring_attention_kernel as jra
from torchmpi_tpu_torch import ops


@pytest.fixture(autouse=True)
def _fresh_counts():
    ops.reset_launch_counts()
    yield
    # a CPU tensor runs the plain versions: no kernel launched
    assert not any(ops.launch_counts().values())


@functools.lru_cache(maxsize=None)
def _jax_backward(p: int, causal: bool):
    """Residuals and both JAX backward branches at (p, causal)."""
    q, k, v, do = inputs(p, 53 * p + causal)

    def body(q, k, v, do):
        o, lse = jra._ring_attention_fwd_xla(q, k, v, "sp", causal, p, True)
        g_kernel = jra.ring_attention_bwd_pallas(q, k, v, o, lse, do, "sp", causal=causal,
                                                 axis_size=p, interpret=True)
        return o, lse, g_kernel, jra._ring_attention_bwd_xla(q, k, v, o, lse, do, "sp", causal, p)

    out = shard_map(body, p, (SEQ,) * 4, (SEQ, LSE, (SEQ,) * 3, (SEQ,) * 3))(q, k, v, do)
    return (q, k, v, do), jax.tree_util.tree_map(np.asarray, out)


@SWEEP
def test_k10_plain_matches_pallas(p, causal):
    (q, k, v, do), (o, lse, g_kernel, _) = _jax_backward(p, causal)
    got = ops.ring_attention_bwd(stack(q), stack(k), stack(v), stack(o), stack_lse(lse),
                                 stack(do), causal)
    for g, want, name in zip(got, g_kernel, "qkv"):
        assert g.dtype == torch.float32
        close(g, stack(want), 2e-4, 2e-4, f"d{name}")


@SWEEP
@pytest.mark.parametrize("bwd_kernel", [False, True])
def test_ring_attention_grads_match_jax(p, causal, bwd_kernel):
    """``RingAttention`` against the JAX ``ring_attention``'s backward: with
    ``bwd_kernel`` K10 (JAX: ``ring_attention_bwd_pallas`` on the saved
    residuals), without it the analytic ring backward (JAX:
    ``_ring_attention_bwd_xla``)."""
    (q, k, v, do), (_, _, g_kernel, g_xla) = _jax_backward(p, causal)
    leaves = [stack(t).requires_grad_() for t in (q, k, v)]
    out = ops.RingAttention.apply(*leaves, causal, False, bwd_kernel)
    got = torch.autograd.grad(out, leaves, stack(do))
    for g, want, name in zip(got, g_kernel if bwd_kernel else g_xla, "qkv"):
        close(g, stack(want), 2e-4, 2e-4, f"d{name}")


@pytest.mark.parametrize("bwd_kernel", [False, True])
def test_ring_attention_matches_jax_grad(bwd_kernel):
    """``RingAttention`` against ``jax.grad`` of the JAX custom VJP, end to
    end, at p=2, causal. Inside ``shard_map`` each rank differentiates its
    local ``sum(o * do)``; the ring backward carries the cross-rank terms."""
    p = 2
    q, k, v, do = inputs(p, 77)

    def body(q, k, v, do):
        def loss(q, k, v):
            return jnp.sum(jra.ring_attention(q, k, v, "sp", True, p, True, bwd_kernel) * do)

        return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

    want = shard_map(body, p, (SEQ,) * 4, (SEQ,) * 3)(q, k, v, do)
    leaves = [stack(t).requires_grad_() for t in (q, k, v)]
    out = ops.RingAttention.apply(*leaves, True, False, bwd_kernel)
    for g, w, name in zip(torch.autograd.grad(out, leaves, stack(do)), want, "qkv"):
        close(g, stack(w), 2e-4, 2e-4, f"d{name}")


def test_bf16_k10_matches_pallas():
    """bf16 in, f32 arithmetic, bf16 gradients, at p=2, causal."""
    p = 2
    rs = np.random.RandomState(9)
    q, k, v, do = (rs.randn(1, p * N, H, 8).astype(ml_dtypes.bfloat16) for _ in range(4))

    def body(q, k, v, do):
        o, lse = jra._ring_attention_fwd_xla(q, k, v, "sp", True, p, True)
        return o, lse, jra.ring_attention_bwd_pallas(q, k, v, o, lse, do, "sp", causal=True,
                                                     axis_size=p, interpret=True)

    o, lse, want = shard_map(body, p, (SEQ,) * 4, (SEQ, LSE, (SEQ,) * 3))(q, k, v, do)
    as_port = lambda x: stack(np.asarray(x, np.float32)).to(torch.bfloat16)  # noqa: E731
    got = ops.ring_attention_bwd(*(as_port(t) for t in (q, k, v, o)), stack_lse(lse),
                                 as_port(do), True)
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == torch.bfloat16
        close(g, stack(np.asarray(w, np.float32)), 5e-2, 1e-2, f"bf16 d{name}")
