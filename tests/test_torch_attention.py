"""The port's ring attention forward (``torchmpi_tpu_torch.ops.
ring_attention_kernel``) and ``parallel`` package against the JAX package,
on the CPU. The backward's parity is ``tests/test_torch_attention_bwd.py``.

The port's wrappers run their plain PyTorch versions here (a CPU tensor).
The JAX kernels run in Pallas interpret mode under ``shard_map`` on the
virtual CPU mesh, as ``tests/test_ops.py`` runs them, at p in {2, 3, 4},
causal and not, b=2, n_local=8, h=2, d=8. Inputs are made with numpy from
a seed and handed to both; the JAX layout is the gathered ``[b, p*n, h, d]``
and the port's the rank-stacked ``[p, b, n, h, d]``.

Tolerances, those of the JAX kernel tests: K8's output atol 2e-5
(``test_ops.py:819``) and its lse 1e-4; K9 rtol and atol 2e-4
(``:1177-1181``); gradients rtol and atol 2e-4 (``:1119-1121``); bf16
outputs atol 5e-2 (``:849-851``).
"""

import functools
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torchmpi_tpu as jmpi
from torchmpi_tpu.ops import ring_attention_kernel as jra
from torchmpi_tpu.parallel import make_parallel_mesh as jmesh
from torchmpi_tpu.parallel.ring_attention import full_self_attention as jfull
from torchmpi_tpu.parallel.ring_attention import ring_self_attention as jring
from torchmpi_tpu_torch import ops
from torchmpi_tpu_torch.ops import ring_attention_kernel as tra
from torchmpi_tpu_torch.parallel import (
    full_self_attention,
    make_parallel_mesh,
    ring_self_attention,
)

B, N, H, D = 2, 8, 2, 8
SEQ = P(None, "sp")  # the gathered sequence axis is sharded over sp
LSE = P(None, None, "sp")


@pytest.fixture(autouse=True)
def _fresh_counts():
    ops.reset_launch_counts()
    yield
    # a CPU tensor runs the plain versions: no kernel launched
    assert not any(ops.launch_counts().values())


def inputs(p: int, seed: int, count: int = 4):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, p * N, H, D).astype(np.float32) for _ in range(count)]


def stack(x) -> torch.Tensor:
    """Gathered ``[b, p*n, h, d]`` -> rank-stacked ``[p, b, n, h, d]``."""
    x = np.array(x, np.float32)
    b, t, h, d = x.shape
    p = t // N
    return torch.from_numpy(np.ascontiguousarray(x.reshape(b, p, N, h, d).transpose(1, 0, 2, 3, 4)))


def stack_lse(lse) -> torch.Tensor:
    """Gathered ``[b, h, p*n]`` -> ``[p, b, h, n]``."""
    x = np.array(lse, np.float32)
    b, h, t = x.shape
    return torch.from_numpy(np.ascontiguousarray(x.reshape(b, h, t // N, N).transpose(2, 0, 1, 3)))


def shard_map(fn, p, in_specs, out_specs):
    mesh = Mesh(np.array(jax.devices()[:p]), ("sp",))
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                                 check_vma=False))


@functools.lru_cache(maxsize=None)
def _jax_forward(p: int, causal: bool):
    """The JAX forward kernels at (p, causal), with their lse, in one call."""
    q, k, v = inputs(p, 31 * p + causal, 3)

    def body(q, k, v):
        kw = dict(causal=causal, axis_size=p, interpret=True, return_lse=True)
        return (jra.ring_attention_pallas(q, k, v, "sp", **kw)
                + jra.ring_attention_bidir_pallas(q, k, v, "sp", **kw))

    out = shard_map(body, p, (SEQ,) * 3, (SEQ, LSE, SEQ, LSE))(q, k, v)
    return (q, k, v), [np.asarray(t) for t in out]


SWEEP = pytest.mark.parametrize("p,causal", [(p, c) for p in (2, 3, 4) for c in (False, True)])


def close(got: torch.Tensor, want, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol, err_msg=what)


@SWEEP
def test_k8_plain_matches_pallas(p, causal):
    (q, k, v), (o, lse, _, _) = _jax_forward(p, causal)
    got_o, got_lse = ops.ring_attention_fwd(stack(q), stack(k), stack(v), causal)
    assert got_o.dtype == torch.float32 and got_lse.shape == (p, B, H, N)
    close(got_o, stack(o), 2e-5, what="o")
    close(got_lse, stack_lse(lse), 1e-4, what="lse")
    # the wrapper on a CPU tensor is the plain version
    po, plse = ops.ring_attention_fwd_plain(stack(q), stack(k), stack(v), causal)
    assert torch.equal(po, got_o) and torch.equal(plse, got_lse)


@SWEEP
def test_k9_plain_matches_pallas(p, causal):
    (q, k, v), (o, lse, ob, lseb) = _jax_forward(p, causal)
    got_o, got_lse = ops.ring_attention_fwd(stack(q), stack(k), stack(v), causal, bidir=True)
    close(got_o, stack(ob), 2e-4, 2e-4, "bidir o")
    close(got_lse, stack_lse(lseb), 1e-4, what="bidir lse")
    # and K9 against K8's JAX output: one function, another visiting order
    close(got_o, stack(o), 2e-4, 2e-4, "bidir against unidirectional")


def test_bf16_k8_matches_pallas():
    """bf16 in, f32 arithmetic, bf16 out (lse f32), at p=4, causal."""
    p = 4
    rs = np.random.RandomState(7)
    q, k, v = (rs.randn(1, p * N, H, D).astype(ml_dtypes.bfloat16) for _ in range(3))
    o, lse = shard_map(
        lambda q, k, v: jra.ring_attention_pallas(q, k, v, "sp", causal=True, axis_size=p,
                                                  interpret=True, return_lse=True),
        p, (SEQ,) * 3, (SEQ, LSE),
    )(q, k, v)
    assert o.dtype == jnp.bfloat16
    got_o, got_lse = ops.ring_attention_fwd(*(stack(t).to(torch.bfloat16) for t in (q, k, v)), True)
    assert got_o.dtype == torch.bfloat16 and got_lse.dtype == torch.float32
    close(got_o, stack(np.asarray(o, np.float32)), 5e-2, what="bf16 o")
    close(got_lse, stack_lse(lse), 1e-4, what="bf16 lse")


def test_p1_is_full_attention():
    """p == 1 has no ring: the forward is full attention with its lse and
    the backward the gradient of full attention (JAX
    ``_full_attention_with_lse`` and the vjp of ``full_self_attention``)."""
    q, k, v, do = inputs(1, 3)
    for causal in (False, True):
        @jax.jit
        def reference(q, k, v, do):
            _, vjp = jax.vjp(lambda q, k, v: jfull(q, k, v, causal=causal), q, k, v)
            return jra._full_attention_with_lse(q, k, v, causal), vjp(do)

        (o, lse), grads = reference(q, k, v, do)
        got_o, got_lse = ops.ring_attention_fwd(stack(q), stack(k), stack(v), causal)
        close(got_o, stack(o), 2e-5, what="p=1 o")
        close(got_lse, stack_lse(lse), 1e-4, what="p=1 lse")
        leaves = [stack(t).requires_grad_() for t in (q, k, v)]
        for bwd_kernel in (False, True):
            out = ops.RingAttention.apply(*leaves, causal, False, bwd_kernel)
            got = torch.autograd.grad(out, leaves, stack(do))
            for g, want in zip(got, grads):
                close(g, stack(want), 2e-5, 2e-5, "p=1 grad")
    with pytest.raises(ValueError, match="no ring"):
        ops.ring_attention_bwd(*(stack(t) for t in (q, k, v, q)), torch.zeros(1, B, H, N),
                               stack(do))


def test_full_self_attention_matches_jax():
    q, k, v = inputs(1, 5, 3)
    for causal in (False, True):
        got = full_self_attention(*(torch.from_numpy(t) for t in (q, k, v)), causal=causal)
        close(got, jfull(q, k, v, causal=causal), 2e-5, what=f"causal={causal}")


@pytest.mark.parametrize("causal", [False, True])
def test_xla_backend_matches_jax_xla_ring(causal):
    """The 'xla' backend (the ppermute ring on the rank axis, autograd
    through it) against the JAX ``'xla'`` ring: output and gradients."""
    p = 4
    q, k, v, do = inputs(p, 11 + causal)

    def body(q, k, v, do):
        def loss(q, k, v):
            out = jring(q, k, v, "sp", causal=causal, backend="xla")
            return jnp.sum(out * do), out

        (_, out), g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
        return out, g

    out, g = shard_map(body, p, (SEQ,) * 4, (SEQ, (SEQ,) * 3))(q, k, v, do)
    leaves = [stack(t).requires_grad_() for t in (q, k, v)]
    got = ring_self_attention(*leaves, causal=causal, backend="xla")
    close(got.detach(), stack(out), 2e-5, what="xla o")
    for gg, want in zip(torch.autograd.grad(got, leaves, stack(do)), g):
        close(gg, stack(want), 2e-4, 2e-4, "xla grad")


@pytest.mark.parametrize("backend", [
    "auto", "kernel", "kernel_full", "kernel_bidir", "kernel_bidir_full",
])
def test_backend_tokens_agree(backend):
    """Every kernel token (on the CPU: the plain versions) and 'auto' (on
    the CPU: the 'xla' ring) give the 'xla' ring's output and gradients."""
    p = 3
    q, k, v, do = (stack(t) for t in inputs(p, 2))
    outs = {}
    for name in ("xla", backend):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = ring_self_attention(*leaves, causal=True, backend=name)
        outs[name] = (out.detach(), torch.autograd.grad(out, leaves, do))
    close(outs[backend][0], outs["xla"][0], 2e-5)
    for got, want in zip(outs[backend][1], outs["xla"][1]):
        close(got, want.numpy(), 2e-4, 2e-4)


@pytest.mark.parametrize("backend", ["pallas", "kernel_interpret", "kernel_bidirx", "bogus"])
def test_unknown_backend_token_raises(backend):
    q = torch.zeros(2, 1, 4, 1, 8)
    with pytest.raises(ValueError, match="unknown ring-attention backend"):
        ring_self_attention(q, q, q, backend=backend)


def test_wrapper_input_checks():
    q = torch.zeros(2, 1, 4, 1, 8)
    with pytest.raises(ValueError, match="rank-stacked"):
        ops.ring_attention_fwd(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="equal shapes"):
        ops.ring_attention_fwd(q, q, torch.zeros(2, 1, 5, 1, 8))
    # off the CPU the kernel path raises for what the kernels do not take
    # (no plain fallback), and on a device that is not CUDA
    m = torch.zeros(2, 1, 4, 1, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ops.ring_attention_fwd(m, m, m)
    h = m.to(torch.float16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        ops.ring_attention_fwd(h, h, h)
    w = torch.zeros(2, 1, 4, 1, 24, device="meta")
    with pytest.raises(ValueError, match="head_dim"):
        ops.ring_attention_bwd(w, w, w, w, torch.zeros(2, 1, 1, 4, device="meta"), w)
    assert tra.HEAD_DIMS == (8, 16, 32, 64, 128)


@pytest.mark.parametrize("axes", [
    {"dp": 8}, {"dp": 2, "sp": 4}, {"dp": -1, "sp": 2}, {"dp": 2, "tp": 2, "sp": -1},
])
def test_mesh_layout_matches_jax(axes):
    """The port's index layout is the JAX mesh's device order (rank r on
    device r of the 8-device CPU mesh)."""
    jmpi.start()
    try:
        mesh = jmesh(jmpi.current_communicator(), axes)
        ids = np.vectorize(lambda d: d.id)(mesh.devices)
    finally:
        jmpi.stop()
    layout = make_parallel_mesh(8, axes)
    assert layout.axis_names == tuple(mesh.axis_names)
    assert layout.shape == ids.shape
    np.testing.assert_array_equal(layout.ranks, ids - ids.min())


@pytest.mark.parametrize("axes,match", [
    ({"dp": -1, "sp": -1}, "at most one"),
    ({"dp": -1, "sp": 3}, "cannot infer"),
    ({"dp": 2, "sp": 2}, "do not cover"),
])
def test_mesh_layout_rejects(axes, match):
    with pytest.raises(ValueError, match=match):
        make_parallel_mesh(8, axes)


def test_scale_is_inverse_sqrt_head_dim():
    """One key per query: attention returns v exactly, whatever the scale;
    two keys with scores 0 and sqrt(d) weight the second by e/(1+e)."""
    q = torch.zeros(2, 1, 1, 1, 4)
    k = torch.zeros(2, 1, 1, 1, 4)
    q[..., 0] = 1.0
    k[1, ..., 0] = 4.0  # rank 1's key scores q.k / sqrt(4) = 2
    v = torch.zeros(2, 1, 1, 1, 4)
    v[1, ..., 1] = 1.0
    o, lse = ops.ring_attention_fwd(q, k, v)
    w = math.exp(2.0) / (1 + math.exp(2.0))
    assert abs(float(o[0, 0, 0, 0, 1]) - w) < 1e-6
    assert abs(float(lse[0, 0, 0, 0]) - math.log(1 + math.exp(2.0))) < 1e-5
