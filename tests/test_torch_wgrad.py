"""The per-rank convolution weight gradient and the per-rank product
(ROADMAP C6's repair) on the CPU: ``ops.conv2d_weight_grad_ranks``,
``ops.rank_bmm`` and the engine's vmap context
``engine.rankwise.rank_products``.

- the plain version (``torch.nn.grad.conv2d_weight`` a rank at a time)
  against ``jax.grad`` of the JAX LeNet's convolutions (flax ``Conv`` with
  its features, 5 x 5 kernels and ``SAME`` padding, channels-last) on the
  same inputs drawn from numpy seeds, within ``JAX_RTOL`` (f32 sums in
  another order: XLA's convolution against ATen's);
- a rank's result bit for bit the same in stacks of 8, 4 and 2, as the
  kernel's is on the card (its tiles and slices of K come from the shape
  alone: :func:`ops.rank_gemm.plan` never reads R);
- under ``rank_products`` (a dispatch mode over the physical
  ``convolution_backward`` and ``bmm`` that vmap issues) the vmap
  gradient of the port's LeNet bit for bit the same rank by rank in stacks
  of 8, 4 and 2, and within ``LOOP_RTOL`` of the loop's per-rank gradient;
  its convolutions' weight gradient goes through the wrapper once a
  convolution for all the ranks, and a grouped convolution's once for
  every rank's groups;
- ``ops.rank_bmm``'s plain version (``a[r] @ b[r]`` a rank at a time)
  against ``jax.vjp`` of flax's ``Dense`` (the JAX MLP6's layer): its
  forward and both gradients within ``JAX_RTOL``; a rank's product bit for
  bit the same in stacks of 8, 4 and 2 at any strides; under
  ``rank_products`` the vmap gradient of the port's MLP6 (config 5's
  model) bit for bit the same rank by rank in stacks of 8, 4 and 2, every
  product one wrapper call for the stack;
- the wrappers' checks. The engine's CPU vmap (one rank at a time) is
  unchanged: ``tests/test_torch_xproc_sharded.py``'s C6 test holds it.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmpi_tpu_torch import ops
from torchmpi_tpu_torch.engine.rankwise import rank_products
from torchmpi_tpu_torch.models import MLP6, LeNet, init_params, make_loss_fn
from torchmpi_tpu_torch.ops import conv_wgrad, rank_bmm_kernel, rank_gemm

JAX_RTOL = 1e-5
LOOP_RTOL = 1e-5
R = 8
# the JAX LeNet's two convolutions: (in channels, out channels, image side)
LENET_CONVS = {"conv0": (1, 32, 28), "conv1": (32, 64, 14)}


def _draw(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_weight_grad(x_nhwc, dy_nhwc, cin, cout):
    """``jax.grad`` of the JAX LeNet's convolution (flax ``Conv(cout, (5,
    5), padding="SAME")``) with respect to its kernel, for the output
    gradient ``dy``: HWIO."""
    import flax.linen as fnn

    conv = fnn.Conv(cout, (5, 5), padding="SAME", use_bias=False)
    kernel = jnp.zeros((5, 5, cin, cout), jnp.float32)

    def loss(k):
        return jnp.sum(conv.apply({"params": {"kernel": k}}, x_nhwc) * dy_nhwc)

    return np.asarray(jax.grad(loss)(kernel))


@pytest.mark.parametrize("name", list(LENET_CONVS))
def test_plain_matches_jax_lenet_convolution(name):
    cin, cout, side = LENET_CONVS[name]
    B = 3
    x = _draw((R, B, cin, side, side), 1)
    dy = _draw((R, B, cout, side, side), 2)
    got = ops.conv2d_weight_grad_ranks_plain(torch.from_numpy(x), torch.from_numpy(dy),
                                             (cout, cin, 5, 5), 1, 2, 1)
    for r in range(R):
        want = _jax_weight_grad(jnp.asarray(x[r].transpose(0, 2, 3, 1)),
                                jnp.asarray(dy[r].transpose(0, 2, 3, 1)), cin, cout)
        np.testing.assert_allclose(got[r].numpy(), want.transpose(3, 2, 0, 1), rtol=JAX_RTOL,
                                   atol=JAX_RTOL * np.abs(want).max())


@pytest.mark.parametrize("shape", [(R, 4, 32, 14, 14, 64, 5, 1, 2, 1),
                                   (R, 2, 3, 17, 17, 16, 7, 2, 3, 1),
                                   (R, 3, 5, 9, 11, 70, 3, 1, 2, 2)],
                         ids=["conv1", "stem", "dilated"])
def test_rank_result_independent_of_the_stack(shape):
    """Rank r's gradient is the same bits in one stack of 8 ranks, in two
    of 4 and in four of 2, and through the wrapper (the plain version on
    the CPU)."""
    _, B, C, H, W, O, k, st, pd, dl = shape
    Ho = (H + 2 * pd - dl * (k - 1) - 1) // st + 1
    Wo = (W + 2 * pd - dl * (k - 1) - 1) // st + 1
    x = torch.from_numpy(_draw((R, B, C, H, W), 3))
    dy = torch.from_numpy(_draw((R, B, O, Ho, Wo), 4))
    whole = ops.conv2d_weight_grad_ranks(x, dy, (O, C, k, k), st, pd, dl)
    assert torch.equal(whole, ops.conv2d_weight_grad_ranks_plain(x, dy, (O, C, k, k), st, pd, dl))
    for m in (4, 2):
        parts = torch.cat([ops.conv2d_weight_grad_ranks(x[a:a + m], dy[a:a + m], (O, C, k, k),
                                                        st, pd, dl) for a in range(0, R, m)])
        assert torch.equal(parts, whole), m


@pytest.mark.parametrize("o, n, k", [(64, 800, 8232), (32, 25, 32928), (512, 4608, 1568),
                                     (64, 147, 401408), (3, 63, 25), (42, 256, 3136),
                                     (8, 10, 128)])
def test_splits_come_from_the_shape(o, n, k):
    """The plan of a launch (``ops.rank_gemm.plan``): the smallest of mma's
    16-row steps that holds M, else 64 rows; 32 columns where N fits, else
    128 beside 64 rows and 64 beside fewer; slices of K that are whole
    stages, cover K, give about ``BLOCKS_PER_RANK`` blocks a rank, number at
    most ``MAX_SPLITS`` and, where there are several, are each at least
    ``MIN_SLICE`` deep."""
    p = rank_gemm.plan(o, n, k)
    assert p.bm == next((b for b in (16, 32, 48) if o <= b), 64) and p.bm >= min(o, 64)
    assert p.bn == (32 if n <= 32 else 128 if p.bm == 64 else 64)
    assert p.tiles == -(-o // p.bm) * -(-n // p.bn)
    assert p.kc % rank_gemm.BK == 0 and p.splits * p.kc >= k > (p.splits - 1) * p.kc
    assert p.splits <= rank_gemm.MAX_SPLITS
    assert p.splits == 1 or (p.tiles * p.splits <= 2 * rank_gemm.BLOCKS_PER_RANK
                             and p.kc >= rank_gemm.MIN_SLICE)


def test_plan_is_the_same_whatever_the_stack():
    """The plan reads (M, N, K) alone: the wrappers derive them from a
    stack of 8, 4 or 2 ranks alike (LeNet's two convolutions and its
    dense0 products, config 5's dense0), so every rank's slices of K are
    the same in any stack."""
    assert list(inspect.signature(rank_gemm.plan).parameters) == ["m", "n", "k"]
    for m in (R, 4, 2):
        plans = []
        for name, (cin, cout, side) in LENET_CONVS.items():
            x, dy = torch.zeros(m, 42, cin, side, side), torch.zeros(m, 42, cout, side, side)
            dims = conv_wgrad._check(x, dy, (cout, cin, 5, 5), 1, 2, 1)
            B, C, O, Ho, Wo, kh, kw = dims[1], dims[2], dims[5], dims[6], dims[7], dims[8], dims[9]
            plans.append(rank_gemm.plan(O, C * kh * kw, B * Ho * Wo))
        for shape_a, shape_b in (((42, 3136), (3136, 256)), ((256, 42), (42, 3136)),
                                 ((42, 256), (256, 3136)), ((8, 784), (784, 128))):
            _, M, N, K = rank_bmm_kernel._check(torch.zeros(m, *shape_a), torch.zeros(m, *shape_b))
            plans.append(rank_gemm.plan(M, N, K))
        if m == R:
            first = plans
        assert plans == first, m
    assert first[1] == rank_gemm.Plan(64, 128, 7, 7, 1184)  # conv1: 7 slices of 1184


def _lenet_case(seed):
    model = LeNet()
    params = {k: v.unsqueeze(0).repeat((R,) + (1,) * v.ndim)
              for k, v in init_params(model, seed=0).items()}
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((R, 6, 784)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (R, 6)))
    return params, (x, y), torch.func.grad(make_loss_fn(model))


def test_vmap_gradient_is_the_same_in_any_stack(monkeypatch):
    """Under ``rank_products`` the vmap gradient of LeNet over 8 ranks
    is every rank's bits in stacks of 4 and of 2, each convolution's weight
    gradient one wrapper call for the whole stack."""
    params, (x, y), grad = _lenet_case(5)
    calls = []
    real = ops.conv2d_weight_grad_ranks

    def spy(xs, *a, **kw):
        calls.append(xs.shape[0])
        return real(xs, *a, **kw)

    monkeypatch.setattr(ops, "conv2d_weight_grad_ranks", spy)
    g = torch.func.vmap(grad)
    with rank_products():
        whole = g(params, (x, y))
        assert calls == [R, R]  # conv1, then conv0, each over the 8 ranks
        for m in (4, 2):
            parts = [g({k: v[a:a + m] for k, v in params.items()}, (x[a:a + m], y[a:a + m]))
                     for a in range(0, R, m)]
            for k in whole:
                assert torch.equal(torch.cat([q[k] for q in parts]), whole[k]), (k, m)


def test_vmap_gradient_matches_the_loop():
    """Under ``rank_products`` every leaf of the vmap gradient is within
    ``LOOP_RTOL`` of the per-rank loop's (the convolutions' weight gradient
    by ``torch.nn.grad.conv2d_weight``, the rest by the batched ops)."""
    params, (x, y), grad = _lenet_case(6)
    with rank_products():
        got = torch.func.vmap(grad)(params, (x, y))
    for r in range(R):
        want = grad({k: v[r] for k, v in params.items()}, (x[r], y[r]))
        for k, w in want.items():
            torch.testing.assert_close(got[k][r], w, rtol=LOOP_RTOL,
                                       atol=LOOP_RTOL * float(w.abs().max()))


def test_grouped_and_padded_convolutions_take_the_kernel(monkeypatch):
    """A grouped convolution is a convolution a group: under the context
    its weight gradient is the wrapper's over the groups (under vmap, the
    ranks times the groups) and within ``LOOP_RTOL`` of the native one,
    and so is a ``'same'``-padded one's; an f64 convolution stays
    native."""
    calls = []
    real = ops.conv2d_weight_grad_ranks

    def spy(xs, *a, **kw):
        calls.append(xs.shape[0])
        return real(xs, *a, **kw)

    monkeypatch.setattr(ops, "conv2d_weight_grad_ranks", spy)

    def f(xr, wr, groups, padding):
        return torch.nn.functional.conv2d(xr, wr, padding=padding, groups=groups).square().sum()

    g = torch.func.vmap(torch.func.grad(f, argnums=1), in_dims=(0, 0, None, None))
    gen = torch.Generator().manual_seed(7)
    cases = [(torch.randn(R, 2, 4, 6, 6, generator=gen), torch.randn(R, 4, 2, 3, 3, generator=gen),
              2, 1, R * 2),
             (torch.randn(R, 2, 4, 6, 6, generator=gen), torch.randn(R, 4, 4, 3, 3, generator=gen),
              1, "same", R),
             (torch.randn(R, 2, 4, 6, 6, generator=gen, dtype=torch.float64),
              torch.randn(R, 4, 4, 3, 3, generator=gen, dtype=torch.float64), 1, 1, None)]
    for *case, launched in cases:
        calls.clear()
        with rank_products():
            got = g(*case)
        assert calls == ([] if launched is None else [launched])
        want = g(*case)
        torch.testing.assert_close(got, want, rtol=LOOP_RTOL,
                                   atol=LOOP_RTOL * float(want.abs().max()))


def test_wrapper_checks_its_arguments():
    x = torch.zeros(2, 1, 3, 6, 6)
    with pytest.raises(ValueError, match="disagree"):
        ops.conv2d_weight_grad_ranks(x, torch.zeros(2, 1, 5, 4, 4), (4, 3, 3, 3))
    with pytest.raises(ValueError, match="are not the convolution's"):
        ops.conv2d_weight_grad_ranks(x, torch.zeros(2, 1, 4, 5, 5), (4, 3, 3, 3))
    with pytest.raises(ValueError, match=r"x \[R, B, C, H, W\]"):
        ops.conv2d_weight_grad_ranks(x[0], torch.zeros(1, 4, 4, 4), (4, 3, 3, 3))


def _jax_dense_products(x, w, dy):
    """flax ``Dense`` (the JAX MLP6's layer, kernel ``[in, out]``) at
    ``x`` ``[B, in]``: its output, and by ``jax.vjp`` for the output
    gradient ``dy`` the kernel's and the input's gradients."""
    import flax.linen as fnn

    dense = fnn.Dense(w.shape[1], use_bias=False)
    y, vjp = jax.vjp(lambda k, xx: dense.apply({"params": {"kernel": k}}, xx), w, x)
    dk, dx = vjp(dy)
    return np.asarray(y), np.asarray(dk), np.asarray(dx)


@pytest.mark.parametrize("width_in, width_out", [(784, 128), (128, 128), (128, 10)],
                         ids=["dense0", "hidden", "head"])
def test_rank_bmm_plain_matches_jax_dense(width_in, width_out):
    """The three products of a dense layer under the engine's vmap, as vmap
    issues them (the port's weight is ``[out, in]``): the forward ``x @
    W^T``, the weight gradient ``dy^T @ x`` and the input gradient ``dy @
    W``, each by ``rank_bmm_plain`` over 8 ranks, against flax ``Dense``'s
    forward and ``jax.vjp`` rank by rank, within ``JAX_RTOL``."""
    B = 8
    x, w, dy = _draw((R, B, width_in), 11), _draw((R, width_out, width_in), 12), \
        _draw((R, B, width_out), 13)
    tx, tw, tdy = (torch.from_numpy(v) for v in (x, w, dy))
    got_y = ops.rank_bmm_plain(tx, tw.transpose(1, 2)).numpy()
    got_dw = ops.rank_bmm_plain(tdy.transpose(1, 2), tx).numpy()
    got_dx = ops.rank_bmm_plain(tdy, tw).numpy()
    for r in range(R):
        y, dk, dx = _jax_dense_products(jnp.asarray(x[r]), jnp.asarray(w[r].T), jnp.asarray(dy[r]))
        for got, want in ((got_y[r], y), (got_dw[r], dk.T), (got_dx[r], dx)):
            np.testing.assert_allclose(got, want, rtol=JAX_RTOL,
                                       atol=JAX_RTOL * np.abs(want).max())


@pytest.mark.parametrize("layout", ["contiguous", "a_transposed", "b_transposed", "b_expanded"])
def test_rank_bmm_independent_of_the_stack(layout):
    """Rank r's product is the same bits in one stack of 8 ranks, in two of
    4 and in four of 2, whatever the operands' strides (a transposed view,
    an operand vmap expanded over the ranks), and the wrapper's on the CPU
    is its plain version."""
    M, K, N = 8, 784, 128
    a = torch.from_numpy(_draw((R, M, K), 14))
    b = torch.from_numpy(_draw((R, K, N), 15))
    if layout == "a_transposed":
        a = a.transpose(1, 2).contiguous().transpose(1, 2)
    elif layout == "b_transposed":
        b = b.transpose(1, 2).contiguous().transpose(1, 2)
    elif layout == "b_expanded":
        b = b[:1].expand(R, K, N)
    whole = ops.rank_bmm(a, b)
    assert torch.equal(whole, ops.rank_bmm_plain(a, b))
    for m in (4, 2):
        parts = torch.cat([ops.rank_bmm(a[i:i + m], b[i:i + m]) for i in range(0, R, m)])
        assert torch.equal(parts, whole), m


def _mlp6_case(seed):
    model = MLP6(features=128)
    params = {k: v.unsqueeze(0).repeat((R,) + (1,) * v.ndim)
              for k, v in init_params(model, seed=0).items()}
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((R, 8, 784)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (R, 8)))
    return params, (x, y), torch.func.grad(make_loss_fn(model))


def test_mlp6_vmap_gradient_is_the_same_in_any_stack(monkeypatch):
    """Under ``rank_products`` the vmap gradient of config 5's MLP6 over 8
    ranks is every rank's bits in stacks of 4 and of 2, and within
    ``LOOP_RTOL`` of the per-rank loop's; its 17 products (6 forwards, 6
    weight gradients, 5 input gradients) each one ``rank_bmm`` call for the
    whole stack."""
    params, (x, y), grad = _mlp6_case(16)
    calls = []
    real = ops.rank_bmm

    def spy(a, b, *rest, **kw):
        calls.append(a.shape[0])
        return real(a, b, *rest, **kw)

    monkeypatch.setattr(ops, "rank_bmm", spy)
    g = torch.func.vmap(grad)
    with rank_products():
        whole = g(params, (x, y))
        assert calls == [R] * 17
        for m in (4, 2):
            parts = [g({k: v[a:a + m] for k, v in params.items()}, (x[a:a + m], y[a:a + m]))
                     for a in range(0, R, m)]
            for k in whole:
                assert torch.equal(torch.cat([q[k] for q in parts]), whole[k]), (k, m)
    for r in range(R):
        want = grad({k: v[r] for k, v in params.items()}, (x[r], y[r]))
        for k, w in want.items():
            torch.testing.assert_close(whole[k][r], w, rtol=LOOP_RTOL,
                                       atol=LOOP_RTOL * float(w.abs().max()))


def test_rank_bmm_checks_its_arguments():
    with pytest.raises(ValueError, match=r"a \[R, M, K\] and b \[R, K, N\]"):
        ops.rank_bmm(torch.zeros(2, 3, 4), torch.zeros(2, 5, 6))
    with pytest.raises(ValueError, match=r"a \[R, M, K\] and b \[R, K, N\]"):
        ops.rank_bmm(torch.zeros(3, 4), torch.zeros(4, 6))
