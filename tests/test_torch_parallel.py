"""The port's tensor, pipeline and expert parallelism
(``torchmpi_tpu_torch.parallel``: ``axis``, ``tp``, ``pp``, ``ep``, and the
``in_graph_*`` syncs of ``torchmpi_tpu_torch.nn``) against the JAX
package's on the CPU.

The JAX functions run as ``tests/test_parallel.py`` runs them: under
``shard_map`` on the 8 virtual CPU devices, rank r on device r of a mesh
laid out as the port's ``MeshLayout``. Inputs come from numpy seeds and
parameters carry over through ``models.convert``. On the CPU every
:func:`axis_psum` runs K3's plain version. Tolerances:

- integer axis sums (inner and outer axes): exact, against the closed
  form "rank r contributes r" and against ``lax.psum``;
- the roll and the block transpose: exact against ``lax.ppermute`` and
  ``lax.all_to_all`` (they move values);
- f32 outputs and gradients: atol 1e-5 (``test_parallel.py``'s MPLinear
  and MoE limits are 1e-4 and 1e-5; the sums here differ from XLA's only
  in the order of adds). MPLinear's gradients of ``sum(out ** 2)`` reach
  600: there rtol 1e-5, and atol the larger of 1e-5 and one f32 spacing
  of the largest value (2^-23 max|value|), which an entry that cancels
  terms of that size carries;
- the pipelines against JAX and the sequential chain: loss rtol 1e-5,
  gradients rtol 1e-4 / atol 1e-6 (``test_parallel.py:314-339``);
- the 1F1B schedule arrays and stash sizes: equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from torchmpi_tpu import nn as jnn
from torchmpi_tpu.parallel import MPLinear as JMPLinear
from torchmpi_tpu.parallel import MPLinearOutputSplit as JMPLinearOutputSplit
from torchmpi_tpu.parallel import moe_dispatch_combine as jmoe
from torchmpi_tpu.parallel import moe_load_stats as jstats
from torchmpi_tpu.parallel import pipeline_1f1b_value_and_grad as j1f1b
from torchmpi_tpu.parallel import pipeline_forward as jforward
from torchmpi_tpu.parallel import pipeline_loss_fn as jloss_fn
from torchmpi_tpu.parallel import shard_input_features as jshard
from torchmpi_tpu.parallel import pp as jpp
from torchmpi_tpu_torch import nn as tnn
from torchmpi_tpu_torch.models import axis_stack_from_jax, mplinear_from_jax
from torchmpi_tpu_torch.ops import ring_kernels
from torchmpi_tpu_torch.parallel import (
    MPLinear,
    MPLinearOutputSplit,
    axis_all_to_all,
    axis_pmean,
    axis_ppermute,
    axis_psum,
    make_parallel_mesh,
    moe_dispatch_combine,
    moe_load_stats,
    pipeline_1f1b_value_and_grad,
    pipeline_forward,
    pipeline_loss_fn,
    shard_input_features,
)
from torchmpi_tpu_torch.parallel import pp as tpp


@pytest.fixture(autouse=True)
def _fresh_port():
    yield
    from torchmpi_tpu_torch import constants

    constants._reset_for_tests()


MESHES = [{"tp": 8}, {"dp": 2, "tp": 4}, {"dp": 2, "pp": 2, "tp": 2}, {"dp": 4, "pp": 2}]


def jax_mesh(axes: dict) -> Mesh:
    p = int(np.prod(list(axes.values())))
    return Mesh(np.array(jax.devices()[:p]).reshape(tuple(axes.values())), tuple(axes))


def smap(fn, axes, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=jax_mesh(axes), in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def every_axis():
    return [(axes, a) for axes in MESHES for a in axes]


def stacked(axes):
    """The out_spec that stacks every device's ``[1, ...]`` result in rank
    order."""
    return P(tuple(axes))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def assert_close_scaled(got, want, rtol=0.0, atol=1e-5):
    """Within ``atol`` or one f32 spacing of the largest value compared
    (an entry that cancels large terms carries their rounding), and
    ``rtol``."""
    scale = 2.0**-23 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=max(atol, scale))


# ----------------------------------------------------------------- axis ops


@pytest.mark.parametrize("axes,axis", every_axis())
def test_axis_psum_integers_exact(axes, axis):
    """Rank r contributes r (and 1000 r + j in column j): each group gets
    its own closed-form sum, over inner and outer axes, equal to lax.psum."""
    layout = make_parallel_mesh(8, axes)
    x = (np.arange(8)[:, None] * 1000 + np.arange(5)[None]).astype(np.int32)
    got = axis_psum(t(x), layout, axis).numpy()
    for r in range(8):
        coords = {a: layout.axis_index(a)[r] for a in axes}
        group = [q for q in range(8)
                 if all(layout.axis_index(a)[q] == coords[a] for a in axes if a != axis)]
        np.testing.assert_array_equal(got[r], x[group].sum(0))
    want = smap(lambda v: lax.psum(v, axis), axes, stacked(axes), stacked(axes))(x)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("axes,axis", every_axis())
def test_axis_psum_gradient_is_the_psum_of_cotangents(axes, axis):
    """check_vma=False: the VJP of psum psums the per-rank cotangents, and
    axis_pmean is the sum over the axis size."""
    layout = make_parallel_mesh(8, axes)
    rng = np.random.RandomState(0)
    x, w = rng.randn(8, 6).astype(np.float32), rng.randn(8, 6).astype(np.float32)

    def jfn(xx, ww):
        return jax.grad(lambda v: jnp.sum(lax.psum(v, axis) * ww))(xx)

    want = smap(jfn, axes, (stacked(axes),) * 2, stacked(axes))(x, w)
    xt = t(x).requires_grad_()
    (axis_psum(xt, layout, axis) * t(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=1e-5)
    mean = smap(lambda v: lax.pmean(v, axis), axes, stacked(axes), stacked(axes))(x)
    np.testing.assert_allclose(axis_pmean(t(x), layout, axis).numpy(), np.asarray(mean),
                               atol=1e-6)


@pytest.mark.parametrize("axes,axis", every_axis())
def test_ppermute_and_all_to_all_move_values_as_jax(axes, axis):
    layout = make_parallel_mesh(8, axes)
    size = axes[axis]
    x = np.arange(8 * size * 3, dtype=np.float32).reshape(8, size, 3)
    for shift in (1, -1):
        perm = [(i, (i + shift) % size) for i in range(size)]
        want = smap(lambda v: lax.ppermute(v, axis, perm), axes, stacked(axes), stacked(axes))(x)
        np.testing.assert_array_equal(axis_ppermute(t(x), layout, axis, shift).numpy(),
                                      np.asarray(want))
    want = smap(lambda v: lax.all_to_all(v[0], axis, 0, 0, tiled=True)[None], axes,
                stacked(axes), stacked(axes))(x)
    np.testing.assert_array_equal(axis_all_to_all(t(x), layout, axis).numpy(),
                                  np.asarray(want))


def test_axis_psum_launches_one_grouped_kernel(monkeypatch):
    """One K3 call over every group (groups = p / size), on the innermost
    row order; the backward one more."""
    calls = []
    real = ring_kernels.ring_allreduce

    def spy(x, groups=1, stream=None):
        calls.append((tuple(x.shape), groups))
        return real(x, groups)

    monkeypatch.setattr(ring_kernels, "ring_allreduce", spy)
    layout = make_parallel_mesh(8, {"dp": 2, "tp": 4})
    x = torch.randn(8, 3, requires_grad=True)
    axis_psum(x, layout, "dp").sum().backward()
    assert calls == [((8, 3), 4), ((8, 3), 4)]


def test_axis_ops_check_their_inputs():
    layout = make_parallel_mesh(8, {"dp": 2, "tp": 4})
    with pytest.raises(ValueError, match="rank-stacked"):
        axis_psum(torch.zeros(4, 2), layout, "tp")
    with pytest.raises(ValueError, match="no axis"):
        axis_psum(torch.zeros(8, 2), layout, "pp")
    with pytest.raises(ValueError, match="blocks"):
        axis_all_to_all(torch.zeros(8, 2), layout, "tp")


# ---------------------------------------------------------------- tp


def _jax_mplinear(x, features, seed, use_bias=True, bias=None):
    """test_parallel.py's MPLinear on tp=8: the output, the per-device
    kernel shards ([8, in/8, f]) and bias, and the per-device gradients of
    sum(out ** 2) for x, the kernel and the bias."""
    model = JMPLinear(features=features, axis="tp", use_bias=use_bias)

    def fn(x_full):
        x_loc = jshard(x_full, "tp")
        params = model.init(jax.random.PRNGKey(seed), x_loc)["params"]
        if bias is not None:
            params = {**params, "bias": jnp.asarray(bias)}

        def loss(xf, prm):
            return jnp.sum(model.apply({"params": prm}, jshard(xf, "tp")) ** 2)

        gx, gp = jax.grad(loss, argnums=(0, 1))(x_full, params)
        out = model.apply({"params": params}, x_loc)
        return (out[None], jax.tree_util.tree_map(lambda a: a[None], params), gx[None],
                jax.tree_util.tree_map(lambda a: a[None], gp))

    return jax.device_get(smap(fn, {"tp": 8}, P(), P("tp"))(x))


@pytest.mark.parametrize("use_bias,bias", [(True, None), (True, np.arange(16)), (False, None)])
def test_mplinear_matches_jax(use_bias, bias):
    """test_parallel.py:44-153's cases: outputs and the x, kernel and bias
    gradients of every rank, the JAX shards carried over."""
    rng = np.random.RandomState(1)
    x = rng.randn(4, 64).astype(np.float32)
    bias = None if bias is None else bias.astype(np.float32)
    out, params, gx, gp = _jax_mplinear(x, 16, 1, use_bias, bias)
    layout = make_parallel_mesh(8, {"tp": 8})
    model = MPLinear(64, 16, layout, use_bias=use_bias)
    model.load_state_dict(mplinear_from_jax({k: v for k, v in params.items()}, layout))
    xt = t(np.broadcast_to(x, (8,) + x.shape)).requires_grad_()
    y = model(shard_input_features(xt, layout))
    close = functools.partial(assert_close_scaled, rtol=1e-5)
    close(y.detach().numpy(), out)
    (y ** 2).flatten(1).sum(1).sum().backward()
    close(xt.grad.numpy(), gx)
    close(model.kernel.grad.numpy(), gp["kernel"])
    if use_bias:
        close(model.bias.grad.numpy(), gp["bias"])


def test_mplinear_bias_once_and_symmetric_gradient():
    """test_parallel.py:88-129: a zero input gives the bias exactly once on
    every rank, and the bias gradient of sum(out) is batch 3 x 8 ranks x
    1/8 = 3.0 on every rank (psum's VJP psums the cotangents)."""
    layout = make_parallel_mesh(8, {"tp": 8})
    model = MPLinear(32, 8, layout)
    with torch.no_grad():
        model.bias.copy_(torch.arange(8.0).expand(8, 8))
    out = model(shard_input_features(torch.zeros(8, 3, 32), layout))
    np.testing.assert_allclose(out.detach().numpy(), np.tile(np.arange(8.0), (8, 3, 1)),
                               atol=1e-6)
    out.flatten(1).sum(1).sum().backward()
    np.testing.assert_allclose(model.bias.grad.numpy(), 3.0, atol=1e-5)


def test_mplinear_on_an_outer_tp_axis_and_dp():
    """tp outside dp ({"tp": 4, "dp": 2}, strided rows): the same outputs as
    the dense product on every rank."""
    layout = make_parallel_mesh(8, {"tp": 4, "dp": 2})
    gen = torch.Generator().manual_seed(0)
    model = MPLinear(16, 5, layout, generator=gen)
    x = torch.randn(2, 3, 16, generator=gen)[layout.axis_index("dp")]
    full = torch.cat([model.kernel[int(np.nonzero(layout.axis_index("tp") == c)[0][0])]
                      for c in range(4)])
    y = model(shard_input_features(x, layout))
    np.testing.assert_allclose(y.detach().numpy(), (x @ full).detach().numpy(), atol=1e-5)


def test_mplinear_converter_forms_on_dp_and_tp():
    """dp 2 x tp 4: the full [in, features] kernel and JAX's per-device
    [p, in / tp, features] shards convert to the same state, whose outputs
    are JAX's on every rank (atol 1e-5); any other kernel shape raises."""
    axes = {"dp": 2, "tp": 4}
    layout = make_parallel_mesh(8, axes)
    rng = np.random.RandomState(4)
    kernel = rng.randn(16, 5).astype(np.float32)
    bias = rng.randn(5).astype(np.float32)
    x = rng.randn(2, 3, 16).astype(np.float32)
    model = JMPLinear(features=5, axis="tp")

    def fn(k_loc, xx):
        out = model.apply({"params": {"kernel": k_loc, "bias": bias}}, jshard(xx[0], "tp"))
        return out[None], k_loc[None]

    out, shards = jax.device_get(smap(fn, axes, (P("tp"), P("dp")),
                                      (stacked(axes), stacked(axes)))(kernel, x))
    xt = t(x)[layout.axis_index("dp")]
    states = [mplinear_from_jax({"kernel": k, "bias": bias}, layout) for k in (kernel, shards)]
    for state in states:
        port = MPLinear(16, 5, layout)
        port.load_state_dict(state)
        np.testing.assert_allclose(port(shard_input_features(xt, layout)).detach().numpy(),
                                   out, atol=1e-5)
    for name in ("kernel", "bias"):
        assert torch.equal(states[0][name], states[1][name])
    with pytest.raises(ValueError, match="MPLinear kernel"):
        mplinear_from_jax({"kernel": shards[:4]}, layout)
    with pytest.raises(ValueError, match="not divisible"):
        mplinear_from_jax({"kernel": kernel[:15]}, layout)


def test_mplinear_output_split_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(8, 3, 12).astype(np.float32)
    model = JMPLinearOutputSplit(features_per_shard=5)

    def fn(xx):
        params = model.init(jax.random.PRNGKey(0), xx[0])
        params = jax.tree_util.tree_map(
            lambda a: a + 0.1 * lax.axis_index("tp").astype(a.dtype), params)
        return model.apply(params, xx[0])[None], jax.tree_util.tree_map(
            lambda a: a[None], params["params"])

    out, params = jax.device_get(smap(fn, {"tp": 8}, P("tp"), P("tp"))(x))
    layout = make_parallel_mesh(8, {"tp": 8})
    port = MPLinearOutputSplit(12, 5, layout)
    port.load_state_dict({k: t(v) for k, v in params.items()})
    np.testing.assert_allclose(port(t(x)).detach().numpy(), out, atol=1e-5)


def test_shard_input_features_matches_jax_and_checks_width():
    layout = make_parallel_mesh(8, {"dp": 2, "tp": 4})
    x = np.random.RandomState(3).randn(8, 2, 12).astype(np.float32)
    want = smap(lambda v: jshard(v, "tp"), {"dp": 2, "tp": 4}, stacked(layout.axis_names),
                stacked(layout.axis_names))(x)
    np.testing.assert_array_equal(shard_input_features(t(x), layout).numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="not divisible by tp=4"):
        shard_input_features(torch.zeros(8, 2, 10), layout)
    with pytest.raises(ValueError, match="not divisible by tp=4"):
        MPLinear(10, 3, layout)


# ---------------------------------------------------------------- pp


def _pp_setup(p, d=16, m=6, mb=3, seed=0):
    rng = np.random.RandomState(seed)
    Ws = rng.randn(p, d, d).astype(np.float32) * 0.3
    micro = rng.randn(m, mb, d).astype(np.float32)
    tgt = np.random.RandomState(seed + 100).randn(m, mb, d).astype(np.float32)
    return Ws, micro, tgt


def _jstage(w, x):
    return jnp.tanh(x @ w[0])


def _tstage(w, x):
    return torch.tanh(torch.bmm(x, w))


def _seq_loss_and_grad(Ws, micro, tgt):
    def seq_loss(W):
        y = jnp.asarray(micro)
        for s in range(W.shape[0]):
            y = jnp.tanh(y @ W[s])
        return jnp.mean((y - jnp.asarray(tgt)) ** 2)

    loss, g = jax.value_and_grad(seq_loss)(jnp.asarray(Ws))
    return float(loss), np.asarray(g)


def _replicated(layout, a):
    return t(np.broadcast_to(a, (layout.num_ranks,) + a.shape))


@pytest.mark.parametrize("p,m", [(1, 3), (2, 4), (4, 3), (4, 6), (8, 8), (4, 32)])
def test_1f1b_plan_equals_jax(p, m):
    """The schedule arrays and the stash sizes are JAX's for every (p, m)
    of test_parallel.py:791 (and m = 8p)."""
    want, got = jpp._one_f_one_b_plan(p, m), tpp._one_f_one_b_plan(p, m)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:] == want[2:]


@pytest.mark.parametrize("p,m", [(2, 6), (4, 1), (4, 9), (8, 6)])
def test_pipeline_forward_matches_jax_and_sequential(p, m):
    Ws, micro, _ = _pp_setup(p, m=m, seed=m)
    want = smap(lambda w, x: jforward(_jstage, w, x, "pp"), {"pp": p}, (P("pp"), P()),
                P())(Ws, micro)
    layout = make_parallel_mesh(p, {"pp": p})
    got = pipeline_forward(_tstage, t(Ws), _replicated(layout, micro), layout)
    seq = micro
    for s in range(p):
        seq = np.tanh(seq @ Ws[s])
    for r in range(p):
        np.testing.assert_allclose(got[r].numpy(), np.asarray(want), rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(got[r].numpy(), seq, rtol=2e-5, atol=1e-6)


def _mse_lanes(outs, tgt):
    return ((outs - tgt) ** 2).flatten(1).mean(1)


@pytest.mark.parametrize("p,convention", [(2, "grad-inside"), (4, "grad-inside"),
                                          (8, "grad-inside"), (2, "grad-outside"),
                                          (4, "grad-outside")])
def test_gpipe_loss_and_grads_match_jax(p, convention):
    """Both conventions under their own reduction of the lanes ('grad-inside':
    sum, 'grad-outside': mean) give JAX's loss and every stage's sequential
    gradient; under the other reduction they are off by exactly p."""
    Ws, micro, tgt = _pp_setup(p, seed=p + (20 if convention == "grad-outside" else 0))
    jfn = jloss_fn(_jstage, lambda o, tt: jnp.mean((o - tt) ** 2), "pp", convention=convention)
    if convention == "grad-inside":
        jl, jg = smap(lambda W, x, tt: jax.value_and_grad(jfn)(W, x, tt), {"pp": p},
                      (P("pp"), P(), P()), (P(), P("pp")))(Ws, micro, tgt)
    else:
        jl, jg = jax.value_and_grad(smap(jfn, {"pp": p}, (P("pp"), P(), P()), P()))(
            jnp.asarray(Ws), jnp.asarray(micro), jnp.asarray(tgt))
    seq_loss, seq_g = _seq_loss_and_grad(Ws, micro, tgt)
    layout = make_parallel_mesh(p, {"pp": p})
    fn = pipeline_loss_fn(_tstage, _mse_lanes, layout, convention=convention)
    W = t(Ws).requires_grad_()
    lanes = fn(W, _replicated(layout, micro), _replicated(layout, tgt))
    reduce = (lambda v: v.sum()) if convention == "grad-inside" else (lambda v: v.mean())
    reduce(lanes).backward()
    np.testing.assert_allclose(lanes.detach().numpy(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(lanes.detach().numpy(), seq_loss, rtol=1e-5)
    np.testing.assert_allclose(W.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(W.grad.numpy(), seq_g, rtol=1e-4, atol=1e-6)
    # the other reduction: p or 1/p off
    W2 = t(Ws).requires_grad_()
    other = (lambda v: v.mean()) if convention == "grad-inside" else (lambda v: v.sum())
    other(fn(W2, _replicated(layout, micro), _replicated(layout, tgt))).backward()
    scale = 1 / p if convention == "grad-inside" else p
    np.testing.assert_allclose(W2.grad.numpy(), seq_g * scale, rtol=1e-4, atol=1e-6)


def test_pipeline_invalid_convention_raises():
    layout = make_parallel_mesh(2, {"pp": 2})
    with pytest.raises(ValueError, match="convention"):
        pipeline_loss_fn(_tstage, _mse_lanes, layout, convention="both")


@pytest.mark.parametrize("p,m", [(1, 3), (2, 4), (4, 3), (4, 6), (8, 8)])
def test_1f1b_loss_and_grads_match_jax(p, m):
    """test_parallel.py:791's cases: JAX's loss and stage gradients, and the
    sequential chain's."""
    Ws, micro, tgt = _pp_setup(p, m=m, seed=p * 10 + m)
    jfn = j1f1b(_jstage, lambda y, tt: jnp.mean((y - tt) ** 2), "pp")
    jl, jg = smap(jfn, {"pp": p}, (P("pp"), P(), P()), (P(), P("pp")))(Ws, micro, tgt)
    seq_loss, seq_g = _seq_loss_and_grad(Ws, micro, tgt)
    layout = make_parallel_mesh(p, {"pp": p})
    fn = pipeline_1f1b_value_and_grad(_tstage, _mse_lanes, layout)
    loss, g = fn(t(Ws), _replicated(layout, micro), _replicated(layout, tgt))
    np.testing.assert_allclose(loss.numpy(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(loss.numpy(), seq_loss, rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), seq_g, rtol=1e-4, atol=1e-6)


def test_1f1b_runs_only_the_active_stages_rows():
    """Idle slots compute nothing: the stage sees only the rows of the
    stages the schedule runs that tick."""
    p, m = 4, 6
    Ws, micro, tgt = _pp_setup(p, m=m)
    layout = make_parallel_mesh(8, {"dp": 2, "pp": p})
    rows_seen = []

    def stage(w, x):
        rows_seen.append(x.shape[0])
        return _tstage(w, x)

    W = axis_stack_from_jax(Ws, layout, "pp")
    pipeline_1f1b_value_and_grad(stage, _mse_lanes, layout)(
        W, _replicated(layout, micro), _replicated(layout, tgt))
    rows_f, rows_b, *_ = tpp._one_f_one_b_plan(p, m)
    want = []
    for t_ in range(rows_f.shape[0]):
        for rows in (rows_f[t_], rows_b[t_]):
            if (rows >= 0).any():
                want.append(2 * int((rows >= 0).sum()))
    assert rows_seen == want


def test_pipeline_over_dp_and_pp_matches_jax_step():
    """examples/pipeline_stages.py's step at dp 2 x pp 4 (residual stages,
    dp-mean of the stage gradients through in_graph_synchronize_gradients),
    one step under each schedule against the JAX step."""
    dp, pp, m, mb, d = 2, 4, 4, 2, 8
    axes = {"dp": dp, "pp": pp}
    rng = np.random.RandomState(0)
    Ws = (rng.randn(pp, d, d) * 0.1).astype(np.float32)
    x = rng.randn(dp, m, mb, d).astype(np.float32)
    tg = rng.randn(dp, m, mb, d).astype(np.float32)
    layout = make_parallel_mesh(8, axes)

    def jstage(w, xx):
        return xx + jnp.tanh(xx @ w[0])

    def tstage(w, xx):
        return xx + torch.tanh(torch.bmm(xx, w))

    for schedule in ("gpipe", "1f1b"):
        if schedule == "gpipe":
            jfn = jloss_fn(jstage, lambda o, tt: jnp.mean((o - tt) ** 2), "pp")

            def jstep(W, xx, tt):
                loss, g = jax.value_and_grad(jfn)(W, xx[0], tt[0])
                return W - 0.3 * lax.pmean(g, "dp"), lax.pmean(loss, ("dp", "pp"))
        else:
            jvag = j1f1b(jstage, lambda y, tt: jnp.mean((y - tt) ** 2), "pp")

            def jstep(W, xx, tt):
                loss, g = jvag(W, xx[0], tt[0])
                return W - 0.3 * lax.pmean(g, "dp"), lax.pmean(loss, "dp")

        jW, jl = smap(jstep, axes, (P("pp"), P("dp"), P("dp")), (P("pp"), P()))(Ws, x, tg)
        W = axis_stack_from_jax(Ws, layout, "pp")
        xs, ts = axis_stack_from_jax(x, layout, "dp"), axis_stack_from_jax(tg, layout, "dp")
        if schedule == "gpipe":
            W.requires_grad_()
            lanes = pipeline_loss_fn(tstage, _mse_lanes, layout)(W, xs, ts)
            lanes.sum().backward()
            g = W.grad
        else:
            lanes, g = pipeline_1f1b_value_and_grad(tstage, _mse_lanes, layout)(W, xs, ts)
        g = tnn.in_graph_synchronize_gradients({"w": g}, layout, "dp")["w"]
        new = (W - 0.3 * g).detach()
        np.testing.assert_allclose(float(lanes.detach().mean()), float(jl), rtol=1e-5)
        np.testing.assert_allclose(new.numpy(), axis_stack_from_jax(np.asarray(jW), layout,
                                                                    "pp").numpy(), atol=1e-6)


def test_3d_step_matches_jax():
    """__graft_entry__.py:480-537's dp 2 x pp 2 x tp 2 step: pipeline stages
    whose contraction is tensor-parallel (a psum over tp inside the stage),
    the dp-mean of the gradients."""
    axes = {"dp": 2, "pp": 2, "tp": 2}
    k3, m3, mb3 = 4, 2, 2
    d3 = k3 * 2
    rng = np.random.RandomState(7)
    W3 = (rng.randn(2, 2, k3, d3) * 0.3).astype(np.float32)
    x3 = rng.randn(2, m3, mb3, d3).astype(np.float32)
    t3 = rng.randn(2, m3, mb3, d3).astype(np.float32)

    def jstage(w, xmb):
        r = lax.axis_index("tp")
        xloc = lax.dynamic_slice_in_dim(xmb, r * k3, k3, axis=1)
        return jnp.tanh(lax.psum(xloc @ w, "tp"))

    jfn = jloss_fn(jstage, lambda o, tt: jnp.mean((o - tt) ** 2), "pp")

    def jstep(W, xx, tt):
        loss, g = jax.value_and_grad(jfn)(W[0, 0], xx[0], tt[0])
        g = lax.pmean(g, "dp")
        return (W[0, 0] - 0.1 * g)[None, None], lax.pmean(loss, ("dp", "tp"))

    jW, jl = smap(jstep, axes, (P("pp", "tp"), P("dp"), P("dp")),
                  (P("pp", "tp"), P()))(W3, x3, t3)
    layout = make_parallel_mesh(8, axes)

    def tstage(w, xmb):
        return torch.tanh(axis_psum(torch.bmm(shard_input_features(xmb, layout), w), layout,
                                    "tp"))

    W = axis_stack_from_jax(W3, layout, ("pp", "tp")).requires_grad_()
    xs, ts = axis_stack_from_jax(x3, layout, "dp"), axis_stack_from_jax(t3, layout, "dp")
    lanes = pipeline_loss_fn(tstage, _mse_lanes, layout)(W, xs, ts)
    lanes.sum().backward()
    g = tnn.in_graph_synchronize_gradients({"w": W.grad}, layout, "dp")["w"]
    np.testing.assert_allclose(float(lanes.detach().mean()), float(jl), rtol=1e-5)
    np.testing.assert_allclose((W - 0.1 * g).detach().numpy(),
                               axis_stack_from_jax(np.asarray(jW), layout, ("pp", "tp")).numpy(),
                               atol=1e-5)


# ---------------------------------------------------------------- ep


def _ep_setup(E, T=12, d=8, seed=0):
    rng = np.random.RandomState(seed)
    We = rng.randn(E, d, d).astype(np.float32) * 0.3
    x = rng.randn(E, T, d).astype(np.float32)
    logits = rng.randn(E, T, E).astype(np.float32) * 2
    return We, x, logits


def _jexpert(w, toks):
    return toks @ w[0]


def _texpert(w, toks):
    return torch.bmm(toks, w)


def _moe_pair(E, We, x, logits, **kw):
    want = smap(lambda w, xx, lg: jmoe(xx[0], lg[0], _jexpert, w, "ep", **kw)[None],
                {"ep": E}, (P("ep"),) * 3, P("ep"))(We, x, logits)
    layout = make_parallel_mesh(E, {"ep": E})
    got = moe_dispatch_combine(t(x), t(logits), _texpert, t(We), layout, **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("E,k,renorm", [(2, 1, True), (4, 1, True), (8, 1, True),
                                        (4, 2, True), (4, 2, False), (8, 2, True)])
def test_moe_matches_jax(E, k, renorm):
    """Top-1 and top-2 routing with the default capacity (drops included)
    and with ample capacity, against JAX."""
    We, x, logits = _ep_setup(E, seed=E + k)
    T = x.shape[1]
    for capacity in (None, 2 * T):
        got, want = _moe_pair(E, We, x, logits, capacity=capacity, top_k=k, renormalize=renorm)
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_moe_capacity_drops_and_secondary_first():
    """test_parallel.py:526-611: overflow beyond capacity contributes zeros;
    under pressure the secondary routes drop first."""
    E = 4
    We, x, logits = _ep_setup(E, T=8, seed=3)
    logits = np.zeros_like(logits)
    logits[:, :, 0] = 10.0
    got, want = _moe_pair(E, We, x, logits, capacity=2)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got[:, 2:], 0.0)
    We, x, logits = _ep_setup(E, T=4, seed=11)
    logits = np.zeros_like(logits)
    for tok in range(4):
        logits[:, tok, tok % E] = 10.0
        logits[:, tok, 0] += 5.0
    got, want = _moe_pair(E, We, x, logits, capacity=1, top_k=2, renormalize=False)
    np.testing.assert_allclose(got, want, atol=1e-5)
    gates = np.asarray(jax.nn.softmax(jnp.asarray(logits[0]), axis=-1))
    for tok in range(4):
        np.testing.assert_allclose(got[0, tok], gates[tok, tok % E] * (x[0, tok] @ We[tok % E]),
                                   rtol=1e-4, atol=1e-5)


def test_moe_queue_positions_count_in_int32():
    """A bf16 queue count would merge positions past 256 (ep.py:87-95): 600
    tokens all to one expert keep 600 distinct slots."""
    E, T = 2, 600
    layout = make_parallel_mesh(E, {"ep": E})
    x = torch.randn(E, T, 4, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    logits = torch.zeros(E, T, E)
    logits[..., 0] = 1.0
    out = moe_dispatch_combine(x, logits, lambda w, tk: tk, None, layout, capacity=T)
    gate = torch.softmax(logits[0, 0], -1)[0].to(torch.bfloat16)
    np.testing.assert_allclose(out.float().numpy(), (x * gate).float().numpy(), rtol=1e-2)


@pytest.mark.parametrize("k", [1, 2])
def test_moe_load_stats_match_jax(k):
    E = 4
    _, _, logits = _ep_setup(E, T=16, seed=5)
    jn, jaux = smap(lambda lg: jstats(lg[0], "ep", top_k=k), {"ep": E}, P("ep"),
                    (P(), P()))(logits)
    layout = make_parallel_mesh(E, {"ep": E})
    n, aux = moe_load_stats(t(logits), layout, top_k=k)
    np.testing.assert_array_equal(n.numpy(), np.broadcast_to(np.asarray(jn), (E, E)))
    assert int(n[0].sum()) == k * E * 16
    np.testing.assert_allclose(aux.numpy(), float(jaux), rtol=1e-6)


def test_moe_gradients_match_jax():
    """Gradients of sum(y ** 2) + 0.01 aux for the expert weights and the
    router logits, every rank's, against JAX's (test_parallel.py:692-724,
    with the auxiliary loss of __graft_entry__.py:560-566)."""
    E = 4
    We, x, logits = _ep_setup(E, T=8, seed=7)

    def jfn(w, xx, lg):
        def loss(w, lg):
            y = jmoe(xx[0], lg[0], _jexpert, w, "ep", capacity=8, top_k=2)
            _, aux = jstats(lg[0], "ep", top_k=2)
            return jnp.sum(y ** 2) + 0.01 * aux

        loss_v, (gw, gl) = jax.value_and_grad(loss, argnums=(0, 1))(w, lg)
        return loss_v[None], gw, gl

    jl, jgw, jgl = smap(jfn, {"ep": E}, (P("ep"),) * 3, (P("ep"),) * 3)(We, x, logits)
    layout = make_parallel_mesh(E, {"ep": E})
    w, lg = t(We).requires_grad_(), t(logits).requires_grad_()
    y = moe_dispatch_combine(t(x), lg, _texpert, w, layout, capacity=8, top_k=2)
    lanes = (y ** 2).sum((1, 2)) + 0.01 * moe_load_stats(lg, layout, top_k=2)[1]
    lanes.sum().backward()
    np.testing.assert_allclose(lanes.detach().numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(jgw), atol=1e-5)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(jgl), atol=1e-5)


def test_moe_validation():
    layout = make_parallel_mesh(2, {"ep": 2})
    x, lg = torch.zeros(2, 4, 8), torch.zeros(2, 4, 2)
    with pytest.raises(ValueError, match="top_k"):
        moe_dispatch_combine(x, lg, _texpert, torch.zeros(2, 8, 8), layout, top_k=3)
    with pytest.raises(ValueError, match="router_logits"):
        moe_dispatch_combine(x, torch.zeros(2, 4, 3), _texpert, None, layout)
    with pytest.raises(ValueError, match="capacity"):
        moe_dispatch_combine(x, lg, _texpert, None, layout, capacity=0)


# ---------------------------------------------------------------- in_graph_*


def _grads(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "a.weight": rng.randn(8, 6, 5).astype(np.float32),
        "b.bias": rng.randn(8, 7).astype(np.float32),
        "c.count": (np.arange(8)[:, None] * np.ones((1, 3))).astype(np.int32),
        "d.weight": rng.randn(8, 300).astype(np.float32),
    }


@pytest.mark.parametrize("axes,axis", [({"dp": 2, "tp": 4}, "dp"), ({"dp": 2, "tp": 4}, "tp"),
                                       ({"mpi": 8}, "mpi")])
@pytest.mark.parametrize("form", ["leaf", "flat", "bucketed", "bucketed_int8", "parameters"])
def test_in_graph_syncs_match_jax(axes, axis, form, monkeypatch):
    """Every in_graph_* form against JAX's under shard_map: f32 within
    atol 1e-5, integer leaves exact (unaveraged forms)."""
    from torchmpi_tpu import constants as jconst
    from torchmpi_tpu_torch import constants as tconst

    grads = _grads()
    layout = make_parallel_mesh(8, axes)
    spec = stacked(axes)
    average = form != "flat"  # the flat form unaveraged keeps the ints exact
    if form == "bucketed_int8":
        jconst.set("wire_quant_min_elements", 256)
        tconst.set("wire_quant_min_elements", 256)
        grads = {k: v for k, v in grads.items() if v.dtype == np.float32}
    local = {k: v[:1] for k, v in grads.items()}
    jb = jnn.GradientBuckets({k: v[0] for k, v in grads.items()}, 2)
    tb = tnn.GradientBuckets({k: t(v[0]) for k, v in grads.items()}, 2)

    def jfn(g):
        g = {k: v[0] for k, v in g.items()}
        if form == "leaf":
            out = jnn.in_graph_synchronize_gradients(g, axis, average=average)
        elif form == "flat":
            out = jnn.in_graph_synchronize_gradients_flat(g, axis, average=average)
        elif form == "parameters":
            out = jnn.in_graph_synchronize_parameters(g, axis, root=1 % axes[axis])
        else:
            out = jnn.in_graph_synchronize_gradients_bucketed(
                g, jb, axis, average=average,
                wire_dtype="int8" if form == "bucketed_int8" else None)
        return {k: v[None] for k, v in out.items()}

    want = jax.device_get(smap(jfn, axes, ({k: spec for k in local},),
                               {k: spec for k in local})(grads))
    tg = {k: t(v) for k, v in grads.items()}
    if form == "leaf":
        got = tnn.in_graph_synchronize_gradients(tg, layout, axis, average=average)
    elif form == "flat":
        got = tnn.in_graph_synchronize_gradients_flat(tg, layout, axis, average=average)
    elif form == "parameters":
        got = tnn.in_graph_synchronize_parameters(tg, layout, axis, root=1 % axes[axis])
    else:
        got = tnn.in_graph_synchronize_gradients_bucketed(
            tg, tb, layout, axis, average=average,
            wire_dtype="int8" if form == "bucketed_int8" else None)
    for k in grads:
        if grads[k].dtype == np.int32 and not average:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
        else:
            np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-5, err_msg=k)
    if form == "bucketed_int8":
        # the wire engaged: not the exact sum
        exact = tnn.in_graph_synchronize_gradients(tg, layout, axis)
        assert any(not torch.equal(got[k], exact[k]) for k in got)


def test_surface_covers_the_jax_package():
    """Every name of torchmpi_tpu.parallel.__all__ and the four in_graph_*
    functions exist in the port."""
    import torchmpi_tpu.parallel as jparallel
    import torchmpi_tpu_torch.parallel as tparallel

    assert set(jparallel.__all__) <= set(tparallel.__all__)
    for name in tparallel.__all__:
        assert callable(getattr(tparallel, name)), name
    for name in ("in_graph_synchronize_gradients", "in_graph_synchronize_gradients_flat",
                 "in_graph_synchronize_gradients_bucketed", "in_graph_synchronize_parameters"):
        assert callable(getattr(tnn, name)), name
