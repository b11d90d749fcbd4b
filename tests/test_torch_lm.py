"""The port's long-context LM (``torchmpi_tpu_torch.models.transformer``, the
``long_context`` example) against the JAX package, on the CPU.

- The JAX ``LongContextTransformer``'s flax parameters carry over with
  ``lm_from_jax_params`` (vocab 64, 2 layers, 2 heads x 8, d_model 32,
  max_len 64, sequence 32). The port's logits at sp=4 (the ring) must match
  the JAX model under ``shard_map`` with ``sp_backend='xla'`` within atol
  2e-4 (``test_parallel.py:243-245``), and so must the port at sp=1 (full
  attention) and with the kernel backends (their plain versions here).
- Three steps of the example's step at dp 2 x sp 2 against the JAX
  example's step (``examples/long_context.py:110-139``, run under
  ``shard_map`` with ``optax.adam``) from the same parameters and batches:
  first-step gradients atol 1e-5, losses rtol 1e-4. Parameters after three
  steps: atol 1e-5 where the first-step gradient exceeds 1e-6, and 6 lr
  elsewhere. Adam moves every parameter by about lr a step whatever its
  gradient's size, so where a gradient is rounding noise (the key bias's,
  which the softmax cancels exactly, is about 1e-10) its sign, and with it
  the move, can differ between two sums of the same terms: two runs then
  part by up to 2 lr a step. A gradient above 1e-6 is a thousand times
  that noise, and there the two runs move alike.
- The example's ``main`` at ``--device cpu --ranks 4 --sp 4 --seq 64
  --steps 3`` with tiny widths exits 0 and the loss falls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from torchmpi_tpu.collectives.primitives import shift
from torchmpi_tpu.models import LongContextTransformer as JLM
from torchmpi_tpu.models import init_lm_params as jinit
from torchmpi_tpu.models import make_lm_loss_fn as jloss_fn
from torchmpi_tpu.utils import flops as jflops
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch.examples import long_context
from torchmpi_tpu_torch.models import (
    LongContextTransformer,
    init_lm_params,
    lm_from_jax_params,
    make_lm_loss_fn,
)
from torchmpi_tpu_torch.utils import flops

WIDTHS = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8, d_model=32, max_len=64)
SEQ = 32
LR = 3e-3


@pytest.fixture(autouse=True)
def _fresh_port():
    yield
    tmpi.runtime_state._reset_for_tests()
    tmpi.constants._reset_for_tests()


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(jinit(JLM(**WIDTHS), SEQ, seed=0))


def port_model(params, backend="xla") -> LongContextTransformer:
    model = LongContextTransformer(**WIDTHS, sp_backend=backend)
    model.load_state_dict(lm_from_jax_params(params))
    return model


def tokens(rows: int, seed: int = 1) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, WIDTHS["vocab_size"], (rows, SEQ)).astype(np.int32)


def test_converter_covers_the_model(jax_params):
    state = lm_from_jax_params(jax_params)
    model = LongContextTransformer(**WIDTHS)
    assert set(state) == set(model.state_dict())
    for name, value in model.state_dict().items():
        assert state[name].shape == value.shape, name
    with pytest.raises(ValueError, match="no port counterpart"):
        lm_from_jax_params({**jax_params, "Conv_0": {"kernel": np.zeros(1)}})


@pytest.fixture(scope="module")
def jax_logits(jax_params):
    """The JAX model over a sequence sharded on an sp=4 mesh ('xla' ring)."""
    model = JLM(**WIDTHS, sp_axis="sp", sp_backend="xla")
    mesh = Mesh(np.array(jax.devices()[:4]), ("sp",))
    f = jax.jit(jax.shard_map(lambda t: model.apply({"params": jax_params}, t), mesh=mesh,
                              in_specs=P(None, "sp"), out_specs=P(None, "sp"), check_vma=False))
    return np.asarray(f(tokens(3)))


@pytest.mark.parametrize("sp,backend", [
    (4, "xla"), (1, "xla"), (4, "kernel_full"), (4, "kernel_bidir"), (2, "auto"),
])
def test_logits_match_jax(jax_params, jax_logits, sp, backend):
    model = port_model(jax_params, backend)
    x = long_context.shard_sequence(torch.from_numpy(tokens(3)), sp)
    with torch.no_grad():
        logits = model(x)  # [sp, B, t_local, vocab]
    got = logits.transpose(0, 1).reshape(3, SEQ, -1)
    np.testing.assert_allclose(got.numpy(), jax_logits, atol=2e-4)


def test_lm_loss_fn_matches_jax(jax_params):
    x = tokens(2, seed=3)
    y = np.roll(x, -1, axis=1)
    want = float(jloss_fn(JLM(**WIDTHS))(jax_params, (jnp.asarray(x), jnp.asarray(y))))
    model = port_model(jax_params)
    with torch.no_grad():
        got = make_lm_loss_fn(model)(dict(model.named_parameters()),
                                     (torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(float(got) - want) <= 1e-5 * abs(want)


def _jax_steps(params, batches, dp, sp):
    """The JAX example's step (``examples/long_context.py:110-139``)."""
    model = JLM(**WIDTHS, sp_axis="sp", sp_backend="xla")
    opt = optax.adam(LR)
    mesh = Mesh(np.array(jax.devices()[:dp * sp]).reshape(dp, sp), ("dp", "sp"))

    def step(params, opt_state, tokens):
        nxt = shift(tokens[:, :1], offset=-1, axis="sp")
        targets = jnp.concatenate([tokens[:, 1:], nxt], axis=1)

        def loss_fn(params):
            logits = model.apply({"params": params}, tokens)
            logp = jax.nn.log_softmax(logits)
            ll = jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
            sp_rank = jax.lax.axis_index("sp")
            t_local = tokens.shape[1]
            is_last = (sp_rank == sp - 1) & (jnp.arange(t_local) == t_local - 1)
            ll = jnp.where(is_last[None, :], 0.0, ll)
            return -jnp.sum(ll) / (tokens.shape[0] * (t_local - 1))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        grads = jax.tree_util.tree_map(lambda g: jax.lax.pmean(g, ("dp", "sp")), grads)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, jax.lax.pmean(loss, ("dp", "sp")), grads

    step_fn = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(P(), P(), P("dp", "sp")),
                                    out_specs=(P(), P(), P(), P()), check_vma=False))
    opt_state = opt.init(params)
    losses, first_grads = [], None
    for batch in batches:
        params, opt_state, loss, grads = step_fn(params, opt_state, batch)
        losses.append(float(loss))
        first_grads = first_grads or jax.device_get(grads)
    return losses, first_grads, jax.device_get(params)


def test_three_steps_match_jax_step(jax_params):
    dp, sp, b = 2, 2, 2
    batches = long_context.make_batches(0, 3, dp * b, SEQ)
    want_losses, want_grads, want_params = _jax_steps(jax_params, batches, dp, sp)

    model = port_model(jax_params)
    grads = {}

    def on_step(step, loss):
        if step == 0:
            grads.update({n: p.grad.clone() for n, p in model.named_parameters()})

    losses = long_context.train(model, batches, LR, dp, sp, "cpu", on_step)
    np.testing.assert_allclose([float(v) for v in losses], want_losses, rtol=1e-4)
    for name, want in lm_from_jax_params(want_grads).items():
        np.testing.assert_allclose(grads[name].numpy(), want.numpy(), atol=1e-5, err_msg=name)
    state = model.state_dict()
    for name, want in lm_from_jax_params(want_params).items():
        diff = (state[name] - want).abs()
        signal = grads[name].abs() > 1e-6
        assert float(diff.max()) <= 6 * LR, name
        assert float((diff * signal).max()) <= 1e-5, name


def test_loss_masks_only_the_last_global_position():
    """Each rank's loss divides by B * (t_local - 1); only the last rank's
    last position has no target. With uniform logits every kept position
    costs log(vocab)."""
    class Uniform(torch.nn.Module):
        def forward(self, x):
            return torch.zeros(x.shape + (8,))

    sp, dp, b, t = 4, 2, 3, 5
    x = torch.zeros((sp, dp * b, t), dtype=torch.int64)
    mean, per_rank = long_context.lm_loss(Uniform(), x, dp)
    full = np.log(8) * t / (t - 1)
    want = np.full((dp, sp), full)
    want[:, -1] = np.log(8)
    np.testing.assert_allclose(per_rank.numpy(), want, rtol=1e-6)
    assert abs(float(mean) - want.mean()) < 1e-6


def test_make_batches_follow_the_jax_draws():
    """The JAX example draws its init batch first, then one per step."""
    rng = np.random.RandomState(5)
    draws = [rng.randint(0, 17, (4, 1)) for _ in range(3)]
    batches = long_context.make_batches(5, 2, 4, 20)
    for phase, batch in zip(draws[1:], batches):
        np.testing.assert_array_equal(batch, (phase + np.arange(20)[None]) % 17 + 5)


def test_init_lm_params_distributions():
    model = LongContextTransformer(vocab_size=512, num_layers=1, num_heads=4, head_dim=16,
                                   d_model=64, max_len=256)
    params = init_lm_params(model, seed=0)
    assert set(params) == set(dict(model.named_parameters()))
    emb = params["embed0.weight"]
    assert abs(float(emb.std()) - 1 / 8) < 0.01  # variance 1 / d_model
    w = params["blocks.0.dense2.weight"]  # lecun_normal, fan_in 64
    std = (1 / 64) ** 0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std and abs(float(w.std()) - (1 / 64) ** 0.5) < 0.01
    assert bool((params["blocks.0.layernorm1.weight"] == 1).all())
    assert not any(float(v.abs().max()) for k, v in params.items() if k.endswith("bias"))
    again = init_lm_params(model, seed=0)
    assert all(torch.equal(params[k], again[k]) for k in params)


@pytest.mark.parametrize("widths", [(16, 8, 1, 2, 4, 32), (128, 32, 2, 4, 8, 256),
                                    (4096, 512, 8, 8, 64, 8192)])
def test_flops_match_jax(widths):
    f = flops.transformer_forward_flops(*widths)
    assert f == jflops.transformer_forward_flops(*widths)
    assert flops.train_flops(f) == jflops.train_flops(f)


def test_mfu_uses_the_card_peak():
    achieved, frac = flops.mfu(1000.0, 67e9, "NVIDIA H100 80GB HBM3")
    assert achieved == 67e12 and abs(frac - 1.0) < 1e-12
    assert flops.device_peak_flops("NVIDIA H100 80GB HBM3", "bfloat16") == 989e12
    assert flops.mfu(1.0, 1, None) == (1.0, None)
    assert flops.mfu(1.0, 1, "some other card")[1] is None


def test_example_main_on_cpu(capsys):
    out = long_context.main([
        "--device", "cpu", "--ranks", "4", "--sp", "4", "--seq", "64", "--steps", "3",
        "--batch", "2", "--vocab", "32", "--layers", "1", "--heads", "2", "--head-dim", "8",
        "--d-model", "16",
    ])
    text = capsys.readouterr().out
    assert "mesh=dp1 x sp4" in text and "tok/s" in text
    assert out["losses"][-1] < out["losses"][0]
