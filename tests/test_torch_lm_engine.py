"""The port's LM in bf16, under remat and through the engine
(``torchmpi_tpu_torch.models.transformer``, ``utils.synthetic_tokens``, the
``long_context`` example's ``--engine``), and the tensor- and
pipeline-parallel twins, against the JAX package on the CPU.

- ``synthetic_tokens``: the JAX arrays, element for element.
- bf16 (``dtype=torch.bfloat16``): every block's output, the residual
  stream, is bf16 and the logits f32. Against the JAX model with
  ``dtype=jnp.bfloat16`` from the same parameters, the logits agree within
  ``2^-5 * max|logits|`` at the element and ``2^-8 * max|logits|`` in the
  mean. Both models round every embedding, Dense and residual add to bf16
  (a relative spacing of 2^-8 to 2^-7), but at different places: flax's
  attention and gelu round each step to bf16 where the port's attention
  runs in f32 (the kernels' plain version) and its gelu rounds once. The
  final f32 LayerNorm rescales the residual's rounding noise to unit scale
  before the head, so the logits carry about a dozen independent
  roundings of 2^-8 (measured 2.4-3.2 x 2^-8 at the element, 0.4 x 2^-8 in
  the mean); f32 stays at ``test_torch_lm.py``'s limits (atol 2e-4).
- ``remat=True``: the loss and every gradient equal the model without it
  bit for bit (sp 1 and the sp 2 ring); the JAX ``remat=True`` model's
  loss within rtol 1e-5 (``test_torch_lm.py``'s f32 limit).
- The engine path at ``tests/test_lm.py:81-100``'s widths (vocab 64, one
  layer, 2 heads x 16, d_model 32, sequence 32, Adam 1e-2, 8 ranks, 2
  sequences a rank): the loss falls as there, and with
  ``shuffle=False`` the epochs' losses follow the JAX engine's from the
  same parameters within rtol 1e-4.
- The twins' ``main`` on ``--device cpu`` with small settings exit 0;
  the pipeline twin's losses equal the JAX example's within rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torchmpi_tpu as jmpi
from torchmpi_tpu.engine import AllReduceSGDEngine as JEngine
from torchmpi_tpu.models import LongContextTransformer as JLM
from torchmpi_tpu.models import init_lm_params as jinit
from torchmpi_tpu.models import make_lm_loss_fn as jloss_fn
from torchmpi_tpu.utils import synthetic_tokens as jtokens
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch.examples import long_context, mnist_modelparallel, pipeline_stages
from torchmpi_tpu_torch.models import LongContextTransformer, lm_from_jax_params
from torchmpi_tpu_torch.utils import synthetic_tokens

WIDTHS = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8, d_model=32, max_len=64)
ENGINE_WIDTHS = dict(vocab_size=64, num_layers=1, num_heads=2, head_dim=16, d_model=32,
                     max_len=32)
SEQ = 32


@pytest.fixture(autouse=True)
def _fresh_port():
    yield
    tmpi.runtime_state._reset_for_tests()
    tmpi.constants._reset_for_tests()


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(jinit(JLM(**WIDTHS), SEQ, seed=0))


def port_model(params, **kw) -> LongContextTransformer:
    model = LongContextTransformer(**WIDTHS, **kw)
    model.load_state_dict(lm_from_jax_params(params))
    return model


def tokens(rows: int, seed: int = 1) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 64, (rows, SEQ)).astype(np.int32)


@pytest.mark.parametrize("args", [dict(num_seqs=4, seq_len=64, vocab=128),
                                  dict(num_seqs=3, seq_len=17, vocab=8192, seed=5)])
def test_synthetic_tokens_equal_jax(args):
    for got, want in zip(synthetic_tokens(**args), jtokens(**args)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_bf16_logits_match_jax_bf16(jax_params, seed):
    x = tokens(4, seed)
    want = np.asarray(JLM(**WIDTHS, dtype=jnp.bfloat16).apply(
        {"params": jax_params}, jnp.asarray(x)), np.float32)
    model = port_model(jax_params, dtype=torch.bfloat16)
    seen = []
    model.blocks[0].register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    with torch.no_grad():
        got = model(torch.from_numpy(x)[None])[0]
    assert seen == [torch.bfloat16] and got.dtype == torch.float32
    scale = float(np.abs(want).max())
    diff = np.abs(got.numpy() - want)
    assert diff.max() <= 2.0**-5 * scale, (diff.max(), scale)
    assert diff.mean() <= 2.0**-8 * scale, (diff.mean(), scale)


def test_f32_model_unchanged_by_the_casts(jax_params):
    x = tokens(2)
    want = np.asarray(JLM(**WIDTHS).apply({"params": jax_params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port_model(jax_params)(torch.from_numpy(x)[None])[0]
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def _loss_and_grads(model, x):
    model.zero_grad(set_to_none=True)
    sp = x.shape[0]
    loss, _ = long_context.lm_loss(model, x, 1)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}, sp


@pytest.mark.parametrize("sp,dtype", [(1, torch.float32), (2, torch.float32),
                                      (2, torch.bfloat16)])
def test_remat_bitwise_equal(jax_params, sp, dtype):
    x = long_context.shard_sequence(torch.from_numpy(tokens(2)), sp)
    plain, plain_g, _ = _loss_and_grads(port_model(jax_params, dtype=dtype), x)
    remat, remat_g, _ = _loss_and_grads(port_model(jax_params, dtype=dtype, remat=True), x)
    assert torch.equal(plain, remat)
    for name in plain_g:
        assert torch.equal(plain_g[name], remat_g[name]), name


def test_remat_loss_matches_jax_remat(jax_params):
    x = tokens(2, seed=3)
    y = np.roll(x, -1, axis=1)
    want = float(jloss_fn(JLM(**WIDTHS, remat=True))(jax_params, (jnp.asarray(x),
                                                                   jnp.asarray(y))))
    model = port_model(jax_params, remat=True)
    from torchmpi_tpu_torch.models import make_lm_loss_fn

    with torch.no_grad():
        got = make_lm_loss_fn(model)(dict(model.named_parameters()),
                                     (torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(float(got) - want) <= 1e-5 * abs(want)


def test_engine_path_trains_and_follows_jax():
    """test_lm.py:77-100 through the port's engine: the loss falls well
    below ln(vocab); without shuffling, two epochs follow the JAX engine's
    losses from the same parameters."""
    x, y = synthetic_tokens(num_seqs=32, seq_len=SEQ, vocab=64)
    jmodel = JLM(**ENGINE_WIDTHS)
    params = jax.device_get(jinit(jmodel, SEQ, seed=0))
    jmpi.start()
    try:
        jengine = JEngine(jloss_fn(jmodel), params, optimizer=optax.adam(1e-2))
        want = jengine.train_resident(x, y, 2, max_epochs=2, shuffle=False)["losses"]
    finally:
        jmpi.stop()
    from torchmpi_tpu_torch.engine import Adam, AllReduceSGDEngine
    from torchmpi_tpu_torch.models import make_lm_loss_fn

    tmpi.start(ranks=8, device="cpu")
    model = LongContextTransformer(**ENGINE_WIDTHS)
    engine = AllReduceSGDEngine(make_lm_loss_fn(model), lm_from_jax_params(params),
                                optimizer=Adam(1e-2), rank_map="loop")
    got = engine.train_resident(x, y, 2, max_epochs=8, shuffle=False)["losses"]
    np.testing.assert_allclose(got[:2], want, rtol=1e-4)
    uniform = float(np.log(64))
    assert got[0] < 1.5 * uniform
    assert got[-1] < 0.7 * uniform
    assert got[-1] < got[0]


def test_engine_example_main_on_cpu(capsys):
    out = long_context.main([
        "--device", "cpu", "--engine", "--ranks", "4", "--seq", "32", "--batch", "2",
        "--num-seqs", "32", "--epochs", "3", "--vocab", "64", "--layers", "1", "--heads", "2",
        "--head-dim", "16", "--d-model", "32", "--lr", "1e-2", "--dtype", "bf16",
    ])
    text = capsys.readouterr().out
    assert "engine, no sp" in text and "tok/s/chip" in text
    assert out["losses"][-1] < out["losses"][0] and out["steps"] == 12


def test_sp_example_bf16_remat_on_cpu(capsys):
    out = long_context.main([
        "--device", "cpu", "--ranks", "4", "--sp", "4", "--seq", "64", "--steps", "3",
        "--batch", "2", "--vocab", "32", "--layers", "1", "--heads", "2", "--head-dim", "8",
        "--d-model", "16", "--dtype", "bf16", "--remat", "--sp-backend", "kernel_full",
    ])
    assert out["losses"][-1] < out["losses"][0]


def test_modelparallel_twin_on_cpu(capsys):
    out = mnist_modelparallel.main(["--device", "cpu", "--train", "2688", "--test", "256"])
    text = capsys.readouterr().out
    assert "mesh=dp2 x tp4" in text and "test_acc" in text
    assert out["steps"] == 24 and out["losses"][-1] < out["losses"][0] and out["acc"] > 0.5


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_twin_follows_the_jax_example(schedule, capsys):
    import importlib.util
    from pathlib import Path

    argv = ["--epochs", "3", "--schedule", schedule]
    out = pipeline_stages.main(["--device", "cpu", *argv])
    spec = importlib.util.spec_from_file_location(
        "jax_pipeline_stages", Path(__file__).resolve().parent.parent / "examples"
        / "pipeline_stages.py")
    jex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jex)
    want = jex.main(argv)
    np.testing.assert_allclose(out["losses"], want, rtol=1e-4)
    assert out["steps"] == 24
