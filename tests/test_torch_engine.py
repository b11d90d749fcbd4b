"""The port's main path (``torchmpi_tpu_torch``: data, LeNet, engine)
against the JAX package, on the CPU, plus the port's independence from JAX.

- ``synthetic_mnist`` and ``DistributedIterator`` batches must equal the
  JAX package's exactly.
- LeNet logits from the same weights (``from_jax_params``) must match
  flax within atol 1e-5 (two f32 convolution implementations).
- Three synchronous AllReduce-SGD steps at p=4, global batch 32, lr 0.2,
  must match the JAX ``AllReduceSGDEngine`` from the same weights and
  batches: losses within rtol 1e-4, parameters within atol 1e-5. So must
  three async steps with the 'full' wire (the bucketed path).
- With an int8 or bf16 wire, sync and async, each rank's parameter update
  must be within 2e-2 of the JAX run's, normalised by its max |update|:
  the JAX wire tests' bound, because the JAX engine's in-graph wire runs
  the ``primitives`` ppermute ring, whose block grid differs from the
  kernel ring's. Both packages lower ``wire_quant_min_elements`` (and the
  port ``small_allreduce_size_cpu``) so that both LeNet buckets engage, and
  the port's selector is pinned to the kernel backend, the card's choice.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

import torchmpi_tpu as jmpi
from torchmpi_tpu import constants as jconstants
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu.engine import AllReduceSGDEngine as JEngine
from torchmpi_tpu.models import LeNet as JLeNet
from torchmpi_tpu.models import LogisticRegression as JLogReg
from torchmpi_tpu.models import init_params as jinit
from torchmpi_tpu.models import make_loss_fn as jloss
from torchmpi_tpu.utils import DistributedIterator as JIterator
from torchmpi_tpu.utils import synthetic_mnist as jsynthetic
from torchmpi_tpu_torch.engine import AllReduceSGDEngine
from torchmpi_tpu_torch.models import (
    LeNet,
    LogisticRegression,
    from_jax_params,
    init_params,
    make_loss_fn,
)
from torchmpi_tpu_torch.utils import DistributedIterator, synthetic_mnist

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _fresh_port():
    yield
    tmpi.runtime_state._reset_for_tests()
    tmpi.constants._reset_for_tests()


def test_synthetic_mnist_is_the_jax_dataset():
    for (a, b) in zip(synthetic_mnist(num_train=300, num_test=50, seed=3),
                      jsynthetic(num_train=300, num_test=50, seed=3)):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("shuffle", [True, False])
def test_distributed_iterator_yields_the_jax_batches(shuffle):
    (x, y), _ = jsynthetic(num_train=400, num_test=10)
    ours = DistributedIterator(x, y, 24, 4, device="cpu", shuffle=shuffle, seed=5)
    ref = JIterator(x, y, 24, 4, shuffle=shuffle, seed=5)
    assert len(ours) == len(ref) == 100 // 6
    for _ in range(2):  # two epochs: the reshuffle follows the JAX seed
        for (tx, ty), (jx, jy) in zip(ours, ref):
            assert tuple(tx.shape) == (4, 6, 28, 28) and ty.dtype == torch.int64
            np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
            np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("model", ["lenet", "logreg"])
def test_logits_match_flax(model):
    jm, tm = (JLeNet(), LeNet()) if model == "lenet" else (JLogReg(), LogisticRegression())
    jp = jinit(jm, (1, 28, 28), seed=0)
    tm.load_state_dict(from_jax_params(jax.device_get(jp)))
    x = np.random.RandomState(1).rand(6, 28, 28).astype(np.float32)
    ref = np.asarray(jm.apply({"params": jp}, x))
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_init_params_follow_flax_defaults():
    params = init_params(LeNet(), seed=0)
    assert sum(v.numel() for v in params.values()) == 857738
    for name, v in params.items():
        if name.endswith("bias"):
            assert not v.any()
        else:
            std = (1.0 / v[0].numel()) ** 0.5 / 0.87962566103423978
            assert v.abs().max() <= 2 * std
            assert 0.8 * (1.0 / v[0].numel()) ** 0.5 < float(v.std()) < 1.2 * (1.0 / v[0].numel()) ** 0.5
    assert all(torch.equal(v, init_params(LeNet(), seed=0)[k]) for k, v in params.items())


def _lenet_batches(p, batch=32, steps=3):
    (x, y), _ = jsynthetic(num_train=512, num_test=8)
    order = JIterator(x, y, batch, p, seed=0)._epoch_order()
    per = batch // p
    return [(x[order[:, b * per:(b + 1) * per]], y[order[:, b * per:(b + 1) * per]])
            for b in range(steps)]


def test_three_sync_steps_match_the_jax_engine():
    p = 4
    batches = _lenet_batches(p)
    jp = jinit(JLeNet(), (1, 28, 28), seed=0)

    jmpi.start(devices=jax.devices()[:p])
    jengine = JEngine(jloss(JLeNet()), jp, optimizer=optax.sgd(0.2))
    jlosses = [float(jengine.step(b)) for b in batches]

    tmpi.start(ranks=p, device="cpu")
    engine = AllReduceSGDEngine(make_loss_fn(LeNet()), from_jax_params(jax.device_get(jp)), lr=0.2)
    losses = [float(engine.step((torch.from_numpy(bx), torch.from_numpy(by).long())))
              for bx, by in batches]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    ref = from_jax_params(jax.device_get(jengine.params))
    for k, v in engine.params.items():
        assert tuple(v.shape) == (p,) + tuple(ref[k].shape)
        for r in range(p):
            np.testing.assert_allclose(v[r].numpy(), ref[k].numpy(), rtol=0, atol=1e-5)
    tmpi.nn.check_with_allreduce(engine.params)


@pytest.mark.parametrize(
    "mode,wire", [("async", "full"), ("sync", "int8"), ("sync", "bf16"),
                  ("async", "int8"), ("async", "bf16")],
)
def test_three_steps_with_buckets_and_wires_match_the_jax_engine(mode, wire, monkeypatch):
    p = 4
    batches = _lenet_batches(p)
    jp = jinit(JLeNet(), (1, 28, 28), seed=0)
    jconstants.set("wire_quant_min_elements", 1)
    jmpi.start(devices=jax.devices()[:p])
    jengine = JEngine(jloss(JLeNet()), jp, optimizer=optax.sgd(0.2), mode=mode, wire_dtype=wire)
    jlosses = [float(jengine.step(b)) for b in batches]
    ref = from_jax_params(jax.device_get(jengine.params))

    init = from_jax_params(jax.device_get(jp))
    tmpi.start(ranks=p, device="cpu")
    tmpi.constants.set("wire_quant_min_elements", 1)
    tmpi.constants.set("small_allreduce_size_cpu", 0)
    monkeypatch.setattr(tmpi.collectives.selector, "select", lambda *a, **k: "kernel")
    engine = AllReduceSGDEngine(make_loss_fn(LeNet()), init, lr=0.2, mode=mode, wire_dtype=wire)
    assert engine.buckets.num_buckets == (2 if mode == "async" else 1)
    losses = [float(engine.step((torch.from_numpy(bx), torch.from_numpy(by).long())))
              for bx, by in batches]
    if wire == "full":
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
        for k, v in engine.params.items():
            for r in range(p):
                np.testing.assert_allclose(v[r].numpy(), ref[k].numpy(), rtol=0, atol=1e-5)
        tmpi.nn.check_with_allreduce(engine.params)
        return
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-4)
    jupdate = np.concatenate([(ref[k] - init[k]).numpy().ravel() for k in sorted(ref)])
    for r in range(p):
        update = np.concatenate([(engine.params[k][r] - init[k]).numpy().ravel()
                                 for k in sorted(ref)])
        err = np.abs(update - jupdate).max() / np.abs(jupdate).max()
        assert err <= 2e-2, r
    # the chunks' owners keep f32 sums, the other ranks the wire's decoding
    spread = max(float((v - v[0:1]).abs().max()) for v in engine.params.values())
    assert 0 < spread <= 1e-2


def test_engine_train_loop_and_hooks():
    (x, y), _ = synthetic_mnist(num_train=256, num_test=8)
    tmpi.start(ranks=2, device="cpu")
    seen = []
    engine = AllReduceSGDEngine(
        make_loss_fn(LogisticRegression()), init_params(LogisticRegression()),
        hooks={"on_update": lambda s: seen.append(s["t"]),
               "on_end": lambda s: seen.append("end")},
    )
    it = DistributedIterator(x, y, 32, 2, device="cpu")
    state = engine.train(lambda: iter(it), max_epochs=2)
    assert state["t"] == 2 * len(it) and state["samples"] == 2 * len(it) * 32
    assert len(state["losses"]) == 2 and seen[-1] == "end" and seen[:2] == [0, 1]
    assert all(np.isfinite(state["losses"]))
    with pytest.raises(ValueError, match="mode must be"):
        AllReduceSGDEngine(make_loss_fn(LogisticRegression()),
                           init_params(LogisticRegression()), mode="sometimes")
    with pytest.raises(ValueError, match="wire_dtype must be"):
        AllReduceSGDEngine(make_loss_fn(LogisticRegression()),
                           init_params(LogisticRegression()), wire_dtype="fp8")


def test_start_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmpi.start()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmpi.start(ranks=2, device="cuda")
    assert not tmpi.started()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from torchmpi_tpu_torch.examples import mnist_allreduce

        mnist_allreduce.main(["--epochs", "1"])


def test_example_runs_on_the_cpu(capsys):
    from torchmpi_tpu_torch.examples import mnist_allreduce

    loss, acc = mnist_allreduce.main(
        ["--model", "logreg", "--ranks", "4", "--epochs", "1", "--device", "cpu"]
    )
    out = capsys.readouterr().out
    assert "samples/sec/chip=" in out and "check_with_allreduce: ok" in out
    assert loss < 2.3 and acc > 0.5


def test_example_async_runs_on_the_cpu(capsys):
    from torchmpi_tpu_torch.examples import mnist_allreduce

    loss, acc = mnist_allreduce.main(
        ["--model", "logreg", "--ranks", "4", "--epochs", "1", "--device", "cpu",
         "--mode", "async"]
    )
    out = capsys.readouterr().out
    assert "mode=async" in out and "check_with_allreduce: ok" in out
    assert loss < 2.3 and acc > 0.5


def test_port_imports_without_jax():
    """The port imports with jax and the JAX package made unimportable,
    and importing it builds no kernel."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['torchmpi_tpu'] = None\n"
        "import torchmpi_tpu_torch, torchmpi_tpu_torch.engine, torchmpi_tpu_torch.models\n"
        "import torchmpi_tpu_torch.utils, torchmpi_tpu_torch.examples.mnist_allreduce\n"
        "import torchmpi_tpu_torch.examples.mnist_parameterserver\n"
        "import torchmpi_tpu_torch.examples.resnet_allreduce\n"
        "import torchmpi_tpu_torch.examples.mnist_sequential\n"
        "import torchmpi_tpu_torch.models.resnet, torchmpi_tpu_torch.engine.optim\n"
        "from torchmpi_tpu_torch.ops import _build\n"
        "assert not _build._loaded\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_port_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|torchmpi_tpu)(\.|\s|$)", re.M)
    files = sorted((REPO / "torchmpi_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        hits = pattern.findall(path.read_text())
        assert not hits, f"{path} imports {hits}"
