"""The port's ResNet data-parallel slice (``torchmpi_tpu_torch``: data, FLOP
count, model, converter, engine with momentum and batch statistics, the
example and the sequential MNIST twin) against the JAX package, on the CPU.

Tolerances, each stated where it is used:

- ``synthetic_imagenet`` and ``resnet_forward_flops`` must equal the JAX
  package's exactly (numpy and integer arithmetic on both sides).
- Logits from the same weights (``resnet_from_jax_params``) on 8 images
  must match flax within atol 1e-4 (ResNet-18) and 1e-5 (the narrow
  bottleneck net) in training mode, where the port normalises by
  ATen's or cuDNN's batch variance and flax by ``E[x^2] - E[x]^2`` (at 16
  px ResNet-18's last stage is 1x1, so each channel's statistics come from
  as many values as images, and on 4 images the two formulas' rounding
  grows to 6e-4 in the logits), and within 1e-5 in evaluation mode; the
  new batch statistics within atol 1e-5. Stride-2
  ``SAME`` padding and max-pool must match XLA's within 1e-6 on odd and
  even sizes.
- Three engine steps with momentum 0.9 and the batch statistics averaged
  over the ranks, sync and async, p = 2 and 4: losses within rtol 1e-4,
  parameters and momentum traces within atol 1e-5, batch statistics within
  atol 1e-6, then ``check_with_allreduce`` on the parameters and on the
  statistics. With ``--bf16`` convolutions, one step within rtol 1e-2 on
  the loss and 2e-2 in norm on the update, against the JAX step computed
  op by op (the test says why).
- ``train_resident(shuffle=False)`` and ``evaluate`` against the JAX
  engine's: epoch losses within rtol 1e-4, parameters within atol 1e-5,
  the accuracy exactly.
- The sequential MNIST twin against ``examples/mnist_sequential.py`` on
  the same seed and weights: epoch losses within rtol 1e-4, the test
  accuracy exactly.
"""

import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu.engine import AllReduceSGDEngine as JEngine
from torchmpi_tpu.models import accuracy as jaccuracy
from torchmpi_tpu.models import resnet as jresnet
from torchmpi_tpu.utils import flops as jflops
from torchmpi_tpu.utils import synthetic_imagenet as jsynthetic
from torchmpi_tpu_torch.engine import SGD, AllReduceSGDEngine
from torchmpi_tpu_torch.models import (
    ResNet18,
    ResNet50,
    accuracy,
    init_resnet,
    make_eval_fn,
    make_stateful_loss_fn,
    resnet_from_jax_params,
)
from torchmpi_tpu_torch.models import resnet as tresnet
from torchmpi_tpu_torch.utils import flops, synthetic_imagenet

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _fresh_port():
    yield
    tmpi.runtime_state._reset_for_tests()
    tmpi.constants._reset_for_tests()


def _narrow(module, **kw):
    """The narrow bottleneck net of the tests: stages [1, 1], 8 filters."""
    return module.ResNet(stage_sizes=[1, 1], block=module.BottleneckBlock, num_filters=8,
                         num_classes=10, **kw)


def _jax_weights(model, size, seed=0):
    """Weights for a flax model as numpy trees ``(params, batch_stats)``, in
    the shapes of its ``init`` (traced, not run: flax's initialisers are
    slow on the CPU): kernels normal with variance 1/fan_in, and the BN
    scales, biases and statistics moved off 1 and 0 (a zero-scaled BN or a
    unit variance would hide a wrong layout)."""
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, size, size, 3)), train=True),
                            jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        z = rs.randn(*leaf.shape).astype(np.float32)
        if name == "kernel":
            return z / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        if name == "var":
            return 1 + 0.1 * np.abs(z)
        return (1 if name == "scale" else 0) + 0.1 * z

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return tree["params"], tree["batch_stats"]


def test_synthetic_imagenet_is_the_jax_dataset():
    ours = synthetic_imagenet(num_train=12, num_test=5, num_classes=7, image_size=16, seed=3)
    ref = jsynthetic(num_train=12, num_test=5, num_classes=7, image_size=16, seed=3)
    for (a, b) in zip(ours, ref):
        for u, v in zip(a, b):
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("image,stages,bottleneck,classes,filters", [
    (224, (3, 4, 6, 3), True, 1000, 64),
    (224, (2, 2, 2, 2), False, 1000, 64),
    (32, (1, 1), True, 10, 8),
    (27, (2, 2, 2, 2), False, 8, 64),
])
def test_resnet_forward_flops_match_jax(image, stages, bottleneck, classes, filters):
    kw = dict(stage_sizes=stages, bottleneck=bottleneck, num_classes=classes,
              num_filters=filters)
    assert flops.resnet_forward_flops(image, **kw) == jflops.resnet_forward_flops(image, **kw)
    assert flops.conv2d_flops(27, 27, 3, 8, 3, 3, 2) == jflops.conv2d_flops(27, 27, 3, 8, 3, 3, 2)


def test_resnet50_counts():
    assert flops.resnet_forward_flops(224) == 8_178_368_512
    assert flops.train_flops(flops.resnet_forward_flops(224)) == 24_535_105_536
    model = ResNet50(device="meta")
    assert sum(v.numel() for v in model.parameters()) == 25_557_032
    assert len(list(model.parameters())) == 161
    assert sum(v.numel() for v in model.buffers()) == 53_120


@pytest.mark.parametrize("size", [7, 8, 9, 16])
@pytest.mark.parametrize("kernel,stride", [(3, 2), (1, 2), (3, 1), (7, 2)])
def test_same_padding_matches_xla(size, kernel, stride):
    rs = np.random.RandomState(size)
    x = rs.randn(2, size, size, 3).astype(np.float32)
    conv = fnn.Conv(4, (kernel, kernel), strides=(stride, stride), use_bias=False)
    variables = conv.init(jax.random.PRNGKey(0), x)
    ref = np.asarray(conv.apply(variables, x))
    ours = tresnet.Conv(3, 4, kernel, stride)
    weight = np.array(variables["params"]["kernel"]).transpose(3, 2, 0, 1).copy()
    out = torch.func.functional_call(ours, {"weight": torch.from_numpy(weight)},
                                     (torch.from_numpy(x).permute(0, 3, 1, 2),))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(), ref, rtol=0, atol=1e-6)
    pool = np.asarray(fnn.max_pool(x, (kernel, kernel), strides=(stride, stride), padding="SAME"))
    out = tresnet.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2), kernel, stride)
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).numpy(), pool)


def test_symmetric_padding_would_differ_on_even_sizes():
    """Why the port pads by hand: on an even input, a stride-2 3x3 conv
    and max-pool with PyTorch's symmetric padding are not XLA's SAME."""
    assert tresnet.same_pads(8, 3, 2) == (0, 1) and tresnet.same_pads(9, 3, 2) == (1, 1)
    x = torch.randn(1, 1, 8, 8, generator=torch.Generator().manual_seed(0))
    ours = tresnet.max_pool_same(x)
    assert not torch.equal(ours, torch.nn.functional.max_pool2d(x, 3, 2, padding=1))


@pytest.mark.parametrize("model,size,atol", [
    ("resnet18", 16, 1e-4), ("bottleneck", 32, 1e-5), ("bottleneck", 27, 1e-5)])
def test_logits_and_batch_stats_match_flax(model, size, atol):
    if model == "resnet18":
        jm, tm = jresnet.ResNet18(num_classes=10), ResNet18(num_classes=10)
    else:
        jm, tm = _narrow(jresnet), _narrow(tresnet)
    jp, js = _jax_weights(jm, size)
    params, stats = resnet_from_jax_params(jp, js)
    assert set(params) == {k for k, _ in tm.named_parameters()}
    assert set(stats) == {k for k, _ in tm.named_buffers()}
    x = np.random.RandomState(2).rand(8, size, size, 3).astype(np.float32)
    ref, updated = jm.apply({"params": jp, "batch_stats": js}, x, train=True,
                            mutable=["batch_stats"])
    loss, new_stats = make_stateful_loss_fn(tm)(params, stats, (torch.from_numpy(x),
                                                                torch.zeros(8, dtype=torch.long)))
    logits = torch.func.functional_call(tm, {**params, **stats}, (torch.from_numpy(x),),
                                        {"train": True, "new_stats": {}})
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref), rtol=0, atol=atol)
    _, ref_stats = resnet_from_jax_params(jp, jax.device_get(updated["batch_stats"]))
    assert set(new_stats) == set(ref_stats)
    for k in ref_stats:
        np.testing.assert_allclose(new_stats[k].numpy(), ref_stats[k].numpy(), rtol=0, atol=1e-5)
    ref = jm.apply({"params": jp, "batch_stats": js}, x, train=False)
    with torch.no_grad():
        out = make_eval_fn(tm)(params, stats, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_converter_rejects_an_unknown_module():
    params, stats = _jax_weights(_narrow(jresnet), 16)
    with pytest.raises(ValueError, match="no port counterpart"):
        resnet_from_jax_params({**params, "Extra_0": {"kernel": np.zeros((1, 1))}}, stats)


def test_init_resnet_follows_flax_initialisers():
    model = _narrow(tresnet)
    params, stats = init_resnet(model, 32, seed=0)
    assert set(params) == {k for k, _ in model.named_parameters()}
    for name, v in params.items():
        if v.ndim > 1:
            fan_in = v[0].numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            assert v.abs().max() <= 2 * std
        elif name.endswith("bias"):
            assert not v.any()
    # each block's last BN is zero-scaled, every other BN scale is 1
    assert not params["blocks.0.bn2.weight"].any() and not params["blocks.1.bn2.weight"].any()
    assert bool((params["bn_init.weight"] == 1).all()) and bool((params["blocks.1.bn0.weight"] == 1).all())
    assert all(bool((v == (1 if k.endswith(".var") else 0)).all()) for k, v in stats.items())
    again, _ = init_resnet(model, 32, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(v, again[k]) for k, v in params.items())


def _jax_loss(model):
    return jresnet.make_stateful_loss_fn(model)


def _batches(p, per_rank, size, steps, seed=0):
    (x, y), _ = jsynthetic(num_train=p * per_rank * steps, num_test=1, num_classes=10,
                           image_size=size, seed=seed)
    x = x.reshape(steps, p, per_rank, size, size, 3)
    y = y.reshape(steps, p, per_rank)
    return list(zip(x, y))


def _tree(torch_tree, r):
    return {k: v[r].numpy() for k, v in torch_tree.items()}


def _start_both(p):
    jmpi.start(devices=jax.devices()[:p])
    tmpi.start(ranks=p, device="cpu")


@pytest.mark.parametrize("mode,p", [("sync", 2), ("sync", 4), ("async", 4)])
def test_three_momentum_steps_match_the_jax_engine(mode, p, monkeypatch):
    size = 16
    jm, tm = _narrow(jresnet), _narrow(tresnet)
    jp, js = _jax_weights(jm, size)
    batches = _batches(p, 4, size, 3)
    _start_both(p)
    jengine = JEngine(_jax_loss(jm), jp, optimizer=optax.sgd(0.1, momentum=0.9), mode=mode,
                      model_state=js)
    jlosses = [float(jengine.step(b)) for b in batches]

    # pin the card's choice of backend: the kernel rings' plain versions
    monkeypatch.setattr(tmpi.collectives.selector, "select", lambda *a, **k: "kernel")
    params, stats = resnet_from_jax_params(jp, js)
    engine = AllReduceSGDEngine(make_stateful_loss_fn(tm), params, mode=mode,
                                optimizer=SGD(0.1, momentum=0.9), model_state=stats)
    losses = [float(engine.step((torch.from_numpy(x), torch.from_numpy(y)))) for x, y in batches]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)

    ref_params, ref_stats = resnet_from_jax_params(jax.device_get(jengine.params),
                                                   jax.device_get(jengine.model_state))
    ref_trace, _ = resnet_from_jax_params(jax.device_get(jengine.opt_state[0].trace), {})
    for r in range(p):
        for k, v in _tree(engine.params, r).items():
            np.testing.assert_allclose(v, ref_params[k].numpy(), rtol=0, atol=1e-5, err_msg=k)
        for k, v in _tree(engine.opt_state, r).items():
            np.testing.assert_allclose(v, ref_trace[k].numpy(), rtol=0, atol=1e-5, err_msg=k)
        for k, v in _tree(engine.model_state, r).items():
            np.testing.assert_allclose(v, ref_stats[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
    tmpi.nn.check_with_allreduce(engine.params)
    tmpi.nn.check_with_allreduce(engine.model_state)


def test_rank_loop_computes_what_vmap_does():
    p, size = 2, 16
    tm = _narrow(tresnet)
    params, stats = init_resnet(tm, size, seed=1)
    batches = _batches(p, 4, size, 2)
    tmpi.start(ranks=p, device="cpu")
    runs = []
    for rank_map in ("vmap", "loop"):
        engine = AllReduceSGDEngine(make_stateful_loss_fn(tm), params, model_state=stats,
                                    optimizer=SGD(0.1, momentum=0.9), rank_map=rank_map)
        losses = [float(engine.step((torch.from_numpy(x), torch.from_numpy(y))))
                  for x, y in batches]
        runs.append((losses, engine.params, engine.model_state))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-6)
    for a, b in ((runs[0][1], runs[1][1]), (runs[0][2], runs[1][2])):
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="rank_map must be"):
        AllReduceSGDEngine(make_stateful_loss_fn(tm), params, model_state=stats, rank_map="pmap")


def test_bf16_step_matches_the_jax_step():
    """One step with bf16 convolutions. The loss must match the JAX
    engine's within rtol 1e-2. The update must be within 2e-2, in norm
    relative to its norm, of the JAX step's update with every bf16 value
    rounded: the mean of the ranks' ``jax.grad`` of the same loss function
    compiled with ``xla_allow_excess_precision`` off, times -lr (momentum's
    first trace is the gradient). The JAX engine's compiled step keeps
    excess precision (XLA's default), which at this size moves its bf16
    update 22% from the rounded one, while the rounded JAX gradient, the
    op-by-op one and the port's agree within 1%. The bf16 rounding itself
    moves the port's update by more than 5% from its f32 one here (checked,
    so the bf16 path is known to be engaged)."""
    p, size, lr = 2, 16, 0.1
    jm = _narrow(jresnet, dtype=jnp.bfloat16)
    jp, js = _jax_weights(jm, size)
    (x, y), = _batches(p, 4, size, 1)
    _start_both(p)
    jengine = JEngine(_jax_loss(jm), jp, optimizer=optax.sgd(lr, momentum=0.9), model_state=js)
    jloss = float(jengine.step((x, y)))
    loss_fn = _jax_loss(jm)
    grad = jax.jit(jax.grad(lambda q, xb, yb: loss_fn(q, js, (xb, yb))[0])).lower(
        jp, x[0], y[0]).compile(compiler_options={"xla_allow_excess_precision": False})
    grads = [jax.device_get(grad(jp, x[r], y[r])) for r in range(p)]
    mean_grad, _ = resnet_from_jax_params(
        jax.tree_util.tree_map(lambda *g: sum(g) / p, *grads), {})
    params, stats = resnet_from_jax_params(jp, js)
    theirs = np.concatenate([(-lr * mean_grad[k]).numpy().ravel() for k in sorted(params)])

    def update(dtype):
        engine = AllReduceSGDEngine(make_stateful_loss_fn(_narrow(tresnet, dtype=dtype)), params,
                                    optimizer=SGD(lr, momentum=0.9), model_state=stats)
        loss = float(engine.step((torch.from_numpy(x), torch.from_numpy(y))))
        assert all(v.dtype == torch.float32 for v in engine.params.values())
        return loss, np.concatenate([(engine.params[k][0] - params[k]).numpy().ravel()
                                     for k in sorted(params)])

    loss, ours = update(torch.bfloat16)
    np.testing.assert_allclose(loss, jloss, rtol=1e-2)
    assert np.linalg.norm(ours - theirs) <= 2e-2 * np.linalg.norm(theirs)
    _, f32 = update(torch.float32)
    assert np.linalg.norm(ours - f32) >= 5e-2 * np.linalg.norm(f32)


def test_train_resident_and_evaluate_match_the_jax_engine():
    p, size = 2, 16
    jm, tm = _narrow(jresnet), _narrow(tresnet)
    jp, js = _jax_weights(jm, size)
    (xtr, ytr), (xte, yte) = jsynthetic(num_train=35, num_test=13, num_classes=10,
                                        image_size=size)
    _start_both(p)
    jengine = JEngine(_jax_loss(jm), jp, optimizer=optax.sgd(0.1, momentum=0.9), model_state=js)
    jstate = jengine.train_resident(xtr, ytr, 4, max_epochs=2, shuffle=False)

    def japply(prm, st, x):
        return jm.apply({"params": prm, "batch_stats": st}, x, train=False)

    jacc = jengine.evaluate(japply, xte, yte, jaccuracy)

    params, stats = resnet_from_jax_params(jp, js)
    engine = AllReduceSGDEngine(make_stateful_loss_fn(tm), params,
                                optimizer=SGD(0.1, momentum=0.9), model_state=stats)
    seen = []
    state = engine.train_resident(xtr, ytr, 4, max_epochs=2, shuffle=False,
                                  epoch_callback=lambda *a: seen.append(a))
    assert state["t"] == jstate["t"] == 2 * (17 // 4)
    assert state["samples"] == jstate["samples"] and len(state["epoch_times"]) == 2
    assert [a[0] for a in seen] == [0, 1]
    np.testing.assert_allclose(state["losses"], jstate["losses"], rtol=1e-4)
    np.testing.assert_allclose(state["loss"], jstate["loss"], rtol=1e-4)
    ref, _ = resnet_from_jax_params(jax.device_get(jengine.params), {})
    for k, v in _tree(engine.params, 1).items():
        np.testing.assert_allclose(v, ref[k].numpy(), rtol=0, atol=1e-5, err_msg=k)
    acc = engine.evaluate(make_eval_fn(tm), xte, yte, accuracy)
    assert acc == pytest.approx(jacc, abs=1e-6)

    # the shuffled order is the port's own, but seeded: two engines agree
    runs = []
    for _ in range(2):
        engine = AllReduceSGDEngine(make_stateful_loss_fn(tm), params,
                                    optimizer=SGD(0.1, momentum=0.9), model_state=stats)
        runs.append(engine.train_resident(xtr, ytr, 4, max_epochs=1, seed=3)["losses"])
    assert runs[0] == runs[1] and np.isfinite(runs[0]).all()
    with pytest.raises(ValueError, match="per-rank batch"):
        engine.train_resident(xtr, ytr, 32, max_epochs=1)


def test_sequential_twin_matches_the_jax_example():
    sys.path.insert(0, str(REPO))
    from examples import mnist_sequential as jseq

    from torchmpi_tpu.models import LogisticRegression as JLogReg
    from torchmpi_tpu.models import init_params as jinit
    from torchmpi_tpu_torch.examples import mnist_sequential
    from torchmpi_tpu_torch.models import from_jax_params

    # lr 0.02: at the example's 0.2 LogisticRegression is chaotic, and a
    # rounding difference grows to 1e-2 within a few steps
    argv = ["--model", "logreg", "--epochs", "3", "--train", "2048", "--lr", "0.02",
            "--seed", "3"]
    jlosses, jacc = jseq.main(argv + ["--cpu"])
    # the JAX example draws its weights with flax's seed 0
    init = from_jax_params(jax.device_get(jinit(JLogReg(), (1, 28, 28))))
    losses, acc = mnist_sequential.main(argv + ["--device", "cpu"], init=init)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert acc == pytest.approx(jacc, abs=1e-6)


@pytest.mark.parametrize("flag", [["--streaming"], ["--input-workers", "2"],
                                  ["--fsdp", "--streaming"], ["--accum-steps", "2", "--streaming"]])
def test_resnet_example_rejects_unported_flags(flag, capsys):
    """The flags that waited for the streaming input pipeline are ported:
    none is rejected any more. ``--streaming`` trains through an
    ``InputPipeline`` (under fsdp and accumulation too), one epoch of its
    batches; ``--input-workers`` alone leaves the resident path as it is."""
    from torchmpi_tpu_torch.examples import resnet_allreduce

    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # beside other test processes on the same cores
    try:
        state, acc = resnet_allreduce.main(
            ["--device", "cpu", "--ranks", "2", "--model", "resnet18", "--classes", "8",
             "--image-size", "16", "--train", "32", "--test", "16", "--per-rank-batch", "4",
             "--epochs", "1"] + flag)
    finally:
        torch.set_num_threads(threads)
    assert ("pipeline" in state) == ("--streaming" in flag)
    if "pipeline" in state:
        assert state["t"] == len(state["pipeline"]) == 4
        assert state["input_stall"] >= state["pipeline"].consumer_stall_s
    assert np.isfinite(state["losses"]).all() and 0.0 <= acc <= 1.0
    assert "streaming input" in capsys.readouterr().out or "--streaming" not in flag


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_resnet_example_runs_on_the_cpu(mode, capsys):
    from torchmpi_tpu_torch.examples import resnet_allreduce

    state, acc = resnet_allreduce.main(
        ["--model", "resnet18", "--classes", "8", "--image-size", "16", "--train", "32",
         "--test", "16", "--per-rank-batch", "4", "--epochs", "1", "--ranks", "2",
         "--device", "cpu", "--mode", mode])
    out = capsys.readouterr().out
    assert "img/s" in out and "test acc" in out and "check_with_allreduce: ok" in out
    assert state["samples"] == 32 and np.isfinite(state["losses"]).all()
    assert 0.0 <= acc <= 1.0
