"""The port's sharded engine modes (``param_sharding='zero1'|'fsdp'``),
gradient accumulation, remat and flat batches against the JAX package's
``AllReduceSGDEngine``, on the CPU, plus the reduce-scatter form of
``FusionBuffer``, ``MLP6`` and ``Adam``.

The JAX engine runs on the virtual CPU devices of ``tests/conftest.py``;
the port at the same p with ``device="cpu"`` and its selector pinned to
the kernel backend, the card's choice, so the kernel rings' plain versions
carry the reduce-scatters and allgathers. Weights cross over through the
converters; inputs come from numpy seeds. Tolerances, each stated where it
is used:

- ``FusionBuffer`` reduce-scatter: the packed buffer and every result
  exactly equal to the JAX buffer's (integer-valued payloads).
- ``MLP6(features=8 p)``, one or two epochs of
  ``train_resident(shuffle=False)``: epoch losses within rtol 1e-4 and
  parameters within rtol 1e-4, atol 1e-6 of the JAX engine's in the same
  mode (``tests/test_engine.py:273-279``), and the port's zero1/fsdp within
  the same of its own replicated run; accumulation over 4 microbatches the
  same against 1. Adam runs there with eps 1e-3: at its default 1e-8 it
  divides each gradient by about its own magnitude, so an element whose
  gradient is near eps moves by lr times its relative rounding error, and
  XLA's and ATen's matmuls round MLP6's gradients differently enough that
  21 of its 60,000 parameters end 2e-4 apart after 4 steps (on the xla and
  the kernel route alike). ``test_adam_matches_optax`` holds the default
  update on the same gradients within rtol 1e-5.
- A narrow ResNet under fsdp, three momentum steps: losses within rtol
  1e-4 of the JAX fsdp run and batch statistics within atol 1e-5; the JAX
  replicated run's statistics (per-rank, then averaged) must differ from
  them by more than 1e-4, so that a per-rank ``pmean`` cannot pass.
- ``remat=True`` against no remat: losses and parameters bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu.collectives import fusion as jfusion
from torchmpi_tpu.engine import AllReduceSGDEngine as JEngine
from torchmpi_tpu.models import MLP6 as JMLP6
from torchmpi_tpu.models import LogisticRegression as JLogReg
from torchmpi_tpu.models import make_loss_fn as jloss
from torchmpi_tpu.models import resnet as jresnet
from torchmpi_tpu.utils import synthetic_imagenet as jsynthetic_imagenet
from torchmpi_tpu.utils import synthetic_mnist as jsynthetic
from torchmpi_tpu_torch import collectives as tcoll
from torchmpi_tpu_torch.engine import SGD, Adam, AllReduceSGDEngine
from torchmpi_tpu_torch.models import (
    MLP6,
    LogisticRegression,
    accuracy,
    from_jax_params,
    init_params,
    init_resnet,
    make_eval_fn,
    make_loss_fn,
    make_stateful_loss_fn,
    resnet_from_jax_params,
)
from torchmpi_tpu_torch.models import resnet as tresnet

P = 8


@pytest.fixture(autouse=True)
def _fresh_port():
    yield
    tmpi.runtime_state._reset_for_tests()
    tmpi.constants._reset_for_tests()


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs beside other test processes on
    the same cores, where ATen's convolutions with a thread per core spin
    against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def kernel_route(monkeypatch):
    """The port's selector pinned to the card's choice, the kernel rings
    (their plain versions on the CPU)."""
    monkeypatch.setattr(tmpi.collectives.selector, "select", lambda *a, **k: "kernel")


def _flax_weights(model, shape, seed=0):
    """A flax model's variables as numpy trees, in the shapes of its
    ``init`` (traced, not run: flax's initialisers are slow on the CPU):
    kernels normal with variance 1/fan_in, biases and BN parameters moved
    off 0 and 1, variances positive."""
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros(shape)), jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        z = rs.randn(*leaf.shape).astype(np.float32)
        if name == "kernel":
            return z / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        if name == "var":
            return 1 + 0.1 * np.abs(z)
        return (1 if name == "scale" else 0) + 0.1 * z

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _start_both(p=P):
    jmpi.start(devices=jax.devices()[:p])
    tmpi.start(ranks=p, device="cpu")


# --- FusionBuffer: the reduce-scatter form --------------------------------
@pytest.mark.parametrize("cap", [1 << 20, 96])
def test_fusion_reducescatter_matches_jax_packing(cap, kernel_route, monkeypatch):
    """The same submissions to both buffers: every flushed buffer (the
    interleaved packing of ``fusion.py:349-364``) and every result equal,
    also where the byte cap cuts the group in two and for a tensor that
    cannot fuse (not 2-D)."""
    p = 4
    rs = np.random.RandomState(cap)
    xs = [rs.randint(-8, 8, size=s).astype(np.float32)
          for s in [(p, 8), (p, 12), (p, 4), (p, 2, 4), (p, 20), (p, 16)]]
    _start_both(p)
    jmpi.constants.set("fusion_buffer_bytes", cap)
    tmpi.constants.set("fusion_buffer_bytes", cap)
    seen = {"jax": [], "port": []}
    jdispatch, tdispatch = jmpi.collectives._dispatch, tcoll._dispatch

    def jcapture(op, x, *a, **k):
        seen["jax"].append((op, np.asarray(x)))
        return jdispatch(op, x, *a, **k)

    def tcapture(op, x, *a, **k):
        seen["port"].append((op, x.numpy().copy()))
        return tdispatch(op, x, *a, **k)

    monkeypatch.setattr(jmpi.collectives, "_dispatch", jcapture)
    monkeypatch.setattr(tcoll, "_dispatch", tcapture)
    jfb = jfusion.FusionBuffer(jmpi.current_communicator())
    tfb = tcoll.FusionBuffer(tmpi.current_communicator())
    jh = [jfb.submit("reducescatter", jnp.asarray(x)) for x in xs]
    th = [tfb.submit("reducescatter", torch.from_numpy(x)) for x in xs]
    jfb.flush_all()
    tfb.flush_all()
    for a, b in zip(jh, th):
        np.testing.assert_array_equal(b.wait().numpy(), np.asarray(a.wait()))
    assert [op for op, _ in seen["port"]] == [op for op, _ in seen["jax"]]
    for (_, a), (_, b) in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(b, a)
    fused = [x for _, x in seen["port"] if x.shape[1] > 16]
    assert len(fused) == (1 if cap > 1000 else 2)
    # tensor (p, 12)'s chunk r lies at offset 8/p of rank r's block
    np.testing.assert_array_equal(fused[0].reshape(p, p, -1)[:, :, 2:5], xs[1].reshape(p, p, 3))


# --- MLP6 against the JAX engine ------------------------------------------
def _mlp_setup(p=P, seed=0):
    jm = JMLP6(features=8 * p)
    jp = _flax_weights(jm, (1, 28, 28), seed)["params"]
    return jm, jp, MLP6(features=8 * p), from_jax_params(jp)


def _optimizers(name):
    return {"sgd": (optax.sgd(0.1), SGD(0.1)),
            "momentum": (optax.sgd(0.1, momentum=0.9), SGD(0.1, momentum=0.9)),
            # eps 1e-3: see the module docstring
            "adam": (optax.adam(1e-2, eps=1e-3), Adam(1e-2, eps=1e-3))}[name]


def _mlp_params(engine):
    return {k: v[0].numpy() for k, v in engine.gathered_params().items()}


def test_mlp6_matches_flax():
    jm, jp, tm, params = _mlp_setup()
    x = np.random.RandomState(1).rand(4, 28, 28).astype(np.float32)
    ref = np.asarray(jm.apply({"params": jp}, x))
    out = torch.func.functional_call(tm, params, (torch.from_numpy(x),))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-5)
    assert sum(v.numel() for v in params.values()) == sum(
        np.size(v) for v in jax.tree_util.tree_leaves(jp))


@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "adam"])
@pytest.mark.parametrize("sharding", ["replicated", "zero1", "fsdp"])
def test_mlp6_train_resident_matches_the_jax_engine(sharding, optimizer, kernel_route):
    """Two epochs of 4 steps, global batch 64: the port in each mode
    against the JAX engine in the same mode and against its own replicated
    run (``tests/test_engine.py:256-339``'s trajectories)."""
    jm, jp, tm, params = _mlp_setup()
    (xtr, ytr), _ = jsynthetic(num_train=256, num_test=1)
    _start_both()
    jopt, topt = _optimizers(optimizer)
    jengine = JEngine(jloss(jm), jp, optimizer=jopt, param_sharding=sharding)
    jstate = jengine.train_resident(xtr, ytr, 8, max_epochs=2, shuffle=False)
    engines = {}
    for mode in {"replicated", sharding}:
        _, topt = _optimizers(optimizer)
        engines[mode] = AllReduceSGDEngine(make_loss_fn(tm), params, optimizer=topt,
                                           param_sharding=mode)
        state = engines[mode].train_resident(xtr, ytr, 8, max_epochs=2, shuffle=False)
        np.testing.assert_allclose(state["losses"], jstate["losses"], rtol=1e-4)
    ref = from_jax_params(jax.device_get(jengine.params))
    ours, base = _mlp_params(engines[sharding]), _mlp_params(engines["replicated"])
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(ours[k], base[k], rtol=1e-4, atol=1e-6, err_msg=k)
    engine = engines[sharding]
    # every leaf but the head's 10-wide bias divides by p and is sharded
    assert sorted(engine._sharded) == ([] if sharding == "replicated" else
                                       sorted(k for k in params if k != "dense5.bias"))
    w = "dense0.weight"
    shard = (P, params[w].numel() // P)
    assert engine.params[w].shape == (shard if sharding == "fsdp" else (P,) + params[w].shape)
    moments = (engine.opt_state if optimizer == "momentum" else
               engine.opt_state["mu"] if optimizer == "adam" else None)
    if moments is not None:
        assert moments[w].shape == (shard if sharding != "replicated" else (P,) + params[w].shape)
        assert moments["dense5.bias"].shape == (P, 10)


def _launches(monkeypatch):
    """Count the reduce-scatter and allgather calls of the kernel backend."""
    from torchmpi_tpu_torch.ops import ring_kernels

    calls = {"rs": 0, "ag": 0}
    for name, key in (("ring_reduce_scatter", "rs"), ("ring_allgather", "ag")):
        fn = getattr(ring_kernels, name)

        def counted(*a, _fn=fn, _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(ring_kernels, name, counted)
    return calls


@pytest.mark.parametrize("sharding,rs,ag", [("replicated", 0, 0), ("zero1", 1, 1),
                                            ("fsdp", 1, 1)])
def test_one_step_runs_one_reduce_scatter_and_one_allgather(sharding, rs, ag, kernel_route,
                                                            monkeypatch):
    """Per step: one fused reduce-scatter of the sharded partials (one
    flush below ``fusion_buffer_bytes``) and one allgather (fsdp: the
    parameters before the forward; zero1: the updates after the
    optimizer); the replicated mode runs neither."""
    _, _, tm, params = _mlp_setup(p=4)
    tmpi.start(ranks=4, device="cpu")
    calls = _launches(monkeypatch)
    engine = AllReduceSGDEngine(make_loss_fn(tm), params, optimizer=SGD(0.1, momentum=0.9),
                                param_sharding=sharding)
    x = torch.from_numpy(np.random.RandomState(0).rand(4, 2, 28, 28).astype(np.float32))
    engine.step((x, torch.zeros(4, 2, dtype=torch.long)))
    assert calls == {"rs": rs, "ag": ag}


@pytest.mark.parametrize("sharding", ["zero1", "fsdp"])
def test_leaves_stay_contiguous(sharding, kernel_route, monkeypatch):
    """The card's kernels take contiguous leaves only: every leaf the
    update's K1 call takes, and every parameter, trace and gathered leaf,
    is contiguous, also a leaf whose gathered block could be a strided
    view (a first axis of p elements)."""
    from torchmpi_tpu_torch.engine import sgd as engine_sgd

    real = engine_sgd.accumulate_many

    def checked(outs, inps):
        assert all(t.is_contiguous() for t in list(outs) + list(inps))
        return real(outs, inps)

    monkeypatch.setattr(engine_sgd, "accumulate_many", checked)
    p = 4
    params = {"a": torch.ones(p), "b": torch.ones(p, 5), "c": torch.ones(3, 2 * p),
              "d": torch.ones(3)}

    def loss_fn(prm, batch):
        x, _ = batch
        return sum((v * x.mean()).sum() for v in prm.values())

    tmpi.start(ranks=p, device="cpu")
    engine = AllReduceSGDEngine(loss_fn, params, optimizer=SGD(0.1, momentum=0.9),
                                param_sharding=sharding)
    assert sorted(engine._sharded) == ["a", "b", "c"]
    for _ in range(2):
        engine.step((torch.ones(p, 2, 3), torch.zeros(p, 2)))
        for tree in (engine.params, engine.opt_state, engine.gathered_params()):
            assert all(v.is_contiguous() for v in tree.values())


@pytest.mark.parametrize("sharding", ["replicated", "fsdp"])
def test_accum_steps_matches_unaccumulated(sharding, kernel_route):
    """``tests/test_engine.py:340-365``: 4 microbatches follow the k=1
    trajectory, and the JAX engine's accumulated run."""
    jm, jp, tm, params = _mlp_setup()
    (xtr, ytr), _ = jsynthetic(num_train=256, num_test=1)
    _start_both()
    jengine = JEngine(jloss(jm), jp, optimizer=optax.sgd(0.1), param_sharding=sharding,
                      accum_steps=4)
    jstate = jengine.train_resident(xtr, ytr, 8, max_epochs=1, shuffle=False)
    runs = {}
    for k in (1, 4):
        engine = AllReduceSGDEngine(make_loss_fn(tm), params, optimizer=SGD(0.1),
                                    param_sharding=sharding, accum_steps=k)
        state = engine.train_resident(xtr, ytr, 8, max_epochs=1, shuffle=False)
        runs[k] = (state["losses"], _mlp_params(engine))
    np.testing.assert_allclose(runs[4][0], runs[1][0], rtol=1e-4)
    np.testing.assert_allclose(runs[4][0], jstate["losses"], rtol=1e-4)
    ref = from_jax_params(jax.device_get(jengine.params))
    for k in ref:
        np.testing.assert_allclose(runs[4][1][k], runs[1][1][k], rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(runs[4][1][k], ref[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def test_accumulation_sums_with_the_accumulate_list_call(monkeypatch):
    """k microbatches: k list calls of K1 sum the gradients from zeros, and
    one more adds the update."""
    from torchmpi_tpu_torch.engine import sgd as engine_sgd

    _, _, tm, params = _mlp_setup(p=2)
    tmpi.start(ranks=2, device="cpu")
    calls = []
    real = engine_sgd.accumulate_many
    monkeypatch.setattr(engine_sgd, "accumulate_many",
                        lambda outs, inps: calls.append(len(outs)) or real(outs, inps))
    engine = AllReduceSGDEngine(make_loss_fn(tm), params, param_sharding="fsdp", accum_steps=3)
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 6, 28, 28).astype(np.float32))
    engine.step((x, torch.zeros(2, 6, dtype=torch.long)))
    assert calls == [len(params)] * 4


# --- ResNet: global batch statistics under fsdp ---------------------------
def _resnet_batches(p, per_rank, size, steps):
    (x, y), _ = jsynthetic_imagenet(num_train=p * per_rank * steps, num_test=1, num_classes=8,
                                    image_size=size)
    return list(zip(x.reshape(steps, p, per_rank, size, size, 3), y.reshape(steps, p, per_rank)))


def _narrow(module):
    return module.ResNet(stage_sizes=[1, 1], block=module.BottleneckBlock, num_filters=8,
                         num_classes=8)


@pytest.mark.parametrize("sharding,accum", [("fsdp", 1), ("zero1", 1), ("fsdp", 2)])
def test_resnet_sharded_uses_the_global_batch_statistics(sharding, accum, kernel_route):
    """Three momentum steps of a narrow ResNet at p=4, 4 images a rank:
    the port's sharded run against the JAX one (one GSPMD computation over
    the global batch), losses and batch statistics; in the plain fsdp case
    the JAX replicated run (per-rank statistics, averaged) is farther from
    them than the tolerance."""
    p, size = 4, 16
    jm, tm = _narrow(jresnet), _narrow(tresnet)
    variables = _flax_weights(jm, (1, size, size, 3))
    jp, js = variables["params"], variables["batch_stats"]
    batches = _resnet_batches(p, 4, size, 3)
    _start_both(p)
    runs = {}
    # the JAX replicated run once, for the case that holds the statistics
    # apart from it
    for mode in (("replicated",) if (sharding, accum) == ("fsdp", 1) else ()) + (sharding,):
        jengine = JEngine(jresnet.make_stateful_loss_fn(jm), jp, model_state=js,
                          optimizer=optax.sgd(0.1, momentum=0.9), param_sharding=mode,
                          accum_steps=accum)
        losses = [float(jengine.step(b)) for b in batches]
        runs[mode] = (losses, resnet_from_jax_params(jax.device_get(jengine.params),
                                                     jax.device_get(jengine.model_state)))
    params, stats = resnet_from_jax_params(jp, js)
    engine = AllReduceSGDEngine(make_stateful_loss_fn(tm), params, model_state=stats,
                                optimizer=SGD(0.1, momentum=0.9), param_sharding=sharding,
                                accum_steps=accum)
    losses = [float(engine.step((torch.from_numpy(x), torch.from_numpy(y))))
              for x, y in batches]
    jlosses, (jparams, jstats) = runs[sharding]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    ours = {k: v[0].numpy() for k, v in engine.model_state.items()}
    for k, v in jstats.items():
        np.testing.assert_allclose(ours[k], v.numpy(), rtol=0, atol=1e-5, err_msg=k)
        for r in range(1, p):  # the global statistics, the same on every rank
            np.testing.assert_array_equal(engine.model_state[k][r].numpy(), ours[k])
    full = {k: v[0].numpy() for k, v in engine.gathered_params().items()}
    for k, v in jparams.items():
        np.testing.assert_allclose(full[k], v.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
    if "replicated" in runs:
        _, (_, rstats) = runs["replicated"]
        assert max(float(np.abs(ours[k] - v.numpy()).max()) for k, v in rstats.items()) > 1e-4
    tmpi.nn.check_with_allreduce(engine.gathered_params())
    tmpi.nn.check_with_allreduce(engine.model_state)


@pytest.mark.parametrize("p", [1, 3])
def test_rank_stacked_batch_norm_gradients(p):
    """The rank-stacked batch norm's own backward against autograd through
    the same function composed of plain operations, in f64: the output
    and the gradients of the input and of each rank's scale and bias
    within 1e-10; the statistics are every rank's rows'."""
    rs = np.random.RandomState(p)
    x = torch.from_numpy(rs.randn(p * 3, 5, 4, 4)).to(memory_format=torch.channels_last)
    w, b = torch.from_numpy(rs.randn(p, 5)), torch.from_numpy(rs.randn(p, 5))
    dy = torch.from_numpy(rs.randn(p * 3, 5, 4, 4))
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    y, mean, invstd = tresnet._RankBatchNorm.apply(*leaves)
    grads = torch.autograd.grad(y, leaves, dy)
    ref = [t.clone().requires_grad_() for t in (x, w, b)]
    m = ref[0].mean(dim=(0, 2, 3), keepdim=True)
    v = ((ref[0] - m) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    xhat = ((ref[0] - m) / torch.sqrt(v + tresnet.BN_EPS)).unflatten(0, (p, -1))
    want = (xhat * ref[1][:, None, :, None, None] + ref[2][:, None, :, None, None]).flatten(0, 1)
    np.testing.assert_allclose(y.detach().numpy(), want.detach().numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(mean.numpy(), m.flatten().detach().numpy(), rtol=0, atol=1e-12)
    for g, h in zip(grads, torch.autograd.grad(want, ref, dy)):
        np.testing.assert_allclose(g.numpy(), h.numpy(), rtol=0, atol=1e-10)


def test_resnet_evaluate_gathers_the_fsdp_parameters(kernel_route):
    """``evaluate`` under fsdp equals ``evaluate`` of a replicated engine
    holding the same parameters and statistics."""
    p, size = 2, 16
    tm = _narrow(tresnet)
    params, stats = init_resnet(tm, size, seed=2)
    (xte, yte), _ = jsynthetic_imagenet(num_train=12, num_test=1, num_classes=8, image_size=size)
    tmpi.start(ranks=p, device="cpu")
    accs = [AllReduceSGDEngine(make_stateful_loss_fn(tm), params, model_state=stats,
                               param_sharding=mode).evaluate(make_eval_fn(tm), xte, yte, accuracy)
            for mode in ("fsdp", "replicated")]
    assert accs[0] == accs[1]


# --- remat ----------------------------------------------------------------
@pytest.mark.parametrize("model,sharding,rank_map", [
    ("mlp", "replicated", "vmap"), ("mlp", "replicated", "loop"), ("mlp", "fsdp", "vmap"),
    ("resnet", "replicated", "vmap"), ("resnet", "replicated", "loop"), ("resnet", "fsdp", "loop"),
])
def test_remat_is_bit_identical(model, sharding, rank_map, kernel_route):
    """Two steps with ``remat=True`` against two without: the losses, the
    parameters and the statistics bit for bit (``sgd.py:231-235``)."""
    p = 2
    if model == "mlp":
        tm = MLP6(features=8 * p)
        params, stats = init_params(tm, seed=3), None
        loss_fn, x = make_loss_fn(tm), np.random.RandomState(0).rand(2, p, 4, 28, 28)
    else:
        tm = _narrow(tresnet)
        params, stats = init_resnet(tm, 16, seed=3)
        loss_fn, x = make_stateful_loss_fn(tm), np.random.RandomState(0).rand(2, p, 4, 16, 16, 3)
    x = torch.from_numpy(x.astype(np.float32))
    y = torch.from_numpy(np.random.RandomState(1).randint(0, 8, (2, p, 4)))
    tmpi.start(ranks=p, device="cpu")
    runs = []
    for remat in (False, True):
        engine = AllReduceSGDEngine(loss_fn, params, model_state=stats, remat=remat,
                                    optimizer=SGD(0.1, momentum=0.9), param_sharding=sharding,
                                    rank_map=rank_map)
        losses = [engine.step((x[i], y[i])) for i in range(2)]
        runs.append((losses, engine.gathered_params(), engine.model_state or {}))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    for t in (1, 2):
        for k, v in runs[0][t].items():
            assert torch.equal(v, runs[1][t][k]), k


# --- validation, flat batches, broadcast ----------------------------------
@pytest.mark.parametrize("kw,match", [
    (dict(accum_steps=0), "accum_steps"),
    (dict(accum_steps=2.0), "accum_steps"),
    (dict(param_sharding="fsdp", mode="async"), "fsdp"),
    (dict(param_sharding="zero1", average_gradients=False), "zero1"),
    (dict(param_sharding="fsdp", wire_dtype="int8"), "requires param_sharding='replicated'"),
    (dict(param_sharding="zero1", wire_dtype="bf16"), "requires param_sharding='replicated'"),
    (dict(param_sharding="zero3"), "param_sharding must be"),
    (dict(batch_format="ragged"), "batch_format must be"),
])
def test_constructor_validation_matches_the_jax_engine(kw, match):
    """The JAX engine's messages (``tests/test_engine.py:369-380,
    442-448``): both packages raise ValueError naming the argument."""
    _start_both(2)
    jparams = {"Dense_0": {"kernel": np.zeros((784, 10), np.float32),
                           "bias": np.zeros(10, np.float32)}}
    with pytest.raises(ValueError, match=match):
        JEngine(jloss(JLogReg()), jparams, **kw)
    with pytest.raises(ValueError, match=match):
        AllReduceSGDEngine(make_loss_fn(LogisticRegression()), from_jax_params(jparams), **kw)


def test_sharded_modes_resolve_the_wire_to_full():
    tmpi.start(ranks=2, device="cpu")
    tmpi.constants.set("wire_dtype", "int8")
    model = LogisticRegression()
    for mode, wire in (("replicated", "int8"), ("zero1", "full"), ("fsdp", "full")):
        engine = AllReduceSGDEngine(make_loss_fn(model), init_params(model), param_sharding=mode)
        assert engine.wire_dtype == wire


@pytest.mark.parametrize("sharding", ["replicated", "fsdp"])
def test_accum_steps_must_divide_the_per_rank_batch(sharding):
    (xtr, ytr), _ = jsynthetic(num_train=64, num_test=1)
    tmpi.start(ranks=2, device="cpu")
    _, _, tm, params = _mlp_setup(p=2)
    engine = AllReduceSGDEngine(make_loss_fn(tm), params, param_sharding=sharding, accum_steps=3)
    with pytest.raises(ValueError, match="not divisible"):
        engine.train_resident(xtr, ytr, 8, max_epochs=1)


@pytest.mark.parametrize("sharding", ["replicated", "zero1", "fsdp"])
def test_flat_batches_match_stacked_ones(sharding):
    """``tests/test_engine.py:472-482``: flat ``[p B, ...]`` batches,
    including B=1 where ``x.shape[0] == p`` with 1-D labels, are read as
    flat; a flat and a stacked batch step to the same parameters."""
    p = 4
    model = LogisticRegression()
    params = init_params(model, seed=1)
    tmpi.start(ranks=p, device="cpu")
    x = np.random.RandomState(0).randn(p, 28, 28).astype(np.float32)  # B=1
    y = np.zeros((p,), np.int64)
    engine = AllReduceSGDEngine(make_loss_fn(model), params, param_sharding=sharding)
    state = engine.train(lambda: iter([(x, y)]), max_epochs=1)
    assert len(state["losses"]) == 1 and state["samples"] == p
    x = torch.from_numpy(np.random.RandomState(1).randn(p * 3, 28, 28).astype(np.float32))
    y = torch.arange(p * 3) % 10
    flat, stacked = (AllReduceSGDEngine(make_loss_fn(model), params, param_sharding=sharding,
                                        batch_format=fmt) for fmt in ("flat", "stacked"))
    assert torch.equal(flat.step((x, y)), stacked.step((x.reshape(p, 3, 28, 28), y.reshape(p, 3))))
    for k, v in flat.params.items():
        assert torch.equal(v, stacked.params[k]), k
    with pytest.raises(ValueError, match="do not split"):
        flat.step((x[:5], y[:5]))


@pytest.mark.parametrize("sharding", ["replicated", "zero1", "fsdp"])
def test_broadcast_parameters_now(sharding):
    """Replicated: rank 0's parameters on every rank (``sgd.py:893-896``);
    the sharded modes hold one logical copy, and it is the identity."""
    model = LogisticRegression()
    tmpi.start(ranks=3, device="cpu")
    engine = AllReduceSGDEngine(make_loss_fn(model), init_params(model, seed=4),
                                param_sharding=sharding)
    engine.params = {k: v + torch.arange(3.0).reshape((3,) + (1,) * (v.ndim - 1))
                     for k, v in engine.params.items()}
    before = dict(engine.params)
    engine.broadcast_parameters_now()
    for k, v in engine.params.items():
        if sharding == "replicated":
            assert torch.equal(v, before[k][:1].expand_as(v))
        else:
            assert v is before[k]


# --- Adam and the example -------------------------------------------------
def test_adam_matches_optax():
    rs = np.random.RandomState(0)
    params = {"w": rs.randn(3, 5).astype(np.float32), "b": rs.randn(5).astype(np.float32)}
    opt, ours = optax.adam(3e-3), Adam(3e-3)
    jstate = opt.init(params)
    tstate = ours.init({k: torch.from_numpy(v) for k, v in params.items()})
    for _ in range(4):
        grads = {k: rs.randn(*v.shape).astype(np.float32) for k, v in params.items()}
        jupd, jstate = opt.update(grads, jstate)
        tupd, tstate = ours.update({k: torch.from_numpy(v) for k, v in grads.items()}, tstate)
        for k in params:
            np.testing.assert_allclose(tupd[k].numpy(), np.asarray(jupd[k]), rtol=1e-5, atol=1e-9)
    assert tstate["count"] == 4


@pytest.mark.parametrize("flags", [["--fsdp", "--accum-steps", "2"], ["--accum-steps", "2"]])
def test_resnet_example_fsdp_and_accumulation_on_the_cpu(flags, capsys):
    from torchmpi_tpu_torch.examples import resnet_allreduce

    state, acc = resnet_allreduce.main(
        ["--model", "resnet18", "--classes", "8", "--image-size", "16", "--train", "32",
         "--test", "16", "--per-rank-batch", "4", "--epochs", "1", "--ranks", "2",
         "--device", "cpu"] + flags)
    out = capsys.readouterr().out
    assert "img/s" in out and "test acc" in out and "check_with_allreduce: ok" in out
    assert ("param_sharding fsdp" in out) == ("--fsdp" in flags)
    assert state["samples"] == 32 and np.isfinite(state["losses"]).all()
    assert 0.0 <= acc <= 1.0
