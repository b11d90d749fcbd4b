"""The port's streaming input pipeline (``torchmpi_tpu_torch.data``)
against the JAX package's (``torchmpi_tpu.data``), on the CPU.

Both sides get the same seeded numpy datasets. The index plan
(``epoch_order``, ``batch_indices``), every delivered batch, the dropped
tail, the loud producer death, the batch-size check and the ``tm_input_*``
values of a deterministic run (one worker, a one-batch ring) must be
equal: no tolerance anywhere, the pipeline moves samples and never
computes on them. The port runs with ``device='cpu'``, where a batch is
the producer's host tensors; the pinned-memory copy stream runs only on
the card (``chip_smoke.py --streaming`` holds every streamed batch there
bit for bit). The engine's ``train`` on a pipeline is held against the
same engine on a plain iterator of the same host batches, loss for loss,
bit for bit, and its input stall against the pipeline's consumer stall.
"""

import time

import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu import constants as jconstants
from torchmpi_tpu import telemetry as jtelemetry
from torchmpi_tpu.data import InputPipeline as JPipe
from torchmpi_tpu.data import InputProducerError as JProducerError
from torchmpi_tpu_torch import constants as tconstants
from torchmpi_tpu_torch import telemetry as ttelemetry
from torchmpi_tpu_torch.data import ArraySource, InputPipeline, InputProducerError


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs beside other test processes on
    the same cores, where ATen's convolutions with a thread per core spin
    against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _runtimes():
    jmpi.start()
    try:
        yield
    finally:
        tmpi.runtime_state._reset_for_tests()
        tmpi.constants._reset_for_tests()


def _dataset(n, feat=6, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, feat).astype(np.float32)
    y = rng.randint(0, 10, size=n).astype(np.int32)
    return x, y


def _pair(data, **kw):
    return JPipe(data, **kw), InputPipeline(data, device="cpu", **kw)


def _same(jb, tb):
    for j, t in zip(jb, tb):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert t.numpy().dtype == np.asarray(j).dtype


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_index_plan_matches_jax(p):
    """epoch_order and batch_indices are JAX's for every epoch, batch and
    world size, shuffled or not; each rank draws only from its shard."""
    data = _dataset(64 + 3)
    for shuffle in (True, False):
        jp, tp = _pair(data, batch_size=2 * p, num_ranks=p, seed=3, shuffle=shuffle)
        assert (len(tp), tp.shard_len, tp.per_rank) == (len(jp), jp.shard_len, jp.per_rank)
        for epoch in range(3):
            order = tp.epoch_order(epoch)
            np.testing.assert_array_equal(order, jp.epoch_order(epoch))
            for r in range(p):
                assert sorted(order[r]) == list(range(r * tp.shard_len, (r + 1) * tp.shard_len))
            for b in range(len(tp)):
                np.testing.assert_array_equal(tp.batch_indices(epoch, b),
                                              jp.batch_indices(epoch, b))


@pytest.mark.parametrize("workers", [1, 3])
def test_batches_equal_jax_bit_for_bit(workers):
    """Two epochs through ``__call__`` (the engine's iterator_fn): every
    batch equals the JAX pipeline's and ``source.gather`` of its indices,
    in order, however many producers assemble them."""
    data = _dataset(72, seed=4)
    jp, tp = _pair(data, batch_size=6, num_ranks=2, seed=9, workers=workers, prefetch=3)
    src = ArraySource(*data)
    for epoch in range(2):
        jbs, tbs = list(jp()), list(tp())
        assert len(jbs) == len(tbs) == len(tp) > 0
        for b, (jb, tb) in enumerate(zip(jbs, tbs)):
            _same(jb, tb)
            _same(src.gather(tp.batch_indices(epoch, b)), tb)


def test_tail_dropped_and_batch_size_checked():
    x, y = _dataset(30)
    jp, tp = _pair((x, y), batch_size=8, num_ranks=2, shuffle=False)
    # 15 per shard / 4 per rank -> 3 full batches, 3 samples dropped
    assert len(tp) == len(jp) == 3
    assert sum(1 for _ in tp) == 3
    for kw in (dict(batch_size=6, num_ranks=4), dict(batch_size=4, num_ranks=8)):
        with pytest.raises(ValueError) as te:
            InputPipeline(_dataset(16), device="cpu", **kw)
        with pytest.raises(ValueError) as je:
            JPipe(_dataset(16), **kw)
        assert str(te.value) == str(je.value)


def test_producer_death_is_loud():
    """A producer crash surfaces as InputProducerError on the consumer
    with the original exception chained, on both sides."""
    data = _dataset(40, seed=6)

    def poison(xb, yb):
        raise ValueError("corrupt shard")

    for cls, err in ((JPipe, JProducerError), (InputPipeline, InputProducerError)):
        kw = {} if cls is JPipe else {"device": "cpu"}
        pipe = cls(data, batch_size=4, num_ranks=2, transform=poison, workers=2, **kw)
        with pytest.raises(err) as ei:
            list(pipe)
        assert isinstance(ei.value.__cause__, ValueError)
        assert str(ei.value) == "input producer died mid-epoch"


def test_transform_may_return_tensors():
    """A producer's transform casts on the host (the ResNet example's bf16
    cast): the batch arrives in the transform's dtype."""
    data = _dataset(16, seed=2)
    pipe = InputPipeline(data, batch_size=4, num_ranks=2, device="cpu",
                         transform=lambda xb, yb: (torch.from_numpy(xb).to(torch.bfloat16), yb))
    for b, (xb, yb) in enumerate(pipe):
        ex, ey = ArraySource(*data).gather(pipe.batch_indices(0, b))
        assert xb.dtype == torch.bfloat16
        assert torch.equal(xb, torch.from_numpy(ex).to(torch.bfloat16))
        assert torch.equal(yb, torch.from_numpy(ey))


def test_cpu_device_never_touches_cuda(monkeypatch):
    """On a CPU device the batch is the producer's host tensors: no stream,
    event or pinned buffer is asked for."""
    def boom(*a, **k):
        raise AssertionError("torch.cuda touched on a CPU pipeline")

    for name in ("Stream", "Event", "current_stream", "stream"):
        monkeypatch.setattr(torch.cuda, name, boom)
    monkeypatch.setattr(torch.Tensor, "pin_memory", boom)
    pipe = InputPipeline(_dataset(24), batch_size=4, num_ranks=2, device="cpu", workers=2)
    assert sum(1 for _ in pipe) == len(pipe)


def _metric_values(tel):
    m = tel.metrics
    return (m.counter("tm_input_batches_total").value(path="host"),
            m.counter("tm_input_batches_total").value(path="device"),
            m.gauge("tm_input_queue_depth").value(),
            m.counter("tm_input_producer_stall_seconds").total(),
            m.counter("tm_input_consumer_stall_seconds").total())


def test_input_telemetry_matches_jax():
    """One worker and a one-batch ring: each side publishes the same
    tm_input_* values, batch counters equal to the epoch's length and a
    queue depth of 0 (the window admits only the next batch, which the
    consumer has just taken); stall counters non-negative."""
    data = _dataset(48, seed=7)
    got = []
    for tel, consts, cls, kw in ((jtelemetry, jconstants, JPipe, {}),
                                 (ttelemetry, tconstants, InputPipeline, {"device": "cpu"})):
        tel.enable()
        try:
            consts.set("input_prefetch_batches", 1)
            consts.set("input_workers", 1)
            before = _metric_values(tel)
            pipe = cls(data, batch_size=4, num_ranks=2, **kw)
            assert (pipe.prefetch, pipe.workers) == (1, 1)
            n = sum(1 for _ in pipe)
            after = _metric_values(tel)
            assert n == len(pipe) == 12
            got.append((after[0] - before[0], after[1] - before[1], after[2]))
            assert after[3] >= before[3] and after[4] >= before[4]
            assert pipe.consumer_stall_s >= 0.0
        finally:
            tel.disable()
    assert got[0] == got[1] == (12.0, 12.0, 0.0)


def _mlp_engine(comm, seed=0):
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import LogisticRegression, init_params, make_loss_fn

    model = LogisticRegression()
    return AllReduceSGDEngine(make_loss_fn(model), init_params(model, seed=seed), lr=0.1,
                              comm=comm)


def test_engine_on_a_pipeline_equals_a_plain_iterator():
    """engine.train on the pipeline gives every step's loss and the final
    parameters of engine.train on a plain iterator of the same host
    batches, bit for bit; the measured input stall covers the pipeline's
    consumer stall, and telemetry's tm_engine_input_stall_seconds counts
    the same seconds."""
    x = np.random.RandomState(1).rand(96, 28, 28).astype(np.float32)
    y = np.random.RandomState(2).randint(0, 10, 96).astype(np.int32)
    tmpi.start(ranks=4, device="cpu")
    comm = tmpi.current_communicator()
    def transform(xb, yb):  # a slow producer: the consumer must stall
        time.sleep(0.02)
        return xb, yb

    pipe = InputPipeline((x, y), batch_size=16, num_ranks=4, seed=5, device="cpu",
                         workers=1, transform=transform)
    runs = {}
    ttelemetry.enable()
    try:
        for name in ("stream", "plain"):
            losses = []
            engine = _mlp_engine(comm)
            engine.hooks["on_forward"] = lambda s: losses.append(s["loss"].clone())
            stall0 = ttelemetry.metrics.counter("tm_engine_input_stall_seconds").total()
            if name == "stream":
                fn = pipe
            else:
                plain = InputPipeline((x, y), batch_size=16, num_ranks=4, seed=5, device="cpu")
                src = ArraySource(x, y)
                epochs = iter(range(2))

                def fn():
                    e = next(epochs)
                    return iter([tuple(torch.from_numpy(a)
                                       for a in src.gather(plain.batch_indices(e, b)))
                                 for b in range(len(plain))])
            state = engine.train(fn, max_epochs=2)
            stall = ttelemetry.metrics.counter("tm_engine_input_stall_seconds").total() - stall0
            runs[name] = (losses, engine.params, state, stall)
    finally:
        ttelemetry.disable()
    (sl, sp, sstate, sstall), (pl, pp, _, _) = runs["stream"], runs["plain"]
    assert len(sl) == len(pl) == 2 * len(pipe)
    assert all(torch.equal(a, b) for a, b in zip(sl, pl))
    assert all(torch.equal(sp[k], pp[k]) for k in pp)
    assert pipe.consumer_stall_s > 0.0
    assert sstate["input_stall"] >= pipe.consumer_stall_s
    assert sstall == pytest.approx(sstate["input_stall"], abs=1e-9)


def test_resnet_example_streams():
    """``resnet_allreduce --streaming --input-workers 2`` (a narrow
    ResNet-18 on the CPU): every batch the engine receives is
    ``source.gather`` of the pipeline's indices, and every step's loss
    equals the same engine's on a plain iterator of those batches."""
    from torchmpi_tpu_torch.engine import SGD, AllReduceSGDEngine
    from torchmpi_tpu_torch.examples import resnet_allreduce
    from torchmpi_tpu_torch.models import ResNet18, init_resnet, make_stateful_loss_fn
    from torchmpi_tpu_torch.utils import synthetic_imagenet

    argv = ["--device", "cpu", "--ranks", "2", "--model", "resnet18", "--classes", "8",
            "--image-size", "16", "--train", "16", "--test", "8", "--per-rank-batch", "4",
            "--epochs", "2"]
    samples, losses = [], []
    state, _ = resnet_allreduce.main(
        argv + ["--streaming", "--input-workers", "2"],
        hooks={"on_sample": lambda s: samples.append((s["epoch"], s["sample"])),
               "on_forward": lambda s: losses.append(s["loss"].clone())})
    pipe = state["pipeline"]
    assert (pipe.workers, len(samples)) == (2, 2 * len(pipe))
    (xtr, ytr), _ = synthetic_imagenet(num_train=16, num_test=8, num_classes=8, image_size=16)
    src = ArraySource(xtr, ytr)
    host = []
    for i, (epoch, (xb, yb)) in enumerate(samples):
        want = src.gather(pipe.batch_indices(epoch, i % len(pipe)))
        assert torch.equal(xb, torch.from_numpy(want[0]))
        assert torch.equal(yb, torch.from_numpy(want[1]))
        host.append(tuple(torch.from_numpy(a) for a in want))

    tmpi.start(ranks=2, device="cpu")
    torch.backends.cudnn.allow_tf32 = False
    model = ResNet18(num_classes=8, device=torch.device("cpu"))
    params, stats = init_resnet(model, 16, seed=0)
    engine = AllReduceSGDEngine(make_stateful_loss_fn(model), params, mode="sync",
                                optimizer=SGD(0.1, momentum=0.9), model_state=stats,
                                rank_map="loop")
    plain = []
    engine.hooks["on_forward"] = lambda s: plain.append(s["loss"].clone())
    epochs = iter([host[:len(pipe)], host[len(pipe):]])
    engine.train(lambda: iter(next(epochs)), max_epochs=2)
    assert len(plain) == len(losses)
    assert all(torch.equal(a, b) for a, b in zip(losses, plain))
