"""The port engine's observability and evaluation options against the JAX
engine's, on the CPU: the profiler window (``profile_dir``,
``profile_window``), step telemetry (``tm_engine_*``, spans, flight
entries, per-step trace roots, ``flops_per_sample``), the measured input
stall of ``train``, and the eval cache (``evaluate``,
``invalidate_eval_cache``).

Tolerances: the metric names and kinds, the trace ids and the MFU
arithmetic are held equal to the JAX package's; the global gradient norm
after one step within rtol 1e-4 of the JAX engine's (the parity bound of
``tests/test_torch_engine.py``); the cached ``evaluate`` equal to the
uncached one exactly.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu import telemetry as jtel
from torchmpi_tpu.engine import AllReduceSGDEngine as JEngine
from torchmpi_tpu.engine import sgd as jsgd
from torchmpi_tpu.telemetry import tracecontext as jtrace
from torchmpi_tpu.utils import flops as jflops
from torchmpi_tpu.utils import tracing as jtracing
from torchmpi_tpu_torch import telemetry as ttel
from torchmpi_tpu_torch.engine import SGD, AllReduceSGDEngine
from torchmpi_tpu_torch.engine import sgd as tsgd
from torchmpi_tpu_torch.models import LogisticRegression, init_params, make_loss_fn
from torchmpi_tpu_torch.telemetry import flightrecorder as tflight
from torchmpi_tpu_torch.telemetry import tracecontext as ttrace
from torchmpi_tpu_torch.utils import flops as tflops
from torchmpi_tpu_torch.utils import synthetic_mnist
from torchmpi_tpu_torch.utils import tracing as ttracing

P = 4


@pytest.fixture(autouse=True)
def _fresh():
    yield
    for tel in (ttel, jtel):
        tel.disable()
        tel.reset()
    tflight.disable()
    tmpi.runtime_state._reset_for_tests()
    tmpi.constants._reset_for_tests()


def _linear(p=P, telemetry=False, start=True, **kw):
    """A linear least-squares engine (``tests/test_telemetry.py:186-198``'s
    model) at p ranks."""
    if telemetry:
        ttel.enable()
    if start:
        tmpi.start(ranks=p, device="cpu")

    def loss_fn(params, batch):
        xb, yb = batch
        return torch.mean((xb @ params["w"] - yb) ** 2)

    return AllReduceSGDEngine(loss_fn, {"w": torch.zeros(8)}, optimizer=SGD(0.1), **kw)


def _linear_batches(steps, p=P, seed=0):
    rs = np.random.RandomState(seed)
    w = rs.randn(8).astype(np.float32)
    out = []
    for _ in range(steps):
        xb = rs.randn(p, 2, 8).astype(np.float32)
        out.append((torch.from_numpy(xb), torch.from_numpy(xb @ w)))
    return out


# --- the profiler window ----------------------------------------------------
@pytest.mark.parametrize("begin,end", [(-1, 2), (3, 3), (5, 2)])
def test_profiler_window_bounds_match_jax(begin, end, tmp_path):
    with pytest.raises(ValueError) as ours:
        ttracing.ProfilerWindow(str(tmp_path), begin, end)
    with pytest.raises(ValueError) as ref:
        jtracing.ProfilerWindow(str(tmp_path), begin, end)
    assert str(ours.value) == str(ref.value)
    assert "0 <= begin < end" in str(ours.value)


def _trace_names(path):
    return [ev.get("name") for ev in json.loads(path.read_text())["traceEvents"]]


def test_train_writes_a_trace_of_its_window(tmp_path):
    """``profile_window=(3, 5)`` over 6 steps: one Chrome trace holding
    exactly steps 3 and 4 (two ``engine.step`` ranges, each with the
    step's operations)."""
    eng = _linear(profile_dir=str(tmp_path), profile_window=(3, 5))
    eng.train(lambda: iter(_linear_batches(6)), max_epochs=1)
    traces = list(tmp_path.glob("*.json"))
    assert len(traces) == 1 and traces[0].name.endswith("steps3-5.json")
    names = _trace_names(traces[0])
    assert names.count("engine.step") == 2
    assert any(n.startswith("aten::") for n in names if n)
    assert not torch.autograd._profiler_enabled()


def test_window_closes_on_exception_and_short_loops(tmp_path):
    """A hook that raises inside the window, and a loop that ends before
    the window does: the trace is stopped and written either way."""
    def boom(state):
        if state["t"] == 3:
            raise RuntimeError("hook failed")

    eng = _linear(profile_dir=str(tmp_path / "a"), profile_window=(2, 8),
                  hooks={"on_update": boom})
    with pytest.raises(RuntimeError, match="hook failed"):
        eng.train(lambda: iter(_linear_batches(6)), max_epochs=1)
    assert not torch.autograd._profiler_enabled()
    assert _trace_names(next((tmp_path / "a").glob("*.json"))).count("engine.step") == 2
    short = _linear(profile_dir=str(tmp_path / "b"), profile_window=(3, 8), start=False)
    short.train(lambda: iter(_linear_batches(4)), max_epochs=1)
    assert not torch.autograd._profiler_enabled()
    assert _trace_names(next((tmp_path / "b").glob("*.json"))).count("engine.step") == 1


def test_annotate_and_timer():
    with torch.profiler.profile() as prof:
        with ttracing.annotate("my.region"):
            torch.ones(3).sum()
    assert any(e.key == "my.region" for e in prof.key_averages())
    t = ttracing.Timer()
    time.sleep(0.01)
    assert t.time() >= 0.01


def test_wire_byte_counters_match_jax():
    ours, ref = ttracing.WireByteCounters(), jtracing.WireByteCounters()
    for c in (ours, ref):
        c.record("allreduce", "int8", 4096, 1056)
        c.record("allreduce", "full", 100, 100)
    assert ours.snapshot() == ref.snapshot()
    assert ours.compression_ratio() == ref.compression_ratio()
    ours.reset()
    assert ours.compression_ratio() == 1.0


def test_vlog_levels(capsys):
    level = ttracing.debug_level()
    try:
        ttracing.set_debug_level(1)
        ttracing.vlog(1, "shown")
        ttracing.vlog(2, "hidden")
    finally:
        ttracing.set_debug_level(level)
    err = capsys.readouterr().err
    assert "shown" in err and "hidden" not in err and "[tm:1]" in err


# --- telemetry ----------------------------------------------------------------
def test_engine_metric_names_and_kinds_match_jax():
    ours, ref = tsgd._engine_metrics(), jsgd._engine_metrics()
    assert [(m.name, type(m).__name__) for m in ours] == \
        [(m.name, type(m).__name__) for m in ref]


def test_record_step_arithmetic_matches_jax(monkeypatch):
    """The same window, examples per chip, gradient norm and input stall
    through both ``_record_step``: equal TFLOP/s, MFU and stall-inclusive
    MFU (against one peak, 67e12), the same counters. A JAX rank is a
    chip, so JAX gets p times the examples; the port's p virtual ranks
    share one card."""
    peak = 67e12
    monkeypatch.setattr(jflops, "device_peak_flops", lambda device: peak)
    monkeypatch.setattr(tflops, "device_peak_flops", lambda name, dtype="float32": peak)
    eng = _linear(telemetry=True, flops_per_sample=16)
    jtel.enable()
    jmpi.start(devices=jax.devices()[:P])
    jeng = JEngine(lambda prm, b: jnp.mean((b[0] @ prm - b[1]) ** 2), jnp.zeros(8),
                   optimizer=optax.sgd(0.1), flops_per_sample=16)
    eng._record_step(64, 1.0, 1.5, 2.0, input_stall_s=0.25)
    jeng._record_step(64 * P, 1.0, 1.5, 2.0, input_stall_s=0.25)
    ours, ref = ttel.metrics.snapshot(), jtel.metrics.snapshot()
    for name in ("tm_engine_tflops_per_chip", "tm_engine_mfu", "tm_engine_mfu_incl_input",
                 "tm_engine_grad_norm", "tm_engine_input_stall_seconds"):
        assert ours[name]["series"] == pytest.approx(ref[name]["series"], rel=1e-12), name
    assert ours["tm_engine_mfu"]["series"][""] == pytest.approx(64 / 0.5 * 16 / peak)
    assert ours["tm_engine_steps_total"]["series"] == ref["tm_engine_steps_total"]["series"]


def test_telemetry_step_records_like_jax():
    """One telemetry-enabled step of the linear model in both packages:
    the same global gradient norm (rtol 1e-4), one step counted, an
    ``engine.step`` span and flight entry, the step's loss run under the
    trace root the JAX engine derives from the step ordinal."""
    batch = _linear_batches(1)[0]
    roots = []
    eng = _linear(telemetry=True, flops_per_sample=16)
    tflight.enable()
    real = eng._step

    def spy(b):
        roots.append(ttrace.current())
        return real(b)

    eng._step = spy
    eng.step(batch)
    jtel.enable()
    jmpi.start(devices=jax.devices()[:P])
    jeng = JEngine(lambda prm, b: jnp.mean((b[0] @ prm - b[1]) ** 2), jnp.zeros(8),
                   optimizer=optax.sgd(0.1), flops_per_sample=16)
    jeng.step((batch[0].numpy().reshape(-1, 8), batch[1].numpy().reshape(-1)))
    ours, ref = ttel.metrics.snapshot(), jtel.metrics.snapshot()
    np.testing.assert_allclose(ours["tm_engine_grad_norm"]["series"][""],
                               ref["tm_engine_grad_norm"]["series"][""], rtol=1e-4)
    assert ours["tm_engine_steps_total"]["series"] == {"mode=sync,sharding=replicated": 1}
    assert ours["tm_engine_tflops_per_chip"]["series"][""] > 0
    assert [s["name"] for s in ttel.trace_events()].count("engine.step") == 1
    assert [e["op"] for e in tflight.recorder.entries()].count("engine.step") == 1
    want = jtrace.new_trace("engine.step", 1)
    assert (roots[0].trace_id, roots[0].span_id) == (want.trace_id, want.span_id)


def test_telemetry_off_records_nothing():
    eng = _linear()
    eng.step(_linear_batches(1)[0])
    assert eng._gnorm is None
    assert "tm_engine_steps_total" not in ttel.metrics.snapshot() or not \
        ttel.metrics.snapshot()["tm_engine_steps_total"]["series"]


def test_train_measures_input_stall():
    """An iterator that waits 20 ms before each batch: ``input_stall``
    holds at least the waits, and telemetry counts them."""
    batches = _linear_batches(3)

    def slow():
        for b in batches:
            time.sleep(0.02)
            yield b

    eng = _linear(telemetry=True)
    state = eng.train(slow, max_epochs=1)
    assert state["input_stall"] >= 0.06
    stall = ttel.metrics.snapshot()["tm_engine_input_stall_seconds"]["series"][""]
    assert stall == pytest.approx(state["input_stall"])
    quick = _linear(start=False).train(lambda: iter(batches), max_epochs=1)
    assert 0 <= quick["input_stall"] < 0.06


def test_train_resident_records_epochs():
    (x, y), _ = synthetic_mnist(num_train=64, num_test=8)
    tmpi.telemetry.enable()
    tmpi.start(ranks=P, device="cpu")
    model = LogisticRegression()
    eng = AllReduceSGDEngine(make_loss_fn(model), init_params(model, seed=0), lr=0.1)
    eng.train_resident(x, y, 4, max_epochs=2, shuffle=False)
    snap = ttel.metrics.snapshot()
    assert snap["tm_engine_epoch_seconds"]["series"][""]["count"] == 2
    assert snap["tm_engine_steps_total"]["series"] == {"mode=sync,sharding=replicated": 8}


# --- the eval cache (tests/test_engine.py:544-597) ---------------------------
def _eval_setup():
    (_, _), (xte, yte) = synthetic_mnist(num_train=8, num_test=64)
    tmpi.start(ranks=P, device="cpu")
    model = LogisticRegression()
    eng = AllReduceSGDEngine(make_loss_fn(model), init_params(model, seed=0), lr=0.1)
    apply_fn = lambda prm, x: torch.func.functional_call(model, prm, (x,))  # noqa: E731
    mean_logit = lambda logits, y: logits.mean()  # noqa: E731
    return eng, apply_fn, mean_logit, xte, yte


def _count_stages(eng, monkeypatch):
    calls = []
    real = eng.stage_dataset
    monkeypatch.setattr(eng, "stage_dataset", lambda x, y, **k: calls.append(1) or real(x, y, **k))
    return calls


def test_evaluate_stages_once_and_restages_on_mutation(monkeypatch):
    """The second call copies nothing; a ONE-element in-place write is
    seen (the full-buffer checksum) and re-staged; the values equal an
    uncached evaluation's."""
    eng, apply_fn, mean_logit, xte, yte = _eval_setup()
    calls = _count_stages(eng, monkeypatch)
    v0 = eng.evaluate(apply_fn, xte, yte, mean_logit)
    assert eng.evaluate(apply_fn, xte, yte, mean_logit) == v0 and len(calls) == 1
    xte[3, 7, 7] += 1000.0
    v1 = eng.evaluate(apply_fn, xte, yte, mean_logit)
    assert v1 != v0 and len(calls) == 2, "mutated eval array served from a stale cache"
    assert v1 == eng.evaluate(apply_fn, xte.copy(), yte.copy(), mean_logit)
    # a CPU tensor is a host set too
    xt = torch.from_numpy(xte.copy())
    assert eng.evaluate(apply_fn, xt, yte, mean_logit) == v1
    xt[0, 0, 0] = 5.0
    assert eng.evaluate(apply_fn, xt, yte, mean_logit) != v1


def test_invalidate_eval_cache_forms(monkeypatch):
    eng, apply_fn, mean_logit, xte, yte = _eval_setup()
    y2 = yte.copy()
    v = eng.evaluate(apply_fn, xte, yte, mean_logit)
    eng.evaluate(apply_fn, xte, y2, mean_logit)
    eng.invalidate_eval_cache(xte, yte)  # exactly one slot
    assert (id(xte), id(yte)) not in eng._eval_data and (id(xte), id(y2)) in eng._eval_data
    assert eng.evaluate(apply_fn, xte, yte, mean_logit) == v
    eng.invalidate_eval_cache(xte)  # every slot of x
    assert all(k[0] != id(xte) for k in eng._eval_data)
    assert eng.evaluate(apply_fn, xte, yte, mean_logit) == v
    eng.invalidate_eval_cache()  # every slot
    assert not eng._eval_data


def test_eval_cache_holds_four_sets_with_recency(monkeypatch):
    """Five sets through a 4-slot cache: the least recently used is
    dropped, and a set used again moves to the back."""
    eng, apply_fn, mean_logit, xte, yte = _eval_setup()
    sets = [(xte + np.float32(i), yte) for i in range(5)]
    for x, y in sets[:4]:
        eng.evaluate(apply_fn, x, y, mean_logit)
    eng.evaluate(apply_fn, *sets[0], mean_logit)  # refresh the oldest
    eng.evaluate(apply_fn, *sets[4], mean_logit)  # evicts sets[1]
    keys = list(eng._eval_data)
    assert len(keys) == 4
    assert (id(sets[1][0]), id(yte)) not in eng._eval_data
    assert keys[-2:] == [(id(sets[0][0]), id(yte)), (id(sets[4][0]), id(yte))]
