"""The port's telemetry core against the JAX package's, on the CPU, and the
MNIST paths as a whole through the schedule compiler with telemetry on.

- ``analysis/lockmon.py``, ``telemetry/{tracecontext, registry,
  flightrecorder}.py`` and ``schedule/{algebra, pipeline}.py`` are plain
  copies: their code must equal the originals' (docstrings and comments
  aside), and the same call sequences (with the clocks patched) must give
  equal snapshots, Prometheus text, trace events and flight entries.
- ``telemetry/spans.py`` enters ``torch.profiler.record_function`` where
  the JAX package enters ``jax.profiler.TraceAnnotation``: a span's name
  shows in a ``torch.profiler`` trace.
- An eager collective with telemetry on records the same metric series
  (backend names mapped, ``kernel`` <-> ``pallas``) as the JAX
  ``eager.run``, and a span and a flight entry stamped with its plan_id.
- The MNIST paths: 3 LeNet sync steps and 3 async int8 steps at p=4,
  telemetry on. Losses as ``tests/test_torch_engine.py`` holds them
  against the JAX engine (sync rtol 1e-4; async int8 the first step's
  rtol 1e-4). The JAX engine syncs in its jitted step, so the flight
  sequence is held against the JAX package's eager gradient sync of the
  same gradients (``nn.synchronize_gradients`` through its
  ``FusionBuffer``; ``GradientBuckets.allreduce_async``): the sequences
  of (op, generator, wire, pipeline depth) must be equal. The handles'
  own ``wait.*`` entries (``runtime/handles.py``, the rank-local
  ``handles`` stream) are held apart: the same kinds and counts in both.
"""

import ast
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu import constants as jconstants
from torchmpi_tpu import nn as jnn
from torchmpi_tpu import telemetry as jtelemetry
from torchmpi_tpu.collectives import eager as jeager
from torchmpi_tpu.engine import AllReduceSGDEngine as JEngine
from torchmpi_tpu.models import LeNet as JLeNet
from torchmpi_tpu.models import init_params as jinit
from torchmpi_tpu.models import make_loss_fn as jloss
from torchmpi_tpu.ops import ring_kernels as jring
from torchmpi_tpu.telemetry import flightrecorder as jflight
from torchmpi_tpu.telemetry import registry as jregistry
from torchmpi_tpu.telemetry import tracecontext as jtracecontext
from torchmpi_tpu.utils import DistributedIterator as JIterator
from torchmpi_tpu.utils import synthetic_mnist as jsynthetic
from torchmpi_tpu_torch import constants, nn as tnn, ops, telemetry
from torchmpi_tpu_torch.collectives import eager
from torchmpi_tpu_torch.engine import AllReduceSGDEngine
from torchmpi_tpu_torch.models import LeNet, from_jax_params, make_loss_fn
from torchmpi_tpu_torch.telemetry import flightrecorder as flight
from torchmpi_tpu_torch.telemetry import registry, tracecontext

# the modules (each package's ``telemetry.spans`` is its span recorder)
spans = importlib.import_module("torchmpi_tpu_torch.telemetry.spans")
jspans = importlib.import_module("torchmpi_tpu.telemetry.spans")

REPO = Path(__file__).resolve().parent.parent
PLAIN_COPIES = ("analysis/lockmon.py", "telemetry/tracecontext.py", "telemetry/registry.py",
                "telemetry/flightrecorder.py", "schedule/algebra.py", "schedule/pipeline.py")


@pytest.fixture(autouse=True)
def _fresh_port():
    yield
    tmpi.runtime_state._reset_for_tests()
    constants._reset_for_tests()
    ops.reset_launch_counts()
    for pkg in (telemetry, jtelemetry):
        pkg.disable()
        pkg.reset()


def _code(path: Path) -> str:
    """The module's syntax tree without its docstrings (and so without
    its comments)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("path", PLAIN_COPIES)
def test_plain_copies_equal_their_originals(path):
    assert _code(REPO / "torchmpi_tpu_torch" / path) == _code(REPO / "torchmpi_tpu" / path)


def _drive_registry(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("tm_calls_total", "calls")
    g = reg.gauge("tm_depth", "depth")
    h = reg.histogram("tm_seconds", "seconds")
    for i in range(40):
        c.inc(op="allreduce", backend="ring")
        c.inc(2, op="broadcast", backend="xla")
        g.set(i * 0.5, comm="global[8]")
        h.observe(1e-5 * (i + 1) ** 2, op="allreduce")
    reg.register_collector("extra", lambda: {"k": 1})
    snap = reg.snapshot()
    text = reg.prometheus()
    quantiles = h.quantiles(op="allreduce")
    reg.reset()
    return snap, text, quantiles, reg.snapshot(), c.total(), h.total_count()


def test_registry_matches_jax():
    assert _drive_registry(registry) == _drive_registry(jregistry)


def _drive_spans(mod, monkeypatch):
    clock = iter(np.arange(0.0, 1.0, 0.001))
    monkeypatch.setattr(mod.time, "perf_counter", lambda: float(next(clock)))
    monkeypatch.setattr(mod, "_TRACE_ANNOTATION_RESOLVED", True)
    monkeypatch.setattr(mod, "_TRACE_ANNOTATION", None)
    rec = mod.SpanRecorder(capacity=4)
    for i in range(6):
        with mod.Span(rec, f"collective.op{i}", {"plan": f"flat-ring-full:{i}", "n": i}):
            pass
    return rec.trace_events(), rec.dropped, rec.total_recorded, len(rec)


def test_spans_match_jax(monkeypatch):
    assert _drive_spans(spans, monkeypatch) == _drive_spans(jspans, monkeypatch)


def _drive_flight(mod, tc, monkeypatch):
    clock = iter(range(1000, 2000))
    monkeypatch.setattr(mod.time, "time", lambda: float(next(clock)))
    rec = mod.FlightRecorder(capacity=5)
    entries = []
    with tc.use(tc.new_trace("run", 3)):
        for i in range(4):
            e = rec.record("global[8]", "allreduce", payload=((8, 256), "float32"),
                           wire="full", backend="ring", routing="flat",
                           plan=f"flat-ring-full:{i}")
            (mod.FlightRecorder.complete if i % 2 else mod.FlightRecorder.fail)(e)
            entries.append(e)
    rec.record("chunks", "fusion.allreduce", payload="(3, 4)", routing="bytes")
    rec.record_complete("global[8]", "engine.step", 5.0, 6.0, payload="steps=1")
    return rec.snapshot(), rec.in_flight(), rec.seq_high_water(), rec.tail(2)


def test_flight_recorder_matches_jax(monkeypatch):
    assert _drive_flight(flight, tracecontext, monkeypatch) == _drive_flight(
        jflight, jtracecontext, monkeypatch)


def test_span_shows_in_a_torch_profiler_trace():
    telemetry.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with telemetry.span("collective.allreduce", plan="flat-xla-full:0"):
            torch.ones(4).sum()
    assert "collective.allreduce" in {e.key for e in prof.key_averages()}
    assert telemetry.trace_events()[-1]["args"]["plan"] == "flat-xla-full:0"


def test_disabled_telemetry_records_nothing(tmp_path):
    assert not telemetry.enabled()
    assert telemetry.span("x") is telemetry.NOOP_SPAN
    tmpi.start(ranks=4, device="cpu")
    eager.run("allreduce", torch.ones(4, 8), tmpi.current_communicator())
    snap = telemetry.snapshot()
    # metric objects other tests made stay registered, with no series
    assert all(not m.get("series") for m in snap["metrics"].values())
    assert snap["flight_recorder"]["entries"] == []
    assert snap.keys() == jtelemetry.snapshot().keys()
    path = telemetry.export_trace(tmp_path / "trace.json")
    assert path.exists()
    assert telemetry.dump(tmp_path / "snap.json")[1] == tmp_path / "snap.trace.json"


def _series(snapshot, name):
    return snapshot["metrics"].get(name, {}).get("series", {})


@pytest.mark.parametrize("backend", ["xla", "ring", "kernel"])
def test_dispatch_records_as_jax(backend, monkeypatch):
    """One eager allreduce and broadcast with telemetry on, in both
    packages (the JAX kernels in Pallas interpret mode): the same metric
    series, labels mapped; a span and a flight entry carrying the plan_id
    in the port."""
    jbackend = {"kernel": "pallas"}.get(backend, backend)
    monkeypatch.setattr(jring, "_FORCE_INTERPRET", True)
    jmpi.start(devices=jax.devices()[:4])
    tmpi.start(ranks=4, device="cpu")
    for pkg in (constants, jconstants):
        pkg.set("small_allreduce_size_cpu", 0)
        pkg.set("small_broadcast_size_cpu", 0)
    x = np.arange(4 * 96, dtype=np.int32).reshape(4, 96)
    telemetry.enable()
    jtelemetry.enable()
    out = eager.run("allreduce", torch.from_numpy(x), tmpi.current_communicator(),
                    backend=backend)
    eager.run("broadcast", torch.from_numpy(x), tmpi.current_communicator(), backend=backend,
              root=1)
    jout = jeager.run("allreduce", jnp.asarray(x), jmpi.current_communicator(), backend=jbackend)
    jeager.run("broadcast", jnp.asarray(x), jmpi.current_communicator(), backend=jbackend,
               root=1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    snap, jsnap = telemetry.snapshot(), jtelemetry.snapshot()
    for name in ("tm_collective_calls_total", "tm_plan_compiles_total"):
        assert {k.replace("kernel", "pallas"): v for k, v in _series(snap, name).items()} == \
            _series(jsnap, name)
    entries = snap["flight_recorder"]["entries"]
    assert [e["op"] for e in entries] == ["allreduce", "broadcast"]
    assert all(e["plan"].startswith(f"flat-{backend}-full:") for e in entries)
    span = [e for e in telemetry.trace_events() if e["name"] == "collective.allreduce"][-1]
    assert span["args"]["plan"] == entries[0]["plan"]


# --- the MNIST paths as a whole ---------------------------------------------
def _lenet_batches(p, batch=32, steps=3):
    (x, y), _ = jsynthetic(num_train=512, num_test=8)
    order = JIterator(x, y, batch, p, seed=0)._epoch_order()
    per = batch // p
    return [(x[order[:, b * per:(b + 1) * per]], y[order[:, b * per:(b + 1) * per]])
            for b in range(steps)]


def _sequence(entries, port: bool):
    """(op, generator, wire, depth) of each flight entry, backends in the
    JAX package's names."""
    out = []
    for e in entries:
        plan = e["plan"]
        if not plan:
            out.append((e["op"], "", e["wire"], 0))
            continue
        head = plan.split(":")[0]
        generator, backend, wire = head.split("@")[0].split("-")
        depth = int(head.split("@p")[1]) if "@p" in head else 1
        if port:
            backend = {"kernel": "pallas"}.get(backend, backend)
        out.append((e["op"], f"{generator}-{backend}", wire, depth))
    return out


@pytest.mark.parametrize("mode,wire", [("sync", "full"), ("async", "int8")])
def test_mnist_paths_with_telemetry_match_jax(mode, wire, monkeypatch):
    p = 4
    batches = _lenet_batches(p)
    jp = jinit(JLeNet(), (1, 28, 28), seed=0)
    for pkg in (constants, jconstants):
        pkg.set("wire_quant_min_elements", 1)
        pkg.set("small_allreduce_size_cpu", 0)
    jmpi.start(devices=jax.devices()[:p])
    jengine = JEngine(jloss(JLeNet()), jp, optimizer=optax.sgd(0.2), mode=mode, wire_dtype=wire)
    jlosses = [float(jengine.step(b)) for b in batches]

    tmpi.start(ranks=p, device="cpu")
    monkeypatch.setattr(tmpi.collectives.selector, "select", lambda *a, **k: "kernel")
    engine = AllReduceSGDEngine(make_loss_fn(LeNet()), from_jax_params(jax.device_get(jp)),
                                lr=0.2, mode=mode, wire_dtype=wire)
    # the gradients each step syncs, to replay through the JAX eager sync
    grads_seen = []
    if mode == "sync":
        real = tnn.synchronize_gradients
        monkeypatch.setattr(tnn, "synchronize_gradients",
                            lambda g, *a, **k: (grads_seen.append(g), real(g, *a, **k))[1])
    else:
        real = engine.buckets.allreduce_async
        monkeypatch.setattr(engine.buckets, "allreduce_async",
                            lambda g, *a, **k: (grads_seen.append(g), real(g, *a, **k))[1])
    telemetry.enable()
    losses = [float(engine.step((torch.from_numpy(bx), torch.from_numpy(by).long())))
              for bx, by in batches]
    all_entries = telemetry.snapshot()["flight_recorder"]["entries"]
    entries = [e for e in all_entries if e["comm"] != "handles"]
    if mode == "sync":
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    else:
        np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-4)
    assert all(e["status"] == flight.STATUS_COMPLETED for e in all_entries)
    assert all(e["plan"] for e in entries if not e["op"].startswith("fusion."))

    # the JAX package's eager gradient sync of the same gradients, on its
    # kernel backend (Pallas in interpret mode)
    monkeypatch.setattr(jmpi.collectives.selector, "select", lambda *a, **k: "pallas")
    monkeypatch.setattr(jring, "_FORCE_INTERPRET", True)
    jconstants.set("ring_implementation", "pallas")
    jtelemetry.enable()
    jflight.recorder.reset()
    buckets = jnn.GradientBuckets(jp, 2) if mode == "async" else None
    for g in grads_seen:
        jg = {k: jnp.asarray(v.numpy()) for k, v in g.items()}
        if mode == "sync":
            jnn.synchronize_gradients(jg)
        else:
            jtree = jax.tree_util.tree_map(
                lambda leaf: jnp.zeros((p,) + leaf.shape, leaf.dtype), jp)
            leaves = jax.tree_util.tree_leaves(jtree)
            # the port's buckets in the JAX tree's leaf order: equal sizes
            assert sorted(v[0].numel() for v in g.values()) == sorted(
                int(np.prod(leaf.shape[1:])) for leaf in leaves)
            hs = buckets.allreduce_async(jtree, wire_dtype=wire)
            for h in reversed(hs):
                h.wait()
    # the handles' "wait.*" entries on their rank-local "handles" stream
    # (runtime/handles.py): the same kinds, as many in both
    jall = jtelemetry.snapshot()["flight_recorder"]["entries"]
    jentries = [e for e in jall if e["comm"] != "handles"]
    waits = sorted(e["op"] for e in all_entries if e["comm"] == "handles")
    assert waits == sorted(e["op"] for e in jall if e["comm"] == "handles")
    seq = _sequence(entries, True)
    assert len(seq) == 6  # a fusion flush and its allreduce, or two buckets, a step
    assert seq == _sequence(jentries, False)
    if mode == "async":
        assert seq[0] == ("allreduce", "flat-pallas", "int8", 1)
