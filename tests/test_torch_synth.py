"""The port's algebra-synthesized lowerings against the JAX package's, on
the CPU at p = 8.

- **Each family pinned** (``halve~synth`` on the flat communicator,
  ``torus~synth`` and ``stripe~synth`` on a cartesian 2x4 one) through
  ``compile_collective`` on the ``ring`` backend, for each wire, on
  seeded random f32 payloads at a width that is a multiple of
  ``p * wire_quant_block_size`` and at one that is not: the port's result
  equals the JAX lowering's bit for bit. The int8 cases follow C4's
  contract (one rounding of each decode-and-add) and need no tolerance.
  Integer payloads are exact; the pipeline twins of torus and stripe at
  depth 2 equal their JAX twins and depth 1; a request on the ``kernel``
  backend runs the same plain rings (label ``ring``).
- **Selection parity**: under ``use_plan_synthesis`` the port's
  ``candidate_plans`` gives the same candidates, feasibility, reasons,
  costs and choice as the JAX package's, on a flat 8-rank, a cartesian
  2x4 and a ragged topology, for the ring and kernel backends, at config
  5's bucket widths and at 4 MiB.
- **The integration cases of ``tests/test_algebra.py``**, each run on both
  packages: the knob gate, the pipeline twins, the fused-flush override,
  a pinned family on an infeasible topology, the selection counters,
  ``explain``'s derivation panel and ``families=``, and overrides that
  name a synthesized generator.

The JAX lowerings' executable cache keys leave ``wire_quant_min_elements``
out, so each test starts both runtimes afresh (ROADMAP, "Facts about the
reference").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu import constants as jconstants
from torchmpi_tpu import telemetry as jtelemetry
from torchmpi_tpu.collectives import eager as jeager
from torchmpi_tpu.collectives import get_fusion_buffer as jget_fusion_buffer
from torchmpi_tpu.schedule import compiler as jsched
from torchmpi_tpu.schedule import generators as jgen
from torchmpi_tpu.schedule import topology as jtopology
from torchmpi_tpu_torch import constants, ops, schedule, telemetry
from torchmpi_tpu_torch.collectives import CollectiveArgumentError, eager, get_fusion_buffer
from torchmpi_tpu_torch.schedule import compiler as sched
from torchmpi_tpu_torch.schedule import cost, generators, topology
from torchmpi_tpu_torch.telemetry import flightrecorder as flight

P = 8
BLOCK = 128  # wire_quant_block_size's default
WIDTHS = (4 * P * BLOCK, 5001)  # a multiple of p*block, and one that is not
WIRES = ("full", "bf16", "int8")
FAMILIES = ("halve~synth", "torus~synth", "stripe~synth")
JAX_BACKEND = {"ring": "ring", "kernel": "pallas"}
TWO_LEVEL = lambda r: str(r % 2)  # noqa: E731 - two groups of four
CONFIG5_BUCKETS = (67210, 100480, 128)  # config 5's gradient buckets a rank
TOPOLOGIES = {
    "flat8": dict(group_sizes=(8,)),
    "cartesian2x4": dict(group_sizes=(4, 4), cartesian=True, nodes=2),
    "ragged": dict(group_sizes=(1, 3, 4)),
}


@pytest.fixture(autouse=True)
def _fresh_port():
    yield
    tmpi.runtime_state._reset_for_tests()
    constants._reset_for_tests()
    sched.clear_plan_overrides()
    cost.clear_calibration()
    ops.reset_launch_counts()
    telemetry.disable()
    telemetry.reset()


def _both(name, value):
    constants.set(name, value)
    jconstants.set(name, value)


def _start_both(family: str = "halve~synth"):
    """Both runtimes at p = 8 with synthesis on; a cartesian 2x4
    communicator for the torus and the stripe. Returns (port comm, JAX
    comm)."""
    tmpi.start(ranks=P, device="cpu")
    jmpi.start(devices=jax.devices()[:P])
    _both("use_plan_synthesis", True)
    if family != "halve~synth":
        tmpi.push_communicator(TWO_LEVEL, name="alg-2l")
        jmpi.push_communicator(TWO_LEVEL, name="alg-2l")
    return tmpi.current_communicator(), jmpi.current_communicator()


def _steps(plan):
    return tuple((s.kind, s.level, s.bytes, s.count, s.note) for s in plan.steps)


def _decision(plan, port: bool) -> tuple:
    backend = {"kernel": "pallas"}.get(plan.backend, plan.backend) if port else plan.backend
    return (plan.op, plan.generator, backend, plan.wire, plan.pipeline, _steps(plan),
            plan.meta, plan.topology_fp)


def _pinned(family, tcomm, jcomm, x, wire=None, backend="ring"):
    """``x`` through ``family`` pinned on both packages: (port result,
    JAX result, port plan, JAX plan)."""
    shape = tuple(x.shape)
    tdtype = torch.from_numpy(x[:1]).dtype
    ep = sched.compile_collective("allreduce", shape, tdtype, tcomm, backend=backend,
                                  generator=family, wire_override=wire)
    jep = jsched.compile_collective("allreduce", shape, jnp.dtype(x.dtype), jcomm,
                                    backend=JAX_BACKEND[backend], generator=family,
                                    wire_override=wire)
    got = ep.execute(torch.from_numpy(x)).numpy()
    want = np.asarray(jep.execute(jnp.asarray(x)))
    return got, want, ep, jep


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(f"i{a.dtype.itemsize}"), b.view(f"i{b.dtype.itemsize}"))


def _payload(n: int, seed: int) -> np.ndarray:
    """Seeded f32 rows that differ per rank and per position, over six
    decades (so the int8 blocks' scales and the adds' roundings vary)."""
    rs = np.random.RandomState(seed)
    scale = 10.0 ** rs.randint(-3, 4, size=(P, 1))
    return (rs.randn(P, n) * scale).astype(np.float32)


# --- each family pinned, on both packages ------------------------------------
@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("family", FAMILIES)
def test_family_equals_jax_bit_for_bit(family, wire, n):
    tcomm, jcomm = _start_both(family)
    _both("wire_quant_min_elements", 1)  # the wire engages on every hop
    x = _payload(n, seed=n + len(wire))
    got, want, ep, jep = _pinned(family, tcomm, jcomm, x, wire)
    assert _decision(ep.plan, True) == _decision(jep.plan, False)
    assert (ep.op_label, ep.backend_label, ep.routing) == (
        jep.op_label, jep.backend_label, jep.routing)
    assert _same_bits(got, want), (family, wire, n, float(np.abs(got - want).max()))
    if wire == "full" and family == "halve~synth":
        # the halving exchange leaves every rank the same total
        assert (got == got[:1]).all()


@pytest.mark.parametrize("family", FAMILIES)
def test_family_under_the_default_wire_cutoff_equals_jax(family):
    """The default ``wire_quant_min_elements``: the rings of the torus and
    the stripe ship their small messages verbatim, the halving exchange
    encodes every hop, in both packages."""
    tcomm, jcomm = _start_both(family)
    x = _payload(5001, seed=3)
    got, want, _, _ = _pinned(family, tcomm, jcomm, x, "int8")
    assert _same_bits(got, want)


@pytest.mark.parametrize("family", FAMILIES)
def test_integer_payload_is_exact(family):
    tcomm, jcomm = _start_both(family)
    x = np.random.RandomState(5).randint(-1000, 1000, (P, 5001)).astype(np.int32)
    got, want, ep, _ = _pinned(family, tcomm, jcomm, x)
    assert ep.wire == "full"
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.broadcast_to(x.sum(0), x.shape))


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("family", ["torus~synth", "stripe~synth"])
def test_pipeline_twins_at_depth_2(family, wire):
    """A pinned depth of 2 gives the torus and the stripe their pipeline
    twins (the ring phases' interleaved segments): equal to the JAX twin
    and to depth 1, bit for bit."""
    tcomm, jcomm = _start_both(family)
    _both("wire_quant_min_elements", 1)
    x = _payload(4 * P * BLOCK, seed=7)
    once, _, _, _ = _pinned(family, tcomm, jcomm, x, wire)
    _both("plan_pipeline_depth", 2)
    _both("plan_pipeline_min_chunk_bytes", 64)
    got, want, ep, jep = _pinned(family, tcomm, jcomm, x, wire)
    assert ep.plan.pipeline == jep.plan.pipeline == 2
    assert _same_bits(got, want) and _same_bits(got, once)


@pytest.mark.parametrize("family", FAMILIES)
def test_kernel_backend_request_runs_the_plain_rings(family):
    """On the ``kernel`` backend a synthesized plan runs the ``ring``
    backend's exchanges (label ``ring``, as JAX under ``pallas``) and
    launches no kernel wrapper."""
    tcomm, jcomm = _start_both(family)
    x = _payload(5001, seed=11)
    ops.reset_launch_counts()
    got, want, ep, jep = _pinned(family, tcomm, jcomm, x, "full", backend="kernel")
    assert ep.backend_label == jep.backend_label == "ring"
    assert not any(ops.launch_counts().values())
    assert _same_bits(got, want)


def _exact_payload(n: int, blk: int = 256) -> np.ndarray:
    """``test_algebra.py``'s exact payload: rank r is nonzero only on the
    blocks ``block_idx % p == r``, +-1 a block."""
    idx = np.arange(n)
    signs = np.where((idx // blk) % 2 == 0, 1.0, -1.0)
    return np.stack([np.where((idx // blk) % P == r, signs, 0.0)
                     for r in range(P)]).astype(np.float32)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("family", FAMILIES)
def test_exact_payload_equals_flat_and_the_sum(family, wire):
    """``test_algebra.py:test_synth_bitwise_vs_flat`` on the port: the
    pinned family equals the flat ring and the exact sum, and JAX's."""
    tcomm, jcomm = _start_both(family)
    _both("wire_quant_min_elements", 1)
    x = _exact_payload(1 << 12)
    got, want, _, _ = _pinned(family, tcomm, jcomm, x, wire)
    flat = sched.compile_collective("allreduce", x.shape, torch.float32, tcomm,
                                    backend="ring", generator="flat", impl="ring",
                                    wire_override=wire).execute(torch.from_numpy(x)).numpy()
    assert _same_bits(got, want) and _same_bits(got, flat)
    assert np.array_equal(got, np.tile(x.sum(0), (P, 1)))


# --- selection parity ---------------------------------------------------------
def _candidate_rows(cands, port: bool):
    return [(_decision(c.plan, port), c.feasible, c.reason, c.cost_us) for c in cands]


@pytest.mark.parametrize("nelem", CONFIG5_BUCKETS + (1 << 20,))
@pytest.mark.parametrize("backend", ["ring", "kernel"])
@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_selection_parity_under_synthesis(topo, backend, nelem):
    _both("use_plan_synthesis", True)
    kw = dict(platform="cpu", **TOPOLOGIES[topo])
    t, j = topology.Topology(**kw), jtopology.Topology(**kw)
    for wire in ("full", "int8"):
        cands = generators.candidate_plans("allreduce", nelem, 4, t, backend, wire=wire)
        jcands = jgen.candidate_plans("allreduce", nelem, 4, j, JAX_BACKEND[backend],
                                      wire=wire)
        assert _candidate_rows(cands, True) == _candidate_rows(jcands, False)
        plan, _ = sched.select_plan("allreduce", nelem, 4, t, backend, wire, True)
        jplan, _ = jsched.select_plan("allreduce", nelem, 4, j, JAX_BACKEND[backend], wire, True)
        assert _decision(plan, True) == _decision(jplan, False)


def test_eager_run_under_synthesis_equals_jax():
    """The policy route: ``eager.run`` with synthesis on chooses the JAX
    plan on the 2x4 communicator and returns the JAX result bit for
    bit."""
    tcomm, jcomm = _start_both("torus~synth")
    _both("small_allreduce_size_cpu", 0)
    x = _payload(1 << 14, seed=13)
    got = eager.run("allreduce", torch.from_numpy(x), tcomm, backend="ring").numpy()
    want = np.asarray(jeager.run("allreduce", jnp.asarray(x), jcomm, backend="ring"))
    ep = sched.compile_collective("allreduce", x.shape, torch.float32, tcomm, backend="ring")
    jep = jsched.compile_collective("allreduce", x.shape, jnp.float32, jcomm, backend="ring")
    assert _decision(ep.plan, True) == _decision(jep.plan, False)
    assert _same_bits(got, want)


# --- test_algebra.py's integration cases, on both packages ------------------
def _fleet(world: int, g: int = 8):
    kw = dict(platform="cpu", group_sizes=tuple([g] * (world // g)), cartesian=True,
              nodes=world // g, name="sim")
    return topology.Topology(**kw), jtopology.Topology(**kw)


def test_candidates_gated_by_the_knob():
    """``test_algebra.py:215``: off, no synthesized candidate; on, each is
    priced and feasible on the ring backend and rejected on ``xla``; in
    both packages alike."""
    t, j = _fleet(256)
    for on in (False, True):
        _both("use_plan_synthesis", on)
        for backend in ("ring", "xla"):
            cands = generators.candidate_plans("allreduce", 1 << 20, 4, t, backend,
                                               wire="int8", route_small=False)
            jcands = jgen.candidate_plans("allreduce", 1 << 20, 4, j, backend,
                                          wire="int8", route_small=False)
            assert _candidate_rows(cands, True) == _candidate_rows(jcands, False)
            synth = [c for c in cands if schedule.is_synthesized(c.plan.generator)]
            assert bool(synth) == on
            assert all(c.feasible == (backend == "ring") for c in synth)


def test_synthesized_ring_phases_earn_pipeline_twins():
    """``test_algebra.py:237``: the stripe and the torus get depth twins,
    the halving exchange none, in both packages."""
    _both("use_plan_synthesis", True)
    kw = dict(platform="cpu", group_sizes=(8,) * 4, cartesian=True, nodes=4)
    depths = []
    for gen_mod, topo, backend in ((generators, topology.Topology(**kw), "ring"),
                                   (jgen, jtopology.Topology(**kw), "ring")):
        d = {}
        for c in gen_mod.candidate_plans("allreduce", 1 << 20, 4, topo, backend,
                                         wire="int8", route_small=False):
            if c.feasible and c.plan.generator.endswith("~synth"):
                d.setdefault(c.plan.generator, set()).add(c.plan.pipeline)
        depths.append(d)
    assert depths[0] == depths[1]
    assert max(depths[0]["stripe~synth"]) > 1 and max(depths[0]["torus~synth"]) > 1
    assert depths[0]["halve~synth"] == {1}


def test_fused_flush_under_a_halve_override_is_bitwise():
    """``test_algebra.py:320``: a plan override naming ``halve~synth``
    steers the fused int8 flush; the flushed results equal the flat
    plan's flush and the JAX package's, bit for bit. The tensors are
    submitted on the ``ring`` backend: on the CPU the port's selector
    sends an allreduce to the vendor path, whose full wire no int8
    override key names."""
    tcomm, jcomm = _start_both()
    for name, value in (("wire_quant_min_elements", 1), ("wire_dtype", "int8"),
                        ("small_allreduce_size_cpu", 1)):
        _both(name, value)
    n = 1 << 10
    xs = [_exact_payload(n, blk=64) for _ in range(3)]

    def flush(fb, wrap):
        hs = [fb.submit("allreduce", wrap(x), backend="ring") for x in xs]
        fb.flush_all(reason="test")
        return [np.asarray(h.wait()) for h in hs]

    base = flush(get_fusion_buffer(tcomm), torch.from_numpy)
    bucket = sched.payload_bucket(3 * n * 4)
    for mod, comm, fp in ((sched, tcomm, topology.Topology.from_communicator(tcomm)),
                          (jsched, jcomm, jtopology.Topology.from_communicator(jcomm))):
        mod.set_plan_override(mod.override_key("allreduce", fp.fingerprint(), bucket, "int8"),
                              "halve~synth")
    eager.free_collective_resources(tcomm)
    jeager.free_collective_resources(jcomm)
    flight.enable()
    try:
        flight.recorder.reset()
        pinned = flush(get_fusion_buffer(tcomm), torch.from_numpy)
        ran = {(e["op"], e["plan"].split(":")[0]) for e in flight.recorder.entries()}
    finally:
        flight.disable()
    jpinned = flush(jget_fusion_buffer(jcomm), jnp.asarray)
    assert ("halve_allreduce", "halve~synth-ring-int8") in ran
    for a, b, c in zip(base, pinned, jpinned):
        assert _same_bits(a, b) and _same_bits(b, c)


def test_pinned_family_on_an_infeasible_topology_raises():
    """``test_algebra.py:357``: the torus on the flat communicator is an
    argument error in both packages."""
    tcomm, jcomm = _start_both()
    with pytest.raises(CollectiveArgumentError):
        sched.compile_collective("allreduce", (P, 1 << 10), torch.float32, tcomm,
                                 backend="ring", generator="torus~synth")
    with pytest.raises(jeager.CollectiveArgumentError):
        jsched.compile_collective("allreduce", (P, 1 << 10), jnp.float32, jcomm,
                                  backend="ring", generator="torus~synth")


def test_selection_counters_tick_as_in_jax():
    """``test_algebra.py:374``: at fleet scale the halving plan wins; the
    candidates and selected counters carry the same series in both
    packages."""
    _both("use_plan_synthesis", True)
    t, j = _fleet(1024)
    telemetry.enable()
    jtelemetry.enable()
    try:
        plan, _ = sched.select_plan("allreduce", 1 << 20, 4, t, "ring", "int8",
                                    route_small=False)
        jplan, _ = jsched.select_plan("allreduce", 1 << 20, 4, j, "ring", "int8",
                                      route_small=False)
        assert plan.generator == jplan.generator and schedule.is_synthesized(plan.generator)
        mets = telemetry.snapshot()["metrics"]
        jmets = jtelemetry.snapshot()["metrics"]
        for name in ("tm_plan_synth_candidates_total", "tm_plan_synth_selected_total"):
            series = mets.get(name, {}).get("series", {})
            assert series and series == jmets.get(name, {}).get("series", {})
        assert any("halve" in k for k in mets["tm_plan_synth_candidates_total"]["series"])
    finally:
        jtelemetry.disable()
        jtelemetry.reset()


@pytest.mark.parametrize("families", ["all", "synth", "legacy"])
def test_explain_derivation_panel_and_families(families):
    """``test_algebra.py:399``: ``explain`` prints the derivation panel for
    the synthesized candidates, ``families`` filters the rendering and
    never the decision; the port's text equals JAX's but for the plan
    cache key's constants counter."""
    _both("use_plan_synthesis", True)
    t, j = _fleet(128)
    kw = dict(op="allreduce", nbytes=64 << 20, wire="int8", backend="ring",
              route_small=False, families=families)
    text = schedule.explain(topo=t, **kw)
    jtext = jsched.explain(topo=j, **kw)
    panel = "derivations (composition algebra -> plan IR):"
    assert (panel in text) == (families != "legacy") == (panel in jtext)
    # the cache-key line names each package's constants counter
    assert [ln for ln in text.splitlines() if not ln.startswith("plan cache key")] == \
        [ln for ln in jtext.splitlines() if not ln.startswith("plan cache key")]
    chosen = [ln for ln in text.splitlines() if "CHOSEN" in ln][0]
    assert chosen == [ln for ln in schedule.explain(topo=t, **{**kw, "families": "all"})
                      .splitlines() if "CHOSEN" in ln][0]


def test_overrides_accept_a_synthesized_generator():
    """``test_algebra.py:423``: ``set_plan_override`` takes a synthesized
    generator, rejects an unknown one, and ``select_plan`` honours it, as
    in JAX."""
    with pytest.raises(ValueError):
        sched.set_plan_override("k", "nonsense~synth")
    _both("use_plan_synthesis", True)
    nelem = 1 << 20
    kw = dict(platform="cpu", group_sizes=(8,), nodes=1)
    for mod, topo in ((sched, topology.Topology(**kw)), (jsched, jtopology.Topology(**kw))):
        key = mod.override_key("allreduce", topo.fingerprint(), mod.payload_bucket(nelem * 4),
                               "int8")
        mod.set_plan_override(key, "halve~synth")
        try:
            plan, _ = mod.select_plan("allreduce", nelem, 4, topo, "ring", "int8",
                                      route_small=False)
            assert plan.generator == "halve~synth"
            assert mod.apply_plan_overrides({key: "halve~synth"}) == {key: "halve~synth"}
        finally:
            mod.clear_plan_overrides()


def test_the_cli_prints_the_derivations(capsys):
    """``python -m torchmpi_tpu_torch.schedule --explain --families synth``
    prints the synthesized plan ids and the derivation panel."""
    from torchmpi_tpu_torch.schedule.__main__ import main

    assert main(["--explain", "--families", "synth", "op=allreduce", "bytes=64M",
                 "groups=8x16", "wire=int8"]) == 0
    out = capsys.readouterr().out
    assert "~synth" in out and "derivations (composition algebra -> plan IR):" in out
    assert not constants.get("use_plan_synthesis")
