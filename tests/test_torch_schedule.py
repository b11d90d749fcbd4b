"""The port's schedule compiler against the JAX package's, on the CPU.

The planning modules (``ir``, ``topology``, ``cost``, ``algebra``,
``pipeline``, ``generators``) are copies: on the same request they must
make the same decision. The port names the kernel backend ``kernel``
where the JAX package says ``pallas``; ``Plan.plan_id`` hashes the
backend, so a plan id is compared exactly where the backend is ``xla``
or ``ring``, and elsewhere the decision is compared field by field (op,
generator, backend with ``kernel``<->``pallas`` mapped, wire, pipeline
depth, steps, topology fingerprint). Costs are compared exactly: the same
arithmetic on the same constants.

On a two-level communicator both compilers choose the hierarchical,
staged or tree families where the JAX gates send a request there
(``TWO_LEVEL_DIFFERENCES`` lists the cases, which once chose apart), and
the port's result equals JAX's. A pinned algebra-synthesized family runs
and equals JAX's lowering (``tests/test_torch_synth.py`` holds every
family, wire and width).

Results of live collectives: the ``ring`` backend keeps the JAX ring's
order of adds, so its f32 results are bitwise equal at every pipeline
depth; integer payloads are exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu import constants as jconstants
from torchmpi_tpu.collectives import eager as jeager
from torchmpi_tpu.schedule import algebra as jalgebra
from torchmpi_tpu.schedule import compiler as jsched
from torchmpi_tpu.schedule import cost as jcost
from torchmpi_tpu.schedule import generators as jgen
from torchmpi_tpu.schedule import pipeline as jpipeline
from torchmpi_tpu.schedule import topology as jtopology
from torchmpi_tpu_torch import constants, ops, schedule, telemetry
from torchmpi_tpu_torch.collectives import eager
from torchmpi_tpu_torch.schedule import algebra, compiler as sched, cost, generators, pipeline
from torchmpi_tpu_torch.schedule import topology
from torchmpi_tpu_torch.telemetry import flightrecorder as flight

OPS = ("broadcast", "reduce", "allreduce", "sendreceive", "allgather", "reducescatter",
       "alltoall")
# the port's backend -> the JAX package's
JAX_BACKEND = {"xla": "xla", "ring": "ring", "kernel": "pallas"}
NELEMS = tuple(1 << k for k in range(8, 25, 4))  # 2^8 .. 2^24 per rank
ITEMSIZES = (4, 2, 1)
WIRES = ("full", "bf16", "int8")
TORCH_DTYPES = {"float32": (torch.float32, jnp.float32), "int32": (torch.int32, jnp.int32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}


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


def _steps(plan):
    return tuple((s.kind, s.level, s.bytes, s.count, s.note) for s in plan.steps)


def decision(plan, port: bool) -> tuple:
    """A plan's decision, in the JAX package's backend names."""
    backend = JAX_BACKEND[plan.backend] if port else plan.backend
    impl = JAX_BACKEND.get(plan.impl, plan.impl) if port else plan.impl
    return (plan.op, plan.generator, backend, impl, plan.wire, plan.pipeline, _steps(plan),
            plan.meta, plan.topology_fp)


def _same_plan(tp, jp) -> None:
    assert decision(tp, True) == decision(jp, False)
    if tp.backend != "kernel":
        assert tp.plan_id == jp.plan_id


def _chosen(cands):
    feasible = [c for c in cands if c.feasible]
    return min(feasible, key=lambda c: c.cost_us or float("inf"))


def _start_both(p: int = 8):
    jmpi.start(devices=jax.devices()[:p])
    tmpi.start(ranks=p, device="cpu")
    return tmpi.current_communicator(), jmpi.current_communicator()


# --- the copied modules against their originals ------------------------------
@pytest.mark.parametrize("groups,cartesian,staged,nodes", [
    ((8,), False, False, 1), ((4,), False, False, 1), ((4, 4), True, False, 2),
    ((1, 3, 4), False, False, 1), ((2, 2, 2, 2), True, True, 4),
])
def test_topology_and_ir_match_jax(groups, cartesian, staged, nodes):
    kw = dict(platform="cpu", group_sizes=groups, cartesian=cartesian, nodes=nodes,
              staged_inter=staged)
    t, j = topology.Topology(**kw), jtopology.Topology(**kw)
    assert t.fingerprint() == j.fingerprint()
    assert (t.describe(), t.shape_token(), t.two_level, t.ragged) == (
        j.describe(), j.shape_token(), j.two_level, j.ragged)
    for op in OPS:
        for backend in ("xla", "ring"):
            tp = generators.gen_flat(op, 4096, 4, t, backend, "full")
            jp = jgen.gen_flat(op, 4096, 4, j, backend, "full")
            assert tp.plan_id == jp.plan_id and tp.describe() == jp.describe()
            assert cost.estimate_us(tp) == jcost.estimate_us(jp)
            assert cost.cost_breakdown(tp) == jcost.cost_breakdown(jp)
            assert cost.pipeline_timeline(tp) == jcost.pipeline_timeline(jp)


@pytest.mark.parametrize("p", [4, 8])
def test_topology_from_communicator_matches_jax(p):
    """The same communicators on the CPU, flat and two-level, fingerprint
    identically in both packages."""
    tcomm, jcomm = _start_both(p)
    for keys in (None, lambda r: str(r % 2), lambda r: "a" if r == 0 else "b"):
        if keys is not None:
            tmpi.push_communicator(keys, name="fp")
            jmpi.push_communicator(keys, name="fp")
            tcomm, jcomm = tmpi.current_communicator(), jmpi.current_communicator()
        t = topology.Topology.from_communicator(tcomm)
        j = jtopology.Topology.from_communicator(jcomm)
        assert t.fingerprint() == j.fingerprint()


@pytest.mark.parametrize("groups,cartesian", [((4, 4), True), ((1, 3, 4), False),
                                              ((2, 2, 2, 2), True)])
def test_algebra_matches_jax(groups, cartesian):
    """``derive_tree`` and, with ``use_plan_synthesis`` on, ``synthesize``
    give the same plans (the ``ring`` backend: plan ids exactly)."""
    _both("use_plan_synthesis", True)
    kw = dict(platform="cpu", group_sizes=groups, cartesian=cartesian)
    t, j = topology.Topology(**kw), jtopology.Topology(**kw)
    for op in ("allreduce", "broadcast"):
        for nelem in (1 << 12, 1 << 20):
            tp = algebra.derive_tree(op, nelem, 4, t, "ring", "full")
            jp = jalgebra.derive_tree(op, nelem, 4, j, "ring", "full")
            assert (tp is None) == (jp is None)
            if tp is not None:
                _same_plan(tp, jp)
                assert algebra.term_of(tp) == jalgebra.term_of(jp)
    for wire in WIRES:
        tps = algebra.synthesize("allreduce", 1 << 20, 4, t, "ring", wire)
        jps = jalgebra.synthesize("allreduce", 1 << 20, 4, j, "ring", wire)
        assert [p.plan_id for p in tps] == [p.plan_id for p in jps]


def test_pipeline_depths_and_spans_match_jax():
    for nbytes in (1, 1 << 18, 1 << 20, 1 << 26):
        assert pipeline.depth_candidates(nbytes) == jpipeline.depth_candidates(nbytes)
    for n, chunk, align in ((1000, 128, 1), (1000, 100, 64), (7, 0, 1)):
        assert list(pipeline.split_spans(n, chunk, align)) == list(
            jpipeline.split_spans(n, chunk, align))


@pytest.mark.parametrize("p", [4, 8])
@pytest.mark.parametrize("backend", ["xla", "ring", "kernel"])
@pytest.mark.parametrize("op", OPS)
def test_candidate_plans_decide_as_jax(op, backend, p):
    """``candidate_plans`` over nelem 2^8..2^24 x itemsize x wire x
    route_small on a flat topology: every candidate's decision, verdict,
    reason and cost, and the chosen one, as JAX's."""
    t = topology.Topology(platform="cpu", group_sizes=(p,))
    j = jtopology.Topology(platform="cpu", group_sizes=(p,))
    for nelem in NELEMS:
        for itemsize in ITEMSIZES:
            for wire in WIRES:
                for route_small in (True, False):
                    tc = generators.candidate_plans(op, nelem, itemsize, t, backend, wire,
                                                    route_small)
                    jc = jgen.candidate_plans(op, nelem, itemsize, j, JAX_BACKEND[backend],
                                              wire, route_small)
                    assert len(tc) == len(jc)
                    for a, b in zip(tc, jc):
                        _same_plan(a.plan, b.plan)
                        assert (a.feasible, a.cost_us, a.structural) == (
                            b.feasible, b.cost_us, b.structural)
                        assert a.reason.replace("kernel", "pallas") == b.reason
                    _same_plan(_chosen(tc).plan, _chosen(jc).plan)


@pytest.mark.parametrize("groups,cartesian,staged", [
    ((4, 4), True, False), ((2, 2, 2, 2), True, False), ((4, 4), True, True),
    ((1, 7), False, False), ((3, 2, 3), False, False),
])
@pytest.mark.parametrize("backend", ["xla", "ring", "kernel"])
def test_candidate_plans_decide_as_jax_on_two_level(groups, cartesian, staged, backend):
    """``candidate_plans`` on two-level topologies (cartesian, ragged, a
    host-staged inter link): every family's candidate, verdict, reason
    and cost, and the chosen plan, as JAX's."""
    kw = dict(platform="cpu", group_sizes=groups, cartesian=cartesian, staged_inter=staged)
    t, j = topology.Topology(**kw), jtopology.Topology(**kw)
    for op in OPS:
        for nelem in NELEMS:
            for wire in WIRES:
                tc = generators.candidate_plans(op, nelem, 4, t, backend, wire)
                jc = jgen.candidate_plans(op, nelem, 4, j, JAX_BACKEND[backend], wire)
                assert len(tc) == len(jc)
                for a, b in zip(tc, jc):
                    _same_plan(a.plan, b.plan)
                    assert (a.feasible, a.cost_us, a.structural) == (
                        b.feasible, b.cost_us, b.structural)
                    assert a.reason.replace("kernel", "pallas") == b.reason
                _same_plan(_chosen(tc).plan, _chosen(jc).plan)


# --- the compiler on a live flat communicator --------------------------------
@pytest.mark.parametrize("wire", [None, "int8"])
@pytest.mark.parametrize("backend", ["xla", "ring", "kernel"])
@pytest.mark.parametrize("op", OPS)
def test_compile_collective_chooses_as_jax(op, backend, wire):
    """``compile_collective`` on the same 8-rank flat communicator, below
    and above the size cutoffs and the wire's element floor, chooses the
    plan JAX's does."""
    tcomm, jcomm = _start_both()
    _both("wire_quant_min_elements", 1 << 12)
    for per_rank in ((3, 64), (3, 1 << 12), (2, 1 << 16)):
        shape = (8,) + ({"alltoall": (8, per_rank[1])}.get(op, per_rank))
        for dtype in ("float32", "int32"):
            td, jd = TORCH_DTYPES[dtype]
            ep = sched.compile_collective(op, shape, td, tcomm, backend=backend,
                                          wire_dtype=wire)
            jep = jsched.compile_collective(op, shape, jd, jcomm, backend=JAX_BACKEND[backend],
                                            wire_dtype=wire)
            _same_plan(ep.plan, jep.plan)
            assert ep.wire == jep.wire and ep.nelem == jep.nelem


@pytest.mark.parametrize("backend", ["xla", "ring", "kernel"])
def test_compile_fused_chooses_as_jax(backend):
    tcomm, jcomm = _start_both()
    for ns in ((64, 32, 16), (1 << 12, 1 << 14), (3, 5, 7, 1 << 18)):
        for wire in (None, "int8"):
            ep = sched.compile_fused("allreduce", ns, torch.float32, tcomm, backend=backend,
                                     wire_dtype=wire)
            jep = jsched.compile_fused("allreduce", ns, jnp.float32, jcomm,
                                       backend=JAX_BACKEND[backend], wire_dtype=wire)
            _same_plan(ep.plan, jep.plan)
            assert (ep.total, ep.wire) == (jep.total, jep.wire)
            # the second call is a memo hit: the same bound plan
            assert sched.compile_fused("allreduce", ns, torch.float32, tcomm,
                                       backend=backend, wire_dtype=wire) is ep


def test_ring_runs_the_chosen_pipeline_depth_bitwise_as_jax():
    """A ``ring`` allreduce whose plan is pipelined runs that depth, and
    the result is bitwise the JAX ring's and the port's at depth 1."""
    tcomm, jcomm = _start_both()
    _both("small_allreduce_size_cpu", 0)
    _both("plan_pipeline_min_chunk_bytes", 1 << 10)
    _both("plan_pipeline_depth", 4)
    x = np.random.RandomState(3).randn(8, 3 * 4096 + 5).astype(np.float32)
    ep = sched.compile_collective("allreduce", x.shape, torch.float32, tcomm, backend="ring")
    jep = jsched.compile_collective("allreduce", x.shape, jnp.float32, jcomm, backend="ring")
    assert ep.plan.pipeline == jep.plan.pipeline == 4 and ep.plan_id == jep.plan_id
    got = eager.run("allreduce", torch.from_numpy(x), tcomm, backend="ring")
    want = np.asarray(jeager.run("allreduce", jnp.asarray(x), jcomm, backend="ring"))
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    constants.set("plan_pipeline_depth", 1)
    depth1 = eager.run("allreduce", torch.from_numpy(x), tcomm, backend="ring")
    assert torch.equal(got.view(torch.int32), depth1.view(torch.int32))


# --- mirrors of tests/test_schedule.py ----------------------------------------
def test_plan_cache_invalidated_by_generation_bump():
    tmpi.start(ranks=8, device="cpu")
    comm = tmpi.current_communicator()
    constants.set("small_allreduce_size_cpu", 1)
    ep1 = sched.compile_collective("allreduce", (8, 4096), torch.float32, comm, backend="ring")
    assert sched.compile_collective("allreduce", (8, 4096), torch.float32, comm,
                                    backend="ring") is ep1
    keys_before = {k for k in comm._plan_cache if k[0] == "_planchoice"}
    constants.set("small_allreduce_size_cpu", 1 << 30)  # a constants.version() bump
    ep2 = sched.compile_collective("allreduce", (8, 4096), torch.float32, comm, backend="ring")
    assert ep2 is not ep1
    assert ep2.plan.backend == "xla" and ep1.plan.backend == "ring"
    assert {k for k in comm._plan_cache if k[0] == "_planchoice"} - keys_before


def test_plan_override_beats_cost_model_and_epoch_invalidates():
    tmpi.start(ranks=8, device="cpu")
    comm = tmpi.current_communicator()
    constants.set("small_allreduce_size_cpu", 1)
    constants.set("use_hierarchical_collectives", False)
    nelem = 4096
    ep = sched.compile_collective("allreduce", (8, nelem), torch.float32, comm, backend="ring")
    assert ep.plan.generator == "flat"
    okey = sched.override_key("allreduce", topology.Topology.from_communicator(comm).fingerprint(),
                              sched.payload_bucket(nelem * 4), "full")
    sched.set_plan_override(okey, "flat")
    ep2 = sched.compile_collective("allreduce", (8, nelem), torch.float32, comm, backend="ring")
    assert ep2 is not ep  # the override epoch bump invalidated the memo
    assert ep2.plan.generator == "flat"
    with pytest.raises(ValueError, match="unknown plan generator"):
        sched.set_plan_override(okey, "nope")


def test_calibration_epoch_invalidates_the_memo():
    """A measured cost table changes the calibration epoch, which the
    dispatch memo and the plan cache key on."""
    tmpi.start(ranks=8, device="cpu")
    comm = tmpi.current_communicator()
    ep = sched.compile_collective("allreduce", (8, 4096), torch.float32, comm, backend="ring")
    key = f"allreduce|global[8]|full|b{sched.payload_bucket(4 * 4096)}|{ep.plan_id}"
    assert cost.set_calibration({key: {"us": 12.5, "n": 3}}) == 1
    assert cost.calibrated_plan_us("allreduce", sched.payload_bucket(4 * 4096), "full",
                                   ep.plan_id) == 12.5
    assert __import__("torchmpi_tpu_torch.telemetry.calibrate",
                      fromlist=["split_key"]).split_key(key) == __import__(
        "torchmpi_tpu.telemetry.calibrate", fromlist=["split_key"]).split_key(key)
    ep2 = sched.compile_collective("allreduce", (8, 4096), torch.float32, comm, backend="ring")
    assert ep2 is not ep and ep2.plan_id == ep.plan_id


def test_precompile_pins_plan_cache_and_zero_plan_misses():
    """After ``precompile`` the warm dispatches are memo hits: no
    ``tm_plan_compiles_total`` increment."""
    tmpi.start(ranks=8, device="cpu")
    comm = tmpi.current_communicator()
    telemetry.enable()
    eager.free_collective_resources(comm)
    assert eager.precompile([("allreduce", (8, 512), torch.float32),
                             ("broadcast", (64,), torch.float32),
                             {"op": "allreduce", "layout": (5, 7), "dtype": torch.float32}],
                            comm=comm) == 3

    def plan_misses():
        series = telemetry.snapshot()["metrics"].get("tm_plan_compiles_total", {}).get(
            "series", {})
        return int(sum(series.values()))

    before = plan_misses()
    eager.run("allreduce", torch.ones(8, 512), comm)
    eager.run("broadcast", torch.ones(8, 64), comm)
    eager.run_fused("allreduce", [torch.ones(8, 5), torch.ones(8, 7)], comm)
    assert plan_misses() - before == 0
    assert comm._dispatch_memo.pinned_count() == 3
    assert comm._plan_cache.pinned_count() >= 1
    # pins outrank the LRU bound, not a teardown
    constants.set("collective_cache_max_entries", 1)
    for n in range(1, 6):
        eager.run("allreduce", torch.ones(8, n), comm)
    assert comm._dispatch_memo.pinned_count() == 3 and len(comm._dispatch_memo) == 3
    eager.free_collective_resources(comm)
    assert "_dispatch_memo" not in comm.__dict__ and "_plan_cache" not in comm.__dict__


def test_start_precompiles_the_declared_collectives():
    tmpi.start(ranks=4, device="cpu",
               precompile_collectives=[("allreduce", (256,), torch.float32)])
    comm = tmpi.current_communicator()
    assert comm._dispatch_memo.pinned_count() == 1


def test_plan_id_stable_and_content_addressed():
    topo = topology.Topology(platform="cpu", group_sizes=(4, 4), cartesian=True)
    p1 = generators.gen_hier("allreduce", 1 << 20, 4, topo, "ring", "full")
    p2 = generators.gen_hier("allreduce", 1 << 20, 4, topo, "ring", "full")
    assert p1.plan_id == p2.plan_id
    assert p1.plan_id != generators.gen_hier("allreduce", 1 << 20, 4, topo, "ring",
                                             "int8").plan_id
    jtopo = jtopology.Topology(platform="cpu", group_sizes=(4, 4), cartesian=True)
    assert p1.plan_id == jgen.gen_hier("allreduce", 1 << 20, 4, jtopo, "ring", "full").plan_id


def test_explain_lists_chosen_and_rejected():
    topo = topology.Topology(platform="cpu", group_sizes=(4,) * 8, cartesian=True)
    text = schedule.explain(op="allreduce", nbytes=4 << 20, topo=topo, backend="ring")
    assert "CHOSEN" in text and "rejected" in text
    assert "plan cache key" in text and "override key" in text
    for gen in ("flat", "hier", "staged", "tree"):
        assert gen in text, text
    chosen = next(line for line in text.splitlines() if line.startswith("CHOSEN"))
    jtopo = jtopology.Topology(platform="cpu", group_sizes=(4,) * 8, cartesian=True)
    jtext = jsched.explain(op="allreduce", nbytes=4 << 20, topo=jtopo, backend="ring")
    assert chosen == next(line for line in jtext.splitlines() if line.startswith("CHOSEN"))
    assert ": hier-ring-full" in chosen


def test_explain_cli_main(capsys):
    from torchmpi_tpu_torch.schedule.__main__ import main, parse_bytes, parse_groups

    assert main(["--explain", "op=allreduce", "bytes=4M", "groups=8"]) == 0
    out = capsys.readouterr().out
    assert "CHOSEN" in out and "candidates:" in out and "cuda topology 8" in out
    assert main(["--explain", "op=broadcast", "bytes=1M", "groups=1+3+4"]) == 0
    out = capsys.readouterr().out
    chosen = next(line for line in out.splitlines() if line.startswith("CHOSEN"))
    assert ": tree-ring-full" in chosen and "~synth" not in out
    assert main(["--explain", "op=allreduce", "bytes=64M", "groups=8", "backend=ring",
                 "platform=cpu"]) == 0
    assert "pipeline: depth 2" in capsys.readouterr().out
    assert parse_bytes("4MiB") == 4 << 20 and parse_groups("4x2") == ((4, 4), True)


def test_flight_entries_carry_plan_id():
    tmpi.start(ranks=8, device="cpu")
    comm = tmpi.current_communicator()
    flight.enable()
    try:
        flight.recorder.reset()
        eager.run("allreduce", torch.ones(8, 256), comm)
        entries = [e for e in flight.recorder.entries() if e["op"] == "allreduce"]
        assert entries and all(e["plan"] for e in entries)
        assert entries[-1]["plan"].startswith("flat-xla-full:")
        assert entries[-1]["status"] == flight.STATUS_COMPLETED
    finally:
        flight.disable()


# --- two-level communicators: the JAX families ------------------------------
# (op, keys, constants, backend, family): where the JAX compiler chooses
# another family than flat, which the port must choose as well
TWO_LEVEL_DIFFERENCES = [
    ("allreduce", "cartesian", {}, "ring", "hier"),
    ("allreduce", "cartesian", {}, "kernel", "hier"),
    ("broadcast", "cartesian", {}, "ring", "hier"),
    ("reduce", "cartesian", {}, "ring", "hier"),
    ("allgather", "cartesian", {}, "ring", "hier"),
    ("allreduce", "ragged", {}, "ring", "tree"),
    ("allreduce", "cartesian", {"use_staged_collectives": True}, "ring", "staged"),
]
KEYS = {"cartesian": lambda r: str(r % 2), "ragged": lambda r: "a" if r == 0 else "b"}


@pytest.mark.parametrize("op,keys,consts,backend,jax_family", TWO_LEVEL_DIFFERENCES)
def test_two_level_chooses_the_jax_family(op, keys, consts, backend, jax_family):
    """The port chooses the JAX family with the same decision and the
    same candidates' feasibility, ``explain`` chooses it, and the integer
    result equals JAX's exactly."""
    from torchmpi_tpu.ops import ring_kernels as jrk

    tmpi.start(ranks=8, device="cpu")
    jmpi.start(devices=jax.devices()[:8])
    for name, value in {"small_allreduce_size_cpu": 0, "small_broadcast_size_cpu": 0,
                        **consts}.items():
        _both(name, value)
    tmpi.push_communicator(KEYS[keys], name="two")
    jmpi.push_communicator(KEYS[keys], name="two")
    tcomm, jcomm = tmpi.current_communicator(), jmpi.current_communicator()
    shape = (8, 3, 1 << 12)
    ep = sched.compile_collective(op, shape, torch.float32, tcomm, backend=backend)
    jep = jsched.compile_collective(op, shape, jnp.float32, jcomm, backend=JAX_BACKEND[backend])
    assert jep.plan.generator == jax_family == ep.plan.generator
    _same_plan(ep.plan, jep.plan)
    assert (ep.op_label, ep.routing) == (jep.op_label, jep.routing)
    topo = topology.Topology.from_communicator(tcomm)
    cands = generators.candidate_plans(op, math.prod(shape[1:]), 4, topo, backend)
    jcands = jgen.candidate_plans(op, math.prod(shape[1:]), 4,
                                  jtopology.Topology.from_communicator(jcomm),
                                  JAX_BACKEND[backend])
    assert [(decision(c.plan, True), c.feasible, c.reason) for c in cands] == \
        [(decision(c.plan, False), c.feasible, c.reason) for c in jcands]
    text = schedule.explain(op=op, nbytes=4 * math.prod(shape[1:]), topo=topo, backend=backend)
    chosen = next(line for line in text.splitlines() if line.startswith("CHOSEN"))
    assert f": {jax_family}-" in chosen
    x = np.random.RandomState(1).randint(-1000, 1000, shape).astype(np.int32)
    got = eager.run(op, torch.from_numpy(x), tcomm, backend=backend)
    jrk._FORCE_INTERPRET = backend == "kernel"
    try:
        want = np.asarray(jeager.run(op, jnp.asarray(x), jcomm, backend=JAX_BACKEND[backend]))
    finally:
        jrk._FORCE_INTERPRET = False
    assert np.array_equal(got.numpy(), want)


def test_a_pinned_torus_runs_and_equals_jax():
    """A pinned synthesized two-level family (the torus) runs, with the
    JAX labels, and its f32 result equals the JAX lowering's bit for
    bit."""
    _start_both()
    tmpi.push_communicator(KEYS["cartesian"], name="two")
    jmpi.push_communicator(KEYS["cartesian"], name="two")
    tcomm, jcomm = tmpi.current_communicator(), jmpi.current_communicator()
    ep = sched.compile_collective("allreduce", (8, 4096), torch.float32, tcomm,
                                  generator="torus~synth", impl="ring")
    jep = jsched.compile_collective("allreduce", (8, 4096), jnp.float32, jcomm,
                                    generator="torus~synth", impl="ring")
    _same_plan(ep.plan, jep.plan)
    assert (ep.op_label, ep.backend_label, ep.routing) == (
        jep.op_label, jep.backend_label, jep.routing) == ("torus_allreduce", "ring", "synth")
    x = np.random.RandomState(2).randn(8, 4096).astype(np.float32)
    got = ep.execute(torch.from_numpy(x)).numpy()
    want = np.asarray(jep.execute(jnp.asarray(x)))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
