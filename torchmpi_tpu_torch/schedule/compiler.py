"""The schedule compiler: requests in, executable plans out.

``compile_collective`` is the single routing authority the legacy
four-way branch stack collapsed into: a request ``(op, payload, dtype,
comm)`` is resolved (effective backend, wire format), planned
(generator candidates against the declared topology, cost-modeled,
autotuner overrides honored), and bound (lowered onto the existing
executors, executable-cache keys preserved). Three cache levels:

1. **dispatch memo** (exact call signature → :class:`ExecutablePlan`,
   generation-stamped): the warm path — one dict hit, zero planning.
2. **plan cache** (``(op, topology fingerprint, payload bucket, wire,
   generation())`` → chosen plan + the full candidate list): reused
   across shapes in the same bucket; the unit ``tune_plan`` overrides.
3. **executable cache** (exact lowering key → compiled fn): unchanged
   from the pre-compiler code, including AOT pin semantics.

All three live on the communicator (``_LRUCache``), are pinned by
``precompile`` and torn down by ``free_collective_resources``.

The port of ``torchmpi_tpu/schedule/compiler.py``. The port compiles no
executable, so it keeps the first two levels: a plan binds the port's
kernel table (``collectives.eager._kernels``) through ``schedule/lower.py``.
Its differences from the JAX compiler:

- the kernel backend is named ``kernel`` (the JAX package's ``pallas``);
- the memo and cache keys carry ``constants.version()``, the port's
  counter of constant changes (the JAX ``generation()``);
- ``_bind`` lowers every family: flat, hierarchical, staged, tree and the
  algebra-synthesized ones (``~synth``), with the JAX labels;
- :meth:`ExecutablePlan.execute` places nothing (the virtual ranks live
  on ``comm.device`` already) and passes a CUDA ``stream`` on to the
  kernels, and :attr:`ExecutablePlan.issue` names the warm async
  allreduces that the C++ issue path (``ops/issue.py``) can take, which
  records the plan's wire bytes as :meth:`ExecutablePlan.execute` does
  (``record_wire``: ``utils.tracing.wire_stats``)."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from .. import constants, telemetry as _telemetry
from . import algebra as _algebra
from . import cost as _cost, generators as _generators
from .ir import Plan
from .topology import Topology

_MET = None


def _plan_metrics():
    global _MET
    if _MET is None:
        m = _telemetry.metrics
        _MET = (
            m.counter(
                "tm_plan_cache_hits_total",
                "plan-compiler warm hits (dispatch memo or plan cache) "
                "by op",
            ),
            m.counter(
                "tm_plan_compiles_total",
                "plan-cache misses (full candidate selection runs) by "
                "op/generator",
            ),
            m.counter(
                "tm_plan_synth_candidates_total",
                "feasible algebra-synthesized candidates priced by "
                "selection, by op/family",
            ),
            m.counter(
                "tm_plan_synth_selected_total",
                "selections won by an algebra-synthesized plan, by "
                "op/family",
            ),
        )
    return _MET


def _count_hit(op: str) -> None:
    if _telemetry.enabled():
        _plan_metrics()[0].inc(op=op)


def _count_compile(op: str, generator: str) -> None:
    if _telemetry.enabled():
        _plan_metrics()[1].inc(op=op, generator=generator)


def _count_synth(op: str, feasible, chosen) -> None:
    """Selection-outcome telemetry for the synthesized families: one
    candidates tick per feasible synth plan priced in this selection
    run, one selected tick when a synth plan wins. Bumped only on plan-
    cache misses (like tm_plan_compiles_total) so the counts track
    decisions, not warm replays."""
    if not _telemetry.enabled():
        return
    mets = _plan_metrics()
    for c in feasible:
        if _algebra.is_synthesized(c.plan.generator):
            mets[2].inc(op=op, family=_algebra.synth_family(
                c.plan.generator))
    if chosen is not None and _algebra.is_synthesized(
            chosen.plan.generator):
        mets[3].inc(op=op, family=_algebra.synth_family(
            chosen.plan.generator))


def _eager():
    from ..collectives import eager

    return eager


# ---------------------------------------------------------------------------
# autotuner plan overrides (the measured winners tune_plan persists)
# ---------------------------------------------------------------------------

_PLAN_OVERRIDES: Dict[str, str] = {}
_OVR_EPOCH = 0  # bumped on any override change: plan-cache keys embed it


def override_key(op: str, topology_fp: str, bucket: int, wire: str) -> str:
    """The persistence identity of one plan decision — what tune_plan
    measures and ``start()`` re-applies, mirroring tuned constants."""
    return f"{op}|{topology_fp}|b{bucket}|{wire}"


def set_plan_override(key: str, generator: str) -> None:
    global _OVR_EPOCH
    if generator not in _generators.GENERATORS and \
            generator not in _algebra.SYNTH_GENERATORS:
        raise ValueError(f"unknown plan generator {generator!r}")
    _PLAN_OVERRIDES[key] = generator
    _OVR_EPOCH += 1


def apply_plan_overrides(entries: Dict[str, str]) -> Dict[str, str]:
    """Bulk-apply persisted overrides (``load_tuning``); unknown
    generator names are skipped (forward-compat with newer caches).
    Returns what was applied."""
    applied = {}
    for key, generator in (entries or {}).items():
        if generator in _generators.GENERATORS or \
                generator in _algebra.SYNTH_GENERATORS:
            _PLAN_OVERRIDES[key] = generator
            applied[key] = generator
    if applied:
        global _OVR_EPOCH
        _OVR_EPOCH += 1
    return applied


def plan_overrides() -> Dict[str, str]:
    return dict(_PLAN_OVERRIDES)


def clear_plan_overrides() -> None:
    global _OVR_EPOCH
    if _PLAN_OVERRIDES:
        _PLAN_OVERRIDES.clear()
        _OVR_EPOCH += 1


def payload_bucket(nbytes: int) -> int:
    """Pow-2 payload bucket for plan-cache keys: plan DECISIONS are
    shared within a bucket (the schedule family rarely flips inside a
    2x band); executables stay keyed on exact shapes below."""
    return max(1, int(nbytes)).bit_length()


# ---------------------------------------------------------------------------
# plan registry: plan_id -> Plan for every candidate the compiler has
# considered in this process. Bounded; lets the calibration fit price a
# measured plan_id with the analytic model (modeled-vs-measured report)
# and lets tooling explain a plan_id seen in a flight dump.
# ---------------------------------------------------------------------------

_PLAN_REGISTRY: Dict[str, Plan] = {}
_PLAN_REGISTRY_MAX = 1024


def _register_plans(cands) -> None:
    for c in cands:
        plan = getattr(c, "plan", c)
        _PLAN_REGISTRY.setdefault(plan.plan_id, plan)
    while len(_PLAN_REGISTRY) > _PLAN_REGISTRY_MAX:
        _PLAN_REGISTRY.pop(next(iter(_PLAN_REGISTRY)))


def plan_by_id(plan_id: str) -> Optional[Plan]:
    """The Plan behind a ``plan_id`` this process has compiled or
    considered; None for plan_ids from other processes/runs."""
    return _PLAN_REGISTRY.get(plan_id)


# ---------------------------------------------------------------------------
# request resolution (the policy the legacy branch stack applied inline)
# ---------------------------------------------------------------------------


def effective_backend(op: str, nelem: int, dtype, platform: str,
                      backend: str, route_small: bool) -> str:
    """Resolve the requested backend: the small-message cutoff reroutes
    custom requests to the vendor path, and a reduction whose dtype the
    kernels cannot carry exactly, or a complex payload of any op, falls
    to the ``ring`` backend, as in the JAX package."""
    eager = _eager()
    effective = backend
    if backend in ("ring", "kernel") and route_small:
        effective = eager.op_route(op, nelem, platform, backend)
    if effective == "kernel":
        from ..ops import ring_kernels

        if op in ("allreduce", "reduce", "reducescatter"):
            if not ring_kernels.supports_dtype(dtype):
                effective = "ring"
        elif dtype.is_complex:
            effective = "ring"
    return effective


def _nelem(shape: Tuple[int, ...]) -> int:
    return math.prod(shape[1:])


# ---------------------------------------------------------------------------
# plan selection
# ---------------------------------------------------------------------------


def _apply_pinned_depth(chosen, feasible):
    """A pinned ``plan_pipeline_depth`` (tune_pipeline_depth's persisted
    winner, or an operator force) overrides the model's DEPTH choice
    within the chosen family — the family choice itself stays with the
    override/cost logic. One helper for ``select_plan`` AND ``explain``
    so dispatch and its introspection can never drift; the swap matches
    the whole plan family (generator + backend + op), never just the
    generator name."""
    if chosen is None:
        return chosen
    pinned_d = int(constants.get("plan_pipeline_depth"))
    if pinned_d > 1 and chosen.plan.pipeline != pinned_d:
        alt = next(
            (c for c in feasible
             if c.plan.generator == chosen.plan.generator
             and c.plan.backend == chosen.plan.backend
             and c.plan.op == chosen.plan.op
             and c.plan.pipeline == pinned_d),
            None,
        )
        if alt is not None:
            return alt
    return chosen


def _plan_cache(comm):
    cache = getattr(comm, "_plan_cache", None)
    if cache is None:
        eager = _eager()
        cache = eager._LRUCache()
        comm._plan_cache = cache  # type: ignore[attr-defined]
    return cache


def select_plan(
    op: str,
    nelem: int,
    itemsize: int,
    topo: Topology,
    backend: str,
    wire: str,
    route_small: bool,
    comm=None,
) -> Tuple[Plan, List["_generators.Candidate"]]:
    """Pick the schedule for an (unpinned) request: plan-cache lookup,
    else enumerate generator candidates, honor a persisted autotuner
    override, else take the cost-model minimum."""
    suffix = constants.platform_suffix(topo.platform)
    small = (
        backend in ("ring", "kernel")
        and route_small
        and op in _generators._CUTOFF_OPS
        and nelem <= constants.get(f"small_{op}_size_{suffix}")
    )
    bucket = payload_bucket(nelem * itemsize)
    pkey = (
        "_planchoice", op, topo.fingerprint(), bucket, wire, backend,
        route_small, small, _OVR_EPOCH, _cost.calibration_epoch(),
        constants.version(),
    )
    cache = _plan_cache(comm) if comm is not None else None
    if cache is not None:
        ent = cache.get(pkey)
        if ent is not None:
            return ent
    cands = _generators.candidate_plans(
        op, nelem, itemsize, topo, backend, wire=wire,
        route_small=route_small,
    )
    _register_plans(cands)
    feasible = [c for c in cands if c.feasible]
    chosen = None
    override = _PLAN_OVERRIDES.get(
        override_key(op, topo.fingerprint(), bucket, wire)
    )
    if override is not None:
        chosen = next(
            (c for c in feasible if c.plan.generator == override), None
        )
    if chosen is None and feasible:
        # measured (calibrated) costs re-order candidates only when the
        # WHOLE feasible depth-1 set was timed: wall-clock microseconds
        # and idealized analytic estimates are incommensurable scales,
        # and mixing them in one min() flips selection on measurement
        # coverage, not merit (the timed incumbent looks expensive next
        # to an untimed candidate's optimistic estimate). Pipelined
        # twins join the measured pool only once they have samples of
        # their own (a depth variant executes — and so gets timed —
        # after the analytic model or a pinned depth first picks it);
        # an unmeasured twin must neither win on an optimistic analytic
        # estimate against measured rivals NOR invalidate a calibration
        # table that fully covered the depth-1 set (depth-1 plan_ids
        # are hash-stable across this feature for exactly that reason).
        # A partially-measured depth-1 set keeps the analytic ordering;
        # tune_plan overrides (checked above) remain the
        # measured-search authority.
        measured = {
            c.plan.plan_id: _cost.calibrated_plan_us(
                op, bucket, wire, c.plan.plan_id
            )
            for c in feasible
        }
        base_covered = all(
            measured[c.plan.plan_id] is not None
            for c in feasible if c.plan.pipeline == 1
        )
        if base_covered:
            pool = [
                c for c in feasible
                if measured[c.plan.plan_id] is not None
            ]
            chosen = min(pool, key=lambda c: measured[c.plan.plan_id])
        else:
            chosen = min(feasible, key=lambda c: c.cost_us or float("inf"))
    chosen = _apply_pinned_depth(chosen, feasible)
    if chosen is None:
        # defensive: the gate algebra always leaves one feasible flat
        # candidate, but a plan must exist even if it ever does not
        chosen = _generators.Candidate(
            plan=_generators.gen_flat(op, nelem, itemsize, topo, backend,
                                      wire),
            cost_us=None, feasible=True, reason="fallback",
        )
        cands = cands + [chosen]
    chosen.chosen = True
    _count_synth(op, feasible, chosen)
    ent = (chosen.plan, cands)
    if cache is not None:
        cache[pkey] = ent
    return ent


def pinned_plan(generator: str, op: str, nelem: int, itemsize: int,
                topo: Topology, impl: str, wire: str) -> Plan:
    """Build the plan a generator-pinning wrapper demanded, bypassing
    the policy gates (a direct ``run_hierarchical_*`` call runs its
    composition exactly like the legacy entry point did) but never
    structural impossibility. A pinned ``plan_pipeline_depth`` still
    applies — a pinned FAMILY earns the tuned pipeline like the policy
    path does."""
    eager = _eager()
    if generator == "hier":
        if not (topo.two_level and topo.cartesian):
            raise eager.CollectiveArgumentError(
                "hierarchical collectives need a cartesian communicator "
                "with multiple intra groups of size > 1"
            )
        plan = _generators.gen_hier(op, nelem, itemsize, topo, impl, wire)
    elif generator == "staged":
        if not (topo.two_level and topo.cartesian):
            raise eager.CollectiveArgumentError(
                "staged hierarchical allreduce needs a cartesian "
                "communicator with multiple intra groups of size > 1"
            )
        plan = _generators.gen_staged(op, nelem, itemsize, topo, impl, wire)
    elif generator == "tree":
        if not topo.two_level:
            raise eager.CollectiveArgumentError(
                "hierarchical allreduce needs a communicator with both "
                "levels"
            )
        plan = _algebra.derive_tree(op, nelem, itemsize, topo, impl, wire)
    elif generator in _algebra.SYNTH_GENERATORS:
        plan = _algebra.derive_synth(generator, op, nelem, itemsize, topo,
                                     impl, wire)
        if plan is None:
            raise eager.CollectiveArgumentError(
                f"synthesized plan {generator!r} is not derivable for "
                f"this (op, topology): {op} on {topo.describe()}"
            )
    else:
        plan = _generators.gen_flat(op, nelem, itemsize, topo, impl, wire)
    return _generators.maybe_pin_depth(plan, nelem, itemsize)


# ---------------------------------------------------------------------------
# binding: plan -> executable
# ---------------------------------------------------------------------------


class ExecutablePlan:
    """A plan bound to a communicator + exact payload: ``execute(x)``
    replays the lowered function through the telemetry dispatch wrapper,
    stamping every flight-recorder entry and span with the plan's stable
    ``plan_id``. ``takes_stream``: the function launches a kernel and
    takes ``stream=``. ``issue``: the route of the C++ async issue path
    (:func:`~torchmpi_tpu_torch.ops.issue.issue_async`) for a CUDA
    allreduce it can carry, else None. ``record_wire``: what each execute
    (and each C++ issue of the plan) records into
    ``utils.tracing.wire_stats``, or None
    (:func:`~torchmpi_tpu_torch.collectives.eager._wire_recorder`)."""

    __slots__ = (
        "plan", "plan_id", "fn", "comm", "op_label", "backend_label",
        "wire", "nelem", "dtype", "routing", "takes_stream", "issue",
        "record_wire",
    )

    def __init__(self, plan: Plan, fn, comm, op_label: str,
                 backend_label: str, wire: str, nelem: int, dtype,
                 routing: str, takes_stream: bool = False, issue=None):
        self.plan = plan
        self.plan_id = plan.plan_id
        self.fn = fn
        self.comm = comm
        self.op_label = op_label
        self.backend_label = backend_label
        self.wire = wire
        self.nelem = nelem
        self.dtype = dtype
        self.routing = routing
        self.takes_stream = takes_stream
        self.issue = issue
        self.record_wire = _eager()._wire_recorder(plan.op, backend_label, routing,
                                                   nelem, dtype, wire)

    def execute(self, x, stream=None):
        eager = _eager()
        if self.record_wire is not None:
            self.record_wire()
        fn = self.fn
        if stream is not None and self.takes_stream:
            def fn(a, _fn=self.fn):
                return _fn(a, stream=stream)
        return eager._dispatch(
            fn, x, self.op_label, self.backend_label, self.wire,
            self.nelem, comm=self.comm, payload=(tuple(x.shape), x.dtype),
            routing=self.routing, plan=self.plan_id,
        )


class FusedExecutablePlan:
    """The coalesced variant: ``execute(flats)`` feeds same-dtype
    ``[p, n_i]`` slabs through one pack (``torch.cat``) and the flat
    plan's function, as one dispatch with one flight entry; on a
    two-level routing (``inner``: the request's backend, ``route_small``
    and ``wire_dtype``) the pack, then the composition through
    ``eager.run``, its own plan and flight entry."""

    __slots__ = (
        "plan", "plan_id", "fn", "comm", "backend_label", "wire", "ns",
        "total", "dtype", "inner", "record_wire",
    )

    def __init__(self, plan: Plan, fn, comm, backend_label: str, wire: str,
                 ns: Tuple[int, ...], total: int, dtype, inner=None):
        self.plan = plan
        self.plan_id = plan.plan_id
        self.fn = fn
        self.comm = comm
        self.backend_label = backend_label
        self.wire = wire
        self.ns = ns
        self.total = total
        self.dtype = dtype
        self.inner = inner
        # a two-level routing records through its own plan's execute
        self.record_wire = None if inner is not None else _eager()._wire_recorder(
            plan.op, backend_label, "fused", total, dtype, wire)

    def execute(self, flats):
        eager = _eager()
        if self.inner is not None:
            backend, route_small, wire_dtype = self.inner
            return eager.run(self.plan.op, self.fn(flats), self.comm, backend=backend,
                             route_small=route_small, wire_dtype=wire_dtype)
        if self.record_wire is not None:
            self.record_wire()
        return eager._dispatch(
            self.fn, flats, self.plan.op, self.backend_label, self.wire,
            self.total, comm=self.comm, payload=(self.ns, self.dtype),
            routing="fused", plan=self.plan_id,
        )


def _bind(plan: Plan, comm, shape: Tuple[int, ...], dtype, wire: str,
          root: int, src: int, dst: int) -> ExecutablePlan:
    """Bind ``plan`` to its lowering (``compiler.py:531``), with the JAX
    package's labels: the op label ``hier_allreduce``, ``hier_{op}``,
    ``staged_allreduce``, ``tree_hier_allreduce``, ``tree_broadcast``,
    ``halve_allreduce``, ``torus_allreduce`` or ``striped_allreduce`` and
    the routing ``hier``, ``staged``, ``tree`` or ``synth`` of the flight
    entries and spans, the backend label the plan's intra transport
    (``ring`` for the synthesized families, whose exchanges and rings are
    the ``ring`` backend's on any request backend)."""
    from . import lower

    op = plan.op
    nelem = _nelem(shape)
    if plan.generator == "flat":
        fn, takes_stream = lower.lower_flat(
            comm, op, plan.backend, shape, dtype, wire, root, src, dst,
            pipeline=plan.pipeline,
        )
        return ExecutablePlan(
            plan, fn, comm, op, plan.backend, wire, nelem, dtype, "flat",
            takes_stream, lower.issue_route(comm, op, plan.backend, shape, dtype, wire),
        )
    if plan.generator in _algebra.SYNTH_GENERATORS:
        if plan.generator == "halve~synth":
            fn, _ = lower.lower_halve_allreduce(comm, shape, dtype, wire)
            label = "halve_allreduce"
        elif plan.generator == "torus~synth":
            fn, _ = lower.lower_torus_allreduce(comm, shape, dtype, wire, pipeline=plan.pipeline)
            label = "torus_allreduce"
        else:
            fn, _ = lower.lower_striped_allreduce(comm, shape, dtype, wire,
                                                  pipeline=plan.pipeline)
            label = "striped_allreduce"
        if comm.multiprocess:
            fn = lower.across(comm, "ring", fn, False)
        return ExecutablePlan(plan, fn, comm, label, "ring", wire, nelem, dtype, "synth")
    impl = plan.impl or plan.backend
    if plan.generator == "hier":
        if op == "allreduce":
            fn, takes_stream = lower.lower_hier_allreduce(
                comm, impl, shape, dtype, wire, pipeline=plan.pipeline)
            return ExecutablePlan(plan, fn, comm, "hier_allreduce", impl, wire, nelem,
                                  dtype, "hier", takes_stream)
        fn, takes_stream = lower.lower_hier_collective(comm, op, root, impl, shape, dtype)
        return ExecutablePlan(plan, fn, comm, f"hier_{op}", impl, "full", nelem, dtype,
                              "hier", takes_stream)
    if plan.generator == "staged":
        depth = plan.pipeline

        def fn(a, stream=None):
            return lower.run_staged_hierarchical_allreduce(a, comm, impl, wire,
                                                           pipeline=depth, stream=stream)

        return ExecutablePlan(plan, fn, comm, "staged_allreduce", impl, wire, nelem, dtype,
                              "staged", impl == "kernel")
    # tree
    if op == "allreduce":
        fn, _ = lower.lower_tree_allreduce(comm, shape, dtype, wire, pipeline=plan.pipeline)
        if comm.multiprocess:
            fn = lower.across(comm, "ring", fn, False)
        return ExecutablePlan(plan, fn, comm, "tree_hier_allreduce", "ring", wire, nelem,
                              dtype, "tree")
    fn, _ = lower.lower_tree_broadcast(comm, root, shape, dtype)
    if comm.multiprocess:
        fn = lower.across(comm, "ring", fn, False)
    return ExecutablePlan(plan, fn, comm, "tree_broadcast", impl, "full", nelem, dtype,
                          "tree")


# ---------------------------------------------------------------------------
# the compile entry points
# ---------------------------------------------------------------------------


def compile_collective(
    op: str,
    shape: Tuple[int, ...],
    dtype,
    comm,
    backend: str = "xla",
    route_small: bool = True,
    wire_dtype: Optional[str] = None,
    root: int = 0,
    src: int = 0,
    dst: int = 0,
    generator: Optional[str] = None,
    impl: Optional[str] = None,
    wire_override: Optional[str] = None,
) -> ExecutablePlan:
    """Compile one eager collective request to an executable plan.

    ``generator``/``impl``/``wire_override`` are the pin surface the
    thin ``run_hierarchical_*`` wrappers use: a pinned generator
    bypasses policy gates (cost model, cutoffs, constants) but not
    structural feasibility, exactly like the legacy direct entry
    points."""
    eager = _eager()
    gen_now = constants.version()
    memo = eager._dispatch_memo(comm)
    dtype_token = str(dtype)
    sig = (
        "_plan", op, tuple(shape), dtype_token, backend, route_small,
        wire_dtype, wire_override, generator, impl, root, src, dst,
    )
    ent = memo.get(sig)
    if ent is not None and ent[0] == gen_now and ent[2] == (
        _OVR_EPOCH, _cost.calibration_epoch(),
    ):
        _count_hit(op)
        return ent[1]
    nelem = _nelem(shape)
    itemsize = dtype.itemsize
    platform = comm.device.type
    topo = Topology.from_communicator(comm)
    if generator is not None:
        eff = impl or backend
        if wire_override is not None:
            wire = wire_override
        elif eff in ("ring", "kernel") and op in eager._WIRE_OPS:
            wire = eager.resolve_wire_dtype(op, nelem, dtype, wire_dtype)
        else:
            wire = "full"
        plan = pinned_plan(generator, op, nelem, itemsize, topo,
                           eff, wire)
    else:
        eff = effective_backend(op, nelem, dtype, platform, backend,
                                route_small)
        if wire_override is not None:
            wire = wire_override
        elif eff in ("ring", "kernel") and op in eager._WIRE_OPS:
            wire = eager.resolve_wire_dtype(op, nelem, dtype, wire_dtype)
        else:
            wire = "full"
        plan, _cands = select_plan(
            op, nelem, itemsize, topo, eff, wire, route_small, comm=comm
        )
    ep = _bind(plan, comm, tuple(shape), dtype, wire, root, src, dst)
    memo[sig] = (gen_now, ep, (_OVR_EPOCH, _cost.calibration_epoch()))
    _count_compile(op, plan.generator)
    return ep


def compile_fused(
    op: str,
    ns: Tuple[int, ...],
    dtype,
    comm,
    backend: str = "xla",
    route_small: bool = True,
    wire_dtype: Optional[str] = None,
) -> FusedExecutablePlan:
    """Compile a coalesced multi-tensor request (one ``[p, n_i]`` slab
    per pending tensor). Routing — latency cutoff, wire format,
    hierarchical delegation — is decided on the TOTAL payload:
    coalescing is exactly what pushes small tensors past the
    bandwidth-path and quantization cutoffs."""
    eager = _eager()
    gen_now = constants.version()
    memo = eager._dispatch_memo(comm)
    total = int(sum(ns))
    sig = ("_planfused", op, tuple(ns), str(dtype), backend, route_small,
           wire_dtype)
    ent = memo.get(sig)
    if ent is not None and ent[0] == gen_now and ent[2] == (
        _OVR_EPOCH, _cost.calibration_epoch(),
    ):
        _count_hit(op)
        return ent[1]
    topo = Topology.from_communicator(comm)
    eff = effective_backend(op, total, dtype, comm.device.type, backend,
                            route_small)
    wire = "full"
    if eff in ("ring", "kernel"):
        wire = eager.resolve_wire_dtype(op, total, dtype, wire_dtype)
    plan, _cands = select_plan(
        op, total, dtype.itemsize, topo, eff, wire, route_small, comm=comm
    )
    if plan.generator == "flat":
        from . import lower

        fn = lower.lower_fused_flat(comm, op, plan.backend, tuple(ns), dtype,
                                    wire, pipeline=plan.pipeline)
        ep = FusedExecutablePlan(plan, fn, comm, plan.backend, wire, tuple(ns), total, dtype)
    else:
        # a two-level routing: the pack, then the composition through
        # run() (its own plan and flight entry), as the JAX package
        # delegates (compiler.py:707-720)
        ep = FusedExecutablePlan(plan, lambda flats: torch.cat(flats, dim=1), comm,
                                 plan.backend, wire, tuple(ns), total, dtype,
                                 inner=(backend, route_small, wire_dtype))
    memo[sig] = (gen_now, ep, (_OVR_EPOCH, _cost.calibration_epoch()))
    _count_compile(op, plan.generator)
    return ep


# ---------------------------------------------------------------------------
# explain (offline-capable: replaces/extends the selector dump)
# ---------------------------------------------------------------------------


def _resolve_wire_offline(op: str, nelem: int, dtype_name: str,
                          requested: Optional[str]) -> str:
    """Tensor-free mirror of ``eager.resolve_wire_dtype`` for offline
    planning (the CLI path, where no backend is imported)."""
    wire = requested if requested is not None else \
        constants.get("wire_dtype")
    if wire in (None, "", "full"):
        return "full"
    if wire not in ("int8", "bf16"):
        raise ValueError(f"unknown wire_dtype {wire!r}")
    if op not in ("allreduce", "reducescatter"):
        return "full"
    if dtype_name != "float32":
        return "full"
    if nelem < constants.get("wire_quant_min_elements"):
        return "full"
    return wire


_DTYPE_SIZES = {
    "float32": 4, "float64": 8, "bfloat16": 2, "float16": 2,
    "int32": 4, "int64": 8, "int16": 2, "int8": 1, "uint8": 1,
}


def explain(
    op: str = "allreduce",
    nbytes: int = 4 << 20,
    topo: Optional[Topology] = None,
    dtype: str = "float32",
    backend: str = "ring",
    wire: Optional[str] = None,
    route_small: bool = True,
    families: str = "all",
) -> str:
    """Render the compiler's decision for a request: the chosen plan,
    its cost-model estimate, and every rejected candidate with its
    reason — the introspection surface that replaces the selector's
    static preference dump. Works offline against a declared
    :class:`Topology` (no card, no live communicator; the default is one
    CUDA card's eight virtual ranks).

    ``families`` filters the candidate RENDERING ('legacy' | 'synth' |
    'all'); the decision itself is always computed over the full set
    (so the CHOSEN line never changes with the filter). Synthesized
    candidates additionally print their algebra derivation — the term
    the bounded enumerator compiled to plan-IR steps."""
    if topo is None:
        topo = Topology(platform="cuda", group_sizes=(8,))
    itemsize = _DTYPE_SIZES.get(dtype, 4)
    nelem = max(1, nbytes // itemsize)
    resolved_wire = (
        _resolve_wire_offline(op, nelem, dtype, wire)
        if backend in ("ring", "kernel") else "full"
    )
    cands = _generators.candidate_plans(
        op, nelem, itemsize, topo, backend, wire=resolved_wire,
        route_small=route_small,
    )
    feasible = [c for c in cands if c.feasible]
    bucket = payload_bucket(nelem * itemsize)
    okey = override_key(op, topo.fingerprint(), bucket, resolved_wire)
    override = _PLAN_OVERRIDES.get(okey)
    chosen = None
    if override is not None:
        chosen = next(
            (c for c in feasible if c.plan.generator == override), None
        )
    how = "autotuned (tune_plan)" if chosen is not None else "cost model"
    if chosen is None and feasible:
        chosen = min(feasible, key=lambda c: c.cost_us or float("inf"))
    # the same pinned-depth rule select_plan applies, so explain shows
    # the decision production dispatch would make
    chosen = _apply_pinned_depth(chosen, feasible)
    lines = [
        f"request: {op} {_generators_fmt_bytes(nbytes)} {dtype} "
        f"backend={backend} wire={resolved_wire}",
        f"topology: {topo.describe()}",
        f"  fingerprint {topo.fingerprint()}",
        f"plan cache key: (op={op}, topo, bucket=2^{bucket}, "
        f"wire={resolved_wire}, generation={constants.version()})",
        f"override key: {okey}"
        + (f" -> {override} (persisted)" if override else " (no override)"),
        "",
    ]
    if chosen is None:
        lines.append("no feasible candidate (request cannot dispatch)")
    else:
        lines.append(
            f"CHOSEN [{how}]: {chosen.plan.plan_id}  "
            f"est {chosen.cost_us:.1f}us"
        )
        lines.append(chosen.plan.describe())
        if _algebra.is_synthesized(chosen.plan.generator):
            lines.append(
                f"  derivation: {_algebra.term_of(chosen.plan)}"
            )
        bd = _cost.cost_breakdown(chosen.plan)
        if bd:
            lines.append(
                "  cost: " + ", ".join(
                    f"{k}={v:.1f}us" for k, v in sorted(bd.items())
                )
            )
        lines.extend(_explain_pipeline(chosen, cands, op, bucket,
                                       resolved_wire))
    lines.append("")
    shown = {
        "legacy": lambda c: not _algebra.is_synthesized(c.plan.generator),
        "synth": lambda c: _algebra.is_synthesized(c.plan.generator),
    }.get(families, lambda c: True)
    label = "candidates:" if families in ("all", None) else \
        f"candidates ({families} families):"
    lines.append(label)
    order = sorted(
        cands,
        key=lambda c: (not c.feasible, c.cost_us or float("inf")),
    )
    for c in order:
        if c is not chosen and not shown(c):
            continue
        mark = "CHOSEN  " if c is chosen else (
            "ok      " if c.feasible else "rejected"
        )
        est = f"{c.cost_us:9.1f}us" if c.cost_us is not None else \
            "      --  "
        reason = f"  ({c.reason})" if c.reason else ""
        lines.append(
            f"  {mark} {c.plan.plan_id:<32} {est}{reason}"
        )
    synths = [c for c in order
              if _algebra.is_synthesized(c.plan.generator)]
    if synths and families != "legacy":
        lines.append("")
        lines.append("derivations (composition algebra -> plan IR):")
        for c in synths:
            lines.append(
                f"  {c.plan.generator:<14} {_algebra.term_of(c.plan)}"
            )
    return "\n".join(lines)


def _explain_pipeline(chosen, cands, op: str, bucket: int,
                      wire: str) -> List[str]:
    """The pipeline-depth panel of ``explain``: the chosen depth, the
    per-chunk stage timeline, and every rejected depth candidate of the
    chosen family with its modeled (or measured, when calibrated) cost —
    the why-this-depth evidence operators asked for."""
    family = [
        c for c in cands
        if c.plan.generator == chosen.plan.generator
        and c.plan.backend == chosen.plan.backend
        and c.plan.op == chosen.plan.op
    ]
    if all(c.plan.pipeline == 1 for c in family):
        return []
    pinned = int(constants.get("plan_pipeline_depth"))
    how = (
        f"pinned (plan_pipeline_depth={pinned})" if pinned > 0
        else "cost model (stage-overlap accounting)"
    )
    lines = ["", f"pipeline: depth {chosen.plan.pipeline} [{how}]"]
    for c in sorted(family, key=lambda c: c.plan.pipeline):
        measured = _cost.calibrated_plan_us(op, bucket, wire,
                                            c.plan.plan_id)
        est = (
            f"{measured:9.1f}us measured" if measured is not None
            else (f"{c.cost_us:9.1f}us modeled" if c.cost_us is not None
                  else "       --")
        )
        mark = "CHOSEN  " if c.plan.plan_id == chosen.plan.plan_id else (
            "ok      " if c.feasible else "rejected"
        )
        reason = f"  ({c.reason})" if c.reason and not c.feasible else ""
        lines.append(f"  {mark} depth {c.plan.pipeline:>2}  {est}{reason}")
    if chosen.plan.pipeline > 1:
        lines.append("  per-chunk stage timeline (us):")
        stages = _cost.pipeline_stage_us(chosen.plan)
        lines.append(
            "    " + ", ".join(
                f"{s}={stages[s]:.1f}" for s in _cost.PIPELINE_STAGES
                if stages.get(s)
            )
        )
        for row in _cost.pipeline_timeline(chosen.plan):
            lines.append(
                f"    chunk {row['chunk']:>2} {row['stage']:<7} "
                f"@{row['start_us']:>9.1f} for {row['us']:.1f}"
            )
    return lines


def _generators_fmt_bytes(n: int) -> str:
    from .ir import _fmt_bytes

    return _fmt_bytes(n)
