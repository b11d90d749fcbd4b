"""Plan generators: every schedule family as a candidate builder.

The legacy router expressed flat / hierarchical / staged / tree as
*code paths* threaded through ``eager.run``'s branch stack. Here each
family is a **generator**: a pure function from ``(op, payload,
topology, wire)`` to a :class:`~.ir.Plan` — a typed step DAG the cost
model can price and the lowerer can bind to the existing executors.
The compiler enumerates ALL generators for a request; infeasible ones
stay in the candidate list with the reason (the ``--explain`` output),
feasible ones are ranked by the analytic cost model, and the
autotuner's measured winners (``tune_plan``) override the analytic
pick per cache key.

Feasibility encodes exactly the contracts the old branches enforced:

- the measured small-message crossover (``small_*_size_*``, autotuned)
  decides fused-XLA vs custom schedules both ways — it IS a cost-model
  term, fed by measurement rather than the analytic alpha/beta;
- ``use_hierarchical_collectives`` enables the composed families;
- a topology whose inter link is declared host-staged
  (``use_staged_collectives``) makes direct inter-island device
  schedules for allreduce infeasible — staging is the only way across;
- cartesian topologies compose peer-to-peer (hier), ragged ones
  root-to-root (tree); a ragged two-level allreduce with hierarchical
  routing on always composes (flat infeasible) — the legacy router
  delegated unconditionally, and keeping flat in play would let the
  cost model silently flip the reduction order. The ragged tree
  *broadcast* generator is new capability: the old router could only
  run ragged broadcasts flat (broadcast moves bytes, no reduction
  order to preserve, so there both stay feasible and cost-modeled).

The **tree** family is no longer hand-written: its plans are derived
from the composition algebra (``schedule.algebra.derive_tree``), with
byte-identical steps and therefore identical plan hashes — the former
``gen_tree`` generator was deleted once the algebra reproduced it.
When ``use_plan_synthesis`` is on, the same algebra's bounded
enumerator contributes **synthesized** candidates (generator names
carry the ``~synth`` marker) the four legacy families cannot express:
recursive-halving RS + recursive-doubling AG for power-of-two axes,
2D torus-axis rings and multi-ring striping for cartesian topologies.

This module is jax-free: candidates can be generated offline.

The port's copy names the hand-written kernel backend ``kernel`` where
the JAX package says ``pallas`` (``collectives/selector.py``); every
family it generates is lowered (``schedule/lower.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

from .. import constants
from . import algebra as _algebra
from . import cost as _cost
from . import pipeline as _pipeline
from .algebra import (  # noqa: F401  (re-exported candidate surface)
    MAX_SYNTH_CANDIDATES,
    SYNTH_GENERATORS,
    SYNTH_OPS,
    is_synthesized,
    synth_family,
)
from .ir import Plan, Step
from .topology import (
    LINK_DCN,
    LINK_HOST,
    LINK_ICI,
    LINK_LOCAL,
    Topology,
)

#: generator (schedule family) names, in presentation order (the
#: synthesized families live in ``SYNTH_GENERATORS``, re-exported from
#: ``schedule.algebra``)
GENERATORS = ("flat", "hier", "staged", "tree")

#: ops the hierarchical cartesian composition covers (legacy hier set)
HIER_OPS = ("allreduce", "broadcast", "reduce", "allgather")

#: ops the ragged tree composition covers (allreduce = legacy binomial;
#: broadcast = new capability the old router could not express)
TREE_OPS = ("allreduce", "broadcast")

#: ops with an autotuned latency-path crossover constant
_CUTOFF_OPS = ("allreduce", "broadcast")

#: ops whose ppermute-ring lowerings accept a pipeline depth (the
#: chunk-pipelined execution dimension; see gen-family docstrings)
PIPELINE_OPS = ("allreduce",)


def pipelined_variant(plan: Plan, depth: int) -> Plan:
    """The depth-``depth`` software-pipelined twin of ``plan``: same
    steps (they describe the full logical volume — the cost model prices
    per-chunk shares), distinct ``plan_id``."""
    return replace(plan, pipeline=int(depth))


def _pipeline_eligible(plan: Plan) -> bool:
    """Whether a plan's executor can thread a pipeline depth: the
    ppermute-ring lowerings of the PIPELINE_OPS families. The Pallas
    RDMA kernels schedule their own multi-buffer DMA pipeline and the
    fused XLA path is a single vendor collective — neither takes an IR
    depth. Synthesized plans whose phases lower to ppermute ring
    segments (the striped and 2D torus-axis families) qualify like any
    ring plan; recursive halving is a log-depth exchange whose lowering
    ignores a chunk depth, so it spawns no twins."""
    if plan.generator == "halve~synth":
        return False
    return plan.op in PIPELINE_OPS and plan.backend == "ring" and (
        not plan.impl or plan.impl == "ring"
    )


def maybe_pin_depth(plan: Plan, nelem: int, itemsize: int) -> Plan:
    """Apply a pinned ``plan_pipeline_depth`` (> 1: the tuned or
    operator-forced depth) to an eligible plan, respecting the per-chunk
    payload floor. Used by the generator-pinning wrappers so a pinned
    family still earns the tuned pipeline."""
    pinned = int(constants.get("plan_pipeline_depth"))
    if pinned <= 1 or not _pipeline_eligible(plan):
        return plan
    nbytes = nelem * itemsize
    if nbytes // pinned < int(constants.get("plan_pipeline_min_chunk_bytes")):
        return plan
    return pipelined_variant(plan, pinned)


def wire_bytes(nelem: int, itemsize: int, wire: str) -> int:
    """On-wire bytes for ``nelem`` elements under a wire encoding — the
    same accounting model as ``primitives.wire_encoded_bytes`` (int8
    payload padded to whole blocks + one f32 scale per block), kept
    jax-free here so offline planning never imports a backend."""
    if wire == "int8":
        block = int(constants.get("wire_quant_block_size"))
        nblocks = -(-max(1, nelem) // block)
        return nblocks * block + nblocks * 4
    if wire == "bf16":
        return nelem * 2
    return nelem * itemsize


@dataclass
class Candidate:
    """One generated plan with its verdict: priced when feasible,
    carrying the gate reason when not. ``structural`` says whether the
    *topology alone* permits the plan — pinned generators (the thin
    ``run_hierarchical_*`` wrappers) bypass policy gates but never
    structural impossibility."""

    plan: Plan
    cost_us: Optional[float]
    feasible: bool
    reason: str = ""
    structural: bool = True
    chosen: bool = False


# ---------------------------------------------------------------------------
# step-sequence builders (aggregated: one Step per phase, count = hops)
# ---------------------------------------------------------------------------


def _ring_allreduce_steps(m: int, nelem: int, itemsize: int, level: str,
                          wire: str, note: str = "") -> Tuple[Step, ...]:
    """Chunked ring allreduce over an axis of ``m`` ranks: (m-1)
    reduce-scatter hops + (m-1) allgather hops of ``nelem/m`` elements,
    quantized per hop when a wire encoding engages."""
    if m <= 1:
        return ()
    chunk = max(1, nelem // m)
    full = chunk * itemsize
    enc = wire_bytes(chunk, itemsize, wire)
    hops = 2 * (m - 1)
    steps: List[Step] = []
    if wire != "full":
        steps.append(Step("quantize", LINK_LOCAL, full, hops, note))
    steps.append(Step("send", level, enc, hops, note))
    steps.append(Step("recv", level, enc, hops, note))
    if wire != "full":
        steps.append(Step("dequantize", LINK_LOCAL, full, hops, note))
    steps.append(Step("local_reduce", LINK_LOCAL, full, m - 1, note))
    return tuple(steps)


def _reduce_steps(m: int, nelem: int, itemsize: int, level: str,
                  note: str = "") -> Tuple[Step, ...]:
    if m <= 1:
        return ()
    chunk = max(1, nelem // m)
    return (
        Step("send", level, chunk * itemsize, m - 1, note),
        Step("recv", level, chunk * itemsize, m - 1, note),
        Step("local_reduce", LINK_LOCAL, chunk * itemsize, m - 1, note),
    )


def _allgather_steps(m: int, nelem: int, itemsize: int, level: str,
                     note: str = "") -> Tuple[Step, ...]:
    """(m-1)-step forwarding ring, each hop moving one rank-block."""
    if m <= 1:
        return ()
    nbytes = nelem * itemsize
    return (
        Step("send", level, nbytes, m - 1, note),
        Step("recv", level, nbytes, m - 1, note),
    )


def _reducescatter_steps(m: int, nelem: int, itemsize: int, level: str,
                         wire: str, note: str = "") -> Tuple[Step, ...]:
    if m <= 1:
        return ()
    chunk = max(1, nelem // m)
    enc = wire_bytes(chunk, itemsize, wire)
    steps: List[Step] = []
    if wire != "full":
        steps.append(Step("quantize", LINK_LOCAL, chunk * itemsize, m - 1,
                          note))
    steps.append(Step("send", level, enc, m - 1, note))
    steps.append(Step("recv", level, enc, m - 1, note))
    if wire != "full":
        steps.append(Step("dequantize", LINK_LOCAL, chunk * itemsize,
                          m - 1, note))
    steps.append(Step("local_reduce", LINK_LOCAL, chunk * itemsize, m - 1,
                      note))
    return tuple(steps)


# ---------------------------------------------------------------------------
# per-generator plan builders
# ---------------------------------------------------------------------------


def _worst_level(topo: Topology) -> str:
    """The link class a FLAT schedule's hops ride: a multi-island
    topology's flat ring crosses island boundaries, so its steps pay
    the inter fabric — the locality cost the composed schedules avoid
    (the whole point of HiCCL-style hierarchical composition)."""
    return LINK_DCN if topo.has_inter else LINK_ICI


def _broadcast_phase(m: int, nelem: int, itemsize: int, level: str,
                     platform: str, note: str = "") -> Tuple[Step, ...]:
    if m <= 1:
        return ()
    nbytes = nelem * itemsize
    suffix = constants.platform_suffix(platform)
    if nbytes <= constants.get(f"broadcast_size_tree_based_{suffix}"):
        depth = max(1, math.ceil(math.log2(m)))
        return (
            Step("send", level, nbytes, depth, note or "binomial tree"),
            Step("recv", level, nbytes, depth, note or "binomial tree"),
        )
    maxb = constants.get(f"max_buffer_size_{suffix}")
    minb = constants.get(f"min_buffer_size_{suffix}")
    k = max(1, -(-nbytes // max(1, maxb)))
    k = min(k, max(1, nbytes // max(1, minb)))
    hops = (m - 1) + (k - 1)
    return (
        Step("send", level, max(1, nbytes // k), hops,
             note or f"pipelined ring, {k} chunk(s)"),
        Step("recv", level, max(1, nbytes // k), hops,
             note or f"pipelined ring, {k} chunk(s)"),
    )


def gen_flat(op: str, nelem: int, itemsize: int, topo: Topology,
             backend: str, wire: str) -> Plan:
    """One collective over the whole communicator, island boundaries
    ignored — the legacy terminal path for every backend."""
    p = topo.size
    level = _worst_level(topo)
    if op == "allreduce":
        steps = _ring_allreduce_steps(p, nelem, itemsize, level, wire)
    elif op == "broadcast":
        steps = _broadcast_phase(p, nelem, itemsize, level, topo.platform)
    elif op == "reduce":
        steps = _reduce_steps(p, nelem, itemsize, level)
    elif op == "allgather":
        steps = _allgather_steps(p, nelem, itemsize, level)
    elif op == "reducescatter":
        steps = _reducescatter_steps(p, nelem, itemsize, level, wire)
    elif op == "alltoall":
        chunk = max(1, nelem // max(1, p))
        steps = (
            Step("send", level, chunk * itemsize, p - 1),
            Step("recv", level, chunk * itemsize, p - 1),
        )
    elif op == "sendreceive":
        steps = (
            Step("send", level, nelem * itemsize, 1),
            Step("recv", level, nelem * itemsize, 1),
        )
    else:
        steps = (Step("send", level, nelem * itemsize, 1),)
    return Plan(
        op=op, generator="flat", backend=backend, wire=wire,
        topology_fp=topo.fingerprint(), steps=steps,
    )


def gen_hier(op: str, nelem: int, itemsize: int, topo: Topology,
             backend: str, wire: str) -> Plan:
    """Two-level cartesian composition: intra phase on the ICI islands,
    inter phase peer-to-peer across them (the cartesian shortcut — no
    trailing intra broadcast)."""
    s = topo.intra_size()
    b = topo.num_groups
    if op == "allreduce":
        steps = (
            _ring_allreduce_steps(s, nelem, itemsize, LINK_ICI, wire,
                                  "intra ring")
            + _ring_allreduce_steps(b, nelem, itemsize, LINK_DCN, wire,
                                    "inter ring")
        )
    elif op == "broadcast":
        steps = (
            _broadcast_phase(b, nelem, itemsize, LINK_DCN, topo.platform,
                             "inter phase")
            + _broadcast_phase(s, nelem, itemsize, LINK_ICI, topo.platform,
                               "intra phase")
        )
    elif op == "reduce":
        steps = (
            _reduce_steps(s, nelem, itemsize, LINK_ICI, "intra phase")
            + _reduce_steps(b, nelem, itemsize, LINK_DCN, "inter phase")
        )
    else:  # allgather
        steps = (
            _allgather_steps(s, nelem, itemsize, LINK_ICI, "intra phase")
            + _allgather_steps(b, nelem * s, itemsize, LINK_DCN,
                               "inter phase")
        )
    return Plan(
        op=op, generator="hier", backend=backend, wire=wire, impl=backend,
        topology_fp=topo.fingerprint(), steps=steps,
    )


def gen_staged(op: str, nelem: int, itemsize: int, topo: Topology,
               backend: str, wire: str) -> Plan:
    """Intra device ring + host-staged inter reduction (the no-GDR
    path): group partials meet in host memory over the PS socket
    transport, the total is pushed back to every rank."""
    s = topo.intra_size()
    b = topo.num_groups
    nbytes = nelem * itemsize
    steps = _ring_allreduce_steps(
        s, nelem, itemsize, LINK_ICI, wire, "intra ring"
    ) + (
        Step("send", LINK_HOST, nbytes, 1, "device->host group partial"),
        Step("reduce", LINK_HOST, nbytes, max(1, b - 1),
             "host partial exchange + sum"),
        Step("recv", LINK_HOST, nbytes, 1, "host->device total"),
    )
    return Plan(
        op=op, generator="staged", backend=backend, wire=wire, impl=backend,
        topology_fp=topo.fingerprint(), steps=steps,
        meta=(("dispatches", 3),),
    )


def gen_tree_derived(op: str, nelem: int, itemsize: int, topo: Topology,
                     backend: str, wire: str) -> Plan:
    """Ragged (non-cartesian) composition over group roots — DERIVED
    from the composition algebra, not hand-written.

    The former ``gen_tree`` generator was deleted once
    ``algebra.derive_tree`` reproduced its step sequences byte-for-byte
    (same notes, counts, byte totals, order, empty meta), so the plan
    hashes on its old selection cells — and with them every persisted
    calibration row and executable-cache key — are unchanged. The
    composition: allreduce = binomial intra reduce ; binomial roots
    reduce ; one-hop gather broadcast of the total (the legacy
    ``run_tree_hierarchical_allreduce``); broadcast = binomial inter
    fan-out ; group-root gather within every island."""
    return _algebra.derive_tree(op, nelem, itemsize, topo, backend, wire)


# ---------------------------------------------------------------------------
# candidate enumeration with feasibility verdicts
# ---------------------------------------------------------------------------


def candidate_plans(
    op: str,
    nelem: int,
    itemsize: int,
    topo: Topology,
    backend: str,
    wire: str = "full",
    route_small: bool = True,
) -> List[Candidate]:
    """Every generator's plan for this request, priced and gated.

    ``backend`` is the *effective* requested backend ('xla' or the
    custom ring/kernel choice, dtype gates already applied). The gates
    reproduce the legacy router's contracts exactly — see the module
    docstring — so default selection is behavior-compatible while the
    candidate list (the explain/tune surface) always shows the whole
    space."""
    custom = backend in ("ring", "kernel")
    suffix = constants.platform_suffix(topo.platform)
    small = False
    if custom and route_small and op in _CUTOFF_OPS:
        small = nelem <= constants.get(f"small_{op}_size_{suffix}")
    hier_on = bool(constants.get("use_hierarchical_collectives"))
    out: List[Candidate] = []

    def add(plan: Plan, feasible: bool, reason: str = "",
            structural: bool = True) -> None:
        cost = _cost.estimate_us(plan) if plan.steps or feasible else None
        out.append(Candidate(
            plan=plan, cost_us=cost, feasible=feasible, reason=reason,
            structural=structural,
        ))

    # flat xla — the latency path
    xla_plan = gen_flat(op, nelem, itemsize, topo, "xla", "full")
    if not custom:
        add(xla_plan, True)
    elif not route_small:
        add(xla_plan, False,
            "backend pinned by caller (route_small=False)")
    elif small:
        add(xla_plan, True,
            "below the measured XLA crossover "
            f"(small_{op}_size_{suffix}, autotuned)")
    else:
        add(xla_plan, False,
            "custom backend requested "
            + (f"above the measured XLA crossover "
               f"(small_{op}_size_{suffix})" if op in _CUTOFF_OPS else ""))

    # flat custom
    flat_plan = gen_flat(op, nelem, itemsize, topo, backend if custom
                         else "ring", wire)
    if not custom:
        add(flat_plan, False, "xla backend requested")
    elif small:
        add(flat_plan, False,
            f"below the measured XLA crossover (small_{op}_size_{suffix}: "
            "latency path wins, autotuned)")
    elif (op == "allreduce" and topo.staged_inter and hier_on
          and route_small and topo.two_level):
        add(flat_plan, False,
            "inter link declared host-staged (use_staged_collectives): "
            "no direct cross-island device schedule")
    elif (op == "allreduce" and hier_on and route_small
          and topo.two_level and not topo.cartesian):
        # the legacy router delegated EVERY large ragged allreduce to
        # the tree composition; keeping flat feasible would let the
        # cost model silently flip the reduction order on real
        # deployments (behavior-compat contract)
        add(flat_plan, False,
            "ragged two-level topology with hierarchical routing on: "
            "allreduce delegates to the tree composition "
            "(collectives_cuda.cpp:546-581)")
    else:
        add(flat_plan, True)

    # hier (two-level cartesian composition)
    if op in HIER_OPS:
        hier_plan = gen_hier(op, nelem, itemsize, topo,
                             backend if custom else "ring", wire)
        structural = topo.two_level and topo.cartesian
        if not structural:
            add(hier_plan, False,
                "needs a cartesian two-level topology", structural=False)
        elif not custom:
            add(hier_plan, False, "xla backend requested")
        elif not route_small:
            add(hier_plan, False,
                "backend pinned by caller (route_small=False)")
        elif not hier_on:
            add(hier_plan, False, "use_hierarchical_collectives is off")
        elif small:
            add(hier_plan, False,
                "below the measured XLA crossover (latency path)")
        elif op == "allreduce" and topo.staged_inter:
            add(hier_plan, False,
                "inter link declared host-staged: staged schedule "
                "replaces the direct inter ring")
        else:
            add(hier_plan, True)

    # staged (host-staged inter allreduce)
    if op == "allreduce":
        staged_plan = gen_staged(op, nelem, itemsize, topo,
                                 backend if custom else "ring", wire)
        structural = topo.two_level and topo.cartesian
        if not structural:
            add(staged_plan, False,
                "needs a cartesian two-level topology", structural=False)
        elif not custom:
            add(staged_plan, False, "xla backend requested")
        elif not route_small:
            add(staged_plan, False,
                "backend pinned by caller (route_small=False)")
        elif not hier_on:
            add(staged_plan, False, "use_hierarchical_collectives is off")
        elif small:
            add(staged_plan, False,
                "below the measured XLA crossover (latency path)")
        elif not topo.staged_inter:
            add(staged_plan, False, "use_staged_collectives is off")
        else:
            add(staged_plan, True)

    # tree (ragged/non-cartesian composition, algebra-derived)
    if op in TREE_OPS:
        tree_plan = gen_tree_derived(op, nelem, itemsize, topo,
                                     backend if custom else "ring", wire)
        structural = topo.two_level and not topo.cartesian
        if not structural:
            add(tree_plan, False,
                "needs a ragged (non-cartesian) two-level topology",
                structural=False)
        elif not custom:
            add(tree_plan, False, "xla backend requested")
        elif not route_small:
            add(tree_plan, False,
                "backend pinned by caller (route_small=False)")
        elif not hier_on:
            add(tree_plan, False, "use_hierarchical_collectives is off")
        elif small:
            add(tree_plan, False,
                "below the measured XLA crossover (latency path)")
        else:
            add(tree_plan, True)

    # synthesized families: the composition algebra's bounded enumerator
    # (opt-in via use_plan_synthesis). Only structurally-admitted plans
    # come back — at most MAX_SYNTH_CANDIDATES, O(candidates) in world
    # size — then the same policy gates the legacy families honor apply.
    # Deliberately NOT gated on route_small: a caller pinning the
    # backend (simfleet's route_small=False pricing path) still races
    # the synthesized schedules against flat — the knob is the opt-in.
    if op in SYNTH_OPS and bool(constants.get("use_plan_synthesis")):
        for synth_plan in _algebra.synthesize(
                op, nelem, itemsize, topo, backend if custom else "ring",
                wire):
            if not custom:
                add(synth_plan, False, "xla backend requested")
            elif small:
                add(synth_plan, False,
                    "below the measured XLA crossover (latency path)")
            elif op == "allreduce" and topo.staged_inter and hier_on \
                    and topo.two_level:
                add(synth_plan, False,
                    "inter link declared host-staged: no direct "
                    "cross-island device schedule")
            elif (synth_plan.generator == "halve~synth" and hier_on
                  and topo.two_level and not topo.cartesian):
                add(synth_plan, False,
                    "ragged two-level topology with hierarchical routing "
                    "on: allreduce reduction order delegates to the tree "
                    "composition")
            else:
                add(synth_plan, True)

    # chunk-pipelined variants: every feasible ppermute-ring candidate of
    # a PIPELINE_OPS family spawns depth-d twins (same steps, the cost
    # model prices per-chunk stage overlap). plan_pipeline_depth pins one
    # depth (1 = pipelining tuned off); 0 lets the model race the depths.
    if op in PIPELINE_OPS:
        nbytes = nelem * itemsize
        pinned = int(constants.get("plan_pipeline_depth"))
        min_chunk = int(constants.get("plan_pipeline_min_chunk_bytes"))
        if pinned > 1:
            depths = [pinned]
        elif pinned == 1:
            depths = []
        else:
            depths = _pipeline.depth_candidates(nbytes)
        for base in [c for c in out
                     if c.feasible and _pipeline_eligible(c.plan)]:
            for d in depths:
                variant = pipelined_variant(base.plan, d)
                if nbytes // d < min_chunk:
                    add(variant, False,
                        f"chunks below plan_pipeline_min_chunk_bytes "
                        f"({min_chunk}B) at depth {d}")
                else:
                    add(variant, True)

    return out
