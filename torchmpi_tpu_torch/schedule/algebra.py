"""Composition algebra: derive collective schedules instead of typing them.

The four legacy generators (flat / hier / staged / tree) are hand-written
schedules. HiCCL (PAPERS.md) shows that expressing a collective as a
*composition* of a few typed combinators over the declared machine
hierarchy lets the candidate set be **derived** — recursive halving for
power-of-two axes, striping across independent fabrics, torus-axis rings
— and GC3 makes the same argument from the compiler side. This module is
that algebra for the plan compiler:

- **Terms** are typed combinators over a :class:`~.topology.Topology`:
  :func:`seq`, :func:`stripe`, :func:`halve`, :func:`ring`,
  :func:`tree`, :func:`scatter`, :func:`gather`, :func:`fence`. Each
  term threads a payload state (elements per rank) and *compiles down to
  the existing plan-IR steps* (send/recv/quantize/...), so lowering,
  executable-cache keys, pipeline-depth twins and the flight-recorder
  ``plan_id`` discipline are all inherited unchanged.
- :func:`derive_tree` re-derives the deleted ``gen_tree`` generator as
  an algebra term with **byte-identical steps** — same plan hashes on
  its old selection cells, so persisted calibrations and executable
  caches stay valid (the proof the algebra subsumes the hand-written
  family).
- :func:`synthesize` is the bounded enumerator: per (op, topology,
  payload, wire) it derives at most :data:`MAX_SYNTH_CANDIDATES` plans
  the legacy families cannot express, each carrying its rendered term in
  plan ``meta`` (the ``--explain`` derivation panel) and a generator
  name ending in the stable ``~synth`` marker (documented in PARITY so
  desync diffs name synthesized plans).

Like the rest of the planning layer this module is jax-free: terms are
built, compiled and priced offline. The executors behind the synthesized
families live in ``schedule.lower`` (ppermute compositions, same
primitives as the legacy lowerings).

Payload-state typing: a term maps ``nelem`` (elements each rank holds of
the logical vector) to a new ``nelem`` — ``scatter``/``halve.rs`` shrink
it by the axis size, ``gather``/``halve.ag`` grow it back, ``ring`` and
``tree`` preserve it. ``seq`` composes; ``stripe`` splits the payload
across k concurrent sub-terms and its cost is the critical (max-priced)
stripe, which is also the step sequence the Plan carries.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

from . import cost as _cost
from .ir import Plan, Step
from .topology import LINK_DCN, LINK_ICI, LINK_LOCAL, Topology

#: generator names of the synthesized families. The ``~synth`` suffix is
#: the stable marker plan_ids carry (generator is the plan_id prefix) —
#: the PARITY-documented way desync diffs and flight dumps name a
#: synthesized plan.
SYNTH_GENERATORS = ("halve~synth", "stripe~synth", "torus~synth")

#: ops the enumerator derives candidates for
SYNTH_OPS = ("allreduce",)

#: hard cap on plans :func:`synthesize` returns for one request — the
#: enumerator is O(candidates), never O(world size)
MAX_SYNTH_CANDIDATES = 4


def is_synthesized(generator: str) -> bool:
    """Whether a generator name denotes an algebra-synthesized family."""
    return generator.endswith("~synth")


def synth_family(generator: str) -> str:
    """Telemetry label: 'halve~synth' -> 'halve'."""
    return generator.split("~", 1)[0]


# ---------------------------------------------------------------------------
# terms
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Ctx:
    """Payload state a term compiles against: ``nelem`` is the elements
    each rank currently holds of the logical vector (scatter/halve
    shrink it, gather grows it)."""

    op: str
    nelem: int
    itemsize: int
    topo: Topology
    wire: str

    def with_nelem(self, nelem: int) -> "Ctx":
        return Ctx(self.op, max(1, int(nelem)), self.itemsize, self.topo,
                   self.wire)


def _axis_size(topo: Topology, axis: str) -> int:
    if axis == "intra":
        return topo.intra_size()
    if axis == "inter":
        return topo.num_groups
    return topo.size  # flat


def _axis_level(topo: Topology, axis: str) -> str:
    if axis == "intra":
        return LINK_ICI
    if axis == "inter":
        return LINK_DCN
    # a flat-axis schedule's hops ride the worst fabric they cross
    return LINK_DCN if topo.has_inter else LINK_ICI


def _wire_bytes(nelem: int, itemsize: int, wire: str) -> int:
    from . import generators as _gen  # lazy: generators imports algebra

    return _gen.wire_bytes(nelem, itemsize, wire)


class Term:
    """Base combinator: ``render()`` is the human-readable derivation
    (the ``--explain`` panel), ``compile(ctx)`` lowers to plan-IR steps
    and threads the payload state."""

    def render(self) -> str:
        raise NotImplementedError

    def compile(self, ctx: Ctx) -> Tuple[Tuple[Step, ...], Ctx]:
        raise NotImplementedError


@dataclass(frozen=True)
class _Seq(Term):
    parts: Tuple[Term, ...]

    def render(self) -> str:
        return "[" + " ; ".join(p.render() for p in self.parts) + "]"

    def compile(self, ctx: Ctx) -> Tuple[Tuple[Step, ...], Ctx]:
        steps: List[Step] = []
        for part in self.parts:
            got, ctx = part.compile(ctx)
            steps.extend(got)
        return tuple(steps), ctx


@dataclass(frozen=True)
class _Stripe(Term):
    """k concurrent sub-schedules over disjoint 1/k payload slices —
    multi-ring striping across independent fabrics. The compiled steps
    are the CRITICAL stripe's (the max-priced one): stripes run
    concurrently, so the modeled cost is the slowest chain, not the sum
    (the invariant the PARITY contract table documents)."""

    parts: Tuple[Term, ...]

    def render(self) -> str:
        k = len(self.parts)
        return f"stripe({k})∘[" + " || ".join(
            p.render() for p in self.parts
        ) + "]"

    def compile(self, ctx: Ctx) -> Tuple[Tuple[Step, ...], Ctx]:
        k = max(1, len(self.parts))
        share = ctx.with_nelem(-(-ctx.nelem // k))
        best: Tuple[Step, ...] = ()
        best_us = -1.0
        for part in self.parts:
            got, _ = part.compile(share)
            us = _cost.serial_steps_us(got)
            if us > best_us:
                best, best_us = got, us
        return best, ctx


@dataclass(frozen=True)
class _Ring(Term):
    """One ring phase over a topology axis: 'ar' = allreduce (RS+AG
    hops), 'rs' = reduce-scatter (shrinks the payload state by the axis
    size), 'ag' = allgather (grows it back)."""

    axis: str
    phase: str = "ar"

    def render(self) -> str:
        if self.phase == "rs":
            return f"scatter.ring({self.axis})"
        if self.phase == "ag":
            return f"gather.ring({self.axis})"
        return f"ring({self.axis})"

    def compile(self, ctx: Ctx) -> Tuple[Tuple[Step, ...], Ctx]:
        from . import generators as _gen

        m = _axis_size(ctx.topo, self.axis)
        level = _axis_level(ctx.topo, self.axis)
        note = self.render()
        if self.phase == "rs":
            steps = _gen._reducescatter_steps(
                m, ctx.nelem, ctx.itemsize, level, ctx.wire, note)
            return steps, ctx.with_nelem(ctx.nelem // max(1, m))
        if self.phase == "ag":
            steps = _gen._allgather_steps(
                m, ctx.nelem, ctx.itemsize, level, note)
            return steps, ctx.with_nelem(ctx.nelem * max(1, m))
        steps = _gen._ring_allreduce_steps(
            m, ctx.nelem, ctx.itemsize, level, ctx.wire, note)
        return steps, ctx


@dataclass(frozen=True)
class _Halve(Term):
    """Recursive halving ('rs') / recursive doubling ('ag') over the
    flat axis — O(log p) latency terms vs the ring's p-1 hops, the
    classic bandwidth-optimal exchange for power-of-two axes. Round k of
    the RS phase exchanges 1/2^k of the payload with the rank distance
    p/2^k away; the AG phase runs the same sizes in reverse."""

    phase: str  # 'rs' | 'ag'

    def render(self) -> str:
        return f"halve.{self.phase}"

    def compile(self, ctx: Ctx) -> Tuple[Tuple[Step, ...], Ctx]:
        p = ctx.topo.size
        rounds = max(0, p.bit_length() - 1)
        level = _axis_level(ctx.topo, "flat")
        steps: List[Step] = []
        if self.phase == "rs":
            base = ctx.nelem
            for k in range(1, rounds + 1):
                seg = max(1, base >> k)
                self._exchange(steps, seg, ctx, level,
                               f"halving round {k}: 1/{1 << k} payload",
                               reduce=True)
            return tuple(steps), ctx.with_nelem(max(1, base >> rounds))
        base = ctx.nelem
        for k in range(rounds, 0, -1):
            seg = max(1, (base << rounds) >> k)
            self._exchange(steps, seg, ctx, level,
                           f"doubling round {rounds - k + 1}: "
                           f"1/{1 << k} payload",
                           reduce=False)
        return tuple(steps), ctx.with_nelem(base << rounds)

    @staticmethod
    def _exchange(steps: List[Step], seg: int, ctx: Ctx, level: str,
                  note: str, reduce: bool) -> None:
        full = seg * ctx.itemsize
        enc = _wire_bytes(seg, ctx.itemsize, ctx.wire)
        if ctx.wire != "full":
            steps.append(Step("quantize", LINK_LOCAL, full, 1, note))
        steps.append(Step("send", level, enc, 1, note))
        steps.append(Step("recv", level, enc, 1, note))
        if ctx.wire != "full":
            steps.append(Step("dequantize", LINK_LOCAL, full, 1, note))
        if reduce:
            steps.append(Step("local_reduce", LINK_LOCAL, full, 1, note))


@dataclass(frozen=True)
class _Tree(Term):
    """Binomial tree over a topology axis: 'reduce' = log2(axis) rounds
    of full-vector exchange + accumulate (the legacy gen_tree phases),
    'fanout' = root pushes the block down a binomial tree."""

    axis: str
    kind: str = "reduce"  # 'reduce' | 'fanout'

    def render(self) -> str:
        return f"tree.{self.kind}({self.axis})"

    def compile(self, ctx: Ctx) -> Tuple[Tuple[Step, ...], Ctx]:
        m = _axis_size(ctx.topo, self.axis)
        level = _axis_level(ctx.topo, self.axis)
        nbytes = ctx.nelem * ctx.itemsize
        if self.kind == "fanout":
            depth = max(1, math.ceil(math.log2(max(1, m))))
            return (Step("send", level, nbytes, depth,
                         "binomial fan-out root -> group roots"),), ctx
        depth = max(0, math.ceil(math.log2(max(1, m))))
        if not depth:
            return (), ctx
        note = ("binomial intra reduce" if self.axis == "intra"
                else "binomial roots reduce")
        enc = _wire_bytes(ctx.nelem, ctx.itemsize, ctx.wire)
        steps: List[Step] = []
        if ctx.wire != "full":
            steps.append(Step("quantize", LINK_LOCAL, nbytes, depth, note))
        steps.append(Step("send", level, enc, depth, note))
        steps.append(Step("recv", level, enc, depth, note))
        if ctx.wire != "full":
            steps.append(Step("dequantize", LINK_LOCAL, nbytes, depth,
                              note))
        steps.append(Step("local_reduce", LINK_LOCAL, nbytes, depth, note))
        return tuple(steps), ctx


@dataclass(frozen=True)
class _Hop(Term):
    """A single full-vector hop on one link level — the scatter/gather
    terminal moves of the tree compositions (one-hop total broadcast,
    island-root gather)."""

    level: str
    note: str

    def render(self) -> str:
        return f"gather({self.note.split()[0]})"

    def compile(self, ctx: Ctx) -> Tuple[Tuple[Step, ...], Ctx]:
        return (Step("send", self.level, ctx.nelem * ctx.itemsize, 1,
                     self.note),), ctx


@dataclass(frozen=True)
class _Fence(Term):
    """Pure ordering barrier between phases: compiles to no steps (the
    executors' SPMD program order already serializes phases); kept as a
    combinator so terms can state the dependency explicitly."""

    def render(self) -> str:
        return "fence"

    def compile(self, ctx: Ctx) -> Tuple[Tuple[Step, ...], Ctx]:
        return (), ctx


# ---------------------------------------------------------------------------
# combinator constructors (the public term-building surface)
# ---------------------------------------------------------------------------


def seq(*parts: Term) -> Term:
    """Sequential composition: run parts in order, payload state threads
    through."""
    return _Seq(tuple(parts))


def stripe(*parts: Term) -> Term:
    """Concurrent composition over ``k = len(parts)`` disjoint payload
    stripes (each part sees 1/k of the payload)."""
    return _Stripe(tuple(parts))


def ring(axis: str, phase: str = "ar") -> Term:
    """Ring phase over ``axis`` ('intra' | 'inter' | 'flat')."""
    return _Ring(axis, phase)


def halve(phase: str) -> Term:
    """Recursive halving ('rs') / doubling ('ag') over the flat axis."""
    return _Halve(phase)


def tree(axis: str, kind: str = "reduce") -> Term:
    """Binomial tree ('reduce' or 'fanout') over ``axis``."""
    return _Tree(axis, kind)


def scatter(axis: str) -> Term:
    """Reduce-scatter over ``axis`` (ring schedule): payload shrinks by
    the axis size."""
    return _Ring(axis, "rs")


def gather(axis: str) -> Term:
    """Allgather over ``axis`` (ring schedule): payload grows by the
    axis size."""
    return _Ring(axis, "ag")


def fence() -> Term:
    return _Fence()


# ---------------------------------------------------------------------------
# gen_tree, re-derived (the deleted legacy generator as an algebra term)
# ---------------------------------------------------------------------------


def tree_term(op: str, topo: Topology) -> Term:
    """The legacy tree composition as an algebra term. allreduce:
    binomial intra reduce, binomial roots reduce, one-hop gather
    broadcast of the total. broadcast: binomial inter fan-out + a
    group-root gather within every island."""
    if op == "allreduce":
        return seq(
            tree("intra", "reduce"),
            tree("inter", "reduce"),
            fence(),
            _Hop(LINK_DCN, "one-hop gather broadcast of the total"),
        )
    return seq(
        tree("inter", "fanout"),
        _Hop(LINK_ICI, "group-root gather within every island"),
    )


def derive_tree(op: str, nelem: int, itemsize: int, topo: Topology,
                backend: str, wire: str) -> Plan:
    """Build the tree-family plan by compiling :func:`tree_term`.

    This IS the former ``generators.gen_tree``: the compiled steps are
    byte-identical to the hand-written generator's (same notes, counts,
    byte totals, order), the generator name stays ``"tree"`` and
    ``meta`` stays empty — so the plan hashes on its old selection cells
    are unchanged and persisted calibrations / executable-cache keys
    remain valid (the gen_tree-parity test pins this)."""
    ctx = Ctx(op, nelem, itemsize, topo, wire)
    steps, _ = tree_term(op, topo).compile(ctx)
    return Plan(
        op=op, generator="tree", backend=backend, wire=wire, impl=backend,
        topology_fp=topo.fingerprint(), steps=steps,
    )


# ---------------------------------------------------------------------------
# the bounded enumerator
# ---------------------------------------------------------------------------


def _term_plan(term: Term, generator: str, ctx: Ctx, backend: str,
               extra_meta: Tuple = ()) -> Plan:
    steps, _ = term.compile(ctx)
    meta = tuple(sorted(extra_meta + (("term", term.render()),)))
    return Plan(
        op=ctx.op, generator=generator, backend=backend, wire=ctx.wire,
        impl=backend, topology_fp=ctx.topo.fingerprint(), steps=steps,
        meta=meta,
    )


def synthesize(op: str, nelem: int, itemsize: int, topo: Topology,
               backend: str, wire: str) -> List[Plan]:
    """Derive the synthesized candidate set for one request: at most
    :data:`MAX_SYNTH_CANDIDATES` plans, deterministic per topology
    fingerprint, O(candidates) regardless of world size. Structural
    admission only (power-of-two axis, cartesian two-level); the policy
    gates (knob, crossover, backend) live in
    ``generators.candidate_plans`` like every legacy family's."""
    if op not in SYNTH_OPS:
        return []
    ctx = Ctx(op, nelem, itemsize, topo, wire)
    out: List[Plan] = []
    p = topo.size
    if p >= 4 and (p & (p - 1)) == 0:
        # recursive-halving RS + recursive-doubling AG: O(log p) hops
        out.append(_term_plan(
            seq(halve("rs"), halve("ag")), "halve~synth", ctx, backend))
    if topo.two_level and topo.cartesian and topo.intra_size() >= 2:
        # 2D torus-axis schedule: scatter on the fast axis, ring the 1/s
        # shard across the slow axis, gather back — inter bytes / s
        out.append(_term_plan(
            seq(scatter("intra"), ring("inter"), gather("intra")),
            "torus~synth", ctx, backend))
        # multi-ring striping: two payload halves run the two fabrics in
        # opposite phase order, so both are busy the whole time
        out.append(_term_plan(
            stripe(seq(ring("intra"), ring("inter")),
                   seq(ring("inter"), ring("intra"))),
            "stripe~synth", ctx, backend,
            extra_meta=(("stripes", 2),)))
    return out[:MAX_SYNTH_CANDIDATES]


def derive_synth(generator: str, op: str, nelem: int, itemsize: int,
                 topo: Topology, backend: str, wire: str) -> Optional[Plan]:
    """The pin surface: the synthesized plan for ``generator`` on this
    request, or None when the topology structurally cannot express it
    (mirrors the legacy generators' pinned structural checks)."""
    for plan in synthesize(op, nelem, itemsize, topo, backend, wire):
        if plan.generator == generator:
            return plan
    return None


def term_of(plan: Plan) -> str:
    """The rendered derivation a synthesized plan carries in ``meta``
    (empty for legacy plans) — the ``--explain`` derivation panel."""
    return dict(plan.meta).get("term", "")
