"""Plan IR: a collective request compiled to a typed step DAG.

A :class:`Plan` is the compiler's unit of decision — *which* schedule a
collective request ``(op, payload, dtype, topology)`` runs, expressed as
a sequence of typed :class:`Step`s against the declared
:class:`~.topology.Topology`. The step vocabulary is deliberately small
(the GC3 framing, PAPERS.md: a collective is a *program*, not a code
path):

======================  ====================================================
step kind               meaning
======================  ====================================================
``send`` / ``recv``     one hop's worth of bytes onto / off a link level
``local_reduce``        on-device accumulate of a received partial
``reduce``              off-device (host) reduction of staged partials
``quantize``            encode to the wire dtype before a hop
``dequantize``          decode (f32 accumulate) after a hop
``pack`` / ``unpack``   gather tensors into / out of a fused flat buffer
======================  ====================================================

Steps are *aggregated*: a ring phase of ``p-1`` identical hops is ONE
Step with ``count=p-1``, so plans stay O(phases), not O(world size), and
the cost model is a dot product. Plans are frozen and hash to a stable
``plan_id`` — the identity that flight-recorder entries, spans, the plan
cache, and the autotuner's persisted winners all share.

This module is dependency-free (no jax): plans can be built, costed and
compared offline (the ``--explain`` CLI path).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Tuple

STEP_KINDS = (
    "send", "recv", "reduce", "quantize", "dequantize",
    "pack", "unpack", "local_reduce",
)


@dataclass(frozen=True)
class Step:
    """One aggregated phase of a plan.

    ``bytes`` is the per-rank byte count each of the ``count``
    occurrences moves (send/recv) or processes (quantize/pack/reduce),
    already in WIRE terms for transport steps (a quantized hop's Step
    carries the encoded size). ``level`` names the link class the cost
    model prices (:mod:`.topology` LINK_*)."""

    kind: str
    level: str
    bytes: int
    count: int = 1
    note: str = ""

    def __post_init__(self):
        if self.kind not in STEP_KINDS:
            raise ValueError(f"unknown step kind {self.kind!r}")


@dataclass(frozen=True)
class Plan:
    """A compiled schedule: the decision artifact the plan cache stores.

    ``generator`` names the schedule family: a hand-written one ('flat'
    | 'hier' | 'staged' | 'tree') or an algebra-synthesized one whose
    name carries the stable ``~synth`` marker ('halve~synth' |
    'stripe~synth' | 'torus~synth') — since the generator is the
    ``plan_id`` prefix, flight dumps and desync diffs name synthesized
    plans by that marker (documented in PARITY). ``backend`` is the
    executor the plan lowers onto ('xla' | 'ring' | 'kernel'); ``impl``
    the intra-phase executor for composed schedules (the legacy
    ``impl=`` / ``staged_intra=`` / ``ring_impl=`` escape hatches, now
    plan attributes instead of kwargs). ``meta`` is a sorted kv-tuple of
    lowering parameters that shape the schedule (chunk counts, bidir
    markers, a synthesized plan's rendered algebra ``term``) so they
    participate in ``plan_id``."""

    op: str
    generator: str
    backend: str
    wire: str
    topology_fp: str
    steps: Tuple[Step, ...] = ()
    impl: str = ""
    meta: Tuple[Tuple[str, Any], ...] = field(default=())
    #: software-pipeline depth: the payload is split into this many
    #: interleaved chunks whose quantize/send-recv/dequantize-reduce
    #: stages overlap (1 = the unpipelined twin). A first-class plan
    #: dimension: it participates in plan_id, the cost model prices it
    #: with stage-overlap accounting, and the lowering threads it into
    #: the executors' segment machinery byte-identically.
    pipeline: int = 1

    @property
    def plan_id(self) -> str:
        """Stable short identity: readable family prefix + content hash.
        Identical requests on identical topologies under identical
        constants produce the identical plan_id on every rank — which is
        what lets the desync analyzer diff *plans*, not just ops."""
        ident = (self.op, self.generator, self.backend, self.wire,
                 self.impl, self.topology_fp, self.steps, self.meta)
        if self.pipeline > 1:
            # depth-1 plans keep their pre-pipeline hash (persisted
            # calibration tables and plan overrides stay valid)
            ident = ident + (self.pipeline,)
        h = hashlib.sha1(repr(ident).encode()).hexdigest()[:8]
        tail = f"+{self.impl}" if self.impl and self.impl != self.backend \
            else ""
        depth = f"@p{self.pipeline}" if self.pipeline > 1 else ""
        return f"{self.generator}-{self.backend}{tail}-{self.wire}{depth}:{h}"

    # ------------------------------------------------------------------
    def total_steps(self) -> int:
        return sum(s.count for s in self.steps)

    def bytes_on_level(self, level: str) -> int:
        """Total per-rank bytes the plan moves/processes on one link
        class — the number the cost model multiplies by beta."""
        return sum(
            s.bytes * s.count for s in self.steps if s.level == level
        )

    def describe(self) -> str:
        lines = [
            f"plan {self.plan_id}  op={self.op} generator={self.generator}"
            f" backend={self.backend}"
            + (f" impl={self.impl}" if self.impl else "")
            + f" wire={self.wire}"
            + (f" pipeline={self.pipeline}" if self.pipeline > 1 else ""),
            f"  topology {self.topology_fp}",
        ]
        for s in self.steps:
            note = f"  # {s.note}" if s.note else ""
            lines.append(
                f"  {s.count:>4} x {s.kind:<12} {s.level:<5} "
                f"{_fmt_bytes(s.bytes)}{note}"
            )
        if self.meta:
            lines.append(
                "  meta: " + ", ".join(f"{k}={v}" for k, v in self.meta)
            )
        return "\n".join(lines)


def prioritized(plan: Plan, priority: int) -> Plan:
    """A frozen twin of ``plan`` carrying a flush *priority* in ``meta``.

    The gradient-overlap scheduler (``schedule.overlap``) dispatches
    buckets in priority order (0 = first gradients ready during the
    backward pass = last layers, the reverse-layer order); stamping the
    order into ``meta`` makes it part of the plan identity, so the
    flight recorder / ``--explain`` tooling can tell a scheduled flush
    from its unscheduled twin. Idempotent on the same priority."""
    meta = tuple(kv for kv in plan.meta if kv[0] != "priority")
    meta = tuple(sorted(meta + (("priority", int(priority)),)))
    if meta == plan.meta:
        return plan
    return Plan(
        op=plan.op, generator=plan.generator, backend=plan.backend,
        wire=plan.wire, topology_fp=plan.topology_fp, steps=plan.steps,
        impl=plan.impl, meta=meta, pipeline=plan.pipeline,
    )


def _fmt_bytes(n: int) -> str:
    if n >= 1 << 20:
        return f"{n / (1 << 20):.2f}MiB"
    if n >= 1 << 10:
        return f"{n / (1 << 10):.1f}KiB"
    return f"{n}B"
