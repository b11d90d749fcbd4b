"""Analytic alpha-beta cost model over plan steps.

Each link class (ICI / DCN / host) carries an ``alpha`` (fixed per-hop
launch latency, µs) and a ``beta`` (per-MiB transfer time, µs/MiB) —
the classic LogP/alpha-beta collective model the GC3/HiCCL line of work
costs schedules with (PAPERS.md). Quantize/dequantize steps are priced
by a throughput term, pack/unpack/local_reduce by a local-bandwidth
term, and every plan pays a per-dispatch overhead — the Python+XLA
submit cost the latency path fights.

All terms are ``plan_cost_*`` constants (knob table in the README):
they start as conservative analytic defaults and are *calibrated by
measurement* — ``tune_plan`` measures real candidate plans and persists
the winner per cache key, and the small-message crossover constants
(``small_*_size_*``, themselves autotuned) feed the latency-path gate.
The analytic model's job is to ORDER candidates between measurements,
not to predict wall time to the microsecond.

On top of the analytic model sits the **measured calibration table**
(``schedule.calibrate()`` / ``load_calibration()``, fed by the live
telemetry plane's dispatch-latency samples): per-(op, payload bucket,
wire, plan_id) measured microseconds that :func:`calibrated_plan_us`
serves and ``select_plan`` prefers over the analytic estimate when a
candidate has actually been measured. Applying a table bumps
:func:`calibration_epoch`, which plan-cache keys embed — a calibration
load invalidates stale plan choices exactly like an autotuner override.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .. import constants
from .ir import Plan, Step
from .topology import LINK_DCN, LINK_HOST, LINK_ICI, LINK_LOCAL

_MIB = float(1 << 20)

# link class -> (alpha constant, beta constant)
_LINK_KNOBS = {
    LINK_ICI: ("plan_cost_alpha_ici_us", "plan_cost_beta_ici_us_per_mib"),
    LINK_DCN: ("plan_cost_alpha_dcn_us", "plan_cost_beta_dcn_us_per_mib"),
    LINK_HOST: ("plan_cost_alpha_host_us", "plan_cost_beta_host_us_per_mib"),
}


def link_alpha_us(level: str) -> float:
    if level == LINK_LOCAL:
        return 0.0
    return float(constants.get(_LINK_KNOBS[level][0]))


def link_beta_us_per_mib(level: str) -> float:
    if level == LINK_LOCAL:
        # on-device local work (pack/unpack/accumulate) rides HBM, far
        # faster than any link: priced as a fraction of the ICI beta
        return float(constants.get(_LINK_KNOBS[LINK_ICI][1])) / 8.0
    return float(constants.get(_LINK_KNOBS[level][1]))


def step_cost_us(step: Step) -> float:
    mib = step.bytes / _MIB
    if step.kind in ("quantize", "dequantize"):
        rate = float(constants.get("plan_cost_quantize_us_per_mib"))
        return step.count * mib * rate
    if step.kind in ("pack", "unpack", "local_reduce"):
        return step.count * mib * link_beta_us_per_mib(LINK_LOCAL)
    # send / recv / reduce: alpha-beta on the step's link class
    return step.count * (
        link_alpha_us(step.level) + mib * link_beta_us_per_mib(step.level)
    )


def serial_steps_us(steps) -> float:
    """Alpha-beta cost of a raw step sequence run serially — the
    critical-path pricer the composition algebra's ``stripe`` combinator
    uses to pick its max-cost (bottleneck) stripe before a Plan exists
    (``estimate_us`` prices whole plans; a stripe's sub-terms are bare
    step tuples)."""
    return float(sum(step_cost_us(s) for s in steps))


# step kind -> software-pipeline stage class. A pipelined plan's chunks
# walk encode -> wire -> decode; chunks at different stages overlap (the
# EQuARX framing: quantize(k+1) hides under send(k), dequantize/reduce
# (k-1) under recv(k)), so the steady-state rate is set by the slowest
# stage CLASS, not the stage sum.
PIPELINE_STAGES = ("encode", "wire", "decode")
_STAGE_OF = {
    "quantize": "encode", "pack": "encode",
    "send": "wire", "recv": "wire", "reduce": "wire",
    "dequantize": "decode", "unpack": "decode", "local_reduce": "decode",
}


def _chunk_step(step: Step, depth: int) -> Step:
    """One chunk's share of an aggregated step: bytes divide by the
    pipeline depth, the per-hop count does NOT (every chunk makes every
    hop — chunking pays depth x the per-hop alphas, the overhead the
    overlap must out-earn)."""
    return Step(step.kind, step.level, -(-step.bytes // max(1, depth)),
                step.count, step.note)


def pipeline_stage_us(plan: Plan, depth: int = 0) -> Dict[str, float]:
    """Per-chunk cost of each pipeline stage class (µs) at ``depth``
    (default: the plan's own). The per-chunk accounting ``estimate_us``
    overlaps and ``--explain`` renders as the stage timeline."""
    d = depth or plan.pipeline
    out: Dict[str, float] = {}
    for step in plan.steps:
        cls = _STAGE_OF.get(step.kind, "wire")
        out[cls] = out.get(cls, 0.0) + step_cost_us(_chunk_step(step, d))
    return out


def estimate_us(plan: Plan) -> float:
    """Total analytic cost of a plan in microseconds: per-dispatch
    overhead (one per compiled executable the plan replays; composed
    host-staged plans declare more via meta ``dispatches``) plus the
    alpha-beta sum over its steps.

    A pipelined plan (``plan.pipeline`` > 1) is priced per-chunk with
    stage-overlap accounting: the first chunk pays every stage (the
    pipeline fill), each further chunk only the bottleneck stage (the
    steady-state initiation interval) — ``fill + (depth-1) * max(stage)``
    — while every chunk still pays its own per-hop alphas. Large
    payloads with real encode/decode work under wire time win; small or
    alpha-dominated ones lose, which is exactly the depth-1 verdict the
    selection should reach."""
    dispatches = 1
    for k, v in plan.meta:
        if k == "dispatches":
            dispatches = int(v)
    total = dispatches * float(constants.get("plan_cost_dispatch_us"))
    if plan.pipeline > 1 and plan.steps:
        stages = pipeline_stage_us(plan)
        fill = sum(stages.values())
        bottleneck = max(stages.values())
        return total + fill + (plan.pipeline - 1) * bottleneck
    for step in plan.steps:
        total += step_cost_us(step)
    return total


def pipeline_timeline(plan: Plan) -> List[dict]:
    """Per-chunk stage start/duration rows (µs) of a pipelined plan —
    the worked timeline ``--explain`` prints. Chunk k's stage s starts
    at ``k * bottleneck + sum(earlier stages)`` (classic software
    pipeline with the bottleneck stage as initiation interval)."""
    if plan.pipeline <= 1:
        return []
    stages = pipeline_stage_us(plan)
    ordered = [(s, stages[s]) for s in PIPELINE_STAGES if stages.get(s)]
    bottleneck = max((us for _, us in ordered), default=0.0)
    rows: List[dict] = []
    for k in range(plan.pipeline):
        t = k * bottleneck
        for name, us in ordered:
            rows.append({
                "chunk": k, "stage": name,
                "start_us": round(t, 2), "us": round(us, 2),
            })
            t += us
    return rows


# ---------------------------------------------------------------------------
# measured calibration table (the live-plane cost model load path)
# ---------------------------------------------------------------------------

# (op, bucket, wire, plan_id) -> measured median dispatch microseconds.
# plan_id hashes the topology fingerprint, so topology identity rides
# along without a separate key part.
_CALIBRATED: Dict[tuple, float] = {}
_CAL_EPOCH = 0


def set_calibration(table: Dict[str, dict]) -> int:
    """Apply a calibrated cost table (``telemetry.calibrate`` ``table``
    shape: ``"op|comm|wire|b<bucket>|plan_id" -> {"us": ...}``).
    Replaces the previous table; returns the number of applied entries.
    Duplicate (op, bucket, wire, plan) keys from different comms merge
    by sample-weighted mean."""
    global _CAL_EPOCH
    from ..telemetry.calibrate import split_key

    merged: Dict[tuple, list] = {}
    for key, row in (table or {}).items():
        parts = split_key(key)
        us = (row or {}).get("us")
        if parts is None or us is None:
            continue
        k = (parts["op"], parts["bucket"], parts["wire"], parts["plan_id"])
        n = max(1, int((row or {}).get("n", 1)))
        acc = merged.setdefault(k, [0.0, 0])
        acc[0] += float(us) * n
        acc[1] += n
    _CALIBRATED.clear()
    for k, (tot, n) in merged.items():
        _CALIBRATED[k] = tot / n
    _CAL_EPOCH += 1
    return len(_CALIBRATED)


def clear_calibration() -> None:
    global _CAL_EPOCH
    if _CALIBRATED:
        _CALIBRATED.clear()
        _CAL_EPOCH += 1


def calibration_epoch() -> int:
    return _CAL_EPOCH


def calibrated_plan_us(op: str, bucket: int, wire: str,
                       plan_id: str) -> Optional[float]:
    """Measured microseconds for one candidate, or None when this plan
    was never measured (the analytic estimate then stands)."""
    return _CALIBRATED.get((op, bucket, wire, plan_id))


def cost_breakdown(plan: Plan) -> Dict[str, float]:
    """Per-link-class µs attribution (explain output)."""
    out: Dict[str, float] = {}
    for step in plan.steps:
        key = step.level if step.kind not in ("quantize", "dequantize") \
            else "codec"
        out[key] = out.get(key, 0.0) + step_cost_us(step)
    return out
