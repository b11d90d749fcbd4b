"""Collective schedule compiler: one plan IR instead of four code paths.

The port of ``torchmpi_tpu/schedule``. A collective request ``(op,
payload, dtype, comm)`` is *compiled*, not routed, into a
:class:`~.ir.Plan`: a DAG of typed steps (send / recv / reduce /
quantize / dequantize / pack / unpack / local_reduce) against a declared
:class:`~.topology.Topology`, picked among candidate schedules (flat
ring, two-level hierarchical, staged, tree: plan *generators*) by an
analytic alpha-beta cost model, cached per ``(op, topology fingerprint,
payload bucket, wire, constants.version())``, and lowered onto the
port's executors (the CUDA ring kernels, the ``ring`` backend, the
vendor path), so numerics and launches are unchanged.

The port lowers every family: flat, hierarchical, staged, tree and, under
``use_plan_synthesis``, the algebra-synthesized ones. The bucket overlap
scheduler is :mod:`.overlap`.

Public surface:

- :func:`compile_collective` / :func:`compile_fused` — the routing
  authority ``eager.run`` / ``run_fused`` / ``run_async`` /
  ``precompile`` all flow through.
- :func:`explain` + ``python -m torchmpi_tpu_torch.schedule --explain`` —
  the decision dump (chosen plan, cost estimate, rejected candidates).
- :func:`set_plan_override` / :func:`plan_overrides` — the autotuner's
  measured-winner persistence surface (``utils.autotune.tune_plan``).
- :func:`calibrate` / :func:`load_calibration` — the measured cost
  model: fit per-(op, comm, wire, payload bucket, plan_id) dispatch
  latencies from flight-recorder samples, persist them like ``tune_plan``
  (``start()`` re-applies), and have ``select_plan`` prefer measured
  microseconds over the analytic estimate.
- ``algebra`` — the composition algebra (:func:`synthesize`,
  :func:`derive_tree` and its combinators).
"""

from typing import Optional

from .algebra import (  # noqa: F401
    MAX_SYNTH_CANDIDATES,
    SYNTH_GENERATORS,
    SYNTH_OPS,
    derive_synth,
    derive_tree,
    is_synthesized,
    synth_family,
    synthesize,
    term_of,
)
from .compiler import (  # noqa: F401
    ExecutablePlan,
    FusedExecutablePlan,
    apply_plan_overrides,
    clear_plan_overrides,
    compile_collective,
    compile_fused,
    effective_backend,
    explain,
    override_key,
    payload_bucket,
    pinned_plan,
    plan_by_id,
    plan_overrides,
    select_plan,
    set_plan_override,
)
from .cost import (  # noqa: F401
    PIPELINE_STAGES,
    calibrated_plan_us,
    calibration_epoch,
    clear_calibration,
    cost_breakdown,
    estimate_us,
    pipeline_stage_us,
    pipeline_timeline,
    set_calibration,
)
from .generators import (  # noqa: F401
    GENERATORS,
    HIER_OPS,
    PIPELINE_OPS,
    TREE_OPS,
    Candidate,
    candidate_plans,
    pipelined_variant,
)
from .ir import STEP_KINDS, Plan, Step, prioritized  # noqa: F401
from .pipeline import (  # noqa: F401
    ChunkPipeline,
    depth_candidates,
    split_spans,
)
from .topology import Topology  # noqa: F401


def calibrate(samples, apply: bool = True, persist: bool = False,
              path=None) -> dict:
    """Fit the measured cost model from dispatch samples.

    ``samples`` is a :class:`~..telemetry.calibrate.SampleStore`, its
    ``to_json()`` dict, or a path to a saved store (what the fleet
    aggregator persists). The fit prices every measured plan_id it can
    resolve through this process's plan registry with the hand-set
    analytic model, so the returned ``report`` shows modeled-vs-measured
    error next to the calibrated fit's. ``apply`` loads the table into
    the selection path (:func:`set_calibration`, bumping the calibration
    epoch every plan-cache key embeds); ``persist`` saves the result
    like ``tune_plan`` (``$TORCHMPI_TPU_CALIBRATION_CACHE`` or
    ``~/.cache/torchmpi_tpu_torch/calibration.json``) for ``start()`` to
    re-apply."""
    from ..telemetry import calibrate as _calib

    if isinstance(samples, (str, bytes)) or hasattr(samples, "__fspath__"):
        store = _calib.SampleStore.load(samples)
    elif isinstance(samples, dict):
        store = _calib.SampleStore.from_json(samples)
    else:
        store = samples
    result = _calib.fit_store(store, plan_lookup=plan_by_id)
    if apply:
        result["applied"] = set_calibration(result["table"])
    if persist:
        result["path"] = str(_calib.save_calibration(
            {k: result[k] for k in ("version", "fitted", "table", "report")},
            path=path,
        ))
    return result


def load_calibration(path=None, apply: bool = True) -> Optional[dict]:
    """Re-apply a persisted calibration (the ``start()`` hook, beside the
    tuned constants' load). Returns the loaded result dict, or None when
    no calibration file exists."""
    from ..telemetry import calibrate as _calib

    result = _calib.load_calibration_file(path)
    if result is None:
        return None
    if apply:
        result["applied"] = set_calibration(result.get("table", {}))
    return result


__all__ = [
    "Plan", "Step", "STEP_KINDS", "Topology", "prioritized",
    "compile_collective", "compile_fused", "explain",
    "candidate_plans", "Candidate", "GENERATORS", "HIER_OPS", "TREE_OPS",
    "PIPELINE_OPS", "PIPELINE_STAGES", "pipelined_variant",
    "pipeline_stage_us", "pipeline_timeline",
    "ChunkPipeline", "depth_candidates", "split_spans",
    "estimate_us", "cost_breakdown",
    "set_plan_override", "apply_plan_overrides", "plan_overrides",
    "clear_plan_overrides", "override_key", "payload_bucket",
    "select_plan", "pinned_plan", "effective_backend", "plan_by_id",
    "calibrate", "load_calibration", "set_calibration",
    "clear_calibration", "calibrated_plan_us", "calibration_epoch",
    "ExecutablePlan", "FusedExecutablePlan",
    "SYNTH_GENERATORS", "SYNTH_OPS", "MAX_SYNTH_CANDIDATES",
    "synthesize", "derive_synth", "derive_tree", "is_synthesized",
    "synth_family", "term_of",
]
