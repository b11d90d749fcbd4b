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

The port lowers the flat, hierarchical, staged and tree families; the
algebra-synthesized ones are priced and shown by :func:`explain` with the
reason ``synthesized lowering not ported (ROADMAP A8)``. The bucket overlap
scheduler is :mod:`.overlap`. Not here yet: the measured calibration
pipeline and ``tune_plan`` (A11);
:func:`set_calibration` takes a table in the JAX package's format.

Public surface:

- :func:`compile_collective` / :func:`compile_fused` — the routing
  authority ``eager.run`` / ``run_fused`` / ``run_async`` /
  ``precompile`` all flow through.
- :func:`explain` + ``python -m torchmpi_tpu_torch.schedule --explain`` —
  the decision dump (chosen plan, cost estimate, rejected candidates).
- :func:`set_plan_override` / :func:`plan_overrides` — plan overrides by
  cache key.
- ``algebra`` — the composition algebra (:func:`synthesize`,
  :func:`derive_tree` and its combinators).
"""

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
    A8_REASON,
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

__all__ = [
    "Plan", "Step", "STEP_KINDS", "Topology", "prioritized",
    "compile_collective", "compile_fused", "explain",
    "candidate_plans", "Candidate", "GENERATORS", "HIER_OPS", "TREE_OPS",
    "PIPELINE_OPS", "PIPELINE_STAGES", "A8_REASON", "pipelined_variant",
    "pipeline_stage_us", "pipeline_timeline",
    "ChunkPipeline", "depth_candidates", "split_spans",
    "estimate_us", "cost_breakdown",
    "set_plan_override", "apply_plan_overrides", "plan_overrides",
    "clear_plan_overrides", "override_key", "payload_bucket",
    "select_plan", "pinned_plan", "effective_backend", "plan_by_id",
    "set_calibration", "clear_calibration", "calibrated_plan_us",
    "calibration_epoch",
    "ExecutablePlan", "FusedExecutablePlan",
    "SYNTH_GENERATORS", "SYNTH_OPS", "MAX_SYNTH_CANDIDATES",
    "synthesize", "derive_synth", "derive_tree", "is_synthesized",
    "synth_family", "term_of",
]
