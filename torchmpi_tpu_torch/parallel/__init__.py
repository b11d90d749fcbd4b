"""Parallel strategies of the port over the named axes of the virtual
ranks: tensor (``tp``), pipeline (``pp``), expert (``ep``) and sequence
(ring attention) parallelism, and the axis collectives they run on."""

from ..collectives.axis import axis_all_to_all, axis_pmean, axis_ppermute, axis_psum
from .ep import moe_dispatch_combine, moe_load_stats
from .mesh import MeshLayout, make_parallel_mesh
from .pp import pipeline_1f1b_value_and_grad, pipeline_forward, pipeline_loss_fn
from .ring_attention import full_self_attention, ring_self_attention
from .tp import MPLinear, MPLinearOutputSplit, shard_input_features

__all__ = [
    "make_parallel_mesh",
    "moe_dispatch_combine",
    "moe_load_stats",
    "pipeline_1f1b_value_and_grad",
    "pipeline_forward",
    "pipeline_loss_fn",
    "ring_self_attention",
    "full_self_attention",
    "MPLinear",
    "MPLinearOutputSplit",
    "shard_input_features",
    "MeshLayout",
    "axis_all_to_all",
    "axis_pmean",
    "axis_ppermute",
    "axis_psum",
]
