"""Parallel strategies of the port: sequence parallelism (ring attention)
over the virtual ranks, and the named axes that lay them out."""

from .mesh import MeshLayout, make_parallel_mesh
from .ring_attention import full_self_attention, ring_self_attention

__all__ = ["MeshLayout", "full_self_attention", "make_parallel_mesh", "ring_self_attention"]
