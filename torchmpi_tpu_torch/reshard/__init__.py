"""Array redistribution between ``(world size, sharding)`` layouts with
bounded memory: the port of ``torchmpi_tpu/reshard``'s planner
(:mod:`.core`).

It reshapes checkpoints: an N-way portable sharded checkpoint restores
onto an M-way world (:mod:`..utils.checkpoint`), or is reshaped offline
by ``python -m torchmpi_tpu_torch.reshard --from N --to M``. The live
engine resize and the cross-process elastic exchange (``reshard/
elastic.py`` of the JAX package) are ROADMAP A10.
"""

from .core import (
    Layout,
    Redistributor,
    Transfer,
    build_plan,
    chunk_spans,
    chunk_transfers,
    compile_reshard,
    estimate_us,
    plan_transfers,
    redistribute_arrays,
    wire_elements,
)

__all__ = [
    "Layout",
    "Redistributor",
    "Transfer",
    "build_plan",
    "chunk_spans",
    "chunk_transfers",
    "compile_reshard",
    "estimate_us",
    "plan_transfers",
    "redistribute_arrays",
    "wire_elements",
]
