"""Collective backend selector.

The port of ``torchmpi_tpu/collectives/selector.py`` (the reference's
``mpi.collectiveSelector``, ``torchmpi/init.lua:463-555``): a preference
table keyed on ``(platform, single/multi node, sync/async, collective)``;
the first *available* backend wins. The platforms are the device types
``cuda`` and ``cpu`` (every other device type takes the ``cpu`` row); the
backends:

- ``xla``    — the vendor path: plain PyTorch over the rank axis;
- ``ring``   — the JAX package's ``ppermute`` ring, hop by hop on the rank
  axis (``primitives.ring_*``); always available, as in the JAX package;
- ``kernel`` — the hand-written CUDA ring kernels (``ops/``), the
  counterpart of ``pallas``; available on a CUDA communicator.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

_COLLECTIVES = (
    "broadcast",
    "reduce",
    "allreduce",
    "sendreceive",
    "allgather",
    "reducescatter",
    "alltoall",
)


def backend_availability(device: Optional[torch.device] = None) -> Dict[str, bool]:
    return {
        "xla": True,
        "ring": True,
        "kernel": device is not None and torch.device(device).type == "cuda",
    }


_SLOW = {c: ["xla", "ring"] for c in _COLLECTIVES}

# Preference order per (platform, nodes, mode, collective): the JAX table's
# cpu row, and its tpu row as the cuda row with 'pallas' named 'kernel'.
# Single-node sync allreduce and broadcast prefer the custom ring on the
# card (the reference's cudaIPC ring beat NCCL, README.md:104-106); small
# sizes are rerouted to 'xla' by eager.op_route either way. Single-node
# async allreduce prefers it too, as the reference's GPU async allreduce
# was its p2p ring (torchmpi_async_p2p_allreduce_THCudaTensor,
# collectives_cuda.cpp:1457-1466): on one card an async collective is the
# same kernel on a side stream. (The JAX tpu row's async entries are 'xla',
# because its engine's async buckets are in-graph psums.) Single-node sync
# allgather and reducescatter prefer it for the same reason: on one node the
# reference's collectives were its own ring, and on the card the
# kernel's allgather beats its library call (expand-copy) and its
# reduce-scatter ties ``x.sum(0)`` (PERF.md); they carry the engine's
# sharded modes. Single-node async reducescatter prefers it too: a
# ``FusionBuffer`` dispatches what it cannot fuse async (a sharded step's
# last single-tensor flush), and on one card that is the same kernel on a
# side stream.
_CUDA_SINGLENODE_SYNC = {
    "broadcast": ["kernel", "ring", "xla"],
    "reduce": ["ring", "xla"],
    "allreduce": ["kernel", "ring", "xla"],
    "sendreceive": ["xla", "ring"],
    "allgather": ["kernel", "ring", "xla"],
    "reducescatter": ["kernel", "ring", "xla"],
    "alltoall": ["xla", "ring"],
}
_DEFAULT: Dict[str, Dict[str, Dict[str, Dict[str, List[str]]]]] = {
    "cpu": {
        "singlenode": {"sync": dict(_SLOW), "async": dict(_SLOW)},
        "multinode": {"sync": dict(_SLOW), "async": dict(_SLOW)},
    },
    "cuda": {
        "singlenode": {
            "sync": dict(_CUDA_SINGLENODE_SYNC),
            "async": {**_SLOW, "allreduce": ["kernel", "ring", "xla"],
                      "reducescatter": ["kernel", "ring", "xla"]},
        },
        "multinode": {"sync": dict(_SLOW), "async": dict(_SLOW)},
    },
}


class CollectiveSelector:
    def __init__(self):
        self.table = _DEFAULT

    def select(
        self,
        collective: str,
        device: torch.device,
        multinode: bool = False,
        mode: str = "sync",
    ) -> str:
        """The preferred available backend for ``collective`` on a
        communicator whose ranks live on ``device``."""
        platform = "cuda" if torch.device(device).type == "cuda" else "cpu"
        nodes = "multinode" if multinode else "singlenode"
        avail = backend_availability(device)
        for b in self.table[platform][nodes][mode][collective]:
            if avail.get(b):
                return b
        return "xla"

    def describe(self, device: torch.device) -> str:
        """The backends available on ``device``, the wire a large f32
        payload of each wire collective would ship, and each row of the
        table with its preferences and choice (``selector.py:158``)."""
        from .. import constants
        from .eager import _WIRE_OPS, resolve_wire_dtype

        avail = backend_availability(device)
        lines = ["Backend availability: " + ", ".join(
            f"{k}={'yes' if v else 'no'}" for k, v in avail.items()
        )]
        custom = avail["ring"] or avail["kernel"]
        formats = {"full": True, "bf16": custom, "int8": custom}
        lines.append(
            f"Wire formats (fp32 {'/'.join(_WIRE_OPS)} >= wire_quant_min_elements): "
            + ", ".join(f"{k}={'yes' if v else 'no'}" for k, v in formats.items())
            + f" -> default {constants.get('wire_dtype')}"
        )
        large = constants.get("wire_quant_min_elements")
        for op in _WIRE_OPS:
            lines.append(f"wire.{op}: -> {resolve_wire_dtype(op, large, torch.float32)}")
        for platform, nodes_tbl in self.table.items():
            for nodes, mode_tbl in nodes_tbl.items():
                for mode, coll_tbl in mode_tbl.items():
                    for coll, prefs in coll_tbl.items():
                        chosen = self.select(coll, torch.device(platform),
                                             nodes == "multinode", mode)
                        lines.append(f"{platform}.{nodes}.{mode}.{coll}: "
                                     f"{' > '.join(prefs)} -> {chosen}")
        return "\n".join(lines)


selector = CollectiveSelector()


def collective_availability(device: Optional[torch.device] = None) -> str:
    """:meth:`CollectiveSelector.describe` for ``device``: the current
    communicator's when the runtime is started, else the card's."""
    if device is None:
        from .. import runtime_state

        device = (runtime_state.current_communicator().device
                  if runtime_state.started() else torch.device("cuda"))
    return selector.describe(device)
