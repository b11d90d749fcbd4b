"""Lower compiled plans onto the port's executors.

A :class:`~.ir.Plan` decides *what* schedule runs; this module binds it
to the functions that run it: the hand-written CUDA ring kernels
(``ops``), the ``ring`` backend's hop-by-hop rings and the vendor path in
``collectives/primitives.py``, through the flat kernel table
``collectives.eager._kernels``.

The port of the flat part of ``torchmpi_tpu/schedule/lower.py``:
:func:`lower_flat` (``lower.py:50``) and :func:`lower_fused_flat`
(``:91``). The JAX lowerings compile an executable per exact shape; the
port binds a function, which the schedule compiler's dispatch memo keeps
per call signature.
The hierarchical, staged, tree, halving, torus and striped lowerings
(``lower.py:203-940``) are ROADMAP A8.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .. import constants


def _eager():
    # late import: eager imports the schedule compiler, which imports this
    from ..collectives import eager

    return eager


def lower_flat(comm, op: str, backend: str, shape: Tuple, dtype, wire: str,
               root: int, src: int, dst: int, pipeline: int = 1):
    """The flat function of ``(op, backend)`` for the payload: the kernel
    table's decisions (the bidirectional ring under
    ``ring_implementation='kernel_bidir'``, the ring tuning, the
    broadcast's tree or pipeline) and the plan's ``pipeline`` depth,
    which the ``ring`` backend's allreduce threads into
    ``primitives.ring_allreduce(pipeline_depth=)`` (bitwise equal at every
    depth). Returns ``(fn, takes_stream)``: ``takes_stream`` when the
    function launches a kernel and takes ``stream=``."""
    nelem = math.prod(shape[1:])
    fn = _eager()._kernels(op, backend, nelem, dtype, comm.device.type, root,
                           src, dst, wire, pipeline=pipeline)
    return fn, backend == "kernel"


def lower_fused_flat(comm, op: str, backend: str, ns: Tuple[int, ...],
                     dtype, wire: str, pipeline: int = 1):
    """The coalesced flat function: the pack of the ``[p, n_i]`` slabs
    (one ``torch.cat``, which XLA fused into the JAX plan) followed by the
    flat function of the ``[p, sum(n_i)]`` total, bound once per
    ``(op, layout, dtype, routing)`` by the dispatch memo."""
    inner, _ = lower_flat(comm, op, backend, (comm.size, sum(ns)), dtype,
                          wire, 0, 0, 0, pipeline=pipeline)
    return lambda flats: inner(torch.cat(flats, dim=1))


def issue_route(comm, op: str, backend: str, shape: Tuple, dtype,
                wire: str) -> Optional[tuple]:
    """The route of the C++ async issue path (``ops/issue.py``) for a
    flat plan, or None where the Python path issues: an allreduce on a
    CUDA communicator of more than one rank, either on the vendor path
    (``(0, 0, 0, 0)``) or through K3 with the full wire and a dtype the
    kernel adds natively (``(1, dtype code, n, chunk elements)``, unless
    ``ring_implementation`` puts it on the bidirectional ring)."""
    if op != "allreduce" or comm.device.type != "cuda" or comm.size < 2:
        return None
    if backend == "xla":
        return (0, 0, 0, 0)
    if backend != "kernel" or wire != "full":
        return None
    if constants.get("ring_implementation") == "kernel_bidir":
        return None
    from ..ops import ring_kernels

    n = math.prod(shape[1:])
    if dtype not in ring_kernels.NATIVE_DTYPES or n == 0:
        return None
    return (1, ring_kernels.NATIVE_DTYPES[dtype], n,
            ring_kernels.chunk_elems(n, comm.size, dtype))
