"""The C++ issue path of a warm async allreduce (``csrc/issue.cpp``).

``eager.run_async`` hands a CUDA allreduce whose plan carries an
:attr:`~torchmpi_tpu_torch.schedule.compiler.ExecutablePlan.issue` route
to :func:`issue_async`: one C++ call records the ordering event on the
caller's stream, makes the side stream wait on it, runs the plan's work
on the side stream (the vendor path's sum, or one K3 launch through
``tm_ring_allreduce``), records the done event and keeps the input alive
for the side stream. The extension is built at first use by
``ops/_build.py``; a build or launch failure raises. There is no CPU
path: on the CPU ``run_async`` runs the collective at once.
"""

from __future__ import annotations

import ctypes

import torch

from . import ring_kernels

_ext = None
_ring_allreduce = 0


def _load() -> None:
    global _ext, _ring_allreduce
    from ._build import extension

    fn = ctypes.cast(ring_kernels._lib().tm_ring_allreduce, ctypes.c_void_p).value
    ext = extension("issue")
    ext.bind(torch._C._CudaStreamBase, torch._C._CudaEventBase)
    _ext, _ring_allreduce = ext, fn


def issue_async(x: torch.Tensor, stream: torch.cuda.Stream, order: torch.cuda.Event,
                done: torch.cuda.Event, route: tuple) -> torch.Tensor:
    """Issue the allreduce of the rank-stacked CUDA tensor ``x`` on
    ``stream`` after ``order`` (recorded on the caller's current stream),
    recording ``done`` after it; returns the output. ``route`` is the
    plan's ``(kind, dtype code, n, chunk elements)``: kind 0 the vendor
    path, kind 1 K3 (counted in ``ring_kernels.launches``)."""
    if _ext is None:
        _load()
    if route[0]:
        out = _ext.issue(x, stream, order, done, _ring_allreduce, *route)
        ring_kernels.launches["ring_allreduce"] += 1
        return out
    return _ext.issue(x, stream, order, done, 0, *route)
