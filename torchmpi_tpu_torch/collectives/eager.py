"""Eager collectives on rank-stacked tensors.

The port of ``torchmpi_tpu/collectives/eager.py`` for flat plans: ``run``
validates a rank-stacked ``[p, ...]`` tensor, resolves the backend (the
size cutoff of :func:`op_route` and the kernel's dtype gate) and the wire
format (:func:`resolve_wire_dtype`), and calls the backend's function
directly; :func:`run_async` runs the same call on a side stream and
returns a :class:`~torchmpi_tpu_torch.runtime.handles.SyncHandle`. The JAX
package compiles each request through the schedule compiler
(``schedule/compiler.py:607``); that and the other schedule families wait
for later slices (ROADMAP queue A2). This slice carries allreduce and
broadcast.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import constants
from ..runtime.communicator import Communicator
from ..runtime.handles import SyncHandle, handles

_OPS = ("allreduce", "broadcast")
# collectives the compressed wire formats apply to (the bandwidth-path
# reductions; data movers are lossless by contract and stay verbatim)
_WIRE_OPS = ("allreduce", "reducescatter")


class CollectiveArgumentError(ValueError):
    pass


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP queue A2: the "
        "collective surface and primitives.ring_allreduce)"
    )


def _check_rank_stacked(x: torch.Tensor, comm: Communicator) -> None:
    if x.ndim < 1 or x.shape[0] != comm.size:
        raise CollectiveArgumentError(
            f"eager collectives expect a rank-stacked tensor with leading axis "
            f"== comm.size ({comm.size}); got shape {tuple(x.shape)}"
        )
    if x.device != comm.device:
        raise CollectiveArgumentError(
            f"tensor on {x.device}, communicator on {comm.device}"
        )


def op_route(op: str, nelem: int, platform: str, requested: str = "ring") -> str:
    """Size-based latency/bandwidth routing (reference
    ``collectives.cpp:296-301``): at or below the cutoff the vendor path,
    above it the requested bandwidth backend. ``nelem`` is per rank."""
    suffix = constants.platform_suffix(platform)
    if op == "allreduce":
        cutoff = constants.get(f"small_allreduce_size_{suffix}")
    elif op == "broadcast":
        cutoff = constants.get(f"small_broadcast_size_{suffix}")
    else:
        return requested
    return "xla" if nelem <= cutoff else requested


def effective_backend(op: str, nelem: int, dtype: torch.dtype, platform: str,
                      backend: str, route_small: bool) -> str:
    """Resolve the requested backend (``schedule/compiler.py:190``): the
    small-message cutoff reroutes custom requests to the vendor path, and a
    reduction whose dtype the kernel cannot carry exactly falls to the
    ``ring`` backend, as in the JAX package."""
    effective = backend
    if backend in ("ring", "kernel") and route_small:
        effective = op_route(op, nelem, platform, backend)
    if effective == "kernel" and op == "allreduce":
        from ..ops import ring_kernels

        if not ring_kernels.supports_dtype(dtype):
            effective = "ring"
    return effective


def resolve_wire_dtype(op: str, nelem: int, dtype: torch.dtype,
                       requested: Optional[str] = None) -> str:
    """The wire format of one eager call (``eager.py:529``): the explicit
    ``wire_dtype=`` argument wins, else the ``wire_dtype`` constant; 'full'
    whenever the encoding cannot engage -- another op, a payload that is
    not f32 (ints pass uncompressed, exactness is their contract), or
    fewer than ``wire_quant_min_elements`` elements per rank."""
    wire = requested if requested is not None else constants.get("wire_dtype")
    if wire in (None, "", "full"):
        return "full"
    if wire not in ("int8", "bf16"):
        raise CollectiveArgumentError(
            f"unknown wire_dtype {wire!r}; expected 'full', 'bf16' or 'int8'"
        )
    if op not in _WIRE_OPS or dtype != torch.float32:
        return "full"
    if nelem < constants.get("wire_quant_min_elements"):
        return "full"
    return wire


def _xla_allreduce(x: torch.Tensor) -> torch.Tensor:
    return x.sum(0, keepdim=True, dtype=x.dtype).expand_as(x).contiguous()


def _kernels(op: str, backend: str, root: int, wire: str = "full") -> Callable:
    """The function of ``backend`` that runs ``op`` on a rank-stacked
    tensor (the flat part of the JAX ``_kernels`` table). A compressed
    ``wire`` pins the quantized ring kernel (``eager.py:489-500``); the
    vendor path ships every payload verbatim."""
    if backend == "xla":
        table = {
            "allreduce": _xla_allreduce,
            "broadcast": lambda x: x[root : root + 1].expand_as(x).contiguous(),
        }
    elif backend == "kernel":
        from ..ops import ring_kernels

        table = {
            "allreduce": (
                ring_kernels.ring_allreduce
                if wire == "full"
                else lambda x: ring_kernels.ring_allreduce_quant(x, wire)
            ),
            "broadcast": lambda x: ring_kernels.ring_broadcast(x, root),
        }
    elif backend == "ring":
        raise _not_ported("the 'ring' (ppermute) backend")
    else:
        raise CollectiveArgumentError(f"unknown backend {backend!r}")
    return table[op]


def _validate(op: str, x: torch.Tensor, comm: Communicator, root: int,
              wire_dtype: Optional[str]) -> None:
    if op not in _OPS:
        raise _not_ported(f"collective {op!r}")
    _check_rank_stacked(x, comm)
    if wire_dtype not in (None, "full", "bf16", "int8"):
        # validated on every call: a typo must not pass silently because
        # this call happened to route to the vendor path
        raise CollectiveArgumentError(
            f"unknown wire_dtype {wire_dtype!r}; expected 'full', 'bf16' or 'int8'"
        )
    if op == "broadcast" and not 0 <= root < comm.size:
        raise CollectiveArgumentError(f"root {root} out of range")


def run(
    op: str,
    x: torch.Tensor,
    comm: Communicator,
    backend: str = "xla",
    root: int = 0,
    route_small: bool = True,
    wire_dtype: Optional[str] = None,
) -> torch.Tensor:
    """Synchronous eager collective on a rank-stacked tensor; returns a new
    rank-stacked tensor (the input is never written). ``wire_dtype``
    ('full' | 'bf16' | 'int8'; None = the ``wire_dtype`` constant) picks
    the wire of the kernel backend's reductions (:func:`resolve_wire_dtype`
    gives the gates)."""
    _validate(op, x, comm, root, wire_dtype)
    nelem = x[0].numel()
    effective = effective_backend(
        op, nelem, x.dtype, comm.device.type, backend, route_small
    )
    wire = (
        resolve_wire_dtype(op, nelem, x.dtype, wire_dtype)
        if effective == "kernel"
        else "full"
    )
    return _kernels(op, effective, root, wire)(x.contiguous())


def _async_stream(comm: Communicator) -> torch.cuda.Stream:
    """The communicator's side stream for async collectives (made at first
    use, like the reference's per-thread collective streams,
    ``resources.cpp:1055-1094``)."""
    stream = getattr(comm, "_async_stream", None)
    if stream is None:
        stream = comm._async_stream = torch.cuda.Stream(comm.device)
    return stream


def run_async(op: str, x: torch.Tensor, comm: Communicator, **kw) -> SyncHandle:
    """Asynchronous variant of :func:`run` (``eager.py:785``); returns a
    handle at once. On a CUDA communicator the collective runs on the
    communicator's side stream, after an event recorded on the caller's
    stream, and ``x`` is kept alive until the side stream has read it; on
    the CPU it runs now and the handle holds the result. The handle is
    registered, so ``sync_all()`` and ``stop()`` drain it."""
    # backpressure: bound the unwaited async collectives
    # (kNumAsyncCollectivesInFlight, lib/constants.cpp:152-155) by waiting
    # the oldest first, as the reference's bounded queues block enqueue
    limit = constants.get("num_async_collectives_in_flight")
    while handles.outstanding_kind("collective") >= limit:
        if not handles.wait_oldest("collective"):
            break
    if comm.device.type != "cuda":
        h = SyncHandle(run(op, x, comm, **kw))
    else:
        side = _async_stream(comm)
        side.wait_stream(torch.cuda.current_stream(comm.device))
        with torch.cuda.stream(side):
            out = run(op, x, comm, **kw)
            done = torch.cuda.Event()
            done.record(side)
        x.record_stream(side)
        h = SyncHandle(out, done)
    handles.register(h, kind="collective")
    return h
