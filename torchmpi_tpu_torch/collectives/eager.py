"""Eager collectives on rank-stacked tensors.

The port of ``torchmpi_tpu/collectives/eager.py`` for flat plans: ``run``
validates a rank-stacked ``[p, ...]`` tensor, resolves the backend (the
size cutoff of :func:`op_route` and the kernel's dtype gate) and calls the
backend's function directly. The JAX package compiles each request through
the schedule compiler (``schedule/compiler.py:607``); that, the other
schedule families and the async surface wait for later slices
(ROADMAP queue A2). This slice carries allreduce and broadcast.
"""

from __future__ import annotations

from typing import Callable

import torch

from .. import constants
from ..runtime.communicator import Communicator

_OPS = ("allreduce", "broadcast")


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


def _xla_allreduce(x: torch.Tensor) -> torch.Tensor:
    return x.sum(0, keepdim=True, dtype=x.dtype).expand_as(x).contiguous()


def _kernels(op: str, backend: str, root: int) -> Callable:
    """The function of ``backend`` that runs ``op`` on a rank-stacked
    tensor (the flat part of the JAX ``_kernels`` table)."""
    if backend == "xla":
        table = {
            "allreduce": _xla_allreduce,
            "broadcast": lambda x: x[root : root + 1].expand_as(x).contiguous(),
        }
    elif backend == "kernel":
        from ..ops import ring_kernels

        table = {
            "allreduce": ring_kernels.ring_allreduce,
            "broadcast": lambda x: ring_kernels.ring_broadcast(x, root),
        }
    elif backend == "ring":
        raise _not_ported("the 'ring' (ppermute) backend")
    else:
        raise CollectiveArgumentError(f"unknown backend {backend!r}")
    return table[op]


def _validate(op: str, x: torch.Tensor, comm: Communicator, root: int) -> None:
    if op not in _OPS:
        raise _not_ported(f"collective {op!r}")
    _check_rank_stacked(x, comm)
    if op == "broadcast" and not 0 <= root < comm.size:
        raise CollectiveArgumentError(f"root {root} out of range")


def run(
    op: str,
    x: torch.Tensor,
    comm: Communicator,
    backend: str = "xla",
    root: int = 0,
    route_small: bool = True,
) -> torch.Tensor:
    """Synchronous eager collective on a rank-stacked tensor; returns a new
    rank-stacked tensor (the input is never written)."""
    _validate(op, x, comm, root)
    effective = effective_backend(
        op, x[0].numel(), x.dtype, comm.device.type, backend, route_small
    )
    return _kernels(op, effective, root)(x.contiguous())
