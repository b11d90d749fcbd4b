"""Public collectives surface of the port.

As in ``torchmpi_tpu/collectives/__init__.py``: the selector-routed
synchronous collectives at the top level take rank-stacked ``[p, ...]``
tensors and return new ones. ``backend=`` pins a backend (``'xla'``,
``'kernel'``), which lets the CPU tests drive the kernel path through the
plain versions. This slice carries allreduce and broadcast.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import constants
from ..runtime.communicator import Communicator
from . import eager
from .eager import CollectiveArgumentError
from .fusion import FusionBuffer, get_fusion_buffer
from .selector import backend_availability, selector


def _current_comm(comm: Optional[Communicator]) -> Communicator:
    if comm is not None:
        return comm
    from .. import runtime_state

    return runtime_state.current_communicator()


def _dispatch(op: str, x: torch.Tensor, comm: Optional[Communicator] = None,
              backend: Optional[str] = None, **kw) -> torch.Tensor:
    comm = _current_comm(comm)
    if backend is None:
        backend = selector.select(op, comm.device, multinode=comm.num_nodes() > 1)
        if backend == "kernel":
            # the selector decides vendor-vs-custom ring; which custom ring
            # runs is the ring_implementation constant, read per call
            impl = constants.get("ring_implementation")
            if impl == "ppermute":
                raise eager._not_ported("ring_implementation='ppermute'")
            if impl != "kernel":
                raise CollectiveArgumentError(
                    f"unknown ring_implementation {impl!r}; expected 'kernel' "
                    "or 'ppermute'"
                )
    return eager.run(op, x, comm, backend=backend, **kw)


def broadcast_tensor(x: torch.Tensor, root: int = 0, comm=None,
                     backend: Optional[str] = None) -> torch.Tensor:
    return _dispatch("broadcast", x, comm, backend, root=root)


def allreduce_tensor(x: torch.Tensor, comm=None,
                     backend: Optional[str] = None) -> torch.Tensor:
    """Sum-allreduce over the rank axis."""
    return _dispatch("allreduce", x, comm, backend)


__all__ = [
    "CollectiveArgumentError",
    "FusionBuffer",
    "allreduce_tensor",
    "backend_availability",
    "broadcast_tensor",
    "eager",
    "get_fusion_buffer",
    "selector",
]
