"""Global runtime state: the started flag and the communicator stack.

The port of ``torchmpi_tpu/runtime_state.py`` (``lib/torch_mpi.cpp:38-51``
state plus the start/stop lifecycle of ``torch_mpi.cpp:233-306``). Where
the JAX ``start()`` takes the process's devices as ranks, this one takes a
rank count and one device: ``start(ranks=p)`` stands for the JAX test
mesh's ``--cpu-mesh p`` virtual devices, all held on one CUDA card.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Union

import torch

from . import constants
from .runtime.communicator import (
    Communicator,
    CommunicatorStack,
    KeySpec,
    split_by_keys,
)

_lock = threading.Lock()
_stack: Optional[CommunicatorStack] = None


class NotStartedError(RuntimeError):
    pass


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """The device an entry point runs on: ``None`` means the first CUDA
    card, and a CUDA device without a card raises — the port never drops
    to the CPU unless the caller asks for ``'cpu'``."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def start(
    ranks: int = 8,
    device: Union[None, str, torch.device] = None,
    with_cartesian_communicator: Optional[bool] = None,
    custom_communicator_init: Optional[Callable[[], None]] = None,
) -> None:
    """Initialise the runtime (``MPI.start``, ``torchmpi/init.lua:31-100``).

    - ``ranks`` — the number of virtual ranks (the JAX tests' and verify
      recipe's 8-device CPU mesh by default).
    - ``device`` — where every rank's tensors live; ``None`` is ``cuda:0``.
    - ``with_cartesian_communicator`` — cartesian vs tree mode, set
      *before* building communicators (``init.lua:61-65``).
    - ``custom_communicator_init`` — callback run right after start, in
      which user code may :func:`push_communicator` (``init.lua:84-91``).
    """
    global _stack
    if ranks < 1:
        raise ValueError(f"start() needs at least one rank, got {ranks}")
    dev = resolve_device(device)
    prev_cartesian = constants.get("use_cartesian_communicator")
    with _lock:
        if _stack is not None:
            raise RuntimeError("torchmpi_tpu_torch.start() called twice")
        if with_cartesian_communicator is not None:
            constants.set(
                "use_cartesian_communicator", bool(with_cartesian_communicator)
            )
        _stack = CommunicatorStack(Communicator(range(ranks), dev, name="global"))
    if custom_communicator_init is not None:
        try:
            custom_communicator_init()
        except BaseException:
            # roll back so a corrected retry of start() works, the cartesian
            # constant set above included
            with _lock:
                _stack = None
                if not constants.constants_frozen():
                    constants.set("use_cartesian_communicator", prev_cartesian)
            raise


def stop() -> None:
    """Teardown (``torchmpi_stop``, ``torch_mpi.cpp:282-306``): waits every
    outstanding async handle, frees every parameter server (stopping its
    polling thread), shuts the offload pools down, then drops the
    communicator stack."""
    global _stack
    from .parameterserver import free_all
    from .runtime.handles import sync_all
    from .runtime.pools import shutdown_all

    sync_all()
    free_all()
    shutdown_all()
    with _lock:
        _stack = None


def started() -> bool:
    return _stack is not None


def _require_stack() -> CommunicatorStack:
    if _stack is None:
        raise NotStartedError("call torchmpi_tpu_torch.start() first")
    return _stack


def stack() -> CommunicatorStack:
    return _require_stack()


def current_communicator() -> Communicator:
    return _require_stack().current


def rank() -> int:
    """Rank of this process in the current communicator: one process owns
    every virtual rank, so 0 (per-rank data is rank-stacked, as in the JAX
    package's single-controller mode)."""
    current_communicator()
    return 0


def size() -> int:
    """Number of (virtual) ranks in the current communicator."""
    return current_communicator().size


def push_communicator(keys: KeySpec, name: Optional[str] = None) -> int:
    """Split the *current* communicator by keys and push the result
    (``torch_mpi.cpp:75-79,251-255``). Returns the new level."""
    st = _require_stack()
    return st.push(split_by_keys(st.current, keys, name=name))


def set_communicator(level: int) -> None:
    _require_stack().set_current(level)


def communicator_names() -> List[str]:
    return _require_stack().names()


def describe() -> str:
    """Multi-line topology dump of the whole communicator stack
    (``torch_mpi.cpp:105-127``), marking the current level and span."""
    st = _require_stack()
    begin, end = st.span
    lines = [
        f"communicator stack (depth={st.depth}, current level={end}, "
        f"span=[{begin}, {end}])"
    ]
    for level in range(st.depth):
        marker = "*" if level == end else " "
        desc = st.at(level).describe().replace("\n", "\n      ")
        lines.append(f" {marker}[{level}] {desc}")
    return "\n".join(lines)


def _reset_for_tests() -> None:
    stop()
