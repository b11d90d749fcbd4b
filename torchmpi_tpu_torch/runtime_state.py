"""Global runtime state: the started flag and the communicator stack.

The port of ``torchmpi_tpu/runtime_state.py`` (``lib/torch_mpi.cpp:38-51``
state plus the start/stop lifecycle of ``torch_mpi.cpp:233-306``). Where
the JAX ``start()`` takes the process's devices as ranks, this one takes a
rank count and one device: ``start(ranks=p)`` stands for the JAX test
mesh's ``--cpu-mesh p`` virtual devices, all held on one CUDA card. Given
a coordinator (``start(coordinator_address=, num_processes=,
process_id=)``, or the launcher's ``TORCHMPI_TPU_*`` environment),
``ranks`` is the process's own rank count, the world is every process's
ranks in process order, and the control plane and the slabs of
``runtime/peers.py`` carry what crosses processes.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, List, Optional, Sequence, Tuple, Union

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
# the processes' control plane (runtime/peers.py) while a multi-process
# runtime is started
_plane = None


class NotStartedError(RuntimeError):
    pass


def _apply_env_constants() -> None:
    """Apply the ``TORCHMPI_TPU_CONSTANTS`` knob overrides
    (``name=value;name=value``, as ``launch --set-constant`` sets them for
    the JAX package). Values are coerced to the knob's current type (a
    bool takes 1/0/true/false/yes/no/on/off); an unknown name or a value
    that does not coerce raises."""
    spec = os.environ.get("TORCHMPI_TPU_CONSTANTS", "")
    if not spec:
        return
    snap = constants.snapshot()
    for item in spec.split(";"):
        if not item.strip():
            continue
        name, _, raw = item.partition("=")
        name, raw = name.strip(), raw.strip()
        if name not in snap:
            raise KeyError(
                f"TORCHMPI_TPU_CONSTANTS names unknown knob {name!r} "
                "(see constants.snapshot() for valid knobs)"
            )
        current = snap[name]
        if isinstance(current, bool):
            low = raw.lower()
            if low not in ("1", "true", "yes", "on", "0", "false", "no", "off"):
                raise ValueError(
                    f"TORCHMPI_TPU_CONSTANTS: bool knob {name!r} got {raw!r} "
                    "(expected 1/0/true/false/yes/no/on/off)"
                )
            value: object = low in ("1", "true", "yes", "on")
        elif isinstance(current, int):
            value = int(raw)
        elif isinstance(current, float):
            value = float(raw)
        else:
            value = raw
        constants.set(name, value)


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
    collective_communicator: Optional[Tuple[int, int]] = None,
    precompile_collectives: Optional[Sequence] = None,
    load_tuned_constants: bool = True,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    with_ici_groups: bool = True,
    **constant_overrides,
) -> None:
    """Initialise the runtime (``MPI.start``, ``torchmpi/init.lua:31-100``).

    - ``ranks`` — the number of virtual ranks of this process (the JAX
      tests' and verify recipe's 8-device CPU mesh by default); the
      launcher's ``TORCHMPI_TPU_LOCAL_RANKS`` (``--cpu-devices K``) wins.
    - ``device`` — where every rank's tensors live; ``None`` is ``cuda:0``
      (``'cpu'`` under the launcher's ``TORCHMPI_TPU_FORCE_CPU``).
    - ``coordinator_address``/``num_processes``/``process_id`` — a job of
      several processes (``init.lua``'s ``MPI_Init``; the JAX package's
      ``jax.distributed.initialize``): ``host:port`` of process 0, which
      the control plane's gloo group meets at. Read from
      ``TORCHMPI_TPU_COORDINATOR``, ``TORCHMPI_TPU_NUM_PROCESSES`` and
      ``TORCHMPI_TPU_PROCESS_ID`` when the first is set (``python -m
      torchmpi_tpu_torch.launch`` sets all three). The world is the sum of
      every process's ``ranks``, process 0's first; a process's
      rank-stacked tensors then hold its own rows only.
    - ``with_ici_groups`` — in a job of several processes, push a
      per-process level (keys ``host<process> ici group``) and set the
      span to it and the level below (``initPerNodeCommunicators``,
      ``init.lua:417-461``).
    - ``with_cartesian_communicator`` — cartesian vs tree mode, set
      *before* building communicators (``init.lua:61-65``).
    - ``custom_communicator_init`` — callback run right after start, in
      which user code may :func:`push_communicator` (``init.lua:84-91``).
    - ``collective_communicator`` — an explicit ``(begin, end)`` span.
    - ``precompile_collectives`` — declared collective specs (see
      :func:`~torchmpi_tpu_torch.collectives.eager.precompile`) whose plans
      are compiled and pinned before ``start()`` returns, against the
      communicator the collectives will use, so step 1 of training plans
      no collective. Runs after the tuned constants load.
    - ``load_tuned_constants`` — re-apply the autotuner's persisted
      constants and plan overrides for this (device type, world size)
      (:func:`~torchmpi_tpu_torch.utils.autotune.load_tuning`) and the
      persisted cost-model calibration
      (:func:`~torchmpi_tpu_torch.schedule.load_calibration`), each
      best-effort, unless the constants are frozen.
    - ``**constant_overrides`` — any :mod:`~torchmpi_tpu_torch.constants`
      knob by name (``start(wire_dtype="int8")``), set after the
      ``TORCHMPI_TPU_CONSTANTS`` overrides, and set again after the tuned
      constants load, so an explicit one always wins. An unknown name
      raises ``KeyError`` before any state changes; the overrides outlive
      a failed or stopped runtime, as any ``constants.set`` does.

    ``start()`` also records the clock-sync triple the offline analyzer
    aligns dumps with, and arms the hang watchdog when
    ``watchdog_timeout_seconds`` is set (``stop()`` stops it).
    """
    global _stack
    for name in constant_overrides:
        if name not in constants.snapshot():
            raise KeyError(
                f"start() got unknown constants override {name!r} "
                "(see constants.snapshot() for valid knobs)"
            )
    if os.environ.get("TORCHMPI_TPU_LOCAL_RANKS"):
        ranks = int(os.environ["TORCHMPI_TPU_LOCAL_RANKS"])
    if device is None and os.environ.get("TORCHMPI_TPU_FORCE_CPU", "").lower() in (
            "1", "true", "yes", "on"):
        device = "cpu"
    if ranks < 1:
        raise ValueError(f"start() needs at least one rank, got {ranks}")
    coordinator_address, num_processes, process_id = _world_from_env(
        coordinator_address, num_processes, process_id)
    dev = resolve_device(device)
    with _lock:
        if _stack is not None:
            raise RuntimeError("torchmpi_tpu_torch.start() called twice")
    _apply_env_constants()
    for name, value in constant_overrides.items():
        constants.set(name, value)
    prev_cartesian = constants.get("use_cartesian_communicator")
    try:
        root = _root_communicator(ranks, dev, coordinator_address, num_processes, process_id,
                                  with_cartesian_communicator)
        with _lock:
            if _stack is not None:
                raise RuntimeError("torchmpi_tpu_torch.start() called twice")
            _stack = CommunicatorStack(root)
    except BaseException:
        _abandon_plane()
        if not constants.constants_frozen():
            constants.set("use_cartesian_communicator", prev_cartesian)
        raise
    try:
        import socket

        from . import telemetry

        telemetry.record_clock_sync(
            process_index=root.process_index, process_count=root.num_nodes(),
            rank=int(os.environ.get("TORCHMPI_TPU_PROCESS_ID", root.process_index)),
            host=socket.gethostname(),
        )
        if constants.get("watchdog_timeout_seconds") > 0:
            from .telemetry.watchdog import start_watchdog

            start_watchdog(
                float(constants.get("watchdog_timeout_seconds")),
                interval=float(constants.get("watchdog_interval_seconds")),
            )
        if custom_communicator_init is not None:
            custom_communicator_init()
        if with_ici_groups:
            _init_per_node_communicators()
        if collective_communicator is not None:
            _stack.set_span(*collective_communicator)
        if load_tuned_constants and not constants.constants_frozen():
            # the measured routing constants and plan winners survive
            # restarts (c_api.h:93-95's autotuner, made durable); a bad
            # cache is skipped, the defaults are always safe
            try:
                from .utils.autotune import load_tuning

                load_tuning(comm=_stack.current, apply=True)
            except Exception:
                pass
            # the measured cost-model calibration re-applies alike
            try:
                from .schedule import load_calibration

                load_calibration()
            except Exception:
                pass
            # the environment's and the explicit overrides beat the
            # persisted tuned values (explicit last: it wins over both)
            _apply_env_constants()
            for name, value in constant_overrides.items():
                constants.set(name, value)
        if precompile_collectives:
            from .collectives.eager import precompile

            precompile(precompile_collectives, comm=_stack.current)
    except BaseException:
        # roll back so a corrected retry of start() works, the cartesian
        # constant set above and the control plane included
        with _lock:
            _stack = None
            if not constants.constants_frozen():
                constants.set("use_cartesian_communicator", prev_cartesian)
        _abandon_plane()
        raise


def _world_from_env(coordinator_address, num_processes, process_id):
    """The job's ``(coordinator, processes, process id)``: the arguments,
    else the launcher's environment (``runtime_state.py:149-185`` of the
    JAX package, with its error text); ``(None, None, None)`` for one
    process."""
    if coordinator_address is None and "TORCHMPI_TPU_COORDINATOR" in os.environ:
        coordinator_address = os.environ["TORCHMPI_TPU_COORDINATOR"]
        try:
            if num_processes is None:
                num_processes = int(os.environ["TORCHMPI_TPU_NUM_PROCESSES"])
            if process_id is None:
                process_id = int(os.environ["TORCHMPI_TPU_PROCESS_ID"])
        except KeyError as e:
            raise ValueError(
                "TORCHMPI_TPU_COORDINATOR is set but its companion "
                f"variable {e.args[0]} is missing — export all three "
                "(the launcher sets them together) or pass "
                "coordinator_address/num_processes/process_id explicitly"
            ) from None
    if coordinator_address is None and (num_processes is not None or process_id is not None):
        raise ValueError("num_processes/process_id require coordinator_address")
    if coordinator_address is not None:
        if not coordinator_address:
            raise ValueError("coordinator_address must name host:port of process 0")
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        if not 0 <= int(process_id) < int(num_processes):
            raise ValueError(f"process_id {process_id} outside [0, {num_processes})")
    return coordinator_address, num_processes, process_id


def _root_communicator(ranks: int, dev: torch.device, coordinator: Optional[str],
                       num_processes: Optional[int], process_id: Optional[int],
                       cartesian: Optional[bool]) -> Communicator:
    """The global communicator: ``ranks`` ranks in one process, or every
    process's ranks in process order over a new control plane. The
    cartesian constant is set last, just before the communicator is
    built (``init.lua:61-65``)."""
    global _plane
    processes, index = None, 0
    if coordinator is not None and int(num_processes) > 1:
        from .runtime.peers import ControlPlane

        _plane = ControlPlane(coordinator, int(num_processes), int(process_id))
        counts = _plane.all_gather_object((int(ranks), dev.type))
        kinds = {kind for _, kind in counts}
        if len(kinds) > 1:
            raise RuntimeError(f"the processes' ranks live on different device types {kinds}")
        processes = [q for q, (n, _) in enumerate(counts) for _ in range(n)]
        index = _plane.index
    if cartesian is not None:
        constants.set("use_cartesian_communicator", bool(cartesian))
    size = len(processes) if processes is not None else ranks
    return Communicator(range(size), dev, name="global", processes=processes,
                        process_index=index)


def _abandon_plane() -> None:
    global _plane
    plane, _plane = _plane, None
    if plane is not None:
        plane.abandon()


def _init_per_node_communicators() -> None:
    """Push a per-process level and set the two-level span,
    ``initPerNodeCommunicators`` (``init.lua:417-461``; the JAX package's
    ``_init_per_node_communicators``, ``runtime_state.py:302-312``). In
    one process the global communicator is already one node."""
    root = _stack.at(0)
    if root.num_nodes() <= 1:
        return
    keys = [f"host{root.process_of(r)} ici group" for r in range(root.size)]
    level = _stack.push(split_by_keys(root, keys, name="per-node ici groups"))
    # span (level-1, level): hierarchical collectives compose the per-node
    # intra groups with the cross-node inter comm (init.lua:445-446)
    _stack.set_span(max(0, level - 1), level)


def plane():
    """The control plane of a multi-process runtime (None in one
    process)."""
    return _plane


def stop() -> None:
    """Teardown (``torchmpi_stop``, ``torch_mpi.cpp:282-306``): waits every
    outstanding async handle, frees every parameter server (stopping its
    polling thread), frees every stack level's collective resources,
    shuts the offload pools down, then drops the communicator stack. In a
    job of several processes it then waits for the device's work, meets
    every process at a barrier, unmaps the peers' slabs, frees its own and
    tears the control plane down, in that order; once a cross-process
    call has failed, it drops the plane and the stack without meeting the
    peers and raises the failure."""
    global _stack, _plane
    from .collectives.eager import free_collective_resources
    from .parameterserver import free_all
    from .runtime.handles import sync_all
    from .runtime.pools import shutdown_all

    from .telemetry.watchdog import stop_watchdog

    plane = _plane
    try:
        sync_all()
        free_all()
        if _stack is not None:
            for level in range(_stack.depth):
                free_collective_resources(_stack.at(level))
        shutdown_all()
        # the start()-scoped watchdog; one armed from the environment lives
        # as long as the process
        stop_watchdog(only_source="constants")
        if plane is not None:
            if _stack is not None and _stack.at(0).device.type == "cuda":
                torch.cuda.synchronize(_stack.at(0).device)
            plane.barrier()
    except BaseException:
        if plane is not None:
            # a cross-process call failed: the processes are out of step,
            # so the plane goes without meeting them, and so does the stack
            plane.issue.close()
            _abandon_plane()
            with _lock:
                _stack = None
        raise
    if plane is not None:
        plane.close()
    with _lock:
        _stack = None
        _plane = None


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
    """Rank of this process's first rank in the current communicator
    (``runtime_state.py:367-387`` of the JAX package): 0 in one process,
    which owns every virtual rank (per-rank data is rank-stacked, as in
    the JAX package's single-controller mode); in a job of several
    processes the global index of the process's first rank, so
    ``offset = rank() * per_rank`` sharding works per process."""
    local = current_communicator().local_ranks
    return local[0] if local else 0


def local_ranks() -> List[int]:
    """The ranks of the current communicator this process owns, in rank
    order: the rows of its rank-stacked tensors."""
    return current_communicator().local_ranks


def size() -> int:
    """Number of (virtual) ranks in the current communicator."""
    return current_communicator().size


def num_processes() -> int:
    """Processes in the job."""
    return _plane.count if _plane is not None else 1


def push_communicator(keys: KeySpec, name: Optional[str] = None) -> int:
    """Split the *current* communicator by keys and push the result
    (``torch_mpi.cpp:75-79,251-255``). Returns the new level."""
    st = _require_stack()
    return st.push(split_by_keys(st.current, keys, name=name))


def set_communicator(level: int) -> None:
    _require_stack().set_current(level)


def set_collective_span(begin: int, end: int) -> None:
    _require_stack().set_span(begin, end)


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


def num_nodes_in_communicator(level: Optional[int] = None) -> int:
    """Nodes the communicator at ``level`` (the current one for None)
    spans."""
    st = _require_stack()
    comm = st.current if level is None else st.at(level)
    return comm.num_nodes()


def _reset_for_tests() -> None:
    stop()
