"""Routing-constant autotuner with persistence.

The port of ``torchmpi_tpu/utils/autotune.py``. The reference ships
hand-tuned small-message cutoffs and leaves autotuning as a TODO
("implement an autotuner; YMMV", ``lib/c_api.h:93-95``). Every routing
constant is set here from measurement on the *actual* communicator:

- :func:`tune_allreduce_cutoff` / :func:`tune_broadcast_cutoff`: the
  element count where the custom ring starts beating the vendor path
  (``kSmallAllreduceSize`` / ``kSmallBcastSize``,
  ``lib/constants.cpp:136-141``).
- :func:`tune_tree_pipeline_switch`: the byte size where the pipelined
  ring broadcast overtakes the binomial tree
  (``kBcastSizeTreeBased``, ``lib/constants.cpp:146-147``).
- :func:`tune_chunk_size`: the best max ring-message size of the
  ``ring`` backend (``kMin/kMaxBufferSize``, ``lib/constants.cpp:142-145``).
- :func:`tune_ring_implementation`: ``ppermute`` (the ``ring`` backend)
  against ``kernel`` (K3) and ``kernel_bidir`` (K5), measured.
- :func:`tune_wire_dtype`: full vs bf16 vs int8 on-wire encoding (K4 on
  the kernel backend) for the bandwidth-path reductions.
- :func:`tune_plan`: measured candidate-plan search for the schedule
  compiler; the winner persists as a plan override per plan-cache key.
- :func:`tune_pipeline_depth`: measured chunk-pipeline depth of the
  ``ring`` plan family (the only one that threads a depth); the winner
  pins ``plan_pipeline_depth``.
- :func:`tune_fusion_threshold`: ``fusion_buffer_bytes`` on the LeNet
  gradient leaves.
- :func:`tune_ps_chunk_bytes`: raises, naming ROADMAP A7's rest (the PS
  transport it times is not ported).

Where the JAX tuners measure ``pallas``, these measure ``kernel`` (the
hand-written CUDA kernels): the custom ring a tuner times is the one that
serves the traffic, ``kernel`` on a CUDA communicator under
``ring_implementation`` 'kernel' or 'kernel_bidir', else ``ring``. As in
JAX, each call is timed on the host clock around a device synchronise
(``utils/tester.py``): a small-message cutoff is decided by what the
caller pays, host dispatch included.

There is no fallback past a broken kernel: on a CUDA communicator a
candidate on the kernel backend that sums wrong raises
:class:`KernelResultError` out of its tuner (one that raises propagates
as it is), where the JAX tuners would record it and let another
candidate win. :func:`tune_all` then restores the constants and plan
overrides it found and persists nothing.

:func:`tune_all` runs everything; results persist per ``(device type,
world size)`` (``cuda:8``, ``cpu:8``) in a JSON cache
(``~/.cache/torchmpi_tpu_torch/autotune.json`` or
``$TORCHMPI_TPU_TUNING_CACHE``) and :func:`load_tuning` re-applies them,
as ``start()`` does.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from .. import constants, telemetry
from ..ops._build import KernelResultError
from ..runtime.communicator import Communicator
from .tester import run_one_config, sweep_sizes


def _require_kernel_ok(comm: Communicator, backend: str, correct: bool, what: str) -> None:
    """Raise :class:`KernelResultError` where a candidate on the kernel
    backend of a CUDA communicator read incorrect: the tuner must not
    pick another candidate past it."""
    if not correct and backend == "kernel" and comm.device.type == "cuda":
        raise KernelResultError(
            f"{what} on the kernel backend gave a wrong result on {comm.device}"
        )


def _audit_decision(knob: str, chosen, applied: bool, candidates) -> None:
    """Every tuned knob lands in the telemetry audit journal with the
    measurements that justified it. Always on: tuning is a cold path and
    the journal is bounded."""
    telemetry.audit(
        "autotune",
        knob=knob,
        chosen=chosen,
        applied=bool(applied),
        candidates=[list(c) for c in candidates],
    )

# constants a tuning run may set; only these are persisted/applied
_TUNABLE = (
    "small_allreduce_size_{s}",
    "small_broadcast_size_{s}",
    "broadcast_size_tree_based_{s}",
    "min_buffer_size_{s}",
    "max_buffer_size_{s}",
    "ring_implementation",
    "wire_dtype",
    "fusion_buffer_bytes",
    "ps_chunk_bytes",
    "plan_pipeline_depth",
)

#: canonical LeNet gradient leaf element counts (conv1 w/b, conv2 w/b,
#: fc1-3 w/b), the latency-bound workload :func:`tune_fusion_threshold`
#: coalesces
LENET_LEAF_SIZES = (150, 6, 2400, 16, 48000, 120, 10080, 84, 840, 10)

#: why :func:`tune_ps_chunk_bytes` cannot run in the port
PS_CHUNK_REASON = (
    "tune_ps_chunk_bytes times the parameter server's socket transport, "
    "which is not ported (ROADMAP A7's rest, over the processes of ROADMAP A13)"
)


def _comm(comm: Optional[Communicator]) -> Communicator:
    if comm is not None:
        return comm
    from .. import runtime_state

    return runtime_state.current_communicator()


def _check_unfrozen(apply: bool, measure_mutates: bool = False) -> None:
    if constants.constants_frozen() and (apply or measure_mutates):
        # fail fast: the expensive sweep would end in FrozenConstantsError
        if measure_mutates:
            raise constants.FrozenConstantsError(
                "constants are frozen; this tuner must temporarily set "
                "constants to pin each measured configuration, so it cannot "
                "run at all after freeze_constants()"
            )
        raise constants.FrozenConstantsError(
            "constants are frozen; call with apply=False to only measure"
        )


def _suffix(comm: Communicator) -> str:
    return constants.platform_suffix(comm.device.type)


def _custom_backend(comm: Communicator) -> str:
    """The custom ring that serves this communicator's traffic: the CUDA
    kernels where they are available and ``ring_implementation`` names
    them, else the ``ring`` backend (the JAX tuners' pallas-or-ppermute
    choice)."""
    from ..collectives.selector import backend_availability

    if backend_availability(comm.device).get("kernel") and constants.get(
        "ring_implementation"
    ) in ("kernel", "kernel_bidir"):
        return "kernel"
    return "ring"


def _block(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_laps(run, device: torch.device, warmup: int, timed: int):
    """``warmup + timed`` calls of ``run``, each timed on the host clock
    through a device synchronise; returns (the last output, the timed
    laps in seconds)."""
    laps = []
    out = None
    for it in range(warmup + timed):
        t0 = time.perf_counter()
        out = run()
        _block(device)
        if it >= warmup:
            laps.append(time.perf_counter() - t0)
    return out, laps


def _tune_small_cutoff(
    op: str,
    comm: Optional[Communicator],
    min_pow: int,
    max_pow: int,
    warmup: int,
    timed: int,
    apply: bool,
) -> Tuple[int, List]:
    comm = _comm(comm)
    _check_unfrozen(apply)
    suffix = _suffix(comm)
    custom = _custom_backend(comm)
    results = []
    crossover = None
    for n in sweep_sizes(min_pow, max_pow, jitter_seed=None):
        xla = run_one_config(
            op, n, comm, backend="xla", benchmark=True,
            warmup=warmup, timed=timed, route_override=False,
        )
        ring = run_one_config(
            op, n, comm, backend=custom, benchmark=True,
            warmup=warmup, timed=timed, route_override=False,
        )
        _require_kernel_ok(comm, custom, ring.correct, f"{op} of {n} elements")
        results.append((n, xla.mean_us, ring.mean_us))
        if crossover is None and ring.mean_us < xla.mean_us:
            # op_route keeps nelem <= cutoff on the vendor path, so the
            # cutoff must sit strictly BELOW the first ring win
            crossover = n - 1
    # Never-crosses -> keep everything on the vendor path (huge cutoff).
    cutoff = crossover if crossover is not None else 1 << (max_pow + 4)
    if apply:
        constants.set(f"small_{op}_size_{suffix}", int(cutoff))
    _audit_decision(f"small_{op}_size_{suffix}", int(cutoff), apply, results)
    return int(cutoff), results


def tune_allreduce_cutoff(
    comm: Optional[Communicator] = None,
    min_pow: int = 8,
    max_pow: int = 20,
    warmup: int = 3,
    timed: int = 5,
    apply: bool = True,
) -> Tuple[int, List]:
    """Find the element count where the custom ring (K3 on the card)
    starts beating the vendor path for allreduce; optionally set it as the
    platform cutoff. Returns ``(cutoff_elements, measurements)``."""
    return _tune_small_cutoff(
        "allreduce", comm, min_pow, max_pow, warmup, timed, apply
    )


def tune_broadcast_cutoff(
    comm: Optional[Communicator] = None,
    min_pow: int = 8,
    max_pow: int = 20,
    warmup: int = 3,
    timed: int = 5,
    apply: bool = True,
) -> Tuple[int, List]:
    """Same crossover search for broadcast (``kSmallBcastSize``). The
    kernel backend broadcasts by the binomial tree at or below
    ``broadcast_size_tree_based`` bytes and by K7 above it."""
    return _tune_small_cutoff(
        "broadcast", comm, min_pow, max_pow, warmup, timed, apply
    )


def _pinned_ring_broadcast_us(
    comm: Communicator, n: int, force_tree: bool, warmup: int, timed: int
) -> float:
    """Measure the custom ring broadcast with the tree/pipeline decision
    pinned by temporarily moving the switch constant."""
    suffix = _suffix(comm)
    name = f"broadcast_size_tree_based_{suffix}"
    prev = constants.get(name)
    constants.set(name, (1 << 62) if force_tree else 0)
    backend = _custom_backend(comm)
    try:
        res = run_one_config(
            "broadcast", n, comm, backend=backend, benchmark=True,
            warmup=warmup, timed=timed, route_override=False,
        )
    finally:
        constants.set(name, prev)
    _require_kernel_ok(comm, backend, res.correct,
                       f"{'tree' if force_tree else 'pipelined'} broadcast of {n} elements")
    return res.mean_us


def tune_tree_pipeline_switch(
    comm: Optional[Communicator] = None,
    min_pow: int = 10,
    max_pow: int = 22,
    warmup: int = 3,
    timed: int = 5,
    apply: bool = True,
) -> Tuple[int, List]:
    """Find the message size (BYTES) where the pipelined ring broadcast
    (K7 on the card) overtakes the binomial tree; set
    ``broadcast_size_tree_based``. Returns ``(switch_bytes,
    measurements)``.

    Requires unfrozen constants even with ``apply=False``: the measurement
    itself pins each variant by temporarily moving the switch constant."""
    comm = _comm(comm)
    _check_unfrozen(apply, measure_mutates=True)
    suffix = _suffix(comm)
    results = []
    crossover_bytes = None
    for n in sweep_sizes(min_pow, max_pow, jitter_seed=None):
        tree_us = _pinned_ring_broadcast_us(comm, n, True, warmup, timed)
        pipe_us = _pinned_ring_broadcast_us(comm, n, False, warmup, timed)
        results.append((n, tree_us, pipe_us))
        if crossover_bytes is None and pipe_us < tree_us:
            crossover_bytes = n * 4 - 1  # f32 sweep; switch sits below
    switch = crossover_bytes if crossover_bytes is not None else 1 << 62
    if apply:
        constants.set(f"broadcast_size_tree_based_{suffix}", int(switch))
    _audit_decision(
        f"broadcast_size_tree_based_{suffix}", int(switch), apply, results
    )
    return int(switch), results


def tune_chunk_size(
    comm: Optional[Communicator] = None,
    nelem: int = 1 << 20,
    candidates: Tuple[int, ...] = (1 << 17, 1 << 18, 1 << 19, 1 << 20, 1 << 22),
    warmup: int = 2,
    timed: int = 4,
    apply: bool = True,
) -> Tuple[int, List]:
    """Pick the max ring-message size (BYTES) minimizing the ``ring``
    backend's large-allreduce latency (the kernels size their own
    chunks); sets ``max_buffer_size`` (and ``min_buffer_size`` = max/8).
    Returns ``(best_max_bytes, measurements)``.

    Requires unfrozen constants even with ``apply=False``: each candidate
    is measured by temporarily setting the buffer-size constants."""
    comm = _comm(comm)
    _check_unfrozen(apply, measure_mutates=True)
    suffix = _suffix(comm)
    max_name = f"max_buffer_size_{suffix}"
    min_name = f"min_buffer_size_{suffix}"
    prev_max, prev_min = constants.get(max_name), constants.get(min_name)
    results = []
    best = (float("inf"), prev_max)
    try:
        for cand in candidates:
            constants.set(max_name, int(cand))
            constants.set(min_name, int(max(1, cand // 8)))
            res = run_one_config(
                "allreduce", nelem, comm, backend="ring", benchmark=True,
                warmup=warmup, timed=timed, route_override=False,
            )
            results.append((cand, res.mean_us))
            if res.mean_us < best[0]:
                best = (res.mean_us, cand)
    finally:
        constants.set(max_name, prev_max)
        constants.set(min_name, prev_min)
    if apply:
        constants.set(max_name, int(best[1]))
        constants.set(min_name, int(max(1, best[1] // 8)))
    _audit_decision(max_name, int(best[1]), apply, results)
    return int(best[1]), results


def tune_ring_implementation(
    comm: Optional[Communicator] = None,
    nelem: int = 1 << 20,
    warmup: int = 2,
    timed: int = 4,
    apply: bool = True,
) -> Tuple[str, List]:
    """Measure ``ppermute`` (the ``ring`` backend) against ``kernel`` (K3)
    and ``kernel_bidir`` (K5) for the custom ring allreduce and set
    ``ring_implementation`` to the fastest. Keeps 'ppermute' where the
    kernels are unavailable (the CPU), as JAX keeps it without pallas; a
    kernel that sums wrong raises :class:`KernelResultError`."""
    comm = _comm(comm)
    # measure_mutates: the sweep itself flips ring_implementation to time
    # each kernel, so frozen constants must fail fast even with apply=False
    _check_unfrozen(apply, measure_mutates=True)
    from ..collectives.selector import backend_availability

    results = []
    winner = "ppermute"
    if backend_availability(comm.device).get("kernel"):
        ring = run_one_config(
            "allreduce", nelem, comm, backend="ring", benchmark=True,
            warmup=warmup, timed=timed, route_override=False,
        )
        results = [("ppermute", ring.mean_us)]
        best_us = ring.mean_us
        prev = constants.get("ring_implementation")
        try:
            for impl in ("kernel", "kernel_bidir"):
                constants.set("ring_implementation", impl)
                res = run_one_config(
                    "allreduce", nelem, comm, backend="kernel",
                    benchmark=True, warmup=warmup, timed=timed,
                    route_override=False,
                )
                _require_kernel_ok(comm, "kernel", res.correct, f"ring_implementation {impl!r}")
                results.append((impl, res.mean_us))
                if res.mean_us < best_us:
                    winner, best_us = impl, res.mean_us
        finally:
            constants.set("ring_implementation", prev)
    if apply:
        constants.set("ring_implementation", winner)
    _audit_decision("ring_implementation", winner, apply, results)
    return winner, results


def tune_wire_dtype(
    comm: Optional[Communicator] = None,
    nelem: int = 1 << 20,
    warmup: int = 2,
    timed: int = 4,
    apply: bool = True,
) -> Tuple[str, List]:
    """Measure the wire encodings ('full', 'bf16', 'int8') for the large
    custom-ring allreduce and set ``wire_dtype`` to the fastest CORRECT
    one; compression must earn its place on the wire. Measures the ring
    that would serve the traffic: K3/K5 and K4 on the kernel backend
    (through the already-tuned ``ring_implementation``), else the ``ring``
    backend. On the card an encoding whose kernel sums wrong raises
    :class:`KernelResultError` (the tuner's payload, rank r contributing
    r, is exact on every wire).

    Requires unfrozen constants even with ``apply=False``: the sweep pins
    each encoding by temporarily setting the ``wire_dtype`` constant."""
    comm = _comm(comm)
    _check_unfrozen(apply, measure_mutates=True)
    backend = _custom_backend(comm)
    prev = constants.get("wire_dtype")
    results: List = []
    best = (float("inf"), "full")
    try:
        for wire in ("full", "bf16", "int8"):
            constants.set("wire_dtype", wire)
            res = run_one_config(
                "allreduce", nelem, comm, backend=backend, benchmark=True,
                warmup=warmup, timed=timed, route_override=False,
            )
            _require_kernel_ok(comm, backend, res.correct, f"wire_dtype {wire!r}")
            results.append((wire, res.mean_us))
            if res.correct and res.mean_us < best[0]:
                best = (res.mean_us, wire)
    finally:
        constants.set("wire_dtype", prev)
    if apply:
        constants.set("wire_dtype", best[1])
    _audit_decision("wire_dtype", best[1], apply, results)
    return best[1], results


def _all_equal(out: torch.Tensor, value: float) -> bool:
    """numpy's ``allclose(out, value, rtol=1e-4)``, on the tensor's
    device."""
    return bool(torch.allclose(out, torch.full_like(out, value), rtol=1e-4))


def tune_plan(
    comm: Optional[Communicator] = None,
    op: str = "allreduce",
    nelem: int = 1 << 20,
    warmup: int = 2,
    timed: int = 4,
    apply: bool = True,
) -> Tuple[str, List]:
    """Measured candidate-plan search: run every *structurally possible*
    schedule family (flat / hier / staged / tree, and the synthesized
    families under ``use_plan_synthesis``) the compiler generates for a
    large ``op`` on THIS communicator's declared topology, and persist the
    winner as a plan override for its plan-cache key
    (``set_plan_override``, keyed like the plan cache: op, topology
    fingerprint, payload bucket, wire), saved in the tuning cache and
    re-applied by ``start()``. A family that raises when it runs
    propagates (the JAX tuner skips it), and one that sums wrong is
    reported ``incorrect``, or on the card's kernel backend raises
    :class:`KernelResultError`."""
    comm = _comm(comm)
    from ..collectives import eager
    from ..schedule import compiler as _sched
    from ..schedule import generators as _gen
    from ..schedule.topology import Topology

    backend = _custom_backend(comm)
    topo = Topology.from_communicator(comm)
    wire = eager.resolve_wire_dtype(op, nelem, torch.float32, None)
    okey = _sched.override_key(
        op, topo.fingerprint(), _sched.payload_bucket(nelem * 4), wire
    )
    cands = _gen.candidate_plans(
        op, nelem, 4, topo, backend, wire=wire, route_small=True
    )
    p = comm.size
    x = torch.ones((p, nelem), dtype=torch.float32, device=comm.device)
    results: List = []
    best = (float("inf"), None)
    measured = set()
    for cand in cands:
        if not cand.structural:
            continue
        gen = cand.plan.generator
        if gen in measured:
            continue  # vendor + custom flat candidates share one generator
        measured.add(gen)
        ep = _sched.compile_collective(
            op, (p, nelem), torch.float32, comm,
            generator=gen, impl=backend, wire_override=wire,
        )
        out, laps = _timed_laps(lambda: ep.execute(x), comm.device, warmup, timed)
        if not _all_equal(out, float(p)):
            _require_kernel_ok(comm, backend, False, f"the {gen!r} plan")
            results.append((gen, None, "incorrect"))
            continue
        mean_us = 1e6 * sum(laps) / max(1, len(laps))
        results.append((gen, mean_us))
        if mean_us < best[0]:
            best = (mean_us, gen)
    winner = best[1] or "flat"
    if apply:
        _sched.set_plan_override(okey, winner)
    _audit_decision(f"plan:{okey}", winner, apply, results)
    return winner, results


def tune_pipeline_depth(
    comm: Optional[Communicator] = None,
    nelem: int = 1 << 20,
    warmup: int = 2,
    timed: int = 4,
    apply: bool = True,
) -> Tuple[int, List]:
    """Measure the chunk-pipeline depths (1, 2, 4, ... per the
    ``plan_pipeline_*`` knobs) for the large flat ``ring`` allreduce on
    THIS communicator and pin the fastest CORRECT one as
    ``plan_pipeline_depth``. Depth 1 pins pipelining off; the analytic
    stage-overlap model decides only where no measurement has spoken
    (the default 0). The kernels schedule their own pipeline, so the
    ``ring`` family is the one measured, as in JAX.

    Requires unfrozen constants even with ``apply=False``: the sweep
    pins each depth by temporarily setting ``plan_pipeline_depth``."""
    comm = _comm(comm)
    _check_unfrozen(apply, measure_mutates=True)
    from ..collectives import eager
    from ..schedule import compiler as _sched
    from ..schedule import pipeline as _pipe

    wire = eager.resolve_wire_dtype("allreduce", nelem, torch.float32, None)
    depths = [1] + _pipe.depth_candidates(nelem * 4)
    p = comm.size
    x = torch.ones((p, nelem), dtype=torch.float32, device=comm.device)
    prev = constants.get("plan_pipeline_depth")
    results: List = []
    best = (float("inf"), 1)
    try:
        for d in depths:
            constants.set("plan_pipeline_depth", int(d))
            ep = _sched.compile_collective(
                "allreduce", (p, nelem), torch.float32, comm,
                generator="flat", impl="ring", wire_override=wire,
            )
            out, laps = _timed_laps(lambda: ep.execute(x), comm.device, warmup, timed)
            if not _all_equal(out, float(p)):
                results.append((d, None, "incorrect"))
                continue
            mean_us = 1e6 * sum(laps) / max(1, len(laps))
            results.append((d, mean_us))
            if mean_us < best[0]:
                best = (mean_us, d)
    finally:
        constants.set("plan_pipeline_depth", prev)
    if apply:
        constants.set("plan_pipeline_depth", int(best[1]))
    _audit_decision("plan_pipeline_depth", int(best[1]), apply, results)
    return int(best[1]), results


def tune_fusion_threshold(
    comm: Optional[Communicator] = None,
    leaf_sizes: Optional[Tuple[int, ...]] = None,
    candidates: Tuple[int, ...] = (0, 1 << 18, 1 << 20, 4 << 20, 16 << 20),
    warmup: int = 2,
    timed: int = 5,
    apply: bool = True,
) -> Tuple[int, List]:
    """Measure the coalescing dispatch (``FusionBuffer``) end to end on a
    canonical small-tensor set (default: the LeNet gradient leaves) under
    candidate ``fusion_buffer_bytes`` values, including 0 (coalescing
    disabled), and set the constant to the fastest. A candidate whose
    sums come out wrong is reported ``incorrect`` and skipped (the JAX
    tuner does not check them), or raises :class:`KernelResultError`
    where its flushes run on the card's kernels.

    Requires unfrozen constants even with ``apply=False``: each candidate
    is measured by temporarily setting ``fusion_buffer_bytes``."""
    comm = _comm(comm)
    _check_unfrozen(apply, measure_mutates=True)
    from ..collectives.fusion import get_fusion_buffer

    backend = _custom_backend(comm)
    sizes = tuple(leaf_sizes or LENET_LEAF_SIZES)
    p = comm.size
    xs = [torch.ones((p, n), dtype=torch.float32, device=comm.device) for n in sizes]
    prev = constants.get("fusion_buffer_bytes")
    results: List = []
    best = (float("inf"), prev)

    def flush_set(fb):
        handles = [fb.submit("allreduce", x) for x in xs]
        fb.flush_all(reason="explicit")
        return [h.wait() for h in handles]

    try:
        for cand in candidates:
            constants.set("fusion_buffer_bytes", int(cand))
            fb = get_fusion_buffer(comm)
            outs, laps = _timed_laps(lambda: flush_set(fb), comm.device, warmup, timed)
            if not all(_all_equal(o, float(p)) for o in outs):
                _require_kernel_ok(comm, backend, False, f"fusion_buffer_bytes {int(cand)}")
                results.append((int(cand), None, "incorrect"))
                continue
            mean_us = 1e6 * sum(laps) / max(1, len(laps))
            results.append((int(cand), mean_us))
            if mean_us < best[0]:
                best = (mean_us, int(cand))
    finally:
        constants.set("fusion_buffer_bytes", prev)
    if apply:
        constants.set("fusion_buffer_bytes", int(best[1]))
    _audit_decision("fusion_buffer_bytes", int(best[1]), apply, results)
    return int(best[1]), results


def tune_ps_chunk_bytes(
    comm: Optional[Communicator] = None,
    nelem: int = 1 << 18,
    candidates: Tuple[int, ...] = (0, 1 << 16, 1 << 18, 1 << 20),
    warmup: int = 2,
    timed: int = 5,
    apply: bool = True,
) -> Tuple[int, List]:
    """The JAX tuner times the PS transport's shard round trip over a real
    loopback listener under candidate ``ps_chunk_bytes`` values. The port
    has no PS transport yet, so after the frozen-constants check (as in
    JAX) this raises ``NotImplementedError`` naming ROADMAP A7's rest."""
    _comm(comm)
    _check_unfrozen(apply, measure_mutates=True)
    raise NotImplementedError(PS_CHUNK_REASON)


def tune_all(
    comm: Optional[Communicator] = None,
    quick: bool = True,
    apply: bool = True,
    persist: bool = True,
) -> Dict[str, object]:
    """Run every tuner and (optionally) persist the resulting constants for
    this (device type, world size). ``quick`` shrinks the sweeps for
    CI-scale runs. ``ps_chunk_bytes`` holds :data:`PS_CHUNK_REASON`, the
    reason its tuner cannot run. A tuner that raises (a kernel that
    fails on the card among them) leaves the constants and plan
    overrides as they were before the call, and nothing is persisted."""
    comm = _comm(comm)
    _check_unfrozen(apply)
    from ..schedule import compiler as _sched

    before = constants.snapshot()
    overrides = dict(_sched.plan_overrides())
    try:
        out = _tune_each(comm, quick, apply)
    except BaseException:
        for name, value in before.items():
            if constants.get(name) != value:
                constants.set(name, value)
        _sched.clear_plan_overrides()
        _sched.apply_plan_overrides(overrides)
        raise
    if apply and persist:
        save_tuning(comm)
    return out


def _tune_each(comm: Communicator, quick: bool, apply: bool) -> Dict[str, object]:
    max_pow = 16 if quick else 20
    big = 1 << (16 if quick else 20)
    out: Dict[str, object] = {}
    out["small_allreduce"] = tune_allreduce_cutoff(
        comm, max_pow=max_pow, apply=apply
    )[0]
    out["small_broadcast"] = tune_broadcast_cutoff(
        comm, max_pow=max_pow, apply=apply
    )[0]
    out["tree_pipeline_switch"] = tune_tree_pipeline_switch(
        comm, max_pow=max_pow + 2, apply=apply
    )[0]
    out["chunk_size"] = tune_chunk_size(comm, nelem=big, apply=apply)[0]
    out["ring_implementation"] = tune_ring_implementation(
        comm, nelem=big, apply=apply
    )[0]
    out["wire_dtype"] = tune_wire_dtype(comm, nelem=big, apply=apply)[0]
    out["plan"] = tune_plan(
        comm, nelem=big, timed=3 if quick else 5, apply=apply
    )[0]
    out["plan_pipeline_depth"] = tune_pipeline_depth(
        comm, nelem=big, timed=3 if quick else 5, apply=apply
    )[0]
    out["fusion_buffer_bytes"] = tune_fusion_threshold(
        comm, timed=3 if quick else 5, apply=apply
    )[0]
    try:
        out["ps_chunk_bytes"] = tune_ps_chunk_bytes(
            comm, nelem=big, timed=3 if quick else 5, apply=apply
        )[0]
    except NotImplementedError as exc:
        out["ps_chunk_bytes"] = str(exc)
    return out


# ---------------------------------------------------------------------------
# persistence per (device type, world size)
# ---------------------------------------------------------------------------


def _cache_path() -> Path:
    env = os.environ.get("TORCHMPI_TPU_TUNING_CACHE")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "torchmpi_tpu_torch" / "autotune.json"


def _cache_key(comm: Communicator) -> str:
    return f"{comm.device.type}:{comm.size}"


def save_tuning(comm: Optional[Communicator] = None) -> Path:
    """Persist the current values of every tunable routing constant, and
    the measured plan winners, under this (device type, world size). The
    write is atomic (temp file + ``os.replace``), so a reader or a crash
    never sees a torn file."""
    comm = _comm(comm)
    path = _cache_path()
    suffix = _suffix(comm)
    names = [t.format(s=suffix) for t in _TUNABLE]
    entry = {n: constants.get(n) for n in names}
    from ..schedule import compiler as _sched

    overrides = _sched.plan_overrides()
    if overrides:
        # measured plan winners (tune_plan) persist alongside the tuned
        # constants and ride the same load path back in at start()
        entry["plan_overrides"] = overrides
    path.parent.mkdir(parents=True, exist_ok=True)
    data = {}
    if path.exists():
        try:
            data = json.loads(path.read_text())
        except Exception:
            data = {}
    data[_cache_key(comm)] = entry
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    tmp.write_text(json.dumps(data, indent=2, sort_keys=True))
    os.replace(tmp, path)
    return path


def load_tuning(
    comm: Optional[Communicator] = None, apply: bool = True
) -> Optional[Dict[str, object]]:
    """Load persisted tuning for this (device type, world size); apply it
    to the constants table when ``apply``. Returns the entry or None."""
    comm = _comm(comm)
    path = _cache_path()
    if not path.exists():
        return None
    try:
        data = json.loads(path.read_text())
    except Exception:
        return None
    entry = data.get(_cache_key(comm))
    if not entry:
        return None
    if apply:
        suffix = _suffix(comm)
        valid = {t.format(s=suffix) for t in _TUNABLE}
        applied = {}
        for name, value in entry.items():
            if name in valid:
                try:
                    constants.set(name, value)
                    applied[name] = value
                except Exception:
                    pass  # type drift in an old cache: keep the default
        overrides = entry.get("plan_overrides")
        if isinstance(overrides, dict):
            from ..schedule import compiler as _sched

            applied_plans = _sched.apply_plan_overrides(overrides)
            if applied_plans:
                applied["plan_overrides"] = applied_plans
        telemetry.audit(
            "autotune_load", key=_cache_key(comm), applied=applied
        )
    return entry
