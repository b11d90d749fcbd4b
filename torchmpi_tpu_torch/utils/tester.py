"""Collective correctness/benchmark harness.

The port of ``torchmpi_tpu/utils/tester.py`` (``torchmpi/tester.lua`` and
the measurement protocol of ``test/collectives_all.lua``): a size sweep
2^8..2^23 elements with random jitter (``tester.lua:43-47``), correctness
on the first call from closed-form values (rank r contributes r), and
benchmark mode: 10 warm-up and 10 timed calls on the host clock around a
synchronised loop, reporting µs and effective bus GB/s from the analytic
communication-volume models (``tester.lua:103-126``,
``collectives_all.lua:313-318``):

- allreduce: ``2 n (p-1)/p`` bytes moved per rank (ring model)
- broadcast / reduce / sendreceive: ``n`` bytes (pipelined model)
- allgather: ``n (p-1)`` bytes
- reducescatter / alltoall: ``n (p-1)/p`` bytes

With p virtual ranks on one card every "link" is the card's memory, so a
bus GB/s is the reference's yardstick applied to this run, not a link
speed. An async call's result is waited inside the loop; the host time of
issuing it is reported beside, as ``launch_us`` (the reference asserts an
async launch under 50 µs, ``collectives_all.lua:192-199``).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from .. import collectives
from ..runtime.communicator import Communicator


def sweep_sizes(
    min_pow: int = 8, max_pow: int = 23, jitter_seed: Optional[int] = 0
) -> List[int]:
    """2^min..2^max with the reference's random jitter on each size."""
    rng = np.random.RandomState(jitter_seed)
    sizes = []
    for k in range(min_pow, max_pow + 1):
        base = 1 << k
        jitter = int(rng.randint(0, max(1, base // 8))) if jitter_seed is not None else 0
        sizes.append(base + jitter)
    return sizes


def bus_bytes(op: str, nbytes: int, p: int) -> float:
    """Analytic communication volume per rank (BASELINE.md models)."""
    if op == "allreduce":
        return 2 * nbytes * (p - 1) / p
    if op in ("broadcast", "reduce"):
        return float(nbytes)
    if op == "allgather":
        return float(nbytes * (p - 1))
    if op == "sendreceive":
        return float(nbytes)
    if op in ("reducescatter", "alltoall"):
        # ring RS: each rank forwards (p-1) partial slices of n/p bytes;
        # alltoall: each rank ships (p-1) of its p blocks
        return nbytes * (p - 1) / p
    raise ValueError(op)


@dataclass
class BenchResult:
    op: str
    backend: str
    nelem: int
    mean_us: float
    bus_gbps: float
    correct: bool
    mode: str = "sync"
    # mean host time to issue one async call (benchmark mode, async only)
    launch_us: float = math.nan


def _payload(op: str, nelem: int, p: int, device: torch.device) -> torch.Tensor:
    """The closed-form input: rank r contributes r (alltoall: rank r's
    block for rank s holds 100 r + s)."""
    r = torch.arange(p, dtype=torch.float32, device=device)
    if op == "alltoall":
        chunk = max(1, nelem // p)
        return (100.0 * r[:, None] + r[None, :])[:, :, None].expand(p, p, chunk).contiguous()
    if op == "reducescatter":
        n = max(p, -(-max(1, nelem) // p) * p)  # last dim divisible by p
    else:
        n = max(1, nelem)
    return r[:, None].expand(p, n).contiguous()


def _close(out: torch.Tensor, expect) -> bool:
    """numpy's ``allclose`` (rtol 1e-5, atol 1e-8), on the tensor's device."""
    expect = torch.as_tensor(expect, dtype=out.dtype, device=out.device)
    return bool(torch.isclose(out, expect, rtol=1e-5, atol=1e-8).all())


def _correct(op: str, out: torch.Tensor, p: int, root: int) -> bool:
    total = p * (p - 1) / 2
    if op == "allreduce" or op == "reducescatter":
        return _close(out, total)
    if op == "broadcast":
        return _close(out, float(root))
    if op == "reduce":
        return _close(out[root], total)
    if op == "allgather":
        ranks = torch.arange(p, dtype=out.dtype, device=out.device)
        return _close(out[0], ranks.repeat_interleave(out.shape[1] // p))
    if op == "alltoall":
        r = torch.arange(p, dtype=out.dtype, device=out.device)
        return _close(out, 100.0 * r[None, :, None] + r[:, None, None])
    return True


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_one_config(
    op: str,
    nelem: int,
    comm: Communicator,
    backend: Optional[str] = None,
    mode: str = "sync",
    benchmark: bool = False,
    warmup: int = 10,
    timed: int = 10,
    root: int = 0,
    route_override: bool = True,
) -> BenchResult:
    """One (op, size, backend, mode) cell of the config matrix
    (``tester.runOneConfig``). Correctness is always checked on the first
    call; benchmark mode adds the timed loop. ``route_override=False``
    pins the exact backend (``route_small=False``: no small-size rerouting
    to the vendor path)."""
    from ..collectives import eager

    p = comm.size
    x = _payload(op, nelem, p, comm.device)
    pinned = not route_override and backend in ("xla", "ring", "kernel")
    ns = collectives.async_ if mode == "async" else collectives
    if backend and not pinned and backend != "selector":
        ns = getattr(ns, backend)
    launch_s: List[float] = []

    def issue():
        if pinned:
            kw = dict(backend=backend, route_small=False)
            if op in ("broadcast", "reduce"):
                kw["root"] = root
            if op == "sendreceive":
                kw.update(src=0, dst=p - 1)
            run = eager.run_async if mode == "async" else eager.run
            return run(op, x, comm, **kw)
        if op == "allreduce":
            return ns.allreduce_tensor(x, comm=comm)
        if op == "broadcast":
            return ns.broadcast_tensor(x, root=root, comm=comm)
        if op == "reduce":
            return ns.reduce_tensor(x, root=root, comm=comm)
        if op == "allgather":
            return ns.allgather_tensor(x, comm=comm)
        if op == "sendreceive":
            return ns.sendreceive_tensor(x, src=0, dst=p - 1, comm=comm)
        if op == "reducescatter":
            return ns.reducescatter_tensor(x, comm=comm)
        if op == "alltoall":
            return ns.alltoall_tensor(x, comm=comm)
        raise ValueError(op)

    def call():
        if mode != "async":
            return issue()
        t0 = time.perf_counter()
        handle = issue()
        launch_s.append(time.perf_counter() - t0)
        return handle.wait()

    correct = _correct(op, call(), p, root)

    mean_us = gbps = launch_us = math.nan
    if benchmark:
        for _ in range(warmup):
            call()
        call()
        _synchronize(comm.device)
        launch_s.clear()
        t0 = time.perf_counter()
        for _ in range(timed):
            call()
        _synchronize(comm.device)
        dt = (time.perf_counter() - t0) / timed
        mean_us = dt * 1e6
        gbps = bus_bytes(op, nelem * 4, p) / dt / 1e9
        if launch_s:
            launch_us = sum(launch_s) / len(launch_s) * 1e6
    return BenchResult(op, backend or "selector", nelem, mean_us, gbps, correct,
                       mode, launch_us)


def run_matrix(
    comm: Communicator,
    ops: Iterable[str] = ("broadcast", "reduce", "allreduce", "allgather"),
    backends: Iterable[str] = ("xla", "ring"),
    modes: Iterable[str] = ("sync", "async"),
    sizes: Optional[List[int]] = None,
    benchmark: bool = False,
    report: Optional[Callable[[BenchResult], None]] = None,
) -> List[BenchResult]:
    """The full config-matrix sweep (``collectives_all.lua:554-598``),
    freeing the communicator's per-size resources after each op's sweep as
    the reference tester does between sizes (``tester.lua:131-133``)."""
    from ..collectives.eager import free_collective_resources

    sizes = sizes or sweep_sizes()
    results = []
    for op in ops:
        for backend in backends:
            for mode in modes:
                for n in sizes:
                    res = run_one_config(op, n, comm, backend, mode, benchmark=benchmark)
                    results.append(res)
                    if report:
                        report(res)
        free_collective_resources(comm)
    return results


def run_ps_throughput(comm: Communicator, nelem: int = 1 << 20, warmup: int = 3,
                      timed: int = 10):
    """Parameter-server center-traffic throughput (``tester.py:213``):
    needs the parameter server, which is not ported yet (ROADMAP A7)."""
    raise NotImplementedError(
        "run_ps_throughput needs the parameter server, which is not ported "
        "to PyTorch yet (ROADMAP queue A7)"
    )
