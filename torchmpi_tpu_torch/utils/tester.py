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
speed. In a job of several processes (the launcher's), each process builds
and checks its own ranks' rows, the volume models keep the global p, and
every process meets the others at the control plane's barrier before its
timed loop, so all of them time the same calls. An async call's result is
waited inside the loop; the host time of issuing it is reported beside,
as ``launch_us`` (the reference asserts an async launch under 50 µs,
``collectives_all.lua:192-199``).

:func:`wire_midpoint_rows` makes inputs of the quantized ring on which
rounding the int8 wire's decode-and-add twice gives other bits than
rounding it once, as the JAX kernel does.
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


def _payload(op: str, nelem: int, p: int, device: torch.device,
             ranks: Optional[List[int]] = None) -> torch.Tensor:
    """The closed-form input of the ``ranks`` (default: all p) in rank
    order: rank r contributes r (alltoall: rank r's block for rank s
    holds 100 r + s)."""
    r = torch.tensor(list(range(p)) if ranks is None else ranks, dtype=torch.float32,
                     device=device)
    s = torch.arange(p, dtype=torch.float32, device=device)
    if op == "alltoall":
        chunk = max(1, nelem // p)
        return (100.0 * r[:, None] + s[None, :])[:, :, None].expand(len(r), p, chunk).contiguous()
    if op == "reducescatter":
        n = max(p, -(-max(1, nelem) // p) * p)  # last dim divisible by p
    else:
        n = max(1, nelem)
    return r[:, None].expand(len(r), n).contiguous()


def _close(out: torch.Tensor, expect) -> bool:
    """numpy's ``allclose`` (rtol 1e-5, atol 1e-8), on the tensor's device."""
    expect = torch.as_tensor(expect, dtype=out.dtype, device=out.device)
    return bool(torch.isclose(out, expect, rtol=1e-5, atol=1e-8).all())


def _correct(op: str, out: torch.Tensor, p: int, root: int,
             ranks: Optional[List[int]] = None) -> bool:
    """The closed-form check of the rows of ``ranks`` (default: all p,
    in rank order). A reduce's non-root rows keep their input. A
    sendreceive reads correct unconditionally, as the JAX tester has it
    (``tester.py:147``)."""
    ranks = list(range(p)) if ranks is None else ranks
    total = p * (p - 1) / 2
    if op == "allreduce" or op == "reducescatter":
        return _close(out, total)
    if op == "broadcast":
        return _close(out, float(root))
    if op == "reduce":
        return all(_close(row, total if r == root else float(r)) for r, row in zip(ranks, out))
    if op == "allgather":
        every = torch.arange(p, dtype=out.dtype, device=out.device)
        return _close(out, every.repeat_interleave(out.shape[1] // p))
    if op == "alltoall":
        r = torch.tensor(ranks, dtype=out.dtype, device=out.device)
        s = torch.arange(p, dtype=out.dtype, device=out.device)
        return _close(out, 100.0 * s[None, :, None] + r[:, None, None])
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
    ranks = comm.local_ranks
    x = _payload(op, nelem, p, comm.device, ranks)
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

    correct = _correct(op, call(), p, root, ranks)

    mean_us = gbps = launch_us = math.nan
    if benchmark:
        for _ in range(warmup):
            call()
        call()
        if comm.multiprocess:
            eager.barrier(comm)  # every process's timed loop starts together
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
    reps: Optional[dict] = None,
) -> List[BenchResult]:
    """The full config-matrix sweep (``collectives_all.lua:554-598``),
    freeing the communicator's per-size resources after each op's sweep as
    the reference tester does between sizes (``tester.lua:131-133``).
    ``reps`` maps a backend to its ``(warmup, timed)`` calls (default the
    reference's 10 and 10)."""
    from ..collectives.eager import free_collective_resources

    sizes = sizes or sweep_sizes()
    results = []
    for op in ops:
        for backend in backends:
            for mode in modes:
                for n in sizes:
                    warmup, timed = (reps or {}).get(backend, (10, 10))
                    res = run_one_config(op, n, comm, backend, mode, benchmark=benchmark,
                                         warmup=warmup, timed=timed)
                    results.append(res)
                    if report:
                        report(res)
        free_collective_resources(comm)
    return results


def run_ps_throughput(comm: Communicator, nelem: int = 1 << 20, warmup: int = 3,
                      timed: int = 10) -> dict:
    """Parameter-server center-traffic throughput (``tester.py:213``):
    timed client ``send('add')`` fan-out (each handle waited: every shard
    applied) and full ``receive`` assembly, in MB/s, the PS analog of the
    collectives' bus-bandwidth lines (the reference's chunked
    clientSend/clientReceive, ``lib/parameterserver.cpp:309-400``). The
    shards live on the communicator's device, so this measures the
    in-process pipeline: the pool and polling threads, the rules' kernels
    and the shard copies. Each timed loop ends in a device synchronise.
    Returns ``send_mbps``, ``recv_mbps`` and ``nbytes``."""
    from ..parameterserver.server import ParameterServer

    x = torch.ones(nelem, device=comm.device)
    nbytes = x.numel() * x.element_size()
    ps = ParameterServer(torch.zeros(nelem), comm=comm)
    try:
        def timed_loop(call) -> float:
            for _ in range(warmup):
                call().wait()
            _synchronize(comm.device)
            t0 = time.perf_counter()
            for _ in range(timed):
                call().wait()
            _synchronize(comm.device)
            return time.perf_counter() - t0

        send_dt = timed_loop(lambda: ps.send(x, rule="add"))
        recv_dt = timed_loop(ps.receive)
    finally:
        ps.free()
    return {
        "send_mbps": nbytes * timed / send_dt / 1e6,
        "recv_mbps": nbytes * timed / recv_dt / 1e6,
        "nbytes": nbytes,
    }


# ---------------------------------------------------------------------------
# inputs on which the int8 wire's decode-and-add shows how often it rounds
# ---------------------------------------------------------------------------

_INV_127 = np.float32(1) / np.float32(127)  # the int8 scale's RN(1/127)


def _f32_neighbours(v: np.ndarray):
    """The two f32 values next to each f64 of ``v``: ``lo <= v <= hi``."""
    c = v.astype(np.float32)
    lo = np.where(c <= v, c, np.nextafter(c, np.float32(-np.inf)))
    hi = np.where(c >= v, c, np.nextafter(c, np.float32(np.inf)))
    return lo, hi


def _is_f32_midpoint(v: np.ndarray) -> np.ndarray:
    lo, hi = _f32_neighbours(v)
    return (lo != hi) & ((lo.astype(np.float64) + hi.astype(np.float64)) / 2 == v)


def wire_midpoint_triples(count: int, rng: np.random.RandomState):
    """``count`` int8 decode-and-add operands that tell one rounding from
    two: the row maximum ``m`` (f32) that sets the scale ``s = RN(m *
    RN(1/127))``, a code ``q`` (|q| <= 126) whose exact product ``q*s`` lies
    halfway between two f32 values, and a ``local`` 2^-60 times the product,
    on the side of the odd neighbour. ``local + q*s`` rounded once is that
    odd neighbour; rounded first in f64 (the sum falls back on the
    midpoint) and then to f32 it is the even one. Returns (m, s, q, local),
    f32 arrays but for ``q`` (int64)."""
    codes = np.arange(1, 127, dtype=np.float64)
    m = np.empty(count, np.float32)
    mids = np.zeros((count, codes.size), bool)
    todo = np.arange(count)
    while todo.size:
        cand = np.exp(rng.uniform(-4.0, 4.0, todo.size)).astype(np.float32)
        found = _is_f32_midpoint((cand * _INV_127).astype(np.float64)[:, None] * codes)
        ok = found.any(1)
        m[todo[ok]], mids[todo[ok]] = cand[ok], found[ok]
        todo = todo[~ok]
    s = m * _INV_127
    # a random code among each row's midpoints, with a random sign
    pick = np.argmax(rng.uniform(size=mids.shape) * mids, axis=1)
    q = (pick + 1) * np.where(rng.uniform(size=count) < 0.5, -1, 1)
    prod = q * s.astype(np.float64)
    lo, hi = _f32_neighbours(prod)
    toward_hi = (hi.view(np.int32) & 1) == 1
    local = (np.abs(prod) * 2.0**-60).astype(np.float32) * np.where(toward_hi, 1, -1)
    return m, s, q, local.astype(np.float32)


def wire_midpoint_rows(p: int, n: int, mode: str = "allreduce", seed: int = 0) -> np.ndarray:
    """Rank-stacked f32 inputs of the quantized ring (``ops.ring_allreduce_quant``
    for ``mode`` 'allreduce': ``[p, n]``; ``ops.ring_reduce_scatter_quant``
    for 'rs': ``[p, p*n]``, p segments of ``n``) on whose last
    reduce-scatter hop 8 lanes of every 128-lane row take the operands of
    :func:`wire_midpoint_triples`. In each row the ranks the
    sum visits before its last two hold zeros (so the running sum reaches
    the second-to-last rank unchanged), that rank holds the row maximum
    and the codes' values ``RN(q*s)`` among smaller random values, and the
    owner holds the ``local`` values among random ones. Made with numpy
    from ``seed``."""
    from ..ops.ring_kernels import quant_chunk_elems

    if p < 2 or mode not in ("allreduce", "rs"):
        raise ValueError(f"wire_midpoint_rows needs p >= 2 and mode 'allreduce' or 'rs', "
                         f"got p={p}, mode={mode!r}")
    rng = np.random.RandomState(seed)
    rps = -(-n // 128)  # 128-lane rows of each rank's buffer or segment
    if mode == "allreduce":
        nrows, valid_n = rps, np.full(rps, n)
        c = quant_chunk_elems(n, p, "int8")
        starts = (np.arange(rps) * 128 % (p * c)) // c
        tails = np.arange(rps)
    else:
        # segment s's sum starts at rank s + 1 and ends at its owner, rank s
        nrows, valid_n = p * rps, np.full(p * rps, n)
        starts = (np.arange(nrows) // rps + 1) % p
        tails = np.arange(nrows) % rps
    valid = np.minimum(128, valid_n - 128 * tails)
    m, s, q, local = wire_midpoint_triples(nrows, rng)
    # per row a random order of its valid lanes: the first holds the
    # maximum, the next 8 the midpoint operands
    keys = rng.uniform(size=(nrows, 128))
    keys[np.arange(128)[None, :] >= valid[:, None]] = np.inf
    order = np.argsort(keys, axis=1)
    row = np.arange(nrows)[:, None]
    enc = (rng.uniform(-0.99, 0.99, (nrows, 128)) * m[:, None]).astype(np.float32)
    enc[row[:, 0], order[:, 0]] = m
    own = rng.randn(nrows, 128).astype(np.float32)
    adv = order[:, 1:9]
    use = np.arange(1, 9)[None, :] < valid[:, None]
    vals = (q * s.astype(np.float64)).astype(np.float32)
    enc[row, adv] = np.where(use, vals[:, None], enc[row, adv])
    own[row, adv] = np.where(use, local[:, None], own[row, adv])
    data = np.zeros((p, nrows, 128), np.float32)
    data[(starts + p - 2) % p, row[:, 0]] = enc
    data[(starts + p - 1) % p, row[:, 0]] = own
    if mode == "allreduce":
        return np.ascontiguousarray(data.reshape(p, rps * 128)[:, :n])
    segs = data.reshape(p, p, rps * 128)[:, :, :n]
    return np.ascontiguousarray(segs.reshape(p, p * n))
