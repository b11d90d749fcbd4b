#!/usr/bin/env python3
"""Time the async issue of a tree's ``chip_smoke.py`` on one card.

``python3 chip_issue.py ROOT`` builds ``ROOT``'s kernels and runs its
``chip_smoke.py``'s ``phase_async_issue`` alone: the host time to issue
an async allreduce at 2^8 elements a rank (p=8) and its parts, as one
``{"async_issue": ...}`` line. It works on any tree whose
``chip_smoke.py`` has ``phase_build`` and ``phase_async_issue``, so two
trees can be read in one call, in turns (parent, change, change,
parent), each in a process of its own.

``--windows N`` reads, in place of that line, N 1,000-call windows of the
routed call alone (``async_.allreduce_tensor``, p=8, the median of each
after 50 warm-up calls, each handle waited outside the timed call) at
2^8 elements a rank, which takes the vendor path, and at 2^17, above
``small_allreduce_size_cuda``, which takes K3 through the C++ issue path
and records the plan's wire bytes there, in this one process
(``{"issue_windows": ...}``), so a parent tree and a change can be read
in turns, each window by the same code.

``--step-windows N`` reads, in place of that line, N windows of 30 MNIST
steps (LeNet, p=8, batch 336) after one warm window, ms a step, of
BASELINE config 1 (sync, the full wire, telemetry off) and of config 2
(async, the int8 wire) with the flight recorder off and on (on, each
bucket's wait is recorded) (``{"step_windows": ...}``), so a parent tree
and a change can be read in turns; with ``--windows`` it follows that
line in the same process.

``--profile`` runs, in place of that line, one 1,000-call window of the
routed call (``async_.allreduce_tensor`` at 2^8, p=8, after 50 warm-up
calls, each handle waited outside the window) under ``cProfile`` and
prints its functions by own time (``{"issue_profile": ...}``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path


def profile_window(cs, dev, reps: int = 1000, warmup: int = 50, top: int = 30) -> None:
    """``reps`` routed async allreduces at 2^8 under cProfile: each
    function's own and cumulative microseconds a call of the window."""
    import cProfile
    import pstats

    import torch

    mpi = cs.mpi
    mpi.start(ranks=cs.P)
    try:
        x = torch.randn((cs.P, 1 << 8), device=dev)
        for _ in range(warmup):
            mpi.wait(mpi.async_.allreduce_tensor(x))
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        hs = []
        for _ in range(reps):
            prof.enable()
            h = mpi.async_.allreduce_tensor(x)
            prof.disable()
            hs.append(h)
            mpi.wait(hs.pop())
        torch.cuda.synchronize()
    finally:
        mpi.stop()
    stats = pstats.Stats(prof)
    rows = []
    for (file, line, fn), (cc, nc, tt, ct, _) in stats.stats.items():
        rows.append({"fn": f"{Path(file).name}:{line}:{fn}", "calls_per_issue": nc / reps,
                     "own_us": tt / reps * 1e6, "cum_us": ct / reps * 1e6})
    rows.sort(key=lambda r: -r["own_us"])
    total = sum(r["own_us"] for r in rows)
    print(json.dumps({"issue_profile": {"reps": reps, "total_own_us_per_issue": total,
                                        "top": rows[:top]}}))


#: the routed call's per-rank sizes: the vendor path, and K3 above the cutoff
ISSUE_SIZES = (("", 1 << 8), ("kernel_", 1 << 17))


def routed_windows(cs, dev, windows: int, reps: int = 1000, warmup: int = 50) -> None:
    """``windows`` medians of ``reps`` routed async allreduces (µs on the
    host clock) at each of :data:`ISSUE_SIZES`, a window of each size in
    turn, one line; ``kernel_route`` is the C++ issue route of the K3 plan,
    ``kernel_records_wire`` whether the tree's plan records its wire bytes
    ``record_wire_us`` the median of ``reps`` such records alone, and
    ``kernel_record_toggled_us`` the K3 call's window medians with the
    memoized plan's record on and off in alternate windows."""
    import statistics
    import time

    import torch
    from torchmpi_tpu_torch.collectives import selector
    from torchmpi_tpu_torch.schedule import compile_collective

    mpi = cs.mpi
    mpi.start(ranks=cs.P)
    try:
        xs = {key: torch.randn((cs.P, n), device=dev) for key, n in ISSUE_SIZES}
        medians = {key: [] for key, _ in ISSUE_SIZES}
        for _ in range(windows):
            for key, _ in ISSUE_SIZES:
                x, times = xs[key], []
                for i in range(warmup + reps):
                    t0 = time.perf_counter_ns()
                    h = mpi.async_.allreduce_tensor(x)
                    t1 = time.perf_counter_ns()
                    mpi.wait(h)
                    if i >= warmup:
                        times.append(t1 - t0)
                torch.cuda.synchronize()
                medians[key].append(statistics.median(times) / 1e3)
        x = xs["kernel_"]
        ep = compile_collective("allreduce", tuple(x.shape), x.dtype, mpi.current_communicator(),
                                backend=selector.select("allreduce", dev, False, "async"))
        # the wire-byte record alone, where the tree's plan makes one, and
        # the routed K3 call with the memoized plan's record on and off in
        # alternate windows of this one process
        record, record_us, toggled = getattr(ep, "record_wire", None), None, None
        if record is not None:
            times = []
            for i in range(warmup + reps):
                t0 = time.perf_counter_ns()
                record()
                if i >= warmup:
                    times.append(time.perf_counter_ns() - t0)
            record_us = statistics.median(times) / 1e3
            memo = mpi.current_communicator()._dispatch_memo.__dict__["_issue"]
            plan = next(e[1] for e in memo.values() if e[1] is not None and e[1].nelem == x.shape[1])
            toggled = {"on": [], "off": []}
            for w in range(2 * windows):
                state = ("on", "off")[(w + w // 2) % 2]  # on, off, off, on, on, off, ...
                plan.record_wire = record if state == "on" else None
                times = []
                for i in range(warmup + reps):
                    t0 = time.perf_counter_ns()
                    h = mpi.async_.allreduce_tensor(x)
                    t1 = time.perf_counter_ns()
                    mpi.wait(h)
                    if i >= warmup:
                        times.append(t1 - t0)
                torch.cuda.synchronize()
                toggled[state].append(statistics.median(times) / 1e3)
            plan.record_wire = record
    finally:
        mpi.stop()
    if ep.issue is None or ep.backend_label != "kernel":
        raise SystemExit(f"chip_issue: the routed plan at 2^17 ({ep.backend_label}) is not K3 "
                         "on the C++ issue path")
    line = {"reps": reps, "p": cs.P, "kernel_route": ep.issue,
            "kernel_records_wire": record is not None, "record_wire_us": record_us,
            "kernel_record_toggled_us": toggled}
    for key, n in ISSUE_SIZES:
        line.update({f"{key}routed_us": medians[key],
                     f"{key}median_us": statistics.median(medians[key]), f"{key}nelem": n})
    print(json.dumps({"issue_windows": line}, default=str))


def step_windows(cs, windows: int, steps: int = 30) -> None:
    """``windows`` readings (ms a step on the host clock, the card drained
    before and after each window of ``steps``) of config 1's sync step with
    telemetry off and of config 2's async int8 step with the flight
    recorder off and on."""
    import time

    import torch
    from torchmpi_tpu_torch.telemetry import flightrecorder

    mpi = cs.mpi
    out = {}
    for name, mode, wire, recorder in (("sync_full_off", "sync", "full", False),
                                       ("async_int8_off", "async", "int8", False),
                                       ("async_int8_recorder_on", "async", "int8", True)):
        mpi.start(ranks=cs.P)
        try:
            comm = mpi.current_communicator()
            engine = cs.mnist_engine(comm, mode, wire)
            batches = cs.mnist_batches(comm, steps)
            if recorder:
                flightrecorder.enable()
            ms = []
            for w in range(windows + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for b in batches:
                    engine.step(b)
                torch.cuda.synchronize()
                if w:
                    ms.append((time.perf_counter() - t0) * 1e3 / steps)
            out[name] = ms
        finally:
            flightrecorder.disable()
            flightrecorder.recorder.reset()
            mpi.stop()
    print(json.dumps({"step_windows": {**out, "steps": steps, "p": cs.P}}))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", help="the root of the tree whose chip_smoke.py runs")
    ap.add_argument("--profile", action="store_true",
                    help="one 1,000-call window of the routed call under cProfile")
    ap.add_argument("--windows", type=int, default=0,
                    help="read this many 1,000-call windows of the routed call alone")
    ap.add_argument("--step-windows", type=int, default=0,
                    help="read this many 30-step windows of configs 1 and 2's MNIST steps")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_issue: no CUDA device; this run needs one card")
    print(f"issue: {root.name}; {cs.card()}", flush=True)
    cs.phase_build()
    if args.profile:
        profile_window(cs, torch.device("cuda", 0))
        return
    if args.windows or args.step_windows:
        if args.windows:
            routed_windows(cs, torch.device("cuda", 0), args.windows)
        if args.step_windows:
            step_windows(cs, args.step_windows)
        return
    cs.phase_async_issue(torch.device("cuda", 0))


if __name__ == "__main__":
    main()
