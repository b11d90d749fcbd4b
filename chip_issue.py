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
routed call alone (``async_.allreduce_tensor`` at 2^8, p=8, the median
of each after 50 warm-up calls, each handle waited outside the timed
call) in this one process (``{"issue_windows": ...}``), so a parent tree
and a change can be read in turns, each window by the same code.

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


def routed_windows(cs, dev, windows: int, reps: int = 1000, warmup: int = 50) -> None:
    """``windows`` medians of ``reps`` routed async allreduces at 2^8 (µs
    on the host clock), one line."""
    import statistics
    import time

    import torch

    mpi = cs.mpi
    mpi.start(ranks=cs.P)
    try:
        x = torch.randn((cs.P, 1 << 8), device=dev)
        medians = []
        for _ in range(windows):
            times = []
            for i in range(warmup + reps):
                t0 = time.perf_counter_ns()
                h = mpi.async_.allreduce_tensor(x)
                t1 = time.perf_counter_ns()
                mpi.wait(h)
                if i >= warmup:
                    times.append(t1 - t0)
            torch.cuda.synchronize()
            medians.append(statistics.median(times) / 1e3)
    finally:
        mpi.stop()
    print(json.dumps({"issue_windows": {"routed_us": medians, "median_us": statistics.median(medians),
                                        "reps": reps, "nelem": 1 << 8, "p": cs.P}}))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", help="the root of the tree whose chip_smoke.py runs")
    ap.add_argument("--profile", action="store_true",
                    help="one 1,000-call window of the routed call under cProfile")
    ap.add_argument("--windows", type=int, default=0,
                    help="read this many 1,000-call windows of the routed call alone")
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
    if args.windows:
        routed_windows(cs, torch.device("cuda", 0), args.windows)
        return
    cs.phase_async_issue(torch.device("cuda", 0))


if __name__ == "__main__":
    main()
