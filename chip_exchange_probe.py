#!/usr/bin/env python3
"""The control plane's two host exchanges, timed on the payloads that flow
through them: is the store exchange among a set of processes
(``ControlPlane._exchange``, keys under process 0's ``TCPStore``) as fast
as the gloo all-gather that every process meets?

``python3 chip_exchange_probe.py [--procs 2 4]`` starts that many processes
on this host (no card is used). Each builds a ``ControlPlane`` at a free
local port and gathers every process's CPU uint8 payload, in process
order, once through gloo (``all_gather_bytes(t)``) and once through the
store (``_exchange`` over every process), alternating, ``--reps`` times
after one warm-up each. The payloads are the ones that cross processes on
the port's paths: a lane's setup exchange (a pickled list of slab handles,
about 1 KB), config 5's staged partial (its largest bucket, 100480 f32 a
process) and the vendor path's row gather at 2^23 f32 (2 ranks a process,
64 MiB). Prints one ``{"exchange_probe": ...}`` line: each payload's median
and min milliseconds per exchange by path, read in process 0.
"""

from __future__ import annotations

import argparse
import json
import socket
import statistics
import sys
import time
from pathlib import Path

import torch
import torch.multiprocessing as tmp

sys.path.insert(0, str(Path(__file__).resolve().parent))

PAYLOADS = {"lane_setup_1k": 1 << 10, "staged_partial_100480_f32": 100480 * 4,
            "vendor_rows_2x2^23_f32": 2 * (1 << 23) * 4}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(index: int, count: int, port: int, reps: int, out) -> None:
    from torchmpi_tpu_torch.runtime.peers import ControlPlane

    plane = ControlPlane(f"localhost:{port}", count, index)
    procs = list(range(count))
    res = {}
    try:
        for name, nbytes in PAYLOADS.items():
            t = torch.full((nbytes,), index, dtype=torch.uint8)
            raw = t.numpy().tobytes()
            paths = {"gloo": lambda: plane.all_gather_bytes(t),
                     "store": lambda: plane._exchange(procs, raw)}
            ms = {path: [] for path in paths}
            for path, fn in paths.items():  # warm-up
                fn()
            for i in range(2 * reps):
                path = ("gloo", "store")[(i + i // 2) % 2]
                plane.barrier()
                t0 = time.perf_counter()
                got = paths[path]()
                ms[path].append((time.perf_counter() - t0) * 1e3)
                first = [bytes(g[:1]) if isinstance(g, bytes) else bytes(g[:1].numpy())
                         for g in got]
                assert first == [bytes([q]) for q in procs], (path, first)
            res[name] = {"bytes": nbytes, **{f"{path}_median_ms": statistics.median(v)
                                             for path, v in ms.items()},
                         **{f"{path}_min_ms": min(v) for path, v in ms.items()}}
        plane.barrier()
    finally:
        plane.close()
    if index == 0:
        out.put(res)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--procs", type=int, nargs="+", default=[2, 4])
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    ctx = tmp.get_context("spawn")
    out = {}
    for count in args.procs:
        q = ctx.Queue()
        port = _free_port()
        workers = [ctx.Process(target=_worker, args=(i, count, port, args.reps, q))
                   for i in range(count)]
        for w in workers:
            w.start()
        out[f"{count}_processes"] = q.get(timeout=600)
        for w in workers:
            w.join(timeout=120)
            if w.is_alive():
                w.terminate()
        if any(w.exitcode for w in workers):
            raise SystemExit(f"chip_exchange_probe: a worker failed: {[w.exitcode for w in workers]}")
    out["host_cpus"] = len(__import__("os").sched_getaffinity(0))
    print(json.dumps({"exchange_probe": out}), flush=True)


if __name__ == "__main__":
    main()
