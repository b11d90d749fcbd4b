"""Collectives benchmark on the PyTorch/CUDA port: the twin of
``examples/bench_collectives.py`` (``test/collectives_all.lua -benchmark``).

Sweeps each op over each backend and mode at sizes 2^min..2^max (with the
reference's jitter) on p virtual ranks of one device, and prints µs and
effective bus GB/s per (op, backend, mode, size), with the closed-form
correctness check of every config. The backends are ``xla`` (plain PyTorch
on the rank axis), ``ring`` (the ppermute ring, hop by hop) and ``kernel``
(the hand-written CUDA ring kernels); small allreduces and broadcasts go to
the vendor path by the size cutoffs, as in the JAX package. Async configs
also print the host time of issuing one call. The exit code is the number
of incorrect configs. ``--ps`` also measures the parameter server's center
traffic (send and receive MB/s at 2^(max-1) elements).

Through the launcher the ranks span processes (``--ranks`` is then each
process's count): every process runs the sweep on its own ranks' rows,
process 0 prints the rows, and each process's exit code counts its
incorrect configs. ``--kernel-bidir`` adds the kernel backend's allreduce
under ``ring_implementation='kernel_bidir'``; ``--launch-counts`` prints,
from every process, one ``{"launches": ...}`` JSON line per op (the
kernel launches its sweep made, counted from 0); ``--json`` prints the
rows as ``{"bench": ...}`` lines; ``--xla-reps W,T`` sets the vendor
path's warm-up and timed calls (the reference's 10,10 by default).

Run:  python -m torchmpi_tpu_torch.examples.bench_collectives --ranks 8
      [--ops broadcast,reduce,allreduce,allgather,reducescatter,alltoall,sendreceive]
      [--backends xla,ring,kernel] [--modes sync,async]
      [--min-pow 8] [--max-pow 23] [--device cpu] [--ps]
      [--kernel-bidir] [--launch-counts] [--json] [--xla-reps 10,10]
      python -m torchmpi_tpu_torch.launch --nproc 2 -m \
          torchmpi_tpu_torch.examples.bench_collectives -- --ranks 4 ...
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ops", default="broadcast,reduce,allreduce,allgather")
    ap.add_argument("--backends", default=None,
                    help="default: xla,ring,kernel on CUDA, xla,ring elsewhere")
    ap.add_argument("--modes", default="sync")
    ap.add_argument("--min-pow", type=int, default=12)
    ap.add_argument("--max-pow", type=int, default=20)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default=None, help="default: cuda:0")
    ap.add_argument("--ps", action="store_true",
                    help="also measure parameter-server center traffic (MB/s, "
                    "the clientSend/clientReceive hot path)")
    ap.add_argument("--kernel-bidir", action="store_true",
                    help="then sweep the kernel backend's allreduce under "
                    "ring_implementation='kernel_bidir'")
    ap.add_argument("--launch-counts", action="store_true",
                    help="print each process's kernel launches per op as JSON lines")
    ap.add_argument("--json", action="store_true", help="print the rows as JSON lines")
    ap.add_argument("--xla-reps", default="10,10", metavar="W,T",
                    help="the vendor path's warm-up and timed calls")
    args = ap.parse_args(argv)

    import torch

    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import constants, ops
    from torchmpi_tpu_torch.utils.tester import run_matrix, run_ps_throughput, sweep_sizes

    # the sweep runs on the global communicator, also when the launcher
    # spreads the ranks over processes (no per-process level pushed)
    mpi.start(ranks=args.ranks, device=args.device, with_ici_groups=False)
    try:
        comm = mpi.current_communicator()
        first = comm.process_index == 0
        on_cuda = comm.device.type == "cuda"
        backends = args.backends or ("xla,ring,kernel" if on_cuda else "xla,ring")
        name = torch.cuda.get_device_name(comm.device) if on_cuda else "cpu"
        reps = {"xla": tuple(int(v) for v in args.xla_reps.split(","))}
        if first:
            print(f"ranks={comm.size} processes={comm.num_nodes()} device={comm.device} ({name})")
            if not args.json:
                print(f"{'op':<16}{'backend':<9}{'mode':<7}{'elements':>10}{'us':>12}"
                      f"{'busGB/s':>10}{'launch_us':>11}  ok")

        def report(r, impl=None):
            if not first:
                return
            if args.json:
                row = {"op": r.op, "backend": r.backend, "mode": r.mode, "nelem": r.nelem,
                       "us": r.mean_us, "bus_gbps": r.bus_gbps, "correct": r.correct,
                       "processes": comm.num_nodes(), "ranks": comm.size}
                if impl:
                    row["ring_implementation"] = impl
                if r.mode == "async":
                    row["launch_us"] = r.launch_us
                print(json.dumps({"bench": row}), flush=True)
                return
            launch = "" if math.isnan(r.launch_us) else f"{r.launch_us:.1f}"
            op = r.op + ("/bidir" if impl else "")
            print(f"{op:<16}{r.backend:<9}{r.mode:<7}{r.nelem:>10}{r.mean_us:>12.1f}"
                  f"{r.bus_gbps:>10.2f}{launch:>11}  {'yes' if r.correct else 'NO'}", flush=True)

        sweeps = [(op, backends.split(","), None) for op in args.ops.split(",")]
        if args.kernel_bidir:
            sweeps.append(("allreduce", ["kernel"], "kernel_bidir"))
        results = []
        for op, bks, impl in sweeps:
            ops.reset_launch_counts()
            if impl:
                constants.set("ring_implementation", impl)
            try:
                results += run_matrix(
                    comm, ops=(op,), backends=bks, modes=args.modes.split(","),
                    sizes=sweep_sizes(args.min_pow, args.max_pow), benchmark=True,
                    report=lambda r, impl=impl: report(r, impl), reps=reps,
                )
                if on_cuda:
                    torch.cuda.synchronize(comm.device)
            finally:
                if impl:
                    constants.set("ring_implementation", "kernel")
            if args.launch_counts:
                print(json.dumps({"launches": {
                    "op": op, "ring_implementation": impl, "process": comm.process_index,
                    "counts": {k: v for k, v in ops.launch_counts().items() if v}}}), flush=True)
        if args.ps:
            r = run_ps_throughput(comm, nelem=1 << (args.max_pow - 1))
            for what in ("send", "recv"):
                print(f"{'ps-' + what:<14}{'server':<9}{'':<7}{r['nbytes'] // 4:>10}"
                      f"{'':>12}{r[what + '_mbps'] / 1e3:>10.2f}{'':>11}  yes")
        bad = [r for r in results if not r.correct]
        print(f"{len(results)} configs, {len(bad)} incorrect"
              + ("" if comm.num_nodes() == 1 else f" (process {comm.process_index})"))
        return len(bad)
    finally:
        mpi.stop()


if __name__ == "__main__":
    sys.exit(main())
