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
of incorrect configs.

Run:  python -m torchmpi_tpu_torch.examples.bench_collectives --ranks 8
      [--ops broadcast,reduce,allreduce,allgather,reducescatter]
      [--backends xla,ring,kernel] [--modes sync,async]
      [--min-pow 8] [--max-pow 23] [--device cpu]
"""

from __future__ import annotations

import argparse
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
                    help="parameter-server center traffic (not ported yet)")
    args = ap.parse_args(argv)
    if args.ps:
        raise NotImplementedError(
            "--ps needs the parameter server, which is not ported to PyTorch "
            "yet (ROADMAP queue A7)"
        )

    import torch

    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch.utils.tester import run_matrix, sweep_sizes

    mpi.start(ranks=args.ranks, device=args.device)
    try:
        comm = mpi.current_communicator()
        on_cuda = comm.device.type == "cuda"
        backends = args.backends or ("xla,ring,kernel" if on_cuda else "xla,ring")
        name = torch.cuda.get_device_name(comm.device) if on_cuda else "cpu"
        print(f"ranks={comm.size} device={comm.device} ({name})")
        print(f"{'op':<14}{'backend':<9}{'mode':<7}{'elements':>10}{'us':>12}"
              f"{'busGB/s':>10}{'launch_us':>11}  ok")

        def report(r):
            launch = "" if math.isnan(r.launch_us) else f"{r.launch_us:.1f}"
            print(f"{r.op:<14}{r.backend:<9}{r.mode:<7}{r.nelem:>10}{r.mean_us:>12.1f}"
                  f"{r.bus_gbps:>10.2f}{launch:>11}  {'yes' if r.correct else 'NO'}")

        results = run_matrix(
            comm,
            ops=args.ops.split(","),
            backends=backends.split(","),
            modes=args.modes.split(","),
            sizes=sweep_sizes(args.min_pow, args.max_pow),
            benchmark=True,
            report=report,
        )
        bad = [r for r in results if not r.correct]
        print(f"{len(results)} configs, {len(bad)} incorrect")
        return len(bad)
    finally:
        mpi.stop()


if __name__ == "__main__":
    sys.exit(main())
