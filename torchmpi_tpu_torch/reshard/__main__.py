"""Offline checkpoint reshaper (the port of ``torchmpi_tpu/reshard/__main__.py``).

    python -m torchmpi_tpu_torch.reshard --from N --to M <src-ckpt> <dst-ckpt>

Reshapes a portable sharded checkpoint
(``utils.checkpoint.save_engine_sharded``) from an N-way world onto an
M-way world with bounded memory: source shards are mmap'd, target shards
are preallocated memmaps, and bytes move through ONE
``reshard_chunk_bytes``-sized scratch buffer — the full array is never
materialized. ``--from``
is optional (the checkpoint header knows its world); when given it is
validated against the header, failing loudly on a mismatch.

``--explain`` prints the compiled redistribution plan (the schedule
IR) for each leaf instead of writing anything.

Exit codes: 0 success, 2 usage/header error.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m torchmpi_tpu_torch.reshard",
        description="reshape a sharded checkpoint between world sizes "
        "with bounded memory",
    )
    ap.add_argument("src", help="source sharded checkpoint directory")
    ap.add_argument("dst", nargs="?", default=None,
                    help="destination directory (required unless --explain)")
    ap.add_argument("--from", dest="from_world", type=int, default=None,
                    help="expected source world size (validated against "
                    "the checkpoint header; optional — the header knows)")
    ap.add_argument("--to", dest="to_world", type=int, required=True,
                    help="target world size")
    ap.add_argument("--chunk-bytes", type=int, default=None,
                    help="scratch chunk size (default: the "
                    "reshard_chunk_bytes knob)")
    ap.add_argument("--explain", action="store_true",
                    help="print each leaf's compiled redistribution plan "
                    "+ cost estimate; write nothing")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable stats output")
    args = ap.parse_args(argv)

    from ..utils import checkpoint as ckpt
    from .core import Layout, build_plan, estimate_us

    try:
        meta = ckpt.read_sharded_meta(args.src)
    except (OSError, ValueError, ckpt.CheckpointMismatchError) as e:
        print(f"reshard: cannot read {args.src}: {e}", file=sys.stderr)
        return 2
    from_world = int(meta["world"])
    if args.from_world is not None and args.from_world != from_world:
        print(
            f"reshard: --from {args.from_world} but {args.src} was saved "
            f"from a {from_world}-way world (header `world`)",
            file=sys.stderr,
        )
        return 2
    if args.to_world < 1:
        print(f"reshard: --to must be >= 1, got {args.to_world}",
              file=sys.stderr)
        return 2

    if args.explain:
        src_l, dst_l = Layout(from_world), Layout(args.to_world)
        for i, rec in enumerate(meta["leaves"]):
            if rec["kind"] == "replicated":
                print(f"leaf {i} {rec['tree']}{rec['path']}: replicated "
                      f"({rec['n']} elements, copied verbatim)")
                continue
            import numpy as np

            plan = build_plan(
                int(rec["n"]), np.dtype(rec["dtype"]).itemsize,
                src_l, dst_l, args.chunk_bytes,
            )
            print(f"leaf {i} {rec['tree']}{rec['path']}: "
                  f"est {estimate_us(plan):.1f}us")
            print("  " + plan.describe().replace("\n", "\n  "))
        return 0

    if args.dst is None:
        print("reshard: a destination directory is required "
              "(or pass --explain)", file=sys.stderr)
        return 2
    stats = ckpt.reshape_sharded(
        args.src, args.dst, args.to_world, chunk_bytes=args.chunk_bytes
    )
    if args.as_json:
        print(json.dumps(stats, indent=2))
    else:
        print(
            f"reshaped {args.src} {stats['from']}-way -> "
            f"{stats['to']}-way at {args.dst}: {stats['leaves']} leaves, "
            f"{stats['moved_bytes']} bytes moved, peak scratch "
            f"{stats['peak_scratch_bytes']}B (largest shard "
            f"{stats['largest_shard_bytes']}B)"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
