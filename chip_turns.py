#!/usr/bin/env python3
"""Time a tree's ring kernels on one card, to compare two trees in turns.

``python3 chip_turns.py ROOT`` builds ``ROOT``'s ring kernels (K3 to K7)
and prints one ``{"turns": ...}`` line of milliseconds
(``chip_smoke.time_ms``: CUDA events over inputs rotated past twice the
L2, f32):

- flat K3 at MNIST LeNet's fused gradients [8, 857738] and at ResNet-50's
  largest fused flush [8, 2360320]; K3 'rs', K5 and K6 at [8, 2^23]; K7 at
  [8, 857738];
- the two-level intra allreduce on 2 groups of 4 at [8, 2^23] and at
  config 5's largest bucket [8, 100480]: one grouped K3 launch where the
  tree's ``ring_allreduce`` takes ``groups``, else one K3 launch a group
  and the slabs' ``torch.cat`` (``schedule.lower._per_group``);
- the one-process K4 at config 2's bucket 0, allreduce [8, 805386] and
  'rs' [8, 805392], int8 and bf16 wires.

It runs on any tree whose ``chip_smoke.py`` has ``phase_build``,
``time_ms`` and ``rotating``, so a parent unpacked beside the working tree
and the tree itself can be read in one call, in turns (parent, change,
change, parent), each in a process of its own.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import sys
from pathlib import Path

P, G, I = 8, 2, 4  # ranks, and config 5's hosts of ranks


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", help="the root of the tree whose kernels are timed")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_turns: no CUDA device; this run needs one card")
    from torchmpi_tpu_torch.schedule import lower

    cs.phase_build(("ring_kernels", "ring_quant"))
    ops = cs.ops
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    grouped = "groups" in inspect.signature(ops.ring_allreduce).parameters
    if grouped:
        def intra(x):
            return ops.ring_allreduce(x, groups=G)
    else:
        def intra(x):
            return lower._per_group(ops.ring_allreduce, x, G, I)

    def timed(fn, n: int) -> float:
        def make():
            return (torch.randn((P, n), generator=gen, device=dev),)

        return cs.time_ms(cs.rotating(fn, make, P * n * 4))

    n23 = 1 << 23
    ms = {
        "k3_857738": timed(ops.ring_allreduce, 857738),
        "k3_2360320": timed(ops.ring_allreduce, 2360320),
        "k3_rs_2^23": timed(ops.ring_reduce_scatter, n23),
        "k5_2^23": timed(ops.ring_allreduce_bidir, n23),
        "k6_2^23": timed(lambda x: ops.ring_reduce(x, 0), n23),
        "k7_857738": timed(lambda x: ops.ring_broadcast(x, 0), 857738),
        "intra_2x4_2^23": timed(intra, n23),
        "intra_2x4_100480": timed(intra, 100480),
        "k4_int8_805386": timed(lambda x: ops.ring_allreduce_quant(x, "int8"), 805386),
        "k4_bf16_805386": timed(lambda x: ops.ring_allreduce_quant(x, "bf16"), 805386),
        "k4_rs_int8_805392": timed(lambda x: ops.ring_reduce_scatter_quant(x, "int8"), 805392),
        "k4_rs_bf16_805392": timed(lambda x: ops.ring_reduce_scatter_quant(x, "bf16"), 805392),
    }
    print(json.dumps({"turns": {"tree": str(args.root), "grouped_intra": grouped, "ms": ms,
                                "card": cs.card()}}), flush=True)


if __name__ == "__main__":
    main()
