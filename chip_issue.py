#!/usr/bin/env python3
"""Time the async issue of a tree's ``chip_smoke.py`` on one card.

``python3 chip_issue.py ROOT`` builds ``ROOT``'s kernels and runs its
``chip_smoke.py``'s ``phase_async_issue`` alone: the host time to issue
an async allreduce at 2^8 elements a rank (p=8) and its parts, as one
``{"async_issue": ...}`` line. It works on any tree whose
``chip_smoke.py`` has ``phase_build`` and ``phase_async_issue``, so two
trees can be read in one call, in turns (parent, change, change,
parent), each in a process of its own.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", help="the root of the tree whose chip_smoke.py runs")
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
    cs.phase_async_issue(torch.device("cuda", 0))


if __name__ == "__main__":
    main()
