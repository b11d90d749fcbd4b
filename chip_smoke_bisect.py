#!/usr/bin/env python3
"""Bisect the ResNet phase of a tree's ``chip_smoke.py`` on one card.

``python3 chip_smoke_bisect.py ROOT --drop PIECE`` runs ``ROOT/chip_smoke.py``
(the complete run, every phase in its order) up to and including its
ResNet phase, with one piece of that phase left out, then stops: its
``{"resnet"}`` line's ``step_ms`` and ``async.step_ms`` are what a
bisection reads. The pieces (``phase_resnet``, before the full-width sync
and async runs):

- ``narrow``: the narrow ResNet on the card and the CPU (its comparison
  is skipped);
- ``rank_maps``: the per-rank gradient forms timed at full width (the
  ``vmap`` form at up to 51 GB);
- ``profile``: the 3-step profile after the sync run (its fields print
  as null);
- ``none``: nothing left out.

It works on any tree whose ``chip_smoke.py`` has these functions
(``resnet_small``, ``rank_maps``, ``resnet_path``, ``phase_ps``), so two
trees can be read in one call, in turns.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path


class _Stop(Exception):
    """Raised by the phase after the ResNet phase: the run ends there."""


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", help="the root of the tree whose chip_smoke.py runs")
    ap.add_argument("--drop", required=True, choices=("narrow", "rank_maps", "profile", "none"))
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if args.drop == "narrow":
        cs.resnet_small = lambda dev, mode: ([1.0] * 3, {"skipped": torch.zeros(1)})
    elif args.drop == "rank_maps":
        cs.rank_maps = lambda dev, data: {"skipped": True}
    elif args.drop == "profile":
        path = cs.resnet_path

        def no_profile(dev, data, mode, profile_steps=0):
            out = path(dev, data, mode)
            if profile_steps:
                out["profile"] = {"device_busy_share": None, "split_us_per_step": {}}
            return out

        cs.resnet_path = no_profile

    def stop(*a, **k):
        raise _Stop

    cs.phase_ps = stop
    print(f"bisect: {root.name} without {args.drop}", flush=True)
    try:
        cs.main([])
    except _Stop:
        print(f"bisect: {root.name} without {args.drop}: stopped after the ResNet phase")
        return
    raise SystemExit("bisect: the run did not reach the phase after the ResNet phase")


if __name__ == "__main__":
    main()
