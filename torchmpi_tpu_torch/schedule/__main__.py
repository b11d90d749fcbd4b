"""``python -m torchmpi_tpu_torch.schedule`` — the plan-compiler CLI.

Offline by design: plans are generated and cost-modeled against a
DECLARED topology, so no card or ``start()`` is needed — this is the
introspection dump that replaces the selector's static preference
table. The port of ``torchmpi_tpu/schedule/__main__.py``: the kernel
backend is named ``kernel``, the platform defaults to ``cuda`` and the
groups to one card's eight virtual ranks; a two-level request shows the
hierarchical, staged or tree plan the JAX package's CLI shows, and
``--families synth`` the synthesized candidates with their derivations.

Examples::

    python -m torchmpi_tpu_torch.schedule --explain op=allreduce bytes=4M
    python -m torchmpi_tpu_torch.schedule --explain op=allreduce bytes=64M \\
        groups=4x8 wire=int8 backend=kernel
    python -m torchmpi_tpu_torch.schedule --explain op=broadcast bytes=1M \\
        groups=1+3+4 platform=cuda     # ragged: the tree plan
    python -m torchmpi_tpu_torch.schedule --explain op=allreduce bytes=4M \\
        groups=8x2 staged=true         # host-staged inter link
    python -m torchmpi_tpu_torch.schedule --explain op=allreduce bytes=64M \\
        groups=8 wire=int8 synth=true  # race the synthesized families
    python -m torchmpi_tpu_torch.schedule --explain --families synth \\
        op=allreduce bytes=64M groups=8x16 wire=int8   # derivations only
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

from .. import constants
from .compiler import explain
from .topology import Topology

_SUFFIXES = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}


def parse_bytes(text: str) -> int:
    t = text.strip().lower().rstrip("ib")  # 4M == 4Mi == 4MiB
    if t and t[-1] in _SUFFIXES:
        return int(float(t[:-1]) * _SUFFIXES[t[-1]])
    return int(float(t))


def parse_groups(text: str):
    """'8' -> flat; '4x2' -> 2 cartesian groups of 4; '1+3+4' -> ragged."""
    t = text.strip().lower()
    if "x" in t:
        size, n = t.split("x", 1)
        return tuple([int(size)] * int(n)), True
    if "+" in t:
        return tuple(int(s) for s in t.split("+")), False
    return (int(t),), False


def parse_kv(tokens) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for tok in tokens:
        if "=" not in tok:
            raise SystemExit(f"expected key=value, got {tok!r}")
        k, v = tok.split("=", 1)
        out[k.strip()] = v.strip()
    return out


_BOOL = {"true": True, "1": True, "yes": True,
         "false": False, "0": False, "no": False}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m torchmpi_tpu_torch.schedule",
        description="collective schedule compiler introspection "
                    "(offline: plans against a declared topology)",
    )
    ap.add_argument(
        "--explain", action="store_true",
        help="print the chosen plan, its cost-model estimate, and the "
             "rejected candidates for a request given as key=value args",
    )
    ap.add_argument(
        "--families", choices=("legacy", "synth", "all"), default="all",
        help="filter the rendered candidate list: hand-written families, "
             "algebra-synthesized families, or both (the decision itself "
             "always races the full set). 'synth' implies synth=true.",
    )
    ap.add_argument(
        "kv", nargs="*",
        help="request: op=allreduce bytes=4M [dtype=float32] "
             "[backend=ring|kernel|xla] [wire=full|bf16|int8] "
             "[groups=4x2|1+3+4|8] [platform=cuda|cpu] [nodes=N] "
             "[staged=true] [route_small=false] [synth=true]",
    )
    args = ap.parse_args(argv)
    if not args.explain:
        ap.print_help()
        return 2
    kv = parse_kv(args.kv)
    op = kv.get("op", "allreduce")
    nbytes = parse_bytes(kv.get("bytes", "4M"))
    group_sizes, cartesian = parse_groups(kv.get("groups", "8"))
    if "cartesian" in kv:
        cartesian = _BOOL[kv["cartesian"].lower()]
    topo = Topology(
        platform=kv.get("platform", "cuda"),
        group_sizes=group_sizes,
        cartesian=cartesian and len(set(group_sizes)) == 1
        and len(group_sizes) > 1,
        nodes=int(kv.get("nodes", "1")),
        staged_inter=_BOOL.get(kv.get("staged", "false").lower(), False),
    )
    # synth=true (or --families synth) opts this explain run into the
    # composition-algebra candidates, exactly like the runtime knob; the
    # prior value is restored so the CLI never leaks process state
    synth = _BOOL.get(kv.get("synth", "false").lower(), False) or \
        args.families == "synth"
    prior = bool(constants.get("use_plan_synthesis"))
    if synth and not prior:
        constants.set("use_plan_synthesis", True)
    try:
        text = explain(
            op=op,
            nbytes=nbytes,
            topo=topo,
            dtype=kv.get("dtype", "float32"),
            backend=kv.get("backend", "ring"),
            wire=kv.get("wire"),
            route_small=_BOOL.get(kv.get("route_small", "true").lower(),
                                  True),
            families=args.families,
        )
    finally:
        if synth and not prior:
            constants.set("use_plan_synthesis", False)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
