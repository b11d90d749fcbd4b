#!/usr/bin/env python3
"""ROADMAP C6's probe on one card: does ``rank_map='vmap'`` depend on how
many ranks one vmap call stacks?

``python3 chip_vmap_probe.py`` takes config 1's first step (the seed-0
LeNet parameters on every rank, the first batch of 336 over P=8 ranks)
under ``torch.func.vmap`` stacking all P ranks, against two calls
stacking ``MP_RANKS`` each (the ranks of ``chip_smoke.py --multiprocess``
run (f)'s two processes). It compares every intermediate of the forward
and every leaf of the gradient bit for bit (the first op that differs),
the same for ``chunk_size`` ``MP_RANKS`` and 1 (is either a repair?), and
times one gradient of all P ranks under each form and under the loop
(CUDA events, ``chip_smoke.time_ms``). It prints one ``{"vmap_probe":
...}`` line with the card's name and power limit, builds no kernel and
uses ``chip_smoke.py``'s settings (no TF32, deterministic cuDNN).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))


def main() -> None:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("chip_vmap_probe: no CUDA device; this run needs one card")
    import chip_smoke as cs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda", 0)
    P, M = cs.P, cs.MP_RANKS

    (xtr, ytr), _ = cs.synthetic_mnist()
    model = cs.LeNet()
    it = cs.DistributedIterator(xtr, ytr, cs.BATCH, P, device=dev)
    x, y = next(iter(it))
    params = {k: v.to(dev).unsqueeze(0).repeat((P,) + (1,) * v.ndim)
              for k, v in cs.init_params(model, seed=0).items()}

    def forward(prm, xb, yb):
        h = xb.reshape(xb.shape[0], 1, 28, 28)
        out = {"conv0": F.conv2d(h, prm["conv0.weight"], prm["conv0.bias"], padding=2)}
        out["pool0"] = F.max_pool2d(F.relu(out["conv0"]), 2)
        out["conv1"] = F.conv2d(out["pool0"], prm["conv1.weight"], prm["conv1.bias"], padding=2)
        out["pool1"] = F.max_pool2d(F.relu(out["conv1"]), 2)
        flat = out["pool1"].permute(0, 2, 3, 1).reshape(xb.shape[0], -1)
        out["dense0"] = F.linear(flat, prm["dense0.weight"], prm["dense0.bias"])
        out["dense1"] = F.linear(F.relu(out["dense0"]), prm["dense1.weight"],
                                 prm["dense1.bias"])
        out["loss"] = F.cross_entropy(out["dense1"], yb.long())
        return out

    grad = torch.func.grad(cs.make_loss_fn(model))

    def split(fn):
        """fn over the ranks in two stacks of M, concatenated."""
        parts = [fn({k: v[a:a + M] for k, v in params.items()}, (x[a:a + M], y[a:a + M]))
                 for a in range(0, P, M)]
        return {k: torch.cat([q[k] for q in parts]) for k in parts[0]}

    def same(a, b) -> list:
        torch.cuda.synchronize()
        return sorted(k for k in a if not torch.equal(cs.bits(a[k]), cs.bits(b[k])))

    fwd = torch.func.vmap(lambda prm, b: forward(prm, *b))
    out = {"forward_differs": same(fwd(params, (x, y)), split(fwd))}
    forms = {"full": {}, f"chunk{M}": {"chunk_size": M}, "chunk1": {"chunk_size": 1}}
    for name, kw in forms.items():
        g = torch.func.vmap(grad, **kw)
        out[f"grad_differs_{name}"] = same(g(params, (x, y)), split(g))
    ms = {name: cs.time_ms(lambda kw=kw: torch.func.vmap(grad, **kw)(params, (x, y)))
          for name, kw in forms.items()}
    ms["loop"] = cs.time_ms(lambda: [grad({k: v[r] for k, v in params.items()}, (x[r], y[r]))
                                     for r in range(P)])
    out["grad_ms"] = ms
    out["card"] = cs.card()
    print(json.dumps({"vmap_probe": out}), flush=True)


if __name__ == "__main__":
    main()
