#!/usr/bin/env python3
"""ROADMAP C6's probe on one card: does ``rank_map='vmap'`` depend on how
many ranks one vmap call stacks, with the native batched ops (cuDNN's
grouped weight gradient, cuBLAS's batched products) and with the per-rank
kernels the engine takes on the card?

``python3 chip_vmap_probe.py`` takes config 1's first step (the seed-0
LeNet parameters on every rank, the first batch of 336 over P=8 ranks) and
config 5's (the seed-0 MLP6 at 128 features, 8 images a rank) under
``torch.func.vmap`` stacking all P ranks, against the same ranks in stacks
of 4 (the two processes of ``chip_smoke.py --multiprocess`` run (f)) and
in stacks of 2 (the four of run (h)). It compares every intermediate of
LeNet's forward and every leaf of both gradients bit for bit (the leaves
that differ), for the native vmap (``'native'``) and for the engine's
form (``'kernel'``: ``engine/rankwise.py``, each convolution's weight
gradient by ``ops.conv2d_weight_grad_ranks`` and each batched product by
``ops.rank_bmm``; :func:`product_form`), prints each leaf's largest
difference between the two forms, and times one LeNet gradient of all P
ranks under each form in turns (native, kernel, kernel, native) and under
the loop (CUDA events, ``chip_smoke.time_ms``). It prints one
``{"vmap_probe": ...}`` line with the card's name and power limit and uses
``chip_smoke.py``'s settings (no TF32, deterministic cuDNN); the kernels
build at their first call.

:func:`native_vmap` and :func:`step_in_turns` serve ``chip_smoke.py``'s
``rank_maps``: config 1's engine step with the kernels against the native
form, in turns.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))

FORMS = ("native", "kernel")


@contextlib.contextmanager
def native_vmap():
    """The engine's vmap gradient on the card with the native batched ops
    (ROADMAP C6's fault: cuDNN's grouped weight gradient, cuBLAS's batched
    products), in place of the per-rank kernels ``engine/rankwise.py``
    routes them through: kept here only, as the yardstick of the repair."""
    from torchmpi_tpu_torch.engine import sgd

    kept = sgd.by_rank_products
    sgd.by_rank_products = lambda batched: batched
    try:
        yield
    finally:
        sgd.by_rank_products = kept


def product_form(form):
    """A context in which a vmap's convolutions and batched products take
    the ``form``: 'kernel' (``engine/rankwise.py``, the engine's) or
    'native'."""
    if form not in FORMS:
        raise ValueError(f"product form must be one of {FORMS}, got {form!r}")
    if form == "native":
        return contextlib.nullcontext()
    from torchmpi_tpu_torch.engine.rankwise import rank_products

    return rank_products()


def step_in_turns(make_engine, batches: list, warmup: int, pairs: int) -> dict:
    """The engine's mean step time (ms) over ``batches[warmup:]`` after
    ``batches[:warmup]``, with the per-rank kernels ('kernel') and with the
    native form (:func:`native_vmap`), in ``pairs`` pairs whose order
    alternates (kernel, native, native, kernel, ...), each on a new
    ``mpi.start(ranks=P)`` and engine (``make_engine(comm)``). Returns each
    form's readings, median and spread (max - min), and the median of the
    pairs' kernel / native ratios."""
    import chip_smoke as cs

    out = {form: [] for form in FORMS}
    for i in range(2 * pairs):
        form = FORMS[(i + i // 2) % 2 == 0]
        cs.mpi.start(ranks=cs.P)
        try:
            with native_vmap() if form == "native" else contextlib.nullcontext():
                engine = make_engine(cs.mpi.current_communicator())
                for b in batches[:warmup]:
                    engine.step(b)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for b in batches[warmup:]:
                    engine.step(b)
                torch.cuda.synchronize()
            out[form].append((time.perf_counter() - t0) / (len(batches) - warmup) * 1e3)
            del engine
        finally:
            cs.mpi.stop()
    ratios = [k / n for k, n in zip(out["kernel"], out["native"])]
    return {**{f"{form}_ms": out[form] for form in FORMS},
            **{f"{form}_median_ms": statistics.median(out[form]) for form in FORMS},
            **{f"{form}_spread_ms": max(out[form]) - min(out[form]) for form in FORMS},
            "ratio_median": statistics.median(ratios), "ratios": ratios,
            "steps": len(batches) - warmup, "pairs": pairs}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_vmap_probe: no CUDA device; this run needs one card")
    import chip_smoke as cs
    from torchmpi_tpu_torch.models import MLP6

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
    mlp = MLP6(features=128)
    mlp_params = {k: v.to(dev).unsqueeze(0).repeat((P,) + (1,) * v.ndim)
                  for k, v in cs.init_params(mlp, seed=0).items()}
    mx, my = next(iter(cs.DistributedIterator(xtr, ytr, cs.CONFIG5["batch_per_rank"] * P, P,
                                              device=dev, seed=3)))

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

    def split(fn, m, prm, xb, yb):
        """fn over the ranks in stacks of m, concatenated."""
        parts = [fn({k: v[a:a + m] for k, v in prm.items()}, (xb[a:a + m], yb[a:a + m]))
                 for a in range(0, P, m)]
        return {k: torch.cat([q[k] for q in parts]) for k in parts[0]}

    def same(a, b) -> list:
        torch.cuda.synchronize()
        return sorted(k for k in a if not torch.equal(cs.bits(a[k]), cs.bits(b[k])))

    fwd = torch.func.vmap(lambda prm, b: forward(prm, *b))
    out = {"forward_differs": {m: same(fwd(params, (x, y)), split(fwd, m, params, x, y))
                               for m in (M, 2)}}
    g = torch.func.vmap(grad)
    g_mlp = torch.func.vmap(torch.func.grad(cs.make_loss_fn(mlp)))
    ms = {}
    # in turns: native, kernel, kernel, native
    for form in ("native", "kernel", "kernel", "native"):
        with product_form(form):
            if f"grad_differs_{form}" not in out:
                whole = g(params, (x, y))
                out[f"grad_differs_{form}"] = {m: same(whole, split(g, m, params, x, y))
                                               for m in (M, 2)}
                whole = g_mlp(mlp_params, (mx, my))
                out[f"mlp6_grad_differs_{form}"] = {
                    m: same(whole, split(g_mlp, m, mlp_params, mx, my)) for m in (M, 2)}
            ms.setdefault(form, []).append(cs.time_ms(lambda: g(params, (x, y))))
    with product_form("native"):
        native = g(params, (x, y))
    with product_form("kernel"):
        kernel = g(params, (x, y))
    torch.cuda.synchronize()
    out["kernel_vs_native_max_abs"] = {k: float((kernel[k] - native[k]).abs().max())
                                       for k in native}
    ms["loop"] = cs.time_ms(lambda: [grad({k: v[r] for k, v in params.items()}, (x[r], y[r]))
                                     for r in range(P)])
    out["grad_ms"] = ms
    out["card"] = cs.card()
    print(json.dumps({"vmap_probe": out}), flush=True)


if __name__ == "__main__":
    main()
