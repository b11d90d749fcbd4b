#!/usr/bin/env python3
"""ROADMAP C6's probe on one card: does ``rank_map='vmap'`` depend on how
many ranks one vmap call stacks, and does either of two forms of the
convolutions' weight gradient repair it?

``python3 chip_vmap_probe.py`` takes config 1's first step (the seed-0
LeNet parameters on every rank, the first batch of 336 over P=8 ranks)
under ``torch.func.vmap`` stacking all P ranks, against the same ranks in
stacks of 4 (the two processes of ``chip_smoke.py --multiprocess`` run
(f)) and in stacks of 2. It compares every intermediate of the forward
and every leaf of the gradient bit for bit (the leaves that differ), for
the native vmap and for the convolutions' weight gradient taken rank by
rank (``'rank'``: one ``convolution_backward`` a rank) or as ``unfold``
and a batched matmul (``'unfold'``), the forward and the input and bias
gradients kept batched (:func:`weight_grad_form`), and times one
gradient of all P ranks under each form and under the loop (CUDA
events, ``chip_smoke.time_ms``). It prints one ``{"vmap_probe":
...}`` line with the card's name and power limit, builds no kernel and
uses ``chip_smoke.py``'s settings (no TF32, deterministic cuDNN).
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

sys.path.insert(0, str(Path(__file__).resolve().parent))

FORMS = ("rank", "unfold")


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _weight_grad_unfold(x, g, wshape, stride, padding, dilation, groups):
    """One rank's weight gradient as ``g`` times the unfolded input: a
    GEMM ``[O, B*HW] @ [B*HW, C*kh*kw]`` (per group); under vmap a
    batched matmul over the ranks."""
    O, Cg, kh, kw = wshape
    B = x.shape[0]
    cols = F.unfold(x, (kh, kw), dilation=dilation, padding=padding, stride=stride)
    hw = cols.shape[-1]
    cols = cols.reshape(B, groups, Cg * kh * kw, hw).permute(1, 0, 3, 2).reshape(
        groups, B * hw, Cg * kh * kw)
    gg = g.reshape(B, groups, O // groups, hw).permute(1, 2, 0, 3).reshape(
        groups, O // groups, B * hw)
    return torch.matmul(gg, cols).reshape(wshape)


class _WeightGradByRank(torch.autograd.Function):
    """One rank's weight gradient; under vmap one call a rank."""

    @staticmethod
    def forward(x, g, wshape, stride, padding, dilation, groups):
        return torch.ops.aten.convolution_backward(
            g, x, g.new_empty(1).expand(wshape), None,
            stride, padding, dilation, False, [0, 0], groups, [False, True, False])[1]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError("the per-rank convolution weight gradient has no derivative")

    @staticmethod
    def vmap(info, in_dims, x, g, wshape, stride, padding, dilation, groups):
        n = info.batch_size
        xd, gd = in_dims[:2]
        x = x.movedim(xd, 0) if xd is not None else x.expand((n,) + x.shape)
        g = g.movedim(gd, 0) if gd is not None else g.expand((n,) + g.shape)
        out = torch.stack([_WeightGradByRank.forward(x[r], g[r], wshape, stride, padding,
                                                     dilation, groups) for r in range(n)])
        return out, 0


class _Conv2d(torch.autograd.Function):
    """``F.conv2d`` whose weight gradient takes ``form``; the forward and
    the input and bias gradients are the native ones."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, b, stride, padding, dilation, groups, form):
        return F.conv2d(x, w, b, stride, padding, dilation, groups)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, b, stride, padding, dilation, groups, form = inputs
        ctx.save_for_backward(x, w)
        ctx.conf = (_pair(stride), _pair(padding), _pair(dilation), groups, form)
        ctx.bias = None if b is None else tuple(b.shape)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups, form = ctx.conf
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        gx = gb = gw = None
        if need_x or (need_b and ctx.bias is not None):
            gx, _, gb = torch.ops.aten.convolution_backward(
                g, x, w, list(ctx.bias) if ctx.bias is not None else None, stride, padding,
                dilation, False, [0, 0], groups,
                [bool(need_x), False, bool(need_b and ctx.bias is not None)])
        if need_w:
            if form == "unfold":
                gw = _weight_grad_unfold(x, g, tuple(w.shape), stride, padding, dilation, groups)
            else:
                gw = _WeightGradByRank.apply(x, g, tuple(w.shape), stride, padding, dilation,
                                             groups)
        return gx, gw, gb, None, None, None, None, None


class _Mode(TorchFunctionMode):
    def __init__(self, form: str):
        super().__init__()
        self.form = form

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.conv2d:
            names = ("input", "weight", "bias", "stride", "padding", "dilation", "groups")
            given = dict(zip(names, args), **kwargs)
            padding = given.get("padding", 0)
            if not isinstance(padding, str):
                return _Conv2d.apply(given["input"], given["weight"], given.get("bias"),
                                     given.get("stride", 1), padding, given.get("dilation", 1),
                                     given.get("groups", 1), self.form)
        return func(*args, **kwargs)


def weight_grad_form(form):
    """A context in which ``F.conv2d`` takes the weight-gradient ``form``
    ('rank' or 'unfold'); None is no change."""
    if form is None:
        return contextlib.nullcontext()
    if form not in FORMS:
        raise ValueError(f"weight-gradient form must be one of {FORMS}, got {form!r}")
    return _Mode(form)


def main() -> None:
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

    def split(fn, m):
        """fn over the ranks in stacks of m, concatenated."""
        parts = [fn({k: v[a:a + m] for k, v in params.items()}, (x[a:a + m], y[a:a + m]))
                 for a in range(0, P, m)]
        return {k: torch.cat([q[k] for q in parts]) for k in parts[0]}

    def same(a, b) -> list:
        torch.cuda.synchronize()
        return sorted(k for k in a if not torch.equal(cs.bits(a[k]), cs.bits(b[k])))

    fwd = torch.func.vmap(lambda prm, b: forward(prm, *b))
    out = {"forward_differs": {m: same(fwd(params, (x, y)), split(fwd, m)) for m in (M, 2)}}
    g = torch.func.vmap(grad)
    ms = {}
    for form in (None, *FORMS):
        name = form or "full"
        with weight_grad_form(form):
            whole = g(params, (x, y))
            out[f"grad_differs_{name}"] = {m: same(whole, split(g, m)) for m in (M, 2)}
            ms[name] = cs.time_ms(lambda: g(params, (x, y)))
    ms["loop"] = cs.time_ms(lambda: [grad({k: v[r] for k, v in params.items()}, (x[r], y[r]))
                                     for r in range(P)])
    out["grad_ms"] = ms
    out["card"] = cs.card()
    print(json.dumps({"vmap_probe": out}), flush=True)


if __name__ == "__main__":
    main()
