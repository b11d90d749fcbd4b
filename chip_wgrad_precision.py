#!/usr/bin/env python3
"""The per-rank convolution weight gradient's precision on one card.

``python3 chip_wgrad_precision.py`` draws each of ``chip_smoke.py``'s
``WGRAD_SHAPES`` from a seed and prints, for each, how far three f32
weight gradients lie from the f64 sums, relative to max |f64|: the
kernel (``ops.conv2d_weight_grad_ranks``), cuDNN's (``torch.nn.grad.
conv2d_weight`` a rank at a time under ``cudnn.deterministic``, as
``chip_smoke.py`` runs) and ATen's on the CPU; then cuDNN's at ``conv1``'s
shape with ``cudnn.deterministic`` off. Then the same on the main path's
own data: config 1's first step (the seed-0 LeNet on 8 ranks of 42
images), each convolution's input and output gradient taken in f64 a rank
at a time and rounded to f32, given to the kernel both contiguous and as
the engine's vmap passes them (views of the grouped convolution's
layout). No TF32 anywhere. It shows which of the kernel and its plain
version a disagreement between them comes from; the kernel builds at its
first call.
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))


def cudnn_grad(x, dy, ws, st, pd, dl):
    return torch.stack([torch.nn.grad.conv2d_weight(x[r], ws, dy[r], st, pd, dl)
                        for r in range(x.shape[0])])


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_wgrad_precision: no CUDA device; this run needs one card")
    import chip_smoke as cs
    from torchmpi_tpu_torch import ops

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def rel(a, f64):
        return float((a.double() - f64.to(a.device)).abs().max()) / float(f64.abs().max())

    print(cs.card())
    for shape in cs.WGRAD_SHAPES:
        x, dy, ws, st, pd, dl = cs.wgrad_inputs(shape, randn)
        f64 = ops.conv2d_weight_grad_ranks_plain(x.double(), dy.double(), ws, st, pd, dl)
        print(shape, "kernel vs f64", rel(ops.conv2d_weight_grad_ranks(x, dy, ws, st, pd, dl), f64),
              "cudnn f32 vs f64", rel(cudnn_grad(x, dy, ws, st, pd, dl), f64),
              "cpu f32 vs f64", rel(cudnn_grad(x.cpu(), dy.cpu(), ws, st, pd, dl), f64),
              flush=True)
    real_data(cs, ops, dev, rel)
    torch.backends.cudnn.deterministic = False
    x, dy, ws, st, pd, dl = cs.wgrad_inputs(cs.WGRAD_CONV1, randn)
    f64 = ops.conv2d_weight_grad_ranks_plain(x.double(), dy.double(), ws, st, pd, dl)
    print("conv1: non-deterministic cudnn f32 vs f64", rel(cudnn_grad(x, dy, ws, st, pd, dl), f64))


def real_data(cs, ops, dev, rel) -> None:
    """The kernel on config 1's first step: each convolution's input and
    output gradient from an f64 pass a rank at a time (cuDNN off)."""
    import torch.nn.functional as F

    (xtr, ytr), _ = cs.synthetic_mnist()
    x, y = next(iter(cs.DistributedIterator(xtr, ytr, cs.BATCH, cs.P, device=dev)))
    params = {k: v.to(dev).double().requires_grad_()
              for k, v in cs.init_params(cs.LeNet(), seed=0).items()}
    ins = {"conv0": [], "conv1": []}
    with torch.backends.cudnn.flags(enabled=False):
        for r in range(cs.P):
            h0 = x[r].double().reshape(-1, 1, 28, 28)
            o0 = F.conv2d(h0, params["conv0.weight"], params["conv0.bias"], padding=2)
            h1 = F.max_pool2d(F.relu(o0), 2)
            o1 = F.conv2d(h1, params["conv1.weight"], params["conv1.bias"], padding=2)
            flat = F.max_pool2d(F.relu(o1), 2).permute(0, 2, 3, 1).reshape(len(h0), -1)
            logits = F.linear(F.relu(F.linear(flat, params["dense0.weight"],
                                              params["dense0.bias"])),
                              params["dense1.weight"], params["dense1.bias"])
            d0, d1 = torch.autograd.grad(F.cross_entropy(logits, y[r].long()), (o0, o1))
            ins["conv0"].append((h0, d0))
            ins["conv1"].append((h1.detach(), d1))
    for name, pairs in ins.items():
        xs = torch.stack([a for a, _ in pairs])
        dys = torch.stack([d for _, d in pairs])
        ws = (dys.shape[2], xs.shape[2], 5, 5)
        f64 = ops.conv2d_weight_grad_ranks_plain(xs, dys, ws, 1, 2, 1)
        xf, dyf = xs.float(), dys.float()
        R, B = xf.shape[:2]
        grouped = (xf.transpose(0, 1).reshape(B, -1, *xf.shape[3:]).unflatten(1, (R, -1))
                   .transpose(0, 1),
                   dyf.transpose(0, 1).reshape(B, -1, *dyf.shape[3:]).unflatten(1, (R, -1))
                   .transpose(0, 1))
        with torch.backends.cudnn.flags(enabled=False):
            aten = ops.conv2d_weight_grad_ranks_plain(xf, dyf, ws, 1, 2, 1)
        print(f"config 1 step 1 {name}: kernel vs f64",
              rel(ops.conv2d_weight_grad_ranks(xf, dyf, ws, 1, 2, 1), f64),
              "kernel (the vmap's grouped views) vs f64",
              rel(ops.conv2d_weight_grad_ranks(*grouped, ws, 1, 2, 1), f64),
              "aten f32 vs f64", rel(aten, f64), "cudnn f32 vs f64",
              rel(cudnn_grad(xf, dyf, ws, 1, 2, 1), f64),
              "cpu f32 vs f64", rel(cudnn_grad(xf.cpu(), dyf.cpu(), ws, 1, 2, 1), f64),
              flush=True)


if __name__ == "__main__":
    main()
