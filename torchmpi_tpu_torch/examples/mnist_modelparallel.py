"""MNIST tensor-parallel training on the PyTorch/CUDA port.

The twin of ``examples/mnist_modelparallel.py`` (``mnist_modelparallel.lua``):
the p virtual ranks of one card form a (dp x tp) mesh (tp 4 when it divides
p); an ``MPLinear`` layer splits its 784 input features over tp and sums the
partial products with the grouped ring kernel K3 (forward, and the input
gradients in the backward); the batch is split over dp. The net: 784 ->
``MPLinear(128)`` (no bias) -> ReLU -> ``Dense(10)`` (replicated). A step
takes every rank's gradient of its own loss, averages all gradients over
dp and the head's over tp (``in_graph_synchronize_gradients``, one K3 a
leaf, as the JAX ``pmean``s at ``examples/mnist_modelparallel.py:105-110``),
and applies SGD. Defaults: batch 336, lr 0.05, 3 epochs of
``synthetic_mnist``, the batches of ``np.random.RandomState(seed)``'s
permutations, as the JAX example draws them.

Prints each epoch's loss and the final test accuracy.

Run:  python -m torchmpi_tpu_torch.examples.mnist_modelparallel [--ranks 8]
      [--tp 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn


class MPNet(nn.Module):
    """784 -> 128 (input-split tensor parallel) -> 10 over the rank-stacked
    images ``[p, B, 28, 28]`` (each rank its dp shard); returns ``[p, B,
    10]``. The head is replicated: one draw, every rank's copy."""

    def __init__(self, layout, device=None, seed: int = 0):
        super().__init__()
        from torchmpi_tpu_torch.parallel import MPLinear, MPLinearOutputSplit

        gen = torch.Generator().manual_seed(seed)
        self.layout = layout
        self.mplinear0 = MPLinear(784, 128, layout, "tp", use_bias=False, device=device,
                                  generator=gen)
        self.dense0 = MPLinearOutputSplit(128, 10, layout, device=device, generator=gen)
        with torch.no_grad():
            self.dense0.kernel.copy_(self.dense0.kernel[:1].expand_as(self.dense0.kernel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from torchmpi_tpu_torch.parallel import shard_input_features

        x = x.reshape(x.shape[0], x.shape[1], -1)
        h = torch.relu(self.mplinear0(shard_input_features(x, self.layout, "tp")))
        return self.dense0(h)


def rank_batches(a: np.ndarray, layout, device) -> torch.Tensor:
    """``[B, ...]`` -> rank-stacked ``[p, B / dp, ...]``: rank (i, j) holds
    the i-th dp shard (``P("dp")``)."""
    dp = layout.size("dp")
    t = torch.as_tensor(a, device=device)
    shards = t.reshape((dp, t.shape[0] // dp) + t.shape[1:])
    return shards[torch.as_tensor(layout.axis_index("dp"), device=device)]


def losses_of(model: MPNet, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Every rank's mean cross-entropy over its shard, ``[p]``."""
    logp = torch.log_softmax(model(x), dim=-1)
    return -logp.gather(-1, y[..., None]).squeeze(-1).mean(-1)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--batch", type=int, default=336)
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--train", type=int, default=8192)
    ap.add_argument("--test", type=int, default=2048)
    ap.add_argument("--device", default=None, help="default: cuda:0")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import nn as mpinn
    from torchmpi_tpu_torch.models import accuracy
    from torchmpi_tpu_torch.parallel import make_parallel_mesh
    from torchmpi_tpu_torch.utils import synthetic_mnist

    # full f32 products, as the JAX run computes them
    torch.backends.cuda.matmul.allow_tf32 = False

    mpi.start(ranks=args.ranks, device=args.device)
    try:
        comm = mpi.current_communicator()
        p, device = comm.size, comm.device
        tp = args.tp if p % args.tp == 0 else 1
        dp = p // tp
        layout = make_parallel_mesh(comm, axes={"dp": dp, "tp": tp})
        print(f"ranks={p} mesh=dp{dp} x tp{tp} device={device}")
        model = MPNet(layout, device, args.seed)
        params = dict(model.named_parameters())
        head = [k for k in params if k.startswith("dense0.")]
        (xtr, ytr), (xte, yte) = synthetic_mnist(num_train=args.train, num_test=args.test,
                                                 seed=args.seed)
        bsz = max(1, args.batch // dp) * dp
        rng = np.random.RandomState(args.seed)
        n = len(xtr)
        losses, steps = [], 0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for epoch in range(args.epochs):
            order = rng.permutation(n)
            for i in range(n // bsz):
                idx = order[i * bsz:(i + 1) * bsz]
                x = rank_batches(xtr[idx], layout, device)
                y = rank_batches(ytr[idx].astype(np.int64), layout, device)
                lanes = losses_of(model, x, y)
                grads = dict(zip(params, torch.autograd.grad(lanes.sum(), list(params.values()))))
                grads = mpinn.in_graph_synchronize_gradients(grads, layout, "dp")
                grads.update(mpinn.in_graph_synchronize_gradients(
                    {k: grads[k] for k in head}, layout, "tp"))
                with torch.no_grad():
                    for k, w in params.items():
                        w.sub_(args.lr * grads[k])
                loss = lanes.detach().mean()
                steps += 1
            losses.append(float(loss))
            print(f"epoch {epoch}: loss={losses[-1]:.4f}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - t0

        # evaluation through the same tp mesh: tp coordinate 0's rows
        m = (len(xte) // dp) * dp
        with torch.no_grad():
            logits = model(rank_batches(xte[:m], layout, device))
        rows = torch.as_tensor(np.nonzero(layout.axis_index("tp") == 0)[0], device=device)
        acc = float(accuracy(logits[rows].reshape(m, -1),
                             torch.as_tensor(yte[:m], device=device)))
        sps = steps * bsz / elapsed
        print(f"final: test_acc={acc:.4f} samples/sec/chip={sps:.0f}")
        return {"losses": losses, "acc": acc, "steps": steps, "samples_per_s": sps}
    finally:
        mpi.stop()


if __name__ == "__main__":
    main()
