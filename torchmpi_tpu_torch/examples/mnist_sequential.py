"""Single-process MNIST on the PyTorch/CUDA port: the convergence oracle.

The twin of ``examples/mnist_sequential.py`` (``mnist_sequential.lua``),
the sequential run whose loss the data-parallel recipes must match
(``mnist_allreduce.lua:87-113``): one process, no communicator, plain SGD
(the accumulate kernel adds each step's update to every leaf in one
launch on the card), ``synthetic_mnist``
walked in ``np.random.RandomState(seed)``'s order, one permutation per
epoch, tail batches dropped. Prints each epoch's last loss, then the final
loss and the test accuracy.

Run:  python -m torchmpi_tpu_torch.examples.mnist_sequential [--model lenet]
      [--epochs 5] [--batch 336] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def main(argv: Optional[Sequence[str]] = None,
         init: Optional[Dict[str, torch.Tensor]] = None) -> Tuple[List[float], float]:
    """Train and return ``(epoch losses, test accuracy)``. ``init`` gives the
    initial parameters (e.g. the JAX run's, through ``from_jax_params``);
    by default :func:`~torchmpi_tpu_torch.models.init_params` draws them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="logreg", choices=["logreg", "lenet"])
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--batch", type=int, default=336)
    ap.add_argument("--train", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda:0")
    args = ap.parse_args(argv)

    from torchmpi_tpu_torch.engine import SGD
    from torchmpi_tpu_torch.models import (
        LeNet,
        LogisticRegression,
        accuracy,
        init_params,
        make_loss_fn,
    )
    from torchmpi_tpu_torch.ops import accumulate_many
    from torchmpi_tpu_torch.utils import synthetic_mnist

    device = torch.device(args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    (xtr, ytr), (xte, yte) = synthetic_mnist(num_train=args.train)
    n = len(xtr)
    if args.batch > n:
        raise SystemExit(f"--batch {args.batch} exceeds --train {n}: no full batch fits")
    model = LeNet() if args.model == "lenet" else LogisticRegression()
    params = init if init is not None else init_params(model, seed=args.seed)
    params = {k: v.to(device) for k, v in params.items()}
    grad_fn = torch.func.grad_and_value(make_loss_fn(model))
    opt = SGD(args.lr)
    x_all = torch.as_tensor(xtr, device=device)
    y_all = torch.as_tensor(ytr, device=device).long()

    rng = np.random.RandomState(args.seed)
    losses = []
    for epoch in range(args.epochs):
        order = torch.as_tensor(rng.permutation(n), device=device)
        loss = None
        for i in range(0, n - args.batch + 1, args.batch):
            idx = order[i:i + args.batch]
            grads, loss = grad_fn(params, (x_all[idx], y_all[idx]))
            updates, _ = opt.update(grads, None)
            params = dict(zip(params, accumulate_many(list(params.values()),
                                                      [updates[k] for k in params])))
        losses.append(float(loss))
        print(f"[seq] epoch {epoch}: loss {losses[-1]:.4f}")

    with torch.no_grad():
        logits = torch.func.functional_call(model, params, (torch.as_tensor(xte, device=device),))
    acc = float(accuracy(logits, torch.as_tensor(yte, device=device)))
    print(f"[seq] done: final loss {losses[-1]:.4f}, test acc {acc:.3f}")
    return losses, acc


if __name__ == "__main__":
    main()
