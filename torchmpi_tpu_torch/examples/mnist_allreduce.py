"""MNIST AllReduce-SGD, synchronous or asynchronous, on the PyTorch/CUDA port.

The twin of ``examples/mnist_allreduce.py`` (``mnist_allreduce.lua`` and
``mnist_allreduce_async.lua``): lr 0.2, global batch 336 split over the
ranks, ``synthetic_mnist``; the p virtual ranks share one CUDA card, the
first parameter sync runs the ring-broadcast kernel and every step's
gradient sync the ring-allreduce kernel. ``--mode async`` syncs the
gradients in buckets, each an async allreduce on a side stream, waited in
reverse order. The engine's wire is the ``wire_dtype`` constant ('full'
unless set), as the JAX example has no wire flag. Prints the final loss,
the test accuracy and samples/sec/chip, and checks replica consistency
with ``check_with_allreduce``.

Run:  python -m torchmpi_tpu_torch.examples.mnist_allreduce --model lenet
      --ranks 8 [--mode async] [--batch 336] [--epochs 5] [--device cuda]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence, Tuple

import torch


def main(argv: Optional[Sequence[str]] = None) -> Tuple[float, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="sync", choices=["sync", "async"])
    ap.add_argument("--model", default="logreg", choices=["logreg", "lenet"])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--batch", type=int, default=336)
    ap.add_argument("--device", default=None, help="default: cuda:0")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import nn as mpinn
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import (
        LeNet,
        LogisticRegression,
        accuracy,
        init_params,
        make_loss_fn,
    )
    from torchmpi_tpu_torch.utils import DistributedIterator, synthetic_mnist

    # full f32 convolutions and products, as the JAX run on the CPU computes
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    mpi.start(ranks=args.ranks, device=args.device)
    try:
        comm = mpi.current_communicator()
        p = comm.size
        print(f"ranks={p} device={comm.device} mode={args.mode}")
        (xtr, ytr), (xte, yte) = synthetic_mnist(seed=args.seed)
        batch = max(1, args.batch // p) * p  # divisible global batch (336/size)
        model = LeNet() if args.model == "lenet" else LogisticRegression()
        engine = AllReduceSGDEngine(
            make_loss_fn(model),
            init_params(model, seed=args.seed),
            lr=args.lr,
            comm=comm,
            mode=args.mode,
            hooks={
                "on_end_epoch": lambda s: print(
                    f"epoch {s['epoch']}: loss={s['losses'][-1]:.4f}"
                )
            },
        )
        it = DistributedIterator(xtr, ytr, batch, p, device=comm.device, seed=args.seed)
        state = engine.train(lambda: iter(it), max_epochs=args.epochs)

        # replica consistency (checkWithAllreduce invariant, init.lua:372-395)
        mpinn.check_with_allreduce(engine.params, comm)
        print("check_with_allreduce: ok")

        final = {k: v[0] for k, v in engine.params.items()}
        with torch.no_grad():
            logits = torch.func.functional_call(
                model, final, (torch.as_tensor(xte, device=comm.device),)
            )
        acc = float(accuracy(logits, torch.as_tensor(yte, device=comm.device)))
        sps = state["samples"] / state["time"]
        chips = 1  # every virtual rank shares one device
        print(
            f"final: loss={state['losses'][-1]:.4f} test_acc={acc:.4f} "
            f"samples/sec={sps:.0f} samples/sec/chip={sps / chips:.0f}"
        )
        return state["losses"][-1], acc
    finally:
        mpi.stop()


if __name__ == "__main__":
    main()
