"""Pipeline-parallel training on the PyTorch/CUDA port.

The twin of ``examples/pipeline_stages.py``: the p virtual ranks of one
card form a (dp x pp) mesh (pp 4 when it divides p), one residual stage
``x + tanh(x @ w)`` a pp rank, trained against a fixed teacher chain.
``--schedule gpipe`` differentiates the GPipe loop
(``parallel.pipeline_loss_fn``, the lanes summed: 'grad-inside'),
``--schedule 1f1b`` runs the PipeDream-flush schedule
(``parallel.pipeline_1f1b_value_and_grad``). A step averages the stage
gradients over dp (``in_graph_synchronize_gradients``: one grouped K3),
and the last-stage loss is summed over pp by one more. Defaults as the
JAX example's: pp 4, 8 microbatches of 16, width 32, 8 epochs of 8 steps,
lr 0.3; the weights, teacher and batches drawn from
``np.random.RandomState(seed)`` in its order.

Prints each epoch's loss and microbatches/sec (epochs after the first),
and fails if the loss does not fall.

Run:  python -m torchmpi_tpu_torch.examples.pipeline_stages [--ranks 8]
      [--pp 4] [--schedule gpipe|1f1b] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

STEPS_PER_EPOCH = 8


def stage_fn(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One residual stage on every rank's rows: ``x + tanh(x @ w)``."""
    return x + torch.tanh(torch.bmm(x, w))


def mse_lanes(y: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Every rank's (row's) mean squared error, ``[rows]``."""
    return ((y - t) ** 2).flatten(1).mean(1)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--pp", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--mb-size", type=int, default=16)
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--schedule", choices=["gpipe", "1f1b"], default="1f1b")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default=None, help="default: cuda:0")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import nn as mpinn
    from torchmpi_tpu_torch.models import axis_stack_from_jax
    from torchmpi_tpu_torch.parallel import (
        make_parallel_mesh,
        pipeline_1f1b_value_and_grad,
        pipeline_loss_fn,
    )

    torch.backends.cuda.matmul.allow_tf32 = False

    mpi.start(ranks=args.ranks, device=args.device)
    try:
        comm = mpi.current_communicator()
        p, device = comm.size, comm.device
        pp = args.pp if p % args.pp == 0 else 1
        dp = p // pp
        layout = make_parallel_mesh(comm, axes={"dp": dp, "pp": pp})
        m, mb, d = args.microbatches, args.mb_size, args.width
        print(f"ranks={p} mesh=dp{dp} x pp{pp} schedule={args.schedule} m={m} mb={mb} d={d} "
              f"device={device}")

        rng = np.random.RandomState(args.seed)
        # residual stages keep activations well-conditioned at any depth
        W = axis_stack_from_jax(rng.randn(pp, d, d).astype(np.float32) * 0.1, layout,
                                "pp").to(device)
        teacher = [rng.randn(d, d).astype(np.float32) * 0.3 for _ in range(pp)]

        def make_batch():
            x = rng.randn(dp, m, mb, d).astype(np.float32)
            t = x.copy()
            for wt in teacher:
                t = t + np.tanh(t @ wt)
            return (axis_stack_from_jax(x, layout, "dp").to(device),
                    axis_stack_from_jax(t, layout, "dp").to(device))

        if args.schedule == "gpipe":
            loss_fn = pipeline_loss_fn(stage_fn, mse_lanes, layout)

            def grads_of(w, x, t):
                w = w.detach().requires_grad_()
                lanes = loss_fn(w, x, t)
                return lanes, torch.autograd.grad(lanes.sum(), w)[0]
        else:
            grads_of = pipeline_1f1b_value_and_grad(stage_fn, mse_lanes, layout)

        losses, steps, t0, timed_epochs = [], 0, None, 0
        for epoch in range(args.epochs):
            for _ in range(STEPS_PER_EPOCH):
                x, t = make_batch()
                lanes, g = grads_of(W, x, t)
                g = mpinn.in_graph_synchronize_gradients({"w": g}, layout, "dp")["w"]
                W = (W - args.lr * g).detach()
                steps += 1
            loss = float(lanes.detach().mean())  # waits for the epoch's steps
            if t0 is None:  # epoch 0 warms up
                t0 = time.perf_counter()
            else:
                timed_epochs += 1
            losses.append(loss)
            print(f"epoch {epoch}: loss={loss:.5f}")
        dt = time.perf_counter() - t0
        rate = timed_epochs * STEPS_PER_EPOCH * m * dp / dt if timed_epochs else None
        print(f"final: loss={losses[-1]:.5f} first={losses[0]:.5f} "
              f"microbatches/sec={rate if rate is None else round(rate, 1)}")
        if not losses[-1] < losses[0]:
            raise SystemExit("pipeline training failed to converge")
        return {"losses": losses, "steps": steps, "microbatches_per_s": rate}
    finally:
        mpi.stop()


if __name__ == "__main__":
    main()
