"""MNIST parameter-server training on the PyTorch/CUDA port.

The twin of ``examples/mnist_parameterserver.py``
(``mnist_parameterserver_{downpour,easgd,dsgd,easgd_dataparallel}.lua``):
each of p virtual ranks runs local SGD on its own replica (the replicas
diverge between integrations, the defining property of async PS training)
while the chosen schedule exchanges state with the sharded parameter
server, whose shards live on the same device:

- ``downpour``: every step each rank sends its accumulated gradients,
  scaled by -lr/p, with the 'add' rule; every ``--tau`` steps the replicas
  adopt the fetched center;
- ``easgd``: every ``--tau`` steps the replicas move toward the center by
  alpha = beta/p and send the elastic difference back;
- ``dsgd``: every step the gradients are averaged through the PS and
  re-applied, so the replicas stay together.

The per-rank step is ``torch.func.vmap`` of ``grad_and_value``, and its
update ``w - lr*g`` runs through the scaled-accumulate kernel (one
rounding, as the JAX package's jitted step); so does the DSGD
re-application ``w + lr*g_loc - lr*g_avg``, as two calls. ``--dataparallel``
makes DP groups of 2 whose roots alone integrate, then broadcast.
``--wire-dtype`` quantizes every client<->server exchange; the shards stay
f32. Model: ``LogisticRegression``, as in the JAX example; ``train`` takes
any model (``chip_smoke.py`` runs LeNet).

Run:  python -m torchmpi_tpu_torch.examples.mnist_parameterserver
      --variant downpour|easgd|dsgd [--dataparallel] [--ranks 8]
      [--device cpu] [--epochs 3] [--wire-dtype full|bf16|int8]
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional, Sequence

import torch

from ..models import LogisticRegression, accuracy, init_params, make_loss_fn


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="downpour", choices=["downpour", "easgd", "dsgd"])
    ap.add_argument(
        "--dataparallel",
        action="store_true",
        help="hierarchical PS x DP: DP groups of 2 "
        "(mnist_parameterserver_easgd_dataparallel.lua)",
    )
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--batch", type=int, default=336)
    ap.add_argument("--tau", type=int, default=10, help="updateFrequency")
    ap.add_argument("--init-delay", type=int, default=20)
    ap.add_argument("--beta", type=float, default=0.9)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default=None, help="default: cuda:0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--wire-dtype",
        default="full",
        choices=["full", "bf16", "int8"],
        help="parameter-server wire encoding of every client<->server "
        "exchange (parameterserver_wire_dtype); the shards stay f32",
    )
    ap.add_argument("--train", type=int, default=8192)
    return ap.parse_args(argv)


def train(model: torch.nn.Module, args: argparse.Namespace, params0=None,
          on_step: Optional[Callable[[int], None]] = None) -> dict:
    """The example's training loop on ``model``, on the current
    communicator (``start()`` first). ``params0``: the initial (un-stacked)
    parameters, by default ``init_params(model, seed=args.seed)``;
    ``on_step(t)`` is called after step t.

    Returns the last step's mean loss of each epoch (``losses``), every
    step's (``step_losses``), the final rank-stacked ``params``, the
    replicas' ``spread`` (max |params[r] - params[0]|), rank 0's test
    ``acc``, the seconds and samples of each epoch, and the ``steps``."""
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import constants
    from torchmpi_tpu_torch.collectives.eager import run_group_broadcast
    from torchmpi_tpu_torch.ops import scale_accumulate
    from torchmpi_tpu_torch.parameterserver import (
        DownpourUpdate,
        EASGDUpdate,
        synchronize_gradients_with_parameterserver,
    )
    from torchmpi_tpu_torch.utils import DistributedIterator, synthetic_mnist

    constants.set("parameterserver_wire_dtype", args.wire_dtype)
    comm = mpi.current_communicator()
    p, dev, lr = comm.size, comm.device, args.lr
    dp_level = None
    if args.dataparallel:
        dp_level = mpi.push_communicator(lambda r: str(r // 2), name="dp")
        mpi.set_communicator(0)
    print(f"ranks={p} device={dev} variant={args.variant} dp={bool(dp_level)}")

    (xtr, ytr), (xte, yte) = synthetic_mnist(num_train=args.train, seed=args.seed)
    if params0 is None:
        params0 = init_params(model, seed=args.seed)
    # rank-stacked replicas, identical at t=0
    params = {
        k: v.detach().to(dev).unsqueeze(0).repeat((p,) + (1,) * v.ndim)
        for k, v in params0.items()
    }
    grad_fn = torch.func.vmap(torch.func.grad_and_value(make_loss_fn(model)))

    update = None
    if args.variant == "downpour":
        # scale by -lr/p: the server sums contributions from p ranks
        update = DownpourUpdate(
            local_update=lambda t: t * (-lr / p),
            send_frequency=1,
            update_frequency=args.tau,
            init_delay=args.init_delay,
            comm=comm,
            dataparallel_level=dp_level,
        )
    elif args.variant == "easgd":
        update = EASGDUpdate(
            beta=args.beta,
            update_frequency=args.tau,
            init_delay=args.init_delay,
            comm=comm,
            dataparallel_level=dp_level,
        )

    batch = max(1, args.batch // p) * p
    it = DistributedIterator(xtr, ytr, batch, p, device=dev, seed=args.seed)
    ps_group = None
    t = 0
    step_losses, epoch_losses, seconds = [], [], []
    try:
        for epoch in range(args.epochs):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for x, y in it:
                grads, losses = grad_fn(params, (x, y))
                grads = {k: g.contiguous() for k, g in grads.items()}
                # the per-rank local step, w - lr*g, rounded once
                params = {k: scale_accumulate(w, grads[k], -lr) for k, w in params.items()}
                if dp_level is not None:
                    # keep the replicas of each DP group together
                    # (easgd_dataparallel.lua:69-71)
                    dp = mpi.stack().at(dp_level)
                    params = {k: run_group_broadcast(w, dp, root=0) for k, w in params.items()}
                if args.variant == "dsgd":
                    # the PS-averaged gradient replaces the local one, so
                    # the replicas stay identical
                    synced, ps_group = synchronize_gradients_with_parameterserver(
                        grads, ps_group, comm=comm
                    )
                    params = {
                        k: scale_accumulate(scale_accumulate(w, grads[k], lr),
                                            synced[k].contiguous(), -lr)
                        for k, w in params.items()
                    }
                elif update is not None:
                    params = update.update(t, params, grads)
                step_losses.append(losses.mean())
                if on_step is not None:
                    on_step(t)
                t += 1
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            seconds.append(time.perf_counter() - t0)
            epoch_losses.append(float(step_losses[-1]))
            print(f"epoch {epoch}: loss={epoch_losses[-1]:.4f}")
    finally:
        if update is not None:
            update.free()
        if ps_group is not None:
            ps_group.free()

    # rank 0's replica (post-integration replicas agree)
    final = {k: v[0] for k, v in params.items()}
    with torch.no_grad():
        logits = torch.func.functional_call(model, final, (torch.as_tensor(xte, device=dev),))
    acc = float(accuracy(logits, torch.as_tensor(yte, device=dev)))
    spread = max(float((w - w[0:1]).abs().max()) for w in params.values())
    print(f"final: test_acc={acc:.4f} replica_spread={spread:.2e}")
    per_epoch = len(it) * batch
    return {
        "losses": epoch_losses,
        "step_losses": [float(v) for v in step_losses],
        "params": params,
        "spread": spread,
        "acc": acc,
        "seconds": seconds,
        "samples_per_epoch": per_epoch,
        "steps": t,
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    import torchmpi_tpu_torch as mpi

    args = parse_args(argv)
    mpi.start(ranks=args.ranks, device=args.device)
    try:
        return train(LogisticRegression(), args)
    finally:
        mpi.stop()


if __name__ == "__main__":
    main()
