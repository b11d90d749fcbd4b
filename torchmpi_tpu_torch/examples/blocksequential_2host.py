"""BlockSequential-style data parallelism over two virtual hosts on the
PyTorch/CUDA port: BASELINE config 5 ("BlockSequential model-parallel MLP
across 2 TPU hosts (hierarchical communicators)").

The twin of ``examples/blocksequential_2host.py``. The reference's
``nn.BlockSequential`` cuts a network into N blocks of about equal
parameter count and overlaps each block's gradient allreduce with the
rest of the backward (``BlockSequential.lua:29-89, 114-151``). Here:

- :class:`~torchmpi_tpu_torch.nn.GradientBuckets` cuts the leaves into
  ``--blocks`` buckets of about equal size in reverse leaf order; each
  bucket's allreduce is an async dispatch, waited in reverse order;
- a two-level communicator (``push_communicator`` with a host key) splits
  the virtual ranks into ``--hosts`` groups, so each bucket's allreduce
  runs the hierarchical plan: the intra-host allreduce (``--backend
  kernel``: the ring kernel once a host; ``ring``: the hop-by-hop rings),
  then the inter-host ring.

MLP6 (128 features), Adam, ``synthetic_mnist``, the JAX example's
defaults. Prints each epoch's test loss, whether the hierarchical plan ran
(read from the plans the communicator's dispatch memo holds), the test
accuracy and samples/sec/chip (over the epochs after the first, which
warms up), and checks replica consistency with ``check_with_allreduce``.

Run:  python -m torchmpi_tpu_torch.examples.blocksequential_2host
      [--backend ring|kernel] [--ranks 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch


def hier_plans_ran(comm) -> bool:
    """Whether a plan of the ``hier`` or ``staged`` family is bound in the
    communicator's dispatch memo, the plans its collectives ran."""
    memo = comm.__dict__.get("_dispatch_memo", {})
    return any(getattr(getattr(entry[1], "plan", None), "generator", None) in ("hier", "staged")
               for entry in memo.values())


def main(argv: Optional[Sequence[str]] = None,
         init: Optional[Dict[str, torch.Tensor]] = None) -> Tuple[List[float], float, bool, float]:
    """Train and return ``(epoch test losses, test accuracy, hierarchical
    plan ran, samples/sec/chip)``. ``init`` gives the initial parameters
    (e.g. the JAX run's, through ``from_jax_params``); by default
    :func:`~torchmpi_tpu_torch.models.init_params` draws them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=3, help="BlockSequential N")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--opt", default="adam", choices=["adam", "sgd"],
                    help="adam converges on the 6-layer MLP where plain SGD stalls")
    ap.add_argument("--batch-per-rank", type=int, default=8)
    ap.add_argument("--train", type=int, default=1024)
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--backend", default="ring", choices=["ring", "kernel"],
                    help="the intra-host transport of the buckets' allreduces")
    ap.add_argument("--device", default=None, help="default: cuda:0")
    args = ap.parse_args(argv)

    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import constants
    from torchmpi_tpu_torch import nn as mpinn
    from torchmpi_tpu_torch.engine import SGD, Adam
    from torchmpi_tpu_torch.models import MLP6, accuracy, init_params, make_loss_fn
    from torchmpi_tpu_torch.nn import GradientBuckets
    from torchmpi_tpu_torch.utils import DistributedIterator, synthetic_mnist

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    mpi.start(ranks=args.ranks, device=args.device)
    try:
        p = mpi.size()
        if p % args.hosts != 0:
            raise SystemExit(f"world size {p} not divisible by {args.hosts} hosts")
        per_host = p // args.hosts
        mpi.push_communicator(lambda r: f"host{r // per_host}", name="hosts")
        comm = mpi.current_communicator()
        dev = comm.device
        print(f"[bseq] {comm.describe()}")
        if comm.num_intra_groups < 2:
            raise SystemExit("need >= 2 hosts")
        # every bucket on the bandwidth path, so the hierarchical plan is
        # what runs (the JAX example pins the same cutoff); restored on exit
        suffix = constants.platform_suffix(dev.type)
        prev_cutoff = constants.get(f"small_allreduce_size_{suffix}")
        constants.set(f"small_allreduce_size_{suffix}", 1)

        model = MLP6(features=128)
        params = init if init is not None else init_params(model)
        buckets = GradientBuckets(params, args.blocks)
        print(f"[bseq] {len(params)} leaves -> {buckets.num_buckets} blocks "
              "(equal-element partition)")
        stacked = {k: v.to(dev).unsqueeze(0).expand((p,) + tuple(v.shape)).contiguous()
                   for k, v in params.items()}
        stacked = mpinn.synchronize_parameters(stacked, comm=comm)
        opt = Adam(args.lr) if args.opt == "adam" else SGD(args.lr, momentum=0.9)
        opt_state = opt.init(stacked)
        loss_fn = make_loss_fn(model)
        grad_fn = torch.func.vmap(torch.func.grad(loss_fn))

        (xtr, ytr), (xte, yte) = synthetic_mnist(num_train=args.train, num_test=512)
        it = DistributedIterator(xtr, ytr, args.batch_per_rank * p, p, device=dev, seed=3)
        x_test = torch.as_tensor(xte, device=dev)
        y_test = torch.as_tensor(yte, device=dev).long()

        losses: List[float] = []
        samples, seconds = 0, 0.0
        try:
            for epoch in range(args.epochs):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                start = time.perf_counter()
                for xb, yb in it:
                    grads = grad_fn(stacked, (xb, yb))
                    # BlockSequential overlap: one async allreduce a block,
                    # waited in reverse launch order (nn.lua:207-212),
                    # through the intra-host x inter-host plan
                    handles = buckets.allreduce_async(grads, comm=comm, backend=args.backend)
                    grads = buckets.wait_and_unflatten(grads, handles, average=True, comm=comm)
                    updates, opt_state = opt.update(grads, opt_state)
                    stacked = {k: stacked[k] + updates[k] for k in stacked}
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                if epoch > 0 or args.epochs == 1:  # the first epoch warms up
                    samples += len(it) * it.batch_size
                    seconds += time.perf_counter() - start
                with torch.no_grad():
                    rank0 = {k: v[0] for k, v in stacked.items()}
                    loss = float(loss_fn(rank0, (x_test[:256], y_test[:256])))
                losses.append(loss)
                print(f"[bseq] epoch {epoch}: test loss {loss:.4f}")
        finally:
            constants.set(f"small_allreduce_size_{suffix}", prev_cutoff)

        mpinn.check_with_allreduce(stacked, comm=comm)  # replicas in sync
        hier_used = hier_plans_ran(comm)
        print(f"[bseq] hierarchical path used: {hier_used}")
        with torch.no_grad():
            logits = torch.func.functional_call(model, {k: v[0] for k, v in stacked.items()},
                                                (x_test,))
        acc = float(accuracy(logits, y_test))
        sps = samples / seconds  # every virtual rank shares one device: one chip
        print(f"[bseq] done: final loss {losses[-1]:.4f}, test acc {acc:.3f}, "
              f"samples/sec/chip {sps:.0f}")
        return losses, acc, hier_used, sps
    finally:
        mpi.stop()


if __name__ == "__main__":
    main()
