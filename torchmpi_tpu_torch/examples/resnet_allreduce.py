"""ResNet data-parallel AllReduce-SGD on the PyTorch/CUDA port.

The twin of ``examples/resnet_allreduce.py``, BASELINE config 4
("ResNet-50 ImageNet data-parallel via synchronizeGradients"): momentum
SGD over p virtual ranks on one card, the batch-norm statistics averaged
over the ranks every step, and the gradients synchronized in one fused
allreduce per flush of the fusion buffer (``--mode sync``) or in four
async buckets (``--mode async``), each through the ring-allreduce kernel;
the first parameter sync (102 MB a rank for ResNet-50) takes the
ring-broadcast kernel, the momentum step the scale-accumulate kernel and
the update the accumulate kernel; the ranks' gradients are computed one
rank after another (``rank_map='loop'``). ``synthetic_imagenet`` is
staged on the card once (``train_resident``), or with ``--streaming``
streamed by ``data.InputPipeline``: ``--input-workers`` host threads
gather (and under ``--bf16`` cast) each rank-stacked batch into pinned
memory, and its copy to the card runs on a copy stream while the step
before it trains (``engine.train``). Prints per-epoch img/s, the
throughput and MFU against the card's f32 (``--bf16``: bf16) peak by the
analytic FLOP count, checks replica consistency of the parameters and the
statistics, and evaluates the test accuracy over the ranks.

``--fsdp`` shards the parameters and the momentum over the ranks
(``param_sharding='fsdp'``): the parameter shards are gathered before
each forward (the ring-allgather kernel), the batch statistics are the
global batch's, and the partial gradients are reduce-scattered (the ring
reduce-scatter kernel) before the momentum step and the update run on the
shards; the replica check then runs on the gathered parameters.
``--accum-steps N`` cuts each step's per-rank batch into N microbatches
whose gradients are summed before one collective and one update.

Run:  python -m torchmpi_tpu_torch.examples.resnet_allreduce [--mode async]
      [--fsdp] [--accum-steps 4] [--streaming --input-workers 2]
      (ResNet-50, 224 px, 8 ranks, per-rank batch 32 on the card)
      python -m torchmpi_tpu_torch.examples.resnet_allreduce --device cpu
      --ranks 2 --model resnet18 --classes 8 --image-size 16 --train 32
      --test 16 --per-rank-batch 4 [--fsdp --accum-steps 2]
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Optional, Sequence

import torch


def main(argv: Optional[Sequence[str]] = None,
         hooks: Optional[Dict[str, Callable]] = None):
    """Train and return ``(state, test accuracy)``; ``hooks`` are the
    engine's (``on_sample``, ``on_forward``, ...). With ``--streaming``
    ``state['pipeline']`` is the run's :class:`InputPipeline`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet50", choices=["resnet18", "resnet50"])
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--train", type=int, default=1024)
    ap.add_argument("--test", type=int, default=128)
    ap.add_argument("--per-rank-batch", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--mode", default="sync", choices=["sync", "async"])
    ap.add_argument("--bf16", action="store_true", help="bfloat16 convolutions")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default=None, help="default: cuda:0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-3: shard params + optimizer state over the ranks")
    ap.add_argument("--accum-steps", type=int, default=1,
                    help="gradient accumulation microbatches per step")
    ap.add_argument("--streaming", action="store_true",
                    help="stream batches through data.InputPipeline instead of "
                    "staging the dataset on the device")
    ap.add_argument("--input-workers", type=int, default=0,
                    help="producer threads for --streaming (0: the input_workers constant)")
    args = ap.parse_args(argv)

    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import nn as mpinn
    from torchmpi_tpu_torch.engine import SGD, AllReduceSGDEngine
    from torchmpi_tpu_torch.models import (
        ResNet18,
        ResNet50,
        accuracy,
        init_resnet,
        make_eval_fn,
        make_stateful_loss_fn,
    )
    from torchmpi_tpu_torch.utils import synthetic_imagenet
    from torchmpi_tpu_torch.utils.flops import mfu, resnet_forward_flops, train_flops

    # full f32 convolutions and products, as the JAX run on the CPU computes
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    mpi.start(ranks=args.ranks, device=args.device)
    try:
        comm = mpi.current_communicator()
        p = comm.size
        print(f"[resnet] world size {p}: {comm.describe()}")
        dtype = torch.bfloat16 if args.bf16 else torch.float32
        ctor = ResNet50 if args.model == "resnet50" else ResNet18
        model = ctor(num_classes=args.classes, dtype=dtype, device=comm.device)
        params, batch_stats = init_resnet(model, args.image_size, seed=args.seed)
        (xtr, ytr), (xte, yte) = synthetic_imagenet(
            num_train=args.train, num_test=args.test, num_classes=args.classes,
            image_size=args.image_size)
        if args.model == "resnet50":
            fwd_flops = resnet_forward_flops(args.image_size, num_classes=args.classes)
        else:
            fwd_flops = resnet_forward_flops(args.image_size, stage_sizes=(2, 2, 2, 2),
                                             bottleneck=False, num_classes=args.classes)
        flops_per_sample = train_flops(fwd_flops)
        engine = AllReduceSGDEngine(
            make_stateful_loss_fn(model), params, comm=comm, mode=args.mode,
            optimizer=SGD(args.lr, momentum=args.momentum), model_state=batch_stats,
            # per-rank gradients rank by rank: at ResNet-50's width vmap's
            # grouped convolutions are slower and hold every rank's
            # activations at once (PERF.md)
            rank_map="loop",
            param_sharding="fsdp" if args.fsdp else "replicated",
            accum_steps=args.accum_steps,
            flops_per_sample=flops_per_sample,
            hooks=hooks,
        )
        print(f"[resnet] param_sharding {engine.param_sharding}, accum_steps {args.accum_steps}")

        def log_epoch(epoch, loss, secs):
            ips = args.per_rank_batch * p * ((args.train // p // args.per_rank_batch) or 1) / max(secs, 1e-9)
            print(f"[resnet] epoch {epoch}: loss {loss:.4f}  {secs:.2f}s  {ips:,.0f} img/s "
                  f"({ips:,.0f}/chip: {p} virtual ranks on 1 card)")

        if args.streaming:
            from torchmpi_tpu_torch.data import InputPipeline

            pipe = InputPipeline(
                (xtr, ytr), batch_size=args.per_rank_batch * p, num_ranks=p,
                device=comm.device, workers=args.input_workers or None,
                # the resident path's image_dtype cast, on the producer threads
                transform=((lambda xb, yb: (torch.from_numpy(xb).to(dtype), yb))
                           if args.bf16 else None))
            state = engine.train(pipe, max_epochs=args.epochs)
            state["pipeline"] = pipe
            print(f"[resnet] streaming input: {len(pipe)} batches/epoch, input stall "
                  f"{state['input_stall']:.3f}s (the pipeline's consumer stall "
                  f"{pipe.consumer_stall_s:.3f}s)")
        else:
            state = engine.train_resident(xtr, ytr, args.per_rank_batch, max_epochs=args.epochs,
                                          image_dtype=dtype if args.bf16 else None,
                                          epoch_callback=log_epoch)
        ips = state["samples"] / max(state["time"], 1e-9)
        name = torch.cuda.get_device_name(comm.device) if comm.device.type == "cuda" else None
        achieved, frac = mfu(ips, flops_per_sample, name, "bfloat16" if args.bf16 else "float32")
        busy = max(state["time"] - state.get("input_stall", 0.0), 1e-9)
        print(f"[resnet] throughput {ips:,.0f} img/s ({ips:,.0f}/chip), "
              f"{achieved / 1e12:.3f} TFLOP/s/chip"
              + (f", MFU {frac * state['time'] / busy:.1%} (incl. input stall {frac:.1%})"
                 if frac is not None else " (no peak for this device: MFU n/a)"))
        # replica consistency of the parameters and the batch statistics
        mpinn.check_with_allreduce(engine.gathered_params(), comm)
        mpinn.check_with_allreduce(engine.model_state, comm)
        print("check_with_allreduce: ok")
        acc = engine.evaluate(make_eval_fn(model), xte, yte, accuracy)
        print(f"[resnet] {args.model} done: final loss {state['losses'][-1]:.4f}, "
              f"test acc {acc:.3f}, {state['samples']:,} samples in {state['time']:.1f}s")
        return state, acc
    finally:
        mpi.stop()


if __name__ == "__main__":
    main()
