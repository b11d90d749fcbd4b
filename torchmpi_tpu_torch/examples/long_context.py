"""Long-context LM training with ring-attention sequence parallelism on the
PyTorch/CUDA port.

The twin of ``examples/long_context.py``. The p virtual ranks of one card
form a (dp x sp) mesh; the sequence is sharded over sp, so every layer's
attention runs the ring of :func:`ring_self_attention` (with
``--sp-backend kernel_full``: the forward kernel K8 and the backward kernel
K10), and dp is folded into the batch. Task: next-token prediction on a
periodic token stream (period 17), the batches drawn from
``np.random.RandomState(seed)`` in the JAX example's order and fed in order.

The step: every rank's loss is ``-sum(ll) / (B * (t_local - 1))`` over its
shard, with only the last global position masked; the JAX ``pmean`` of
loss and gradients over (dp, sp) is, on one card, the backward of the mean
of the per-rank losses in one autograd graph (the ring attention backward
carries the cross-rank cotangents ``ppermute``'s transpose carries in
JAX), and the replicated parameters are one copy. Adam as ``optax.adam``
(b1 0.9, b2 0.999, eps 1e-8).

Prints the step losses, tokens/sec/chip (steps after the first, which
builds the kernels), TFLOP/s/chip and MFU against the card's f32 peak,
and exits non-zero if the loss does not fall.

``--dtype bf16`` computes the embeddings and blocks in bf16 (the
kernels K8/K10 then take bf16), ``--remat`` recomputes each block in the
backward (K8 launched twice a layer and step).

``--engine`` runs the LM as the JAX package's benchmark does
(``bench.py:758-782``): ``synthetic_tokens(--num-seqs, --seq, --vocab)``
through ``AllReduceSGDEngine(make_lm_loss_fn(model), optimizer=Adam(lr),
rank_map="loop").train_resident`` with ``--batch`` sequences a rank, no
sequence parallelism (full attention, plain torch), the gradients synced
by the engine's fused ring-allreduce flushes (K3), the first parameter
sync a ring broadcast (K7). It prints each epoch's mean loss,
tokens/sec/chip and step ms over the epochs after the first, and the
peak memory on a card.

Run:  python -m torchmpi_tpu_torch.examples.long_context --ranks 4 --sp 4
      --seq 4096 --batch 4 --steps 20 --lr 3e-4 --sp-backend kernel_full
      --vocab 8192 --layers 8 --heads 8 --head-dim 64 --d-model 512
      (``--device cpu`` runs the kernels' plain versions on the CPU)
      python -m torchmpi_tpu_torch.examples.long_context --engine --ranks 8
      --seq 1024 --batch 8 --num-seqs 256 --epochs 2 --lr 3e-4 --dtype bf16
      --vocab 8192 --layers 8 --heads 8 --head-dim 64 --d-model 512
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

BACKENDS = ("xla", "auto", "kernel", "kernel_full", "kernel_bidir", "kernel_bidir_full")
PERIOD = 17
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def make_batches(seed: int, steps: int, rows: int, seq: int) -> List[np.ndarray]:
    """``steps`` batches ``[rows, seq]`` of the periodic stream, drawn as
    the JAX example draws them: first its init batch, then one per step."""
    rng = np.random.RandomState(seed)

    def make_batch(n):
        # periodic stream: token[t] = (phase + t) % 17, mapped into vocab
        phase = rng.randint(0, PERIOD, (n, 1))
        t = np.arange(seq)[None, :]
        return ((phase + t) % PERIOD + 5).astype(np.int32)

    make_batch(rows)  # the JAX example's init batch (the port's init draws no tokens)
    return [make_batch(rows) for _ in range(steps)]


def shard_sequence(tokens: torch.Tensor, sp: int) -> torch.Tensor:
    """``[N, T]`` -> rank-stacked ``[sp, N, T / sp]``: rank r holds
    positions r*T/sp .. of every sequence."""
    n, t = tokens.shape
    return tokens.reshape(n, sp, t // sp).transpose(0, 1).contiguous()


def lm_loss(model: torch.nn.Module, tokens: torch.Tensor, dp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean over the ranks of the per-rank losses, and the losses
    ``[dp, sp]``. ``tokens``: ``[sp, dp * B, t_local]``; rank (i, r) holds
    rows i*B .. of shard r."""
    sp, rows, t = tokens.shape
    # predict token[t+1] from token[<=t]: rank r's last target is rank r+1's
    # first token (the JAX ``shift(offset=-1)``)
    targets = torch.cat([tokens[:, :, 1:], torch.roll(tokens[:, :, :1], -1, 0)], dim=2)
    logp = torch.log_softmax(model(tokens), dim=-1)
    ll = logp.gather(-1, targets[..., None].long())[..., 0]
    # mask the final global position (no target exists for it)
    is_last = torch.zeros((sp, t), dtype=torch.bool, device=tokens.device)
    is_last[-1, -1] = True
    ll = torch.where(is_last[:, None], 0.0, ll)
    b = rows // dp
    per_rank = -ll.reshape(sp, dp, b, t).sum((2, 3)).T / (b * (t - 1))
    return per_rank.mean(), per_rank


def train(model: torch.nn.Module, batches: Sequence[np.ndarray], lr: float, dp: int, sp: int,
          device, on_step: Optional[Callable[[int, torch.Tensor], None]] = None) -> List[torch.Tensor]:
    """One Adam step per batch; returns the step losses (device scalars)."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for step, tokens in enumerate(batches):
        x = shard_sequence(torch.as_tensor(tokens, device=device), sp)
        loss, _ = lm_loss(model, x, dp)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if on_step is not None:
            on_step(step, losses[-1])
    return losses


def engine_run(model: torch.nn.Module, comm, num_seqs: int, seq: int, per_rank: int,
               epochs: int, lr: float, seed: int = 0) -> dict:
    """Train ``model`` (fresh parameters from ``seed``) through the engine
    on ``synthetic_tokens``: ``epochs`` epochs of ``train_resident`` with
    ``per_rank`` sequences a rank, Adam ``lr``, ``rank_map='loop'``.
    Returns the epochs' mean losses, and the tokens/sec/chip and step ms
    of the epochs after the first; and the engine."""
    from torchmpi_tpu_torch.engine import Adam, AllReduceSGDEngine
    from torchmpi_tpu_torch.models import init_lm_params, make_lm_loss_fn
    from torchmpi_tpu_torch.utils import synthetic_tokens

    x, y = synthetic_tokens(num_seqs=num_seqs, seq_len=seq, vocab=model.vocab_size)
    engine = AllReduceSGDEngine(make_lm_loss_fn(model), init_lm_params(model, seed=seed),
                                comm=comm, optimizer=Adam(lr), rank_map="loop")
    state = engine.train_resident(
        x, y, per_rank, max_epochs=epochs, shuffle=False,
        epoch_callback=lambda e, loss, s: print(f"epoch {e}: loss={loss:.4f} ({s:.3f} s)"))
    steps = len(x) // comm.size // per_rank
    timed = state["epoch_times"][1:] or state["epoch_times"]
    tokens = len(timed) * steps * comm.size * per_rank * seq
    return {"losses": state["losses"], "steps": steps * epochs,
            "tokens_per_s": tokens / sum(timed),
            "step_ms": sum(timed) / (len(timed) * steps) * 1e3}, engine


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=None,
                    help="default: 3e-3, or 3e-4 with --engine (bench.py's)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--sp", type=int, default=4)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sp-backend", default="xla", choices=BACKENDS,
                    help="ring-attention backend: the plain ring, the kernels (K8 or, "
                         "with _bidir, K9 forward; with _full the K10 backward), or auto")
    ap.add_argument("--device", default=None, help="default: cuda:0")
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--head-dim", type=int, default=32)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--dtype", default="f32", choices=sorted(DTYPES))
    ap.add_argument("--remat", action="store_true", help="recompute each block in the backward")
    ap.add_argument("--engine", action="store_true",
                    help="train through AllReduceSGDEngine.train_resident (no sp)")
    ap.add_argument("--num-seqs", type=int, default=256, help="--engine: the dataset's size")
    ap.add_argument("--epochs", type=int, default=2, help="--engine: epochs")
    args = ap.parse_args(argv)
    if args.lr is None:
        args.lr = 3e-4 if args.engine else 3e-3

    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch.models import LongContextTransformer, init_lm_params
    from torchmpi_tpu_torch.parallel import make_parallel_mesh
    from torchmpi_tpu_torch.utils.flops import mfu, train_flops, transformer_forward_flops

    # full f32 products, as the JAX run computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    mpi.start(ranks=args.ranks, device=args.device)
    try:
        comm = mpi.current_communicator()
        p, device = comm.size, comm.device
        widths = dict(vocab_size=args.vocab, num_layers=args.layers, num_heads=args.heads,
                      head_dim=args.head_dim, d_model=args.d_model, max_len=args.seq,
                      dtype=DTYPES[args.dtype], remat=args.remat)
        if args.engine:
            print(f"ranks={p} engine, no sp: seq={args.seq} batch={args.batch} a rank "
                  f"dtype={args.dtype} device={device}")
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            run, _ = engine_run(LongContextTransformer(**widths), comm, args.num_seqs, args.seq,
                                args.batch, args.epochs, args.lr, args.seed)
            peak = torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None
            losses = run["losses"]
            print(f"throughput: {run['tokens_per_s']:,.0f} tok/s/chip, {run['step_ms']:.2f} ms "
                  f"a step" + ("" if peak is None else f", peak memory {peak:.2f} GB"))
            print(f"final: loss={losses[-1]:.4f} (first epoch {losses[0]:.4f})")
            if not losses[-1] < losses[0]:
                raise SystemExit(f"long_context: the loss did not fall ({losses[0]:.4f} -> "
                                 f"{losses[-1]:.4f})")
            return {**run, "peak_gb": peak}
        sp = args.sp if p % args.sp == 0 else 1
        mesh = make_parallel_mesh(comm, axes={"dp": p // sp, "sp": sp})
        dp = mesh.size("dp")
        print(f"ranks={p} mesh=dp{dp} x sp{sp} seq={args.seq} device={device} "
              f"sp_backend={args.sp_backend}")
        if args.seq % sp:
            raise ValueError(f"--seq {args.seq} does not split over sp={sp}")
        model = LongContextTransformer(**widths, sp_backend=args.sp_backend).to(device)
        model.load_state_dict(init_lm_params(model, seed=args.seed))
        batches = make_batches(args.seed, args.steps, dp * args.batch, args.seq)

        marks = []

        def on_step(step, loss):
            print(f"step {step}: loss={float(loss):.4f}")
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            marks.append(time.perf_counter())

        t0 = time.perf_counter()
        losses = [float(v) for v in train(model, batches, args.lr, dp, sp, device, on_step)]
        if len(marks) > 1:
            timed, elapsed = len(marks) - 1, marks[-1] - marks[0]
        else:
            timed, elapsed = 1, marks[0] - t0

        flops_per_token = train_flops(transformer_forward_flops(
            args.seq, args.d_model, args.layers, args.heads, args.head_dim, args.vocab,
        )) // args.seq
        tokens_per_sec = timed * dp * args.batch * args.seq / max(elapsed, 1e-9)
        chips = 1  # every virtual rank shares one device
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else None
        achieved, frac = mfu(tokens_per_sec / chips, flops_per_token, name)
        print(
            f"throughput: {tokens_per_sec:,.0f} tok/s ({tokens_per_sec / chips:,.0f}/chip), "
            f"{achieved / 1e12:.3f} TFLOP/s/chip"
            + (f", MFU {frac:.1%} of the f32 peak" if frac is not None
               else " (no peak for this device: MFU n/a)")
        )
        first, final = losses[0], losses[-1]
        print(f"final: loss={final:.4f} (first {first:.4f}; random = {np.log(PERIOD):.4f})")
        if not final < first:
            raise SystemExit(f"long_context: the loss did not fall ({first:.4f} -> {final:.4f})")
        return {"losses": losses, "tokens_per_sec": tokens_per_sec, "mfu": frac}
    finally:
        mpi.stop()


if __name__ == "__main__":
    main()
