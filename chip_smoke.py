#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``torchmpi_tpu_torch``) on one card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc`` (CUDA_HOME, /usr/local/cuda or the PATH), imports
nothing of JAX or of the JAX package, and exits non-zero as soon as any
phase fails:

1. prints the card (``nvidia-smi`` name and power limit) and the
   toolchain;
2. builds every kernel from ``torchmpi_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together);
3. holds each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and over a sweep of dtypes, wires, modes, ranks
   and ragged sizes: every comparison must be exact (the plain versions
   repeat the kernels' arithmetic in the same order and type), and the
   closed form "rank r contributes r" must sum to p(p-1)/2;
4. checks the trainer on a small input against the same trainer on the
   CPU (plain versions), then drives the two main paths, MNIST LeNet at
   p=8 virtual ranks, global batch 336, lr 0.2, two epochs of
   ``synthetic_mnist`` each (the first warms up), with every launch count
   set to 0 just before each path and read just after it:
   - synchronous AllReduce-SGD (one fused ring allreduce per step);
   - asynchronous AllReduce-SGD with the int8 wire (two gradient buckets
     per step: the first through the quantized ring kernel, the second
     on the vendor path), which prints the replicas' spread;
5. holds the async buckets against blocking allreduces of the same
   buckets, bit for bit, step by step, for the 'full' and int8 wires, and
   runs one async 'full' epoch through ``check_with_allreduce``;
6. profiles 5 steps of each main path (``torch.profiler``) and prints one
   ``{"profile": ...}`` line each: device time by kernel and busy share;
7. times each kernel, its plain version and, where there is one, a PyTorch
   call computing the same function with CUDA events at the main paths'
   shapes, on inputs rotated past the L2, and prints one
   ``{"kernels": [...]}`` line;
8. prints last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

import torchmpi_tpu_torch as mpi  # noqa: E402
from torchmpi_tpu_torch import nn as mpinn  # noqa: E402
from torchmpi_tpu_torch import ops  # noqa: E402
from torchmpi_tpu_torch.engine import AllReduceSGDEngine  # noqa: E402
from torchmpi_tpu_torch.models import (  # noqa: E402
    LeNet,
    accuracy,
    init_params,
    make_loss_fn,
)
from torchmpi_tpu_torch.ops import _build  # noqa: E402
from torchmpi_tpu_torch.utils import DistributedIterator, synthetic_mnist  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores (data sheet)
L2_BYTES = 50 * 2**20  # H100 L2 cache
P = 8  # virtual ranks on the main path
BATCH = 336
LR = 0.2
LENET_PARAMS = 857738  # LeNet's fused gradient buffer, per rank
BUCKET0 = 805386  # LeNet's first async gradient bucket, per rank
LARGEST_LEAF = (256, 7 * 7 * 64)  # LeNet dense0.weight, the largest update
WIRES = ("int8", "bf16")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def bits(t: torch.Tensor) -> torch.Tensor:
    """An integer view of ``t`` that compares bit patterns (-0.0 != 0.0)."""
    if t.dtype == torch.bool:
        return t.view(torch.uint8)
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def rand(shape, dtype, gen, dev):
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    if dtype == torch.bool:
        return torch.rand(shape, generator=gen, device=dev) < 0.3
    info = torch.iinfo(dtype)
    lo, hi = max(info.min, -(1 << 20)), min(info.max, 1 << 20)
    return torch.randint(lo, hi + 1, shape, generator=gen, device=dev, dtype=torch.int64).to(dtype)


def time_ms(fn, reps: int = 5, per: int = 20) -> float:
    """Median over ``reps`` of the mean time of ``per`` back-to-back calls,
    with CUDA events. A sleep kernel queued first keeps the card busy while
    the host enqueues, so host launch overhead does not pad the timing."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def phase_device() -> None:
    print(card())
    nvcc = _build.nvcc_path()
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    print(
        f"toolchain: nvcc {nvcc} ({nvcc_version}); torch {torch.__version__}; "
        f"torch CUDA {torch.version.cuda}; python {sys.version.split()[0]}"
    )


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = _build.build_all()
    print(f"build: {len(paths)} libraries in {time.perf_counter() - t0:.1f} s")


def check_quant(dev, gen) -> dict:
    """The quantized ring against its plain version: both wires, both
    modes, p in {2, 3, 8}, ragged sizes, a second segment above
    8 x 896 x 128 elements, and the main paths' shapes (the async bucket
    [8, 805386] and the sync-wire buffer [8, 857738])."""
    err = {}
    for wire in WIRES:
        for n in (BUCKET0, LENET_PARAMS):
            x = torch.randn((P, n), generator=gen, device=dev)
            k, pl = ops.ring_allreduce_quant(x, wire), ops.ring_allreduce_quant_plain(x, wire)
            torch.cuda.synchronize()
            require(torch.equal(bits(k), bits(pl)), f"ring_allreduce_quant {wire} [8, {n}] != plain")
            if n == BUCKET0:
                err[f"ring_allreduce_quant_{wire}"] = float((k - pl).abs().max())
            exact = x.double().sum(0)
            rel = float((k.double() - exact).abs().max() / exact.abs().max())
            require(rel < 2e-2, f"ring_allreduce_quant {wire} [8, {n}] off the sum by {rel}")
        x = torch.randn((P, P * 100674), generator=gen, device=dev)
        k, pl = ops.ring_reduce_scatter_quant(x, wire), ops.ring_reduce_scatter_quant_plain(x, wire)
        torch.cuda.synchronize()
        require(torch.equal(bits(k), bits(pl)), f"ring_reduce_scatter_quant {wire} [8, 805392] != plain")
        err[f"ring_reduce_scatter_quant_{wire}"] = float((k - pl).abs().max())
        for p in (2, 3, 8):
            for n in (1, 1000, 5000, 100003, 8 * 896 * 128 + 4099):
                x = torch.randn((p, n), generator=gen, device=dev)
                require(torch.equal(bits(ops.ring_allreduce_quant(x, wire)),
                                    bits(ops.ring_allreduce_quant_plain(x, wire))),
                        f"ring_allreduce_quant {wire} p={p} n={n} != plain")
                x = torch.randn((p, p, n), generator=gen, device=dev)
                require(torch.equal(bits(ops.ring_reduce_scatter_quant(x, wire)),
                                    bits(ops.ring_reduce_scatter_quant_plain(x, wire))),
                        f"ring_reduce_scatter_quant {wire} p={p} seg={n} != plain")
    # zeros and constant rows: the scale floor and exact codes
    z = torch.zeros((3, 5000), device=dev)
    z[1, 128:256] = 2.5
    for wire in WIRES:
        require(torch.equal(bits(ops.ring_allreduce_quant(z, wire)),
                            bits(ops.ring_allreduce_quant_plain(z, wire))),
                f"ring_allreduce_quant {wire} on zeros != plain")
    return err


def phase_kernels(dev) -> dict:
    """Every kernel against its plain version; returns the main-path
    max |kernel - plain| of each."""
    gen = torch.Generator(device=dev).manual_seed(0)
    err = {}

    # ring allreduce at the main path's shape: distinct random rows
    x = torch.randn((P, LENET_PARAMS), generator=gen, device=dev)
    k, pl = ops.ring_allreduce(x), ops.ring_allreduce_plain(x)
    torch.cuda.synchronize()
    err["ring_allreduce"] = float((k - pl).abs().max())
    require(torch.equal(bits(k), bits(pl)), "ring_allreduce f32 [8, 857738] != plain")
    require(bool((k == k[0:1]).all()), "ring_allreduce rows differ across ranks")
    # the closed form: rank r contributes r
    for dtype in (torch.float32, torch.int32):
        ranks = torch.arange(P, device=dev, dtype=dtype)[:, None].expand(P, LENET_PARAMS)
        out = ops.ring_allreduce(ranks.contiguous())
        require(bool((out == P * (P - 1) // 2).all()), f"closed form p(p-1)/2 fails in {dtype}")
    # every native and carried dtype, ragged sizes, p in {2, 3, 8}
    dtypes = [torch.float32, torch.bfloat16, torch.float16, torch.int32, torch.int8,
              torch.uint8, torch.int16, torch.uint16, torch.bool]
    for p in (2, 3, 8):
        for n in (1, 1000, 8 * 128 * 8 + 3, 100003):
            for dtype in dtypes:
                x = rand((p, n), dtype, gen, dev)
                k, pl = ops.ring_allreduce(x), ops.ring_allreduce_plain(x)
                require(k.dtype == dtype and k.shape == x.shape, f"ring_allreduce shape/dtype {dtype}")
                require(torch.equal(bits(k), bits(pl)), f"ring_allreduce p={p} n={n} {dtype} != plain")
                if not dtype.is_floating_point and dtype != torch.bool:
                    exact = x.to(torch.int64).sum(0).to(dtype)
                    require(torch.equal(k[0], exact), f"ring_allreduce p={p} n={n} {dtype} inexact")
    x = torch.randn((P, 6, 50), generator=gen, device=dev)
    require(torch.equal(ops.ring_allreduce(x), ops.ring_allreduce_plain(x)),
            "ring_allreduce [8, 6, 50] != plain")
    try:
        ops.ring_allreduce(torch.zeros((P, 10), dtype=torch.float64, device=dev))
    except ValueError:
        pass
    else:
        require(False, "ring_allreduce took float64")

    # ring broadcast: main path shape, then roots 0 and 3 over dtypes and
    # ragged byte counts; -0.0 must survive
    x = torch.randn((P, LENET_PARAMS), generator=gen, device=dev)
    k, pl = ops.ring_broadcast(x, 0), ops.ring_broadcast_plain(x, 0)
    torch.cuda.synchronize()
    err["ring_broadcast"] = float((k - pl).abs().max())
    require(torch.equal(bits(k), bits(pl)), "ring_broadcast f32 [8, 857738] != plain")
    for root in (0, 3):
        for n in (1, 1001, 8 * 128 * 8 + 3, 100003):
            for dtype in dtypes + [torch.float64]:
                x = rand((P, n), dtype, gen, dev)
                if dtype.is_floating_point:
                    x[root, 0] = -0.0
                k = ops.ring_broadcast(x, root)
                require(torch.equal(bits(k), bits(ops.ring_broadcast_plain(x, root))),
                        f"ring_broadcast root={root} n={n} {dtype} != plain")
                require(torch.equal(bits(k), bits(x[root:root + 1].expand_as(x))),
                        f"ring_broadcast root={root} n={n} {dtype} lost bytes")

    # accumulate: ragged shape, dtypes, and the main path's largest update
    for dtype in dtypes[:6]:
        a, b = rand((317, 53), dtype, gen, dev), rand((317, 53), dtype, gen, dev)
        require(torch.equal(bits(ops.accumulate(a, b)), bits(ops.accumulate_plain(a, b))),
                f"accumulate (317, 53) {dtype} != plain")
    a = torch.randn((P,) + LARGEST_LEAF, generator=gen, device=dev)
    b = torch.randn((P,) + LARGEST_LEAF, generator=gen, device=dev)
    k, pl = ops.accumulate(a, b), ops.accumulate_plain(a, b)
    torch.cuda.synchronize()
    err["accumulate"] = float((k - pl).abs().max())
    require(torch.equal(bits(k), bits(pl)), "accumulate [8, 256, 3136] != plain")

    err.update(check_quant(dev, gen))
    print(f"kernels: all comparisons exact; main-path max|kernel - plain| = {err}")
    return err


def small_trainer(device, batches, params) -> tuple:
    mpi.start(ranks=4, device=device)
    try:
        model = LeNet()
        eng = AllReduceSGDEngine(make_loss_fn(model), params, lr=LR)
        losses = [float(eng.step(tuple(t.to(device) for t in b))) for b in batches]
        return losses, {k: v.cpu() for k, v in eng.params.items()}
    finally:
        mpi.stop()


def main_path(dev, mode: str, wire: str) -> dict:
    """Drive one main path for two epochs: counts to 0 just before, read
    just after. Returns what the run showed."""
    (xtr, ytr), (xte, yte) = synthetic_mnist()
    model = LeNet()
    step_losses, epoch_t = [], {}

    def on_start_epoch(s):
        torch.cuda.synchronize()
        epoch_t[s["epoch"]] = time.perf_counter()

    def on_end_epoch(s):
        torch.cuda.synchronize()
        epoch_t[s["epoch"]] = time.perf_counter() - epoch_t[s["epoch"]]

    ops.reset_launch_counts()
    mpi.start(ranks=P)
    try:
        comm = mpi.current_communicator()
        engine = AllReduceSGDEngine(
            make_loss_fn(model), init_params(model, seed=0), lr=LR, comm=comm,
            mode=mode, wire_dtype=wire,
            hooks={
                "on_update": lambda s: step_losses.append(s["loss"]),
                "on_start_epoch": on_start_epoch,
                "on_end_epoch": on_end_epoch,
            },
        )
        it = DistributedIterator(xtr, ytr, BATCH, P, device=comm.device)
        state = engine.train(lambda: iter(it), max_epochs=2)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        params = engine.params
        spread = max(float((v - v[0:1]).abs().max()) for v in params.values())
        if wire == "full":
            mpinn.check_with_allreduce(params, comm)
    finally:
        mpi.stop()

    losses = [float(v) for v in step_losses]
    steps = state["t"]
    require(all(abs(v) < float("inf") for v in losses), f"{mode}/{wire}: non-finite loss")
    first, last = losses[0], sum(losses[-3:]) / 3
    require(last < first, f"{mode}/{wire}: loss did not fall: first step {first:.4f}, last three {last:.4f}")
    final = {k: v[0] for k, v in params.items()}
    x_test = torch.as_tensor(xte, device=dev)
    logits = torch.func.functional_call(model, final, (x_test,))
    require(tuple(logits.shape) == (len(xte), 10) and bool(torch.isfinite(logits).all()),
            f"{mode}/{wire}: test logits malformed")
    acc = float(accuracy(logits, torch.as_tensor(yte, device=dev)))
    steady = len(it) * BATCH / epoch_t[1]
    print(
        f"trainer: MNIST LeNet {mode} wire={wire} p={P} batch={BATCH} lr={LR}: {steps} steps, "
        f"loss {first:.4f} -> {last:.4f} (epoch ends {state['losses']}), test_acc={acc:.4f}, "
        f"max replica spread max|params[r] - params[0]| = {spread!r}, launches {counts}"
    )
    print(
        f"samples/sec/chip ({mode}, wire {wire}): {steady:.1f} (second epoch; both epochs "
        f"with warm-up: {state['samples'] / state['time']:.1f}; {P} virtual ranks on 1 card)"
    )
    return {"counts": counts, "steps": steps, "spread": spread, "samples_per_s": steady}


def phase_trainer(dev) -> dict:
    # the CUDA trainer against the same trainer on the CPU, on a small input
    (x, y), _ = synthetic_mnist(num_train=512, num_test=64)
    it = DistributedIterator(x, y, 32, 4, device="cpu")
    batches = [b for _, b in zip(range(3), iter(it))]
    params = init_params(LeNet(), seed=0)
    gl, gp = small_trainer(dev, batches, params)
    cl, cp = small_trainer("cpu", batches, params)
    for a, b in zip(gl, cl):
        require(abs(a - b) <= 1e-4 * abs(b), f"small trainer loss {a} vs CPU {b}")
    for k in cp:
        d = float((gp[k] - cp[k]).abs().max())
        require(d <= 1e-5, f"small trainer {k} differs from CPU by {d}")
    print(f"trainer: 3 steps at p=4 match the CPU plain path (losses {gl})")

    sync = main_path(dev, "sync", "full")
    c, steps = sync["counts"], sync["steps"]
    require(c["ring_allreduce"] == steps,
            f"sync: ring_allreduce launched {c['ring_allreduce']} times in {steps} steps")
    require(c["ring_broadcast"] >= 1, "sync: ring_broadcast never launched")
    require(c["accumulate"] >= steps, "sync: accumulate not launched every step")
    require(not any(v for k, v in c.items() if "quant" in k), "sync: a quantized ring launched")
    print("sync path: check_with_allreduce passed")

    quant = main_path(dev, "async", "int8")
    c, steps = quant["counts"], quant["steps"]
    require(c["ring_allreduce_quant_int8"] == steps,
            f"async int8: quantized ring launched {c['ring_allreduce_quant_int8']} times in {steps} steps")
    require(c["ring_allreduce"] == 0, f"async int8: K3 ring_allreduce launched {c['ring_allreduce']} times")
    require(c["ring_broadcast"] >= 1, "async int8: ring_broadcast never launched")
    require(c["accumulate"] >= steps, "async int8: accumulate not launched every step")
    require(quant["spread"] > 0, "async int8: replicas identical; the wire did not engage")
    return {"sync": sync, "async_int8": quant}


def phase_async(dev) -> None:
    """Each step's async buckets against blocking allreduces of the same
    packed buckets, bit for bit ('full' and int8), then one async 'full'
    epoch through check_with_allreduce."""
    (xtr, ytr), _ = synthetic_mnist()
    model = LeNet()
    for wire in ("full", "int8"):
        mpi.start(ranks=P)
        try:
            comm = mpi.current_communicator()
            engine = AllReduceSGDEngine(make_loss_fn(model), init_params(model, seed=0),
                                        lr=LR, comm=comm, mode="async", wire_dtype=wire)
            buckets = engine.buckets
            it = DistributedIterator(xtr, ytr, BATCH, P, device=comm.device)
            for step, batch in zip(range(6), iter(it)):
                grads, _ = engine._grad_fn(engine.params, batch)
                handles = buckets.allreduce_async(grads, comm, wire_dtype=wire)
                got = [None] * len(handles)
                for b in reversed(range(len(handles))):
                    got[b] = handles[b].wait()
                want = [mpi.allreduce_tensor(buckets.pack(grads, b, P), comm=comm, wire_dtype=wire)
                        for b in range(buckets.num_buckets)]
                for b in range(buckets.num_buckets):
                    require(torch.equal(bits(got[b]), bits(want[b])),
                            f"async {wire}: step {step} bucket {b} differs from the blocking allreduce")
                engine.step(batch)
            if wire == "full":
                state = engine.train(lambda: iter(it), max_epochs=1)
                mpinn.check_with_allreduce(engine.params, comm)
                print(f"async full: {state['t']} more steps, check_with_allreduce passed")
        finally:
            mpi.stop()
    print("async: every step's buckets equal the blocking allreduce bit for bit ('full', int8)")


def phase_profile(mode: str, wire: str) -> None:
    """Where a main-path step's time goes: ``torch.profiler`` over 5 steps
    after 3 warm-up steps, device time by kernel and the share of the
    window the device was busy (the profiler's own host cost lengthens the
    window, so the share is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile

    (xtr, ytr), _ = synthetic_mnist()
    mpi.start(ranks=P)
    try:
        comm = mpi.current_communicator()
        model = LeNet()
        engine = AllReduceSGDEngine(make_loss_fn(model), init_params(model, seed=0),
                                    lr=LR, comm=comm, mode=mode, wire_dtype=wire)
        it = DistributedIterator(xtr, ytr, BATCH, P, device=comm.device)
        batches = [b for _, b in zip(range(8), iter(it))]
        for b in batches[:3]:
            engine.step(b)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in batches[3:]:
                engine.step(b)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        mpi.stop()
    # device-side events only: a host op's "self" device time repeats the
    # time of the kernels it launched, which are listed on their own
    rows = sorted(
        (
            (e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        ),
        reverse=True,
    )
    busy_us = sum(r[0] for r in rows)
    print(json.dumps({"profile": {
        "path": f"{mode}, wire {wire}", "steps": 5, "window_us_per_step": wall_us / 5,
        "device_busy_us_per_step": busy_us / 5,
        "device_busy_share": busy_us / wall_us if rows else None,
        "top_kernels_us_per_step": [
            {"name": k[:80], "us": us / 5, "calls_per_step": n / 5} for us, k, n in rows[:10]
        ],
        "port_kernels_us_per_step": [
            {"name": k[:80], "us": us / 5, "calls_per_step": n / 5}
            for us, k, n in rows if "tmpi::" in k
        ],
    }}))


def bound(nbytes: int, nops: int) -> tuple:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the f32 rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def rotating(fn, make, in_bytes: int):
    """``fn`` over enough copies of its inputs (made by ``make``) that
    together they exceed twice the card's 50 MB L2: back-to-back calls
    cycle through them, so each call reads its inputs from device memory,
    as the main path's calls do."""
    copies = max(2, -(-2 * L2_BYTES // in_bytes))
    sets = itertools.cycle([make() for _ in range(copies)])
    return lambda: fn(*next(sets))


def phase_timing(dev, runs: dict, errs: dict) -> None:
    """Time each kernel, its plain version and one PyTorch call computing
    the same function where there is one, at the main paths' shapes, on
    inputs rotated past the L2 (:func:`rotating`); bound_ms counts each
    input read once and each output written once. ``launches`` is the sum
    over the two main-path runs, split in ``launches_by_path``."""
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    n, hops, seg = LENET_PARAMS, 2 * (P - 1), 100674  # seg: bucket 0's slice per rank
    rows = [
        dict(
            name="ring_allreduce", source="torchmpi_tpu_torch/csrc/ring_kernels.cu",
            replaces="torchmpi_tpu/ops/ring_kernels.py:201",
            shape=[P, n], make=lambda: (randn(P, n),), in_bytes=P * n * 4,
            bytes=2 * P * n * 4, ops=(P - 1) * n,
            kernel=ops.ring_allreduce, plain=ops.ring_allreduce_plain,
            library=lambda x: x.sum(0, keepdim=True).expand_as(x).contiguous(),
        ),
        dict(
            name="ring_broadcast", source="torchmpi_tpu_torch/csrc/ring_kernels.cu",
            replaces="torchmpi_tpu/ops/ring_kernels.py:1282",
            shape=[P, n], make=lambda: (randn(P, n),), in_bytes=P * n * 4,
            bytes=(1 + P) * n * 4, ops=0,
            kernel=lambda x: ops.ring_broadcast(x, 0),
            plain=lambda x: ops.ring_broadcast_plain(x, 0),
            library=lambda x: x[0:1].expand_as(x).clone(),
        ),
        dict(
            name="accumulate", source="torchmpi_tpu_torch/csrc/reduce_kernel.cu",
            replaces="torchmpi_tpu/ops/reduce_kernel.py:28",
            shape=[P, *LARGEST_LEAF], make=lambda: (randn(P, *LARGEST_LEAF), randn(P, *LARGEST_LEAF)),
            in_bytes=2 * P * LARGEST_LEAF[0] * LARGEST_LEAF[1] * 4,
            bytes=3 * P * LARGEST_LEAF[0] * LARGEST_LEAF[1] * 4, ops=P * LARGEST_LEAF[0] * LARGEST_LEAF[1],
            kernel=ops.accumulate, plain=ops.accumulate_plain, library=torch.add,
        ),
    ]
    for wire in WIRES:
        # per element and hop: int8 |v|, max, divide, round, convert, then a
        # multiply and an add (f64 in the reduce-scatter); bf16 a cast and an add
        per_hop = 7 if wire == "int8" else 2
        rows.append(dict(
            name=f"ring_allreduce_quant_{wire}", source="torchmpi_tpu_torch/csrc/ring_quant.cu",
            replaces="torchmpi_tpu/ops/ring_kernels.py:551",
            shape=[P, BUCKET0], make=lambda: (randn(P, BUCKET0),), in_bytes=P * BUCKET0 * 4,
            bytes=2 * P * BUCKET0 * 4, ops=hops * per_hop * BUCKET0,
            kernel=lambda x, w=wire: ops.ring_allreduce_quant(x, w),
            plain=lambda x, w=wire: ops.ring_allreduce_quant_plain(x, w),
            library=None, k3=ops.ring_allreduce,
        ))
        rows.append(dict(
            name=f"ring_reduce_scatter_quant_{wire}", source="torchmpi_tpu_torch/csrc/ring_quant.cu",
            replaces="torchmpi_tpu/ops/ring_kernels.py:551",
            shape=[P, P * seg], make=lambda: (randn(P, P * seg),), in_bytes=P * P * seg * 4,
            bytes=(P + 1) * P * seg * 4, ops=(P - 1) * per_hop * P * seg,
            kernel=lambda x, w=wire: ops.ring_reduce_scatter_quant(x, w),
            plain=lambda x, w=wire: ops.ring_reduce_scatter_quant_plain(x, w),
            library=None,
        ))
    out = []
    for r in rows:

        def timed(fn):
            return time_ms(rotating(fn, r["make"], r["in_bytes"]))

        ms = timed(r["kernel"])
        bound_ms, bound_by = bound(r["bytes"], r["ops"])
        by_path = {path: run["counts"][r["name"]] for path, run in runs.items()}
        row = {
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": errs[r["name"]], "ms": ms, "kernel_ms": ms,
            "plain_ms": timed(r["plain"]),
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes a requantizing ring
            "library_ms": timed(r["library"]) if r["library"] else None,
            "shape": r["shape"], "dtype": "float32",
        }
        if "k3" in r:
            row["k3_f32_ms"] = timed(r["k3"])  # K3's f32 ring at the same shape
        out.append(row)
    print(json.dumps({"kernels": out}))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs one card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # deterministic convolution algorithms: the seeded run then follows one
    # loss trajectory on every call, so "the loss falls" is reproducible
    # (LeNet at lr 0.2 has spikes, and cuDNN's default algorithms moved
    # them from call to call)
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda", 0)
    phase_device()
    phase_build()
    errs = phase_kernels(dev)
    runs = phase_trainer(dev)
    phase_async(dev)
    phase_profile("sync", "full")
    phase_profile("async", "int8")
    phase_timing(dev, runs, errs)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
