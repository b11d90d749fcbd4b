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
   the main paths' shapes and over a sweep of dtypes, wires, modes, ranks,
   roots and ragged sizes: every comparison of a collective kernel must be
   exact (the plain versions repeat the kernels' arithmetic in the same
   order and type), and the closed form "rank r contributes r" must sum to
   p(p-1)/2;
4. checks the trainer on a small input against the same trainer on the
   CPU (plain versions), then drives the two MNIST paths, LeNet at p=8
   virtual ranks, global batch 336, lr 0.2, two epochs of
   ``synthetic_mnist`` each (the first warms up), with every launch count
   set to 0 just before each path and read just after it:
   - synchronous AllReduce-SGD (one fused ring allreduce per step; the
     first weight sync, 3.4 MB per rank, takes the binomial tree);
   - asynchronous AllReduce-SGD with the int8 wire (two gradient buckets
     per step: the first through the quantized ring kernel, the second
     on the vendor path), which prints the replicas' spread;
5. holds the async buckets against blocking allreduces of the same
   buckets, bit for bit, step by step, for the 'full' and int8 wires, and
   runs one async 'full' epoch through ``check_with_allreduce``;
6. drives the collectives benchmark (``utils.tester.run_matrix``, the
   ``bench_collectives`` example's sweep) at p=8: broadcast, reduce,
   allreduce, allgather and reducescatter over the xla, ring and kernel
   backends, sync and async, sizes 2^8..2^23 with the reference's jitter,
   then the kernel backend's allreduce under
   ``ring_implementation='kernel_bidir'``; every config's closed form must
   hold, each op's launch counts (0 just before, read just after) must be
   the calls the sweep routed to each kernel, and each config prints one
   ``{"bench": ...}`` line;
7. drives the long-context LM path (``examples/long_context.py``): a small
   LM on the card against the same LM on the CPU (plain versions), then the
   ``lm`` line's widths (vocab 8192, 8 layers, 8 heads x 64, d_model 512),
   4096 tokens over sp=4 virtual ranks, batch 4, Adam lr 3e-4, causal, f32:
   20 steps with ``kernel_full`` (K8 forward, K10 backward, in every layer)
   with exact launch counts and the loss falling, then 5 steps each with
   ``kernel_bidir_full`` (K9) and ``xla`` (no kernel) from the same init
   and batches, whose losses must match the first 5;
8. drives the parameter-server path (``examples/mnist_parameterserver.py``'s
   twin, ``train`` on LeNet): p=8, global batch 336, lr 0.2, ``--tau 5
   --init-delay 10``, two epochs (48 steps) each of Downpour, EASGD (beta
   0.9) and DSGD with the full wire, and Downpour with the int8 wire; the
   loss must fall, and the launch counts (0 just before each run, read just
   after) must be the K1 and K2 applies the schedule routes
   (:func:`ps_expected`), every other kernel 0; then a short
   LogisticRegression run of each on the card against the CPU (plain
   versions), and ``run_ps_throughput`` at 2^20 elements and at LeNet's
   size, full and int8 wire (``{"ps": ...}`` lines);
9. profiles 5 steps of each MNIST path, 2 LM steps and 5 Downpour steps
   (``torch.profiler``) and prints one ``{"profile": ...}`` line each:
   device time by kernel and busy share (the LM's with the step time,
   tokens/sec/chip and MFU of 7.'s ``kernel_full`` run); times Downpour
   steps with the PS
   server's 100 us polling cadence and with none (``{"ps_poll": ...}``);
10. times each kernel, its plain version and, where there is one, a
   PyTorch call computing the same function with CUDA events at the main
   paths' shapes, on inputs rotated past the L2, and prints one
   ``{"kernels": [...]}`` line: each row's bound is the larger of its bytes
   over 3.35 TB/s and its operations over 67 TFLOP/s (f32), or for the
   attention rows over 165 TFLOP/s (f32 as 3xTF32 on the tensor cores,
   with the f32 bound beside it), and no kernel may read under its bound;
11. prints last ``{"ok": true, "device": {...}}``.

Kernels are held to their plain versions bit for bit, but for the ring
attention kernels (K8, K9, K10), which merge 64-key tiles where the plain
versions merge whole blocks (and K10 multiplies on the tensor cores, as
3xTF32 for f32 inputs): those agree within the tolerances of ``ATTN_TOL``
(f32) and ``BF16_REL`` (bf16).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import re
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

import torchmpi_tpu_torch as mpi  # noqa: E402
from torchmpi_tpu_torch import constants  # noqa: E402
from torchmpi_tpu_torch import nn as mpinn  # noqa: E402
from torchmpi_tpu_torch import ops  # noqa: E402
from torchmpi_tpu_torch.collectives import primitives  # noqa: E402
from torchmpi_tpu_torch.engine import AllReduceSGDEngine  # noqa: E402
from torchmpi_tpu_torch.examples import long_context  # noqa: E402
from torchmpi_tpu_torch.examples import mnist_parameterserver as ps_example  # noqa: E402
from torchmpi_tpu_torch.models import (  # noqa: E402
    LeNet,
    LogisticRegression,
    LongContextTransformer,
    accuracy,
    init_lm_params,
    init_params,
    make_loss_fn,
)
from torchmpi_tpu_torch.ops import _build  # noqa: E402
from torchmpi_tpu_torch.ops.ring_kernels import bidir_chunk_elems  # noqa: E402
from torchmpi_tpu_torch.parallel import ring_self_attention  # noqa: E402
from torchmpi_tpu_torch.parameterserver import server as ps_server  # noqa: E402
from torchmpi_tpu_torch.utils import DistributedIterator, synthetic_mnist  # noqa: E402
from torchmpi_tpu_torch.utils.flops import mfu, train_flops, transformer_forward_flops  # noqa: E402
from torchmpi_tpu_torch.utils.tester import run_matrix, run_ps_throughput, sweep_sizes  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores (data sheet)
# the f32 rate on the tensor cores as 3xTF32: three TF32 MMAs (495 TFLOP/s
# dense, data sheet) per f32 product
F32_3XTF32_OPS_PER_S = 495e12 / 3
L2_BYTES = 50 * 2**20  # H100 L2 cache
P = 8  # virtual ranks on the main path
BATCH = 336
LR = 0.2
LENET_PARAMS = 857738  # LeNet's fused gradient buffer, per rank
BUCKET0 = 805386  # LeNet's first async gradient bucket, per rank
LARGEST_LEAF = (256, 7 * 7 * 64)  # LeNet dense0.weight, the largest update
WIRES = ("int8", "bf16")
SWEEP = sweep_sizes(8, 23)  # the collectives benchmark's sizes, per rank
BENCH_OPS = ("broadcast", "reduce", "allreduce", "allgather", "reducescatter")
# run_one_config's calls in benchmark mode: the checked one, 10 warm-up, one
# synchronised, 10 timed
BENCH_CALLS = 22
N23, N20 = 1 << 23, 1 << 20  # the kernels line's shapes per rank
# the LM path: the bench's lm line widths, 4096 tokens over sp=4, batch 4
LM_WIDTHS = dict(vocab_size=8192, num_layers=8, num_heads=8, head_dim=64, d_model=512,
                 max_len=4096)
LM_SEQ, LM_SP, LM_BATCH, LM_LR, LM_STEPS, LM_CHECK_STEPS = 4096, 4, 4, 3e-4, 20, 5
ATTN_MAIN = (LM_SP, LM_BATCH, LM_SEQ // LM_SP, 8, 64)  # its [sp, b, n_local, h, d]
# kernel against plain, (atol, rtol). f32: as tests/test_ops.py holds the
# JAX kernels, outputs atol 2e-5, the backward and K9 against K8 2e-4; lse
# (f32 for every input dtype) 1e-4. bf16: both sides round an f32 result
# to bf16, so they differ by at most one bf16 ulp (2^-7 of the value) and
# the f32 sums' rounding: rtol 2^-7, atol 2^-7 of the largest |plain|, a
# limit that scales with the values compared
ATTN_TOL = {"o": (2e-5, 0.0), "lse": (1e-4, 0.0), "grad": (2e-4, 2e-4), "k9_vs_k8": (2e-4, 2e-4)}
BF16_REL = 2.0**-7
# the parameter-server path: the JAX example's CLI at LeNet's full width
PS_ARGS = ["--batch", str(BATCH), "--lr", str(LR), "--epochs", "2", "--train", "8192",
           "--tau", "5", "--init-delay", "10", "--beta", "0.9", "--seed", "0"]
PS_TAU, PS_DELAY = 5, 10
PS_STEPS = 2 * (8192 // P // (BATCH // P))  # two epochs of 24 steps
PS_VARIANTS = (("downpour", "full"), ("easgd", "full"), ("dsgd", "full"), ("downpour", "int8"))
LENET_LEAVES = 8
SHARD = LARGEST_LEAF[0] * LARGEST_LEAF[1] // P  # one server's shard of dense0.weight
SCALE_ALPHAS = (0.0, 1.0, -1.0, 0.1, -0.2 / 8)
# the card against the CPU on the PS path: a short LogisticRegression run
# (lr 0.02, where a rounding difference does not grow chaotically), held
# as tests/test_torch_ps.py holds the port to the JAX package
PS_SMALL = ["--train", "1024", "--epochs", "1", "--batch", "32", "--lr", "0.02", "--tau", "5",
            "--init-delay", "10", "--seed", "0"]


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


def ptxas_report(log: str, part: str) -> dict:
    """Registers and spill bytes of each kernel whose name holds ``part``,
    from ``nvcc -Xptxas -v`` output, by ``name<D, dtype>``."""
    report, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            m = re.search(r"attn\d+(\w+_kernel)ILi(\d+)E(\w)", entry.group(1))
            name = (f"{m.group(1)}<{m.group(2)}, {'float' if m.group(3) == 'f' else 'bf16'}>"
                    if m and part in m.group(1) else None)
            continue
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            report.setdefault(name, {}).update(spill_stores=int(spill.group(1)),
                                               spill_loads=int(spill.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            report.setdefault(name, {})["registers"] = int(regs.group(1))
    return report


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = _build.build_all()
    print(f"build: {len(paths)} libraries in {time.perf_counter() - t0:.1f} s")
    # K10's registers and spills at every head dim and dtype (sm_90a)
    log = _build.build_log("ring_attention")
    if log.exists():
        print(json.dumps({"ptxas": ptxas_report(log.read_text(), "_mma_kernel")}))


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


def check_scale(dev, gen) -> dict:
    """K2 (``scale_accumulate``) and K1's in-place path against their plain
    versions, bit for bit: f32, f64, bf16 and f16; alpha in
    :data:`SCALE_ALPHAS`; sizes 1 to 2^23 + 5; both operands aligned, both
    at element offset 1, and at offsets 3 and 1 (misaligned vectors, as a
    shard view is); out of place and in place (``out_`` the first input, as
    the 'add' rule applies); then the main path's largest leaf."""
    err = {}

    def same(k, pl, what):
        torch.cuda.synchronize()
        require(k.dtype == pl.dtype and k.shape == pl.shape, f"{what}: shape/dtype")
        require(torch.equal(bits(k), bits(pl)), f"{what} != plain")

    for dtype in (torch.float32, torch.float64, torch.bfloat16, torch.float16):
        for n in (1, 7, 1000, 100003, (1 << 23) + 5):
            a_base, b_base = rand((n + 3,), dtype, gen, dev), rand((n + 3,), dtype, gen, dev)
            for oa, ob in ((0, 0), (1, 1), (3, 1)):
                a, b = a_base[oa:oa + n], b_base[ob:ob + n]
                what = f"n={n} {dtype} offsets ({oa}, {ob})"
                for alpha in SCALE_ALPHAS:
                    pl = ops.scale_accumulate_plain(a, b, alpha)
                    same(ops.scale_accumulate(a, b, alpha), pl, f"scale_accumulate alpha={alpha} {what}")
                    dst = a_base.clone()[oa:oa + n]
                    ops.scale_accumulate(dst, b, alpha, out_=dst)
                    same(dst, pl, f"scale_accumulate in place alpha={alpha} {what}")
                if dtype != torch.float64:
                    dst = a_base.clone()[oa:oa + n]
                    ops.accumulate(dst, b, out_=dst)
                    same(dst, ops.accumulate_plain(a, b), f"accumulate in place {what}")
    a = torch.randn((P,) + LARGEST_LEAF, generator=gen, device=dev)
    b = torch.randn((P,) + LARGEST_LEAF, generator=gen, device=dev)
    k, pl = ops.scale_accumulate(a, b, -LR), ops.scale_accumulate_plain(a, b, -LR)
    same(k, pl, "scale_accumulate [8, 256, 3136]")
    err["scale_accumulate"] = float((k - pl).abs().max())
    # what the kernel does not take raises on the card (no plain fallback)
    try:
        ops.scale_accumulate(torch.ones(8, device=dev, dtype=torch.int32), torch.ones(8, device=dev), 2.0)
    except ValueError:
        pass
    else:
        require(False, "scale_accumulate took int32")
    print("scale_accumulate: bit for bit equal to its plain version over f32, f64, bf16, f16, "
          f"alpha {SCALE_ALPHAS}, sizes 1..2^23+5, aligned and misaligned views, in place")
    return err


def check_phases(dev, gen) -> dict:
    """The reduce-scatter, allgather, reduce and bidirectional kernels
    against their plain versions: p in {2, 3, 8}, ragged sizes, f32, bf16
    and i32 (and bool and f64 for the allgather, with -0.0), every root of
    the reduce, the bidirectional ring at odd n, at p=2 (run by K3) and
    above one segment of its layout, then the kernels line's shapes and
    the sweep's largest size at p=8."""
    err = {}

    def same(k, pl, what):
        torch.cuda.synchronize()
        require(k.dtype == pl.dtype and k.shape == pl.shape, f"{what}: shape/dtype")
        require(torch.equal(bits(k), bits(pl)), f"{what} != plain")

    dtypes = (torch.float32, torch.bfloat16, torch.int32)
    for p in (2, 3, 8):
        for n in (1, 1001, 8 * 128 * 8 + 3, 100003):
            for dtype in dtypes:
                x = rand((p, p * n), dtype, gen, dev)
                same(ops.ring_reduce_scatter(x), ops.ring_reduce_scatter_plain(x),
                     f"ring_reduce_scatter p={p} seg={n} {dtype}")
                x = rand((p, n), dtype, gen, dev)
                for root in range(p):
                    same(ops.ring_reduce(x, root), ops.ring_reduce_plain(x, root),
                         f"ring_reduce p={p} n={n} root={root} {dtype}")
                same(ops.ring_allreduce_bidir(x), ops.ring_allreduce_bidir_plain(x),
                     f"ring_allreduce_bidir p={p} n={n} {dtype}")
            for dtype in dtypes + (torch.bool, torch.float64):
                x = rand((p, n), dtype, gen, dev)
                if dtype.is_floating_point:
                    x[:, 0] = -0.0
                k = ops.ring_allgather(x)
                same(k, ops.ring_allgather_plain(x), f"ring_allgather p={p} n={n} {dtype}")
                require(torch.equal(bits(k), bits(x.expand((p,) + tuple(x.shape)))),
                        f"ring_allgather p={p} n={n} {dtype} lost bytes")
    # the closed form: segment s of the reduce-scatter is p(p-1)/2
    ranks = torch.arange(P, device=dev, dtype=torch.int32)[:, None].expand(P, P * 1000)
    require(bool((ops.ring_reduce_scatter(ranks.contiguous()) == P * (P - 1) // 2).all()),
            "ring_reduce_scatter closed form")
    # p == 2 runs the unidirectional kernel, as the JAX wrapper delegates
    before = ops.launch_counts()
    x = rand((2, 1001), torch.float32, gen, dev)
    same(ops.ring_allreduce_bidir(x), ops.ring_allreduce_plain(x), "ring_allreduce_bidir p=2")
    after = ops.launch_counts()
    require(after["ring_allreduce"] == before["ring_allreduce"] + 1
            and after["ring_allreduce_bidir"] == before["ring_allreduce_bidir"],
            "ring_allreduce_bidir p=2 did not run K3")
    # three segments of the bidirectional layout per half, and odd
    c = bidir_chunk_elems(3 * P * 57344, P, torch.float32)
    n = 2 * 3 * P * c - 7
    require(-(-n // 2) > 2 * P * c, "bidir input below three segments")
    x = rand((P, n), torch.float32, gen, dev)
    same(ops.ring_allreduce_bidir(x), ops.ring_allreduce_bidir_plain(x),
         f"ring_allreduce_bidir p=8 n={n}")
    # the kernels line's shapes (their max |kernel - plain|) and the
    # sweep's largest size per rank
    rs_n = -(-SWEEP[-1] // P) * P
    for n, rs, ag in ((N23, N23, N20), (SWEEP[-1], rs_n, SWEEP[-1])):
        x = rand((P, rs), torch.float32, gen, dev)
        k, pl = ops.ring_reduce_scatter(x), ops.ring_reduce_scatter_plain(x)
        same(k, pl, f"ring_reduce_scatter [8, {rs}]")
        err.setdefault("ring_reduce_scatter", float((k - pl).abs().max()))
        x = rand((P, ag), torch.float32, gen, dev)
        k, pl = ops.ring_allgather(x), ops.ring_allgather_plain(x)
        same(k, pl, f"ring_allgather [8, {ag}]")
        err.setdefault("ring_allgather", float((k - pl).abs().max()))
        del k, pl
        x = rand((P, n), torch.float32, gen, dev)
        for root in (0, 5):
            k, pl = ops.ring_reduce(x, root), ops.ring_reduce_plain(x, root)
            same(k, pl, f"ring_reduce [8, {n}] root={root}")
            err.setdefault("ring_reduce", float((k - pl).abs().max()))
        k, pl = ops.ring_allreduce_bidir(x), ops.ring_allreduce_bidir_plain(x)
        same(k, pl, f"ring_allreduce_bidir [8, {n}]")
        err.setdefault("ring_allreduce_bidir", float((k - pl).abs().max()))
    return err


def check_attention(dev, gen) -> dict:
    """K8, K9 and K10 against their plain versions on the card, within
    :data:`ATTN_TOL` (f32) and :data:`BF16_REL` (bf16) (the kernels merge
    64-key tiles, the plain versions whole blocks, so they agree to
    rounding): p in {2, 3, 4, 8},
    causal and not, f32 and bf16, d in {32, 64}, at a ragged n_local of
    1000 (b 1, h 2); d in {8, 16, 128} at p=3, n_local 200; then the LM
    path's shape [4, 4, 1024, 8, 64], f32, causal. Returns the main
    shape's max |kernel - plain| of each."""
    err = {}

    def close(got, want, key, what):
        """``got`` within the limits of ``key`` (:data:`ATTN_TOL`; bf16
        scaled to ``want``) of ``want``; and a zeroed ``got`` would not be."""
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == want.dtype, f"{what}: shape/dtype")
        ref = want.float().abs()
        atol, rtol = (ATTN_TOL[key] if got.dtype == torch.float32
                      else (BF16_REL * float(ref.max()), BF16_REL))
        limit = atol + rtol * ref
        diff = (got.float() - want.float()).abs()
        require(bool(torch.isfinite(got.float()).all()) and bool((diff <= limit).all()),
                f"{what}: max |kernel - plain| {float(diff.max())} beyond atol {atol}, rtol {rtol}")
        require(bool((ref > limit).any()), f"{what}: the limit would pass zeros")
        return float(diff.max())

    def run(shape, dtype, causal, what):
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(4))
        o, lse = ops.ring_attention_fwd(q, k, v, causal)
        o_pl, lse_pl = ops.ring_attention_fwd_plain(q, k, v, causal)
        e8 = close(o, o_pl, "o", f"K8 o {what}")
        close(lse, lse_pl, "lse", f"K8 lse {what}")
        ob, lseb = ops.ring_attention_fwd(q, k, v, causal, bidir=True)
        ob_pl, lseb_pl = ops.ring_attention_fwd_plain(q, k, v, causal, bidir=True)
        e9 = close(ob, ob_pl, "o", f"K9 o {what}")
        close(lseb, lseb_pl, "lse", f"K9 lse {what}")
        close(ob, o, "k9_vs_k8", f"K9 against K8 {what}")
        # the backward from the same (o, lse) for both
        g = ops.ring_attention_bwd(q, k, v, o_pl, lse_pl, do, causal)
        g_pl = ops.ring_attention_bwd_plain(q, k, v, o_pl, lse_pl, do, causal)
        e10 = max(close(a, b, "grad", f"K10 d{n} {what}") for a, b, n in zip(g, g_pl, "qkv"))
        return {"ring_attention_fwd": e8, "ring_attention_fwd_bidir": e9, "ring_attention_bwd": e10}

    for p, causal, dtype, d in itertools.product(
            (2, 3, 4, 8), (False, True), (torch.float32, torch.bfloat16), (32, 64)):
        run((p, 1, 1000, 2, d), dtype, causal, f"p={p} causal={causal} {dtype} d={d} n_local=1000")
    # the other head dims the kernels take, at a small ragged shape
    for causal, dtype, d in itertools.product(
            (False, True), (torch.float32, torch.bfloat16), (8, 16, 128)):
        run((3, 2, 200, 3, d), dtype, causal, f"p=3 causal={causal} {dtype} d={d} n_local=200")
    err.update(run(ATTN_MAIN, torch.float32, True, f"{list(ATTN_MAIN)} f32 causal"))
    # what the kernels do not take raises on the card (no plain fallback),
    # under the 'auto' backend too
    for x in (torch.zeros(ATTN_MAIN, device=dev, dtype=torch.float16),
              torch.zeros(ATTN_MAIN[:4] + (24,), device=dev)):
        for name, call in (("ring_attention_fwd", ops.ring_attention_fwd),
                           ("auto", partial(ring_self_attention, backend="auto"))):
            try:
                call(x, x, x)
            except ValueError:
                continue
            require(False, f"{name} took {x.dtype}, head_dim {x.shape[-1]}")
    print(f"attention: K8, K9, K10 within (atol, rtol) {ATTN_TOL} (f32) and rtol 2^-7, atol "
          f"2^-7 max|plain| (bf16) of their plain versions; main-shape max|kernel - plain| = {err}")
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

    err.update(check_scale(dev, gen))
    err.update(check_quant(dev, gen))
    err.update(check_phases(dev, gen))
    print(f"kernels: all collective comparisons exact; main-path max|kernel - plain| = {err}")
    err.update(check_attention(dev, gen))
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
        with counting(primitives, "tree_broadcast") as tree:
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
    return {"counts": counts, "steps": steps, "spread": spread, "samples_per_s": steady,
            "tree_broadcasts": len(tree)}


@contextlib.contextmanager
def counting(module, name: str):
    """Count the calls of ``module.name`` inside the block (a list with one
    entry per call)."""
    calls = []
    real = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, real)


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
    # the first weight sync, 3.4 MB per rank, is at most
    # broadcast_size_tree_based_cuda (4 MiB): the binomial tree, not K7
    require(sync["tree_broadcasts"] >= 1 and c["ring_broadcast"] == 0,
            f"sync: weight broadcast took {sync['tree_broadcasts']} trees, "
            f"{c['ring_broadcast']} K7 launches")
    require(c["accumulate"] >= steps, "sync: accumulate not launched every step")
    require(not any(v for k, v in c.items() if "quant" in k), "sync: a quantized ring launched")
    print("sync path: check_with_allreduce passed")

    quant = main_path(dev, "async", "int8")
    c, steps = quant["counts"], quant["steps"]
    require(c["ring_allreduce_quant_int8"] == steps,
            f"async int8: quantized ring launched {c['ring_allreduce_quant_int8']} times in {steps} steps")
    require(c["ring_allreduce"] == 0, f"async int8: K3 ring_allreduce launched {c['ring_allreduce']} times")
    require(quant["tree_broadcasts"] >= 1 and c["ring_broadcast"] == 0,
            f"async int8: weight broadcast took {quant['tree_broadcasts']} trees, "
            f"{c['ring_broadcast']} K7 launches")
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


def lm_run(dev, widths: dict, seq: int, batch: int, lr: float, steps: int, backend: str) -> dict:
    """Train a fresh LM (seed 0) for ``steps`` steps of the example's step
    over ``LM_SP`` sequence shards: every launch count set to 0 just before
    and read just after. Tokens/sec/chip over the steps after the first."""
    model = LongContextTransformer(**widths, sp_backend=backend).to(dev)
    model.load_state_dict(init_lm_params(model, seed=0))
    batches = long_context.make_batches(0, steps, batch, seq)
    marks = []

    def on_step(step, loss):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        marks.append(time.perf_counter())

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses = long_context.train(model, batches, lr, 1, LM_SP, dev, on_step)
    counts = ops.launch_counts()
    losses = [float(v) for v in losses]
    require(all(abs(v) < float("inf") for v in losses), f"LM {backend}: non-finite loss {losses}")
    run = {"losses": losses, "counts": counts,
           "tokens_per_s": (len(marks) - 1) * batch * seq / (marks[-1] - marks[0]),
           "step_ms": (marks[-1] - marks[0]) / (len(marks) - 1) * 1e3,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None}
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return run


def phase_lm(dev) -> tuple:
    """The long-context LM path: a small LM against the CPU, then the
    full-width path through ``kernel_full``, ``kernel_bidir_full`` and
    ``xla`` (see the module docstring). Returns each run's launch counts,
    and the ``kernel_full`` run's step time, tokens/sec/chip and MFU."""
    layers = LM_WIDTHS["num_layers"]
    small = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=16, d_model=32, max_len=64)
    card = lm_run(dev, small, 64, 2, 3e-3, 3, "kernel_full")
    cpu = lm_run(torch.device("cpu"), small, 64, 2, 3e-3, 3, "kernel_full")
    for a, b in zip(card["losses"], cpu["losses"]):
        require(abs(a - b) <= 1e-4 * abs(b), f"small LM loss {a} vs CPU {b}")
    require(card["counts"]["ring_attention_fwd"] == 2 * 3, "small LM: K8 not launched")
    print(f"lm: 3 small steps on the card match the CPU plain path (losses {card['losses']})")

    def expect(counts, what, **launched):
        want = {name: 0 for name in counts}
        want.update(launched)
        require(counts == want, f"LM {what}: launches {counts} != {want}")

    full = lm_run(dev, LM_WIDTHS, LM_SEQ, LM_BATCH, LM_LR, LM_STEPS, "kernel_full")
    losses = full["losses"]
    expect(full["counts"], "kernel_full", ring_attention_fwd=layers * LM_STEPS,
           ring_attention_bwd=2 * layers * LM_STEPS)
    last = sum(losses[-3:]) / 3
    require(last < losses[0], f"LM: loss did not fall: {losses[0]:.4f} -> {last:.4f}")
    flops_per_token = train_flops(transformer_forward_flops(
        LM_SEQ, LM_WIDTHS["d_model"], layers, LM_WIDTHS["num_heads"], LM_WIDTHS["head_dim"],
        LM_WIDTHS["vocab_size"])) // LM_SEQ
    achieved, frac = mfu(full["tokens_per_s"], flops_per_token, torch.cuda.get_device_name(0))
    print(
        f"lm: {LM_WIDTHS}, seq {LM_SEQ} over sp={LM_SP}, batch {LM_BATCH}, lr {LM_LR}, "
        f"kernel_full: {LM_STEPS} steps, loss {losses[0]:.4f} -> {last:.4f} (last three; "
        f"losses {[round(v, 4) for v in losses]}), launches {full['counts']}, "
        f"peak memory {full['peak_gb']:.2f} GB"
    )
    print(f"tokens/sec/chip (LM, kernel_full): {full['tokens_per_s']:.1f} "
          f"({full['step_ms']:.2f} ms per step after the first; {achieved / 1e12:.3f} TFLOP/s, "
          f"MFU {frac:.2%} of the f32 peak by the analytic count)")
    runs = {"lm_kernel_full": full["counts"]}
    stats = {"step_ms": full["step_ms"], "tokens_per_s_per_chip": full["tokens_per_s"],
             "tflops": achieved / 1e12, "mfu_f32": frac}
    for backend, launched in (
        ("kernel_bidir_full", dict(ring_attention_fwd_bidir=layers * LM_CHECK_STEPS,
                                   ring_attention_bwd=2 * layers * LM_CHECK_STEPS)),
        ("xla", {}),
    ):
        run = lm_run(dev, LM_WIDTHS, LM_SEQ, LM_BATCH, LM_LR, LM_CHECK_STEPS, backend)
        expect(run["counts"], backend, **launched)
        for a, b in zip(run["losses"], losses):
            require(abs(a - b) <= 1e-3 * abs(b), f"LM {backend}: loss {a} vs kernel_full {b}")
        print(f"lm: {backend} {LM_CHECK_STEPS} steps match kernel_full's (losses {run['losses']}); "
              f"tokens/sec/chip {run['tokens_per_s']:.1f}, peak memory {run['peak_gb']:.2f} GB")
        runs[f"lm_{backend}"] = run["counts"]
    return runs, stats


def ps_expected(variant: str, steps: int) -> tuple:
    """The K1 and K2 launches one PS run of ``steps`` steps routes, by the
    schedule, with L = 8 LeNet leaves and S = P shards per leaf: every
    step's local update is one K2 per leaf; an 'add' send of one leaf is
    one apply per shard, through K1 (no scale travels: Downpour scales on
    the client); Downpour accumulates the gradients with K1 from the second
    step on and sends every step from init_delay + 1; EASGD folds (one K2
    per leaf) and sends its elastic differences at each integration,
    init_delay + k * tau; DSGD sends every step ('zero' applies launch
    nothing) and re-applies the averaged gradient with two K2 per leaf.
    Returns the counts and the formula."""
    L, S = LENET_LEAVES, P
    if variant == "downpour":
        sends = len(range(PS_DELAY + 1, steps))
        k1 = L * (steps - 1) + L * S * sends
        k2 = L * steps
        formula = (f"K1 = L*(steps-1) + L*S*sends = {L}*{steps - 1} + {L}*{S}*{sends} = {k1}; "
                   f"K2 = L*steps = {k2}")
    elif variant == "easgd":
        folds = len(range(PS_DELAY + PS_TAU, steps, PS_TAU))
        k1 = L * S * folds
        k2 = L * steps + L * folds
        formula = (f"K1 = L*S*integrations = {L}*{S}*{folds} = {k1}; "
                   f"K2 = L*steps + L*integrations = {L}*{steps} + {L}*{folds} = {k2}")
    else:
        k1 = L * S * steps
        k2 = 3 * L * steps
        formula = f"K1 = L*S*steps = {L}*{S}*{steps} = {k1}; K2 = 3*L*steps = {k2}"
    return {"accumulate": k1, "scale_accumulate": k2}, formula


def ps_run(model, argv, device=None, **kw) -> dict:
    """One run of the PS example's training loop on ``model`` at p=8, with
    every launch count set to 0 just before it and read just after."""
    args = ps_example.parse_args(argv)
    mpi.start(ranks=P, device=device)
    try:
        ops.reset_launch_counts()
        res = ps_example.train(model, args, **kw)
        if mpi.current_communicator().device.type == "cuda":
            torch.cuda.synchronize()
        res["counts"] = ops.launch_counts()
    finally:
        mpi.stop()
    return res


def phase_ps(dev) -> dict:
    """The parameter-server path at full width (see the module docstring);
    returns each run's launch counts."""
    runs = {}
    for variant, wire in PS_VARIANTS:
        path = f"ps_{variant}" + ("" if wire == "full" else f"_{wire}")
        res = ps_run(LeNet(), PS_ARGS + ["--variant", variant, "--wire-dtype", wire])
        steps, counts, losses = res["steps"], res["counts"], res["step_losses"]
        require(steps == PS_STEPS, f"{path}: {steps} steps, not {PS_STEPS}")
        want = {name: 0 for name in counts}
        launched, formula = ps_expected(variant, steps)
        want.update(launched)
        require(counts == want, f"{path}: launches {counts} != {want} ({formula})")
        require(all(abs(v) < float("inf") for v in losses), f"{path}: non-finite loss")
        first, last = losses[0], sum(losses[-3:]) / 3
        require(last < first, f"{path}: loss did not fall: {first:.4f} -> {last:.4f}")
        params = res["params"]
        require(all(bool(torch.isfinite(v).all()) for v in params.values()),
                f"{path}: non-finite parameters")
        sps = res["samples_per_epoch"] / res["seconds"][1]
        print(f"ps: {path} LeNet p={P} batch={BATCH} lr={LR} tau={PS_TAU} init_delay={PS_DELAY}: "
              f"{steps} steps, loss {first:.4f} -> {last:.4f} (epoch ends {res['losses']}), "
              f"test_acc={res['acc']:.4f}, replica spread {res['spread']!r}; "
              f"launches {launched} = the schedule's {formula}")
        print(f"samples/sec/chip (PS {variant}, wire {wire}): {sps:.1f} (second epoch; "
              f"{res['seconds'][1] / (steps // 2) * 1e3:.3f} ms per step; {P} virtual ranks on 1 card)")
        runs[path] = counts
    return runs


def phase_ps_vs_cpu(dev) -> None:
    """Each PS variant on the card against the same run on the CPU (plain
    versions): a LogisticRegression run of 32 steps (:data:`PS_SMALL`) from
    the same init and batches, with ps_prefetch off on both (the exact
    fetch-at-integration semantics), within the CPU tests' tolerances:
    every step's loss rtol 1e-4 and the parameters atol 1e-5; with the int8
    wire a gradient's rounding can move a value across a quantization step,
    so rtol and atol 2e-3."""
    constants.set("ps_prefetch", False)
    try:
        for variant, wire in PS_VARIANTS:
            argv = PS_SMALL + ["--variant", variant, "--wire-dtype", wire]
            params0 = init_params(LogisticRegression(), seed=0)
            card = ps_run(LogisticRegression(), argv, params0=params0)
            cpu = ps_run(LogisticRegression(), argv, device="cpu", params0=params0)
            rtol, atol = (1e-4, 1e-5) if wire == "full" else (2e-3, 2e-3)
            for a, b in zip(card["step_losses"], cpu["step_losses"]):
                require(abs(a - b) <= rtol * abs(b), f"PS {variant}/{wire}: card loss {a} vs CPU {b}")
            for k, v in cpu["params"].items():
                d = float((card["params"][k].cpu() - v).abs().max())
                require(d <= atol, f"PS {variant}/{wire}: {k} differs from the CPU by {d}")
            print(f"ps: {variant}/{wire} on the card matches the CPU plain path over "
                  f"{card['steps']} steps (last loss {card['step_losses'][-1]:.6f})")
    finally:
        constants.set("ps_prefetch", True)


def phase_ps_throughput() -> None:
    """Center traffic through the PS, send ('add') and receive MB/s, at
    2^20 elements and at LeNet's size, with the full and the int8 wire
    (whose per-shard round trips run on the client and pool threads), one
    ``{"ps": ...}`` line each."""
    mpi.start(ranks=P)
    try:
        comm = mpi.current_communicator()
        for wire in ("full", "int8"):
            constants.set("parameterserver_wire_dtype", wire)
            for n in (1 << 20, LENET_PARAMS):
                r = run_ps_throughput(comm, nelem=n)
                print(json.dumps({"ps": {"nelem": n, "ranks": P, "wire": wire, **r}}))
    finally:
        constants.set("parameterserver_wire_dtype", "full")
        mpi.stop()


def phase_profile_ps() -> None:
    """Where a Downpour step's time goes (LeNet, full width): 5 steps
    profiled once the PS is engaged (steps 15-19, one integration among
    them), and the median step time of steps 12-23 with the server's 100 us
    polling cadence and with none, in turns (100, 0, 0, 100 us): the share
    of a step the cadence costs (``{"ps_poll": ...}``)."""
    from torch.profiler import ProfilerActivity, profile

    argv = PS_ARGS + ["--epochs", "1", "--variant", "downpour"]  # the last --epochs wins
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks = {}

    def on_step(t):
        torch.cuda.synchronize()
        marks[t] = time.perf_counter()
        if t == 14:
            prof.start()
        elif t == 19:
            prof.stop()

    ps_run(LeNet(), argv, on_step=on_step)
    print_profile(prof, (marks[19] - marks[14]) * 1e6, 5, "PS downpour, LeNet, full width")

    def step_ms(poll_s: float) -> float:
        ps_server._POLL_INTERVAL_S = poll_s
        stamps = []
        try:
            ps_run(LeNet(), argv, on_step=lambda t: (torch.cuda.synchronize(),
                                                      stamps.append(time.perf_counter())))
        finally:
            ps_server._POLL_INTERVAL_S = 100e-6
        return statistics.median(b - a for a, b in zip(stamps[11:-1], stamps[12:])) * 1e3

    times = {poll: [] for poll in (100e-6, 0.0)}
    for poll in (100e-6, 0.0, 0.0, 100e-6):
        times[poll].append(step_ms(poll))
    with_poll, without = statistics.mean(times[100e-6]), statistics.mean(times[0.0])
    print(json.dumps({"ps_poll": {
        "path": "PS downpour, LeNet", "step_ms_poll_100us": times[100e-6],
        "step_ms_poll_0": times[0.0],
        "poll_share": (with_poll - without) / with_poll,
    }}))


def bench_expected(op: str) -> dict:
    """The kernel launches the sweep routes from one op's kernel-backend
    configs (sync and async, BENCH_CALLS calls each), by the rules of the
    flat lowering: allreduces above ``small_allreduce_size_cuda`` elements
    go to K3 (K5 for 'allreduce_bidir'); broadcasts above
    ``small_broadcast_size_cuda`` elements and ``broadcast_size_tree_based_cuda``
    bytes to K7, smaller ones to the vendor path or the tree; every
    reduce, allgather and reducescatter to its kernel."""
    calls = 2 * BENCH_CALLS
    if op in ("allreduce", "allreduce_bidir"):
        big = [n for n in SWEEP if n > constants.get("small_allreduce_size_cuda")]
        name = "ring_allreduce_bidir" if op == "allreduce_bidir" else "ring_allreduce"
        return {name: calls * len(big)}
    if op == "broadcast":
        big = [n for n in SWEEP if n > constants.get("small_broadcast_size_cuda")
               and 4 * n > constants.get("broadcast_size_tree_based_cuda")]
        return {"ring_broadcast": calls * len(big)}
    kernel = {"reduce": "ring_reduce", "allgather": "ring_allgather",
              "reducescatter": "ring_reduce_scatter"}[op]
    return {kernel: calls * len(SWEEP)}


def phase_bench() -> dict:
    """The collectives benchmark at p=8 (``run_matrix``, as
    ``python -m torchmpi_tpu_torch.examples.bench_collectives`` runs it):
    each op over the xla, ring and kernel backends, sync and async, every
    size of the sweep, then the kernel-backend allreduce under
    'kernel_bidir'. Each op's launch counts are set to 0 just before it
    and must equal :func:`bench_expected` just after (every other kernel
    0: a reduce or an allgather launches no K3). Returns the counts."""
    runs, results = {}, []
    mpi.start(ranks=P)
    try:
        comm = mpi.current_communicator()
        for op in BENCH_OPS + ("allreduce_bidir",):
            bidir = op == "allreduce_bidir"

            def report(r, impl="kernel_bidir" if bidir else None):
                row = {"op": r.op, "backend": r.backend, "mode": r.mode, "nelem": r.nelem,
                       "us": r.mean_us, "bus_gbps": r.bus_gbps, "correct": r.correct}
                if impl:
                    row["ring_implementation"] = impl
                if r.mode == "async":
                    row["launch_us"] = r.launch_us
                print(json.dumps({"bench": row}))

            ops.reset_launch_counts()
            if bidir:
                constants.set("ring_implementation", "kernel_bidir")
            try:
                out = run_matrix(
                    comm, ops=("allreduce",) if bidir else (op,),
                    backends=("kernel",) if bidir else ("xla", "ring", "kernel"),
                    modes=("sync", "async"), sizes=SWEEP, benchmark=True, report=report,
                )
                torch.cuda.synchronize()
            finally:
                constants.set("ring_implementation", "kernel")
            counts = ops.launch_counts()
            want = {name: 0 for name in counts}
            want.update(bench_expected(op))
            require(counts == want, f"bench {op}: launches {counts} != {want}")
            bad = [(r.backend, r.mode, r.nelem) for r in out if not r.correct]
            require(not bad, f"bench {op}: incorrect configs {bad}")
            runs[f"bench_{op}"] = counts
            results += out
    finally:
        mpi.stop()
    launch = {}
    for r in results:
        if r.mode == "async":
            launch.setdefault(r.backend, []).append(r.launch_us)
    print(
        f"bench: {len(results)} configs at p={P}, sizes {SWEEP[0]}..{SWEEP[-1]}, all correct; "
        "launch counts as routed; median host time to issue an async call (us): "
        + json.dumps({b: statistics.median(v) for b, v in launch.items()})
    )
    return runs


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
    print_profile(prof, wall_us, 5, f"{mode}, wire {wire}")


def print_profile(prof, wall_us: float, steps: int, path: str, **fields) -> None:
    """One ``{"profile": ...}`` line: device time by kernel per step and the
    share of the window the device was busy, and ``fields`` as they are."""
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
        "path": path, "steps": steps, "window_us_per_step": wall_us / steps,
        "device_busy_us_per_step": busy_us / steps,
        "device_busy_share": busy_us / wall_us if rows else None,
        "top_kernels_us_per_step": [
            {"name": k[:80], "us": us / steps, "calls_per_step": n / steps}
            for us, k, n in rows[:10]
        ],
        "port_kernels_us_per_step": [
            {"name": k[:80], "us": us / steps, "calls_per_step": n / steps}
            for us, k, n in rows if "tmpi::" in k
        ],
        **fields,
    }}))


def phase_profile_lm(dev, lm: dict) -> None:
    """Where an LM step's time goes (``kernel_full``, full width): 2 steps
    profiled after 1 warm-up step (K10's two launches are
    ``bwd_dq_mma_kernel`` and ``bwd_dkv_mma_kernel``), with the unprofiled
    run's step time, tokens/sec/chip and MFU (``lm``)."""
    from torch.profiler import ProfilerActivity, profile

    model = LongContextTransformer(**LM_WIDTHS, sp_backend="kernel_full").to(dev)
    model.load_state_dict(init_lm_params(model, seed=0))
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    start = []

    def on_step(step, loss):
        torch.cuda.synchronize()
        if step == 0:  # the warm-up step is done: profile the next two
            prof.start()
            start.append(time.perf_counter())

    long_context.train(model, long_context.make_batches(0, 3, LM_BATCH, LM_SEQ), LM_LR, 1,
                       LM_SP, dev, on_step)
    wall_us = (time.perf_counter() - start[0]) * 1e6
    prof.stop()
    del model
    torch.cuda.empty_cache()
    print_profile(prof, wall_us, 2, "LM kernel_full, full width", lm_run_unprofiled=lm)


def bound(nbytes: int, nops: int, tensor_cores: bool = False) -> tuple:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the f32 rate, on the CUDA
    cores or, for work the tensor cores can do, as 3xTF32."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if tensor_cores:
        by_ops, ops_name = nops / F32_3XTF32_OPS_PER_S * 1e3, "operations (3xTF32)"
    else:
        by_ops, ops_name = nops / F32_OPS_PER_S * 1e3, "operations"
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, ops_name)


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
    over the driven paths (``runs``: path -> launch counts), split in
    ``launches_by_path``."""
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
        dict(
            # the local step's update of LeNet's largest leaf, w - lr * g;
            # then one server's apply to its shard of it, in place at an odd
            # element offset, as a shard view sits
            name="scale_accumulate", source="torchmpi_tpu_torch/csrc/reduce_kernel.cu",
            replaces="torchmpi_tpu/ops/reduce_kernel.py:32",
            shape=[P, *LARGEST_LEAF], make=lambda: (randn(P, *LARGEST_LEAF), randn(P, *LARGEST_LEAF)),
            in_bytes=2 * P * LARGEST_LEAF[0] * LARGEST_LEAF[1] * 4,
            bytes=3 * P * LARGEST_LEAF[0] * LARGEST_LEAF[1] * 4,
            ops=2 * P * LARGEST_LEAF[0] * LARGEST_LEAF[1],
            kernel=lambda a, b: ops.scale_accumulate(a, b, -LR),
            plain=lambda a, b: ops.scale_accumulate_plain(a, b, -LR),
            library=lambda a, b: torch.add(a, b, alpha=-LR),
            shard=dict(
                shape=[SHARD], make=lambda: (randn(SHARD + 1)[1:], randn(SHARD)),
                in_bytes=2 * SHARD * 4, bytes=3 * SHARD * 4, ops=2 * SHARD,
                kernel=lambda a, b: ops.scale_accumulate(a, b, -LR, out_=a),
                plain=lambda a, b: ops.scale_accumulate_plain(a, b, -LR, out_=a),
                library=lambda a, b: a.add_(b, alpha=-LR),
            ),
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
    # the collectives benchmark's kernels at the sweep's top size, 2^23 f32
    # per rank (the allgather at 2^20: its output is p times its input)
    rows += [
        dict(
            name="ring_reduce_scatter", source="torchmpi_tpu_torch/csrc/ring_kernels.cu",
            replaces="torchmpi_tpu/ops/ring_kernels.py:201",
            shape=[P, N23], make=lambda: (randn(P, N23),), in_bytes=P * N23 * 4,
            bytes=(P + 1) * N23 * 4, ops=(P - 1) * N23,
            kernel=ops.ring_reduce_scatter, plain=ops.ring_reduce_scatter_plain,
            library=lambda x: x.sum(0),
        ),
        dict(
            name="ring_allgather", source="torchmpi_tpu_torch/csrc/ring_kernels.cu",
            replaces="torchmpi_tpu/ops/ring_kernels.py:201",
            shape=[P, N20], make=lambda: (randn(P, N20),), in_bytes=P * N20 * 4,
            bytes=(P + P * P) * N20 * 4, ops=0,
            kernel=ops.ring_allgather, plain=ops.ring_allgather_plain,
            library=lambda x: x.reshape(1, -1).expand(P, -1).contiguous(),
        ),
        dict(
            # the 'rs' phase and the root gather in one kernel; the
            # library call computes the root's sum only (the other rows'
            # copy is not in it)
            name="ring_reduce", source="torchmpi_tpu_torch/csrc/ring_kernels.cu",
            replaces="torchmpi_tpu/ops/ring_kernels.py:1120",
            shape=[P, N23], make=lambda: (randn(P, N23),), in_bytes=P * N23 * 4,
            bytes=2 * P * N23 * 4, ops=(P - 1) * N23,
            kernel=lambda x: ops.ring_reduce(x, 0), plain=lambda x: ops.ring_reduce_plain(x, 0),
            library=lambda x: x.sum(0),
        ),
        dict(
            name="ring_allreduce_bidir", source="torchmpi_tpu_torch/csrc/ring_kernels.cu",
            replaces="torchmpi_tpu/ops/ring_kernels.py:897",
            shape=[P, N23], make=lambda: (randn(P, N23),), in_bytes=P * N23 * 4,
            bytes=2 * P * N23 * 4, ops=(P - 1) * N23,
            kernel=ops.ring_allreduce_bidir, plain=ops.ring_allreduce_bidir_plain,
            library=lambda x: x.sum(0, keepdim=True).expand_as(x).contiguous(),
            k3=ops.ring_allreduce,
        ),
    ]
    # ring attention at the LM path's shape, f32, causal; the bound counts
    # the useful products: the T(T+1)/2 (query, key) pairs the causal mask
    # keeps over the gathered T = sp*n per cell, 4 d flops each forward and
    # 10 d backward, at the 3xTF32 rate (the tensor cores could do the work
    # at f32 accuracy), with the CUDA cores' f32 bound beside it; the
    # library call is SDPA over the gathered sequence [b, h, T, d] (and its
    # backward)
    # (names apart from n above: the earlier rows' lambdas read it late)
    asp, ab, an, ah, ad = ATTN_MAIN
    pair_flops = ab * ah * (asp * an) * (asp * an + 1) // 2 * ad
    qkv_bytes, lse_bytes = asp * ab * an * ah * ad * 4, asp * ab * ah * an * 4

    def qkv():
        return tuple(randn(*ATTN_MAIN) for _ in range(3))

    def bwd_inputs():
        q, k, v = qkv()
        return (q, k, v, *ops.ring_attention_fwd_plain(q, k, v, True), randn(*ATTN_MAIN))

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def gathered():
        return tuple(t.permute(1, 3, 0, 2, 4).reshape(ab, ah, asp * an, ad) for t in qkv())

    def sdpa_graph():
        leaves = [t.requires_grad_() for t in gathered()]
        return sdpa(*leaves, is_causal=True), leaves, randn(ab, ah, asp * an, ad)

    attn = dict(source="torchmpi_tpu_torch/csrc/ring_attention.cu", shape=list(ATTN_MAIN),
                causal=True, tensor_cores=True)
    rows += [
        dict(attn, name="ring_attention_fwd",
             replaces="torchmpi_tpu/ops/ring_attention_kernel.py:117",
             make=qkv, in_bytes=3 * qkv_bytes, bytes=4 * qkv_bytes + lse_bytes, ops=4 * pair_flops,
             kernel=lambda q, k, v: ops.ring_attention_fwd(q, k, v, True),
             plain=lambda q, k, v: ops.ring_attention_fwd_plain(q, k, v, True),
             library=lambda q, k, v: sdpa(q, k, v, is_causal=True), library_make=gathered),
        dict(attn, name="ring_attention_fwd_bidir",
             replaces="torchmpi_tpu/ops/ring_attention_kernel.py:506",
             make=qkv, in_bytes=3 * qkv_bytes, bytes=4 * qkv_bytes + lse_bytes, ops=4 * pair_flops,
             kernel=lambda q, k, v: ops.ring_attention_fwd(q, k, v, True, True),
             plain=lambda q, k, v: ops.ring_attention_fwd_plain(q, k, v, True, True),
             library=lambda q, k, v: sdpa(q, k, v, is_causal=True), library_make=gathered),
        dict(attn, name="ring_attention_bwd",
             replaces="torchmpi_tpu/ops/ring_attention_kernel.py:852",
             make=bwd_inputs, in_bytes=5 * qkv_bytes + lse_bytes,
             bytes=8 * qkv_bytes + lse_bytes, ops=10 * pair_flops,
             kernel=lambda *a: ops.ring_attention_bwd(*a, True),
             plain=lambda *a: ops.ring_attention_bwd_plain(*a, True),
             library=lambda out, leaves, do: torch.autograd.grad(out, leaves, do, retain_graph=True),
             library_make=sdpa_graph),
    ]
    out = []
    for r in rows:
        def timed(fn, make=r["make"]):
            return time_ms(rotating(fn, make, r["in_bytes"]))

        ms = timed(r["kernel"])
        bound_ms, bound_by = bound(r["bytes"], r["ops"], r.get("tensor_cores", False))
        require(bound_ms <= ms, f"{r['name']}: {ms} ms is under its bound {bound_ms} ms")
        by_path = {path: counts[r["name"]] for path, counts in runs.items()}
        row = {
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": errs[r["name"]], "ms": ms, "kernel_ms": ms,
            "plain_ms": timed(r["plain"]),
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes a requantizing ring; the
            # attention rows' library calls take the gathered layout
            "library_ms": r["library"] and timed(r["library"], r.get("library_make", r["make"])),
            "shape": r["shape"], "dtype": "float32",
        }
        if r.get("causal"):
            row["causal"] = True
        if r.get("tensor_cores"):
            row["bound_f32_ms"] = bound(r["bytes"], r["ops"])[0]
        if "shard" in r:
            sh = r["shard"]

            def shard_ms(fn):
                return time_ms(rotating(fn, sh["make"], sh["in_bytes"]))

            row.update({
                "shard_shape": sh["shape"],
                "shard_ms": shard_ms(sh["kernel"]),
                "shard_bound_ms": bound(sh["bytes"], sh["ops"])[0],
                "shard_plain_ms": shard_ms(sh["plain"]),
                "shard_library_ms": shard_ms(sh["library"]),
                "launches_per_ps_step": {path: counts[r["name"]] / PS_STEPS
                                         for path, counts in runs.items() if path.startswith("ps_")},
            })
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
    runs = {path: run["counts"] for path, run in phase_trainer(dev).items()}
    phase_async(dev)
    runs.update(phase_bench())
    lm_runs, lm_stats = phase_lm(dev)
    runs.update(lm_runs)
    runs.update(phase_ps(dev))
    phase_ps_vs_cpu(dev)
    phase_ps_throughput()
    phase_profile("sync", "full")
    phase_profile("async", "int8")
    phase_profile_lm(dev, lm_stats)
    phase_profile_ps()
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
