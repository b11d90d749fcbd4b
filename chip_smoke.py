#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``torchmpi_tpu_torch``) on one card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc`` (CUDA_HOME, /usr/local/cuda or the PATH), imports
nothing of JAX or of the JAX package, and exits non-zero as soon as any
phase fails:

1. prints the card (``nvidia-smi`` name and power limit) and the
   toolchain;
2. builds every kernel from ``torchmpi_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together with the host compiler's build of the C++
   async issue path, ``csrc/issue.cpp``) and prints the registers and spills of the
   tensor-core attention kernels and of K4 (``ring_quant_kernel``), and
   K4's SASS opcode counts (``{"ptxas": ...}``, ``{"sass": ...}``);
3. holds each kernel against its plain PyTorch version on the card, at
   the main paths' shapes and over a sweep of dtypes, wires, modes, ranks,
   roots and ragged sizes: every comparison of a collective kernel must be
   exact (the plain versions repeat the kernels' arithmetic in the same
   order and type), and the closed form "rank r contributes r" must sum to
   p(p-1)/2; K4's sweep adds p > 8, rows around the int8 scale's floor,
   quotients at half-integers and the rows on which rounding the int8
   decode-and-add twice would differ from rounding it once; K1 and K2's
   list forms over ResNet-50's 161 leaves, mixed lists and the PS shard at
   an odd offset, with the launches each call counts (``{"many_table"}``
   names the table the build takes and the host time of one list call);
   the per-rank kernels of ROADMAP C6's repair (the convolution weight
   gradient and the product) within ``WGRAD_RTOL`` of max|plain| of their
   plain versions and bit for bit across stacks of 8, 4 and 2 ranks;
4. checks the trainer on a small input against the same trainer on the
   CPU (plain versions), and the main path's first steps' gradients
   through the per-rank kernels against the same engine's with their
   plain versions (:func:`main_path_gradient`), then drives the two MNIST
   paths, LeNet at p=8
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
   ``{"bench": ...}`` line; then the host time to issue an async allreduce
   at 2^8 elements and its parts (``{"async_issue": ...}``: the schedule
   compiler's memo hit and the C++ issue path among them); then the
   schedule compiler's phase (:func:`phase_compiler`, the
   ``{"compiler": ...}`` line): no plan-cache or dispatch-memo miss in 20
   MNIST sync steps after ``engine.precompile()``, a ``plan_id`` on every
   flight-recorder entry of 5 sync and 5 async int8 steps, the sync
   step's time with telemetry off and on in turns, and the ``ring``
   backend's allreduce at [8, 2^24] at the compiler's pipeline depth,
   bitwise equal to depth 1; then the two-level phase
   (:func:`phase_hier`, BASELINE config 5): every two-level lowering
   (hierarchical allreduce on ``xla``, ``ring`` at depths 1 and 2,
   ``kernel``, ``kernel_bidir`` and the int8 wire; broadcast, reduce and
   allgather on ``ring`` and ``kernel``; the staged allreduce; the tree
   allreduce and broadcast on ragged splits) on the card against the CPU,
   bit for bit (``xla`` within ``HIER_XLA_RTOL``) with exact launches: one
   over every group for an intra phase on K3, K3 'ag' or K7, one a group
   on K4, K5 or K6; the grouped K3, K3 'ag' and K7 on the card against
   their plain versions bit for bit (:func:`check_grouped`: config 5's
   bucket widths, [8, 2^23], ``HIER_N``, every native dtype); the twin of
   ``examples/blocksequential_2host.py`` at its defaults (MLP6, Adam, 3
   blocks, 2 hosts of 4, 64 steps) with the ``ring`` and the ``kernel``
   intra phase: falling losses, accuracy above 0.6,
   ``check_with_allreduce``, the hierarchical plan run, K3 launched steps
   x blocks times; and the two-level allreduce at [8, 2^23] beside flat
   K3, the grouped intra phase against its bound and the library call,
   and one host's K3 slab against its bound (``{"hier": ...}``);
7. drives the long-context LM path (``examples/long_context.py``): a small
   LM on the card against the same LM on the CPU (plain versions), then the
   ``lm`` line's widths (vocab 8192, 8 layers, 8 heads x 64, d_model 512),
   4096 tokens over sp=4 virtual ranks, batch 4, Adam lr 3e-4, causal, f32:
   20 steps with ``kernel_full`` (K8 forward, K10 backward, in every layer)
   with exact launch counts and the loss falling, then 5 steps each with
   ``kernel_bidir_full`` (K9) and ``xla`` (no kernel) from the same init
   and batches, whose losses must match the first 5; then the parallel
   phase (:func:`phase_parallel`, the ``{"parallel"}`` line): the twins of
   ``examples/mnist_modelparallel.py`` (dp 2 x tp 4, 72 steps) and
   ``examples/pipeline_stages.py`` under GPipe and 1F1B (dp 2 x pp 4, 64
   steps each), one MoE step (ep 8, top-2) and one dp 2 x pp 2 x tp 2 step
   at ``__graft_entry__.py``'s widths, each also small on the card against
   the CPU, with every K3 launch exact (``axis_psum`` is one grouped K3,
   its backward another); the LM above in bf16, with and without remat, 5
   steps each (K8 8 or 16 a step, K10 16), its losses within
   ``LM_BF16_RTOL`` of the f32 run's and remat's equal to the plain
   run's; and the LM through the engine at ``bench.py:758-770``'s chip
   widths (vocab 8192, 8 layers, 8x64 heads, d_model 512, seq 1024, bf16,
   Adam 3e-4, 8 sequences a rank, two epochs of 4 steps) with exact
   launches (K3 per fused flush, one K7, one K1 list call a step), a
   falling loss, tokens/sec/chip, step ms, peak memory and a 2-step
   profile beside the card;
8. drives the ResNet path (``examples/resnet_allreduce.py``, BASELINE
   config 4): a narrow ResNet (stages [1, 1], 8 filters, 32 px, p=4) on
   the card against the CPU (plain versions), sync and async; the step
   time of both per-rank gradient forms (``rank_map`` 'vmap' and 'loop')
   on ResNet-50 at full width and on the MNIST path's LeNet, and LeNet's
   vmap with the per-rank kernels against its native form in turns; then
   ResNet-50 at full width (1000 classes, 224 px), p=8, per-rank batch
   32, momentum 0.9, lr 0.1, three epochs of
   ``synthetic_imagenet(2048)``, in sync and in async mode (4 buckets):
   exact launch counts (:func:`resnet_expected`: the momentum trace and
   the update one list call each a step), finite losses, the last
   epoch's below the first's, ``check_with_allreduce`` on the parameters
   and the batch statistics, the test accuracy, one async step's buckets
   against blocking allreduces bit for bit, a 3-step profile and one
   ``{"resnet": ...}`` line (img/s/chip, step time, MFU, the device's busy
   share and time by kernel class); then the sequential MNIST twin on the
   card (K1 only) beside the p=8 sync MNIST run; then the sharded
   path (``--fsdp`` and ``--accum-steps`` of the same example, and
   ``param_sharding='zero1'``): ResNet-18 (8 classes, 16 px, 4 a rank) and
   LeNet (the MNIST path's widths) at p=8 on the card against the CPU
   under fsdp, zero1, fsdp with two microbatches and fsdp with remat, 3
   steps each; then ResNet-50 at the same full width under fsdp, zero1 and
   fsdp with 4 microbatches, two epochs of 8 steps each: exact launch
   counts (:func:`sharded_expected`: K3 'rs' per packed flush, one K3
   'ag', one K2 and one K1 list call a step, and k more K1 calls with k
   microbatches), the last epoch's loss below the first's,
   ``check_with_allreduce`` on the gathered parameters and the statistics,
   and one ``{"sharded": ...}`` line (step time, img/s/chip, MFU, peak
   memory, losses, launches a step, the card); then the engine's options
   (:func:`phase_engine`, one ``{"engine": ...}`` line with the card): (a)
   LeNet sync at the MNIST path's widths resumed from a
   ``checkpoint_every(3)`` checkpoint after 3 of 6 steps, bit for bit
   the unbroken run, with its launches counted (1 K3 and 1 K1 a step;
   its first sync takes the tree broadcast); (b) ResNet-50 fsdp at full
   width resumed after 2 of 4 steps from a checkpoint reshaped 8 -> 4 ->
   8 by ``python -m torchmpi_tpu_torch.reshard`` (the files byte for byte
   the original's), bit for bit, with the save's bytes, host copy and
   write and the step at and off a save boundary timed; (c) ResNet-50
   sync with ``flops_per_sample``, telemetry off and on: the step times
   and ``tm_engine_mfu``; (d) LeNet ``train`` with ``profile_dir`` and
   window (3, 5): the trace holds exactly 2 K3 and 2 K1 launches by their
   kernel names; (e) ``GradientBuckets.sync_scheduled`` on config 2's two
   buckets, full and int8 wire: 'none' and 'reverse' bit for bit, the
   launches exact, each schedule's median ms; (f) a second ``evaluate``
   of the same set staged nothing and copied nothing to the card;
9. drives the parameter-server path (``examples/mnist_parameterserver.py``'s
   twin, ``train`` on LeNet): p=8, global batch 336, lr 0.2, ``--tau 5
   --init-delay 10``, two epochs (48 steps) each of Downpour, EASGD (beta
   0.9) and DSGD with the full wire, and Downpour with the int8 wire; the
   loss must fall, and the launch counts (0 just before each run, read just
   after) must be the K1 and K2 applies the schedule routes
   (:func:`ps_expected`), every other kernel 0; then a short
   LogisticRegression run of each on the card against the CPU (plain
   versions), and ``run_ps_throughput`` at 2^20 elements and at LeNet's
   size, full and int8 wire (``{"ps": ...}`` lines);
10. profiles 5 steps of each MNIST path, 2 LM steps and 5 Downpour steps
   (``torch.profiler``) and prints one ``{"profile": ...}`` line each:
   device time by kernel and busy share (the LM's with the step time,
   tokens/sec/chip and MFU of 7.'s ``kernel_full`` run); times Downpour
   steps with the PS
   server's 100 us polling cadence and with none (``{"ps_poll": ...}``);
11. times K3 'rs' against ``x.sum(0)`` in turns at [8, 2^23] and at the
   sharded path's largest packed flush, and K3 'ag' against expand-copy at
   its packed parameter gather (``{"rs_retime": ...}``);
   then the streamed ResNet path (:func:`phase_streaming`:
   ``resnet_allreduce.main`` with ``--streaming --input-workers 2`` at
   the ResNet path's widths, two epochs of 8 steps: every batch the
   engine received equal on the card, bit for bit, to ``source.gather``
   of the pipeline's indices, every step's loss equal bit for bit to the
   same engine's on a plain iterator of those host batches, the launches
   of :func:`resnet_expected`, the resident run beside it; the
   ``{"streaming": ...}`` line) and the serving path
   (:func:`phase_serve`: config 1's LeNet in a ParameterServer over the
   p=8 ranks, an InferenceServer answering 64-image requests at QoS 0-2
   from four threads while a downpour trainer publishes 48 scaled 'add'
   sends; every reply the forward of one published version bit for bit,
   then of ``ps.receive()``, swaps >= 2, QoS 0 shed at pending 4, K2
   launched 8 a send; the ``{"serve": ...}`` line); then the
   algebra-synthesized lowerings (:func:`phase_synth`: halve, torus and
   stripe pinned on the ``ring`` and ``kernel`` backends for each wire at
   config 5's bucket widths and an odd width, on the card against the
   CPU bit for bit with no hand-kernel launch; the exact payload against
   flat K3 and the sum; each family at [8, 2^23] beside flat K3 and
   ``hier``; config 5's twin under ``use_plan_synthesis`` and under
   overrides pinning torus and stripe: falling losses within
   ``SYNTH_LOSS_RTOL`` of the ``hier`` run's, each bucket's plan the CPU
   port's, bucket allreduces bit for bit the CPU's, exact launches; the
   ``{"synth": ...}`` line) and a supervised rollback
   (:func:`phase_supervise`: LeNet's sync engine with a live aggregator
   and a ``RecoverySupervisor``; a held async K3 gives the ``hang``
   verdict, failed evictions escalate to a rollback from the last
   checkpoint, and the run ends bit for bit on a clean run's; the
   ``{"supervise": ...}`` line) and the ranks in two processes
   (:func:`phase_multiprocess`: 2 processes x 4 ranks through the
   launcher; the cross-process K3 allreduce, 'rs' and 'ag', K4 (both
   modes, both wires) and K7 bit for bit their plain versions and the
   one-process rows, and so the cross-process K5 and K6 (the latter in
   the root's process only); sendreceive's and alltoall's rows on every
   backend; config 1 replicated under two spans and under fsdp
   and zero1, config 2 (async, int8), each bit for bit its one-process
   run, exact launches; config 1 under ``rank_map='vmap'`` held to the
   one-process vmap run (ROADMAP C6); the host time to issue an async
   cross-process allreduce; run (g), the collectives benchmark through
   the launcher by the two processes (every op of the surface on xla,
   ring and kernel, sync and async, 2^8..2^23, then the kernel allreduce
   under 'kernel_bidir'): every row correct, exact launches a process;
   the ``{"multiprocess": ...}`` line and the ``{"bench_2x4": ...}`` line,
   the bus GB/s at 2^23 beside the one-process sweep's; run (h), config 5
   by 4 processes x 2 ranks in 2 hosts of 2 processes under ``hier`` and
   staged, bit for bit the one-process run of 8, the grouped
   cross-process K3 and K7 and communicators over some of the processes,
   the ``{"groups_4x2": ...}`` line);
   then times each kernel, its plain version and,
   where there is one, a
   PyTorch call computing the same function with CUDA events at the main
   paths' shapes, on inputs rotated past the L2, and prints one
   ``{"kernels": [...]}`` line: each row's bound is the larger of its bytes
   over 3.35 TB/s and its operations over 67 TFLOP/s (f32), or for the
   attention rows over 165 TFLOP/s (f32 as 3xTF32 on the tensor cores,
   with the f32 bound beside it), and no kernel may read under its bound;
   K2's row carries the floor of one launch (an empty kernel, same timing)
   beside its shard; rows marked ``at`` time K3, K1, K2 and K7 at the
   ResNet path's shapes (its largest fused flush, its largest leaf, the
   update and the momentum trace of a whole step, its first parameter
   sync) with their launches per ResNet step, and K3 'rs' and 'ag' at the
   sharded path's shapes with their launches per sharded step;
12. prints last ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --resnet`` runs the build, the sync MNIST path and
step 8's ResNet phase alone; ``--sharded`` the build, step 8's sharded
path and step 11's retime; ``--compiler`` the build, the schedule
compiler's phase and the async issue line; ``--hier`` the build and the
two-level phase; ``--engine`` the build and the engine phase;
``--parallel`` the build and the parallel phase; ``--streaming`` the
build and the streamed ResNet phase; ``--serve`` the build and the
serving phase; ``--synth`` the build and the synthesized lowerings'
phase; ``--supervise`` the build and the supervised rollback;
``--multiprocess`` the build and the ranks in two and four processes;
``--wgrad`` builds the per-rank kernels alone, holds them against their
plain versions and prints their rows; ``--attention`` builds the attention
kernels alone, prints their ptxas report, holds them against their plain
versions, runs the bf16 sp LM with and without remat under its gates and
prints K8, K9 and K10's f32 and bf16 rows.
``python3 chip_smoke.py --many`` builds K1 and K2 alone,
holds their list forms against the plain versions (``{"many_table"}``).
``python3 chip_smoke.py --quant check`` builds K4 alone, prints its registers and
SASS counts, holds it against its plain version and times its rows
(``{"quant_kernels": ...}``); ``--quant time`` only times them. None of
these prints the result line. ``python3 chip_vmap_probe.py`` is ROADMAP
C6's probe on the card, ``python3 chip_wgrad_precision.py`` the weight
gradient's precision against f64 and ``python3 chip_exchange_probe.py``
the control plane's two host exchanges.

Kernels are held to their plain versions bit for bit, but for the ring
attention kernels (K8, K9, K10), which merge 64-key tiles where the plain
versions merge whole blocks and multiply on the tensor cores (as 3xTF32
for f32 inputs): those agree within the tolerances of ``ATTN_TOL`` (f32)
and ``BF16_REL`` (bf16).
"""

from __future__ import annotations

import atexit
import contextlib
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from functools import partial
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

# the tuning and calibration caches that start() reloads live in a
# directory of this run alone (removed at exit): a persisted tuning or
# calibration would change the routes, and so the launch counts, of every
# phase
_CACHES = Path(tempfile.mkdtemp(prefix="chip-smoke-caches-"))
atexit.register(shutil.rmtree, _CACHES, True)
os.environ["TORCHMPI_TPU_TUNING_CACHE"] = str(_CACHES / "autotune.json")
os.environ["TORCHMPI_TPU_CALIBRATION_CACHE"] = str(_CACHES / "calibration.json")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torchmpi_tpu_torch as mpi  # noqa: E402
from torchmpi_tpu_torch import constants  # noqa: E402
from torchmpi_tpu_torch import nn as mpinn  # noqa: E402
from torchmpi_tpu_torch import ops  # noqa: E402
from torchmpi_tpu_torch import telemetry  # noqa: E402
from torchmpi_tpu_torch.collectives import primitives  # noqa: E402
from torchmpi_tpu_torch.engine import SGD, AllReduceSGDEngine  # noqa: E402
from torchmpi_tpu_torch.examples import long_context  # noqa: E402
from torchmpi_tpu_torch.examples import mnist_sequential  # noqa: E402
from torchmpi_tpu_torch.examples import mnist_parameterserver as ps_example  # noqa: E402
from torchmpi_tpu_torch.examples import resnet_allreduce  # noqa: E402
from torchmpi_tpu_torch.models import (  # noqa: E402
    BottleneckBlock,
    LeNet,
    LogisticRegression,
    LongContextTransformer,
    ResNet,
    ResNet18,
    ResNet50,
    accuracy,
    init_lm_params,
    init_params,
    init_resnet,
    make_eval_fn,
    make_loss_fn,
    make_stateful_loss_fn,
)
from torchmpi_tpu_torch.ops import _build  # noqa: E402
from torchmpi_tpu_torch.ops.ring_kernels import NATIVE_DTYPES, bidir_chunk_elems  # noqa: E402
from torchmpi_tpu_torch.parallel import ring_self_attention  # noqa: E402
from torchmpi_tpu_torch.data import ArraySource  # noqa: E402
from torchmpi_tpu_torch.parameterserver import ParameterServer  # noqa: E402
from torchmpi_tpu_torch.parameterserver import server as ps_server  # noqa: E402
from torchmpi_tpu_torch.serve import InferenceServer  # noqa: E402
from torchmpi_tpu_torch.utils import (  # noqa: E402
    DistributedIterator,
    synthetic_imagenet,
    synthetic_mnist,
    synthetic_tokens,
)
from torchmpi_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from torchmpi_tpu_torch.utils.flops import (  # noqa: E402
    mfu,
    resnet_forward_flops,
    train_flops,
    transformer_forward_flops,
)
from torchmpi_tpu_torch.utils.tester import (  # noqa: E402
    run_matrix,
    run_ps_throughput,
    sweep_sizes,
    wire_midpoint_rows,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores (data sheet)
# the f32 rate on the tensor cores as 3xTF32: three TF32 MMAs (495 TFLOP/s
# dense, data sheet) per f32 product
F32_3XTF32_OPS_PER_S = 495e12 / 3
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate (data sheet)
L2_BYTES = 50 * 2**20  # H100 L2 cache
P = 8  # virtual ranks on the main path
BATCH = 336
LR = 0.2
LENET_PARAMS = 857738  # LeNet's fused gradient buffer, per rank
# LeNet's convolutions: under the engine's vmap on the card each one's
# weight gradient is one launch of the per-rank kernel a step (C6's repair)
LENET_CONVS = 2
# its per-rank products under the vmap, one ops.rank_bmm launch each a
# step: the two dense layers' forwards, weight and input gradients
LENET_PRODUCTS = 6
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
# the parallel phase: the MoE step and the 3-D step at __graft_entry__.py's
# widths; the LM through the engine at bench.py:758-770's chip widths, bf16,
# two epochs of synthetic_tokens(256, 1024, 8192) at 8 sequences a rank
MOE = dict(d=8, T=6, top_k=2)
CUBE = dict(k=4, m=2, mb=2)
LM_ENGINE = dict(vocab_size=8192, num_layers=8, num_heads=8, head_dim=64, d_model=512,
                 max_len=1024)
LM_ENGINE_RUN = dict(num_seqs=256, seq=1024, per_rank=8, epochs=2, lr=3e-4)
LM_ENGINE_STEPS = LM_ENGINE_RUN["epochs"] * (LM_ENGINE_RUN["num_seqs"] // P
                                             // LM_ENGINE_RUN["per_rank"])  # 8
# bf16 against f32 losses, step by step: the loss is an f32 mean over 16,384
# tokens, so the residual stream's bf16 roundings (2^-8 relative) mostly
# average out (1e-6 to 1.5e-4 relative on the CPU at 2 layers of width 128)
LM_BF16_RTOL = 2.0**-8
# kernel against plain, (atol, rtol). f32: as tests/test_ops.py holds the
# JAX kernels, outputs atol 2e-5, the backward and K9 against K8 2e-4; lse
# (f32 for every input dtype) 1e-4. bf16: both sides round an f32 result
# to bf16, so they differ by at most one bf16 ulp (2^-7 of the value) and
# the f32 sums' rounding: rtol 2^-7, atol 2^-7 of the largest |plain|, a
# limit that scales with the values compared
ATTN_TOL = {"o": (2e-5, 0.0), "lse": (1e-4, 0.0), "grad": (2e-4, 2e-4), "k9_vs_k8": (2e-4, 2e-4)}
BF16_REL = 2.0**-7
# the forward attention kernel's block layout (csrc/ring_attention.cu,
# FwdBlock): the faster at the LM shape of the two that were tried
FWD_LAYOUT = "B (8 warps, 128 query rows; A, 4 warps over 64 rows, was slower)"
# the attention kernels' sources (``--attention`` builds these alone)
ATTENTION_SOURCES = ("ring_attention", "ring_attention_bf16")
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
# the ResNet path (examples/resnet_allreduce.py, BASELINE config 4): ResNet-50
# at full width, p=8, per-rank batch 32, momentum SGD, three epochs of
# synthetic_imagenet(2048) (8 steps each; the first warms up)
RESNET = dict(classes=1000, image=224, per_rank=32, lr=0.1, momentum=0.9, train=2048, test=128,
              epochs=3, buckets=4)
RESNET_LEAVES, RESNET_PARAMS, RESNET_STATS = 161, 25557032, 53120
RESNET_LARGEST_LEAF = (512, 512, 3, 3)  # the last stage's 3x3 conv, 2,359,296 a rank
RESNET_FLUSH = 2360320  # its largest fused flush per rank (the 3x3 conv and two BNs)
RESNET_BUCKET = 8534784  # its largest async bucket per rank
RESNET_STEPS = RESNET["epochs"] * (RESNET["train"] // P // RESNET["per_rank"])  # 24
RESNET_TIMED_STEPS = 3  # per rank map, after one warm-up step
# the card against the CPU: a narrow ResNet at 32 px, p=4, three steps;
# losses within rtol 1e-4, parameters, traces and statistics within atol 1e-4
RESNET_SMALL = dict(stage_sizes=[1, 1], block=BottleneckBlock, num_filters=8, num_classes=10)
# the sharded path (examples/resnet_allreduce.py --fsdp [--accum-steps 4], and
# param_sharding='zero1'): ResNet-50 at the ResNet path's widths, two epochs
# of 8 steps (the first warms up) of each (mode, accum_steps)
SHARDED_RUNS = (("fsdp", 1), ("zero1", 1), ("fsdp", 4))
SHARDED_EPOCHS = 2
SHARDED_STEPS = SHARDED_EPOCHS * (RESNET["train"] // P // RESNET["per_rank"])  # 16
RESNET_GATHER = RESNET_PARAMS // P  # fsdp's packed parameter shards per rank, one K3 'ag'
# the card against the CPU: ResNet-18 (8 classes, 16 px, 4 images a rank) and
# LeNet at the MNIST path's widths, p=8, three steps of each (mode,
# accum_steps, remat); losses within rtol 1e-4, parameters within atol 1e-4
SHARDED_SMALL = (("fsdp", 1, False), ("zero1", 1, False), ("fsdp", 2, False), ("fsdp", 1, True))
# K1 and K2's bound over a whole ResNet-50 step: every leaf's two inputs read
# and its result written once, f32, p=8
RESNET_STEP_BYTES = 3 * 4 * P * RESNET_PARAMS
# time_ms's settings for a call over ResNet-50's 161 leaves: its host side
# takes milliseconds, so 5 calls a timing behind a sleep of about 60 ms
# keep the card fed while the host enqueues them
LIST_TIMING = dict(per=5, sleep=100_000_000)
# the two-level phase (BASELINE config 5): two-level communicators of the
# p=8 ranks, ragged ones for the tree, the payload a rank of the checks
# (ragged: the last chunk is short), the twin's defaults
HIER_KEYS = {"2x4": lambda r: str(r % 2), "4x2": lambda r: f"host{r // 2}"}
HIER_RAGGED = {"1+7": lambda r: "a" if r == 0 else "b", "3+2+3": lambda r: "abc"[r * 3 // P]}
HIER_N = (1 << 16) + 5  # just above wire_quant_min_elements: the int8 wire engages
HIER_XLA_RTOL = 1e-5  # the card's sum within and across groups against the CPU's
CONFIG5 = dict(blocks=3, hosts=2, epochs=4, train=1024, batch_per_rank=8)
CONFIG5_STEPS = CONFIG5["epochs"] * (CONFIG5["train"] // P // CONFIG5["batch_per_rank"])  # 64
CONFIG5_G, CONFIG5_I = CONFIG5["hosts"], P // CONFIG5["hosts"]
CONFIG5_BUCKET = 100480  # its largest gradient bucket per rank (dense1.bias, dense0.weight)
CONFIG5_BUCKETS = (67210, CONFIG5_BUCKET, 128)  # its three buckets per rank
CONFIG5_PARAMS = 167818  # MLP6 at 128 features: its first sync's one fused broadcast a rank
# MLP6's per-rank products a step on the card, one ops.rank_bmm launch
# each: 6 forwards, 6 weight gradients, 5 input gradients (not the input's)
CONFIG5_PRODUCTS = 17
# the engine phase: its checkpoints under the checkout (removed at the end),
# LeNet 3 steps + a checkpoint + 3, ResNet-50 fsdp 2 + 2, the telemetry run's
# (warm-up, timed) steps, the profile window, the scheduled syncs timed
ENGINE_CKPT_ROOT = Path(__file__).resolve().parent / "_engine_ckpt"
ENGINE_RESUME_STEPS = 3
ENGINE_RESNET_STEPS = 2
ENGINE_TELEMETRY_STEPS = (2, 3)
ENGINE_WINDOW = (3, 5)
ENGINE_SCHED_REPS = 20
CONFIG2_BUCKETS = (BUCKET0, LENET_PARAMS - BUCKET0)  # config 2's two buckets a rank
# the streamed ResNet path (examples/resnet_allreduce.py --streaming): the
# ResNet path's widths, two epochs of synthetic_imagenet(2048) (8 steps each;
# the first warms up), two producer threads; the same example resident
# beside it for img/s
STREAM = dict(train=2048, epochs=2, workers=2)
STREAM_ARGS = ["--model", "resnet50", "--classes", str(RESNET["classes"]),
               "--image-size", str(RESNET["image"]), "--train", str(STREAM["train"]),
               "--test", str(RESNET["test"]), "--per-rank-batch", str(RESNET["per_rank"]),
               "--epochs", str(STREAM["epochs"]), "--lr", str(RESNET["lr"]),
               "--momentum", str(RESNET["momentum"]), "--ranks", str(P)]
# the serving path: config 1's LeNet flattened (LENET_PARAMS f32) in a
# ParameterServer over the p=8 ranks; a downpour trainer publishes 48 scaled
# 'add' sends of its gradients on 64 images; request threads send 64-image
# payloads at QoS 0-2 while the refresher swaps every 5 ms
SERVE = dict(sends=48, lr=0.05, batch=64, threads=4, payloads=4, min_requests=25,
             refresh_s=0.005, budget=4)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


_MARK = [time.perf_counter()]


def mark(phase: str) -> None:
    """Print the seconds since the last mark (or the start): each phase's
    share of the run's time limit."""
    now = time.perf_counter()
    print(f"phase {phase}: {now - _MARK[0]:.1f} s", flush=True)
    _MARK[0] = now


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


def time_ms(fn, reps: int = 5, per: int = 20, sleep: int = 20_000_000) -> float:
    """Median over ``reps`` of the mean time of ``per`` back-to-back calls,
    with CUDA events. A sleep kernel of ``sleep`` cycles queued first keeps
    the card busy while the host enqueues, so host launch overhead does not
    pad the timing."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(sleep)
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


def attention_kernel(mangled: str):
    """``name<D, dtype>`` (``name<D, dtype, bidir>`` for the forward's K9
    order) of a tensor-core attention kernel's mangled name (the f32
    kernels' ``*_mma_kernel<D, float>``, the bf16 ones' ``*_wgmma_kernel<D>``),
    else None."""
    m = re.search(r"attn\d+(\w+_mma_kernel)ILi(\d+)E(\w)(Lb1)?", mangled)
    if m:
        return (f"{m.group(1)}<{m.group(2)}, {'float' if m.group(3) == 'f' else 'bf16'}"
                f"{', bidir' if m.group(4) else ''}>")
    m = re.search(r"attn16\d+(\w+_wgmma_kernel)ILi(\d+)E(Lb1)?", mangled)
    if m:
        return f"{m.group(1)}<{m.group(2)}, bf16{', bidir' if m.group(3) else ''}>"
    return None


# SASS opcodes that show how the attention kernels multiply and copy:
# wgmma (HGMMA), mma.sync (HMMA), TMA tile loads (UTMALDG) and cp.async
# (LDGSTS)
ATTN_SASS = ("HGMMA", "HMMA", "UTMALDG", "LDGSTS")


def attention_sass(lib: Path) -> dict:
    """Per attention kernel of ``lib``: static counts of :data:`ATTN_SASS`
    opcodes, whether an HMMA takes TF32 operands, the operands of its
    ``setmaxnreg`` instructions (USETMAXREG) and the highest register its
    code names (above the launch's allocation where a warpgroup took more
    by ``setmaxnreg``), from ``cuobjdump -sass``."""
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            name = attention_kernel(fn.group(1))
            if name:
                out[name] = {**dict.fromkeys(ATTN_SASS, 0), "tf32_hmma": 0, "setmaxnreg": [],
                             "max_register": 0}
            continue
        op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)([.\w]*)\s*([^;]*);", line)
        if not (name and op):
            continue
        regs = [int(x) for x in re.findall(r"\bR(\d+)\b", op.group(3))]
        if regs:
            out[name]["max_register"] = max(out[name]["max_register"], max(regs))
        if op.group(1) in ATTN_SASS:
            out[name][op.group(1)] += 1
        if op.group(1) == "HMMA" and "TF32" in op.group(2):
            out[name]["tf32_hmma"] += 1
        if op.group(1) == "USETMAXREG":
            out[name]["setmaxnreg"].append(f"{op.group(2)} {op.group(3).strip()}")
    return out


def quant_kernel(mangled: str):
    """``ring_quant_kernel<wire, mode, maxp, vec>`` of a mangled name (maxp
    0 is the p > 8 path; vec the floats a lane moves at once), else None."""
    m = re.search(r"ring_quant_kernelILi(\d)ELi(\d)ELi(\d+)ELi(\d)E", mangled)
    if not m:
        return None
    wire, mode = WIRES[int(m.group(1))], ("allreduce", "rs")[int(m.group(2))]
    return f"ring_quant_kernel<{wire}, {mode}, {m.group(3)}, {m.group(4)}>"


def ptxas_report(log: str, name_of) -> dict:
    """Registers and spill bytes of each kernel that ``name_of`` names
    (mangled name -> name or None), from ``nvcc -Xptxas -v`` output."""
    report, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = name_of(entry.group(1))
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


# SASS opcodes counted in K4's code: the division's reciprocal and range
# check, the conversions and f64 work the C4 repair removed, the warp max's
# shuffles, the FMAs, the global loads and stores
SASS_OPS = ("MUFU", "FCHK", "F2I", "I2F", "F2F", "DMUL", "DADD", "DFMA", "SHFL", "REDUX", "FFMA",
            "LDG", "STG")


def sass_counts(lib: Path, name_of) -> dict:
    """Static counts of :data:`SASS_OPS` in each kernel of ``lib`` that
    ``name_of`` names, from ``cuobjdump -sass`` (instructions in the code,
    the unrolled hops and the division's slow path included; not counts of
    executed instructions)."""
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            name = name_of(fn.group(1))
            if name:
                counts[name] = dict.fromkeys(SASS_OPS, 0)
            continue
        op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", line)
        if name and op and op.group(1) in counts[name]:
            counts[name][op.group(1)] += 1
    return counts


def phase_build(names=_build.SOURCES + _build.EXTENSIONS) -> None:
    t0 = time.perf_counter()
    paths = _build.build_all(names)
    print(f"build: {len(paths)} libraries in {time.perf_counter() - t0:.1f} s")
    # registers and spills (sm_90a) of every tensor-core attention kernel
    # (K8/K9's fwd_mma_kernel and K10's bwd_dq_mma_kernel and
    # bwd_dkv_mma_kernel on f32, their *_wgmma_kernel on bf16, at every
    # head dim) and of K4, and K4's SASS opcode counts
    for source, name_of in (("ring_attention", attention_kernel),
                            ("ring_attention_bf16", attention_kernel), ("ring_quant", quant_kernel),
                            ("conv_wgrad", lambda m: "conv_wgrad_kernel" if "conv_wgrad" in m
                             else None),
                            ("rank_bmm", lambda m: "rank_bmm_kernel" if "rank_bmm" in m else None)):
        if source not in names:
            continue
        if source == "ring_attention":
            print(f"forward attention layout: {FWD_LAYOUT}")
        log = _build.build_log(source)
        if log.exists():
            print(json.dumps({"ptxas": ptxas_report(log.read_text(), name_of)}))
            if source in ATTENTION_SOURCES:
                # ptxas's warnings and its notes of a serialized wgmma
                # pipeline ("Potential Performance Loss")
                for line in log.read_text().splitlines():
                    if "warning" in line.lower() or "Performance Loss" in line:
                        print(f"ptxas {source}: {line.strip()}")
        else:
            print(f"no ptxas report: {log} is missing")
    if "ring_quant" in names:
        print(json.dumps({"sass": sass_counts(_build.target("ring_quant"), quant_kernel)}))
    # how each attention kernel multiplies and copies: the bf16 kernels by
    # wgmma and TMA with setmaxnreg, none of them TF32 on bf16 inputs
    for source in ATTENTION_SOURCES:
        if source in names:
            print(json.dumps({"attention_sass": attention_sass(_build.target(source))}))


def check_quant(dev, gen) -> dict:
    """The quantized ring against its plain version, bit for bit: both
    wires, both modes, p in {2, 3, 8} and the p > 8 path (9, 16), ragged
    sizes, rows of 16-, 8- and 4-byte accesses (n a multiple of 4, of 2,
    odd, and a misaligned view), a second segment above 8 x 896 x 128
    elements, the main paths' shapes (the async bucket [8, 805386] and the
    sync-wire buffer [8, 857738]), zeros, rows under and around the int8
    scale's floor, rows whose quotients lie on or next to half-integers
    (:func:`halfway_rows`, where the kernel's encode divides), and rows on
    whose last reduce-scatter hop rounding the int8 decode-and-add twice
    would differ from rounding it once (``tester.wire_midpoint_rows``)."""
    err = {}

    def same(k, pl, what):
        torch.cuda.synchronize()
        require(torch.equal(bits(k), bits(pl)), f"{what} != plain")

    def both(x, wire, what):
        same(ops.ring_allreduce_quant(x, wire), ops.ring_allreduce_quant_plain(x, wire),
             f"ring_allreduce_quant {wire} {what}")

    def both_rs(x, wire, what):
        same(ops.ring_reduce_scatter_quant(x, wire), ops.ring_reduce_scatter_quant_plain(x, wire),
             f"ring_reduce_scatter_quant {wire} {what}")

    for wire in WIRES:
        for n in (BUCKET0, LENET_PARAMS):
            x = torch.randn((P, n), generator=gen, device=dev)
            k, pl = ops.ring_allreduce_quant(x, wire), ops.ring_allreduce_quant_plain(x, wire)
            same(k, pl, f"ring_allreduce_quant {wire} [8, {n}]")
            if n == BUCKET0:
                err[f"ring_allreduce_quant_{wire}"] = float((k - pl).abs().max())
            exact = x.double().sum(0)
            rel = float((k.double() - exact).abs().max() / exact.abs().max())
            require(rel < 2e-2, f"ring_allreduce_quant {wire} [8, {n}] off the sum by {rel}")
        x = torch.randn((P, P * 100674), generator=gen, device=dev)
        k, pl = ops.ring_reduce_scatter_quant(x, wire), ops.ring_reduce_scatter_quant_plain(x, wire)
        same(k, pl, f"ring_reduce_scatter_quant {wire} [8, 805392]")
        err[f"ring_reduce_scatter_quant_{wire}"] = float((k - pl).abs().max())
        for p in (2, 3, 8, 9, 16):
            for n in (1, 1000, 1002, 5000, 100003, 8 * 896 * 128 + 4099):
                if p > 8 and n > 100003:
                    continue
                both(torch.randn((p, n), generator=gen, device=dev), wire, f"p={p} n={n}")
                both_rs(torch.randn((p, p, n), generator=gen, device=dev), wire, f"p={p} seg={n}")
            # a view one float past an aligned start: 4-byte accesses
            view = torch.randn(p * 4096 + 1, generator=gen, device=dev)[1:].view(p, 4096)
            both(view, wire, f"p={p} misaligned view")
        # the C4 rows: the main paths' shapes, then small and p > 8
        for p, n in ((P, BUCKET0), (2, 5000), (3, 1002), (9, 5000)):
            mid = torch.from_numpy(wire_midpoint_rows(p, n, "allreduce", seed=p)).to(dev)
            both(mid, wire, f"midpoint rows p={p} n={n}")
        for p, seg in ((P, 100674), (2, 600), (3, 1001), (9, 600)):
            mid = torch.from_numpy(wire_midpoint_rows(p, seg, "rs", seed=p)).to(dev)
            both_rs(mid.view(p, p, seg), wire, f"midpoint rows p={p} seg={seg}")
        for p in (2, 3, 8, 9):
            both(halfway_rows(p, 5000, seed=p).to(dev), wire, f"halfway rows p={p}")
            both_rs(halfway_rows(p, p * 1024, seed=p).to(dev).view(p, p, 1024), wire,
                    f"halfway rows p={p}")
            for scale in (1e-31, 3e-30):
                tiny = torch.randn((p, 5000), generator=gen, device=dev) * scale
                both(tiny, wire, f"rows of size {scale} p={p}")
                both_rs(tiny[:, :p * 500].contiguous().view(p, p, 500), wire,
                        f"rows of size {scale} p={p}")
    # zeros and constant rows: the scale floor and exact codes
    z = torch.zeros((3, 5000), device=dev)
    z[1, 128:256] = 2.5
    zs = torch.zeros((3, 3, 1000), device=dev)
    zs[1, 2, 128:256] = 2.5
    for wire in WIRES:
        both(z, wire, "on zeros")
        both_rs(zs, wire, "on zeros")
    return err


def halfway_rows(p: int, n: int, seed: int) -> torch.Tensor:
    """``[p, n]`` f32 rows (made with numpy from ``seed``) whose int8
    quotients v / scale lie on or within two ulps of half-integers, where
    K4's encode takes the IEEE division: each 128-lane row holds its max m
    in its first lane and RN((k + 1/2) s) for random codes k, nudged by 0,
    1 or 2 ulps either way, in the others (s = RN(m RN(1/127)))."""
    rng = np.random.RandomState(seed)
    rows = -(-n // 128)
    m = np.exp(rng.uniform(-3.0, 3.0, (p, rows, 1))).astype(np.float32)
    s = (m * (np.float32(1) / np.float32(127))).astype(np.float64)
    v = ((rng.randint(-126, 126, (p, rows, 128)) + 0.5) * s).astype(np.float32)
    for _ in range(2):
        step = rng.choice([-np.inf, 0.0, np.inf], v.shape).astype(np.float32)
        v = np.where(step == 0, v, np.nextafter(v, step))
    v[:, :, 0] = m[:, :, 0]
    return torch.from_numpy(np.ascontiguousarray(v.reshape(p, -1)[:, :n]))


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
    1000 (b 1, h 2); d in {8, 16, 128} at p=3, n_local 200; d 64 at p=5,
    n_local 24 (under one key tile); then the LM path's shape
    [4, 4, 1024, 8, 64], causal, in f32 and in bf16 (the bf16 and remat
    sp LM's). Returns the main shape's max |kernel - plain| of each, the
    bf16 ones keyed ``name@lm_bf16``."""
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
    # fewer keys a block than one key tile
    for causal, dtype in itertools.product((False, True), (torch.float32, torch.bfloat16)):
        run((5, 1, 24, 2, 64), dtype, causal, f"p=5 causal={causal} {dtype} d=64 n_local=24")
    err.update(run(ATTN_MAIN, torch.float32, True, f"{list(ATTN_MAIN)} f32 causal"))
    err.update({f"{name}@lm_bf16": e for name, e in run(
        ATTN_MAIN, torch.bfloat16, True, f"{list(ATTN_MAIN)} bf16 causal").items()})
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


# the per-rank convolution weight gradient (ROADMAP C6's repair): the
# config-1 step's two convolutions under the engine's vmap (8 ranks of 42
# images), then ResNet-like and ragged shapes (R, B, C, H, W, O, k, stride,
# padding, dilation)
WGRAD_CONV1 = (P, BATCH // P, 32, 14, 14, 64, 5, 1, 2, 1)
WGRAD_SHAPES = (
    (P, BATCH // P, 1, 28, 28, 32, 5, 1, 2, 1),  # LeNet conv0
    WGRAD_CONV1,
    (2, 4, 3, 64, 64, 64, 7, 2, 3, 1),  # a ResNet stem
    (3, 2, 64, 14, 14, 128, 1, 2, 0, 1),  # a strided 1x1 projection
    (2, 3, 5, 9, 11, 70, 3, 1, 2, 2),  # ragged tiles, dilation 2
    (1, 1, 7, 5, 5, 3, 3, 1, 1, 1),  # one rank, one image
)
# |kernel - plain| against max |plain|: the f32 sums run in another order
# than cuDNN's (no TF32 on either side); a zeroed output reads 1
WGRAD_RTOL = 1e-5


def wgrad_inputs(shape, randn):
    """``(x, dy, weight shape, stride, padding, dilation)`` of a
    :data:`WGRAD_SHAPES` entry, drawn by ``randn``."""
    R, B, C, H, W, O, k, st, pd, dl = shape
    Ho = (H + 2 * pd - dl * (k - 1) - 1) // st + 1
    Wo = (W + 2 * pd - dl * (k - 1) - 1) // st + 1
    return randn(R, B, C, H, W), randn(R, B, O, Ho, Wo), (O, C, k, k), st, pd, dl


def wgrad_grouped(x, dy, wshape, stride, padding, dilation):
    """cuDNN's weight gradient of the same convolution as the engine's
    native vmap makes it: one grouped convolution, a group a rank."""
    R, B = x.shape[:2]
    O, C, kh, kw = wshape
    return torch.nn.grad.conv2d_weight(
        x.transpose(0, 1).reshape(B, R * C, *x.shape[3:]), (R * O, C, kh, kw),
        dy.transpose(0, 1).reshape(B, R * O, *dy.shape[3:]), stride, padding, dilation,
        groups=R).reshape(R, O, C, kh, kw)


def check_wgrad(dev, gen) -> dict:
    """The per-rank weight gradient (``ops.conv2d_weight_grad_ranks``)
    against its plain version on the card over :data:`WGRAD_SHAPES`,
    within :data:`WGRAD_RTOL` of max |plain|; at the config-1 shapes bit for
    bit the same rank's result in stacks of 8, 4 and 2 and on a second
    call. Returns max |kernel - plain| at ``conv1``'s shape."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    err, worst = {}, 0.0
    for shape in WGRAD_SHAPES:
        args = wgrad_inputs(shape, randn)
        k = ops.conv2d_weight_grad_ranks(*args)
        pl = ops.conv2d_weight_grad_ranks_plain(*args)
        torch.cuda.synchronize()
        scale = float(pl.abs().max())
        rel = float((k - pl).abs().max()) / scale
        worst = max(worst, rel)
        require(scale > 0 and rel <= WGRAD_RTOL,
                f"conv2d_weight_grad_ranks {shape}: |kernel - plain| / max|plain| = {rel}")
        if shape == WGRAD_CONV1:
            err["conv2d_weight_grad_ranks"] = float((k - pl).abs().max())
        if shape[0] == P:
            x, dy = args[:2]
            require(torch.equal(bits(k), bits(ops.conv2d_weight_grad_ranks(*args))),
                    f"conv2d_weight_grad_ranks {shape}: two calls differ")
            for m in (4, 2):
                parts = torch.cat([ops.conv2d_weight_grad_ranks(x[a:a + m], dy[a:a + m], *args[2:])
                                   for a in range(0, P, m)])
                require(torch.equal(bits(k), bits(parts)),
                        f"conv2d_weight_grad_ranks {shape}: stacks of {m} differ from one of {P}")
    print(f"wgrad: {len(WGRAD_SHAPES)} shapes within {WGRAD_RTOL} of max|plain| (worst {worst:.3e}); "
          f"config 1's bit for bit in stacks of {P}, 4 and 2")
    return err


def wgrad_row(randn) -> dict:
    """The kernels line's row of the per-rank weight gradient at config 1's
    ``conv1`` under the engine's vmap; its library call is cuDNN's grouped
    weight gradient, which the native vmap ran."""
    R, B, C, H, W, O, k = WGRAD_CONV1[:7]
    n_in = R * B * (C + O) * H * W  # x and dy: stride 1, 'same' padding
    return dict(
        name="conv2d_weight_grad_ranks", source="torchmpi_tpu_torch/csrc/conv_wgrad.cu",
        replaces="none: a port repair (ROADMAP C6); the JAX package takes this gradient "
                 "from XLA",
        shape=[R, B, C, H, W], make=lambda: wgrad_inputs(WGRAD_CONV1, randn),
        in_bytes=n_in * 4, bytes=(n_in + R * O * C * k * k) * 4,
        ops=2 * R * O * C * k * k * B * H * W,
        kernel=ops.conv2d_weight_grad_ranks, plain=ops.conv2d_weight_grad_ranks_plain,
        library=wgrad_grouped)


# the per-rank product (ROADMAP C6's repair) as the engine's vmap issues
# it: (R, M, K, N, a transposed, b transposed), a transposed operand a
# view of its [R, K, M] or [R, N, K] layout
BMM_LENET = (P, BATCH // P, 7 * 7 * 64, 256, False, True)  # LeNet dense0's forward, x @ W^T
BMM_SHAPES = (
    BMM_LENET,
    (P, 256, BATCH // P, 7 * 7 * 64, True, False),  # its weight gradient, dy^T @ x
    (P, BATCH // P, 256, 7 * 7 * 64, False, False),  # its input gradient, dy @ W
    (P, 8, 784, 128, False, True),  # config 5's dense0 forward
    (P, 128, 8, 784, True, False),  # its weight gradient
    (P, 8, 128, 128, False, False),  # a hidden layer's input gradient
    (3, 5, 37, 70, False, False),  # ragged tiles
)


def bmm_inputs(shape, randn):
    """``(a, b)`` of a :data:`BMM_SHAPES` entry, drawn by ``randn``."""
    R, M, K, N, a_t, b_t = shape
    a = randn(R, K, M).transpose(1, 2) if a_t else randn(R, M, K)
    b = randn(R, N, K).transpose(1, 2) if b_t else randn(R, K, N)
    return a, b


def check_bmm(dev, gen) -> dict:
    """The per-rank product (``ops.rank_bmm``) against its plain version on
    the card over :data:`BMM_SHAPES`, within :data:`WGRAD_RTOL` of max
    |plain|; at the shapes of 8 ranks bit for bit the same rank's result in
    stacks of 8, 4 and 2, contiguous, and on a second call. Returns max
    |kernel - plain| at :data:`BMM_LENET`."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    err, worst = {}, 0.0
    for shape in BMM_SHAPES:
        a, b = bmm_inputs(shape, randn)
        k, pl = ops.rank_bmm(a, b), ops.rank_bmm_plain(a, b)
        torch.cuda.synchronize()
        scale = float(pl.abs().max())
        rel = float((k - pl).abs().max()) / scale
        worst = max(worst, rel)
        require(scale > 0 and rel <= WGRAD_RTOL,
                f"rank_bmm {shape}: |kernel - plain| / max|plain| = {rel}")
        if shape == BMM_LENET:
            err["rank_bmm"] = float((k - pl).abs().max())
        if shape[0] == P:
            require(torch.equal(bits(k), bits(ops.rank_bmm(a, b))) and
                    torch.equal(bits(k), bits(ops.rank_bmm(a.contiguous(), b.contiguous()))),
                    f"rank_bmm {shape}: a second call, or the contiguous operands, differ")
            for m in (4, 2):
                parts = torch.cat([ops.rank_bmm(a[i:i + m], b[i:i + m]) for i in range(0, P, m)])
                require(torch.equal(bits(k), bits(parts)),
                        f"rank_bmm {shape}: stacks of {m} differ from one of {P}")
    print(f"rank_bmm: {len(BMM_SHAPES)} shapes within {WGRAD_RTOL} of max|plain| (worst "
          f"{worst:.3e}); bit for bit in stacks of {P}, 4 and 2 and at any strides")
    return err


def bmm_row(randn) -> dict:
    """The kernels line's row of the per-rank product at config 1's
    ``dense0`` forward under the engine's vmap; its library call is
    ``torch.bmm`` (cuBLAS's batched product, which the native vmap ran)."""
    R, M, K, N = BMM_LENET[:4]
    n_in = R * (M * K + K * N)
    return dict(
        name="rank_bmm", source="torchmpi_tpu_torch/csrc/rank_bmm.cu",
        replaces="none: a port repair (ROADMAP C6); the JAX package takes these products "
                 "from XLA",
        shape=[R, M, K, N], make=lambda: bmm_inputs(BMM_LENET, randn),
        in_bytes=n_in * 4, bytes=(n_in + R * M * N) * 4, ops=2 * R * M * N * K,
        kernel=ops.rank_bmm, plain=ops.rank_bmm_plain, library=torch.bmm)


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

    err.update(check_resnet_shapes(dev, gen))
    err.update(check_lm_shapes(dev, gen))
    err.update(check_many(dev, gen))
    err.update(check_scale(dev, gen))
    err.update(check_quant(dev, gen))
    err.update(check_phases(dev, gen))
    err.update(check_wgrad(dev, gen))
    err.update(check_bmm(dev, gen))
    print(f"kernels: all collective comparisons exact; main-path max|kernel - plain| = {err}")
    err.update(check_attention(dev, gen))
    return err


def check_resnet_shapes(dev, gen) -> dict:
    """K3, K1, K2 and K7 against their plain versions, bit for bit, at the
    ResNet path's shapes: its largest fused flush and largest async bucket
    (K3), its largest leaf's update and momentum trace (K1, K2 with alpha
    0.9), and its first parameter sync, every parameter in one broadcast
    (K7); and K3 'rs' and 'ag' at the sharded path's largest packed
    reduce-scatter flush and its packed parameter gather. Returns max
    |kernel - plain| of each, keyed ``name@resnet`` or ``name@fsdp``."""
    err = {}
    for what, n in (("", RESNET_FLUSH), ("_bucket", RESNET_BUCKET)):
        x = torch.randn((P, n), generator=gen, device=dev)
        k, pl = ops.ring_allreduce(x), ops.ring_allreduce_plain(x)
        require(torch.equal(bits(k), bits(pl)), f"ring_allreduce f32 [{P}, {n}] != plain")
        err[f"ring_allreduce@resnet{what}"] = float((k - pl).abs().max())
    a = torch.randn((P,) + RESNET_LARGEST_LEAF, generator=gen, device=dev)
    b = torch.randn((P,) + RESNET_LARGEST_LEAF, generator=gen, device=dev)
    for name, k, pl in (
        ("accumulate", ops.accumulate(a, b), ops.accumulate_plain(a, b)),
        ("scale_accumulate", ops.scale_accumulate(a, b, RESNET["momentum"]),
         ops.scale_accumulate_plain(a, b, RESNET["momentum"])),
    ):
        require(torch.equal(bits(k), bits(pl)), f"{name} [{P}, 512, 512, 3, 3] != plain")
        err[f"{name}@resnet"] = float((k - pl).abs().max())
    x = torch.randn((P, RESNET_PARAMS), generator=gen, device=dev)
    k, pl = ops.ring_broadcast(x, 0), ops.ring_broadcast_plain(x, 0)
    require(torch.equal(bits(k), bits(pl)), f"ring_broadcast [{P}, {RESNET_PARAMS}] != plain")
    err["ring_broadcast@resnet"] = float((k - pl).abs().max())
    # the sharded path: K3 'rs' at its largest packed flush, 'ag' at its
    # packed parameter shards
    for name, kernel, plain, n in (
        ("ring_reduce_scatter", ops.ring_reduce_scatter, ops.ring_reduce_scatter_plain, RESNET_FLUSH),
        ("ring_allgather", ops.ring_allgather, ops.ring_allgather_plain, RESNET_GATHER),
    ):
        x = torch.randn((P, n), generator=gen, device=dev)
        k, pl = kernel(x), plain(x)
        require(torch.equal(bits(k), bits(pl)), f"{name} [{P}, {n}] != plain")
        err[f"{name}@fsdp"] = float((k - pl).abs().max())
        del k, pl
    return err


def lm_engine_shapes() -> list:
    """The LM engine path's parameter shapes a rank (bench widths), in the
    order the engine submits their gradients: the model's."""
    with torch.device("meta"):
        model = LongContextTransformer(**LM_ENGINE, dtype=torch.bfloat16)
    return [tuple(v.shape) for v in model.parameters()]


def lm_engine_flushes() -> list:
    """The distinct sizes a rank of the LM engine path's fused gradient
    flushes that K3 sums (above ``small_allreduce_size_cuda``)."""
    cutoff = constants.get("small_allreduce_size_cuda")
    sizes = [math.prod(s) for s in lm_engine_shapes()]
    return sorted({n for n, _ in fusion_flushes(sizes) if n > cutoff})


def check_lm_shapes(dev, gen) -> dict:
    """K3, K7 and K1's list form against their plain versions, bit for bit,
    at the LM engine path's shapes (bench widths, p=8): K3 at every size
    of its fused gradient flushes, K7 at its first parameter sync (every
    parameter in one broadcast), and one K1 list call over its leaves (the
    Adam update), with the launches it counts. Returns max |kernel -
    plain| of each, keyed ``name@lm``."""
    err = {"ring_allreduce@lm": 0.0}
    flushes = lm_engine_flushes()
    for n in flushes:
        x = torch.randn((P, n), generator=gen, device=dev)
        k, pl = ops.ring_allreduce(x), ops.ring_allreduce_plain(x)
        require(torch.equal(bits(k), bits(pl)), f"ring_allreduce f32 [{P}, {n}] (LM flush) != plain")
        err["ring_allreduce@lm"] = max(err["ring_allreduce@lm"], float((k - pl).abs().max()))
    shapes = lm_engine_shapes()
    total = sum(math.prod(s) for s in shapes)
    x = torch.randn((P, total), generator=gen, device=dev)
    k, pl = ops.ring_broadcast(x, 0), ops.ring_broadcast_plain(x, 0)
    require(torch.equal(bits(k), bits(pl)), f"ring_broadcast [{P}, {total}] (LM sync) != plain")
    err["ring_broadcast@lm"] = float((k - pl).abs().max())
    del x, k, pl
    outs = [torch.randn((P,) + s, generator=gen, device=dev) for s in shapes]
    inps = [torch.randn((P,) + s, generator=gen, device=dev) for s in shapes]
    k, counts = counted(ops.accumulate_many, outs, inps)
    expect_launches(counts, "accumulate_many LM", accumulate=list_launches(len(shapes)))
    pl = ops.accumulate_many_plain(outs, inps)
    for i, (a, b) in enumerate(zip(k, pl)):
        require(torch.equal(bits(a), bits(b)), f"accumulate_many LM: leaf {i} != plain")
    err["accumulate_many@lm"] = max(float((a - b).abs().max()) for a, b in zip(k, pl))
    print(f"lm shapes: K3 at the LM engine's flushes {flushes}, K7 at [{P}, {total}] and K1 over "
          f"its {len(shapes)} leaves bit for bit equal to their plain versions")
    return err


def resnet_leaf_shapes() -> list:
    """ResNet-50's 161 parameter shapes, rank-stacked at p=8, in the order
    the engine holds them."""
    model = ResNet50(num_classes=RESNET["classes"], device="meta")
    return [(P,) + tuple(v.shape) for v in model.parameters()]


def list_launches(leaves: int) -> int:
    """The launches of one list-form call over ``leaves`` leaves of one
    dtype: ceil(leaves / leaves_per_launch)."""
    return -(-leaves // ops.reduce_kernel.leaves_per_launch())


def check_many(dev, gen) -> dict:
    """K1 and K2's list forms (``accumulate_many``, ``scale_accumulate_many``)
    against their plain versions, bit for bit: over ResNet-50's 161 leaves
    at p=8 (K1 out of place as the engine's update, K2 as its momentum
    trace, and K2 in place), with the launches each call counts; over a
    mixed list of 205 leaves (every dtype each kernel takes, one element,
    odd lengths, views at odd element offsets, empty leaves); and over the
    PS shard at an odd offset in place. Prints the table the build takes
    and the host time of one list call (``{"many_table"}``); returns max
    |kernel - plain| over the ResNet leaves."""
    rk = ops.reduce_kernel
    err = {}

    def same(k, pl, what):
        require(len(k) == len(pl), f"{what}: {len(k)} results, {len(pl)} plain")
        for i, (a, b) in enumerate(zip(k, pl)):
            require(a.dtype == b.dtype and a.shape == b.shape, f"{what}: leaf {i} shape/dtype")
            require(torch.equal(bits(a), bits(b)), f"{what}: leaf {i} != plain")

    def counted(fn, name, want, what):
        before = ops.launch_counts()[name]
        out = fn()
        torch.cuda.synchronize()
        got = ops.launch_counts()[name] - before
        require(got == want, f"{what}: {got} launches, want {want}")
        return out

    shapes = resnet_leaf_shapes()
    outs = [torch.randn(sh, generator=gen, device=dev) for sh in shapes]
    inps = [torch.randn(sh, generator=gen, device=dev) for sh in shapes]
    momentum = RESNET["momentum"]
    k = counted(lambda: ops.accumulate_many(outs, inps), "accumulate",
                list_launches(len(shapes)), "accumulate_many ResNet-50")
    plain = ops.accumulate_many_plain(outs, inps)
    same(k, plain, "accumulate_many ResNet-50")
    err["accumulate_many@resnet"] = max(float((a - b).abs().max()) for a, b in zip(k, plain))
    del k, plain
    k = counted(lambda: ops.scale_accumulate_many(inps, outs, momentum), "scale_accumulate",
                list_launches(len(shapes)), "scale_accumulate_many ResNet-50")
    plain = ops.scale_accumulate_many_plain(inps, outs, momentum)
    same(k, plain, "scale_accumulate_many ResNet-50")
    err["scale_accumulate_many@resnet"] = max(float((a - b).abs().max()) for a, b in zip(k, plain))
    del k
    ops.scale_accumulate_many(inps, outs, momentum, out_=inps)
    same(inps, plain, "scale_accumulate_many ResNet-50 in place")
    del plain
    # the mixed lists: K1's and K2's dtypes, ragged and misaligned leaves
    for dtypes, name in (((torch.float32, torch.bfloat16, torch.float16, torch.int32,
                           torch.int8, torch.uint8), "accumulate"),
                         ((torch.float32, torch.float64, torch.bfloat16, torch.float16),
                          "scale_accumulate")):
        a_list, b_list = [], []
        for i in range(205):
            dtype, n, off = dtypes[i % len(dtypes)], (1, 7, 0, 1000, 100003, 64)[i % 6], i % 3
            base_a, base_b = rand((n + 3,), dtype, gen, dev), rand((n + 3,), dtype, gen, dev)
            a_list.append(base_a[off:off + n])
            b_list.append(base_b[(i % 5) % 3:(i % 5) % 3 + n])
        if name == "accumulate":
            want = ops.accumulate_many_plain(a_list, b_list)
            same(ops.accumulate_many(a_list, b_list), want, "accumulate_many mixed")
            dst = [x.clone() for x in a_list]
            ops.accumulate_many(dst, b_list, out_=dst)
            same(dst, want, "accumulate_many mixed in place")
        else:
            for alpha in SCALE_ALPHAS:
                same(ops.scale_accumulate_many(a_list, b_list, alpha),
                     ops.scale_accumulate_many_plain(a_list, b_list, alpha),
                     f"scale_accumulate_many mixed alpha={alpha}")
    shard = torch.randn(SHARD + 1, generator=gen, device=dev)[1:]
    shard_in = torch.randn(SHARD, generator=gen, device=dev)
    want = ops.scale_accumulate_plain(shard, shard_in, -LR)
    counted(lambda: ops.scale_accumulate(shard, shard_in, -LR, out_=shard),
            "scale_accumulate", 1, "scale_accumulate PS shard")
    same([shard], [want], "scale_accumulate PS shard at offset 1")
    # the host's side of one list call over the 161 leaves (checks, outputs,
    # table, launch) beside _foreach_add's: medians of 100 calls
    host = {"accumulate_many_us": host_us(lambda: ops.accumulate_many(outs, inps)),
            "foreach_add_us": host_us(lambda: torch._foreach_add(outs, inps))}
    print(json.dumps({"many_table": {
        "leaves_per_launch": rk.leaves_per_launch(), "table_bytes": rk.table_bytes(),
        "resnet_launches": list_launches(len(shapes)), "host": host}}))
    print(f"accumulate_many / scale_accumulate_many: bit for bit equal to their plain versions "
          f"over ResNet-50's {len(shapes)} leaves, mixed lists of 205 leaves and the PS shard")
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


# the main path's gradient check: along its first steps, each leaf of the
# engine's gradient through the per-rank kernels within this share of its
# max |plain| of the same engine's gradient with the kernels' plain
# versions at the same parameters (the same forward: LeNet's max pools
# route the gradient by the forward's argmax, so a gradient with another
# forward's rounding, a per-rank loop's or f64's, parts at near ties by
# up to 7e-3 of a convolution's max)
MAIN_GRAD_STEPS, MAIN_GRAD_RTOL = 3, 1e-4


@contextlib.contextmanager
def plain_rank_products():
    """The engine's vmap on the card with the per-rank kernels' plain
    versions in their place (``engine/rankwise.py`` calls them through
    ``ops``)."""
    kept = ops.conv2d_weight_grad_ranks, ops.rank_bmm
    ops.conv2d_weight_grad_ranks = ops.conv2d_weight_grad_ranks_plain
    ops.rank_bmm = ops.rank_bmm_plain
    try:
        yield
    finally:
        ops.conv2d_weight_grad_ranks, ops.rank_bmm = kept


def main_path_gradient(dev) -> dict:
    """The main path's engine (LeNet, p=8, batch 336, lr 0.2, the vmap
    with the per-rank kernels) over its first :data:`MAIN_GRAD_STEPS`
    batches: at each step its gradient against the same engine's with the
    kernels' plain versions (:func:`plain_rank_products`) at the same
    parameters, each leaf within :data:`MAIN_GRAD_RTOL` of its max |plain|;
    then the engine steps as the main path does. It catches a broken
    gradient that the spike-prone losses of lr 0.2 would not show."""
    (xtr, ytr), _ = synthetic_mnist()
    model = LeNet()
    it = DistributedIterator(xtr, ytr, BATCH, P, device=dev)
    batches = [b for _, b in zip(range(MAIN_GRAD_STEPS), iter(it))]
    dist, far = {}, []
    mpi.start(ranks=P)
    try:
        engine = AllReduceSGDEngine(make_loss_fn(model), init_params(model, seed=0), lr=LR,
                                    comm=mpi.current_communicator())
        for step, b in enumerate(batches):
            got = engine._grad_fn(engine.params, b)[0]
            with plain_rank_products():
                want = engine._grad_fn(engine.params, b)[0]
            torch.cuda.synchronize()
            for k, w in want.items():
                rel = float((got[k] - w).abs().max()) / float(w.abs().max())
                dist[k] = max(dist.get(k, 0.0), rel)
                if not rel <= MAIN_GRAD_RTOL:
                    far.append(f"step {step + 1} {k}: {rel:.3e}")
            engine.step(b)
        torch.cuda.synchronize()
    finally:
        mpi.stop()
    require(not far, f"main path: the gradient through the per-rank kernels parts from the "
                     f"plain versions' (of max|plain|): {far}")
    print(f"trainer: the main path's first {MAIN_GRAD_STEPS} steps' gradients through the "
          f"per-rank kernels within {max(dist.values()):.3e} of max|plain| of their plain "
          f"versions' (each leaf's largest: {dist})")
    return dist


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
    # LeNet at lr 0.2 spikes at steps that move with the rounding (the JAX
    # engine too), so a spike in the last steps says nothing of whether it
    # learns: the gate is the second epoch's mean, as runs (a)-(d) of
    # --multiprocess take it
    first, mean = losses[0], sum(losses[len(it):]) / (len(losses) - len(it))
    require(mean < first, f"{mode}/{wire}: loss did not fall: first step {first:.4f}, second "
                          f"epoch's mean {mean:.4f} ({losses})")
    final = {k: v[0] for k, v in params.items()}
    x_test = torch.as_tensor(xte, device=dev)
    logits = torch.func.functional_call(model, final, (x_test,))
    require(tuple(logits.shape) == (len(xte), 10) and bool(torch.isfinite(logits).all()),
            f"{mode}/{wire}: test logits malformed")
    acc = float(accuracy(logits, torch.as_tensor(yte, device=dev)))
    steady = len(it) * BATCH / epoch_t[1]
    print(
        f"trainer: MNIST LeNet {mode} wire={wire} p={P} batch={BATCH} lr={LR}: {steps} steps, "
        f"loss {first:.4f} -> {mean:.4f} (the second epoch's mean; epoch ends "
        f"{state['losses']}), test_acc={acc:.4f}, "
        f"max replica spread max|params[r] - params[0]| = {spread!r}, launches {counts}"
    )
    print(
        f"samples/sec/chip ({mode}, wire {wire}): {steady:.1f} (second epoch; both epochs "
        f"with warm-up: {state['samples'] / state['time']:.1f}; {P} virtual ranks on 1 card)"
    )
    return {"counts": counts, "steps": steps, "spread": spread, "samples_per_s": steady,
            "tree_broadcasts": len(tree), "final_loss": state["losses"][-1], "test_acc": acc}


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
    main_path_gradient(dev)

    sync = main_path(dev, "sync", "full")
    c, steps = sync["counts"], sync["steps"]
    require(c["ring_allreduce"] == steps,
            f"sync: ring_allreduce launched {c['ring_allreduce']} times in {steps} steps")
    # the first weight sync, 3.4 MB per rank, is at most
    # broadcast_size_tree_based_cuda (4 MiB): the binomial tree, not K7
    require(sync["tree_broadcasts"] >= 1 and c["ring_broadcast"] == 0,
            f"sync: weight broadcast took {sync['tree_broadcasts']} trees, "
            f"{c['ring_broadcast']} K7 launches")
    require(c["accumulate"] == steps * list_launches(LENET_LEAVES),
            f"sync: accumulate launched {c['accumulate']} times in {steps} steps, want "
            f"{list_launches(LENET_LEAVES)} a step")
    require(c["scale_accumulate"] == 0, "sync: scale_accumulate launched without a momentum")
    require(c["conv2d_weight_grad_ranks"] == LENET_CONVS * steps,
            f"sync: the per-rank weight gradient launched {c['conv2d_weight_grad_ranks']} times "
            f"in {steps} steps, want {LENET_CONVS} a step")
    require(c["rank_bmm"] == LENET_PRODUCTS * steps,
            f"sync: the per-rank product launched {c['rank_bmm']} times in {steps} steps, want "
            f"{LENET_PRODUCTS} a step")
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
    require(c["accumulate"] == steps * list_launches(LENET_LEAVES),
            f"async int8: accumulate launched {c['accumulate']} times in {steps} steps, want "
            f"{list_launches(LENET_LEAVES)} a step")
    require(c["conv2d_weight_grad_ranks"] == LENET_CONVS * steps,
            f"async int8: the per-rank weight gradient launched "
            f"{c['conv2d_weight_grad_ranks']} times in {steps} steps")
    require(c["rank_bmm"] == LENET_PRODUCTS * steps,
            f"async int8: the per-rank product launched {c['rank_bmm']} times in {steps} steps")
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


def expect_launches(counts: dict, what: str, **launched) -> None:
    """Every launch count 0 but ``launched``, which must be exact."""
    want = {name: 0 for name in counts}
    want.update(launched)
    require(counts == want, f"{what}: launches {counts} != {want}")


def lm_run(dev, widths: dict, seq: int, batch: int, lr: float, steps: int, backend: str,
           **model_kw) -> dict:
    """Train a fresh LM (seed 0) for ``steps`` steps of the example's step
    over ``LM_SP`` sequence shards: every launch count set to 0 just before
    and read just after. Tokens/sec/chip over the steps after the first.
    ``model_kw``: the model's ``dtype`` and ``remat``."""
    model = LongContextTransformer(**widths, sp_backend=backend, **model_kw).to(dev)
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

    full = lm_run(dev, LM_WIDTHS, LM_SEQ, LM_BATCH, LM_LR, LM_STEPS, "kernel_full")
    losses = full["losses"]
    expect_launches(full["counts"], "LM kernel_full", ring_attention_fwd=layers * LM_STEPS,
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
             "tflops": achieved / 1e12, "mfu_f32": frac, "losses": losses}
    for backend, launched in (
        ("kernel_bidir_full", dict(ring_attention_fwd_bidir=layers * LM_CHECK_STEPS,
                                   ring_attention_bwd=2 * layers * LM_CHECK_STEPS)),
        ("xla", {}),
    ):
        run = lm_run(dev, LM_WIDTHS, LM_SEQ, LM_BATCH, LM_LR, LM_CHECK_STEPS, backend)
        expect_launches(run["counts"], f"LM {backend}", **launched)
        for a, b in zip(run["losses"], losses):
            require(abs(a - b) <= 1e-3 * abs(b), f"LM {backend}: loss {a} vs kernel_full {b}")
        print(f"lm: {backend} {LM_CHECK_STEPS} steps match kernel_full's (losses {run['losses']}); "
              f"tokens/sec/chip {run['tokens_per_s']:.1f}, peak memory {run['peak_gb']:.2f} GB")
        runs[f"lm_{backend}"] = run["counts"]
    return runs, stats


def counted(fn, *args, **kw):
    """``fn(*args, **kw)`` with every launch count set to 0 just before and
    read just after: ``(result, counts)``."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = fn(*args, **kw)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, ops.launch_counts()


def moe_step(device) -> tuple:
    """One MoE step at ``__graft_entry__.py:539-579``'s widths: ep 8, d 8, 6
    tokens a rank, top-2, capacity 2T; the loss ``sum(y^2) + 0.01 aux``
    each rank, SGD 0.1 on the experts. Returns (losses [p], new weights)."""
    from torchmpi_tpu_torch.parallel import make_parallel_mesh, moe_dispatch_combine, moe_load_stats

    p, d, T = P, MOE["d"], MOE["T"]
    rng = np.random.RandomState(0)
    w = torch.as_tensor(rng.randn(p, d, d).astype(np.float32) * 0.3, device=device)
    x = torch.as_tensor(rng.randn(p, T, d).astype(np.float32), device=device)
    logits = torch.as_tensor(rng.randn(p, T, p).astype(np.float32), device=device)
    layout = make_parallel_mesh(p, {"ep": p})
    w.requires_grad_()
    y = moe_dispatch_combine(x, logits, lambda ww, tk: torch.bmm(tk, ww), w, layout,
                             capacity=2 * T, top_k=MOE["top_k"])
    _, aux = moe_load_stats(logits, layout, top_k=MOE["top_k"])
    lanes = (y ** 2).sum((1, 2)) + 0.01 * aux
    (g,) = torch.autograd.grad(lanes.sum(), w)
    return lanes.detach(), (w - 0.1 * g).detach()


def cube_step(device) -> tuple:
    """One dp 2 x pp 2 x tp 2 step of ``__graft_entry__.py:480-537``: GPipe
    stages whose contraction is tensor-parallel (a psum over tp in every
    stage), 2 microbatches of 2, the stage gradients averaged over dp, SGD
    0.1. Returns (losses [p], new weights)."""
    from torchmpi_tpu_torch.models import axis_stack_from_jax
    from torchmpi_tpu_torch.parallel import axis_psum, make_parallel_mesh, pipeline_loss_fn
    from torchmpi_tpu_torch.parallel import shard_input_features

    k, m, mb = CUBE["k"], CUBE["m"], CUBE["mb"]
    layout = make_parallel_mesh(P, {"dp": 2, "pp": 2, "tp": P // 4})
    tp = layout.size("tp")
    d = k * tp
    rng = np.random.RandomState(0)
    W = axis_stack_from_jax(rng.randn(2, tp, k, d).astype(np.float32) * 0.3, layout,
                            ("pp", "tp")).to(device)
    x = axis_stack_from_jax(rng.randn(2, m, mb, d).astype(np.float32), layout, "dp").to(device)
    t = axis_stack_from_jax(rng.randn(2, m, mb, d).astype(np.float32), layout, "dp").to(device)

    def stage(w, xmb):
        return torch.tanh(axis_psum(torch.bmm(shard_input_features(xmb, layout), w), layout,
                                    "tp"))

    loss_fn = pipeline_loss_fn(stage, lambda o, tt: ((o - tt) ** 2).flatten(1).mean(1), layout)
    W.requires_grad_()
    lanes = loss_fn(W, x, t)
    (g,) = torch.autograd.grad(lanes.sum(), W)
    g = mpinn.in_graph_synchronize_gradients({"w": g}, layout, "dp")["w"]
    return lanes.detach(), (W - 0.1 * g).detach()


def lm_engine_expected(num_leaves: int, sizes: list, steps: int) -> dict:
    """The LM engine run's launches: the first sync one fused broadcast (K7
    above the tree cutoff); a step one K3 per fusion flush above
    ``small_allreduce_size_cuda`` (the gradients, f32, in the parameters'
    order) and the update one K1 list call (Adam itself is plain torch)."""
    cutoff = constants.get("small_allreduce_size_cuda")
    k3 = sum(n > cutoff for n, _ in fusion_flushes(sizes))
    total = sum(sizes)
    k7 = int(total > constants.get("small_broadcast_size_cuda")
             and total * 4 > constants.get("broadcast_size_tree_based_cuda"))
    return {"ring_allreduce": k3 * steps, "ring_broadcast": k7,
            "accumulate": list_launches(num_leaves) * steps}


def lm_bf16(dev, f32_losses=None) -> tuple:
    """The sp LM in bf16, without and with remat (K8 once or twice a layer
    and step, K10 2 launches a layer and step either way), against f32
    (``f32_losses``, else an f32 run of its own): the loss falls, each step
    within ``LM_BF16_RTOL`` of f32, remat within 1e-5 of no remat. Returns
    each run's launch counts and the ``{"parallel"}`` line's entries."""
    layers = LM_WIDTHS["num_layers"]
    if f32_losses is None:
        f32_losses = lm_run(dev, LM_WIDTHS, LM_SEQ, LM_BATCH, LM_LR, LM_CHECK_STEPS,
                            "kernel_full")["losses"]
    runs, line, bf16 = {}, {}, {}
    for remat in (False, True):
        run = lm_run(dev, LM_WIDTHS, LM_SEQ, LM_BATCH, LM_LR, LM_CHECK_STEPS, "kernel_full",
                     dtype=torch.bfloat16, remat=remat)
        what = "LM bf16" + (" remat" if remat else "")
        expect_launches(run["counts"], what,
                        ring_attention_fwd=(2 if remat else 1) * layers * LM_CHECK_STEPS,
                        ring_attention_bwd=2 * layers * LM_CHECK_STEPS)
        losses = run["losses"]
        require(losses[-1] < losses[0], f"{what}: loss did not fall {losses}")
        for u, v in zip(losses, f32_losses):
            require(abs(u - v) <= LM_BF16_RTOL * abs(v), f"{what}: loss {u} vs f32 {v}")
        runs["lm_bf16" + ("_remat" if remat else "")] = run["counts"]
        bf16[remat] = run
        line[what.replace(" ", "_")] = {k: run[k] for k in ("losses", "tokens_per_s", "step_ms",
                                                            "peak_gb")}
    for u, v in zip(bf16[True]["losses"], bf16[False]["losses"]):
        require(abs(u - v) <= 1e-5 * abs(v), f"LM bf16 remat: loss {u} vs {v} without remat")
    line["lm_bf16_remat_equal_bits"] = bf16[True]["losses"] == bf16[False]["losses"]
    line["lm_f32_losses"] = f32_losses[:LM_CHECK_STEPS]
    return runs, line


def phase_parallel(dev, f32_losses=None) -> dict:
    """Tensor, pipeline and expert parallelism and the LM's bf16, remat and
    engine paths (see the module docstring); every K3 count exact. Returns
    each path's launch counts."""
    from torchmpi_tpu_torch.examples import mnist_modelparallel, pipeline_stages

    runs, line = {}, {"card": card()}
    device = ["--device", str(dev)]

    # tensor parallelism: the twin small on the card and the CPU, then at
    # its defaults (dp 2 x tp 4, 72 steps): a step one K3 in the forward,
    # one in the backward, 3 for the dp mean and 2 for the head's tp mean;
    # the evaluation one
    small = ["--train", "1344", "--test", "256", "--epochs", "1"]
    a = mnist_modelparallel.main(device + small)
    b = mnist_modelparallel.main(["--device", "cpu"] + small)
    for u, v in zip(a["losses"], b["losses"]):
        require(abs(u - v) <= 1e-4 * abs(v), f"tp twin: loss {u} vs CPU {v}")
    tp, counts = counted(mnist_modelparallel.main, device)
    expect_launches(counts, "tp twin", ring_allreduce=7 * tp["steps"] + 1)
    require(tp["losses"][-1] < tp["losses"][0], f"tp twin: loss did not fall {tp['losses']}")
    runs["parallel_tp"] = counts
    line["tp"] = {k: tp[k] for k in ("losses", "acc", "steps", "samples_per_s")}

    # pipeline parallelism: both schedules small against the CPU, then at the
    # defaults (dp 2 x pp 4, 64 steps): a step one K3 for the loss over pp,
    # one for the dp mean of the stage gradients
    for schedule in ("gpipe", "1f1b"):
        small = ["--schedule", schedule, "--epochs", "2"]
        a = pipeline_stages.main(device + small)
        b = pipeline_stages.main(["--device", "cpu"] + small)
        for u, v in zip(a["losses"], b["losses"]):
            require(abs(u - v) <= 1e-4 * abs(v), f"pipeline {schedule}: loss {u} vs CPU {v}")
        run, counts = counted(pipeline_stages.main, device + ["--schedule", schedule])
        expect_launches(counts, f"pipeline {schedule}", ring_allreduce=2 * run["steps"])
        runs[f"parallel_pp_{schedule}"] = counts
        line[f"pp_{schedule}"] = {k: run[k] for k in ("losses", "steps", "microbatches_per_s")}

    # one MoE step (3 K3: the route counts, int32, and the two gate means)
    # and one 3-D step (3 ticks' tp psums forward and back, the loss over pp,
    # the dp mean: 8 K3), each against the CPU
    for name, step, k3 in (("moe", moe_step, 3), ("cube", cube_step, 8)):
        (lanes, w), counts = counted(step, dev)
        cpu_lanes, cpu_w = step(torch.device("cpu"))
        require(torch.allclose(lanes.cpu(), cpu_lanes, rtol=1e-5, atol=1e-5),
                f"{name}: losses {lanes.tolist()} vs CPU {cpu_lanes.tolist()}")
        err = float((w.cpu() - cpu_w).abs().max())
        require(err <= 1e-5, f"{name}: weights differ from the CPU by {err}")
        require(bool(torch.isfinite(lanes).all()), f"{name}: non-finite loss")
        expect_launches(counts, name, ring_allreduce=k3)
        runs[f"parallel_{name}"] = counts
        line[name] = {"loss": float(lanes.mean()), "max_abs_err_vs_cpu": err}

    bf16_runs, bf16_line = lm_bf16(dev, f32_losses)
    runs.update(bf16_runs)
    line.update(bf16_line)

    # the LM through the engine at bench.py's chip widths, bf16, 8 ranks x 8
    # sequences of 1024, two epochs of 4 steps
    from torchmpi_tpu_torch.examples.long_context import engine_run

    mpi.start(ranks=P, device=dev)
    try:
        comm = mpi.current_communicator()
        model = LongContextTransformer(**LM_ENGINE, dtype=torch.bfloat16)
        sizes = [v.numel() for v in model.parameters()]
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        (run, engine), counts = counted(engine_run, model, comm, **LM_ENGINE_RUN)
        peak = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
        if dev.type == "cuda":
            # where a step's time goes: two profiled steps on the first batch
            x, y = synthetic_tokens(P * LM_ENGINE_RUN["per_rank"], LM_ENGINE_RUN["seq"],
                                    LM_ENGINE["vocab_size"])
            line["lm_engine_profile"] = resnet_profile(
                engine, (x, y), 2, f"LM engine, bench widths, bf16, p={P}")["split_us_per_step"]
    finally:
        mpi.stop()
    expect_launches(counts, "LM engine",
                    **lm_engine_expected(len(sizes), sizes, run["steps"]))
    require(run["losses"][-1] < run["losses"][0], f"LM engine: loss did not fall {run['losses']}")
    runs["lm_engine"] = counts
    line["lm_engine"] = {**{k: run[k] for k in ("losses", "steps", "tokens_per_s", "step_ms")},
                         "params_per_rank": sum(sizes), "peak_gb": peak,
                         "widths": LM_ENGINE, **LM_ENGINE_RUN}
    print(f"lm engine: {LM_ENGINE}, bf16, {P} ranks x {LM_ENGINE_RUN['per_rank']} sequences of "
          f"{LM_ENGINE_RUN['seq']}: tokens/sec/chip {run['tokens_per_s']:.1f}, "
          f"{run['step_ms']:.2f} ms a step, peak {peak} GB, losses {run['losses']} ({card()})")
    print(json.dumps({"parallel": line}))
    return runs


def resnet_expected(engine, steps: int) -> dict:
    """The kernel launches one ResNet run of ``steps`` steps routes, from the
    parameters' sizes (in the order the gradients are submitted) and the
    routing constants: the first parameter sync, one fused broadcast, runs
    K7 above the tree cutoff; every step runs the momentum trace (K2) and
    the update (K1) as one list call each over the leaves,
    :func:`list_launches` launches each, and K3 once per gradient collective
    above ``small_allreduce_size_cuda``: in sync mode each flush of the
    fusion buffer (it flushes once ``fusion_buffer_bytes`` are pending, and
    the rest when waited), in async mode each bucket. The statistics'
    average (one fused allreduce of 53,120 floats a rank) and any smaller
    flush take the vendor path. Every other kernel: 0."""
    cutoff = constants.get("small_allreduce_size_cuda")
    sizes = [v[0].numel() for v in engine.params.values()]
    if engine.mode == "sync":
        cap = constants.get("fusion_buffer_bytes") // 4
        flushes, pending = [], 0
        for n in sizes:
            pending += n
            if pending >= cap:
                flushes, pending = flushes + [pending], 0
        flushes += [pending] if pending else []
    else:
        flushes = [sum(engine.buckets.sizes[i] for i in b) for b in engine.buckets.buckets]
    stats = sum(v[0].numel() for v in engine.model_state.values())
    k3 = sum(n > cutoff for n in flushes) + (stats > cutoff)
    total = sum(sizes)
    k7 = int(total > constants.get("small_broadcast_size_cuda")
             and total * 4 > constants.get("broadcast_size_tree_based_cuda"))
    want = {name: 0 for name in ops.launch_counts()}
    k12 = list_launches(len(sizes))
    want.update(ring_allreduce=k3 * steps, ring_broadcast=k7, accumulate=k12 * steps,
                scale_accumulate=k12 * steps)
    return {"counts": want, "k3_per_step": k3, "flushes": flushes}


def resnet_engine(model, comm, mode: str, rank_map: str = "loop"):
    """The example's engine: momentum SGD, the batch statistics as model
    state, four buckets in async mode; parameters from seed 0."""
    params, stats = init_resnet(model, RESNET["image"], seed=0)
    return AllReduceSGDEngine(
        make_stateful_loss_fn(model), params, comm=comm, mode=mode, num_buckets=RESNET["buckets"],
        optimizer=SGD(RESNET["lr"], momentum=RESNET["momentum"]), model_state=stats,
        rank_map=rank_map)


def resnet_batch(data, p: int, per_rank: int, dev):
    """The first ``p * per_rank`` training images as one rank-stacked batch."""
    (x, y), _ = data
    n = p * per_rank
    return (torch.as_tensor(x[:n]).to(dev).reshape((p, per_rank) + x.shape[1:]),
            torch.as_tensor(y[:n]).to(dev, torch.int64).reshape(p, per_rank))


def resnet_small(dev, mode: str) -> tuple:
    """Three steps of a narrow ResNet at 32 px, p=4, from one init: the
    losses, then the parameters, traces and statistics of rank 0."""
    mpi.start(ranks=4, device=dev)
    try:
        comm = mpi.current_communicator()
        engine = resnet_engine(ResNet(**RESNET_SMALL), comm, mode)
        (x, y), _ = synthetic_imagenet(num_train=3 * 4 * 8, num_test=1, num_classes=10,
                                       image_size=32)
        x = torch.as_tensor(x).reshape(3, 4, 8, 32, 32, 3)
        y = torch.as_tensor(y).long().reshape(3, 4, 8)
        losses = [float(engine.step((x[i].to(dev), y[i].to(dev)))) for i in range(3)]
        trees = {"params": engine.params, "trace": engine.opt_state, "stats": engine.model_state}
        return losses, {f"{t}.{k}": v[0].cpu() for t, tree in trees.items() for k, v in tree.items()}
    finally:
        mpi.stop()


def rank_map_step_ms(make_engine, batches: list, warmup: int) -> dict:
    """Both per-rank gradient forms' (``rank_map`` 'vmap', the engine's on
    the card with the per-rank kernels, and 'loop') mean step time over
    ``batches[warmup:]`` after ``batches[:warmup]``, and peak memory;
    ``make_engine(comm, rank_map)`` builds the engine."""
    out = {}
    for form in ("vmap", "loop"):
        mpi.start(ranks=P)
        try:
            engine = make_engine(mpi.current_communicator(), form)
            torch.cuda.reset_peak_memory_stats()
            for b in batches[:warmup]:
                engine.step(b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in batches[warmup:]:
                engine.step(b)
            torch.cuda.synchronize()
            out[form] = {"step_ms": (time.perf_counter() - t0) / (len(batches) - warmup) * 1e3,
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            del engine
        finally:
            mpi.stop()
        torch.cuda.empty_cache()
    return out


# config 1's vmap step with the per-rank kernels against the native form:
# pairs of runs in turns, each this many steps after 4
RANK_MAP_TURNS, RANK_MAP_TURN_STEPS = 5, 100


def rank_maps(dev, data) -> dict:
    """Both per-rank gradient forms on ResNet-50 at full width (sync,
    ``RESNET_TIMED_STEPS`` steps after one) and on the MNIST path's LeNet
    (p=8, batch 336, 20 steps after 4); then LeNet's vmap step against its
    native form (cuDNN's grouped weight gradient, cuBLAS's batched
    products) in :data:`RANK_MAP_TURNS` pairs of runs in turns
    (``chip_vmap_probe.step_in_turns``)."""
    from chip_vmap_probe import step_in_turns

    batch = resnet_batch(data, P, RESNET["per_rank"], dev)
    resnet = rank_map_step_ms(
        lambda comm, rank_map: resnet_engine(ResNet50(num_classes=RESNET["classes"], device=dev),
                                             comm, "sync", rank_map),
        [batch] * (1 + RESNET_TIMED_STEPS), 1)
    (xtr, ytr), _ = synthetic_mnist()
    it = DistributedIterator(xtr, ytr, BATCH, P, device=dev)
    batches = [b for _, b in zip(range(24), iter(it))]

    def lenet(comm, rank_map="vmap"):
        return AllReduceSGDEngine(make_loss_fn(LeNet()), init_params(LeNet(), seed=0), lr=LR,
                                  comm=comm, rank_map=rank_map)

    forms = rank_map_step_ms(lenet, batches, 4)
    turns = step_in_turns(lenet, [batches[i % len(batches)] for i in range(4 + RANK_MAP_TURN_STEPS)],
                          4, RANK_MAP_TURNS)
    print(f"rank_map: ResNet-50 at full width (sync) {resnet}; MNIST LeNet (sync) {forms}; "
          f"LeNet's vmap with the per-rank kernels against the native form in turns {turns}")
    return {"resnet50": resnet, "mnist_lenet": forms, "mnist_lenet_vmap_turns": turns}


def kernel_class(name: str) -> str:
    """The class of a device kernel by its name, for the ResNet and LM engine splits."""
    if "ring_allreduce_kernel" in name:
        return "K3 ring_allreduce"
    if "ring_reduce_scatter_kernel" in name:
        return "K3 ring_reduce_scatter"
    if "ring_broadcast_kernel" in name:
        return "K3 ring_allgather or K7 (the byte-copy ring)"
    if "tmpi::many_" in name:
        return "K2 scale_accumulate" if "Scale" in name else "K1 accumulate"
    if "tmpi::" in name:
        return "other port kernels"
    low = name.lower()
    if "softmax" in low:
        return "softmax"
    if any(t in low for t in ("conv", "cudnn", "xmma", "dgrad", "wgrad", "winograd", "gemm",
                              "cutlass")):
        return "cuDNN conv and cuBLAS"
    return "other"


def resnet_path(dev, data, mode: str, profile_steps: int = 0) -> dict:
    """Drive the ResNet path at full width: ``train_resident`` for
    ``RESNET['epochs']`` epochs, every launch count set to 0 just before the
    engine is built (its parameter sync is on the path) and read just after
    training; then, outside the counted run, the replica checks, the test
    accuracy, the async buckets against blocking allreduces (async), and a
    ``profile_steps``-step profile (if asked)."""
    (xtr, ytr), (xte, yte) = data
    model = ResNet50(num_classes=RESNET["classes"], device=dev)
    out = {}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    mpi.start(ranks=P)
    try:
        comm = mpi.current_communicator()
        engine = resnet_engine(model, comm, mode)
        state = engine.train_resident(xtr, ytr, RESNET["per_rank"], max_epochs=RESNET["epochs"])
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        expected = resnet_expected(engine, state["t"])
        require(counts == expected["counts"],
                f"ResNet {mode}: launches {counts} != {expected['counts']}")
        require(sum(v.numel() for v in engine.params.values()) == P * RESNET_PARAMS
                and len(engine.params) == RESNET_LEAVES
                and sum(v.numel() for v in engine.model_state.values()) == P * RESNET_STATS,
                f"ResNet {mode}: not ResNet-50's widths")
        losses = state["losses"]
        require(all(np.isfinite(losses)) and np.isfinite(state["loss"]),
                f"ResNet {mode}: non-finite loss {losses}")
        require(losses[-1] < losses[0], f"ResNet {mode}: loss did not fall: epochs {losses}")
        mpinn.check_with_allreduce(engine.params, comm)
        mpinn.check_with_allreduce(engine.model_state, comm)
        acc = engine.evaluate(make_eval_fn(model), xte, yte, accuracy)
        require(0.0 <= acc <= 1.0, f"ResNet {mode}: test accuracy {acc}")
        if mode == "async":
            resnet_async_buckets(engine, comm, resnet_batch(data, P, RESNET["per_rank"], dev))
        if profile_steps:
            out["profile"] = resnet_profile(engine, resnet_batch(data, P, RESNET["per_rank"], dev),
                                            profile_steps)
        steps_per_epoch = state["t"] // RESNET["epochs"]
        # the epochs after the first, which warms up (cuDNN's choices)
        steady_s = sum(state["epoch_times"][1:])
        steady = (RESNET["epochs"] - 1) * steps_per_epoch * P * RESNET["per_rank"] / steady_s
        out.update(counts=counts, k3_per_step=expected["k3_per_step"], epoch_losses=losses,
                   test_acc=acc, img_per_s=steady,
                   step_ms=steady_s / ((RESNET["epochs"] - 1) * steps_per_epoch) * 1e3,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9, steps=state["t"])
        del engine
    finally:
        mpi.stop()
    torch.cuda.empty_cache()
    print(f"resnet: ResNet-50 {mode}, p={P}, per-rank batch {RESNET['per_rank']}, "
          f"{RESNET['image']} px, {RESNET['classes']} classes, lr {RESNET['lr']}, momentum "
          f"{RESNET['momentum']}: {out['steps']} steps, epoch losses {losses}, test_acc {acc:.4f}, "
          f"launches {counts} (K3 {expected['k3_per_step']} a step; flushes per rank "
          f"{expected['flushes']}), check_with_allreduce on parameters and statistics passed")
    return out


def resnet_async_buckets(engine, comm, batch) -> None:
    """One step's async buckets against blocking allreduces of the same
    packed buckets, bit for bit."""
    buckets = engine.buckets
    grads, _ = engine._grad_fn(engine.params, engine.model_state, batch)
    handles = buckets.allreduce_async(grads, comm)
    got = [None] * len(handles)
    for b in reversed(range(len(handles))):
        got[b] = handles[b].wait()
    for b in range(buckets.num_buckets):
        want = mpi.allreduce_tensor(buckets.pack(grads, b, P), comm=comm)
        require(torch.equal(bits(got[b]), bits(want)),
                f"ResNet async: bucket {b} differs from the blocking allreduce")
    print(f"resnet: async, one step's {buckets.num_buckets} buckets equal the blocking "
          "allreduce bit for bit")


def resnet_profile(engine, batch, steps: int, path: str = "") -> dict:
    """``steps`` profiled steps (after the run): the ``{"profile"}`` line,
    and device time per step by kernel class (:func:`kernel_class`)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    row = print_profile(prof, wall_us, steps, path or f"ResNet-50 {engine.mode}, p={P}")
    split: dict = {}
    for us, name, _ in device_rows(prof):
        split[kernel_class(name)] = split.get(kernel_class(name), 0.0) + us / steps
    row["split_us_per_step"] = split
    return row


def phase_resnet(dev, mnist_sync: dict) -> dict:
    """The ResNet path (see the module docstring): the card against the CPU
    on a narrow ResNet, the per-rank gradient forms timed, ResNet-50 at full
    width sync (profiled) and async, then the sequential MNIST twin on the
    card beside the p=8 sync MNIST run. Returns each run's launch counts."""
    for mode in ("sync", "async"):
        cl, cp = resnet_small(dev, mode)
        hl, hp = resnet_small(torch.device("cpu"), mode)
        for a, b in zip(cl, hl):
            require(abs(a - b) <= 1e-4 * abs(b), f"small ResNet {mode}: loss {a} vs CPU {b}")
        worst = max((float((cp[k] - hp[k]).abs().max()), k) for k in hp)
        require(worst[0] <= 1e-4, f"small ResNet {mode}: {worst[1]} differs from the CPU by {worst[0]}")
        print(f"resnet: 3 small steps ({mode}) on the card match the CPU plain path (losses {cl}, "
              f"max |card - CPU| {worst[0]:.3e} at {worst[1]})")

    data = synthetic_imagenet(num_train=RESNET["train"], num_test=RESNET["test"],
                              num_classes=RESNET["classes"], image_size=RESNET["image"])
    forms = rank_maps(dev, data)
    sync = resnet_path(dev, data, "sync", profile_steps=3)
    asyn = resnet_path(dev, data, "async")
    fwd = resnet_forward_flops(RESNET["image"], num_classes=RESNET["classes"])
    achieved, frac = mfu(sync["img_per_s"], train_flops(fwd), torch.cuda.get_device_name(0))
    prof = sync["profile"]
    print(json.dumps({"resnet": {
        "model": "resnet50", "p": P, "per_rank_batch": RESNET["per_rank"],
        "image": RESNET["image"], "classes": RESNET["classes"],
        "img_per_s_per_chip": sync["img_per_s"], "step_ms": sync["step_ms"],
        "tflops": achieved / 1e12, "mfu_f32": frac,
        "device_busy_share": prof["device_busy_share"],
        "device_us_per_step_by_class": prof["split_us_per_step"],
        "k3_per_step": sync["k3_per_step"], "k1_k2_per_step": list_launches(RESNET_LEAVES),
        "epoch_losses": sync["epoch_losses"], "test_acc": sync["test_acc"],
        "peak_gb": sync["peak_gb"], "rank_map": forms,
        "async": {"img_per_s_per_chip": asyn["img_per_s"], "step_ms": asyn["step_ms"],
                  "k3_per_step": asyn["k3_per_step"], "epoch_losses": asyn["epoch_losses"],
                  "test_acc": asyn["test_acc"]},
        "card": card(),
    }}))

    # the convergence oracle: one process, plain SGD, the MNIST run's widths
    ops.reset_launch_counts()
    losses, acc = mnist_sequential.main(["--model", "lenet", "--epochs", "2", "--batch",
                                         str(BATCH), "--lr", str(LR), "--seed", "0"])
    counts = ops.launch_counts()
    steps = 2 * (8192 // BATCH)
    want = {name: 0 for name in counts}
    want["accumulate"] = list_launches(LENET_LEAVES) * steps
    require(counts == want, f"sequential MNIST: launches {counts} != {want}")
    require(all(np.isfinite(losses)), f"sequential MNIST: non-finite loss {losses}")
    print(f"sequential MNIST (LeNet, batch {BATCH}, lr {LR}, 2 epochs): final loss "
          f"{losses[-1]:.4f}, test_acc {acc:.4f}; p={P} sync AllReduce-SGD: final loss "
          f"{mnist_sync['final_loss']:.4f}, test_acc {mnist_sync['test_acc']:.4f}; launches {counts}")
    return {"resnet_sync": sync["counts"], "resnet_async": asyn["counts"],
            "mnist_sequential": counts}


def fusion_flushes(sizes: list) -> list:
    """The flushes of one fusion-buffer group fed tensors of ``sizes``
    elements a rank in turn: it flushes once ``fusion_buffer_bytes`` (f32)
    are pending, and the rest when waited. Each flush is (elements a rank,
    tensors)."""
    cap = constants.get("fusion_buffer_bytes") // 4
    flushes, pending, count = [], 0, 0
    for n in sizes:
        pending, count = pending + n, count + 1
        if pending >= cap:
            flushes, pending, count = flushes + [(pending, count)], 0, 0
    return flushes + ([(pending, count)] if count else [])


def sharded_expected(engine, steps: int) -> dict:
    """The kernel launches one sharded ResNet run of ``steps`` steps routes,
    from the parameters' sizes in the order the engine submits them and the
    routing constants. Per step: K3 'rs' once per flush of the fusion
    buffer's reduce-scatter group (a flush of fewer than
    ``fusion_min_tensors`` tensors once per tensor); K3 'ag' once per dtype
    of the sharded leaves (fsdp: the parameters before the forward; zero1:
    the updates); K3 once per allreduce flush of the replicated leaves above
    ``small_allreduce_size_cuda``; the momentum trace (K2) one list call;
    the update (K1) one list call and, with ``accum_steps`` k > 1, k more
    summing the microbatches' gradients. No K7: the sharded modes broadcast
    nothing. Every other kernel: 0."""
    sizes = {k: math.prod(shape[1:]) for k, shape in engine._shapes.items()}
    sharded = set(engine._sharded)
    least = max(1, constants.get("fusion_min_tensors"))
    rs = fusion_flushes([n for k, n in sizes.items() if k in sharded])
    ar = fusion_flushes([n for k, n in sizes.items() if k not in sharded])
    cutoff = constants.get("small_allreduce_size_cuda")
    leaves, k = list_launches(len(sizes)), engine.accum_steps
    per_step = {
        "ring_reduce_scatter": sum(1 if c >= least else c for _, c in rs),
        "ring_allgather": len({engine.params[name].dtype for name in sharded}),
        "ring_allreduce": sum(n > cutoff for n, _ in ar),
        "scale_accumulate": leaves,
        "accumulate": leaves * (1 + (k if k > 1 else 0)),
    }
    want = {name: 0 for name in ops.launch_counts()}
    want.update({name: n * steps for name, n in per_step.items()})
    return {"counts": want, "per_step": per_step, "rs_flushes": [n for n, _ in rs]}


def sharded_small(dev, model_name: str, mode: str, accum: int, remat: bool) -> tuple:
    """Three steps of ResNet-18 (8 classes, 16 px, 4 images a rank) or of
    LeNet (the MNIST path's batch and lr), p=8, in one sharded mode, from
    one init: the losses, then rank 0's gathered parameters."""
    mpi.start(ranks=P, device=dev)
    try:
        comm = mpi.current_communicator()
        kw = dict(comm=comm, param_sharding=mode, accum_steps=accum, remat=remat)
        if model_name == "resnet18":
            model = ResNet18(num_classes=8)
            params, stats = init_resnet(model, 16, seed=0)
            engine = AllReduceSGDEngine(make_stateful_loss_fn(model), params, model_state=stats,
                                        optimizer=SGD(RESNET["lr"], momentum=RESNET["momentum"]),
                                        **kw)
            (x, y), _ = synthetic_imagenet(num_train=3 * P * 4, num_test=1, num_classes=8,
                                           image_size=16)
            x, y = x.reshape(3, P, 4, 16, 16, 3), y.reshape(3, P, 4)
        else:
            engine = AllReduceSGDEngine(make_loss_fn(LeNet()), init_params(LeNet(), seed=0), lr=LR,
                                        **kw)
            (x, y), _ = synthetic_mnist(num_train=3 * BATCH, num_test=1)
            x, y = x.reshape(3, P, BATCH // P, 28, 28), y.reshape(3, P, BATCH // P)
        x, y = torch.as_tensor(x), torch.as_tensor(y).long()
        losses = [float(engine.step((x[i].to(dev), y[i].to(dev)))) for i in range(3)]
        return losses, {k: v[0].cpu() for k, v in engine.gathered_params().items()}
    finally:
        mpi.stop()


def sharded_path(dev, data, mode: str, accum: int, profile_steps: int = 0) -> dict:
    """Drive the sharded path at full width: ``train_resident`` for
    ``SHARDED_EPOCHS`` epochs of ResNet-50 with ``param_sharding=mode`` and
    ``accum_steps=accum``, every launch count set to 0 just before the
    engine is built and read just after training (:func:`sharded_expected`);
    then, outside the counted run, the replica checks on the gathered
    parameters and the statistics, the test accuracy and a
    ``profile_steps``-step profile (if asked)."""
    (xtr, ytr), (xte, yte) = data
    model = ResNet50(num_classes=RESNET["classes"], device=dev)
    params, stats = init_resnet(model, RESNET["image"], seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    mpi.start(ranks=P)
    try:
        comm = mpi.current_communicator()
        engine = AllReduceSGDEngine(
            make_stateful_loss_fn(model), params, comm=comm, model_state=stats,
            optimizer=SGD(RESNET["lr"], momentum=RESNET["momentum"]), param_sharding=mode,
            accum_steps=accum)
        state = engine.train_resident(xtr, ytr, RESNET["per_rank"], max_epochs=SHARDED_EPOCHS)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        expected = sharded_expected(engine, state["t"])
        name = f"{mode}" + (f" accum_steps={accum}" if accum > 1 else "")
        require(counts == expected["counts"],
                f"sharded {name}: launches {counts} != {expected['counts']}")
        require(len(engine.params) == RESNET_LEAVES and len(engine._sharded) == RESNET_LEAVES
                and sum(v.numel() for v in engine.params.values())
                == (RESNET_PARAMS if mode == "fsdp" else P * RESNET_PARAMS),
                f"sharded {name}: not ResNet-50's widths, or a leaf not sharded")
        require(max(expected["rs_flushes"]) == RESNET_FLUSH,
                f"sharded {name}: largest flush {max(expected['rs_flushes'])} != {RESNET_FLUSH}")
        losses = state["losses"]
        require(all(np.isfinite(losses)) and np.isfinite(state["loss"]),
                f"sharded {name}: non-finite loss {losses}")
        require(losses[-1] < losses[0], f"sharded {name}: loss did not fall: epochs {losses}")
        mpinn.check_with_allreduce(engine.gathered_params(), comm)
        mpinn.check_with_allreduce(engine.model_state, comm)
        acc = engine.evaluate(make_eval_fn(model), xte, yte, accuracy)
        require(0.0 <= acc <= 1.0, f"sharded {name}: test accuracy {acc}")
        profile = None
        if profile_steps:
            row = resnet_profile(engine, resnet_batch(data, P, RESNET["per_rank"], dev),
                                 profile_steps, f"ResNet-50 {name}, p={P}")
            profile = {k: row[k] for k in ("window_us_per_step", "device_busy_share",
                                           "split_us_per_step")}
        steps_per_epoch = state["t"] // SHARDED_EPOCHS
        steady_s = sum(state["epoch_times"][1:])
        steady_steps = (SHARDED_EPOCHS - 1) * steps_per_epoch
        img_per_s = steady_steps * P * RESNET["per_rank"] / steady_s
        fwd = resnet_forward_flops(RESNET["image"], num_classes=RESNET["classes"])
        achieved, frac = mfu(img_per_s, train_flops(fwd), torch.cuda.get_device_name(0))
        out = {"param_sharding": mode, "accum_steps": accum, "steps": state["t"],
               "step_ms": steady_s / steady_steps * 1e3, "img_per_s_per_chip": img_per_s,
               "tflops": achieved / 1e12, "mfu_f32": frac, "peak_gb": peak_gb,
               "epoch_losses": losses, "test_acc": acc,
               "launches_per_step": expected["per_step"], "rs_flushes": expected["rs_flushes"],
               "profile": profile, "counts": counts}
        del engine
    finally:
        mpi.stop()
    torch.cuda.empty_cache()
    print(f"sharded: ResNet-50 {name}, p={P}, per-rank batch {RESNET['per_rank']}: {out['steps']} "
          f"steps, epoch losses {losses}, test_acc {acc:.4f}, peak {peak_gb:.2f} GB, launches "
          f"{counts} (a step: {expected['per_step']}; reduce-scatter flushes per rank "
          f"{expected['rs_flushes']}), check_with_allreduce on the gathered parameters and the "
          "statistics passed")
    return out


def phase_sharded(dev) -> dict:
    """The sharded path (see the module docstring): ResNet-18 and LeNet on
    the card against the CPU under fsdp, zero1, fsdp with two microbatches
    and remat; then ResNet-50 at full width under each of
    ``SHARDED_RUNS``, and one ``{"sharded": ...}`` line. Returns each full
    run's launch counts."""
    for model_name in ("resnet18", "lenet"):
        for mode, accum, remat in SHARDED_SMALL:
            what = f"{model_name} {mode} accum_steps={accum} remat={remat}"
            cl, cp = sharded_small(dev, model_name, mode, accum, remat)
            hl, hp = sharded_small(torch.device("cpu"), model_name, mode, accum, remat)
            for a, b in zip(cl, hl):
                require(abs(a - b) <= 1e-4 * abs(b), f"sharded {what}: loss {a} vs CPU {b}")
            worst = max((float((cp[k] - hp[k]).abs().max()), k) for k in hp)
            require(worst[0] <= 1e-4, f"sharded {what}: {worst[1]} differs from the CPU by {worst[0]}")
            print(f"sharded: 3 steps of {what} on the card match the CPU plain path (losses {cl}, "
                  f"max |card - CPU| {worst[0]:.3e} at {worst[1]})")
    data = synthetic_imagenet(num_train=RESNET["train"], num_test=RESNET["test"],
                              num_classes=RESNET["classes"], image_size=RESNET["image"])
    runs, line = {}, []
    for i, (mode, accum) in enumerate(SHARDED_RUNS):
        out = sharded_path(dev, data, mode, accum, profile_steps=3 if i == 0 else 0)
        runs[f"sharded_{mode}" + (f"_accum{accum}" if accum > 1 else "")] = out.pop("counts")
        line.append(out)
    print(json.dumps({"sharded": {
        "model": "resnet50", "p": P, "per_rank_batch": RESNET["per_rank"], "image": RESNET["image"],
        "classes": RESNET["classes"], "lr": RESNET["lr"], "momentum": RESNET["momentum"],
        "runs": line, "card": card()}}))
    return runs


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


# the one-process sweep's bus GB/s at its largest size, by (op, backend,
# mode), beside which run (g) prints the two processes'
BENCH_TOP: dict = {}


def bench_key(row: dict) -> str:
    impl = "/kernel_bidir" if row.get("ring_implementation") else ""
    return f"{row['op']}{impl}/{row['backend']}/{row['mode']}"


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
                if r.nelem == SWEEP[-1]:
                    BENCH_TOP[bench_key(row)] = r.bus_gbps
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


def phase_async_issue(dev) -> None:
    """The host time to issue an async allreduce at 2^8 elements a rank
    (p=8), and its parts: the selector-routed call (its choice memoized on
    the communicator), the same with the backend pinned (no selector), the
    selector's ``select`` alone, the collective's own synchronous issue
    (``eager.run``, its route memoized and re-derived), K3's wrapper at
    2^8 on the current stream and with the stream passed, the device guard
    and current-stream lookup it skips, the side stream's ``wait_stream``,
    event and ``record_stream``, and ``run_async``'s own parts: the switch
    to the side stream and back, a stream context entered and left (the
    switch it replaces), the reused ordering event, and a handle made and
    registered; the schedule compiler's dispatch-memo hit alone
    (``compile_collective_hit``), and the C++ issue path's own call for
    the routed plan (``cpp_issue``: the ordering event, the stream switch,
    the vendor path's three calls, the done event and ``record_stream``).
    Each the median of 1,000 calls on the host clock, after 50 warm-up
    calls, with every handle waited outside the timed window; one
    ``{"async_issue": ...}`` line of microseconds."""
    from torchmpi_tpu_torch.collectives import eager, selector
    from torchmpi_tpu_torch.ops.issue import issue_async
    from torchmpi_tpu_torch.runtime.handles import SyncHandle, handles
    from torchmpi_tpu_torch.schedule import compile_collective

    n = 1 << 8

    def median_us(issue, finish=lambda h: None, reps=1000, warmup=50):
        times = []
        for i in range(warmup + reps):
            t0 = time.perf_counter_ns()
            h = issue()
            t1 = time.perf_counter_ns()
            finish(h)
            if i >= warmup:
                times.append(t1 - t0)
        torch.cuda.synchronize()
        return statistics.median(times) / 1e3

    mpi.start(ranks=P)
    try:
        comm = mpi.current_communicator()
        x = torch.randn((P, n), device=dev)
        side = torch.cuda.Stream(dev)
        main, ctx, order = torch.cuda.current_stream(dev), torch.cuda.stream(side), torch.cuda.Event()
        routed = selector.select("allreduce", dev, False, "async")
        route = compile_collective("allreduce", tuple(x.shape), x.dtype, comm,
                                   backend=routed).issue
        require(route is not None, f"async_issue: the routed plan ({routed}) has no C++ route")
        row = {
            "async_allreduce_tensor": median_us(lambda: mpi.async_.allreduce_tensor(x), mpi.wait),
            "async_kernel_pinned": median_us(lambda: mpi.async_.kernel.allreduce_tensor(x),
                                             mpi.wait),
            "selector_select": median_us(lambda: selector.select("allreduce", dev, False,
                                                                 "async")),
            "eager_run_sync": median_us(lambda: eager.run("allreduce", x, comm, backend="kernel")),
            # the plan memoized (above), and its dispatch memo dropped on
            # every call (the plan cache still hits)
            "eager_run_route_miss": median_us(
                lambda: (comm.__dict__.pop("_dispatch_memo", None),
                         eager.run("allreduce", x, comm, backend="kernel"))),
            # the routed call's memo lookup alone, and the C++ issue of its
            # plan (the vendor path at 2^8)
            "compile_collective_hit": median_us(
                lambda: compile_collective("allreduce", tuple(x.shape), x.dtype, comm,
                                           backend=routed)),
            "cpp_issue": median_us(
                lambda: SyncHandle(issue_async(x, side, order, torch.cuda.Event(), route)),
                mpi.wait),
            # K3's wrapper at 2^8 (a launch): on the current stream, and
            # with the stream passed, as run_async passes its side stream
            "k3_wrapper": median_us(lambda: ops.ring_allreduce(x)),
            "k3_wrapper_stream_passed": median_us(lambda: ops.ring_allreduce(x, stream=main)),
            # what the wrappers no longer do on the current device
            "device_guard": median_us(lambda: torch.cuda.device(dev).__exit__(
                None, None, torch.cuda.device(dev).__enter__())),
            "current_stream_lookup": median_us(lambda: torch.cuda.current_stream().cuda_stream),
            "wait_stream": median_us(lambda: side.wait_stream(torch.cuda.current_stream(dev))),
            "event_record": median_us(lambda: torch.cuda.Event().record(side)),
            "record_stream": median_us(lambda: x.record_stream(side)),
            # run_async's own parts: the switch to the side stream and back
            # (set_stream twice), beside a cached stream context entered and
            # left (the switch it replaced), the reused ordering event
            # recorded and waited (in place of wait_stream), and a handle
            # made and registered
            "stream_switch": median_us(
                lambda: (torch.cuda.set_stream(side), torch.cuda.set_stream(main))),
            "stream_context": median_us(lambda: ctx.__exit__(None, None, ctx.__enter__())),
            "order_event": median_us(lambda: (order.record(main), side.wait_event(order))),
            "handle_register": median_us(
                lambda: handles.register(SyncHandle(x), kind="collective"), handles.wait_index),
        }
    finally:
        mpi.stop()
    print(json.dumps({"async_issue": {"us": row, "nelem": n, "p": P, "reps": 1000,
                                      "reference_contract_us": 50}}))


def plan_compiles() -> int:
    """The schedule compiler's dispatch-memo misses so far (its
    ``tm_plan_compiles_total`` counter, counted while telemetry is on)."""
    series = mpi.telemetry.metrics.snapshot().get("tm_plan_compiles_total", {}).get("series", {})
    return int(sum(series.values()))


def mnist_engine(comm, mode: str, wire: str):
    model = LeNet()
    return AllReduceSGDEngine(make_loss_fn(model), init_params(model, seed=0), lr=LR, comm=comm,
                              mode=mode, wire_dtype=wire)


def mnist_batches(comm, steps: int) -> list:
    (xtr, ytr), _ = synthetic_mnist()
    it = DistributedIterator(xtr, ytr, BATCH, P, device=comm.device)
    return [b for _, b in zip(range(steps), itertools.cycle(it))]


def phase_compiler(dev) -> dict:
    """The schedule compiler on the card (BASELINE config 1: LeNet, p=8,
    batch 336):

    1. warm plans: ``engine.precompile()``, then 20 sync steps with
       telemetry on must make no dispatch-memo miss (the compiler's
       ``tm_plan_compiles_total``, bumped by ``_count_compile``) and no
       plan-cache miss (no new plan-cache entry), with every collective a
       memo hit (``_count_hit``) and one K3 launch a step;
    2. plan stamps: 5 sync steps and 5 async int8 steps with telemetry
       and the flight recorder on: every entry completes, every
       collective entry carries a ``plan_id`` (the handles' ``wait.*``
       entries run no plan), one ``flat-kernel-full`` allreduce a sync
       step and an int8 ``flat-kernel`` plan for each async step's
       bucket 0;
    3. telemetry's cost: 30 sync steps with telemetry (and so the flight
       recorder) off and on, in turns (off, on, on, off), ms a step;
    4. the ring's pipeline depth: a ``ring``-backend allreduce at [8,
       2^24] f32 runs the depth the compiler chose, bitwise equal to the
       same ring at depth 1.

    Prints one ``{"compiler": ...}`` line."""
    from torchmpi_tpu_torch.collectives import eager
    from torchmpi_tpu_torch.telemetry import flightrecorder

    telemetry = mpi.telemetry
    out = {}
    mpi.start(ranks=P)
    try:
        comm = mpi.current_communicator()
        engine = mnist_engine(comm, "sync", "full")
        batches = mnist_batches(comm, 20)
        warmed = engine.precompile()
        telemetry.reset()
        telemetry.enable()
        try:
            ops.reset_launch_counts()
            plans_before = set(comm._plan_cache)
            misses_before = plan_compiles()
            for b in batches:
                engine.step(b)
            torch.cuda.synchronize()
            hits = sum(telemetry.metrics.snapshot().get("tm_plan_cache_hits_total", {})
                       .get("series", {}).values())
            memo_misses = plan_compiles() - misses_before
            plan_misses = len(set(comm._plan_cache) - plans_before)
        finally:
            telemetry.disable()
        k3 = ops.launch_counts()["ring_allreduce"]
        require(memo_misses == 0 and plan_misses == 0,
                f"compiler: after precompile, 20 warm steps made {memo_misses} dispatch-memo and "
                f"{plan_misses} plan-cache misses")
        require(k3 == len(batches), f"compiler: {k3} K3 launches in {len(batches)} warm steps")
        out["warm"] = {"warmed": warmed, "steps": len(batches), "memo_misses": memo_misses,
                       "plan_cache_misses": plan_misses, "memo_hits": int(hits),
                       "k3_launches": k3,
                       "pinned": [comm._dispatch_memo.pinned_count(),
                                  comm._plan_cache.pinned_count()]}

        # plan stamps
        telemetry.reset()
        telemetry.enable()
        try:
            for b in batches[:5]:
                engine.step(b)
            quant = mnist_engine(comm, "async", "int8")
            flightrecorder.recorder.reset()
            for b in batches[:5]:
                quant.step(b)
            async_entries = flightrecorder.recorder.entries()
            torch.cuda.synchronize()
        finally:
            telemetry.disable()
        entries = async_entries
        require(all(e["status"] == flightrecorder.STATUS_COMPLETED for e in entries),
                "compiler: a flight entry did not complete")
        # the handles' waits (the rank-local "handles" stream) run no plan
        collectives = [e for e in entries if e["comm"] != "handles"
                       and not e["op"].startswith(("fusion.", "engine."))]
        require(collectives and all(e["plan"] for e in collectives),
                "compiler: a collective flight entry carries no plan_id")
        bucket0 = [e["plan"] for e in collectives if e["wire"] == "int8"]
        require(len(bucket0) == 5 and all(pl.startswith("flat-kernel-int8") for pl in bucket0),
                f"compiler: async int8 bucket 0 plans {bucket0}")
        out["stamps"] = {"async": sorted({(e["op"], e["plan"]) for e in collectives}),
                         "async_waits": sorted({e["op"] for e in entries
                                                if e["comm"] == "handles"})}
    finally:
        mpi.stop()

    # the sync steps' stamps, apart: a fresh runtime, so the entries are
    # only these 5 steps'
    mpi.start(ranks=P)
    try:
        comm = mpi.current_communicator()
        engine = mnist_engine(comm, "sync", "full")
        batches = mnist_batches(comm, 30)
        telemetry.reset()
        telemetry.enable()
        try:
            for b in batches[:5]:
                engine.step(b)
            torch.cuda.synchronize()
            entries = flightrecorder.recorder.entries()
        finally:
            telemetry.disable()
        require(all(e["status"] == flightrecorder.STATUS_COMPLETED for e in entries),
                "compiler: a sync flight entry did not complete")
        collectives = [e for e in entries if e["comm"] != "handles"
                       and not e["op"].startswith(("fusion.", "engine."))]
        require(all(e["plan"] for e in collectives),
                "compiler: a sync collective flight entry carries no plan_id")
        allreduces = [e["plan"] for e in collectives if e["op"] == "allreduce"]
        require(len(allreduces) == 5 and all(pl.startswith("flat-kernel-full") for pl in allreduces),
                f"compiler: sync allreduce plans {allreduces}")
        out["stamps"]["sync"] = sorted({(e["op"], e["plan"], e["routing"]) for e in collectives})
        out["stamps"]["entries"] = len(entries)

        # telemetry's cost, in turns
        def step_ms(on: bool) -> float:
            (telemetry.enable if on else telemetry.disable)()
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for b in batches:
                    engine.step(b)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3 / len(batches)
            finally:
                telemetry.disable()

        step_ms(False)  # warm
        turns = [("off", step_ms(False)), ("on", step_ms(True)), ("on", step_ms(True)),
                 ("off", step_ms(False))]
        out["telemetry_step_ms"] = turns

        # the ring's pipeline depth at [8, 2^24] f32
        x = torch.randn((P, 1 << 24), device=dev, generator=torch.Generator(device=dev).manual_seed(5))
        from torchmpi_tpu_torch.schedule import compile_collective

        ep = compile_collective("allreduce", tuple(x.shape), x.dtype, comm, backend="ring")
        got = eager.run("allreduce", x, comm, backend="ring")
        minb, maxb, nbuf = eager.ring_tuning("cuda")
        want = primitives.ring_allreduce(x, max_bytes_per_step=maxb, min_bytes_per_step=minb,
                                         num_buffers=nbuf, pipeline_depth=1)
        require(torch.equal(bits(got), bits(want)),
                f"compiler: the ring at depth {ep.plan.pipeline} differs from depth 1")
        require(ep.plan.pipeline > 1, f"compiler: ring plan {ep.plan_id} is not pipelined")
        out["ring_depth"] = {"shape": list(x.shape), "plan": ep.plan_id,
                             "depth": ep.plan.pipeline, "bitwise_equal_depth1": True}
        del x, got, want
    finally:
        mpi.stop()
    out["card"] = card()
    print(json.dumps({"compiler": out}))
    return out


@contextlib.contextmanager
def cuda_columns_on_cpu():
    """Inside the block every ``_cpu`` routing constant holds its ``_cuda``
    value, so a CPU reference cuts its rings and picks its broadcasts as
    the card does."""
    snap = constants.snapshot()
    try:
        for name, value in snap.items():
            if name.endswith("_cuda"):
                constants.set(name[:-len("cuda")] + "cpu", value)
        yield
    finally:
        for name, value in snap.items():
            if name.endswith("_cpu"):
                constants.set(name, value)


@contextlib.contextmanager
def constants_set(values: dict):
    before = {name: constants.get(name) for name in values}
    try:
        for name, value in values.items():
            constants.set(name, value)
        yield
    finally:
        for name, value in before.items():
            constants.set(name, value)


def two_level(device, keys):
    """A two-level communicator of the P ranks on ``device``, split by
    ``keys`` as ``push_communicator`` splits the global one."""
    from torchmpi_tpu_torch.runtime.communicator import Communicator, split_by_keys

    return split_by_keys(Communicator(range(P), device), keys, name="two-level")


def hier_cases(G: int, I: int) -> list:
    """(name, call, constants, launches a float and an int payload make):
    every two-level lowering on a cartesian communicator of G groups of I
    ranks. An intra phase on K3, K3 'ag' or K7 is one launch over every
    group; on K4, K5 or K6 one launch a group."""
    from torchmpi_tpu_torch.collectives import eager

    ar, col = eager.run_hierarchical_allreduce, eager.run_hierarchical_collective
    bidir = "ring_allreduce_bidir" if I > 2 else "ring_allreduce"  # K5 runs K3 on 2 ranks
    depth2 = {"plan_pipeline_depth": 2, "plan_pipeline_min_chunk_bytes": 1024}
    return [
        ("allreduce xla", lambda x, c: ar(x, c, impl="xla"), {}, {}, {}),
        ("allreduce ring", lambda x, c: ar(x, c, impl="ring"), {}, {}, {}),
        ("allreduce ring depth 2", lambda x, c: ar(x, c, impl="ring"), depth2, {}, {}),
        ("allreduce ring int8", lambda x, c: ar(x, c, impl="ring", wire="int8"), {}, {}, {}),
        ("allreduce kernel", lambda x, c: ar(x, c, impl="kernel"), {},
         {"ring_allreduce": 1}, {"ring_allreduce": 1}),
        ("allreduce kernel_bidir", lambda x, c: ar(x, c, impl="kernel"),
         {"ring_implementation": "kernel_bidir"}, {bidir: G}, {bidir: G}),
        ("allreduce kernel int8", lambda x, c: ar(x, c, impl="kernel", wire="int8"), {},
         {"ring_allreduce_quant_int8": G}, {"ring_allreduce": 1}),
        ("broadcast ring", lambda x, c: col("broadcast", x, c, root=3), {}, {}, {}),
        ("broadcast kernel", lambda x, c: col("broadcast", x, c, root=3, ring_impl="kernel"), {},
         {"ring_broadcast": 1}, {"ring_broadcast": 1}),
        ("reduce ring", lambda x, c: col("reduce", x, c, root=5), {}, {}, {}),
        ("reduce kernel", lambda x, c: col("reduce", x, c, root=5, ring_impl="kernel"), {},
         {"ring_reduce": G}, {"ring_reduce": G}),
        ("allgather ring", lambda x, c: col("allgather", x[:, :HIER_N // 8], c), {}, {}, {}),
        ("allgather kernel",
         lambda x, c: col("allgather", x[:, :HIER_N // 8].contiguous(), c, ring_impl="kernel"), {},
         {"ring_allgather": 1}, {"ring_allgather": 1}),
        ("staged ring", lambda x, c: ar(x, c, impl="staged"), {}, {}, {}),
        ("staged kernel", lambda x, c: ar(x, c, impl="staged", staged_intra="kernel"), {},
         {"ring_allreduce": 1}, {"ring_allreduce": 1}),
    ]


def tree_cases() -> list:
    from torchmpi_tpu_torch.collectives import eager
    from torchmpi_tpu_torch.schedule import compiler as sched

    def bcast(root):
        return lambda x, c: sched.compile_collective(
            "broadcast", tuple(x.shape), x.dtype, c, root=root, generator="tree",
            impl="ring").execute(x)

    tree = eager.run_tree_hierarchical_allreduce
    return [
        ("tree allreduce", lambda x, c: tree(x, c), {}, {}, {}),
        ("tree allreduce int8", lambda x, c: tree(x, c, wire="int8"), {}, {}, {}),
        ("tree broadcast root 0", bcast(0), {}, {}, {}),
        ("tree broadcast root 5", bcast(5), {}, {}, {}),
    ]


def check_hier(dev) -> dict:
    """Every two-level lowering on the card against the same lowering on
    the CPU (plain versions), p=8 as 2x4 (``str(r % 2)``: groups of
    non-contiguous ranks) and 4x2 (``host{r // 2}``) cartesian groups, the
    tree on two ragged splits, f32 and int32 payloads of ``HIER_N`` a
    rank: bit for bit (the ``xla`` sums within ``HIER_XLA_RTOL`` of the
    largest |sum| on f32, exact on int32), and each case's launches
    exact (0 just before the card's call, read just after; 1 an intra
    phase on K3, K3 'ag' or K7, G on K4, K5 or K6). Returns the largest
    |card - CPU| of each case."""
    gen = torch.Generator(device=dev).manual_seed(13)
    errs = {}
    with cuda_columns_on_cpu():
        layouts = [(name, keys, hier_cases) for name, keys in HIER_KEYS.items()]
        layouts += [(name, keys, lambda G, I: tree_cases()) for name, keys in HIER_RAGGED.items()]
        for layout, keys, cases in layouts:
            gcomm, ccomm = two_level(dev, keys), two_level("cpu", keys)
            G, I = gcomm.num_intra_groups, len(gcomm.groups[0])
            for name, call, consts, f32_launch, int_launch in cases(G, I):
                for dtype, launches in ((torch.float32, f32_launch), (torch.int32, int_launch)):
                    x = rand((P, HIER_N), dtype, gen, dev)
                    with constants_set(consts):
                        ops.reset_launch_counts()
                        got = call(x, gcomm)
                        torch.cuda.synchronize()
                        counts = ops.launch_counts()
                        want = call(x.cpu(), ccomm)
                    what = f"hier {layout} {name} {dtype}"
                    require(got.shape == want.shape and got.dtype == want.dtype, f"{what}: shape")
                    got = got.cpu()
                    err = float((got.double() - want.double()).abs().max())
                    if name.endswith("xla") and dtype.is_floating_point:
                        scale = float(x.abs().sum(0).max())
                        require(err <= HIER_XLA_RTOL * scale,
                                f"{what}: card and CPU sums {err} apart (limit "
                                f"{HIER_XLA_RTOL * scale})")
                    else:
                        require(torch.equal(bits(got), bits(want)), f"{what}: card != CPU ({err})")
                    expected = {k: launches.get(k, 0) for k in counts}
                    require(counts == expected, f"{what}: launches {counts}, expected {expected}")
                    errs[f"{layout} {name} {str(dtype)[6:]}"] = err
    print(f"hier: {len(errs)} two-level lowerings on the card equal the CPU's, launches exact")
    return errs


def config5_run(backend: str, argv=()) -> dict:
    """The config-5 twin at its defaults with ``--backend`` (and ``argv``):
    the launch counts (0 just before, read just after) and the plans its
    communicator held when it stopped."""
    from torchmpi_tpu_torch.examples import blocksequential_2host

    memo = {}
    real_stop = mpi.stop

    def stop():
        memo.update(mpi.current_communicator().__dict__.get("_dispatch_memo", {}))
        real_stop()

    mpi.stop = stop
    try:
        ops.reset_launch_counts()
        losses, acc, hier_used, sps = blocksequential_2host.main(["--backend", backend, *argv])
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        mpi.stop = real_stop
    plans = sorted({(ent[1].op_label, ent[1].plan_id) for key, ent in memo.items()
                    if key[0] == "_plan"})
    # each gradient bucket's plan: the allreduces of config 5's bucket widths
    buckets = {key[2][1]: (ent[1].op_label, ent[1].plan_id) for key, ent in memo.items()
               if key[0] == "_plan" and key[1] == "allreduce" and len(key[2]) == 2
               and key[2][1] in CONFIG5_BUCKETS}
    return dict(losses=losses, acc=acc, hier_used=hier_used, samples_per_s_chip=sps,
                counts=counts, plans=plans, buckets=buckets)


def config5_expected(run: dict, backend: str) -> dict:
    """Its launches: :data:`CONFIG5_PRODUCTS` per-rank products every step
    (its vmap on the card), one K3 over both hosts for every bucket of
    every step on the kernel backend, and one K7 over both hosts for each
    ``hier-kernel`` broadcast plan (the first parameter sync)."""
    expected = dict.fromkeys(run["counts"], 0)
    expected["rank_bmm"] = CONFIG5_STEPS * CONFIG5_PRODUCTS
    if backend == "kernel":
        expected["ring_allreduce"] = CONFIG5_STEPS * CONFIG5["blocks"]
    expected["ring_broadcast"] = sum(
        1 for label, plan_id in run["plans"]
        if label == "hier_broadcast" and plan_id.startswith("hier-kernel"))
    return expected


GROUPED_LAYOUTS = ((1, P), (CONFIG5_G, CONFIG5_I), (4, 2))  # G groups x I ranks


def check_grouped(dev, gen) -> dict:
    """The grouped K3, K3 'ag' and K7 (``groups=G`` on the group-major
    rows, one launch) on the card against their plain versions on the same
    card, bit for bit: G x I in ``GROUPED_LAYOUTS``, every native dtype, at
    config 5's three bucket widths and its parameters (its first sync's
    broadcast), ``HIER_N`` (odd) and 2^23 a rank (f32 only: the other
    dtypes take the same code at the smaller widths), K7 from root I - 1. Returns the largest |kernel - plain| at the kernels
    line's grouped shapes."""
    errs = {}
    widths = CONFIG5_BUCKETS + (CONFIG5_PARAMS, HIER_N)
    cases = [(n, dtype) for n in widths for dtype in NATIVE_DTYPES]
    cases.append((N23, torch.float32))
    for G, I in GROUPED_LAYOUTS:
        root = I - 1
        grouped = (
            ("ring_allreduce", lambda x: ops.ring_allreduce(x, groups=G),
             lambda x: ops.ring_allreduce_plain(x, G)),
            ("ring_allgather", lambda x: ops.ring_allgather(x, groups=G),
             lambda x: ops.ring_allgather_plain(x, G)),
            ("ring_broadcast", lambda x: ops.ring_broadcast(x, root, groups=G),
             lambda x: ops.ring_broadcast_plain(x, root, G)),
        )
        for n, dtype in cases:
            x = rand((P, n), dtype, gen, dev)
            for name, kernel, plain in grouped:
                got, want = kernel(x), plain(x)
                torch.cuda.synchronize()
                what = f"grouped {name} {G}x{I} [{P}, {n}] {dtype}"
                require(got.shape == want.shape and got.dtype == want.dtype, f"{what}: shape")
                require(torch.equal(bits(got), bits(want)), f"{what}: kernel != plain")
                if dtype == torch.float32 and G == CONFIG5_G:
                    errs[f"{name}@grouped_{n}"] = float((got - want).abs().max())
            del x
    print(f"grouped: K3, K3 'ag' and K7 over {len(GROUPED_LAYOUTS)} layouts and "
          f"{len(cases)} widths and dtypes equal their plain versions")
    return errs


def phase_hier(dev) -> tuple:
    """BASELINE config 5 and the two-level lowerings on the card:

    1. :func:`check_hier`, every lowering against the CPU's, and the
       twin below on a small run (256 images, 2 epochs) against the same
       run on the CPU, losses within rtol 1e-4;
    2. the twin of ``examples/blocksequential_2host.py`` at its defaults
       (MLP6 at 128 features, Adam lr 1e-3, 3 blocks, 2 hosts of 4 ranks,
       8 a rank, 4 epochs of ``synthetic_mnist(1024)``: 64 steps) with
       ``--backend ring`` and then ``--backend kernel``: falling test
       losses, accuracy above 0.6, ``check_with_allreduce`` (inside the
       twin), the hierarchical plan run, exact launches
       (:func:`config5_expected`);
    3. the two-level allreduce at [8, 2^23] f32 on 2 hosts of 4 with the
       kernel and the ring intra phases, flat K3 at the same size, the
       intra phase's library call (each host's sum, ``x.view(G, I,
       n).sum(1)``, expanded to its ranks) and K3 on one host's [4, 2^23]
       slab against its bound, and the kernel allreduce's two phases
       alone (the grouped K3, one launch, against its bound; the inter
       rings), beside the intra phase as one K3 a host with the slabs'
       ``torch.cat`` (the lowering until the grouped launch); the same
       three intra forms at config 5's largest bucket, [8, 100480]; every
       time in ms by :func:`time_ms` on inputs rotated past the L2.

    Prints one ``{"hier": ...}`` line; returns the runs' launch counts
    (paths ``hier_ring``, ``hier_kernel``) and the errors of the checks."""
    from torchmpi_tpu_torch.collectives import eager

    errs = check_hier(dev)
    errs.update(check_grouped(dev, torch.Generator(device=dev).manual_seed(17)))
    # the twin on the card against the twin on the CPU (plain versions),
    # on a small run: the same losses but for the devices' roundings
    from torchmpi_tpu_torch.examples import blocksequential_2host

    small = ["--train", "256", "--epochs", "2", "--backend", "kernel"]
    card_losses = blocksequential_2host.main(small)[0]
    cpu_losses = blocksequential_2host.main(small + ["--device", "cpu"])[0]
    for a, b in zip(card_losses, cpu_losses):
        require(abs(a - b) <= 1e-4 * abs(b),
                f"config 5 small run: card losses {card_losses}, CPU {cpu_losses}")
    runs, twin = {}, {}
    for backend in ("ring", "kernel"):
        run = config5_run(backend)
        losses, what = run["losses"], f"config 5 --backend {backend}"
        require(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
                f"{what}: test losses {losses} do not fall")
        require(run["acc"] > 0.6, f"{what}: test accuracy {run['acc']}")
        require(run["hier_used"], f"{what}: the hierarchical plan did not run")
        expected = config5_expected(run, backend)
        require(run["counts"] == expected,
                f"{what}: launches {run['counts']}, expected {expected}")
        runs[f"hier_{backend}"] = run["counts"]
        twin[backend] = {k: run[k] for k in ("losses", "acc", "samples_per_s_chip", "plans")}
        twin[backend]["launches"] = {k: v for k, v in run["counts"].items() if v}

    # times at [8, 2^23] f32 on the config's 2 hosts of 4
    from torchmpi_tpu_torch.schedule import lower

    G, I, n = CONFIG5_G, CONFIG5_I, N23
    comm = two_level(dev, lambda r: f"host{r // I}")
    minb, maxb, nbuf = eager.ring_tuning("cuda")

    def inter(v):
        return primitives.ring_allreduce(v, max_bytes_per_step=maxb, min_bytes_per_step=minb,
                                         num_buffers=nbuf, batched=True)

    gen = torch.Generator(device=dev).manual_seed(5)

    def timed(fn, rows: int = P, width: int = n):
        return time_ms(rotating(fn, lambda: (torch.randn((rows, width), generator=gen,
                                                         device=dev),), rows * width * 4))

    def library(width):
        return lambda x: x.view(G, I, width).sum(1, keepdim=True).expand(G, I, width).reshape(
            P, width)

    # K3 on one host's slab (the per-group form timed below) at the largest
    # bucket and at 2^23, against its plain version
    for width in (CONFIG5_BUCKET, n):
        slab = torch.randn((I, width), generator=gen, device=dev)
        err = float((ops.ring_allreduce(slab) - ops.ring_allreduce_plain(slab)).abs().max())
        require(err == 0.0, f"K3 on a [{I}, {width}] slab differs from its plain version by {err}")
    del slab
    times = {
        "two_level_kernel_ms": timed(lambda x: eager.run_hierarchical_allreduce(x, comm,
                                                                               impl="kernel")),
        "two_level_ring_ms": timed(lambda x: eager.run_hierarchical_allreduce(x, comm,
                                                                             impl="ring")),
        # its parts: the intra phase (the grouped K3, one launch), the
        # inter phase (the ring backend's rings of 2 ranks, 4 at once)
        "intra_kernel_ms": timed(lambda x: ops.ring_allreduce(x, groups=G)),
        "intra_bound_ms": 2 * P * n * 4 / HBM_BYTES_PER_S * 1e3,
        "intra_per_group_ms": timed(lambda x: lower._per_group(ops.ring_allreduce, x, G, I)),
        "inter_ring_ms": timed(lambda x: lower._inter_rings(inter, x, G, I)),
        "flat_k3_ms": timed(ops.ring_allreduce),
        "intra_library_ms": timed(library(n)),
        "slab_k3_ms": timed(ops.ring_allreduce, rows=I),
        "slab_bound_ms": 2 * I * n * 4 / HBM_BYTES_PER_S * 1e3,
    }
    c5 = CONFIG5_BUCKET
    config5_intra = {
        "shape": [P, c5],
        "grouped_k3_ms": timed(lambda x: ops.ring_allreduce(x, groups=G), width=c5),
        "bound_ms": 2 * P * c5 * 4 / HBM_BYTES_PER_S * 1e3,
        "per_group_ms": timed(lambda x: lower._per_group(ops.ring_allreduce, x, G, I), width=c5),
        "library_ms": timed(library(c5), width=c5),
        "slab_k3_ms": timed(ops.ring_allreduce, rows=I, width=c5),
    }
    for what, ms, bound_ms in (
            ("K3 on a slab", times["slab_k3_ms"], times["slab_bound_ms"]),
            ("the grouped intra phase", times["intra_kernel_ms"], times["intra_bound_ms"]),
            ("the per-group intra phase", times["intra_per_group_ms"], times["intra_bound_ms"]),
            ("the grouped K3 at config 5's bucket", config5_intra["grouped_k3_ms"],
             config5_intra["bound_ms"])):
        require(ms >= bound_ms, f"{what} read {ms} ms, under its bound {bound_ms} ms")
    print(json.dumps({"hier": {
        "checks": len(errs), "config5": twin, "steps": CONFIG5_STEPS,
        "times_at": {"shape": [P, n], "dtype": "float32", "groups": f"{G}x{I}", **times},
        "config5_intra": config5_intra, "card": card()}}))
    return runs, errs


# --- the engine phase: checkpoints, telemetry, the profile window, the
# scheduled bucket sync and the eval cache ------------------------------------
def live_state(engine) -> list:
    """``(path, leaf)`` of the engine's parameters, optimizer state and
    model state, in the checkpoint's order."""
    return ckpt._walk({"params": engine.params, "opt_state": engine.opt_state,
                       "model_state": engine.model_state})


def same_bits(state_a: list, state_b: list) -> bool:
    if [k for k, _ in state_a] != [k for k, _ in state_b]:
        return False
    for (_, a), (_, b) in zip(state_a, state_b):
        if isinstance(a, torch.Tensor):
            if a.shape != b.shape or not torch.equal(bits(a.cpu()), bits(b.cpu())):
                return False
        elif a != b:
            return False
    return True


def synced_ms(fn) -> tuple:
    """``(fn(), its wall ms)``, the card idle before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def counts_want(**launches) -> dict:
    want = {name: 0 for name in ops.launch_counts()}
    want.update(launches)
    return want


def lenet_vmap_launches(steps: int) -> dict:
    """The per-rank kernels' launches in ``steps`` LeNet steps under the
    engine's vmap on the card (ROADMAP C6's repair): each convolution's
    weight gradient and each dense product once a step."""
    return {"conv2d_weight_grad_ranks": LENET_CONVS * steps,
            "rank_bmm": LENET_PRODUCTS * steps}


def file_digests(data_dir: Path) -> dict:
    import hashlib

    return {f.name: hashlib.sha1(f.read_bytes()).hexdigest() for f in sorted(data_dir.iterdir())}


def engine_lenet(dev, root: Path) -> tuple:
    """(a) and (f): config 1's LeNet sync at p=8, batch 336: 6 unbroken
    steps with the launches counted, then 3 steps with
    ``checkpoint_every(3)``, a flush, a restore into a fresh engine and 3
    more, bit for bit the unbroken run; then two ``evaluate`` calls on the
    test set, the second profiled."""
    from torch.profiler import ProfilerActivity, profile

    (xtr, ytr), (xte, yte) = synthetic_mnist()
    model = LeNet()
    it = DistributedIterator(xtr, ytr, BATCH, P, device=dev)
    batches = [b for _, b in zip(range(2 * ENGINE_RESUME_STEPS), iter(it))]
    path = root / "lenet"
    ops.reset_launch_counts()
    mpi.start(ranks=P)
    try:
        comm = mpi.current_communicator()

        def make():
            return AllReduceSGDEngine(make_loss_fn(model), init_params(model, seed=0), lr=LR,
                                      comm=comm)

        with counting(primitives, "tree_broadcast") as tree:
            unbroken = make()
            losses = [float(unbroken.step(b)) for b in batches]
            torch.cuda.synchronize()
        counts = ops.launch_counts()
        steps = len(batches)
        require(counts == counts_want(ring_allreduce=steps,
                                      accumulate=steps * list_launches(LENET_LEAVES),
                                      **lenet_vmap_launches(steps)),
                f"engine lenet: launches {counts}")
        require(len(tree) >= 1, "engine lenet: the first weight sync took no tree broadcast")
        first = make()
        first.checkpoint_every(ENGINE_RESUME_STEPS, path)
        resumed = [float(first.step(b)) for b in batches[:ENGINE_RESUME_STEPS]]
        first.flush_checkpoint()
        second = make()
        meta = ckpt.restore_engine_sharded(path, second)
        require(meta["step"] == ENGINE_RESUME_STEPS, f"engine lenet: checkpoint step {meta['step']}")
        resumed += [float(second.step(b)) for b in batches[ENGINE_RESUME_STEPS:]]
        require(resumed == losses, f"engine lenet: resumed losses {resumed} != {losses}")
        require(same_bits(live_state(second), live_state(unbroken)),
                "engine lenet: the resumed state differs from the unbroken run's")
        # (f) the eval cache
        apply_fn = lambda prm, x: torch.func.functional_call(model, prm, (x,))  # noqa: E731
        staged = []
        real_stage = second.stage_dataset
        second.stage_dataset = lambda x, y, **k: staged.append(1) or real_stage(x, y, **k)
        v1, first_ms = synced_ms(lambda: second.evaluate(apply_fn, xte, yte, accuracy))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            v2, _ = synced_ms(lambda: second.evaluate(apply_fn, xte, yte, accuracy))
        _, second_ms = synced_ms(lambda: second.evaluate(apply_fn, xte, yte, accuracy))
        h2d = sum(e.count for e in prof.key_averages() if "HtoD" in e.key)
        require(v1 == v2 and len(staged) == 1 and h2d == 0,
                f"engine eval cache: values {v1} / {v2}, staged {len(staged)} times, "
                f"{h2d} host-to-device copies in the second evaluate")
    finally:
        mpi.stop()
    return counts, {
        "lenet_resume": {"steps": steps, "checkpoint_step": ENGINE_RESUME_STEPS,
                         "bitwise": True, "losses": losses,
                         "launches_per_step": {"ring_allreduce": 1,
                                               "accumulate": list_launches(LENET_LEAVES)},
                         "first_sync": "tree broadcast (3.4 MB a rank, under the 4 MiB tree "
                                       "cutoff): 0 K7"},
        "eval_cache": {"value": v1, "staged": len(staged), "h2d_copies_second_call": h2d,
                       "first_ms": first_ms, "cached_ms": second_ms, "test_set": len(xte)},
    }


def engine_resnet_fsdp(dev, data, root: Path) -> tuple:
    """(b): ResNet-50 fsdp at config 4's widths, 32 a rank, p=8: 4 unbroken
    steps with the launches counted; then 2 steps with
    ``checkpoint_every(2)`` (the second a save boundary), the checkpoint
    reshaped 8 -> 4 -> 8 by the CLI (the files byte for byte the
    original's), restored into a fresh engine and 2 more steps, bit for
    bit the unbroken run; the host copy and the write of a save timed
    alone."""
    import subprocess as sp

    model = ResNet50(num_classes=RESNET["classes"], device=dev)
    steps = 2 * ENGINE_RESNET_STEPS
    (x, y), _ = data
    n = P * RESNET["per_rank"]
    batches = [resnet_batch(((x[i * n:], y[i * n:]), None), P, RESNET["per_rank"], dev)
               for i in range(steps)]
    ck8, ck4, ck8b = root / "rn8", root / "rn4", root / "rn8b"
    out = {}
    ops.reset_launch_counts()
    mpi.start(ranks=P)
    try:
        comm = mpi.current_communicator()

        def make():
            params, stats = init_resnet(model, RESNET["image"], seed=0)
            return AllReduceSGDEngine(
                make_stateful_loss_fn(model), params, comm=comm, model_state=stats,
                optimizer=SGD(RESNET["lr"], momentum=RESNET["momentum"]), param_sharding="fsdp")

        engine = make()
        losses = [float(engine.step(b)) for b in batches]
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        expected = sharded_expected(engine, steps)
        require(counts == expected["counts"],
                f"engine resnet fsdp: launches {counts} != {expected['counts']}")
        unbroken = [(k, v.cpu() if isinstance(v, torch.Tensor) else v)
                    for k, v in live_state(engine)]
        del engine
        torch.cuda.empty_cache()
        engine = make()
        engine.checkpoint_every(ENGINE_RESNET_STEPS, ck8)
        resumed, step_ms = [], []
        for b in batches[:ENGINE_RESNET_STEPS]:
            loss, ms = synced_ms(lambda b=b: engine.step(b))
            resumed.append(float(loss))
            step_ms.append(ms)
        _, flush_ms = synced_ms(lambda: engine.flush_checkpoint(timeout=600))
        # one save's parts alone: the host copy on the step thread, the files
        state, host_ms = synced_ms(lambda: ckpt.host_state(engine))
        t0 = time.perf_counter()
        ckpt.save_engine_sharded(root / "timed", engine, step=ENGINE_RESNET_STEPS, state=state)
        write_s = time.perf_counter() - t0
        del engine, state
        torch.cuda.empty_cache()
        data_dir = ckpt.current_data_dir(ck8)
        nbytes = sum(f.stat().st_size for f in data_dir.iterdir())
        cli = {}
        for src, dst, frm, world in ((ck8, ck4, P, P // 2), (ck4, ck8b, P // 2, P)):
            t0 = time.perf_counter()
            run = sp.run([sys.executable, "-m", "torchmpi_tpu_torch.reshard", "--from",
                          str(frm), "--to", str(world), str(src), str(dst), "--json"],
                         capture_output=True, text=True, cwd=str(Path(__file__).resolve().parent))
            require(run.returncode == 0, f"engine reshard CLI {src.name} -> {dst.name}: "
                                         f"{run.stderr[-2000:]}")
            stats = json.loads(run.stdout)
            require(stats["peak_scratch_bytes"] < 2 * stats["largest_shard_bytes"],
                    f"engine reshard CLI: scratch {stats['peak_scratch_bytes']} bytes")
            cli[f"{frm}to{world}"] = {
                "s": time.perf_counter() - t0, "moved_bytes": stats["moved_bytes"],
                "peak_scratch_bytes": stats["peak_scratch_bytes"],
                "largest_shard_bytes": stats["largest_shard_bytes"]}
        require(file_digests(ckpt.current_data_dir(ck8b)) == file_digests(data_dir),
                "engine reshard: 8 -> 4 -> 8 changed the files")
        engine = make()
        meta = ckpt.restore_engine_sharded(ck8b, engine)
        require(meta["step"] == ENGINE_RESNET_STEPS and meta["world"] == P,
                f"engine resnet fsdp: restored header {meta['step']}, {meta['world']}")
        resumed += [float(engine.step(b)) for b in batches[ENGINE_RESNET_STEPS:]]
        require(resumed == losses, f"engine resnet fsdp: resumed losses {resumed} != {losses}")
        require(same_bits(live_state(engine), unbroken),
                "engine resnet fsdp: the resumed state differs from the unbroken run's")
        del engine
        out = {"steps": steps, "checkpoint_step": ENGINE_RESNET_STEPS, "bitwise": True,
               "losses": losses, "launches_per_step": expected["per_step"],
               "checkpoint_bytes": nbytes, "files": len(list(data_dir.iterdir())),
               "host_copy_ms": host_ms, "write_s": write_s,
               "step_ms_no_boundary": step_ms[0], "step_ms_save_boundary": step_ms[1],
               "flush_wait_ms": flush_ms, "reshard_cli": cli}
    finally:
        mpi.stop()
    torch.cuda.empty_cache()
    return counts, out


def engine_telemetry(dev, data) -> tuple:
    """(c): ResNet-50 sync (replicated, the example's loop) with
    ``flops_per_sample``, an engine with telemetry off and one with it on,
    each ``ENGINE_TELEMETRY_STEPS`` warm-up and timed steps; the on run's
    launches counted and its ``tm_engine_*`` gauges read."""
    model = ResNet50(num_classes=RESNET["classes"], device=dev)
    fps = train_flops(resnet_forward_flops(RESNET["image"], num_classes=RESNET["classes"]))
    warm, timed = ENGINE_TELEMETRY_STEPS
    batch = resnet_batch(data, P, RESNET["per_rank"], dev)
    out, counts = {}, None
    mpi.start(ranks=P)
    try:
        comm = mpi.current_communicator()
        for on in (False, True):
            if on:
                mpi.telemetry.reset()
                mpi.telemetry.enable()
            ops.reset_launch_counts()
            params, stats = init_resnet(model, RESNET["image"], seed=0)
            engine = AllReduceSGDEngine(
                make_stateful_loss_fn(model), params, comm=comm, model_state=stats,
                optimizer=SGD(RESNET["lr"], momentum=RESNET["momentum"]), rank_map="loop",
                flops_per_sample=fps)
            for _ in range(warm):
                engine.step(batch)
            ms = [synced_ms(lambda: engine.step(batch))[1] for _ in range(timed)]
            if on:
                counts = ops.launch_counts()
                expected = resnet_expected(engine, warm + timed)
                require(counts == expected["counts"],
                        f"engine telemetry: launches {counts} != {expected['counts']}")
                snap = mpi.telemetry.metrics.snapshot()
                gauge = {name: snap[name]["series"].get("") for name in (
                    "tm_engine_mfu", "tm_engine_tflops_per_chip", "tm_engine_examples_per_sec",
                    "tm_engine_grad_norm")}
                hist = snap["tm_engine_step_seconds"]["series"][""]
                require(hist["count"] == warm + timed and gauge["tm_engine_mfu"] is not None
                        and 0 < gauge["tm_engine_mfu"] < 1,
                        f"engine telemetry: {hist['count']} steps recorded, gauges {gauge}")
                out["on"] = {"step_ms": ms, **gauge}
                mpi.telemetry.disable()
            else:
                out["off"] = {"step_ms": ms}
            del engine
            torch.cuda.empty_cache()
    finally:
        mpi.telemetry.disable()
        mpi.stop()
    out.update(flops_per_sample=fps, warmup_steps=warm)
    return counts, out


def engine_profile_window(dev, root: Path) -> dict:
    """(d): MNIST LeNet sync ``train`` with ``profile_dir`` and window
    (3, 5): the Chrome trace holds exactly two steps' K3 and K1 launches,
    by their CUDA kernel names."""
    (xtr, ytr), _ = synthetic_mnist()
    it = DistributedIterator(xtr, ytr, BATCH, P, device=dev)
    batches = [b for _, b in zip(range(6), iter(it))]
    mpi.start(ranks=P)
    try:
        model = LeNet()
        engine = AllReduceSGDEngine(make_loss_fn(model), init_params(model, seed=0), lr=LR,
                                    comm=mpi.current_communicator(),
                                    profile_dir=str(root / "trace"), profile_window=ENGINE_WINDOW)
        engine.train(lambda: iter(batches), max_epochs=1)
    finally:
        mpi.stop()
    traces = list((root / "trace").glob("*.json"))
    require(len(traces) == 1, f"engine profile window: {len(traces)} trace files")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    k3 = sum("ring_allreduce_kernel" in k for k in kernels)
    k1 = sum("many_kernel" in k for k in kernels)
    # the host's ranges (the card's timeline repeats the name per kernel)
    steps = [e for e in events
             if e.get("name") == "engine.step" and e.get("cat") == "user_annotation"]
    n = ENGINE_WINDOW[1] - ENGINE_WINDOW[0]
    require(k3 == n and k1 == n * list_launches(LENET_LEAVES) and len(steps) == n,
            f"engine profile window: {k3} K3, {k1} K1, {len(steps)} engine.step ranges in the "
            f"trace of steps {ENGINE_WINDOW}")
    return {"window": list(ENGINE_WINDOW), "k3": k3, "k1": k1, "engine_step_ranges": len(steps),
            "kernel_events": len(kernels), "trace_mb": traces[0].stat().st_size / 1e6}


def engine_scheduled(dev) -> tuple:
    """(e): ``GradientBuckets.sync_scheduled`` on config 2's buckets
    (LeNet, 4 asked, 2 made: 805,386 and 52,352 a rank) at p=8, the full
    and the int8 wire: 'none' and 'reverse' bit for bit, the launches of
    ``ENGINE_SCHED_REPS`` calls exact (the first bucket K3, or K4 int8;
    the second on the vendor path), the median ms of each schedule."""
    params = init_params(LeNet(), seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    runs, out = {}, {}
    mpi.start(ranks=P)
    try:
        comm = mpi.current_communicator()
        bkts = mpinn.GradientBuckets(params, 4)
        sizes = [sum(bkts.sizes[i] for i in b) for b in bkts.buckets]
        require(tuple(sizes) == CONFIG2_BUCKETS, f"engine scheduled: buckets {sizes}")
        grads = {k: torch.randn((P,) + tuple(v.shape), generator=gen, device=dev)
                 for k, v in params.items()}
        for wire in ("full", "int8"):
            res, row = {}, {}
            for sched in ("none", "reverse"):
                for _ in range(3):
                    bkts.sync_scheduled(grads, comm=comm, wire_dtype=wire, schedule=sched)
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                ms = []
                for _ in range(ENGINE_SCHED_REPS):
                    res[sched], t = synced_ms(lambda: bkts.sync_scheduled(
                        grads, comm=comm, wire_dtype=wire, schedule=sched))
                    ms.append(t)
                counts = ops.launch_counts()
                key = "ring_allreduce" if wire == "full" else "ring_allreduce_quant_int8"
                require(counts == counts_want(**{key: ENGINE_SCHED_REPS}),
                        f"engine scheduled {wire} {sched}: launches {counts}")
                runs[f"engine_sched_{wire}_{sched}"] = counts
                row[sched] = {"median_ms": statistics.median(ms), "min_ms": min(ms),
                              "max_ms": max(ms)}
            for k in grads:
                require(torch.equal(bits(res["none"][k]), bits(res["reverse"][k])),
                        f"engine scheduled {wire}: 'none' and 'reverse' differ at {k}")
            out[wire] = {**row, "bitwise": True}
    finally:
        mpi.stop()
    out.update(buckets=list(CONFIG2_BUCKETS), reps=ENGINE_SCHED_REPS)
    return runs, out


def phase_engine(dev) -> dict:
    """The engine's checkpoints, telemetry, profile window, scheduled
    bucket sync and eval cache ((a)-(f) of the module docstring), each
    path's launches counted; one ``{"engine": ...}`` line. The
    checkpoints live under ``_engine_ckpt/`` of the checkout, removed at
    the end. Returns each counted run's launch counts."""
    import shutil

    root = ENGINE_CKPT_ROOT
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    runs, line = {}, {}
    try:
        runs["engine_lenet"], lenet = engine_lenet(dev, root)
        line.update(lenet)
        line["profile_window"] = engine_profile_window(dev, root)
        sched_runs, line["scheduled"] = engine_scheduled(dev)
        runs.update(sched_runs)
        data = synthetic_imagenet(num_train=2 * ENGINE_RESNET_STEPS * P * RESNET["per_rank"],
                                  num_test=1, num_classes=RESNET["classes"],
                                  image_size=RESNET["image"])
        runs["engine_resnet50_fsdp"], line["resnet50_fsdp_resume"] = engine_resnet_fsdp(
            dev, data, root)
        runs["engine_resnet50_telemetry"], line["telemetry"] = engine_telemetry(dev, data)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"engine": {**line, "p": P, "card": card()}}))
    return runs


# ---------------------------------------------------------------------------
# observability beyond the core (--observe): the autotuner on the card, the
# tuning's reload, the live plane, the analyzer and the measured calibration
# ---------------------------------------------------------------------------

OBSERVE_SYNC_STEPS = 20  # config 1's sync steps with telemetry and the live plane on
OBSERVE_SCHED_REPS = 10  # config 2's scheduled int8 syncs beside them
OBSERVE_CAND_REPS = 5  # dispatches of each feasible candidate plan the calibration prices
OBSERVE_TURN_STEPS = 30  # MNIST sync steps a turn, A11 off and on
OBSERVE_WATCHDOG_S = 30.0  # the watchdog's timeout while armed: no step comes near it
OBSERVE_LIVE_S = 0.1  # the live exporter's interval while armed
TUNERS = ("tune_allreduce_cutoff", "tune_broadcast_cutoff", "tune_tree_pipeline_switch",
          "tune_chunk_size", "tune_ring_implementation", "tune_wire_dtype", "tune_plan",
          "tune_pipeline_depth", "tune_fusion_threshold", "tune_ps_chunk_bytes")


def kernel_allreduce(n: int, wire: str, impl: str) -> str:
    """The kernel an allreduce of ``n`` f32 elements a rank launches on
    the kernel backend: K4 where the compressed wire engages, else K5
    under 'kernel_bidir', else K3."""
    if wire in ("int8", "bf16") and n >= constants.get("wire_quant_min_elements"):
        return f"ring_allreduce_quant_{wire}"
    return "ring_allreduce_bidir" if impl == "kernel_bidir" else "ring_allreduce"


def fusion_dispatches(sizes, cap: int, min_tensors: int) -> list:
    """The per-rank widths a ``FusionBuffer`` dispatches for ``sizes``
    submitted in order then ``flush_all``: one at a time when ``cap`` is
    0; else a group flushes when its pending bytes reach ``cap``, as one
    fused dispatch of at least ``min_tensors`` tensors or one by one."""
    if cap <= 0:
        return list(sizes)
    out, pend = [], []

    def flush():
        out.extend([sum(pend)] if len(pend) >= min_tensors else pend)
        pend.clear()

    for n in sizes:
        pend.append(n)
        if sum(pend) * 4 >= cap:
            flush()
    if pend:
        flush()
    return out


def tuner_expected(name: str, kw: dict) -> dict:
    """The launches tuner ``name`` makes on the card with the arguments
    ``kw``, worked out from its loops and the constants as it starts: a
    measured configuration of ``run_one_config`` makes warmup + timed + 2
    calls (the checked first call, the warm-up, one more, the timed ones),
    a plan or a fusion candidate warmup + timed; the ``ring`` and vendor
    paths launch nothing, the kernel backend's allreduce one K3, K4 or K5
    (:func:`kernel_allreduce`), its broadcast one K7 above
    ``broadcast_size_tree_based_cuda`` bytes and the tree at or below (the
    ``_cuda`` column, on the card)."""
    from torchmpi_tpu_torch.collectives import eager
    from torchmpi_tpu_torch.schedule import generators
    from torchmpi_tpu_torch.schedule.topology import Topology
    from torchmpi_tpu_torch.utils import autotune

    want = dict.fromkeys(ops.launch_counts(), 0)
    if name == "tune_ps_chunk_bytes":
        return want
    impl, wire = constants.get("ring_implementation"), constants.get("wire_dtype")
    comm = mpi.current_communicator()
    kernel = autotune._custom_backend(comm) == "kernel"
    suffix = constants.platform_suffix(comm.device.type)
    calls = kw["warmup"] + kw["timed"] + 2
    laps = kw["warmup"] + kw["timed"]
    if name in ("tune_allreduce_cutoff", "tune_broadcast_cutoff", "tune_tree_pipeline_switch"):
        for n in sweep_sizes(kw["min_pow"], kw["max_pow"], jitter_seed=None):
            if not kernel:
                continue
            if name == "tune_allreduce_cutoff":
                want[kernel_allreduce(n, wire, impl)] += calls
            elif name == "tune_tree_pipeline_switch" or \
                    n * 4 > constants.get(f"broadcast_size_tree_based_{suffix}"):
                want["ring_broadcast"] += calls  # the tree pinned launches none
    elif name == "tune_ring_implementation":
        for candidate in ("kernel", "kernel_bidir"):
            want[kernel_allreduce(kw["nelem"], wire, candidate)] += calls
    elif name == "tune_wire_dtype" and kernel:
        for w in ("full", "bf16", "int8"):
            want[kernel_allreduce(kw["nelem"], w, impl)] += calls
    elif name == "tune_plan" and kernel:
        w = eager.resolve_wire_dtype("allreduce", kw["nelem"], torch.float32, None)
        gens = {c.plan.generator for c in generators.candidate_plans(
            "allreduce", kw["nelem"], 4, Topology.from_communicator(comm), "kernel",
            wire=w, route_small=True) if c.structural}
        require(gens == {"flat"}, f"tune_plan on one island: families {sorted(gens)}")
        want[kernel_allreduce(kw["nelem"], w, impl)] += laps
    elif name == "tune_fusion_threshold":
        for cap in kw["candidates"]:
            for n in fusion_dispatches(kw["leaf_sizes"] or autotune.LENET_LEAF_SIZES, cap,
                                       max(1, constants.get("fusion_min_tensors"))):
                if n > constants.get(f"small_allreduce_size_{suffix}"):
                    want[kernel_allreduce(n, wire, impl)] += laps
    return want


def observe_tune(dev) -> tuple:
    """(a): ``tune_all(quick=True)`` at p=8, each tuner's launches counted
    (0 just before, read just after) and held to :func:`tuner_expected`,
    every measured configuration's µs and correctness; then (b):
    ``save_tuning``, ``stop()``, the constants back at their defaults,
    ``start()``: the tuned constants and plan overrides come back. The
    saved tuning is then deleted, so later ``start()`` calls keep the
    defaults."""
    import inspect

    from torchmpi_tpu_torch.schedule import compiler as sched
    from torchmpi_tpu_torch.utils import autotune

    defaults = constants.snapshot()
    rows, runs, current = {}, {}, [None]
    real_roc = autotune.run_one_config
    real = {name: getattr(autotune, name) for name in TUNERS}

    def roc(op, nelem, comm, backend=None, **kw):
        res = real_roc(op, nelem, comm, backend=backend, **kw)
        rows[current[0]]["configs"].append(
            {"op": op, "backend": backend, "nelem": nelem, "us": res.mean_us,
             "correct": res.correct, "ring_implementation": constants.get("ring_implementation"),
             "wire_dtype": constants.get("wire_dtype")})
        return res

    def wrap(name):
        def tuner(*a, **k):
            kw = inspect.signature(real[name]).bind(*a, **k)
            kw.apply_defaults()
            want = tuner_expected(name, dict(kw.arguments))
            current[0] = name
            rows[name] = {"configs": []}
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            try:
                out = real[name](*a, **k)
            except NotImplementedError as exc:
                rows[name]["raised"] = str(exc)
                raise
            finally:
                torch.cuda.synchronize()
                counts = ops.launch_counts()
                runs[f"observe_{name}"] = counts
                rows[name]["launches"] = {k: v for k, v in counts.items() if v}
                require(counts == want, f"observe {name}: launches {counts} != {want}")
            rows[name].update(chosen=out[0], results=[list(r) for r in out[1]])
            return out
        return tuner

    mpi.start(ranks=P)
    try:
        autotune.run_one_config = roc
        for name in TUNERS:
            setattr(autotune, name, wrap(name))
        t0 = time.perf_counter()
        tuned = autotune.tune_all(quick=True)
        tune_s = time.perf_counter() - t0
    finally:
        autotune.run_one_config = real_roc
        for name, fn in real.items():
            setattr(autotune, name, fn)
    for name, row in rows.items():
        bad = [c for c in row["configs"] if not c["correct"]]
        require(not bad, f"observe {name}: incorrect runs {bad}")
        # a plan, depth or fusion candidate that failed reads (value, None, why)
        bad = [r for r in row.get("results", []) if r[1] is None]
        require(not bad, f"observe {name}: candidates failed {bad}")
    require("ROADMAP A13" in str(tuned["ps_chunk_bytes"]),
            f"observe: tune_all's ps_chunk_bytes {tuned['ps_chunk_bytes']!r}")
    names = [t.format(s=constants.platform_suffix(dev.type)) for t in autotune._TUNABLE]
    tuned_consts = {n: constants.get(n) for n in names}
    overrides = dict(sched.plan_overrides())
    try:
        path = autotune.save_tuning()
    finally:
        mpi.stop()
    for name, value in defaults.items():
        constants.set(name, value)
    sched.clear_plan_overrides()
    mpi.start(ranks=P)
    try:
        reloaded = {n: constants.get(n) for n in names}
        require(reloaded == tuned_consts, f"observe: start() reloaded {reloaded} != {tuned_consts}")
        require(sched.plan_overrides() == overrides,
                f"observe: start() reloaded plan overrides {sched.plan_overrides()} != {overrides}")
    finally:
        mpi.stop()
        # every later start() of this run reloads the defaults
        path.unlink()
    line = {"tune_all": tuned, "tune_s": tune_s, "tuners": rows, "cache": str(path),
            "reloaded": {n: {"tuned": tuned_consts[n], "default": defaults[n]} for n in names},
            "plan_overrides": overrides}
    return runs, line


def wait_frames(agg, more: int = 2, timeout: float = 10.0) -> None:
    """Wait until ``agg`` has taken ``more`` frames after this call."""
    mark = agg.frames_total
    deadline = time.time() + timeout
    while agg.frames_total < mark + more and time.time() < deadline:
        time.sleep(0.02)
    require(agg.frames_total >= mark + more, f"observe: the aggregator took {agg.frames_total - mark} "
            f"frames in {timeout} s")


def scrape(agg, path: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{agg.http_port}{path}", timeout=10) as r:
        return json.loads(r.read().decode())


@contextlib.contextmanager
def a11_armed(agg):
    """Telemetry and the flight recorder on, the hang watchdog armed
    (``OBSERVE_WATCHDOG_S``) and a live exporter streaming to ``agg``;
    all of it off again after the block."""
    from torchmpi_tpu_torch.telemetry import flightrecorder, live, watchdog

    mpi.telemetry.enable()
    wd = watchdog.start_watchdog(OBSERVE_WATCHDOG_S, interval=1.0)
    live.start_exporter(("127.0.0.1", agg.ingest_port), rank=0)
    try:
        yield wd
    finally:
        live.stop_exporter()
        watchdog.stop_watchdog()
        mpi.telemetry.disable()
        flightrecorder.disable()


def observe_live(dev, agg, root: Path) -> tuple:
    """(c): config 1's sync steps and config 2's scheduled int8 sync with
    telemetry, the flight recorder, the watchdog and a live exporter on,
    streaming to ``agg``: exact launches, the verdict ``clean`` on
    ``/verdicts`` and ``/health``, the int8 bucket's wire bytes, the
    analyzer on the dump (no desync, a critical path, an overlap ledger).
    Returns the counted runs, the line's part and the flight entries."""
    from torchmpi_tpu_torch.telemetry import analyze, flightrecorder
    from torchmpi_tpu_torch.utils import tracing

    runs, out = {}, {}
    telemetry = mpi.telemetry
    telemetry.reset()
    tracing.wire_stats.reset()
    mpi.start(ranks=P)
    try:
        comm = mpi.current_communicator()
        engine = mnist_engine(comm, "sync", "full")
        batches = mnist_batches(comm, OBSERVE_SYNC_STEPS)
        params = init_params(LeNet(), seed=0)
        bkts = mpinn.GradientBuckets(params, 4)
        gen = torch.Generator(device=dev).manual_seed(0)
        grads = {k: torch.randn((P,) + tuple(v.shape), generator=gen, device=dev)
                 for k, v in params.items()}
        with a11_armed(agg) as wd:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            for b in batches:
                engine.step(b)
            torch.cuda.synchronize()
            runs["observe_config1"] = ops.launch_counts()
            ops.reset_launch_counts()
            for _ in range(OBSERVE_SCHED_REPS):
                bkts.sync_scheduled(grads, comm=comm, wire_dtype="int8", schedule="reverse")
            torch.cuda.synchronize()
            runs["observe_config2_sched"] = ops.launch_counts()
            wait_frames(agg)
            health, verdicts = scrape(agg, "/health"), scrape(agg, "/verdicts")
            entries = flightrecorder.recorder.entries()
            require(not wd.hang_reports, f"observe: the watchdog reported {wd.hang_reports}")
            telemetry.dump(root / "telemetry_rank_0.json")
        wire = tracing.wire_stats.snapshot()
    finally:
        mpi.stop()
    require(runs["observe_config1"] == counts_want(
        ring_allreduce=OBSERVE_SYNC_STEPS,
        accumulate=OBSERVE_SYNC_STEPS * list_launches(LENET_LEAVES),
        **lenet_vmap_launches(OBSERVE_SYNC_STEPS)),
        f"observe: config 1 launches {runs['observe_config1']}")
    require(runs["observe_config2_sched"] == counts_want(
        ring_allreduce_quant_int8=OBSERVE_SCHED_REPS),
        f"observe: config 2 scheduled launches {runs['observe_config2_sched']}")
    require(verdicts["verdict"] == "clean", f"observe: live verdict {verdicts['verdict']} "
            f"({verdicts.get('summary')})")
    require("0" in health["ranks"], f"observe: /health ranks {list(health['ranks'])}")
    block = constants.get("wire_quant_block_size")
    want = (OBSERVE_SCHED_REPS, OBSERVE_SCHED_REPS * BUCKET0 * 4,
            OBSERVE_SCHED_REPS * primitives.wire_encoded_bytes(BUCKET0, 4, "int8", block))
    require(tuple(wire["by_format"].get("allreduce:int8", ())) == want,
            f"observe: int8 wire bytes {wire['by_format']} != {want}")
    report = analyze.analyze(root)
    require(report["desync"]["status"] == "none", f"observe: analyzer desync {report['desync']}")
    require(report["critical_path"].get("ranks"), "observe: the analyzer found no critical path")
    require(report["overlap"]["plans"], "observe: the analyzer found no overlap ledger")
    waits = [e for e in entries if e["comm"] == "handles"]
    out.update(
        verdict=verdicts["verdict"], summary=verdicts.get("summary"),
        health_rank0={k: v for k, v in health["ranks"]["0"].items()
                      if k in ("age_s", "seq_high_water", "frames", "step_p50_ms")},
        frames=agg.frames_total, entries=len(entries), wait_entries=len(waits),
        wire_stats=wire, critical_path={k: report["critical_path"].get(k) for k in
                                            ("fleet_buckets_us", "fleet_dominant", "coverage")},
        overlap=report["overlap"]["plans"], desync=report["desync"]["status"])
    return runs, out, entries


def select_choices(requests, backends) -> dict:
    """The plan ``select_plan`` picks for each (request, backend):
    ``requests`` maps a name to ``(comm, nelem)``."""
    from torchmpi_tpu_torch.collectives import eager
    from torchmpi_tpu_torch.schedule import select_plan
    from torchmpi_tpu_torch.schedule.topology import Topology

    out = {}
    for name, (c, n) in requests.items():
        for backend in backends:
            wire = eager.resolve_wire_dtype("allreduce", n, torch.float32, None)
            plan, _ = select_plan("allreduce", n, 4, Topology.from_communicator(c), backend,
                                  wire, True, comm=c)
            out[f"{name}/{backend}"] = plan.plan_id
    return out


def candidate_sweep(requests, backends) -> list:
    """Every feasible candidate plan of each (request, backend), dispatched
    ``OBSERVE_CAND_REPS`` times on the card (depth pinned through
    ``plan_pipeline_depth``) with the flight recorder on; returns the flight
    entries and the candidates the pin did not reproduce."""
    from torchmpi_tpu_torch.collectives import eager
    from torchmpi_tpu_torch.schedule import candidate_plans, compile_collective
    from torchmpi_tpu_torch.schedule import compiler as sched
    from torchmpi_tpu_torch.schedule.topology import Topology
    from torchmpi_tpu_torch.telemetry import flightrecorder

    unpinned = []
    flightrecorder.recorder.reset()
    flightrecorder.enable()
    try:
        for name, (c, n) in requests.items():
            x = torch.ones((P, n), device=c.device)
            for backend in backends:
                wire = eager.resolve_wire_dtype("allreduce", n, torch.float32, None)
                cands = candidate_plans("allreduce", n, 4, Topology.from_communicator(c),
                                        backend, wire=wire, route_small=True)
                # known to plan_by_id, so the calibration prices each one
                sched._register_plans(cands)
                for cand in cands:
                    if not cand.feasible:
                        continue
                    plan = cand.plan
                    with constants_set({"plan_pipeline_depth": max(1, plan.pipeline)}):
                        ep = compile_collective("allreduce", (P, n), torch.float32, c,
                                                backend=plan.backend, generator=plan.generator,
                                                impl=plan.impl or plan.backend, wire_override=wire)
                        if ep.plan_id != plan.plan_id:
                            # a candidate the pin does not reproduce stays unmeasured
                            unpinned.append([plan.plan_id, ep.plan_id])
                            continue
                        for _ in range(OBSERVE_CAND_REPS):
                            out = ep.execute(x)
                    torch.cuda.synchronize()
                    require(bool((out == P).all()), f"observe: candidate {plan.plan_id} summed wrong")
        return flightrecorder.recorder.entries(), unpinned
    finally:
        flightrecorder.disable()


def observe_calibrate(entries: list) -> dict:
    """(d): the measured calibration from (c)'s flight entries, then from
    those and a sweep of every feasible candidate of config 1's flush
    ([8, 857738]) and config 5's buckets (on its 2 hosts of 4), on the
    ``kernel`` and ``ring`` backends: the modeled against the measured µs
    of every plan, and the plan ``select_plan`` picks for each request
    before and after. The dispatch entries complete when the host has
    issued the work, so the samples price the host's dispatch."""
    from torchmpi_tpu_torch import schedule
    from torchmpi_tpu_torch.telemetry import calibrate

    out = {}
    backends = ("kernel", "ring")
    schedule.clear_calibration()
    mpi.start(ranks=P)
    try:
        flat = mpi.current_communicator()
        mpi.push_communicator(lambda r: f"host{r // CONFIG5_I}", name="hosts")  # the twin's
        hosts = mpi.current_communicator()
        requests = {"config1_flush": (flat, LENET_PARAMS)}
        requests.update({f"config5_bucket{i}": (hosts, n) for i, n in enumerate(CONFIG5_BUCKETS)})
        before = select_choices(requests, backends)
        stages = {}
        store = calibrate.samples_from_entries(entries)
        stages["c_entries"] = schedule.calibrate(store)
        after_c = select_choices(requests, backends)
        sweep, out["unpinned"] = candidate_sweep(requests, backends)
        calibrate.samples_from_entries(sweep, store)
        stages["c_and_sweep"] = schedule.calibrate(store)
        after = select_choices(requests, backends)
    finally:
        mpi.stop()
        schedule.clear_calibration()
    for stage, res in stages.items():
        out[stage] = {
            "report": res["report"], "applied": res["applied"],
            "plans": {key: {k: row.get(k) for k in ("us", "n", "modeled_us", "fitted_us")}
                      for key, row in res["table"].items()}}
    out["choices"] = {req: {"analytic": before[req], "calibrated_c": after_c[req],
                            "calibrated_sweep": after[req],
                            "changed": before[req] != after[req]} for req in before}
    out["note"] = ("dispatch entries complete when the host has issued the work: the samples "
                   "price the host's dispatch, not the card's time")
    return out


def observe_turns(dev, agg) -> dict:
    """(e): the MNIST sync step (config 1) with A11 off and with every
    piece armed (:func:`a11_armed`), ``OBSERVE_TURN_STEPS`` steps a turn,
    in turns (off, on, on, off): ms a step."""
    mpi.start(ranks=P)
    try:
        comm = mpi.current_communicator()
        engine = mnist_engine(comm, "sync", "full")
        batches = mnist_batches(comm, OBSERVE_TURN_STEPS)

        def step_ms(on: bool) -> float:
            with a11_armed(agg) if on else contextlib.nullcontext():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for b in batches:
                    engine.step(b)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3 / len(batches)

        step_ms(False)  # warm
        return {"turns_ms": [("off", step_ms(False)), ("on", step_ms(True)),
                             ("on", step_ms(True)), ("off", step_ms(False))],
                "steps": len(batches)}
    finally:
        mpi.stop()


def phase_observe(dev) -> dict:
    """Observability beyond the core on the card ((a)-(e)): the autotuner
    (:func:`observe_tune`), the live plane and the analyzer
    (:func:`observe_live`), the measured calibration
    (:func:`observe_calibrate`) and A11's cost on the MNIST sync step
    (:func:`observe_turns`). The constants, plan overrides and calibration
    are restored when the phase ends; the dump lives in a temporary
    directory, removed at the end. One ``{"observe": ...}`` line; returns
    each counted run's launch counts."""
    from torchmpi_tpu_torch import schedule
    from torchmpi_tpu_torch.schedule import compiler as sched
    from torchmpi_tpu_torch.telemetry import live

    before = constants.snapshot()
    overrides = dict(sched.plan_overrides())
    root = Path(tempfile.mkdtemp(prefix="observe-"))
    agg = live.FleetAggregator()
    line = {}
    try:
        runs, line["tune"] = observe_tune(dev)
        for name, value in before.items():
            constants.set(name, value)
        sched.clear_plan_overrides()
        constants.set("telemetry_live_interval_s", OBSERVE_LIVE_S)
        agg.serve()
        live_runs, line["live"], entries = observe_live(dev, agg, root)
        runs.update(live_runs)
        line["calibration"] = observe_calibrate(entries)
        line["a11_cost"] = observe_turns(dev, agg)
    finally:
        agg.close()
        shutil.rmtree(root, ignore_errors=True)
        for name, value in before.items():
            constants.set(name, value)
        sched.clear_plan_overrides()
        sched.apply_plan_overrides(overrides)
        schedule.clear_calibration()
    print(json.dumps({"observe": {**line, "p": P, "card": card()}}, default=str))
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


def device_rows(prof) -> list:
    """``(device us, kernel name, calls)`` of every device kernel in a
    profile, largest first. Device-side events only: a host op's "self"
    device time repeats the time of the kernels it launched, which are
    listed on their own."""
    return sorted(
        (
            (e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        ),
        reverse=True,
    )


def print_profile(prof, wall_us: float, steps: int, path: str, **fields) -> dict:
    """One ``{"profile": ...}`` line: device time by kernel per step and the
    share of the window the device was busy, and ``fields`` as they are.
    Returns the line's object."""
    rows = device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    row = {
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
    }
    print(json.dumps({"profile": row}))
    return row


def phase_profile_lm(dev, lm: dict) -> None:
    """Where an LM step's time goes (``kernel_full``, full width): 2 steps
    profiled after 1 warm-up step (K8 is ``fwd_mma_kernel``, K10's two
    launches are ``bwd_dq_mma_kernel`` and ``bwd_dkv_mma_kernel``), with the
    unprofiled run's step time, tokens/sec/chip and MFU (``lm``)."""
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


def bound(nbytes: int, nops: int, tensor_cores: bool = False, bf16: bool = False) -> tuple:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the f32 rate, on the CUDA
    cores or, for work the tensor cores can do, as 3xTF32 (f32 inputs) or
    at the bf16 rate (bf16 inputs)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if tensor_cores and bf16:
        by_ops, ops_name = nops / BF16_OPS_PER_S * 1e3, "operations (bf16)"
    elif tensor_cores:
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


def timing_rows(randn) -> list:
    """The kernels line's rows: each kernel at its main path's shape, with
    its plain version, its library call (or None), the bytes and operations
    of its bound and the inputs ``make`` draws with ``randn``."""
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
    # the ResNet path's shapes: K3 at its largest fused flush, K1 and K2 at
    # its largest leaf (K2 as the momentum trace, g + 0.9 m), K7 at the
    # first parameter sync (every parameter, one fused broadcast)
    flush, leaf, whole = RESNET_FLUSH, list(RESNET_LARGEST_LEAF), RESNET_PARAMS
    leaf_n = math.prod(leaf)
    momentum = RESNET["momentum"]
    rows += [
        dict(
            name="ring_allreduce", at="ResNet-50 sync, its largest fused gradient flush",
            err="ring_allreduce@resnet",
            source="torchmpi_tpu_torch/csrc/ring_kernels.cu",
            replaces="torchmpi_tpu/ops/ring_kernels.py:201",
            shape=[P, flush], make=lambda: (randn(P, flush),), in_bytes=P * flush * 4,
            bytes=2 * P * flush * 4, ops=(P - 1) * flush,
            kernel=ops.ring_allreduce, plain=ops.ring_allreduce_plain,
            library=lambda x: x.sum(0, keepdim=True).expand_as(x).contiguous(),
        ),
        dict(
            name="accumulate", at="ResNet-50, the update of its largest leaf",
            err="accumulate@resnet",
            source="torchmpi_tpu_torch/csrc/reduce_kernel.cu",
            replaces="torchmpi_tpu/ops/reduce_kernel.py:28",
            shape=[P, *leaf], make=lambda: (randn(P, *leaf), randn(P, *leaf)),
            in_bytes=2 * P * leaf_n * 4, bytes=3 * P * leaf_n * 4, ops=P * leaf_n,
            kernel=ops.accumulate, plain=ops.accumulate_plain, library=torch.add,
        ),
        dict(
            name="scale_accumulate", at="ResNet-50, the momentum trace of its largest leaf",
            err="scale_accumulate@resnet",
            source="torchmpi_tpu_torch/csrc/reduce_kernel.cu",
            replaces="torchmpi_tpu/ops/reduce_kernel.py:32",
            shape=[P, *leaf], make=lambda: (randn(P, *leaf), randn(P, *leaf)),
            in_bytes=2 * P * leaf_n * 4, bytes=3 * P * leaf_n * 4, ops=2 * P * leaf_n,
            kernel=lambda a, b: ops.scale_accumulate(a, b, momentum),
            plain=lambda a, b: ops.scale_accumulate_plain(a, b, momentum),
            library=lambda a, b: torch.add(a, b, alpha=momentum),
        ),
        # the engine's whole update and momentum trace of a ResNet-50 step:
        # one list call over its 161 leaves (list_launches launches each)
        dict(
            name="accumulate", at="ResNet-50 step, the update of all 161 leaves in one call",
            err="accumulate_many@resnet",
            source="torchmpi_tpu_torch/csrc/reduce_kernel.cu",
            replaces="torchmpi_tpu/ops/reduce_kernel.py:28",
            shape=[P, RESNET_PARAMS], make=lambda: step_leaves(randn),
            in_bytes=2 * P * RESNET_PARAMS * 4, bytes=RESNET_STEP_BYTES, ops=P * RESNET_PARAMS,
            kernel=ops.accumulate_many, plain=ops.accumulate_many_plain,
            library=torch._foreach_add, timing=LIST_TIMING,
        ),
        dict(
            name="scale_accumulate",
            at="ResNet-50 step, the momentum trace of all 161 leaves in one call",
            err="scale_accumulate_many@resnet",
            source="torchmpi_tpu_torch/csrc/reduce_kernel.cu",
            replaces="torchmpi_tpu/ops/reduce_kernel.py:32",
            shape=[P, RESNET_PARAMS], make=lambda: step_leaves(randn),
            in_bytes=2 * P * RESNET_PARAMS * 4, bytes=RESNET_STEP_BYTES, ops=2 * P * RESNET_PARAMS,
            kernel=lambda a, b: ops.scale_accumulate_many(a, b, momentum),
            plain=lambda a, b: ops.scale_accumulate_many_plain(a, b, momentum),
            library=lambda a, b: torch._foreach_add(a, b, alpha=momentum), timing=LIST_TIMING,
        ),
        # the sharded path (fsdp): K3 'rs' at its largest packed flush, 'ag'
        # at its packed parameter shards
        dict(
            name="ring_reduce_scatter", at="ResNet-50 fsdp, its largest packed reduce-scatter flush",
            err="ring_reduce_scatter@fsdp", per_step=("sharded_", SHARDED_STEPS),
            source="torchmpi_tpu_torch/csrc/ring_kernels.cu",
            replaces="torchmpi_tpu/ops/ring_kernels.py:201",
            shape=[P, flush], make=lambda: (randn(P, flush),), in_bytes=P * flush * 4,
            bytes=(P + 1) * flush * 4, ops=(P - 1) * flush,
            kernel=ops.ring_reduce_scatter, plain=ops.ring_reduce_scatter_plain,
            library=lambda x: x.sum(0),
        ),
        dict(
            name="ring_allgather", at="ResNet-50 fsdp, its parameter allgather",
            err="ring_allgather@fsdp", per_step=("sharded_", SHARDED_STEPS),
            source="torchmpi_tpu_torch/csrc/ring_kernels.cu",
            replaces="torchmpi_tpu/ops/ring_kernels.py:201",
            shape=[P, RESNET_GATHER], make=lambda: (randn(P, RESNET_GATHER),),
            in_bytes=P * RESNET_GATHER * 4, bytes=(P + P * P) * RESNET_GATHER * 4, ops=0,
            kernel=ops.ring_allgather, plain=ops.ring_allgather_plain,
            library=lambda x: x.reshape(1, -1).expand(P, -1).contiguous(),
        ),
        dict(
            name="ring_broadcast", at="ResNet-50, the first parameter sync",
            err="ring_broadcast@resnet",
            source="torchmpi_tpu_torch/csrc/ring_kernels.cu",
            replaces="torchmpi_tpu/ops/ring_kernels.py:1282",
            shape=[P, whole], make=lambda: (randn(P, whole),), in_bytes=P * whole * 4,
            bytes=(1 + P) * whole * 4, ops=0,
            kernel=lambda x: ops.ring_broadcast(x, 0),
            plain=lambda x: ops.ring_broadcast_plain(x, 0),
            library=lambda x: x[0:1].expand_as(x).clone(),
        ),
    ]
    # the LM engine path's shapes (bench widths): K3 at its largest fused
    # flush, K7 at its first parameter sync, K1 over its leaves (the Adam
    # update, one list call)
    lm_shapes = lm_engine_shapes()
    lm_flush, lm_whole = max(lm_engine_flushes()), sum(math.prod(sh) for sh in lm_shapes)
    lm_per_step = ("lm_engine", LM_ENGINE_STEPS)
    rows += [
        dict(
            name="ring_allreduce", at="LM engine, its largest fused gradient flush",
            err="ring_allreduce@lm", per_step=lm_per_step,
            source="torchmpi_tpu_torch/csrc/ring_kernels.cu",
            replaces="torchmpi_tpu/ops/ring_kernels.py:201",
            shape=[P, lm_flush], make=lambda: (randn(P, lm_flush),), in_bytes=P * lm_flush * 4,
            bytes=2 * P * lm_flush * 4, ops=(P - 1) * lm_flush,
            kernel=ops.ring_allreduce, plain=ops.ring_allreduce_plain,
            library=lambda x: x.sum(0, keepdim=True).expand_as(x).contiguous(),
        ),
        dict(
            name="ring_broadcast", at="LM engine, the first parameter sync",
            err="ring_broadcast@lm", per_step=lm_per_step,
            source="torchmpi_tpu_torch/csrc/ring_kernels.cu",
            replaces="torchmpi_tpu/ops/ring_kernels.py:1282",
            shape=[P, lm_whole], make=lambda: (randn(P, lm_whole),), in_bytes=P * lm_whole * 4,
            bytes=(1 + P) * lm_whole * 4, ops=0,
            kernel=lambda x: ops.ring_broadcast(x, 0),
            plain=lambda x: ops.ring_broadcast_plain(x, 0),
            library=lambda x: x[0:1].expand_as(x).clone(),
        ),
        dict(
            name="accumulate",
            at=f"LM engine step, the update of all {len(lm_shapes)} leaves in one call",
            err="accumulate_many@lm", per_step=lm_per_step,
            source="torchmpi_tpu_torch/csrc/reduce_kernel.cu",
            replaces="torchmpi_tpu/ops/reduce_kernel.py:28",
            shape=[P, lm_whole],
            make=lambda: tuple([randn(P, *sh) for sh in lm_shapes] for _ in range(2)),
            in_bytes=2 * P * lm_whole * 4, bytes=3 * P * lm_whole * 4, ops=P * lm_whole,
            kernel=ops.accumulate_many, plain=ops.accumulate_many_plain,
            library=torch._foreach_add, timing=LIST_TIMING,
        ),
    ]
    # config 5 (2 hosts of 4): the intra phase of its largest bucket and a
    # two-level allreduce's at 2^23, the grouped K3 (one launch over both
    # hosts), and its first parameter sync's intra broadcast, the grouped
    # K7; the library calls are each host's sum, or its root row, expanded
    c5g, c5i = CONFIG5_G, CONFIG5_I
    for width, err in ((CONFIG5_BUCKET, "config5"), (N23, "2^23")):
        rows.append(dict(
            name="ring_allreduce", at=f"config 5, the two-level intra phase at [{P}, {width}], "
            f"{c5g} hosts of {c5i} in one launch",
            err=f"ring_allreduce@grouped_{width}", per_step=("hier_", CONFIG5_STEPS),
            source="torchmpi_tpu_torch/csrc/ring_kernels.cu",
            replaces="torchmpi_tpu/ops/ring_kernels.py:201",
            shape=[P, width], make=lambda w=width: (randn(P, w),), in_bytes=P * width * 4,
            bytes=2 * P * width * 4, ops=(c5i - 1) * c5g * width,
            kernel=lambda x: ops.ring_allreduce(x, groups=c5g),
            plain=lambda x: ops.ring_allreduce_plain(x, c5g),
            library=lambda x, w=width: x.view(c5g, c5i, w).sum(1, keepdim=True).expand(
                c5g, c5i, w).reshape(P, w),
        ))
    c5p = CONFIG5_PARAMS
    rows.append(dict(
        name="ring_broadcast", at=f"config 5, the first parameter sync's intra broadcast, "
        f"{c5g} hosts of {c5i} in one launch",
        err=f"ring_broadcast@grouped_{c5p}", per_step=("hier_", CONFIG5_STEPS),
        source="torchmpi_tpu_torch/csrc/ring_kernels.cu",
        replaces="torchmpi_tpu/ops/ring_kernels.py:1282",
        shape=[P, c5p], make=lambda: (randn(P, c5p),), in_bytes=P * c5p * 4,
        bytes=c5g * (1 + c5i) * c5p * 4, ops=0,
        kernel=lambda x: ops.ring_broadcast(x, 0, groups=c5g),
        plain=lambda x: ops.ring_broadcast_plain(x, 0, c5g),
        library=lambda x: x.view(c5g, c5i, c5p)[:, :1].expand(c5g, c5i, c5p).reshape(P, c5p),
    ))
    for wire in WIRES:
        # per element and hop: int8 |v|, max, divide, two adds that round,
        # then a multiply and an add (one FMA in the reduce-scatter); bf16 a
        # cast and an add
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
            # not K6's function: the sum of the root's row alone, where the
            # kernel also writes the other p-1 rows
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
        wgrad_row(randn),
        bmm_row(randn),
    ]
    # ring attention at the LM path's shape, f32, causal; the bound counts
    # the useful products: the T(T+1)/2 (query, key) pairs the causal mask
    # keeps over the gathered T = sp*n per cell, 4 d flops each forward and
    # 10 d backward, at the 3xTF32 rate (the tensor cores could do the work
    # at f32 accuracy), with the CUDA cores' f32 bound beside it; the
    # library call is SDPA over the gathered sequence [b, h, T, d] (and its
    # backward)
    rows += attention_rows(randn, torch.float32)
    # K8 and K10 in bf16 at the same shape, as the bf16 and remat sp LM
    # runs them (bf16 inputs: the bound at the bf16 tensor-core rate)
    rows += [dict(r, at="the bf16 sp LM, with and without remat",
                  err=f"{r['name']}@lm_bf16", per_step=("lm_bf16", LM_CHECK_STEPS))
             for r in attention_rows(randn, torch.bfloat16)
             if r["name"] != "ring_attention_fwd_bidir"]
    return rows


def attention_rows(randn, dtype) -> list:
    """The kernels line's rows of K8, K9 and K10 at the LM path's shape,
    causal, on ``dtype`` inputs (the lse is f32 for every dtype)."""
    asp, ab, an, ah, ad = ATTN_MAIN
    pair_flops = ab * ah * (asp * an) * (asp * an + 1) // 2 * ad
    size = torch.finfo(dtype).bits // 8
    qkv_bytes, lse_bytes = asp * ab * an * ah * ad * size, asp * ab * ah * an * 4

    def draw(*shape):
        return randn(*shape).to(dtype)

    def qkv():
        return tuple(draw(*ATTN_MAIN) for _ in range(3))

    def bwd_inputs():
        q, k, v = qkv()
        return (q, k, v, *ops.ring_attention_fwd_plain(q, k, v, True), draw(*ATTN_MAIN))

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def gathered():
        return tuple(t.permute(1, 3, 0, 2, 4).reshape(ab, ah, asp * an, ad) for t in qkv())

    def sdpa_graph():
        leaves = [t.requires_grad_() for t in gathered()]
        return sdpa(*leaves, is_causal=True), leaves, draw(ab, ah, asp * an, ad)

    source = "ring_attention_bf16.cu" if dtype == torch.bfloat16 else "ring_attention.cu"
    attn = dict(source=f"torchmpi_tpu_torch/csrc/{source}", shape=list(ATTN_MAIN),
                causal=True, tensor_cores=True, dtype=str(dtype)[6:])
    return [
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


def step_leaves(randn) -> tuple:
    """Two lists of ResNet-50's 161 rank-stacked leaves: a step's parameters
    and updates (or gradients and traces)."""
    shapes = resnet_leaf_shapes()
    return [randn(*sh) for sh in shapes], [randn(*sh) for sh in shapes]


def time_rows(rows: list, runs: dict, errs: dict, launch_floor_ms: float) -> list:
    """Time each row's kernel, plain version and library call on inputs
    rotated past the L2 (:func:`rotating`); bound_ms counts each input read
    once and each output written once. ``launches`` is the sum over the
    driven paths (``runs``: path -> launch counts), split in
    ``launches_by_path``."""
    out = []
    for r in rows:
        def timed(fn, make=r["make"]):
            return time_ms(rotating(fn, make, r["in_bytes"]), **r.get("timing", {}))

        ms = timed(r["kernel"])
        bound_ms, bound_by = bound(r["bytes"], r["ops"], r.get("tensor_cores", False),
                                   r.get("dtype") == "bfloat16")
        require(bound_ms <= ms, f"{r['name']}: {ms} ms is under its bound {bound_ms} ms")
        by_path = {path: counts[r["name"]] for path, counts in runs.items()}
        row = {
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": errs.get(r.get("err", r["name"])), "ms": ms, "kernel_ms": ms,
            "plain_ms": timed(r["plain"]),
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes a requantizing ring; the
            # attention rows' library calls take the gathered layout
            "library_ms": r["library"] and timed(r["library"], r.get("library_make", r["make"])),
            "shape": r["shape"], "dtype": r.get("dtype", "float32"),
        }
        if "at" in r:
            row["at"] = r["at"]
            prefix, steps = r.get("per_step", ("resnet_", RESNET_STEPS))
            row[f"launches_per_{prefix.rstrip('_')}_step"] = {
                path: counts[r["name"]] / steps for path, counts in runs.items()
                if path.startswith(prefix)}
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
                # one launch of a kernel that does nothing, by the same
                # time_ms: the floor under any one-launch apply
                "launch_floor_ms": launch_floor_ms,
                "launches_per_ps_step": {path: counts[r["name"]] / PS_STEPS
                                         for path, counts in runs.items() if path.startswith("ps_")},
            })
        if "k3" in r:
            row["k3_f32_ms"] = timed(r["k3"])  # K3's f32 ring at the same shape
        out.append(row)
    return out


def host_us(fn, reps: int = 100) -> float:
    """The median host time of ``fn`` in microseconds, after 10 warm-up
    calls, the device drained every 10 calls (outside the timed calls)."""
    times = []
    for i in range(10 + reps):
        if i % 10 == 0:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if i >= 10:
            times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def in_turns(dev, kernel, library, n: int) -> dict:
    """``kernel`` and ``library`` on [8, n] f32 inputs rotated past the L2,
    timed in turns (kernel, library, library, kernel, twice over) by
    :func:`time_ms`: four readings each, in ms."""
    gen = torch.Generator(device=dev).manual_seed(3)

    def make():
        return (torch.randn((P, n), generator=gen, device=dev),)

    fns = {"kernel_ms": rotating(kernel, make, P * n * 4),
           "library_ms": rotating(library, make, P * n * 4)}
    readings: dict = {name: [] for name in fns}
    for name in ["kernel_ms", "library_ms", "library_ms", "kernel_ms"] * 2:
        readings[name].append(time_ms(fns[name]))
    return readings


def phase_rs_retime(dev) -> None:
    """K3 'rs' (``ring_reduce_scatter``) against ``x.sum(0)`` at [8, 2^23],
    the kernels line's shapes and calls, and, beside it, the sharded path's
    K3 'rs' at its largest packed flush against ``x.sum(0)`` and K3 'ag' at
    its packed parameter gather against expand-copy, each timed in turns
    (:func:`in_turns`): one ``{"rs_retime": ...}`` line of ms."""
    rs = in_turns(dev, ops.ring_reduce_scatter, lambda x: x.sum(0), N23)
    fsdp_rs = in_turns(dev, ops.ring_reduce_scatter, lambda x: x.sum(0), RESNET_FLUSH)
    fsdp_ag = in_turns(dev, ops.ring_allgather,
                       lambda x: x.reshape(1, -1).expand(P, -1).contiguous(), RESNET_GATHER)
    print(json.dumps({"rs_retime": {
        "kernel_ms": rs["kernel_ms"], "x_sum0_ms": rs["library_ms"], "shape": [P, N23],
        "bound_ms": (P + 1) * N23 * 4 / HBM_BYTES_PER_S * 1e3,
        "fsdp_rs": {**fsdp_rs, "library": "x.sum(0)", "shape": [P, RESNET_FLUSH],
                    "bound_ms": (P + 1) * RESNET_FLUSH * 4 / HBM_BYTES_PER_S * 1e3},
        "fsdp_ag": {**fsdp_ag, "library": "expand-copy", "shape": [P, RESNET_GATHER],
                    "bound_ms": (P + P * P) * RESNET_GATHER * 4 / HBM_BYTES_PER_S * 1e3},
        "card": card()}}))


def launch_floor_ms() -> float:
    """The device time of one launch of a kernel that does no work
    (PyTorch's spin kernel told to spin 0 cycles), by :func:`time_ms`."""
    return time_ms(lambda: torch.cuda._sleep(0))


def streamed_run(argv: list) -> dict:
    """One run of the ResNet example, every launch count set to 0 just
    before it and read just after; telemetry is switched on once the
    engine is built (the engine's own step telemetry stays off) so the
    pipeline's tm_input_* families are live. Keeps a device copy of every
    batch the engine receives, every step's loss, the end time of each
    epoch and the queue depth at each delivery."""
    run = {"samples": [], "losses": [], "ends": [], "depths": []}
    depth = telemetry.metrics.gauge("tm_input_queue_depth")
    hooks = {
        "on_start": lambda s: telemetry.enable(),
        "on_sample": lambda s: (run["samples"].append(
            (s["epoch"], [t.clone() for t in s["sample"]])), run["depths"].append(depth.value())),
        "on_forward": lambda s: run["losses"].append(s["loss"].detach().clone()),
        "on_end_epoch": lambda s: run["ends"].append(time.perf_counter()),
    }
    stall0 = (telemetry.metrics.counter("tm_input_producer_stall_seconds").total(),
              telemetry.metrics.counter("tm_input_consumer_stall_seconds").total())
    ops.reset_launch_counts()
    try:
        state, acc = resnet_allreduce.main(argv, hooks=hooks)
        torch.cuda.synchronize()
        run["counts"] = ops.launch_counts()
    finally:
        telemetry.disable()
    run["producer_stall_s"] = (telemetry.metrics.counter("tm_input_producer_stall_seconds").total()
                               - stall0[0])
    run["consumer_stall_metric_s"] = (
        telemetry.metrics.counter("tm_input_consumer_stall_seconds").total() - stall0[1])
    run.update(state=state, acc=acc)
    return run


def phase_streaming(dev) -> dict:
    """The streamed ResNet path (``resnet_allreduce.main([... '--streaming',
    '--input-workers', '2'])``) at full width: every batch the engine
    received, on the card, equal bit for bit to ``source.gather`` of the
    pipeline's ``batch_indices`` on the host; every step's loss equal bit for
    bit to the same engine's driven by a plain iterator of those host
    batches in the same order; launches exact (:func:`resnet_expected`, as
    the resident run's); the same example resident for img/s. Prints the
    ``{"streaming"}`` line and returns the run's launch counts."""
    streamed = streamed_run(STREAM_ARGS + ["--streaming", "--input-workers",
                                           str(STREAM["workers"])])
    state = streamed["state"]
    pipe, engine = state["pipeline"], state["engine"]
    steps_per_epoch = len(pipe)
    require(state["t"] == STREAM["epochs"] * steps_per_epoch == len(streamed["samples"]),
            f"streaming: {state['t']} steps, {len(streamed['samples'])} batches")
    require(pipe.workers == STREAM["workers"], f"streaming: {pipe.workers} producers")
    expected = resnet_expected(engine, state["t"])
    require(streamed["counts"] == expected["counts"],
            f"streaming: launches {streamed['counts']} != {expected['counts']}")
    del engine, state["engine"]
    (xtr, ytr), _ = synthetic_imagenet(num_train=STREAM["train"], num_test=RESNET["test"],
                                       num_classes=RESNET["classes"], image_size=RESNET["image"])
    src = ArraySource(xtr, ytr)
    host = []
    for i, (epoch, (xb, yb)) in enumerate(streamed["samples"]):
        want = [torch.from_numpy(a) for a in src.gather(pipe.batch_indices(epoch, i % steps_per_epoch))]
        require(xb.device.type == dev.type and torch.equal(bits(xb.cpu()), bits(want[0]))
                and torch.equal(yb.cpu(), want[1]),
                f"streaming: batch {i % steps_per_epoch} of epoch {epoch} differs from the host's")
        host.append(want)
    streamed["samples"].clear()
    print(f"streaming: every one of {len(host)} streamed batches equals source.gather of its "
          "indices bit for bit")

    # the same engine on a plain iterator of the same host batches
    mpi.start(ranks=P)
    try:
        engine = resnet_engine(ResNet50(num_classes=RESNET["classes"], device=dev),
                               mpi.current_communicator(), "sync")
        plain = []
        engine.hooks["on_forward"] = lambda s: plain.append(s["loss"].detach().clone())
        epochs = iter([host[:steps_per_epoch], host[steps_per_epoch:]])
        engine.train(lambda: iter(next(epochs)), max_epochs=STREAM["epochs"])
        torch.cuda.synchronize()
        del engine
    finally:
        mpi.stop()
    losses = [float(v) for v in streamed["losses"]]
    require(len(plain) == len(losses)
            and all(torch.equal(bits(a), bits(b)) for a, b in zip(streamed["losses"], plain)),
            f"streaming: losses {losses} != the plain iterator's {[float(v) for v in plain]}")
    require(all(np.isfinite(losses)), f"streaming: non-finite loss {losses}")
    print(f"streaming: {len(losses)} step losses equal the plain iterator's bit for bit "
          f"({losses[0]:.4f} -> {losses[-1]:.4f})")
    torch.cuda.empty_cache()

    resident = streamed_run(STREAM_ARGS)
    rstate = resident["state"]
    del rstate["engine"]
    torch.cuda.empty_cache()
    batch = P * RESNET["per_rank"]
    steady = (STREAM["epochs"] - 1) * steps_per_epoch * batch
    streamed_ips = steady / (streamed["ends"][-1] - streamed["ends"][0])
    resident_ips = steady / sum(rstate["epoch_times"][1:])
    depths = [d for d in streamed["depths"] if d is not None]
    line = {
        "model": "resnet50", "p": P, "per_rank_batch": RESNET["per_rank"],
        "image": RESNET["image"], "classes": RESNET["classes"], "epochs": STREAM["epochs"],
        "steps": state["t"], "input_workers": STREAM["workers"],
        "prefetch": pipe.prefetch, "pinned": "pin_memory() per batch",
        "img_per_s_per_chip": streamed_ips, "resident_img_per_s_per_chip": resident_ips,
        "input_stall_s": state["input_stall"], "time_s": state["time"],
        "consumer_stall_s": pipe.consumer_stall_s,
        "consumer_stall_metric_s": streamed["consumer_stall_metric_s"],
        "producer_stall_s": streamed["producer_stall_s"],
        "mean_queue_depth": statistics.mean(depths) if depths else None,
        "losses": losses, "launches": {k: v for k, v in streamed["counts"].items() if v},
        "test_acc": streamed["acc"], "card": card(),
    }
    print(json.dumps({"streaming": line}))
    return {"streaming_resnet": streamed["counts"]}


def lenet_views(weights: torch.Tensor, shapes: list) -> dict:
    """LeNet's parameters as views of the flat ``weights``."""
    leaves = torch.split(weights, [math.prod(s) for _, s in shapes])
    return {name: v.view(shape) for (name, shape), v in zip(shapes, leaves)}


def lenet_fn(dev, shapes: list):
    """``model_fn(weights, x)``: LeNet's forward on ``dev`` from the flat
    ``weights``, ``x`` flat 28x28 images. Each thread runs its own module:
    ``functional_call`` swaps a module's parameters while it runs, so
    threads must not share one."""
    local = threading.local()

    def fn(weights, x):
        if not hasattr(local, "model"):
            local.model = LeNet().to(dev)
        return torch.func.functional_call(local.model, lenet_views(weights, shapes),
                                          (x.view(-1, 28 * 28),))

    return fn


def phase_serve(dev) -> dict:
    """LeNet served under training: config 1's LeNet flattened in a
    ParameterServer over the p=8 ranks on the card, an InferenceServer
    answering with LeNet's forward from its snapshot while a downpour
    trainer thread publishes ``SERVE['sends']`` scaled 'add' sends (K2 on
    every shard) and request threads call ``handle``. Every ok reply must
    equal, bit for bit, the forward of one published version (computed
    from the host copies the trainer keeps: the plain K2 on the CPU, one
    rounding as the card applies it); after the trainer stops and a last
    ``refresh_once``, the forward of ``ps.receive()``, which must equal the
    last version; swaps >= 2; a budget of 4 sheds QoS 0 at pending 4 while
    QoS 2 is answered; K2 launched P a send, nothing else. Prints the
    ``{"serve"}`` line and returns the run's launch counts."""
    init = init_params(LeNet(), seed=0)
    shapes = [(k, tuple(v.shape)) for k, v in init.items()]
    flat = torch.cat([v.reshape(-1) for v in init.values()])
    require(flat.numel() == LENET_PARAMS, f"serve: LeNet has {flat.numel()} parameters")
    fn = lenet_fn(dev, shapes)
    (xtr, ytr), (xte, _) = synthetic_mnist()
    payloads = [np.ascontiguousarray(xte[i * SERVE["batch"]:(i + 1) * SERVE["batch"]])
                for i in range(SERVE["payloads"])]
    versions = [flat.clone()]
    errors, replies, latencies = [], [], []
    trained = threading.Event()
    saved = {k: constants.get(k) for k in ("serve_refresh_interval_s", "serve_queue_budget")}
    mpi.start(ranks=P)
    constants.set("serve_refresh_interval_s", SERVE["refresh_s"])
    try:
        ps = ParameterServer(flat, comm=mpi.current_communicator())
        srv = InferenceServer(fn, ps)
        gen = torch.Generator().manual_seed(1)
        loss_fn = make_loss_fn(LeNet().to(dev))  # the trainer's own module

        def trainer():
            try:
                for _ in range(SERVE["sends"]):
                    idx = torch.randint(0, len(xtr), (SERVE["batch"],), generator=gen)
                    batch = (torch.from_numpy(xtr[idx.numpy()]).to(dev),
                             torch.from_numpy(ytr[idx.numpy()]).long().to(dev))
                    w = ps.receive(client=1).wait().requires_grad_()
                    (grad,) = torch.autograd.grad(loss_fn(lenet_views(w, shapes), batch), w)
                    ps.send(grad, rule="add", client=1, scale=-SERVE["lr"]).wait()
                    versions.append(ops.scale_accumulate(versions[-1], grad.cpu(), -SERVE["lr"]))
            except BaseException as e:  # noqa: BLE001 - reported by the main thread
                errors.append(e)
            finally:
                trained.set()

        def requests(seed):
            r = np.random.RandomState(seed)
            try:
                n = 0
                while not trained.is_set() or n < SERVE["min_requests"]:
                    j, qos = int(r.randint(SERVE["payloads"])), int(r.randint(3))
                    t0 = time.perf_counter()
                    status, y = srv.handle("infer", qos, payloads[j].tobytes(), pending=0)
                    latencies.append(time.perf_counter() - t0)
                    replies.append((status, j, y))
                    n += 1
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        ops.reset_launch_counts()
        srv.start()
        threads = [threading.Thread(target=trainer)] + [
            threading.Thread(target=requests, args=(s,)) for s in range(SERVE["threads"])]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        srv.stop()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        require(not errors, f"serve: a thread failed: {errors[:1]!r}")
        expect_launches(counts, "serve", scale_accumulate=SERVE["sends"] * P)
        last = ps.receive().wait().cpu()
        require(torch.equal(bits(last), bits(versions[-1])),
                "serve: the PS's weights differ from the host copies of the sends")
        swaps_trained = srv.cache.swaps
        srv.refresh_once()
        want = [np.stack([fn(v.to(dev), torch.from_numpy(x).to(dev).reshape(-1)).cpu().numpy()
                          for v in versions]) for x in payloads]
        ok = [(j, y) for s, j, y in replies if s == "ok"]
        require(len(ok) == len(replies), "serve: a request at pending 0 was shed")
        versions_served = set()
        for j, y in ok:
            hit = np.flatnonzero((want[j].view(np.int32) == y.view(np.int32)).all(axis=(1, 2)))
            require(hit.size > 0, "serve: a reply equals the forward of no published version")
            versions_served.add(int(hit[-1]))
        for j, x in enumerate(payloads):
            status, y = srv.handle("infer", 2, x.tobytes(), pending=0)
            require(status == "ok" and np.array_equal(y.view(np.int32), want[j][-1].view(np.int32)),
                    "serve: after the last refresh a reply is not the forward of ps.receive()")
        require(swaps_trained >= 2, f"serve: {swaps_trained} swaps under training")
        constants.set("serve_queue_budget", SERVE["budget"])
        retry = constants.get("serve_shed_retry_ms")
        shed = srv.handle("infer", 0, payloads[0].tobytes(), pending=SERVE["budget"])
        top = srv.handle("infer", 2, payloads[0].tobytes(), pending=SERVE["budget"])
        require(shed == (f"shed:{retry}", None), f"serve: QoS 0 at pending 4 got {shed[0]}")
        require(top[0] == "ok" and np.array_equal(top[1], want[0][-1]),
                f"serve: QoS 2 at pending 4 got {top[0]}")
        alone = []  # one thread, no trainer: the request path's own time
        for _ in range(50):
            t0 = time.perf_counter()
            srv.handle("infer", 2, payloads[0].tobytes(), pending=0)
            alone.append(time.perf_counter() - t0)
        lat = sorted(latencies)
        line = {
            "model": "lenet", "params": LENET_PARAMS, "p": P, "sends": SERVE["sends"],
            "lr": SERVE["lr"], "payload_images": SERVE["batch"], "threads": SERVE["threads"],
            "requests": len(ok), "requests_per_s": len(ok) / wall, "wall_s": wall,
            "handle_p50_ms": lat[len(lat) // 2] * 1e3,
            "handle_p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3,
            "handle_alone_p50_ms": statistics.median(alone) * 1e3,
            "swaps": swaps_trained, "versions_served": len(versions_served),
            "shed": srv.shed, "launches": {k: v for k, v in counts.items() if v},
            "card": card(),
        }
        print(f"serve: {len(ok)} replies during {SERVE['sends']} sends, each the forward of one "
              f"of {len(versions)} published versions bit for bit ({len(versions_served)} "
              f"distinct), then of ps.receive(); QoS 0 shed at pending {SERVE['budget']} "
              f"({shed[0]}), QoS 2 answered")
        print(json.dumps({"serve": line}))
        ps.free()
    finally:
        mpi.stop()
        for k, v in saved.items():
            constants.set(k, v)
    return {"serve_ps": counts}


# --- the algebra-synthesized lowerings (config 5 through halve, torus and
# stripe) and the supervised rollback -------------------------------------------
SYNTH_FAMILIES = ("halve~synth", "torus~synth", "stripe~synth")
SYNTH_WIDTHS = CONFIG5_BUCKETS + (HIER_N,)  # config 5's buckets and an odd width
SYNTH_LOSS_RTOL = 1e-3  # a synthesized run's test losses against the hier run's
SYNTH_CAPTURED = 6  # bucket allreduces of each synthesized run held card against CPU


def synth_comm(dev, family: str):
    """The communicator a family runs on: the flat one for the halving
    exchange, config 5's 2 hosts of 4 for the torus and the stripe."""
    from torchmpi_tpu_torch.runtime.communicator import Communicator

    if family == "halve~synth":
        return Communicator(range(P), dev)
    return two_level(dev, lambda r: f"host{r // CONFIG5_I}")


def pinned_synth(family: str, comm, backend: str, wire: str):
    from torchmpi_tpu_torch.schedule import compiler as sched

    return lambda x: sched.compile_collective(
        "allreduce", tuple(x.shape), x.dtype, comm, backend=backend, generator=family,
        wire_override=wire).execute(x)


def exact_payload(n: int, dev, blk: int = 256) -> torch.Tensor:
    """``tests/test_algebra.py``'s exact payload: rank r nonzero only on
    the blocks ``block_idx % p == r``, +-1 a block (every position has one
    contributor, every quantize block's max is 0 or 1)."""
    idx = torch.arange(n, device=dev)
    signs = torch.where((idx // blk) % 2 == 0, 1.0, -1.0)
    return torch.stack([torch.where((idx // blk) % P == r, signs, 0.0) for r in range(P)])


def check_synth(dev) -> dict:
    """Each family pinned (``compile_collective(generator=...)``) on the
    ``ring`` and ``kernel`` backends, for each wire, at config 5's three
    bucket widths and ``HIER_N``, on a seeded f32 payload, with the
    default ``wire_quant_min_elements`` and with 1 (every hop encoded):
    bit for bit the same plan on the CPU, and no hand-kernel launch. Then
    the exact payload: each family equal to flat K3 and to the exact sum
    under every wire. Returns the number of comparisons."""
    gen = torch.Generator(device=dev).manual_seed(19)
    checks = 0
    with cuda_columns_on_cpu():
        for family in SYNTH_FAMILIES:
            gcomm, ccomm = synth_comm(dev, family), synth_comm("cpu", family)
            for cutoff in (constants.get("wire_quant_min_elements"), 1):
                with constants_set({"wire_quant_min_elements": cutoff}):
                    for n in SYNTH_WIDTHS:
                        x = rand((P, n), torch.float32, gen, dev)
                        for wire in ("full", "bf16", "int8"):
                            want = pinned_synth(family, ccomm, "ring", wire)(x.cpu())
                            for backend in ("ring", "kernel"):
                                ops.reset_launch_counts()
                                got = pinned_synth(family, gcomm, backend, wire)(x)
                                torch.cuda.synchronize()
                                what = f"synth {family} {backend} {wire} [{P}, {n}] cutoff {cutoff}"
                                require(not any(ops.launch_counts().values()),
                                        f"{what}: launched {ops.launch_counts()}")
                                require(torch.equal(bits(got.cpu()), bits(want)),
                                        f"{what}: card != CPU "
                                        f"({float((got.cpu() - want).abs().max())})")
                                checks += 1
            x = exact_payload(1 << 12, dev)
            total = x.sum(0, keepdim=True).expand_as(x)
            flat = ops.ring_allreduce(x)
            with constants_set({"wire_quant_min_elements": 1}):
                for wire in ("full", "bf16", "int8"):
                    got = pinned_synth(family, gcomm, "kernel", wire)(x)
                    require(torch.equal(got, total) and torch.equal(bits(got), bits(flat)),
                            f"synth {family} {wire}: the exact payload's sum differs")
                    checks += 1
    print(f"synth: {checks} synthesized allreduces on the card equal the CPU's (or the exact "
          "sum and flat K3), no hand kernel launched")
    return checks


def synth_times(dev) -> dict:
    """Each family at [8, 2^23] f32, the full wire, beside flat K3 and the
    ``hier`` plan (kernel intra phase) on the same communicator, by
    :func:`time_ms` over rotated inputs, and one call of each with its
    launches counted."""
    from torchmpi_tpu_torch.collectives import eager

    gen = torch.Generator(device=dev).manual_seed(23)

    def timed(fn):
        return time_ms(rotating(fn, lambda: (torch.randn((P, N23), generator=gen, device=dev),),
                                P * N23 * 4))

    hosts = synth_comm(dev, "torus~synth")
    out = {"shape": [P, N23], "wire": "full", "groups": f"{CONFIG5_G}x{CONFIG5_I}",
           "flat_k3_ms": timed(ops.ring_allreduce),
           "hier_kernel_ms": timed(lambda x: eager.run_hierarchical_allreduce(
               x, hosts, impl="kernel")),
           "bound_ms": 2 * P * N23 * 4 / HBM_BYTES_PER_S * 1e3, "launches": {}}
    x = torch.randn((P, N23), generator=gen, device=dev)
    for family in SYNTH_FAMILIES:
        fn = pinned_synth(family, synth_comm(dev, family), "kernel", "full")
        out[f"{family.split('~')[0]}_ms"] = timed(fn)
        ops.reset_launch_counts()
        fn(x)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        require(not any(counts.values()), f"synth {family} at 2^23: launched {counts}")
        out["launches"][family] = sum(counts.values())
    return out


@contextlib.contextmanager
def captured_synth(limit: int):
    """The first ``limit`` executes of a synthesized plan inside the
    block: (generator, wire, input copy, output)."""
    from torchmpi_tpu_torch.schedule import compiler as sched

    seen = []
    real = sched.ExecutablePlan.execute

    def execute(self, x, stream=None):
        out = real(self, x, stream)
        if self.routing == "synth" and len(seen) < limit:
            seen.append((self.plan.generator, self.wire, x.clone(), out))
        return out

    sched.ExecutablePlan.execute = execute
    try:
        yield seen
    finally:
        sched.ExecutablePlan.execute = real


def config5_synth(dev, hier: dict, overrides: dict) -> dict:
    """Config 5's twin at its defaults on ``kernel`` with
    ``use_plan_synthesis`` on and ``overrides`` (bucket width ->
    generator) as plan overrides: falling losses within
    ``SYNTH_LOSS_RTOL`` of the ``hier`` run's, each bucket's plan the one
    the CPU port chooses, exact launches (K3 a step for each bucket left
    on a non-synthesized plan, one K7), and the first ``SYNTH_CAPTURED``
    bucket allreduces held bit for bit against the same plans on the
    CPU."""
    from torchmpi_tpu_torch.schedule import compiler as sched
    from torchmpi_tpu_torch.schedule.topology import Topology

    cpu_hosts = synth_comm("cpu", "torus~synth")
    try:
        # the overrides under the card's topology and the CPU's (the
        # fingerprint names the platform)
        for comm in (synth_comm(dev, "torus~synth"), cpu_hosts):
            fp = Topology.from_communicator(comm).fingerprint()
            for n, family in overrides.items():
                sched.set_plan_override(sched.override_key(
                    "allreduce", fp, sched.payload_bucket(n * 4), "full"), family)
        with constants_set({"use_plan_synthesis": True}), captured_synth(SYNTH_CAPTURED) as seen:
            run = config5_run("kernel")
        # the CPU port's choice for each bucket: the same request, the
        # card's routing constants
        with cuda_columns_on_cpu(), constants_set({"use_plan_synthesis": True,
                                                   "small_allreduce_size_cpu": 1}):
            for n, (label, plan_id) in sorted(run["buckets"].items()):
                ep = sched.compile_collective("allreduce", (P, n), torch.float32, cpu_hosts,
                                              backend="kernel")
                require((ep.op_label, ep.plan_id.split(":")[0]) == (label, plan_id.split(":")[0]),
                        f"config 5 synth {overrides}: bucket {n} ran {plan_id}, the CPU port "
                        f"chooses {ep.plan_id}")
            require(len(seen) == SYNTH_CAPTURED, f"config 5 synth: {len(seen)} synthesized calls")
            for family, wire, x, out in seen:
                want = sched.compile_collective(
                    "allreduce", tuple(x.shape), torch.float32, cpu_hosts, backend="kernel",
                    generator=family, wire_override=wire).execute(x.cpu())
                require(torch.equal(bits(out.cpu()), bits(want)),
                        f"config 5 {family} [{tuple(x.shape)}]: card != CPU")
    finally:
        sched.clear_plan_overrides()
    losses, what = run["losses"], f"config 5 synth {overrides or 'chosen'}"
    require(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
            f"{what}: test losses {losses} do not fall")
    for a, b in zip(losses, hier["losses"]):
        require(abs(a - b) <= SYNTH_LOSS_RTOL * abs(b),
                f"{what}: losses {losses}, the hier run's {hier['losses']}")
    synth_buckets = sum(1 for label, _ in run["buckets"].values()
                        if label in ("halve_allreduce", "torus_allreduce", "striped_allreduce"))
    require(len(run["buckets"]) == CONFIG5["blocks"], f"{what}: buckets {run['buckets']}")
    expected = dict.fromkeys(run["counts"], 0)
    expected["rank_bmm"] = CONFIG5_STEPS * CONFIG5_PRODUCTS
    expected["ring_allreduce"] = CONFIG5_STEPS * (CONFIG5["blocks"] - synth_buckets)
    expected["ring_broadcast"] = 1
    require(run["counts"] == expected, f"{what}: launches {run['counts']}, expected {expected}")
    return {"plans": {str(n): plan_id for n, (_, plan_id) in sorted(run["buckets"].items())},
            "losses": losses, "acc": run["acc"], "samples_per_s_chip": run["samples_per_s_chip"],
            "launches": {k: v for k, v in run["counts"].items() if v},
            "captured_bitwise": len(seen), "counts": run["counts"]}


def phase_synth(dev) -> dict:
    """The algebra-synthesized lowerings on the card (p = 8; halve on the
    flat communicator, torus and stripe on config 5's 2 hosts of 4):

    1. :func:`check_synth`, each family on the card against the CPU;
    2. :func:`synth_times`, each family at [8, 2^23] beside flat K3 and
       ``hier``;
    3. config 5's twin on ``kernel`` with ``hier`` (the default), then with
       ``use_plan_synthesis`` on (:func:`config5_synth`), then with every
       bucket pinned to ``torus~synth`` and to ``stripe~synth`` by plan
       overrides.

    Restores the constants and overrides; prints one ``{"synth": ...}``
    line and returns the runs' launch counts."""
    checks = check_synth(dev)
    times = synth_times(dev)
    hier = config5_run("kernel")
    require(hier["counts"] == config5_expected(hier, "kernel"),
            f"config 5 hier: launches {hier['counts']}")
    runs = {"chosen": config5_synth(dev, hier, {})}
    for family in ("torus~synth", "stripe~synth"):
        runs[family] = config5_synth(dev, hier, dict.fromkeys(CONFIG5_BUCKETS, family))
    runs["hier"] = {"plans": {str(n): plan_id for n, (_, plan_id) in sorted(hier["buckets"].items())},
                    "losses": hier["losses"], "acc": hier["acc"],
                    "samples_per_s_chip": hier["samples_per_s_chip"],
                    "launches": {k: v for k, v in hier["counts"].items() if v},
                    "counts": hier["counts"]}
    counts = {f"synth_{name}": run.pop("counts") for name, run in runs.items()}
    print(json.dumps({"synth": {"checks": checks, "times_at": times, "config5": runs,
                                "loss_rtol": SYNTH_LOSS_RTOL, "steps": CONFIG5_STEPS,
                                "card": card()}}))
    return counts


SUPERVISE = dict(steps=12, checkpoint_every=4, fault_step=6, hang_after_s=0.25, hold_s=4.0,
                 live_interval_s=0.05)
SUPERVISE_KNOBS = {"supervisor_hysteresis_windows": 2, "supervisor_max_retries": 2,
                   "supervisor_backoff_base_s": 0.02, "supervisor_backoff_cap_s": 0.05}


class SmokeActuator:
    """The harness's actuator (the package has none in one process):
    ``evict`` cannot shrink a live world here (``engine.resize`` is ROADMAP
    A10's rest) and returns False; ``rollback`` restores a fresh engine
    from the registry's last checkpoint and returns True."""

    def __init__(self, make, holder: dict):
        self.make, self.holder, self.calls = make, holder, []

    def evict(self, ranks, reason):
        self.calls.append(("evict", list(ranks), reason))
        return False

    def grow(self, reason):
        self.calls.append(("grow", [], reason))
        return False

    def rollback(self, reason):
        from torchmpi_tpu_torch.supervise import last_checkpoint

        self.calls.append(("rollback", [], reason))
        self.holder["engine"].flush_checkpoint()
        rec = last_checkpoint()
        fresh = self.make()
        meta = ckpt.restore_engine_sharded(rec["path"], fresh)
        self.holder.update(engine=fresh, step=int(meta["step"]), restored=int(meta["step"]))
        return True


def phase_supervise(dev) -> dict:
    """A supervised rollback of a real engine: config 1's LeNet on the sync
    engine over p = 8 (batch 336, lr 0.2), ``checkpoint_every`` registering
    each save in the checkpoint registry, a live exporter streaming to a
    ``FleetAggregator`` (``hang_after_s``) with a ``RecoverySupervisor``
    attached, and ``sup.observe(agg.evaluate())`` after each step. At
    ``fault_step`` an async K3 allreduce of LeNet's gradient width is
    queued on the communicator's side stream behind a ``hold_s`` spin
    kernel and a thread waits its handle: the handle's ``wait.arrays``
    flight entry stays issued past ``hang_after_s`` (the dispatch entry
    closes at issue), the ``hang`` verdict. The job is wedged there, so
    the harness takes no step, only windows ``live_interval_s`` apart,
    until the supervisor acts. The harness's actuator fails every
    eviction, so the ladder escalates to the rollback, which restores the
    last checkpoint; the run trains on to the final step, its losses and
    state bit for bit a clean run's, its launches exact (one K3 and one
    K1 list call a step run, and the held K3). ``/actions`` and
    ``/metrics`` are scraped. Prints one ``{"supervise": ...}`` line."""
    import shutil
    import urllib.request

    from torchmpi_tpu_torch.collectives import eager
    from torchmpi_tpu_torch.supervise import RecoverySupervisor, checkpoints
    from torchmpi_tpu_torch.telemetry import flightrecorder, live

    cfg = SUPERVISE
    (xtr, ytr), _ = synthetic_mnist()
    model = LeNet()
    root = ENGINE_CKPT_ROOT / "supervise"
    shutil.rmtree(root, ignore_errors=True)
    prior_state = os.environ.get(checkpoints.STATE_ENV)
    os.environ[checkpoints.STATE_ENV] = str(root / "last_checkpoint.json")
    checkpoints._reset_for_tests()
    agg = live.FleetAggregator(mark_dir=root / "marks", hang_after_s=cfg["hang_after_s"])
    agg.serve()
    mpi.start(ranks=P)
    try:
        comm = mpi.current_communicator()
        it = DistributedIterator(xtr, ytr, BATCH, P, device=dev)
        batches = [b for _, b in zip(range(cfg["steps"]), iter(it))]

        def make():
            return AllReduceSGDEngine(make_loss_fn(model), init_params(model, seed=0), lr=LR,
                                      comm=comm)

        clean = make()
        clean_losses = [float(clean.step(b)) for b in batches]
        torch.cuda.synchronize()
        with constants_set({**SUPERVISE_KNOBS,
                            "telemetry_live_interval_s": cfg["live_interval_s"]}):
            holder = {"engine": make(), "step": 0}
            holder["engine"].checkpoint_every(cfg["checkpoint_every"], root / "ck")
            act = SmokeActuator(make, holder)
            sup = RecoverySupervisor(act, seed=0)
            agg.attach_supervisor(sup)
            live.start_exporter(("127.0.0.1", agg.ingest_port), rank=0)
            losses, windows, observe_s, steps_run = {}, [], [], 0
            held = waiter = t_fault = None
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            deadline = time.time() + 60.0
            while holder["step"] < cfg["steps"] and time.time() < deadline:
                if holder["step"] == cfg["fault_step"] and held is None:
                    side = eager._async_side(comm)
                    with torch.cuda.stream(side.stream):
                        torch.cuda._sleep(int(cfg["hold_s"] * 1.98e9))
                    x = torch.ones((P, LENET_PARAMS), device=dev)
                    held = eager.run_async("allreduce", x, comm, backend="kernel")
                    waiter = threading.Thread(target=held.wait, daemon=True)
                    waiter.start()
                    t_fault = time.time()
                if held is not None and not sup.rolled_back:
                    time.sleep(cfg["live_interval_s"])  # wedged: a window, no step
                else:
                    step = holder["step"]
                    losses[step] = float(holder["engine"].step(batches[step]))
                    steps_run += 1
                    holder["step"] = step + 1
                t0 = time.perf_counter()
                doc = agg.evaluate()
                acted = sup.observe(doc)
                observe_s.append(time.perf_counter() - t0)
                if t_fault is not None and not any(
                        "rollback" in w["actions"] for w in windows):
                    windows.append({"t_s": round(time.time() - t_fault, 4),
                                    "verdict": doc["verdict"],
                                    "actions": [e["action"] for e in acted]})
            waiter.join(timeout=30.0)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            wait_frames(agg)
            verdict_after = agg.evaluate()["verdict"]
            acts = scrape(agg, "/actions")
            with urllib.request.urlopen(f"http://127.0.0.1:{agg.http_port}/metrics",
                                        timeout=10) as r:
                prom = r.read().decode()
            final = holder["engine"]
            live.stop_exporter()
    finally:
        mpi.stop()
        flightrecorder.disable()
        agg.close()
        if prior_state is None:
            os.environ.pop(checkpoints.STATE_ENV, None)
        else:
            os.environ[checkpoints.STATE_ENV] = prior_state
        checkpoints._reset_for_tests()
        shutil.rmtree(root, ignore_errors=True)
    journal = sup.journal
    actions = [e["action"] for e in journal]
    require(sup.rolled_back and actions == ["evict-shrink"] * SUPERVISE_KNOBS[
        "supervisor_max_retries"] + ["rollback"], f"supervise: journal {journal}")
    require(all(e["verdict"] == "hang" for e in journal), f"supervise: journal {journal}")
    require(not waiter.is_alive(), "supervise: the held allreduce never completed")
    got = [losses[i] for i in range(cfg["steps"])]
    require(got == clean_losses, f"supervise: losses {got} != the clean run's {clean_losses}")
    require(same_bits(live_state(final), live_state(clean)),
            "supervise: the recovered state differs from the clean run's")
    require(counts == counts_want(ring_allreduce=steps_run + 1,
                                  accumulate=steps_run * list_launches(LENET_LEAVES),
                                  **lenet_vmap_launches(steps_run)),
            f"supervise: launches {counts} for {steps_run} steps and the held K3")
    require(acts["rolled_back"] and [e["action"] for e in acts["journal"]] == actions,
            f"supervise: /actions {acts}")
    require("tm_supervisor_rolled_back 1" in prom and
            'tm_supervisor_actions_total{action="rollback",result="applied"} 1' in prom,
            "supervise: /metrics lacks the tm_supervisor lines")
    out = {"cause": "an async K3 allreduce held behind a spin kernel on the side stream: its "
                    "handle's wait.arrays flight entry issued past hang_after_s (the dispatch "
                    "entry closes at issue)",
           "journal": journal, "actuator_calls": act.calls,
           "restored_step": holder["restored"], "windows_fault_to_rollback": windows,
           "steps_run": steps_run, "launches": {k: v for k, v in counts.items() if v},
           "observe_s": {"n": len(observe_s), "median": statistics.median(observe_s),
                         "max": max(observe_s)},
           "verdict_after_the_hold": verdict_after, "losses": got, "bitwise": True,
           **cfg, "knobs": SUPERVISE_KNOBS, "card": card()}
    print(json.dumps({"supervise": out}))
    return {"supervise": counts}


# ---------------------------------------------------------------------------
# ranks in two processes on the card (--multiprocess): the cross-process K3
# (allreduce, 'rs' and 'ag'), K4 (allreduce and 'rs', int8 and bf16), K5,
# K6 and K7, config 1 trained by 2 processes x 4 ranks through the
# launcher, replicated and under fsdp and zero1, config 2 (the async
# engine, the int8 wire), config 1 under rank_map='vmap' (ROADMAP C6), and
# the collectives benchmark by the two processes (run (g))
# ---------------------------------------------------------------------------

MP_PROCS, MP_RANKS = 2, P // 2  # processes, ranks a process: P in all
MP_SIZES = (LENET_PARAMS, 1000003, 1025, 1)  # LeNet's flat, odd and ragged widths
MP_ROOTS = (0, 5)  # a root in each process
# run (a)'s losses against the one-process kernel run's: its first step
# bit for bit (the first sync is a copy, so step 1 reads the same weights),
# then the vendor path's sums differ from K3's in their last bits and LeNet
# at lr 0.2 grows that (on the CPU 1e-7 at step 4, 0.64 at step 48; on the
# card 5.1e-4 within 10 steps), so the first MP_CLOSE_STEPS steps are held
# within MP_LOSS_RTOL and the rest reported; every step of (a) is held bit
# for bit to the one-process run under the same span and path
MP_LOSS_RTOL = 1e-3
MP_CLOSE_STEPS = 10
MP_CALLS = 50  # timed calls of the whole cross-process allreduce and of gloo's
MP_RS_N, MP_AG_N = N23, N20  # the timed 'rs' and 'ag' rows, the one-process rows' shapes
MP_SHARDED = {"c": "fsdp", "d": "zero1"}  # the sharded runs
MP_QUANT_SIZES = (BUCKET0, 1000003, 1025)  # LeNet's int8 bucket, odd and ragged widths
MP_QUANT_RS_N = P * 100674  # the timed K4 'rs' row, the one-process row's shape
MP_ISSUE_N = 1 << 8  # the async issue's width, as {"async_issue"} times it
MP_K56_N = N23  # the timed cross-process K5 and K6 rows, the one-process rows' shape
MP_SENDRECV = ((0, 7), (6, 1), (1, 2))  # (src, dst): across, back, within a process
# run (g): the collectives benchmark by the processes through the launcher,
# every op of the surface; the vendor path's rows (gloo through host memory,
# 0.1-0.5 s a call at 2^23) take 1 warm-up and 2 timed calls, the others
# the reference's 10 and 10
MP_BENCH_OPS = BENCH_OPS + ("alltoall", "sendreceive")
MP_BENCH_POWS = (8, 23)  # the sweep's sizes, as the one-process sweep's
MP_BENCH_XLA_REPS = (1, 2)


def mp_lenet(comm, rank_map: str = "loop", sharding: str = "replicated", mode: str = "sync",
             wire=None) -> dict:
    """Config 1 (LeNet, batch 336, lr 0.2, seed 0, two epochs of
    ``synthetic_mnist``: 48 steps) on ``comm``'s ranks of this process
    under ``sharding``, or with ``mode='async'`` and ``wire='int8'``
    config 2, counts set to 0 just before the engine (its first sync
    included) and read just after: the step losses, the launches, the
    second epoch's global samples/s."""
    (xtr, ytr), _ = synthetic_mnist()
    model = LeNet()
    losses, epoch_t = [], {}

    def on_start_epoch(s):
        torch.cuda.synchronize()
        epoch_t[s["epoch"]] = time.perf_counter()

    def on_end_epoch(s):
        torch.cuda.synchronize()
        epoch_t[s["epoch"]] = time.perf_counter() - epoch_t[s["epoch"]]

    ops.reset_launch_counts()
    engine = AllReduceSGDEngine(
        make_loss_fn(model), init_params(model, seed=0), lr=LR, comm=comm, rank_map=rank_map,
        param_sharding=sharding, mode=mode, wire_dtype=wire,
        hooks={"on_update": lambda s: losses.append(s["loss"]),
               "on_start_epoch": on_start_epoch, "on_end_epoch": on_end_epoch})
    it = DistributedIterator(xtr, ytr, BATCH, P, device=comm.device)
    state = engine.train(lambda: iter(it), max_epochs=2)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if wire in (None, "full"):
        mpinn.check_with_allreduce(engine.gathered_params(), comm)
    else:
        # the chunks' owners keep f32 sums, the other ranks the wire's decoding
        spread = max(float((v - v[0:1]).abs().max()) for v in engine.params.values())
        require(spread > 0, f"config 2 on {comm.name}: replicas identical; the wire did not engage")
    losses = [float(v) for v in losses]
    what = f"{mode}/{wire or 'full'}/{rank_map}/{sharding} on {comm.name}"
    require(all(math.isfinite(v) for v in losses), f"{what}: non-finite loss ({losses})")
    mean = sum(losses[len(it):]) / (len(losses) - len(it))
    median = statistics.median(losses[len(it):])
    if mode == "sync" and rank_map == "loop":
        # LeNet at lr 0.2 spikes now and then: the second epoch's mean is the
        # gate, not the last steps
        require(mean < losses[0], f"{what}: loss did not fall: first step {losses[0]}, "
                                  f"second epoch's mean {mean} ({losses})")
    else:
        # (e) and (f): LeNet at lr 0.2 on these batches spikes at step 2 and
        # again at steps that move with the rounding (the JAX engine to 3.97
        # at steps 21-22 under config 2, the port's loop and vmap at other
        # steps: ``python tests/test_torch_xproc_async.py --trajectories``),
        # and two such spikes in the second epoch lift its mean past the
        # first step: the gate is the second epoch's median, the mean is
        # reported
        require(median < losses[0], f"{what}: loss did not fall: first step {losses[0]}, "
                                    f"second epoch's median {median} ({losses})")
    return {"losses": losses, "counts": counts, "steps": state["t"],
            "samples_per_s": len(it) * BATCH / epoch_t[1],
            "loss_gate": {"first": losses[0], "second_epoch_mean": mean,
                          "second_epoch_median": median, "mean_under_first": mean < losses[0]}}


def mp_reference(vendor_span: bool, sharding: str = "replicated", mode: str = "sync",
                 wire=None, rank_map: str = "loop") -> dict:
    """A one-process p=8 run of config 1 with the rank map the processes
    take: on the kernel backend (K3 a step, the first sync by the binomial
    tree), what run (b) must equal bit for bit; or (``vendor_span``) under
    run (a)'s per-node span (keys ``host<r // 4> ici group``) with the
    selector's single-node allreduce and broadcast rows set to the vendor
    path, as (a)'s multinode rows route it, what (a) must equal; or under
    ``sharding`` (the single-node rows' kernel rings: K3 'rs' and 'ag' a
    step), what (c) or (d) must equal; or under ``mode``, ``wire`` and
    ``rank_map`` (the single-node rows: K4 a step for config 2), what (e)
    or (f) is held to."""
    from torchmpi_tpu_torch.collectives import selector

    rows = selector.table["cuda"]["singlenode"]["sync"]
    saved = {op: rows[op] for op in ("allreduce", "broadcast")}
    mpi.start(ranks=P)
    try:
        if vendor_span:
            mpi.push_communicator(lambda r: f"host{r // MP_RANKS} ici group",
                                  name="per-node ici groups")
            mpi.set_collective_span(0, 1)
            for op in saved:
                rows[op] = ["xla"]
        return mp_lenet(mpi.current_communicator(), rank_map=rank_map, sharding=sharding,
                        mode=mode, wire=wire)
    finally:
        rows.update(saved)
        mpi.stop()


def mp_payload(n: int, dtype: torch.dtype, seed: int) -> torch.Tensor:
    """The seeded [P, n] payload every process draws whole (on the CPU)."""
    gen = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        return torch.randn((P, n), generator=gen).to(dtype)
    info = torch.iinfo(dtype)
    lo, hi = max(info.min, -8), min(info.max, 8)
    return torch.randint(lo, hi + 1, (P, n), generator=gen).to(dtype)


def mp_table(lane, s: int, n: int, dtype) -> list:
    views = lane.views(s, (n,), dtype)
    return [views[q][lane.index_of[r]] for r, q in enumerate(lane.procs)]


def mp_check(dev, comm) -> dict:
    """The cross-process K3 (allreduce, 'ag', and 'rs' on ``[P, P w]``)
    and K7 on the card against their plain versions on the same slabs and
    against the one-process K3's rows and the root's row, bit for bit,
    over the native dtypes, the widths ``w`` of ``MP_SIZES`` and the roots
    of ``MP_ROOTS``; the cross-process K4 (allreduce, and 'rs' on ``[P, P
    w]``) against its plain version and the one-process K4's rows, bit for
    bit, both wires, the widths of ``MP_QUANT_SIZES``, the owned ranks in
    both orders; and the closed form."""
    plane = mpi.runtime_state.plane()
    lane = plane.lane(comm)
    local, L = comm.local_ranks, comm.local_size
    names = ("ring_allreduce_xproc", "ring_broadcast_xproc", "ring_reduce_scatter_xproc",
             "ring_allgather_xproc", "ring_allreduce_bidir_xproc", "ring_reduce_xproc",
             *(f"{op}_quant_xproc_{w}" for op in ("ring_allreduce", "ring_reduce_scatter")
               for w in WIRES))
    checks, err = 0, dict.fromkeys(names, 0.0)

    def held(name, got, plain, one):
        err[name] = max(err[name], float((got.double() - plain.double()).abs().max()))
        require(torch.equal(bits(got), bits(plain)),
                f"{name} {got.dtype} {tuple(got.shape)}: differs from its plain version")
        require(torch.equal(bits(got), bits(one)),
                f"{name} {got.dtype} {tuple(got.shape)}: differs from the one-process rows")
    for dtype in NATIVE_DTYPES:
        for i, n in enumerate(MP_SIZES):
            full = mp_payload(n, dtype, 17 + i).to(dev)
            s = lane.publish(full[local].contiguous(), n * full.element_size())
            table = mp_table(lane, s, n, dtype)
            got = ops.ring_allreduce_xproc(table, L)
            plain = ops.ring_allreduce_xproc_plain(table, L)
            err["ring_allreduce_xproc"] = max(err["ring_allreduce_xproc"],
                                              float((got.double() - plain.double()).abs().max()))
            require(torch.equal(bits(got), bits(plain)),
                    f"cross-process K3 {dtype} n={n}: differs from its plain version")
            require(torch.equal(bits(got), bits(ops.ring_allreduce(full)[local])),
                    f"cross-process K3 {dtype} n={n}: differs from the one-process K3")
            for root in MP_ROOTS:
                src = table[root]
                got7 = ops.ring_broadcast_xproc(src, L)
                plain7 = ops.ring_broadcast_xproc_plain(src, L)
                err["ring_broadcast_xproc"] = max(
                    err["ring_broadcast_xproc"], float((got7.double() - plain7.double()).abs().max()))
                require(torch.equal(bits(got7), bits(plain7))
                        and torch.equal(bits(got7), bits(full[root].expand(L, n))),
                        f"cross-process K7 {dtype} n={n} root={root}: wrong bytes")
            held("ring_allgather_xproc", ops.ring_allgather_xproc(table, L),
                 ops.ring_allgather_xproc_plain(table, L), ops.ring_allgather(full)[local])
            held("ring_allreduce_bidir_xproc", ops.ring_allreduce_bidir_xproc(table, L),
                 ops.ring_allreduce_bidir_xproc_plain(table, L),
                 ops.ring_allreduce_bidir(full)[local])
            for root in MP_ROOTS:
                if comm.process_of(root) != plane.index:
                    continue  # only the root's process launches K6
                one = ops.ring_reduce(full, root)
                for owned in (local, local[::-1]):
                    held("ring_reduce_xproc", ops.ring_reduce_xproc(table, owned, root),
                         ops.ring_reduce_xproc_plain(table, owned, root), one[owned])
                checks += 2
            lane.release()
            full = mp_payload(P * n, dtype, 31 + i).to(dev)
            s = lane.publish(full[local].contiguous(), P * n * full.element_size())
            table = mp_table(lane, s, P * n, dtype)
            one = ops.ring_reduce_scatter(full)
            for owned in (local, local[::-1]):  # the owned ranks in any order
                held("ring_reduce_scatter_xproc", ops.ring_reduce_scatter_xproc(table, owned),
                     ops.ring_reduce_scatter_xproc_plain(table, owned), one[owned])
            lane.release()
            checks += 5 + len(MP_ROOTS)
    for wire in WIRES:
        for i, n in enumerate(MP_QUANT_SIZES):
            full = mp_payload(n, torch.float32, 41 + i).to(dev)
            s = lane.publish(full[local].contiguous(), n * 4)
            table = mp_table(lane, s, n, torch.float32)
            one = ops.ring_allreduce_quant(full, wire)
            for owned in (local, local[::-1]):
                held(f"ring_allreduce_quant_xproc_{wire}",
                     ops.ring_allreduce_quant_xproc(table, owned, wire),
                     ops.ring_allreduce_quant_xproc_plain(table, owned, wire), one[owned])
            lane.release()
            full = mp_payload(P * n, torch.float32, 53 + i).to(dev)
            s = lane.publish(full[local].contiguous(), P * n * 4)
            table = mp_table(lane, s, P * n, torch.float32)
            one = ops.ring_reduce_scatter_quant(full.reshape(P, P, n), wire).reshape(P, n)
            for owned in (local, local[::-1]):
                held(f"ring_reduce_scatter_quant_xproc_{wire}",
                     ops.ring_reduce_scatter_quant_xproc(table, owned, wire),
                     ops.ring_reduce_scatter_quant_xproc_plain(table, owned, wire), one[owned])
            lane.release()
            checks += 4
    # the closed form through the collective: rank r gives r
    x = torch.stack([torch.full((LENET_PARAMS,), float(r), device=dev) for r in local])
    out = mpi.kernel.allreduce_tensor(x, comm=comm)
    require(bool((out == P * (P - 1) / 2).all()), "cross-process K3: closed form")
    checks += mp_check_moves(dev, comm)
    torch.cuda.synchronize()
    return {"checks": checks, "max_abs_err": err}


def mp_check_moves(dev, comm) -> int:
    """The rows of sendreceive (which the tester reads correct
    unconditionally) for the pairs of ``MP_SENDRECV`` and of alltoall on a
    seeded payload, on every backend, sync and async, against the
    one-process result; returns the comparisons."""
    local, checks = comm.local_ranks, 0
    x = mp_payload(N20, torch.float32, 61).to(dev)
    blocks = mp_payload(P * 1025, torch.float32, 67).to(dev).reshape(P, P, 1025)
    for b in ("xla", "ring", "kernel"):
        for mode in ("sync", "async"):
            ns = getattr(mpi.async_ if mode == "async" else mpi, b)

            def done(out):
                return out.wait() if mode == "async" else out
            for src, dst in MP_SENDRECV:
                got = done(ns.sendreceive_tensor(x[local].contiguous(), src, dst, comm=comm))
                want = primitives.sendreceive(x, src, dst)[local]
                require(torch.equal(bits(got), bits(want)),
                        f"sendreceive {src}->{dst} on {b} ({mode}): wrong rows")
            got = done(ns.alltoall_tensor(blocks[local].contiguous(), comm=comm))
            require(torch.equal(bits(got), bits(primitives.alltoall(blocks)[local])),
                    f"alltoall on {b} ({mode}): wrong rows")
            checks += len(MP_SENDRECV) + 1
    return checks


def mp_time(dev, comm) -> dict:
    """Times at [P, LENET_PARAMS] f32: the whole cross-process allreduce
    (host protocol, staging copy, K3) per call with both processes in
    step and the protocol's host time a call; then, in process 0 while
    process 1 waits at the barrier, K3 and K7 alone and their plain
    versions on rows rotated past the L2 (the two slots of the slabs and
    two sets of local copies), and the staging copy; then gloo's
    all_reduce of the same payload (each process's rows summed, the sum
    all-reduced through host memory, copied back to its rows) and gloo's
    broadcast of the root's row, both processes in step."""
    import torch.distributed as dist

    plane = mpi.runtime_state.plane()
    lane = plane.lane(comm)
    local, L, n = comm.local_ranks, comm.local_size, LENET_PARAMS
    full = mp_payload(n, torch.float32, 5).to(dev)
    x = full[local].contiguous()

    def in_step(fn, calls: int = MP_CALLS) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        plane.barrier()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e3

    proto0, calls0 = lane.protocol_s, lane.calls
    call_ms = in_step(lambda: lane.allreduce(x))
    protocol_us = (lane.protocol_s - proto0) / (lane.calls - calls0) * 1e6
    tables = []
    for _ in range(2):  # both slots hold every process's rows
        s = lane.publish(x, n * 4)
        tables.append(mp_table(lane, s, n, torch.float32))
        lane.release()
    torch.cuda.synchronize()
    plane.barrier()
    timed = {}
    if plane.index == 0:
        copies = max(2, -(-2 * L2_BYTES // (P * n * 4)))
        tables += [[r.clone() for r in tables[0]] for _ in range(copies - 2)]
        sets = itertools.cycle(tables)
        roots = itertools.cycle([t[MP_ROOTS[1]] for t in tables])
        srcs = itertools.cycle([x.clone() for _ in range(copies)])
        dst = lane._view(lane.me, 0, L * n * 4, (L, n), torch.float32)
        timed = {
            "k3_ms": time_ms(lambda: ops.ring_allreduce_xproc(next(sets), L)),
            "k3_plain_ms": time_ms(lambda: ops.ring_allreduce_xproc_plain(next(sets), L)),
            "k7_ms": time_ms(lambda: ops.ring_broadcast_xproc(next(roots), L)),
            "k7_plain_ms": time_ms(lambda: ops.ring_broadcast_xproc_plain(next(roots), L)),
            "staging_ms": time_ms(lambda: dst.copy_(next(srcs))),
        }
        del tables, sets, roots, srcs, dst
    torch.cuda.synchronize()
    plane.barrier()

    def gloo_allreduce():
        t = x.sum(0).cpu()
        dist.all_reduce(t)
        return t.to(dev).expand(L, n).contiguous()

    def gloo_broadcast():
        owner = comm.process_of(MP_ROOTS[1])
        t = x[local.index(MP_ROOTS[1])].cpu() if plane.index == owner else torch.empty(n)
        dist.broadcast(t, src=owner)
        return t.to(dev).expand(L, n).contiguous()

    return {**timed, "call_ms": call_ms, "protocol_us": protocol_us,
            "gloo_allreduce_ms": in_step(gloo_allreduce, 20),
            "gloo_broadcast_ms": in_step(gloo_broadcast, 20),
            **mp_time_sharded(dev, comm, in_step), **mp_time_quant(dev, comm, in_step),
            **mp_time_k56(dev, comm, in_step), **mp_issue(dev, comm)}


def mp_time_k56(dev, comm, in_step) -> dict:
    """The cross-process K5 (the ``kernel_bidir`` allreduce) and K6 (the
    reduce to rank ``MP_ROOTS[0]``, in process 0) at ``[P, MP_K56_N]``
    f32: the whole lane call with both processes in step; then, in process
    0 while process 1 waits at the barrier, each kernel and its plain
    version on the two slots' tables; then gloo with both processes in
    step: ``all_reduce`` and ``reduce`` of each process's rows summed,
    through host memory, copied back to its rows (the reduce to the
    root's row)."""
    import torch.distributed as dist

    plane = mpi.runtime_state.plane()
    lane = plane.lane(comm)
    local, L, n = comm.local_ranks, comm.local_size, MP_K56_N
    root = MP_ROOTS[0]
    owner = comm.process_of(root)
    x = mp_payload(n, torch.float32, 13).to(dev)[local].contiguous()
    out = {"k5_call_ms": in_step(lambda: lane.allreduce_bidir(x)),
           "k6_call_ms": in_step(lambda: lane.reduce(x, root))}
    tables = []
    for _ in range(2):  # both slots hold every process's rows
        s = lane.publish(x, n * 4)
        tables.append(mp_table(lane, s, n, torch.float32))
        lane.release()
    torch.cuda.synchronize()
    plane.barrier()
    if plane.index == owner:
        sets = itertools.cycle(tables)
        out["k5_ms"] = time_ms(lambda: ops.ring_allreduce_bidir_xproc(next(sets), L))
        out["k5_plain_ms"] = time_ms(lambda: ops.ring_allreduce_bidir_xproc_plain(next(sets), L))
        out["k6_ms"] = time_ms(lambda: ops.ring_reduce_xproc(next(sets), local, root))
        out["k6_plain_ms"] = time_ms(lambda: ops.ring_reduce_xproc_plain(next(sets), local, root))
        del sets
    del tables
    torch.cuda.synchronize()
    plane.barrier()

    def gloo_allreduce():
        t = x.sum(0).cpu()
        dist.all_reduce(t)
        return t.to(dev).expand(L, n).contiguous()

    def gloo_reduce():
        t = x.sum(0).cpu()
        dist.reduce(t, dst=owner)
        res = x.clone()
        if plane.index == owner:
            res[local.index(root)] = t.to(dev)
        return res

    out["gloo_k5_ms"] = in_step(gloo_allreduce, 10)
    out["gloo_k6_ms"] = in_step(gloo_reduce, 10)
    return out


def mp_time_quant(dev, comm, in_step) -> dict:
    """The cross-process K4 at ``[P, BUCKET0]`` (allreduce) and ``[P,
    MP_QUANT_RS_N]`` ('rs') f32, each wire: the whole lane call
    (``Lane.allreduce_quant`` / ``reduce_scatter_quant``) with both
    processes in step and its protocol's host time a call; then, in
    process 0 while process 1 waits at the barrier, the kernel and its
    plain version on the two slots' tables and copies of them past twice
    the L2."""
    plane = mpi.runtime_state.plane()
    lane = plane.lane(comm)
    local = comm.local_ranks
    out = {}
    for mode, n in (("ar", BUCKET0), ("rs", MP_QUANT_RS_N)):
        x = mp_payload(n, torch.float32, 11).to(dev)[local].contiguous()
        for wire in WIRES:
            key = f"k4{mode}_{wire}"
            call = ((lambda: lane.allreduce_quant(x, wire)) if mode == "ar"
                    else (lambda: lane.reduce_scatter_quant(x, wire)))
            proto0, calls0 = lane.protocol_s, lane.calls
            out[f"{key}_call_ms"] = in_step(call)
            out[f"{key}_protocol_us"] = ((lane.protocol_s - proto0) / (lane.calls - calls0)
                                         * 1e6)
            tables = []
            for _ in range(2):  # both slots hold every process's rows
                s = lane.publish(x, n * 4)
                tables.append(mp_table(lane, s, n, torch.float32))
                lane.release()
            torch.cuda.synchronize()
            plane.barrier()
            if plane.index == 0:
                copies = max(2, -(-2 * L2_BYTES // (P * n * 4)))
                tables += [[r.clone() for r in tables[0]] for _ in range(copies - 2)]
                sets = itertools.cycle(tables)
                if mode == "ar":
                    kernel = lambda: ops.ring_allreduce_quant_xproc(next(sets), local, wire)  # noqa: E731
                    plain = lambda: ops.ring_allreduce_quant_xproc_plain(next(sets), local, wire)  # noqa: E731
                else:
                    kernel = lambda: ops.ring_reduce_scatter_quant_xproc(next(sets), local, wire)  # noqa: E731
                    plain = lambda: ops.ring_reduce_scatter_quant_xproc_plain(  # noqa: E731
                        next(sets), local, wire)
                out[f"{key}_ms"], out[f"{key}_plain_ms"] = time_ms(kernel), time_ms(plain)
                del sets, kernel, plain
            del tables
            torch.cuda.synchronize()
            plane.barrier()
    return out


def mp_issue(dev, comm) -> dict:
    """The host microseconds to issue an async allreduce across the
    processes at ``[L, MP_ISSUE_N]`` f32, selector-routed and with the
    kernel backend pinned: each the median of 1,000 calls after 50
    warm-up calls, every handle waited outside the timed window (both
    processes issue the same calls), as ``{"async_issue"}`` times the
    one-process issue."""
    x = torch.randn((comm.local_size, MP_ISSUE_N), device=dev)

    def median_us(issue, reps=1000, warmup=50):
        times = []
        for i in range(warmup + reps):
            t0 = time.perf_counter_ns()
            h = issue()
            t1 = time.perf_counter_ns()
            h.wait()
            if i >= warmup:
                times.append(t1 - t0)
        torch.cuda.synchronize()
        return statistics.median(times) / 1e3

    return {"issue_async_allreduce_tensor_us": median_us(
                lambda: mpi.async_.allreduce_tensor(x, comm=comm)),
            "issue_async_kernel_pinned_us": median_us(
                lambda: mpi.async_.kernel.allreduce_tensor(x, comm=comm))}


def mp_time_sharded(dev, comm, in_step) -> dict:
    """The cross-process K3 'rs' at ``[P, MP_RS_N]`` and 'ag' at ``[P,
    MP_AG_N]`` f32: the whole lane call with both processes in step, then,
    in process 0 while process 1 waits at the barrier, the kernel and its
    plain version on the two slots' tables (each a different copy of every
    process's rows; the 'ag' tables copied on until they exceed twice the
    L2), then gloo with both processes in step: ``all_gather`` of each
    process's rows for 'ag', and for 'rs' ``reduce_scatter_tensor`` of each
    process's rows summed, where the gloo build takes it (else None)."""
    import torch.distributed as dist

    plane = mpi.runtime_state.plane()
    lane = plane.lane(comm)
    local, L = comm.local_ranks, comm.local_size
    out = {}
    for mode, n in (("rs", MP_RS_N), ("ag", MP_AG_N)):
        x = mp_payload(n, torch.float32, 7).to(dev)[local].contiguous()
        call = (lambda: lane.reduce_scatter(x)) if mode == "rs" else (lambda: lane.allgather(x))
        out[f"{mode}_call_ms"] = in_step(call)
        tables = []
        for _ in range(2):  # both slots hold every process's rows
            s = lane.publish(x, n * 4)
            tables.append(mp_table(lane, s, n, torch.float32))
            lane.release()
        torch.cuda.synchronize()
        plane.barrier()
        if plane.index == 0:
            copies = max(2, -(-2 * L2_BYTES // (P * n * 4)))
            tables += [[r.clone() for r in tables[0]] for _ in range(copies - 2)]
            sets = itertools.cycle(tables)
            if mode == "rs":
                kernel = lambda: ops.ring_reduce_scatter_xproc(next(sets), local)  # noqa: E731
                plain = lambda: ops.ring_reduce_scatter_xproc_plain(next(sets), local)  # noqa: E731
            else:
                kernel = lambda: ops.ring_allgather_xproc(next(sets), L)  # noqa: E731
                plain = lambda: ops.ring_allgather_xproc_plain(next(sets), L)  # noqa: E731
            out[f"{mode}_ms"], out[f"{mode}_plain_ms"] = time_ms(kernel), time_ms(plain)
            del sets, kernel, plain
        del tables
        torch.cuda.synchronize()
        plane.barrier()

        def gloo():
            if mode == "ag":
                parts = [torch.empty((L, n)) for _ in range(plane.count)]
                dist.all_gather(parts, x.cpu())
                full = torch.cat(parts).to(dev)  # the processes' rows are consecutive
                return full[None].expand(L, P, n).contiguous()
            t = x.sum(0).cpu()
            part = torch.empty(n // plane.count)
            dist.reduce_scatter_tensor(part, t)
            return part.to(dev).reshape(L, n // P)

        try:
            out[f"gloo_{mode}_ms"] = in_step(gloo, 10)
        except (RuntimeError, NotImplementedError, ValueError) as e:
            out[f"gloo_{mode}_ms"], out[f"gloo_{mode}_none"] = None, f"{type(e).__name__}: {e}"[:200]
    return out


def mp_run(ici: bool, prefer_kernel: bool, sharding: str = "replicated", mode: str = "sync",
           wire=None, rank_map: str = "loop") -> dict:
    """One of the runs of config 1 on the card across the processes: (a)
    ``ici`` as the JAX package routes it, the per-node span and the
    compiler's plan (the selector's multinode rows: the vendor path over
    gloo); (b) the flat span with the selector's ``cuda.multinode.sync``
    allreduce, broadcast, allgather and reducescatter rows set to prefer
    ``kernel`` (the reference's user-editable collectiveSelector), so the
    gradients and the first sync run the cross-process K3 and K7; (c) and
    (d) the same rows under ``sharding`` fsdp or zero1, so the partials
    run the cross-process K3 'rs' and the parameters (fsdp) or the updates
    (zero1) 'ag'; (e) config 2 with the ``async`` allreduce row set to
    prefer ``kernel`` too, so its int8 bucket runs the cross-process K4 on
    the issue thread; (f) (b) under ``rank_map='vmap'``."""
    from torchmpi_tpu_torch.collectives import selector

    rows = selector.table["cuda"]["multinode"]["sync"]
    arows = selector.table["cuda"]["multinode"]["async"]
    saved = {op: rows[op] for op in ("allreduce", "broadcast", "allgather", "reducescatter")}
    saved_async = arows["allreduce"]
    mpi.start(ranks=MP_RANKS, with_ici_groups=ici)
    try:
        if prefer_kernel:
            for op in saved:
                rows[op] = ["kernel", "ring", "xla"]
            arows["allreduce"] = ["kernel", "ring", "xla"]
        comm = mpi.current_communicator()
        lane = mpi.runtime_state.plane().lane(comm)
        proto0, calls0 = lane.protocol_s, lane.calls
        run = mp_lenet(comm, rank_map=rank_map, sharding=sharding, mode=mode, wire=wire)
        memo = comm.__dict__.get("_dispatch_memo", {})
        run["plans"] = sorted({f"{ent[1].plan.generator}/{ent[1].plan.backend}"
                               for ent in memo.values() if hasattr(ent[1], "plan")})
        run["lane_calls"] = lane.calls - calls0
        run["protocol_us"] = ((lane.protocol_s - proto0) / max(1, lane.calls - calls0) * 1e6)
        run["slab_growths"], run["slab_mib"] = lane.growths, 2 * lane.cap / 2**20
        run["span"] = list(mpi.stack().span)
        return run
    finally:
        rows.update(saved)
        arows["allreduce"] = saved_async
        mpi.stop()


def mp_worker(out_dir: str) -> None:
    """One process of ``--multiprocess`` (started by the launcher, which
    gives the world): the kernel checks and times, then runs (a) to (f);
    its results to ``out_dir/proc<i>.json``. Nothing is caught: a failure
    fails the process, and the launcher the job."""
    res = {}
    mpi.start(ranks=MP_RANKS, with_ici_groups=False)
    try:
        comm = mpi.current_communicator()
        dev = comm.device
        require(comm.multiprocess and comm.size == P and comm.num_nodes() == MP_PROCS,
                f"the launcher's world is {comm.size} ranks in {comm.num_nodes()} processes")
        res["check"] = mp_check(dev, comm)
        res["time"] = mp_time(dev, comm)
        index = mpi.runtime_state.plane().index
    finally:
        mpi.stop()
    res["a"] = mp_run(ici=True, prefer_kernel=False)
    res["b"] = mp_run(ici=False, prefer_kernel=True)
    for run, sharding in MP_SHARDED.items():
        res[run] = mp_run(ici=False, prefer_kernel=True, sharding=sharding)
    res["e"] = mp_run(ici=False, prefer_kernel=True, mode="async", wire="int8")
    res["f"] = mp_run(ici=False, prefer_kernel=True, rank_map="vmap")
    Path(out_dir, f"proc{index}.json").write_text(json.dumps(res))
    print(f"multiprocess worker {index} OK")


def mp_expected(steps: int, kernel: bool, sharding: str = "replicated", wire=None,
                rank_map: str = "loop") -> dict:
    """A process's launches in a run of config 1: K1 a step; in (b) and
    (f) the cross-process K3 a step and K7 once (the first sync); in (e)
    (config 2) the cross-process K4 (int8) a step for bucket 0 and K7
    once, bucket 1 (52352 elements) under ``small_allreduce_size_cuda``
    on the vendor path over gloo, and no one-process K4; under fsdp or
    zero1 ((c), (d)) no K7 (nothing is broadcast), the cross-process K3
    'rs' once a flush of the fusion buffer's reduce-scatter group over the
    sharded leaves (a flush of fewer than ``fusion_min_tensors`` tensors
    once a tensor), 'ag' once (one dtype), and the cross-process K3
    allreduce once a flush of the other leaves above
    ``small_allreduce_size_cuda`` (LeNet's one such leaf, the head's 10
    biases, is below it: the vendor path over gloo)."""
    want = {name: 0 for name in ops.launch_counts()}
    want["accumulate"] = steps * list_launches(LENET_LEAVES)
    if sharding != "replicated":
        sizes = {k: v.numel() for k, v in init_params(LeNet(), seed=0).items()}
        sharded = [k for k, v in init_params(LeNet(), seed=0).items()
                   if any(d >= P and d % P == 0 for d in v.shape)]
        least = max(1, constants.get("fusion_min_tensors"))
        cutoff = constants.get("small_allreduce_size_cuda")
        rs = fusion_flushes([sizes[k] for k in sharded])
        ar = fusion_flushes([n for k, n in sizes.items() if k not in sharded])
        want["ring_reduce_scatter_xproc"] = steps * sum(1 if c >= least else c for _, c in rs)
        want["ring_allgather_xproc"] = steps
        want["ring_allreduce_xproc"] = steps * sum(n > cutoff for n, _ in ar)
    elif wire is not None:
        want[f"ring_allreduce_quant_xproc_{wire}"] = steps
        want["ring_broadcast_xproc"] = 1
    elif kernel:
        want["ring_allreduce_xproc"] = steps
        want["ring_broadcast_xproc"] = 1
    if rank_map == "vmap":
        want.update(lenet_vmap_launches(steps))
    return want


def mp_bench_expected(op: str, impl, proc: int) -> dict:
    """A process's launches in run (g)'s sweep of one op (its kernel
    backend's configs, sync and async, ``BENCH_CALLS`` calls each), by the
    rules of the flat lowering across processes and the default cutoffs:
    allreduces above ``small_allreduce_size_cuda`` elements the
    cross-process K3 (K5 under 'kernel_bidir'), broadcasts above
    ``small_broadcast_size_cuda`` the cross-process K7 (at any size above
    it: no tree across processes), every reduce the cross-process K6 in
    the process of the root (rank 0) only, every allgather and
    reducescatter the cross-process K3 'ag' and 'rs'; alltoall and
    sendreceive copy from the slabs and launch nothing."""
    defaults = constants._Constants()
    calls, sweep = 2 * BENCH_CALLS, sweep_sizes(*MP_BENCH_POWS)
    if op == "allreduce":
        big = [n for n in sweep if n > defaults.small_allreduce_size_cuda]
        name = "ring_allreduce_bidir_xproc" if impl else "ring_allreduce_xproc"
        return {name: calls * len(big)}
    if op == "broadcast":
        big = [n for n in sweep if n > defaults.small_broadcast_size_cuda]
        return {"ring_broadcast_xproc": calls * len(big)}
    if op == "reduce":
        return {"ring_reduce_xproc": calls * len(sweep)} if proc == 0 else {}
    if op in ("allgather", "reducescatter"):
        name = "ring_allgather_xproc" if op == "allgather" else "ring_reduce_scatter_xproc"
        return {name: calls * len(sweep)}
    return {}


def mp_bench(root: Path) -> tuple:
    """Run (g): ``python -m torchmpi_tpu_torch.launch --nproc MP_PROCS -m
    torchmpi_tpu_torch.examples.bench_collectives`` at MP_RANKS ranks a
    process, every op of ``MP_BENCH_OPS`` on xla, ring and kernel, sync
    and async, every size of the sweep, then the kernel allreduce under
    'kernel_bidir' (the tuning and calibration caches empty, so both
    processes route by the default cutoffs). Every row must read correct
    and every process's launches of each op's sweep (counted from 0 just
    before it) must equal :func:`mp_bench_expected`. Returns the launches
    summed over the processes, the rows at the largest size and the
    seconds it took."""
    logs = root / "_mp_bench_logs"
    shutil.rmtree(logs, ignore_errors=True)
    caches = Path(tempfile.mkdtemp(prefix="chip-smoke-bench-caches-"))
    env = dict(os.environ, TORCHMPI_TPU_TUNING_CACHE=str(caches / "autotune.json"),
               TORCHMPI_TPU_CALIBRATION_CACHE=str(caches / "calibration.json"))
    args = ["--ranks", str(MP_RANKS), "--ops", ",".join(MP_BENCH_OPS),
            "--backends", "xla,ring,kernel", "--modes", "sync,async",
            "--min-pow", str(MP_BENCH_POWS[0]), "--max-pow", str(MP_BENCH_POWS[1]),
            "--kernel-bidir", "--launch-counts", "--json",
            "--xla-reps", ",".join(map(str, MP_BENCH_XLA_REPS))]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torchmpi_tpu_torch.launch", "--nproc", str(MP_PROCS),
         "--log-dir", str(logs), "-m", "torchmpi_tpu_torch.examples.bench_collectives", "--",
         *args], cwd=str(root), env=env, timeout=600)
    seconds = time.perf_counter() - t0
    shutil.rmtree(caches, ignore_errors=True)
    texts = [(logs / f"rank_{i}.log").read_text() for i in range(MP_PROCS)]
    require(proc.returncode == 0, f"run (g) failed ({proc.returncode}):\n"
            + "\n".join(f"--- {i}\n{t[-3000:]}" for i, t in enumerate(texts)))
    lines = [[json.loads(ln) for ln in t.splitlines() if ln.startswith("{")] for t in texts]
    rows = [ln["bench"] for ln in lines[0] if "bench" in ln]
    sweep = sweep_sizes(*MP_BENCH_POWS)
    want_rows = (len(MP_BENCH_OPS) * 3 + 1) * 2 * len(sweep)
    require(len(rows) == want_rows, f"run (g): {len(rows)} rows, not {want_rows}")
    bad = [bench_key(r) + f"/{r['nelem']}" for r in rows if not r["correct"]]
    require(not bad, f"run (g): incorrect configs {bad}")
    names = list(ops.launch_counts())
    summed = dict.fromkeys(names, 0)
    for i, found in enumerate(lines):
        got = [ln["launches"] for ln in found if "launches" in ln]
        require(len(got) == len(MP_BENCH_OPS) + 1, f"run (g) proc {i}: {len(got)} launch lines")
        for entry in got:
            want = mp_bench_expected(entry["op"], entry["ring_implementation"], i)
            require(entry["counts"] == want,
                    f"run (g) proc {i} {entry['op']} ({entry['ring_implementation']}): launches "
                    f"{entry['counts']} != {want}")
            for k, v in entry["counts"].items():
                summed[k] += v
    top = {bench_key(r): r["bus_gbps"] for r in rows if r["nelem"] == sweep[-1]}
    return summed, top, seconds


# ---------------------------------------------------------------------------
# run (h): groups and communicators over some of the processes (ROADMAP
# A13's rest, part 10) in the reference's layout: 4 processes x 2 ranks, 2
# hosts of 2 processes (host key r // 4, pushed from the root level)
# ---------------------------------------------------------------------------

MPH_PROCS, MPH_RANKS = 4, P // 4
MPH_HOST = P // CONFIG5["hosts"]  # ranks a host: each host's group spans 2 processes
MPH_SUBSETS = ((0, 1), (2, 3), (1, 2))  # disjoint, disjoint, overlapping
MPH_SUBSET_N = N20
MPH_STAGED_N = CONFIG5_BUCKET
# the grouped cross-process kernels' checks: (width, dtype)
MPH_CHECKS = ((CONFIG5_BUCKET, torch.float32), (CONFIG5_PARAMS, torch.float32),
              (1025, torch.bfloat16), (1001, torch.int32), (N23, torch.float32))


def mph_host_key(r: int) -> str:
    return f"host{r // MPH_HOST}"


@contextlib.contextmanager
def mph_kernel_sync():
    """The selector's ``cuda.multinode.sync`` allreduce and broadcast rows
    set to prefer ``kernel`` (the reference's user-editable
    collectiveSelector), as run (b) sets them: config 5's first parameter
    sync across the processes is then the two-level broadcast on
    ``kernel`` (the grouped cross-process K7), as it is in one process."""
    from torchmpi_tpu_torch.collectives import selector

    rows = selector.table["cuda"]["multinode"]["sync"]
    saved = {op: rows[op] for op in ("allreduce", "broadcast")}
    for op in saved:
        rows[op] = ["kernel", "ring", "xla"]
    try:
        yield
    finally:
        rows.update(saved)


def mph_config5(staged: bool) -> dict:
    """Config 5's twin in this process of run (h): ``--ranks MPH_RANKS``
    through :func:`config5_run` with ``start()`` pushing no per-process
    level, so the example's host key splits the world's ranks (each
    host's group spans two processes), under :func:`mph_kernel_sync`;
    ``staged`` turns ``use_staged_collectives`` on."""
    real_start = mpi.start
    mpi.start = partial(real_start, with_ici_groups=False)
    try:
        with constants_set({"use_staged_collectives": staged}), mph_kernel_sync():
            run = config5_run("kernel", ("--ranks", str(MPH_RANKS)))
    finally:
        mpi.start = real_start
    run["plans"] = [list(pl) for pl in run["plans"]]
    run["buckets"] = {str(k): list(v) for k, v in run["buckets"].items()}
    return run


def staged_formula(full: torch.Tensor, groups, process_of) -> torch.Tensor:
    """The JAX multi-controller staged total (``torchmpi_tpu/schedule/
    lower.py:478-523``) of the rank-stacked ``full`` on the host: each
    group summed by the grouped ring's plain version (the grouped K3's
    adds), each process's representatives (each group's first rank)
    summed from zeros in group order, the partials summed from zeros in
    process order."""
    order = [r for g in groups for r in g]
    sums = ops.ring_allreduce_plain(full[order].contiguous(), groups=len(groups))
    total = torch.zeros_like(full[0])
    for q in sorted(set(process_of)):
        partial = torch.zeros_like(full[0])
        for i, g in enumerate(groups):
            if process_of[g[0]] == q:
                partial = partial + sums[i * len(g)]
        total = total + partial
    return total


def mph_check(dev, comm) -> dict:
    """The grouped cross-process K3 (``Lane.allreduce_groups``) and K7
    (``Lane.broadcast_groups``, from each intra rank) over the host groups
    that span processes, on :data:`MPH_CHECKS`: each process's rows bit for
    bit the one-process grouped K3 / K7 launch's rows on the same full
    ``[P, n]`` (and the grouped plain versions'); the staged allreduce on
    ``kernel`` bit for bit :func:`staged_formula` on f32 and exactly
    p(p-1)/2 on the integers rank r -> r. Returns the checks' count, the
    largest |kernel - plain| and this process's launches."""
    lane = mpi.runtime_state.plane().lane(comm)
    groups, local = comm.groups, comm.local_ranks
    G, checks, err = len(groups), 0, {"ring_allreduce_xproc_grouped": 0.0,
                                      "ring_broadcast_xproc_grouped": 0.0}
    ops.reset_launch_counts()
    for i, (n, dtype) in enumerate(MPH_CHECKS):
        full = mp_payload(n, dtype, 40 + i).to(dev)
        x = full[local].contiguous()
        got = lane.allreduce_groups(x, groups)
        one = ops.ring_allreduce(full, groups=G)
        plain = ops.ring_allreduce_plain(full, groups=G)
        torch.cuda.synchronize()
        require(torch.equal(bits(one), bits(plain)), f"run (h): one-process grouped K3 {n} {dtype}")
        require(torch.equal(bits(got), bits(one[local])),
                f"run (h): grouped cross-process K3 [{P}, {n}] {dtype} != the one-process launch")
        if dtype.is_floating_point:
            err["ring_allreduce_xproc_grouped"] = max(
                err["ring_allreduce_xproc_grouped"],
                float((got.float() - plain[local].float()).abs().max()))
        checks += 1
        for root in range(MPH_HOST):
            got = lane.broadcast_groups(x, groups, root)
            want = ops.ring_broadcast(full, root, groups=G)
            torch.cuda.synchronize()
            require(torch.equal(bits(want), bits(ops.ring_broadcast_plain(full, root, groups=G))),
                    f"run (h): one-process grouped K7 {n} {dtype}")
            require(torch.equal(bits(got), bits(want[local])),
                    f"run (h): grouped cross-process K7 [{P}, {n}] {dtype} root {root} != the "
                    "one-process launch")
            checks += 1
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    want_x = len(MPH_CHECKS)
    require(launches.get("ring_allreduce_xproc_grouped") == want_x and
            launches.get("ring_broadcast_xproc_grouped") == want_x * MPH_HOST,
            f"run (h): check launches {launches}")
    # the staged allreduce: f32 against the host formula, integers exact
    full = mp_payload(MPH_STAGED_N, torch.float32, 50)
    staged = eager_staged(full[local].to(dev), comm)
    want = staged_formula(full, groups, comm.processes)
    require(torch.equal(bits(staged.cpu()), bits(want.expand(len(local), -1))),
            "run (h): the staged allreduce is not the multi-controller order's bits")
    ints = torch.arange(P, dtype=torch.int32)[local, None].expand(-1, 4097).contiguous().to(dev)
    total = eager_staged(ints, comm)
    require(bool((total == P * (P - 1) // 2).all()), "run (h): staged integers inexact")
    checks += 2
    return {"checks": checks, "max_abs_err": err, "launches": launches}


def eager_staged(x: torch.Tensor, comm) -> torch.Tensor:
    from torchmpi_tpu_torch.collectives import eager

    return eager.run_hierarchical_allreduce(x, comm, impl="staged", staged_intra="kernel")


def mph_time(dev, comm) -> dict:
    """In process 0 while the others wait at the barrier: the grouped
    cross-process K3 over its host group (4 rows read where they lie, its
    2 written) at [8, 2^23] and at config 5's largest bucket, and the
    grouped K7 at config 5's first sync, each beside its plain version, on
    rows rotated past the L2; then, every process in step, the whole lane
    calls and gloo's all_reduce / broadcast within each host's pair of
    processes (a gloo group a host, made by every process)."""
    import torch.distributed as dist

    plane = mpi.runtime_state.plane()
    lane = plane.lane(comm)
    groups, local, L = comm.groups, comm.local_ranks, comm.local_size
    mine = next(g for g in groups if local[0] in g)
    owned = [mine.index(r) for r in local]
    out = {}
    for name, n in (("n23", N23), ("bucket", CONFIG5_BUCKET), ("sync", CONFIG5_PARAMS)):
        x = mp_payload(n, torch.float32, 60).to(dev)[local].contiguous()
        tables = []
        for _ in range(2):  # both slots hold every process's rows
            s = lane.publish(x, n * 4)
            views = lane.views(s, (n,), torch.float32)
            tables.append([views[lane.procs[r]][lane.index_of[r]] for r in mine])
            lane.release()
        torch.cuda.synchronize()
        plane.barrier()
        if plane.index == 0:
            copies = max(2, -(-2 * L2_BYTES // (len(mine) * n * 4)))
            tables += [[r.clone() for r in tables[0]] for _ in range(copies - 2)]
            sets = itertools.cycle(tables)
            roots = itertools.cycle([[t[0]] for t in tables])
            if name == "sync":
                out["k7_ms"] = time_ms(lambda: ops.ring_broadcast_xproc(
                    next(roots), L, owned=[0] * L))
                out["k7_plain_ms"] = time_ms(lambda: ops.ring_broadcast_xproc_plain(
                    next(roots), L, owned=[0] * L))
            else:
                out[f"k3_{name}_ms"] = time_ms(lambda: ops.ring_allreduce_xproc(
                    next(sets), L, owned=owned))
                out[f"k3_{name}_plain_ms"] = time_ms(lambda: ops.ring_allreduce_xproc_plain(
                    next(sets), L, owned=owned))
            del sets, roots
        del tables
        torch.cuda.synchronize()
        plane.barrier()
    # every process in step: the whole grouped lane calls, and gloo within
    # each host's pair of processes
    hosts = [dist.new_group(sorted({comm.process_of(r) for r in g}), backend="gloo")
             for g in groups]
    mygroup = hosts[groups.index(mine)]

    def in_step(fn, calls: int) -> float:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        plane.barrier()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e3

    for name, n in (("n23", N23), ("bucket", CONFIG5_BUCKET)):
        x = mp_payload(n, torch.float32, 61).to(dev)[local].contiguous()

        def gloo_allreduce():
            t = x.sum(0).cpu()
            dist.all_reduce(t, group=mygroup)
            return t.to(dev).expand(L, n).contiguous()

        out[f"call_{name}_ms"] = in_step(lambda: lane.allreduce_groups(x, groups), 20)
        out[f"gloo_{name}_ms"] = in_step(gloo_allreduce, 5 if n == N23 else 20)
    x = mp_payload(CONFIG5_PARAMS, torch.float32, 62).to(dev)[local].contiguous()
    root = comm.process_of(mine[0])

    def gloo_broadcast():
        t = x[0].cpu() if plane.index == root else torch.empty(CONFIG5_PARAMS)
        dist.broadcast(t, src=root, group=mygroup)
        return t.to(dev).expand(L, CONFIG5_PARAMS).contiguous()

    out["call_sync_ms"] = in_step(lambda: lane.broadcast_groups(x, groups, 0), 20)
    out["gloo_sync_ms"] = in_step(gloo_broadcast, 20)
    for g in hosts:
        dist.destroy_process_group(g)
    return out


def mph_subsets(dev, plane) -> dict:
    """The communicators over some of the processes: each pair of
    :data:`MPH_SUBSETS` builds a ``Communicator`` over its 4 ranks only
    (processes {0,1} and {2,3} disjoint, {1,2} overlapping) and runs an
    allreduce and a broadcast on ``kernel`` (the cross-process K3 and K7
    over the pair's lane): each process's rows bit for bit the plain
    versions' on the full ``[4, n]``, exactly one launch of each a call.
    Returns this process's launches and lane members by pair."""
    from torchmpi_tpu_torch.runtime.communicator import Communicator

    out = {}
    for i, procs in enumerate(MPH_SUBSETS):
        if plane.index not in procs:
            continue
        ranks = [r for q in procs for r in range(q * MPH_RANKS, (q + 1) * MPH_RANKS)]
        sub = Communicator(ranks, dev, name=f"processes {procs}",
                           processes=[q for q in procs for _ in range(MPH_RANKS)],
                           process_index=plane.index)
        full = mp_payload(MPH_SUBSET_N, torch.float32, 70 + i)[:sub.size].to(dev)
        x = full[sub.local_ranks].contiguous()
        ops.reset_launch_counts()
        got = mpi.kernel.allreduce_tensor(x, comm=sub)
        root = sub.size - 1
        bcast = mpi.kernel.broadcast_tensor(x, root=root, comm=sub)
        torch.cuda.synchronize()
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        require(torch.equal(bits(got), bits(ops.ring_allreduce_plain(full)[sub.local_ranks])),
                f"run (h): allreduce over processes {procs} != the plain version")
        require(torch.equal(bits(bcast), bits(full[root].expand_as(x))),
                f"run (h): broadcast over processes {procs} != the root's row")
        require(counts == {"ring_allreduce_xproc": 1, "ring_broadcast_xproc": 1},
                f"run (h): processes {procs}: launches {counts}")
        from torchmpi_tpu_torch.collectives import eager

        eager.barrier(sub)
        out[f"{procs[0]}{procs[1]}"] = {"launches": counts,
                                        "lane_members": plane.lane(sub).members}
    return out


def mph_worker(out_dir: str) -> None:
    """One process of run (h) (started by the launcher with ``--nproc
    4``): config 5's twin under ``hier`` and under ``use_staged_collectives``
    (:func:`mph_config5`), then the grouped kernels' checks, the staged
    order, the times and the subset communicators; its results to
    ``out_dir/h<i>.json``. Nothing is caught."""
    res = {"hier": mph_config5(False), "staged": mph_config5(True)}
    mpi.start(ranks=MPH_RANKS, with_ici_groups=False)
    try:
        plane = mpi.runtime_state.plane()
        mpi.push_communicator(mph_host_key, name="hosts")
        comm = mpi.current_communicator()
        dev = comm.device
        require(comm.multiprocess and comm.num_nodes() == MPH_PROCS and
                all(len({comm.process_of(r) for r in g}) == 2 for g in comm.groups),
                f"run (h): the host groups {comm.groups} do not span two processes each")
        res["check"] = mph_check(dev, comm)
        res["time"] = mph_time(dev, comm)
        res["subsets"] = mph_subsets(dev, plane)
        index = plane.index
    finally:
        mpi.stop()
    Path(out_dir, f"h{index}.json").write_text(json.dumps(res))
    print(f"run (h) worker {index} OK")


def mph_expected(run: dict) -> dict:
    """A process's launches in run (h)'s config-5 twin: its
    :data:`CONFIG5_PRODUCTS` per-rank products every step, the grouped
    cross-process K3 for every bucket of every step (the intra phase of
    the ``hier`` or ``staged`` plan) and the grouped cross-process K7 for
    each ``hier-kernel`` broadcast plan (the first parameter sync)."""
    want = dict.fromkeys(run["counts"], 0)
    want["rank_bmm"] = CONFIG5_STEPS * CONFIG5_PRODUCTS
    want["ring_allreduce_xproc_grouped"] = CONFIG5_STEPS * CONFIG5["blocks"]
    want["ring_broadcast_xproc_grouped"] = sum(
        1 for label, plan_id in run["plans"]
        if label == "hier_broadcast" and plan_id.startswith("hier-kernel"))
    return want


def mph_run(root: Path) -> tuple:
    """Run (h): the one-process config-5 runs of 8 ranks under ``hier`` and
    ``use_staged_collectives``, then the four workers through ``python -m
    torchmpi_tpu_torch.launch --nproc 4`` (logs and results under
    ``_mph_logs/``), held to them: both runs' losses bit for bit the
    one-process runs' in every process, exact launches, the grouped
    kernels' and the subsets' checks. Prints the ``{"groups_4x2": ...}``
    line; returns the launches summed over the processes (by run) and the
    kernels line's rows of the grouped K3 and K7."""
    t0 = time.perf_counter()
    refs = {}
    for name, staged in (("hier", False), ("staged", True)):
        with constants_set({"use_staged_collectives": staged}):
            refs[name] = config5_run("kernel")
        refs[name]["plans"] = [list(pl) for pl in refs[name]["plans"]]
    logs = root / "_mph_logs"
    for old in logs.glob("h*.json"):
        old.unlink()
    proc = subprocess.run(
        [sys.executable, "-m", "torchmpi_tpu_torch.launch", "--nproc", str(MPH_PROCS),
         "--log-dir", str(logs), str(Path(__file__).resolve()), "--",
         "--mp-groups-worker", str(logs)], cwd=str(root), timeout=600)
    tails = "\n".join(f"--- {f.name}\n" + f.read_text()[-3000:]
                      for f in sorted(logs.glob("rank_*.log")))
    require(proc.returncode == 0, f"run (h) workers failed ({proc.returncode}):\n{tails}")
    res = [json.loads((logs / f"h{i}.json").read_text()) for i in range(MPH_PROCS)]
    seconds = time.perf_counter() - t0
    for i, r in enumerate(res):
        for name in ("hier", "staged"):
            run, ref = r[name], refs[name]
            require(run["losses"] == ref["losses"],
                    f"run (h) proc {i} {name}: losses {run['losses']} != the one-process "
                    f"run's {ref['losses']}")
            require(run["hier_used"], f"run (h) proc {i} {name}: no two-level plan ran")
            want = mph_expected(run)
            require(run["counts"] == want,
                    f"run (h) proc {i} {name}: launches {run['counts']} != {want}")
        require(refs["staged"]["plans"] != refs["hier"]["plans"],
                "run (h): use_staged_collectives changed no plan")
    t = res[0]["time"]
    rows = []
    for name, n, nbytes, nops, ms, plain, lib, shape_note in (
            ("ring_allreduce_xproc_grouped", N23, 6 * N23 * 4, 3 * N23, t["k3_n23_ms"],
             t["k3_n23_plain_ms"], t["gloo_n23_ms"], "its host group's 4 rows read, its 2 written"),
            ("ring_broadcast_xproc_grouped", CONFIG5_PARAMS, 3 * CONFIG5_PARAMS * 4, 0,
             t["k7_ms"], t["k7_plain_ms"], t["gloo_sync_ms"],
             "its host group's root row read, its 2 written")):
        bound_ms, bound_by = bound(nbytes, nops)
        require(bound_ms <= ms, f"{name}: {ms} ms is under its bound {bound_ms} ms")
        rows.append({
            "name": name, "route": "cuda", "source": "torchmpi_tpu_torch/csrc/ring_kernels.cu",
            "replaces": ("torchmpi_tpu/ops/ring_kernels.py:1282" if "broadcast" in name
                         else "torchmpi_tpu/ops/ring_kernels.py:201"),
            "max_abs_err": max(r["check"]["max_abs_err"][name] for r in res),
            "ms": ms, "kernel_ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib,
            "library": ("gloo all_reduce of each process's rows summed, within its host's "
                        "2 processes" if "allreduce" in name else
                        "gloo broadcast of the host root's row within its host's 2 processes"),
            "shape": [P, n], "dtype": "float32", "processes": MPH_PROCS,
            "one_launch": f"one process's: {shape_note}"})
    rows[0]["bucket"] = {"shape": [P, CONFIG5_BUCKET], "ms": t["k3_bucket_ms"],
                         "plain_ms": t["k3_bucket_plain_ms"],
                         "bound_ms": bound(6 * CONFIG5_BUCKET * 4, 3 * CONFIG5_BUCKET)[0],
                         "library_ms": t["gloo_bucket_ms"]}
    summary = {
        "processes": MPH_PROCS, "ranks_per_process": MPH_RANKS, "card": card(),
        "groups": "host r // 4: each host's 4 ranks in 2 processes", "seconds": seconds,
        "checks": sum(r["check"]["checks"] for r in res),
        **{name: {"bitwise_one_process": True, "samples_per_s_chip": res[0][name]["samples_per_s_chip"],
                  "one_process_samples_per_s_chip": refs[name]["samples_per_s_chip"],
                  "final_loss": refs[name]["losses"][-1], "plans": res[0][name]["plans"],
                  "launches_by_process": [{k: v for k, v in r[name]["counts"].items() if v}
                                          for r in res]}
           for name in ("hier", "staged")},
        "staged_order": "JAX multi-controller, bit for bit on f32, integers exact",
        "subsets": [r["subsets"] for r in res],
        "check_launches_by_process": [r["check"]["launches"] for r in res],
        "time": t}
    print(json.dumps({"groups_4x2": summary}))
    runs = {f"mp_h_{name}": {k: sum(r[name]["counts"][k] for r in res)
                             for k in res[0][name]["counts"]} for name in ("hier", "staged")}
    return runs, rows


def phase_multiprocess(dev) -> tuple:
    """``--multiprocess``: the one-process references from the seed, then
    the two workers through ``python -m torchmpi_tpu_torch.launch``
    (their logs and results under ``_mp_logs/``), their results held
    to the contract: the cross-process K3 (allreduce, 'rs', 'ag'), K5, K6
    and K7 bit for bit their plain versions and the one-process rows, run (b)'s
    losses bit for bit the one-process kernel run's, run (a)'s bit for bit
    the one-process run under its span and path and its first
    ``MP_CLOSE_STEPS`` within ``MP_LOSS_RTOL`` of the kernel run's, runs
    (c) and (d) (fsdp, zero1) bit for bit the one-process run under the
    same mode, run (e) (config 2) bit for bit the one-process async int8
    run, exact launches; run (f) (``rank_map='vmap'``) bit for bit the
    one-process vmap run at every step (ROADMAP C6: the convolutions'
    weight gradient is the per-rank kernel, whose sums do not depend on
    how many ranks a process stacks, where cuDNN's grouped one did).
    Prints the ``{"multiprocess": ...}`` line;
    runs run (g) (:func:`mp_bench`) and prints the ``{"bench_2x4": ...}``
    line; returns the runs' launches (summed over the processes) and the
    ten kernel rows of the kernels line (K3's three modes, K7, K5, K6,
    K4's two modes in both wires)."""
    ref, ref_a = mp_reference(False), mp_reference(True)
    refs = {run: mp_reference(False, sharding) for run, sharding in MP_SHARDED.items()}
    ref_e = mp_reference(False, mode="async", wire="int8")
    ref_f = mp_reference(False, rank_map="vmap")
    root = Path(__file__).resolve().parent
    logs = root / "_mp_logs"  # the workers' logs and results
    for old in logs.glob("proc*.json"):
        old.unlink()
    proc = subprocess.run(
        [sys.executable, "-m", "torchmpi_tpu_torch.launch", "--nproc", str(MP_PROCS),
         "--log-dir", str(logs), str(Path(__file__).resolve()), "--", "--mp-worker", str(logs)],
        cwd=str(root), timeout=600)
    tails = "\n".join(f"--- {f.name}\n" + f.read_text()[-3000:]
                      for f in sorted(logs.glob("rank_*.log")))
    require(proc.returncode == 0, f"multiprocess workers failed ({proc.returncode}):\n{tails}")
    res = [json.loads((logs / f"proc{i}.json").read_text()) for i in range(MP_PROCS)]
    g_counts, g_top, g_seconds = mp_bench(root)
    h_runs, h_rows = mph_run(root)
    for i, r in enumerate(res):
        steps = r["b"]["steps"]
        require(steps == ref["steps"] == r["a"]["steps"], f"proc {i}: steps differ")
        require(r["b"]["losses"] == ref["losses"],
                f"proc {i}: run (b)'s losses differ from the one-process kernel run's: "
                f"{r['b']['losses'][:4]} vs {ref['losses'][:4]}")
        require(r["a"]["losses"] == ref_a["losses"],
                f"proc {i}: run (a)'s losses differ from the one-process run under its span and "
                f"path: {r['a']['losses'][:4]} vs {ref_a['losses'][:4]}")
        rel = [abs(a - b) / abs(b) for a, b in zip(r["a"]["losses"], ref["losses"])]
        require(rel[0] == 0, f"proc {i}: run (a)'s first loss differs from the kernel run's")
        close = max(rel[:MP_CLOSE_STEPS])
        require(close <= MP_LOSS_RTOL,
                f"proc {i}: run (a)'s first {MP_CLOSE_STEPS} losses {close} from the kernel run's")
        r["a"]["rel_first"], r["a"]["rel_all"], r["a"]["rel_by_step"] = close, max(rel), rel
        for run, sharding in MP_SHARDED.items():
            require(r[run]["losses"] == refs[run]["losses"],
                    f"proc {i}: run ({run}, {sharding})'s losses differ from the one-process "
                    f"run's: {r[run]['losses'][:4]} vs {refs[run]['losses'][:4]}")
        require(r["e"]["losses"] == ref_e["losses"],
                f"proc {i}: run (e)'s losses differ from the one-process config-2 run's: "
                f"{r['e']['losses'][:4]} vs {ref_e['losses'][:4]}")
        require(ref_e["counts"]["ring_allreduce_quant_int8"] == steps,
                f"the one-process config-2 run launched K4 {ref_e['counts']}")
        # ROADMAP C6: the convolutions' weight gradient under vmap is the
        # per-rank kernel, whose sums do not depend on how many ranks a
        # process stacks, so every step is bit for bit the one-process run's
        rel = [abs(a - b) / abs(b) for a, b in zip(r["f"]["losses"], ref_f["losses"])]
        r["f"]["first_differing_step"] = next((k + 1 for k, v in enumerate(rel) if v), None)
        r["f"]["rel_all"] = max(rel)
        require(r["f"]["losses"] == ref_f["losses"],
                f"proc {i}: run (f)'s losses part from the one-process vmap run's at step "
                f"{r['f']['first_differing_step']} (max rel {r['f']['rel_all']})")
        vmap_want = lenet_vmap_launches(steps)
        require({k: ref_f["counts"][k] for k in vmap_want} == vmap_want,
                f"the one-process vmap run launched the per-rank kernels "
                f"{ {k: ref_f['counts'][k] for k in vmap_want} } times, want {vmap_want}")
        for run, kernel in (("a", False), ("b", True), ("c", True), ("d", True), ("e", True),
                            ("f", True)):
            want = mp_expected(steps, kernel, MP_SHARDED.get(run, "replicated"),
                               "int8" if run == "e" else None, "vmap" if run == "f" else "loop")
            require(r[run]["counts"] == want,
                    f"proc {i} run ({run}): launches {r[run]['counts']} != {want}")
    t = res[0]["time"]
    n, m = LENET_PARAMS, MP_RS_N // P
    rows = []
    for (name, shape, reads, nbytes, nops, ms, plain, lib, lib_name) in (
            ("ring_allreduce_xproc", n, f"{P} rows read, {MP_RANKS} written",
             (P + MP_RANKS) * n * 4, (P - 1) * n, t["k3_ms"], t["k3_plain_ms"],
             t["gloo_allreduce_ms"], "gloo all_reduce of each process's rows summed"),
            ("ring_broadcast_xproc", n, f"1 row read, {MP_RANKS} written",
             (1 + MP_RANKS) * n * 4, 0, t["k7_ms"], t["k7_plain_ms"],
             t["gloo_broadcast_ms"], "gloo broadcast of the root's row"),
            # each process reads its MP_RANKS segments from every row and
            # writes them; the adds are (P - 1) a written element
            ("ring_reduce_scatter_xproc", MP_RS_N,
             f"{MP_RANKS} segments of each of {P} rows read, {MP_RANKS} written",
             (MP_RANKS * MP_RS_N + MP_RANKS * m) * 4, (P - 1) * MP_RANKS * m, t["rs_ms"],
             t["rs_plain_ms"], t["gloo_rs_ms"],
             t.get("gloo_rs_none", "gloo reduce_scatter_tensor of each process's rows summed")),
            ("ring_allgather_xproc", MP_AG_N, f"{P} blocks read, {MP_RANKS} x {P} written",
             (P + MP_RANKS * P) * MP_AG_N * 4, 0, t["ag_ms"], t["ag_plain_ms"],
             t["gloo_ag_ms"], "gloo all_gather of each process's rows"),
            # the cross-process K4: every row position's chain walked over
            # the P rows, its MP_RANKS ranks stored; the 'rs' walks its
            # MP_RANKS segments. Operations as the one-process K4 rows count
            # them (int8 7 a hop, bf16 2), plus the installs stored
            *((f"ring_allreduce_quant_xproc_{w}", BUCKET0, f"{P} rows read, {MP_RANKS} written",
               (P + MP_RANKS) * BUCKET0 * 4,
               ((P - 1) * (7 if w == "int8" else 2) + MP_RANKS) * BUCKET0,
               t[f"k4ar_{w}_ms"], t[f"k4ar_{w}_plain_ms"], None,
               "none: no PyTorch call requantizes on every hop") for w in WIRES),
            # the cross-process K5 and K6: each process's (K6: the root's
            # process's) launch reads the P rows and writes its MP_RANKS
            ("ring_allreduce_bidir_xproc", MP_K56_N, f"{P} rows read, {MP_RANKS} written",
             (P + MP_RANKS) * MP_K56_N * 4, (P - 1) * MP_K56_N, t["k5_ms"], t["k5_plain_ms"],
             t["gloo_k5_ms"], "gloo all_reduce of each process's rows summed"),
            ("ring_reduce_xproc", MP_K56_N,
             f"the root's process: {P} rows read, {MP_RANKS} written (the root's sum, the "
             "other rows their inputs)", (P + MP_RANKS) * MP_K56_N * 4, (P - 1) * MP_K56_N,
             t["k6_ms"], t["k6_plain_ms"], t["gloo_k6_ms"],
             "gloo reduce of each process's rows summed to the root's process"),
            *((f"ring_reduce_scatter_quant_xproc_{w}", MP_QUANT_RS_N,
               f"{MP_RANKS} segments of each of {P} rows read, {MP_RANKS} written",
               (MP_RANKS * MP_QUANT_RS_N + MP_RANKS * (MP_QUANT_RS_N // P)) * 4,
               (P - 1) * (7 if w == "int8" else 2) * MP_RANKS * (MP_QUANT_RS_N // P),
               t[f"k4rs_{w}_ms"], t[f"k4rs_{w}_plain_ms"], None,
               "none: no PyTorch call requantizes on every hop") for w in WIRES)):
        bound_ms, bound_by = bound(nbytes, nops)
        require(bound_ms <= ms, f"{name}: {ms} ms is under its bound {bound_ms} ms")
        quant = "quant" in name
        rows.append({
            "name": name, "route": "cuda",
            "source": ("torchmpi_tpu_torch/csrc/ring_quant.cu" if quant
                       else "torchmpi_tpu_torch/csrc/ring_kernels.cu"),
            "replaces": ("torchmpi_tpu/ops/ring_kernels.py:1282" if "broadcast" in name
                         else "torchmpi_tpu/ops/ring_kernels.py:551" if quant
                         else "torchmpi_tpu/ops/ring_kernels.py:897" if "bidir" in name
                         else "torchmpi_tpu/ops/ring_kernels.py:1120" if name == "ring_reduce_xproc"
                         else "torchmpi_tpu/ops/ring_kernels.py:201"),
            "max_abs_err": max(r["check"]["max_abs_err"][name] for r in res),
            "ms": ms, "kernel_ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib, "library": lib_name,
            "shape": [P, shape], "dtype": "float32", "processes": MP_PROCS,
            "one_launch": f"one process's: {reads}"})
    summary = {
        "processes": MP_PROCS, "ranks_per_process": MP_RANKS, "card": card(),
        "checks": sum(r["check"]["checks"] for r in res),
        "one_process": {"samples_per_s": ref["samples_per_s"], "steps": ref["steps"],
                        "final_loss": ref["losses"][-1]},
        "one_process_vendor_span": {"samples_per_s": ref_a["samples_per_s"]},
        "a": {k: res[0]["a"][k] for k in ("samples_per_s", "plans", "span", "rel_first",
                                          "rel_all", "rel_by_step", "lane_calls", "protocol_us")},
        "a_bitwise_one_process_same_span": True,
        "b": {k: res[0]["b"][k] for k in ("samples_per_s", "plans", "span", "lane_calls",
                                          "protocol_us")},
        "b_bitwise_one_process": True,
        "k3": {"shape": [P, n], "ms": t["k3_ms"], "call_ms": t["call_ms"],
               "protocol_us": t["protocol_us"], "staging_ms": t["staging_ms"],
               # both processes' launches: each reads the P rows and writes its own
               "job_bound_ms": MP_PROCS * (P + MP_RANKS) * n * 4 / HBM_BYTES_PER_S * 1e3,
               # both processes' staging copies: each reads and writes its rows
               "staging_bound_ms": MP_PROCS * 2 * MP_RANKS * n * 4 / HBM_BYTES_PER_S * 1e3,
               "gloo_allreduce_ms": t["gloo_allreduce_ms"]},
        "k7": {"ms": t["k7_ms"], "gloo_broadcast_ms": t["gloo_broadcast_ms"]},
        "rs": {"shape": [P, MP_RS_N], "ms": t["rs_ms"], "call_ms": t["rs_call_ms"],
               "gloo_ms": t["gloo_rs_ms"], "gloo_none": t.get("gloo_rs_none")},
        "ag": {"shape": [P, MP_AG_N], "ms": t["ag_ms"], "call_ms": t["ag_call_ms"],
               "gloo_ms": t["gloo_ag_ms"]},
        "k4": {f"{mode}_{w}": {"shape": [P, n], "ms": t[f"k4{mode}_{w}_ms"],
                               "call_ms": t[f"k4{mode}_{w}_call_ms"],
                               "protocol_us": t[f"k4{mode}_{w}_protocol_us"]}
               for mode, n in (("ar", BUCKET0), ("rs", MP_QUANT_RS_N)) for w in WIRES},
        # the host time to issue an async allreduce across the processes
        # (the reference's contract: under 50 us; reported, not gated)
        "async_issue_us": {"shape": [MP_RANKS, MP_ISSUE_N],
                           **{k: r["time"][k] for r in res[:1] for k in
                              ("issue_async_allreduce_tensor_us",
                               "issue_async_kernel_pinned_us")},
                           "by_process": [{k: r["time"][k] for k in
                                           ("issue_async_allreduce_tensor_us",
                                            "issue_async_kernel_pinned_us")} for r in res]},
        "e": {"config": 2, "bitwise_one_process": True,
              "one_process_samples_per_s": ref_e["samples_per_s"],
              "final_loss": ref_e["losses"][-1], "loss_gate": ref_e["loss_gate"],
              **{k: res[0]["e"][k] for k in ("samples_per_s", "plans", "span", "lane_calls",
                                            "protocol_us", "slab_growths", "slab_mib")},
              "launches_per_process": {k: v for k, v in res[0]["e"]["counts"].items() if v}},
        "f": {"rank_map": "vmap",
              "bitwise_one_process": all(r["f"]["losses"] == ref_f["losses"] for r in res),
              "first_differing_step": [r["f"]["first_differing_step"] for r in res],
              "max_rel_loss": max(r["f"]["rel_all"] for r in res),
              "one_process_samples_per_s": ref_f["samples_per_s"],
              "loop_one_process_samples_per_s": ref["samples_per_s"],
              "samples_per_s": res[0]["f"]["samples_per_s"],
              "losses_first": [ref_f["losses"][:6], res[0]["f"]["losses"][:6]],
              "loss_gate": [ref_f["loss_gate"], *(r["f"]["loss_gate"] for r in res)]},
    }
    for run, sharding in MP_SHARDED.items():
        summary[run] = {
            "sharding": sharding, "bitwise_one_process": True,
            "one_process_samples_per_s": refs[run]["samples_per_s"],
            "final_loss": refs[run]["losses"][-1],
            **{k: res[0][run][k] for k in ("samples_per_s", "plans", "span", "lane_calls",
                                           "protocol_us", "slab_growths", "slab_mib")},
            "launches_per_process": {k: v for k, v in res[0][run]["counts"].items() if v}}
    summary["k5"] = {"shape": [P, MP_K56_N], "ms": t["k5_ms"], "call_ms": t["k5_call_ms"],
                     "gloo_ms": t["gloo_k5_ms"]}
    summary["k6"] = {"shape": [P, MP_K56_N], "ms": t["k6_ms"], "call_ms": t["k6_call_ms"],
                     "gloo_ms": t["gloo_k6_ms"]}
    summary["g"] = {"seconds": g_seconds, "ops": list(MP_BENCH_OPS), "sizes": len(SWEEP),
                    "xla_reps": list(MP_BENCH_XLA_REPS), "all_correct": True,
                    "launches": {k: v for k, v in g_counts.items() if v}}
    print(json.dumps({"multiprocess": summary}))
    # the sweep's bus GB/s at its largest size: one process of P ranks (the
    # complete run's phase_bench; absent under --multiprocess) and the two
    # processes of run (g)
    print(json.dumps({"bench_2x4": {
        "nelem": SWEEP[-1], "card": card(), "xla_reps": list(MP_BENCH_XLA_REPS),
        "bus_gbps": {k: {"one_process": BENCH_TOP.get(k), "two_processes": v}
                     for k, v in sorted(g_top.items())}}}))
    runs = {f"mp_{run}": {k: sum(r[run]["counts"][k] for r in res) for k in res[0][run]["counts"]}
            for run in ("a", "b", *MP_SHARDED, "e", "f")}
    runs["mp_g"] = g_counts
    runs.update(h_runs)
    return runs, rows + h_rows


def phase_timing(dev, runs: dict, errs: dict, timed_rows=()) -> None:
    """Time every kernel (:func:`timing_rows`, :func:`time_rows`) and print
    the ``{"kernels": [...]}`` line, with ``timed_rows``, the rows timed
    across processes (:func:`phase_multiprocess`), their launches summed
    over ``runs`` as the others'."""
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = timing_rows(lambda *shape: torch.randn(shape, generator=gen, device=dev))
    out = time_rows(rows, runs, errs, launch_floor_ms())
    for row in timed_rows:
        by_path = {path: counts[row["name"]] for path, counts in runs.items()}
        out.append({**row, "launches": sum(by_path.values()), "launches_by_path": by_path})
    print(json.dumps({"kernels": out}))


def attention_only(dev) -> None:
    """``--attention``: build the attention kernels, print their ptxas
    report, hold them against their plain versions, run the bf16 sp LM with
    and without remat under its gates (``{"attention_lm"}``), then time
    K8, K9 and K10 in f32 and bf16 at the LM path's shape
    (``{"attention_kernels": [...]}``, launches from the two LM runs)."""
    phase_build(ATTENTION_SOURCES)
    errs = check_attention(dev, torch.Generator(device=dev).manual_seed(0))
    runs, line = lm_bf16(dev)
    print(json.dumps({"attention_lm": {**line, "card": card()}}))
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    rows = attention_rows(randn, torch.float32) + [
        dict(r, err=f"{r['name']}@lm_bf16") for r in attention_rows(randn, torch.bfloat16)]
    print(json.dumps({"attention_kernels": time_rows(rows, runs, errs, launch_floor_ms())}))
    print(json.dumps({"attention_profile": attention_profile(randn)}))


def attention_profile(randn, calls: int = 20) -> dict:
    """Device microseconds a call of each CUDA kernel that K8 and K10 launch
    on bf16 inputs at the LM path's shape, causal (K10's dQ and dK/dV
    launches apart), from ``torch.profiler`` over ``calls`` calls each."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, do = (randn(*ATTN_MAIN).to(torch.bfloat16) for _ in range(4))
    o, lse = ops.ring_attention_fwd(q, k, v, True)
    ops.ring_attention_bwd(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ops.ring_attention_fwd(q, k, v, True)
            ops.ring_attention_bwd(q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if "wgmma_kernel" in e.key and us:
            out[e.key.split("(")[0].replace("void ", "")] = us / calls
    return {"us_per_call": out, "shape": list(ATTN_MAIN), "card": card()}


def quant_only(dev, check: bool) -> None:
    """``--quant``: build K4 alone, print its registers, spills and SASS
    counts, hold it against its plain version (``check``), and time its
    rows (``{"quant_kernels": [...]}``, no launches: no path is driven)."""
    phase_build(("ring_quant",))
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = check_quant(dev, gen) if check else {}
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = [r for r in timing_rows(lambda *shape: torch.randn(shape, generator=gen, device=dev))
            if "quant" in r["name"]]
    print(json.dumps({"quant_kernels": time_rows(rows, {}, errs, launch_floor_ms())}))


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--quant", choices=("check", "time"),
        help="only K4: build, registers and SASS, then 'check' (against the plain "
             "version) and time, or 'time' alone; prints no result line")
    parser.add_argument(
        "--many", action="store_true",
        help="only K1 and K2's list kernels: build, check them against the plain versions "
             "(check_many); prints no result line")
    parser.add_argument(
        "--resnet", action="store_true",
        help="only the ResNet phase (after the build and the sync MNIST path it prints "
             "beside the sequential twin); prints no result line")
    parser.add_argument(
        "--sharded", action="store_true",
        help="only the sharded phase (fsdp, zero1, accumulation and remat) and the "
             "retime of K3 'rs' and 'ag', after the build; prints no result line")
    parser.add_argument(
        "--hier", action="store_true",
        help="only the two-level phase (every two-level lowering against the CPU, the config-5 "
             "twin under both intra transports, the {\"hier\"} line), after the build; prints "
             "no result line")
    parser.add_argument(
        "--engine", action="store_true",
        help="only the engine phase (checkpoints and resume, the reshard CLI, telemetry, the "
             "profile window, the scheduled bucket sync, the eval cache; the {\"engine\"} line), "
             "after the build; prints no result line")
    parser.add_argument(
        "--parallel", action="store_true",
        help="only the parallel phase (the tp and pipeline twins, the MoE and 3-D steps, the "
             "bf16 and remat sp LM, the LM through the engine; the {\"parallel\"} line), after "
             "the build; prints no result line")
    parser.add_argument(
        "--observe", action="store_true",
        help="only the observability phase (tune_all with exact launches, the tuning's reload, "
             "the live plane and the analyzer on configs 1 and 2, the measured calibration, "
             "A11's cost on the sync step; the {\"observe\"} line), after the build; prints no "
             "result line")
    parser.add_argument(
        "--streaming", action="store_true",
        help="only the streamed ResNet-50 phase (the example's --streaming against source.gather "
             "and a plain iterator, exact launches, the resident run beside it; the "
             "{\"streaming\"} line), after the build; prints no result line")
    parser.add_argument(
        "--serve", action="store_true",
        help="only the serving phase (LeNet served from the parameter server while a downpour "
             "trainer publishes; the {\"serve\"} line), after the build; prints no result line")
    parser.add_argument(
        "--synth", action="store_true",
        help="only the synthesized lowerings' phase (halve, torus and stripe on the card against "
             "the CPU, timed at 2^23, config 5 trained through them; the {\"synth\"} line), "
             "after the build; prints no result line")
    parser.add_argument(
        "--supervise", action="store_true",
        help="only the supervised rollback (LeNet's sync engine, a held allreduce's hang "
             "verdict, the supervisor's evictions and rollback; the {\"supervise\"} line), "
             "after the build; prints no result line")
    parser.add_argument(
        "--compiler", action="store_true",
        help="only the schedule compiler's phase (warm plans after precompile, plan stamps, "
             "telemetry's cost, the ring's pipeline depth) and the async issue line, after the "
             "build; prints no result line")
    parser.add_argument(
        "--multiprocess", action="store_true",
        help="only the multi-process phase (the cross-process K3 allreduce, 'rs' and 'ag', K4, "
             "K5, K6 and K7 against their plain versions, config 1 by 2 processes x 4 ranks "
             "through the launcher, runs (a) and (b) replicated, (c) fsdp, (d) zero1, (e) "
             "config 2, (f) rank_map='vmap', (g) the collectives benchmark by the two processes; "
             "(h) config 5 by 4 processes x 2 ranks in hosts of 2 processes, the grouped "
             "cross-process K3 and K7, communicators over some of the processes; the "
             "{\"multiprocess\"}, {\"bench_2x4\"} and {\"groups_4x2\"} lines), after the "
             "build; prints no result line")
    parser.add_argument(
        "--attention", action="store_true",
        help="only the attention kernels (K8, K9, K10): build them, print their registers, "
             "spills and setmaxnreg, check them against their plain versions "
             "(check_attention), train the bf16 sp LM with and without remat under its gates, "
             "and print their f32 and bf16 kernels rows (launches from the LM runs); prints "
             "no result line")
    parser.add_argument(
        "--wgrad", action="store_true",
        help="only the per-rank kernels (the convolution weight gradient and the product): "
             "build them, check them against their plain versions and across stacks, print "
             "their kernels rows (no launches: no path is driven); prints no result line")
    parser.add_argument("--mp-worker", metavar="DIR", help=argparse.SUPPRESS)
    parser.add_argument("--mp-groups-worker", metavar="DIR", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
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
    if args.mp_worker:
        mp_worker(args.mp_worker)
        return
    if args.mp_groups_worker:
        mph_worker(args.mp_groups_worker)
        return
    phase_device()
    if args.quant:
        quant_only(dev, args.quant == "check")
        return
    if args.many:
        phase_build(("reduce_kernel",))
        check_many(dev, torch.Generator(device=dev).manual_seed(0))
        return
    if args.attention:
        attention_only(dev)
        return
    if args.wgrad:
        phase_build(("conv_wgrad", "rank_bmm"))
        errs = check_wgrad(dev, torch.Generator(device=dev).manual_seed(0))
        errs.update(check_bmm(dev, torch.Generator(device=dev).manual_seed(0)))
        gen = torch.Generator(device=dev).manual_seed(1)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        print(json.dumps({"wgrad_kernels": time_rows([wgrad_row(randn), bmm_row(randn)], {}, errs,
                                                     launch_floor_ms())}))
        return
    phase_build()
    mark("build")
    if args.resnet:
        phase_resnet(dev, main_path(dev, "sync", "full"))
        return
    if args.sharded:
        phase_sharded(dev)
        phase_rs_retime(dev)
        return
    if args.compiler:
        phase_compiler(dev)
        phase_async_issue(dev)
        return
    if args.hier:
        phase_hier(dev)
        return
    if args.engine:
        phase_engine(dev)
        return
    if args.parallel:
        phase_parallel(dev)
        return
    if args.observe:
        phase_observe(dev)
        return
    if args.streaming:
        phase_streaming(dev)
        return
    if args.serve:
        phase_serve(dev)
        return
    if args.synth:
        phase_synth(dev)
        return
    if args.supervise:
        phase_supervise(dev)
        return
    if args.multiprocess:
        phase_multiprocess(dev)
        return
    errs = phase_kernels(dev)
    mark("kernels")
    trainer = phase_trainer(dev)
    mark("trainer")
    runs = {path: run["counts"] for path, run in trainer.items()}
    phase_async(dev)
    mark("async")
    runs.update(phase_bench())
    mark("bench")
    phase_async_issue(dev)
    mark("async_issue")
    phase_compiler(dev)
    mark("compiler")
    hier_runs, hier_errs = phase_hier(dev)
    mark("hier")
    runs.update(hier_runs)
    errs.update(hier_errs)
    lm_runs, lm_stats = phase_lm(dev)
    mark("lm")
    runs.update(lm_runs)
    runs.update(phase_parallel(dev, lm_stats.pop("losses")))
    mark("parallel")
    runs.update(phase_resnet(dev, trainer["sync"]))
    mark("resnet")
    runs.update(phase_sharded(dev))
    mark("sharded")
    runs.update(phase_engine(dev))
    mark("engine")
    runs.update(phase_observe(dev))
    mark("observe")
    runs.update(phase_ps(dev))
    mark("ps")
    phase_ps_vs_cpu(dev)
    mark("ps_vs_cpu")
    phase_ps_throughput()
    mark("ps_throughput")
    phase_profile("sync", "full")
    mark("profile")
    phase_profile("async", "int8")
    mark("profile")
    phase_profile_lm(dev, lm_stats)
    mark("profile_lm")
    phase_profile_ps()
    mark("profile_ps")
    phase_rs_retime(dev)
    mark("rs_retime")
    runs.update(phase_streaming(dev))
    mark("streaming")
    runs.update(phase_serve(dev))
    mark("serve")
    runs.update(phase_synth(dev))
    mark("synth")
    runs.update(phase_supervise(dev))
    mark("supervise")
    mp_runs, mp_rows = phase_multiprocess(dev)
    mark("multiprocess")
    runs.update(mp_runs)
    phase_timing(dev, runs, errs, mp_rows)
    mark("timing")
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
