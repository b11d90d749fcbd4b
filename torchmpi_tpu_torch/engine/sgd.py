"""Data-parallel SGD over virtual ranks: synchronous or asynchronous with
replicated parameters, or synchronous with sharded optimizer state
(``'zero1'``) or sharded parameters and optimizer state (``'fsdp'``).

The port of ``torchmpi_tpu/engine/sgd.py:AllReduceSGDEngine``. The JAX
engine compiles one SPMD step whose gradient sync is in-graph (and, under
fsdp/zero1, one GSPMD step over the global batch); PyTorch has no such
step, so this one does what ``sgdengine.lua`` did through
``mpinn.synchronizeGradients`` — eager collectives after the backward
pass, which the selector sends through the ring kernels.

``param_sharding='replicated'`` (the reference's model):

1. per-rank losses and gradients over the rank-stacked batch, each rank
   with its own copy of the parameters: ``torch.func.vmap`` of
   ``grad_and_value`` (``rank_map='vmap'``; a convolution with rank-stacked
   weights runs as one grouped convolution), or one ``grad_and_value`` per
   rank in turn (``rank_map='loop'``), which computes the same and holds
   one rank's activations at a time (for ResNet-50 at full width on one
   H100 the loop is the faster, and the ResNet example's default:
   PERF.md);
2. with a ``model_state`` (batch-norm statistics), the ranks' new states
   averaged over the ranks (``sgd.py:489-492``'s ``pmean``): one fused
   allreduce, divided by p;
3. the gradient sync:
   - ``mode='sync'`` with the 'full' wire: ``nn.synchronize_gradients``,
     one fused allreduce of all gradients (the ring-allreduce kernel);
   - ``mode='async'`` (``sgdengine.lua:91-124``): ``GradientBuckets``
     (``num_buckets``) launches one async allreduce per bucket on a side
     stream, then waits them in reverse order (``nn.lua:207-212``);
   - a compressed wire (``wire_dtype='int8'`` or ``'bf16'``) takes the
     bucketed path in sync mode too, with one bucket (``sgd.py:328-337``);
     each bucket above the cutoffs goes through the quantized ring kernel;
4. divide by p (``average_gradients=True``);
5. the optimizer's update (:class:`~torchmpi_tpu_torch.engine.optim.SGD`:
   plain SGD with ``lr``, or with a momentum whose trace step is the
   scale-accumulate kernel over every leaf at once; or
   :class:`~torchmpi_tpu_torch.engine.optim.Adam`), added to the
   parameters by the accumulate kernel over every leaf at once (the port's
   ``optax.apply_updates``).

At construction the parameters are replicated to every rank and, with
``broadcast_parameters=True``, equalised from rank 0 by
``nn.synchronize_parameters`` (the ring-broadcast kernel), which
:meth:`AllReduceSGDEngine.broadcast_parameters_now` repeats on demand.
Under a compressed wire each chunk's owner keeps its f32 sum and the other
ranks its wire decoding, so replicas drift apart by the wire's rounding,
as in the JAX engine. The model state is replicated as it is given, not
broadcast, as in the JAX engine.

``param_sharding='zero1'`` / ``'fsdp'`` (``sgd.py:343-361``, ``517-556``):
a leaf is sharded when one of its axes has at least p elements and divides
by p, as in the JAX engine; any other leaf stays replicated and its
gradient is allreduced as above. Rank r's shard of a leaf is the r-th p-th
of the leaf's row-major flattening, ``[p, n / p]`` over the ranks: the
r-th block of the leaf's axis 0 where that axis divides by p. The JAX
engine shards the first axis of the flax leaf that divides by p; the
port's leaves are flax's transposed (dense kernels ``[out, in]``, conv
kernels OIHW; ``models.convert``), so a resharding between the two moves
that axis to the front of the port's layout before flattening. The step:

1. under ``'fsdp'`` the parameter shards, packed per dtype, are gathered
   by one ``allgather_tensor`` (K3 'ag'); under ``'zero1'`` the
   parameters are replicated already;
2. each rank's partial gradient: the gradient of the global loss with
   respect to that rank's copy of the weights. For a stateless loss that
   is the rank's gradient of its own mean loss, divided by p after the
   sum. With a ``model_state`` the loss is called once on the rank-stacked
   parameters, state and batch and must return the mean loss over all
   ranks' rows and the global new state (``models.make_stateful_loss_fn``
   does: batch norm over every rank's rows, as the JAX GSPMD step; the
   state is not averaged afterwards);
3. the sharded leaves' partials are summed by the reduce-scatter form of
   the communicator's ``FusionBuffer`` (K3 'rs' per flush), each rank
   keeping its shard of the sum;
4. the optimizer runs on the shards (the momentum trace one K2 list
   call); under ``'fsdp'`` one K1 list call adds the updates to the
   parameter shards; under ``'zero1'`` the updates are gathered by one
   ``allgather_tensor`` (K3 'ag', "the applied updates are gathered once
   per step", ``sgd.py:211-214``) and one K1 list call adds them to the
   replicated parameters.

One process holds one logical copy, as in the JAX package, so the sharded
modes broadcast nothing at construction and ``broadcast_parameters_now``
is the identity (``sgd.py:376-389, 574-579``). ``self.params`` holds the
shards of the sharded leaves under ``'fsdp'``;
:meth:`AllReduceSGDEngine.gathered_params` gives the full rank-stacked
parameters in every mode. In a job of several processes every tree holds
this process's rows (``comm.local_ranks``), rank r's shard on rank r's
row, and the reduce-scatter and allgather are the cross-process K3 'rs'
and 'ag' on the kernel backend, the int8 or bf16 wire the cross-process
K4; a model state under a sharded mode there raises (its global batch
statistics need a reduction across processes inside the forward, ROADMAP
A13's rest).

``accum_steps=k`` cuts each rank's batch into k equal microbatches (rows
``[i b, (i + 1) b)`` of every rank, the rank-major split of
``sgd.py:527-540``), runs them in turn, sums their gradients from zeros
with K1 list calls and divides by k, then makes one collective and one
update (``sgd.py:430-464``). The model state gets k microbatch-sized
updates: per rank, then averaged, under ``'replicated'``; global under the
sharded modes. ``remat=True`` wraps the loss so that its backward
recomputes the forward (:class:`_Remat`), with gradients equal to the
plain ones bit for bit. ``batch_format`` ('auto' | 'flat' | 'stacked')
says whether :meth:`AllReduceSGDEngine.step` takes flat ``[p B, ...]``
batches (``sgd.py:1495-1519``).

:meth:`AllReduceSGDEngine.train_resident` stages a dataset on the device
once and runs epochs of steps over it (rank r's batches from its own
contiguous shard in every mode), and :meth:`AllReduceSGDEngine.evaluate`
runs a metric over an evaluation set split over the ranks.
:meth:`AllReduceSGDEngine.collective_specs` declares the gradient sync's
collectives and :meth:`AllReduceSGDEngine.precompile` warms and pins their
plans in the schedule compiler (``sgd.py:654-730``), so the first step
plans none. :meth:`AllReduceSGDEngine.evaluate` stages an evaluation set
on the device once and serves it from a cache of up to four sets, keyed
by the arrays' identities and checked by a full-buffer checksum, so an
in-place mutation re-stages (:meth:`AllReduceSGDEngine.invalidate_eval_cache`
drops sets by hand).

Observability and checkpoints (``sgd.py:787-891, 1379-1493``):

- ``profile_dir`` opens a :class:`~torchmpi_tpu_torch.utils.tracing.ProfilerWindow`
  (``torch.profiler``) over steps ``profile_window = (begin, end)`` of
  :meth:`AllReduceSGDEngine.train`, the reference's nvprof window
  (``sgdengine.lua:38-63``), and writes a Chrome trace when it closes;
- with telemetry enabled at construction, every step of :meth:`step` and
  :meth:`train` (and every epoch of :meth:`train_resident`) blocks on its
  loss and records the ``tm_engine_*`` metrics, an ``engine.step`` (or
  ``engine.epoch``) span and flight entry, each step under a trace
  context rooted at its ordinal; the global gradient norm after the sync
  is computed then only; ``flops_per_sample`` turns the rate into
  TFLOP/s and MFU against the card's peak in the parameters' dtype;
  :meth:`train` measures its wait on the input iterator
  (``state['input_stall']``);
- :meth:`AllReduceSGDEngine.checkpoint_every` saves a portable sharded
  checkpoint (:mod:`~torchmpi_tpu_torch.utils.checkpoint`) every N calls
  of :meth:`step`: the host copy on the step thread, the files on a
  background thread, one save in flight (across processes, the
  cooperative save on the step thread).

The JAX engine's ``resize`` (a live world resize) is not ported yet
(ROADMAP A10).
"""

from __future__ import annotations

import contextlib
import math
import sys
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import collectives, constants
from .. import nn as mpinn
from .. import telemetry as _telemetry
from ..ops import accumulate_many
from ..runtime.communicator import Communicator
from ..telemetry import flightrecorder as _flight
from ..telemetry import tracecontext as _tracecontext
from ..utils import checkpoint as _ckpt
from ..utils.flops import mfu
from ..utils.tracing import ProfilerWindow, annotate
from .optim import SGD
from .rankwise import by_rank_products

Tree = Dict[str, torch.Tensor]

# the engine's telemetry handles, made by the first telemetry-enabled engine
_ENG_MET = None


def _engine_metrics():
    """The ``tm_engine_*`` metrics of ``sgd.py:50-95``, same names and
    kinds."""
    global _ENG_MET
    if _ENG_MET is None:
        m = _telemetry.metrics
        _ENG_MET = (
            m.counter("tm_engine_steps_total", "optimizer steps taken"),
            m.histogram(
                "tm_engine_step_seconds",
                "blocking wall time per training step (telemetry-enabled "
                "engines block on the step to time it honestly)",
            ),
            m.histogram("tm_engine_epoch_seconds", "wall time per device-resident epoch"),
            m.gauge("tm_engine_examples_per_sec", "training throughput over the last step/epoch"),
            m.gauge("tm_engine_grad_norm", "global gradient norm after synchronization"),
            m.gauge(
                "tm_engine_mfu",
                "model-FLOPs utilization vs the card's peak in the parameters' "
                "dtype (engines constructed with flops_per_sample only)",
            ),
            m.gauge("tm_engine_tflops_per_chip",
                    "achieved TFLOP/s per chip (flops_per_sample engines)"),
            m.gauge(
                "tm_engine_mfu_incl_input",
                "MFU over the step window INCLUDING measured input-stall "
                "time; diverges from tm_engine_mfu exactly when the run "
                "is input-bound",
            ),
            m.counter(
                "tm_engine_input_stall_seconds",
                "seconds the training loop spent waiting on the input "
                "iterator (excluded from tm_engine_mfu's step window)",
            ),
        )
    return _ENG_MET


def _array_fingerprint(a) -> Optional[tuple]:
    """Exact content fingerprint (shape, dtype, full-buffer CRC32) of a
    host array or CPU tensor (``sgd.py:144-162``), which detects any
    in-place mutation of a cached evaluation set; None for a tensor on a
    device, which is not cached (staging it copies nothing)."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            return None
        a = a.detach()
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    arr = np.asarray(a)
    if arr.size == 0:
        return (arr.shape, arr.dtype.str, 0)
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    return (arr.shape, arr.dtype.str, zlib.crc32(memoryview(arr).cast("B")))


class _Remat(torch.autograd.Function):
    """A loss whose backward recomputes its forward (``jax.checkpoint``):
    ``apply(run, n, *flat)`` returns ``run(*flat)``, a tuple of the loss and
    any state tensors (not differentiable), without keeping the forward's
    activations; the backward runs ``run`` again under ``torch.func.vjp``
    for the first ``n`` inputs (the parameters). It composes with
    ``torch.func.grad`` and ``vmap`` (``setup_context`` and a generated
    vmap rule), which ``torch.utils.checkpoint`` does not, and computes
    the same operations, so the gradients equal the plain ones bit for
    bit."""

    generate_vmap_rule = True

    @staticmethod
    def forward(run, n, *flat):
        return run(*flat)

    @staticmethod
    def setup_context(ctx, inputs, output):
        run, n, *flat = inputs
        ctx.run, ctx.n = run, n
        ctx.save_for_backward(*flat)
        ctx.mark_non_differentiable(*output[1:])

    @staticmethod
    def backward(ctx, grad_loss, *_):
        flat, n = ctx.saved_tensors, ctx.n
        _, vjp = torch.func.vjp(lambda *prm: ctx.run(*prm, *flat[n:])[0], *flat[:n])
        return (None, None) + tuple(vjp(grad_loss)) + (None,) * (len(flat) - n)


def remat_loss(loss_fn: Callable, has_state: bool) -> Callable:
    """``loss_fn`` (``(params, batch) -> loss``, or ``(params, state,
    batch) -> (loss, new_state)`` with ``has_state``) through
    :class:`_Remat`."""

    def wrapped(params: Tree, *rest):
        keys = list(params)
        flat_rest, spec = pytree.tree_flatten(rest)
        state_keys: list = []

        def run(*flat):
            args = pytree.tree_unflatten(list(flat[len(keys):]), spec)
            out = loss_fn(dict(zip(keys, flat[:len(keys)])), *args)
            if not has_state:
                return (out,)
            loss, state = out
            state_keys[:] = list(state)
            return (loss,) + tuple(state.values())

        out = _Remat.apply(run, len(keys), *[params[k] for k in keys], *flat_rest)
        if not has_state:
            return out[0]
        return out[0], dict(zip(state_keys, out[1:]))

    return wrapped


class AllReduceSGDEngine:
    """Data-parallel SGD engine over a communicator.

    ``loss_fn(params, batch) -> scalar`` is one rank's loss (see
    ``models.make_loss_fn``); ``params`` is a dict of un-stacked initial
    parameters. ``self.params`` holds the rank-stacked ``[p, ...]``
    parameters on the communicator's device (under ``'fsdp'``, the
    ``[p, n / p]`` shards of the sharded leaves), ``self.opt_state`` the
    optimizer's state (on the shards under the sharded modes) and
    ``self.model_state`` the rank-stacked model state (or None)."""

    def __init__(
        self,
        loss_fn: Callable,
        params: Dict[str, torch.Tensor],
        lr: float = 0.2,
        comm: Optional[Communicator] = None,
        mode: str = "sync",
        num_buckets: int = 4,
        average_gradients: bool = True,
        broadcast_parameters: bool = True,
        hooks: Optional[Dict[str, Callable]] = None,
        wire_dtype: Optional[str] = None,
        optimizer=None,
        model_state: Optional[Dict[str, torch.Tensor]] = None,
        rank_map: str = "vmap",
        param_sharding: str = "replicated",
        accum_steps: int = 1,
        remat: bool = False,
        batch_format: str = "auto",
        profile_dir: Optional[str] = None,
        profile_window: tuple = (3, 8),
        flops_per_sample: Optional[int] = None,
    ):
        """``mode``: 'sync' (one fused allreduce) or 'async' (bucketed);
        ``num_buckets``: the buckets of async mode (``BlockSequential``'s
        N). ``wire_dtype``: the gradient allreduce's wire ('full' |
        'bf16' | 'int8'; None = the ``wire_dtype`` constant, read once
        here, under ``'replicated'``; 'full' under the sharded modes).
        ``optimizer``: an :class:`~torchmpi_tpu_torch.engine.SGD` or
        :class:`~torchmpi_tpu_torch.engine.Adam` (None: plain SGD with
        ``lr``). ``model_state``: a dict of un-stacked mutable model state
        (batch-norm statistics); ``loss_fn`` then has the signature
        ``loss_fn(params, state, batch) -> (loss, new_state)``.
        ``rank_map``: 'vmap' or 'loop', how the per-rank gradients are
        computed (the same values either way). ``param_sharding``:
        'replicated', 'zero1' or 'fsdp'; the sharded modes require
        ``mode='sync'`` and ``average_gradients=True``. ``accum_steps``:
        microbatches per step. ``remat``: recompute the forward in the
        backward. ``batch_format``: 'auto', 'flat' or 'stacked' (see
        :meth:`step`). ``profile_dir``: where :meth:`train` writes a
        ``torch.profiler`` trace of its steps ``profile_window = (begin,
        end)``. ``flops_per_sample``: analytic training FLOPs a sample
        (``utils/flops.py``), read only when telemetry is enabled: the
        rate becomes TFLOP/s and MFU gauges. Whether telemetry is enabled
        is read once, here, as in the JAX engine."""
        if comm is None:
            from .. import runtime_state

            comm = runtime_state.current_communicator()
        if mode not in ("sync", "async"):
            raise ValueError(f"mode must be 'sync' or 'async', got {mode!r}")
        if batch_format not in ("auto", "flat", "stacked"):
            raise ValueError(f"batch_format must be auto/flat/stacked, got {batch_format!r}")
        if param_sharding not in ("replicated", "fsdp", "zero1"):
            raise ValueError(
                f"param_sharding must be replicated/fsdp/zero1, got {param_sharding!r}")
        sharded = param_sharding != "replicated"
        if sharded and (mode != "sync" or not average_gradients):
            raise ValueError(
                f"param_sharding={param_sharding!r} requires mode='sync' and "
                "average_gradients=True (the global-batch loss already yields mean "
                "gradients)"
            )
        if not isinstance(accum_steps, int) or accum_steps < 1:
            raise ValueError(f"accum_steps must be a positive int, got {accum_steps!r}")
        if wire_dtype not in (None, "full", "bf16", "int8"):
            raise ValueError(
                f"wire_dtype must be None/'full'/'bf16'/'int8', got {wire_dtype!r}"
            )
        if rank_map not in ("vmap", "loop"):
            raise ValueError(f"rank_map must be 'vmap' or 'loop', got {rank_map!r}")
        if comm.multiprocess:
            from ..runtime.peers import rest

            if sharded and model_state is not None:
                # the sharded step normalises its loss and batch statistics
                # over every rank's rows in one forward: across processes that
                # needs a differentiable cross-process reduction in the model
                raise rest(f"global batch statistics (a model state under "
                           f"param_sharding={param_sharding!r})", 9)
        if wire_dtype is None:
            wire_dtype = constants.get("wire_dtype") if not sharded else "full"
        if wire_dtype in ("bf16", "int8") and sharded:
            raise ValueError(
                f"wire_dtype={wire_dtype!r} requires param_sharding='replicated' (the "
                "sharded modes' reduce-scatter and allgather ship the full wire)"
            )
        self.wire_dtype = wire_dtype
        # a compressed wire needs the bucketed (flat-buffer) sync even in
        # sync mode; one bucket keeps sync mode's single collective
        self.buckets = (
            mpinn.GradientBuckets(params, num_buckets if mode == "async" else 1)
            if mode == "async" or wire_dtype in ("bf16", "int8")
            else None
        )
        self.comm = comm
        self.lr = lr
        self.optimizer = optimizer if optimizer is not None else SGD(lr)
        self.mode = mode
        self.average_gradients = average_gradients
        self.hooks = hooks or {}
        self.rank_map = rank_map
        self.param_sharding = param_sharding
        self.accum_steps = accum_steps
        self.remat = remat
        self.batch_format = batch_format
        self.profile_dir = profile_dir
        self.profile_window = profile_window
        self.flops_per_sample = flops_per_sample
        # captured once, as the JAX engine's compiled step is
        self._telemetry = _telemetry.enabled()
        # step ordinal for per-step trace-context roots
        self._trace_steps = 0
        self._gnorm: Optional[torch.Tensor] = None
        self._ckpt_every, self._ckpt_path, self._ckpt_counter = 0, None, 0
        self._ckpt_thread: Optional[threading.Thread] = None
        self._ckpt_warned = False
        # staged evaluation sets: (id(x), id(y)) -> (fingerprint, xd, yd, x, y)
        self._eval_data: Dict[tuple, tuple] = {}
        has_state = model_state is not None
        self.loss_fn = remat_loss(loss_fn, has_state) if remat else loss_fn
        p = comm.size
        # rank-stacked shapes, and the leaves the sharded modes shard
        # (sgd.py:343-361: an axis of at least p that divides by p)
        self._shapes = {k: (p,) + tuple(v.shape) for k, v in params.items()}
        self._sharded = [k for k, v in params.items()
                         if sharded and any(d >= p and d % p == 0 for d in v.shape)]
        self.params = self._replicate(params)
        if param_sharding == "fsdp":
            self.params = self._shard_tree(self.params)
        elif broadcast_parameters and not sharded:
            self.broadcast_parameters_now()
        self.opt_state = self.optimizer.init(self._shard_tree(self.params))
        self.model_state = None if model_state is None else self._replicate(model_state)
        self._grad_fn = self._per_rank(
            torch.func.grad_and_value(self.loss_fn, has_aux=has_state))

    def _replicate(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        p = self.comm.local_size
        return {k: v.detach().to(self.comm.device).unsqueeze(0).repeat((p,) + (1,) * v.ndim)
                for k, v in tree.items()}

    def _whole(self, key: str, leaf: torch.Tensor) -> bool:
        """Whether a live leaf of a sharded key holds the whole value on
        each of this process's rows (not its ``[L, n / p]`` shards)."""
        return tuple(leaf.shape[1:]) == self._shapes[key][1:]

    def _shard_tree(self, tree: Tree) -> Tree:
        """``tree`` with each sharded leaf that is still whole (rank-stacked
        ``[L, ...]``, this process's rows) cut to rank r's shard on rank
        r's row, ``[L, n / p]``."""
        p, local = self.comm.size, self.comm.local_ranks
        out = dict(tree)
        for k in self._sharded:
            if self._whole(k, tree[k]):
                row = torch.arange(len(local), device=tree[k].device)
                r = torch.tensor(local, device=tree[k].device)
                out[k] = tree[k].reshape(len(local), p, -1)[row, r]
        return out

    def _gather(self, shards: Tree) -> Tree:
        """``shards`` with every sharded leaf made whole: the shards of one
        dtype packed ``[L, total / p]`` and gathered by one
        ``allgather_tensor`` (rank s's block holds every leaf's s-th
        chunk), then each leaf cut back out."""
        p, local = self.comm.size, self.comm.local_size
        out = dict(shards)
        by_dtype: Dict[torch.dtype, list] = {}
        for k in self._sharded:
            by_dtype.setdefault(shards[k].dtype, []).append(k)
        for names in by_dtype.values():
            packed = torch.cat([shards[k] for k in names], dim=1)
            full = collectives.allgather_tensor(packed, comm=self.comm).reshape(local, p, -1)
            off = 0
            for k in names:
                m = shards[k].shape[1]
                # contiguous, as the kernels take their leaves
                out[k] = full[:, :, off:off + m].reshape(
                    (local,) + self._shapes[k][1:]).contiguous()
                off += m
        return out

    def gathered_params(self) -> Tree:
        """The full rank-stacked ``[p, ...]`` parameters: under ``'fsdp'``
        the shards gathered (one ``allgather_tensor`` per dtype), else
        ``self.params``."""
        if self.param_sharding == "fsdp":
            return self._gather(self.params)
        return self.params

    def broadcast_parameters_now(self) -> None:
        """One-shot replica equalisation (``sgdengine.lua:140-144``,
        ``sgd.py:893``): rank 0's parameters on every rank, by one fused
        broadcast (the ring-broadcast kernel above the tree cutoff). The
        identity under the sharded modes, which hold one logical copy."""
        if self.param_sharding == "replicated":
            self.params = self._own(mpinn.synchronize_parameters(self.params, self.comm))

    def _per_rank(self, fn: Callable) -> Callable:
        """``fn`` over rank-stacked arguments, its outputs stacked on a
        leading rank axis: ``torch.func.vmap``, or a loop over the ranks
        (``rank_map``). On the CPU vmap takes one rank at a time
        (``chunk_size=1``): a vmap over L ranks batches the dense layers
        into one ``bmm`` and the convolutions into one grouped
        convolution, whose oneDNN kernels round by L, so a rank's gradient
        would depend on how many ranks its process holds (ROADMAP C6);
        one at a time it does not, and on the CPU it costs no more. On
        the card the ranks stay batched, and each f32 convolution's weight
        gradient and each f32 batched product is a hand-written per-rank
        kernel (``engine/rankwise.py``), one launch for every rank, whose
        sums do not depend on how many ranks it holds (cuDNN's grouped
        weight gradient and cuBLAS's batched products did)."""
        if self.rank_map == "vmap":
            if self.comm.device.type == "cpu":
                return torch.func.vmap(fn, chunk_size=1)
            return by_rank_products(torch.func.vmap(fn))

        def loop(*args):
            outs = [fn(*pytree.tree_map(lambda t, r=r: t[r], args))
                    for r in range(self.comm.local_size)]
            flat, spec = zip(*(pytree.tree_flatten(o) for o in outs))
            return pytree.tree_unflatten([torch.stack(leaves) for leaves in zip(*flat)], spec[0])

        return loop

    @staticmethod
    def _own(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        # slices of a fused buffer -> tensors of their own, as the kernels
        # take contiguous inputs
        return {k: v.contiguous() for k, v in tree.items()}

    def _prepare_batch(self, batch):
        """A rank-stacked ``[p, B, ...]`` batch on the communicator's
        device from a flat ``[p B, ...]`` or a rank-stacked one
        (``sgd.py:1495-1519``). Under 'auto' a batch is rank-stacked when
        every leaf has at least two dims and a leading axis of p; that is
        ambiguous for flat batches of exactly p samples whose every leaf
        is at least 2-D (one-hot labels ``[p, C]``), which
        ``batch_format='flat'`` or ``'stacked'`` settles. In a job of
        several processes each gets the global batch and keeps its own
        ranks' rows (rank r's slice is the r-th ``B`` samples), or a
        rank-stacked batch of its own ``[L, B, ...]`` rows as it is."""
        comm = self.comm
        p = comm.size
        if comm.multiprocess:
            return self._local_batch(batch)
        leaves, spec = pytree.tree_flatten(batch)
        leaves = [torch.as_tensor(t).to(self.comm.device) for t in leaves]
        if self.batch_format == "auto":
            stacked = all(t.ndim >= 2 and t.shape[0] == p for t in leaves)
        else:
            stacked = self.batch_format == "stacked"
        if not stacked:
            bad = [tuple(t.shape) for t in leaves if t.ndim < 1 or t.shape[0] % p]
            if bad:
                raise ValueError(f"flat batch leaves {bad} do not split over {p} ranks")
            leaves = [t.reshape((p, t.shape[0] // p) + t.shape[1:]) for t in leaves]
        return pytree.tree_unflatten(leaves, spec)

    def _local_batch(self, batch):
        """:meth:`_prepare_batch` in a job of several processes: this
        process's ``[L, B, ...]`` rows of a global batch, flat or stacked
        over every rank, or a batch of its own rows as it is."""
        comm = self.comm
        p, own = comm.size, comm.local_size
        leaves, spec = pytree.tree_flatten(batch)
        leaves = [torch.as_tensor(t) for t in leaves]

        def lead(n):
            return all(t.ndim >= 2 and t.shape[0] == n for t in leaves)

        if self.batch_format != "flat" and lead(own):
            rows = leaves
        elif self.batch_format != "flat" and lead(p):
            rows = [t[comm.local_ranks] for t in leaves]
        elif self.batch_format == "stacked":
            raise ValueError(f"stacked batch leaves {[tuple(t.shape) for t in leaves]} lead "
                             f"with neither the {p} ranks nor this process's {own}")
        else:
            bad = [tuple(t.shape) for t in leaves if t.ndim < 1 or t.shape[0] % p]
            if bad:
                raise ValueError(f"flat batch leaves {bad} do not split over {p} ranks")
            rows = [t.reshape((p, t.shape[0] // p) + t.shape[1:])[comm.local_ranks]
                    for t in leaves]
        return pytree.tree_unflatten([t.to(comm.device) for t in rows], spec)

    def _grads(self, params: Tree, state, batch) -> tuple:
        """``(grads, loss, new_state)`` of one (micro)batch: the ranks'
        gradients (under the sharded modes with a model state, the
        partial gradients of the global loss), the mean loss as a device
        scalar, and the new state, not yet averaged."""
        if state is None:
            grads, losses = self._grad_fn(params, batch)
            return grads, self._rank_mean(losses), None
        if self.param_sharding == "replicated":
            grads, (losses, new_state) = self._grad_fn(params, state, batch)
            return grads, self._rank_mean(losses), new_state
        keys = list(params)
        leaves = [params[k].detach().requires_grad_() for k in keys]
        with torch.enable_grad():
            loss, new_state = self.loss_fn(dict(zip(keys, leaves)), state, batch)
            grads = torch.autograd.grad(loss, leaves)
        return (dict(zip(keys, grads)), loss.detach(),
                {k: v.detach() for k, v in new_state.items()})

    def _rank_mean(self, values: torch.Tensor) -> torch.Tensor:
        """The mean of a per-rank ``[L]`` tensor over every rank: across
        processes the ranks' values gathered from the slabs first, so the
        mean is the one-process mean over the same ``[p]``."""
        if self.comm.multiprocess:
            from ..schedule.lower import gather_full

            values = gather_full(self.comm, "ring", values.contiguous())
        return values.mean()

    def _accumulated(self, params: Tree, batch) -> tuple:
        """:meth:`_grads` over ``accum_steps`` microbatches in turn: the
        gradients summed from zeros by K1 list calls and divided by
        ``accum_steps``, the mean of the losses, the state after the last
        microbatch (``sgd.py:430-464``)."""
        k = self.accum_steps
        if k == 1:
            return self._grads(params, self.model_state, batch)
        n = pytree.tree_leaves(batch)[0].shape[1]
        if n % k:
            raise ValueError(f"per-rank batch {n} not divisible by accum_steps={k}")
        b = n // k
        keys = list(params)
        gsum = [torch.zeros_like(params[key]) for key in keys]
        state, losses = self.model_state, []
        for i in range(k):
            micro = pytree.tree_map(lambda t, i=i: t[:, i * b:(i + 1) * b], batch)
            grads, loss, state = self._grads(params, state, micro)
            gsum = accumulate_many(gsum, [grads[key].contiguous() for key in keys])
            losses.append(loss)
        return ({key: g / k for key, g in zip(keys, gsum)}, torch.stack(losses).mean(), state)

    def _sync_sharded(self, grads: Tree, scale: float) -> Tree:
        """The sharded modes' gradient sync: the sharded leaves' partials
        through the ``FusionBuffer``'s reduce-scatter (rank r keeps its
        shard of the sum), the others allreduced; every sum times
        ``scale``."""
        local = self.comm.local_size
        fb = collectives.get_fusion_buffer(self.comm)
        handles = {k: fb.submit("reducescatter", grads[k].reshape(local, -1))
                   for k in self._sharded}
        fb.flush_for(handles.values())
        out = {k: h.wait() for k, h in handles.items()}
        rest = {k: g for k, g in grads.items() if k not in handles}
        if rest:
            out.update(mpinn.synchronize_gradients(rest, self.comm))
        return {k: (out[k] * scale).to(grads[k].dtype) for k in grads}

    def step(self, batch) -> torch.Tensor:
        """One training step on a batch ``(x, y)``, rank-stacked ``[p, B,
        ...]`` or flat ``[p B, ...]`` (``batch_format``); updates
        ``self.params`` (and ``self.opt_state`` and ``self.model_state``)
        and returns the mean loss over the ranks as a device scalar (not
        synchronised, but under telemetry, which blocks on it to time the
        step). Each call counts towards :meth:`checkpoint_every`."""
        loss = self._train_step(self._prepare_batch(batch))
        self._maybe_checkpoint()
        return loss

    @staticmethod
    def _examples(batch) -> int:
        lead = pytree.tree_leaves(batch)[0]
        return lead.shape[0] * lead.shape[1]

    @staticmethod
    def _block(loss: torch.Tensor) -> float:
        """Wait for ``loss`` (and so for its step); the host clock after."""
        loss.item()
        return time.perf_counter()

    def _grad_norm(self, grads: Tree) -> torch.Tensor:
        """The global gradient norm after the sync, as a device scalar: a
        sharded leaf's shards summed over every rank (across processes the
        other processes' shards gathered from the slabs first, so the sum
        is the one-process sum over the same ``[p, n / p]``), any other
        leaf's first row (every rank holds the same sum)."""
        def square(k, g):
            if k not in self._sharded or self._whole(k, g):
                return g[0].float().square().sum()
            if self.comm.multiprocess:
                from ..schedule.lower import gather_full

                g = gather_full(self.comm, "ring", g.contiguous())
            return g.float().square().sum()

        return torch.stack([square(k, g) for k, g in grads.items()]).sum().sqrt()

    def _record_step(self, examples: int, t0: float, t1: float, gnorm=None,
                     steps: int = 1, epoch: bool = False, input_stall_s: float = 0.0) -> None:
        """Record one step (or epoch) whose compute window is ``[t0, t1]``
        (``sgd.py:600-652``): the ``tm_engine_*`` metrics, an
        ``engine.step``/``engine.epoch`` span and flight entry.
        ``input_stall_s`` is the wait on the input iterator before the
        window; throughput and MFU come from the window alone, and
        ``tm_engine_mfu_incl_input`` counts the stall in. The p virtual
        ranks share the communicator's one device, so the chip's rate is
        the whole rate (the JAX engine, a device a rank, divides by p)."""
        (n_steps, step_s, epoch_s, eps, gn, mfu_g, tflops_g,
         mfu_incl_g, stall_c) = _engine_metrics()
        dt = max(t1 - t0, 1e-12)
        stall = max(float(input_stall_s), 0.0)
        n_steps.inc(steps, mode=self.mode, sharding=self.param_sharding)
        (epoch_s if epoch else step_s).observe(dt)
        rate = examples / dt
        eps.set(rate)
        if stall > 0:
            stall_c.inc(stall)
        if gnorm is not None:
            gn.set(float(gnorm))
        if self.flops_per_sample:
            dev = self.comm.device
            name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else None
            dtype = str(next(iter(self.params.values())).dtype).replace("torch.", "")
            achieved, frac = mfu(rate, self.flops_per_sample, name, dtype)
            tflops_g.set(achieved / 1e12)
            if frac is not None:
                mfu_g.set(frac)
                mfu_incl_g.set(frac * dt / (dt + stall))
        _telemetry.spans.record(
            "engine.epoch" if epoch else "engine.step", t0 * 1e6, dt * 1e6,
            {"examples": examples, "steps": steps},
        )
        if _flight.enabled():
            wall_t1 = time.time()
            _flight.recorder.record_complete(
                _flight.comm_key(self.comm), "engine.epoch" if epoch else "engine.step",
                wall_t1 - dt, wall_t1, payload=f"examples={examples},steps={steps}",
                routing=self.mode,
            )

    # --- checkpoint_every: the async rollback-artifact hook (sgd.py:812-891) ---
    def checkpoint_every(self, steps: int, path, start_step: int = 0) -> None:
        """Arm periodic checkpoints: every ``steps`` calls of :meth:`step`,
        save a portable sharded checkpoint
        (:func:`~torchmpi_tpu_torch.utils.checkpoint.save_engine_sharded`:
        atomic ``CURRENT`` pointer, restore onto any world) to ``path`` and
        register it as the newest rollback artifact. The state is copied
        to host memory on the step thread (the next step replaces the
        tensors); the files are written by one daemon thread. One save in
        flight at a time: a boundary reached while the previous save is
        still writing is skipped, not queued. In a job of several processes
        the save is the cooperative one, made on the step thread before
        :meth:`step` returns: its barriers are collectives of the control
        plane, which every process must issue in the same order as the
        step's own. Only :meth:`step` counts, as
        in the JAX engine: :meth:`train` and :meth:`train_resident` neither
        count nor save. ``steps=0`` disarms. A resumed run passes
        ``start_step`` (the restored checkpoint's step) so the saved step
        numbers continue the trajectory."""
        if int(steps) < 0:
            raise ValueError(f"checkpoint_every expects steps >= 0, got {steps}")
        self._ckpt_every = int(steps)
        self._ckpt_path = path
        self._ckpt_counter = int(start_step)

    def _maybe_checkpoint(self) -> None:
        if not self._ckpt_every:
            return
        self._ckpt_counter += 1
        if self._ckpt_counter % self._ckpt_every:
            return
        if self.comm.multiprocess:
            # the cooperative save meets the other processes at gloo barriers,
            # which must come in the same order as the step's lane and gloo
            # calls in every process: on the step thread, synchronously
            self._save_checkpoint(self._ckpt_counter, None)
            return
        t = self._ckpt_thread
        if t is not None and t.is_alive():
            return  # the previous save is still in flight
        state = _ckpt.host_state(self)
        self._ckpt_thread = threading.Thread(
            target=self._save_checkpoint, args=(self._ckpt_counter, state),
            name="tm-engine-ckpt", daemon=True,
        )
        self._ckpt_thread.start()

    def _save_checkpoint(self, step: int, state) -> None:
        try:
            _ckpt.save_engine_sharded(self._ckpt_path, self, step=step, state=state)
        except Exception as e:  # noqa: BLE001 - a failed async save must not
            # take the training loop down, but one that always fails leaves
            # no rollback artifact: say so once
            if not self._ckpt_warned:
                self._ckpt_warned = True
                print(f"[engine] checkpoint_every save to {self._ckpt_path} failed: {e!r} "
                      "(further failures suppressed)", file=sys.stderr)

    def flush_checkpoint(self, timeout: float = 60.0) -> None:
        """Join any save in flight (call before a deliberate exit, so the
        newest artifact is published)."""
        t = self._ckpt_thread
        if t is not None:
            t.join(timeout=timeout)

    def _step(self, batch) -> torch.Tensor:
        sharding = self.param_sharding
        params = self.gathered_params()
        grads, loss, new_state = self._accumulated(params, batch)
        if new_state is not None:
            if sharding == "replicated":
                # cross-replica batch statistics before the gradient sync, as
                # the JAX step's pmean (sgd.py:489-492): one fused allreduce, / p
                new_state = self._own(mpinn.synchronize_parameters(
                    new_state, self.comm, with_allreduce=True))
            self.model_state = new_state
        if sharding != "replicated":
            # partials of the global loss sum to its gradient; per-rank
            # gradients of the ranks' own mean losses sum to p times it
            scale = 1.0 if self.model_state is not None else 1.0 / self.comm.size
            grads = self._sync_sharded(grads, scale)
        elif self.buckets is None:
            grads = mpinn.synchronize_gradients(
                grads, self.comm, average=self.average_gradients
            )
        else:
            handles = self.buckets.allreduce_async(
                grads, self.comm, wire_dtype=self.wire_dtype
            )
            grads = self.buckets.wait_and_unflatten(
                grads, handles, average=self.average_gradients
            )
        if self._telemetry:
            self._gnorm = self._grad_norm(grads)
        updates, self.opt_state = self.optimizer.update(grads, self.opt_state)
        target = self.params
        if sharding == "zero1":
            # the applied updates are gathered once per step (sgd.py:211-214)
            updates = self._gather(updates)
        keys = list(target)
        self.params = dict(zip(keys, accumulate_many(
            [target[k] for k in keys], [updates[k] for k in keys])))
        return loss

    def _hook(self, name: str, state: Dict[str, Any]) -> None:
        fn = self.hooks.get(name)
        if fn is not None:
            fn(state)

    def train(self, iterator_fn: Callable[[], Any], max_epochs: int = 5) -> Dict[str, Any]:
        """Run the training loop (``sgd.py:1379``): ``iterator_fn()`` is
        called per epoch and yields batches (rank-stacked or flat, as
        :meth:`step` takes them). Hooks
        ``on_start``, ``on_start_epoch``, ``on_sample``, ``on_forward``,
        ``on_backward``, ``on_update``, ``on_end_epoch`` and ``on_end`` get
        the state dict; ``state['losses']`` holds each epoch's last loss,
        ``state['samples'] / state['time']`` is samples per second, and
        ``state['input_stall']`` the seconds spent waiting on the
        iterator. With ``profile_dir`` the steps ``profile_window`` are
        traced (the trace is stopped on every exit, and on loops that end
        inside the window). Steps of ``train`` do not count towards
        :meth:`checkpoint_every`, as in the JAX engine."""
        state: Dict[str, Any] = {
            "engine": self,
            "epoch": 0,
            "t": 0,
            "training": True,
            "loss": None,
            "losses": [],
            "samples": 0,
            "time": 0.0,
            "input_stall": 0.0,
        }
        self._hook("on_start", state)
        win = (ProfilerWindow(self.profile_dir, *self.profile_window, device=self.comm.device)
               if self.profile_dir else None)
        self._synchronize()
        t_start = time.perf_counter()
        try:
            for epoch in range(max_epochs):
                state["epoch"] = epoch
                loss = None
                self._hook("on_start_epoch", state)
                # an explicit next(), so the wait on the iterator is measured
                batch_iter = iter(iterator_fn())
                while True:
                    t_fetch = time.perf_counter()
                    try:
                        batch = next(batch_iter)
                    except StopIteration:
                        break
                    fetch_s = time.perf_counter() - t_fetch
                    state["input_stall"] += fetch_s
                    batch = self._prepare_batch(batch)
                    state["sample"] = batch
                    self._hook("on_sample", state)
                    if win is not None:
                        if win.active and state["t"] >= win.end:
                            # the traced tail complete before the window stops
                            self._synchronize()
                        win.step(state["t"])
                    traced = (annotate("engine.step") if win is not None and win.active
                              else contextlib.nullcontext())
                    with traced:
                        loss = self._train_step(batch, fetch_s)
                    state["loss"] = loss
                    self._hook("on_forward", state)
                    self._hook("on_backward", state)
                    self._hook("on_update", state)
                    state["t"] += 1
                    state["samples"] += self._examples(batch)
                if loss is None:
                    raise RuntimeError(
                        f"iterator_fn() yielded no batches in epoch {epoch}; it "
                        "must return a fresh iterator each call"
                    )
                state["losses"].append(float(loss))
                self._hook("on_end_epoch", state)
        finally:
            if win is not None:
                if win.active:
                    try:  # the same flush for loops ending inside the window
                        self._synchronize()
                    except Exception:  # noqa: BLE001 - close regardless
                        pass
                win.close()
        self._synchronize()
        state["time"] = time.perf_counter() - t_start
        state["training"] = False
        self._hook("on_end", state)
        return state

    def _train_step(self, batch, fetch_s: float = 0.0) -> torch.Tensor:
        """One step of :meth:`step` or :meth:`train`. With telemetry, a
        causal trace root whose ids derive from the step ordinal
        (``sgd.py:787-807``), blocked on and recorded with the wait on the
        input iterator before it (``fetch_s``)."""
        if not self._telemetry:
            return self._step(batch)
        self._trace_steps += 1
        with _tracecontext.use(_tracecontext.new_trace("engine.step", self._trace_steps)):
            t0 = time.perf_counter()
            loss = self._step(batch)
            self._record_step(self._examples(batch), t0, self._block(loss), self._gnorm,
                              input_stall_s=fetch_s)
        return loss

    def stage_dataset(self, x, y, dtype: Optional[torch.dtype] = None):
        """``(x, y)`` on the communicator's device, trimmed to a multiple of
        the world size (``sgd.py:1169``): rank r owns the contiguous shard
        ``[r * ns, (r + 1) * ns)``. ``dtype`` narrows the images (e.g.
        ``torch.bfloat16``); labels become int64."""
        p = self.comm.size
        n = (len(x) // p) * p
        xd = torch.as_tensor(x[:n]).to(self.comm.device)
        if dtype is not None:
            xd = xd.to(dtype)
        yd = torch.as_tensor(y[:n]).to(self.comm.device, torch.int64)
        return xd, yd

    def train_resident(
        self,
        x,
        y,
        per_rank_batch: int,
        max_epochs: int = 5,
        shuffle: bool = True,
        seed: int = 0,
        image_dtype: Optional[torch.dtype] = None,
        epoch_callback: Optional[Callable[[int, float, float], None]] = None,
    ) -> Dict[str, Any]:
        """Device-resident training (``sgd.py:1292``): stage ``(x, y)`` once
        (:meth:`stage_dataset`) and run ``max_epochs`` epochs of
        ``len(shard) // per_rank_batch`` steps, rank r's batch i taken from
        its own shard. ``shuffle=False`` walks each shard in order, the JAX
        engine's batches exactly; ``shuffle=True`` permutes each rank's
        shard every epoch with a ``torch.Generator`` seeded from ``(seed,
        r)`` (the JAX engine's threefry permutation cannot be matched in
        PyTorch, so the shuffled order differs from its). Returns a state
        dict like :meth:`train`, whose ``losses`` are each epoch's mean
        step loss, plus ``epoch_times``; ``epoch_callback(epoch, loss,
        seconds)`` runs after each epoch. Epoch-level hooks fire as in
        :meth:`train`, the per-step ones do not (as in the JAX engine).
        The parameters were equalised at construction. Every mode walks
        the same batches (``sgd.py:1199-1241``). With telemetry each epoch
        is recorded as one ``engine.epoch``."""
        p, dev = self.comm.size, self.comm.device
        local = self.comm.local_ranks
        xd, yd = self.stage_dataset(x, y, dtype=image_dtype)
        ns = xd.shape[0] // p
        nb = ns // per_rank_batch
        if nb == 0:
            raise ValueError(f"dataset shard of {ns} samples < per-rank batch {per_rank_batch}")
        xs, ys = xd.reshape((p, ns) + xd.shape[1:]), yd.reshape((p, ns) + yd.shape[1:])
        if self.comm.multiprocess:  # this process's ranks' shards
            xs, ys = xs[local], ys[local]
        rows = torch.arange(len(local), device=dev)[:, None]
        gens = [torch.Generator().manual_seed(
            int(np.random.SeedSequence((seed, r)).generate_state(1, np.uint64)[0]))
            for r in local]
        state: Dict[str, Any] = {
            "engine": self, "epoch": 0, "t": 0, "training": True, "loss": None,
            "losses": [], "epoch_times": [], "samples": 0, "time": 0.0,
        }
        self._hook("on_start", state)
        self._synchronize()
        t_start = time.perf_counter()
        for epoch in range(max_epochs):
            state["epoch"] = epoch
            self._hook("on_start_epoch", state)
            te = time.perf_counter()
            if shuffle:
                perm = torch.stack([torch.randperm(ns, generator=g) for g in gens]).to(dev)
            else:
                perm = torch.arange(ns, device=dev).expand(len(local), ns)
            losses = []
            for i in range(nb):
                idx = perm[:, i * per_rank_batch:(i + 1) * per_rank_batch]
                losses.append(self._step((xs[rows, idx], ys[rows, idx])))
            losses = torch.stack(losses).cpu()  # waits for the epoch's steps
            state["epoch_times"].append(time.perf_counter() - te)
            if self._telemetry:
                self._record_step(nb * per_rank_batch * p, te, te + state["epoch_times"][-1],
                                  self._gnorm, steps=nb, epoch=True)
            state["t"] += nb
            state["samples"] += nb * per_rank_batch * p
            state["loss"] = float(losses[-1])
            state["losses"].append(float(losses.mean()))
            if epoch_callback is not None:
                epoch_callback(epoch, state["losses"][-1], state["epoch_times"][-1])
            self._hook("on_end_epoch", state)
        self._synchronize()
        state["time"] = time.perf_counter() - t_start
        state["training"] = False
        self._hook("on_end", state)
        return state

    def invalidate_eval_cache(self, x=None, y=None) -> None:
        """Drop staged evaluation sets: every set (no arguments), every set
        staged for array ``x`` (``y`` omitted), or exactly the ``(x, y)``
        set (``sgd.py:1521-1536``). In-place mutations are seen anyway
        (the checksum of every :meth:`evaluate` call); this gives the
        device memory back before the next :meth:`evaluate`."""
        if x is None:
            self._eval_data.clear()
        elif y is None:
            for key in [k for k in self._eval_data if k[0] == id(x)]:
                del self._eval_data[key]
        else:
            self._eval_data.pop((id(x), id(y)), None)

    def _staged_eval(self, x, y):
        """``(x, y)`` on the device, staged once per ``(id(x), id(y))``
        and checked by a full-buffer checksum (``sgd.py:1555-1576``): at
        most 4 sets, the least recently used dropped first; a set that
        changed in place is staged again. Sets already on a device are
        not cached."""
        fp = (_array_fingerprint(x), _array_fingerprint(y))
        if None in fp:
            return self.stage_dataset(x, y)
        key = (id(x), id(y))
        cached = self._eval_data.get(key)
        if cached is not None and cached[0] == fp:
            # recency refresh: a loop over more than 4 sets reuses the newest
            self._eval_data[key] = self._eval_data.pop(key)
            return cached[1], cached[2]
        self._eval_data.pop(key, None)
        xd, yd = self.stage_dataset(x, y)
        if len(self._eval_data) >= 4:
            self._eval_data.pop(next(iter(self._eval_data)))
        # the arrays are kept, so their ids stay unique while cached
        self._eval_data[key] = (fp, xd, yd, x, y)
        return xd, yd

    def evaluate(self, apply_fn: Callable, x, y, metric: Callable) -> float:
        """``metric(apply_fn(...), y)`` over the evaluation set
        (``sgd.py:1538``): ``apply_fn(params, x)``, or ``apply_fn(params,
        state, x)`` with a ``model_state``. The set is split over the ranks
        as :meth:`stage_dataset` cuts it (the tail ``len(x) % p`` dropped),
        each rank runs its shard on its own parameters and state, and the
        ranks' values are averaged: ``metric`` must be a mean-style
        reduction, so the result is its value over the kept set. Under
        ``'fsdp'`` the parameters are gathered first. A host set is copied
        to the device once and then served from the engine's cache
        (:meth:`_staged_eval`)."""
        p = self.comm.size
        if len(x) < p:
            raise ValueError(f"evaluation set of {len(x)} samples < {p} ranks")
        xd, yd = self._staged_eval(x, y)
        xs, ys = xd.reshape((p, -1) + xd.shape[1:]), yd.reshape(p, -1)
        if self.comm.multiprocess:
            xs, ys = xs[self.comm.local_ranks], ys[self.comm.local_ranks]
        params = self.gathered_params()
        if self.model_state is None:
            fn, args = (lambda prm, xb, yb: metric(apply_fn(prm, xb), yb)), (params,)
        else:
            fn = lambda prm, st, xb, yb: metric(apply_fn(prm, st, xb), yb)  # noqa: E731
            args = (params, self.model_state)
        with torch.no_grad():
            values = self._per_rank(fn)(*args, xs, ys)
        return float(self._rank_mean(values.float()))

    def collective_specs(self) -> List:
        """The gradient sync's collectives as declared specs for
        :func:`~torchmpi_tpu_torch.collectives.eager.precompile` (or
        ``start(precompile_collectives=...)``), as ``sgd.py:654`` declares
        them: a bucketed engine's one ``(op, (p, total), dtype, None,
        wire)`` per bucket (the packed buffer ``GradientBuckets``
        dispatches); an unbucketed one's fused groups as ``{"layout":
        per-leaf widths}`` dicts (what ``nn.synchronize_gradients``
        flushes through ``run_fused``), cut where the ``FusionBuffer``
        cuts them: at ``fusion_buffer_bytes`` of one dtype, with a leaf
        of one dim, and a group of fewer than ``fusion_min_tensors``
        leaves, dispatched on their own, as ``(op, shape, dtype)``
        specs. Empty under the sharded modes, as in JAX: their
        reduce-scatter and allgather flushes are not warmed."""
        if self.param_sharding != "replicated":
            return []
        p = self.comm.size
        if self.buckets is not None:
            return [("allreduce", (p, sum(self.buckets.sizes[i] for i in self.buckets.buckets[b])),
                     self.buckets.bucket_dtype(b), None, self.wire_dtype)
                    for b in range(self.buckets.num_buckets)]
        cap = constants.get("fusion_buffer_bytes")
        specs, groups = [], {}

        def close(dtype):
            shapes = groups.pop(dtype, [])
            if len(shapes) < max(1, constants.get("fusion_min_tensors")):
                specs.extend(("allreduce", shape, dtype) for shape in shapes)
            else:
                specs.append({"op": "allreduce", "dtype": dtype,
                              "layout": tuple(math.prod(s[1:]) for s in shapes)})

        for key, shape in self._shapes.items():
            dtype = self.params[key].dtype
            if cap <= 0 or len(shape) < 2:
                specs.append(("allreduce", shape, dtype))
                continue
            group = groups.setdefault(dtype, [])
            group.append(shape)
            if sum(math.prod(s[1:]) for s in group) * dtype.itemsize >= cap:
                close(dtype)
        for dtype in list(groups):
            close(dtype)
        return specs

    def precompile(self) -> int:
        """Warm and pin the plans of :meth:`collective_specs`
        (``sgd.py:709``), so the first step plans no collective; returns
        the number of specs warmed. The JAX engine's ``precompile(batch)``
        also compiles its jitted step for the batch's shapes; the port's
        step runs op by op and has nothing to compile."""
        from ..collectives.eager import precompile

        specs = self.collective_specs()
        return precompile(specs, comm=self.comm) if specs else 0

    def _synchronize(self) -> None:
        if self.comm.device.type == "cuda":
            torch.cuda.synchronize(self.comm.device)
