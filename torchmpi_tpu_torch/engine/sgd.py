"""Data-parallel SGD over virtual ranks, synchronous or asynchronous.

The port of ``torchmpi_tpu/engine/sgd.py:AllReduceSGDEngine`` with
replicated parameters (``sgdengine.lua``). The JAX engine compiles one
SPMD step whose gradient sync is in-graph; PyTorch has no such step, so
this one does what ``sgdengine.lua`` did through
``mpinn.synchronizeGradients`` — eager allreduces after the backward pass,
which the selector sends through the ring kernels:

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
   scale-accumulate kernel over every leaf at once), added to the
   parameters by the accumulate kernel over every leaf at once (the port's
   ``optax.apply_updates``).

At construction the parameters are replicated to every rank and, with
``broadcast_parameters=True``, equalised from rank 0 by
``nn.synchronize_parameters`` (the ring-broadcast kernel). Under a
compressed wire each chunk's owner keeps its f32 sum and the other ranks
its wire decoding, so replicas drift apart by the wire's rounding, as in
the JAX engine. The model state is replicated as it is given, not
broadcast, as in the JAX engine.

:meth:`AllReduceSGDEngine.train_resident` stages a dataset on the device
once and runs epochs of steps over it, and
:meth:`AllReduceSGDEngine.evaluate` runs a metric over an evaluation set
split over the ranks. fsdp/zero1, accumulation, remat and checkpoints wait
for later slices (ROADMAP queue A5).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import constants
from .. import nn as mpinn
from ..ops import accumulate_many
from ..runtime.communicator import Communicator
from .optim import SGD


class AllReduceSGDEngine:
    """Data-parallel SGD engine over a communicator.

    ``loss_fn(params, batch) -> scalar`` is one rank's loss (see
    ``models.make_loss_fn``); ``params`` is a dict of un-stacked initial
    parameters. ``self.params`` holds the rank-stacked ``[p, ...]``
    parameters on the communicator's device, ``self.opt_state`` the
    optimizer's state and ``self.model_state`` the rank-stacked model
    state (or None)."""

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
        optimizer: Optional[SGD] = None,
        model_state: Optional[Dict[str, torch.Tensor]] = None,
        rank_map: str = "vmap",
    ):
        """``mode``: 'sync' (one fused allreduce) or 'async' (bucketed);
        ``num_buckets``: the buckets of async mode (``BlockSequential``'s
        N). ``wire_dtype``: the gradient allreduce's wire ('full' |
        'bf16' | 'int8'; None = the ``wire_dtype`` constant, read once
        here). ``optimizer``: an :class:`~torchmpi_tpu_torch.engine.SGD`
        (None: plain SGD with ``lr``). ``model_state``: a dict of un-stacked
        mutable model state (batch-norm statistics); ``loss_fn`` then has
        the signature ``loss_fn(params, state, batch) -> (loss,
        new_state)`` and the new states are averaged over the ranks every
        step. ``rank_map``: 'vmap' or 'loop', how the per-rank gradients
        are computed (the same values either way)."""
        if comm is None:
            from .. import runtime_state

            comm = runtime_state.current_communicator()
        if mode not in ("sync", "async"):
            raise ValueError(f"mode must be 'sync' or 'async', got {mode!r}")
        if wire_dtype not in (None, "full", "bf16", "int8"):
            raise ValueError(
                f"wire_dtype must be None/'full'/'bf16'/'int8', got {wire_dtype!r}"
            )
        if rank_map not in ("vmap", "loop"):
            raise ValueError(f"rank_map must be 'vmap' or 'loop', got {rank_map!r}")
        if wire_dtype is None:
            wire_dtype = constants.get("wire_dtype")
        self.wire_dtype = wire_dtype
        # a compressed wire needs the bucketed (flat-buffer) sync even in
        # sync mode; one bucket keeps sync mode's single collective
        self.buckets = (
            mpinn.GradientBuckets(params, num_buckets if mode == "async" else 1)
            if mode == "async" or wire_dtype in ("bf16", "int8")
            else None
        )
        self.comm = comm
        self.loss_fn = loss_fn
        self.lr = lr
        self.optimizer = optimizer if optimizer is not None else SGD(lr)
        self.mode = mode
        self.average_gradients = average_gradients
        self.hooks = hooks or {}
        self.rank_map = rank_map
        self.params = self._replicate(params)
        if broadcast_parameters:
            self.params = self._own(mpinn.synchronize_parameters(self.params, comm))
        self.opt_state = self.optimizer.init(self.params)
        self.model_state = None if model_state is None else self._replicate(model_state)
        self._grad_fn = self._per_rank(
            torch.func.grad_and_value(loss_fn, has_aux=model_state is not None))

    def _replicate(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        p = self.comm.size
        return {k: v.detach().to(self.comm.device).unsqueeze(0).repeat((p,) + (1,) * v.ndim)
                for k, v in tree.items()}

    def _per_rank(self, fn: Callable) -> Callable:
        """``fn`` over rank-stacked arguments, its outputs stacked on a
        leading rank axis: ``torch.func.vmap``, or a loop over the ranks
        (``rank_map``)."""
        if self.rank_map == "vmap":
            return torch.func.vmap(fn)

        def loop(*args):
            outs = [fn(*pytree.tree_map(lambda t, r=r: t[r], args)) for r in range(self.comm.size)]
            flat, spec = zip(*(pytree.tree_flatten(o) for o in outs))
            return pytree.tree_unflatten([torch.stack(leaves) for leaves in zip(*flat)], spec[0])

        return loop

    @staticmethod
    def _own(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        # slices of a fused buffer -> tensors of their own, as the kernels
        # take contiguous inputs
        return {k: v.contiguous() for k, v in tree.items()}

    def step(self, batch) -> torch.Tensor:
        """One training step on a rank-stacked batch ``(x[p, B, ...],
        y[p, B])``; updates ``self.params`` (and ``self.opt_state`` and
        ``self.model_state``) and returns the mean of the ranks' losses as
        a device scalar (not synchronised)."""
        if self.model_state is None:
            grads, losses = self._grad_fn(self.params, batch)
        else:
            grads, (losses, new_state) = self._grad_fn(self.params, self.model_state, batch)
            # cross-replica batch statistics before the gradient sync, as the
            # JAX step's pmean (sgd.py:489-492): one fused allreduce, / p
            self.model_state = self._own(
                mpinn.synchronize_parameters(new_state, self.comm, with_allreduce=True))
        if self.buckets is None:
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
        updates, self.opt_state = self.optimizer.update(grads, self.opt_state)
        keys = list(self.params)
        self.params = dict(zip(keys, accumulate_many(
            [self.params[k] for k in keys], [updates[k] for k in keys])))
        return losses.mean()

    def _hook(self, name: str, state: Dict[str, Any]) -> None:
        fn = self.hooks.get(name)
        if fn is not None:
            fn(state)

    def train(self, iterator_fn: Callable[[], Any], max_epochs: int = 5) -> Dict[str, Any]:
        """Run the training loop (``sgd.py:1379``): ``iterator_fn()`` is
        called per epoch and yields rank-stacked device batches. Hooks
        ``on_start``, ``on_start_epoch``, ``on_sample``, ``on_forward``,
        ``on_backward``, ``on_update``, ``on_end_epoch`` and ``on_end`` get
        the state dict; ``state['losses']`` holds each epoch's last loss,
        ``state['samples'] / state['time']`` is samples per second."""
        state: Dict[str, Any] = {
            "engine": self,
            "epoch": 0,
            "t": 0,
            "training": True,
            "loss": None,
            "losses": [],
            "samples": 0,
            "time": 0.0,
        }
        self._hook("on_start", state)
        self._synchronize()
        t_start = time.perf_counter()
        for epoch in range(max_epochs):
            state["epoch"] = epoch
            loss = None
            self._hook("on_start_epoch", state)
            for batch in iterator_fn():
                state["sample"] = batch
                self._hook("on_sample", state)
                loss = self.step(batch)
                state["loss"] = loss
                self._hook("on_forward", state)
                self._hook("on_backward", state)
                self._hook("on_update", state)
                state["t"] += 1
                state["samples"] += batch[0].shape[0] * batch[0].shape[1]
            if loss is None:
                raise RuntimeError(
                    f"iterator_fn() yielded no batches in epoch {epoch}; it "
                    "must return a fresh iterator each call"
                )
            state["losses"].append(float(loss))
            self._hook("on_end_epoch", state)
        self._synchronize()
        state["time"] = time.perf_counter() - t_start
        state["training"] = False
        self._hook("on_end", state)
        return state

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
        The parameters were equalised at construction."""
        p, dev = self.comm.size, self.comm.device
        xd, yd = self.stage_dataset(x, y, dtype=image_dtype)
        ns = xd.shape[0] // p
        nb = ns // per_rank_batch
        if nb == 0:
            raise ValueError(f"dataset shard of {ns} samples < per-rank batch {per_rank_batch}")
        xs, ys = xd.reshape((p, ns) + xd.shape[1:]), yd.reshape(p, ns)
        rows = torch.arange(p, device=dev)[:, None]
        gens = [torch.Generator().manual_seed(
            int(np.random.SeedSequence((seed, r)).generate_state(1, np.uint64)[0]))
            for r in range(p)]
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
                perm = torch.arange(ns, device=dev).expand(p, ns)
            losses = []
            for i in range(nb):
                idx = perm[:, i * per_rank_batch:(i + 1) * per_rank_batch]
                losses.append(self.step((xs[rows, idx], ys[rows, idx])))
            losses = torch.stack(losses).cpu()  # waits for the epoch's steps
            state["epoch_times"].append(time.perf_counter() - te)
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

    def evaluate(self, apply_fn: Callable, x, y, metric: Callable) -> float:
        """``metric(apply_fn(...), y)`` over the evaluation set
        (``sgd.py:1538``): ``apply_fn(params, x)``, or ``apply_fn(params,
        state, x)`` with a ``model_state``. The set is split over the ranks
        as :meth:`stage_dataset` cuts it (the tail ``len(x) % p`` dropped),
        each rank runs its shard on its own parameters and state, and the
        ranks' values are averaged: ``metric`` must be a mean-style
        reduction, so the result is its value over the kept set."""
        p = self.comm.size
        if len(x) < p:
            raise ValueError(f"evaluation set of {len(x)} samples < {p} ranks")
        xd, yd = self.stage_dataset(x, y)
        xs, ys = xd.reshape((p, -1) + xd.shape[1:]), yd.reshape(p, -1)
        if self.model_state is None:
            fn, args = (lambda prm, xb, yb: metric(apply_fn(prm, xb), yb)), (self.params,)
        else:
            fn = lambda prm, st, xb, yb: metric(apply_fn(prm, st, xb), yb)  # noqa: E731
            args = (self.params, self.model_state)
        with torch.no_grad():
            values = self._per_rank(fn)(*args, xs, ys)
        return float(values.float().mean())

    def _synchronize(self) -> None:
        if self.comm.device.type == "cuda":
            torch.cuda.synchronize(self.comm.device)
