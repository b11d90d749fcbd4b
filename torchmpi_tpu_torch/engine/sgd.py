"""Data-parallel SGD over virtual ranks, synchronous or asynchronous.

The port of ``torchmpi_tpu/engine/sgd.py:AllReduceSGDEngine`` with
replicated parameters (``sgdengine.lua``). The JAX engine compiles one
SPMD step whose gradient sync is in-graph; PyTorch has no such step, so
this one does what ``sgdengine.lua`` did through
``mpinn.synchronizeGradients`` — eager allreduces after the backward pass,
which the selector sends through the ring kernels:

1. per-rank losses and gradients over the rank-stacked batch, each rank
   with its own copy of the parameters (``torch.func.vmap`` of
   ``grad_and_value``);
2. the gradient sync:
   - ``mode='sync'`` with the 'full' wire: ``nn.synchronize_gradients``,
     one fused allreduce of all gradients (the ring-allreduce kernel);
   - ``mode='async'`` (``sgdengine.lua:91-124``): ``GradientBuckets``
     (``num_buckets``) launches one async allreduce per bucket on a side
     stream, then waits them in reverse order (``nn.lua:207-212``);
   - a compressed wire (``wire_dtype='int8'`` or ``'bf16'``) takes the
     bucketed path in sync mode too, with one bucket (``sgd.py:328-337``);
     each bucket above the cutoffs goes through the quantized ring kernel;
3. divide by p (``average_gradients=True``);
4. a plain SGD step, ``params + (-lr * grads)``, where the add is the
   accumulate kernel (the port's ``optax.apply_updates``).

At construction the parameters are replicated to every rank and, with
``broadcast_parameters=True``, equalised from rank 0 by
``nn.synchronize_parameters`` (the ring-broadcast kernel). Under a
compressed wire each chunk's owner keeps its f32 sum and the other ranks
its wire decoding, so replicas drift apart by the wire's rounding, as in
the JAX engine. fsdp/zero1, accumulation, remat and checkpoints wait for
later slices (ROADMAP queue A5).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from .. import constants
from .. import nn as mpinn
from ..ops import accumulate
from ..runtime.communicator import Communicator


class AllReduceSGDEngine:
    """Data-parallel SGD engine over a communicator.

    ``loss_fn(params, batch) -> scalar`` is one rank's loss (see
    ``models.make_loss_fn``); ``params`` is a dict of un-stacked initial
    parameters. ``self.params`` holds the rank-stacked ``[p, ...]``
    parameters on the communicator's device."""

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
    ):
        """``mode``: 'sync' (one fused allreduce) or 'async' (bucketed);
        ``num_buckets``: the buckets of async mode (``BlockSequential``'s
        N). ``wire_dtype``: the gradient allreduce's wire ('full' |
        'bf16' | 'int8'; None = the ``wire_dtype`` constant, read once
        here)."""
        if comm is None:
            from .. import runtime_state

            comm = runtime_state.current_communicator()
        if mode not in ("sync", "async"):
            raise ValueError(f"mode must be 'sync' or 'async', got {mode!r}")
        if wire_dtype not in (None, "full", "bf16", "int8"):
            raise ValueError(
                f"wire_dtype must be None/'full'/'bf16'/'int8', got {wire_dtype!r}"
            )
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
        self.mode = mode
        self.average_gradients = average_gradients
        self.hooks = hooks or {}
        p = comm.size
        self.params = {
            k: v.detach().to(comm.device).unsqueeze(0).repeat((p,) + (1,) * v.ndim)
            for k, v in params.items()
        }
        if broadcast_parameters:
            self.params = self._own(mpinn.synchronize_parameters(self.params, comm))
        self._grad_fn = torch.func.vmap(torch.func.grad_and_value(loss_fn))

    @staticmethod
    def _own(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        # slices of a fused buffer -> tensors of their own, as the kernels
        # take contiguous inputs
        return {k: v.contiguous() for k, v in tree.items()}

    def step(self, batch) -> torch.Tensor:
        """One training step on a rank-stacked batch ``(x[p, B, ...],
        y[p, B])``; updates ``self.params`` and returns the mean of the
        ranks' losses as a device scalar (not synchronised)."""
        grads, losses = self._grad_fn(self.params, batch)
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
        self.params = {
            k: accumulate(v, (grads[k] * -self.lr).contiguous())
            for k, v in self.params.items()
        }
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
        sync = self.comm.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(self.comm.device)
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
        if sync:
            torch.cuda.synchronize(self.comm.device)
        state["time"] = time.perf_counter() - t_start
        state["training"] = False
        self._hook("on_end", state)
        return state
