"""Synchronous data-parallel SGD over virtual ranks.

The port of ``torchmpi_tpu/engine/sgd.py:AllReduceSGDEngine`` in
``mode='sync'`` with replicated parameters (``sgdengine.lua``). The JAX
engine compiles one SPMD step whose gradient sync is an in-graph ``psum``;
PyTorch has no such step, so this one does what ``sgdengine.lua`` did
through ``mpinn.synchronizeGradients`` — an eager allreduce after the
backward pass, which the selector sends through the ring-allreduce kernel:

1. per-rank losses and gradients over the rank-stacked batch, each rank
   with its own copy of the parameters (``torch.func.vmap`` of
   ``grad_and_value``);
2. ``nn.synchronize_gradients``: one fused allreduce of all gradients;
3. divide by p (``average_gradients=True``);
4. a plain SGD step, ``params + (-lr * grads)``, where the add is the
   accumulate kernel (the port's ``optax.apply_updates``).

At construction the parameters are replicated to every rank and, with
``broadcast_parameters=True``, equalised from rank 0 by
``nn.synchronize_parameters`` (the ring-broadcast kernel). Async mode,
wire formats, fsdp/zero1, accumulation and checkpoints wait for later
slices (ROADMAP queue A5).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

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
        average_gradients: bool = True,
        broadcast_parameters: bool = True,
        hooks: Optional[Dict[str, Callable]] = None,
    ):
        if comm is None:
            from .. import runtime_state

            comm = runtime_state.current_communicator()
        if mode != "sync":
            raise NotImplementedError(
                f"mode={mode!r} is not ported yet (ROADMAP queue A5); the "
                "port runs mode='sync'"
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
        grads = mpinn.synchronize_gradients(
            grads, self.comm, average=self.average_gradients
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
