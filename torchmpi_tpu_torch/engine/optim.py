"""The engine's optimizers: port-side counterparts of ``optax.sgd`` and
``optax.adam``.

``SGD(learning_rate, momentum)`` has the semantics of ``optax.sgd`` (no
Nesterov): ``trace`` then ``scale(-learning_rate)``. With a momentum the
state holds one trace per parameter, ``m = g + momentum * m`` (zeros at
the start), and the update is ``-learning_rate * m``; without one there is
no state and the update is ``-learning_rate * g``, plain SGD. The trace
step is K2's function, ``out + alpha * in`` rounded once, over every leaf
in one call (:func:`~torchmpi_tpu_torch.ops.scale_accumulate_many`); the
engine adds the update to the parameters with K1 the same way
(:func:`~torchmpi_tpu_torch.ops.accumulate_many`,
``optax.apply_updates``). Trees are dicts of rank-stacked tensors, or of
their shards under the engine's sharded modes.

``Adam(learning_rate, b1, b2, eps)`` has the semantics of ``optax.adam``
(``eps`` outside the square root, no ``eps_root``): the moments
``mu = (1 - b1) g + b1 mu`` and ``nu = (1 - b2) g^2 + b2 nu`` (zeros at the
start), bias-corrected by ``1 - b^t`` at step t, and the update
``-learning_rate * mu_hat / (sqrt(nu_hat) + eps)``. optax runs this
outside any Pallas kernel, and so does the port: plain torch.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from ..ops import scale_accumulate_many

Tree = Dict[str, torch.Tensor]


class SGD:
    """``optax.sgd(learning_rate, momentum)`` over dicts of tensors."""

    def __init__(self, learning_rate: float, momentum: Optional[float] = None):
        self.learning_rate = learning_rate
        self.momentum = momentum

    def init(self, params: Tree) -> Optional[Tree]:
        """The state: a zero trace per parameter, or None without a
        momentum."""
        if self.momentum is None:
            return None
        return {k: torch.zeros_like(v) for k, v in params.items()}

    def update(self, grads: Tree, state: Optional[Tree]) -> Tuple[Tree, Optional[Tree]]:
        """``(updates, new_state)`` for the gradients ``grads``."""
        if self.momentum is None:
            return {k: (g * -self.learning_rate).contiguous() for k, g in grads.items()}, None
        keys = list(grads)
        trace = dict(zip(keys, scale_accumulate_many(
            [grads[k].contiguous() for k in keys], [state[k] for k in keys], self.momentum)))
        return {k: m * -self.learning_rate for k, m in trace.items()}, trace


class Adam:
    """``optax.adam(learning_rate, b1, b2, eps)`` over dicts of tensors."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Tree) -> Dict[str, Union[int, Tree]]:
        """The state: the step count and zero first and second moments."""
        return {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(self, grads: Tree, state) -> Tuple[Tree, dict]:
        """``(updates, new_state)`` for the gradients ``grads``."""
        b1, b2 = self.b1, self.b2
        count = state["count"] + 1
        mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in grads.items()}
        nu = {k: (1 - b2) * (g * g) + b2 * state["nu"][k] for k, g in grads.items()}
        c1, c2 = 1 - b1**count, 1 - b2**count
        updates = {k: (-self.learning_rate * ((mu[k] / c1) / ((nu[k] / c2).sqrt() + self.eps)))
                   .contiguous() for k in grads}
        return updates, {"count": count, "mu": mu, "nu": nu}
