"""The engine's optimizer: a port-side counterpart of ``optax.sgd``.

``SGD(learning_rate, momentum)`` has the semantics of ``optax.sgd`` (no
Nesterov): ``trace`` then ``scale(-learning_rate)``. With a momentum the
state holds one trace per parameter, ``m = g + momentum * m`` (zeros at
the start), and the update is ``-learning_rate * m``; without one there is
no state and the update is ``-learning_rate * g``, plain SGD. The trace
step is K2's function, ``out + alpha * in`` rounded once, over every leaf
in one call (:func:`~torchmpi_tpu_torch.ops.scale_accumulate_many`); the
engine adds the update to the parameters with K1 the same way
(:func:`~torchmpi_tpu_torch.ops.accumulate_many`,
``optax.apply_updates``). Trees are dicts of rank-stacked tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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
