"""Models of the port's main path."""

from .convert import from_jax_params
from .mnist import (
    LeNet,
    LogisticRegression,
    accuracy,
    cross_entropy_loss,
    init_params,
    make_loss_fn,
)

__all__ = [
    "LeNet",
    "LogisticRegression",
    "accuracy",
    "cross_entropy_loss",
    "from_jax_params",
    "init_params",
    "make_loss_fn",
]
