"""Models of the port: the MNIST family and the long-context LM."""

from .convert import from_jax_params, lm_from_jax_params
from .mnist import (
    LeNet,
    LogisticRegression,
    accuracy,
    cross_entropy_loss,
    init_params,
    make_loss_fn,
)
from .transformer import (
    LongContextTransformer,
    RingAttentionBlock,
    init_lm_params,
    make_lm_loss_fn,
)

__all__ = [
    "LeNet",
    "LogisticRegression",
    "LongContextTransformer",
    "RingAttentionBlock",
    "accuracy",
    "cross_entropy_loss",
    "from_jax_params",
    "init_lm_params",
    "init_params",
    "lm_from_jax_params",
    "make_lm_loss_fn",
    "make_loss_fn",
]
