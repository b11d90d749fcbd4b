"""Models of the port: the MNIST family, the 6-layer MLP, the ResNet family
and the long-context LM."""

from .convert import (
    axis_stack_from_jax,
    from_jax_params,
    lm_from_jax_params,
    mplinear_from_jax,
    resnet_from_jax_params,
)
from .mlp import MLP6
from .mnist import (
    LeNet,
    LogisticRegression,
    accuracy,
    cross_entropy_loss,
    init_params,
    make_loss_fn,
)
from .resnet import (
    BasicBlock,
    BottleneckBlock,
    ResNet,
    ResNet18,
    ResNet50,
    init_resnet,
    make_eval_fn,
    make_stateful_loss_fn,
)
from .transformer import (
    LongContextTransformer,
    RingAttentionBlock,
    init_lm_params,
    make_lm_loss_fn,
)

__all__ = [
    "BasicBlock",
    "BottleneckBlock",
    "LeNet",
    "LogisticRegression",
    "LongContextTransformer",
    "MLP6",
    "ResNet",
    "ResNet18",
    "ResNet50",
    "RingAttentionBlock",
    "accuracy",
    "axis_stack_from_jax",
    "cross_entropy_loss",
    "from_jax_params",
    "init_lm_params",
    "init_params",
    "init_resnet",
    "lm_from_jax_params",
    "make_eval_fn",
    "make_lm_loss_fn",
    "make_loss_fn",
    "make_stateful_loss_fn",
    "mplinear_from_jax",
    "resnet_from_jax_params",
]
