"""Training engines of the port and their optimizer."""

from .optim import SGD
from .sgd import AllReduceSGDEngine

__all__ = ["AllReduceSGDEngine", "SGD"]
