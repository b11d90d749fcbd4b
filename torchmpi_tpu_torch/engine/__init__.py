"""Training engines of the port and their optimizer."""

from .optim import SGD, Adam
from .sgd import AllReduceSGDEngine

__all__ = ["Adam", "AllReduceSGDEngine", "SGD"]
