"""Training engines of the port."""

from .sgd import AllReduceSGDEngine

__all__ = ["AllReduceSGDEngine"]
