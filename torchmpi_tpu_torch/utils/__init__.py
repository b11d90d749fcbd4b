"""Data utilities of the port."""

from .data import DistributedIterator, synthetic_mnist

__all__ = ["DistributedIterator", "synthetic_mnist"]
