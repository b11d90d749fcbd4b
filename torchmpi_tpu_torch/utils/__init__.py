"""Data utilities and the collectives tester of the port."""

from .data import DistributedIterator, synthetic_mnist
from .tester import BenchResult, bus_bytes, run_matrix, run_one_config, sweep_sizes

__all__ = [
    "BenchResult",
    "DistributedIterator",
    "bus_bytes",
    "run_matrix",
    "run_one_config",
    "sweep_sizes",
    "synthetic_mnist",
]
