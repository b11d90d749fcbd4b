"""Data utilities, the collectives tester and the autotuner of the port."""

from . import autotune  # noqa: F401
from .data import DistributedIterator, synthetic_imagenet, synthetic_mnist, synthetic_tokens
from .tester import (
    BenchResult,
    bus_bytes,
    run_matrix,
    run_one_config,
    run_ps_throughput,
    sweep_sizes,
)

__all__ = [
    "BenchResult",
    "autotune",
    "DistributedIterator",
    "bus_bytes",
    "run_matrix",
    "run_one_config",
    "run_ps_throughput",
    "sweep_sizes",
    "synthetic_imagenet",
    "synthetic_mnist",
    "synthetic_tokens",
]
