"""torchmpi_tpu_torch: the PyTorch/CUDA port of ``torchmpi_tpu``.

p virtual ranks live on one CUDA card as rank-stacked ``[p, ...]``
tensors — the counterpart of the JAX package's single-controller mode, in
which p devices of one process hold rank-stacked arrays. The kernels the
JAX package wrote in Pallas are written by hand in CUDA for Hopper
(``ops/``, ``csrc/``) and carry the collectives on a CUDA communicator.

This port carries the MNIST AllReduce-SGD paths, synchronous and
asynchronous, with an optional compressed wire::

    import torchmpi_tpu_torch as mpi
    mpi.start(ranks=8)                      # cuda:0; device='cpu' for tests
    engine = AllReduceSGDEngine(loss_fn, params)   # ring-broadcast kernel
    engine.train(lambda: iter(it))          # ring-allreduce kernel per step
    mpi.nn.check_with_allreduce(engine.params)
    mpi.stop()

``AllReduceSGDEngine(..., mode='async', wire_dtype='int8')`` syncs the
gradients in buckets, async on a side stream, through the quantized ring
kernel; ``mpi.collectives.async_`` returns handles to wait on. The whole
collective surface (broadcast, reduce, allreduce, allgather, sendreceive,
reducescatter, alltoall) runs on the ``xla``, ``ring`` and ``kernel``
backends; ``python -m torchmpi_tpu_torch.examples.bench_collectives``
sweeps it.

The package imports ``torch`` and never ``jax`` or ``torchmpi_tpu``.
"""

from . import collectives, constants, nn, ops
from .collectives import (
    allgather_tensor,
    allreduce_tensor,
    alltoall_tensor,
    broadcast_tensor,
    reduce_tensor,
    reducescatter_tensor,
    sendreceive_tensor,
)
from .runtime.communicator import Communicator, CommunicatorError
from .runtime_state import (
    NotStartedError,
    communicator_names,
    current_communicator,
    describe,
    push_communicator,
    rank,
    set_communicator,
    size,
    start,
    started,
    stop,
)

__all__ = [
    "Communicator",
    "CommunicatorError",
    "NotStartedError",
    "allgather_tensor",
    "allreduce_tensor",
    "alltoall_tensor",
    "broadcast_tensor",
    "collectives",
    "communicator_names",
    "constants",
    "current_communicator",
    "describe",
    "nn",
    "ops",
    "push_communicator",
    "rank",
    "reduce_tensor",
    "reducescatter_tensor",
    "sendreceive_tensor",
    "set_communicator",
    "size",
    "start",
    "started",
    "stop",
]
