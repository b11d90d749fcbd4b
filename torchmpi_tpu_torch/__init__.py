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
kernel; ``mpi.async_`` returns handles to wait on (``mpi.wait(h)``). The whole
collective surface (broadcast, reduce, allreduce, allgather, sendreceive,
reducescatter, alltoall) runs on the ``xla``, ``ring`` and ``kernel``
backends; ``python -m torchmpi_tpu_torch.examples.bench_collectives``
sweeps it. ``mpi.parameterserver`` shards tensors over the ranks on the
same device and runs the Downpour, EASGD and DSGD schedules
(``python -m torchmpi_tpu_torch.examples.mnist_parameterserver``).

The package imports ``torch`` and never ``jax`` or ``torchmpi_tpu``.
"""

from . import collectives, constants, nn, ops, parameterserver
from .collectives import (
    allgather_tensor,
    allreduce_tensor,
    alltoall_tensor,
    async_,
    broadcast_tensor,
    kernel,
    reduce_tensor,
    reducescatter_tensor,
    ring,
    sendreceive_tensor,
    xla,
)
from .runtime.communicator import Communicator, CommunicatorError, split_by_keys
from .runtime.handles import SyncHandle, sync_all, wait
from .runtime_state import (
    NotStartedError,
    communicator_names,
    current_communicator,
    describe,
    push_communicator,
    rank,
    set_communicator,
    size,
    stack,
    start,
    started,
    stop,
)

# subpackages as attributes, as the reference's ``mpi.engine`` etc.; last,
# since each imports from the modules above
from . import engine, parallel, utils  # noqa: E402

__all__ = [
    "Communicator",
    "CommunicatorError",
    "NotStartedError",
    "SyncHandle",
    "allgather_tensor",
    "allreduce_tensor",
    "alltoall_tensor",
    "async_",
    "broadcast_tensor",
    "collectives",
    "communicator_names",
    "constants",
    "current_communicator",
    "describe",
    "engine",
    "kernel",
    "nn",
    "ops",
    "parallel",
    "parameterserver",
    "push_communicator",
    "rank",
    "reduce_tensor",
    "reducescatter_tensor",
    "ring",
    "sendreceive_tensor",
    "set_communicator",
    "size",
    "split_by_keys",
    "stack",
    "start",
    "started",
    "stop",
    "sync_all",
    "utils",
    "wait",
    "xla",
]
