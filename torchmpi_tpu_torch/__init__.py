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
sweeps it. Every eager collective is compiled by ``mpi.schedule`` to a
cached plan (``python -m torchmpi_tpu_torch.schedule --explain`` shows the
choice), and ``mpi.telemetry`` records its spans, metrics and
flight-recorder entries, each stamped with the plan's ``plan_id``.
``mpi.parameterserver`` shards tensors over the ranks on the same device
and runs the Downpour, EASGD and DSGD schedules
(``python -m torchmpi_tpu_torch.examples.mnist_parameterserver``).
``mpi.data.InputPipeline`` streams rank-stacked batches through pinned
memory and a copy stream, ``torchmpi_tpu_torch.serve`` answers inference
requests from the parameter server's weights while it trains, and
``python -m torchmpi_tpu_torch.analysis`` is the package's tpu-lint.

The package imports ``torch`` and never ``jax`` or ``torchmpi_tpu``.
"""

from . import collectives, constants, nn, ops, parameterserver, schedule, telemetry
from .collectives import (
    allgather_tensor,
    allgatherv_tensor,
    allreduce_scalar,
    allreduce_tensor,
    alltoall_tensor,
    async_,
    barrier,
    broadcast_scalar,
    broadcast_tensor,
    collective_availability,
    free_collective_resources,
    kernel,
    reduce_scalar,
    reduce_tensor,
    reducescatter_tensor,
    ring,
    selector as collective_selector,
    sendreceive_scalar,
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
    local_ranks,
    num_nodes_in_communicator,
    num_processes,
    push_communicator,
    rank,
    set_collective_span,
    set_communicator,
    size,
    stack,
    start,
    started,
    stop,
)

# subpackages as attributes, as the reference's ``mpi.engine`` etc.; last,
# since each imports from the modules above
from . import data, engine, parallel, utils  # noqa: E402

__version__ = "0.5.0"

__all__ = [
    "__version__",
    "Communicator",
    "CommunicatorError",
    "NotStartedError",
    "SyncHandle",
    "allgather_tensor",
    "allgatherv_tensor",
    "allreduce_scalar",
    "allreduce_tensor",
    "alltoall_tensor",
    "async_",
    "barrier",
    "broadcast_scalar",
    "broadcast_tensor",
    "collective_availability",
    "collective_selector",
    "collectives",
    "communicator_names",
    "constants",
    "current_communicator",
    "describe",
    "engine",
    "free_collective_resources",
    "kernel",
    "local_ranks",
    "nn",
    "num_nodes_in_communicator",
    "num_processes",
    "ops",
    "parallel",
    "parameterserver",
    "push_communicator",
    "rank",
    "reduce_scalar",
    "reduce_tensor",
    "reducescatter_tensor",
    "ring",
    "schedule",
    "sendreceive_scalar",
    "sendreceive_tensor",
    "set_collective_span",
    "set_communicator",
    "size",
    "split_by_keys",
    "stack",
    "start",
    "started",
    "stop",
    "sync_all",
    "telemetry",
    "utils",
    "wait",
    "xla",
]
