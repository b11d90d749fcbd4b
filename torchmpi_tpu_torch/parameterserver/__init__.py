"""Sharded parameter server on the communicator's device (reference N10 +
L6/L7), the port of ``torchmpi_tpu/parameterserver``.

The in-process data path honours the ``parameterserver_wire_dtype``
precision (:mod:`.wire`) and supports client-side double-buffered prefetch
(:meth:`ParameterServer.prefetch`, ``ps_prefetch``). The socket transport,
its event loop, the shm lane, replication chains, delta fetches and
``serve/`` wait for later slices (ROADMAP A7, A13)."""

from . import wire
from .rules import UPDATE_RULES
from .server import ParameterServer, free_all, shard_range
from .tensors import PSGroup, synchronize_gradients_with_parameterserver
from .update import DownpourUpdate, EASGDUpdate, Update

__all__ = [
    "ParameterServer",
    "PSGroup",
    "free_all",
    "shard_range",
    "UPDATE_RULES",
    "Update",
    "DownpourUpdate",
    "EASGDUpdate",
    "synchronize_gradients_with_parameterserver",
    "wire",
]
