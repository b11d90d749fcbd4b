"""Runtime core of the port: the communicator stack over virtual ranks, the
handles of async work and the offload pools."""

from .communicator import (
    Communicator,
    CommunicatorError,
    CommunicatorStack,
    KeySpec,
    split_by_keys,
)
from .handles import StreamResult, SyncHandle, sync_all, wait

__all__ = [
    "Communicator",
    "CommunicatorError",
    "CommunicatorStack",
    "KeySpec",
    "StreamResult",
    "SyncHandle",
    "split_by_keys",
    "sync_all",
    "wait",
]
