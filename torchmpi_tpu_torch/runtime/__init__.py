"""Runtime core of the port: the communicator stack over virtual ranks and
the handles of async collectives."""

from .communicator import (
    Communicator,
    CommunicatorError,
    CommunicatorStack,
    KeySpec,
    split_by_keys,
)
from .handles import SyncHandle, sync_all, wait

__all__ = [
    "Communicator",
    "CommunicatorError",
    "CommunicatorStack",
    "KeySpec",
    "SyncHandle",
    "split_by_keys",
    "sync_all",
    "wait",
]
