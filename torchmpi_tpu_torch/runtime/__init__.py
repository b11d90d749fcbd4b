"""Runtime core of the port: the communicator stack over virtual ranks."""

from .communicator import (
    Communicator,
    CommunicatorError,
    CommunicatorStack,
    KeySpec,
    split_by_keys,
)

__all__ = [
    "Communicator",
    "CommunicatorError",
    "CommunicatorStack",
    "KeySpec",
    "split_by_keys",
]
