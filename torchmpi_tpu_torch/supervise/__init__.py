"""Recovery support: for now only the last-good-checkpoint registry
(:mod:`.checkpoints`). The verdict-driven recovery supervisor and its
policy table (``torchmpi_tpu/supervise/core.py``, ``policy.py``) are
ROADMAP A10.
"""

from .checkpoints import (  # noqa: F401
    describe_last,
    last_checkpoint,
    register_checkpoint,
)

__all__ = ["register_checkpoint", "last_checkpoint", "describe_last"]
