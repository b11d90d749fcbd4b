"""Recovery: the verdict-driven recovery supervisor and the
last-good-checkpoint registry, the port of ``torchmpi_tpu/supervise``.

A policy engine maps each streaming verdict of the live plane
(:class:`~..telemetry.live.FleetAggregator`) to a bounded remediation:

    rank-dead / hang      -> evict + live shrink
    straggler             -> quarantine (evict + rejoin denylist)
    resize-incomplete     -> evict the ranks that never entered
    desync / resize-torn  -> checkpoint rollback (from the last
                             registered checkpoint_every artifact)
    overload              -> scale-up
    underload             -> scale-down (retire the highest live rank)
    clean (persisting)    -> grow back (opt-in)

with hysteresis, jittered bounded retries, and an escalation ladder.
The actions run through an actuator the caller supplies; in one process
the caller calls ``observe(aggregator.evaluate())`` itself. See
:mod:`.core` (engine), :mod:`.policy` (the declarative table), and
:mod:`.checkpoints` (the registry rollbacks restore from). The
launcher's and the simulator's actuators wait for multi-process ranks
(ROADMAP A13, A10's rest) and ``sim/``.
"""

from .checkpoints import (  # noqa: F401
    describe_last,
    last_checkpoint,
    register_checkpoint,
)
from .core import Actuator, RecoverySupervisor  # noqa: F401
from .policy import (  # noqa: F401
    A_EVICT,
    A_GROW,
    A_QUARANTINE,
    A_ROLLBACK,
    A_SCALE_DOWN,
    A_SCALE_UP,
    PolicyRule,
    default_policy,
)

__all__ = [
    "Actuator", "RecoverySupervisor", "PolicyRule", "default_policy",
    "register_checkpoint", "last_checkpoint", "describe_last",
    "A_EVICT", "A_GROW", "A_QUARANTINE", "A_ROLLBACK",
    "A_SCALE_UP", "A_SCALE_DOWN",
]
