"""The declarative recovery policy: verdict -> remediation, bounded.

A copy of ``torchmpi_tpu/supervise/policy.py`` (standard library only).

One :class:`PolicyRule` per streaming verdict (the
:data:`~..telemetry.live.VERDICT_PRIORITY` names), each carrying the
four numbers that keep an autonomous supervisor SAFE:

- ``hysteresis`` — consecutive aggregation windows the verdict must
  persist before any action fires (a single noisy window acts on
  nobody);
- ``max_retries`` — bounded attempts per ladder rung;
- ``backoff_base_s`` / ``backoff_cap_s`` — jittered exponential backoff
  between attempts (base * 2^attempt, +-50% jitter, capped);
- ``escalate`` — the next rung when the bounded retries are exhausted
  and the verdict still stands (evictions that did not clear the
  verdict escalate to a checkpoint rollback).

The default table (:func:`default_policy`) is built from the
``supervisor_*`` constants, so a ``constants.set`` (or ``start(**kw)``)
before the supervisor is built deploys a different temperament without
code:

==================  =============  ==========================
verdict             action         escalation
==================  =============  ==========================
desync              rollback       (terminal)
resize-torn         rollback       (terminal)
hang                evict-shrink   rollback
rank-dead           evict-shrink   rollback
resize-incomplete   evict-shrink   rollback
straggler           quarantine     (none: advisory eviction)
overload            scale-up       (none: at max world the
                                   serving brownout ladder
                                   degrades instead)
ps-overload         (observe)      (none: admission control
                                   already sheds the load)
underload           scale-down     (none)
clean               grow-back      (opt-in via
                                   supervisor_grow_back)
==================  =============  ==========================

The scale rungs are the AMBITIOUS half of the ladder: every other rung
reacts to failure, these react to load (the serving tier's streaming
load verdicts). Flap damping is layered — asymmetric hysteresis
(``supervisor_scale_up_hysteresis`` fast, ``supervisor_scale_down_``
``hysteresis`` slow) plus a shared cooldown
(``supervisor_scale_cooldown_s``) between ANY two applied scale
actions, so an oscillating arrival trace cannot saw the world size.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from .. import constants

# action names (the journal/metrics vocabulary)
A_EVICT = "evict-shrink"
A_QUARANTINE = "quarantine"
A_ROLLBACK = "rollback"
A_GROW = "grow-back"
A_SCALE_UP = "scale-up"
A_SCALE_DOWN = "scale-down"


@dataclass(frozen=True)
class PolicyRule:
    action: str
    hysteresis: int
    max_retries: int
    backoff_base_s: float
    backoff_cap_s: float
    escalate: Optional[str] = None


def default_policy() -> Dict[str, PolicyRule]:
    """The shipped table, parameterized by the ``supervisor_*`` knobs
    (read at construction: set them before building the supervisor)."""
    hyst = int(constants.get("supervisor_hysteresis_windows"))
    retries = int(constants.get("supervisor_max_retries"))
    base = float(constants.get("supervisor_backoff_base_s"))
    cap = float(constants.get("supervisor_backoff_cap_s"))

    def rule(action: str, escalate: Optional[str] = None,
             hysteresis: Optional[int] = None) -> PolicyRule:
        return PolicyRule(
            action=action,
            hysteresis=hyst if hysteresis is None else hysteresis,
            max_retries=retries,
            backoff_base_s=base,
            backoff_cap_s=cap,
            escalate=escalate,
        )

    table: Dict[str, PolicyRule] = {
        # a cross-rank collective divergence cannot be repaired by
        # membership surgery: the streams already disagree
        "desync": rule(A_ROLLBACK),
        # a torn resize means the redistribution sources are suspect
        "resize-torn": rule(A_ROLLBACK),
        "hang": rule(A_EVICT, escalate=A_ROLLBACK),
        "rank-dead": rule(A_EVICT, escalate=A_ROLLBACK),
        "resize-incomplete": rule(A_EVICT, escalate=A_ROLLBACK),
        "straggler": rule(A_QUARANTINE),
        # ps-overload is absent on purpose: BUSY/backoff admission
        # control is the load-shedding mechanism; killing servers under
        # load would amplify the storm
        #
        # the load rungs (serving tier): scale-up reacts faster than
        # scale-down by construction — asymmetric hysteresis is the
        # first line of flap damping, the supervisor's shared scale
        # cooldown the second
        "overload": rule(
            A_SCALE_UP,
            hysteresis=int(
                constants.get("supervisor_scale_up_hysteresis")
            ),
        ),
        "underload": rule(
            A_SCALE_DOWN,
            hysteresis=int(
                constants.get("supervisor_scale_down_hysteresis")
            ),
        ),
    }
    if bool(constants.get("supervisor_grow_back")):
        # grow back only after the fleet has been CLEAN for the same
        # hysteresis the destructive rungs require
        table["clean"] = rule(A_GROW)
    return table
