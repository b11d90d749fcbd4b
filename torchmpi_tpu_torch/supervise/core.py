"""RecoverySupervisor: the verdict -> action policy engine.

A copy of ``torchmpi_tpu/supervise/core.py`` (standard library only,
over the port's lock monitor, flight recorder and checkpoint registry):
the same journals, ``actions_doc()`` and ``tm_supervisor_*`` lines for
the same verdict documents, seed and clock.

The sensing half is the live plane: per-rank telemetry streams into a
:class:`~..telemetry.live.FleetAggregator` whose
:meth:`~..telemetry.live.FleetAggregator.evaluate` names ONE verdict per
window. This module is the acting half: a deterministic state machine
that consumes those verdict documents and drives remediation through an
injected **actuator**. In one process the caller owns the loop:
``observe(aggregator.evaluate())`` after each step, with an actuator of
its own (``observe()`` is a plain synchronous call). Two actuators of
the JAX package wait for their layers: the launcher's (``launch
--elastic --supervise``: kill wedged workers, commit the live shrink,
relaunch from the last registered checkpoint), which needs
multi-process ranks (ROADMAP A13) and the elastic coordinator (A10's
rest), and the fleet simulator's (``sim/``).

Safety properties (the policy table, :mod:`.policy`, carries the
numbers):

- **hysteresis** — a verdict acts only after persisting N consecutive
  aggregation windows;
- **bounded retries + jittered exponential backoff** per rung
  (deterministic: the jitter RNG is seeded);
- **escalation ladder** — evictions that fail to clear the verdict
  escalate to a checkpoint rollback; a rollback fires at most once per
  supervisor lifetime (the relaunch builds a fresh one);
- **quarantine** — stragglers are evicted AND denylisted for a
  cooldown: the grow-back rung discounts denylisted capacity from its
  target, so the supervisor will not replace a known-slow host until
  the cooldown lapses (operator-initiated grows are not vetoed);
- **dry-run** — every decision is journaled, nothing is actuated.

Every action lands in :attr:`RecoverySupervisor.journal`, in the
process flight recorder (comm ``supervisor``) when telemetry is
enabled, in the ``tm_supervisor_*`` metric lines the aggregator's
``/metrics`` serves, and in the ``/actions`` HTTP document.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Dict, List, Optional

from ..analysis import lockmon as _lockmon
from ..telemetry import flightrecorder as _flight
from . import checkpoints
from .policy import (
    A_EVICT,
    A_GROW,
    A_QUARANTINE,
    A_ROLLBACK,
    A_SCALE_DOWN,
    A_SCALE_UP,
    PolicyRule,
    default_policy,
)


class Actuator:
    """The remediation surface a supervisor drives. Subclasses return
    True when the action was applied (False/raise = failed attempt —
    it counts against the rung's bounded retries)."""

    def evict(self, ranks: List[int], reason: str) -> bool:
        raise NotImplementedError

    def grow(self, reason: str) -> bool:
        raise NotImplementedError

    def rollback(self, reason: str) -> bool:
        raise NotImplementedError

    # load-driven resizes default to the failure-driven primitives: an
    # actuator that can grow/evict can already scale, and one that wants
    # different mechanics (warm pools, draining) overrides these
    def scale_up(self, reason: str) -> bool:
        return self.grow(reason)

    def scale_down(self, ranks: List[int], reason: str) -> bool:
        return self.evict(ranks, reason)


class RecoverySupervisor:
    """Deterministic verdict->action engine (module docstring)."""

    def __init__(self, actuator: Actuator,
                 policy: Optional[Dict[str, PolicyRule]] = None,
                 clock: Optional[Callable[[], float]] = None,
                 dry_run: bool = False, seed: int = 0,
                 quarantine_cooldown_s: Optional[float] = None,
                 on_action: Optional[Callable[[dict], None]] = None):
        from .. import constants

        self.actuator = actuator
        self.policy = dict(policy) if policy is not None else default_policy()
        self.dry_run = bool(dry_run)
        self._clock = clock or time.time
        self._rng = random.Random(seed)
        self._on_action = on_action
        self._cooldown = float(
            constants.get("supervisor_quarantine_cooldown_s")
            if quarantine_cooldown_s is None else quarantine_cooldown_s
        )
        # scale-rung flap damping (read at construction, same contract
        # as default_policy: the launcher applies --set-constant first)
        self._scale_cooldown = float(
            constants.get("supervisor_scale_cooldown_s")
        )
        self._scale_max_world = int(
            constants.get("supervisor_scale_max_world")
        )
        self._scale_min_world = max(
            1, int(constants.get("supervisor_scale_min_world"))
        )
        self._last_scale_t = float("-inf")
        # one lock covers every mutable field: the observe loop (the
        # launcher's supervisor thread / the sim tick) mutates while the
        # aggregator's HTTP threads render /actions and /metrics — an
        # unlocked scrape mid-_act is a RuntimeError and an HTTP 500 on
        # a healthy fleet (the same rule as FleetAggregator._lock)
        self._lock = _lockmon.make_lock(
            "supervise/core.py:RecoverySupervisor._lock"
        )
        self.journal: List[dict] = []
        self.quarantined: Dict[int, float] = {}  # rank -> denylist until
        self.evicted: set = set()
        self.rolled_back = False
        self.counters: Dict[str, int] = {}
        self._verdict = "clean"
        self._windows = 0          # consecutive windows of _verdict
        self._world_high = 0       # largest fleet ever observed
        # per-verdict ladder state
        self._rung: Dict[str, int] = {}       # 0 = primary, 1 = escalated
        self._attempts: Dict[str, int] = {}   # attempts at current rung
        self._next_ok: Dict[str, float] = {}  # backoff gate

    # -- the decision step --------------------------------------------------
    def observe(self, doc: dict, now: Optional[float] = None) -> List[dict]:
        """Consume one verdict document (one aggregation window); returns
        the journal entries this window produced (possibly empty)."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            verdict = doc.get("verdict", "clean")
            if verdict == self._verdict:
                self._windows += 1
            else:
                self._verdict, self._windows = verdict, 1
            self._world_high = max(
                self._world_high, len(doc.get("ranks", []))
            )
            for r in [r for r, t in self.quarantined.items() if now >= t]:
                del self.quarantined[r]
            if verdict == "clean" and (
                self._windows >= self._clean_hysteresis()
            ):
                # recovery held: the ladders reset (a LATER fault starts
                # a fresh bounded episode, not a continuation of the old
                # one) — including the evicted set, so a member that
                # REJOINS after the episode is targetable again
                self._rung.clear()
                self._attempts.clear()
                self._next_ok.clear()
                self.evicted.clear()
            rule = self.policy.get(verdict)
            if rule is None or self.rolled_back:
                return []
            if self._windows < rule.hysteresis:
                return []
            if now < self._next_ok.get(verdict, 0.0):
                return []
            return self._act(rule, verdict, doc, now)

    def _clean_hysteresis(self) -> int:
        rule = self.policy.get("clean")
        if rule is not None:
            return rule.hysteresis
        # scale rungs excluded: scale-down's deliberately long
        # hysteresis is capacity flap damping, not a bar recovery must
        # clear before fault ladders reset
        return max(
            (r.hysteresis for r in self.policy.values()
             if r.action not in (A_SCALE_UP, A_SCALE_DOWN)),
            default=1,
        )

    # -- acting -------------------------------------------------------------
    def _act(self, rule: PolicyRule, verdict: str, doc: dict,
             now: float) -> List[dict]:
        attempt = self._attempts.get(verdict, 0)
        rung = self._rung.get(verdict, 0)
        action = rule.action
        if rung == 0 and attempt >= rule.max_retries:
            if rule.escalate is None:
                return []  # rung exhausted, nowhere to go: hold
            rung = self._rung[verdict] = 1
            attempt = self._attempts[verdict] = 0
        if rung == 1:
            action = rule.escalate
            if attempt >= rule.max_retries:
                return []  # the LAST rung is bounded too: hold, don't
                # hammer a rollback path that keeps failing
        if action == A_GROW and not self._want_grow(doc):
            return []
        if action in (A_SCALE_UP, A_SCALE_DOWN):
            if now - self._last_scale_t < self._scale_cooldown:
                return []  # flap damping: one resize per cooldown, max
            world = len(doc.get("ranks", []))
            if action == A_SCALE_UP and self._scale_max_world and (
                world >= self._scale_max_world
            ):
                # at the ceiling the supervisor HOLDS: the serving
                # tier's brownout ladder degrades gracefully instead of
                # the fleet collapsing under a grow it cannot satisfy
                return []
            if action == A_SCALE_DOWN and (
                world - 1 < self._scale_min_world
            ):
                return []
        targets = self._targets(action, verdict, doc)
        entry = {
            "time": round(now, 6),
            "verdict": verdict,
            "windows": self._windows,
            "action": action,
            "ranks": targets,
            "attempt": attempt + 1,
            "escalated": rung == 1,
        }
        entry["result"] = self._perform(action, targets, verdict, now)
        self.journal.append(entry)
        key = f"{action}:{entry['result']}"
        self.counters[key] = self.counters.get(key, 0) + 1
        self._attempts[verdict] = attempt + 1
        backoff = min(
            rule.backoff_cap_s,
            rule.backoff_base_s * (2 ** attempt),
        ) * (0.5 + self._rng.random())  # +-50% jitter, seeded
        self._next_ok[verdict] = now + backoff
        self._record_flight(entry)
        if self._on_action is not None:
            try:
                self._on_action(entry)
            except Exception:  # noqa: BLE001 - reporting must not gate acting
                pass
        return [entry]

    def _perform(self, action: str, targets: List[int], verdict: str,
                 now: float) -> str:
        if self.dry_run:
            return "dry-run"
        try:
            if action in (A_EVICT, A_QUARANTINE):
                ok = True
                if targets:
                    ok = self.actuator.evict(targets, reason=verdict)
                if ok:
                    # a FAILED eviction leaves the targets fresh: the
                    # bounded retry must re-attempt the kill, not skip
                    # the ranks and exhaust the rung on no-ops
                    self.evicted.update(targets)
                    if action == A_QUARANTINE:
                        for r in targets:
                            self.quarantined[r] = now + self._cooldown
                return "applied" if ok else "failed"
            if action == A_GROW:
                return "applied" if self.actuator.grow(reason=verdict) \
                    else "failed"
            if action == A_SCALE_UP:
                ok = self.actuator.scale_up(reason=verdict)
                if ok:
                    self._last_scale_t = now
                return "applied" if ok else "failed"
            if action == A_SCALE_DOWN:
                ok = True
                if targets:
                    ok = self.actuator.scale_down(targets, reason=verdict)
                if ok:
                    self.evicted.update(targets)
                    self._last_scale_t = now
                    # a deliberate shrink lowers the observed high-water
                    # mark: grow-back must not fight scale-down by
                    # restoring capacity the load no longer needs
                    self._world_high = max(
                        self._scale_min_world,
                        self._world_high - len(targets),
                    )
                return "applied" if ok else "failed"
            if action == A_ROLLBACK:
                ok = self.actuator.rollback(reason=verdict)
                if ok:
                    self.rolled_back = True
                return "applied" if ok else "failed"
        except Exception:  # noqa: BLE001 - a failed actuation is a
            return "failed"  # counted attempt, never a supervisor crash
        return "failed"

    # -- target selection ---------------------------------------------------
    def _targets(self, action: str, verdict: str, doc: dict) -> List[int]:
        if action in (A_ROLLBACK, A_GROW, A_SCALE_UP):
            return []
        fresh = lambda rs: sorted(  # noqa: E731
            {int(r) for r in rs} - self.evicted
        )
        if action == A_SCALE_DOWN:
            # retire the HIGHEST live rank: the elastic world contracts
            # from the top, so the shrink commits without renumbering
            live = fresh(doc.get("ranks") or [])
            if len(live) <= self._scale_min_world:
                return []
            return [live[-1]]
        if verdict == "rank-dead":
            return fresh(doc.get("dead_ranks") or [])
        if verdict == "hang":
            dead = fresh(doc.get("dead_ranks") or [])
            if dead:
                return dead
            if self.evicted:
                # an eviction is already in flight this episode: the
                # survivors' stuck entries are expected evidence while
                # the shrink commits, NOT a fresh deadlock — killing the
                # "oldest waiter" here would behead a healthy rank that
                # is merely waiting out the resize. Hold (the attempt
                # still counts, so a hang that OUTLIVES the eviction
                # escalates to rollback, the designed ladder).
                return []
            stuck = doc.get("stuck") or []
            if not stuck:
                return []
            # a true deadlock names no corpse: evict the single oldest
            # waiter — the epoch bump un-wedges the rest, and the rung's
            # bounded retries keep this from decimating a healthy fleet
            oldest = min(
                stuck, key=lambda s: (float(s.get("t_issue") or 0.0),
                                      int(s.get("rank", 0))),
            )
            return fresh([int(oldest.get("rank", -1))])
        if verdict == "resize-incomplete":
            never = set()
            for info in (doc.get("resize") or {}).get("epochs", {}).values():
                never.update(int(r) for r in info.get("never_entered") or [])
            return fresh(never)
        if verdict == "straggler":
            ranking = (doc.get("stragglers") or {}).get("ranking") or []
            if not ranking:
                return []
            return fresh([int(ranking[0]["rank"])])
        return []

    def _want_grow(self, doc: dict) -> bool:
        target = self._world_high - len(self.quarantined)
        return len(doc.get("ranks", [])) < target

    # -- reporting ----------------------------------------------------------
    def _record_flight(self, entry: dict) -> None:
        if not _flight.enabled():
            return
        e = _flight.recorder.record(
            "supervisor", f"supervise.{entry['action']}",
            payload=f"ranks={entry['ranks']}",
            backend="supervisor",
            routing=f"verdict={entry['verdict']}",
            seq=len(self.journal) - 1,
        )
        if entry["result"] == "failed":
            _flight.FlightRecorder.fail(e)
        else:
            _flight.FlightRecorder.complete(e)

    def actions_doc(self, now: Optional[float] = None) -> dict:
        """The ``/actions`` HTTP document: journal + ladder state.
        Rendered under the lock — the observe loop mutates these."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            return self._actions_doc_locked(now)

    def _actions_doc_locked(self, now: float) -> dict:
        return {
            "time": round(now, 6),
            "dry_run": self.dry_run,
            "verdict": self._verdict,
            "windows": self._windows,
            "rolled_back": self.rolled_back,
            "journal": list(self.journal),
            "evicted": sorted(self.evicted),
            "quarantined": {
                str(r): round(t, 6) for r, t in sorted(
                    self.quarantined.items()
                )
            },
            "counters": dict(sorted(self.counters.items())),
            "last_checkpoint": checkpoints.last_checkpoint(),
            "policy": {
                v: {
                    "action": r.action,
                    "hysteresis": r.hysteresis,
                    "max_retries": r.max_retries,
                    "escalate": r.escalate,
                }
                for v, r in sorted(self.policy.items())
            },
        }

    def prometheus_lines(self) -> List[str]:
        """``tm_supervisor_*`` gauge/counter lines for the aggregator's
        ``/metrics`` passthrough (under the lock, same reason as
        :meth:`actions_doc`)."""
        with self._lock:
            return self._prometheus_lines_locked()

    def _prometheus_lines_locked(self) -> List[str]:
        out = [
            "# HELP tm_supervisor_actions_total recovery actions taken "
            "by the supervisor, by action and result",
            "# TYPE tm_supervisor_actions_total counter",
        ]
        for key, n in sorted(self.counters.items()):
            action, _, result = key.partition(":")
            out.append(
                f'tm_supervisor_actions_total{{action="{action}",'
                f'result="{result}"}} {n}'
            )
        out += [
            "# HELP tm_supervisor_quarantined_ranks ranks currently on "
            "the rejoin denylist",
            "# TYPE tm_supervisor_quarantined_ranks gauge",
            f"tm_supervisor_quarantined_ranks {len(self.quarantined)}",
            "# HELP tm_supervisor_rolled_back 1 after the supervisor's "
            "checkpoint-rollback rung fired",
            "# TYPE tm_supervisor_rolled_back gauge",
            f"tm_supervisor_rolled_back {int(self.rolled_back)}",
            "# HELP tm_supervisor_verdict_windows consecutive windows "
            "the current verdict has persisted",
            "# TYPE tm_supervisor_verdict_windows gauge",
            f'tm_supervisor_verdict_windows{{verdict="{self._verdict}"}} '
            f"{self._windows}",
            "# HELP tm_supervisor_dry_run 1 when decisions are journaled "
            "but not actuated",
            "# TYPE tm_supervisor_dry_run gauge",
            f"tm_supervisor_dry_run {int(self.dry_run)}",
        ]
        return out
