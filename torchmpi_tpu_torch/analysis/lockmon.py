"""Opt-in instrumented-lock runtime monitor (``TORCHMPI_TPU_LOCK_MONITOR=1``).

The static analyzer (:mod:`.locks`) derives the lock-order graph from
the source; this module validates that graph against *reality*: when
armed, every lock the threaded modules create through
:func:`make_lock` / :func:`make_condition` is a :class:`MonitoredLock`
that records the actual acquisition order (per thread, by lock *name*)
into a process-global order table. The first time two locks are
observed in both orders, the second acquisition **fails** with
:class:`LockOrderInversion` and the violation is recorded — sanitizer
wiring for a language TSan can't reach. Tier-1 runs once under the
monitor in CI (``scripts/ci.sh``); the conftest gate fails the session
if any inversion was recorded, even one swallowed by a worker thread.

Disarmed (the default), :func:`make_lock` returns a plain
``threading.Lock`` — zero overhead, byte-identical hot paths.

Same-name pairs are never flagged: a name covers every instance of a
lock *definition* (e.g. the per-rank mailbox locks
``server.py:_Instance.locks[]``), and instances of one definition may
legitimately interleave.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

__all__ = [
    "LockOrderInversion", "MonitoredLock", "make_lock", "make_condition",
    "enabled", "violations", "order_table", "reset",
]


def _env_true(name: str) -> bool:
    return os.environ.get(name, "").lower() in ("1", "true", "yes", "on")


_MONITOR = _env_true("TORCHMPI_TPU_LOCK_MONITOR")

# guards the order table + violation list (a plain lock: monitor
# internals are never themselves monitored)
_guard = threading.Lock()
# (first, second) -> "thread/site" of the first observation
_order: Dict[Tuple[str, str], str] = {}
_violations: List[dict] = []
_held = threading.local()


class LockOrderInversion(RuntimeError):
    """Two locks were acquired in both orders — a potential deadlock."""


def enabled() -> bool:
    return _MONITOR


def set_enabled(on: bool) -> None:
    """Test hook: arm/disarm for locks created AFTER this call."""
    global _MONITOR
    _MONITOR = bool(on)


def violations() -> List[dict]:
    with _guard:
        return list(_violations)


def order_table() -> Dict[Tuple[str, str], str]:
    """The observed acquired-while-held pairs (for introspection and for
    diffing against the static graph)."""
    with _guard:
        return dict(_order)


def reset() -> None:
    with _guard:
        _order.clear()
        del _violations[:]


def snapshot_state():
    """(order table, violations) — pair with :func:`restore_state` so a
    test that provokes a DELIBERATE inversion can put the global tables
    back exactly as it found them, instead of reset()-ing away any real
    violations recorded earlier in the session (which would blind the
    session-end gate)."""
    with _guard:
        return (dict(_order), [dict(v) for v in _violations])


def restore_state(state) -> None:
    order, viols = state
    with _guard:
        _order.clear()
        _order.update(order)
        del _violations[:]
        _violations.extend(viols)


def _held_stack() -> list:
    stack = getattr(_held, "stack", None)
    if stack is None:
        stack = _held.stack = []
    return stack


class MonitoredLock:
    """``threading.Lock`` wrapper recording acquisition order by name.

    Duck-types the Lock API (acquire/release/locked/context manager)
    plus ``_is_owned`` so ``threading.Condition`` can use it as its
    underlying lock (its wait() release/re-acquire flows through this
    wrapper, keeping the held-stack exact)."""

    __slots__ = ("name", "_lock", "_owner")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._owner: Optional[int] = None

    # -- Lock protocol ------------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if not got:
            return False
        stack = _held_stack()
        bad = self._record(stack)
        if bad is not None:
            self._lock.release()
            raise LockOrderInversion(bad)
        self._owner = threading.get_ident()
        stack.append(self.name)
        return True

    def release(self) -> None:
        stack = _held_stack()
        if self.name in stack:
            # remove the most recent hold of this name
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == self.name:
                    del stack[i]
                    break
        self._owner = None
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def _is_owned(self) -> bool:  # Condition support
        return self._owner == threading.get_ident()

    def __repr__(self) -> str:
        return f"MonitoredLock({self.name!r})"

    # -- order recording ----------------------------------------------------
    def _record(self, stack: list) -> Optional[str]:
        if not stack:
            return None
        me = self.name
        site = f"thread {threading.current_thread().name}"
        with _guard:
            for h in stack:
                if h == me:
                    continue  # same definition: instances may interleave
                rev = _order.get((me, h))
                if rev is not None:
                    record = {
                        "pair": (h, me),
                        "first_order": f"{me} -> {h}",
                        "first_site": rev,
                        "second_order": f"{h} -> {me}",
                        "second_site": site,
                    }
                    _violations.append(record)
                    return (
                        f"lock-order inversion: acquiring {me!r} while "
                        f"holding {h!r}, but the opposite order was "
                        f"observed earlier ({rev})"
                    )
                _order.setdefault((h, me), site)
        return None


def make_lock(name: str):
    """A plain ``threading.Lock`` — or, under the monitor, a
    :class:`MonitoredLock` keyed by ``name`` (use the static analyzer's
    naming, ``module.py:Class.attr``, so the runtime table diffs
    directly against the static graph)."""
    if _MONITOR:
        return MonitoredLock(name)
    return threading.Lock()


def make_condition(name: str) -> threading.Condition:
    """A Condition over a (possibly monitored) lock."""
    return threading.Condition(make_lock(name))
