"""Collective flight recorder: a bounded ring of structured dispatch events.

The spans answer "how long did things take on THIS rank"; the flight
recorder answers the cross-rank questions — "which rank issued a
mismatched collective", "who is the straggler", "what was in flight when
the world hung". Every eager collective dispatch, fusion-buffer flush,
engine step, and parameter-server RPC records one entry:

    (seq, comm, op, payload, wire, backend, routing,
     t_issue, t_complete, status, trace, span, parent)

- ``seq`` is a **monotonic per-communicator sequence number**. Ranks
  executing the same program issue the same (seq, op, payload) stream per
  communicator, so cross-rank desync is a *diff* (the GC3 schedule-as-data
  framing, PAPERS.md): the first divergent (seq, op, payload) IS the bug.
  PS RPC entries reuse the transport's own per-peer wire seq instead, so
  a recorder entry can be matched to the frame on the wire.
- ``payload`` is a deterministic shape/dtype descriptor (built lazily at
  snapshot time — the hot path stores the raw tuple, no string work).
- ``status`` walks ``issued -> completed | failed``. An entry stuck at
  ``issued`` past the watchdog timeout is the hang signal
  (:mod:`telemetry.watchdog`).

Recording is allocation-light: one lock, one dict bump for the seq, one
small list, one ``deque(maxlen)`` append. When the ring wraps, the
``dropped`` counter makes the truncation detectable (the analyzer trims
cross-rank diffs to the overlapping seq window). Entries are mutated in
place on completion — completion of an already-evicted entry is harmless.

Gating: the recorder follows the telemetry master switch
(``TORCHMPI_TPU_TELEMETRY`` / ``telemetry.enable()``) but can also be
enabled **alone** (:func:`enable`), which is how ``bench.py --microbench``
isolates recorder+watchdog overhead from the metrics/span machinery.
Stdlib-only, like the rest of the package.
"""

from __future__ import annotations

import os
import threading
from ..analysis import lockmon as _lockmon
from . import tracecontext as _tracecontext
import time
from collections import deque
from typing import Dict, List, Optional

STATUS_ISSUED = "issued"
STATUS_COMPLETED = "completed"
STATUS_FAILED = "failed"

# entry slot layout (a list, mutated in place on completion)
_SEQ, _COMM, _OP, _PAYLOAD, _WIRE, _BACKEND, _ROUTING, _PLAN = range(8)
_T_ISSUE, _T_COMPLETE, _STATUS = 8, 9, 10
# causal trace context: all-zero when tracing is off / unstamped
_TRACE, _SPAN, _PARENT = 11, 12, 13

ENTRY_KEYS = (
    "seq", "comm", "op", "payload", "wire", "backend", "routing", "plan",
    "t_issue", "t_complete", "status", "trace", "span", "parent",
)


def comm_key(comm) -> str:
    """Stable cross-rank identity for a communicator: name + size (names
    like 'global' / 'per-node ici groups' repeat per stack level; the size
    disambiguates without dragging device ids, which differ per rank)."""
    return f"{getattr(comm, 'name', '?')}[{getattr(comm, 'size', 0)}]"


def format_payload(payload) -> str:
    """Deterministic JSON-friendly payload descriptor. The hot path stores
    ``(shape, dtype)`` tuples raw; this stringifies at snapshot time."""
    if payload is None:
        return ""
    if isinstance(payload, str):
        return payload
    if isinstance(payload, tuple) and len(payload) == 2:
        shape, dtype = payload
        try:
            return f"{tuple(shape)}:{dtype}"
        except TypeError:
            return f"{shape}:{dtype}"
    return str(payload)


class FlightRecorder:
    """Bounded ring of structured dispatch entries + per-comm seq state."""

    def __init__(self, capacity: int = 4096):
        self._lock = _lockmon.make_lock(
            "flightrecorder.py:FlightRecorder._lock"
        )
        self._buf: deque = deque(maxlen=int(capacity))
        self._seqs: Dict[str, int] = {}
        self.total_recorded = 0
        self.dropped = 0

    @property
    def capacity(self) -> int:
        return self._buf.maxlen or 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    # ------------------------------------------------------------------
    def record(self, comm: str, op: str, payload=None, wire: str = "",
               backend: str = "", routing: str = "",
               seq: Optional[int] = None, plan: str = "",
               trace: int = 0, span: int = 0, parent: int = 0) -> list:
        """Append one ``issued`` entry; returns the (mutable) entry.
        ``seq=None`` draws the next per-``comm`` sequence number;
        an explicit seq (the PS transport's wire seq) advances the
        high-water mark to match. ``plan`` is the schedule compiler's
        stable plan_id — the analyzer diffs it alongside (op, payload),
        so a cross-rank divergence can name the diverging *schedule*
        (hierarchical sub-structure included), not just the op.

        ``trace``/``span``/``parent`` pin this entry into the
        causal DAG. Explicit ids win (wire-received context); otherwise
        the ambient :mod:`telemetry.tracecontext` is consulted and a
        deterministic child span derived from (comm, op, seq)."""
        t = time.time()
        with self._lock:
            if seq is None:
                seq = self._seqs.get(comm, -1) + 1
            self._seqs[comm] = seq
            if not trace:
                trace, span, parent = _tracecontext.stamp(comm, op, seq)
            entry = [seq, comm, op, payload, wire, backend, routing, plan,
                     t, None, STATUS_ISSUED, trace, span, parent]
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(entry)
            self.total_recorded += 1
        return entry

    @staticmethod
    def complete(entry: list) -> None:
        entry[_T_COMPLETE] = time.time()
        entry[_STATUS] = STATUS_COMPLETED

    @staticmethod
    def fail(entry: list) -> None:
        entry[_T_COMPLETE] = time.time()
        entry[_STATUS] = STATUS_FAILED

    def record_complete(self, comm: str, op: str, t_issue: float,
                        t_complete: float, payload=None, wire: str = "",
                        backend: str = "", routing: str = "",
                        seq: Optional[int] = None,
                        trace: int = 0, span: int = 0,
                        parent: int = 0) -> list:
        """Record an already-finished event (engine steps time themselves
        and report after the fact) with explicit wall timestamps."""
        entry = self.record(comm, op, payload=payload, wire=wire,
                            backend=backend, routing=routing, seq=seq,
                            trace=trace, span=span, parent=parent)
        entry[_T_ISSUE] = t_issue
        entry[_T_COMPLETE] = t_complete
        entry[_STATUS] = STATUS_COMPLETED
        return entry

    # ------------------------------------------------------------------
    def in_flight(self, older_than: float = 0.0) -> List[dict]:
        """Entries still ``issued``, optionally only those issued more
        than ``older_than`` seconds ago (the watchdog's hang predicate)."""
        cutoff = time.time() - older_than
        with self._lock:
            entries = [list(e) for e in self._buf
                       if e[_STATUS] == STATUS_ISSUED]
        return [self._as_dict(e) for e in entries if e[_T_ISSUE] <= cutoff]

    def in_flight_count(self) -> int:
        """Allocation-free count of ``issued`` entries (heartbeat field)."""
        with self._lock:
            return sum(1 for e in self._buf if e[_STATUS] == STATUS_ISSUED)

    def seq_high_water(self) -> Dict[str, int]:
        """Last issued seq per communicator — the 'how far did this rank
        get' signal heartbeats carry and the analyzer diffs."""
        with self._lock:
            return dict(self._seqs)

    @staticmethod
    def _as_dict(entry: list) -> dict:
        d = dict(zip(ENTRY_KEYS, entry))
        d["payload"] = format_payload(d["payload"])
        return d

    def entries(self) -> List[dict]:
        with self._lock:
            snap = [list(e) for e in self._buf]
        return [self._as_dict(e) for e in snap]

    def tail(self, n: int) -> List[dict]:
        """The newest ``n`` entries (oldest first) as dicts — the bounded
        flight payload the live telemetry exporter streams each interval.
        Entries are copied under the lock, so in-place completion racing
        the copy is harmless; a ``completed`` status for an entry a
        previous tail shipped as ``issued`` simply rides the next one."""
        with self._lock:
            buf = list(self._buf)
            snap = [list(e) for e in (buf[-int(n):] if n else buf)]
        return [self._as_dict(e) for e in snap]

    def snapshot(self) -> dict:
        """JSON-serializable dump: entries + seq high-water + ring health
        (``dropped`` > 0 means the oldest entries were evicted)."""
        return {
            "capacity": self.capacity,
            "recorded": self.total_recorded,
            "dropped": self.dropped,
            "seq_high_water": self.seq_high_water(),
            "entries": self.entries(),
        }

    def reset(self) -> None:
        with self._lock:
            self._buf.clear()
            self._seqs.clear()
            self.total_recorded = 0
            self.dropped = 0


#: process-global flight recorder (capacity via TORCHMPI_TPU_FLIGHT_ENTRIES)
recorder = FlightRecorder(
    capacity=int(os.environ.get("TORCHMPI_TPU_FLIGHT_ENTRIES", "4096") or 4096)
)

# Effective enable state = (telemetry master switch) OR (forced on).
# telemetry.enable()/disable() push their state here via _sync_telemetry so
# the hot-path check stays one module-global read — no cross-module lookup.
_forced = False
_telemetry_on = False
_enabled = False


def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Force the recorder on independently of the telemetry switch (the
    overhead-isolation mode of ``bench.py --microbench``)."""
    global _forced, _enabled
    _forced = True
    _enabled = True


def disable() -> None:
    global _forced, _enabled
    _forced = False
    _enabled = _telemetry_on


def _sync_telemetry(on: bool) -> None:
    """Called by ``telemetry.enable``/``disable`` (and the env-var init)."""
    global _telemetry_on, _enabled
    _telemetry_on = bool(on)
    _enabled = _forced or _telemetry_on
