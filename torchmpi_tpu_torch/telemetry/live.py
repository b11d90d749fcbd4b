"""Live telemetry plane: streaming fleet aggregation + online verdicts.

The port of ``torchmpi_tpu/telemetry/live.py``. The rest of the
observability is post-mortem: metrics dumped on exit, the cross-rank
analyzer run offline over files. This module makes the same evidence
STREAM while the job runs:

- **Exporter** (one per rank, :func:`start_exporter` or the
  ``TORCHMPI_TPU_TELEMETRY_LIVE`` env hook the launcher sets): a
  daemon thread that every ``telemetry_live_interval_s`` seconds ships
  one bounded frame — the metric-family **delta** since the last frame
  (``registry.snapshot(since=...)``, O(changes)), the flight-recorder
  seq high-waters, the newest ``telemetry_live_tail_entries`` flight
  entries, and span-ring occupancy — over one persistent TCP
  connection. A failed send flips the next frame to a full snapshot
  (delta-then-full reconciliation); a clean stop sends a ``bye``.
  In carrier mode the frame instead **piggybacks on an elastic
  member's heartbeat** (``TORCHMPI_TPU_TELEMETRY_LIVE_VIA=heartbeat``,
  :func:`heartbeat_frame`): zero extra sockets, the coordinator forwards
  it. The port keeps the carrier; the elastic launcher that pulls it is
  ROADMAP A10.

- **FleetAggregator** (lives in the launcher, or rank 0, or a test):
  reconciles per-rank views and runs the analyzer's detectors
  *incrementally* over the rolling window — ``detect_desync`` /
  ``rank_stragglers`` / ``ps_health`` / ``analyze_resizes`` from
  :mod:`.analyze` operate on the aggregated state exactly as they do
  on dump files, long before any process exits. Verdict priority:
  desync > resize-torn > hang (stuck in-flight past the watchdog
  timeout) > rank-dead (stream closed/stale) > resize-incomplete >
  straggler > ps-overload > clean. Completed dispatch entries feed a
  :class:`~.calibrate.SampleStore` (the cost-model calibration feed),
  and a closed-without-bye stream writes a ``dead_rank_<r>.json``
  marker the hang watchdog uses to attribute "peer dead" instead of
  "stale heartbeat".

- **Scrape surface** (:meth:`FleetAggregator.serve`): ``/metrics``
  (fleet-level Prometheus text: every rank's families re-labelled
  ``rank="r"`` plus ``tm_fleet_*`` gauges), ``/health`` (per-rank JSON:
  ages, seq high-waters/lags, step time, BUSY rate, resize epoch,
  dominant PS term), ``/verdicts`` (the streaming verdict JSON with an
  analyzer-style summary), ``/calibration`` (the sample store), and —
  with a recovery supervisor attached (:meth:`FleetAggregator.
  attach_supervisor`: any object with the supervisor's ``actions_doc``
  and ``prometheus_lines``) — ``/actions`` (the recovery
  journal, quarantine denylist and ladder state) plus
  ``tm_supervisor_*`` lines on ``/metrics``.

The aggregator is deterministic by construction — ``ingest``/
``evaluate`` are plain synchronous calls with an injectable clock — so
a driver that feeds it frames gets the same verdicts byte for byte.
Stdlib-only, like the rest of the package.
"""

from __future__ import annotations

import atexit
import json
import os
import socket
import struct
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import constants
from ..analysis import lockmon as _lockmon
from . import criticalpath as _criticalpath
from . import flightrecorder as _flight
from .analyze import (
    analyze_resizes,
    detect_desync,
    ps_health,
    rank_stragglers,
)
from .calibrate import SampleStore
from .registry import metrics_generation

_LEN = struct.Struct("!I")

#: per-(rank, comm) bound on retained streamed entries: the detectors
#: diff a rolling window, not history
MAX_ENTRIES_PER_COMM = 256

#: live verdict names, in priority order (first present wins).
#: ``overload`` sits ABOVE ``ps-overload``: when a serving tier is
#: present its BUSY/shed traffic lands in the same admission counters,
#: and the actionable rung (scale-up) must win over the observe-only
#: ps-overload finding. ``underload`` is last — any problem beats the
#: suggestion to shrink.
VERDICT_PRIORITY = (
    "desync", "resize-torn", "hang", "rank-dead", "resize-incomplete",
    "straggler", "overload", "ps-overload", "underload",
)


def _env_rank() -> int:
    for var in ("TORCHMPI_TPU_PROCESS_ID", "TORCHMPI_TPU_ELASTIC_RANK"):
        try:
            return int(os.environ[var])
        except (KeyError, ValueError):
            continue
    return 0


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


def _send_frame(sock: socket.socket, frame: dict) -> None:
    payload = json.dumps(frame, default=str).encode()
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    while view:
        got = sock.recv_into(view)
        if got == 0:
            raise ConnectionError("live telemetry peer closed")
        view = view[got:]
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> dict:
    n = _LEN.unpack(_recv_exact(sock, _LEN.size))[0]
    return json.loads(_recv_exact(sock, n))


# ---------------------------------------------------------------------------
# per-rank exporter
# ---------------------------------------------------------------------------


class LiveExporter:
    """One rank's non-blocking telemetry feed (module docstring).

    ``carrier=True`` builds frames for an external transport (the
    elastic heartbeat piggyback) instead of owning a socket/thread:
    :meth:`frame` is then called by the carrier at its own cadence."""

    def __init__(self, addr: Optional[Tuple[str, int]] = None,
                 rank: Optional[int] = None, carrier: bool = False):
        self.addr = addr
        self.rank = rank if rank is not None else _env_rank()
        self.carrier = carrier
        self._last_gen: Optional[int] = None  # None -> next frame is full
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._paused = False
        self._thread: Optional[threading.Thread] = None
        self._lock = _lockmon.make_lock("live.py:LiveExporter._lock")
        self._frames = None  # lazy metric handle

    # -- frame building ----------------------------------------------------
    def frame(self) -> dict:
        """One bounded delta frame (or a full one after a drop/start)."""
        from . import metrics, refresh_clock_sync, spans

        since = self._last_gen
        rec = _flight.recorder
        tail_n = int(constants.get("telemetry_live_tail_entries"))
        if since is None:
            kind = "full"
            # generation read BEFORE the scan: a change racing the scan
            # then stamps > gen and rides the next delta instead of
            # falling between frames
            gen = metrics_generation()
            met: dict = metrics.snapshot()
        else:
            kind = "delta"
            met = metrics.snapshot(since=since)
            gen = met["generation"]
        self._last_gen = gen
        return {
            "v": 1,
            "kind": kind,
            "rank": self.rank,
            "pid": os.getpid(),
            "time": time.time(),
            "metrics": met,
            "metrics_generation": gen,
            "seq_high_water": rec.seq_high_water(),
            "flight_tail": rec.tail(tail_n),
            "flight_dropped": rec.dropped,
            "flight_recorded": rec.total_recorded,
            "spans": {
                "recorded": spans.total_recorded,
                "dropped": spans.dropped,
            },
            "resize_epoch": int(constants.get("resize_epoch")),
            # the clock triple is RE-CAPTURED on every frame (heartbeat
            # cadence): the merger aligns with the freshest one, so
            # wall-vs-perf drift is bounded by one live interval instead
            # of accumulating since start()
            "clock_sync": refresh_clock_sync(),
        }

    def mark_dropped(self) -> None:
        """The carrier failed to deliver the last frame: the next one
        must be a full snapshot (delta chain broken)."""
        self._last_gen = None

    # -- socket transport --------------------------------------------------
    def start(self) -> None:
        if self.carrier or self._thread is not None:
            return
        # the flight tail is the frame's backbone: streaming without the
        # recorder would be a silent no-op (same rule as the watchdog)
        _flight.enable()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="tm-live-exporter", daemon=True
        )
        self._thread.start()

    def pause(self) -> None:
        self._paused = True

    def resume(self) -> None:
        self._paused = False

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
        self._thread = None
        with self._lock:
            sock, self._sock = self._sock, None
        if sock is not None:
            try:
                _send_frame(sock, {"v": 1, "kind": "bye", "rank": self.rank,
                                   "time": time.time()})
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def _loop(self) -> None:
        interval = float(constants.get("telemetry_live_interval_s"))
        while not self._stop.wait(interval):
            if self._paused:
                continue
            try:
                self.send_once()
            except Exception:  # noqa: BLE001 - the exporter must outlive
                pass           # any single broken frame
            interval = float(constants.get("telemetry_live_interval_s"))

    def send_once(self) -> bool:
        """Build and ship one frame; returns success. On failure the
        socket is dropped and the next frame goes full."""
        frame = self.frame()
        try:
            with self._lock:
                if self._sock is None:
                    self._sock = socket.create_connection(
                        self.addr, timeout=5
                    )
                _send_frame(self._sock, frame)
            self._count("ok")
            return True
        except OSError:
            with self._lock:
                sock, self._sock = self._sock, None
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            self.mark_dropped()
            self._count("error")
            return False

    def _count(self, result: str) -> None:
        from . import enabled, metrics

        if not enabled():
            return
        if self._frames is None:
            self._frames = metrics.counter(
                "tm_live_frames_total",
                "live telemetry frames shipped by the exporter, by result",
            )
        self._frames.inc(result=result)


_exporter_lock = _lockmon.make_lock("live.py:_exporter")
_exporter: Optional[LiveExporter] = None


def exporter() -> Optional[LiveExporter]:
    return _exporter


def start_exporter(addr, rank: Optional[int] = None) -> LiveExporter:
    """Start (or return) the process's live exporter streaming to
    ``addr`` (``(host, port)`` or ``"host:port"``)."""
    global _exporter
    if isinstance(addr, str):
        h, _, p = addr.rpartition(":")
        addr = (h or "127.0.0.1", int(p))
    with _exporter_lock:
        if _exporter is not None:
            return _exporter
        exp = LiveExporter(addr=addr, rank=rank)
        _exporter = exp
    exp.start()
    atexit.register(stop_exporter)
    return exp


def start_carrier(rank: Optional[int] = None) -> LiveExporter:
    """Arm the exporter in carrier mode: no socket, no thread — the
    elastic member's heartbeat loop pulls :func:`heartbeat_frame`."""
    global _exporter
    with _exporter_lock:
        if _exporter is not None:
            return _exporter
        _flight.enable()
        exp = LiveExporter(carrier=True, rank=rank)
        _exporter = exp
    return exp


def stop_exporter() -> None:
    """Stop and discard the process exporter (sends the ``bye`` frame);
    safe to call repeatedly — also the atexit hook."""
    global _exporter
    with _exporter_lock:
        exp, _exporter = _exporter, None
    if exp is not None:
        exp.stop()


def heartbeat_frame() -> Optional[dict]:
    """The carrier-mode payload for the elastic heartbeat piggyback:
    one frame dict when carrier mode is armed, else None (the member's
    beat stays telemetry-free)."""
    exp = _exporter
    if exp is None or not exp.carrier:
        return None
    try:
        return exp.frame()
    except Exception:  # noqa: BLE001 - the heartbeat must never break
        return None


def _maybe_start_from_env() -> None:
    """Telemetry import-time hook (mirrors the watchdog's): the launcher
    exports ``TORCHMPI_TPU_TELEMETRY_LIVE=host:port`` (socket exporter)
    or ``TORCHMPI_TPU_TELEMETRY_LIVE_VIA=heartbeat`` (elastic
    piggyback)."""
    via = os.environ.get("TORCHMPI_TPU_TELEMETRY_LIVE_VIA", "")
    if via == "heartbeat":
        start_carrier()
        return
    addr = os.environ.get("TORCHMPI_TPU_TELEMETRY_LIVE", "")
    if addr and ":" in addr:
        try:
            start_exporter(addr)
        except (OSError, ValueError):
            pass


# ---------------------------------------------------------------------------
# fleet aggregation
# ---------------------------------------------------------------------------


class _RankView:
    __slots__ = (
        "rank", "pid", "last_time", "metrics", "seq_high_water",
        "entries", "flight_dropped", "flight_recorded", "spans",
        "resize_epoch", "closed", "frames", "expected_since",
        "clock_sync",
    )

    def __init__(self, rank: int):
        self.rank = rank
        self.pid = 0
        self.last_time = 0.0
        self.metrics: Dict[str, Any] = {}
        self.seq_high_water: Dict[str, int] = {}
        # comm -> OrderedDict(seq -> entry dict), bounded per comm
        self.entries: Dict[str, OrderedDict] = {}
        self.flight_dropped = 0
        self.flight_recorded = 0
        self.spans: Dict[str, Any] = {}
        self.resize_epoch = 0
        self.closed: Optional[str] = None  # None | "clean" | "dead"
        self.frames = 0
        # freshest per-frame clock triple (drift hardening): kept by
        # wall_time, so an out-of-order replay never regresses alignment
        self.clock_sync: Optional[dict] = None
        # the metrics generation the next delta must chain from; a
        # mismatch (dropped frame) keeps the old families until a full
        # snapshot restores coherence
        self.expected_since: Optional[int] = None


class FleetAggregator:
    """Rolling fleet view + incremental verdicts (module docstring).

    Construction starts nothing: :meth:`ingest` / :meth:`evaluate` are
    synchronous (the simulator's deterministic path). :meth:`serve`
    adds the ingest listener + HTTP scrape endpoints for real fleets."""

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 stale_after_s: Optional[float] = None,
                 mark_dir=None, hang_after_s: Optional[float] = None):
        self._clock = clock or time.time
        self._stale_after = stale_after_s
        # seconds an entry may sit `issued` before the hang verdict
        # fires; None falls back to the watchdog_timeout_seconds knob —
        # the launcher passes its --watchdog-timeout explicitly, since
        # that flag reaches the WORKERS via env, not this process's
        # constants table
        self._hang_after = hang_after_s
        self.mark_dir = Path(mark_dir) if mark_dir else None
        self._lock = _lockmon.make_lock("live.py:FleetAggregator._lock")
        self.ranks: Dict[int, _RankView] = {}
        self.samples = SampleStore()
        self.started_at = self._clock()
        self.verdict_history: List[dict] = []
        self._last_verdict: Optional[str] = None
        self.frames_total = 0
        self.incoherent_deltas = 0
        self._ingest_srv: Optional[socket.socket] = None
        self._http = None
        self._closed = False
        self.ingest_port: Optional[int] = None
        self.http_port: Optional[int] = None
        # an attached RecoverySupervisor (launch --supervise): its
        # journal serves on /actions and its tm_supervisor_* lines ride
        # the /metrics passthrough
        self.supervisor = None
        # load-verdict trend state (serving tier): the previous window's
        # fleet counter totals + ps_health servers dict, advanced at
        # most once per live interval — /verdicts scrapes between ticks
        # reuse the stored sample instead of corrupting the window
        self._load_prev: Optional[dict] = None
        self._load_sample: Optional[dict] = None
        # per-listener BUSY-rate baseline (every fleet, serving or not):
        # the previous ps_health servers dict + its evaluation time,
        # from which ps_health derives busy_rate_per_s, and the per-rank
        # rate rollup the /health rows and `top` display
        self._ps_rate_prev: Optional[dict] = None
        self._busy_rates: Dict[str, float] = {}

    def attach_supervisor(self, supervisor) -> None:
        """Expose a recovery supervisor (a
        :class:`~torchmpi_tpu_torch.supervise.RecoverySupervisor`, or any
        object with its ``actions_doc`` and ``prometheus_lines``) on the
        scrape surface (``/actions`` + ``tm_supervisor_*`` metrics).
        The supervisor's observe loop stays outside: whoever owns the
        cadence (launcher thread, simulator tick) feeds it verdicts."""
        self.supervisor = supervisor

    def mark_evicted(self, rank: int) -> None:
        """A deliberate eviction (supervisor or operator): drop the
        rank's view so the fleet verdicts stop charging the job with a
        corpse it already buried — an evicted member is OUT of the job,
        not a dead rank forever. A rejoining member re-creates the view
        with its next frame. Clears the dead-rank marker too (the
        watchdogs must not keep attributing 'peer dead' to a member the
        membership already dropped)."""
        with self._lock:
            self.ranks.pop(rank, None)
            # re-baseline the load window: the popped view's counters
            # vanish from the fleet totals, and a clamped-to-zero delta
            # would read as a traffic collapse (phantom underload)
            self._load_prev = None
            self._load_sample = None
        self._clear_dead_marker(rank)

    # -- ingestion ---------------------------------------------------------
    def ingest(self, frame: dict) -> None:
        """Apply one exporter frame (any transport: socket, heartbeat
        piggyback, simulator)."""
        kind = frame.get("kind")
        rank = int(frame.get("rank", -1))
        revived = False
        with self._lock:
            rv = self.ranks.get(rank)
            if rv is None:
                rv = self.ranks[rank] = _RankView(rank)
            if kind == "bye":
                rv.closed = "clean"
                rv.last_time = float(frame.get("time", rv.last_time))
                return
            revived = rv.closed == "dead"
            rv.closed = None  # a live frame revives a flapping stream
            rv.frames += 1
            self.frames_total += 1
            rv.pid = int(frame.get("pid", rv.pid))
            rv.last_time = float(frame.get("time", 0.0))
            rv.resize_epoch = int(frame.get("resize_epoch", rv.resize_epoch))
            rv.flight_dropped = int(frame.get("flight_dropped", 0))
            rv.flight_recorded = int(frame.get("flight_recorded", 0))
            rv.spans = frame.get("spans", rv.spans)
            met = frame.get("metrics")
            if isinstance(met, dict):
                if kind == "delta" and "families" in met:
                    if rv.expected_since is not None and (
                        met.get("since") != rv.expected_since
                    ):
                        # a frame was lost between this delta and the
                        # last applied one: merge what arrived (counters
                        # and high-waters are absolute values, never
                        # increments) but count the incoherence — the
                        # exporter sends a full frame after any failed
                        # send, which restores the chain
                        self.incoherent_deltas += 1
                    rv.metrics.update(met.get("families") or {})
                    rv.metrics.update(met.get("collectors") or {})
                    rv.expected_since = met.get("generation")
                else:
                    rv.metrics = dict(met)
                    rv.expected_since = frame.get("metrics_generation")
            cs = frame.get("clock_sync")
            if isinstance(cs, dict):
                prev_wall = (rv.clock_sync or {}).get("wall_time", 0.0)
                if float(cs.get("wall_time", 0.0)) >= float(prev_wall):
                    rv.clock_sync = cs
            for comm, seq in (frame.get("seq_high_water") or {}).items():
                rv.seq_high_water[comm] = int(seq)
            for e in frame.get("flight_tail") or []:
                self._merge_entry(rv, e)
        if revived:
            # a transient disconnect must not leave its dead-rank marker
            # behind: a LATER stale heartbeat would otherwise read as
            # "peer dead" to the watchdogs forever — the exact
            # misattribution this marker exists to prevent
            self._clear_dead_marker(rank)

    def _merge_entry(self, rv: _RankView, e: dict) -> None:
        comm = e.get("comm")
        if comm is None or "seq" not in e:
            return
        book = rv.entries.get(comm)
        if book is None:
            book = rv.entries[comm] = OrderedDict()
        seq = int(e["seq"])
        prev = book.get(seq)
        if prev is not None and prev.get("_sampled"):
            return  # already complete and sampled; tails re-ship context
        book[seq] = e
        book.move_to_end(seq)
        while len(book) > MAX_ENTRIES_PER_COMM:
            book.popitem(last=False)
        if e.get("status") == "completed" and self.samples.add_entry(e):
            e["_sampled"] = True

    # -- the analyzer-compatible view ---------------------------------------
    def _pseudo_ranks(self) -> Dict[int, dict]:
        """The aggregated state in the exact shape the analyzer's detectors
        consume, so desync/straggler/PS-health/resize run INCREMENTALLY
        over the rolling window with zero detector changes."""
        out = {}
        for rank, rv in self.ranks.items():
            entries = [
                e for book in rv.entries.values() for e in book.values()
            ]
            out[rank] = {
                "restart": 0,
                "snapshot": {
                    # copy: the detectors iterate this dict AFTER the
                    # lock is released, while delta ingest may insert
                    # new families into the original
                    "metrics": dict(rv.metrics),
                    "flight_recorder": {
                        "entries": entries,
                        "seq_high_water": dict(rv.seq_high_water),
                        "dropped": rv.flight_dropped,
                    },
                    "spans": rv.spans,
                    "clock_sync": rv.clock_sync,
                },
                "trace_events": [],
            }
        return out

    # -- verdicts ----------------------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> dict:
        """Run the detectors over the current rolling view and return
        the streaming verdict document. Appends to
        :attr:`verdict_history` when the primary verdict changes."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            ranks = self._pseudo_ranks()
            rank_meta = {
                r: (rv.last_time, rv.closed, rv.frames)
                for r, rv in self.ranks.items()
            }
        desync = detect_desync(ranks)
        stragglers = rank_stragglers(ranks)
        interval = float(constants.get("telemetry_live_interval_s"))
        with self._lock:
            rate_prev = self._ps_rate_prev
        ps = ps_health(
            ranks,
            prev=rate_prev["servers"] if rate_prev else None,
            interval_s=(now - rate_prev["t"])
            if rate_prev and now > rate_prev["t"] else None,
        )
        if rate_prev is None or (now - rate_prev["t"]) >= 0.5 * interval:
            with self._lock:
                self._ps_rate_prev = {
                    "t": now, "servers": ps.get("servers", {}),
                }
                self._busy_rates = {
                    r: round(
                        sum((e.get("busy_rate_per_s") or {}).values()), 3
                    )
                    for r, e in ps.get("servers", {}).items()
                    if e.get("busy_rate_per_s")
                }
        load = self._load_trends(ranks, now)
        resize = analyze_resizes(
            {"ranks": ranks, "heartbeats": {
                str(r): {"time": t} for r, (t, _, _) in rank_meta.items()
            }}
        )
        stale_after = self._stale_after
        if stale_after is None:
            stale_after = 3.0 * float(
                constants.get("telemetry_live_interval_s")
            )
        dead = sorted(
            r for r, (t, closed, frames) in rank_meta.items()
            if closed == "dead"
            or (closed != "clean" and frames and now - t > stale_after)
        )
        wd = (
            self._hang_after if self._hang_after is not None
            else float(constants.get("watchdog_timeout_seconds"))
        )
        stuck = []
        if wd > 0:
            for r, data in ranks.items():
                if r in dead:
                    continue  # a dead stream's tail is frozen evidence,
                    # not a live in-flight wait
                for e in data["snapshot"]["flight_recorder"]["entries"]:
                    if (
                        e.get("status") == _flight.STATUS_ISSUED
                        and now - float(e.get("t_issue", now)) > wd
                    ):
                        stuck.append({
                            "rank": r,
                            **{k: e.get(k) for k in (
                                "comm", "seq", "op", "payload", "t_issue",
                            )},
                        })
        stuck.sort(key=lambda s: (s["rank"], s["comm"], s["seq"]))
        resize_failed = sorted({
            r for r, data in ranks.items()
            for e in data["snapshot"]["flight_recorder"]["entries"]
            if e.get("comm") == "resize" and e.get("status") == "failed"
        })

        present = {
            "desync": desync["status"] != "none",
            "resize-torn": bool(resize_failed),
            "hang": bool(stuck),
            "rank-dead": bool(dead),
            "resize-incomplete": resize.get("status") == "incomplete",
            "straggler": bool(stragglers.get("significant")),
            "overload": bool(load and load.get("overload")),
            "ps-overload": self._ps_overloaded(ps),
            "underload": bool(load and load.get("underload")),
        }
        verdict = next(
            (v for v in VERDICT_PRIORITY if present[v]), "clean"
        )
        doc = {
            "time": round(now, 6),
            "verdict": verdict,
            "findings": sorted(v for v, p in present.items() if p),
            "ranks": sorted(ranks),
            "dead_ranks": dead,
            "stuck": stuck,
            "resize_failed_ranks": resize_failed,
            "desync": desync,
            "stragglers": stragglers,
            "resize": resize,
            "ps": ps,
            "load": load,
            "summary": self._summary(
                verdict, desync, stragglers, dead, stuck, resize, load,
            ),
        }
        with self._lock:
            if verdict != self._last_verdict:
                self._last_verdict = verdict
                self.verdict_history.append(
                    {"time": round(now, 6), "verdict": verdict}
                )
        return doc

    @staticmethod
    def _ps_overloaded(ps: dict) -> bool:
        # mirrors sim.faults.verdict_of: BUSY rejections under a
        # queue-dominated (or unattributed) server
        for srv in ps.get("servers", {}).values():
            conns = srv.get("connections") or {}
            if conns.get("busy_rejected"):
                dominant = {
                    a.get("dominant")
                    for a in (srv.get("server_time") or {}).values()
                }
                if "queue" in dominant or not dominant:
                    return True
        return False

    # -- load verdicts (serving tier) ----------------------------------
    @staticmethod
    def _load_totals(ranks: Dict[int, dict]) -> Optional[dict]:
        """Fleet-wide serving-tier counter totals, or None when no rank
        reports a ``tm_serve_*`` family — fleets without a serving tier
        never see load verdicts (training-only jobs keep their verdicts
        bit for bit)."""
        tot = {"requests": 0.0, "shed": 0.0, "breaches": 0.0,
               "busy": 0.0, "queue": 0.0, "serve_ranks": 0}
        present = False
        for data in ranks.values():
            met = data["snapshot"].get("metrics", {})
            fam = met.get("tm_serve_requests_total")
            if isinstance(fam, dict):
                present = True
                tot["serve_ranks"] += 1
                for label, v in (fam.get("series") or {}).items():
                    if "shed" in label:
                        tot["shed"] += v
                    else:
                        tot["requests"] += v
            for name, key in (
                ("tm_serve_slo_breaches_total", "breaches"),
                ("tm_ps_busy_rejected_total", "busy"),
                ("tm_serve_queue_depth", "queue"),
            ):
                series = (met.get(name) or {}).get("series")
                if series:
                    tot[key] += sum(series.values())
        return tot if present else None

    def _load_trends(self, ranks: Dict[int, dict],
                     now: float) -> Optional[dict]:
        """Incremental load sample over the live window: SLO-burn rate,
        BUSY/shed-rate trend, queue-growth trend, per-rank QPS — the
        three signals the scale-up/scale-down rungs act on, computed
        from the frames the aggregator already receives (no new wire
        traffic). The window advances at most once per live interval;
        calls between ticks (HTTP scrapes hit :meth:`evaluate` too)
        return the stored sample unchanged."""
        tot = self._load_totals(ranks)
        interval = float(constants.get("telemetry_live_interval_s"))
        with self._lock:
            prev = self._load_prev
            sample = self._load_sample
            if tot is None:
                self._load_prev = None
                self._load_sample = None
                return None
            if prev is not None and (now - prev["t"]) < 0.5 * interval:
                return sample
            if prev is None:
                self._load_prev = {"t": now, **tot}
                return sample
            dt = now - prev["t"]
            n = max(1, tot["serve_ranks"])
            # counter deltas clamp at zero: a restarted rank's counters
            # reset, and a negative delta is noise, not negative load
            served = max(0.0, tot["requests"] - prev["requests"])
            shed = max(0.0, tot["shed"] - prev["shed"])
            breaches = max(0.0, tot["breaches"] - prev["breaches"])
            busy = max(0.0, tot["busy"] - prev["busy"])
            qgrow = (tot["queue"] - prev["queue"]) / dt / n
            qps = (served + shed) / dt / n
            burn = breaches / served if served else 0.0
            # shed replies count into the reject-rate trend: brownout
            # shedding IS the serving tier reporting overload
            busy_rate = (busy + shed) / dt / n
            overload = (
                burn > float(constants.get("serve_slo_burn_threshold"))
                or busy_rate > float(
                    constants.get("serve_overload_busy_rate")
                )
                or qgrow > float(
                    constants.get("serve_queue_growth_per_s")
                )
            )
            underload = (
                not overload
                and breaches == 0 and busy == 0 and shed == 0
                and qgrow <= 0
                and qps < float(constants.get("serve_underload_qps"))
            )
            sample = {
                "window_s": round(dt, 6),
                "serve_ranks": tot["serve_ranks"],
                "qps_per_rank": round(qps, 3),
                "slo_burn": round(burn, 4),
                "busy_rate_per_s": round(busy_rate, 3),
                "queue_growth_per_s": round(qgrow, 3),
                "shed_per_s": round(shed / dt / n, 3),
                "overload": overload,
                "underload": underload,
            }
            self._load_sample = sample
            self._load_prev = {"t": now, **tot}
            return sample

    @staticmethod
    def _summary(verdict, desync, stragglers, dead, stuck, resize,
                 load=None) -> List[str]:
        lines = [f"verdict: {verdict}"]
        div = desync.get("first_divergence")
        if div is None:
            lines.append("desync: none")
        else:
            ops = ", ".join(
                f"rank {r}={op}" for r, op in sorted(div["ops"].items())
            )
            lines.append(
                f"desync: comm={div['comm']} first divergent "
                f"seq={div['seq']} ({ops or 'missing on ' + str(div['ranks_missing_seq'])})"
            )
        if stragglers.get("significant"):
            w = stragglers["ranking"][0]
            lines.append(
                f"straggler: rank {w['rank']} "
                f"(mean lag {w['mean_lag_ms']}ms)"
            )
        else:
            lines.append("straggler: none")
        if dead:
            lines.append(f"dead/stale ranks: {dead}")
        if stuck:
            s = stuck[0]
            lines.append(
                f"hang: {len(stuck)} in-flight past the watchdog timeout "
                f"(first: rank {s['rank']} {s['op']} comm={s['comm']} "
                f"seq={s['seq']})"
            )
        bad = {
            ep: info for ep, info in resize.get("epochs", {}).items()
            if info.get("never_entered") or info.get("failed")
        }
        for ep, info in sorted(bad.items(), key=lambda kv: int(kv[0])):
            detail = []
            if info.get("never_entered"):
                detail.append(f"never entered by {info['never_entered']}")
            if info.get("failed"):
                detail.append(f"failed on {info['failed']}")
            lines.append(f"resize: epoch {ep} " + "; ".join(detail))
        if load is not None:
            lines.append(
                f"load: {load['qps_per_rank']}/s/rank "
                f"burn={load['slo_burn']} "
                f"busy/s={load['busy_rate_per_s']} "
                f"queue{'+' if load['queue_growth_per_s'] >= 0 else ''}"
                f"{load['queue_growth_per_s']}/s"
            )
        return lines

    # -- health / prometheus ------------------------------------------------
    def _rank_snapshots(self) -> List[dict]:
        """Copies of the mutable per-rank fields, taken under the lock:
        scrape rendering must never iterate a dict the ingest thread is
        growing mid-frame (RuntimeError and an HTTP 500 on a healthy
        fleet). Family snapshot dicts are replaced wholesale on ingest
        — never mutated in place — so a shallow copy is a stable view."""
        with self._lock:
            return [
                {
                    "rank": rv.rank,
                    "last_time": rv.last_time,
                    "closed": rv.closed,
                    "frames": rv.frames,
                    "resize_epoch": rv.resize_epoch,
                    "spans": dict(rv.spans or {}),
                    "seq_high_water": dict(rv.seq_high_water),
                    "metrics": dict(rv.metrics),
                }
                for rv in sorted(
                    self.ranks.values(), key=lambda v: v.rank
                )
            ]

    def health(self, now: Optional[float] = None) -> dict:
        """Per-rank liveness + the ``top`` CLI's row data."""
        now = self._clock() if now is None else float(now)
        views = self._rank_snapshots()
        with self._lock:
            frames_total = self.frames_total
            incoherent = self.incoherent_deltas
            pranks = self._pseudo_ranks()
        cp = _criticalpath.critical_path(pranks)
        fleet_hw: Dict[str, int] = {}
        rows = {}
        for rv in views:
            for comm, seq in rv["seq_high_water"].items():
                fleet_hw[comm] = max(fleet_hw.get(comm, -1), seq)
        for rv in views:
            rank = rv["rank"]
            lag = max(
                (
                    fleet_hw[c] - s
                    for c, s in rv["seq_high_water"].items()
                    if c in fleet_hw
                ),
                default=0,
            )
            step = (
                rv["metrics"].get("tm_engine_step_seconds", {})
                .get("series", {})
            )
            step_p50_ms = None
            for h in step.values():
                q = (h.get("quantiles") or {}).get("0.5")
                if q is not None:
                    step_p50_ms = round(float(q) * 1e3, 3)
                break
            busy = sum(
                (rv["metrics"].get("tm_ps_busy_rejected_total", {})
                 .get("series", {}) or {}).values()
            )
            dominant = None
            att = (
                ps_health({rank: {"snapshot": {"metrics": rv["metrics"]}}})
                .get("servers", {}).get(str(rank), {})
                .get("server_time") or {}
            )
            for a in att.values():
                dominant = a.get("dominant")
                break
            rows[str(rank)] = {
                "age_s": round(max(0.0, now - rv["last_time"]), 3),
                "closed": rv["closed"],
                "frames": rv["frames"],
                "seq_high_water": rv["seq_high_water"],
                "seq_lag": lag,
                "step_p50_ms": step_p50_ms,
                "busy_rejected": busy,
                # rolling per-window rate (summed over this rank's
                # listeners), captured by the last evaluate(): the trend
                # `top` and the load verdict key on, vs the integral
                "busy_rate_per_s": self._busy_rates.get(str(rank)),
                "resize_epoch": rv["resize_epoch"],
                "ps_dominant": dominant,
                # dominant critical-path term over the rolling window
                # (the `top` cp_term column); compute-only windows show
                # "compute"
                "cp_dominant": cp["ranks"].get(str(rank), {}).get(
                    "dominant"
                ),
                "spans_dropped": rv["spans"].get("dropped", 0),
            }
        return {
            "time": round(now, 6),
            "ranks": rows,
            "fleet_seq_high_water": fleet_hw,
            "frames_total": frames_total,
            "incoherent_deltas": incoherent,
            "samples": len(self.samples),
        }

    def criticalpath(self, now: Optional[float] = None) -> dict:
        """Live critical-path attribution over the rolling entry window
        (the ``/criticalpath`` endpoint): the same causal-DAG analysis
        the offline analyzer runs on full dumps, here incremental over
        the streamed flight tails — per-rank buckets, cross-rank
        dominance, the measured overlap ledger, serve hop split."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            pranks = self._pseudo_ranks()
        return {
            "time": round(now, 6),
            "critical_path": _criticalpath.critical_path(pranks),
            "overlap": _criticalpath.overlap_ledger(pranks),
            "serve_hops": _criticalpath.serve_hops(pranks),
        }

    def prometheus(self, now: Optional[float] = None) -> str:
        """Fleet-level Prometheus text: aggregator gauges + every rank's
        families re-rendered with a ``rank`` label."""
        now = self._clock() if now is None else float(now)
        views = self._rank_snapshots()
        out: List[str] = [
            "# HELP tm_fleet_ranks ranks currently known to the live "
            "aggregator",
            "# TYPE tm_fleet_ranks gauge",
            f"tm_fleet_ranks {len(views)}",
            "# HELP tm_fleet_seq_high_water last flight-recorder seq per "
            "rank and communicator",
            "# TYPE tm_fleet_seq_high_water gauge",
        ]
        for rv in views:
            for comm, seq in sorted(rv["seq_high_water"].items()):
                out.append(
                    f'tm_fleet_seq_high_water{{rank="{rv["rank"]}",'
                    f'comm="{comm}"}} {seq}'
                )
        out.append(
            "# HELP tm_fleet_rank_report_age_seconds seconds since each "
            "rank's last frame"
        )
        out.append("# TYPE tm_fleet_rank_report_age_seconds gauge")
        for rv in views:
            out.append(
                f'tm_fleet_rank_report_age_seconds{{rank="{rv["rank"]}"}} '
                f"{max(0.0, round(now - rv['last_time'], 3))}"
            )
        # critical-path + trace-context families over the rolling window
        with self._lock:
            pranks = self._pseudo_ranks()
        cp = _criticalpath.critical_path(pranks)
        out.append(
            "# HELP tm_criticalpath_bucket_us per-rank wall-time "
            "critical-path attribution over the rolling window, by bucket"
        )
        out.append("# TYPE tm_criticalpath_bucket_us gauge")
        for r, row in sorted(
            cp["ranks"].items(), key=lambda kv: int(kv[0])
        ):
            for b, us in sorted(row["buckets_us"].items()):
                out.append(
                    f'tm_criticalpath_bucket_us{{rank="{r}",'
                    f'bucket="{b}"}} {us}'
                )
        out.append(
            "# HELP tm_criticalpath_dominance_us fleet wait each rank's "
            "lateness caused (critical-path straggler dominance)"
        )
        out.append("# TYPE tm_criticalpath_dominance_us gauge")
        for r, us in sorted(
            cp.get("dominance_us", {}).items(), key=lambda kv: int(kv[0])
        ):
            out.append(f'tm_criticalpath_dominance_us{{rank="{r}"}} {us}')
        out.append(
            "# HELP tm_trace_stamped_entries flight entries in the "
            "rolling window carrying a causal trace context"
        )
        out.append("# TYPE tm_trace_stamped_entries gauge")
        for r in sorted(pranks):
            stamped = sum(
                1 for e in pranks[r]["snapshot"]["flight_recorder"][
                    "entries"
                ] if e.get("trace")
            )
            out.append(f'tm_trace_stamped_entries{{rank="{r}"}} {stamped}')
        flows = _criticalpath.flow_events(
            pranks,
            max_flows=int(constants.get("trace_max_flow_events")),
        )
        out.append(
            "# HELP tm_trace_flow_events cross-rank causal flow arrows "
            "derivable from the rolling window"
        )
        out.append("# TYPE tm_trace_flow_events gauge")
        out.append(
            "tm_trace_flow_events "
            f"{sum(1 for ev in flows if ev['ph'] == 's')}"
        )
        sup = self.supervisor
        if sup is not None:
            out.extend(sup.prometheus_lines())
        # per-rank family passthrough, rank-labelled
        typed: Dict[str, str] = {}
        lines: List[str] = []
        for rv in views:
            for name, fam in sorted(rv["metrics"].items()):
                if not isinstance(fam, dict) or "kind" not in fam:
                    continue  # collector payloads are JSON-only
                kind = fam["kind"]
                if name not in typed:
                    typed[name] = kind
                    if fam.get("help"):
                        lines.append(f"# HELP {name} {fam['help']}")
                    lines.append(f"# TYPE {name} {kind}")
                for label_str, val in sorted(
                    (fam.get("series") or {}).items()
                ):
                    base = f'rank="{rv["rank"]}"'
                    if label_str:
                        base += "," + ",".join(
                            f'{p.split("=", 1)[0]}="{p.split("=", 1)[1]}"'
                            for p in label_str.split(",") if "=" in p
                        )
                    if kind == "histogram" and isinstance(val, dict):
                        cum = 0
                        for b, c in (val.get("buckets") or {}).items():
                            if b == "+Inf":
                                continue
                            cum += c
                            lines.append(
                                f'{name}_bucket{{{base},le="{b}"}} {cum}'
                            )
                        lines.append(
                            f'{name}_bucket{{{base},le="+Inf"}} '
                            f"{val.get('count', 0)}"
                        )
                        lines.append(
                            f"{name}_sum{{{base}}} {val.get('sum', 0)}"
                        )
                        lines.append(
                            f"{name}_count{{{base}}} {val.get('count', 0)}"
                        )
                    else:
                        lines.append(f"{name}{{{base}}} {val}")
        return "\n".join(out + lines) + "\n"

    # -- serving -----------------------------------------------------------
    def serve(self, host: str = "127.0.0.1", ingest_port: int = 0,
              http_port: int = 0) -> None:
        """Start the ingest listener and the HTTP scrape endpoint."""
        self._ingest_srv = socket.socket()
        self._ingest_srv.setsockopt(
            socket.SOL_SOCKET, socket.SO_REUSEADDR, 1
        )
        self._ingest_srv.bind((host, ingest_port))
        self._ingest_srv.listen(64)
        self.ingest_port = self._ingest_srv.getsockname()[1]
        threading.Thread(
            target=self._accept_loop, name="tm-live-ingest", daemon=True
        ).start()
        self._serve_http(host, http_port)

    def _serve_http(self, host: str, port: int) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        agg = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: A003 - quiet
                pass

            def do_GET(self):  # noqa: N802 - http.server API
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        body = agg.prometheus().encode()
                        ctype = "text/plain; version=0.0.4"
                    elif path == "/health":
                        body = json.dumps(
                            agg.health(), indent=1, sort_keys=True,
                            default=str,
                        ).encode()
                        ctype = "application/json"
                    elif path == "/verdicts":
                        doc = agg.evaluate()
                        doc["history"] = agg.verdict_history
                        body = json.dumps(
                            doc, indent=1, sort_keys=True, default=str
                        ).encode()
                        ctype = "application/json"
                    elif path == "/criticalpath":
                        body = json.dumps(
                            agg.criticalpath(), indent=1,
                            sort_keys=True, default=str,
                        ).encode()
                        ctype = "application/json"
                    elif path == "/calibration":
                        body = agg.calibration_json().encode()
                        ctype = "application/json"
                    elif path == "/actions":
                        sup = agg.supervisor
                        if sup is None:
                            self.send_error(
                                404, "no supervisor attached"
                            )
                            return
                        body = json.dumps(
                            sup.actions_doc(), indent=1, sort_keys=True,
                            default=str,
                        ).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception as e:  # noqa: BLE001 - a scrape must
                    # never kill the plane
                    self.send_error(500, str(e))
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._http = ThreadingHTTPServer((host, port), Handler)
        self._http.daemon_threads = True
        self.http_port = self._http.server_address[1]
        threading.Thread(
            target=self._http.serve_forever, name="tm-live-http",
            daemon=True,
        ).start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._ingest_srv.accept()
            except OSError:
                return
            threading.Thread(
                target=self._reader, args=(conn,), daemon=True
            ).start()

    def _reader(self, conn: socket.socket) -> None:
        rank: Optional[int] = None
        clean = False
        try:
            with conn:
                conn.settimeout(600)
                while not self._closed:
                    frame = _recv_frame(conn)
                    rank = int(frame.get("rank", -1))
                    self.ingest(frame)
                    if frame.get("kind") == "bye":
                        clean = True
                        return
        except (ConnectionError, OSError, ValueError, struct.error):
            pass
        finally:
            if rank is not None and not clean and not self._closed:
                self._mark_dead(rank)

    def _mark_dead(self, rank: int) -> None:
        """A stream closed without a ``bye``: the live plane's dead-rank
        flag. Records it and drops the ``dead_rank_<r>.json`` marker the
        hang watchdog composes with ("peer dead", not "stale
        heartbeat")."""
        with self._lock:
            rv = self.ranks.get(rank)
            if rv is None or rv.closed == "clean":
                return
            rv.closed = "dead"
        if self.mark_dir is not None:
            try:
                self.mark_dir.mkdir(parents=True, exist_ok=True)
                path = self.mark_dir / f"dead_rank_{rank}.json"
                tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
                tmp.write_text(json.dumps({
                    "rank": rank,
                    "time": self._clock(),
                    "reason": "live telemetry stream closed without bye",
                }))
                os.replace(tmp, path)
            except OSError:
                pass

    def _clear_dead_marker(self, rank: int) -> None:
        if self.mark_dir is None:
            return
        try:
            (self.mark_dir / f"dead_rank_{rank}.json").unlink()
        except OSError:
            pass

    def calibration_json(self) -> str:
        """The sample store serialized under the aggregator lock —
        ingest mutates it under the same lock, so a scrape can never
        catch a dict mid-insert."""
        with self._lock:
            return json.dumps(
                self.samples.to_json(), indent=1, sort_keys=True
            )

    def save_samples(self, path) -> Path:
        """Persist the calibration sample store (the launcher does this
        at teardown; ``schedule.calibrate(path)`` fits from it).
        Serialized under the lock: a straggling reader thread may still
        be ingesting."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
        tmp.write_text(self.calibration_json())
        os.replace(tmp, path)
        return path

    def close(self) -> None:
        self._closed = True
        if self._ingest_srv is not None:
            try:
                self._ingest_srv.close()
            except OSError:
                pass
        if self._http is not None:
            try:
                self._http.shutdown()
                self._http.server_close()
            except OSError:
                pass
