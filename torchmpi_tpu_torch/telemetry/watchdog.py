"""Hang watchdog: a daemon thread + per-rank heartbeat files.

The reference's only runtime failure detector was a 10s spin-acquire abort
(``resources.cpp:124-133``); a hung collective or parameter-server RPC
otherwise meant a silent wedge and a manual ``pkill``. This watchdog turns
a wedge into evidence:

- every ``interval`` seconds the thread writes this rank's **heartbeat
  file** (``heartbeat_rank_<r>.json``: wall time, pid, flight-recorder seq
  high-water, in-flight count) into the telemetry dir, and samples the PS
  listener queue depth into a bounded timeline (exported with every
  snapshot — the "queue depth over time" series the analyzer plots);
- when any flight-recorder entry stays ``issued`` past ``timeout``
  seconds, or a **peer's** heartbeat goes stale past the same bound, it
  dumps a structured **hang report** (``hang_rank_<r>.json``: the stuck
  entries, the full flight recorder, metrics snapshot, span trace events,
  and every thread's stack) plus the regular per-rank telemetry dump — so
  the evidence survives even when the launcher then kills the job.

One report per (reason) per process; the watchdog never kills anything
itself (``TORCHMPI_TPU_WATCHDOG_ABORT=1`` opts into SIGABRT after the
dump for jobs that would otherwise hang forever).

The port of ``torchmpi_tpu/telemetry/watchdog.py``. Wiring: ``start()``
starts it when the ``watchdog_timeout_seconds`` constant is set (and
``stop()`` stops it); ``TORCHMPI_TPU_WATCHDOG=N`` in the environment (what
the JAX launcher's ``--watchdog-timeout N`` sets in every rank) starts it
at telemetry import, heartbeat dir the directory of
``TORCHMPI_TPU_TELEMETRY_DUMP``. The port's async waits block on the
device while the flight recorder is on (``runtime/handles.py``), so a
wedged wait stays ``issued`` and is flagged. Stdlib-only.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from collections import deque
from pathlib import Path
from typing import Optional

from . import flightrecorder as _flight
from ..analysis import lockmon as _lockmon


def _env_rank() -> Optional[int]:
    try:
        return int(os.environ["TORCHMPI_TPU_PROCESS_ID"])
    except (KeyError, ValueError):
        return None


def _thread_stacks() -> dict:
    """Every live thread's stack, by name — the py-spy view of a wedge."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        label = f"{names.get(ident, 'unknown')} (tid {ident})"
        out[label] = traceback.format_stack(frame)
    return out


class Watchdog:
    """One per process; obtain via :func:`start_watchdog`."""

    def __init__(self, timeout: float, interval: Optional[float] = None,
                 heartbeat_dir=None, rank: Optional[int] = None,
                 abort: bool = False):
        self.timeout = float(timeout)
        self.interval = float(
            interval if interval is not None
            else max(0.1, min(1.0, self.timeout / 4))
        )
        self.dir = Path(heartbeat_dir) if heartbeat_dir else None
        self.rank = rank if rank is not None else _env_rank()
        self.abort = abort
        self.queue_timeline: deque = deque(maxlen=512)
        self._fired: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started_at = 0.0
        #: who armed it: "env" (launcher, process-lived) or "constants"
        #: (start()-scoped, stopped by stop())
        self.source = "constants"
        self.hang_reports: list = []  # paths written, for introspection

    # ------------------------------------------------------------------
    @property
    def _rank_tag(self) -> str:
        return str(self.rank) if self.rank is not None else f"pid{os.getpid()}"

    def heartbeat_path(self) -> Optional[Path]:
        if self.dir is None:
            return None
        return self.dir / f"heartbeat_rank_{self._rank_tag}.json"

    def hang_path(self) -> Path:
        name = f"hang_rank_{self._rank_tag}.json"
        return (self.dir / name) if self.dir is not None else Path(name)

    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        # the watchdog's hang predicate IS the flight recorder: arming one
        # without the other would be a silent no-op, so force the recorder
        # on (cheap — bench gates its dispatch overhead under 2%)
        _flight.enable()
        self._started_at = time.time()
        if self.dir is not None:
            try:
                self.dir.mkdir(parents=True, exist_ok=True)
            except OSError:
                self.dir = None
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="torchmpi-tpu-torch-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.interval + 2)
        self._thread = None
        # retract the heartbeat: a cleanly-stopped rank (mpi.stop()) must
        # not read as a stale peer to watchdogs still running elsewhere
        path = self.heartbeat_path()
        if path is not None:
            try:
                path.unlink()
            except OSError:
                pass

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.beat()
                self.check()
            except Exception:  # noqa: BLE001 - the watchdog must outlive
                pass           # any single broken probe

    # ------------------------------------------------------------------
    def beat(self) -> None:
        """Write this rank's heartbeat + sample the PS listener queue."""
        self._sample_queue_depth()
        path = self.heartbeat_path()
        if path is None:
            return
        rec = _flight.recorder
        beat = {
            "rank": self.rank,
            "pid": os.getpid(),
            "time": time.time(),
            "seq_high_water": rec.seq_high_water(),
            "in_flight": rec.in_flight_count(),
        }
        tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
        tmp.write_text(json.dumps(beat))
        os.replace(tmp, path)

    def _sample_queue_depth(self) -> None:
        from . import metrics

        fn = metrics._collectors.get("ps_listener")
        if fn is None:
            return
        try:
            stats = fn()
        except Exception:  # noqa: BLE001
            return
        depth = stats.get("queue_depth")
        if depth is not None:
            self.queue_timeline.append(
                {"time": time.time(), "queue_depth": depth}
            )

    def queue_timeline_snapshot(self) -> list:
        return list(self.queue_timeline)

    # ------------------------------------------------------------------
    def check(self) -> None:
        stuck = _flight.recorder.in_flight(older_than=self.timeout)
        if stuck:
            self.fire("in_flight_timeout", {"stuck": stuck})
        stale = self._stale_peers()
        if stale:
            # compose with the live telemetry plane: a peer whose live
            # stream already closed without a bye (the aggregator's
            # dead_rank_<r>.json marker) is DEAD, not merely late with a
            # heartbeat — attribute it as such so the hang report names
            # the real condition
            dead = [b for b in stale if self._live_marked_dead(b)]
            plain = [b for b in stale if b not in dead]
            if dead:
                self.fire("peer_dead", {"peers": dead})
            if plain:
                self.fire("peer_heartbeat_stale", {"peers": plain})

    def _live_marked_dead(self, beat: dict) -> bool:
        if self.dir is None:
            return False
        rank = beat.get("rank")
        tag = str(rank) if rank is not None else f"pid{beat.get('pid')}"
        return (self.dir / f"dead_rank_{tag}.json").exists()

    def _stale_peers(self) -> list:
        if self.dir is None:
            return []
        own = self.heartbeat_path()
        now = time.time()
        out = []
        for path in sorted(self.dir.glob("heartbeat_rank_*.json")):
            if own is not None and path.name == own.name:
                continue
            try:
                beat = json.loads(path.read_text())
                t = float(beat.get("time", 0))
            except (OSError, ValueError):
                continue
            if t < self._started_at:
                # leftover from a previous run/incarnation in a reused
                # dir (a SIGKILL'd rank never retracts its file): only a
                # beat observed ALIVE during this watchdog's lifetime can
                # be judged stale
                continue
            age = now - t
            # grace of one interval: a peer mid-write is not a hang
            if age > self.timeout + self.interval:
                beat["stale_seconds"] = age
                out.append(beat)
        return out

    def fire(self, reason: str, detail: dict) -> Optional[Path]:
        """Dump the hang report once per reason; returns its path."""
        if reason in self._fired:
            return None
        self._fired.add(reason)
        report = {
            "reason": reason,
            "rank": self.rank,
            "pid": os.getpid(),
            "time": time.time(),
            "watchdog_timeout_seconds": self.timeout,
            "detail": detail,
            "threads": _thread_stacks(),
            "flight_recorder": _flight.recorder.snapshot(),
        }
        # metrics/spans best-effort: the report must land even if a
        # collector wedges (it runs in THIS thread, not the hung one)
        from . import metrics, snapshot as _tel_snapshot, trace_events

        try:
            tel = _tel_snapshot()
            # the flight ring is already the report's top-level key; a
            # second serialized copy would double the dump size at the
            # worst possible moment (a wedged process)
            tel.pop("flight_recorder", None)
            report["telemetry"] = tel
            report["trace_events"] = trace_events()
        except Exception as e:  # noqa: BLE001
            report["telemetry_error"] = f"{type(e).__name__}: {e}"
        path = self.hang_path()
        if self.hang_reports:
            # one file per distinct reason: a second diagnosis (e.g.
            # peer_dead after in_flight_timeout) must not overwrite the
            # first report's evidence. Still matches the analyzer's and
            # launcher-cleanup's hang_rank_*.json glob.
            path = path.with_name(
                f"hang_rank_{self._rank_tag}.{reason}.json"
            )
        try:
            tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
            tmp.write_text(json.dumps(report, indent=2, default=str))
            os.replace(tmp, path)
            self.hang_reports.append(path)
        except OSError:
            return None
        # also refresh the regular per-rank dump: the analyzer reads both,
        # and the launcher may SIGKILL this process before atexit runs
        dump_path = os.environ.get("TORCHMPI_TPU_TELEMETRY_DUMP", "")
        if dump_path:
            from . import dump as _dump

            try:
                _dump(dump_path)
            except Exception:  # noqa: BLE001
                pass
        print(
            f"[torchmpi_tpu_torch.watchdog] HANG ({reason}) after "
            f"{self.timeout:.1f}s — report: {path}",
            file=sys.stderr, flush=True,
        )
        if self.abort:
            import signal

            os.kill(os.getpid(), signal.SIGABRT)
        return path


_lock = _lockmon.make_lock("watchdog.py:_lock")
_active: Optional[Watchdog] = None


def active() -> Optional[Watchdog]:
    return _active


def start_watchdog(timeout: float, interval: Optional[float] = None,
                   heartbeat_dir=None, rank: Optional[int] = None,
                   abort: Optional[bool] = None,
                   source: str = "constants") -> Watchdog:
    """Start (or return the already-running) process watchdog. Defaults:
    heartbeat dir = the directory of ``TORCHMPI_TPU_TELEMETRY_DUMP`` (the
    launcher's --telemetry-dir), rank = ``TORCHMPI_TPU_PROCESS_ID``."""
    global _active
    with _lock:
        if _active is not None:
            return _active
        if heartbeat_dir is None:
            dump = os.environ.get("TORCHMPI_TPU_TELEMETRY_DUMP", "")
            if dump:
                heartbeat_dir = Path(dump).parent
        if abort is None:
            abort = os.environ.get(
                "TORCHMPI_TPU_WATCHDOG_ABORT", ""
            ).lower() in ("1", "true", "yes", "on")
        wd = Watchdog(timeout, interval=interval,
                      heartbeat_dir=heartbeat_dir, rank=rank, abort=abort)
        wd.source = source
        _active = wd
    # ride the queue-depth timeline into every metrics snapshot — this is
    # the "queue depth over time" series the analyzer's PS-health report
    # plots (a point-in-time gauge can't show a building backlog)
    from . import metrics

    metrics.register_collector(
        "ps_queue_timeline", wd.queue_timeline_snapshot
    )
    wd.start()
    return wd


def stop_watchdog(only_source: Optional[str] = None) -> None:
    """Stop the active watchdog. ``only_source="constants"`` (what
    ``mpi.stop()`` passes) leaves an env-armed one running: the launcher
    asked for process-lifetime coverage, and a stop/start cycle must not
    silently shed it."""
    global _active
    with _lock:
        wd = _active
        if wd is None or (
            only_source is not None and wd.source != only_source
        ):
            return
        _active = None
    wd.stop()
    from . import metrics

    metrics.unregister_collector("ps_queue_timeline")


def _maybe_start_from_env() -> None:
    """Telemetry import-time hook: ``TORCHMPI_TPU_WATCHDOG=<seconds>``
    (the launcher's --watchdog-timeout) arms the watchdog in every rank."""
    raw = os.environ.get("TORCHMPI_TPU_WATCHDOG", "")
    if not raw:
        return
    try:
        timeout = float(raw)
    except ValueError:
        return
    if timeout > 0:
        start_watchdog(timeout, source="env")
