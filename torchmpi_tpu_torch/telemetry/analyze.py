"""Offline cross-rank analyzer: merge per-rank telemetry dumps into one
timeline and diagnose desync / stragglers / hangs / PS fleet health.

    python -m torchmpi_tpu_torch.telemetry.analyze <telemetry-dir> \
        [--out report.json] [--trace merged.trace.json] [--strict]

The port of ``torchmpi_tpu/telemetry/analyze.py``, which reads journals
only, so the two read the same dumps alike. Exit codes (``--strict`` is
the CI gate): ``0`` clean (or not strict), ``1`` desync detected, ``2`` usage/input error (no rank
dumps), ``3`` hang diagnosed without a desync — a desync found
alongside a hang exits 1, since the desync is the root cause.

Ingests everything a ``--telemetry-dir`` run leaves behind:

- ``telemetry_rank_<r>[.restart<k>].json`` snapshots (+ their
  ``.trace.json`` span exports) — highest restart per rank wins;
- ``hang_rank_*.json`` watchdog hang reports;
- ``heartbeat_rank_*.json`` heartbeats (progress of ranks that died
  without dumping).

And produces:

1. **One merged Perfetto-loadable trace** — one track (pid) per rank.
   Span timestamps are rank-local ``perf_counter`` values; the clock-sync
   record ``start()`` captured (one (wall, perf) pair per rank) is the
   offset handshake that puts them all on a single wall-clock axis.
   Flight-recorder entries ride along as a ``flight`` thread per rank.
2. **A machine-readable report** (JSON):
   - *desync*: per-communicator (seq, op, payload) streams diffed across
     ranks over their overlapping seq window — the first divergent
     (seq, op, payload) is pinpointed, plus per-rank seq high-water
     mismatches (a rank that stopped early). The GC3 schedule-as-data
     payoff: desync is a diff, not a debugging session.
   - *stragglers*: per-(comm, seq) issue-time spread across ranks — who
     is consistently last, by how much (the Awan et al. cross-rank
     timeline-correlation methodology, PAPERS.md).
   - *ps*: per-server RPC latency quantiles (p50/p95/p99 from the
     histogram buckets) and the listener queue-depth timeline the
     watchdog sampled.
   - *hangs*: for each watchdog report, the stuck entries and the ranks
     that **never entered** the stuck collective (seq high-water below
     the stuck seq, or — for peer-scoped PS streams — no matching-op
     entry in the hang window).

Stdlib-only: runs anywhere, no torch required.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path
from typing import Dict, List, Optional

from . import criticalpath as _criticalpath


def _max_flow_events() -> int:
    """The trace_max_flow_events knob; defensive default so the analyzer
    stays usable even if the constants table cannot load."""
    try:
        from .. import constants
        return int(constants.get("trace_max_flow_events"))
    except Exception:
        return 512


_RANK_RE = re.compile(
    r"^telemetry_rank_(\d+)(?:\.restart(\d+))?\.json$"
)

# PS streams are per-peer *directional* (rank 0's "ps:1" pairs with rank
# 1's "ps:0"), so they are excluded from the cross-rank seq diff and the
# straggler spread, which both assume one shared stream per comm key.
# "handles" (SyncHandle.wait blocking regions) is likewise rank-local:
# which waits run depends on timing (prefetch, backpressure drains), not
# on the program's collective schedule. "chunks" is the chunk-pipeline
# sub-entry stream (schedule.pipeline.CHUNK_COMM): per-chunk events of a
# parent dispatch whose count and timing vary with payload split and
# socket pacing, not with the program — a pipelined run must diff clean.
_PS_PREFIX = "ps:"
_LOCAL_COMMS = ("handles", "chunks")

# synthetic tid for the flight-recorder track merged under each rank's pid
_FLIGHT_TID = 0xF11


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def load_run(telemetry_dir) -> dict:
    """Read every rank dump / hang report / heartbeat in the directory."""
    d = Path(telemetry_dir)
    per_rank: Dict[int, dict] = {}
    for path in sorted(d.iterdir()) if d.is_dir() else []:
        m = _RANK_RE.match(path.name)
        if not m:
            continue
        rank, restart = int(m.group(1)), int(m.group(2) or 0)
        prev = per_rank.get(rank)
        if prev is not None and prev["restart"] >= restart:
            continue
        try:
            snap = json.loads(path.read_text())
        except (OSError, ValueError) as e:
            per_rank[rank] = {
                "restart": restart, "path": str(path),
                "error": f"{type(e).__name__}: {e}",
                "snapshot": {}, "trace_events": [],
            }
            continue
        trace_path = path.with_name(f"{path.stem}.trace.json")
        events: List[dict] = []
        if trace_path.exists():
            try:
                events = json.loads(trace_path.read_text()).get(
                    "traceEvents", []
                )
            except (OSError, ValueError):
                pass
        per_rank[rank] = {
            "restart": restart,
            "path": str(path),
            "snapshot": snap,
            "trace_events": events,
        }
    hangs = []
    heartbeats = {}
    if d.is_dir():
        for path in sorted(d.glob("hang_rank_*.json")):
            try:
                hangs.append(json.loads(path.read_text()))
            except (OSError, ValueError):
                pass
        for path in sorted(d.glob("heartbeat_rank_*.json")):
            try:
                heartbeats[path.stem.split("heartbeat_rank_")[-1]] = (
                    json.loads(path.read_text())
                )
            except (OSError, ValueError):
                pass
    return {"dir": str(d), "ranks": per_rank, "hangs": hangs,
            "heartbeats": heartbeats}


def _flight_entries(data: dict) -> List[dict]:
    return data["snapshot"].get("flight_recorder", {}).get("entries", [])


def _wall_offset_us(data: dict) -> Optional[float]:
    """µs to add to a rank's perf_counter-based span ts to land on the
    wall clock; None when the rank never recorded a clock sync."""
    cs = data["snapshot"].get("clock_sync")
    if not cs:
        return None
    try:
        return (float(cs["wall_time"]) - float(cs["perf_counter"])) * 1e6
    except (KeyError, TypeError, ValueError):
        return None


# ---------------------------------------------------------------------------
# merged trace
# ---------------------------------------------------------------------------


def merged_trace(ranks: Dict[int, dict]) -> dict:
    """One Chrome-trace object with one pid (track) per rank, all events
    aligned to a common wall-clock axis where clock sync allows."""
    events: List[dict] = []
    aligned: Dict[int, bool] = {}
    all_ts: List[float] = []
    per_rank_events: Dict[int, List[dict]] = {}
    for rank, data in sorted(ranks.items()):
        off = _wall_offset_us(data)
        aligned[rank] = off is not None
        shift = off or 0.0
        evs = []
        for ev in data["trace_events"]:
            if ev.get("ph") == "M":
                continue  # re-emitted below with the rank identity
            ev = dict(ev)
            ev["pid"] = rank
            ev["ts"] = float(ev.get("ts", 0)) + shift
            evs.append(ev)
            all_ts.append(ev["ts"])
        for e in _flight_entries(data):
            t0 = float(e["t_issue"]) * 1e6
            t1 = (
                float(e["t_complete"]) * 1e6
                if e.get("t_complete") else t0
            )
            evs.append({
                "ph": "X",
                "name": f"flight.{e['op']}",
                "cat": "flight",
                "ts": t0,
                "dur": max(t1 - t0, 1.0),
                "pid": rank,
                "tid": _FLIGHT_TID,
                "args": {k: e.get(k, "") for k in
                         ("seq", "comm", "payload", "wire", "backend",
                          "routing", "plan", "status")},
            })
            all_ts.append(t0)
        per_rank_events[rank] = evs
    # cross-rank causal arrows: same logical collective across pid
    # tracks, and each trace-stamped PS RPC to the server work it
    # caused. Emitted with the SAME absolute wall-µs timebase as the
    # flight slices (each arrow endpoint binds +1µs inside its slice),
    # so the shared base normalization below lands them correctly.
    flow_evs = _criticalpath.flow_events(
        ranks, flight_tid=_FLIGHT_TID, max_flows=_max_flow_events()
    )
    base = min(all_ts) if all_ts else 0.0
    for ev in flow_evs:
        ev["ts"] = round(ev["ts"] - base, 3)
        events.append(ev)
    for rank in sorted(per_rank_events):
        suffix = "" if aligned[rank] else " (unaligned)"
        events.append({
            "ph": "M", "ts": 0, "name": "process_name", "pid": rank,
            "tid": 0, "args": {"name": f"rank {rank}{suffix}"},
        })
        events.append({
            "ph": "M", "ts": 0, "name": "thread_name", "pid": rank,
            "tid": _FLIGHT_TID, "args": {"name": "flight recorder"},
        })
        for ev in per_rank_events[rank]:
            ev["ts"] = round(ev["ts"] - base, 3)
            events.append(ev)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "clockAligned": aligned,
    }


# ---------------------------------------------------------------------------
# desync detection
# ---------------------------------------------------------------------------


def _collective_streams(ranks: Dict[int, dict]) -> Dict[str, Dict[int, dict]]:
    """comm -> rank -> {seq: entry} for shared (non-PS) streams."""
    streams: Dict[str, Dict[int, dict]] = {}
    for rank, data in ranks.items():
        for e in _flight_entries(data):
            comm = e["comm"]
            if comm.startswith(_PS_PREFIX) or comm in _LOCAL_COMMS:
                continue
            streams.setdefault(comm, {}).setdefault(rank, {})[e["seq"]] = e
    return streams


def detect_desync(ranks: Dict[int, dict]) -> dict:
    """Diff per-comm (seq, op, payload, plan) streams across ranks. The
    ring may have dropped old entries, so each comm is compared over the
    seq window every rank still holds; per-rank high-water mismatches are
    reported separately (the 'rank stopped early' signal). The plan_id
    participates in the diff: two ranks can agree on (op, payload) yet
    compile DIFFERENT schedules (divergent constants, topology or
    autotuner state) — before plans, that desync was invisible here and
    hierarchical sub-structure was attributed to the parent op with no
    routing detail."""
    truncated = {
        rank: data["snapshot"].get("flight_recorder", {}).get("dropped", 0)
        for rank, data in ranks.items()
    }
    comms = {}
    first_div = None
    for comm, by_rank in sorted(_collective_streams(ranks).items()):
        if len(by_rank) < 2:
            continue  # nothing to diff against
        lo = max(min(s) for s in by_rank.values())
        hi = min(max(s) for s in by_rank.values())
        high_water = {r: max(s) for r, s in by_rank.items()}
        divergence = None
        for seq in range(lo, hi + 1):
            vals = {r: s.get(seq) for r, s in by_rank.items()}
            missing = [r for r, v in vals.items() if v is None]
            kinds = {
                r: (v["op"], v["payload"], v.get("plan", ""))
                for r, v in vals.items() if v is not None
            }
            if missing or len(set(kinds.values())) > 1:
                divergence = {
                    "comm": comm,
                    "seq": seq,
                    "ops": {str(r): v[0] for r, v in kinds.items()},
                    "payloads": {str(r): v[1] for r, v in kinds.items()},
                    "plans": {str(r): v[2] for r, v in kinds.items()},
                    "ranks_missing_seq": missing,
                }
                break
        tail_mismatch = len(set(high_water.values())) > 1
        comms[comm] = {
            "ranks": sorted(by_rank),
            "compared_window": [lo, hi],
            "seq_high_water": {str(r): v for r, v in high_water.items()},
            "tail_mismatch": tail_mismatch,
            "divergence": divergence,
        }
        if divergence and first_div is None:
            first_div = divergence
    status = "desync" if first_div else "none"
    return {
        "status": status,
        "first_divergence": first_div,
        "comms": comms,
        "ring_dropped": {str(r): v for r, v in truncated.items() if v},
    }


# ---------------------------------------------------------------------------
# straggler ranking
# ---------------------------------------------------------------------------


def rank_stragglers(ranks: Dict[int, dict]) -> dict:
    """Per-(comm, seq) issue-time spread across ranks: who enters each
    collective last, and by how much. Requires the shared wall clock the
    flight recorder stamps (time.time()); meaningful skew >> NTP error."""
    lag_sum: Dict[int, float] = {}
    last_count: Dict[int, int] = {}
    samples = 0
    max_spread = 0.0
    for comm, by_rank in _collective_streams(ranks).items():
        if len(by_rank) < 2 or comm == _RESIZE_COMM:
            # resize barrier entries spread by design (the first rank
            # in waits for the last) — analyze_resizes owns that comm
            continue
        common = set.intersection(*(set(s) for s in by_rank.values()))
        for seq in common:
            entries = {r: s[seq] for r, s in by_rank.items()}
            if len({e["op"] for e in entries.values()}) != 1:
                continue  # desynced seq: not a timing comparison
            times = {r: float(e["t_issue"]) for r, e in entries.items()}
            t_min = min(times.values())
            spread = max(times.values()) - t_min
            max_spread = max(max_spread, spread)
            last = max(times, key=times.get)
            last_count[last] = last_count.get(last, 0) + 1
            for r, t in times.items():
                lag_sum[r] = lag_sum.get(r, 0.0) + (t - t_min)
            samples += 1
    ranking = sorted(
        (
            {
                "rank": r,
                "mean_lag_ms": round(lag_sum.get(r, 0.0) / samples * 1e3, 3),
                "last_count": last_count.get(r, 0),
            }
            for r in sorted(ranks)
        ),
        key=lambda d: (-d["mean_lag_ms"], -d["last_count"]),
    ) if samples else []
    worst = ranking[0] if ranking else None
    return {
        "samples": samples,
        "max_spread_ms": round(max_spread * 1e3, 3),
        "ranking": ranking,
        "worst": worst["rank"] if worst else None,
        # scheduling jitter and NTP skew sit well under this; a real
        # straggler (slow host, contended input pipeline) sits well over
        "significant": bool(worst and worst["mean_lag_ms"] >= 25.0),
    }


# ---------------------------------------------------------------------------
# PS fleet health
# ---------------------------------------------------------------------------


def _series_labels(label_str: str) -> dict:
    out = {}
    for part in label_str.split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            out[k] = v
    return out


def _kind_series(metrics: dict, name: str, label: str = "kind") -> dict:
    """Histogram series of ``name`` keyed by one of its labels
    (``kind`` by default; the read-lane series key on ``lane``)."""
    out = {}
    for label_str, h in metrics.get(name, {}).get("series", {}).items():
        kind = _series_labels(label_str).get(label, label_str)
        out[kind] = {
            "count": h.get("count"),
            "mean_s": (
                round(h["sum"] / h["count"], 6) if h.get("count") else None
            ),
            "quantiles_s": h.get("quantiles", {}),
        }
    return out


def ps_health(
    ranks: Dict[int, dict], prev: Optional[dict] = None,
    interval_s: Optional[float] = None,
) -> dict:
    """Per-server RPC latency quantiles, queue depth over time,
    connection lifecycle, admission control, and the server-side
    queue-vs-apply attribution (where an RPC's latency went: waiting for
    a pool worker, or applying the rule).

    BUSY rejects are reported both as the integral (``busy_rejected``,
    summed over listeners — what the overload verdict historically keyed
    on) and per listener (``busy_by_listener``). With ``prev`` (the
    ``servers`` dict of the previous call) and the elapsed
    ``interval_s``, each server also carries ``busy_rate_per_s`` — the
    per-listener ROLLING rate over the window, which is what the load
    verdict and ``top`` trend on: a high integral from a storm an hour
    ago is history, a high rate is load NOW."""
    prev = prev or {}
    servers = {}
    for rank, data in sorted(ranks.items()):
        metrics = data["snapshot"].get("metrics", {})
        rpc = _kind_series(metrics, "tm_ps_rpc_latency_seconds")
        queue_t = _kind_series(metrics, "tm_ps_server_queue_seconds")
        apply_t = _kind_series(metrics, "tm_ps_server_apply_seconds")
        attribution = {}
        for kind in set(queue_t) | set(apply_t):
            q = (queue_t.get(kind) or {}).get("mean_s")
            a = (apply_t.get(kind) or {}).get("mean_s")
            attribution[kind] = {
                "queue_mean_s": q,
                "apply_mean_s": a,
                # the actionable verdict: a queue-dominated server needs
                # admission budget / pool tuning; an apply-dominated one
                # needs faster rules or more shards
                "dominant": (
                    "queue" if (q or 0) > (a or 0) else "apply"
                ) if (q is not None or a is not None) else None,
            }
        connections = {}
        for name, key in (
            ("tm_ps_connections_open", "open"),
            ("tm_ps_accepts_total", "accepted"),
            ("tm_ps_disconnects_total", "disconnected"),
            ("tm_ps_busy_rejected_total", "busy_rejected"),
            # failover dead-marks: active = peers this rank is currently
            # routing around; expiries = retry windows that elapsed (each
            # one closed a bounded split-brain window by re-probing)
            ("tm_ps_dead_marks_active", "dead_marks_active"),
            ("tm_ps_dead_mark_expiries_total", "dead_mark_expiries"),
        ):
            series = metrics.get(name, {}).get("series", {})
            if series:
                connections[key] = sum(series.values())
        busy_by_listener: Dict[str, float] = {}
        for label_str, v in metrics.get(
            "tm_ps_busy_rejected_total", {}
        ).get("series", {}).items():
            lst = _series_labels(label_str).get("listener", label_str)
            busy_by_listener[lst] = busy_by_listener.get(lst, 0) + v
        # read-path attribution, split by serving lane (owner socket /
        # replica socket / same-host shm): where fetches were routed,
        # why any fell back to the owner (stale floor, dead member, shm
        # miss), seqlock contention, and per-lane latency — the
        # read-side twin of the queue-vs-apply write attribution
        reads: Dict[str, dict] = {}
        routes: Dict[str, float] = {}
        for label_str, v in metrics.get(
            "tm_ps_read_routes_total", {}
        ).get("series", {}).items():
            lane = _series_labels(label_str).get("lane", label_str)
            routes[lane] = routes.get(lane, 0) + v
        if routes:
            reads["routes_by_lane"] = routes
        fallbacks: Dict[str, float] = {}
        for label_str, v in metrics.get(
            "tm_ps_read_fallbacks_total", {}
        ).get("series", {}).items():
            reason = _series_labels(label_str).get("reason", label_str)
            fallbacks[reason] = fallbacks.get(reason, 0) + v
        if fallbacks:
            reads["fallbacks_by_reason"] = fallbacks
        shm_retries = metrics.get(
            "tm_ps_read_shm_retries_total", {}
        ).get("series", {})
        if shm_retries:
            reads["shm_seqlock_retries"] = sum(shm_retries.values())
        stale_srv = metrics.get(
            "tm_ps_read_stale_redirects_total", {}
        ).get("series", {})
        if stale_srv:
            reads["stale_redirects_served"] = sum(stale_srv.values())
        read_lat = _kind_series(
            metrics, "tm_ps_read_latency_seconds", label="lane"
        )
        if read_lat:
            reads["latency_by_lane"] = read_lat
        listener = metrics.get("ps_listener")
        timeline = metrics.get("ps_queue_timeline") or []
        if rpc or listener or timeline or attribution or connections or reads:
            entry = {
                "rpc_latency": rpc,
                "server_time": attribution,
                "connections": connections or None,
                "listener": listener,
                "queue_depth_timeline": timeline,
                "queue_depth_max": max(
                    (p.get("queue_depth") or 0 for p in timeline), default=None
                ) if timeline else None,
            }
            if reads:
                entry["reads"] = reads
            if busy_by_listener:
                entry["busy_by_listener"] = busy_by_listener
                if interval_s:
                    prev_b = (
                        prev.get(str(rank)) or {}
                    ).get("busy_by_listener") or {}
                    entry["busy_rate_per_s"] = {
                        lst: round(
                            max(0.0, v - prev_b.get(lst, 0)) / interval_s,
                            3,
                        )
                        for lst, v in busy_by_listener.items()
                    }
            servers[str(rank)] = entry
    return {"servers": servers}


# ---------------------------------------------------------------------------
# resize-epoch analysis
# ---------------------------------------------------------------------------

# the reserved flight comm key resize barriers record under (engine
# resize, elastic member resize, PS chain re-formation); seq == epoch
_RESIZE_COMM = "resize"


def analyze_resizes(run: dict) -> dict:
    """Group ``resize.*`` flight entries by epoch and name any rank
    that never entered the resize barrier — the rank a resize hangs on.
    Entries are recorded with ``seq = resize epoch`` and an identical
    payload on every participant, so a missing (rank, epoch) pair IS
    the diagnosis; heartbeats cover ranks that died without dumping."""
    ranks = run["ranks"]
    per_rank: Dict[int, Dict[int, dict]] = {}
    for rank, data in ranks.items():
        for e in _flight_entries(data):
            if e["comm"] == _RESIZE_COMM:
                per_rank.setdefault(rank, {})[e["seq"]] = e
    if not per_rank:
        return {"status": "none", "epochs": {}}
    all_ranks = set(ranks)
    for tag in run.get("heartbeats", {}):
        try:
            all_ranks.add(int(tag))
        except ValueError:
            pass
    epochs = {}
    clean = True
    for epoch in sorted({s for m in per_rank.values() for s in m}):
        entered = sorted(r for r, m in per_rank.items() if epoch in m)
        # only ranks alive at (or after) the epoch can be expected in
        # its barrier: a rank whose dump/heartbeat never reached this
        # epoch's FIRST entry time was the death the resize responded
        # to, not a straggler
        t0 = min(
            float(per_rank[r][epoch]["t_issue"]) for r in entered
        )
        expected = set(entered)
        for r in all_ranks - set(entered):
            # expected = the rank existed BEFORE the epoch fired (some
            # entry at/below t0 — a later joiner is not a straggler)
            # AND showed life AT/after it (an entry or heartbeat past
            # t0 — the death the resize responded to is not one either)
            data = ranks.get(r)
            born_before = alive_past = False
            if data is not None:
                for e in _flight_entries(data):
                    t = float(e["t_issue"])
                    born_before |= t <= t0
                    alive_past |= t >= t0
            beat = run.get("heartbeats", {}).get(str(r))
            if beat and float(beat.get("time", 0)) >= t0:
                alive_past = True
            if born_before and alive_past:
                expected.add(r)
        never = sorted(expected - set(entered))
        failed = sorted(
            r for r in entered
            if per_rank[r][epoch].get("status") == "failed"
        )
        if never or failed:
            clean = False
        epochs[str(epoch)] = {
            "entered": entered,
            "never_entered": never,
            "failed": failed,
            "payload": per_rank[entered[0]][epoch]["payload"]
            if entered else "",
        }
    return {"status": "ok" if clean else "incomplete", "epochs": epochs}


# ---------------------------------------------------------------------------
# hang analysis
# ---------------------------------------------------------------------------


def analyze_hangs(run: dict) -> list:
    """For each watchdog report: the stuck entries, and which ranks never
    entered them (seq high-water below the stuck seq for shared streams;
    no matching-op entry in the hang window for peer-scoped PS ones)."""
    ranks = run["ranks"]
    out = []
    for hang in run["hangs"]:
        stuck_entries = hang.get("detail", {}).get("stuck", [])
        diagnosed = []
        for stuck in stuck_entries:
            comm, seq, op = stuck["comm"], stuck["seq"], stuck["op"]
            never_entered = []
            if comm in _LOCAL_COMMS:
                pass  # rank-local blocking region: no cross-rank members
            elif not comm.startswith(_PS_PREFIX):
                for r, data in sorted(ranks.items()):
                    hw = (
                        data["snapshot"].get("flight_recorder", {})
                        .get("seq_high_water", {})
                    )
                    if hw.get(comm, -1) < seq:
                        never_entered.append(r)
            else:
                # PS streams are directional: "ps:<peer>" names the peer
                # process the hang rank was waiting on — only THAT peer
                # can have "never entered"; other ranks' unrelated RPC
                # traffic proves nothing either way
                m = re.match(rf"{_PS_PREFIX}(\d+)$", comm)
                peer = int(m.group(1)) if m else None
                t0 = float(stuck["t_issue"]) - 1.0
                if peer is not None and peer != hang.get("rank"):
                    data = ranks.get(peer)
                    if data is None or not any(
                        e["op"] == op and float(e["t_issue"]) >= t0
                        for e in _flight_entries(data)
                    ):
                        never_entered.append(peer)
            # heartbeats cover ranks that died before dumping (shared
            # streams only — a peer's own PS streams are directional and
            # never carry this comm key)
            if not comm.startswith(_PS_PREFIX) and comm not in _LOCAL_COMMS:
                for tag, beat in run["heartbeats"].items():
                    try:
                        r = int(tag)
                    except ValueError:
                        continue
                    if r in ranks or r == hang.get("rank"):
                        continue
                    if beat.get("seq_high_water", {}).get(comm, -1) < seq:
                        never_entered.append(r)
            diagnosed.append({
                "stuck": {k: stuck.get(k) for k in
                          ("comm", "seq", "op", "payload", "wire",
                           "backend", "t_issue")},
                "ranks_never_entered": sorted(set(never_entered)),
            })
        out.append({
            "rank": hang.get("rank"),
            "reason": hang.get("reason"),
            "time": hang.get("time"),
            "watchdog_timeout_seconds": hang.get("watchdog_timeout_seconds"),
            "stuck_collectives": diagnosed,
        })
    return out


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def analyze(telemetry_dir, run: Optional[dict] = None) -> dict:
    """The full report (without writing anything). ``run`` short-circuits
    the directory read when the caller already holds a ``load_run``."""
    if run is None:
        run = load_run(telemetry_dir)
    ranks = run["ranks"]
    report = {
        "dir": run["dir"],
        "ranks": sorted(ranks),
        "restarts": {str(r): d["restart"] for r, d in ranks.items()
                     if d["restart"]},
        "spans_dropped": {
            str(r): d["snapshot"].get("spans", {}).get("dropped", 0)
            for r, d in ranks.items()
        },
        "desync": detect_desync(ranks),
        "stragglers": rank_stragglers(ranks),
        "ps": ps_health(ranks),
        "resize": analyze_resizes(run),
        "hangs": analyze_hangs(run),
        "critical_path": _criticalpath.critical_path(ranks),
        "overlap": _criticalpath.overlap_ledger(ranks),
        "serve_hops": _criticalpath.serve_hops(ranks),
    }
    return report


def _summary_lines(report: dict) -> List[str]:
    lines = [f"ranks: {', '.join(map(str, report['ranks'])) or '(none)'}"]
    div = report["desync"]["first_divergence"]
    if div is None:
        lines.append("desync: none")
    else:
        plans = div.get("plans", {})
        if len(set(div["ops"].values())) <= 1 and len(set(plans.values())) > 1:
            # same op, different compiled schedule: name the PLAN — the
            # divergence the old op-only diff could not see
            detail = ", ".join(
                f"rank {r}={p or '(no plan)'}" for r, p in sorted(plans.items())
            )
        else:
            detail = ", ".join(
                f"rank {r}={op}" for r, op in sorted(div["ops"].items())
            )
        lines.append(
            f"desync: comm={div['comm']} first divergent seq={div['seq']} "
            f"({detail or 'missing on ' + str(div['ranks_missing_seq'])})"
        )
    st = report["stragglers"]
    if st.get("significant"):
        w = st["ranking"][0]
        lines.append(
            f"straggler: rank {w['rank']} (mean lag {w['mean_lag_ms']}ms, "
            f"last into {w['last_count']}/{st['samples']} collectives)"
        )
    else:
        lines.append("straggler: none")
    cp = report.get("critical_path", {})
    if cp.get("fleet_dominant"):
        line = f"critical path: fleet dominated by {cp['fleet_dominant']}"
        if cp.get("dominant_rank") is not None:
            dom_us = cp.get("dominance_us", {}).get(
                str(cp["dominant_rank"]), 0.0
            )
            line += (
                f"; rank {cp['dominant_rank']} caused "
                f"{dom_us / 1000.0:.1f}ms of fleet wait"
            )
        lines.append(line)
    rz = report.get("resize", {"status": "none"})
    if rz["status"] == "none":
        lines.append("resize: none")
    else:
        bad = {
            ep: info for ep, info in rz["epochs"].items()
            if info["never_entered"] or info["failed"]
        }
        if not bad:
            lines.append(
                f"resize: {len(rz['epochs'])} epoch(s), every live rank "
                "entered the barrier"
            )
        for ep, info in sorted(bad.items(), key=lambda kv: int(kv[0])):
            detail = []
            if info["never_entered"]:
                detail.append(
                    f"never entered by ranks {info['never_entered']}"
                )
            if info["failed"]:
                detail.append(f"failed on ranks {info['failed']}")
            lines.append(
                f"resize: epoch {ep} ({info['payload']}) "
                + "; ".join(detail)
            )
    if report["hangs"]:
        for h in report["hangs"]:
            for d in h["stuck_collectives"]:
                s = d["stuck"]
                lines.append(
                    f"hang: rank {h['rank']} stuck in {s['op']} "
                    f"(comm={s['comm']} seq={s['seq']}); never entered: "
                    f"{d['ranks_never_entered'] or 'none'}"
                )
            if not h["stuck_collectives"]:
                lines.append(
                    f"hang: rank {h['rank']} ({h['reason']})"
                )
    else:
        lines.append("hangs: none")
    truncated = report["desync"].get("ring_dropped", {})
    if truncated:
        lines.append(f"flight-ring truncation: {truncated}")
    return lines


def _critical_path_panel(report: dict) -> List[str]:
    """The --critical-path panel: per-rank attribution, cross-rank
    dominance, the measured overlap ledger, and serve hop decomposition."""
    cp = report.get("critical_path", {})
    lines = ["critical path:"]
    rows = cp.get("ranks", {})
    if not rows:
        lines.append("  (no flight-recorder entries)")
        return lines
    for rank in sorted(rows, key=int):
        row = rows[rank]
        total = row["window_us"] or 1.0
        top = sorted(
            row["buckets_us"].items(), key=lambda kv: -kv[1]
        )[:4]
        terms = ", ".join(
            f"{b} {us / total * 100:.0f}%" for b, us in top
        )
        dom = row["dominance_us"]
        lines.append(
            f"  rank {rank}: window {row['window_us'] / 1000:.1f}ms | "
            f"{terms}"
            + (f" | caused {dom / 1000:.1f}ms fleet wait" if dom else "")
        )
    if cp.get("dominant_rank") is not None:
        lines.append(
            f"  dominant rank: {cp['dominant_rank']} "
            f"(fleet-dominant term: {cp.get('fleet_dominant')})"
        )
    ov = report.get("overlap", {}).get("plans", {})
    if ov:
        lines.append("overlap ledger (measured, per plan):")
        for plan, row in sorted(ov.items()):
            lines.append(
                f"  {plan}: {row['chunks']} chunks, serial "
                f"{row['serial_us'] / 1000:.2f}ms -> span "
                f"{row['span_us'] / 1000:.2f}ms "
                f"(overlap {row['measured_fraction'] * 100:.1f}%)"
            )
    sh = report.get("serve_hops", {}).get("summary")
    if sh:
        lines.append(
            f"serve hops: {sh['hops']} decomposed | mean client "
            f"{sh['mean_client_us'] / 1000:.2f}ms = server "
            f"{sh['mean_server_us'] / 1000:.2f}ms + wire/queue "
            f"{sh['mean_wire_us'] / 1000:.2f}ms"
        )
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m torchmpi_tpu_torch.telemetry.analyze",
        description="merge per-rank telemetry dumps; diagnose desync, "
        "stragglers, hangs, PS health",
    )
    ap.add_argument("dir", help="the --telemetry-dir of the run")
    ap.add_argument("--out", default=None,
                    help="report JSON path (default <dir>/analysis.json)")
    ap.add_argument("--trace", default=None,
                    help="merged Perfetto trace path "
                    "(default <dir>/merged.trace.json)")
    ap.add_argument("--strict", action="store_true",
                    help="fail on findings: exit 1 on desync, 3 on hang "
                    "(desync wins when both); 0 clean, 2 input error")
    ap.add_argument("--critical-path", action="store_true",
                    help="print the per-rank critical-path attribution "
                    "panel (buckets, dominance, overlap ledger, serve "
                    "hops)")
    args = ap.parse_args(argv)

    d = Path(args.dir)
    run = load_run(d)
    if not run["ranks"]:
        print(f"no telemetry_rank_*.json dumps under {d}", file=sys.stderr)
        return 2
    report = analyze(d, run=run)
    trace = merged_trace(run["ranks"])

    out = Path(args.out) if args.out else d / "analysis.json"
    trace_path = Path(args.trace) if args.trace else d / "merged.trace.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2, default=str))
    trace_path.write_text(json.dumps(trace))

    for line in _summary_lines(report):
        print(line)
    if args.critical_path:
        for line in _critical_path_panel(report):
            print(line)
    print(f"report: {out}")
    print(f"merged trace: {trace_path}")
    # Exit-code contract:
    #   0 — analysis ran; without --strict always, with --strict clean
    #   1 — --strict: cross-rank desync detected (also when a hang was
    #       found alongside it: the desync is the root cause to chase)
    #   2 — usage/input error (no telemetry_rank_*.json dumps)
    #   3 — --strict: hang diagnosed (watchdog reports), no desync
    if args.strict:
        if report["desync"]["status"] != "none":
            print("strict: failing on desync", file=sys.stderr)
            return 1
        if report["hangs"]:
            print("strict: failing on hang diagnosis", file=sys.stderr)
            return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
