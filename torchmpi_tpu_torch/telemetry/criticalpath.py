"""Causal DAG assembly: flow events, critical-path attribution, and the
measured overlap ledger.

The port of ``torchmpi_tpu/telemetry/criticalpath.py``, copied whole: it
reads journals only. The flight recorder stamps every dispatch with
wall-clock times and ``(trace, span, parent)`` ids; this module turns
those per-rank journals into cross-rank answers:

- :func:`flow_events` — Perfetto flow arrows (ph ``s``/``t``/``f``)
  linking the SAME logical collective across pid=rank tracks (joined by
  ``(comm, seq, plan)``: SPMD ranks issue identical streams, so the key
  needs no wire traffic) and each PS RPC to the server-side work it
  caused (joined by the wire-carried span ids: client entry ``span`` ==
  server entry ``parent``).
- :func:`critical_path` — per-rank wall-time attribution into buckets
  (compute, collective, wire, quantize, ps_*, serve queue, wait): a
  sweep over each rank's recorded intervals where the innermost
  (latest-starting) covering interval wins, gaps count as ``compute``
  (host work the recorder does not instrument), and the early entrants
  of a synchronous collective are reclassified as ``wait`` until the
  last rank arrives. Bucket sums therefore cover the FULL window by
  construction. Cross-rank dominance (how much fleet wait each rank's
  lateness caused) names the straggler causally — not just "who was
  last" but "whose lateness cost the most rank-seconds".
- :func:`overlap_ledger` — measured overlap fraction per plan_id from
  the chunk-pipeline sub-entries (``schedule/pipeline.py``) and the
  bucket sub-entries of ``schedule/overlap.py``, the number the analytic
  ``cost.pipeline_stage_us`` stage-overlap is checked against
  (:func:`modeled_overlap_fraction` prices the model side).

Stdlib-only, like the rest of :mod:`telemetry`: journals in, JSON out.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from .tracecontext import fnv1a64

# comm-key conventions shared with analyze.py (kept literal here so the
# module stays import-light; analyze.py asserts they agree)
_PS_PREFIX = "ps:"
_PS_SERVER_PREFIX = "ps:server:"
_CHUNK_COMM = "chunks"
_HANDLE_COMM = "handles"
_RESIZE_COMM = "resize"

#: attribution buckets, in sweep priority order (later = more specific;
#: when intervals overlap the innermost covering interval wins, and ties
#: break toward the higher-priority bucket)
BUCKETS = (
    "compute",        # gaps: host work the recorder does not instrument
    "collective",     # shared collective dispatch (allreduce/bcast/...)
    "wait",           # early entrant blocked on the last rank to arrive
    "ps_wire",        # client-observed PS RPC round trip
    "quantize",       # chunk-pipeline encode/decode sub-entries
    "ps_queue",       # server-side admitted-but-unapplied (queue) time
    "ps_apply",       # server-side rule apply
    "chain_forward",  # replica-pump forward hop
    "serve_queue",    # serving REQUEST on the server side
)
_PRIORITY = {b: i for i, b in enumerate(BUCKETS)}


def classify(entry: dict) -> str:
    """Attribution bucket for one flight-recorder entry."""
    comm = str(entry.get("comm", ""))
    op = str(entry.get("op", ""))
    routing = str(entry.get("routing", ""))
    if comm == _CHUNK_COMM:
        return "quantize"
    if comm.startswith(_PS_SERVER_PREFIX):
        if "fwd=1" in routing:
            return "chain_forward"
        if op == "request":
            return "serve_queue"
        return "ps_apply"
    if comm.startswith(_PS_PREFIX):
        return "ps_wire"
    if comm in (_HANDLE_COMM, _RESIZE_COMM):
        return "wait"
    if op.startswith("engine."):
        return "compute"
    return "collective"


def _entries_of(data: dict) -> List[dict]:
    return data.get("snapshot", {}).get(
        "flight_recorder", {}
    ).get("entries", [])


def _span_times(e: dict) -> Optional[Tuple[float, float]]:
    """(t0, t1) wall seconds, or None for unusable entries."""
    try:
        t0 = float(e["t_issue"])
    except (KeyError, TypeError, ValueError):
        return None
    t1 = e.get("t_complete")
    try:
        t1 = float(t1) if t1 is not None else t0
    except (TypeError, ValueError):
        t1 = t0
    return t0, max(t0, t1)


def _shared_streams(
    ranks: Dict[int, dict],
) -> Dict[str, Dict[int, Dict[int, dict]]]:
    """comm -> rank -> seq -> entry for shared (non-PS, non-local)
    streams — the same join detect_desync/rank_stragglers use."""
    streams: Dict[str, Dict[int, Dict[int, dict]]] = {}
    for rank, data in ranks.items():
        for e in _entries_of(data):
            comm = str(e.get("comm", ""))
            if (
                comm.startswith(_PS_PREFIX)
                or comm in (_CHUNK_COMM, _HANDLE_COMM, _RESIZE_COMM)
            ):
                continue
            streams.setdefault(comm, {}).setdefault(
                rank, {}
            )[e.get("seq")] = e
    return streams


# ---------------------------------------------------------------------------
# flow events
# ---------------------------------------------------------------------------


def flow_events(
    ranks: Dict[int, dict],
    flight_tid: int = 0xF11,
    max_flows: int = 0,
) -> List[dict]:
    """Perfetto flow arrows with ABSOLUTE wall-µs timestamps (the caller
    normalizes to the merged trace's base, exactly like slice events).

    Two flow families:

    - ``collective``: entries sharing ``(comm, seq)`` across >=2 ranks
      are one logical collective; the arrow runs earliest entrant ->
      ... -> last entrant (the straggler direction reads left to
      right in Perfetto).
    - ``ps``: a trace-stamped client RPC entry (``span`` S) points at
      every entry on any rank whose ``parent`` is S — the wire-carried
      causal edge (chain forwards included: each hop re-parents).

    ``max_flows`` > 0 caps the emitted flow count (earliest first) so a
    long journal cannot bloat the merged trace unboundedly; 0 = no cap.
    """
    flows: List[Tuple[float, List[dict]]] = []
    # collective flows, joined by (comm, seq)
    for comm, by_rank in sorted(_shared_streams(ranks).items()):
        if len(by_rank) < 2:
            continue
        seqs = set()
        for s in by_rank.values():
            seqs.update(s)
        for seq in sorted(s for s in seqs if s is not None):
            parts = []
            for rank, s in sorted(by_rank.items()):
                e = s.get(seq)
                if e is None:
                    continue
                ts = _span_times(e)
                if ts is None:
                    continue
                parts.append((ts[0], rank, e))
            if len(parts) < 2:
                continue
            parts.sort()
            fid = f"{fnv1a64('flow', comm, seq):#x}"
            evs = []
            for i, (t0, rank, e) in enumerate(parts):
                ph = "s" if i == 0 else (
                    "f" if i == len(parts) - 1 else "t"
                )
                ev = {
                    "ph": ph,
                    "id": fid,
                    "name": f"collective.{e.get('op', '?')}",
                    "cat": "flow.collective",
                    # +1µs: bind INSIDE the flight slice at this ts
                    "ts": t0 * 1e6 + 1.0,
                    "pid": rank,
                    "tid": flight_tid,
                }
                if ph == "f":
                    ev["bp"] = "e"
                evs.append(ev)
            flows.append((parts[0][0], evs))
    # PS causal flows, joined by the wire-carried span ids
    by_parent: Dict[int, List[Tuple[float, int, dict]]] = {}
    senders: Dict[int, Tuple[float, int, dict]] = {}
    for rank, data in ranks.items():
        for e in _entries_of(data):
            span = int(e.get("span") or 0)
            parent = int(e.get("parent") or 0)
            ts = _span_times(e)
            if ts is None:
                continue
            if span and str(e.get("comm", "")).startswith(_PS_PREFIX):
                if not str(e.get("comm", "")).startswith(
                    _PS_SERVER_PREFIX
                ):
                    senders[span] = (ts[0], rank, e)
            if parent:
                by_parent.setdefault(parent, []).append(
                    (ts[0], rank, e)
                )
    for span, src in sorted(senders.items()):
        children = by_parent.get(span)
        if not children:
            continue
        t0, rank, e = src
        fid = f"{fnv1a64('psflow', int(e.get('trace') or 0), span):#x}"
        evs = [{
            "ph": "s", "id": fid,
            "name": f"ps.{e.get('op', '?')}",
            "cat": "flow.ps",
            "ts": t0 * 1e6 + 1.0, "pid": rank, "tid": flight_tid,
        }]
        ordered = sorted(children)
        for i, (ct0, crank, _ce) in enumerate(ordered):
            ph = "f" if i == len(ordered) - 1 else "t"
            ev = {
                "ph": ph, "id": fid,
                "name": f"ps.{e.get('op', '?')}",
                "cat": "flow.ps",
                "ts": ct0 * 1e6 + 1.0, "pid": crank, "tid": flight_tid,
            }
            if ph == "f":
                ev["bp"] = "e"
            evs.append(ev)
        flows.append((t0, evs))
    flows.sort(key=lambda f: f[0])
    if max_flows and max_flows > 0:
        flows = flows[:max_flows]
    out: List[dict] = []
    for _, evs in flows:
        out.extend(evs)
    return out


# ---------------------------------------------------------------------------
# critical-path attribution
# ---------------------------------------------------------------------------


def _sweep(intervals: List[Tuple[float, float, str, float]],
           t0: float, t1: float) -> Dict[str, float]:
    """Attribute [t0, t1] to buckets: at every elementary segment the
    covering interval with the latest start (innermost) wins, priority
    breaking ties; uncovered time is ``compute``. Returns seconds."""
    buckets: Dict[str, float] = {}
    if t1 <= t0:
        return buckets
    cuts = {t0, t1}
    for a, b, _bucket, _start in intervals:
        if b <= t0 or a >= t1:
            continue
        cuts.add(max(a, t0))
        cuts.add(min(b, t1))
    points = sorted(cuts)
    for a, b in zip(points, points[1:]):
        if b <= a:
            continue
        best = None
        for ia, ib, bucket, start in intervals:
            if ia <= a and b <= ib:
                key = (start, _PRIORITY.get(bucket, 0))
                if best is None or key > best[0]:
                    best = (key, bucket)
        bucket = best[1] if best else "compute"
        buckets[bucket] = buckets.get(bucket, 0.0) + (b - a)
    return buckets


def critical_path(ranks: Dict[int, dict]) -> dict:
    """Per-rank wall-time attribution + cross-rank dominance.

    The report's contract: for every rank, ``sum(buckets_us) ==
    window_us`` exactly (gaps are attributed, not dropped), so the CI
    criterion "bucket sum covers >=95% of step wall time" holds by
    construction whenever a window exists at all."""
    per_rank_iv: Dict[int, List[Tuple[float, float, str, float]]] = {}
    windows: Dict[int, Tuple[float, float]] = {}
    for rank, data in ranks.items():
        ivs: List[Tuple[float, float, str, float]] = []
        lo = hi = None
        for e in _entries_of(data):
            ts = _span_times(e)
            if ts is None:
                continue
            a, b = ts
            lo = a if lo is None else min(lo, a)
            hi = b if hi is None else max(hi, b)
            if b > a:
                ivs.append((a, b, classify(e), a))
        if lo is None:
            continue
        per_rank_iv[rank] = ivs
        windows[rank] = (lo, hi)
    # synchronous-collective wait: for each shared (comm, seq), ranks
    # that entered before the last entrant are WAITING until it arrives;
    # that portion of their collective interval is reclassified. The
    # last entrant's lateness is charged to its dominance score.
    dominance: Dict[int, float] = {}
    streams = _shared_streams(ranks)
    for comm, by_rank in streams.items():
        if len(by_rank) < 2 or comm == _RESIZE_COMM:
            continue
        seqs = set()
        for s in by_rank.values():
            seqs.update(s)
        for seq in seqs:
            times = {}
            for rank, s in by_rank.items():
                e = s.get(seq)
                ts = _span_times(e) if e is not None else None
                if ts is not None:
                    times[rank] = ts[0]
            if len(times) < 2:
                continue
            t_last = max(times.values())
            last_rank = max(times, key=lambda r: (times[r], r))
            caused = 0.0
            for rank, t in times.items():
                if rank == last_rank or t >= t_last:
                    continue
                caused += t_last - t
                # innermost-wins sweep: start the wait interval AT the
                # rank's own entry (same start as the collective slice,
                # higher priority wins the tie)
                per_rank_iv.setdefault(rank, []).append(
                    (t, t_last, "wait", t)
                )
            dominance[last_rank] = dominance.get(last_rank, 0.0) + caused
    report_ranks: Dict[str, dict] = {}
    fleet: Dict[str, float] = {}
    for rank in sorted(windows):
        t0, t1 = windows[rank]
        buckets = _sweep(per_rank_iv.get(rank, []), t0, t1)
        total = t1 - t0
        bucket_us = {
            b: round(s * 1e6, 3) for b, s in sorted(buckets.items())
        }
        for b, s in buckets.items():
            fleet[b] = fleet.get(b, 0.0) + s
        dominant = max(
            (b for b in buckets if b != "compute"),
            key=lambda b: buckets[b],
            default=None,
        )
        report_ranks[str(rank)] = {
            "window_us": round(total * 1e6, 3),
            "buckets_us": bucket_us,
            "coverage": 1.0 if total > 0 else 0.0,
            "dominant": dominant or "compute",
            "dominance_us": round(dominance.get(rank, 0.0) * 1e6, 3),
        }
    dom_rank = max(
        dominance, key=lambda r: (dominance[r], -r), default=None,
    )
    fleet_total = sum(fleet.values())
    return {
        "ranks": report_ranks,
        "fleet_buckets_us": {
            b: round(s * 1e6, 3) for b, s in sorted(fleet.items())
        },
        "fleet_dominant": max(
            (b for b in fleet if b != "compute"),
            key=lambda b: fleet[b], default=None,
        ) if fleet else None,
        "coverage": 1.0 if fleet_total > 0 else 0.0,
        "dominant_rank": dom_rank,
        "dominance_us": {
            str(r): round(s * 1e6, 3)
            for r, s in sorted(dominance.items())
        },
    }


# ---------------------------------------------------------------------------
# overlap ledger
# ---------------------------------------------------------------------------


def overlap_ledger(ranks: Dict[int, dict]) -> dict:
    """Measured overlap fraction per plan_id from the chunk-pipeline
    sub-entries (``comm == "chunks"``, ``plan == "<plan_id>#<idx>"``).

    serial   = sum of per-chunk durations (what depth=1 would cost)
    span     = last completion - first issue (what actually elapsed)
    measured = 1 - span/serial, clamped to [0, 1]

    Judged against :func:`modeled_overlap_fraction` of the SAME plan's
    stage costs by callers that hold the plan (this module never imports
    the schedule IR)."""
    per_plan: Dict[str, List[Tuple[float, float]]] = {}
    for data in ranks.values():
        for e in _entries_of(data):
            if str(e.get("comm", "")) != _CHUNK_COMM:
                continue
            plan = str(e.get("plan", ""))
            base = plan.rsplit("#", 1)[0] if "#" in plan else plan
            if not base:
                continue
            ts = _span_times(e)
            if ts is None or ts[1] <= ts[0]:
                continue
            per_plan.setdefault(base, []).append(ts)
    plans = {}
    for plan, spans in sorted(per_plan.items()):
        if len(spans) < 2:
            continue  # a single chunk has nothing to overlap
        serial = sum(b - a for a, b in spans)
        wall = max(b for _, b in spans) - min(a for a, _ in spans)
        if serial <= 0:
            continue
        measured = max(0.0, min(1.0, 1.0 - wall / serial))
        plans[plan] = {
            "chunks": len(spans),
            "serial_us": round(serial * 1e6, 3),
            "span_us": round(wall * 1e6, 3),
            "measured_fraction": round(measured, 4),
        }
    return {"plans": plans}


def modeled_overlap_fraction(
    stage_costs_us: Dict[str, float], depth: int
) -> float:
    """The analytic stage-overlap as a fraction comparable to the
    ledger's measured one: a depth-d pipeline over stages with per-chunk
    costs ``fill = sum(stages)`` and ``bottleneck = max(stages)`` takes
    ``fill + (depth-1)*bottleneck`` against ``depth*fill`` serial."""
    depth = max(1, int(depth))
    fill = sum(float(v) for v in stage_costs_us.values())
    if fill <= 0 or depth == 1:
        return 0.0
    bottleneck = max(float(v) for v in stage_costs_us.values())
    pipelined = fill + (depth - 1) * bottleneck
    serial = depth * fill
    return max(0.0, min(1.0, 1.0 - pipelined / serial))


def measured_overlap_fraction(
    serial_us: float, pipelined_us: float
) -> float:
    """Overlap fraction from two measured lap times (depth=1 vs depth=d
    of the same work): how much of the serial cost the pipeline hid."""
    if serial_us <= 0:
        return 0.0
    return max(0.0, min(1.0, 1.0 - pipelined_us / serial_us))


# ---------------------------------------------------------------------------
# serve hop decomposition
# ---------------------------------------------------------------------------


def serve_hops(ranks: Dict[int, dict]) -> dict:
    """Client-side serve RPC entries joined to the server-side work they
    caused (wire span ids): each hop decomposed into server time vs
    wire+queueing remainder — which hop burned a slow request's budget."""
    server_by_parent: Dict[int, Tuple[float, float]] = {}
    for data in ranks.values():
        for e in _entries_of(data):
            if (
                str(e.get("comm", "")).startswith(_PS_SERVER_PREFIX)
                and str(e.get("op", "")) == "request"
            ):
                parent = int(e.get("parent") or 0)
                ts = _span_times(e)
                if parent and ts is not None:
                    server_by_parent[parent] = ts
    hops = []
    for rank, data in sorted(ranks.items()):
        for e in _entries_of(data):
            if (
                not str(e.get("comm", "")).startswith(_PS_PREFIX)
                or str(e.get("comm", "")).startswith(_PS_SERVER_PREFIX)
                or str(e.get("op", "")) != "request"
            ):
                continue
            ts = _span_times(e)
            span = int(e.get("span") or 0)
            if ts is None or not span:
                continue
            client_us = (ts[1] - ts[0]) * 1e6
            srv = server_by_parent.get(span)
            srv_us = (srv[1] - srv[0]) * 1e6 if srv else None
            hops.append({
                "rank": rank,
                "client_us": round(client_us, 3),
                "server_us": (
                    round(srv_us, 3) if srv_us is not None else None
                ),
                "wire_us": (
                    round(max(0.0, client_us - srv_us), 3)
                    if srv_us is not None else None
                ),
            })
    decomposed = [h for h in hops if h["server_us"] is not None]
    summary = None
    if decomposed:
        n = len(decomposed)
        summary = {
            "hops": n,
            "mean_client_us": round(
                sum(h["client_us"] for h in decomposed) / n, 3
            ),
            "mean_server_us": round(
                sum(h["server_us"] for h in decomposed) / n, 3
            ),
            "mean_wire_us": round(
                sum(h["wire_us"] for h in decomposed) / n, 3
            ),
        }
    return {"hops": hops, "summary": summary}
