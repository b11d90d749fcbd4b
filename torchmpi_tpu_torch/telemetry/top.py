"""``python -m torchmpi_tpu_torch.telemetry.top`` — live fleet console.

The port of ``torchmpi_tpu/telemetry/top.py``. A plain-text
top(1)-style view over the live telemetry plane's scrape endpoints (a
``FleetAggregator.serve()``'s ``http_port``):

    python -m torchmpi_tpu_torch.telemetry.top 127.0.0.1:9123
    python -m torchmpi_tpu_torch.telemetry.top 127.0.0.1:9123 --once

Each refresh fetches ``/health`` + ``/verdicts`` and renders one row
per rank — last-report age, flight seq high-water and lag behind the
fleet, step p50, BUSY reject count and rolling per-second rate, resize
epoch, dominant PS latency term, dominant critical-path term (what the
rank's wall time is actually spent on, from the causal trace layer's
/criticalpath attribution) — under the streaming verdict summary. ``--once`` prints a single
frame (scripts/tests); the default loops every ``--interval`` seconds,
clearing the screen between frames. Stdlib-only (urllib).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional
from urllib.request import urlopen


def _fetch(base: str, path: str, timeout: float = 5.0) -> dict:
    with urlopen(f"http://{base}{path}", timeout=timeout) as resp:
        return json.loads(resp.read())


def _fmt(v, width: int, suffix: str = "") -> str:
    s = "-" if v is None else f"{v}{suffix}"
    return s.rjust(width)


def render(health: dict, verdicts: dict) -> str:
    lines = []
    for s in verdicts.get("summary", []):
        lines.append(s)
    hw = health.get("fleet_seq_high_water", {})
    if hw:
        lines.append(
            "fleet seq high-water: "
            + ", ".join(f"{c}={s}" for c, s in sorted(hw.items()))
        )
    lines.append(
        f"frames: {health.get('frames_total', 0)}  "
        f"calibration samples: {health.get('samples', 0)}  "
        f"incoherent deltas: {health.get('incoherent_deltas', 0)}"
    )
    lines.append("")
    header = (
        f"{'rank':>5} {'age_s':>7} {'seq_hw':>8} {'lag':>5} "
        f"{'step_p50':>9} {'busy':>6} {'busy/s':>7} {'epoch':>6} "
        f"{'ps_term':>8} {'cp_term':>13} {'state':>6}"
    )
    lines.append(header)
    lines.append("-" * len(header))
    for rank, row in sorted(
        health.get("ranks", {}).items(), key=lambda kv: int(kv[0])
    ):
        seq_hw = max(row.get("seq_high_water", {}).values(), default=None)
        state = row.get("closed") or "live"
        lines.append(
            f"{rank:>5} {_fmt(row.get('age_s'), 7)} {_fmt(seq_hw, 8)} "
            f"{_fmt(row.get('seq_lag'), 5)} "
            f"{_fmt(row.get('step_p50_ms'), 9, 'ms')} "
            f"{_fmt(row.get('busy_rejected'), 6)} "
            f"{_fmt(row.get('busy_rate_per_s'), 7)} "
            f"{_fmt(row.get('resize_epoch'), 6)} "
            f"{_fmt(row.get('ps_dominant'), 8)} "
            f"{_fmt(row.get('cp_dominant'), 13)} {state:>6}"
        )
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m torchmpi_tpu_torch.telemetry.top",
        description="live per-rank fleet console over the telemetry "
        "plane's scrape endpoints",
    )
    ap.add_argument("address", help="aggregator host:port "
                    "(FleetAggregator.serve()'s http_port)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh period, seconds (default 2)")
    ap.add_argument("--once", action="store_true",
                    help="print one frame and exit (no screen clearing)")
    args = ap.parse_args(argv)

    while True:
        try:
            health = _fetch(args.address, "/health")
            verdicts = _fetch(args.address, "/verdicts")
        except OSError as e:
            print(f"top: cannot reach {args.address}: {e}",
                  file=sys.stderr)
            return 1
        frame = render(health, verdicts)
        if args.once:
            print(frame)
            return 0
        # ANSI clear + home: a plain-text live view without curses
        sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
        sys.stdout.flush()
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
