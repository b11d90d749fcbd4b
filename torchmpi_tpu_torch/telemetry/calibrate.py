"""Cost-model calibration from live-plane dispatch samples.

The port of ``torchmpi_tpu/telemetry/calibrate.py``; it differs in the
payload descriptors it reads (the port's flight entries name a dtype as
torch does, ``torch.float32``) and in its cache's default path. The
schedule compiler's ``plan_cost_*`` constants are hand-set analytic
defaults; their job is to *order* candidate plans, not to predict wall
time. This module closes the calibration loop: every
completed flight-recorder entry the live telemetry plane streams is a
**measured dispatch latency** keyed

    (op, comm, wire, payload bucket, plan_id)

— the same identity the plan cache decides on (``plan_id`` hashes the
topology fingerprint, so topology rides along). A :class:`SampleStore`
accumulates them (in the fleet aggregator, or directly from a local
recorder snapshot), :func:`fit_store` fits a per-(op, comm, wire)
alpha-beta line over the bucket medians and emits

- a **calibrated cost table**: per-(op, comm, wire, bucket, plan_id)
  measured medians + fitted predictions, applied to plan selection by
  ``schedule.calibrate()`` via :func:`~..schedule.cost.set_calibration`
  (persisted like ``tune_plan``, re-applied by ``start()``);
- a **calibration report**: modeled-vs-measured error of the hand-set
  analytic model next to the fitted one, per group and overall — the
  evidence the calibrated model actually predicts better.

Stdlib-only: the fleet aggregator and the offline CLI path both import
it.
"""

from __future__ import annotations

import json
import os
import statistics
from pathlib import Path
from typing import Callable, Dict, List, Optional

from .. import constants

_MIB = float(1 << 20)

#: per-(key) sample cap: calibration needs medians, not history
MAX_SAMPLES_PER_KEY = 512

_DTYPE_SIZES = {
    "float32": 4, "float64": 8, "bfloat16": 2, "float16": 2,
    "int32": 4, "int64": 8, "int16": 2, "int8": 1, "uint8": 1,
    "bool": 1, "complex64": 8, "complex128": 16,
}

# ops whose entries are calibration samples (collective dispatches; PS
# RPCs, engine steps, waits and resize barriers have their own health
# surfaces and no plan to price)
_SAMPLED_PREFIXES = (
    "allreduce", "reduce", "reducescatter", "broadcast", "allgather",
    "gather", "scatter", "alltoall", "sendrecv", "hier_", "staged_",
    "tree_",
)


def payload_nbytes(payload: str, routing: str = "") -> Optional[int]:
    """Per-rank payload bytes from a flight entry's payload descriptor
    (``"(2, 32):float32"``, or ``"(2, 32):torch.float32"`` as the port's
    entries name a torch dtype). Dispatch payloads are rank-stacked — the
    leading dim is the world — so flat payloads count
    ``prod(shape[1:])`` elements; ``fused`` entries carry the per-tensor
    size tuple instead and count the sum (matching the compiler's total
    used for bucketing)."""
    if not payload or ":" not in payload:
        return None
    shape_s, _, dtype_s = payload.rpartition(":")
    dtype_s = dtype_s.strip()
    itemsize = _DTYPE_SIZES.get(dtype_s[6:] if dtype_s.startswith("torch.") else dtype_s)
    if itemsize is None:
        return None
    shape_s = shape_s.strip()
    if not (shape_s.startswith("(") and shape_s.endswith(")")):
        return None
    try:
        dims = [int(tok) for tok in shape_s[1:-1].split(",") if tok.strip()]
    except ValueError:
        return None
    if not dims:
        return None
    if routing == "fused":
        nelem = sum(dims)
    else:
        nelem = 1
        for d in dims[1:]:
            nelem *= d
    return max(1, nelem) * itemsize


def _bucket(nbytes: int) -> int:
    """Pow-2 payload bucket — must match the plan cache's
    ``schedule.payload_bucket`` (duplicated to keep this module free of
    the schedule import for the aggregator path)."""
    return max(1, int(nbytes)).bit_length()


def sample_key(op: str, comm: str, wire: str, bucket: int,
               plan_id: str) -> str:
    return f"{op}|{comm}|{wire}|b{bucket}|{plan_id}"


def split_key(key: str) -> Optional[dict]:
    parts = key.split("|")
    if len(parts) != 5 or not parts[3].startswith("b"):
        return None
    try:
        bucket = int(parts[3][1:])
    except ValueError:
        return None
    return {"op": parts[0], "comm": parts[1], "wire": parts[2],
            "bucket": bucket, "plan_id": parts[4]}


class SampleStore:
    """Measured dispatch latencies, bounded per key, JSON-serializable.

    ``samples[key] = {"us": [...], "nbytes": int}`` — the ``us`` list is
    capped at :data:`MAX_SAMPLES_PER_KEY` (newest kept; medians need a
    window, not history)."""

    def __init__(self):
        self.samples: Dict[str, dict] = {}

    def __len__(self) -> int:
        return sum(len(s["us"]) for s in self.samples.values())

    def add(self, op: str, comm: str, wire: str, nbytes: int,
            plan_id: str, us: float) -> None:
        key = sample_key(op, comm, wire, _bucket(nbytes), plan_id)
        ent = self.samples.setdefault(key, {"us": [], "nbytes": int(nbytes)})
        ent["us"].append(round(float(us), 3))
        if len(ent["us"]) > MAX_SAMPLES_PER_KEY:
            del ent["us"][: len(ent["us"]) - MAX_SAMPLES_PER_KEY]

    def add_entry(self, entry: dict) -> bool:
        """Ingest one flight-recorder entry dict; returns whether it was
        a calibration sample (completed, planned, payload parseable).

        Chunk sub-entries of a pipelined dispatch (``routing="chunk"`` /
        the rank-local ``chunks`` stream) are NOT samples: their
        per-chunk timings would land in the *chunk-size* payload bucket
        and bias the medians the fit consumes. The parent dispatch entry
        carries the logical payload, and its plan_id carries the depth
        (``...@p4``), so pipelined and unpipelined samples stay
        comparable within one logical bucket."""
        if entry.get("status") != "completed" or not entry.get("plan"):
            return False
        if entry.get("routing") == "chunk" or entry.get("comm") == "chunks":
            return False
        op = entry.get("op", "")
        if not op.startswith(_SAMPLED_PREFIXES):
            return False
        t0, t1 = entry.get("t_issue"), entry.get("t_complete")
        if not t0 or not t1 or t1 < t0:
            return False
        nbytes = payload_nbytes(
            entry.get("payload", ""), entry.get("routing", "")
        )
        if nbytes is None:
            return False
        self.add(op, entry.get("comm", "?"), entry.get("wire", "") or "full",
                 nbytes, entry["plan"], (float(t1) - float(t0)) * 1e6)
        return True

    def merge(self, other: "SampleStore") -> None:
        for key, ent in other.samples.items():
            mine = self.samples.setdefault(
                key, {"us": [], "nbytes": ent["nbytes"]}
            )
            mine["us"].extend(ent["us"])
            if len(mine["us"]) > MAX_SAMPLES_PER_KEY:
                del mine["us"][: len(mine["us"]) - MAX_SAMPLES_PER_KEY]

    # -- (de)serialization -------------------------------------------------
    def to_json(self) -> dict:
        return {"version": 1, "samples": self.samples}

    @classmethod
    def from_json(cls, data: dict) -> "SampleStore":
        store = cls()
        for key, ent in (data.get("samples") or {}).items():
            if split_key(key) is None:
                continue
            store.samples[key] = {
                "us": [float(u) for u in ent.get("us", [])],
                "nbytes": int(ent.get("nbytes", 0)),
            }
        return store

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
        tmp.write_text(json.dumps(self.to_json(), indent=1, sort_keys=True))
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path) -> "SampleStore":
        return cls.from_json(json.loads(Path(path).read_text()))


def samples_from_entries(entries: List[dict],
                         store: Optional[SampleStore] = None) -> SampleStore:
    """Build (or extend) a :class:`SampleStore` from flight-recorder
    entry dicts (the in-process path), mirroring what the fleet
    aggregator accumulates from streamed tails."""
    store = store if store is not None else SampleStore()
    for e in entries:
        store.add_entry(e)
    return store


# ---------------------------------------------------------------------------
# persistence (the tune_plan idiom: a JSON cache start() re-applies)
# ---------------------------------------------------------------------------


def default_path() -> Path:
    env = os.environ.get("TORCHMPI_TPU_CALIBRATION_CACHE", "")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "torchmpi_tpu_torch" / "calibration.json"


def save_calibration(result: dict, path=None) -> Path:
    path = Path(path) if path is not None else default_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
    tmp.write_text(json.dumps(result, indent=1, sort_keys=True))
    os.replace(tmp, path)
    return path


def load_calibration_file(path=None) -> Optional[dict]:
    path = Path(path) if path is not None else default_path()
    try:
        data = json.loads(path.read_text())
    except (OSError, ValueError):
        return None
    return data if isinstance(data, dict) and "table" in data else None


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------


def _fit_line(points: List[tuple]) -> tuple:
    """Least-squares ``us = alpha + beta * MiB`` over (nbytes, us)
    points, clamped non-negative (a negative launch latency or
    bandwidth term is a fit artifact, not physics)."""
    if not points:
        return 0.0, 0.0
    if len(points) == 1:
        return float(points[0][1]), 0.0
    xs = [b / _MIB for b, _ in points]
    ys = [u for _, u in points]
    n = len(points)
    mx, my = sum(xs) / n, sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    if sxx <= 0:
        return max(0.0, my), 0.0
    beta = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
    alpha = my - beta * mx
    if beta < 0:
        # payload-independent regime (dispatch dominated): flat fit
        return max(0.0, my), 0.0
    if alpha < 0:
        return 0.0, sum(ys) / max(sum(xs), 1e-12)
    return alpha, beta


def fit_store(store: SampleStore,
              plan_lookup: Optional[Callable[[str], object]] = None) -> dict:
    """Fit the calibrated cost model from a sample store.

    Returns ``{"fitted", "table", "report"}``:

    - ``fitted``: per-(op, comm, wire) group, the alpha/beta line over
      its bucket medians;
    - ``table``: per sample key, the measured median, sample count and
      the group fit's prediction — the persisted cost model
      ``schedule.cost.set_calibration`` consumes;
    - ``report``: per group and overall, mean |error| of the hand-set
      analytic model (``plan_lookup(plan_id)`` -> Plan priced by
      ``schedule.cost.estimate_us``; skipped when the plan is unknown,
      e.g. offline) vs the fitted model, against the measured medians.

    The analytic estimator is imported lazily so this module stays
    importable without the schedule package fully loaded."""
    min_n = int(constants.get("plan_calibration_min_samples"))
    groups: Dict[str, List[tuple]] = {}
    medians: Dict[str, dict] = {}
    for key, ent in sorted(store.samples.items()):
        parts = split_key(key)
        if parts is None or len(ent["us"]) < max(1, min_n):
            continue
        med = float(statistics.median(ent["us"]))
        medians[key] = {
            "us": round(med, 3),
            "n": len(ent["us"]),
            "nbytes": ent["nbytes"],
            **parts,
        }
        gkey = f"{parts['op']}|{parts['comm']}|{parts['wire']}"
        groups.setdefault(gkey, []).append((ent["nbytes"], med))

    fitted = {}
    for gkey, points in sorted(groups.items()):
        # one point per bucket: multiple plans in a bucket average first
        by_bytes: Dict[int, List[float]] = {}
        for b, u in points:
            by_bytes.setdefault(b, []).append(u)
        pts = sorted((b, sum(us) / len(us)) for b, us in by_bytes.items())
        alpha, beta = _fit_line(pts)
        fitted[gkey] = {
            "alpha_us": round(alpha, 3),
            "beta_us_per_mib": round(beta, 3),
            "points": len(pts),
        }

    estimate_us = None
    if plan_lookup is not None:
        try:
            from ..schedule.cost import estimate_us as _est

            estimate_us = _est
        except Exception:  # noqa: BLE001 - offline fit stays usable
            estimate_us = None

    table: Dict[str, dict] = {}
    group_err: Dict[str, dict] = {}
    modeled_errs: List[float] = []
    calibrated_errs: List[float] = []
    for key, med in medians.items():
        gkey = f"{med['op']}|{med['comm']}|{med['wire']}"
        fit = fitted[gkey]
        pred = fit["alpha_us"] + fit["beta_us_per_mib"] * (
            med["nbytes"] / _MIB
        )
        row = {
            "us": med["us"],
            "n": med["n"],
            "nbytes": med["nbytes"],
            "fitted_us": round(pred, 3),
        }
        cal_err = abs(pred - med["us"]) / max(med["us"], 1e-9)
        calibrated_errs.append(cal_err)
        ge = group_err.setdefault(
            gkey, {"modeled": [], "calibrated": [], "buckets": 0}
        )
        ge["calibrated"].append(cal_err)
        ge["buckets"] += 1
        if estimate_us is not None:
            plan = plan_lookup(med["plan_id"])
            if plan is not None:
                modeled = float(estimate_us(plan))
                row["modeled_us"] = round(modeled, 3)
                m_err = abs(modeled - med["us"]) / max(med["us"], 1e-9)
                modeled_errs.append(m_err)
                ge["modeled"].append(m_err)
        table[key] = row

    def _mean_pct(errs: List[float]) -> Optional[float]:
        return round(100.0 * sum(errs) / len(errs), 2) if errs else None

    report = {
        "samples": len(store),
        "keys": len(medians),
        "groups": {
            g: {
                "modeled_err_pct": _mean_pct(ge["modeled"]),
                "calibrated_err_pct": _mean_pct(ge["calibrated"]),
                "buckets": ge["buckets"],
            }
            for g, ge in sorted(group_err.items())
        },
        "modeled_err_pct": _mean_pct(modeled_errs),
        "calibrated_err_pct": _mean_pct(calibrated_errs),
    }
    return {"version": 1, "fitted": fitted, "table": table, "report": report}
