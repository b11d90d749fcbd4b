"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

The reference shipped no metric surface at all (nvprof windows and VLOG
macros were the whole story, SURVEY.md §5); production serving needs the
numbers themselves. This registry is deliberately tiny and dependency-free:

- every metric is **labelled** (a ``dict`` of string label -> value) and
  **thread-safe** (one lock per metric; the hot path is one dict update);
- histograms use **fixed bucket boundaries** chosen at creation, so
  ``observe`` is O(len(buckets)) with zero allocation after the first
  labelset;
- the registry renders both a JSON :meth:`snapshot` (the ``telemetry.dump``
  payload) and Prometheus text exposition (:meth:`prometheus`);
- every mutation stamps a process-wide **generation**, so
  ``snapshot(since=g)`` returns only the families that changed after
  generation ``g`` — the bounded-delta payload the live telemetry
  exporter streams (O(changes) per interval, not O(metrics));
- external producers plug in as **collectors** — callables returning a
  plain dict merged into the snapshot (``utils.tracing.wire_stats`` is
  registered this way, so the logical-vs-wire byte accounting appears in
  every snapshot without tracing depending on this module).

Metric *objects* are process-lived: instrumented modules fetch them once at
import and call ``inc``/``set``/``observe`` forever after; :meth:`reset`
clears the recorded series but never invalidates the objects.
"""

from __future__ import annotations

import threading
from ..analysis import lockmon as _lockmon
from typing import Callable, Dict, Optional, Sequence, Tuple

# Default histogram boundaries: latency-shaped, spanning 10µs .. 100s.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-5, 1e-4, 1e-3, 1e-2, 0.1, 0.5, 1.0, 5.0, 10.0, 100.0
)

# Quantiles estimated from bucket counts in every snapshot / exposition
# (the cross-rank analyzer reads these; bucket counts alone don't rank
# stragglers or express an SLO).
QUANTILES: Tuple[float, ...] = (0.5, 0.95, 0.99)


# ---------------------------------------------------------------------------
# change generations: one process-wide monotone counter stamped on every
# metric mutation. The delta contract the live exporter depends on: a
# change stamped at generation g is returned by every snapshot(since=s)
# with s < g — the stamp happens inside the metric's own lock together
# with the data write, and the counter has its own lock, so a snapshot
# that read generation g0 *before* scanning families can never miss a
# change it did not include (the change's stamp is then > g0 and the
# next delta picks it up).
# ---------------------------------------------------------------------------

_GEN_LOCK = _lockmon.make_lock("registry.py:_generation")
_generation = 0


def _bump_generation() -> int:
    global _generation
    with _GEN_LOCK:
        _generation += 1
        return _generation


def metrics_generation() -> int:
    """The current process-wide metrics change generation."""
    with _GEN_LOCK:
        return _generation


def _label_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(key: Tuple[Tuple[str, str], ...]) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


def _prom_labels(key: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = _lockmon.make_lock("registry.py:_Metric._lock")
        self._series: Dict[Tuple[Tuple[str, str], ...], object] = {}
        # creation counts as a change: a family registered after a delta
        # baseline must appear in the next delta even if never bumped
        self._gen = _bump_generation()

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self._gen = _bump_generation()

    def snapshot(self) -> dict:
        with self._lock:
            series = {
                _label_str(k): self._snap_value(v)
                for k, v in self._series.items()
            }
        return {"kind": self.kind, "help": self.help, "series": series}

    def _snap_value(self, v):
        return v

    def _prom_lines(self):
        with self._lock:
            items = list(self._series.items())
        for key, v in items:
            yield f"{self.name}{_prom_labels(key)} {v}"

    def prometheus(self) -> str:
        head = []
        if self.help:
            head.append(f"# HELP {self.name} {self.help}")
        head.append(f"# TYPE {self.name} {self.kind}")
        return "\n".join(head + list(self._prom_lines()))


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0) + value
            self._gen = _bump_generation()

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0)

    def total(self) -> float:
        """Sum over every labelset (the 'is anything happening' read)."""
        with self._lock:
            return sum(self._series.values())


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = value
            self._gen = _bump_generation()

    def value(self, **labels) -> Optional[float]:
        with self._lock:
            return self._series.get(_label_key(labels))


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket boundary")
        self.buckets = bs

    def observe(self, value: float, **labels) -> None:
        k = _label_key(labels)
        with self._lock:
            state = self._series.get(k)
            if state is None:
                # counts per finite bucket + one +Inf overflow slot
                state = [[0] * (len(self.buckets) + 1), 0.0, 0]
                self._series[k] = state
            counts, _, _ = state
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            state[1] += value
            state[2] += 1
            self._gen = _bump_generation()

    def _quantile_estimates(self, counts, n) -> Dict[str, float]:
        """p50/p95/p99 from the bucket counts: the classic Prometheus
        ``histogram_quantile`` estimator — find the bucket holding the
        target rank, interpolate linearly within its boundaries. Values in
        the +Inf bucket clamp to the top finite boundary (the estimator
        has no upper edge to interpolate against)."""
        out: Dict[str, float] = {}
        if n <= 0:
            return out
        for q in QUANTILES:
            target = q * n
            cum = 0
            val = float(self.buckets[-1])
            for i, c in enumerate(counts[:-1]):
                if cum + c >= target:
                    lo = float(self.buckets[i - 1]) if i else 0.0
                    hi = float(self.buckets[i])
                    val = lo + (hi - lo) * ((target - cum) / c) if c else hi
                    break
                cum += c
            out[str(q)] = val
        return out

    def quantiles(self, **labels) -> Dict[str, float]:
        """Estimated quantiles (:data:`QUANTILES`) for one labelset."""
        with self._lock:
            state = self._series.get(_label_key(labels))
            if state is None:
                return {}
            counts, _, n = list(state[0]), state[1], state[2]
        return self._quantile_estimates(counts, n)

    def count(self, **labels) -> int:
        with self._lock:
            state = self._series.get(_label_key(labels))
            return state[2] if state else 0

    def total_count(self) -> int:
        with self._lock:
            return sum(s[2] for s in self._series.values())

    def _snap_value(self, state):
        counts, total, n = state
        return {
            "buckets": {
                **{str(b): counts[i] for i, b in enumerate(self.buckets)},
                "+Inf": counts[-1],
            },
            "sum": total,
            "count": n,
            "quantiles": self._quantile_estimates(counts, n),
        }

    def _prom_lines(self):
        with self._lock:
            items = [
                (k, (list(s[0]), s[1], s[2])) for k, s in self._series.items()
            ]
        for key, (counts, total, n) in items:
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += counts[i]
                le = 'le="%s"' % b
                yield f"{self.name}_bucket{_prom_labels(key, le)} {cum}"
            inf = 'le="+Inf"'
            yield f"{self.name}_bucket{_prom_labels(key, inf)} {n}"
            yield f"{self.name}_sum{_prom_labels(key)} {total}"
            yield f"{self.name}_count{_prom_labels(key)} {n}"

    def prometheus(self) -> str:
        # estimated quantiles are exposed as a SEPARATE `<name>_quantile`
        # gauge family: a histogram family may legally carry only
        # _bucket/_sum/_count samples, and strict OpenMetrics parsers
        # reject bare quantile-labelled lines inside it
        out = [super().prometheus()]
        with self._lock:
            items = [
                (k, (list(s[0]), s[2])) for k, s in self._series.items()
            ]
        qlines = []
        for key, (counts, n) in items:
            for q, v in self._quantile_estimates(counts, n).items():
                quant = f'quantile="{q}"'
                qlines.append(
                    f"{self.name}_quantile{_prom_labels(key, quant)} {v}"
                )
        if qlines:
            out.append(
                f"# HELP {self.name}_quantile estimated quantiles of "
                f"{self.name} (from bucket counts)"
            )
            out.append(f"# TYPE {self.name}_quantile gauge")
            out.extend(qlines)
        return "\n".join(out)


class MetricsRegistry:
    """Name -> metric table plus pluggable snapshot collectors."""

    def __init__(self):
        self._lock = _lockmon.make_lock("registry.py:MetricsRegistry._lock")
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: Dict[str, Callable[[], dict]] = {}

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            elif "buckets" in kw and tuple(
                sorted(float(b) for b in kw["buckets"])
            ) != m.buckets:
                # silently bucketing a second caller's observations by the
                # first caller's boundaries would corrupt its distribution
                raise ValueError(
                    f"histogram {name!r} already registered with buckets "
                    f"{m.buckets}, requested {tuple(kw['buckets'])}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def register_collector(self, name: str, fn: Callable[[], dict]) -> None:
        """Attach an external producer; ``fn()`` runs at snapshot time and
        its dict lands under ``name``. Re-registering replaces (the PS
        listener re-registers on every transport bootstrap)."""
        with self._lock:
            self._collectors[name] = fn

    def unregister_collector(self, name: str) -> None:
        """Detach a producer (a stopped watchdog must not keep feeding —
        or be kept alive by — snapshots)."""
        with self._lock:
            self._collectors.pop(name, None)

    def generation(self) -> int:
        """Process-wide metrics change generation (see module notes)."""
        return metrics_generation()

    def snapshot(self, since: Optional[int] = None) -> dict:
        """Full snapshot (``since=None``, the historical flat form), or a
        **bounded delta**: only the typed families whose change
        generation is > ``since``, wrapped as ``{"generation", "since",
        "families", "collectors"}``. The generation is read BEFORE the
        family scan, so a concurrent change is either included here or
        guaranteed to appear in the next delta — never silently lost.
        Collector producers are external (their change times are
        unknowable), so every delta carries them verbatim."""
        g0 = metrics_generation() if since is not None else 0
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors.items())
        if since is not None:
            families = {}
            for m in metrics:
                with m._lock:
                    changed = m._gen > since
                if changed:
                    families[m.name] = m.snapshot()
            out: dict = {
                "generation": g0,
                "since": since,
                "families": families,
                "collectors": {},
            }
            sink = out["collectors"]
        else:
            out = {m.name: m.snapshot() for m in metrics}
            sink = out
        for name, fn in collectors:
            try:
                sink[name] = fn()
            except Exception as e:  # noqa: BLE001 - a broken producer must
                # never take the snapshot down with it
                sink[name] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def prometheus(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        return "\n".join(m.prometheus() for m in metrics) + (
            "\n" if metrics else ""
        )

    def reset(self) -> None:
        """Clear every recorded series; metric objects (held by the
        instrumented modules) and collectors stay registered."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()
