"""The inference server: request handler + brownout ladder + refresher.

The port of ``torchmpi_tpu/serve/server.py``. One :class:`InferenceServer`
per serving process answers each request from the current
:class:`~.weights.WeightCache` snapshot, and runs a background refresher
that fetches fresh weights from the parameter server and swaps them in by
version vector — serving never pauses for a refresh. The snapshot lives
on the parameter server's device: a request's payload becomes a float32
tensor there, ``model_fn(weights, x)`` runs there, and the reply is a
host float32 array, ready for the wire.

The brownout ladder (:func:`brownout_level`) is the graceful-degradation
story for a fleet already at ``supervisor_scale_max_world``:

- level 0 — serve everything;
- level 1 (pending >= ``serve_queue_budget``) — shed QoS 0 with a
  ``shed:<retry_ms>`` reply (the serving analog of BUSY/retry-after);
- level 2 (pending >= 2x budget) — shed everything below the top QoS
  level AND widen the weight-refresh interval/staleness bound by
  ``serve_brownout_staleness_factor`` (staler weights beat missed SLOs);
- level 3 is not computed here: it is the transport admission budget
  itself (``ps_pending_frame_budget``) BUSYing every frame kind.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import constants, telemetry as _telemetry
from .weights import WeightCache, version_vector

_MET = None


def _metric_handles():
    global _MET
    if _MET is None:
        m = _telemetry.metrics
        _MET = (
            m.counter(
                "tm_serve_requests_total",
                "inference requests answered, by result (ok/shed)",
            ),
            m.histogram(
                "tm_serve_latency_seconds",
                "server-side service time per answered request",
            ),
            m.counter(
                "tm_serve_slo_breaches_total",
                "answered requests whose service time exceeded "
                "serve_slo_ms",
            ),
            m.gauge(
                "tm_serve_queue_depth",
                "admitted-frame backlog observed by the request handler",
            ),
            m.gauge(
                "tm_serve_brownout_level",
                "current brownout ladder level (0 = serving everything)",
            ),
            m.counter(
                "tm_serve_weight_swaps_total",
                "weight refreshes that installed a newer version vector",
            ),
            m.gauge(
                "tm_serve_weight_version",
                "sum of the serving snapshot's shard version vector",
            ),
            m.gauge(
                "tm_serve_weight_age_seconds",
                "seconds since the last applied weight swap",
            ),
            m.counter(
                "tm_serve_weight_fetches_total",
                "background weight-refresh fetches, by outcome "
                "(swap/same/failed)",
            ),
        )
    return _MET


def brownout_level(pending: int, budget: int) -> int:
    """The pure ladder: 0 below the serve queue budget, 1 at it, 2 at
    twice it."""
    if budget <= 0 or pending < budget:
        return 0
    if pending < 2 * budget:
        return 1
    return 2


def shed_qos_floor(level: int, qos_levels: int) -> int:
    """Lowest QoS level still SERVED at a brownout level: level 1 sheds
    class 0 only; level 2 sheds everything below the top class."""
    if level <= 0:
        return 0
    if level == 1:
        return min(1, max(0, qos_levels - 1))
    return max(0, qos_levels - 1)


def _fetch(ps, client: int, read_policy=None) -> torch.Tensor:
    """``ps``'s assembled tensor as float32, complete on the device: the snapshot is
    read by request threads on streams of their own, so it is published
    only once the fetch's copies have finished."""
    w = ps.receive(client, read_policy=read_policy).wait().to(torch.float32)
    if w.is_cuda:
        torch.cuda.current_stream(w.device).synchronize()
    return w


class InferenceServer:
    """Answer inference requests from an atomic weight snapshot.

    ``model_fn(weights, x) -> y`` is the inference function: ``weights``
    the snapshot tensor, ``x`` the request's float32 payload as a flat
    tensor on the snapshot's device. ``ps`` is the
    :class:`~..parameterserver.ParameterServer` the downpour group
    publishes through; ``weights`` seeds the first snapshot (fetched from
    the PS synchronously when omitted). ``transport`` (when given) gets
    this server installed as its request handler on :meth:`start`."""

    def __init__(
        self,
        model_fn: Callable,
        ps=None,
        *,
        weights=None,
        client: int = 0,
        transport=None,
        clock=time.monotonic,
    ):
        self.model_fn = model_fn
        self.ps = ps
        self.client = client
        self.transport = transport
        self._clock = clock
        # the vector is read BEFORE the fetch (here and in refresh_once):
        # a snapshot is then at least as new as the vector it is keyed by,
        # so a send racing the fetch never leaves a stale snapshot behind
        # a vector that already counts it
        vec = version_vector(ps, client) if ps is not None else ()
        if weights is None:
            if ps is None:
                raise ValueError("InferenceServer needs weights or a ps")
            weights = _fetch(ps, client)
        self.cache = WeightCache(weights, vec, clock=clock)
        self.level = 0
        self.served = 0
        self.shed = 0
        self.slo_breaches = 0
        self.stale = False
        self._stop = threading.Event()
        self._refresher: Optional[threading.Thread] = None

    # -- request path ---------------------------------------------------
    def handle(self, rule: str, qos: int, payload, pending: int):
        """The request handler: ``(status_rule, result)``, the result a
        host float32 array."""
        budget = int(constants.get("serve_queue_budget"))
        level = brownout_level(int(pending), budget)
        self.level = level
        met = _metric_handles() if _telemetry.enabled() else None
        if met is not None:
            met[3].set(int(pending))
            met[4].set(level)
        floor = shed_qos_floor(
            level, int(constants.get("serve_qos_levels"))
        )
        if int(qos) < floor:
            self.shed += 1
            if met is not None:
                met[0].inc(result="shed")
            retry = int(constants.get("serve_shed_retry_ms"))
            return f"shed:{retry}", None
        t0 = self._clock()
        weights, _vec = self.cache.get()
        x = torch.from_numpy(
            np.frombuffer(payload, np.float32).copy()
            if payload else np.empty(0, np.float32)
        ).to(weights.device)
        y = torch.as_tensor(self.model_fn(weights, x))
        y = y.detach().to("cpu", torch.float32).numpy()
        dt = self._clock() - t0
        self.served += 1
        if dt * 1000.0 > float(constants.get("serve_slo_ms")):
            self.slo_breaches += 1
            if met is not None:
                met[2].inc()
        if met is not None:
            met[0].inc(result="ok")
            met[1].observe(dt)
        return "ok", y

    # -- weight refresh (background thread) -----------------------------
    def staleness_bound_s(self) -> float:
        """The live staleness bound: the configured bound, widened by
        the brownout factor at level >= 2 (rung two of the ladder)."""
        bound = float(constants.get("serve_refresh_staleness_s"))
        if self.level >= 2:
            bound *= float(
                constants.get("serve_brownout_staleness_factor")
            )
        return bound

    def refresh_once(self) -> bool:
        """One fetch-and-maybe-swap; returns whether a swap landed.

        The fetch rides ``serve_refresh_read_policy`` (default
        ``replica``), which the port's parameter server accepts and, with
        every shard in this process, routes nothing (ROADMAP A13)."""
        met = _metric_handles() if _telemetry.enabled() else None
        vec = version_vector(self.ps, self.client)
        try:
            arr = _fetch(
                self.ps, self.client,
                read_policy=(
                    constants.get("serve_refresh_read_policy") or None
                ),
            )
        except Exception:  # noqa: BLE001 - refresh is best-effort
            if met is not None:
                met[8].inc(outcome="failed")
            return False
        swapped = self.cache.swap(arr, vec)
        age = self.cache.age_s()
        self.stale = age > self.staleness_bound_s()
        if met is not None:
            met[8].inc(outcome="swap" if swapped else "same")
            met[7].set(round(age, 3))
            if swapped:
                met[5].inc()
                met[6].set(sum(v for v in vec if v > 0))
        return swapped

    def _refresh_loop(self) -> None:
        while not self._stop.is_set():
            interval = float(constants.get("serve_refresh_interval_s"))
            if self.level >= 2:
                # brownout rung two: fetch less often, tolerate staler
                # weights — the PS sheds one source of load
                interval *= float(
                    constants.get("serve_brownout_staleness_factor")
                )
            if self._stop.wait(interval):
                return
            self.refresh_once()

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "InferenceServer":
        if self.transport is not None:
            self.transport.set_request_handler(self.handle)
        if self.ps is not None and self._refresher is None:
            self._refresher = threading.Thread(
                target=self._refresh_loop, name="tm-serve-refresh",
                daemon=True,
            )
            self._refresher.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._refresher is not None:
            self._refresher.join(timeout=5)
            self._refresher = None
        if self.transport is not None:
            self.transport.set_request_handler(None)
