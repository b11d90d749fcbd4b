"""The serving client: REQUEST round trips with shed/retry handling.

The port of ``torchmpi_tpu/serve/client.py``: host logic over any object
with ``serve_request(proc, tag, x, qos=)`` (the JAX package's PS
transport; the port's waits for ROADMAP A7's rest). ``shed:`` replies are the
SERVER's brownout ladder talking: the request was admitted but dropped by
QoS, and the reply carries the retry-after hint the client honors here
(bounded; a request shed past the retry budget surfaces as
:class:`ShedError`, never a silent drop).

Latency accounting: the server observes only queue + handle time, which
makes shed/BUSY-retried requests vanish from latency metrics exactly
when the system is degrading. ``tm_serve_client_e2e_seconds`` closes
that gap — it is observed HERE, around the full retry loop, labelled by
QoS class and outcome, so a request that was shed 5 times before
succeeding shows its true client-observed latency (and a request that
exhausted its budget still lands in the ``shed`` series)."""

from __future__ import annotations

import random
import time
from typing import Optional

import numpy as np

from .. import telemetry as _telemetry
from ..telemetry import tracecontext as _tracecontext

_CLIENT_MET = None


def _client_metrics():
    global _CLIENT_MET
    if _CLIENT_MET is None:
        _CLIENT_MET = _telemetry.metrics.histogram(
            "tm_serve_client_e2e_seconds",
            "client-observed end-to-end serve latency including shed/"
            "BUSY retries, by QoS class and outcome (ok|shed|error)",
        )
    return _CLIENT_MET


class ShedError(RuntimeError):
    """Raised when a request was brownout-shed past its retry budget."""

    def __init__(self, sheds: int, retry_ms: int):
        super().__init__(
            f"request shed {sheds}x by the serving brownout ladder "
            f"(last retry-after hint {retry_ms}ms)"
        )
        self.sheds = sheds
        self.retry_ms = retry_ms


class ServeClient:
    def __init__(
        self,
        transport,
        proc: int,
        *,
        qos: int = 0,
        tag: str = "infer",
        rng: Optional[random.Random] = None,
        sleep=time.sleep,
    ):
        self.transport = transport
        self.proc = proc
        self.qos = qos
        self.tag = tag
        self._rng = rng or random.Random()
        self._sleep = sleep
        # per-client request ordinal: the deterministic part of each
        # request's trace-context root (no randomness — replays and
        # tests stay byte-stable)
        self._requests = 0

    def infer_once(self, x: np.ndarray, qos: Optional[int] = None):
        """One round trip: ``(status_rule, result_or_None)``."""
        return self.transport.serve_request(
            self.proc, self.tag, np.asarray(x, np.float32),
            qos=self.qos if qos is None else qos,
        )

    def infer(self, x: np.ndarray, qos: Optional[int] = None,
              max_sheds: int = 8) -> np.ndarray:
        """Round trips until an ``ok`` reply, honoring shed retry-after
        hints with +-50% jitter; raises :class:`ShedError` after
        ``max_sheds`` consecutive sheds. Each call is one causal trace:
        every retry hop shares the request's trace id, so the analyzer
        can decompose a slow p99 into queue vs wire vs shed-backoff."""
        qos_eff = self.qos if qos is None else qos
        telemetry_on = _telemetry.enabled()
        t0 = time.perf_counter() if telemetry_on else 0.0
        self._requests += 1
        ctx = (
            _tracecontext.current()
            or _tracecontext.new_trace(
                "serve", self.proc, self.tag, self._requests
            )
        )
        outcome = "error"
        try:
            with _tracecontext.use(ctx):
                retry_ms = 0
                for attempt in range(max_sheds + 1):
                    status, result = self.infer_once(x, qos=qos)
                    if status == "ok":
                        outcome = "ok"
                        return result
                    if status.startswith("shed:"):
                        retry_ms = int(status.split(":", 1)[1] or 0)
                        if attempt < max_sheds:
                            self._sleep(
                                (retry_ms / 1000.0)
                                * (0.5 + self._rng.random())
                            )
                        continue
                    raise RuntimeError(
                        f"unexpected serve reply {status!r}"
                    )
                outcome = "shed"
                raise ShedError(max_sheds, retry_ms)
        finally:
            if telemetry_on:
                _client_metrics().observe(
                    time.perf_counter() - t0,
                    qos=str(qos_eff), outcome=outcome,
                )
