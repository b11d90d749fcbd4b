"""The port's live telemetry plane (``telemetry/live.py``) and console
(``telemetry/top.py``) against the JAX package's, on the CPU.

- The same frames, made with numpy from a seed, into both packages'
  ``FleetAggregator`` under one injected clock give equal ``/verdicts``,
  ``/health``, ``/metrics`` and ``/calibration`` documents (exact), for a
  clean fleet, a desync, a straggler, a hang and a dead rank.
- One real loopback exporter -> aggregator -> HTTP scrape in one process,
  fed by the port's own collectives on the CPU: the verdict is ``clean``,
  the completed dispatches become calibration samples, ``/actions``
  serves an attached supervisor, and ``top.render`` equals the JAX
  console's on the same documents.
- The elastic heartbeat carrier and the environment arming.

Every socket has a timeout; intervals are 0.05 s.
"""

import copy
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import torchmpi_tpu_torch as tmpi
from torchmpi_tpu import constants as jconstants
from torchmpi_tpu import telemetry as jtelemetry
from torchmpi_tpu.telemetry import flightrecorder as jflight
from torchmpi_tpu.telemetry import live as jlive
from torchmpi_tpu.telemetry import top as jtop
from torchmpi_tpu_torch import constants, telemetry
from torchmpi_tpu_torch.collectives import eager
from torchmpi_tpu_torch.telemetry import flightrecorder as flight
from torchmpi_tpu_torch.telemetry import live, top

P = 4


@pytest.fixture(autouse=True)
def _fresh_port():
    yield
    for lv in (live, jlive):
        lv.stop_exporter()
    tmpi.runtime_state._reset_for_tests()
    constants._reset_for_tests()
    jconstants._reset_for_tests()
    for pkg in (telemetry, jtelemetry):
        pkg.disable()
        pkg.reset()
    flight.disable()
    jflight.disable()


def _canon(doc) -> str:
    return json.dumps(doc, sort_keys=True, default=str)


def _frames(seed: int, scenario: str, t: float):
    """One full frame a rank: P ranks' flight tails over a shared stream
    (issue skews and durations from the seed) and a metric family. The
    payloads name the dtype as the JAX entries do (``float32``); the
    port's own ``torch.float32`` is read in the loopback test."""
    rng = np.random.default_rng(seed)
    skew = rng.uniform(0.0, 0.001, P)
    if scenario == "straggler":
        skew[2] += 0.3
    widths = rng.integers(8, 4096, 10)
    frames = []
    for r in range(P):
        entries = []
        for i in range(10):
            t0 = t - 20.0 + 1.0 * i + skew[r]
            op = "reduce" if scenario == "desync" and r == 1 and i == 4 else "allreduce"
            stuck = scenario == "hang" and r == 0 and i == 9
            entries.append({
                "seq": i, "comm": f"global[{P}]", "op": op,
                "payload": f"({P}, {int(widths[i])}):float32", "wire": "full",
                "backend": "kernel", "routing": "flat", "plan": f"flat-kernel-full:{i % 2:04x}",
                "t_issue": t0, "t_complete": None if stuck else t0 + float(rng.uniform(1e-4, 1e-3)),
                "status": "issued" if stuck else "completed", "trace": 0, "span": 0, "parent": 0,
            })
        hw = {f"global[{P}]": 9}
        metrics = {"tm_collective_calls_total": {
            "kind": "counter", "help": "calls",
            "series": {"op=allreduce": int(rng.integers(10, 100))}}}
        frames.append({"kind": "full", "rank": r, "time": t, "metrics": metrics,
                       "metrics_generation": 1, "seq_high_water": hw, "flight_tail": entries})
    return frames


SCENARIOS = [("clean", "clean"), ("desync", "desync"), ("straggler", "straggler"),
             ("hang", "hang"), ("dead", "rank-dead")]


@pytest.mark.parametrize("scenario,verdict", SCENARIOS)
@pytest.mark.parametrize("seed", [0, 1])
def test_aggregators_give_equal_documents(scenario, verdict, seed):
    now = 5000.0
    aggs = [mod.FleetAggregator(clock=lambda: now, stale_after_s=3.0, hang_after_s=5.0)
            for mod in (live, jlive)]
    frames = _frames(seed, scenario, now - 1.0)
    for agg in aggs:
        for f in frames:
            if scenario == "dead" and f["rank"] == 3:
                f = dict(f, time=now - 10.0)
            agg.ingest(copy.deepcopy(f))
    docs = [agg.evaluate(now=now) for agg in aggs]
    assert _canon(docs[0]) == _canon(docs[1])
    assert docs[0]["verdict"] == verdict
    for name in ("health", "prometheus", "criticalpath"):
        assert _canon(getattr(aggs[0], name)(now=now)) == _canon(getattr(aggs[1], name)(now=now))
    assert aggs[0].calibration_json() == aggs[1].calibration_json()
    h, v = aggs[0].health(now=now), docs[0]
    assert top.render(h, v) == jtop.render(h, v)


def _scrape(agg, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{agg.http_port}{path}", timeout=10) as r:
        return r.read().decode()


class _Supervisor:
    """Any object with the supervisor's scrape surface."""

    def actions_doc(self):
        return {"actions": [{"kind": "evict", "rank": 2}], "quarantined": [2]}

    def prometheus_lines(self):
        return ["# TYPE tm_supervisor_actions_total counter",
                "tm_supervisor_actions_total 1"]


def test_loopback_exporter_aggregator_scrape(capsys):
    constants.set("telemetry_live_interval_s", 0.05)
    tmpi.start(ranks=P, device="cpu", small_allreduce_size_cpu=0)
    telemetry.enable()
    agg = live.FleetAggregator()
    agg.serve()
    try:
        live.start_exporter(("127.0.0.1", agg.ingest_port), rank=3)
        comm = tmpi.current_communicator()
        x = torch.ones(P, 256)
        for _ in range(4):
            eager.run("allreduce", x, comm, backend="ring")
        tmpi.wait(tmpi.async_.allreduce_tensor(x))
        deadline = time.time() + 10
        while time.time() < deadline and (
                agg.frames_total < 2 or not agg.ranks.get(3) or not len(agg.samples)):
            time.sleep(0.05)
        health = json.loads(_scrape(agg, "/health"))
        assert "3" in health["ranks"]
        assert health["fleet_seq_high_water"].get(f"global[{P}]", -1) >= 3
        verd = json.loads(_scrape(agg, "/verdicts"))
        assert verd["verdict"] == "clean" and "desync: none" in verd["summary"]
        prom = _scrape(agg, "/metrics")
        assert f'tm_fleet_seq_high_water{{rank="3",comm="global[{P}]"}}' in prom
        cal = json.loads(_scrape(agg, "/calibration"))
        assert cal["samples"]
        with pytest.raises(urllib.error.HTTPError):
            _scrape(agg, "/actions")
        agg.attach_supervisor(_Supervisor())
        assert json.loads(_scrape(agg, "/actions"))["quarantined"] == [2]
        assert "tm_supervisor_actions_total 1" in _scrape(agg, "/metrics")
        assert top.render(health, verd) == jtop.render(health, verd)
        assert top.main([f"127.0.0.1:{agg.http_port}", "--once"]) == 0
        assert "desync: none" in capsys.readouterr().out
        live.stop_exporter()
        assert live.exporter() is None
    finally:
        live.stop_exporter()
        agg.close()


def test_heartbeat_carrier_frame_matches_jax():
    frames = []
    for lv in (live, jlive):
        lv.start_carrier(rank=2)
        frame = lv.heartbeat_frame()
        frames.append(frame)
        lv.stop_exporter()
        assert lv.heartbeat_frame() is None
    assert sorted(frames[0]) == sorted(frames[1])
    assert frames[0]["rank"] == frames[1]["rank"] == 2
    assert frames[0]["kind"] == frames[1]["kind"] == "full"


def test_env_arms_the_exporter(monkeypatch):
    agg = live.FleetAggregator()
    agg.serve()
    try:
        monkeypatch.setenv("TORCHMPI_TPU_TELEMETRY_LIVE", f"127.0.0.1:{agg.ingest_port}")
        live._maybe_start_from_env()
        assert live.exporter() is not None and not live.exporter().carrier
        live.stop_exporter()
        monkeypatch.delenv("TORCHMPI_TPU_TELEMETRY_LIVE")
        monkeypatch.setenv("TORCHMPI_TPU_TELEMETRY_LIVE_VIA", "heartbeat")
        live._maybe_start_from_env()
        assert live.exporter().carrier and flight.enabled()
    finally:
        live.stop_exporter()
        agg.close()
