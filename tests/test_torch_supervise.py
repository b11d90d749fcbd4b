"""The port's recovery supervisor (``torchmpi_tpu_torch.supervise``)
against the JAX package's, on the CPU.

Every in-process case of ``tests/test_supervise.py`` runs as a script of
verdict documents through both supervisors, with the same seed, the same
injected clock and the same ``supervisor_*`` knobs: the journals, the
actuators' calls, ``actions_doc()`` and ``prometheus_lines()`` must be
equal as JSON, and each case's own assertions hold on the port. Then the
port's live aggregator with the port's supervisor attached: ``/actions``
and the ``tm_supervisor_*`` lines of ``/metrics``, the 404 without a
supervisor, ``mark_evicted``, and the flight entries under comm
``supervisor`` (this file disables the flight recorders it enables).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

import torchmpi_tpu.supervise as jsupervise
import torchmpi_tpu_torch.supervise as tsupervise
from torchmpi_tpu import constants as jconstants
from torchmpi_tpu import telemetry as jtelemetry
from torchmpi_tpu.supervise import checkpoints as jcheckpoints
from torchmpi_tpu.telemetry import flightrecorder as jflight
from torchmpi_tpu_torch import constants, telemetry
from torchmpi_tpu_torch.supervise import checkpoints
from torchmpi_tpu_torch.telemetry import flightrecorder as flight
from torchmpi_tpu_torch.telemetry.live import FleetAggregator

PORT = SimpleNamespace(mod=tsupervise, constants=constants)
JAX = SimpleNamespace(mod=jsupervise, constants=jconstants)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv(checkpoints.STATE_ENV, raising=False)
    checkpoints._reset_for_tests()
    jcheckpoints._reset_for_tests()
    yield
    constants._reset_for_tests()
    jconstants._reset_for_tests()
    checkpoints._reset_for_tests()
    jcheckpoints._reset_for_tests()


class Recorder:
    """An actuator that records calls; per-action success is settable."""

    def __init__(self, ok=True):
        self.calls = []
        self.ok = ok

    def evict(self, ranks, reason):
        self.calls.append(("evict", list(ranks), reason))
        return self.ok

    def grow(self, reason):
        self.calls.append(("grow", [], reason))
        return self.ok

    def rollback(self, reason):
        self.calls.append(("rollback", [], reason))
        return self.ok

    def scale_up(self, reason):
        self.calls.append(("scale_up", [], reason))
        return self.ok

    def scale_down(self, ranks, reason):
        self.calls.append(("scale_down", list(ranks), reason))
        return self.ok


def doc(verdict, ranks=(0, 1, 2, 3), dead=(), stuck=(), stragglers=None, resize=None):
    return {
        "verdict": verdict,
        "ranks": list(ranks),
        "dead_ranks": list(dead),
        "stuck": list(stuck),
        "stragglers": stragglers or {},
        "resize": resize or {},
    }


def _drive(sup, d, t0, t1, step=1.0):
    out, t = [], t0
    while t <= t1:
        out += sup.observe(d, now=t)
        t += step
    return out


class Case:
    """One scripted case on one package: its supervisors, actuators and
    what each observe returned."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.sups = []
        self.acts = []
        self.out = []

    def mk(self, ok=True, **kw):
        kw.setdefault("clock", lambda: 0.0)
        act = Recorder(ok)
        sup = self.pkg.mod.RecoverySupervisor(act, **kw)
        self.sups.append(sup)
        self.acts.append(act)
        return sup

    def set(self, name, value):
        self.pkg.constants.set(name, value)

    def observe(self, sup, d, now):
        got = sup.observe(d, now=now)
        self.out.append(got)
        return got

    def drive(self, sup, d, t0, t1, step=1.0):
        got = _drive(sup, d, t0, t1, step)
        self.out.append(got)
        return got

    def result(self) -> str:
        return json.dumps({
            "out": self.out,
            "calls": [a.calls for a in self.acts],
            "journals": [s.journal for s in self.sups],
            "docs": [s.actions_doc(now=1000.0) for s in self.sups],
            "prom": [s.prometheus_lines() for s in self.sups],
        }, sort_keys=True)


def case_single_noisy_window(c):
    sup = c.mk()
    assert c.observe(sup, doc("rank-dead", dead=[2]), 0.0) == []
    assert c.observe(sup, doc("clean"), 1.0) == []


def case_hysteresis(c):
    sup = c.mk()
    n = c.pkg.constants.get("supervisor_hysteresis_windows")
    for i in range(n - 1):
        assert c.observe(sup, doc("rank-dead", dead=[2]), float(i)) == []
    out = c.observe(sup, doc("rank-dead", dead=[2]), float(n))
    assert [e["action"] for e in out] == [c.pkg.mod.A_EVICT] and out[0]["ranks"] == [2]


def case_hysteresis_knob(c):
    c.set("supervisor_hysteresis_windows", 1)
    out = c.observe(c.mk(), doc("rank-dead", dead=[5]), 0.0)
    assert [e["action"] for e in out] == [c.pkg.mod.A_EVICT]


def case_verdict_change_resets_the_streak(c):
    sup = c.mk()
    c.observe(sup, doc("rank-dead", dead=[2]), 0.0)
    c.observe(sup, doc("rank-dead", dead=[2]), 1.0)
    c.observe(sup, doc("straggler"), 2.0)
    assert c.observe(sup, doc("rank-dead", dead=[2]), 3.0) == []


def case_backoff(c):
    c.set("supervisor_backoff_base_s", 5.0)
    sup = c.mk(seed=7)
    d = doc("rank-dead", dead=[2])
    n = c.pkg.constants.get("supervisor_hysteresis_windows")
    entries = c.drive(sup, d, 0.0, float(n) - 1)
    assert len(entries) == 1
    t_act = entries[0]["time"]
    assert c.observe(sup, d, t_act + 2.0) == []
    assert [e["attempt"] for e in c.observe(sup, d, t_act + 10.0)] == [2]


def case_escalation(c):
    sup = c.mk(ok=False, seed=3)
    entries = c.drive(sup, doc("rank-dead", dead=[2]), 0.0, 400.0)
    actions = [e["action"] for e in entries]
    retries = c.pkg.constants.get("supervisor_max_retries")
    assert actions[:retries] == [c.pkg.mod.A_EVICT] * retries
    assert c.pkg.mod.A_ROLLBACK in actions


def case_rollback_once(c):
    sup = c.mk(seed=1)
    entries = c.drive(sup, doc("resize-torn"), 0.0, 200.0)
    assert [e["action"] for e in entries] == [c.pkg.mod.A_ROLLBACK] and sup.rolled_back


def case_clean_streak_resets_the_ladder(c):
    sup = c.mk(seed=2)
    n = c.pkg.constants.get("supervisor_hysteresis_windows")
    c.drive(sup, doc("rank-dead", dead=[2]), 0.0, float(n))
    c.drive(sup, doc("clean"), 10.0, 10.0 + n)
    entries = c.drive(sup, doc("rank-dead", dead=[3]), 100.0, 100.0 + n)
    assert [e["action"] for e in entries] == [c.pkg.mod.A_EVICT]
    assert entries[0]["attempt"] == 1 and not entries[0]["escalated"]


def case_seeded_jitter(c):
    for seed in (11, 12):
        c.drive(c.mk(ok=False, seed=seed), doc("rank-dead", dead=[2]), 0.0, 119.0)
    a, b = c.out
    assert [e["action"] for e in a] == [e["action"] for e in b]
    assert [e["time"] for e in a] != [e["time"] for e in b]


def case_hang_targets(c):
    c.set("supervisor_hysteresis_windows", 1)
    out = c.observe(c.mk(), doc("hang", dead=[3], stuck=[{"rank": 1, "t_issue": 5.0}]), 0.0)
    assert out[0]["ranks"] == [3]
    out = c.observe(c.mk(), doc("hang", stuck=[{"rank": 2, "t_issue": 9.0},
                                               {"rank": 1, "t_issue": 5.0}]), 0.0)
    assert out[0]["ranks"] == [1]


def case_quarantine(c):
    c.set("supervisor_hysteresis_windows", 1)
    c.set("supervisor_quarantine_cooldown_s", 10.0)
    sup = c.mk()
    d = doc("straggler", stragglers={"significant": True,
                                     "ranking": [{"rank": 7, "mean_lag_ms": 80.0}]})
    out = c.observe(sup, d, 0.0)
    assert out[0]["action"] == c.pkg.mod.A_QUARANTINE and 7 in sup.quarantined
    c.observe(sup, doc("clean"), 5.0)
    assert 7 in sup.quarantined
    c.observe(sup, doc("clean"), 11.0)
    assert 7 not in sup.quarantined


def case_grow_back(c):
    c.set("supervisor_grow_back", True)
    c.set("supervisor_hysteresis_windows", 2)
    sup = c.mk(policy=c.pkg.mod.default_policy())
    c.observe(sup, doc("rank-dead", ranks=[0, 1, 2, 3], dead=[2]), 0.0)
    c.observe(sup, doc("rank-dead", ranks=[0, 1, 2, 3], dead=[2]), 1.0)
    assert c.observe(sup, doc("clean", ranks=[0, 1, 3]), 2.0) == []
    out = c.observe(sup, doc("clean", ranks=[0, 1, 3]), 3.0)
    assert [e["action"] for e in out] == [c.pkg.mod.A_GROW]
    assert c.observe(sup, doc("clean", ranks=[0, 1, 3, 4]), 50.0) == []


def case_dry_run(c):
    c.set("supervisor_hysteresis_windows", 1)
    sup = c.mk(dry_run=True)
    assert c.observe(sup, doc("rank-dead", dead=[2]), 0.0)[0]["result"] == "dry-run"
    assert sup.counters == {f"{c.pkg.mod.A_EVICT}:dry-run": 1}


def case_evicted_not_retargeted(c):
    c.set("supervisor_hysteresis_windows", 1)
    c.set("supervisor_backoff_base_s", 0.1)
    sup = c.mk(seed=5)
    c.observe(sup, doc("rank-dead", dead=[2]), 0.0)
    c.observe(sup, doc("rank-dead", dead=[2]), 5.0)


def case_scale_rungs(c):
    """The load rungs: scale-up at its hysteresis, the shared cooldown,
    the world ceiling, scale-down of the highest live rank to the
    floor."""
    c.set("supervisor_scale_cooldown_s", 10.0)
    c.set("supervisor_scale_max_world", 6)
    c.set("supervisor_scale_min_world", 3)
    sup = c.mk(seed=9)
    c.drive(sup, doc("overload", ranks=[0, 1, 2, 3]), 0.0, 40.0)
    c.drive(sup, doc("overload", ranks=range(6)), 41.0, 60.0)
    c.drive(sup, doc("underload", ranks=range(5)), 61.0, 200.0, step=2.0)


def case_default_policy(c):
    """The shipped table, and its knobs read at construction."""
    c.set("supervisor_max_retries", 5)
    c.set("supervisor_scale_up_hysteresis", 2)
    table = c.pkg.mod.default_policy()
    assert "clean" not in table and "ps-overload" not in table
    c.out.append({v: [r.action, r.hysteresis, r.max_retries, r.backoff_base_s,
                      r.backoff_cap_s, r.escalate] for v, r in sorted(table.items())})


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_scripted_case_equals_jax(name):
    results = []
    for pkg in (PORT, JAX):
        c = Case(pkg)
        CASES[name](c)
        results.append(c.result())
    assert results[0] == results[1]


def test_the_surface_is_the_jax_surface():
    assert tsupervise.__all__ == jsupervise.__all__
    for name in ("A_EVICT", "A_GROW", "A_QUARANTINE", "A_ROLLBACK", "A_SCALE_UP",
                 "A_SCALE_DOWN"):
        assert getattr(tsupervise, name) == getattr(jsupervise, name)
    act = tsupervise.Actuator()
    with pytest.raises(NotImplementedError):
        act.scale_up("overload")  # defaults to grow, which a subclass supplies


def test_rollback_journal_names_the_registered_checkpoint(tmp_path):
    """``actions_doc`` carries the registry's last checkpoint, as JAX's."""
    c_port, c_jax = Case(PORT), Case(JAX)
    for c, reg in ((c_port, checkpoints), (c_jax, jcheckpoints)):
        reg.register_checkpoint(tmp_path / "ck", 6)
        c.set("supervisor_hysteresis_windows", 1)
        c.observe(c.mk(), doc("desync"), 0.0)
    port, jax_ = json.loads(c_port.result()), json.loads(c_jax.result())
    for d in (port, jax_):
        for entry in d["docs"]:
            entry["last_checkpoint"].pop("time")
    assert port == jax_
    assert port["docs"][0]["last_checkpoint"]["step"] == 6


def test_flight_entries_equal_jax():
    """Each action lands in the flight recorder under comm ``supervisor``
    (op ``supervise.<action>``, routing ``verdict=<verdict>``, the failed
    ones failed), as in JAX."""
    rows = []
    for pkg, fr, tel in ((PORT, flight, telemetry), (JAX, jflight, jtelemetry)):
        tel.enable()
        fr.enable()
        try:
            fr.recorder.reset()
            c = Case(pkg)
            c.set("supervisor_hysteresis_windows", 1)
            c.drive(c.mk(ok=False, seed=4), doc("rank-dead", dead=[2]), 0.0, 200.0)
            entries = [e for e in fr.recorder.snapshot()["entries"]
                       if e["comm"] == "supervisor"]
            rows.append([(e["op"], e["payload"], e["backend"], e["routing"], e["seq"],
                          e["status"]) for e in entries])
        finally:
            fr.disable()
            tel.disable()
    assert rows[0] == rows[1]
    assert rows[0][0][0] == "supervise.evict-shrink" and rows[0][0][3] == "verdict=rank-dead"


def _get(url: str) -> str:
    return urllib.request.urlopen(url, timeout=10).read().decode()


def test_actions_endpoint_and_supervisor_metrics():
    constants.set("supervisor_hysteresis_windows", 1)
    agg = FleetAggregator(clock=lambda: 0.0)
    sup = Case(PORT).mk()
    sup.observe(doc("rank-dead", dead=[2]), now=0.0)
    agg.attach_supervisor(sup)
    agg.serve()
    try:
        base = f"http://127.0.0.1:{agg.http_port}"
        acts = json.loads(_get(base + "/actions"))
        assert acts["journal"][0]["action"] == tsupervise.A_EVICT
        assert acts["policy"]["rank-dead"]["escalate"] == tsupervise.A_ROLLBACK
        prom = _get(base + "/metrics")
        assert 'tm_supervisor_actions_total{action="evict-shrink",result="applied"} 1' in prom
        for line in sup.prometheus_lines():
            assert line in prom
    finally:
        agg.close()


def test_actions_endpoint_404_without_supervisor():
    agg = FleetAggregator(clock=lambda: 0.0)
    agg.serve()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"http://127.0.0.1:{agg.http_port}/actions")
        assert ei.value.code == 404
    finally:
        agg.close()


def test_mark_evicted_drops_the_view_and_the_marker(tmp_path):
    t = [100.0]
    agg = FleetAggregator(clock=lambda: t[0], stale_after_s=1.0, mark_dir=tmp_path)
    agg.ingest({"kind": "full", "rank": 1, "time": 100.0, "metrics": {}})
    (tmp_path / "dead_rank_1.json").write_text("{}")
    t[0] = 105.0
    assert agg.evaluate()["verdict"] == "rank-dead"
    agg.mark_evicted(1)
    assert agg.evaluate()["verdict"] == "clean"
    assert 1 not in agg.ranks and not (tmp_path / "dead_rank_1.json").exists()


def test_a_supervisor_drives_the_aggregators_verdicts(tmp_path):
    """The one-process loop: a dead-rank marker's verdict through the
    port's aggregator into the port's supervisor (an actuator whose
    evict fails), which escalates to the rollback after its retries."""
    for name, value in (("supervisor_hysteresis_windows", 1), ("supervisor_max_retries", 2),
                        ("supervisor_backoff_base_s", 0.5), ("supervisor_backoff_cap_s", 1.0)):
        constants.set(name, value)
    t = [0.0]
    agg = FleetAggregator(clock=lambda: t[0], mark_dir=tmp_path)
    for r in range(4):
        agg.ingest({"kind": "full", "rank": r, "time": 0.0, "metrics": {}})
    (tmp_path / "dead_rank_2.json").write_text("{}")

    class Act(tsupervise.Actuator):
        def __init__(self):
            self.calls = []

        def evict(self, ranks, reason):
            self.calls.append(("evict", ranks))
            return False

        def rollback(self, reason):
            self.calls.append(("rollback", []))
            return True

    act = Act()
    sup = tsupervise.RecoverySupervisor(act, clock=lambda: t[0], seed=0)
    for _ in range(12):
        t[0] += 1.0
        for r in (0, 1, 3):
            agg.ingest({"kind": "full", "rank": r, "time": t[0], "metrics": {}})
        sup.observe(agg.evaluate())
        if sup.rolled_back:
            break
    assert [a for a, _ in act.calls] == ["evict", "evict", "rollback"]
    assert act.calls[0][1] == [2] and sup.rolled_back
