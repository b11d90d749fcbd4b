"""The port's observability beyond the core against the JAX package's, on
the CPU.

- ``telemetry/criticalpath.py`` and ``telemetry/analyze.py``: synthetic
  flight journals and metric dumps, made with numpy from a seed, go
  through both packages; ``critical_path``, ``overlap_ledger``,
  ``detect_desync``, ``rank_stragglers`` and the whole ``analyze`` report
  must be equal as JSON (exact). The port's own ``telemetry.dump`` of a
  small CPU run loads in both analyzers with equal reports.
- ``telemetry/calibrate.py`` and ``schedule.calibrate``: the same sample
  store gives the same ``fit_store`` table and report (exact), the plan
  compiled in both packages resolving the same plan_id;
  ``calibrate(persist=True)`` then a fresh ``start()`` re-applies it.
- ``utils.tracing.wire_stats``: the same full, bf16 and int8 allreduces
  give equal snapshots (exact byte counts), and the ``wire_stats``
  collector rides every snapshot.
- ``runtime/handles.py``: an async allreduce's ``wait()`` leaves one
  completed ``wait.<kind>`` entry with JAX's fields.
- ``telemetry/watchdog.py``: an entry left ``issued`` past a 0.2 s
  timeout is flagged, with the same report keys as JAX's.
"""

import json
import shutil
import time
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu import constants as jconstants
from torchmpi_tpu import schedule as jschedule
from torchmpi_tpu import telemetry as jtelemetry
from torchmpi_tpu.collectives import eager as jeager
from torchmpi_tpu.runtime.handles import SyncHandle as JSyncHandle
from torchmpi_tpu.schedule import compiler as jsched
from torchmpi_tpu.telemetry import analyze as janalyze
from torchmpi_tpu.telemetry import calibrate as jcalibrate
from torchmpi_tpu.telemetry import criticalpath as jcriticalpath
from torchmpi_tpu.telemetry import flightrecorder as jflight
from torchmpi_tpu.telemetry import watchdog as jwatchdog
from torchmpi_tpu.utils import tracing as jtracing
from torchmpi_tpu_torch import constants, ops, schedule, telemetry
from torchmpi_tpu_torch.collectives import eager
from torchmpi_tpu_torch.runtime.handles import SyncHandle
from torchmpi_tpu_torch.schedule import compiler as sched
from torchmpi_tpu_torch.telemetry import analyze, calibrate, criticalpath
from torchmpi_tpu_torch.telemetry import flightrecorder as flight
from torchmpi_tpu_torch.telemetry import watchdog
from torchmpi_tpu_torch.utils import tracing

P = 4


@pytest.fixture(autouse=True)
def _fresh_port():
    yield
    for wd in (watchdog, jwatchdog):
        wd.stop_watchdog()
    tmpi.runtime_state._reset_for_tests()
    constants._reset_for_tests()
    ops.reset_launch_counts()
    sched.clear_plan_overrides()
    schedule.clear_calibration()
    for pkg, fr, trc in ((telemetry, flight, tracing), (jtelemetry, jflight, jtracing)):
        fr.disable()
        pkg.disable()
        pkg.reset()
        trc.wire_stats.reset()


def _canon(doc) -> str:
    return json.dumps(doc, sort_keys=True, default=str)


# ---------------------------------------------------------------------------
# synthetic journals, made with numpy from a seed
# ---------------------------------------------------------------------------


def _journal(seed: int, desync: bool):
    """Per-rank flight entries of P SPMD ranks: a shared collective stream
    (skewed issue times, rank 2 the slowest), a stream of pipelined chunk
    sub-entries and of overlap-scheduled buckets, a PS RPC pair joined by
    span ids; ``desync`` makes rank 1's sixth collective another op."""
    rng = np.random.default_rng(seed)
    skew = rng.uniform(0.0, 0.002, P)
    skew[2] += 0.01
    ops_ = rng.choice(["allreduce", "broadcast", "allgather"], 12)
    widths = rng.integers(16, 4096, 12)
    durs = rng.uniform(1e-4, 2e-3, (P, 12))
    ranks = {}
    for r in range(P):
        entries = []
        t = 1000.0
        for i in range(12):
            t += 0.02
            op = str(ops_[i])
            if desync and r == 1 and i == 5:
                op = "reduce"
            t0 = t + skew[r]
            entries.append({
                "seq": i, "comm": f"global[{P}]", "op": op,
                "payload": f"({P}, {int(widths[i])}):float32", "wire": "full",
                "backend": "ring", "routing": "flat", "plan": f"flat-ring-full:{i % 3:04x}",
                "t_issue": t0, "t_complete": t0 + float(durs[r, i]), "status": "completed",
                "trace": 7, "span": 100 + i, "parent": 0,
            })
        for b in range(4):
            t0 = t + 0.01 + 0.0004 * b + skew[r]
            entries.append({
                "seq": b, "comm": "chunks", "op": "allreduce", "payload": "4096B",
                "wire": "full", "backend": "ring", "routing": "chunk",
                "plan": f"flat-ring-full:00aa@p4#{b}", "t_issue": t0,
                "t_complete": t0 + 0.001, "status": "completed",
                "trace": 0, "span": 0, "parent": 0,
            })
        for b in range(3):
            t0 = t + 0.02 + 0.0005 * b
            entries.append({
                "seq": 4 + b, "comm": "chunks", "op": "allreduce", "payload": "1024B",
                "wire": "full", "backend": "", "routing": "bucket",
                "plan": f"overlap-reverse:grads#{b}", "t_issue": t0,
                "t_complete": t0 + 0.0015, "status": "completed",
                "trace": 0, "span": 0, "parent": 0,
            })
        if r == 0:
            entries.append({
                "seq": 0, "comm": "ps:client", "op": "ps.send", "payload": "(64,):float32",
                "wire": "full", "backend": "", "routing": "", "plan": "",
                "t_issue": t + 0.03, "t_complete": t + 0.034, "status": "completed",
                "trace": 9, "span": 501, "parent": 0,
            })
        if r == 3:
            entries.append({
                "seq": 0, "comm": "ps:server", "op": "ps.apply", "payload": "(64,):float32",
                "wire": "full", "backend": "", "routing": "", "plan": "",
                "t_issue": t + 0.031, "t_complete": t + 0.033, "status": "completed",
                "trace": 9, "span": 502, "parent": 501,
            })
        ranks[r] = entries
    return ranks


def _write_run(d, journal, seed: int):
    """``telemetry_rank_<r>.json`` dumps (and their span traces) of the
    journal, with clock-sync records and a PS latency histogram."""
    rng = np.random.default_rng(seed + 1)
    d.mkdir(parents=True, exist_ok=True)
    for r, entries in journal.items():
        hw = {}
        for e in entries:
            hw[e["comm"]] = max(hw.get(e["comm"], -1), e["seq"])
        counts = [int(c) for c in rng.integers(0, 20, 4)]
        snap = {
            "pid": 1000 + r, "time": 2000.0,
            "clock_sync": {"wall_time": 1000.0, "perf_counter": 2.0 + r,
                           "monotonic": 1.0, "rank": r},
            "metrics": {"tm_ps_rpc_seconds": {
                "kind": "histogram", "help": "ps rpc",
                "buckets": [0.001, 0.01, 0.1],
                "series": {"kind=send": {"buckets": counts, "sum": 0.5, "count": sum(counts)}},
            }},
            "spans": {"buffered": 1, "recorded": 1, "capacity": 4096, "dropped": 0},
            "flight_recorder": {"capacity": 4096, "recorded": len(entries), "dropped": 0,
                                "seq_high_water": hw, "entries": entries},
        }
        (d / f"telemetry_rank_{r}.json").write_text(json.dumps(snap))
        trace = {"traceEvents": [
            {"ph": "X", "name": "collective.allreduce", "cat": "torchmpi_tpu",
             "ts": 100.0 + 10 * r, "dur": float(rng.uniform(1, 9)), "pid": 1000 + r, "tid": 1},
        ], "displayTimeUnit": "ms"}
        (d / f"telemetry_rank_{r}.trace.json").write_text(json.dumps(trace))


@pytest.mark.parametrize("seed,desync", [(0, False), (1, True), (2, False)])
def test_criticalpath_and_detectors_equal_jax(seed, desync):
    journal = _journal(seed, desync)
    ranks = {r: {"snapshot": {"flight_recorder": {"entries": e}}, "trace_events": []}
             for r, e in journal.items()}
    for fn in ("critical_path", "overlap_ledger", "serve_hops"):
        assert _canon(getattr(criticalpath, fn)(ranks)) == _canon(getattr(jcriticalpath, fn)(ranks))
    assert _canon(criticalpath.flow_events(ranks)) == _canon(jcriticalpath.flow_events(ranks))
    for e in journal[0]:
        assert criticalpath.classify(e) == jcriticalpath.classify(e)
    ledger = criticalpath.overlap_ledger(ranks)["plans"]
    assert "flat-ring-full:00aa@p4" in ledger and "overlap-reverse:grads" in ledger
    assert criticalpath.modeled_overlap_fraction({"a": 3.0, "b": 1.0}, 4) == \
        jcriticalpath.modeled_overlap_fraction({"a": 3.0, "b": 1.0}, 4)
    desync_doc = analyze.detect_desync(ranks)
    assert _canon(desync_doc) == _canon(janalyze.detect_desync(ranks))
    assert (desync_doc["status"] != "none") == desync
    assert _canon(analyze.rank_stragglers(ranks)) == _canon(janalyze.rank_stragglers(ranks))


@pytest.mark.parametrize("seed,desync", [(3, False), (4, True)])
def test_analyze_report_and_trace_equal_jax(seed, desync, tmp_path):
    _write_run(tmp_path, _journal(seed, desync), seed)
    report = analyze.analyze(tmp_path)
    assert _canon(report) == _canon(janalyze.analyze(tmp_path))
    run, jrun = analyze.load_run(tmp_path), janalyze.load_run(tmp_path)
    assert _canon(analyze.merged_trace(run["ranks"])) == _canon(janalyze.merged_trace(jrun["ranks"]))
    assert _canon(analyze.ps_health(run["ranks"])) == _canon(janalyze.ps_health(jrun["ranks"]))
    assert analyze._summary_lines(report) == janalyze._summary_lines(report)
    assert analyze._critical_path_panel(report) == janalyze._critical_path_panel(report)
    assert report["critical_path"] and report["overlap"]["plans"]
    code = analyze.main([str(tmp_path), "--strict", "--critical-path"])
    assert code == (1 if desync else 0)


def test_analyze_hangs_and_cli_contract_equal_jax(tmp_path, capsys):
    journal = _journal(5, False)
    stuck = dict(journal[1][7], status="issued", t_complete=None)
    journal[1] = journal[1][:7]
    _write_run(tmp_path, journal, 5)
    (tmp_path / "hang_rank_1.json").write_text(json.dumps(
        {"reason": "in_flight_timeout", "rank": 1, "detail": {"stuck": [stuck]}}))
    run = analyze.load_run(tmp_path)
    assert _canon(analyze.analyze_hangs(run)) == _canon(janalyze.analyze_hangs(janalyze.load_run(tmp_path)))
    assert _canon(analyze.analyze_resizes(run)) == _canon(janalyze.analyze_resizes(run))
    assert analyze.main([str(tmp_path), "--strict"]) == janalyze.main([str(tmp_path), "--strict"])
    assert analyze.main([str(tmp_path / "empty")]) == 2
    capsys.readouterr()


def test_port_dump_loads_in_both_analyzers(tmp_path):
    """A small CPU run of the port with telemetry on (eager, fused and
    async collectives, a wait), dumped by ``telemetry.dump`` as two ranks'
    files: both analyzers give the same report, no desync."""
    tmpi.start(ranks=P, device="cpu")
    telemetry.enable()
    x = torch.arange(P * 64, dtype=torch.float32).reshape(P, 64)
    tmpi.allreduce_tensor(x)
    tmpi.broadcast_tensor(x, root=1)
    h = tmpi.async_.allreduce_tensor(x)
    tmpi.wait(h)
    fb = tmpi.collectives.fusion.get_fusion_buffer()
    hs = [fb.submit("allreduce", x[:, :n].contiguous()) for n in (8, 16, 24)]
    fb.flush_all()
    [hh.wait() for hh in hs]
    d = tmp_path / "run"
    d.mkdir()
    telemetry.dump(d / "telemetry_rank_0.json")
    for name in ("telemetry_rank_0.json", "telemetry_rank_0.trace.json"):
        shutil.copy(d / name, d / name.replace("rank_0", "rank_1"))
    snap = json.loads((d / "telemetry_rank_0.json").read_text())
    assert snap["clock_sync"]["process_count"] == 1
    assert "wire_stats" in snap["metrics"]
    report = analyze.analyze(d)
    assert _canon(report) == _canon(janalyze.analyze(d))
    assert report["desync"]["status"] == "none" and report["ranks"] == [0, 1]
    assert report["critical_path"]["ranks"]
    run = analyze.load_run(d)
    assert _canon(analyze.merged_trace(run["ranks"])) == _canon(janalyze.merged_trace(run["ranks"]))


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def _start_both(p: int = 8):
    tmpi.start(ranks=p, device="cpu")
    jmpi.start(devices=jax.devices()[:p])
    return tmpi.current_communicator(), jmpi.current_communicator()


def _store(plan_ids, seed: int):
    rng = np.random.default_rng(seed)
    store = calibrate.SampleStore()
    for pid in plan_ids:
        for nbytes in (4096, 1 << 14, 1 << 16, 1 << 20):
            for _ in range(4):
                store.add("allreduce", "global[8]", "full", nbytes, pid,
                          float(rng.uniform(50, 500) + nbytes / 4096))
    return store


def test_payload_nbytes_reads_torch_dtype_names():
    for payload, routing in (("(8, 64):float32", ""), ("(8, 64):torch.float32", ""),
                             ("(8, 100):torch.bfloat16", ""), ("(150, 6):torch.float32", "fused"),
                             ("weird", ""), ("", "")):
        want = jcalibrate.payload_nbytes(payload.replace("torch.", ""), routing)
        assert calibrate.payload_nbytes(payload, routing) == want
    assert calibrate.payload_nbytes(flight.format_payload(((8, 64), torch.float32))) == 256
    for nbytes in (1, 17, 4096, (1 << 20) + 3):
        assert calibrate._bucket(nbytes) == schedule.payload_bucket(nbytes)


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_store_and_calibrate_equal_jax(seed, monkeypatch, tmp_path):
    tcomm, jcomm = _start_both()
    for pkg in (constants, jconstants):
        pkg.set("small_allreduce_size_cpu", 0)
    ep = sched.compile_collective("allreduce", (8, 4096), torch.float32, tcomm, backend="ring")
    jep = jsched.compile_collective("allreduce", (8, 4096), jnp.float32, jcomm, backend="ring")
    assert ep.plan_id == jep.plan_id
    store = _store([ep.plan_id, "unknown-plan"], seed)
    jstore = jcalibrate.SampleStore.from_json(json.loads(json.dumps(store.to_json())))
    assert _canon(calibrate.fit_store(store)) == _canon(jcalibrate.fit_store(jstore))
    got = schedule.calibrate(store, apply=False)
    want = jschedule.calibrate(jstore, apply=False)
    assert _canon(got) == _canon(want)
    assert got["report"]["modeled_err_pct"] is not None
    # persisted, then re-applied by a fresh start()
    monkeypatch.setenv("TORCHMPI_TPU_CALIBRATION_CACHE", str(tmp_path / "cal.json"))
    res = schedule.calibrate(store, persist=True)
    assert res["applied"] == len(res["table"]) and (tmp_path / "cal.json").exists()
    schedule.clear_calibration()
    tmpi.stop()
    epoch0 = schedule.calibration_epoch()
    tmpi.start(ranks=8, device="cpu")
    assert schedule.calibration_epoch() == epoch0 + 1
    bucket = schedule.payload_bucket(1 << 16)
    assert schedule.calibrated_plan_us("allreduce", bucket, "full", ep.plan_id) == \
        pytest.approx(res["table"][calibrate.sample_key(
            "allreduce", "global[8]", "full", bucket, ep.plan_id)]["us"])
    tmpi.stop()
    tmpi.start(ranks=8, device="cpu", load_tuned_constants=False)
    assert schedule.calibration_epoch() == epoch0 + 1


def test_samples_from_port_entries_feed_the_fit():
    """A CPU run's own flight entries (torch dtype names) become samples
    under the plans the compiler stamped."""
    tmpi.start(ranks=8, device="cpu", small_allreduce_size_cpu=0)
    flight.enable()
    x = torch.ones(8, 1024)
    for _ in range(4):
        eager.run("allreduce", x, tmpi.current_communicator(), backend="ring")
    entries = flight.recorder.entries()
    store = calibrate.samples_from_entries(entries)
    assert len(store) == 4
    (key,) = store.samples
    assert calibrate.split_key(key)["plan_id"] == entries[0]["plan"]
    result = schedule.calibrate(store, apply=True)
    assert result["applied"] == 1 and result["report"]["modeled_err_pct"] is not None


# ---------------------------------------------------------------------------
# wire_stats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["ring", "kernel"])
def test_wire_stats_equal_jax(backend):
    tcomm, jcomm = _start_both()
    for pkg in (constants, jconstants):
        pkg.set("small_allreduce_size_cpu", 0)
        pkg.set("wire_quant_min_elements", 256)
    x = np.random.default_rng(0).standard_normal((8, 1000)).astype(np.float32)
    for wire in ("full", "bf16", "int8", "int8"):
        eager.run("allreduce", torch.from_numpy(x), tcomm, backend=backend, wire_dtype=wire)
        jeager.run("allreduce", jnp.asarray(x), jcomm, backend="ring", wire_dtype=wire)
    eager.run("allreduce", torch.from_numpy(x[:, :100]), tcomm, backend=backend, wire_dtype="int8")
    jeager.run("allreduce", jnp.asarray(x[:, :100]), jcomm, backend="ring", wire_dtype="int8")
    eager.run("allreduce", torch.from_numpy(x), tcomm, backend="xla")
    jeager.run("allreduce", jnp.asarray(x), jcomm, backend="xla")
    got = tracing.wire_stats.snapshot()
    assert got == jtracing.wire_stats.snapshot()
    calls, logical, wire_bytes = got["by_format"]["allreduce:int8"]
    assert (calls, logical) == (2, 2 * 4000)
    assert wire_bytes == 2 * eager.prim.wire_encoded_bytes(
        1000, 4, "int8", constants.get("wire_quant_block_size"))
    assert telemetry.snapshot()["metrics"]["wire_stats"] == got


# ---------------------------------------------------------------------------
# the handles' wait entries
# ---------------------------------------------------------------------------


def test_async_wait_records_one_wait_entry_like_jax():
    tcomm, jcomm = _start_both(P)
    for fr in (flight, jflight):
        fr.enable()
    x = np.arange(P * 32, dtype=np.float32).reshape(P, 32)
    h = tmpi.async_.allreduce_tensor(torch.from_numpy(x))
    jh = jmpi.async_.allreduce_tensor(jnp.asarray(x))
    h.wait(), h.wait()
    jh.wait(), jh.wait()
    waits = [e for e in flight.recorder.entries() if e["comm"] == "handles"]
    jwaits = [e for e in jflight.recorder.entries() if e["comm"] == "handles"]
    assert len(waits) == len(jwaits) == 1
    (w,), (jw,) = waits, jwaits
    assert list(w) == list(jw)
    for key in ("seq", "comm", "op", "payload", "wire", "backend", "routing", "plan", "status"):
        assert w[key] == jw[key], key
    assert (w["op"], w["status"]) == ("wait.arrays", "completed")
    assert w["t_complete"] >= w["t_issue"]


def test_future_wait_records_wait_future_like_jax():
    for fr in (flight, jflight):
        fr.enable()
    for cls in (SyncHandle, JSyncHandle):
        f = Future()
        f.set_result(3)
        assert cls(future=f).wait() == 3
    (w,) = [e for e in flight.recorder.entries() if e["comm"] == "handles"]
    (jw,) = [e for e in jflight.recorder.entries() if e["comm"] == "handles"]
    assert (w["op"], w["backend"], w["status"]) == (jw["op"], jw["backend"], jw["status"]) \
        == ("wait.future", "future", "completed")
    f = Future()
    f.set_exception(ValueError("boom"))
    with pytest.raises(ValueError):
        SyncHandle(future=f).wait()
    assert flight.recorder.entries()[-1]["status"] == "failed"


def test_wait_records_nothing_with_the_recorder_off():
    tmpi.start(ranks=P, device="cpu")
    assert not flight.enabled()
    tmpi.wait(tmpi.async_.allreduce_tensor(torch.ones(P, 8)))
    assert not flight.recorder.entries()


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------


def _fire(wd_mod, fr, d):
    fr.enable()
    fr.recorder.reset()
    fr.recorder.record("global[2]", "allreduce", payload=((2, 64), "float32"), backend="ring")
    wd = wd_mod.start_watchdog(0.2, interval=0.05, heartbeat_dir=d, rank=0)
    deadline = time.time() + 5
    while not wd.hang_reports and time.time() < deadline:
        time.sleep(0.05)
    wd_mod.stop_watchdog()
    return json.loads((d / "hang_rank_0.json").read_text())


def test_watchdog_flags_a_stuck_entry_like_jax(tmp_path):
    report = _fire(watchdog, flight, tmp_path / "port")
    jreport = _fire(jwatchdog, jflight, tmp_path / "jax")
    assert report["reason"] == jreport["reason"] == "in_flight_timeout"
    assert sorted(report) == sorted(jreport)
    assert sorted(report["detail"]) == sorted(jreport["detail"])
    stuck, jstuck = report["detail"]["stuck"][0], jreport["detail"]["stuck"][0]
    assert sorted(stuck) == sorted(jstuck)
    assert (stuck["op"], stuck["status"], stuck["payload"]) == \
        (jstuck["op"], jstuck["status"], jstuck["payload"]) == \
        ("allreduce", "issued", "(2, 64):float32")
    assert sorted(report["flight_recorder"]) == sorted(jreport["flight_recorder"])
    assert sorted(report["telemetry"]) == sorted(jreport["telemetry"])
    assert report["threads"]


def test_watchdog_heartbeat_env_arming_and_start_stop(tmp_path, monkeypatch):
    wd = watchdog.start_watchdog(5.0, interval=0.05, heartbeat_dir=tmp_path, rank=3)
    hb = tmp_path / "heartbeat_rank_3.json"
    deadline = time.time() + 5
    while not hb.exists() and time.time() < deadline:
        time.sleep(0.02)
    assert json.loads(hb.read_text())["rank"] == 3
    watchdog.stop_watchdog()
    assert not hb.exists() and watchdog.active() is None and wd.source == "constants"
    # armed from the environment, it outlives a runtime stop
    monkeypatch.setenv("TORCHMPI_TPU_WATCHDOG", "30")
    watchdog._maybe_start_from_env()
    env_wd = watchdog.active()
    assert env_wd is not None and env_wd.source == "env" and flight.enabled()
    tmpi.start(ranks=2, device="cpu")
    tmpi.stop()
    assert watchdog.active() is env_wd
    watchdog.stop_watchdog()
    # armed by the constant, start() to stop()
    tmpi.start(ranks=2, device="cpu", watchdog_timeout_seconds=30)
    assert watchdog.active() is not None and watchdog.active().source == "constants"
    tmpi.stop()
    assert watchdog.active() is None
