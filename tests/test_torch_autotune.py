"""The port's autotuner (``utils/autotune.py``) against the JAX package's,
on the CPU at p = 8.

- Each tuner measures the same candidates as the JAX tuner on the same
  communicator (the flat one and a cartesian two-level one), up to the
  backend names; ``tune_plan`` measures the same generator families.
  The timings themselves are the host's and are not compared.
- ``save_tuning`` -> ``stop()`` -> ``start()`` re-applies the tuned
  constants and the plan override under the key ``cpu:8``; an explicit
  ``start(**overrides)`` still wins, and ``load_tuned_constants=False``
  loads nothing.
- With the constants frozen each tuner raises as the JAX one does.
- ``tune_ps_chunk_bytes`` raises naming ROADMAP A13, and ``tune_all``
  keeps that reason under its key.
- No tuner steps past a broken kernel: on a CUDA communicator a kernel
  candidate that sums wrong raises, ``tune_all`` then restores what it
  found and persists nothing; ``tune_plan`` races the synthesized
  families as the JAX tuner does, reports one that sums wrong
  ``incorrect`` and lets one that raises propagate.

Each cache is pointed at ``tmp_path``.
"""

import json
from types import SimpleNamespace

import jax
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu import constants as jconstants
from torchmpi_tpu.utils import autotune as jautotune
from torchmpi_tpu_torch import constants, telemetry, utils
from torchmpi_tpu_torch.ops._build import KernelResultError
from torchmpi_tpu_torch.schedule import compiler as sched
from torchmpi_tpu_torch.utils import autotune

TWO_LEVEL = lambda r: str(r % 2)  # noqa: E731 - two groups of four


@pytest.fixture(autouse=True)
def _fresh_port(monkeypatch, tmp_path):
    monkeypatch.setenv("TORCHMPI_TPU_TUNING_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("TORCHMPI_TPU_CALIBRATION_CACHE", str(tmp_path / "calibration.json"))
    yield
    tmpi.runtime_state._reset_for_tests()
    constants._reset_for_tests()
    sched.clear_plan_overrides()
    telemetry.reset()


def _start_both(two_level: bool):
    tmpi.start(ranks=8, device="cpu")
    jmpi.start(devices=jax.devices()[:8])
    if two_level:
        tmpi.push_communicator(TWO_LEVEL, name="two")
        jmpi.push_communicator(TWO_LEVEL, name="two")


def _candidates(results):
    """Each measured candidate, with its verdict where it was not timed."""
    return [r[0] if r[1] is not None else (r[0], r[2]) for r in results]


TUNERS = {
    "tune_allreduce_cutoff": dict(min_pow=4, max_pow=5),
    "tune_broadcast_cutoff": dict(min_pow=4, max_pow=5),
    "tune_tree_pipeline_switch": dict(min_pow=4, max_pow=5),
    "tune_chunk_size": dict(nelem=1 << 10, candidates=(1 << 10, 1 << 12)),
    "tune_ring_implementation": dict(nelem=1 << 10),
    "tune_wire_dtype": dict(nelem=1 << 10),
    "tune_plan": dict(nelem=1 << 12),
    "tune_pipeline_depth": dict(nelem=1 << 14),
    "tune_fusion_threshold": dict(leaf_sizes=(10, 20, 30), candidates=(0, 64, 1 << 20)),
}


@pytest.mark.parametrize("two_level", [False, True])
@pytest.mark.parametrize("name", sorted(TUNERS))
def test_tuner_measures_the_jax_candidates(name, two_level):
    _start_both(two_level)
    for pkg in (constants, jconstants):
        pkg.set("wire_quant_min_elements", 256)
        pkg.set("plan_pipeline_min_chunk_bytes", 1 << 10)
    kw = dict(TUNERS[name], warmup=0, timed=1, apply=False)
    _, results = getattr(autotune, name)(**kw)
    _, jresults = getattr(jautotune, name)(**kw)
    assert _candidates(results) == _candidates(jresults)
    assert all(len(r) >= 2 for r in results)
    if name == "tune_plan":
        assert all(r[1] is not None for r in results)
        assert {r[0] for r in results} >= ({"flat", "hier", "staged"} if two_level else {"flat"})
    if name == "tune_pipeline_depth":
        assert [r[0] for r in results] == [1, 2, 4, 8]
    audit = telemetry.audit_log()[-1]
    assert audit["event"] == "autotune" and audit["applied"] is False


def test_save_stop_start_reapplies_tuning_and_overrides_win(tmp_path):
    tmpi.start(ranks=8, device="cpu")
    comm = tmpi.current_communicator()
    cutoff, _ = autotune.tune_allreduce_cutoff(min_pow=4, max_pow=5, warmup=0, timed=1)
    assert constants.get("small_allreduce_size_cpu") == cutoff
    winner, _ = autotune.tune_plan(nelem=1 << 12, warmup=0, timed=1)
    constants.set("wire_dtype", "int8")
    constants.set("fusion_buffer_bytes", 12345)
    path = autotune.save_tuning(comm)
    assert path == tmp_path / "autotune.json"
    entry = json.loads(path.read_text())["cpu:8"]
    assert entry["small_allreduce_size_cpu"] == cutoff and entry["wire_dtype"] == "int8"
    assert list(entry["plan_overrides"].values()) == [winner]
    overrides = dict(sched.plan_overrides())
    tmpi.stop()
    constants._reset_for_tests()
    sched.clear_plan_overrides()
    tmpi.start(ranks=8, device="cpu")
    assert constants.get("small_allreduce_size_cpu") == cutoff
    assert (constants.get("wire_dtype"), constants.get("fusion_buffer_bytes")) == ("int8", 12345)
    assert sched.plan_overrides() == overrides
    load = [e for e in telemetry.audit_log() if e["event"] == "autotune_load"][-1]
    assert load["key"] == "cpu:8" and load["applied"]["wire_dtype"] == "int8"
    # an explicit override beats the tuned value; the environment's too
    tmpi.stop()
    constants._reset_for_tests()
    tmpi.start(ranks=8, device="cpu", wire_dtype="bf16")
    assert constants.get("wire_dtype") == "bf16"
    assert constants.get("fusion_buffer_bytes") == 12345
    tmpi.stop()
    constants._reset_for_tests()
    tmpi.start(ranks=8, device="cpu", load_tuned_constants=False)
    assert constants.get("wire_dtype") == "full"
    # another world size has no entry
    tmpi.stop()
    constants._reset_for_tests()
    tmpi.start(ranks=4, device="cpu")
    assert constants.get("wire_dtype") == "full"
    assert autotune.load_tuning() is None


def test_tuning_cache_default_path_is_the_ports(monkeypatch):
    monkeypatch.delenv("TORCHMPI_TPU_TUNING_CACHE")
    path = autotune._cache_path()
    assert path.parts[-2:] == ("torchmpi_tpu_torch", "autotune.json")
    assert path != jautotune._cache_path()
    assert utils.autotune is autotune and "autotune" in utils.__all__


# the tuners that set constants to pin what they measure: frozen
# constants stop them even with apply=False
MUTATING = ["tune_tree_pipeline_switch", "tune_chunk_size", "tune_ring_implementation",
            "tune_wire_dtype", "tune_pipeline_depth", "tune_fusion_threshold",
            "tune_ps_chunk_bytes"]
# (tune_plan sets a plan override, no constant, and checks nothing in
# either package)
FROZEN_CASES = ([(name, True) for name in sorted(TUNERS) + ["tune_ps_chunk_bytes", "tune_all"]
                 if name != "tune_plan"]
                + [(name, False) for name in MUTATING])


@pytest.mark.parametrize("name,apply", FROZEN_CASES)
def test_frozen_constants_raise_as_in_jax(name, apply):
    _start_both(False)
    for pkg, mod in ((constants, autotune), (jconstants, jautotune)):
        pkg.freeze_constants()
        try:
            with pytest.raises(pkg.FrozenConstantsError):
                getattr(mod, name)(apply=apply)
        finally:
            pkg._reset_for_tests()


def test_ps_chunk_bytes_names_a13_and_tune_all_keeps_the_reason(monkeypatch):
    tmpi.start(ranks=8, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        autotune.tune_ps_chunk_bytes()
    calls = []

    def fake(name, value):
        def run(*a, **k):
            calls.append(name)
            return value, []
        return run

    for name, value in (("tune_allreduce_cutoff", 100), ("tune_broadcast_cutoff", 200),
                        ("tune_tree_pipeline_switch", 300), ("tune_chunk_size", 1 << 18),
                        ("tune_ring_implementation", "ppermute"), ("tune_wire_dtype", "full"),
                        ("tune_plan", "flat"), ("tune_pipeline_depth", 1),
                        ("tune_fusion_threshold", 0)):
        monkeypatch.setattr(autotune, name, fake(name, value))
    out = autotune.tune_all(quick=True)
    assert out["ps_chunk_bytes"] == autotune.PS_CHUNK_REASON and "A13" in out["ps_chunk_bytes"]
    assert len(calls) == 9 and out["plan"] == "flat" and out["small_allreduce"] == 100
    assert "cpu:8" in json.loads(autotune._cache_path().read_text())


def test_a_wrong_kernel_result_on_the_card_raises():
    card = SimpleNamespace(device=torch.device("cuda", 0))
    host = SimpleNamespace(device=torch.device("cpu"))
    with pytest.raises(KernelResultError, match="wire_dtype 'int8'"):
        autotune._require_kernel_ok(card, "kernel", False, "wire_dtype 'int8'")
    # a correct kernel, the ring path and the CPU's plain versions do not raise
    autotune._require_kernel_ok(card, "kernel", True, "x")
    autotune._require_kernel_ok(card, "ring", False, "x")
    autotune._require_kernel_ok(host, "kernel", False, "x")


def test_tune_all_restores_and_persists_nothing_when_a_tuner_fails(monkeypatch):
    tmpi.start(ranks=8, device="cpu")
    before = constants.snapshot()
    sched.set_plan_override("k", "flat")

    def cutoff(*a, **k):
        constants.set("small_allreduce_size_cpu", 7)
        return 7, []

    def plan(*a, **k):
        sched.set_plan_override("other", "hier")
        raise KernelResultError("the 'flat' plan gave a wrong result")

    monkeypatch.setattr(autotune, "tune_allreduce_cutoff", cutoff)
    for name in ("tune_broadcast_cutoff", "tune_tree_pipeline_switch", "tune_chunk_size",
                 "tune_ring_implementation", "tune_wire_dtype"):
        monkeypatch.setattr(autotune, name, lambda *a, **k: (0, []))
    monkeypatch.setattr(autotune, "tune_plan", plan)
    with pytest.raises(KernelResultError):
        autotune.tune_all(quick=True)
    assert constants.snapshot() == before
    assert sched.plan_overrides() == {"k": "flat"}
    assert not autotune._cache_path().exists()


def test_tune_plan_races_the_synthesized_families(monkeypatch):
    _start_both(True)
    for c in (constants, jconstants):
        c.set("use_plan_synthesis", True)
    _, results = autotune.tune_plan(nelem=1 << 12, warmup=0, timed=1, apply=False)
    _, jresults = jautotune.tune_plan(nelem=1 << 12, warmup=0, timed=1, apply=False)
    assert _candidates(results) == _candidates(jresults)
    assert {r[0] for r in results if r[1] is not None} >= {"flat", "hier", "torus~synth",
                                                             "stripe~synth"}
    real = sched.compile_collective

    def wrong_torus(op, shape, dtype, comm, generator=None, **kw):
        ep = real(op, shape, dtype, comm, generator=generator, **kw)
        if generator != "torus~synth":
            return ep
        return SimpleNamespace(execute=lambda x: torch.zeros_like(x))

    monkeypatch.setattr(sched, "compile_collective", wrong_torus)
    _, results = autotune.tune_plan(nelem=1 << 12, warmup=0, timed=1, apply=False)
    assert ("torus~synth", None, "incorrect") in results

    def broken(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(sched, "compile_collective", lambda *a, **k: SimpleNamespace(execute=broken))
    with pytest.raises(RuntimeError, match="launch failed"):
        autotune.tune_plan(nelem=1 << 12, warmup=0, timed=1, apply=False)
