"""The port's reshard planner (``torchmpi_tpu_torch.reshard``) against the
JAX package's (``torchmpi_tpu.reshard``), and the port's offline
reshaper CLI.

Exact equality throughout, over a grid of element counts n in {0, 1, 7,
100, 4099}, source and target worlds 1-8 and every rotation of the
source world: ``Layout.intervals``, ``plan_transfers`` (every field of
every transfer, in order), the ``Redistributor``'s compiled plan id and
transfers, ``build_plan``'s description and cost estimate, and the arrays
``redistribute_arrays`` hands out (also with chunking down to 4 bytes).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torchmpi_tpu.reshard as jrs
import torchmpi_tpu_torch as tmpi
import torchmpi_tpu_torch.reshard as trs
from torchmpi_tpu_torch.engine import SGD, AllReduceSGDEngine
from torchmpi_tpu_torch.models import MLP6, init_params, make_loss_fn
from torchmpi_tpu_torch.utils import checkpoint as tck

REPO = Path(__file__).resolve().parent.parent
NS = (0, 1, 7, 100, 4099)
WORLDS = range(1, 9)


@pytest.fixture(autouse=True)
def _fresh_port():
    yield
    tmpi.runtime_state._reset_for_tests()
    tmpi.constants._reset_for_tests()


def _fields(transfers):
    return [dataclasses.astuple(t) for t in transfers]


@pytest.mark.parametrize("src", WORLDS)
@pytest.mark.parametrize("n", NS)
def test_intervals_and_transfers_equal_jax(n, src):
    """Every rotation of the source world and every target world: the
    same intervals, the same minimal transfers, the same wire count."""
    for rot in range(src):
        assert trs.Layout(src, rotation=rot).intervals(n) == \
            jrs.Layout(src, rotation=rot).intervals(n)
        assert trs.Layout(src, rotation=rot).token() == jrs.Layout(src, rotation=rot).token()
        for dst in WORLDS:
            for kind in ("sharded", "replicated"):
                ours = trs.plan_transfers(n, trs.Layout(src, kind, rot), trs.Layout(dst))
                ref = jrs.plan_transfers(n, jrs.Layout(src, kind, rot), jrs.Layout(dst))
                assert _fields(ours) == _fields(ref), (n, src, dst, rot, kind)
                assert trs.wire_elements(ours) == jrs.wire_elements(ref)


@pytest.mark.parametrize("src", WORLDS)
@pytest.mark.parametrize("n", NS)
def test_redistributor_plans_equal_jax(n, src):
    """The compiled plan (its id, description and cost estimate) and the
    chunked transfers of every (source, target) pair."""
    for dst in WORLDS:
        for chunk in (None, 64):
            ours = trs.Redistributor(n, np.float32, trs.Layout(src), trs.Layout(dst), chunk)
            ref = jrs.Redistributor(n, np.float32, jrs.Layout(src), jrs.Layout(dst), chunk)
            assert ours.plan.plan_id == ref.plan.plan_id
            assert ours.plan.describe() == ref.plan.describe()
            assert trs.estimate_us(ours.plan) == jrs.estimate_us(ref.plan)
            assert _fields(ours.transfers) == _fields(ref.transfers)
            assert ours.chunk_elems == ref.chunk_elems
            assert _fields(trs.chunk_transfers(ours.transfers, 3)) == \
                _fields(jrs.chunk_transfers(ref.transfers, 3))


@pytest.mark.parametrize("n", NS)
def test_redistribute_arrays_equals_jax(n):
    """The arrays and the scratch bound of ``redistribute_arrays`` for
    every (source, target) world pair, unchunked and in 4-byte chunks."""
    full = np.arange(n, dtype=np.float32) * np.float32(0.5) - 3
    for src in WORLDS:
        shards = {r: full[s:e] for r, (s, e) in enumerate(jrs.Layout(src).intervals(n))}
        for dst in WORLDS:
            for chunk in (None, 4):
                ours, ord_ = trs.redistribute_arrays(shards, n, trs.Layout(src), trs.Layout(dst),
                                                     chunk)
                ref, rrd = jrs.redistribute_arrays(shards, n, jrs.Layout(src), jrs.Layout(dst),
                                                   chunk)
                assert sorted(ours) == sorted(ref)
                for r in ref:
                    np.testing.assert_array_equal(ours[r], ref[r])
                assert ord_.peak_scratch_bytes == rrd.peak_scratch_bytes
    assert list(trs.chunk_spans(n, 10)) == list(jrs.chunk_spans(n, 10))


def test_layout_rejects_what_jax_rejects():
    for args in ((0,), (2, "striped")):
        with pytest.raises(ValueError) as ours:
            trs.Layout(*args)
        with pytest.raises(ValueError) as ref:
            jrs.Layout(*args)
        assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="n must be >= 0"):
        trs.plan_transfers(-1, trs.Layout(1), trs.Layout(2))


def _fsdp_engine(p):
    tmpi.start(ranks=p, device="cpu")
    model = MLP6(features=32)
    return AllReduceSGDEngine(make_loss_fn(model), init_params(model, seed=0),
                              optimizer=SGD(0.1, momentum=0.9), param_sharding="fsdp")


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "torchmpi_tpu_torch.reshard", *map(str, args)],
        cwd=str(REPO), capture_output=True, text=True, timeout=120,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )


def test_reshard_cli_reshapes_and_explains(tmp_path):
    """``python -m torchmpi_tpu_torch.reshard``: a 4-way checkpoint to 2
    ways (the JSON stats), ``--from`` checked against the header, and
    ``--explain`` printing the plans and writing nothing."""
    eng = _fsdp_engine(4)
    tck.save_engine_sharded(tmp_path / "ck", eng, step=0)
    out = _cli("--from", 4, "--to", 2, tmp_path / "ck", tmp_path / "ck2", "--json")
    assert out.returncode == 0, out.stderr[-2000:]
    stats = json.loads(out.stdout)
    assert stats["from"] == 4 and stats["to"] == 2
    assert tck.read_sharded_meta(tmp_path / "ck2")["world"] == 2
    bad = _cli("--from", 8, "--to", 2, tmp_path / "ck", tmp_path / "ck3")
    assert bad.returncode == 2 and "4-way world" in bad.stderr
    assert not (tmp_path / "ck3").exists()
    ex = _cli("--to", 2, "--explain", tmp_path / "ck")
    assert ex.returncode == 0 and "op=reshard" in ex.stdout
    # the reshaped checkpoint restores onto a 2-way engine, equal to the
    # saved state
    tmpi.runtime_state._reset_for_tests()
    eng2 = _fsdp_engine(2)
    tck.restore_engine_sharded(tmp_path / "ck2", eng2)
    saved = tck.host_state(eng)
    for k, v in tck.host_state(eng2)["params"].items():
        assert torch.equal(v, saved["params"][k])
