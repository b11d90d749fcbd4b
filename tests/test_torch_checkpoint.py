"""The port's checkpoints (``torchmpi_tpu_torch.utils.checkpoint``), the
engine's ``checkpoint_every`` and the checkpoint registry, on the CPU,
against the JAX package where the two share a format.

The engine is ``MLP6(features=32)`` at p=4 (p=8 for the 8 -> 4 -> 8
reshape), its selector pinned to the kernel backend, the card's choice,
so the kernel rings' plain versions carry the sync. Tolerances:

- a save and a restore, and a run of 3 steps, a save, a restore into a
  fresh engine and 3 more steps against 6 unbroken steps: bit for bit,
  in each of 'replicated', 'zero1' and 'fsdp', with momentum SGD and with
  Adam;
- the resumed run against the JAX engine's 6 steps from the same weights
  and batches: losses within rtol 1e-4, parameters within atol 1e-5
  (``tests/test_torch_engine.py``'s parity bounds). Adam runs at eps 1e-3,
  as in ``tests/test_torch_sharded.py`` (whose docstring says why);
- reshapes, cross-world restores and the JAX package's reshaper on a port
  checkpoint: bytes and arrays exactly equal;
- the registry's records: equal to the JAX registry's, timestamps aside.
"""

import json
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu.engine import AllReduceSGDEngine as JEngine
from torchmpi_tpu.models import MLP6 as JMLP6
from torchmpi_tpu.models import make_loss_fn as jloss
from torchmpi_tpu.supervise import checkpoints as jreg
from torchmpi_tpu.utils import checkpoint as jck
from torchmpi_tpu_torch.engine import SGD, Adam, AllReduceSGDEngine
from torchmpi_tpu_torch.models import MLP6, from_jax_params, make_loss_fn
from torchmpi_tpu_torch.parameterserver import PSGroup
from torchmpi_tpu_torch.supervise import checkpoints as treg
from torchmpi_tpu_torch.utils import checkpoint as tck

P = 4
WIDTH = 32
SHARDINGS = ("replicated", "zero1", "fsdp")


@pytest.fixture(autouse=True)
def _fresh_port(monkeypatch):
    monkeypatch.delenv(treg.STATE_ENV, raising=False)
    treg._reset_for_tests()
    yield
    tmpi.runtime_state._reset_for_tests()
    tmpi.constants._reset_for_tests()
    treg._reset_for_tests()


@pytest.fixture(autouse=True)
def kernel_route(monkeypatch):
    monkeypatch.setattr(tmpi.collectives.selector, "select", lambda *a, **k: "kernel")


def _flax_weights(width=WIDTH, seed=0):
    """MLP6's flax variables as numpy, kernels with variance 1/fan_in and
    biases off 0 (flax's initialisers traced, not run)."""
    shapes = jax.eval_shape(lambda k: JMLP6(features=width).init(k, jnp.zeros((1, 28, 28))),
                            jax.random.PRNGKey(0))["params"]
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        z = rs.randn(*leaf.shape).astype(np.float32)
        if path[-1].key == "kernel":
            return z / np.float32(np.sqrt(leaf.shape[0]))
        return np.float32(0.1) * z

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _optimizer(name, package):
    if name == "momentum":
        return optax.sgd(0.1, momentum=0.9) if package == "jax" else SGD(0.1, momentum=0.9)
    return optax.adam(1e-2, eps=1e-3) if package == "jax" else Adam(1e-2, eps=1e-3)


def _engine(sharding="fsdp", opt="momentum", p=P, width=WIDTH, start=True):
    if start:
        tmpi.start(ranks=p, device="cpu")
    model = MLP6(features=width)
    return AllReduceSGDEngine(make_loss_fn(model), from_jax_params(_flax_weights(width)),
                              optimizer=_optimizer(opt, "port"), param_sharding=sharding)


def _batches(steps=6, p=P, per_rank=8, seed=1):
    rs = np.random.RandomState(seed)
    return [(rs.rand(p, per_rank, 28, 28).astype(np.float32),
             rs.randint(0, 10, (p, per_rank)).astype(np.int64)) for _ in range(steps)]


def _t(batch):
    return tuple(torch.from_numpy(a) for a in batch)


def _leaves(engine):
    return tck._walk({"params": engine.params, "opt_state": engine.opt_state,
                      "model_state": engine.model_state})


def _assert_same_state(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.shape == y.shape and torch.equal(x, y), k
        else:
            assert x == y, k


@pytest.mark.parametrize("opt", ["momentum", "adam"])
@pytest.mark.parametrize("sharding", SHARDINGS)
def test_same_world_round_trip_is_bitwise(sharding, opt, tmp_path):
    """Two steps, a save, a restore into a fresh engine: every live leaf
    (the shards under fsdp/zero1, the step count under Adam) equal."""
    eng = _engine(sharding, opt)
    for b in _batches(2):
        eng.step(_t(b))
    tck.save_engine_sharded(tmp_path / "ck", eng, step=2)
    fresh = _engine(sharding, opt, start=False)
    meta = tck.restore_engine_sharded(tmp_path / "ck", fresh)
    assert meta["step"] == 2 and meta["world"] == P and meta["sharding"] == sharding
    _assert_same_state(eng, fresh)


@pytest.mark.parametrize("sharding", SHARDINGS)
def test_single_process_format_round_trip(sharding, tmp_path):
    eng = _engine(sharding)
    for b in _batches(2):
        eng.step(_t(b))
    tck.save_engine(tmp_path / "ck", eng, step=2, extra={"note": "x"})
    fresh = _engine(sharding, start=False)
    meta = tck.restore_engine(tmp_path / "ck", fresh)
    assert meta["step"] == 2 and meta["note"] == "x"
    _assert_same_state(eng, fresh)


def _jax_run(opt, sharding, batches):
    jmpi.start(devices=jax.devices()[:P])
    jeng = JEngine(jloss(JMLP6(features=WIDTH)), _flax_weights(), optimizer=_optimizer(opt, "jax"),
                   param_sharding=sharding)
    losses = [float(jeng.step((x.reshape(-1, 28, 28), y.reshape(-1)))) for x, y in batches]
    return losses, from_jax_params(jax.device_get(jeng.params))


@pytest.mark.parametrize("opt", ["momentum", "adam"])
@pytest.mark.parametrize("sharding", SHARDINGS)
def test_resumed_run_equals_unbroken_run(sharding, opt, tmp_path):
    """3 steps with ``checkpoint_every(3)``, a flush, a restore into a
    fresh engine and 3 more steps: the losses and every leaf bit for bit
    those of 6 unbroken steps, and within the parity bounds of the JAX
    engine's 6 steps."""
    batches = _batches(6)
    unbroken = _engine(sharding, opt)
    losses = [float(unbroken.step(_t(b))) for b in batches]
    first = _engine(sharding, opt, start=False)
    first.checkpoint_every(3, tmp_path / "ck")
    resumed = [float(first.step(_t(b))) for b in batches[:3]]
    first.flush_checkpoint()
    second = _engine(sharding, opt, start=False)
    meta = tck.restore_engine_sharded(tmp_path / "ck", second)
    assert meta["step"] == 3
    second.checkpoint_every(3, tmp_path / "ck", start_step=meta["step"])
    resumed += [float(second.step(_t(b))) for b in batches[3:]]
    second.flush_checkpoint()
    assert resumed == losses
    _assert_same_state(unbroken, second)
    assert tck.read_sharded_meta(tmp_path / "ck")["step"] == 6
    jlosses, jparams = _jax_run(opt, sharding, batches)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    ours = {k: v[0].numpy() for k, v in second.gathered_params().items()}
    for k, v in jparams.items():
        np.testing.assert_allclose(ours[k], v.numpy(), rtol=0, atol=1e-5, err_msg=k)


def _files(data_dir: Path) -> dict:
    return {f.name: f.read_bytes() for f in sorted(data_dir.iterdir())}


@pytest.mark.parametrize("chunk_bytes", [None, 256])
def test_reshape_8_4_8_is_byte_identical(chunk_bytes, tmp_path):
    """An 8-way fsdp checkpoint reshaped to 4 ways and back writes the
    same files byte for byte, the scratch below twice the largest shard."""
    eng = _engine("fsdp", p=8, width=64)
    eng.step(_t(_batches(1, p=8)[0]))
    tck.save_engine_sharded(tmp_path / "ck8", eng, step=1)
    s4 = tck.reshape_sharded(tmp_path / "ck8", tmp_path / "ck4", 4, chunk_bytes=chunk_bytes)
    s8 = tck.reshape_sharded(tmp_path / "ck4", tmp_path / "ck8b", 8, chunk_bytes=chunk_bytes)
    assert (s4["from"], s4["to"], s8["from"], s8["to"]) == (8, 4, 4, 8)
    for stats in (s4, s8):
        assert stats["peak_scratch_bytes"] < 2 * stats["largest_shard_bytes"]
    assert _files(tck.current_data_dir(tmp_path / "ck8")) == \
        _files(tck.current_data_dir(tmp_path / "ck8b"))
    assert len(list(tck.current_data_dir(tmp_path / "ck4").glob("leaf0.rank*.npy"))) == 4


def test_fsdp_shard_files_are_the_live_shards(tmp_path):
    """Under fsdp at the engine's world, a sharded leaf's file of rank r
    holds its live shard r."""
    eng = _engine("fsdp")
    tck.save_engine_sharded(tmp_path / "ck", eng)
    meta = tck.read_sharded_meta(tmp_path / "ck")
    data = tck.current_data_dir(tmp_path / "ck")
    i = next(i for i, rec in enumerate(meta["leaves"])
             if rec["tree"] == "params" and rec["path"] == "['dense1.weight']")
    for r in range(P):
        np.testing.assert_array_equal(np.load(data / f"leaf{i}.rank{r}.npy"),
                                      eng.params["dense1.weight"][r].numpy())


@pytest.mark.parametrize("src,dst", [(8, 4), (4, 8), (8, 2)])
def test_cross_world_restore_is_transparent(src, dst, tmp_path):
    """A ``src``-way fsdp checkpoint restores onto a ``dst``-way engine
    through the reshard planner: the logical parameters and momentum
    equal the saved ones."""
    eng = _engine("fsdp", p=src)
    eng.step(_t(_batches(1, p=src)[0]))
    tck.save_engine_sharded(tmp_path / "ck", eng, step=1)
    saved = tck.host_state(eng)
    tmpi.runtime_state._reset_for_tests()
    other = _engine("fsdp", p=dst)
    tck.restore_engine_sharded(tmp_path / "ck", other)
    got = tck.host_state(other)
    for name in ("params", "opt_state"):
        for k, v in saved[name].items():
            assert torch.equal(got[name][k], v), (name, k)
    # and the restored engine trains on
    other.step(_t(_batches(1, p=dst)[0]))


def test_jax_tools_read_and_reshape_a_port_checkpoint(tmp_path):
    """The format is shared: the JAX package's ``read_sharded_meta`` reads
    a port checkpoint, and its ``reshape_sharded`` writes the same bytes
    and stats as the port's."""
    eng = _engine("zero1", opt="adam", p=8, width=64)
    eng.step(_t(_batches(1, p=8)[0]))
    tck.save_engine_sharded(tmp_path / "ck", eng, step=1)
    assert jck.read_sharded_meta(tmp_path / "ck") == tck.read_sharded_meta(tmp_path / "ck")
    ours = tck.reshape_sharded(tmp_path / "ck", tmp_path / "port3", 3, chunk_bytes=512)
    ref = jck.reshape_sharded(tmp_path / "ck", tmp_path / "jax3", 3, chunk_bytes=512)
    assert ours == ref
    assert _files(tck.current_data_dir(tmp_path / "port3")) == \
        _files(jck.current_data_dir(tmp_path / "jax3"))


def test_sharded_save_is_atomic_against_kill(tmp_path):
    """``tests/test_reshard.py:253``: a save killed at any point leaves the
    previous checkpoint readable, and the next save removes the orphan and
    the superseded payload."""
    eng = _engine("zero1")
    tck.save_engine_sharded(tmp_path / "ck", eng, step=1)
    before = tck.read_sharded_meta(tmp_path / "ck")
    tmp_dir = tmp_path / "ck" / ".tmp-deadbeef"
    tmp_dir.mkdir()
    (tmp_dir / "leaf0.rank0.npy").write_bytes(b"torn")
    assert tck.read_sharded_meta(tmp_path / "ck") == before, "killed save must not be visible"
    tck.restore_engine_sharded(tmp_path / "ck", _engine("zero1", start=False))
    old_dir = tck.current_data_dir(tmp_path / "ck")
    tck.save_engine_sharded(tmp_path / "ck", eng, step=2)
    assert not tmp_dir.exists() and not old_dir.exists()
    assert tck.read_sharded_meta(tmp_path / "ck")["step"] == 2


@pytest.mark.parametrize("field", ["param_sharding", "fingerprint", "world"])
def test_restore_mismatch_is_named(field, tmp_path):
    """``tests/test_reshard.py:276-295``: each mismatch raises before any
    state is touched, naming its field (a world mismatch of the
    single-process format names the port's reshaper)."""
    eng = _engine("zero1")
    tck.save_engine_sharded(tmp_path / "ck", eng, step=1)
    tck.save_engine(tmp_path / "single", eng, step=1)
    if field == "param_sharding":
        target, restore, path = _engine("fsdp", start=False), tck.restore_engine_sharded, "ck"
    elif field == "fingerprint":
        target, restore, path = (_engine("zero1", width=16, start=False),
                                 tck.restore_engine_sharded, "ck")
    else:
        tmpi.runtime_state._reset_for_tests()
        target, restore, path = _engine("zero1", p=2), tck.restore_engine, "single"
    before = [v.clone() for v in target.params.values()]
    with pytest.raises(tck.CheckpointMismatchError, match=field) as err:
        restore(tmp_path / path, target)
    if field == "world":
        assert "python -m torchmpi_tpu_torch.reshard --from 4 --to 2" in str(err.value)
    assert all(torch.equal(a, b) for a, b in zip(before, target.params.values()))


def test_checkpoint_every_counts_step_calls_only(tmp_path):
    """Every 2 calls of ``step``: the saves publish at steps 2 and 4 of 5;
    ``train`` neither counts nor saves."""
    eng = _engine("replicated")
    eng.checkpoint_every(2, tmp_path / "ck")
    seen = []
    for b in _batches(5):
        eng.step(_t(b))
        eng.flush_checkpoint()
        rec = treg.last_checkpoint()
        seen.append(None if rec is None else rec["step"])
    assert seen == [None, 2, 2, 4, 4]
    eng.train(lambda: iter([_t(b) for b in _batches(3)]), max_epochs=1)
    eng.flush_checkpoint()
    assert tck.read_sharded_meta(tmp_path / "ck")["step"] == 4
    eng.checkpoint_every(0, tmp_path / "ck")  # disarmed
    eng.step(_t(_batches(1)[0]))
    assert eng._ckpt_thread is None or not eng._ckpt_thread.is_alive()
    with pytest.raises(ValueError, match="steps >= 0"):
        eng.checkpoint_every(-1, tmp_path / "ck")


def test_checkpoint_every_skips_while_a_save_is_in_flight(tmp_path, monkeypatch):
    """A boundary reached while the previous save still writes is
    skipped, not queued; ``flush_checkpoint`` joins the save in flight."""
    gate, calls = threading.Event(), []
    real = tck.save_engine_sharded

    def slow(path, engine, step=0, **kw):
        calls.append(step)
        gate.wait(30)
        return real(path, engine, step=step, **kw)

    monkeypatch.setattr(tck, "save_engine_sharded", slow)
    eng = _engine("fsdp")
    eng.checkpoint_every(1, tmp_path / "ck")
    for b in _batches(3):
        eng.step(_t(b))
    assert calls == [1], "steps 2 and 3 reached their boundary during the first save"
    gate.set()
    eng.flush_checkpoint()
    assert not eng._ckpt_thread.is_alive()
    assert tck.read_sharded_meta(tmp_path / "ck")["step"] == 1
    eng.step(_t(_batches(1)[0]))
    eng.flush_checkpoint()
    assert calls == [1, 4] and tck.read_sharded_meta(tmp_path / "ck")["step"] == 4


def test_a_failed_save_is_warned_once(tmp_path, capsys):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    eng = _engine("replicated")
    eng.checkpoint_every(1, blocker / "ck")
    for b in _batches(3):
        eng.step(_t(b))
        eng.flush_checkpoint()
    err = capsys.readouterr().err
    assert err.count("checkpoint_every save to") == 1 and "further failures suppressed" in err


def _registry_sequence(reg, tmp_path, monkeypatch, sf):
    """``tests/test_supervise.py:288-319``'s calls; each step's records."""
    monkeypatch.setenv(reg.STATE_ENV, str(sf))
    reg._reset_for_tests()
    out = [reg.last_checkpoint(), "none registered" in reg.describe_last()]
    out.append(reg.register_checkpoint(tmp_path / "ck", 4))
    out.append(reg.last_checkpoint())
    out.append(reg.register_checkpoint(tmp_path / "old", 2, extra={"why": "late"}))
    out.append(reg.last_checkpoint())
    out.append(json.loads(sf.read_text()))
    sf.write_text(json.dumps({"path": str(tmp_path / "theirs"), "step": 9, "time": 0.0}))
    out += [reg.last_checkpoint(), reg.describe_last()]
    out.append(reg.register_checkpoint(tmp_path / "theirs", 1))
    out += [reg.last_checkpoint(), reg.describe_last()]
    monkeypatch.delenv(reg.STATE_ENV)
    out.append(reg.describe_last())
    return [{k: v for k, v in r.items() if k != "time"} if isinstance(r, dict) else r
            for r in out]


def test_registry_records_match_jax(tmp_path, monkeypatch):
    ours = _registry_sequence(treg, tmp_path, monkeypatch, tmp_path / "port.json")
    ref = _registry_sequence(jreg, tmp_path, monkeypatch, tmp_path / "jax.json")
    assert ours == ref
    assert treg.STATE_ENV == jreg.STATE_ENV == "TORCHMPI_TPU_CHECKPOINT_STATE"


def test_save_registers_the_published_checkpoint(tmp_path, monkeypatch):
    sf = tmp_path / "last.json"
    monkeypatch.setenv(treg.STATE_ENV, str(sf))
    eng = _engine("fsdp")
    tck.save_engine_sharded(tmp_path / "ck", eng, step=7)
    rec = treg.last_checkpoint()
    assert rec["path"] == str((tmp_path / "ck").resolve()) and rec["step"] == 7
    assert json.loads(sf.read_text())["step"] == 7


def test_parameter_server_round_trip_is_exact(tmp_path):
    """Centers saved, the servers moved on by an add, then restored by the
    'copy' rule: exactly the saved centers."""
    tmpi.start(ranks=P, device="cpu")
    rs = np.random.RandomState(3)
    tree = {"a": torch.from_numpy(rs.randn(P, 37).astype(np.float32)),
            "b": torch.from_numpy(rs.randn(P, 4, 6).astype(np.float32))}
    grp = PSGroup(tree)
    try:
        before = [srv.receive().wait().clone() for srv in grp.servers]
        tck.save_parameter_servers(tmp_path / "ps", grp)
        for srv, center in zip(grp.servers, before):
            srv.send(torch.ones_like(center), rule="add").wait()
        moved = [srv.receive().wait() for srv in grp.servers]
        assert not torch.equal(moved[0], before[0])
        tck.restore_parameter_servers(tmp_path / "ps", grp)
        for srv, want in zip(grp.servers, before):
            assert torch.equal(srv.receive().wait(), want)
    finally:
        for srv in grp.servers:
            srv.free()
