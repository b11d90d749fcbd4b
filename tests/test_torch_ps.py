"""The port's parameter server (``torchmpi_tpu_torch.parameterserver``)
against the JAX package's, on the CPU, at p=8.

Both sides get the same seeded numpy inputs; the port runs with
``start(ranks=8, device='cpu')``, where the rules' kernels run their plain
versions. Every case sets ``ps_prefetch=False`` on both sides (the exact
fetch-at-integration semantics, ``update.py:144-146``): with it on, the
eager prefetch races the same tick's sends on the pool threads in either
package, and a fetched center may or may not include them. Only the test
of the eager prefetch itself keeps it on, and it checks the schedule.

Tolerances:

- none for the closed forms (init and receive, the zero/copy/add loop, a
  scaled send at -0.5, DSGD, Downpour's sums, the wire round trips): both
  sides round alike;
- EASGD's fold ``x + alpha * (center - x)`` is one rounding in the port
  (the scaled-accumulate kernel) and two in the JAX package's numpy: one
  ulp per fold, so rtol 1e-6 per schedule step;
- the example twin (``main`` of both examples, the same synthetic data and
  initial weights, 32 steps): every step's loss rtol 1e-4, the final
  parameters and replica spread atol 1e-5, as the engine's parity (the JAX
  CPU and the torch CPU kernels of the per-rank gradients sum in other
  orders). The run takes lr 0.02: at the example's 0.2 the logistic
  regression on this data is chaotic, and a first difference of 1e-7 in
  a loss grows to 1e-2 within 32 steps. With the int8 wire the
  quantization blocks follow each side's parameter layout (a flax dense
  kernel is the port's weight transposed), so an exchanged value differs by
  up to one int8 step of its block (max|w| / 127, about 8e-4 here): losses
  rtol 2e-3, parameters and spread atol 2e-3.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu import constants as jconstants
from torchmpi_tpu.parameterserver import DownpourUpdate as JDownpour
from torchmpi_tpu.parameterserver import EASGDUpdate as JEASGD
from torchmpi_tpu.parameterserver import ParameterServer as JPS
from torchmpi_tpu.parameterserver import free_all as jfree_all
from torchmpi_tpu.parameterserver import shard_range as jshard_range
from torchmpi_tpu.parameterserver import synchronize_gradients_with_parameterserver as jsync
from torchmpi_tpu.parameterserver import server as jserver
from torchmpi_tpu.parameterserver import wire as jwire
from torchmpi_tpu_torch import parameterserver as tps
from torchmpi_tpu_torch.parameterserver import server as tserver
from torchmpi_tpu_torch.parameterserver import wire as twire
from torchmpi_tpu_torch.runtime.handles import StreamResult, SyncHandle, handles as thandles

P = 8


@pytest.fixture(autouse=True)
def _runtimes():
    # both packages rotate a server's remainder shards by its instance id:
    # number this test's instances from 0 on both sides, whatever other
    # tests in the process created before
    jserver._server._ids = itertools.count()
    tserver._server._ids = itertools.count()
    jmpi.start()
    tmpi.start(ranks=P, device="cpu")
    for c in (jconstants, tmpi.constants):
        c.set("ps_prefetch", False)
    try:
        yield
    finally:
        tps.free_all()
        jfree_all()
        tmpi.runtime_state._reset_for_tests()
        tmpi.constants._reset_for_tests()


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# ParameterServer
# ---------------------------------------------------------------------------


def test_shard_range_matches_jax():
    """getRange parity with the remainder rotation: coverage, no overlap,
    balance, and the JAX package's ranges for every rotation."""
    for n, p in [(100, 8), (7, 8), (8, 8), (1000, 7), (3, 2), (67, 8)]:
        for rot in range(p):
            ranges = [tps.shard_range(n, p, r, rot) for r in range(p)]
            assert ranges == [jshard_range(n, p, r, rot) for r in range(p)]
            assert ranges[0][0] == 0 and ranges[-1][1] == n
            assert all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))
            sizes = [e - s for s, e in ranges]
            assert max(sizes) - min(sizes) <= 1 and sum(sizes) == n


def test_instances_rotate_their_remainders():
    """Each instance rotates its remainder by its id, as the JAX instances
    do: eight mixed-dtype instances spread their extra bytes."""
    insts = [tserver._server.register(torch.zeros(67, dtype=dt), (67,), P)
             for dt in [torch.float32, torch.float64] * 4]
    try:
        loads = np.zeros(P)
        for inst in insts:
            assert inst.ranges == [jshard_range(67, P, r, inst.id % P) for r in range(P)]
            for r, (s, e) in enumerate(inst.ranges):
                loads[r] += (e - s) * inst.dtype.itemsize
        assert loads.max() - loads.min() <= 2 * 8
    finally:
        for inst in insts:
            tserver._server.unregister(inst)


def test_init_and_receive_match_jax():
    v = np.arange(100, dtype=np.float32).reshape(10, 10)
    ps, jps = tps.ParameterServer(_t(v)), JPS(v)
    out = ps.receive().wait()
    assert out.dtype == torch.float32 and tuple(out.shape) == (10, 10)
    np.testing.assert_array_equal(out.numpy(), jps.receive().wait())
    np.testing.assert_array_equal(out.numpy(), v)


def test_rule_zero_copy_add_loop_matches_jax():
    """The lua test's rule loop (parameterserver.lua:88-150) on ragged
    shards: zero, add from every rank, the sum of the contributions."""
    n = 67
    ps, jps = tps.ParameterServer(torch.zeros(n)), JPS(np.zeros(n, np.float32))
    for _ in range(5):
        for server, full in ((ps, torch.full), (jps, lambda shape, v: np.full(shape, v, np.float32))):
            server.send(full((n,), 0.0), rule="zero").wait()
            hs = [server.send(full((n,), float(r + 1)), rule="add", client=r) for r in range(P)]
            for h in hs:
                h.wait()
        out = ps.receive().wait().numpy()
        np.testing.assert_array_equal(out, P * (P + 1) / 2)
        np.testing.assert_array_equal(out, jps.receive().wait())
    assert ps._inst.versions == jps._inst.versions == [5 * (1 + P)] * P
    ps.send(torch.full((n,), 3.0), rule="copy").wait()
    np.testing.assert_array_equal(ps.receive().wait().numpy(), 3.0)


@pytest.mark.parametrize("wire", ["full", "int8"])
def test_scaled_send_matches_jax(wire):
    """A scaled 'add' at -0.5 is exact either way: fused in the port under
    the full wire (shard + scale * values, one rounding), scaled on the
    client before the int8 wire as in the JAX package."""
    for c in (jconstants, tmpi.constants):
        c.set("parameterserver_wire_dtype", wire)
    v = np.random.RandomState(0).randn(300).astype(np.float32)
    ps, jps = tps.ParameterServer(torch.ones(300)), JPS(np.ones(300, np.float32))
    ps.send(_t(v), rule="add", scale=-0.5).wait()
    jps.send(v, rule="add", scale=-0.5).wait()
    out = ps.receive().wait().numpy()
    np.testing.assert_array_equal(out, jps.receive().wait())
    if wire == "full":
        np.testing.assert_array_equal(out, 1 - 0.5 * v)
    # a scaled copy stores the scaled values, as the JAX client scales them
    ps.send(_t(v), rule="copy", scale=2.0).wait()
    jps.send(v, rule="copy", scale=2.0).wait()
    np.testing.assert_array_equal(ps.receive().wait().numpy(), jps.receive().wait())


def test_scaled_send_rounds_once():
    """Under the full wire the fused apply is the scaled-accumulate kernel's
    one rounding (the JAX client multiply rounds twice)."""
    rs = np.random.RandomState(5)
    v0, v = rs.randn(2, 4096).astype(np.float32)
    ps = tps.ParameterServer(_t(v0))
    ps.send(_t(v), rule="add", scale=0.1).wait()
    want = tmpi.ops.scale_accumulate_plain(_t(v0), _t(v), 0.1)
    assert torch.equal(ps.receive().wait(), want)


def test_multidim_and_dtypes():
    v = np.random.RandomState(0).randn(4, 5, 6).astype(np.float32)
    ps, jps = tps.ParameterServer(_t(v)), JPS(v)
    ps.send(torch.ones(4, 5, 6), rule="add").wait()
    jps.send(np.ones_like(v), rule="add").wait()
    np.testing.assert_array_equal(ps.receive().wait().numpy(), jps.receive().wait())
    # f64 shards stay f64 (and take the f64 fused apply); others become f32
    ps64 = tps.ParameterServer(torch.zeros(10, dtype=torch.float64))
    ps64.send(torch.ones(10, dtype=torch.float64), scale=1 / 3).wait()
    out = ps64.receive().wait()
    assert out.dtype == torch.float64 and bool((out == 1 / 3).all())
    assert tps.ParameterServer(torch.zeros(3, dtype=torch.int32)).dtype == torch.float32
    assert ps.shard_of(7).shape == (15,)


def test_rejections():
    ps = tps.ParameterServer(torch.zeros(4))
    with pytest.raises(KeyError):
        ps.send(torch.ones(4), rule="multiply")
    with pytest.raises(ValueError):
        ps.send(torch.ones(5))
    ps.free()
    assert ps.freed
    with pytest.raises(RuntimeError):
        ps.send(torch.ones(4))
    with pytest.raises(RuntimeError):
        ps.receive()
    with pytest.raises(RuntimeError):
        ps.shard_of(0)


def test_free_with_pending_send_never_hangs():
    ps = tps.ParameterServer(torch.zeros(8))
    h = ps.send(torch.ones(8), rule="add")
    ps.free()
    h.wait()  # applied or failed, never hung


def test_ranks_in_several_processes_raise(monkeypatch):
    comm = tmpi.current_communicator()
    monkeypatch.setattr(comm, "num_nodes", lambda: 2)
    with pytest.raises(NotImplementedError, match="A13"):
        tps.ParameterServer(torch.zeros(4), comm=comm)


def test_send_owns_its_buffer():
    """send() copies its input at once: the caller may reuse it."""
    ps = tps.ParameterServer(torch.zeros(1 << 12))
    x = torch.ones(1 << 12)
    hs = [ps.send(x, rule="add", client=r) for r in range(P)]
    x.fill_(100.0)
    for h in hs:
        assert isinstance(h, SyncHandle)
        assert h.wait() is None and h.done
    assert bool((ps.receive().wait() == P).all())


def test_in_flight_bound():
    """num_async_parameterservers_in_flight bounds the unfinished client
    ops: an enqueue past it first drains the oldest."""
    tmpi.constants.set("num_async_parameterservers_in_flight", 1)
    ps = tps.ParameterServer(torch.zeros(64))
    hs = [ps.send(torch.ones(64), client=r) for r in range(P)]
    assert len(tserver._inflight) <= 1
    for h in hs:
        h.wait()
    assert bool((ps.receive().wait() == P).all())


def test_deadlock_timeout_raises():
    """A server thread that never serves: the send fails after
    deadlock_timeout_seconds instead of blocking for ever."""
    tmpi.constants.set("deadlock_timeout_seconds", 1)
    ps = tps.ParameterServer(torch.zeros(4))
    tserver._server.shutdown()  # stops the polling thread, frees ps
    inst = tserver._Instance(999, torch.zeros(4), (4,), P)  # never registered
    ps._inst = inst
    with pytest.raises(RuntimeError, match="blocked > 1s"):
        ps.send(torch.ones(4)).wait()
    with pytest.raises(RuntimeError, match="blocked > 1s"):
        ps.receive().wait()


def test_prefetch_double_buffers():
    ps = tps.ParameterServer(torch.arange(20.0))
    h1, h2 = ps.prefetch(client=3), ps.prefetch(client=3)
    assert h1 is not h2 and ps.prefetch(client=3) is h1
    assert ps.receive(client=3) is h1 and ps.receive(client=3) is h2
    h3 = ps.receive(client=3)
    assert h3 not in (h1, h2)
    for h in (h1, h2, h3):
        assert torch.equal(h.wait(), torch.arange(20.0))


def test_future_handles_and_sync_all():
    """The future variant: wait() takes the future's result; a
    StreamResult is unwrapped (its event is None on the CPU); sync_all
    drains a registered future handle like a collective one."""
    from concurrent.futures import Future

    f = Future()
    h = SyncHandle(future=f)
    thandles.register(h, kind="ps")
    assert not h.done and thandles.outstanding == 1
    f.set_result(StreamResult(torch.ones(3), None))
    tmpi.runtime.sync_all()
    assert thandles.outstanding == 0 and torch.equal(h.wait(), torch.ones(3))
    with pytest.raises(ValueError, match="not both"):
        SyncHandle(torch.ones(1), future=Future())
    bad = Future()
    bad.set_exception(RuntimeError("boom"))
    with pytest.raises(RuntimeError, match="boom"):
        SyncHandle(future=bad).wait()


def test_stop_frees_parameter_servers():
    tps.ParameterServer(torch.zeros(4))
    thread = tserver._server._thread
    assert thread is not None and thread.is_alive()
    tmpi.stop()
    thread.join(5)
    assert not thread.is_alive() and tserver._server._thread is None
    assert tmpi.runtime.pools.parameterserver_pool._executor is None


# ---------------------------------------------------------------------------
# wire
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["bf16", "int8"])
@pytest.mark.parametrize("n", [1, 127, 128, 1000, 4099])
def test_wire_roundtrip_bitwise(name, n):
    rs = np.random.RandomState(n)
    x = (rs.randn(n) * np.exp2(rs.randint(-20, 20, n))).astype(np.float32)
    x[: n // 3] = 0.0  # a zero block keeps its zeros
    if n > 5:
        x[3] = np.float32(3.4e38)
        x[4] = -1.0e-40  # subnormal
    code = twire.wire_code(name)
    assert code == jwire.wire_code(name)
    out = twire.roundtrip(_t(x), code, 128).numpy()
    ref = jwire.roundtrip(x, code, 128)
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


def test_wire_resolution():
    assert twire.resolve_ps_wire(torch.float64, "int8") == twire.WIRE_FULL
    assert twire.resolve_ps_wire(torch.float32, "bf16") == twire.WIRE_BF16
    assert twire.resolve_ps_wire(torch.float32) == twire.WIRE_FULL
    with pytest.raises(ValueError, match="unknown parameterserver wire"):
        twire.wire_code("fp8")


# ---------------------------------------------------------------------------
# PSGroup, DSGD, schedules
# ---------------------------------------------------------------------------


def _stacked(seed=0):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(P, 11).astype(np.float32), "b": rng.randn(P, 3, 4).astype(np.float32)}


def test_psgroup_roundtrip():
    tree = _stacked()
    grp = tps.PSGroup({k: _t(v) for k, v in tree.items()})
    center = grp.receive_full()
    for k, v in tree.items():
        np.testing.assert_array_equal(center[k].numpy(), v[0])
    prefetched = grp.prefetch_full()
    assert len(prefetched) == 2 and grp.receive_full()["a"].shape == (11,)
    with pytest.raises(ValueError, match="rank-stacked"):
        tps.PSGroup({"w": torch.zeros(3, 4)})


def test_dsgd_equals_allreduce_and_jax():
    """DSGD through the PS is the averaged allreduce, equal to the JAX
    package's bit for bit (both pre-sum the ranks in rank order)."""
    tree = _stacked(seed=3)
    synced, grp = tps.synchronize_gradients_with_parameterserver({k: _t(v) for k, v in tree.items()})
    jsynced, jgrp = jsync({k: jnp.asarray(v) for k, v in tree.items()})
    for k, v in tree.items():
        got = synced[k].numpy()
        assert got.shape == v.shape
        np.testing.assert_array_equal(got, np.asarray(jsynced[k]))
        np.testing.assert_allclose(got, np.broadcast_to(v.mean(axis=0), v.shape), rtol=1e-5)
    again, grp2 = tps.synchronize_gradients_with_parameterserver(
        {k: _t(v) for k, v in tree.items()}, grp)
    assert grp2 is grp and torch.equal(again["a"], synced["a"])


def _schedule_run(make_port, make_jax, steps, grads_seed, tol):
    """Drive both schedules for ``steps`` ticks from the same params and
    seeded gradients; compare params (within ``tol``) and the schedule
    counters after every tick. Returns both updates (to read their PS)."""
    rng = np.random.RandomState(grads_seed)
    w0 = rng.randn(P, 6).astype(np.float32)
    upd, jupd = make_port(), make_jax()
    params, jparams = {"w": _t(w0)}, {"w": jnp.asarray(w0)}
    trace, jtrace = [], []
    for step in range(steps):
        g = rng.randn(P, 6).astype(np.float32)
        params = upd.update(step, params, {"w": _t(g)})
        jparams = jupd.update(step, jparams, {"w": jnp.asarray(g)})
        for u, tr in ((upd, trace), (jupd, jtrace)):
            tr.append((step, u.ps is not None, u.next_prefetch, u.next_integration,
                       getattr(u, "next_send", None)))
        np.testing.assert_allclose(params["w"].numpy(), np.asarray(jparams["w"]), rtol=tol, atol=tol)
    assert trace == jtrace
    return upd, jupd


@pytest.mark.parametrize("prefetch", [0, 2])
def test_downpour_schedule_matches_jax(prefetch):
    kw = dict(send_frequency=1, update_frequency=3, init_delay=2, prefetch=prefetch)
    upd, jupd = _schedule_run(
        lambda: tps.DownpourUpdate(local_update=lambda t: t * -0.1, **kw),
        lambda: JDownpour(local_update=lambda t: -0.1 * t, **kw),
        steps=12, grads_seed=prefetch, tol=0)
    np.testing.assert_array_equal(upd.ps.receive_full()["w"].numpy(),
                                  np.asarray(jupd.ps.receive_full()["w"]))
    upd.free()
    jupd.free()


def test_downpour_closed_form():
    """The JAX test's closed form: gradient units accumulate from step 0;
    sends at steps 2-5 deliver 3+1+1+1 = 6 units of -p*lr; the replicas
    agree after the integrations at steps 3 and 5."""
    lr = 0.1
    upd = tps.DownpourUpdate(local_update=lambda t: t * -lr, send_frequency=1,
                             update_frequency=2, init_delay=1, prefetch=0)
    params = {"w": torch.zeros(P, 8)}
    for step in range(6):
        params = upd.update(step, params, {"w": torch.ones(P, 8)})
    np.testing.assert_allclose(upd.ps.receive_full()["w"].numpy(), -lr * P * 6, rtol=1e-5)
    assert torch.equal(params["w"], params["w"][0:1].expand(P, 8))
    upd.free()


def test_easgd_schedule_matches_jax():
    kw = dict(beta=0.9, update_frequency=2, init_delay=1, prefetch=0)
    upd, jupd = _schedule_run(lambda: tps.EASGDUpdate(**kw), lambda: JEASGD(**kw),
                              steps=9, grads_seed=7, tol=1e-6)
    for h in upd.handles_send:
        h.wait()
    for h in jupd.handles_send:
        h.wait()
    np.testing.assert_allclose(upd.ps.receive_full()["w"].numpy(),
                               np.asarray(jupd.ps.receive_full()["w"]), rtol=1e-6)
    upd.free()
    jupd.free()


def test_free_applies_the_sends_in_flight():
    """EASGD leaves its sends unwaited; free() waits them before freeing,
    so every update sent is applied (and counted)."""
    upd = tps.EASGDUpdate(beta=0.9, update_frequency=1, init_delay=0, prefetch=0)
    params = {"w": torch.randn(P, 1000)}
    for step in range(2):
        params = upd.update(step, params, {"w": torch.zeros(P, 1000)})
    in_flight = list(upd.handles_send)
    assert in_flight
    upd.free()
    assert all(h.done for h in in_flight) and not upd.handles_send


def test_easgd_moves_toward_center():
    rng = np.random.RandomState(1)
    w0 = rng.randn(P, 6).astype(np.float32)
    upd = tps.EASGDUpdate(beta=0.9, update_frequency=1, init_delay=0, prefetch=0)
    zeros = {"w": torch.zeros(P, 6)}
    params = upd.update(1, upd.update(0, {"w": _t(w0)}, zeros), zeros)
    alpha = 0.9 / P
    np.testing.assert_allclose(params["w"].numpy(), w0 + alpha * (w0[0][None] - w0), rtol=1e-5)
    for h in upd.handles_send:
        h.wait()
    np.testing.assert_allclose(upd.ps.receive_full()["w"].numpy(),
                               w0[0] - alpha * (w0[0][None] - w0).sum(axis=0), rtol=1e-4)
    upd.free()


def test_update_prefetch_validation():
    with pytest.raises(ValueError):
        tps.DownpourUpdate(update_frequency=5, prefetch=9)


def test_downpour_eager_prefetch_in_flight():
    """ps_prefetch on: after an integration at prefetch distance 0 the next
    fetch is in flight at once; off, it is not (the schedule, not values)."""
    tmpi.constants.set("ps_prefetch", True)
    ones = {"w": torch.ones(P, 8)}

    def run_steps(upd, n):
        params = {"w": torch.zeros(P, 8)}
        for step in range(n):
            params = upd.update(step, params, ones)
        return params

    kw = dict(local_update=lambda t: t, send_frequency=1, update_frequency=2,
              init_delay=1, prefetch=0)
    upd = tps.DownpourUpdate(**kw)
    run_steps(upd, 4)  # first integration at step 3
    assert upd.handles_prefetch, "eager prefetch not issued"
    assert bool(torch.isfinite(run_steps(upd, 6)["w"]).all())
    upd.free()
    tmpi.constants.set("ps_prefetch", False)
    upd2 = tps.DownpourUpdate(**kw)
    run_steps(upd2, 4)
    assert not upd2.handles_prefetch
    upd2.free()


def test_mixed_ps_dataparallel_matches_jax():
    """Only DP roots integrate, then broadcast within their groups
    (update.lua:82-113)."""
    levels = []
    for m in (tmpi, jmpi):
        levels.append(m.push_communicator(lambda r: str(r // 2), name="dp"))
        m.set_communicator(0)
    kw = dict(send_frequency=1, update_frequency=1, init_delay=0, prefetch=0, sharding_level=0)
    upd = tps.DownpourUpdate(local_update=lambda t: t, dataparallel_level=levels[0], **kw)
    jupd = JDownpour(local_update=lambda t: t, dataparallel_level=levels[1], **kw)
    params, jparams = {"w": torch.zeros(P, 4)}, {"w": jnp.zeros((P, 4), jnp.float32)}
    for step in range(2):
        params = upd.update(step, params, {"w": torch.ones(P, 4)})
        jparams = jupd.update(step, jparams, {"w": jnp.ones((P, 4), jnp.float32)})
    np.testing.assert_array_equal(params["w"].numpy(), np.asarray(jparams["w"]))
    np.testing.assert_array_equal(params["w"].numpy(), 0)
    np.testing.assert_allclose(upd.ps.receive_full()["w"].numpy(), 2.0 * P)
    upd.free()
    jupd.free()


def test_group_broadcast_matches_jax():
    from torchmpi_tpu.collectives.eager import run_group_broadcast as jbcast
    from torchmpi_tpu_torch.collectives.eager import run_group_broadcast

    x = np.arange(P * 5, dtype=np.float32).reshape(P, 5)
    for keys in (lambda r: str(r // 4), lambda r: str(min(r, 2))):  # cartesian, ragged
        tmpi.push_communicator(keys, name="g")
        jmpi.push_communicator(keys, name="g")
        out = run_group_broadcast(_t(x), tmpi.current_communicator(), root=0)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jbcast(x, jmpi.current_communicator(), 0)))
        tmpi.set_communicator(0)
        jmpi.set_communicator(0)
    np.testing.assert_array_equal(out.numpy()[2:], np.broadcast_to(x[2], (P - 2, 5)))


# ---------------------------------------------------------------------------
# the example twin
# ---------------------------------------------------------------------------


def _jax_example(argv, monkeypatch):
    """``main`` of the JAX example, capturing every jitted local step's
    (params, grads, loss) and the final rank-stacked params (what the last
    schedule tick or DSGD re-application returned)."""
    import torchmpi_tpu.parameterserver as jps_pkg
    from examples import mnist_parameterserver as jexample

    steps, finals = [], []
    real_jit, real_shard_map = jax.jit, jax.shard_map

    def shard_map(f, **kw):
        mapped = real_shard_map(f, **kw)

        def local_step(*a):
            return mapped(*a)

        local_step.capture = True
        return local_step

    def jit(f, *a, **kw):
        compiled = real_jit(f, *a, **kw)
        if not getattr(f, "capture", False):
            return compiled

        def run(*args):
            out = compiled(*args)
            steps.append(out)
            return out

        return run

    class Downpour(JDownpour):
        def update(self, *a):
            finals.append(super().update(*a))
            return finals[-1]

    class EASGD(JEASGD):
        def update(self, *a):
            finals.append(super().update(*a))
            return finals[-1]

    real_sync = jps_pkg.synchronize_gradients_with_parameterserver
    lr = float(argv[argv.index("--lr") + 1]) if "--lr" in argv else 0.2

    def sync(grads, *a, **kw):
        synced, grp = real_sync(grads, *a, **kw)
        params, grads_loc, _ = steps[-1]
        finals.append(jax.tree_util.tree_map(lambda w, g, s: w + lr * g - lr * s,
                                             params, grads_loc, synced))
        return synced, grp

    monkeypatch.setattr(jax, "jit", jit)
    monkeypatch.setattr(jax, "shard_map", shard_map)
    monkeypatch.setattr(jps_pkg, "DownpourUpdate", Downpour)
    monkeypatch.setattr(jps_pkg, "EASGDUpdate", EASGD)
    monkeypatch.setattr(jps_pkg, "synchronize_gradients_with_parameterserver", sync)
    try:
        jexample.main(argv)
    finally:
        monkeypatch.undo()
    return steps, finals


EXAMPLE = ["--train", "1024", "--epochs", "1", "--batch", "32", "--lr", "0.02", "--tau", "5",
           "--init-delay", "10", "--seed", "0"]


@pytest.mark.parametrize("variant,wire", [("downpour", "full"), ("easgd", "full"),
                                          ("dsgd", "full"), ("downpour", "int8")])
def test_example_matches_jax(variant, wire, monkeypatch):
    from torchmpi_tpu.models import LogisticRegression as JLogReg
    from torchmpi_tpu.models import init_params as jinit
    from torchmpi_tpu_torch.examples import mnist_parameterserver as texample
    from torchmpi_tpu_torch.models import LogisticRegression, from_jax_params

    argv = EXAMPLE + ["--variant", variant, "--wire-dtype", wire]
    jax_params0 = jax.device_get(jinit(JLogReg(), (1, 28, 28), seed=0))
    jmpi.stop()  # the JAX main starts its own runtime
    jsteps, jfinals = _jax_example(argv, monkeypatch)
    port = texample.train(LogisticRegression(), texample.parse_args(argv),
                          params0=from_jax_params(jax_params0))

    assert port["steps"] == len(jsteps) == 1024 // 32
    jlosses = [float(jnp.mean(step[2])) for step in jsteps]
    loss_rtol, atol = (1e-4, 1e-5) if wire == "full" else (2e-3, 2e-3)
    np.testing.assert_allclose(port["step_losses"], jlosses, rtol=loss_rtol)
    assert port["losses"] == port["step_losses"][-1:]
    jfinal = {"dense0.weight": np.asarray(jfinals[-1]["Dense_0"]["kernel"]).transpose(0, 2, 1),
              "dense0.bias": np.asarray(jfinals[-1]["Dense_0"]["bias"])}
    jspread = max(float(np.abs(w - w[0]).max()) for w in jfinal.values())
    for k, w in jfinal.items():
        np.testing.assert_allclose(port["params"][k].numpy(), w, atol=atol, rtol=0)
    assert abs(port["spread"] - jspread) <= atol
    if variant != "dsgd":
        assert port["spread"] > 1e-3  # the replicas diverged between integrations


def test_example_main_runs_on_the_cpu(capsys):
    """The twin's CLI on the CPU, with the DP groups of --dataparallel:
    only their roots integrate, and each pair of replicas stays equal."""
    from torchmpi_tpu_torch.examples import mnist_parameterserver as texample

    tmpi.stop()  # main starts its own runtime
    res = texample.main(["--variant", "easgd", "--dataparallel", "--ranks", "4", "--device",
                         "cpu", "--train", "512", "--epochs", "1", "--batch", "32", "--tau",
                         "2", "--init-delay", "2"])
    out = capsys.readouterr().out
    assert "variant=easgd dp=True" in out and "replica_spread=" in out
    assert res["steps"] == 16 and not tmpi.started()
    for w in res["params"].values():
        assert torch.equal(w[0::2], w[1::2])
