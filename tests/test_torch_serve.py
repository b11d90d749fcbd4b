"""The port's serving tier (``torchmpi_tpu_torch.serve``) against the JAX
package's (``torchmpi_tpu.serve``), on the CPU: the in-process cases of
``test_serve.py`` run through both, on the same seeded inputs.

- The brownout ladder and the QoS floor over a grid: equal.
- ``WeightCache`` swaps, ``version_vector`` over the same sends to both
  parameter servers (p=8), ``refresh_once``'s swaps and read policy, and
  ``handle``'s statuses, counters and values: equal. The model functions
  are the same arithmetic in numpy and in torch; the replies are float32
  of sums and products of a few exact values, equal bit for bit.
- The client's round trips, retry-after sleeps (one seeded
  ``random.Random`` each) and ``ShedError``: equal.
- A snapshot is storage the parameter server never writes again: after a
  ``send`` the snapshot taken before it is unchanged, as in JAX. A fetch
  racing sends assembles one whole version (the port posts a send's and a
  fetch's messages to every shard under one lock), and a server under
  training answers each request from one published version.
"""

import random
import threading

import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu import constants as jconstants
from torchmpi_tpu import serve as jserve
from torchmpi_tpu.parameterserver import ParameterServer as JPS
from torchmpi_tpu.parameterserver import free_all as jfree_all
from torchmpi_tpu_torch import constants as tconstants
from torchmpi_tpu_torch import serve as tserve
from torchmpi_tpu_torch.parameterserver import ParameterServer as TPS
from torchmpi_tpu_torch.parameterserver import free_all as tfree_all

P = 8


@pytest.fixture(autouse=True)
def _runtimes():
    jmpi.start()
    tmpi.start(ranks=P, device="cpu")
    try:
        yield
    finally:
        tfree_all()
        jfree_all()
        tmpi.runtime_state._reset_for_tests()
        tmpi.constants._reset_for_tests()


def _both(name, value):
    jconstants.set(name, value)
    tconstants.set(name, value)


def test_public_names_match_jax():
    assert tserve.__all__ == jserve.__all__


@pytest.mark.parametrize("budget", [0, 1, 4, 256])
def test_brownout_ladder_matches_jax(budget):
    for pending in list(range(0, 20)) + [255, 256, 511, 512, 513, 10_000]:
        assert tserve.brownout_level(pending, budget) == jserve.brownout_level(pending, budget)
    for level in range(4):
        for qos_levels in range(1, 5):
            assert (tserve.shed_qos_floor(level, qos_levels)
                    == jserve.shed_qos_floor(level, qos_levels))


def test_weight_cache_swaps_like_jax():
    t = [100.0]
    caches = (jserve.WeightCache(np.zeros(4, np.float32), (0, 0), clock=lambda: t[0]),
              tserve.WeightCache(torch.zeros(4), (0, 0), clock=lambda: t[0]))
    steps = [(np.ones(4, np.float32), (0, 0), 100.0), (np.ones(4, np.float32), (1, 0), 105.0),
             (np.full(4, 3, np.float32), (1, 0), 106.0), (np.full(4, 2, np.float32), (2, 1), 107.5)]
    for w, vec, now in steps:
        t[0] = now
        got = [c.swap(w, vec) if i == 0 else c.swap(torch.from_numpy(w), vec)
               for i, c in enumerate(caches)]
        assert got[0] == got[1]
        jw, jv = caches[0].get()
        tw, tv = caches[1].get()
        np.testing.assert_array_equal(tw.numpy(), jw)
        assert tv == jv and caches[1].swaps == caches[0].swaps
    t[0] = 110.0
    assert caches[1].age_s() == caches[0].age_s() == pytest.approx(2.5)


def _pair_ps(n=P, seed=0):
    init = np.random.RandomState(seed).randn(n).astype(np.float32)
    return JPS(init), TPS(torch.from_numpy(init.copy()))


def test_version_vector_and_refresh_match_jax():
    """The same sends to both parameter servers: equal vectors after each,
    a server seeded from the live vector, refresh_once swapping exactly
    when the vector moved, and equal snapshots."""
    jps, tps = _pair_ps()
    assert tserve.version_vector(tps) == jserve.version_vector(jps)
    one = np.ones(P, np.float32)
    jps.send(one, rule="add").wait()
    tps.send(torch.from_numpy(one), rule="add").wait()
    v1 = tserve.version_vector(tps)
    assert v1 == jserve.version_vector(jps) and v1 != (0,) * P
    jsrv = jserve.InferenceServer(lambda w, x: x, jps)
    tsrv = tserve.InferenceServer(lambda w, x: x, tps)
    assert tsrv.cache.versions == jsrv.cache.versions == v1
    for sends in (1, 0, 2, 0):
        for _ in range(sends):
            jps.send(one, rule="add", client=1).wait()
            tps.send(torch.from_numpy(one), rule="add", client=1).wait()
        assert tsrv.refresh_once() == jsrv.refresh_once() == (sends > 0)
        assert tsrv.cache.swaps == jsrv.cache.swaps
        assert tsrv.cache.versions == jsrv.cache.versions == tserve.version_vector(tps)
        np.testing.assert_array_equal(tsrv.cache.get()[0].numpy(), jsrv.cache.get()[0])
    assert tsrv.cache.swaps == 2


def test_refresh_rides_the_read_policy_like_jax():
    """refresh_once passes serve_refresh_read_policy ('replica' by default,
    '' inherits ps_read_policy as None) to receive, on both sides; the
    port's receive and prefetch take the parameter and, every shard local,
    return the same tensor under any policy."""
    assert tconstants.get("serve_refresh_read_policy") == "replica"
    seen = {}
    for name, ps in zip(("jax", "torch"), _pair_ps(seed=1)):
        seen[name] = []
        orig = ps.receive

        def receive(client=0, read_policy=None, orig=orig, log=seen[name]):
            log.append(read_policy)
            return orig(client, read_policy=read_policy)

        ps.receive = receive
        mod = jserve if name == "jax" else tserve
        srv = mod.InferenceServer(lambda w, x: x, ps)
        for policy in ("replica", "owner", ""):
            (jconstants if name == "jax" else tconstants).set(
                "serve_refresh_read_policy", policy)
            v = np.full(P, 0.5, np.float32)
            ps.send(v if name == "jax" else torch.from_numpy(v), rule="add").wait()
            assert srv.refresh_once()
    assert seen["torch"][1:] == seen["jax"][1:] == ["replica", "owner", None]
    _, tps = _pair_ps(seed=2)
    want = tps.receive().wait()
    for policy in (None, "owner", "replica", "adaptive"):
        assert torch.equal(tps.receive(read_policy=policy).wait(), want)
        assert torch.equal(tps.prefetch(read_policy=policy).wait(), want)
        tps.receive().wait()  # consume the prefetched fetch


def test_snapshot_survives_later_sends():
    """The torn-snapshot check: the port's PS applies its rules in place
    on its shards, yet the snapshot a server took before a send is
    unchanged after it (the fetch assembled copies), as the JAX package's
    numpy snapshot is."""
    jps, tps = _pair_ps(seed=3)
    jsrv = jserve.InferenceServer(lambda w, x: x, jps)
    tsrv = tserve.InferenceServer(lambda w, x: x, tps)
    jw0, tw0 = jsrv.cache.get()[0].copy(), tsrv.cache.get()[0].clone()
    np.testing.assert_array_equal(tw0.numpy(), jw0)
    for _ in range(3):
        g = np.random.RandomState(4).randn(P).astype(np.float32)
        jps.send(g, rule="add", scale=-0.5).wait()
        tps.send(torch.from_numpy(g), rule="add", scale=-0.5).wait()
    assert torch.equal(tsrv.cache.get()[0], tw0)
    np.testing.assert_array_equal(jsrv.cache.get()[0], jw0)
    assert not torch.equal(tps.receive().wait(), tw0)


def _jax_fn(w, x):
    return x.reshape(-1, 4) @ w.reshape(4, 3) + np.float32(w.sum())


def _torch_fn(w, x):
    return x.reshape(-1, 4) @ w.reshape(4, 3) + w.sum()


def test_handle_statuses_and_values_match_jax():
    """handle on both sides: the reply's status and values, the shed
    ladder at pending 4 and 8 under a budget of 4, and the counters."""
    _both("serve_queue_budget", 4)
    w = np.arange(12, dtype=np.float32) / 4
    jsrv = jserve.InferenceServer(_jax_fn, weights=w)
    tsrv = tserve.InferenceServer(_torch_fn, weights=torch.from_numpy(w.copy()))
    x = (np.arange(8, dtype=np.float32) - 3).tobytes()
    retry = int(tconstants.get("serve_shed_retry_ms"))
    for qos, pending, want in ((0, 0, "ok"), (0, 4, f"shed:{retry}"), (1, 4, "ok"),
                               (1, 8, f"shed:{retry}"), (2, 8, "ok"), (2, 0, "ok")):
        (js, jy), (ts, ty) = (s.handle("infer", qos, x, pending=pending)
                              for s in (jsrv, tsrv))
        assert ts == js == want
        if want == "ok":
            assert isinstance(ty, np.ndarray) and ty.dtype == np.float32
            np.testing.assert_array_equal(ty, jy)
        else:
            assert ty is None and jy is None
    for attr in ("served", "shed", "level", "slo_breaches"):
        assert getattr(tsrv, attr) == getattr(jsrv, attr)
    assert (tsrv.served, tsrv.shed, tsrv.level) == (4, 2, 0)


def test_server_requires_weights_or_ps():
    for mod in (jserve, tserve):
        with pytest.raises(ValueError, match="needs weights or a ps"):
            mod.InferenceServer(lambda w, x: x)


class _FakeServeTransport:
    def __init__(self, replies):
        self.replies = list(replies)
        self.calls = 0

    def serve_request(self, proc, rule, payload, qos=0):
        self.calls += 1
        return self.replies.pop(0) if self.replies else ("shed:10", None)


@pytest.mark.parametrize("max_sheds", [0, 2, 5])
def test_client_retries_and_shed_error_match_jax(max_sheds):
    """A shed then an ok: one jittered sleep inside +-50% of the hint, the
    same on both sides; an endless shed: max_sheds + 1 round trips, then
    ShedError with the same message and fields."""
    out = {}
    for name, mod in (("jax", jserve), ("torch", tserve)):
        sleeps = []
        tr = _FakeServeTransport([("shed:40", None), ("ok", np.array([7.0], np.float32))])
        got = mod.ServeClient(tr, 0, sleep=sleeps.append, rng=random.Random(7)).infer(
            np.array([1.0], np.float32))
        tr2 = _FakeServeTransport([])
        sleeps2 = []
        with pytest.raises(mod.ShedError) as ei:
            mod.ServeClient(tr2, 0, sleep=sleeps2.append, rng=random.Random(7)).infer(
                np.array([1.0], np.float32), max_sheds=max_sheds)
        out[name] = (got.tolist(), sleeps, tr2.calls, sleeps2, str(ei.value),
                     ei.value.sheds, ei.value.retry_ms)
    assert out["torch"] == out["jax"]
    assert len(out["torch"][1]) == 1 and 0.02 <= out["torch"][1][0] <= 0.06
    assert out["torch"][2] == max_sheds + 1


def test_fetches_racing_sends_assemble_one_version():
    """A sender adds ones (a version k tensor is k everywhere) while a
    fetcher reads: every fetch is uniform, never shards of two versions."""
    tps = TPS(torch.zeros(P * 3 + 5))
    one = torch.ones(P * 3 + 5)
    done = threading.Event()
    fetched = []

    def fetch():
        while not done.is_set():
            fetched.append(tps.receive(client=1).wait())

    t = threading.Thread(target=fetch)
    t.start()
    try:
        for _ in range(60):
            tps.send(one, rule="add").wait()
    finally:
        done.set()
        t.join()
    assert fetched
    for f in fetched:
        assert bool((f == f[0]).all()), f"torn fetch {f.unique().tolist()}"
    assert torch.equal(tps.receive().wait(), one * 60)


def test_serving_under_training_answers_from_published_versions():
    """The card's serving phase at a small size: a trainer thread publishes
    scaled 'add' sends while request threads call handle and the
    refresher swaps; every ok reply is the model's output on one published
    version, and after a last refresh the replies are those of
    ps.receive(). The versions are computed on the host by the plain
    scaled-accumulate (one rounding, as the PS applies it)."""
    from torchmpi_tpu_torch.ops import scale_accumulate

    _both("serve_refresh_interval_s", 0.002)
    rng = np.random.RandomState(5)
    n, lr = 12, 0.125
    w0 = rng.randn(n).astype(np.float32)
    tps = TPS(torch.from_numpy(w0.copy()))
    versions = [torch.from_numpy(w0.copy())]
    grads = [torch.from_numpy(rng.randn(n).astype(np.float32)) for _ in range(12)]
    for g in grads:
        versions.append(scale_accumulate(versions[-1], g, lr))
    xs = [rng.randn(8).astype(np.float32) for _ in range(3)]
    want = [[_torch_fn(v, torch.from_numpy(x)).numpy() for v in versions] for x in xs]
    srv = tserve.InferenceServer(_torch_fn, tps).start()
    replies = []

    def requests(seed):
        r = random.Random(seed)
        for _ in range(40):
            i = r.randrange(len(xs))
            status, y = srv.handle("infer", r.randrange(3), xs[i].tobytes(), pending=0)
            replies.append((status, i, y))

    threads = [threading.Thread(target=requests, args=(s,)) for s in range(3)]
    for t in threads:
        t.start()
    for g in grads:
        tps.send(g, rule="add", scale=lr).wait()
    for t in threads:
        t.join()
    srv.stop()
    assert torch.equal(tps.receive().wait(), versions[-1])
    assert len(replies) == 120 and all(s == "ok" for s, _, _ in replies)
    for _, i, y in replies:
        assert any(np.array_equal(y, v) for v in want[i]), "reply from no published version"
    srv.refresh_once()
    for i, x in enumerate(xs):
        assert np.array_equal(srv.handle("infer", 2, x.tobytes(), pending=0)[1], want[i][-1])
    assert srv.cache.swaps >= 1
