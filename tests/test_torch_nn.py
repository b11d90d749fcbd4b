"""The port's gradient buckets and async handles (``torchmpi_tpu_torch``)
against the JAX package, on the CPU.

- ``GradientBuckets``: the partition, the bucket dtypes, the pack order,
  the unflatten and the error-feedback encode must equal the JAX class's
  on the same dict of leaves (exact: the same integer arithmetic, the same
  concatenation, and an encode whose rounding is the JAX one's as XLA's
  CPU backend computes it, so bitwise).
- ``allreduce_async`` + ``wait_and_unflatten`` must give the blocking
  ``allreduce_tensor`` of the same packed buckets, bit for bit.
- ``SyncHandle``: wait, double wait, waits by table index, ``sync_all``,
  the ``num_async_collectives_in_flight`` bound and ``stop()``'s drain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmpi_tpu import constants as jconstants
from torchmpi_tpu import nn as jnn
from torchmpi_tpu.models import LeNet as JLeNet
from torchmpi_tpu.models import init_params as jinit
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import constants, nn, ops
from torchmpi_tpu_torch.models import LeNet, init_params
from torchmpi_tpu_torch.runtime.handles import SyncHandle, handles as thandles


@pytest.fixture(autouse=True)
def _fresh_port():
    yield
    tmpi.runtime_state._reset_for_tests()
    constants._reset_for_tests()
    ops.reset_launch_counts()


def _tree(p, seed=0):
    """A small mixed tree: names out of sorted order, a bf16 leaf that
    promotes its bucket, and leaves of very different sizes."""
    rs = np.random.RandomState(seed)
    return {
        "w2": rs.randn(p, 40, 30).astype(np.float32),
        "b1": rs.randn(p, 64).astype(np.float32),
        "w1": rs.randn(p, 700).astype(np.float32),
        "a0": rs.randn(p, 3, 5).astype(np.float32),
        "h": rs.randn(p, 90).astype(np.float32),
    }


def _template(tree):
    return {k: v[0] for k, v in tree.items()}


def test_lenet_partition_is_the_jax_one():
    """LeNet at 4 buckets: bucket 0 = dense1.weight, dense1.bias,
    dense0.weight (805,386), bucket 1 = the rest (52,352)."""
    ours = nn.GradientBuckets(init_params(LeNet()), 4)
    jp = jinit(JLeNet(), (1, 28, 28), seed=0)
    ref = jnn.GradientBuckets(jp, 4)
    assert ours.buckets == ref.buckets and ours.num_buckets == ref.num_buckets == 2
    assert [ours.names[i] for i in ours.buckets[0]] == ["dense1.weight", "dense1.bias", "dense0.weight"]
    assert [sum(ours.sizes[i] for i in b) for b in ours.buckets] == [805386, 52352]
    assert nn.GradientBuckets(init_params(LeNet()), 1).buckets == [list(range(7, -1, -1))]


@pytest.mark.parametrize("num_buckets", [1, 2, 3, 4, 9])
def test_partition_pack_and_unflatten_match_jax(num_buckets):
    p = 3
    tree = _tree(p)
    tree["h"] = tree["h"].astype(jnp.bfloat16)
    ours = nn.GradientBuckets(
        {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16 if k == "h" else torch.float32)[0]
         for k, v in tree.items()}, num_buckets)
    ref = jnn.GradientBuckets(_template(tree), num_buckets)
    assert ours.buckets == ref.buckets and ours.num_buckets == ref.num_buckets
    ttree = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.bfloat16 if k == "h" else torch.float32) for k, v in tree.items()}
    leaves = jax.tree_util.tree_leaves(tree)
    results, jresults = [], []
    for b in range(ours.num_buckets):
        assert str(ours.bucket_dtype(b)).split(".")[-1] == str(ref.bucket_dtype(b))
        packed = ours.pack(ttree, b, p)
        _, jpacked = ref._packed_bucket(b, leaves, p)
        np.testing.assert_array_equal(packed.float().numpy(), np.asarray(jpacked, np.float32))
        results.append(packed * 2)
        jresults.append(jpacked * 2)
    out = ours.unflatten_results(ttree, results, average=True, p=p)
    jout = ref.unflatten_results(tree, jresults, average=True, p=p)
    assert list(out) == list(ttree)
    for k in tree:
        assert out[k].shape == ttree[k].shape
        np.testing.assert_array_equal(out[k].float().numpy(), np.asarray(jout[k], np.float32))


@pytest.mark.parametrize("wire", ["int8", "bf16"])
def test_error_feedback_matches_jax(wire):
    """Two flushes: the second adds back the first's residual."""
    p = 2
    for c in (constants, jconstants):
        c.set("wire_quant_min_elements", 1)
    tree = _tree(p)
    ours = nn.GradientBuckets({k: torch.from_numpy(v[0]) for k, v in tree.items()}, 2)
    ref = jnn.GradientBuckets(_template(tree), 2)
    for step in range(2):
        grads = _tree(p, seed=step + 1)
        ttree = {k: torch.from_numpy(v) for k, v in grads.items()}
        leaves = jax.tree_util.tree_leaves(grads)
        for b in range(ours.num_buckets):
            buf = ours.pack(ttree, b, p)
            qv = ours._error_feedback(b, buf, wire)
            _, jbuf = ref._packed_bucket(b, leaves, p)
            jqv = ref._error_feedback(b, jbuf, wire)
            np.testing.assert_array_equal(qv.numpy().view(np.int32), np.asarray(jqv).view(np.int32))
            key = next(k for k in ours._residuals if k[0] == b)
            jkey = next(k for k in ref._residuals if k[0] == b)
            np.testing.assert_array_equal(ours._residuals[key].numpy(), np.asarray(ref._residuals[jkey]))
            assert not torch.equal(qv, buf)
    # below the cutoff it ships the bucket unchanged
    constants.set("wire_quant_min_elements", 1 << 20)
    assert ours._error_feedback(0, buf, wire) is buf


@pytest.mark.parametrize("wire", ["full", "int8", "bf16"])
@pytest.mark.parametrize("error_feedback", [False, True])
def test_async_buckets_equal_blocking_allreduce(wire, error_feedback):
    p = 3
    tmpi.start(ranks=p, device="cpu")
    constants.set("small_allreduce_size_cpu", 0)
    constants.set("wire_quant_min_elements", 1000)  # bucket 0 engages, bucket 1 not
    constants.set("wire_error_feedback", error_feedback)
    grads = {k: torch.from_numpy(v) for k, v in _tree(p).items()}
    buckets = nn.GradientBuckets({k: v[0] for k, v in grads.items()}, 2)
    assert [sum(buckets.sizes[i] for i in b) for b in buckets.buckets] == [1200, 869]
    hs = buckets.allreduce_async(grads, backend="kernel", wire_dtype=wire)
    assert len(hs) == 2 and all(isinstance(h, SyncHandle) for h in hs)
    out = buckets.wait_and_unflatten(grads, hs, average=True)
    expect = []
    for b in range(2):
        buf = buckets.pack(grads, b, p)
        if error_feedback:
            buf = nn.GradientBuckets({k: v[0] for k, v in grads.items()}, 2)._error_feedback(b, buf, wire)
        expect.append(tmpi.allreduce_tensor(buf, backend="kernel", wire_dtype=wire))
    ref = buckets.unflatten_results(grads, expect, average=True, p=p)
    for k in grads:
        assert torch.equal(out[k], ref[k])
    exact = nn.synchronize_gradients(grads, average=True)
    worst = max(float((out[k] - exact[k]).abs().max() / exact[k].abs().max()) for k in grads)
    assert worst <= (1e-6 if wire == "full" else 2e-2)
    assert thandles.outstanding == 0


def test_synchronize_gradients_wire():
    p = 2
    tmpi.start(ranks=p, device="cpu")
    constants.set("small_allreduce_size_cpu", 0)
    constants.set("wire_quant_min_elements", 1)
    grads = {k: torch.from_numpy(v) for k, v in _tree(p).items()}
    for fused in (True, False):
        exact = nn.synchronize_gradients(grads, fused=fused)
        wired = nn.synchronize_gradients(grads, fused=fused, wire_dtype="int8")
        # the selector's cpu row is the vendor path, which ships verbatim
        for k in grads:
            assert torch.equal(wired[k], exact[k])


def test_sync_handles():
    p = 2
    tmpi.start(ranks=p, device="cpu")
    x = torch.arange(2 * 300, dtype=torch.float32).reshape(p, 300)
    h = tmpi.collectives.async_.allreduce_tensor(x)
    assert thandles.outstanding == 1 and h.done
    out = h.wait()
    assert torch.equal(out, x.sum(0, keepdim=True).expand_as(x))
    assert h.wait() is out and thandles.outstanding == 0  # a double wait is a no-op
    idx = thandles.register(SyncHandle(out), kind="collective")
    assert tmpi.collectives.wait(idx) is out and tmpi.collectives.wait(idx) is None
    assert tmpi.collectives.wait(None) is None
    with pytest.raises(TypeError):
        tmpi.collectives.wait("handle")
    # the in-flight bound waits the oldest before launching more
    constants.set("num_async_collectives_in_flight", 2)
    hs = [tmpi.collectives.async_.allreduce_tensor(x) for _ in range(5)]
    assert thandles.outstanding == 2 and thandles.outstanding_kind("collective") == 2
    tmpi.collectives.sync_all()
    assert thandles.outstanding == 0 and all(h.wait() is not None for h in hs)
    tmpi.collectives.async_.allreduce_tensor(x)
    assert thandles.outstanding == 1
    tmpi.stop()  # drains the table
    assert thandles.outstanding == 0
    assert "waited" in repr(hs[0])
