"""The port's overlap scheduler (``torchmpi_tpu_torch.schedule.overlap``,
``GradientBuckets.sync_scheduled``) against the JAX package's, on the CPU.

Exact equality throughout (``tests/test_nn.py:180-215``): 'none' and
'reverse' bitwise equal on the full and the int8 wire, the unknown-schedule
error the JAX message, and the port's ``sync_scheduled`` equal to the JAX
one on the same closed-form integer payload (small integers sum exactly
in f32 in any order). The int8 wire needs the ring backend pinned, the
CPU's ``small_allreduce_size_cpu`` cutoff at 0 and
``wire_quant_min_elements`` lowered, or the call routes to the exact
vendor path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu.nn import GradientBuckets as JBuckets
from torchmpi_tpu_torch.nn import GradientBuckets
from torchmpi_tpu_torch.schedule import overlap
from torchmpi_tpu_torch.telemetry import flightrecorder as tflight

P = 4
SHAPES = {"a": (5, 7), "b": (33,), "c": (4, 4, 3), "d": (128,), "e": (2,)}


@pytest.fixture(autouse=True)
def _fresh_port():
    yield
    tflight.disable()
    tflight.recorder.reset()
    tmpi.runtime_state._reset_for_tests()
    tmpi.constants._reset_for_tests()


def _tree(p=P, seed=0, integer=True):
    rs = np.random.RandomState(seed)
    return {k: (rs.randint(-8, 9, (p,) + s) if integer else rs.randn(p, *s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("buckets", [1, 3])
@pytest.mark.parametrize("wire", ["full", "int8"])
def test_none_and_reverse_are_bitwise_equal(wire, buckets):
    tmpi.start(ranks=P, device="cpu")
    backend = None
    if wire == "int8":
        tmpi.constants.set("small_allreduce_size_cpu", 0)
        tmpi.constants.set("wire_quant_min_elements", 16)
        backend = "ring"
    tree = _torch(_tree(integer=False))
    bkts = GradientBuckets(tree, buckets)
    out = {s: bkts.sync_scheduled(tree, backend=backend, wire_dtype=wire, schedule=s)
           for s in ("none", "reverse")}
    for k in tree:
        assert torch.equal(out["none"][k].view(torch.int32), out["reverse"][k].view(torch.int32)), k
    total = {k: v.sum(0, keepdim=True).expand_as(v) for k, v in tree.items()}
    for k, v in out["reverse"].items():
        if wire == "full":
            torch.testing.assert_close(v, total[k], rtol=1e-5, atol=1e-5)
        else:  # the int8 wire's rounding, within a block's scale
            assert float((v - total[k]).abs().max()) < 0.1 * float(total[k].abs().max()) + 0.1


def test_unknown_schedule_error_matches_jax():
    tmpi.start(ranks=P, device="cpu")
    tree = _torch(_tree())
    with pytest.raises(ValueError, match="overlap_schedule") as ours:
        GradientBuckets(tree, 2).sync_scheduled(tree, schedule="forward")
    jmpi.start(devices=jax.devices()[:P])
    jtree = {k: jnp.asarray(v) for k, v in _tree().items()}
    with pytest.raises(ValueError) as ref:
        JBuckets(jtree, 2).sync_scheduled(jtree, schedule="forward")
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("schedule", ["none", "reverse", None])
@pytest.mark.parametrize("average", [False, True])
def test_sync_scheduled_equals_jax(schedule, average):
    """The same closed-form payload through both packages' scheduled
    syncs, on the default route (the constant's schedule for None)."""
    tree = _tree(seed=3)
    tmpi.start(ranks=P, device="cpu")
    jmpi.start(devices=jax.devices()[:P])
    if schedule is None:
        tmpi.constants.set("overlap_schedule", "reverse")
        jmpi.constants.set("overlap_schedule", "reverse")
    ours = GradientBuckets(_torch(tree), 3).sync_scheduled(
        _torch(tree), wire_dtype="full", average=average, schedule=schedule)
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    ref = JBuckets(jtree, 3).sync_scheduled(jtree, wire_dtype="full", average=average,
                                            schedule=schedule)
    for k in tree:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))
    assert GradientBuckets(_torch(tree), 3).buckets == JBuckets(jtree, 3).buckets


def test_resolve_schedule_reads_the_constant():
    assert overlap.resolve_schedule() == "none"
    tmpi.constants.set("overlap_schedule", "reverse")
    assert overlap.resolve_schedule() == "reverse"
    assert overlap.resolve_schedule("none") == "none"
    assert overlap.resolve_schedule("") == "none"
    assert overlap.schedule_base("reverse", "grads") == "overlap-reverse:grads"


@pytest.mark.parametrize("schedule", ["none", "reverse"])
def test_flight_entries_and_priorities(schedule):
    """One sub-entry per bucket on the ``chunks`` stream, stamped
    ``overlap-<schedule>:<tag>#<b>``, and each bucket's prioritized plan
    twin registered."""
    tmpi.start(ranks=P, device="cpu")
    tflight.enable()
    tree = _torch(_tree())
    bkts = GradientBuckets(tree, 3)
    bkts.sync_scheduled(tree, wire_dtype="full", schedule=schedule, tag="t")
    subs = [e for e in tflight.recorder.entries() if e["comm"] == "chunks"]
    nb = bkts.num_buckets
    assert nb > 1
    assert [e["plan"] for e in subs] == [f"overlap-{schedule}:t#{b}" for b in range(nb)]
    assert all(e["status"] == "completed" for e in subs)
    ids = overlap.register_priorities(bkts, tmpi.current_communicator(), None, "full")
    assert len(ids) == nb and all(ids) and len(set(ids)) == nb
