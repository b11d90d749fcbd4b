"""The port's two-level collectives against the JAX package's, on the CPU.

Each case of ``tests/test_hierarchical.py`` (and the hierarchical rows of
``tests/test_pipeline.py``'s depth matrix) runs in both packages on the
same 8 ranks and the same two-level communicator, and the results are
held to each other:

- bit for bit on the ``ring`` backend (the port's batched rings keep the
  chunk layout and order of adds of one JAX ring per group), and on the
  ``kernel`` backend against the JAX ``pallas`` backend run in Pallas
  interpret mode (``ring_kernels._FORCE_INTERPRET``): the port's intra
  phase runs a kernel's plain version on the CPU, over every group at
  once (K3, K3 'ag', K7) or once per group (K4, K5, K6);
- exactly on integer payloads;
- within rtol 1e-6 on ``xla`` (the JAX ``psum`` of ``psum`` against a sum
  within each group, then across groups).

Communicators: ``str(r % 2)`` (two groups of four, not contiguous ranks,
as the JAX tests' key) and ``f"host{r // 2}"`` (four contiguous groups of
two), plus a ragged one for the tree. The intra phase's kernel wrappers
of ``ops.ring_kernels`` are spied on: one call per intra phase for K3,
K3 'ag' and K7, one per group for K4, K5 and K6 (the CPU path runs the
plain versions, which count no launch; the launch counts themselves are
checked on the card by ``chip_smoke.py --hier``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu import constants as jconstants
from torchmpi_tpu.collectives import eager as jeager
from torchmpi_tpu.ops import ring_kernels as jrk
from torchmpi_tpu_torch import constants, ops
from torchmpi_tpu_torch.collectives import CollectiveArgumentError, eager
from torchmpi_tpu_torch.ops import ring_kernels as rk

P = 8
KEYS = {"2x4": lambda r: str(r % 2), "4x2": lambda r: f"host{r // 2}"}
RAGGED = {"1+7": lambda r: "a" if r == 0 else "b", "3+2+3": lambda r: "abc"[r * 3 // P]}
XLA_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _fresh_port():
    yield
    tmpi.runtime_state._reset_for_tests()
    constants._reset_for_tests()
    ops.reset_launch_counts()
    jrk._FORCE_INTERPRET = False


def _both(name, value):
    constants.set(name, value)
    jconstants.set(name, value)


def _comms(keys):
    jmpi.start(devices=jax.devices()[:P])
    tmpi.start(ranks=P, device="cpu")
    jmpi.push_communicator(keys, name="h2l")
    tmpi.push_communicator(keys, name="h2l")
    return tmpi.current_communicator(), jmpi.current_communicator()


def _rand(shape, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.randint(-1000, 1000, shape).astype(dtype) + (1 << 24)
    return rng.randn(*shape).astype(dtype)


def _same(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def _spy(monkeypatch, *names):
    """Count the calls of ``ops.ring_kernels`` wrappers (patched before the
    communicator's first call: a bound plan holds the function)."""
    calls = {name: 0 for name in names}
    for name in names:
        real = getattr(rk, name)

        def wrapped(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(rk, name, wrapped)
    return calls


# --- tests/test_hierarchical.py, case by case ---------------------------------
@pytest.mark.parametrize("keys", list(KEYS))
@pytest.mark.parametrize("root", [0, 3])
def test_hierarchical_broadcast_as_jax(keys, root):
    tcomm, jcomm = _comms(KEYS[keys])
    x = _rand((P, 300), root)
    got = eager.run_hierarchical_collective("broadcast", torch.from_numpy(x), tcomm, root=root)
    _same(got, jeager.run_hierarchical_collective("broadcast", jnp.asarray(x), jcomm, root=root))
    assert np.array_equal(got.numpy(), np.tile(x[root], (P, 1)))


@pytest.mark.parametrize("keys", list(KEYS))
@pytest.mark.parametrize("root", [0, 2])
def test_hierarchical_reduce_as_jax(keys, root):
    tcomm, jcomm = _comms(KEYS[keys])
    x = _rand((P, 257), root + 10)
    got = eager.run_hierarchical_collective("reduce", torch.from_numpy(x), tcomm, root=root)
    _same(got, jeager.run_hierarchical_collective("reduce", jnp.asarray(x), jcomm, root=root))


@pytest.mark.parametrize("keys", list(KEYS))
def test_hierarchical_allgather_as_jax(keys):
    tcomm, jcomm = _comms(KEYS[keys])
    x = _rand((P, 5, 40), 7)
    got = eager.run_hierarchical_collective("allgather", torch.from_numpy(x), tcomm)
    _same(got, jeager.run_hierarchical_collective("allgather", jnp.asarray(x), jcomm))
    assert np.array_equal(got.numpy()[3], np.concatenate(list(x), axis=-1))


@pytest.mark.parametrize("keys", list(KEYS))
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_hierarchical_allreduce_ring_as_jax(keys, dtype):
    tcomm, jcomm = _comms(KEYS[keys])
    x = _rand((P, 3, 1000), 4, dtype)
    got = eager.run_hierarchical_allreduce(torch.from_numpy(x), tcomm, impl="ring")
    _same(got, jeager.run_hierarchical_allreduce(jnp.asarray(x), jcomm, impl="ring"))


@pytest.mark.parametrize("keys", list(KEYS))
def test_hierarchical_allreduce_xla_within_tolerance(keys):
    tcomm, jcomm = _comms(KEYS[keys])
    x = _rand((P, 4000), 5)
    got = eager.run_hierarchical_allreduce(torch.from_numpy(x), tcomm, impl="xla").numpy()
    want = np.asarray(jeager.run_hierarchical_allreduce(jnp.asarray(x), jcomm, impl="xla"))
    np.testing.assert_allclose(got, want, rtol=XLA_RTOL, atol=XLA_RTOL * np.abs(x).sum(0).max())
    ints = _rand((P, 4000), 6, np.int32)
    _same(eager.run_hierarchical_allreduce(torch.from_numpy(ints), tcomm, impl="xla"),
          jeager.run_hierarchical_allreduce(jnp.asarray(ints), jcomm, impl="xla"))


def test_hierarchical_collective_routed_from_dispatch():
    """Above the cutoffs the ring backend routes broadcast and allgather
    through the hierarchical plans on a cartesian two-level communicator,
    as in JAX."""
    tcomm, jcomm = _comms(KEYS["2x4"])
    _both("small_broadcast_size_cpu", 1)
    x = np.tile(np.arange(P, dtype=np.float32)[:, None], (1, 600))
    got = tmpi.ring.broadcast_tensor(torch.from_numpy(x), root=1, comm=tcomm)
    _same(got, jmpi.ring.broadcast_tensor(jnp.asarray(x), root=1, comm=jcomm))
    got = tmpi.ring.allgather_tensor(torch.from_numpy(x[:, :8]), comm=tcomm)
    _same(got, jmpi.ring.allgather_tensor(jnp.asarray(x[:, :8]), comm=jcomm))
    labels = {ent[1].op_label for ent in tcomm._dispatch_memo.values()}
    assert {"hier_broadcast", "hier_allgather"} <= labels


@pytest.mark.parametrize("keys", list(RAGGED))
def test_tree_hierarchical_allreduce_ragged(keys):
    tcomm, jcomm = _comms(RAGGED[keys])
    assert not tcomm.cartesian and tcomm.has_inter_collective
    x = np.tile(np.arange(P, dtype=np.int32)[:, None], (1, 123))
    got = eager.run_tree_hierarchical_allreduce(torch.from_numpy(x), tcomm)
    _same(got, jeager.run_tree_hierarchical_allreduce(jnp.asarray(x), jcomm))
    assert np.array_equal(got.numpy(), np.full((P, 123), P * (P - 1) // 2))
    f = _rand((P, 700), 8)
    _same(eager.run_tree_hierarchical_allreduce(torch.from_numpy(f), tcomm),
          jeager.run_tree_hierarchical_allreduce(jnp.asarray(f), jcomm))


@pytest.mark.parametrize("keys", list(RAGGED))
def test_tree_hierarchical_routed_from_dispatch(keys):
    """Allreduce and broadcast on a ragged communicator take the tree
    plans through the dispatch, as in JAX."""
    tcomm, jcomm = _comms(RAGGED[keys])
    _both("small_allreduce_size_cpu", 1)
    _both("small_broadcast_size_cpu", 1)
    x = _rand((P, 700), 9)
    _same(tmpi.ring.allreduce_tensor(torch.from_numpy(x), comm=tcomm),
          jmpi.ring.allreduce_tensor(jnp.asarray(x), comm=jcomm))
    for root in (0, 5):
        _same(tmpi.ring.broadcast_tensor(torch.from_numpy(x), root=root, comm=tcomm),
              jmpi.ring.broadcast_tensor(jnp.asarray(x), root=root, comm=jcomm))
    labels = {ent[1].op_label for ent in tcomm._dispatch_memo.values()}
    assert {"tree_hier_allreduce", "tree_broadcast"} <= labels


def test_hierarchical_collective_rejects_flat_comm():
    tmpi.start(ranks=P, device="cpu")
    jmpi.start(devices=jax.devices()[:P])
    x = np.zeros((P, 8), np.float32)
    for run, arr, stack in ((eager.run_hierarchical_collective, torch.from_numpy(x), tmpi.stack()),
                            (jeager.run_hierarchical_collective, jnp.asarray(x), jmpi.stack())):
        with pytest.raises(Exception) as err:
            run("broadcast", arr, stack.at(0))
        assert "cartesian communicator" in str(err.value)
    with pytest.raises(CollectiveArgumentError):
        eager.run_hierarchical_allreduce(torch.from_numpy(x), tmpi.stack().at(0))
    with pytest.raises(CollectiveArgumentError):
        eager.run_tree_hierarchical_allreduce(torch.from_numpy(x), tmpi.stack().at(0))
    tmpi.push_communicator(KEYS["2x4"], name="h")
    with pytest.raises(CollectiveArgumentError, match="broadcast/reduce/allgather"):
        eager.run_hierarchical_collective("alltoall", torch.from_numpy(x),
                                          tmpi.current_communicator())


@pytest.mark.parametrize("keys", list(KEYS))
def test_hierarchical_reduce_int_exact(keys):
    tcomm, jcomm = _comms(KEYS[keys])
    x = np.tile(np.arange(P, dtype=np.int32)[:, None], (1, 99)) + (1 << 24)
    for impl in ("ring", "kernel"):
        got = eager.run_hierarchical_collective("reduce", torch.from_numpy(x), tcomm, root=1,
                                                ring_impl=impl)
        expect = x.copy()
        expect[1] = x.astype(np.int64).sum(axis=0).astype(np.int32)
        assert np.array_equal(got.numpy(), expect)
    _same(got, jeager.run_hierarchical_collective("reduce", jnp.asarray(x), jcomm, root=1))


# --- the kernel backend's intra phase ---------------------------------------
@pytest.mark.parametrize("keys", list(KEYS))
def test_hierarchical_kernel_intra_phase(keys, monkeypatch):
    """``impl='kernel'`` runs the intra phase of every composition through
    the ring kernels' wrappers, K3 and K3 'ag' one call over every group
    and K6 one a group, bitwise equal to the JAX ``pallas`` compositions in
    interpret mode."""
    calls = _spy(monkeypatch, "ring_allreduce", "ring_reduce", "ring_allgather")
    tcomm, jcomm = _comms(KEYS[keys])
    G = tcomm.num_intra_groups
    jrk._FORCE_INTERPRET = True
    x = _rand((P, 300), 3)
    got = eager.run_hierarchical_allreduce(torch.from_numpy(x), tcomm, impl="kernel")
    _same(got, jeager.run_hierarchical_allreduce(jnp.asarray(x), jcomm, impl="pallas"))
    got = eager.run_hierarchical_collective("reduce", torch.from_numpy(x), tcomm, root=2,
                                            ring_impl="kernel")
    _same(got, jeager.run_hierarchical_collective("reduce", jnp.asarray(x), jcomm, root=2,
                                                  ring_impl="pallas"))
    got = eager.run_hierarchical_collective("allgather", torch.from_numpy(x[:, :16]), tcomm,
                                            ring_impl="kernel")
    _same(got, jeager.run_hierarchical_collective("allgather", jnp.asarray(x[:, :16]), jcomm,
                                                  ring_impl="pallas"))
    assert calls == {"ring_allreduce": 1, "ring_reduce": G, "ring_allgather": 1}


@pytest.mark.parametrize("keys", list(KEYS))
def test_hierarchical_kernel_broadcast_intra_phase(keys, monkeypatch):
    """The intra broadcast runs K7's wrapper once over every group, above
    and below the tree cutoff (as JAX's pallas intra phase runs K7 on
    every group)."""
    calls = _spy(monkeypatch, "ring_broadcast")
    tcomm, jcomm = _comms(KEYS[keys])
    jrk._FORCE_INTERPRET = True
    for cutoff in (64, 1 << 30):
        _both("broadcast_size_tree_based_cpu", cutoff)
        x = _rand((P, 3000), 5)
        got = eager.run_hierarchical_collective("broadcast", torch.from_numpy(x), tcomm, root=1,
                                                ring_impl="kernel")
        _same(got, jeager.run_hierarchical_collective("broadcast", jnp.asarray(x), jcomm,
                                                      root=1, ring_impl="pallas"))
    assert calls == {"ring_broadcast": 2}


def test_hierarchical_kernel_routed_from_dispatch(monkeypatch):
    """The kernel backend's allreduce on a cartesian two-level
    communicator takes the hierarchical plan with the kernel intra phase
    (``hier-kernel``), as JAX's takes ``hier-pallas``."""
    calls = _spy(monkeypatch, "ring_allreduce")
    tcomm, jcomm = _comms(KEYS["2x4"])
    _both("small_allreduce_size_cpu", 1)
    jrk._FORCE_INTERPRET = True
    x = np.tile(np.arange(P, dtype=np.float32)[:, None], (1, 700))
    got = eager.run("allreduce", torch.from_numpy(x), tcomm, backend="kernel")
    _same(got, jeager.run("allreduce", jnp.asarray(x), jcomm, backend="pallas"))
    assert np.array_equal(got.numpy(), np.full((P, 700), P * (P - 1) / 2, np.float32))
    ep = next(ent[1] for ent in tcomm._dispatch_memo.values())
    assert (ep.op_label, ep.backend_label, ep.routing) == ("hier_allreduce", "kernel", "hier")
    assert calls["ring_allreduce"] == 1


@pytest.mark.parametrize("keys", list(KEYS))
def test_hierarchical_kernel_bidir_intra_phase(keys, monkeypatch):
    """``ring_implementation='kernel_bidir'`` puts the intra allreduce on
    K5's wrapper (which runs K3 for groups of two, as JAX's delegates),
    bitwise equal to JAX's ``pallas_bidir``."""
    calls = _spy(monkeypatch, "ring_allreduce_bidir")
    tcomm, jcomm = _comms(KEYS[keys])
    constants.set("ring_implementation", "kernel_bidir")
    jconstants.set("ring_implementation", "pallas_bidir")
    jrk._FORCE_INTERPRET = True
    x = _rand((P, 300), 9)
    got = eager.run_hierarchical_allreduce(torch.from_numpy(x), tcomm, impl="kernel")
    _same(got, jeager.run_hierarchical_allreduce(jnp.asarray(x), jcomm, impl="pallas"))
    assert calls == {"ring_allreduce_bidir": tcomm.num_intra_groups}


def _jax_levels(x, groups, intra, inter):
    """The JAX composition of ``lower_hier_allreduce`` level by level: the
    per-device ``intra`` function over each group's devices, then
    ``inter`` over each set of same-intra-rank devices, each under
    ``shard_map`` on a one-axis mesh (``shard_map`` over the two-axis
    mesh runs the same rings; its interpret-mode quantized kernel does not
    finish on the CPU)."""
    from jax.sharding import Mesh, PartitionSpec

    def run(fn, rows):
        mesh = Mesh(np.array(jax.devices()[:len(rows)]), ("mpi",))
        shm = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=PartitionSpec("mpi"),
                                    out_specs=PartitionSpec("mpi"), check_vma=False))
        return np.asarray(shm(jnp.asarray(x[rows])))

    x = np.array(x)
    for g in groups:
        x[g] = run(intra, g)
    for i in range(len(groups[0])):
        col = [g[i] for g in groups]
        x[col] = run(inter, col)
    return x


@pytest.mark.parametrize("wire", ["int8", "bf16"])
def test_hierarchical_kernel_wire_intra_phase(wire, monkeypatch):
    """A compressed wire puts the intra allreduce on K4's wrapper once a
    group and encodes the inter ring's hops too, bitwise equal to the
    JAX ``pallas`` composition's levels with the same wire: the
    interpret-mode quantized kernel within each group, then the JAX
    ``ppermute`` ring across the groups (:func:`_jax_levels`)."""
    from torchmpi_tpu.collectives import primitives as jprim

    calls = _spy(monkeypatch, "ring_allreduce_quant", "ring_allreduce")
    tcomm, jcomm = _comms(KEYS["4x2"])
    _both("wire_quant_min_elements", 1)
    x = _rand((P, 40), 11)
    got = eager.run_hierarchical_allreduce(torch.from_numpy(x), tcomm, impl="kernel", wire=wire)
    minb, maxb, nbuf = jeager.ring_tuning("cpu")
    want = _jax_levels(
        x, jcomm._groups,
        lambda b: jrk.ring_allreduce_pallas(b, "mpi", interpret=True, wire_dtype=wire),
        lambda b: jprim.ring_allreduce(b, "mpi", max_bytes_per_step=maxb,
                                       min_bytes_per_step=minb, num_buffers=nbuf,
                                       wire_dtype=wire))
    _same(got, want)
    assert calls == {"ring_allreduce_quant": tcomm.num_intra_groups, "ring_allreduce": 0}
    # an integer payload ships verbatim: K3 over every group, exact
    ints = _rand((P, 40), 12, np.int32)
    got = eager.run_hierarchical_allreduce(torch.from_numpy(ints), tcomm, impl="kernel",
                                           wire=wire)
    assert np.array_equal(got.numpy(), np.tile(ints.astype(np.int64).sum(0), (P, 1)))
    assert calls["ring_allreduce"] == 1


@pytest.mark.parametrize("keys", list(KEYS))
def test_staged_hierarchical_kernel_intra_phase(keys, monkeypatch):
    """The staged plan keeps the kernel intra ring (one K3 call over every
    group) and sums the group totals on the host in group order, bitwise
    equal to JAX's staged composition."""
    calls = _spy(monkeypatch, "ring_allreduce")
    tcomm, jcomm = _comms(KEYS[keys])
    jrk._FORCE_INTERPRET = True
    x = _rand((P, 300), 13)
    got = eager.run_hierarchical_allreduce(torch.from_numpy(x), tcomm, impl="staged",
                                           staged_intra="kernel")
    _same(got, jeager.run_hierarchical_allreduce(jnp.asarray(x), jcomm, impl="staged",
                                                 staged_intra="pallas"))
    assert calls == {"ring_allreduce": 1}


def test_staged_kernel_intra_via_run_dispatch(monkeypatch):
    """``use_staged_collectives`` with the kernel backend requested routes
    the staged plan and keeps the kernel intra ring, as in JAX."""
    calls = _spy(monkeypatch, "ring_allreduce")
    tcomm, jcomm = _comms(KEYS["2x4"])
    _both("use_staged_collectives", True)
    _both("small_allreduce_size_cpu", 1)
    jrk._FORCE_INTERPRET = True
    x = _rand((P, 300), 14)
    got = tmpi.kernel.allreduce_tensor(torch.from_numpy(x), comm=tcomm)
    _same(got, jmpi.pallas.allreduce_tensor(jnp.asarray(x), comm=jcomm))
    ep = next(ent[1] for ent in tcomm._dispatch_memo.values())
    assert (ep.op_label, ep.routing) == ("staged_allreduce", "staged")
    assert calls == {"ring_allreduce": 1}


# --- tests/test_pipeline.py's depth matrix, hierarchical rows -----------------
@pytest.mark.parametrize("wire", ["full", "bf16", "int8"])
@pytest.mark.parametrize("routing", ["hier", "staged", "tree"])
def test_pipelined_hierarchical_as_jax(routing, wire):
    """Depth 4 against depth 1 and against JAX at both depths, bitwise,
    for the ring compositions under every wire."""
    keys = RAGGED["1+7"] if routing == "tree" else KEYS["2x4"]
    tcomm, jcomm = _comms(keys)
    x = _rand((P, 2048 + 3), 15)
    outs = []
    for depth in (1, 4):
        for name, value in (("wire_quant_min_elements", 1), ("wire_dtype", wire),
                            ("small_allreduce_size_cpu", 1),
                            ("plan_pipeline_min_chunk_bytes", 64),
                            ("plan_pipeline_depth", depth)):
            _both(name, value)
        if routing == "tree":
            got = eager.run_tree_hierarchical_allreduce(torch.from_numpy(x), tcomm, wire=wire)
            want = jeager.run_tree_hierarchical_allreduce(jnp.asarray(x), jcomm, wire=wire)
        else:
            kw = dict(impl="ring") if routing == "hier" else dict(impl="staged",
                                                                  staged_intra="ring")
            got = eager.run_hierarchical_allreduce(torch.from_numpy(x), tcomm, wire=wire, **kw)
            want = jeager.run_hierarchical_allreduce(jnp.asarray(x), jcomm, wire=wire, **kw)
        _same(got, want)
        outs.append(got)
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
    from torchmpi_tpu_torch.schedule import compiler as sched

    ep = sched.compile_collective("allreduce", x.shape, torch.float32, tcomm,
                                  generator=routing, impl="ring", wire_override=wire)
    assert ep.plan.pipeline == 4 and "@p4" in ep.plan_id


def test_async_buckets_take_the_hierarchical_plan():
    """``GradientBuckets.allreduce_async`` on a two-level communicator
    runs each bucket through the hierarchical plan, its results equal to
    the JAX package's on integer payloads."""
    from torchmpi_tpu.nn import GradientBuckets as JBuckets
    from torchmpi_tpu_torch.nn import GradientBuckets

    tcomm, jcomm = _comms(KEYS["4x2"])
    _both("small_allreduce_size_cpu", 1)
    grads = {f"w{i}": _rand((P, 64 * (i + 1)), 20 + i, np.int32) for i in range(4)}
    tb = GradientBuckets({k: torch.from_numpy(v[0]) for k, v in grads.items()}, 2)
    jb = JBuckets({k: jnp.asarray(v[0]) for k, v in grads.items()}, 2)
    th = tb.allreduce_async({k: torch.from_numpy(v) for k, v in grads.items()}, comm=tcomm,
                            backend="ring")
    jh = jb.allreduce_async({k: jnp.asarray(v) for k, v in grads.items()}, comm=jcomm,
                            backend="ring")
    got = tb.wait_and_unflatten({k: torch.from_numpy(v) for k, v in grads.items()}, th)
    want = jb.wait_and_unflatten({k: jnp.asarray(v) for k, v in grads.items()}, jh)
    for k in grads:
        _same(got[k], want[k])
    assert {ent[1].plan.generator for ent in tcomm._dispatch_memo.values()} == {"hier"}


def test_fused_flush_delegates_to_the_hierarchical_plan():
    """A coalesced allreduce (``run_fused``, a ``FusionBuffer`` flush) on a
    two-level communicator packs the slabs, then runs the hierarchical
    plan through ``run``, as the JAX compiler delegates: the same plan
    and the same result as JAX's, bit for bit."""
    tcomm, jcomm = _comms(KEYS["2x4"])
    _both("small_allreduce_size_cpu", 1)
    flats = [_rand((P, n), 30 + n) for n in (64, 640, 1344)]
    got = eager.run_fused("allreduce", [torch.from_numpy(f) for f in flats], tcomm,
                          backend="ring")
    _same(got, jeager.run_fused("allreduce", [jnp.asarray(f) for f in flats], jcomm,
                                backend="ring"))
    plans = {ent[1].plan.generator for ent in tcomm._dispatch_memo.values()}
    assert plans == {"hier"}


def test_staged_across_processes_is_refused():
    """The staged allreduce across processes runs whether the intra groups
    lie in one process or span them (``tests/test_torch_multiprocess.py``,
    ``tests/test_torch_xproc_groups.py``), over the control plane that
    meets the processes. A communicator that claims two processes in a job
    started without a coordinator has none, and is refused, naming what
    it needs. Here process 0 of 2 holds ranks 0-3, and the 2x4 split's
    groups (``r % 2``) each span both processes."""
    from torchmpi_tpu_torch.runtime.communicator import Communicator

    tcomm = Communicator(range(P), torch.device("cpu"), keys=[KEYS["2x4"](r) for r in range(P)],
                         processes=[r // (P // 2) for r in range(P)], process_index=0)
    assert tcomm.multiprocess and tcomm.cartesian and tcomm.num_nodes() == 2
    with pytest.raises(CollectiveArgumentError, match="started with a coordinator"):
        eager.run_hierarchical_allreduce(torch.ones(P // 2, 16), tcomm, impl="staged")
