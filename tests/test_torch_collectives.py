"""The port's runtime and collective layers (``torchmpi_tpu_torch``)
against the JAX package, on the CPU.

Communicator splits must give the same groups, members and cartesian flag
as the JAX ``Communicator`` for the same keys (exact). The selector, the
size cutoffs and the dispatch rules are checked as values (exact).
Collective results on the CPU come from the plain versions: broadcasts are
exact; allreduces are compared with numpy's sum within rtol 1e-6 (another
order of adds), and the gradient sync is compared with the JAX package's
``nn.synchronize_gradients`` within the same tolerance.
"""

import jax
import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu import constants as jconstants
from torchmpi_tpu import nn as jnn
from torchmpi_tpu.runtime.communicator import Communicator as JComm
from torchmpi_tpu.runtime.communicator import split_by_keys as jsplit
from torchmpi_tpu_torch import constants, nn
from torchmpi_tpu_torch.collectives import CollectiveArgumentError, eager, selector
from torchmpi_tpu_torch.runtime import Communicator, split_by_keys


@pytest.fixture(autouse=True)
def _fresh_port():
    yield
    tmpi.runtime_state._reset_for_tests()
    constants._reset_for_tests()


def _same(tc, jc):
    assert tc.size == jc.size
    assert tc.cartesian == jc.cartesian
    assert tc.num_intra_groups == jc.num_intra_groups
    assert tc.groups == [list(g) for g in jc._groups]
    for r in range(tc.size):
        assert tc.member(r) == type(tc.member(r))(*vars(jc.member(r)).values())


KEYS = [
    ["a"] * 8,
    [str(r % 2) for r in range(8)],
    [str(r // 3) for r in range(8)],  # ragged: 3, 3, 2 -> tree
    ["z", "a", "z", "b", "a", "b", "z", "a"],
    [str(r) for r in range(8)],
]


@pytest.mark.parametrize("keys", KEYS)
@pytest.mark.parametrize("cartesian", [None, False])
def test_communicator_split_matches_jax(keys, cartesian):
    devices = jax.devices()[:8]
    tc = Communicator(range(8), "cpu", keys, cartesian=cartesian)
    jc = JComm(devices, keys, cartesian=cartesian)
    _same(tc, jc)
    # a nested split subdivides the parent's groups the same way
    sub = [str(r % 3) for r in range(8)]
    _same(split_by_keys(tc, sub), jsplit(jc, sub))
    _same(split_by_keys(tc, lambda r: str(r < 4)), jsplit(jc, lambda r: str(r < 4)))


def test_runtime_stack():
    with pytest.raises(tmpi.NotStartedError):
        tmpi.size()
    tmpi.start(ranks=4, device="cpu")
    with pytest.raises(RuntimeError, match="twice"):
        tmpi.start(ranks=4, device="cpu")
    assert tmpi.size() == 4 and tmpi.rank() == 0
    level = tmpi.push_communicator(lambda r: str(r % 2), name="pairs")
    assert level == 1 and tmpi.communicator_names() == ["global", "pairs"]
    assert tmpi.current_communicator().groups == [[0, 2], [1, 3]]
    assert "*[1] Communicator 'pairs'" in tmpi.describe()
    tmpi.set_communicator(0)
    assert tmpi.current_communicator().name == "global"
    tmpi.stop()
    assert not tmpi.started()


def test_cutoff_constants_carry_the_jax_values():
    for kind in ("small_allreduce_size", "small_broadcast_size"):
        for suffix in ("cpu", "tpu"):
            assert constants.get(f"{kind}_{suffix}") == jconstants.get(f"{kind}_{suffix}")
    assert constants.get("small_allreduce_size_cuda") == 1 << 16
    assert constants.get("small_broadcast_size_cuda") == 1 << 13
    assert constants.platform_suffix("cuda") == "cuda"
    assert constants.platform_suffix("cpu") == "cpu"
    assert constants.get("ring_implementation") == "kernel"
    constants.freeze_constants()
    with pytest.raises(constants.FrozenConstantsError):
        constants.set("wire_dtype", "int8")


def test_selector_cuda_row():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert selector.select("allreduce", cuda) == "kernel"
    assert selector.select("broadcast", cuda) == "kernel"
    # the ring backend is available, so reduce takes it, as on the JAX tpu row
    assert selector.select("reduce", cuda) == "ring"
    for op in ("allgather", "reducescatter", "alltoall", "sendreceive"):
        assert selector.select(op, cuda) == "xla"
    # async allreduce on the card is the same ring on a side stream, as the
    # reference's GPU async allreduce was its p2p ring
    assert selector.select("allreduce", cuda, mode="async") == "kernel"
    assert selector.select("broadcast", cuda, mode="async") == "xla"
    assert selector.select("allreduce", cpu, mode="async") == "xla"
    assert selector.select("allreduce", cuda, multinode=True) == "xla"
    assert selector.select("allreduce", cpu) == "xla"
    assert selector.select("broadcast", cpu) == "xla"


@pytest.mark.parametrize(
    "op,nelem,expect",
    [("allreduce", 1 << 16, "xla"), ("allreduce", (1 << 16) + 1, "kernel"),
     ("broadcast", 1 << 13, "xla"), ("broadcast", (1 << 13) + 1, "kernel"),
     ("allreduce", 7850, "xla"), ("allreduce", 857738, "kernel"),
     ("allgather", 1, "kernel")],
)
def test_op_route_cutoffs(op, nelem, expect):
    assert eager.op_route(op, nelem, "cuda", "kernel") == expect
    assert eager.op_route(op, nelem, "cpu", "kernel") == expect
    constants.set("small_allreduce_size_cuda", 0)
    constants.set("small_broadcast_size_cuda", 0)
    assert eager.op_route(op, nelem, "cuda", "kernel") == "kernel"


def test_ring_implementation_ppermute_raises(monkeypatch):
    """Where the selector picks a custom ring, the ring_implementation
    constant says which runs: 'ppermute' the ring backend, 'kernel' and
    'kernel_bidir' the kernels (``collectives/__init__.py:50-64``); an
    unknown name raises. The selector is pinned to its card choice, as the
    CPU has no kernels."""
    tmpi.start(ranks=4, device="cpu")
    seen = []
    real = eager.run
    monkeypatch.setattr(selector, "select", lambda *a, **k: "kernel")
    monkeypatch.setattr(eager, "run", lambda op, x, comm, backend, **kw: seen.append(backend)
                        or real(op, x, comm, backend=backend, **kw))
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 70000).astype(np.float32))
    for impl, backend in (("ppermute", "ring"), ("kernel", "kernel"), ("kernel_bidir", "kernel")):
        constants.set("ring_implementation", impl)
        out = tmpi.allreduce_tensor(x)
        assert seen[-1] == backend
        np.testing.assert_allclose(out.numpy(), np.broadcast_to(x.numpy().sum(0), x.shape),
                                   rtol=1e-5, atol=1e-5)
    constants.set("ring_implementation", "pallas")
    with pytest.raises(CollectiveArgumentError, match="ring_implementation"):
        tmpi.broadcast_tensor(x)


def test_eager_validation():
    tmpi.start(ranks=4, device="cpu")
    with pytest.raises(CollectiveArgumentError, match="leading axis"):
        tmpi.allreduce_tensor(torch.zeros(3, 10))
    with pytest.raises(CollectiveArgumentError, match="root"):
        tmpi.broadcast_tensor(torch.zeros(4, 10), root=4)
    with pytest.raises(CollectiveArgumentError, match="unknown backend"):
        tmpi.allreduce_tensor(torch.zeros(4, 10), backend="nccl")
    with pytest.raises(CollectiveArgumentError, match="unknown collective"):
        eager.run("gather", torch.zeros(4, 10), tmpi.current_communicator())
    with pytest.raises(CollectiveArgumentError, match="communicator on"):
        tmpi.allreduce_tensor(torch.zeros(4, 10, device="meta"))


@pytest.mark.parametrize("backend", [None, "xla", "kernel"])
def test_collectives_on_the_cpu(backend):
    tmpi.start(ranks=4, device="cpu")
    x = np.random.RandomState(0).randn(4, 3, 100).astype(np.float32)
    out = tmpi.allreduce_tensor(torch.from_numpy(x), backend=backend).numpy()
    np.testing.assert_allclose(out, np.broadcast_to(x.sum(0), x.shape), rtol=1e-6, atol=1e-6)
    b = tmpi.broadcast_tensor(torch.from_numpy(x), root=2, backend=backend).numpy()
    np.testing.assert_array_equal(b, np.broadcast_to(x[2], x.shape))
    assert out.shape == b.shape == x.shape


def _grads(p):
    rs = np.random.RandomState(5)
    return {
        "w": rs.randn(p, 300, 40).astype(np.float32),
        "b": rs.randn(p, 40).astype(np.float32),
        "steps": rs.randint(-9, 9, (p, 7)).astype(np.int32),
    }


@pytest.mark.parametrize("fusion_bytes", [4 << 20, 0, 2000])
def test_synchronize_gradients_matches_jax(fusion_bytes):
    """Fused (one flat buffer per dtype, flushed on capacity or wait) and
    unfused paths give the JAX package's result; ints exactly."""
    p = 4
    grads = _grads(p)
    jmpi.start(devices=jax.devices()[:p])
    ref = jax.device_get(jnn.synchronize_gradients(grads, average=True))
    tmpi.start(ranks=p, device="cpu")
    constants.set("fusion_buffer_bytes", fusion_bytes)
    constants.set("small_allreduce_size_cpu", 0)
    for fused in (True, False):
        out = nn.synchronize_gradients(
            {k: torch.from_numpy(v) for k, v in grads.items()}, average=True, fused=fused
        )
        for k in grads:
            assert out[k].shape == grads[k].shape and out[k].numpy().dtype == ref[k].dtype
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(out["steps"].numpy(), np.asarray(ref["steps"]))


def test_synchronize_parameters_and_replica_check():
    p = 4
    tmpi.start(ranks=p, device="cpu")
    params = {k: torch.from_numpy(v) for k, v in _grads(p).items()}
    with pytest.raises(AssertionError, match="desync"):
        nn.check_with_allreduce(params)
    synced = nn.synchronize_parameters(params, root=1)
    for k, v in synced.items():
        assert torch.equal(v, params[k][1:2].expand_as(v))
    nn.check_with_allreduce(synced)
    averaged = nn.synchronize_parameters({"w": params["w"]}, with_allreduce=True)
    np.testing.assert_allclose(
        averaged["w"].numpy(), np.broadcast_to(params["w"].numpy().mean(0), (p, 300, 40)),
        rtol=1e-5, atol=1e-6,
    )
