"""The port's collective surface, its routing and the collectives tester
against the JAX package, on the CPU.

Every op runs through the port's per-backend namespaces (``xla``, ``ring``,
``kernel``; sync and ``async_``) and through the JAX ``eager.run`` on the
same seeded numpy input (its ``pallas`` backend in Pallas interpret mode,
``ring_kernels._FORCE_INTERPRET``), with the size cutoffs off in both
packages so small payloads reach the custom rings. The port's kernel
wrappers run their plain versions here.

Tolerance: the ``ring`` and ``kernel`` backends keep the JAX rings' chunk
layouts and order of adds, so their results must be bitwise equal; the
``xla`` backend sums in another order than XLA's ``psum``, so f32 sums
agree within rtol 1e-6, and ints and every data mover exactly. The
selector's choices, the tester's sizes and volumes and the routing
decisions are checked as values (exact).
"""

import jax
import numpy as np
import pytest
import torch

import torchmpi_tpu as jmpi
import torchmpi_tpu_torch as tmpi
from torchmpi_tpu import constants as jconstants
from torchmpi_tpu.collectives import eager as jeager
from torchmpi_tpu.collectives import selector as jselector
from torchmpi_tpu.ops import ring_kernels as jring
from torchmpi_tpu.utils import tester as jtester
from torchmpi_tpu_torch import constants, ops
from torchmpi_tpu_torch.collectives import eager, primitives, selector
from torchmpi_tpu_torch.ops import ring_kernels as tring
from torchmpi_tpu_torch.utils import tester

OPS = ["broadcast", "reduce", "allreduce", "sendreceive", "allgather", "reducescatter",
       "alltoall"]
P_RANKS = 4


@pytest.fixture(autouse=True)
def _fresh_port():
    yield
    tmpi.runtime_state._reset_for_tests()
    constants._reset_for_tests()
    ops.reset_launch_counts()


def _no_cutoffs():
    for pkg in (constants, jconstants):
        pkg.set("small_allreduce_size_cpu", 0)
        pkg.set("small_broadcast_size_cpu", 0)


def _input(op: str, p: int, dtype) -> np.ndarray:
    shape = {"reducescatter": (p, 3, 8 * p), "alltoall": (p, p, 5)}.get(op, (p, 3, 50))
    x = np.random.RandomState(OPS.index(op)).randn(*shape)
    return (x * 1000).astype(np.int32) if dtype == "int32" else x.astype(np.float32)


def _port_call(op: str, x: torch.Tensor, backend: str, mode: str, p: int):
    ns = getattr(tmpi.collectives.async_ if mode == "async" else tmpi.collectives, backend)
    if op in ("broadcast", "reduce"):
        r = getattr(ns, f"{op}_tensor")(x, root=1)
    elif op == "sendreceive":
        r = ns.sendreceive_tensor(x, src=0, dst=p - 1)
    else:
        r = getattr(ns, f"{op}_tensor")(x)
    return r.wait() if mode == "async" else r


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("backend", ["xla", "ring", "kernel"])
@pytest.mark.parametrize("op", OPS)
def test_surface_matches_jax_eager(op, backend, dtype, monkeypatch):
    p = P_RANKS
    monkeypatch.setattr(jring, "_FORCE_INTERPRET", True)
    _no_cutoffs()
    x = _input(op, p, dtype)
    jmpi.start(devices=jax.devices()[:p])
    jbackend = "pallas" if backend == "kernel" else backend
    ref = np.asarray(jeager.run(op, x, jmpi.current_communicator(), backend=jbackend,
                                root=1, src=0, dst=p - 1))
    tmpi.start(ranks=p, device="cpu")
    for mode in ("sync", "async"):
        out = _port_call(op, torch.from_numpy(x), backend, mode, p).numpy()
        assert out.shape == ref.shape and out.dtype == ref.dtype, mode
        if backend == "xla" and dtype == "float32" and op in ("allreduce", "reduce",
                                                            "reducescatter"):
            np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    assert not any(ops.launch_counts().values())  # plain versions on the CPU


def test_allgather_of_scalars_and_errors():
    p = P_RANKS
    tmpi.start(ranks=p, device="cpu")
    v = torch.arange(p, dtype=torch.float32)
    for backend in ("xla", "ring", "kernel"):
        out = tmpi.allgather_tensor(v, backend=backend)
        assert torch.equal(out, v.expand(p, p))
    with pytest.raises(tmpi.collectives.CollectiveArgumentError, match="divisible"):
        tmpi.reducescatter_tensor(torch.zeros(p, 3, 6))
    with pytest.raises(tmpi.collectives.CollectiveArgumentError, match="alltoall"):
        tmpi.alltoall_tensor(torch.zeros(p, 3))
    with pytest.raises(tmpi.collectives.CollectiveArgumentError, match="out of range"):
        tmpi.sendreceive_tensor(torch.zeros(p, 3), src=0, dst=p)
    with pytest.raises(tmpi.collectives.CollectiveArgumentError, match="root"):
        tmpi.reduce_tensor(torch.zeros(p, 3), root=-1)
    tmpi.collectives.free_collective_resources(tmpi.current_communicator())


def test_kernel_bidir_selects_the_bidirectional_ring():
    """ring_implementation='kernel_bidir' runs the kernel backend's
    allreduce on the bidirectional ring (not under a wire, which pins the
    quantized ring), as 'pallas_bidir' does in the JAX flat lowering."""
    p = 4
    tmpi.start(ranks=p, device="cpu")
    _no_cutoffs()
    constants.set("wire_quant_min_elements", 1)
    x = torch.from_numpy(np.random.RandomState(0).randn(p, 9001).astype(np.float32))
    uni = tmpi.allreduce_tensor(x, backend="kernel")
    assert torch.equal(uni, ops.ring_allreduce(x))
    constants.set("ring_implementation", "kernel_bidir")
    bidir = tmpi.allreduce_tensor(x, backend="kernel")
    assert torch.equal(bidir, ops.ring_allreduce_bidir(x)) and not torch.equal(bidir, uni)
    assert torch.equal(tmpi.allreduce_tensor(x, backend="kernel", wire_dtype="int8"),
                       ops.ring_allreduce_quant(x, "int8"))
    # a compressed wire on the ring backend rides the ppermute ring's codec
    assert torch.equal(tmpi.allreduce_tensor(x, backend="ring", wire_dtype="bf16"),
                       primitives.ring_allreduce(x, wire_dtype="bf16"))


@pytest.mark.parametrize("extra,k7_calls", [(0, 0), (4, 1)])
def test_kernel_broadcast_routes_tree_then_k7(extra, k7_calls, monkeypatch):
    """At most broadcast_size_tree_based bytes per rank the kernel backend
    broadcasts through the binomial tree, above it through the ring
    broadcast kernel (K7), as the JAX flat lowering routes its pallas
    broadcast. On the CPU the K7 wrapper runs its plain version and counts
    no launch, so the test counts calls of the wrapper."""
    p, nbytes = 2, (1 << 22) + extra
    calls = []
    real = tring.ring_broadcast
    monkeypatch.setattr(tring, "ring_broadcast",
                        lambda x, root=0: calls.append(root) or real(x, root))
    tmpi.start(ranks=p, device="cpu")
    x = torch.from_numpy(np.random.RandomState(1).randn(p, nbytes // 4).astype(np.float32))
    assert eager.broadcast_plan(nbytes // 4, torch.float32, "cpu")[0] == (extra == 0)
    out = tmpi.broadcast_tensor(x, root=1, backend="kernel")
    assert len(calls) == k7_calls
    assert torch.equal(out, x[1:2].expand_as(x))
    assert torch.equal(out, tmpi.broadcast_tensor(x, root=1, backend="ring"))


@pytest.mark.parametrize("nelem,dtype", [(100, torch.float32), (1 << 20, torch.float32),
                                         ((1 << 20) + 1, torch.float32),
                                         (3 << 21, torch.bfloat16), (10**7, torch.int8)])
def test_ring_tuning_and_broadcast_plan_match_jax(nelem, dtype):
    for platform in ("cpu", "tpu"):
        jdtype = {torch.float32: np.float32, torch.bfloat16: np.float16,
                  torch.int8: np.int8}[dtype]
        assert eager.ring_tuning(platform) == jeager.ring_tuning(platform)
        assert eager.broadcast_plan(nelem, dtype, platform) == jeager.broadcast_plan(
            nelem, jdtype, platform)
    assert eager.ring_tuning("cuda") == eager.ring_tuning("cpu")


def test_selector_matches_the_jax_table(monkeypatch):
    """Each (op, mode) choice on a CUDA communicator is the JAX tpu row's
    with 'pallas' named 'kernel', and on the CPU the JAX cpu row's. One
    choice differs on purpose: async allreduce on the card prefers the
    kernel ring on a side stream (the reference's GPU async allreduce was
    its p2p ring), where the JAX tpu row's async entries are in-graph
    psums."""
    monkeypatch.setattr(jring, "_FORCE_INTERPRET", True)
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    for op in OPS:
        for mode in ("sync", "async"):
            want = jselector.select(op, "tpu", mode=mode).replace("pallas", "kernel")
            if (op, mode) == ("allreduce", "async"):
                want = "kernel"
            assert selector.select(op, cuda, mode=mode) == want, (op, mode)
            assert selector.select(op, cpu, mode=mode) == jselector.select(
                op, "cpu", mode=mode), (op, mode)
            assert selector.select(op, cuda, multinode=True, mode=mode) == "xla"
    assert tmpi.collectives.backend_availability(cpu) == {"xla": True, "ring": True,
                                                          "kernel": False}


@pytest.mark.parametrize("min_pow,max_pow,seed", [(8, 23, 0), (12, 20, 0), (8, 10, None),
                                                  (3, 9, 7)])
def test_sweep_sizes_and_bus_bytes_match_jax(min_pow, max_pow, seed):
    assert tester.sweep_sizes(min_pow, max_pow, seed) == jtester.sweep_sizes(
        min_pow, max_pow, seed)
    for op in OPS:
        for p in (2, 8):
            assert tester.bus_bytes(op, 4096, p) == jtester.bus_bytes(op, 4096, p)
    with pytest.raises(ValueError):
        tester.bus_bytes("gather", 4, 2)


def test_tester_checks_every_op_on_the_cpu():
    tmpi.start(ranks=3, device="cpu")
    comm = tmpi.current_communicator()
    results = tester.run_matrix(comm, ops=OPS, backends=("xla", "ring", "kernel"),
                                modes=("sync", "async"), sizes=[300], benchmark=True)
    assert len(results) == len(OPS) * 3 * 2
    assert all(r.correct for r in results)
    for r in results:
        assert r.mean_us > 0 and r.bus_gbps > 0
        assert (r.launch_us > 0) == (r.mode == "async")
    pinned = tester.run_one_config("allreduce", 300, comm, "kernel", route_override=False)
    assert pinned.correct and pinned.backend == "kernel"
    ps = tester.run_ps_throughput(comm, nelem=1000, warmup=1, timed=2)
    assert ps["nbytes"] == 4000 and ps["send_mbps"] > 0 and ps["recv_mbps"] > 0


def test_bench_example_exits_zero():
    from torchmpi_tpu_torch.examples import bench_collectives

    assert bench_collectives.main(["--ranks", "4", "--device", "cpu", "--max-pow", "10"]) == 0
    assert bench_collectives.main(["--ranks", "2", "--device", "cpu", "--min-pow", "8",
                                   "--max-pow", "9", "--ops", "reducescatter,alltoall",
                                   "--backends", "kernel", "--modes", "async"]) == 0
    assert bench_collectives.main(["--ps", "--ranks", "4", "--device", "cpu",
                                   "--min-pow", "8", "--max-pow", "9", "--ops", "allreduce",
                                   "--backends", "xla"]) == 0


@pytest.mark.parametrize("cartesian", [False, True])
def test_failed_start_restores_the_cartesian_constant(cartesian):
    """A ``start()`` whose ``custom_communicator_init`` raises leaves
    ``use_cartesian_communicator`` as it was, as the reference's rollback
    does (``torchmpi_tpu/runtime_state.py`` ``start``), and a retry starts."""
    constants.set("use_cartesian_communicator", not cartesian)

    def boom():
        raise RuntimeError("init failed")

    with pytest.raises(RuntimeError, match="init failed"):
        tmpi.start(ranks=2, device="cpu", with_cartesian_communicator=cartesian,
                   custom_communicator_init=boom)
    assert not tmpi.started()
    assert constants.get("use_cartesian_communicator") is (not cartesian)
    tmpi.start(ranks=2, device="cpu", with_cartesian_communicator=cartesian)
    assert tmpi.started() and tmpi.size() == 2
    assert constants.get("use_cartesian_communicator") is cartesian


# the reference's top-level names the port re-exports; the reference's
# ``pallas`` backend is the port's ``kernel``
REEXPORTS = ["async_", "xla", "ring", "kernel", "wait", "sync_all", "SyncHandle",
             "split_by_keys", "engine", "parallel", "utils"]


@pytest.mark.parametrize("name", REEXPORTS)
def test_reference_names_are_exported(name):
    assert hasattr(jmpi, "pallas" if name == "kernel" else name)
    assert hasattr(tmpi, name) and name in tmpi.__all__
    assert getattr(tmpi, name) is not None


@pytest.mark.parametrize("backend", [None, "xla", "ring", "kernel"])
def test_async_allreduce_then_wait_matches_jax(backend, monkeypatch):
    """The reference's own usage, ``h = mpi.async_.allreduce_tensor(x)``
    then ``mpi.wait(h)``, on the CPU virtual ranks, against the JAX
    package's result for the same numpy input (its ``pallas`` backend in
    Pallas interpret mode; f32 sums in another order on the ``xla`` and
    selector paths: rtol 1e-6)."""
    p = P_RANKS
    monkeypatch.setattr(jring, "_FORCE_INTERPRET", True)
    _no_cutoffs()
    x = np.random.RandomState(11).randn(p, 3, 50).astype(np.float32)
    jmpi.start(devices=jax.devices()[:p])
    jns = jmpi.async_ if backend is None else getattr(
        jmpi.async_, "pallas" if backend == "kernel" else backend)
    ref = np.asarray(jmpi.wait(jns.allreduce_tensor(x)))
    tmpi.start(ranks=p, device="cpu")
    ns = tmpi.async_ if backend is None else getattr(tmpi.async_, backend)
    h = ns.allreduce_tensor(torch.from_numpy(x))
    assert isinstance(h, tmpi.SyncHandle)
    out = tmpi.wait(h).numpy()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    tmpi.sync_all()
