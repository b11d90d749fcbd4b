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
    with 'pallas' named 'kernel', and on the CPU the JAX cpu row's. Four
    choices differ on purpose: async allreduce on the card prefers the
    kernel ring on a side stream (the reference's GPU async allreduce was
    its p2p ring), where the JAX tpu row's async entries are in-graph
    psums; sync allgather and reducescatter prefer the kernel rings,
    which carry the engine's sharded modes (on one node the reference's
    collectives were its own ring), where the JAX tpu row names XLA's; and
    async reducescatter prefers its kernel ring too (the FusionBuffer's
    unfused remainder of a sharded step dispatches async)."""
    monkeypatch.setattr(jring, "_FORCE_INTERPRET", True)
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    for op in OPS:
        for mode in ("sync", "async"):
            want = jselector.select(op, "tpu", mode=mode).replace("pallas", "kernel")
            if (op, mode) in (("allreduce", "async"), ("allgather", "sync"),
                              ("reducescatter", "sync"), ("reducescatter", "async")):
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


def test_in_flight_limit_blocks_and_the_registry_drains():
    """The async issue path's bookkeeping: the per-kind count that the
    backpressure check reads follows every registration and every way a
    handle is waited; once ``num_async_collectives_in_flight`` handles are
    out, a new issue waits the oldest first; ``sync_all()`` and ``stop()``
    drain the table."""
    from torchmpi_tpu_torch.runtime.handles import SyncHandle, handles

    p = 2
    tmpi.start(ranks=p, device="cpu")
    constants.set("num_async_collectives_in_flight", 3)
    x = torch.arange(2 * 16, dtype=torch.float32).reshape(p, 16)
    issued = []
    for i in range(7):
        issued.append(tmpi.async_.allreduce_tensor(x))
        assert handles.outstanding_kind("collective") == min(i + 1, 3)
        # the ones beyond the limit were waited oldest first
        assert [h._done for h in issued] == [j < i + 1 - 3 for j in range(i + 1)]
    other = SyncHandle(x)
    idx = handles.register(other, kind="ps")
    assert handles.outstanding == 4 and handles.outstanding_kind("ps") == 1
    issued[-1].wait()  # a handle's own wait leaves the count
    assert handles.outstanding_kind("collective") == 2
    assert tmpi.wait(idx) is x and handles.outstanding_kind("ps") == 0
    assert handles.wait_oldest("collective") and handles.outstanding_kind("collective") == 1
    tmpi.sync_all()
    assert handles.outstanding == 0 and handles.outstanding_kind("collective") == 0
    assert all(h._done for h in issued)
    assert not handles.wait_oldest("collective")
    tmpi.async_.allreduce_tensor(x)
    assert handles.outstanding_kind("collective") == 1
    tmpi.stop()
    assert handles.outstanding == 0 and handles.outstanding_kind("collective") == 0


# the top-level names of the reference's ``__all__`` that the port's surface
# adds on top of REEXPORTS; ``telemetry`` waits for its port and ``pallas``
# is the port's ``kernel``
A1_NAMES = ["barrier", "allgatherv_tensor", "broadcast_scalar", "allreduce_scalar",
            "reduce_scalar", "sendreceive_scalar", "collective_availability",
            "collective_selector", "free_collective_resources", "num_processes",
            "set_collective_span", "num_nodes_in_communicator", "__version__"]


@pytest.mark.parametrize("name", A1_NAMES)
def test_runtime_and_scalar_names_are_exported(name):
    assert name in jmpi.__all__
    assert hasattr(tmpi, name) and name in tmpi.__all__


# the observability surface: the schedule's calibration entry points, the
# autotuner, and the telemetry modules beyond the core
OBSERVE_NAMES = [("schedule", "calibrate"), ("schedule", "load_calibration"),
                 ("utils", "autotune"), ("telemetry", "analyze"), ("telemetry", "calibrate"),
                 ("telemetry", "criticalpath"), ("telemetry", "live"), ("telemetry", "top"),
                 ("telemetry", "watchdog")]


@pytest.mark.parametrize("pkg,name", OBSERVE_NAMES)
def test_observability_names_are_exported(pkg, name):
    import importlib

    jmod = importlib.import_module(f"torchmpi_tpu.{pkg}")
    tmod = importlib.import_module(f"torchmpi_tpu_torch.{pkg}")
    if pkg in ("telemetry", "utils"):
        # a module of the package in both, with the same public functions
        # (``top`` is imported by its CLI, the JAX ``autotune`` by start())
        jsub = importlib.import_module(f"torchmpi_tpu.{pkg}.{name}")
        tsub = importlib.import_module(f"torchmpi_tpu_torch.{pkg}.{name}")
        assert {n for n in vars(jsub) if not n.startswith("_") and callable(vars(jsub)[n])
                and getattr(vars(jsub)[n], "__module__", "") == jsub.__name__} == \
            {n for n in vars(tsub) if not n.startswith("_") and callable(vars(tsub)[n])
             and getattr(vars(tsub)[n], "__module__", "") == tsub.__name__}
        if pkg == "utils":
            assert tmod.autotune is tsub and name in tmod.__all__
        return
    assert hasattr(jmod, name) and hasattr(tmod, name)
    assert name in jmod.__all__ and name in tmod.__all__


@pytest.mark.parametrize("pkg", ["data", "serve", "analysis"])
def test_input_serving_and_lint_packages_match_jax(pkg):
    """The streaming input pipeline, the serving tier and tpu-lint: the
    same public names as the JAX sub-packages; ``mpi.data`` is an
    attribute of the package, as in JAX."""
    import importlib

    jmod = importlib.import_module(f"torchmpi_tpu.{pkg}")
    tmod = importlib.import_module(f"torchmpi_tpu_torch.{pkg}")
    public = lambda m: sorted(getattr(m, "__all__", None)  # noqa: E731
                              or [n for n in vars(m) if not n.startswith("_")
                                  and not isinstance(vars(m)[n], type(m))
                                  and n not in ("annotations",)])
    assert public(tmod) == public(jmod)
    assert hasattr(jmpi, "data") and tmpi.data is importlib.import_module("torchmpi_tpu_torch.data")


def test_every_reference_name_is_exported():
    missing = {n for n in jmpi.__all__ if n not in tmpi.__all__ or not hasattr(tmpi, n)}
    assert missing == {"pallas"}
    assert tmpi.__version__ == jmpi.__version__
    assert tmpi.collective_selector is selector


def test_scalar_collectives_and_barrier_match_jax():
    """As ``tests/test_collectives.py:323-329``: in one process each scalar
    collective returns its input, and a barrier runs."""
    jmpi.start(devices=jax.devices()[:P_RANKS])
    tmpi.start(ranks=P_RANKS, device="cpu")
    for value in (42, 3.5, -7):
        assert tmpi.broadcast_scalar(value, root=0) == jmpi.broadcast_scalar(value, root=0)
        assert tmpi.allreduce_scalar(value) == jmpi.allreduce_scalar(value)
        assert tmpi.reduce_scalar(value, root=1) == jmpi.reduce_scalar(value, root=1)
        assert tmpi.sendreceive_scalar(value, 0, 2) == jmpi.sendreceive_scalar(value, 0, 2)
    tmpi.barrier()
    jmpi.barrier()
    assert tmpi.num_processes() == jmpi.num_processes() == 1
    assert tmpi.local_ranks() == list(range(P_RANKS))


def test_barrier_needs_a_started_runtime():
    with pytest.raises(tmpi.NotStartedError):
        tmpi.barrier()


def test_collective_availability_string():
    tmpi.start(ranks=2, device="cpu")
    s = tmpi.collective_availability()
    assert "xla=yes" in s and "allreduce" in s and "kernel=no" in s
    assert "cuda.singlenode.sync.allreduce: kernel > ring > xla -> kernel" in s
    assert "cpu.singlenode.sync.allreduce: xla > ring -> xla" in s
    assert "wire.allreduce: -> full" in s
    assert "kernel=yes" in tmpi.collective_availability(torch.device("cuda"))


@pytest.mark.parametrize("backend", ["xla", "ring"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_allgatherv_matches_jax(backend, dtype):
    """Ragged last-dim blocks, concatenated in rank order on every rank,
    against the JAX ``eager.run_allgatherv`` on the same numpy blocks
    (exact: the blocks are only moved)."""
    p = P_RANKS
    rng = np.random.RandomState(1)
    sizes = [(r % 3) + 1 + 4 * r for r in range(p)]
    blocks = [(rng.randn(2, s) * 100).astype(dtype) for s in sizes]
    jmpi.start(devices=jax.devices()[:p])
    ref = np.asarray(jeager.run_allgatherv(blocks, jmpi.current_communicator(), backend=backend))
    tmpi.start(ranks=p, device="cpu")
    out = tmpi.allgatherv_tensor([torch.from_numpy(b) for b in blocks], backend=backend)
    assert tuple(out.shape) == ref.shape == (p, 2, sum(sizes))
    np.testing.assert_array_equal(out.numpy(), ref)
    # numpy blocks are taken as they are, 1-D ones too
    ints = [np.arange(r + 1, dtype=np.int32) + 10 * r for r in range(p)]
    got = tmpi.allgatherv_tensor(ints, backend=backend).numpy()
    np.testing.assert_array_equal(got, np.broadcast_to(np.concatenate(ints), got.shape))


def test_allgatherv_argument_errors():
    p = P_RANKS
    tmpi.start(ranks=p, device="cpu")
    err = tmpi.collectives.CollectiveArgumentError
    with pytest.raises(err, match="blocks"):
        tmpi.allgatherv_tensor([np.zeros(3)] * (p + 1))
    with pytest.raises(err, match="leading"):
        tmpi.allgatherv_tensor([np.zeros((2, 3), np.float32)] * (p - 1)
                               + [np.zeros((3, 3), np.float32)])
    with pytest.raises(err, match="dtype"):
        tmpi.allgatherv_tensor([np.zeros(3, np.float32)] * (p - 1) + [np.zeros(3, np.int32)])
    with pytest.raises(err, match="backend"):
        tmpi.allgatherv_tensor([np.zeros(3, np.float32)] * p, backend="kernel")


def test_runtime_queries_match_jax():
    """As ``tests/test_communicator.py``: one node, the collective span set
    and checked as the JAX stack sets it."""
    jmpi.start(devices=jax.devices()[:8])
    tmpi.start(ranks=8, device="cpu")
    assert tmpi.num_nodes_in_communicator() == jmpi.num_nodes_in_communicator() == 1
    for pkg in (jmpi, tmpi):
        l1 = pkg.push_communicator(lambda r: str(r // 4))
        l2 = pkg.push_communicator(lambda r: str(r // 2))
        assert pkg.stack().span == (l2, l2)
        pkg.set_collective_span(l1, l2)
        assert pkg.stack().span == (l1, l2)
        assert pkg.num_nodes_in_communicator(0) == 1
        with pytest.raises(Exception, match="span"):
            pkg.set_collective_span(0, 5)
        pkg.set_communicator(0)
        assert pkg.current_communicator().name == "global"
    assert tmpi.describe().splitlines()[0] == jmpi.describe().splitlines()[0]


def test_start_takes_a_collective_span():
    def split():
        tmpi.push_communicator(lambda r: str(r // 2))

    tmpi.start(ranks=4, device="cpu", custom_communicator_init=split,
               collective_communicator=(0, 1))
    assert tmpi.stack().span == (0, 1) and tmpi.current_communicator().num_intra_groups == 2
    tmpi.stop()
    with pytest.raises(Exception, match="span"):
        tmpi.start(ranks=4, device="cpu", collective_communicator=(0, 3))
    assert not tmpi.started()


def test_start_constant_overrides():
    """As ``tests/test_constants.py``: ``start(**overrides)`` sets knobs by
    name; an unknown name raises ``KeyError`` before any state changes, and
    a corrected retry starts."""
    with pytest.raises(KeyError):
        tmpi.start(ranks=2, device="cpu", not_a_knob=1)
    assert not tmpi.started()
    tmpi.start(ranks=2, device="cpu", wire_dtype="int8", ps_replication=2)
    assert constants.get("wire_dtype") == "int8" and constants.get("ps_replication") == 2


def test_env_constants_match_jax(monkeypatch):
    """``TORCHMPI_TPU_CONSTANTS`` reaches both packages' knobs with the same
    coercion, and an explicit ``start()`` override beats it."""
    monkeypatch.setenv("TORCHMPI_TPU_CONSTANTS",
                       "ps_replication=2;ps_prefetch=false;wire_dtype=bf16;"
                       "small_allreduce_size_cpu=7")
    jmpi.start(devices=jax.devices()[:2], wire_dtype="int8")
    tmpi.start(ranks=2, device="cpu", wire_dtype="int8")
    for name in ("ps_replication", "ps_prefetch", "wire_dtype", "small_allreduce_size_cpu"):
        assert constants.get(name) == jconstants.get(name), name
    assert constants.get("ps_prefetch") is False and constants.get("wire_dtype") == "int8"
    assert constants.get("small_allreduce_size_cpu") == 7


@pytest.mark.parametrize("spec,error", [("not_a_knob=1", KeyError),
                                        ("ps_prefetch=ture", ValueError)])
def test_env_constants_reject_bad_entries(spec, error, monkeypatch):
    monkeypatch.setenv("TORCHMPI_TPU_CONSTANTS", spec)
    with pytest.raises(error):
        tmpi.start(ranks=2, device="cpu")
    assert not tmpi.started()
    monkeypatch.setenv("TORCHMPI_TPU_CONSTANTS", "ps_prefetch=off")
    tmpi.start(ranks=2, device="cpu")
    assert constants.get("ps_prefetch") is False


def _count_selects(monkeypatch):
    calls = []
    real = selector.select

    def counted(op, device, multinode=False, mode="sync"):
        calls.append((op, mode))
        return real(op, device, multinode=multinode, mode=mode)

    monkeypatch.setattr(selector, "select", counted)
    return calls


def test_selector_runs_once_per_op_and_mode(monkeypatch):
    """The selector's choice is memoized on the communicator per ``(op,
    mode)``, as the JAX ``_dispatch`` memoizes it: repeated calls select
    once; a pinned backend never selects; another communicator selects
    anew; ``free_collective_resources`` drops the memo, as the JAX one
    drops ``_selector_cache``."""
    p = P_RANKS
    calls = _count_selects(monkeypatch)
    tmpi.start(ranks=p, device="cpu")
    x = torch.from_numpy(np.random.RandomState(3).randn(p, 300).astype(np.float32))
    for _ in range(3):
        tmpi.allreduce_tensor(x)
        tmpi.broadcast_tensor(x, root=1)
        tmpi.wait(tmpi.async_.allreduce_tensor(x))
        tmpi.allreduce_tensor(x, backend="ring")
    assert sorted(calls) == [("allreduce", "async"), ("allreduce", "sync"),
                             ("broadcast", "sync")]
    comm = tmpi.current_communicator()
    assert comm._selector_cache == {("allreduce", "sync"): "xla", ("broadcast", "sync"): "xla",
                                    ("allreduce", "async"): "xla"}
    tmpi.push_communicator(lambda r: str(r % 2))
    tmpi.allreduce_tensor(x)
    assert calls.count(("allreduce", "sync")) == 2
    tmpi.set_communicator(0)
    tmpi.allreduce_tensor(x)
    assert calls.count(("allreduce", "sync")) == 2
    tmpi.free_collective_resources(comm)
    assert not hasattr(comm, "_selector_cache")
    tmpi.allreduce_tensor(x)
    assert calls.count(("allreduce", "sync")) == 3


def test_memoized_selector_still_reads_ring_implementation(monkeypatch):
    """With the selector's custom-ring choice memoized, a changed
    ``ring_implementation`` still takes effect on the next call (it is
    read per call, as in the JAX ``_dispatch``)."""
    p = P_RANKS
    calls = _count_selects(monkeypatch)
    tmpi.start(ranks=p, device="cpu")
    comm = tmpi.current_communicator()
    comm._selector_cache = {("allreduce", "sync"): "kernel"}  # the card's choice
    seen = []
    real = eager.run
    monkeypatch.setattr(eager, "run", lambda op, x, comm, backend, **kw: seen.append(backend)
                        or real(op, x, comm, backend=backend, **kw))
    x = torch.from_numpy(np.random.RandomState(4).randn(p, 70000).astype(np.float32))
    for impl, backend in (("kernel", "kernel"), ("ppermute", "ring"), ("kernel", "kernel")):
        constants.set("ring_implementation", impl)
        tmpi.allreduce_tensor(x)
        assert seen[-1] == backend
    assert calls == []


def test_free_collective_resources_flushes_the_fusion_buffer():
    """Pending fused submissions are dispatched before the buffer goes, so
    no handle is orphaned (``eager.py:246``)."""
    p = P_RANKS
    tmpi.start(ranks=p, device="cpu")
    constants.set("fusion_buffer_bytes", 1 << 20)
    comm = tmpi.current_communicator()
    fb = tmpi.collectives.get_fusion_buffer(comm)
    xs = [torch.full((p, 10), float(i)) for i in range(3)]
    handles = [fb.submit("allreduce", x) for x in xs]
    tmpi.free_collective_resources(comm)
    assert not hasattr(comm, "_fusion_buffer")
    for i, h in enumerate(handles):
        assert torch.equal(h.wait(), torch.full((p, 10), float(i * p)))
