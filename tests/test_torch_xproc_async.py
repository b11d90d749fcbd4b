"""The async collectives and the int8/bf16 wire with the port's ranks
spread over real processes, on the CPU.

Two worker processes of two ranks each (``start(coordinator_address=...)``,
``device='cpu'``: the control plane's gloo group and issue thread, the
lanes' POSIX shared memory and the plain versions of the cross-process
K3, K4 and K7) run, once for the module, on inputs this module draws from
numpy seeds and hands them in a file:

- async allreduce, reduce-scatter, allgather and broadcast on ``xla``,
  ``ring`` and ``kernel``, each followed by the same op issued
  synchronously before any handle is waited, the handles then waited in
  reverse issue order; a batch drained by ``sync_all()``; and handles
  still outstanding when ``stop()`` runs. Every process's rows must equal
  the one-process port's rows of the same ``[p, ...]`` bit for bit, and
  lie within ``JAX_RTOL`` of the JAX package's single-controller run on
  ``jax.devices()[:4]``;
- the int8 and bf16 wire of the allreduce and the reduce-scatter on the
  ``kernel`` backend (the cross-process K4, sync and async) and on
  ``ring`` (the rows gathered, the one-process plan): bit for bit the
  one-process port, whose plain K4 is pinned here to the interpret-mode
  Pallas kernel on a one-axis mesh, as ``tests/test_torch_wire.py`` pins
  it;
- config 2 (LeNet, the async engine, the int8 wire, batch 336, lr 0.2,
  flax-shaped weights from a numpy seed) for ``LENET_STEPS`` steps with
  ``rank_map='loop'``, the selector pinned to the kernel rings, with and
  without error feedback: the losses and parameters must equal the
  one-process p=4 run's bit for bit, and lie within the tolerance
  ``tests/test_torch_engine.py`` holds the ``("async", "int8")`` engine
  to against the JAX engine.

A third worker pair kills one process while the other's async allreduce
is outstanding: its ``wait()`` must raise ``PeerError`` within seconds.
Plain-version tests of the two new forms run in this process. Both the
tests' process and the workers take two intra-op threads, so ATen rounds
alike in both.
"""

import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import constants, ops
from torchmpi_tpu_torch.launch import _free_port

_REPO = Path(__file__).resolve().parent.parent
L = 2  # ranks a process
NPROC = 2
P = L * NPROC
SHAPES = {"allreduce": ((700,), (70001,)), "reducescatter": ((700,), (3, 28)),
          "allgather": ((700,), (3, 7)), "broadcast": ((700,), (70001,))}
BACKENDS = ("xla", "ring", "kernel")
ROOT = P - 1  # the broadcast's root, in the second process
WIRES = ("int8", "bf16")
WIRE_SHAPES = {"allreduce": ((5000,), (70001,)), "reducescatter": ((2400,), (5, 512))}
WIRE_BACKENDS = ("ring", "kernel")
TREE = {"a": (30, 40), "b": (700,), "c": (5, 7, 9)}  # a gradient dict's leaves
JAX_RTOL = 1e-6
LENET_STEPS = 3
LENET_BATCH = 336
LR = 0.2
FEEDBACK = (False, True)  # config 2's default (off), and error feedback on
KILL_BOUND_S = 20.0  # how soon a dead peer must surface from wait()

_WORKER = textwrap.dedent(
    """
    import sys
    pid, nproc, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    sys.path.insert(0, {repo!r})
    import torch
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import constants
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import LeNet, make_loss_fn
    from torchmpi_tpu_torch.ops import ring_kernels

    torch.set_num_threads(2)  # as the tests' process (_two_threads)
    L, ROOT, STEPS, BATCH, LR = {L}, {root}, {steps}, {batch}, {lr}
    inputs = torch.load(f"{{out_dir}}/inputs.pt")
    calls = {{"k4": 0, "k4rs": 0}}
    real_ar, real_rs = (ring_kernels.ring_allreduce_quant_xproc,
                        ring_kernels.ring_reduce_scatter_quant_xproc)

    def k4(*a, **kw):
        calls["k4"] += 1
        return real_ar(*a, **kw)

    def k4rs(*a, **kw):
        calls["k4rs"] += 1
        return real_rs(*a, **kw)

    ring_kernels.ring_allreduce_quant_xproc = k4
    ring_kernels.ring_reduce_scatter_quant_xproc = k4rs

    def start(**kw):
        mpi.start(ranks=L, device="cpu", coordinator_address=f"localhost:{{port}}",
                  num_processes=nproc, process_id=pid, **kw)

    def issue(ns, op, x, comm, **kw):
        fn = getattr(ns, f"{{op}}_tensor")
        return fn(x, root=ROOT, comm=comm) if op == "broadcast" else fn(x, comm=comm, **kw)

    res = {{}}
    start()
    comm = mpi.stack().at(0)
    mine = comm.local_ranks
    constants.set("small_allreduce_size_cpu", 0)
    constants.set("small_broadcast_size_cpu", 0)
    constants.set("wire_quant_min_elements", 1)

    # every op async, each followed by the same op issued synchronously,
    # the handles waited in reverse issue order
    for b in ("xla", "ring", "kernel"):
        handles = []
        for key, full in inputs["payloads"].items():
            op = key.split("/")[0]
            handles.append((key, issue(getattr(mpi.async_, b), op, full[mine], comm)))
            res[f"sync/{{key}}/{{b}}"] = issue(getattr(mpi, b), op, full[mine], comm)
        for key, h in reversed(handles):
            res[f"async/{{key}}/{{b}}"] = h.wait()

    # a batch drained by sync_all(), then waited (a no-op)
    x = inputs["payloads"]["allreduce/(70001,)"][mine]
    handles = {{b: getattr(mpi.async_, b).allreduce_tensor(x, comm=comm) for b in ("xla", "ring",
                                                                              "kernel")}}
    mpi.sync_all()
    res["sync_all"] = {{b: h.wait() for b, h in handles.items()}}

    # the wire, sync and async: the cross-process K4 on the kernel backend
    before = dict(calls)
    for key, full in inputs["wire_payloads"].items():
        op = key.split("/")[0]
        for wire in ("int8", "bf16"):
            for b in ("ring", "kernel"):
                h = issue(getattr(mpi.async_, b), op, full[mine], comm, wire_dtype=wire)
                res[f"wire/{{key}}/{{wire}}/{{b}}"] = issue(getattr(mpi, b), op, full[mine], comm,
                                                          wire_dtype=wire)
                res[f"wire_async/{{key}}/{{wire}}/{{b}}"] = h.wait()
    res["k4_calls"] = {{k: calls[k] - before[k] for k in calls}}

    # the scheduled bucket sync under both schedules, and the fusion
    # buffer's unfused dispatch (a flush below fusion_min_tensors)
    from torchmpi_tpu_torch import nn as mpinn
    tree = {{k: v[mine] for k, v in inputs["tree"].items()}}
    bkts = mpinn.GradientBuckets({{k: v[0] for k, v in inputs["tree"].items()}}, 2)
    for sched in ("reverse", "none"):
        res[f"tree/scheduled-{{sched}}"] = bkts.sync_scheduled(tree, comm, backend="kernel",
                                                             average=True, schedule=sched)
    constants.set("fusion_min_tensors", 100)
    fb = mpi.collectives.get_fusion_buffer(comm)
    fused = {{k: fb.submit("allreduce", v, backend="kernel") for k, v in tree.items()}}
    fb.flush_for(fused.values())
    res["tree/unfused"] = {{k: h.wait() for k, h in fused.items()}}

    # handles outstanding at stop(), which drains them
    late = {{b: getattr(mpi.async_, b).allreduce_tensor(x, comm=comm) for b in ("xla", "ring",
                                                                           "kernel")}}
    mpi.stop()
    res["stop"] = {{b: h.wait() for b, h in late.items()}}

    # config 2: the async engine with the int8 wire, its two buckets
    constants._reset_for_tests()
    mpi.collectives.selector.select = lambda *a, **k: "kernel"
    xtr, ytr = inputs["mnist"]
    for feedback in {feedback}:
        start(with_ici_groups=False)
        constants.set("wire_error_feedback", feedback)
        eng = AllReduceSGDEngine(make_loss_fn(LeNet()), inputs["lenet"], lr=LR,
                                 comm=mpi.current_communicator(), mode="async",
                                 wire_dtype="int8", rank_map="loop")
        before = dict(calls)
        losses = [float(eng.step((xtr[i * BATCH:(i + 1) * BATCH],
                                  ytr[i * BATCH:(i + 1) * BATCH]))) for i in range(STEPS)]
        res[f"lenet/{{feedback}}"] = {{
            "losses": losses, "params": dict(eng.params), "buckets": eng.buckets.num_buckets,
            "k4": calls["k4"] - before["k4"]}}
        mpi.stop()
    torch.save(res, f"{{out_dir}}/proc{{pid}}.pt")
    print(f"proc {{pid}} OK")
    """
).format(repo=str(_REPO), L=L, root=ROOT, steps=LENET_STEPS, batch=LENET_BATCH, lr=LR,
         feedback=FEEDBACK)

# one process dies while the other's async allreduce waits on it
_KILL_WORKER = textwrap.dedent(
    """
    import os, signal, sys, time
    pid, nproc, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    backend = sys.argv[5]
    sys.path.insert(0, {repo!r})
    import torch
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import constants
    from torchmpi_tpu_torch.runtime.peers import PeerError

    mpi.start(ranks={L}, device="cpu", coordinator_address=f"localhost:{{port}}",
              num_processes=nproc, process_id=pid, with_ici_groups=False)
    constants.set("deadlock_timeout_seconds", 120)
    constants.set("small_allreduce_size_cpu", 0)  # the lane on kernel, gloo on xla
    comm = mpi.current_communicator()
    x = torch.ones((comm.local_size, 1024))
    mpi.kernel.allreduce_tensor(x, comm=comm)  # the lane, made by both
    mpi.barrier()
    if pid == 1:
        time.sleep(0.5)  # process 0's call is outstanding by now
        os.kill(os.getpid(), signal.SIGKILL)
    t0 = time.monotonic()
    h = getattr(mpi.async_, backend).allreduce_tensor(x, comm=comm)
    issued = time.monotonic() - t0
    try:
        h.wait()
        outcome = "returned"
    except PeerError as e:
        outcome = f"PeerError: {{e}}"
    waited = time.monotonic() - t0
    try:
        getattr(mpi.async_, backend).allreduce_tensor(x, comm=comm).wait()
        after = "returned"
    except PeerError as e:
        after = f"PeerError: {{e}}"
    t0 = time.monotonic()
    try:
        mpi.stop()
        stopped = "returned"
    except PeerError as e:
        stopped = f"PeerError: {{e}}"
    torch.save({{"outcome": outcome, "issued_s": issued, "waited_s": waited, "after": after,
                "stopped": stopped, "stop_s": time.monotonic() - t0,
                "started_after_stop": mpi.started()}}, f"{{out_dir}}/kill.pt")
    print("proc 0 OK", flush=True)
    os._exit(0)  # the peer is gone: no collective teardown
    """
).format(repo=str(_REPO), L=L)


def _lenet_jax_weights():
    """flax LeNet variables in the shapes of its ``init`` (traced, not
    run), kernels normal with variance 1/fan_in and biases near 0, from a
    numpy seed."""
    import jax
    import jax.numpy as jnp

    from torchmpi_tpu.models import LeNet as JLeNet

    shapes = jax.eval_shape(lambda k: JLeNet().init(k, jnp.zeros((1, 28, 28))),
                            jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)

    def fill(path, leaf):
        z = rs.randn(*leaf.shape).astype(np.float32)
        if path[-1].key == "kernel":
            return z / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        return 0.1 * z

    return jax.tree_util.tree_map_with_path(fill, shapes)["params"]


def _payloads(shapes: dict, seed: int) -> dict:
    """Seeded f32 ``[p, ...]`` payloads keyed ``op/shape``."""
    rng = np.random.default_rng(seed)
    return {f"{op}/{shape}": torch.from_numpy(rng.standard_normal((P,) + shape)
                                              .astype(np.float32))
            for op, group in shapes.items() for shape in group}


def _mnist():
    from torchmpi_tpu_torch.utils import synthetic_mnist

    (x, y), _ = synthetic_mnist(num_train=LENET_BATCH * LENET_STEPS, num_test=1)
    return torch.as_tensor(x), torch.as_tensor(y)


def _spawn(tmp_path: Path, source: str, name: str, *args) -> list:
    worker = tmp_path / f"{name}.py"
    worker.write_text(source)
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, str(worker), str(i), str(NPROC), str(port), str(tmp_path), *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for i in range(NPROC)]


def _finish(procs: list, timeout: float) -> list:
    outs = []
    for proc in procs:
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process workers timed out")
        outs.append(out)
    return outs


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, as each worker takes: ATen's convolutions and
    products round by how they split over threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs():
    from torchmpi_tpu_torch.models import from_jax_params

    jp = _lenet_jax_weights()
    rng = np.random.default_rng(2)
    tree = {k: torch.from_numpy(rng.standard_normal((P,) + shape).astype(np.float32))
            for k, shape in TREE.items()}
    return {"payloads": _payloads(SHAPES, 0), "wire_payloads": _payloads(WIRE_SHAPES, 1),
            "tree": tree, "mnist": _mnist(), "lenet_jax": jp, "lenet": from_jax_params(jp)}


@pytest.fixture(scope="module")
def worker_results(tmp_path_factory, inputs):
    tmp = tmp_path_factory.mktemp("xproc_async")
    torch.save({k: v for k, v in inputs.items() if k != "lenet_jax"}, tmp / "inputs.pt")
    outs = _finish(_spawn(tmp, _WORKER, "worker"), timeout=300)
    for i, out in enumerate(outs):
        assert f"proc {i} OK" in out, f"proc {i} failed:\n{out[-3000:]}"
    return [torch.load(tmp / f"proc{i}.pt") for i in range(NPROC)]


def _rows(full: torch.Tensor, proc: int) -> torch.Tensor:
    return full[proc * L:(proc + 1) * L]


def _one(ns, op: str, x: torch.Tensor, **kw) -> torch.Tensor:
    fn = getattr(ns, f"{op}_tensor")
    return fn(x, root=ROOT) if op == "broadcast" else fn(x, **kw)


@pytest.fixture(scope="module")
def one_process(inputs):
    """The one-process port on the same payloads, sync (the async calls
    of one process run the same plan)."""
    tmpi.start(ranks=P, device="cpu", with_ici_groups=False)
    try:
        constants.set("small_allreduce_size_cpu", 0)
        constants.set("small_broadcast_size_cpu", 0)
        constants.set("wire_quant_min_elements", 1)
        res = {}
        for key, x in inputs["payloads"].items():
            for b in BACKENDS:
                res[f"{key}/{b}"] = _one(getattr(tmpi, b), key.split("/")[0], x)
        for key, x in inputs["wire_payloads"].items():
            for wire in WIRES:
                for b in WIRE_BACKENDS:
                    res[f"{key}/{wire}/{b}"] = _one(getattr(tmpi, b), key.split("/")[0], x,
                                                    wire_dtype=wire)
        tree = inputs["tree"]
        comm = tmpi.current_communicator()
        bkts = tmpi.nn.GradientBuckets({k: v[0] for k, v in tree.items()}, 2)
        for sched in ("reverse", "none"):
            res[f"tree/scheduled-{sched}"] = bkts.sync_scheduled(
                tree, comm, backend="kernel", average=True, schedule=sched)
        res["tree/unfused"] = {k: tmpi.kernel.allreduce_tensor(v) for k, v in tree.items()}
        return res
    finally:
        tmpi.stop()
        constants._reset_for_tests()


_KEYS = [f"{op}/{shape}/{b}" for op, group in SHAPES.items() for shape in group
         for b in BACKENDS]


@pytest.mark.parametrize("key", _KEYS)
def test_async_and_interleaved_sync_bitwise_one_process(worker_results, one_process, key):
    """Every process's rows of the async call (waited out of issue order)
    and of the sync call issued between it and its wait are the
    one-process port's rows of the same ``[p, ...]``, bit for bit."""
    for proc, res in enumerate(worker_results):
        want = _rows(one_process[key], proc)
        for mode in ("async", "sync"):
            got = res[f"{mode}/{key}"]
            assert got.dtype == want.dtype and torch.equal(got, want), (key, mode, proc)


def test_sync_all_and_stop_drain_outstanding_handles(worker_results, one_process):
    """Handles drained by ``sync_all()``, and handles still outstanding
    when ``stop()`` runs, hold the one-process rows (a later ``wait()`` is
    a no-op)."""
    for proc, res in enumerate(worker_results):
        for b in BACKENDS:
            want = _rows(one_process[f"allreduce/(70001,)/{b}"], proc)
            assert torch.equal(res["sync_all"][b], want), (b, proc)
            assert torch.equal(res["stop"][b], want), (b, proc)


@pytest.mark.parametrize("key", ["tree/scheduled-reverse", "tree/scheduled-none",
                                 "tree/unfused"])
def test_buckets_and_fusion_dispatch_async(worker_results, one_process, key):
    """``GradientBuckets.sync_scheduled`` under both schedules and the
    ``FusionBuffer``'s unfused async dispatch across processes: every
    process's rows of every leaf the one-process rows, bit for bit."""
    for proc, res in enumerate(worker_results):
        for name, v in one_process[key].items():
            assert torch.equal(res[key][name], _rows(v, proc)), (key, name, proc)


@pytest.fixture(scope="module")
def jax_results(inputs):
    """The JAX package single-controller on jax.devices()[:4]."""
    import jax

    import torchmpi_tpu as jmpi
    from torchmpi_tpu import constants as jconstants

    jmpi.start(devices=jax.devices()[:P])
    try:
        jconstants.set("small_allreduce_size_cpu", 0)
        comm = jmpi.stack().at(0)
        res = {}
        for key, x in inputs["payloads"].items():
            op = key.split("/")[0]
            for b in ("xla", "ring"):
                fn = getattr(jmpi.xla if b == "xla" else jmpi.ring, f"{op}_tensor")
                arr = jax.numpy.asarray(x.numpy())
                out = fn(arr, root=ROOT, comm=comm) if op == "broadcast" else fn(arr, comm=comm)
                res[f"{key}/{b}"] = np.asarray(out)
        return res
    finally:
        jmpi.stop()
        jconstants._reset_for_tests()


@pytest.mark.parametrize("key", _KEYS)
def test_async_matches_jax(worker_results, jax_results, key):
    """Within JAX_RTOL of the JAX single-controller run of the same
    payload (the kernel rows against the vendor path's)."""
    base, backend = key.rsplit("/", 1)
    want = jax_results[f"{base}/{'ring' if backend == 'ring' else 'xla'}"]
    for proc, res in enumerate(worker_results):
        got, ref = res[f"async/{key}"].numpy(), want[proc * L:(proc + 1) * L]
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=JAX_RTOL, atol=JAX_RTOL)


# --- the int8/bf16 wire ---------------------------------------------------
_WIRE_KEYS = [f"{op}/{shape}/{wire}/{b}" for op, group in WIRE_SHAPES.items()
              for shape in group for wire in WIRES for b in WIRE_BACKENDS]


@pytest.mark.parametrize("key", _WIRE_KEYS)
def test_wire_bitwise_one_process(worker_results, one_process, key):
    """The compressed wire across processes, sync and async: the kernel
    backend through the cross-process K4, the ``ring`` backend through the
    gathered rows; every process's rows the one-process rows bit for bit
    (the ranks' rows differ: each chunk's owner keeps its f32 sum)."""
    for proc, res in enumerate(worker_results):
        want = _rows(one_process[key], proc)
        for mode in ("wire", "wire_async"):
            assert torch.equal(res[f"{mode}/{key}"], want), (key, mode, proc)
    full = one_process[key]
    assert (full != full[0:1]).any()


def test_wire_runs_the_cross_process_k4(worker_results):
    """Each kernel-backend wire call ran the cross-process K4 once, its
    allreduce mode for the allreduces and its 'rs' mode for the
    reduce-scatters, sync and async, both wires."""
    n_ar, n_rs = len(WIRE_SHAPES["allreduce"]), len(WIRE_SHAPES["reducescatter"])
    for res in worker_results:
        assert res["k4_calls"] == {"k4": 2 * len(WIRES) * n_ar, "k4rs": 2 * len(WIRES) * n_rs}


def _pallas_quant(x: np.ndarray, mode: str, wire: str) -> np.ndarray:
    """The interpret-mode Pallas kernel on a one-axis mesh of P devices:
    the allreduce of ``[P, n]``, or the reduce-scatter of ``[P, P*seg]``
    as ``[P, seg]`` (``tests/test_torch_wire.py``'s ``_pallas_quant``)."""
    import jax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as PS

    from torchmpi_tpu import constants as jconstants
    from torchmpi_tpu.ops import ring_kernels as jring

    mesh = Mesh(np.array(jax.devices()[:P]), ("mpi",))

    def run(fn, arr):
        return np.asarray(jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=PS("mpi"),
                                                out_specs=PS("mpi"), check_vma=False))(arr))

    # the wire engages at every width, as in the processes
    jconstants.set("wire_quant_min_elements", 1)
    try:
        if mode == "allreduce":
            return run(lambda b: jring.ring_allreduce_pallas(
                b, "mpi", axis_size=P, interpret=True, wire_dtype=wire), x)
        seg = x.shape[1] // P
        return run(lambda b: jring.ring_reduce_scatter_pallas(
            b[0].reshape(P, seg), "mpi", axis_size=P, interpret=True, wire_dtype=wire)[None],
            x.reshape(P, 1, P * seg)).reshape(P, seg)
    finally:
        jconstants._reset_for_tests()


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("op", ("allreduce", "reducescatter"))
def test_plain_k4_is_pinned_to_pallas(worker_results, one_process, inputs, wire, op):
    """The one-process rows the processes are held to are the
    interpret-mode Pallas kernel's at p=4, bit for bit (the first width of
    each op), and so are the processes' own rows."""
    shape = WIRE_SHAPES[op][0]
    x = inputs["wire_payloads"][f"{op}/{shape}"].numpy()
    ref = _pallas_quant(x.reshape(P, -1), "allreduce" if op == "allreduce" else "rs", wire)
    got = one_process[f"{op}/{shape}/{wire}/kernel"].numpy().reshape(P, -1)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    for proc, res in enumerate(worker_results):
        mine = res[f"wire/{op}/{shape}/{wire}/kernel"].numpy().reshape(L, -1)
        np.testing.assert_array_equal(mine.view(np.int32), _rows(ref, proc).view(np.int32))


# --- the plain versions of the two new forms ------------------------------
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("owned", [[0, 1], [2, 3], [3, 0], [1, 3, 0]], ids=str)
@pytest.mark.parametrize("n", [128, 1000, 4097])
def test_allreduce_quant_xproc_plain_is_the_one_process_rows(wire, owned, n):
    """The cross-process K4's plain allreduce over a table of p rows
    gives the one-process plain K4's rows of the ranks in ``owned``, in
    that order, bit for bit, at even and ragged widths."""
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((P, n)).astype(np.float32))
    got = ops.ring_allreduce_quant_xproc_plain(list(x), owned, wire)
    assert torch.equal(got, ops.ring_allreduce_quant_plain(x, wire)[owned])
    assert torch.equal(ops.ring_allreduce_quant_xproc(list(x), owned, wire), got)


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("owned", [[0, 1], [2, 3], [3, 0], [1, 3, 0]], ids=str)
@pytest.mark.parametrize("seg", [128, 600, 1031])
def test_reduce_scatter_quant_xproc_plain_is_the_one_process_rows(wire, owned, seg):
    """The cross-process K4's plain 'rs' over a table of p rows of p
    segments gives the one-process plain K4 'rs' rows of the ranks in
    ``owned``, bit for bit."""
    x = torch.from_numpy(np.random.default_rng(seg).standard_normal((P, P * seg))
                         .astype(np.float32))
    got = ops.ring_reduce_scatter_quant_xproc_plain(list(x), owned, wire)
    want = ops.ring_reduce_scatter_quant_plain(x.reshape(P, P, seg), wire).reshape(P, seg)
    assert torch.equal(got, want[owned])
    assert torch.equal(ops.ring_reduce_scatter_quant_xproc(list(x), owned, wire), got)


def test_quant_xproc_forms_check_their_arguments():
    rows = list(torch.zeros((P, 8 * P)))
    with pytest.raises(ValueError, match="out of range or repeated"):
        ops.ring_allreduce_quant_xproc_plain(rows, [0, 0], "int8")
    with pytest.raises(ValueError, match="out of range or repeated"):
        ops.ring_reduce_scatter_quant_xproc_plain(rows, [P], "bf16")
    with pytest.raises(ValueError, match="wire must be"):
        ops.ring_allreduce_quant_xproc_plain(rows, [0], "fp8")
    with pytest.raises(ValueError, match="1-D float32"):
        ops.ring_allreduce_quant_xproc_plain(list(torch.zeros((P, 8), dtype=torch.bfloat16)),
                                             [0], "int8")
    with pytest.raises(ValueError, match="p segments"):
        ops.ring_reduce_scatter_quant_xproc_plain(list(torch.zeros((P, 6))), [0], "int8")
    with pytest.raises(ValueError, match="runs on CUDA or the CPU"):
        ops.ring_allreduce_quant_xproc([torch.zeros(8, device="meta")] * P, [0], "int8")


# --- config 2 -------------------------------------------------------------
def _lenet_steps(inputs, comm=None):
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import LeNet, make_loss_fn

    x, y = inputs["mnist"]
    eng = AllReduceSGDEngine(make_loss_fn(LeNet()), inputs["lenet"], lr=LR, comm=comm,
                             mode="async", wire_dtype="int8", rank_map="loop")
    losses = [float(eng.step((x[i * LENET_BATCH:(i + 1) * LENET_BATCH],
                              y[i * LENET_BATCH:(i + 1) * LENET_BATCH])))
              for i in range(LENET_STEPS)]
    return losses, dict(eng.params), eng.buckets.num_buckets


@pytest.fixture(scope="module")
def lenet_one_process(inputs):
    mp = pytest.MonkeyPatch()
    mp.setattr(tmpi.collectives.selector, "select", lambda *a, **k: "kernel")
    out = {}
    try:
        for feedback in FEEDBACK:
            tmpi.start(ranks=P, device="cpu", with_ici_groups=False)
            try:
                constants.set("wire_error_feedback", feedback)
                out[feedback] = _lenet_steps(inputs)
            finally:
                tmpi.stop()
                constants._reset_for_tests()
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("feedback", FEEDBACK, ids=["config2", "error-feedback"])
def test_config2_equals_one_process(worker_results, lenet_one_process, feedback):
    """Config 2 by 2 processes x 2: the losses and every process's rows of
    the parameters equal the one-process p=4 run's bit for bit; two
    buckets, bucket 0 through the cross-process K4 every step."""
    losses, params, buckets = lenet_one_process[feedback]
    assert buckets == 2
    for proc, res in enumerate(worker_results):
        run = res[f"lenet/{feedback}"]
        assert run["losses"] == losses and run["buckets"] == buckets
        for name, v in params.items():
            assert torch.equal(run["params"][name], _rows(v, proc)), name
        assert run["k4"] == LENET_STEPS


@pytest.fixture(scope="module")
def lenet_jax(inputs):
    """The JAX engine's async int8 steps of the same batches."""
    import jax
    import optax

    import torchmpi_tpu as jmpi
    from torchmpi_tpu.engine import AllReduceSGDEngine as JEngine
    from torchmpi_tpu.models import LeNet as JLeNet
    from torchmpi_tpu.models import make_loss_fn as jloss
    from torchmpi_tpu_torch.models import from_jax_params

    x, y = (t.numpy() for t in inputs["mnist"])
    jmpi.start(devices=jax.devices()[:P])
    try:
        eng = JEngine(jloss(JLeNet()), inputs["lenet_jax"], optimizer=optax.sgd(LR),
                      mode="async", wire_dtype="int8")
        losses = [float(eng.step((x[i * LENET_BATCH:(i + 1) * LENET_BATCH],
                                  y[i * LENET_BATCH:(i + 1) * LENET_BATCH])))
                  for i in range(LENET_STEPS)]
        return losses, from_jax_params(jax.device_get(eng.params))
    finally:
        jmpi.stop()


def test_config2_matches_the_jax_engine(worker_results, lenet_jax, inputs):
    """Within the tolerance ``tests/test_torch_engine.py`` holds the
    ``("async", "int8")`` engine to: the first loss rtol 1e-4, each rank's
    update within 2e-2 of the JAX update's largest magnitude, the ranks'
    rows apart by the wire's rounding only (at most 1e-2)."""
    jlosses, ref = lenet_jax
    init = inputs["lenet"]
    jupdate = np.concatenate([(ref[k] - init[k]).numpy().ravel() for k in sorted(ref)])
    for res in worker_results:
        run = res[f"lenet/{False}"]
        np.testing.assert_allclose(run["losses"][0], jlosses[0], rtol=1e-4)
        for r in range(L):
            update = np.concatenate([(run["params"][k][r] - init[k]).numpy().ravel()
                                     for k in sorted(ref)])
            assert np.abs(update - jupdate).max() / np.abs(jupdate).max() <= 2e-2, r
        spread = max(float((v - v[0:1]).abs().max()) for v in run["params"].values())
        assert spread <= 1e-2


# --- the issue thread alone ------------------------------------------------
def test_issue_thread_keeps_fifo_order_under_contention():
    """More submitting threads than cores, a short switch interval: every
    call runs once, each thread's calls in its submission order, and
    ``drain()`` from any thread returns with nothing pending."""
    import os
    import threading

    from torchmpi_tpu_torch.runtime.peers import IssueThread

    issue, ran = IssueThread(), []
    per, nthreads = 200, (os.cpu_count() or 2) + 2

    def submitter(t):
        futs = [issue.submit(lambda t=t, i=i: ran.append((t, i)) or i) for i in range(per)]
        assert [f.result(timeout=30) for f in futs] == list(range(per))
        issue.drain()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submitter, args=(t,)) for t in range(nthreads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
        issue.close()
    assert len(ran) == per * nthreads and issue._pending == 0
    for t in range(nthreads):
        assert [i for q, i in ran if q == t] == list(range(per))


def test_issue_thread_fails_every_call_after_a_failure():
    """A call that raises sets its error on its future; every later call
    fails with ``PeerError`` naming it, and so does ``drain()``."""
    from torchmpi_tpu_torch.runtime.peers import IssueThread, PeerError

    issue = IssueThread()
    try:
        ok = issue.submit(lambda: 1)
        bad = issue.submit(lambda: 1 / 0)
        later = issue.submit(lambda: 2)
        assert ok.result(timeout=30) == 1
        with pytest.raises(ZeroDivisionError):
            bad.result(timeout=30)
        with pytest.raises(PeerError, match="ZeroDivisionError"):
            later.result(timeout=30)
        with pytest.raises(PeerError, match="an earlier cross-process call failed"):
            issue.drain()
    finally:
        issue.close()


# the exit ends the thread, as it is meant to; pytest reports that as a warning
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_issue_thread_survives_an_exit_in_a_call():
    """A call that raises an exit (not an ``Exception``) ends the thread:
    the calls queued behind it and every later one fail with
    ``PeerError``, and ``drain()`` and ``close()`` return instead of
    waiting on it."""
    import threading

    from torchmpi_tpu_torch.runtime.peers import IssueThread, PeerError

    issue, gate = IssueThread(), threading.Event()
    try:
        held = issue.submit(lambda: gate.wait(30))
        exits = issue.submit(lambda: sys.exit(3))
        behind = issue.submit(lambda: 2)
        gate.set()
        assert held.result(timeout=30) is True
        with pytest.raises(SystemExit):
            exits.result(timeout=30)
        with pytest.raises(PeerError, match="SystemExit"):
            behind.result(timeout=30)
        with pytest.raises(PeerError, match="an earlier cross-process call failed"):
            issue.drain()
        assert issue._pending == 0
        with pytest.raises(PeerError, match="SystemExit"):
            issue.submit(lambda: 3).result(timeout=30)
    finally:
        issue.close()
    assert issue._thread is None


# --- a peer that dies -----------------------------------------------------
@pytest.mark.parametrize("backend", ["kernel", "xla"])
def test_dead_peer_surfaces_from_wait(tmp_path, backend):
    """One process is killed while the other's async allreduce waits on
    it (on ``kernel`` for its post in the lane, on ``xla`` in gloo's
    gather): that ``wait()`` raises ``PeerError`` within ``KILL_BOUND_S``,
    the issue itself returned at once, every later call raises too (the
    processes are out of step), and ``stop()`` drops the runtime without
    waiting for the peer and raises."""
    procs = _spawn(tmp_path, _KILL_WORKER, "kill", backend)
    t0 = time.monotonic()
    outs = _finish(procs, timeout=120)
    assert procs[1].returncode == -9, outs[1][-2000:]
    assert procs[0].returncode == 0 and "proc 0 OK" in outs[0], outs[0][-3000:]
    res = torch.load(tmp_path / "kill.pt")
    assert res["outcome"].startswith("PeerError") and "died" in res["outcome"], res
    assert res["issued_s"] < 1.0 and res["waited_s"] < KILL_BOUND_S, res
    assert res["after"].startswith("PeerError"), res
    # stop() tears the runtime down without meeting the dead peer, then raises
    assert res["stopped"].startswith("PeerError") and res["stop_s"] < KILL_BOUND_S, res
    assert not res["started_after_stop"], res
    assert time.monotonic() - t0 < 120


# --- the 48-step trajectories behind chip_smoke.py's runs (e) and (f) ----------
def lenet_trajectories(epochs: int = 2) -> dict:
    """Config 1 (sync, 'full') and config 2 (async, int8) at p=8: LeNet
    from the port's seed-0 parameters, ``synthetic_mnist``'s 8,192 images,
    batch 336, lr 0.2, ``epochs`` epochs of 24 steps, the batches of
    ``DistributedIterator`` (seed 0), as ``chip_smoke.py``'s one-process
    references of runs (b), (e) and (f) take them. The JAX engine on
    ``jax.devices()[:8]`` (its weights converted from the port's), and the
    port under ``rank_map`` 'loop' and 'vmap' (config 1) and 'loop'
    (config 2, the selector pinned to the kernel rings). For each run:
    the losses, the first, the last epoch's mean and median, and the
    steps whose loss exceeds the first by more than 0.2."""
    import statistics

    import jax
    import optax

    import torchmpi_tpu as jmpi
    from torchmpi_tpu.engine import AllReduceSGDEngine as JEngine
    from torchmpi_tpu.models import LeNet as JLeNet
    from torchmpi_tpu.models import make_loss_fn as jloss
    from torchmpi_tpu.utils import DistributedIterator as JIterator
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import LeNet, init_params, make_loss_fn
    from torchmpi_tpu_torch.utils import DistributedIterator, synthetic_mnist

    p, batch, lr = 8, 336, 0.2
    (x, y), _ = synthetic_mnist()
    init = init_params(LeNet(), seed=0)
    flax = {f"{'Conv' if k.startswith('conv') else 'Dense'}_{k[-1]}": {
        "kernel": np.ascontiguousarray(init[f"{k}.weight"].numpy().transpose(2, 3, 1, 0)
                                       if k.startswith("conv") else init[f"{k}.weight"].numpy().T),
        "bias": init[f"{k}.bias"].numpy()} for k in ("conv0", "conv1", "dense0", "dense1")}

    def summary(losses):
        last = losses[-len(losses) // epochs:]
        return {"losses": losses, "first": losses[0], "last_epoch_mean": sum(last) / len(last),
                "last_epoch_median": statistics.median(last),
                "spikes": [s + 1 for s, v in enumerate(losses) if v > losses[0] + 0.2]}

    out = {}
    for mode, wire in (("sync", "full"), ("async", "int8")):
        jmpi.start(devices=jax.devices()[:p])
        try:
            engine = JEngine(jloss(JLeNet()), flax, optimizer=optax.sgd(lr), mode=mode,
                             wire_dtype=wire)
            it = JIterator(x, y, batch, p, seed=0)
            out[f"jax/{mode}/{wire}"] = summary(
                [float(engine.step(b)) for _ in range(epochs) for b in it])
        finally:
            jmpi.stop()
    for mode, wire, rank_map in (("sync", "full", "loop"), ("sync", "full", "vmap"),
                                 ("async", "int8", "loop")):
        tmpi.start(ranks=p, device="cpu")
        try:
            if wire != "full":
                constants.set("small_allreduce_size_cpu", 0)
            losses = []
            engine = AllReduceSGDEngine(
                make_loss_fn(LeNet()), init, lr=lr, mode=mode, wire_dtype=wire,
                rank_map=rank_map, hooks={"on_update": lambda s: losses.append(float(s["loss"]))})
            select = tmpi.collectives.selector.select
            if wire != "full":
                tmpi.collectives.selector.select = lambda *a, **k: "kernel"
            it = DistributedIterator(x, y, batch, p, device="cpu")
            try:
                engine.train(lambda: iter(it), max_epochs=epochs)
            finally:
                tmpi.collectives.selector.select = select
            out[f"port/{mode}/{wire}/{rank_map}"] = summary(losses)
        finally:
            tmpi.stop()
            tmpi.constants._reset_for_tests()
    return out


if __name__ == "__main__":
    import argparse
    import json
    import os

    parser = argparse.ArgumentParser(
        description="config 1's and config 2's 48-step LeNet trajectories at p=8, the JAX "
                    "engine against the port, on the CPU")
    parser.add_argument("--trajectories", action="store_true", required=True)
    parser.parse_args()
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps({"trajectories": lenet_trajectories()}))
