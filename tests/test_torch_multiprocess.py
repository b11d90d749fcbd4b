"""The port's ranks spread over real processes on the CPU.

Two worker processes of two ranks each (``start(coordinator_address=...)``,
``device='cpu'``: the control plane's gloo group, the lanes' POSIX shared
memory and the plain versions of the cross-process K3 and K7) run, once
for the module:

- the closed-form allreduce (rank r gives r, the total p(p-1)/2) on
  ``xla``, ``ring`` and ``kernel``, on the global level and on the
  per-node level ``start()`` pushes, as ``_WORKER`` of
  ``tests/test_multiprocess.py`` does;
- seeded f32 allreduces, broadcasts and reduces on both levels and every
  backend, held here bit for bit against the one-process port on the same
  ``[p, n]`` and within ``JAX_RTOL`` of the JAX package's single-controller
  run on ``jax.devices()[:4]`` (the JAX ``psum`` adds in another order);
- the scalar collectives (``_SCALAR_WORKER``), the staged level
  (``_STAGED_WORKER``), the errors of what this slice does not carry
  across processes, and the local-rows contract;
- config 1 (LeNet, batch 336, lr 0.2, seed 0) for a few steps under the
  per-node span and under the flat one, whose losses and parameters must
  equal the one-process run's under the same span bit for bit. The
  engine takes ``rank_map='loop'``: vmap batches the ranks' convolutions
  into one grouped convolution whose algorithm, and so whose rounding,
  depends on how many ranks a process holds.

The launcher runs the unmodified ``mnist_allreduce`` twin as 2 processes.
Three and four processes and the launcher's kill, multi-launcher and
signal cases are marked slow.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import constants
from torchmpi_tpu_torch.launch import _free_port

_REPO = Path(__file__).resolve().parent.parent
L = 2  # ranks a process
NPROC = 2
P = L * NPROC
SIZES = (700, 70001)
BACKENDS = ("xla", "ring", "kernel")
LEVELS = ("global", "node")
JAX_RTOL = 1e-6
LENET_STEPS = 3

_WORKER = textwrap.dedent(
    """
    import sys
    pid, nproc, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import constants
    from torchmpi_tpu_torch.collectives import CollectiveArgumentError, eager
    from torchmpi_tpu_torch.ops import ring_kernels
    from torchmpi_tpu_torch.schedule import compiler

    L, SIZES, STEPS = {L}, {SIZES}, {steps}
    calls = {{"k3": 0, "k7": 0}}
    real_k3, real_k7 = ring_kernels.ring_allreduce_xproc, ring_kernels.ring_broadcast_xproc

    def k3(*a, **kw):
        calls["k3"] += 1
        return real_k3(*a, **kw)

    def k7(*a, **kw):
        calls["k7"] += 1
        return real_k7(*a, **kw)

    ring_kernels.ring_allreduce_xproc, ring_kernels.ring_broadcast_xproc = k3, k7

    def start(**kw):
        mpi.start(ranks=L, device="cpu", coordinator_address=f"localhost:{{port}}",
                  num_processes=nproc, process_id=pid, **kw)

    res = {{}}
    start()
    gcomm, hcomm = mpi.stack().at(0), mpi.stack().at(1)
    p = gcomm.size
    mine = list(range(L * pid, L * pid + L))
    assert p == L * nproc and mpi.size() == p, p
    assert mpi.num_processes() == nproc and gcomm.num_nodes() == nproc
    assert mpi.local_ranks() == mine and mpi.rank() == L * pid, mpi.local_ranks()
    assert mpi.stack().span == (0, 1) and mpi.current_communicator() is hcomm
    assert hcomm.cartesian and hcomm.num_intra_groups == nproc
    assert f"processes=[{{pid}}]" in mpi.describe()
    constants.set("small_allreduce_size_cpu", 0)
    constants.set("small_broadcast_size_cpu", 0)

    # the closed form on every backend and both levels
    for c in (gcomm, hcomm):
        x = torch.stack([torch.full((700,), float(r)) for r in c.local_ranks])
        for b in (None, "xla", "ring", "kernel"):
            out = mpi.allreduce_tensor(x, comm=c, backend=b)
            assert out.shape == x.shape and (out == p * (p - 1) / 2).all(), (c.name, b, out)
    res["plan_node_ring"] = compiler.compile_collective(
        "allreduce", (p, 700), torch.float32, hcomm, backend="ring").plan.generator
    from torchmpi_tpu_torch.schedule.topology import Topology
    res["topology"] = Topology.from_communicator(hcomm).fingerprint()
    for b in ("xla", "ring"):
        for n in SIZES:
            res[f"plan/{{b}}/{{n}}"] = compiler.compile_collective(
                "allreduce", (p, n), torch.float32, hcomm, backend=b).plan.plan_id
    k3_closed = calls["k3"]

    # seeded payloads: every process draws the whole [p, n] and keeps its rows
    rng = np.random.default_rng(0)
    for n in SIZES:
        x = torch.from_numpy(rng.standard_normal((p, n)).astype(np.float32)[mine])
        for level, c in (("global", gcomm), ("node", hcomm)):
            for b in ("xla", "ring", "kernel"):
                res[f"allreduce/{{level}}/{{b}}/{{n}}"] = mpi.allreduce_tensor(x, comm=c, backend=b)
                res[f"broadcast/{{level}}/{{b}}/{{n}}"] = mpi.broadcast_tensor(
                    x, root=p - 1, comm=c, backend=b)
                res[f"reduce/{{level}}/{{b}}/{{n}}"] = mpi.reduce_tensor(x, root=1, comm=c, backend=b)
    res["calls"] = dict(calls, k3_closed=k3_closed)

    # the staged level, as _STAGED_WORKER: closed form twice, then seeded
    constants.set("use_staged_collectives", True)
    big = torch.stack([torch.full((700,), float(r)) for r in mine])
    out = mpi.ring.allreduce_tensor(big, comm=hcomm)
    assert (out == p * (p - 1) / 2).all(), out
    out2 = mpi.ring.allreduce_tensor(out, comm=hcomm)
    assert (out2 == p * p * (p - 1) / 2).all(), out2
    res["plan_staged"] = compiler.compile_collective(
        "allreduce", (p, 700), torch.float32, hcomm, backend="ring").plan.generator
    xs = torch.from_numpy(np.random.default_rng(1).standard_normal((p, 70001)).astype(
        np.float32)[mine])
    for b in ("ring", "kernel"):
        res[f"staged/{{b}}"] = eager.run_hierarchical_allreduce(
            xs, hcomm, impl="staged", staged_intra=b)
    constants.set("use_staged_collectives", False)

    # the scalar collectives, as _SCALAR_WORKER
    assert mpi.broadcast_scalar(100 + pid, root=1) == 101
    assert mpi.allreduce_scalar(10.5 + pid) == sum(10.5 + q for q in range(nproc))
    r = mpi.reduce_scalar(3 + pid, root=0)
    assert r == (sum(3 + q for q in range(nproc)) if pid == 0 else 3 + pid), r
    s = mpi.sendreceive_scalar(40 + pid, src=1, dst=0)
    assert s == (41 if pid == 0 else 40 + pid), s
    assert mpi.sendreceive_scalar(50 + pid, src=0, dst=1) == 50 + (pid != 1) * pid
    assert isinstance(mpi.allreduce_scalar(2), int)

    # alltoall and sendreceive across the processes: the closed form
    a2a = torch.stack([100.0 * r + torch.arange(float(p)) for r in mine])[:, :, None]
    for b in ("xla", "ring", "kernel"):
        out = mpi.alltoall_tensor(a2a.expand(L, p, 8).contiguous(), comm=gcomm, backend=b)
        want = 100.0 * torch.arange(float(p))[None, :, None] + torch.tensor(mine)[:, None, None]
        assert torch.equal(out, want.expand(L, p, 8)), (b, out)
        x = torch.stack([torch.full((64,), float(r)) for r in mine])
        out = mpi.sendreceive_tensor(x, p - 1, 0, comm=gcomm, backend=b)
        assert all((row == (p - 1 if r == 0 else r)).all() for r, row in zip(mine, out)), (b, out)

    # what this slice does not carry across processes raises, by name
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.runtime.communicator import split_by_keys
    spanning = split_by_keys(gcomm, lambda r: str(r % 2))  # each group in both processes
    for fn in (lambda: eager.run_hierarchical_allreduce(torch.ones((L, 256)), spanning,
                                                        impl="staged", staged_intra="ring"),
               lambda: AllReduceSGDEngine(lambda prm, st, b: (0.0, st), {{"w": torch.ones(8)}},
                                          model_state={{"mean": torch.zeros(4)}},
                                          param_sharding="fsdp")):
        try:
            fn()
        except NotImplementedError as e:
            assert "ROADMAP A13's rest" in str(e), e
        else:
            raise AssertionError("no NotImplementedError")
    try:
        mpi.allreduce_tensor(torch.ones((p, 8)))
    except CollectiveArgumentError as e:
        assert f"this process's rank count ({{L}}" in str(e), e
    else:
        raise AssertionError("a [p, ...] tensor passed")
    mpi.barrier()
    mpi.stop()

    # config 1 for a few steps under both spans
    from torchmpi_tpu_torch import nn as mpinn
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import LeNet, init_params, make_loss_fn
    from torchmpi_tpu_torch.utils import DistributedIterator, synthetic_mnist

    (xtr, ytr), _ = synthetic_mnist(num_train=2048, num_test=64)
    for ici in (True, False):
        start(with_ici_groups=ici)
        comm = mpi.current_communicator()
        model = LeNet()
        eng = AllReduceSGDEngine(make_loss_fn(model), init_params(model, seed=0), lr=0.2,
                                 comm=comm, rank_map="loop")
        it = DistributedIterator(xtr, ytr, 336, p, device="cpu")
        res[f"lenet/{{ici}}/losses"] = [float(eng.step(b)) for _, b in zip(range(STEPS), iter(it))]
        mpinn.check_with_allreduce(eng.params, comm)
        res[f"lenet/{{ici}}/params"] = {{k: v.clone() for k, v in eng.params.items()}}
        mpi.stop()
    torch.save(res, f"{{out_dir}}/proc{{pid}}.pt")
    print(f"proc {{pid}} OK")
    """
).format(repo=str(_REPO), L=L, SIZES=SIZES, steps=LENET_STEPS)

_CLOSED_WORKER = textwrap.dedent(
    """
    import sys
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    sys.path.insert(0, {repo!r})
    import torch
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import constants

    mpi.start(ranks=2, device="cpu", coordinator_address=f"localhost:{{port}}",
              num_processes=nproc, process_id=pid)
    constants.set("small_allreduce_size_cpu", 0)
    p = mpi.size()
    assert p == 2 * nproc and mpi.current_communicator().num_nodes() == nproc
    for c in (mpi.stack().at(0), mpi.stack().at(1)):
        x = torch.stack([torch.full((700,), float(r)) for r in c.local_ranks])
        for b in ("xla", "ring", "kernel"):
            assert (mpi.allreduce_tensor(x, comm=c, backend=b) == p * (p - 1) / 2).all()
    mpi.stop()
    print(f"proc {{pid}} OK")
    """
).format(repo=str(_REPO))

_LAUNCHED = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, {repo!r})
    import torch
    import torchmpi_tpu_torch as mpi

    mpi.start()  # no arguments: the launcher's environment gives the world
    p = mpi.size()
    assert p == 4 and mpi.num_processes() == 2, p
    comm = mpi.current_communicator()
    x = torch.stack([torch.full((8,), float(r)) for r in comm.local_ranks])
    assert (mpi.allreduce_tensor(x) == p * (p - 1) / 2).all()
    print(f"launched rank={{mpi.rank()}} OK")
    mpi.stop()
    """
).format(repo=str(_REPO))


def _run_workers(tmp_path, source: str, nproc: int = NPROC, timeout: float = 240) -> list:
    worker = tmp_path / "worker.py"
    worker.write_text(source)
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), str(nproc), str(port), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(nproc)
    ]
    outs = []
    for proc in procs:
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process workers timed out")
        outs.append(out)
    for i, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i} OK" in out
    return outs


@pytest.fixture(scope="module")
def worker_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp")
    _run_workers(tmp, _WORKER)
    return [torch.load(tmp / f"proc{i}.pt") for i in range(NPROC)]


def _payload(n: int) -> torch.Tensor:
    rng = np.random.default_rng(0)
    for m in SIZES:
        x = torch.from_numpy(rng.standard_normal((P, m)).astype(np.float32))
        if m == n:
            return x
    raise KeyError(n)


@pytest.fixture(scope="module")
def one_process():
    """The one-process port on the same [p, n] payloads and levels."""
    tmpi.start(ranks=P, device="cpu")
    try:
        tmpi.push_communicator(lambda r: f"host{r // L} ici group", name="per-node ici groups")
        tmpi.set_collective_span(0, 1)
        constants.set("small_allreduce_size_cpu", 0)
        constants.set("small_broadcast_size_cpu", 0)
        comms = {"global": tmpi.stack().at(0), "node": tmpi.stack().at(1)}
        res = {}
        for n in SIZES:
            x = _payload(n)
            for level, c in comms.items():
                for b in BACKENDS:
                    res[f"allreduce/{level}/{b}/{n}"] = tmpi.allreduce_tensor(x, comm=c, backend=b)
                    res[f"broadcast/{level}/{b}/{n}"] = tmpi.broadcast_tensor(
                        x, root=P - 1, comm=c, backend=b)
                    res[f"reduce/{level}/{b}/{n}"] = tmpi.reduce_tensor(x, root=1, comm=c,
                                                                        backend=b)
        constants.set("use_staged_collectives", True)
        xs = torch.from_numpy(np.random.default_rng(1).standard_normal((P, 70001)).astype(
            np.float32))
        from torchmpi_tpu_torch.collectives import eager

        for b in ("ring", "kernel"):
            res[f"staged/{b}"] = eager.run_hierarchical_allreduce(
                xs, comms["node"], impl="staged", staged_intra=b)
        return res
    finally:
        tmpi.stop()
        constants._reset_for_tests()


def _rows(full: torch.Tensor, proc: int) -> torch.Tensor:
    return full[proc * L:(proc + 1) * L]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("op", ("allreduce", "broadcast", "reduce"))
def test_seeded_bitwise_one_process(worker_results, one_process, op, level, backend, n):
    """Every process's rows are the one-process port's rows of the same
    [p, n], bit for bit."""
    key = f"{op}/{level}/{backend}/{n}"
    for proc, res in enumerate(worker_results):
        assert torch.equal(res[key], _rows(one_process[key], proc)), (key, proc)


@pytest.mark.parametrize("intra", ("ring", "kernel"))
def test_staged_bitwise_one_process(worker_results, one_process, intra):
    """The staged level's host hop across processes: each process sums the
    representatives it owns, the partials summed in process order."""
    key = f"staged/{intra}"
    for proc, res in enumerate(worker_results):
        assert torch.equal(res[key], _rows(one_process[key], proc))


def test_per_node_and_staged_plans(worker_results):
    """The per-node level takes a two-level plan, and the staged plan once
    ``use_staged_collectives`` declares the inter link host-staged."""
    for res in worker_results:
        assert res["plan_node_ring"] == "hier"
        assert res["plan_staged"] == "staged"


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("backend", ("xla", "ring"))
def test_chosen_plan_equals_jax_on_the_same_topology(worker_results, backend, n):
    """The per-node level of a 2-process job (two groups of two, 2 nodes
    counted as processes) is the topology the JAX compiler declares for
    two controller processes of two devices; the plan the port's compiler
    chooses there is the JAX compiler's (the same plan_id)."""
    from torchmpi_tpu import constants as jconstants
    from torchmpi_tpu.schedule import compiler as jcompiler
    from torchmpi_tpu.schedule import topology as jtopology

    jtopo = jtopology.Topology(platform="cpu", group_sizes=(L,) * NPROC, cartesian=True,
                               nodes=NPROC, name="per-node ici groups")
    jconstants.set("small_allreduce_size_cpu", 0)
    try:
        plan, _ = jcompiler.select_plan("allreduce", n, 4, jtopo, backend, "full", True)
    finally:
        jconstants._reset_for_tests()
    for res in worker_results:
        assert res["topology"] == jtopo.fingerprint()
        assert res[f"plan/{backend}/{n}"] == plan.plan_id


def test_kernel_backend_runs_cross_process_kernels(worker_results):
    """The kernel backend's flat allreduce and broadcast run the
    cross-process K3 and K7 (their plain versions on the CPU): one K3 per
    flat kernel allreduce, one K7 per flat kernel broadcast."""
    for res in worker_results:
        calls = res["calls"]
        # the closed form: one flat kernel allreduce on the global level
        assert calls["k3_closed"] == 1
        # then one flat kernel allreduce and broadcast a size
        assert calls["k3"] == 1 + len(SIZES)
        assert calls["k7"] == len(SIZES)


@pytest.fixture(scope="module")
def jax_results():
    """The JAX package single-controller on jax.devices()[:4], with the
    same per-node level pushed."""
    import jax

    import torchmpi_tpu as jmpi
    from torchmpi_tpu import constants as jconstants

    jmpi.start(devices=jax.devices()[:P])
    try:
        jmpi.push_communicator(lambda r: f"host{r // L} ici group", name="per-node ici groups")
        jmpi.set_collective_span(0, 1)
        jconstants.set("small_allreduce_size_cpu", 0)
        comms = {"global": jmpi.stack().at(0), "node": jmpi.stack().at(1)}
        res = {}
        for n in SIZES:
            x = _payload(n).numpy()
            for level, c in comms.items():
                for b in ("xla", "ring"):
                    ns = jmpi.xla if b == "xla" else jmpi.ring
                    res[f"{level}/{b}/{n}"] = np.asarray(
                        ns.allreduce_tensor(jax.numpy.asarray(x), comm=c))
        return res
    finally:
        jmpi.stop()
        jconstants._reset_for_tests()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("level", LEVELS)
def test_seeded_allreduce_matches_jax(worker_results, jax_results, level, backend, n):
    """Within JAX_RTOL of the JAX single-controller allreduce of the same
    payload (the ring bit for bit, as the one-process port's is)."""
    want = jax_results[f"{level}/{'ring' if backend == 'ring' else 'xla'}/{n}"]
    for proc, res in enumerate(worker_results):
        got = res[f"allreduce/{level}/{backend}/{n}"].numpy()
        ref = want[proc * L:(proc + 1) * L]
        if backend == "ring":
            assert np.array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=JAX_RTOL, atol=JAX_RTOL)


@pytest.fixture(scope="module")
def lenet_one_process():
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import LeNet, init_params, make_loss_fn
    from torchmpi_tpu_torch.utils import DistributedIterator, synthetic_mnist

    (xtr, ytr), _ = synthetic_mnist(num_train=2048, num_test=64)
    out = {}
    for ici in (True, False):
        tmpi.start(ranks=P, device="cpu")
        try:
            if ici:
                tmpi.push_communicator(lambda r: f"host{r // L} ici group")
                tmpi.set_collective_span(0, 1)
            comm = tmpi.current_communicator()
            model = LeNet()
            eng = AllReduceSGDEngine(make_loss_fn(model), init_params(model, seed=0), lr=0.2,
                                     comm=comm, rank_map="loop")
            it = DistributedIterator(xtr, ytr, 336, P, device="cpu")
            losses = [float(eng.step(b)) for _, b in zip(range(LENET_STEPS), iter(it))]
            out[ici] = (losses, {k: v.clone() for k, v in eng.params.items()})
        finally:
            tmpi.stop()
    return out


@pytest.mark.parametrize("ici", (True, False), ids=("per-node-span", "flat"))
def test_config1_lenet_equals_one_process(worker_results, lenet_one_process, ici):
    """Config 1's LeNet steps across two processes: the losses and every
    process's parameter rows equal the one-process run's under the same
    span, bit for bit."""
    losses, params = lenet_one_process[ici]
    for proc, res in enumerate(worker_results):
        assert res[f"lenet/{ici}/losses"] == losses
        for k, v in params.items():
            assert torch.equal(res[f"lenet/{ici}/params"][k], _rows(v, proc)), k


def test_launcher_runs_unmodified_script(tmp_path):
    """``python -m torchmpi_tpu_torch.launch`` makes an unmodified
    ``start()`` script process i of 2, with per-rank logs."""
    worker = tmp_path / "worker.py"
    worker.write_text(_LAUNCHED)
    log_dir = tmp_path / "logs"
    proc = subprocess.run(
        [sys.executable, "-m", "torchmpi_tpu_torch.launch", "--nproc", "2", "--cpu-devices",
         "2", "--log-dir", str(log_dir), str(worker)],
        cwd=str(_REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:]
    logs = (log_dir / "rank_0.log").read_text() + (log_dir / "rank_1.log").read_text()
    for rank in (0, 2):  # the first rank of each process
        assert f"launched rank={rank} OK" in logs


def test_launcher_runs_unmodified_mnist_twin():
    """The ``mnist_allreduce`` twin, unmodified, as 2 processes of 2 CPU
    ranks: both finish one epoch on the same loss and pass
    ``check_with_allreduce`` across the processes."""
    proc = subprocess.run(
        [sys.executable, "-m", "torchmpi_tpu_torch.launch", "--nproc", "2", "--cpu-devices",
         "2", "-m", "torchmpi_tpu_torch.examples.mnist_allreduce", "--", "--epochs", "1"],
        cwd=str(_REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:]
    lines = proc.stdout.splitlines()
    finals = [line.split("final: ")[1].split(" test_acc")[0] for line in lines
              if "final: " in line]
    assert len(finals) == 2 and finals[0] == finals[1], finals
    assert sum("check_with_allreduce: ok" in line for line in lines) == 2
    assert sum("ranks=4 device=cpu" in line for line in lines) == 2


def test_start_reads_the_launcher_environment(monkeypatch):
    """A coordinator without its companions raises with the JAX text."""
    monkeypatch.setenv("TORCHMPI_TPU_COORDINATOR", "localhost:1")
    monkeypatch.delenv("TORCHMPI_TPU_NUM_PROCESSES", raising=False)
    with pytest.raises(ValueError, match="TORCHMPI_TPU_NUM_PROCESSES is missing"):
        tmpi.start(ranks=2, device="cpu")
    assert not tmpi.started()


def test_launcher_a10_flags_raise():
    from torchmpi_tpu_torch import launch

    for flag in ("--elastic", "--supervise", "--telemetry-live"):
        with pytest.raises(NotImplementedError, match="ROADMAP A10's rest"):
            launch.main(["--nproc", "2", flag, "x.py"])


@pytest.mark.slow
@pytest.mark.parametrize("nproc", [3, 4])
def test_multiprocess_closed_form(tmp_path, nproc):
    _run_workers(tmp_path, _CLOSED_WORKER, nproc=nproc)


@pytest.mark.slow
def test_launcher_kills_survivors_and_propagates_exit(tmp_path):
    crasher = tmp_path / "crasher.py"
    crasher.write_text(
        "import os, sys, time\n"
        "if os.environ['TORCHMPI_TPU_PROCESS_ID'] == '1':\n"
        "    sys.exit(7)\n"
        "time.sleep(120)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-m", "torchmpi_tpu_torch.launch", "--nproc", "2", "--cpu-devices",
         "1", str(crasher)],
        cwd=str(_REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)  # far below the survivor's sleep: proves the kill
    assert proc.returncode == 7, proc.stdout[-1000:]


@pytest.mark.slow
def test_launcher_multihost_contract(tmp_path):
    """Two launchers with --nnodes 2 --node-rank {0,1} and one
    --coordinator are one job."""
    worker = tmp_path / "worker.py"
    worker.write_text(_LAUNCHED)
    port = _free_port()
    launchers = [
        subprocess.Popen(
            [sys.executable, "-m", "torchmpi_tpu_torch.launch", "--nproc", "1",
             "--cpu-devices", "2", "--nnodes", "2", "--node-rank", str(nr),
             "--coordinator", f"localhost:{port}", str(worker)],
            cwd=str(_REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for nr in (0, 1)
    ]
    outs = []
    for p in launchers:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in launchers:
                q.kill()
            pytest.fail("multi-launcher job timed out")
        outs.append(out)
    for nr, (p, out) in enumerate(zip(launchers, outs)):
        assert p.returncode == 0, f"node {nr} failed:\n{out[-2000:]}"
    assert "launched rank=0 OK" in outs[0]
    assert "launched rank=2 OK" in outs[1]


@pytest.mark.slow
def test_launcher_maps_signal_death_to_128_plus_signum(tmp_path):
    killer = tmp_path / "killer.py"
    killer.write_text(
        "import os, signal, time\n"
        "if os.environ['TORCHMPI_TPU_PROCESS_ID'] == '1':\n"
        "    os.kill(os.getpid(), signal.SIGKILL)\n"
        "time.sleep(120)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-m", "torchmpi_tpu_torch.launch", "--nproc", "2", "--cpu-devices",
         "1", str(killer)],
        cwd=str(_REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)
    assert proc.returncode == 137, (proc.returncode, proc.stdout[-500:])
