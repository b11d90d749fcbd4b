"""Allgather, reduce-scatter, the sharded engine and the cooperative
checkpoint with the port's ranks spread over real processes, on the CPU.

Two worker processes of two ranks each (``start(coordinator_address=...)``,
``device='cpu'``: the control plane's gloo group, the lanes' POSIX shared
memory and the plain versions of the cross-process K3 'rs' and 'ag') run,
once for the module, on inputs this module draws from numpy seeds and
hands them in a file:

- allgather and reduce-scatter on ``xla``, ``ring`` and ``kernel``, on
  the global level and on the per-node level ``start()`` pushes, at
  widths that include a ragged one and a payload of three dims, and on
  the kernel backend over bf16, int16 and bool. Every process's rows must
  equal the one-process port's rows of the same ``[p, ...]`` bit for bit,
  and the f32 results must lie within ``JAX_RTOL`` of the JAX package's
  single-controller run on ``jax.devices()[:4]`` (its reduce-scatter
  adds in another order; the ``ring`` backend and every allgather are
  held bit for bit);
- what still raises across processes, by name: alltoall, sendreceive
  and a model state under fsdp;
- config 1's LeNet (batch 336, lr 0.2, flax-shaped weights from a numpy
  seed) under fsdp and zero1 with ``accum_steps`` 1 and 2 (fsdp's with
  ``remat``) for
  ``LENET_STEPS`` steps on the flat span, the selector pinned to the
  kernel rings (the card's choice). Losses and parameters must equal the
  one-process run's under the same mode bit for bit (``rank_map='loop'``,
  as in ``tests/test_torch_multiprocess.py``), and lie within the
  tolerance ``tests/test_torch_sharded.py`` holds against the JAX engine:
  losses rtol 1e-4, parameters rtol 1e-4 and atol 1e-6 (the JAX
  ``accum_steps=1`` run for both microbatch counts: the step's gradient is
  the same mean);
- the port's twin of ``_CKPT_WORKER`` (``tests/test_multiprocess.py:
  171-217``): MLP6 at ``features=8*p`` under fsdp through
  ``train_resident``, ``save_engine``, a fresh engine, ``restore_engine``
  and a resumed epoch, bit for bit where the JAX test asks rtol 1e-5; the
  same state saved by ``save_engine_sharded`` must be byte for byte, file
  by file, what one process writes, and restore onto a one-process p=4
  engine that resumes bit for bit; ``checkpoint_every`` saves on the step
  thread.

Plain-version tests of the two new forms run in this process.

Config 1 under the default ``rank_map='vmap'`` by 2 processes x 2 must be
the one-process p=4 vmap run bit for bit over ``C6_STEPS`` steps at
``C6_THREADS`` intra-op threads (ROADMAP C6).
``PYTHONPATH=. python tests/test_torch_xproc_sharded.py --vmap-drift N`` measures ROADMAP
C's probe: config 1 (replicated, ``rank_map='vmap'``) by 2 processes x 2
against the one-process p=4 vmap run over N steps (``--threads T``
intra-op threads in every process, 2 by default), and prints the largest
relative loss difference and parameter difference.
"""

import json
import subprocess
import sys
import textwrap
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
RS_SHAPES = ((700,), (70004,), (3, 28))  # the last dim divides by P
AG_SHAPES = ((700,), (70001,), (3, 7))
BACKENDS = ("xla", "ring", "kernel")
LEVELS = ("global", "node")
EXTRA_DTYPES = (torch.bfloat16, torch.int16, torch.bool)
JAX_RTOL = 1e-6
LENET_STEPS = 3
LENET_BATCH = 336
LR = 0.2
RUNS = (("fsdp", 1), ("fsdp", 2), ("zero1", 1), ("zero1", 2))
REMAT = ("fsdp", 2)  # the run that also recomputes its forward in the backward
MLP_BATCH = 8  # a rank's batch in the checkpoint twin
C6_STEPS, C6_THREADS = 8, 4  # ROADMAP C6's test: vmap across processes, bit for bit
# the errors a worker must meet, each naming its part of ROADMAP A13's rest
RAISES = {"staged_span": 10, "stateful_fsdp": 9}
MOVES = ("alltoall", "sendreceive")  # run on the interleaved communicator

_WORKER = textwrap.dedent(
    """
    import os, sys
    from pathlib import Path
    pid, nproc, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    os.environ["TORCHMPI_TPU_CHECKPOINT_STATE"] = f"{{out_dir}}/registry{{pid}}.json"
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import constants
    from torchmpi_tpu_torch.engine import SGD, AllReduceSGDEngine

    torch.set_num_threads(2)  # as the tests' process (_two_threads)
    from torchmpi_tpu_torch.models import MLP6, LeNet, init_params, make_loss_fn
    from torchmpi_tpu_torch.ops import ring_kernels
    from torchmpi_tpu_torch.utils import checkpoint

    L, STEPS, BATCH, LR, RUNS, MLP_BATCH = {L}, {steps}, {batch}, {lr}, {runs}, {mlp_batch}
    REMAT = {remat}
    inputs = torch.load(f"{{out_dir}}/inputs.pt")
    calls = {{"rs": 0, "ag": 0}}
    real_rs, real_ag = ring_kernels.ring_reduce_scatter_xproc, ring_kernels.ring_allgather_xproc

    def rs(*a, **kw):
        calls["rs"] += 1
        return real_rs(*a, **kw)

    def ag(*a, **kw):
        calls["ag"] += 1
        return real_ag(*a, **kw)

    ring_kernels.ring_reduce_scatter_xproc, ring_kernels.ring_allgather_xproc = rs, ag

    def start(**kw):
        mpi.start(ranks=L, device="cpu", coordinator_address=f"localhost:{{port}}",
                  num_processes=nproc, process_id=pid, **kw)

    res = {{}}
    start()
    gcomm, hcomm = mpi.stack().at(0), mpi.stack().at(1)
    p, mine = gcomm.size, gcomm.local_ranks
    constants.set("small_allreduce_size_cpu", 0)
    constants.set("small_broadcast_size_cpu", 0)
    for key, full in inputs["payloads"].items():
        op, dtype = key.split("/")[0], key.split("/")[1]
        fn = mpi.reducescatter_tensor if op == "rs" else mpi.allgather_tensor
        x = full[mine]
        for level, c in (("global", gcomm), ("node", hcomm)):
            for b in ("xla", "ring", "kernel"):
                if dtype != "float32" and (b != "kernel" or level != "global"):
                    continue
                res[f"{{key}}/{{level}}/{{b}}"] = fn(x, comm=c, backend=b)
    res["calls"] = dict(calls)

    # a communicator whose ranks interleave the processes (rank r in process
    # r % nproc): a process's rows, and the segments it owns, are not
    # consecutive ranks
    from torchmpi_tpu_torch.runtime.communicator import Communicator
    icomm = Communicator(list(range(p)), gcomm.device, ["all"] * p, name="interleaved",
                         processes=[r % nproc for r in range(p)], process_index=pid)
    for key, full in inputs["payloads"].items():
        fn = mpi.reducescatter_tensor if key.startswith("rs") else mpi.allgather_tensor
        for b in ("ring", "kernel"):
            res[f"{{key}}/interleaved/{{b}}"] = fn(full[icomm.local_ranks], comm=icomm,
                                                   backend=b)

    # alltoall and sendreceive on the interleaved ranks
    a2a = torch.arange(p * p * 3, dtype=torch.float32).reshape(p, p, 3)[icomm.local_ranks]
    for b in ("ring", "kernel"):
        res[f"moves/alltoall/{{b}}"] = mpi.alltoall_tensor(a2a, comm=icomm, backend=b)
        res[f"moves/sendreceive/{{b}}"] = mpi.sendreceive_tensor(a2a, 1, 2, comm=icomm, backend=b)

    # what still raises across processes, each naming its part
    from torchmpi_tpu_torch.collectives import eager
    from torchmpi_tpu_torch.runtime.communicator import split_by_keys
    spanning = split_by_keys(gcomm, lambda r: str(r % 2))  # each group in both processes
    raised = {{}}
    model = MLP6(features=8 * p)
    params = init_params(model, seed=0)
    for name, fn in (
            ("staged_span", lambda: eager.run_hierarchical_allreduce(
                torch.ones((L, 256)), spanning, impl="staged", staged_intra="ring")),
            ("stateful_fsdp", lambda: AllReduceSGDEngine(
                lambda prm, st, b: (0.0, st), params, model_state={{"mean": torch.zeros(4)}},
                param_sharding="fsdp"))):
        try:
            fn()
        except NotImplementedError as e:
            raised[name] = str(e)
    res["raised"] = raised
    mpi.barrier()
    mpi.stop()

    # config 1 under the sharded modes on the flat span, the kernel rings
    mpi.collectives.selector.select = lambda *a, **k: "kernel"
    xtr, ytr = inputs["mnist"]
    for mode, k in RUNS:
        start(with_ici_groups=False)
        comm = mpi.current_communicator()
        eng = AllReduceSGDEngine(make_loss_fn(LeNet()), inputs["lenet"], lr=LR, comm=comm,
                                 rank_map="loop", param_sharding=mode, accum_steps=k,
                                 remat=(mode, k) == REMAT)
        before, losses, growths = dict(calls), [], []
        for i in range(STEPS):
            losses.append(float(eng.step((xtr[i * BATCH:(i + 1) * BATCH],
                                          ytr[i * BATCH:(i + 1) * BATCH]))))
            growths.append(mpi.runtime_state.plane().lane(comm).growths)
        res[f"lenet/{{mode}}/{{k}}"] = {{
            "losses": losses, "rs": calls["rs"] - before["rs"],
            "ag": calls["ag"] - before["ag"], "growths": growths,
            "params": eng.gathered_params()}}
        mpi.stop()

    # the twin of _CKPT_WORKER, then the sharded save and checkpoint_every
    start(with_ici_groups=False)
    ck = Path(out_dir)
    mx, my = inputs["mlp_data"]

    def build():
        return AllReduceSGDEngine(make_loss_fn(model), params, optimizer=SGD(0.1),
                                  param_sharding="fsdp", rank_map="loop")

    eng = build()
    st0 = eng.train_resident(mx, my, MLP_BATCH, max_epochs=1, shuffle=False)
    ev0 = eng.evaluate(lambda prm, xb: torch.func.functional_call(model, prm, (xb,)),
                       mx[:64], my[:64], lambda out, yb: out.mean())
    checkpoint.save_engine(ck / "single", eng, step=1)
    data_dir = checkpoint.save_engine_sharded(ck / "sharded", eng, step=1)
    checkpoint.save_engine_sharded(ck / "world2", eng, step=1, world=2)
    mpi.barrier()
    eng2 = build()
    meta = checkpoint.restore_engine(ck / "single", eng2)
    assert meta["step"] == 1
    a = eng.train_resident(mx, my, MLP_BATCH, max_epochs=1, shuffle=False, seed=3)
    b = eng2.train_resident(mx, my, MLP_BATCH, max_epochs=1, shuffle=False, seed=3)
    eng3 = build()
    checkpoint.restore_engine_sharded(ck / "sharded", eng3)
    c = eng3.train_resident(mx, my, MLP_BATCH, max_epochs=1, shuffle=False, seed=3)
    res["ckpt"] = {{
        "st0": st0["losses"], "eval": ev0, "a": a["losses"], "b": b["losses"],
        "c": c["losses"],
        "a_params": eng.gathered_params(), "b_params": eng2.gathered_params(),
        "c_params": eng3.gathered_params(), "data_dir": data_dir.name}}
    eng.checkpoint_every(1, ck / "every")
    eng.step((mx[:MLP_BATCH * p], my[:MLP_BATCH * p]))
    res["every"] = checkpoint.read_sharded_meta(ck / "every")["step"]
    mpi.barrier()
    mpi.stop()
    torch.save(res, f"{{out_dir}}/proc{{pid}}.pt")
    print(f"proc {{pid}} OK")
    """
).format(repo=str(_REPO), L=L, steps=LENET_STEPS, batch=LENET_BATCH, lr=LR, runs=RUNS,
         mlp_batch=MLP_BATCH, remat=REMAT)


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


def _payloads() -> dict:
    """Seeded ``[p, ...]`` payloads, keyed ``op/dtype/shape``."""
    rng = np.random.default_rng(0)
    out = {}
    for op, shapes in (("rs", RS_SHAPES), ("ag", AG_SHAPES)):
        for shape in shapes:
            out[f"{op}/float32/{shape}"] = torch.from_numpy(
                rng.standard_normal((P,) + shape).astype(np.float32))
        for dtype in EXTRA_DTYPES:
            vals = rng.integers(-4, 5, (P,) + shapes[0])
            t = torch.from_numpy(vals.astype(np.float32)).to(dtype)
            out[f"{op}/{str(dtype).split('.')[1]}/{shapes[0]}"] = t
    return out


def _mnist():
    from torchmpi_tpu_torch.utils import synthetic_mnist

    (x, y), _ = synthetic_mnist(num_train=LENET_BATCH * LENET_STEPS, num_test=1)
    return torch.as_tensor(x), torch.as_tensor(y)


def _mlp_data():
    from torchmpi_tpu_torch.utils import synthetic_mnist

    (x, y), _ = synthetic_mnist(num_train=256, num_test=1)
    return torch.as_tensor(x), torch.as_tensor(y)


def _run_workers(tmp_path, source: str, nproc: int = NPROC, timeout: float = 300,
                 args=()) -> list:
    worker = tmp_path / "worker.py"
    worker.write_text(source)
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), str(nproc), str(port), str(tmp_path),
             *map(str, args)],
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
def inputs():
    from torchmpi_tpu_torch.models import from_jax_params

    jp = _lenet_jax_weights()
    return {"payloads": _payloads(), "mnist": _mnist(), "lenet_jax": jp,
            "lenet": from_jax_params(jp), "mlp_data": _mlp_data()}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory, inputs):
    tmp = tmp_path_factory.mktemp("xproc")
    torch.save({k: v for k, v in inputs.items() if k != "lenet_jax"}, tmp / "inputs.pt")
    _run_workers(tmp, _WORKER)
    return tmp


@pytest.fixture(scope="module")
def worker_results(workdir):
    return [torch.load(workdir / f"proc{i}.pt") for i in range(NPROC)]


def _rows(full: torch.Tensor, proc: int) -> torch.Tensor:
    return full[proc * L:(proc + 1) * L]


def _start_one(**kw):
    tmpi.start(ranks=P, device="cpu", **kw)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, as each worker takes (two processes share the
    host's cores): ATen's convolutions and products round by how they
    split over threads, so the bitwise comparisons need the same count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _kernel_selector():
    """The port's selector pinned to the card's choice, the kernel rings
    (their plain versions on the CPU), as the workers pin it; the module's
    collectives name their backends."""
    mp = pytest.MonkeyPatch()
    mp.setattr(tmpi.collectives.selector, "select", lambda *a, **k: "kernel")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def one_process(inputs):
    """The one-process port on the same payloads and levels."""
    _start_one()
    try:
        tmpi.push_communicator(lambda r: f"host{r // L} ici group", name="per-node ici groups")
        tmpi.set_collective_span(0, 1)
        constants.set("small_allreduce_size_cpu", 0)
        constants.set("small_broadcast_size_cpu", 0)
        comms = {"global": tmpi.stack().at(0), "node": tmpi.stack().at(1)}
        res = {}
        for key, x in inputs["payloads"].items():
            fn = tmpi.reducescatter_tensor if key.startswith("rs") else tmpi.allgather_tensor
            for level, c in comms.items():
                for b in BACKENDS:
                    res[f"{key}/{level}/{b}"] = fn(x, comm=c, backend=b)
        return res
    finally:
        tmpi.stop()
        constants._reset_for_tests()


def _keys(op):
    shapes = RS_SHAPES if op == "rs" else AG_SHAPES
    keys = [f"{op}/float32/{s}/{lv}/{b}" for s in shapes for lv in LEVELS for b in BACKENDS]
    keys += [f"{op}/{str(d).split('.')[1]}/{shapes[0]}/global/kernel" for d in EXTRA_DTYPES]
    return keys


@pytest.mark.parametrize("op", ("rs", "ag"))
def test_interleaved_processes_bitwise_one_process(worker_results, one_process, op):
    """On a communicator whose ranks alternate between the processes, each
    process's rows (ranks ``r % 2 == proc``, not consecutive) of the
    ``ring`` and ``kernel`` results are the one-process rows of those
    ranks, every payload and dtype, bit for bit."""
    keys = [k for k in one_process if k.startswith(op) and k.endswith("/global/kernel")]
    for proc, res in enumerate(worker_results):
        rows = [r for r in range(P) if r % NPROC == proc]
        for key in keys:
            base = key.rsplit("/", 2)[0]
            for b in ("ring", "kernel"):
                got, want = res[f"{base}/interleaved/{b}"], one_process[f"{base}/global/{b}"]
                assert torch.equal(got, want[rows]), (base, b, proc)


@pytest.mark.parametrize("key", _keys("rs") + _keys("ag"))
def test_bitwise_one_process(worker_results, one_process, key):
    """Every process's rows are the one-process port's rows of the same
    ``[p, ...]``, bit for bit, dtype and all."""
    for proc, res in enumerate(worker_results):
        got, want = res[key], _rows(one_process[key], proc)
        assert got.dtype == want.dtype and torch.equal(got, want), (key, proc)


def test_kernel_backend_runs_the_cross_process_forms(worker_results):
    """The kernel backend's flat reduce-scatter and allgather run the
    cross-process K3 'rs' and 'ag' (their plain versions on the CPU): one a
    call on the global level, and one a reduce-scatter on the per-node
    level too (a flat plan there); the per-node allgather is the two-level
    plan, which gathers the rows."""
    n_rs, n_ag = len(RS_SHAPES), len(AG_SHAPES)
    for res in worker_results:
        assert res["calls"] == {"rs": 2 * n_rs + len(EXTRA_DTYPES),
                                "ag": n_ag + len(EXTRA_DTYPES)}


@pytest.fixture(scope="module")
def jax_results(inputs):
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
        for key, x in inputs["payloads"].items():
            if "/float32/" not in key:
                continue
            for level, c in comms.items():
                for b in ("xla", "ring"):
                    ns = jmpi.xla if b == "xla" else jmpi.ring
                    fn = ns.reducescatter_tensor if key.startswith("rs") else ns.allgather_tensor
                    res[f"{key}/{level}/{b}"] = np.asarray(fn(jax.numpy.asarray(x.numpy()),
                                                              comm=c))
        return res
    finally:
        jmpi.stop()
        jconstants._reset_for_tests()


@pytest.mark.parametrize("key", [k for k in _keys("rs") + _keys("ag") if "/float32/" in k])
def test_matches_jax(worker_results, jax_results, key):
    """Within JAX_RTOL of the JAX single-controller run of the same
    payload: the ``ring`` backend and every allgather bit for bit, the
    vendor and kernel reduce-scatters to the tolerance (another order of
    adds than the JAX ``psum_scatter``)."""
    backend = key.rsplit("/", 1)[1]
    want = jax_results[key.rsplit("/", 1)[0] + f"/{'ring' if backend == 'ring' else 'xla'}"]
    for proc, res in enumerate(worker_results):
        got, ref = res[key].numpy(), want[proc * L:(proc + 1) * L]
        assert got.shape == ref.shape
        if backend == "ring" or key.startswith("ag"):
            assert np.array_equal(got, ref), key
        else:
            np.testing.assert_allclose(got, ref, rtol=JAX_RTOL, atol=JAX_RTOL)


@pytest.mark.parametrize("name", sorted(RAISES))
def test_what_still_raises_names_its_part(worker_results, name):
    for res in worker_results:
        assert f"ROADMAP A13's rest, part {RAISES[name]}" in res["raised"][name], res["raised"]


@pytest.mark.parametrize("op", MOVES)
def test_moves_on_interleaved_ranks(worker_results, op):
    """alltoall and sendreceive (src 1, dst 2) on a communicator whose
    ranks interleave the processes, on ``ring`` and ``kernel`` (the
    lane's copies): each process's rows of the one-process result."""
    x = torch.arange(P * P * 3, dtype=torch.float32).reshape(P, P, 3)
    want = x.transpose(0, 1).contiguous() if op == "alltoall" else x.clone()
    if op == "sendreceive":
        want[2] = x[1]
    for proc, res in enumerate(worker_results):
        rows = [r for r in range(P) if r % NPROC == proc]
        for b in ("ring", "kernel"):
            assert torch.equal(res[f"moves/{op}/{b}"], want[rows]), (op, b, proc)


# --- the plain versions of the two new forms ------------------------------
_NATIVE = list(ops.ring_kernels.NATIVE_DTYPES) + [torch.bool, torch.int16]


def _native_rows(dtype, p, n, seed):
    rng = np.random.default_rng(seed)
    lo = 0 if dtype in (torch.uint8, torch.bool) else -4
    vals = rng.integers(lo, lo + 9, (p, n)) if not dtype.is_floating_point else \
        rng.standard_normal((p, n))
    return torch.from_numpy(vals.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", _NATIVE, ids=str)
@pytest.mark.parametrize("owned", [[0, 1], [2, 3], [3, 0], [1, 3, 0]], ids=str)
def test_reduce_scatter_xproc_plain_is_the_one_process_rows(dtype, owned):
    """The cross-process 'rs' plain version over a table of p rows, with
    consecutive and non-consecutive ``owned``, against the one-process
    plain 'rs' rows of those ranks (i16 and bool in their i32 carrier, as
    the lane publishes them)."""
    x = _native_rows(dtype, P, P * 37, 1)
    carrier = ops.ring_kernels.carrier_dtype(dtype)
    table = list(x.to(carrier))
    got = ops.ring_reduce_scatter_xproc_plain(table, owned).to(dtype)
    want = ops.ring_reduce_scatter_plain(x)[owned]
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(ops.ring_reduce_scatter_xproc(table, owned).to(dtype), want)


@pytest.mark.parametrize("dtype", _NATIVE + [torch.float64], ids=str)
@pytest.mark.parametrize("local", [1, 2, 3])
def test_allgather_xproc_plain_is_the_one_process_rows(dtype, local):
    """The cross-process 'ag' plain version: every local row holds every
    block in rank order, the one-process plain 'ag' rows, bytes and all
    (-0.0 survives)."""
    x = _native_rows(dtype, P, 29, 2).reshape(P, 29)
    if dtype.is_floating_point:
        x[1, 3] = -0.0
    got = ops.ring_allgather_xproc_plain(list(x), local)
    want = ops.ring_allgather_plain(x)[:local]
    assert got.shape == (local, P, 29) and torch.equal(got.view(torch.uint8),
                                                      want.view(torch.uint8))


def test_xproc_forms_check_their_arguments():
    rows = list(torch.zeros((P, 8)))
    with pytest.raises(ValueError, match="out of range"):
        ops.ring_reduce_scatter_xproc_plain(rows, [0, P])
    with pytest.raises(ValueError, match="1-D rank rows of p segments"):
        ops.ring_reduce_scatter_xproc_plain(list(torch.zeros((P, 6))), [0])
    with pytest.raises(ValueError, match="differ in shape"):
        ops.ring_allgather_xproc_plain(rows[:-1] + [torch.zeros(9)], 2)
    with pytest.raises(ValueError, match="runs on CUDA or the CPU"):
        ops.ring_allgather_xproc([torch.zeros(8, device="meta")] * P, 2)


# --- config 1 under the sharded modes -------------------------------------
@pytest.fixture(scope="module")
def lenet_one_process(inputs):
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import LeNet, make_loss_fn

    x, y = inputs["mnist"]
    out = {}
    for mode, k in RUNS:
        _start_one()
        try:
            eng = AllReduceSGDEngine(make_loss_fn(LeNet()), inputs["lenet"], lr=LR,
                                     rank_map="loop", param_sharding=mode, accum_steps=k,
                                     remat=(mode, k) == REMAT)
            losses = [float(eng.step((x[i * LENET_BATCH:(i + 1) * LENET_BATCH],
                                      y[i * LENET_BATCH:(i + 1) * LENET_BATCH])))
                      for i in range(LENET_STEPS)]
            out[(mode, k)] = (losses, eng.gathered_params())
        finally:
            tmpi.stop()
    return out


@pytest.fixture(scope="module")
def lenet_jax(inputs):
    """The JAX engine's fsdp and zero1 steps of the same batches."""
    import jax
    import optax

    import torchmpi_tpu as jmpi
    from torchmpi_tpu.engine import AllReduceSGDEngine as JEngine
    from torchmpi_tpu.models import LeNet as JLeNet
    from torchmpi_tpu.models import make_loss_fn as jloss
    from torchmpi_tpu_torch.models import from_jax_params

    x, y = (t.numpy() for t in inputs["mnist"])
    out = {}
    jmpi.start(devices=jax.devices()[:P])
    try:
        for mode in ("fsdp", "zero1"):
            eng = JEngine(jloss(JLeNet()), inputs["lenet_jax"], optimizer=optax.sgd(LR),
                          param_sharding=mode)
            losses = [float(eng.step((x[i * LENET_BATCH:(i + 1) * LENET_BATCH],
                                      y[i * LENET_BATCH:(i + 1) * LENET_BATCH])))
                      for i in range(LENET_STEPS)]
            out[mode] = (losses, from_jax_params(jax.device_get(eng.params)))
    finally:
        jmpi.stop()
    return out


@pytest.mark.parametrize("mode,k", RUNS, ids=[f"{m}-accum{k}" for m, k in RUNS])
def test_config1_sharded_equals_one_process(worker_results, lenet_one_process, mode, k):
    """Config 1 by 2 processes x 2 under fsdp or zero1: the losses and
    every process's rows of the gathered parameters equal the one-process
    run's bit for bit; each step ran the cross-process K3 'rs' once (one
    FusionBuffer flush: the sharded partials fit ``fusion_buffer_bytes``)
    and 'ag' once (fsdp's parameters, zero1's updates), and the lane's
    slabs grew in the first step only."""
    losses, params = lenet_one_process[(mode, k)]
    for proc, res in enumerate(worker_results):
        run = res[f"lenet/{mode}/{k}"]
        assert run["losses"] == losses
        for name, v in params.items():
            assert torch.equal(run["params"][name], _rows(v, proc)), name
        assert (run["rs"], run["ag"]) == (LENET_STEPS, LENET_STEPS)
        assert run["growths"] == run["growths"][:1] * LENET_STEPS


@pytest.mark.parametrize("mode,k", RUNS, ids=[f"{m}-accum{k}" for m, k in RUNS])
def test_config1_sharded_matches_the_jax_engine(worker_results, lenet_jax, mode, k):
    """Within the tolerance ``tests/test_torch_sharded.py`` holds against
    the JAX engine: losses rtol 1e-4, parameters rtol 1e-4 and atol 1e-6."""
    losses, params = lenet_jax[mode]
    for proc, res in enumerate(worker_results):
        run = res[f"lenet/{mode}/{k}"]
        np.testing.assert_allclose(run["losses"], losses, rtol=1e-4)
        for name, v in params.items():
            np.testing.assert_allclose(run["params"][name][0].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=name)


# --- the cooperative checkpoint -------------------------------------------
def _mlp_engine():
    from torchmpi_tpu_torch.engine import SGD, AllReduceSGDEngine
    from torchmpi_tpu_torch.models import MLP6, init_params, make_loss_fn

    model = MLP6(features=8 * P)
    return AllReduceSGDEngine(make_loss_fn(model), init_params(model, seed=0),
                              optimizer=SGD(0.1), param_sharding="fsdp", rank_map="loop")


def test_checkpoint_twin_resumes_bit_for_bit(worker_results):
    """``save_engine`` across processes, ``restore_engine`` into a fresh
    engine: the resumed epoch equals the original engine's bit for bit in
    every process (the JAX ``_CKPT_WORKER`` asks rtol 1e-5)."""
    for res in worker_results:
        ck = res["ckpt"]
        assert ck["a"] == ck["b"] == ck["c"]
        for k, v in ck["a_params"].items():
            assert torch.equal(ck["b_params"][k], v) and torch.equal(ck["c_params"][k], v), k


@pytest.fixture(scope="module")
def mlp_one_process(inputs, tmp_path_factory):
    """The one-process p=4 run of the twin: its first epoch, its sharded
    save of that state, and the worker's sharded checkpoint restored onto
    a fresh one-process engine and resumed."""
    from torchmpi_tpu_torch.models import MLP6
    from torchmpi_tpu_torch.supervise import checkpoints as registry
    from torchmpi_tpu_torch.utils import checkpoint

    tmp = tmp_path_factory.mktemp("one")
    x, y = inputs["mlp_data"]
    _start_one()
    try:
        eng = _mlp_engine()
        st0 = eng.train_resident(x, y, MLP_BATCH, max_epochs=1, shuffle=False)
        model = MLP6(features=8 * P)
        ev0 = eng.evaluate(lambda prm, xb: torch.func.functional_call(model, prm, (xb,)),
                           x[:64], y[:64], lambda out, yb: out.mean())
        data_dir = checkpoint.save_engine_sharded(tmp / "sharded", eng, step=1)
        world2 = checkpoint.save_engine_sharded(tmp / "world2", eng, step=1, world=2)
        return {"st0": st0["losses"], "eval": ev0, "data_dir": data_dir, "world2": world2}
    finally:
        tmpi.stop()
        registry._reset_for_tests()


def test_sharded_save_is_the_one_process_files(workdir, worker_results, mlp_one_process):
    """The two processes' sharded checkpoint holds, file by file, the
    bytes one process writes for the same state (the data directory's
    token aside), after the same first epoch bit for bit (and the same
    ``evaluate`` under fsdp)."""
    from torchmpi_tpu_torch.utils import checkpoint

    for res in worker_results:
        assert res["ckpt"]["st0"] == mlp_one_process["st0"]
        assert res["ckpt"]["eval"] == mlp_one_process["eval"]
    ours = workdir / "sharded" / worker_results[0]["ckpt"]["data_dir"]
    assert all(res["ckpt"]["data_dir"] == ours.name for res in worker_results)
    assert (workdir / "sharded" / "CURRENT").read_text().strip() == ours.name
    # the engine's world (each process its own ranks' files) and another
    # world (the shards gathered, process 0 writing every file)
    for ours, theirs, last in ((ours, mlp_one_process["data_dir"], ".rank3."),
                               (checkpoint.current_data_dir(workdir / "world2"),
                                mlp_one_process["world2"], ".rank1.")):
        names = sorted(f.name for f in theirs.iterdir())
        assert names == sorted(f.name for f in ours.iterdir())
        assert any(last in n for n in names) and "meta.json" in names
        for name in names:
            assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
        assert not list(ours.parent.glob(".tmp-*"))


def test_sharded_save_restores_onto_one_process(workdir, worker_results, mlp_one_process,
                                                inputs):
    """The two processes' sharded checkpoint restored onto a one-process
    p=4 engine resumes bit for bit the processes' resumed epoch."""
    from torchmpi_tpu_torch.utils import checkpoint

    x, y = inputs["mlp_data"]
    _start_one()
    try:
        eng = _mlp_engine()
        meta = checkpoint.restore_engine_sharded(workdir / "sharded", eng)
        assert meta["world"] == P and meta["step"] == 1
        resumed = eng.train_resident(x, y, MLP_BATCH, max_epochs=1, shuffle=False, seed=3)
        params = eng.gathered_params()
    finally:
        tmpi.stop()
    for proc, res in enumerate(worker_results):
        assert res["ckpt"]["a"] == resumed["losses"]
        for k, v in params.items():
            assert torch.equal(res["ckpt"]["a_params"][k], _rows(v, proc)), k


def test_checkpoint_every_saves_on_the_step_thread(worker_results):
    """Across processes ``checkpoint_every`` saves cooperatively before
    ``step`` returns: the checkpoint is there when the step is."""
    for res in worker_results:
        assert res["every"] == 1


# --- ROADMAP C's probe: rank_map='vmap' across processes -------------------
_DRIFT_WORKER = textwrap.dedent(
    """
    import sys
    pid, nproc, port, out_dir, steps, threads = (int(sys.argv[1]), int(sys.argv[2]),
                                                 sys.argv[3], sys.argv[4], int(sys.argv[5]),
                                                 int(sys.argv[6]))
    sys.path.insert(0, {repo!r})
    import torch
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import LeNet, make_loss_fn

    torch.set_num_threads(threads)
    mpi.collectives.selector.select = lambda *a, **k: "kernel"
    inputs = torch.load(f"{{out_dir}}/inputs.pt")
    mpi.start(ranks={L}, device="cpu", coordinator_address=f"localhost:{{port}}",
              num_processes=nproc, process_id=pid, with_ici_groups=False)
    x, y = inputs["mnist"]
    eng = AllReduceSGDEngine(make_loss_fn(LeNet()), inputs["lenet"], lr={lr}, rank_map="vmap")
    n = len(x) // {batch}
    losses = [float(eng.step((x[(i % n) * {batch}:(i % n + 1) * {batch}],
                              y[(i % n) * {batch}:(i % n + 1) * {batch}])))
              for i in range(steps)]
    torch.save({{"losses": losses, "params": dict(eng.params)}}, f"{{out_dir}}/proc{{pid}}.pt")
    mpi.stop()
    print(f"proc {{pid}} OK")
    """
).format(repo=str(_REPO), L=L, lr=LR, batch=LENET_BATCH)


def vmap_drift(tmp_path: Path, inputs: dict, steps: int, threads: int = 2) -> dict:
    """Config 1 (replicated, ``rank_map='vmap'``) by 2 processes x 2
    against the one-process p=4 vmap run over ``steps`` steps of the same
    batches, every process on ``threads`` intra-op threads and the
    selector pinned to the kernel rings on both sides: the largest
    relative loss difference, the step it is first nonzero at, the largest
    parameter difference, and whether every parameter lies within rtol
    1e-4, atol 1e-6."""
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import LeNet, make_loss_fn

    torch.save({k: inputs[k] for k in ("mnist", "lenet")}, tmp_path / "inputs.pt")
    _run_workers(tmp_path, _DRIFT_WORKER, args=(steps, threads), timeout=1200)
    procs = [torch.load(tmp_path / f"proc{i}.pt") for i in range(NPROC)]
    x, y = inputs["mnist"]
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    mp = pytest.MonkeyPatch()
    mp.setattr(tmpi.collectives.selector, "select", lambda *a, **k: "kernel")
    _start_one(with_ici_groups=False)
    try:
        eng = AllReduceSGDEngine(make_loss_fn(LeNet()), inputs["lenet"], lr=LR, rank_map="vmap")
        n = len(x) // LENET_BATCH
        losses = [float(eng.step((x[(i % n) * LENET_BATCH:(i % n + 1) * LENET_BATCH],
                                  y[(i % n) * LENET_BATCH:(i % n + 1) * LENET_BATCH])))
                  for i in range(steps)]
        params = dict(eng.params)
    finally:
        tmpi.stop()
        mp.undo()
        torch.set_num_threads(before)
    rel = [abs(a - b) / abs(b) for a, b in zip(procs[0]["losses"], losses)]
    pairs = [(procs[q]["params"][k], _rows(v, q)) for q in range(NPROC) for k, v in params.items()]
    return {"steps": steps, "max_rel_loss": max(rel),
            "first_nonzero_step": next((i + 1 for i, r in enumerate(rel) if r), None),
            "rel_by_step": rel,
            "max_abs_param": max(float((a - b).abs().max()) for a, b in pairs),
            "params_within": all(torch.allclose(a, b, rtol=1e-4, atol=1e-6) for a, b in pairs),
            "same_across_processes": procs[0]["losses"] == procs[1]["losses"],
            "threads": threads}


def test_vmap_across_processes_within_the_stated_tolerance(tmp_path, inputs):
    """ROADMAP C6 held on the CPU: the default ``rank_map='vmap'`` by 2
    processes x 2 is the one-process p=4 vmap run bit for bit over
    ``C6_STEPS`` steps at ``C6_THREADS`` intra-op threads in every
    process (where a vmap over every local rank at once parted at step
    5), losses and every parameter."""
    drift = vmap_drift(tmp_path, inputs, C6_STEPS, C6_THREADS)
    assert drift["same_across_processes"]
    assert drift["first_nonzero_step"] is None and drift["max_abs_param"] == 0.0, drift


if __name__ == "__main__":
    import argparse
    import tempfile

    parser = argparse.ArgumentParser(description="ROADMAP C's probe of rank_map='vmap'")
    parser.add_argument("--vmap-drift", type=int, metavar="STEPS", required=True)
    parser.add_argument("--threads", type=int, default=2,
                        help="intra-op threads of every process (default 2, as the tests)")
    args = parser.parse_args()
    from torchmpi_tpu_torch.models import LeNet, init_params

    from torchmpi_tpu_torch.utils import synthetic_mnist

    (x, y), _ = synthetic_mnist()
    probe_inputs = {"mnist": (torch.as_tensor(x), torch.as_tensor(y)),
                    "lenet": init_params(LeNet(), seed=0)}
    with tempfile.TemporaryDirectory() as d:
        print(json.dumps(vmap_drift(Path(d), probe_inputs, args.vmap_drift, args.threads)))
