"""The rest of the collective surface with the port's ranks spread over
real processes, on the CPU: alltoall, sendreceive, allgatherv, the group
broadcast, and the reduce and the ``kernel_bidir`` allreduce through the
cross-process K6 and K5.

Two worker processes of two ranks each (``start(coordinator_address=...)``,
``device='cpu'``: the control plane's gloo group and issue thread, the
lanes' POSIX shared memory and the plain versions of the cross-process
kernels) run, once for the module, on inputs this module draws from numpy
seeds and hands them in a file:

- alltoall, sendreceive and reduce on ``xla``, ``ring`` and ``kernel``,
  and the allreduce under ``ring_implementation='kernel_bidir'`` on
  ``kernel``, each async and then the same op synchronously before the
  handle is waited; allgatherv on ``xla`` and ``ring``; the group
  broadcast on a cartesian communicator whose groups span both processes
  and on a ragged one. Every process's rows must equal the one-process
  port's rows of the same ``[p, ...]`` bit for bit; the moves must equal
  the JAX package's single-controller run on ``jax.devices()[:4]`` bit for
  bit, the sums lie within ``JAX_RTOL`` of it;
- spies on ``schedule.lower.across``/``gather_full`` and on the kernel
  wrappers: on ``kernel`` the reduce runs the cross-process K6 in the
  root's process only and the ``kernel_bidir`` allreduce the
  cross-process K5, and neither they nor alltoall and sendreceive on
  ``ring`` and ``kernel`` gather the rows;
- a block that disagrees in one process makes allgatherv raise
  ``CollectiveArgumentError`` in both; the staged allreduce over groups
  that span the processes gives the JAX multi-controller total (ROADMAP
  A13's rest, part 10, carries it);
- the collectives benchmark's tester (``utils/tester.py``) over sizes
  2^8..2^12, every op, backend and mode: every row correct.

Plain-version tests of the cross-process K5 and K6 run in this process.
Both the tests' process and the workers take two intra-op threads.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import torchmpi_tpu_torch as tmpi
from torchmpi_tpu_torch import constants, ops
from torchmpi_tpu_torch.collectives import eager
from torchmpi_tpu_torch.launch import _free_port
from torchmpi_tpu_torch.runtime.communicator import split_by_keys

_REPO = Path(__file__).resolve().parent.parent
L = 2  # ranks a process
NPROC = 2
P = L * NPROC
BACKENDS = ("xla", "ring", "kernel")
JAX_RTOL = 1e-6
# key -> (op, per-rank shape, dtype, keyword arguments); alltoall's first
# per-rank dim is P (block s goes to rank s)
SPECS = {
    "alltoall/(4, 3)": ("alltoall", (P, 3), "float32", {}),
    "alltoall/(4, 2, 5)": ("alltoall", (P, 2, 5), "float32", {}),
    "alltoall/int32": ("alltoall", (P, 7), "int32", {}),
    "sendreceive/0-3": ("sendreceive", (700,), "float32", {"src": 0, "dst": 3}),
    "sendreceive/3-0": ("sendreceive", (3, 7), "float32", {"src": 3, "dst": 0}),
    "sendreceive/1-0": ("sendreceive", (700,), "float32", {"src": 1, "dst": 0}),
    "sendreceive/2-1/bool": ("sendreceive", (64,), "bool", {"src": 2, "dst": 1}),
    "reduce/0": ("reduce", (700,), "float32", {"root": 0}),
    "reduce/3": ("reduce", (70001,), "float32", {"root": 3}),
    "reduce/2/int32": ("reduce", (700,), "int32", {"root": 2}),
    "reduce/1/int16": ("reduce", (300,), "int16", {"root": 1}),
    "bidir/(700,)": ("allreduce", (700,), "float32", {}),
    "bidir/(70001,)": ("allreduce", (70001,), "float32", {}),
    "bidir/bfloat16": ("allreduce", (1001,), "bfloat16", {}),
}
MOVES = ("alltoall", "sendreceive")
# allgatherv: each rank's last dim, and the leading dims
GATHERV = {"float32": ((3, 5, 1, 4), (2,)), "int32": ((6, 2, 2, 9), ())}
GATHERV_BACKENDS = ("xla", "ring")
# the group broadcasts: name -> (keys, intra root)
GROUPS = {"cartesian/0": ("mod2", 0), "cartesian/1": ("mod2", 1), "ragged/0": ("ragged", 0)}
JAX_DTYPES = ("float32", "int32", "bool")  # the payloads held against JAX
SWEEP_POWS = (8, 12)
SWEEP_OPS = ("broadcast", "reduce", "allreduce", "allgather", "reducescatter", "alltoall",
             "sendreceive")

_WORKER = textwrap.dedent(
    """
    import sys
    pid, nproc, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    sys.path.insert(0, {repo!r})
    import torch
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import constants
    from torchmpi_tpu_torch.collectives import CollectiveArgumentError, eager
    from torchmpi_tpu_torch.ops import ring_kernels
    from torchmpi_tpu_torch.runtime.communicator import split_by_keys
    from torchmpi_tpu_torch.schedule import lower
    from torchmpi_tpu_torch.utils.tester import run_matrix, sweep_sizes

    torch.set_num_threads(2)  # as the tests' process (_two_threads)
    L, SPECS, BACKENDS = {L}, {specs!r}, {backends!r}
    inputs = torch.load(f"{{out_dir}}/inputs.pt")
    calls = {{}}

    def spy(module, name):
        real = getattr(module, name)
        calls[name] = 0

        def counted(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)

        setattr(module, name, counted)

    for name in ("across", "gather_full"):
        spy(lower, name)
    for name in ("ring_allreduce_bidir_xproc", "ring_reduce_xproc", "ring_allreduce_bidir",
                 "ring_reduce"):
        spy(ring_kernels, name)

    mpi.start(ranks=L, device="cpu", coordinator_address=f"localhost:{{port}}",
              num_processes=nproc, process_id=pid, with_ici_groups=False)
    comm = mpi.current_communicator()
    mine = comm.local_ranks
    constants.set("small_allreduce_size_cpu", 0)
    res = {{}}

    def issue(ns, op, x, kw):
        fn = getattr(ns, f"{{op}}_tensor")
        if op == "sendreceive":
            return fn(x, kw["src"], kw["dst"], comm=comm)
        if op == "reduce":
            return fn(x, root=kw["root"], comm=comm)
        return fn(x, comm=comm)

    for key, (op, shape, dtype, kw) in SPECS.items():
        x = inputs["payloads"][key][mine]
        bidir = key.startswith("bidir")
        if bidir:
            constants.set("ring_implementation", "kernel_bidir")
        for b in ("kernel",) if bidir else BACKENDS:
            before = dict(calls)
            h = issue(getattr(mpi.async_, b), op, x, kw)
            res[f"sync/{{key}}/{{b}}"] = issue(getattr(mpi, b), op, x, kw)
            res[f"async/{{key}}/{{b}}"] = h.wait()
            res[f"calls/{{key}}/{{b}}"] = {{k: calls[k] - before[k] for k in calls}}
        if bidir:
            constants.set("ring_implementation", "kernel")

    for dtype, blocks in inputs["gatherv"].items():
        for b in ("xla", "ring"):
            res[f"gatherv/{{dtype}}/{{b}}"] = mpi.allgatherv_tensor([blocks[r] for r in mine],
                                                                 comm=comm, backend=b)
    bad = [inputs["gatherv"]["float32"][r] for r in mine]
    if pid == 1:
        bad[1] = bad[1].reshape(1, -1).expand(3, -1)  # other leading dims
    try:
        mpi.allgatherv_tensor(bad, comm=comm)
        res["gatherv_error"] = None
    except CollectiveArgumentError as e:
        res["gatherv_error"] = str(e)

    keys = {{"mod2": lambda r: str(r % 2), "ragged": lambda r: "a" if r == 0 else "b"}}
    split = {{name: split_by_keys(comm, fn) for name, fn in keys.items()}}
    res["groups"] = {{name: c.groups for name, c in split.items()}}
    for name, (which, root) in inputs["group_cases"].items():
        x = inputs["group_payload"][mine]
        res[f"group/{{name}}"] = eager.run_group_broadcast(x, split[which], root=root)

    # the staged allreduce over the mod-2 groups, which span both processes
    res["staged_span"] = eager.run_hierarchical_allreduce(
        inputs["group_payload"][mine], split["mod2"], impl="staged", staged_intra="ring")

    # the collectives benchmark's tester over every op, backend and mode
    reps = {{b: (0, 1) for b in BACKENDS}}
    rows = run_matrix(comm, ops={ops!r}, backends=BACKENDS, modes=("sync", "async"),
                      sizes=sweep_sizes(*{pows!r}), benchmark=True, reps=reps)
    constants.set("ring_implementation", "kernel_bidir")
    rows += run_matrix(comm, ops=("allreduce",), backends=("kernel",), modes=("sync", "async"),
                       sizes=sweep_sizes(*{pows!r}), benchmark=True, reps=reps)
    res["sweep"] = [(r.op, r.backend, r.mode, r.nelem, r.correct) for r in rows]
    mpi.stop()
    torch.save(res, f"{{out_dir}}/proc{{pid}}.pt")
    print(f"proc {{pid}} OK")
    """
).format(repo=str(_REPO), L=L, specs=SPECS, backends=BACKENDS, ops=SWEEP_OPS, pows=SWEEP_POWS)


def _draw(rng, shape, dtype: str) -> torch.Tensor:
    if dtype == "bool":
        return torch.from_numpy(rng.integers(0, 2, shape).astype(bool))
    if dtype in ("float32", "bfloat16"):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            getattr(torch, dtype))
    return torch.from_numpy(rng.integers(-9, 10, shape).astype(dtype))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, as each worker takes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    payloads = {key: _draw(rng, (P,) + shape, dtype) for key, (_, shape, dtype, _) in SPECS.items()}
    gatherv = {dtype: [_draw(rng, lead + (n,), dtype) for n in sizes]
               for dtype, (sizes, lead) in GATHERV.items()}
    return {"payloads": payloads, "gatherv": gatherv, "group_cases": GROUPS,
            "group_payload": _draw(rng, (P, 5, 3), "float32")}


@pytest.fixture(scope="module")
def worker_results(tmp_path_factory, inputs):
    tmp = tmp_path_factory.mktemp("xproc_collectives")
    torch.save(inputs, tmp / "inputs.pt")
    worker = tmp / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), str(NPROC), str(port), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for i in range(NPROC)]
    outs = []
    for proc in procs:
        try:
            out, _ = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process workers timed out")
        outs.append(out)
    for i, out in enumerate(outs):
        assert f"proc {i} OK" in out, f"proc {i} failed:\n{out[-3000:]}"
    return [torch.load(tmp / f"proc{i}.pt") for i in range(NPROC)]


def _rows(full: torch.Tensor, proc: int) -> torch.Tensor:
    return full[proc * L:(proc + 1) * L]


def _one(ns, op: str, x: torch.Tensor, kw: dict) -> torch.Tensor:
    fn = getattr(ns, f"{op}_tensor")
    if op == "sendreceive":
        return fn(x, kw["src"], kw["dst"])
    if op == "reduce":
        return fn(x, root=kw["root"])
    return fn(x)


def _groups(which: str, comm):
    keys = {"mod2": lambda r: str(r % 2), "ragged": lambda r: "a" if r == 0 else "b"}
    return split_by_keys(comm, keys[which])


@pytest.fixture(scope="module")
def one_process(inputs):
    """The one-process port on the same payloads, sync."""
    tmpi.start(ranks=P, device="cpu", with_ici_groups=False)
    try:
        constants.set("small_allreduce_size_cpu", 0)
        comm = tmpi.current_communicator()
        res = {}
        for key, (op, _, _, kw) in SPECS.items():
            x = inputs["payloads"][key]
            if key.startswith("bidir"):
                constants.set("ring_implementation", "kernel_bidir")
                res[f"{key}/kernel"] = _one(tmpi.kernel, op, x, kw)
                constants.set("ring_implementation", "kernel")
                continue
            for b in BACKENDS:
                res[f"{key}/{b}"] = _one(getattr(tmpi, b), op, x, kw)
        for dtype, blocks in inputs["gatherv"].items():
            for b in GATHERV_BACKENDS:
                res[f"gatherv/{dtype}/{b}"] = tmpi.allgatherv_tensor(blocks, backend=b)
        for name, (which, root) in GROUPS.items():
            res[f"group/{name}"] = eager.run_group_broadcast(
                inputs["group_payload"], _groups(which, comm), root=root)
        return res
    finally:
        tmpi.stop()
        constants._reset_for_tests()


_KEYS = [f"{key}/{b}" for key in SPECS for b in (("kernel",) if key.startswith("bidir")
                                                   else BACKENDS)]


@pytest.mark.parametrize("key", _KEYS)
def test_bitwise_one_process(worker_results, one_process, key):
    """Every process's rows of the async call (waited after the sync one)
    and of the sync call are the one-process port's rows of the same
    ``[p, ...]``, bit for bit, in its dtype."""
    for proc, res in enumerate(worker_results):
        want = _rows(one_process[key], proc)
        for mode in ("async", "sync"):
            got = res[f"{mode}/{key}"]
            assert got.dtype == want.dtype and torch.equal(got, want), (key, mode, proc)


@pytest.mark.parametrize("key", [f"gatherv/{d}/{b}" for d in GATHERV for b in GATHERV_BACKENDS]
                         + [f"group/{name}" for name in GROUPS])
def test_gatherv_and_group_broadcast_bitwise_one_process(worker_results, one_process, key):
    """allgatherv (each process's blocks of its ranks, the sizes exchanged
    over the control plane) and the group broadcast (each row read from
    its group root's row where it lies): the one-process rows bit for
    bit."""
    for proc, res in enumerate(worker_results):
        want = _rows(one_process[key], proc)
        assert res[key].dtype == want.dtype and torch.equal(res[key], want), (key, proc)


def test_group_cases_span_the_processes(worker_results):
    """The cartesian groups (rank mod 2) hold one rank of each process, the
    ragged ones a group of one and a group of three."""
    for res in worker_results:
        assert res["groups"] == {"mod2": [[0, 2], [1, 3]], "ragged": [[0], [1, 2, 3]]}


@pytest.fixture(scope="module")
def jax_results(inputs):
    """The JAX package single-controller on jax.devices()[:4]."""
    import jax

    import torchmpi_tpu as jmpi
    from torchmpi_tpu import constants as jconstants
    from torchmpi_tpu.collectives import eager as jeager
    from torchmpi_tpu.runtime.communicator import split_by_keys as jsplit

    jmpi.start(devices=jax.devices()[:P])
    try:
        jconstants.set("small_allreduce_size_cpu", 0)
        comm = jmpi.stack().at(0)
        res = {}
        for key, (op, _, dtype, kw) in SPECS.items():
            if dtype not in JAX_DTYPES:
                continue
            x = jax.numpy.asarray(inputs["payloads"][key].numpy())
            for b in ("xla", "ring"):
                fn = getattr(jmpi.xla if b == "xla" else jmpi.ring, f"{op}_tensor")
                if op == "sendreceive":
                    out = fn(x, kw["src"], kw["dst"], comm=comm)
                elif op == "reduce":
                    out = fn(x, root=kw["root"], comm=comm)
                else:
                    out = fn(x, comm=comm)
                res[f"{key}/{b}"] = np.asarray(out)
        for dtype, blocks in inputs["gatherv"].items():
            for b in GATHERV_BACKENDS:
                res[f"gatherv/{dtype}/{b}"] = np.asarray(jmpi.allgatherv_tensor(
                    [blk.numpy() for blk in blocks], comm=comm, backend=b))
        keys = {"mod2": lambda r: str(r % 2), "ragged": lambda r: "a" if r == 0 else "b"}
        for name, (which, root) in GROUPS.items():
            res[f"group/{name}"] = np.asarray(jeager.run_group_broadcast(
                jax.numpy.asarray(inputs["group_payload"].numpy()), jsplit(comm, keys[which]),
                root=root))
        return res
    finally:
        jmpi.stop()
        jconstants._reset_for_tests()


_JAX_KEYS = [k for k in _KEYS if SPECS[k.rsplit("/", 1)[0]][2] in JAX_DTYPES]


@pytest.mark.parametrize("key", _JAX_KEYS)
def test_matches_jax(worker_results, jax_results, key):
    """Against the JAX single-controller run of the same payload (the
    kernel rows against the vendor path's): the moves bit for bit, the
    sums within JAX_RTOL."""
    base, backend = key.rsplit("/", 1)
    op = SPECS[base][0]
    want = jax_results[f"{base}/{'ring' if backend == 'ring' else 'xla'}"]
    for proc, res in enumerate(worker_results):
        got, ref = res[f"async/{key}"].numpy(), want[proc * L:(proc + 1) * L]
        assert got.shape == ref.shape and got.dtype == ref.dtype, (got.dtype, ref.dtype)
        if op in MOVES:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=JAX_RTOL, atol=JAX_RTOL)


@pytest.mark.parametrize("key", [f"gatherv/{d}/{b}" for d in GATHERV for b in GATHERV_BACKENDS]
                         + [f"group/{name}" for name in GROUPS])
def test_gatherv_and_group_broadcast_match_jax(worker_results, jax_results, key):
    for proc, res in enumerate(worker_results):
        np.testing.assert_array_equal(res[key].numpy(), _rows(jax_results[key], proc))


# --- what runs where ------------------------------------------------------
@pytest.mark.parametrize("key", _KEYS)
def test_no_row_gather_where_the_lane_carries_it(worker_results, key):
    """On ``kernel`` the reduce runs the cross-process K6 (in the root's
    process only, one launch a call) and the ``kernel_bidir`` allreduce
    the cross-process K5 (one launch a call in each process), never the
    one-process K5/K6; on ``ring`` and ``kernel`` alltoall and
    sendreceive copy from the slabs. None of them gathers the rows
    (``lower.across`` binds nothing, ``gather_full`` runs never); on
    ``xla`` they gather over gloo."""
    base, backend = key.rsplit("/", 1)
    op, kw = SPECS[base][0], SPECS[base][3]
    for proc, res in enumerate(worker_results):
        calls = res[f"calls/{key}"]
        assert calls["ring_allreduce_bidir"] == calls["ring_reduce"] == 0, calls
        if backend == "xla":
            assert calls["gather_full"] == 2, calls  # the async call and the sync one
            continue
        if op in MOVES or backend == "kernel":
            assert calls["across"] == calls["gather_full"] == 0, calls
        if backend == "kernel" and op == "reduce":
            owner = kw["root"] // L == proc
            assert calls["ring_reduce_xproc"] == (2 if owner else 0), calls
        if backend == "kernel" and base.startswith("bidir"):
            assert calls["ring_allreduce_bidir_xproc"] == 2, calls


def test_gatherv_disagreeing_block_raises_in_every_process(worker_results):
    """A block with other leading dims, passed by process 1 only, raises
    ``CollectiveArgumentError`` in both processes (the shapes are checked
    after the exchange)."""
    for res in worker_results:
        assert res["gatherv_error"] and "block 3 shape (3, 8)" in res["gatherv_error"], res


def test_staged_allreduce_over_spanning_groups_names_part_10(worker_results, inputs):
    """The staged allreduce over groups that span the processes, which
    raised naming ROADMAP A13's rest, part 10 until that part carried it:
    every row is the JAX multi-controller total, each process's
    representatives (groups {0,2} and {1,3}: both in process 0) summed from
    zeros in group order and the partials from zeros in process order."""
    x = inputs["group_payload"]
    partial = torch.zeros_like(x[0])
    for g in ([0, 2], [1, 3]):
        partial = partial + (x[g[0]] + x[g[1]])
    total = (torch.zeros_like(x[0]) + partial) + torch.zeros_like(x[0])
    for res in worker_results:
        assert torch.equal(res["staged_span"], total.expand(L, *total.shape))


def test_lane_over_some_processes_names_part_10():
    """A communicator whose ranks lie in some of the processes has a lane
    since ROADMAP A13's rest, part 10; one whose processes lie on two hosts
    still raises, naming part 8."""
    from types import SimpleNamespace

    from torchmpi_tpu_torch.runtime.peers import Lane

    plane = SimpleNamespace(hosts=["h", "h", "g"], count=3, index=0)
    comm = SimpleNamespace(processes=[0, 0, 2, 2])
    with pytest.raises(NotImplementedError, match="ROADMAP A13's rest, part 8"):
        Lane(plane, comm, "0-2n1")


def test_tester_sweep_across_processes_reads_correct(worker_results):
    """The collectives benchmark's tester, every process on its own rows:
    every op on every backend, sync and async, sizes 2^8..2^12, and the
    kernel allreduce under 'kernel_bidir', all correct."""
    n_sizes = SWEEP_POWS[1] - SWEEP_POWS[0] + 1
    for res in worker_results:
        rows = res["sweep"]
        assert len(rows) == (len(SWEEP_OPS) * len(BACKENDS) + 1) * 2 * n_sizes
        assert [r for r in rows if not r[-1]] == []


# --- the plain versions of the two new forms ------------------------------
_NATIVE = list(ops.ring_kernels.NATIVE_DTYPES)


def _rows_of(dtype, n, seed):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((P, n)) if dtype.is_floating_point else rng.integers(-4, 5, (P, n))
    return torch.from_numpy(vals.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", _NATIVE, ids=str)
@pytest.mark.parametrize("n", [128, 1001, 4097])
def test_allreduce_bidir_xproc_plain_is_the_one_process_rows(dtype, n):
    """The cross-process K5's plain version over a table of p rows: each of
    the ``local`` rows the one-process plain K5's row, bit for bit, for 1
    to p local rows."""
    x = _rows_of(dtype, n, n)
    want = ops.ring_allreduce_bidir_plain(x)
    for local in (1, L, P):
        got = ops.ring_allreduce_bidir_xproc_plain(list(x), local)
        assert torch.equal(got, want[:1].expand(local, n))
        assert torch.equal(ops.ring_allreduce_bidir_xproc(list(x), local), got)


@pytest.mark.parametrize("root", range(P))
@pytest.mark.parametrize("order", ["ascending", "descending"])
@pytest.mark.parametrize("n", [128, 1001])
def test_reduce_xproc_plain_is_the_one_process_rows(root, order, n):
    """The cross-process K6's plain version in the root's process, the
    owned ranks in either order: the one-process plain K6's rows of those
    ranks bit for bit (the root's the sum, every other its input)."""
    x = _rows_of(torch.float32, n, root)
    mine = [r for r in range(P) if r // L == root // L]
    owned = mine if order == "ascending" else mine[::-1]
    got = ops.ring_reduce_xproc_plain(list(x), owned, root)
    assert torch.equal(got, ops.ring_reduce_plain(x, root)[owned])
    assert torch.equal(ops.ring_reduce_xproc(list(x), owned, root), got)


def test_xproc_k5_k6_check_their_arguments():
    rows = list(torch.zeros((P, 8)))
    with pytest.raises(ValueError, match="not among the owned ranks"):
        ops.ring_reduce_xproc_plain(rows, [0, 1], 3)
    with pytest.raises(ValueError, match="out of range or repeated"):
        ops.ring_reduce_xproc_plain(rows, [0, 0], 0)
    with pytest.raises(ValueError, match="runs on CUDA or the CPU"):
        ops.ring_reduce_xproc([torch.zeros(8, device="meta")] * P, [0], 0)
    with pytest.raises(ValueError, match="runs on CUDA or the CPU"):
        ops.ring_allreduce_bidir_xproc([torch.zeros(8, device="meta")] * P, 1)
