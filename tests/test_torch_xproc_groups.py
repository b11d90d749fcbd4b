"""Groups and communicators over some of the processes (ROADMAP A13's
rest, part 10), the port's ranks spread over real processes on the CPU.

Layout (a): two worker processes of three ranks, the host key ``r // 2``
pushed from the root level (groups {0,1}, {2,3}, {4,5}: group {2,3} spans
both processes, and so does every inter group). On ``xla``, ``ring`` and
``kernel`` (the plain versions of the cross-process kernels, over the
lanes' POSIX shared memory): the hierarchical allreduce, the two-level
broadcast from two roots and the staged allreduce, each held bit for bit
to the one-process port on the same ``[p, ...]`` and within ``JAX_RTOL``
of the JAX package's single-controller run on six devices; an integer
payload (rank r holds r) sums to p(p-1)/2 exactly. On ``kernel`` spies
show the grouped cross-process K3 (the intra phase) and K7 (the intra
broadcast) run, one call a process, and that no call gathers the rows
into the one-process plan (``schedule.lower.across``).

Layout (c): three worker processes of two ranks, in the same launch as
(a). Each pair of processes builds a ``Communicator`` over its four ranks
only (processes {0,1} and {1,2} overlap in process 1; {0,2} leaves process
1 out), and runs an allreduce and a broadcast on every backend; the
{1,2} communicator, split by position mod 2 (groups that span its two
processes), also runs the hierarchical allreduce on ``kernel``, the
staged allreduce on ``ring`` and ``kernel`` and the two-level broadcast.
Every result is the one-process port's on the same rows, bit for bit; a
process outside a communicator never takes part in it (its lane and its
exchanges meet its own processes only), so the three finish. The two
launches run at once, in about 20 s.

The plain versions of the grouped cross-process K3 and K7 are held to the
one-process grouped plain versions here, and the staged order to the JAX
multi-controller formula (each process's representatives summed from
zeros, the partials from zeros in process order). Layout (b), the
reference's (4 processes x 2 ranks, hosts of two processes), is marked
slow.
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
from torchmpi_tpu_torch.runtime.communicator import Communicator, split_by_keys

_REPO = Path(__file__).resolve().parent.parent
BACKENDS = ("xla", "ring", "kernel")
JAX_RTOL = 1e-6
N = 1001  # a ragged width
ROOTS = (0, 3)  # the broadcasts' roots: in process 0's host group, and in the spanning one
# layout (a): processes x ranks, the host key from the root level
A_PROCS, A_RANKS = 2, 3
A_P = A_PROCS * A_RANKS
# layout (c): processes x ranks, and the subset communicators by the
# processes that build them
C_PROCS, C_RANKS = 3, 2
SUBSETS = ((0, 1), (1, 2), (0, 2))
SPLIT = (1, 2)  # the subset whose communicator is also split in spanning groups
# layout (b), slow: 4 processes x 2 ranks, 2 hosts of 2 processes
B_PROCS, B_RANKS = 4, 2

_WORKER = textwrap.dedent(
    """
    import sys
    pid, nproc, ranks, port, out_dir, layout = (int(sys.argv[1]), int(sys.argv[2]),
                                                int(sys.argv[3]), sys.argv[4], sys.argv[5],
                                                sys.argv[6])
    sys.path.insert(0, {repo!r})
    import torch
    import torchmpi_tpu_torch as mpi
    from torchmpi_tpu_torch import constants
    from torchmpi_tpu_torch.collectives import eager
    from torchmpi_tpu_torch.ops import ring_kernels
    from torchmpi_tpu_torch.runtime.communicator import Communicator, split_by_keys
    from torchmpi_tpu_torch.schedule import lower

    torch.set_num_threads(1)
    BACKENDS, ROOTS = {backends!r}, {roots!r}
    inputs = torch.load(f"{{out_dir}}/inputs.pt")
    calls = {{}}

    def spy(module, name):
        real = getattr(module, name)
        calls[name] = 0

        def counted(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)

        setattr(module, name, counted)

    for name in ("across",):
        spy(lower, name)
    for name in ("ring_allreduce_xproc", "ring_broadcast_xproc", "ring_allreduce",
                 "ring_broadcast"):
        spy(ring_kernels, name)

    mpi.start(ranks=ranks, device="cpu", coordinator_address=f"localhost:{{port}}",
              num_processes=nproc, process_id=pid, with_ici_groups=False)
    constants.set("small_allreduce_size_cpu", 0)
    constants.set("small_broadcast_size_cpu", 0)
    res = {{}}

    def two_level(comm, x, tag, backends=BACKENDS, staged=BACKENDS):
        for b in backends:
            before = dict(calls)
            res[f"{{tag}}hier/{{b}}"] = eager.run_hierarchical_allreduce(x, comm, impl=b)
            res[f"calls/{{tag}}hier/{{b}}"] = {{k: calls[k] - before[k] for k in calls}}
            for root in ROOTS:
                before = dict(calls)
                res[f"{{tag}}bcast{{root}}/{{b}}"] = eager.run_hierarchical_collective(
                    "broadcast", x, comm, root=root, ring_impl=b)
                res[f"calls/{{tag}}bcast{{root}}/{{b}}"] = {{k: calls[k] - before[k]
                                                        for k in calls}}
        for b in staged:
            res[f"{{tag}}staged/{{b}}"] = eager.run_hierarchical_allreduce(
                x, comm, impl="staged", staged_intra=b)

    if layout in ("a", "b"):
        # the host key pushed from the root level, so a host's group spans
        # processes (a key pushed over a per-process level would split it)
        per_host = {{"a": 2, "b": 4}}[layout]
        mpi.push_communicator(lambda r: f"host{{r // per_host}}", name="hosts")
        comm = mpi.current_communicator()
        mine = comm.local_ranks
        res["groups"] = comm.groups
        two_level(comm, inputs[layout]["x"][mine], "")
        ints = torch.arange(comm.size, dtype=torch.int32)[mine, None].expand(-1, 257).contiguous()
        for b in BACKENDS:
            res[f"ints/{{b}}"] = eager.run_hierarchical_allreduce(ints, comm, impl=b)
            res[f"ints_staged/{{b}}"] = eager.run_hierarchical_allreduce(
                ints, comm, impl="staged", staged_intra=b)
        h = mpi.async_.kernel.allreduce_tensor(inputs[layout]["x"][mine], comm=comm)
        res["async/kernel"] = h.wait()
    if layout in ("c", "b"):
        subsets = {subsets!r} if layout == "c" else ((0, 1), (2, 3), (1, 2))
        for procs in subsets:
            if pid not in procs:
                continue
            ranks_of = [r for q in procs for r in range(q * ranks, (q + 1) * ranks)]
            sub = Communicator(ranks_of, torch.device("cpu"), name=f"sub{{procs}}",
                               processes=[q for q in procs for _ in range(ranks)],
                               process_index=pid)
            x = inputs["c"][procs][sub.local_ranks]
            tag = f"sub{{procs[0]}}{{procs[1]}}/"
            for b in BACKENDS:
                res[f"{{tag}}allreduce/{{b}}"] = getattr(mpi, b).allreduce_tensor(x, comm=sub)
                res[f"{{tag}}broadcast/{{b}}"] = getattr(mpi, b).broadcast_tensor(
                    x, root=sub.size - 1, comm=sub)
            if tuple(procs) == {split!r}:
                spanning = split_by_keys(sub, lambda r: str(r % 2))
                res["split_groups"] = spanning.groups
                two_level(spanning, x, f"{{tag}}split/", backends=("kernel",),
                          staged=("ring", "kernel"))
            eager.barrier(sub)
            res[f"{{tag}}lane_members"] = mpi.runtime_state.plane().lane(sub).members
    mpi.stop()
    torch.save(res, f"{{out_dir}}/{{layout}}{{pid}}.pt")
    print(f"proc {{pid}} OK")
    """
).format(repo=str(_REPO), backends=BACKENDS, roots=ROOTS, subsets=SUBSETS, split=SPLIT)


def _draw(rng, shape) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as each worker takes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(24)
    return {"a": {"x": _draw(rng, (A_P, N))},
            "b": {"x": _draw(rng, (B_PROCS * B_RANKS, N))},
            "c": {procs: _draw(rng, (2 * C_RANKS, 5, 7)) for procs in SUBSETS + ((2, 3),)}}


def _launch(tmp: Path, layout: str, nproc: int, ranks: int):
    port = _free_port()
    return [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(i), str(nproc), str(ranks), str(port),
         str(tmp), layout], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(nproc)]


def _collect(tmp: Path, layout: str, procs) -> list:
    outs = []
    for proc in procs:
        try:
            out, _ = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"layout ({layout}) workers timed out")
        outs.append(out)
    for i, out in enumerate(outs):
        assert f"proc {i} OK" in out, f"layout ({layout}) proc {i} failed:\n{out[-3000:]}"
    return [torch.load(tmp / f"{layout}{i}.pt") for i in range(len(procs))]


@pytest.fixture(scope="module")
def workers(tmp_path_factory, inputs):
    """Layouts (a) and (c), launched together."""
    tmp = tmp_path_factory.mktemp("xproc_groups")
    torch.save(inputs, tmp / "inputs.pt")
    (tmp / "worker.py").write_text(_WORKER)
    a = _launch(tmp, "a", A_PROCS, A_RANKS)
    c = _launch(tmp, "c", C_PROCS, C_RANKS)
    return {"a": _collect(tmp, "a", a), "c": _collect(tmp, "c", c)}


def _one_process_two_level(comm, x, tag, res, backends=BACKENDS, staged=BACKENDS):
    for b in backends:
        res[f"{tag}hier/{b}"] = eager.run_hierarchical_allreduce(x, comm, impl=b)
        for root in ROOTS:
            res[f"{tag}bcast{root}/{b}"] = eager.run_hierarchical_collective(
                "broadcast", x, comm, root=root, ring_impl=b)
    for b in staged:
        res[f"{tag}staged/{b}"] = eager.run_hierarchical_allreduce(
            x, comm, impl="staged", staged_intra=b)


@pytest.fixture(scope="module")
def one_process(inputs):
    """The one-process port on the same payloads and communicators."""
    res = {}
    tmpi.start(ranks=A_P, device="cpu", with_ici_groups=False)
    try:
        constants.set("small_allreduce_size_cpu", 0)
        constants.set("small_broadcast_size_cpu", 0)
        tmpi.push_communicator(lambda r: f"host{r // 2}", name="hosts")
        comm = tmpi.current_communicator()
        _one_process_two_level(comm, inputs["a"]["x"], "", res)
        for procs in SUBSETS:
            x = inputs["c"][procs]
            sub = Communicator(range(len(x)), torch.device("cpu"))
            tag = f"sub{procs[0]}{procs[1]}/"
            for b in BACKENDS:
                res[f"{tag}allreduce/{b}"] = getattr(tmpi, b).allreduce_tensor(x, comm=sub)
                res[f"{tag}broadcast/{b}"] = getattr(tmpi, b).broadcast_tensor(
                    x, root=sub.size - 1, comm=sub)
            if procs == SPLIT:
                _one_process_two_level(split_by_keys(sub, lambda r: str(r % 2)), x,
                                       f"{tag}split/", res, backends=("kernel",),
                                       staged=("ring", "kernel"))
    finally:
        tmpi.stop()
        constants._reset_for_tests()
    return res


_A_KEYS = ([f"hier/{b}" for b in BACKENDS] + [f"bcast{r}/{b}" for r in ROOTS for b in BACKENDS]
           + [f"staged/{b}" for b in BACKENDS])


@pytest.mark.parametrize("key", _A_KEYS)
def test_spanning_groups_bitwise_one_process(workers, one_process, key):
    """Layout (a): every process's rows of the hierarchical allreduce, the
    two-level broadcast and the staged allreduce are the one-process
    port's rows of the same ``[p, ...]``, bit for bit."""
    for proc, res in enumerate(workers["a"]):
        want = one_process[key][proc * A_RANKS:(proc + 1) * A_RANKS]
        assert torch.equal(res[key], want), (key, proc)


def test_layout_a_groups_span_the_processes(workers):
    for res in workers["a"]:
        assert res["groups"] == [[0, 1], [2, 3], [4, 5]]


@pytest.mark.parametrize("key", ["ints", "ints_staged"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_integer_payload_sums_exactly(workers, key, backend):
    """Rank r holds r: every row of the two-level and the staged allreduce
    is p(p-1)/2, exactly."""
    for res in workers["a"]:
        got = res[f"{key}/{backend}"]
        assert got.dtype == torch.int32
        assert bool((got == A_P * (A_P - 1) // 2).all()), got


def test_async_kernel_allreduce_over_spanning_groups(workers, one_process):
    """The async allreduce on ``kernel`` over the spanning groups (the
    plan the compiler picks for the two-level communicator, on the issue
    thread): the one-process rows of the hierarchical allreduce."""
    for proc, res in enumerate(workers["a"]):
        want = one_process["hier/kernel"][proc * A_RANKS:(proc + 1) * A_RANKS]
        assert torch.equal(res["async/kernel"], want), proc


@pytest.mark.parametrize("key", ["hier/kernel"] + [f"bcast{r}/kernel" for r in ROOTS])
def test_kernel_runs_grouped_cross_process_kernels(workers, key):
    """On ``kernel`` the intra phase is one call of the grouped
    cross-process K3 (the allreduce) or K7 (the broadcast) in each
    process, never the one-process kernel, and nothing gathers the rows
    into the one-process plan."""
    for proc, res in enumerate(workers["a"]):
        calls = res[f"calls/{key}"]
        assert calls["across"] == 0, calls
        assert calls["ring_allreduce"] == calls["ring_broadcast"] == 0, calls
        name = "ring_allreduce_xproc" if key.startswith("hier") else "ring_broadcast_xproc"
        assert calls[name] == 1, calls


@pytest.fixture(scope="module")
def jax_results(inputs):
    """Layout (a)'s collectives by the JAX package single-controller on
    ``jax.devices()[:6]`` under the same host key."""
    import jax

    import torchmpi_tpu as jmpi
    from torchmpi_tpu import constants as jconstants
    from torchmpi_tpu.collectives import eager as jeager

    jmpi.start(devices=jax.devices()[:A_P])
    try:
        jconstants.set("small_allreduce_size_cpu", 0)
        jmpi.push_communicator(lambda r: f"host{r // 2}", name="hosts")
        comm = jmpi.current_communicator()
        x = jax.numpy.asarray(inputs["a"]["x"].numpy())
        res = {"hier": np.asarray(jeager.run_hierarchical_allreduce(x, comm, impl="ring")),
               "staged": np.asarray(jeager.run_hierarchical_allreduce(
                   x, comm, impl="staged", staged_intra="ring"))}
        for root in ROOTS:
            res[f"bcast{root}"] = np.asarray(jeager.run_hierarchical_collective(
                "broadcast", x, comm, root=root))
        return res
    finally:
        jmpi.stop()
        jconstants._reset_for_tests()


@pytest.mark.parametrize("key", _A_KEYS)
def test_spanning_groups_match_jax(workers, jax_results, key):
    """Against the JAX single-controller run: the broadcasts bit for bit,
    the sums within ``JAX_RTOL``."""
    op = key.split("/")[0]
    for proc, res in enumerate(workers["a"]):
        got = res[key].numpy()
        ref = jax_results[op][proc * A_RANKS:(proc + 1) * A_RANKS]
        if op.startswith("bcast"):
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=JAX_RTOL, atol=JAX_RTOL)


# --- layout (c): communicators over some of the processes ------------------
_C_KEYS = ([f"sub{a}{b}/{op}/{be}" for a, b in SUBSETS for op in ("allreduce", "broadcast")
            for be in BACKENDS]
           + [f"sub{SPLIT[0]}{SPLIT[1]}/split/{k}" for k in
              ["hier/kernel"] + [f"bcast{r}/kernel" for r in ROOTS]
              + ["staged/ring", "staged/kernel"]])


@pytest.mark.parametrize("key", _C_KEYS)
def test_subset_communicators_bitwise_one_process(workers, one_process, key):
    """Each process of a communicator over some of the processes gets the
    one-process port's rows of the same ``[4, ...]``, bit for bit; the
    processes outside it take no part."""
    procs = tuple(int(c) for c in key[3:5])
    for pid, res in enumerate(workers["c"]):
        if pid not in procs:
            assert key not in res
            continue
        at = procs.index(pid) * C_RANKS
        assert torch.equal(res[key], one_process[key][at:at + C_RANKS]), (key, pid)


def test_subset_lanes_meet_their_processes_only(workers):
    """Every subset communicator's lane has its own processes as members,
    and the split one's groups span its two processes."""
    for pid, res in enumerate(workers["c"]):
        for procs in SUBSETS:
            key = f"sub{procs[0]}{procs[1]}/lane_members"
            assert (res.get(key) == list(procs)) if pid in procs else key not in res
        if pid in SPLIT:
            assert res["split_groups"] == [[0, 2], [1, 3]]


# --- the plain versions of the grouped cross-process K3 and K7 -------------
def _stacked(dtype, rows, n, seed):
    rng = np.random.default_rng(seed)
    if dtype.is_floating_point:
        return torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32)).to(dtype)
    return torch.from_numpy(rng.integers(-40, 41, (rows, n)).astype(np.int64)).to(dtype)


_LAYOUTS = [(3, 2), (2, 4), (1, 8), (4, 2)]  # G groups x I ranks


@pytest.mark.parametrize("dtype", list(ops.ring_kernels.NATIVE_DTYPES), ids=str)
@pytest.mark.parametrize("layout", _LAYOUTS, ids=lambda gi: f"{gi[0]}x{gi[1]}")
def test_grouped_allreduce_xproc_plain_is_the_one_process_grouped_rows(dtype, layout):
    """The grouped cross-process K3's plain version over a group-major
    table, the owned positions in any order: each row the one-process
    grouped plain K3's row at that position, bit for bit."""
    G, I = layout
    x = _stacked(dtype, G * I, 1001, G * 10 + I)
    want = ops.ring_allreduce_plain(x, groups=G)
    for owned in ([0], list(range(G * I))[::-1], [G * I - 1, 0]):
        got = ops.ring_allreduce_xproc_plain(list(x), len(owned), groups=G, owned=owned)
        assert torch.equal(got, want[owned])
        assert torch.equal(ops.ring_allreduce_xproc(list(x), len(owned), groups=G,
                                                    owned=owned), got)


@pytest.mark.parametrize("layout", _LAYOUTS, ids=lambda gi: f"{gi[0]}x{gi[1]}")
@pytest.mark.parametrize("root", [0, 1])
def test_grouped_broadcast_xproc_plain_is_the_one_process_grouped_rows(layout, root):
    """The grouped cross-process K7's plain version, one root row a group
    and each row's group: the one-process grouped plain K7's rows, bytes
    and all (-0.0 survives)."""
    G, I = layout
    x = _stacked(torch.float32, G * I, 333, G + I)
    x[root, 0] = -0.0
    want = ops.ring_broadcast_plain(x, root, groups=G)
    roots = [x[g * I + root] for g in range(G)]
    rows = list(range(G * I))[::-2]
    got = ops.ring_broadcast_xproc_plain(roots, len(rows), owned=[r // I for r in rows])
    assert torch.equal(got.view(torch.int32), want[rows].view(torch.int32))


def test_grouped_xproc_plain_versions_check_their_arguments():
    rows = list(torch.zeros((6, 8)))
    with pytest.raises(ValueError, match="groups of equal size"):
        ops.ring_allreduce_xproc_plain(rows, 1, groups=4, owned=[0])
    with pytest.raises(ValueError, match="needs the owned positions"):
        ops.ring_allreduce_xproc_plain(rows, 1, groups=2)
    with pytest.raises(ValueError, match="out of range or repeated"):
        ops.ring_allreduce_xproc_plain(rows, 2, groups=2, owned=[1, 1])
    with pytest.raises(ValueError, match="need each row's group"):
        ops.ring_broadcast_xproc_plain(rows[:2], 1)
    with pytest.raises(ValueError, match="out of range"):
        ops.ring_broadcast_xproc_plain(rows[:2], 1, owned=[2])
    with pytest.raises(ValueError, match="runs on CUDA or the CPU"):
        ops.ring_allreduce_xproc([torch.zeros(8, device="meta")] * 4, 1, groups=2, owned=[3])
    with pytest.raises(ValueError, match="runs on CUDA or the CPU"):
        ops.ring_broadcast_xproc([torch.zeros(8, device="meta")] * 2, 1, owned=[1])


@pytest.mark.parametrize("sizes", [(12 << 20, 5), (0, 9 << 20), (1 << 20, 1 << 20)],
                         ids=["over_the_limit", "empty_and_over", "one_piece"])
def test_store_exchange_carries_payloads_over_the_store_limit(sizes):
    """The exchange among some of the processes (``ControlPlane._exchange``)
    moves payloads larger than the TCPStore's 8 MiB message limit as
    pieces, through one real store served in this process: two members,
    in two threads, each read the other's bytes whole, in process order,
    over three epochs (each deleting its keys of the one before)."""
    import threading
    import types
    from datetime import timedelta

    import torch.distributed as dist

    from torchmpi_tpu_torch.runtime import peers

    port = _free_port()
    server = dist.TCPStore("localhost", port, 2, is_master=True, wait_for_workers=False,
                           timeout=timedelta(seconds=60))
    client = dist.TCPStore("localhost", port, 2, is_master=False, timeout=timedelta(seconds=60))
    planes = [types.SimpleNamespace(index=q, pids=[0, 0], _epochs={}, _pieces={},
                                    drain=lambda: None, _sets=dist.PrefixStore("t", st))
              for q, st in enumerate((server, client))]
    got = [[], []]

    def run(q):
        for epoch in range(3):
            payload = bytes([q * 16 + epoch]) * sizes[q]
            got[q].append(peers.ControlPlane._exchange(planes[q], [0, 1], payload))

    threads = [threading.Thread(target=run, args=(q,)) for q in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for q in range(2):
        assert [[len(b) for b in out] for out in got[q]] == [list(sizes)] * 3
        for epoch, out in enumerate(got[q]):
            assert all(b == bytes([p * 16 + epoch]) * sizes[p] for p, b in enumerate(out))
    store = planes[0]._sets
    assert store.check(["0,1/3/0", "0,1/3/1"])
    for old in ("0,1/1/0", "0,1/1/1", "0,1/2/0", "0,1/2/1", "0,1/2/0/1", "0,1/2/1/2"):
        assert not store.check([old]), old


def staged_formula(x: torch.Tensor, groups, process_of) -> torch.Tensor:
    """The JAX multi-controller staged total (``torchmpi_tpu/schedule/
    lower.py:478-523``) of the group sums of ``x`` (each group's rows
    summed by the one-process grouped ring): each process sums the
    representatives it owns (each group's first rank) from zeros in group
    order, and the partials are summed from zeros in process order."""
    order = [r for g in groups for r in g]
    sums = ops.ring_allreduce_plain(x[order].contiguous(), groups=len(groups))
    reps = {g[0]: sums[i * len(g)] for i, g in enumerate(groups)}
    total = torch.zeros_like(x[0])
    for q in sorted(set(process_of)):
        partial = torch.zeros_like(x[0])
        for g in groups:
            if process_of[g[0]] == q:
                partial = partial + reps[g[0]]
        total = total + partial
    return total


def test_staged_formula_is_the_one_process_staged_sum_on_layout_a(inputs, one_process):
    """On layout (a) the multi-controller order gives the one-process
    staged bits: process 0 owns the first two representatives, process 1
    the third, so the partials add in the same order."""
    x = inputs["a"]["x"]
    want = staged_formula(x, [[0, 1], [2, 3], [4, 5]], [r // A_RANKS for r in range(A_P)])
    assert torch.equal(one_process["staged/kernel"][0], want)


# --- layout (b), the reference's: 4 processes x 2 ranks ---------------------
@pytest.mark.slow
def test_reference_layout_four_processes(tmp_path, inputs):
    """Layout (b): hosts of two processes (key ``r // 4``), the two-level
    allreduce, broadcast and staged allreduce on every backend against
    the one-process port bit for bit (the staged one also against the
    multi-controller formula: with one representative in each of two
    processes it adds only exact zeros to the one-process order), the
    integers exact; subset communicators
    over processes {0,1} and {2,3} (disjoint) and {1,2} (overlapping)."""
    torch.save(inputs, tmp_path / "inputs.pt")
    (tmp_path / "worker.py").write_text(_WORKER)
    res = _collect(tmp_path, "b", _launch(tmp_path, "b", B_PROCS, B_RANKS))
    p = B_PROCS * B_RANKS
    x = inputs["b"]["x"]
    tmpi.start(ranks=p, device="cpu", with_ici_groups=False)
    try:
        constants.set("small_allreduce_size_cpu", 0)
        constants.set("small_broadcast_size_cpu", 0)
        tmpi.push_communicator(lambda r: f"host{r // 4}", name="hosts")
        one = {}
        _one_process_two_level(tmpi.current_communicator(), x, "", one)
    finally:
        tmpi.stop()
        constants._reset_for_tests()
    staged = staged_formula(x, [[0, 1, 2, 3], [4, 5, 6, 7]], [r // B_RANKS for r in range(p)])
    for pid, r in enumerate(res):
        rows = slice(pid * B_RANKS, (pid + 1) * B_RANKS)
        assert r["groups"] == [[0, 1, 2, 3], [4, 5, 6, 7]]
        for key, want in one.items():
            assert torch.equal(r[key], want[rows]), (key, pid)
        assert torch.equal(r["staged/kernel"], staged.expand(B_RANKS, -1))
        for b in BACKENDS:
            assert bool((r[f"ints/{b}"] == p * (p - 1) // 2).all())
            assert bool((r[f"ints_staged/{b}"] == p * (p - 1) // 2).all())
        for procs in ((0, 1), (2, 3), (1, 2)):
            key = f"sub{procs[0]}{procs[1]}/lane_members"
            assert (r.get(key) == list(procs)) if pid in procs else key not in r
