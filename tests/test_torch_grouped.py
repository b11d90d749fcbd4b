"""The grouped ring kernels of ``torchmpi_tpu_torch.ops`` on the CPU.

K3's allreduce (``ring_allreduce``), K3 'ag' (``ring_allgather``) and K7
(``ring_broadcast``) take ``groups``: the rows hold G rings of I ranks in
group-major order (the intra phase of a two-level communicator), and one
launch serves them all. On the CPU the wrappers run their plain versions,
which are held here

- against the per-group plain versions on each group's ``[I, ...]`` slab,
  bit for bit, over G x I in {1x8, 2x4, 4x2, 8x1}, every native dtype and
  the int16 and bool carriers, an odd and an aligned width;
- against the JAX package's ``ring_allreduce_pallas``,
  ``ring_allgather_pallas`` and ``ring_broadcast_pallas`` in Pallas
  interpret mode, one group at a time under ``shard_map`` on a one-axis
  mesh of I CPU devices, bit for bit;

and the CUDA launch path is driven with the library faked: one call of
the C entry with the row and group counts, and one count, per grouped
call. Inputs are made with numpy from a seed. Tolerance: none; each
group's ring keeps the chunk layout and order of adds of one I-rank ring.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from torchmpi_tpu.ops import ring_kernels as jring
from torchmpi_tpu_torch import ops
from torchmpi_tpu_torch.ops import _build
from torchmpi_tpu_torch.ops import ring_kernels as rk

LAYOUTS = [(1, 8), (2, 4), (4, 2), (8, 1)]  # G groups x I ranks
DTYPES = ["float32", "bfloat16", "float16", "int32", "int8", "uint8", "int16", "bool"]
WIDTHS = {"odd": 1001, "aligned": 2048}


@pytest.fixture(autouse=True)
def _fresh_counts():
    yield
    ops.reset_launch_counts()


def _inputs(shape, dtype: str, seed: int):
    """The same values as a numpy array (for JAX) and a tensor (for the
    port); bf16 is rounded from f32 on both sides."""
    rs = np.random.RandomState(seed)
    if dtype == "bool":
        x = rs.rand(*shape) < 0.3
        return x, torch.from_numpy(x)
    if dtype in ("float32", "bfloat16", "float16"):
        x = rs.randn(*shape).astype(np.float32)
        x.flat[::97] = -0.0  # the bytes move, so -0.0 survives where it is kept
        if dtype == "bfloat16":
            return x.astype(ml_dtypes.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
        x = x.astype(dtype)
        return x, torch.from_numpy(x)
    info = np.iinfo(dtype)
    x = rs.randint(info.min, int(info.max) + 1, shape).astype(dtype)
    return x, torch.from_numpy(x)


def _bits(a) -> np.ndarray:
    """Bit patterns of a numpy array or tensor (-0.0 != 0.0)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    a = np.ascontiguousarray(a)
    return a.view({4: np.int32, 2: np.int16, 1: np.int8}[a.itemsize])


def _slabs(t: torch.Tensor, G: int):
    return t.reshape((G, -1) + tuple(t.shape[1:])).unbind(0)


def _same(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _case_seed(G: int, dtype: str, width: str) -> int:
    return 100 * G + 10 * DTYPES.index(dtype) + (width == "odd")


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G,I", LAYOUTS)
def test_grouped_allreduce_equals_per_group(G, I, dtype, width):
    _, x = _inputs((G * I, WIDTHS[width]), dtype, _case_seed(G, dtype, width))
    got = ops.ring_allreduce(x, groups=G)
    want = torch.cat([ops.ring_allreduce_plain(s) for s in _slabs(x, G)])
    _same(got, want)
    assert torch.equal(ops.ring_allreduce_plain(x, G), got)


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G,I", LAYOUTS)
def test_grouped_allgather_equals_per_group(G, I, dtype, width):
    _, x = _inputs((G * I, WIDTHS[width]), dtype, _case_seed(G, dtype, width) + 1)
    got = ops.ring_allgather(x, groups=G)
    assert tuple(got.shape) == (G * I, I, WIDTHS[width])
    want = torch.cat([ops.ring_allgather_plain(s) for s in _slabs(x, G)])
    _same(got, want)
    assert torch.equal(ops.ring_allgather_plain(x, G), got)


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G,I", LAYOUTS)
def test_grouped_broadcast_equals_per_group(G, I, dtype, width):
    root = I - 1  # a non-zero root wherever a group has more than one rank
    _, x = _inputs((G * I, WIDTHS[width]), dtype, _case_seed(G, dtype, width) + 2)
    got = ops.ring_broadcast(x, root, groups=G)
    want = torch.cat([ops.ring_broadcast_plain(s, root) for s in _slabs(x, G)])
    _same(got, want)
    assert torch.equal(ops.ring_broadcast_plain(x, root, G), got)


def _shard_map(fn, p):
    mesh = Mesh(np.array(jax.devices()[:p]), ("mpi",))
    return jax.jit(
        jax.shard_map(fn, mesh=mesh, in_specs=P("mpi"), out_specs=P("mpi"), check_vma=False)
    )


# the JAX kernel of each grouped op on one group's rows, and the port's
# grouped call on all the rows
PALLAS = {
    "allreduce": (lambda I, root: lambda b: jring.ring_allreduce_pallas(
        b, "mpi", axis_size=I, interpret=True),
        lambda x, G, root: ops.ring_allreduce(x, groups=G)),
    "allgather": (lambda I, root: lambda b: jring.ring_allgather_pallas(
        b[0], "mpi", axis_size=I, interpret=True)[None],
        lambda x, G, root: ops.ring_allgather(x, groups=G)),
    "broadcast": (lambda I, root: lambda b: jring.ring_broadcast_pallas(
        b, root, "mpi", axis_size=I, interpret=True),
        lambda x, G, root: ops.ring_broadcast(x, root, groups=G)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "bool"])
@pytest.mark.parametrize("op", list(PALLAS))
@pytest.mark.parametrize("G,I", LAYOUTS)
def test_grouped_matches_pallas_group_by_group(G, I, op, dtype):
    jax_kernel, port = PALLAS[op]
    root = I - 1
    x, tx = _inputs((G * I, WIDTHS["odd"]), dtype, 7 * G + len(op))
    got = port(tx, G, root)
    f = _shard_map(jax_kernel(I, root), I)
    want = np.concatenate([np.asarray(f(x[g * I:(g + 1) * I])) for g in range(G)])
    np.testing.assert_array_equal(_bits(got), _bits(want))


class _FakeRing:
    """Stands in for the built ring library: records each C call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("tm_ring_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args[2:-1])) or 0


@pytest.mark.parametrize("G,I", LAYOUTS[:3])
def test_grouped_wrappers_launch_once(G, I, monkeypatch):
    """The CUDA launch path, with the library, the stream and the device
    check faked (on tensors that hold no data): one call of the C entry
    per grouped call, with the row and group counts and one group's chunk
    layout, and one count each."""
    lib = _FakeRing()
    monkeypatch.setattr(rk, "_lib", lambda: lib)
    monkeypatch.setattr(rk, "_check_cuda", lambda x, what: None)
    monkeypatch.setattr(_build, "launch", lambda device, call, stream=None: call(0))
    n = 100480
    x = torch.empty((G * I, n), device="meta")
    assert ops.ring_allreduce(x, groups=G).shape == x.shape
    assert tuple(ops.ring_allgather(x, groups=G).shape) == (G * I, I, n)
    assert ops.ring_broadcast(x, I - 1, groups=G).shape == x.shape
    chunk = rk.chunk_elems(n, I, torch.float32)
    assert lib.calls == [
        ("tm_ring_allreduce", (rk.NATIVE_DTYPES[torch.float32], G * I, G, n, chunk)),
        ("tm_ring_allgather", (G * I, G, n * 4)),
        ("tm_ring_broadcast", (G * I, G, n * 4, I - 1)),
    ]
    counts = ops.launch_counts()
    assert (counts["ring_allreduce"], counts["ring_allgather"], counts["ring_broadcast"]) == (
        1, 1, 1)


def test_groups_must_split_the_rows():
    x = torch.zeros(8, 5)
    for call in (lambda: ops.ring_allreduce(x, groups=3), lambda: ops.ring_allgather(x, groups=3),
                 lambda: ops.ring_broadcast(x, 0, groups=3),
                 lambda: ops.ring_allreduce(x, groups=0)):
        with pytest.raises(ValueError, match="groups of equal size"):
            call()
    with pytest.raises(ValueError, match="out of range"):
        ops.ring_broadcast(x, 4, groups=2)
