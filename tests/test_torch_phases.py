"""The port's reduce-scatter, allgather, reduce and bidirectional allreduce
kernels (``torchmpi_tpu_torch.ops``) against the JAX package's Pallas
kernels, on the CPU.

The port's wrappers run their plain PyTorch versions here (a CPU tensor);
``ring_reduce_scatter_pallas``, ``ring_allgather_pallas``,
``ring_reduce_pallas`` and ``ring_allreduce_bidir_pallas`` run in Pallas
interpret mode under ``shard_map`` on the 8-device CPU mesh, as
``tests/test_ops.py`` runs them. Inputs are made with numpy from a seed and
handed to both.

Tolerance: none. The plain versions keep the JAX kernels' chunk layouts
and order of adds (reduce-scatter: segment s from rank s + 1 rightward;
reduce: the allreduce's layout; bidir: half A rightward and half B leftward
in ``_segmented_pair_ready``'s layout), so f32 and bf16 results must be
bitwise equal, and integers and the byte-moving allgather exactly equal.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torchmpi_tpu_torch as tmpi
from torchmpi_tpu.ops import ring_kernels as jring
from torchmpi_tpu_torch import ops
from torchmpi_tpu_torch.ops import ring_kernels as tring

DTYPES = ["float32", "int32", "bfloat16"]


@pytest.fixture(autouse=True)
def _fresh_port():
    yield
    tmpi.runtime_state._reset_for_tests()
    tmpi.constants._reset_for_tests()
    ops.reset_launch_counts()


def _shard_map(fn, p):
    mesh = Mesh(np.array(jax.devices()[:p]), ("mpi",))
    return jax.jit(
        jax.shard_map(fn, mesh=mesh, in_specs=P("mpi"), out_specs=P("mpi"),
                      check_vma=False)
    )


def _inputs(shape, dtype: str, seed: int):
    """The same values as a numpy array (for JAX) and a tensor (for the
    port); bf16 goes through f32 on both sides."""
    x = np.random.RandomState(seed).randn(*shape)
    if dtype == "int32":
        x = (x * 1000).astype(np.int32)
        return x, torch.from_numpy(x)
    x = x.astype(np.float32)
    if dtype == "bfloat16":
        return x.astype(ml_dtypes.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return x, torch.from_numpy(x)


def _bits(a) -> np.ndarray:
    """Bit patterns of a numpy array or tensor (-0.0 != 0.0)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    a = np.ascontiguousarray(a)
    return a.view({4: np.int32, 2: np.int16, 1: np.int8}[a.itemsize])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_reduce_scatter_bitwise_matches_pallas(p, dtype):
    seg = 300  # ragged: not a multiple of 128 lanes
    x, tx = _inputs((p, p * seg), dtype, seed=p)
    ref = np.asarray(_shard_map(
        lambda b: jring.ring_reduce_scatter_pallas(
            b.reshape(p * seg), "mpi", axis_size=p, interpret=True), p)(x))
    out = ops.ring_reduce_scatter(tx)
    assert tuple(out.shape) == (p, seg) and out.dtype == tx.dtype
    np.testing.assert_array_equal(_bits(out), _bits(ref.reshape(p, seg)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_allgather_bitwise_matches_pallas(p, dtype):
    x, tx = _inputs((p, 7, 33), dtype, seed=10 + p)
    if dtype != "int32":
        x[:, 0, 0] = -0.0  # the bytes move, so -0.0 survives
        tx[:, 0, 0] = -0.0
    ref = np.asarray(_shard_map(
        lambda b: jring.ring_allgather_pallas(b[0], "mpi", axis_size=p, interpret=True)[None],
        p)(x))
    out = ops.ring_allgather(tx)
    assert tuple(out.shape) == (p, p, 7, 33) and out.dtype == tx.dtype
    np.testing.assert_array_equal(_bits(out), _bits(ref))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p,roots", [(2, (1,)), (3, (0, 1, 2)), (4, (3,)), (8, (0, 5))])
def test_reduce_bitwise_matches_pallas(p, roots, dtype):
    x, tx = _inputs((p, 1001), dtype, seed=20 + p)
    for root in roots:
        ref = np.asarray(_shard_map(
            lambda b: jring.ring_reduce_pallas(b, root, "mpi", axis_size=p, interpret=True),
            p)(x))
        out = ops.ring_reduce(tx, root)
        np.testing.assert_array_equal(_bits(out), _bits(ref))
        # the root's row is the allreduce's, every other row the input
        assert torch.equal(out[root], ops.ring_allreduce(tx)[root])
        others = [r for r in range(p) if r != root]
        assert torch.equal(out[others], tx[others])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_bidir_allreduce_bitwise_matches_pallas(p, dtype):
    n = 8 * 128 * 3 + 5  # odd: half B is one element short of half A
    x, tx = _inputs((p, n), dtype, seed=30 + p)
    ref = np.asarray(_shard_map(
        lambda b: jring.ring_allreduce_bidir_pallas(b, "mpi", axis_size=p, interpret=True),
        p)(x))
    out = ops.ring_allreduce_bidir(tx)
    assert out.shape == tx.shape and out.dtype == tx.dtype
    np.testing.assert_array_equal(_bits(out), _bits(ref))


def test_orders_are_visible():
    """At p=3 the start ranks matter: a sum started at rank 0 everywhere
    differs from each kernel's ring order on some elements, so the bitwise
    tests above would catch an off-by-one that p=2 hides."""
    p, seg = 3, 4000
    x = torch.from_numpy(np.random.RandomState(0).randn(p, p * seg).astype(np.float32))
    naive = (x[0] + x[1]) + x[2]
    rs = ops.ring_reduce_scatter(x)
    assert (rs.reshape(-1) != naive).any()
    # segment 0 starts at rank 1: ((x1 + x2) + x0)
    s0 = slice(0, seg)
    assert torch.equal(rs[0], (x[1, s0] + x[2, s0]) + x[0, s0])
    bidir = ops.ring_allreduce_bidir(x)[0]
    assert (bidir != naive).any()
    # chunk 0 of half A starts at rank 0 rightward, chunk 0 of half B at
    # rank 0 leftward ((x0 + x2) + x1)
    half = (p * seg + 1) // 2
    c = tring.bidir_chunk_elems(half, p, torch.float32)
    assert c < half
    assert torch.equal(bidir[:c], naive[:c])
    b = slice(half, half + c)
    assert torch.equal(bidir[b], (x[0, b] + x[2, b]) + x[1, b])


@pytest.mark.parametrize(
    "half,p,dtype",
    [(428869, 8, torch.float32), (3, 3, torch.float32), (4194304, 8, torch.float32),
     (513 // 2 + 1, 4, torch.bfloat16), (10**6, 5, torch.int8), (777, 2, torch.int32)],
)
def test_bidir_layout_is_the_jax_wrappers(half, p, dtype):
    """bidir_chunk_elems is _segmented_pair_ready's seg_rows * 128 for the
    same half-buffer, and the segment count follows from it."""
    jdtype = {torch.float32: np.float32, torch.bfloat16: np.float16,
              torch.int8: np.int8, torch.int32: np.int32}[dtype]
    segs, seg_rows = jring._segmented_pair_ready(np.zeros(half, jdtype), p, jdtype)
    c = tring.bidir_chunk_elems(half, p, dtype)
    assert c == seg_rows * 128
    assert len(segs) == -(-half // (p * c))


def test_reduce_scatter_checks_and_dtypes():
    with pytest.raises(ValueError, match="divide"):
        ops.ring_reduce_scatter(torch.zeros(3, 10))
    # i16 rides an i32 carrier and comes back exact; p == 1 is the input
    x = torch.from_numpy(np.random.RandomState(1).randint(-300, 300, (4, 8, 5))).to(torch.int16)
    out = ops.ring_reduce_scatter(x)
    assert out.dtype == torch.int16 and tuple(out.shape) == (4, 2, 5)
    assert torch.equal(out, x.sum(0, dtype=torch.int16).reshape(4, 2, 5))
    one = torch.ones(1, 6)
    assert ops.ring_reduce_scatter(one) is one
    with pytest.raises(ValueError, match="not supported"):
        ops.ring_reduce_scatter(torch.zeros(2, 4, dtype=torch.float64))


def test_reduce_scatter_wire_runs_the_quantized_ring():
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 600).astype(np.float32))
    for wire in ("int8", "bf16"):
        assert torch.equal(ops.ring_reduce_scatter(x, wire),
                           ops.ring_reduce_scatter_quant(x, wire))


@pytest.mark.parametrize("dtype", [torch.bool, torch.float64, torch.int64, torch.uint8])
def test_allgather_any_dtype_as_bytes(dtype):
    x = torch.from_numpy(np.random.RandomState(3).randn(3, 41) > 0).to(dtype)
    out = ops.ring_allgather(x)
    assert out.dtype == dtype and torch.equal(out, x.expand(3, 3, 41))
    with pytest.raises(ValueError, match="complex"):
        ops.ring_allgather(torch.zeros(2, 3, dtype=torch.complex64))


def test_reduce_and_bidir_checks():
    with pytest.raises(ValueError, match="out of range"):
        ops.ring_reduce(torch.zeros(3, 10), 3)
    one = torch.ones(1, 6)
    assert ops.ring_reduce(one, 0) is one and ops.ring_allreduce_bidir(one) is one
    b = torch.from_numpy(np.random.RandomState(4).rand(4, 300) < 0.3)
    assert torch.equal(ops.ring_reduce(b, 2)[2], b.any(0))
    assert torch.equal(ops.ring_allreduce_bidir(b), b.any(0).expand(4, 300))
    with pytest.raises(ValueError, match="not supported"):
        ops.ring_allreduce_bidir(torch.zeros(3, 4, dtype=torch.float64))


def test_new_wrappers_launch_or_raise_off_the_cpu():
    """A tensor that is on neither the CPU nor a CUDA card gets no quiet
    fallback to a plain version, and nothing counts as a launch."""
    x = torch.empty(2, 8, device="meta")
    for call in (lambda: ops.ring_reduce_scatter(x), lambda: ops.ring_allgather(x),
                 lambda: ops.ring_reduce(x, 0), lambda: ops.ring_allreduce_bidir(x),
                 lambda: ops.ring_allreduce_bidir(torch.empty(3, 8, device="meta"))):
        with pytest.raises(ValueError, match="CUDA or the CPU"):
            call()
    assert not any(ops.launch_counts().values())
