"""The port's kernel modules (``torchmpi_tpu_torch.ops``) against the JAX
package's Pallas kernels, on the CPU.

Here the port's wrappers run their plain PyTorch versions (a CPU tensor),
and the JAX kernels run in Pallas interpret mode under ``shard_map`` on the
8-device CPU mesh, as ``tests/test_ops.py`` runs them. Inputs are made with
numpy from a seed and handed to both.

Tolerance: none. The ring allreduce keeps the JAX ring's chunk layout and
order of adds, so its f32 results must be bitwise equal to
``ring_allreduce_pallas``; integer, broadcast and accumulate results must
be exactly equal too.
"""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torchmpi_tpu_torch as tmpi
from torchmpi_tpu.ops import reduce_kernel as jreduce
from torchmpi_tpu.ops import ring_kernels as jring
from torchmpi_tpu_torch import ops
from torchmpi_tpu_torch.ops import _build
from torchmpi_tpu_torch.ops import ring_kernels as tring


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


def _jax_ring_allreduce(x: np.ndarray) -> np.ndarray:
    p = x.shape[0]
    f = _shard_map(
        lambda b: jring.ring_allreduce_pallas(b, "mpi", axis_size=p, interpret=True), p
    )
    return np.asarray(f(x))


def _port_allreduce(x: np.ndarray) -> np.ndarray:
    """The port's eager allreduce pinned to the kernel backend, with the
    small-message cutoff off so every size reaches the ring."""
    tmpi.start(ranks=x.shape[0], device="cpu")
    tmpi.constants.set("small_allreduce_size_cpu", 0)
    try:
        out = tmpi.allreduce_tensor(torch.from_numpy(x), backend="kernel")
    finally:
        tmpi.stop()
    return out.numpy()


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("n", [1000, 1024, 8 * 128 * 8 + 3])
def test_ring_allreduce_bitwise_matches_pallas(p, n):
    x = np.random.RandomState(p * 1000 + n).randn(p, n).astype(np.float32)
    out = _port_allreduce(x)
    ref = _jax_ring_allreduce(x)
    assert out.shape == ref.shape == (p, n)
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


def test_ring_allreduce_order_is_visible():
    """The layout matters: at p=3 a sum started at rank 0 everywhere gives
    other bits than the ring on some elements, so the bitwise test above
    would catch a wrong chunk layout."""
    p, n = 3, 8 * 128 * 8 + 3
    x = np.random.RandomState(p * 1000 + n).randn(p, n).astype(np.float32)
    naive = (x[0] + x[1]) + x[2]
    assert (_port_allreduce(x)[0] != naive).any()


def test_ring_allreduce_closed_form_int32():
    """Rank r contributes base + r; the sum is exact (above 2^24, where an
    f32 carrier would round) and equals JAX's."""
    p, n = 3, 5000
    x = ((1 << 24) + np.arange(p, dtype=np.int64)[:, None] + np.zeros((p, n), np.int64)).astype(np.int32)
    out = _port_allreduce(x)
    np.testing.assert_array_equal(out, np.full((p, n), p * (1 << 24) + p * (p - 1) // 2))
    np.testing.assert_array_equal(out, _jax_ring_allreduce(x))


@pytest.mark.parametrize(
    "dtype", [torch.int8, torch.uint8, torch.int16, torch.uint16, torch.bool, torch.bfloat16]
)
def test_ring_allreduce_dtype_contract(dtype):
    """Native types add (and wrap) in their own type; i16/u16/bool ride an
    i32 carrier and come back in their own dtype."""
    rs = np.random.RandomState(7)
    if dtype == torch.bool:
        x = torch.from_numpy(rs.rand(3, 700) < 0.3)
        expect = x.any(0)
    elif dtype == torch.bfloat16:
        x = torch.from_numpy(rs.randn(3, 700).astype(np.float32)).to(dtype)
        # chunk 0 holds all 700 elements: the sum starts at rank 0
        expect = (x[0] + x[1]) + x[2]
    else:
        info = torch.iinfo(dtype)
        x = torch.from_numpy(rs.randint(info.min, info.max + 1, (3, 700))).to(dtype)
        expect = x.to(torch.int64).sum(0).to(dtype)
    out = ops.ring_allreduce(x)
    assert out.dtype == dtype
    for r in range(3):
        assert torch.equal(out[r], expect)


def test_float64_and_complex_raise():
    for dtype in (torch.float64, torch.complex64, torch.int64):
        with pytest.raises(ValueError, match="not supported"):
            ops.ring_allreduce(torch.zeros(2, 10, dtype=dtype))
    # the eager kernel backend routes such a reduction to the ring backend,
    # which sums f64 in f64, as the JAX package falls back to its ppermute ring
    tmpi.start(ranks=2, device="cpu")
    tmpi.constants.set("small_allreduce_size_cpu", 0)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 10))
    out = tmpi.allreduce_tensor(x, backend="kernel")
    assert out.dtype == torch.float64 and torch.equal(out, (x[0] + x[1]).expand(2, 10))


@pytest.mark.parametrize(
    "n,p,dtype",
    [(857738, 8, torch.float32), (1000, 2, torch.float32), (8195, 3, torch.float32),
     (10**7, 8, torch.float32), (123457, 5, torch.bfloat16), (3, 2, torch.int8),
     (999999, 3, torch.uint8), (4096, 4, torch.int32)],
)
def test_chunk_layout_is_the_jax_wrappers(n, p, dtype):
    """chunk_elems is _segmented's seg_rows * 128 for the same inputs."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    jdtype = {4: np.float32, 2: np.float16, 1: np.int8}[itemsize]
    min_rows = jring._min_rows(jdtype)
    rows = jring._tile_rows(-(-n // p), jdtype)
    seg_rows = min(rows, jring._max_rows(p, itemsize, min_rows))
    assert tring.chunk_elems(n, p, dtype) == seg_rows * 128


def test_lenet_layout():
    """LeNet's fused gradients at p=8: one segment of 8 chunks of 840 rows."""
    assert tring.chunk_elems(857738, 8, torch.float32) == 840 * 128 == 107520


@pytest.mark.parametrize("root", [0, 1, 2])
def test_ring_broadcast_matches_pallas(root):
    p = 3
    x = np.random.RandomState(root).randn(p, 1500).astype(np.float32)
    x[root, :7] = -0.0
    f = _shard_map(
        lambda b: jring.ring_broadcast_pallas(b, root, "mpi", axis_size=p, interpret=True), p
    )
    ref = np.asarray(f(x))
    tmpi.start(ranks=p, device="cpu")
    tmpi.constants.set("small_broadcast_size_cpu", 0)
    out = tmpi.broadcast_tensor(torch.from_numpy(x), root=root, backend="kernel").numpy()
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    assert np.signbit(out[:, :7]).all()


@pytest.mark.parametrize("dtype", [torch.bool, torch.bfloat16, torch.float64, torch.int16])
def test_ring_broadcast_any_dtype(dtype):
    x = torch.from_numpy(np.random.RandomState(3).randn(4, 333)).to(dtype)
    out = ops.ring_broadcast(x, 3)
    assert out.dtype == dtype and torch.equal(out, x[3:4].expand_as(x))
    with pytest.raises(ValueError, match="out of range"):
        ops.ring_broadcast(x, 4)


@pytest.mark.parametrize("shape", [(317, 53), (3 * 1024 * 128 + 17,)])
def test_accumulate_matches_pallas(shape):
    rs = np.random.RandomState(0)
    a = rs.randn(*shape).astype(np.float32)
    b = rs.randn(*shape).astype(np.float32)
    ref = np.asarray(jreduce.accumulate(a, b, interpret=True))
    out = ops.accumulate(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_accumulate_casts_input_and_checks_shape():
    out = ops.accumulate(torch.ones(5, dtype=torch.int32), torch.full((5,), 2.7))
    assert out.dtype == torch.int32 and out.tolist() == [3] * 5
    with pytest.raises(ValueError, match="equal shapes"):
        ops.accumulate(torch.ones(5), torch.ones(4))


@pytest.mark.parametrize("alpha", [-0.25, 0.1, -0.0125, 0.0, 1.0])
@pytest.mark.parametrize("shape", [(1000,), (3 * 1024 * 128 + 17,)])
def test_scale_accumulate_bitwise_matches_pallas(shape, alpha):
    """f32: one rounding, as the interpret-mode kernel (an FMA), bit for bit
    at test_ops.py's shape and a multiblock ragged one."""
    rs = np.random.RandomState(1)
    a = rs.randn(*shape).astype(np.float32)
    b = rs.randn(*shape).astype(np.float32)
    ref = np.asarray(jreduce.scale_accumulate(a, b, alpha, interpret=True))
    out = ops.scale_accumulate(torch.from_numpy(a), torch.from_numpy(b), alpha).numpy()
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


def test_scale_accumulate_rounds_once_in_f32():
    """The one rounding is visible: numpy's a + f32(alpha) * b rounds twice
    and differs on some elements, so the bitwise test above would catch a
    two-rounding plain version."""
    rs = np.random.RandomState(1)
    a, b = rs.randn(2, 65536).astype(np.float32)
    out = ops.scale_accumulate(torch.from_numpy(a), torch.from_numpy(b), 0.1).numpy()
    assert (out != a + np.float32(0.1) * b).any()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("alpha", [-0.25, 0.1, -0.0125, 0.3])
def test_scale_accumulate_half_types_match_pallas(dtype, alpha):
    """Pins how the interpret-mode kernel rounds the half types: bf16 after
    the product and after the sum, f16 once (product and sum in f32)."""
    import jax.numpy as jnp

    rs = np.random.RandomState(2)
    a, b = (jnp.asarray(rs.randn(65536).astype(np.float32)).astype(dtype) for _ in range(2))
    ref = np.asarray(jreduce.scale_accumulate(a, b, alpha, interpret=True).astype(jnp.float32))
    ta, tb = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))
              for x in (a, b))
    out = ops.scale_accumulate(ta, tb, alpha)
    assert out.dtype == ta.dtype
    np.testing.assert_array_equal(out.float().numpy(), ref)
    # the other rounding would differ: the test tells the two apart
    al = float(torch.tensor(alpha, dtype=ta.dtype))
    other = ((ta.float() + al * tb.float()).to(ta.dtype) if dtype == "bfloat16"
             else (ta.float() + (al * tb.float()).to(ta.dtype).float()).to(ta.dtype))
    if alpha != -0.25:  # a power of two: both roundings agree
        assert (other.float().numpy() != ref).any()


def test_scale_accumulate_f64_is_one_rounding():
    """f64 (the parameter server's f64 shards): the correctly rounded
    fma(alpha, b, a), held against exact rational arithmetic, cancellation
    cases included."""
    from fractions import Fraction

    rs = np.random.RandomState(3)
    alpha = 1 / 3
    b = rs.randn(3000) * np.exp2(rs.randint(-30, 30, 3000))
    a = rs.randn(3000) * np.exp2(rs.randint(-60, 60, 3000))
    a[:1000] = -(alpha * b[:1000]) * (1 + rs.randint(-3, 4, 1000) * 2.0**-52)
    out = ops.scale_accumulate(torch.from_numpy(a), torch.from_numpy(b), alpha).numpy()
    exact = [float(Fraction(x) + Fraction(alpha) * Fraction(y)) for x, y in zip(a, b)]
    np.testing.assert_array_equal(out, np.array(exact))
    assert (out != a + alpha * b).any()


def test_scale_accumulate_in_place_and_checks():
    """out_ may be the first input (a rule applied in place); integer
    dtypes raise, as do mismatched shapes and destinations."""
    rs = np.random.RandomState(4)
    base = torch.from_numpy(rs.randn(1001).astype(np.float32))
    shard = base[3:700]  # a view at an odd element offset
    inc = torch.from_numpy(rs.randn(697).astype(np.float32))
    want = ops.scale_accumulate(shard, inc, -0.5)
    got = ops.scale_accumulate(shard, inc, -0.5, out_=shard)
    assert got.data_ptr() == shard.data_ptr() and torch.equal(shard, want)
    acc = base[5:20].clone()
    ops.accumulate(acc, torch.ones(15), out_=acc)
    assert torch.equal(acc, base[5:20] + 1)
    with pytest.raises(ValueError, match="float32, bfloat16"):
        ops.scale_accumulate(torch.ones(5, dtype=torch.int32), torch.ones(5), 2.0)
    with pytest.raises(ValueError, match="equal shapes"):
        ops.scale_accumulate(torch.ones(5), torch.ones(4), 2.0)
    with pytest.raises(ValueError, match="out_ must match"):
        ops.scale_accumulate(torch.ones(5), torch.ones(5), 2.0, out_=torch.ones(4))


def test_wrappers_launch_or_raise_off_the_cpu():
    """A tensor that is on neither the CPU nor a CUDA card gets no quiet
    fallback to a plain version."""
    x = torch.empty(2, 8, device="meta")
    a = torch.empty(2, 1, 4, 1, 8, device="meta")  # [sp, b, n, h, d]
    lse = torch.empty(2, 1, 1, 4, device="meta")
    for call in (lambda: ops.ring_allreduce(x), lambda: ops.ring_broadcast(x),
                 lambda: ops.accumulate(x, x),
                 lambda: ops.scale_accumulate(x, x, 0.5),
                 lambda: ops.accumulate(x, x, out_=x),
                 lambda: ops.scale_accumulate(x, x, 0.5, out_=x),
                 lambda: ops.ring_allreduce_quant(x, "int8"),
                 lambda: ops.ring_reduce_scatter_quant(x, "bf16"),
                 lambda: ops.ring_attention_fwd(a, a, a, bidir=True),
                 lambda: ops.ring_attention_bwd(a, a, a, a, lse, a),
                 lambda: ops.ring_allreduce_xproc([x[0], x[1]], 1),
                 lambda: ops.ring_broadcast_xproc(x[0], 2),
                 lambda: ops.ring_reduce_scatter_xproc([x[0], x[1]], [1]),
                 lambda: ops.ring_allgather_xproc([x[0], x[1]], 1),
                 lambda: ops.ring_allreduce_quant_xproc([x[0], x[1]], [1], "int8"),
                 lambda: ops.ring_reduce_scatter_quant_xproc([x[0], x[1]], [0], "bf16"),
                 lambda: ops.ring_allreduce_bidir_xproc([x[0], x[1]], 1),
                 lambda: ops.ring_reduce_xproc([x[0], x[1]], [1], 1),
                 lambda: ops.conv2d_weight_grad_ranks(
                     torch.empty(2, 1, 3, 6, 6, device="meta"),
                     torch.empty(2, 1, 4, 4, 4, device="meta"), (4, 3, 3, 3)),
                 lambda: ops.rank_bmm(torch.empty(2, 3, 4, device="meta"),
                                      torch.empty(2, 4, 5, device="meta"))):
        with pytest.raises(ValueError, match="CUDA or the CPU"):
            call()
    counts = ops.launch_counts()
    assert set(counts) == {"ring_allreduce", "ring_broadcast", "accumulate", "scale_accumulate",
                           "ring_reduce_scatter", "ring_allgather", "ring_reduce",
                           "ring_allreduce_bidir", "ring_allreduce_xproc",
                           "ring_broadcast_xproc", "ring_reduce_scatter_xproc",
                           "ring_allreduce_xproc_grouped", "ring_broadcast_xproc_grouped",
                           "ring_allgather_xproc", "ring_allreduce_bidir_xproc",
                           "ring_reduce_xproc", "ring_attention_fwd",
                           "ring_attention_fwd_bidir", "ring_attention_bwd",
                           "conv2d_weight_grad_ranks", "rank_bmm"} | {
        f"{op}_{wire}" for op in ("ring_allreduce_quant", "ring_reduce_scatter_quant",
                                  "ring_allreduce_quant_xproc",
                                  "ring_reduce_scatter_quant_xproc")
        for wire in ("int8", "bf16")
    }
    assert not any(counts.values())


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has /usr/local/cuda")
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.nvcc_path()


def test_build_is_keyed_on_the_sources():
    names = {_build.target(s).name for s in _build.SOURCES}
    assert len(names) == len(_build.SOURCES) == 6
    assert all(n.startswith("lib") and n.endswith(".so") for n in names)
    assert _build.target("ring_kernels").parent == _build.BUILD_DIR

