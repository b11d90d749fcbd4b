"""The port's ``ring`` backend and vendor ops
(``torchmpi_tpu_torch.collectives.primitives``) against the JAX package's
``torchmpi_tpu.collectives.primitives``, on the CPU.

The JAX primitives run per device under ``shard_map`` on the 8-device CPU
mesh; the port's take the rank-stacked tensor and run every rank's part
hop by hop. Inputs are made with numpy from a seed and handed to both.

Tolerance: none. Each port primitive keeps its JAX twin's chunk layout
(``_flatten_pad``, the byte-bounded segments, the pipeline segments) and
order of adds, and the wire's rounding as XLA's CPU backend gives it (the
int8 scale as a product with the f32 reciprocal of 127, the decode-and-add
in f64 against XLA's single f32 FMA, which it equals but for a
double-rounding case none of these inputs hits), so every result must be
bitwise equal. The ring is held against ``primitives``, not against the
Pallas kernels, whose int8 blocks differ (ROADMAP section C).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torchmpi_tpu_torch as tmpi
from torchmpi_tpu import constants as jconstants
from torchmpi_tpu.collectives import primitives as jprim
from torchmpi_tpu_torch import constants
from torchmpi_tpu_torch.collectives import primitives as prim


@pytest.fixture(autouse=True)
def _fresh_port():
    yield
    tmpi.runtime_state._reset_for_tests()
    constants._reset_for_tests()


def _shard_map(fn, p):
    mesh = Mesh(np.array(jax.devices()[:p]), ("mpi",))
    return jax.jit(
        jax.shard_map(fn, mesh=mesh, in_specs=P("mpi"), out_specs=P("mpi"),
                      check_vma=False)
    )


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    return a.view({4: np.int32, 2: np.int16, 1: np.int8}[a.itemsize])


def _x(shape, seed, dtype=np.float32):
    x = np.random.RandomState(seed).randn(*shape)
    return (x * 1000).astype(dtype) if np.dtype(dtype).kind == "i" else x.astype(dtype)


ALLREDUCE_CASES = [
    {},
    {"max_bytes_per_step": 1024, "min_bytes_per_step": 512, "num_buffers": 3},
    {"max_bytes_per_step": 700, "num_buffers": 1},
    {"pipeline_depth": 4},
    {"wire_dtype": "int8"},
    {"wire_dtype": "bf16"},
    {"wire_dtype": "int8", "pipeline_depth": 3},
]


@pytest.mark.parametrize("kw", ALLREDUCE_CASES, ids=lambda kw: ",".join(kw) or "plain")
@pytest.mark.parametrize("p", [2, 3, 8])
def test_ring_allreduce_bitwise_matches_primitives(p, kw):
    jconstants.set("wire_quant_min_elements", 1)
    constants.set("wire_quant_min_elements", 1)
    x = _x((p, 5003), seed=p)
    ref = np.asarray(_shard_map(lambda b: jprim.ring_allreduce(b, "mpi", **kw), p)(x))
    out = prim.ring_allreduce(torch.from_numpy(x), **kw)
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    if "wire_dtype" not in kw:
        assert (out == out[0:1]).all()


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_ring_allreduce_segments_and_ints(dtype):
    """Many byte-bounded waves (more segments than buffers) and an int
    payload (exact)."""
    p = 4
    x = _x((p, 3, 1001), seed=7, dtype=dtype)
    kw = {"max_bytes_per_step": 256, "min_bytes_per_step": 128, "num_buffers": 2}
    ref = np.asarray(_shard_map(lambda b: jprim.ring_allreduce(b, "mpi", **kw), p)(x))
    out = prim.ring_allreduce(torch.from_numpy(x), **kw)
    assert out.shape == x.shape
    np.testing.assert_array_equal(_bits(out), _bits(ref))


@pytest.mark.parametrize("wire", [None, "int8", "bf16"])
@pytest.mark.parametrize("p", [2, 3, 8])
def test_ring_reduce_scatter_bitwise_matches_primitives(p, wire):
    jconstants.set("wire_quant_min_elements", 1)
    constants.set("wire_quant_min_elements", 1)
    x = _x((p, 3, 40 * p), seed=10 + p)
    ref = np.asarray(_shard_map(
        lambda b: jprim.ring_reduce_scatter(b, "mpi", dim=-1, wire_dtype=wire), p)(x))
    out = prim.ring_reduce_scatter(torch.from_numpy(x), dim=-1, wire_dtype=wire)
    assert tuple(out.shape) == (p, 3, 40)
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    with pytest.raises(ValueError, match="divisible"):
        prim.ring_reduce_scatter(torch.zeros(p, 3, 40 * p + 1))


@pytest.mark.parametrize("p", [2, 3, 8])
def test_ring_reduce_and_broadcasts_match_primitives(p):
    x = _x((p, 1111), seed=20 + p)
    tx = torch.from_numpy(x)
    for root in sorted({0, 1, p - 1}):
        ref = _shard_map(lambda b: jprim.ring_reduce(b, root, "mpi"), p)(x)
        np.testing.assert_array_equal(_bits(prim.ring_reduce(tx, root)), _bits(np.asarray(ref)))
        for k in (None, 3):
            ref = _shard_map(lambda b: jprim.ring_broadcast(b, root, "mpi", num_chunks=k), p)(x)
            np.testing.assert_array_equal(prim.ring_broadcast(tx, root, num_chunks=k).numpy(),
                                          np.asarray(ref))
        ref = _shard_map(lambda b: jprim.tree_broadcast(b, root, "mpi"), p)(x)
        np.testing.assert_array_equal(prim.tree_broadcast(tx, root).numpy(), np.asarray(ref))


@pytest.mark.parametrize("p", [2, 3, 8])
def test_data_movers_match_primitives(p):
    x3 = _x((p, 3, 4 * p), seed=30 + p)
    t3 = torch.from_numpy(x3)
    for dim in (-1, 0, 1):
        ref = _shard_map(lambda b: jprim.ring_allgather(b, "mpi", dim=dim + 1 if dim >= 0 else dim),
                         p)(x3)
        np.testing.assert_array_equal(prim.ring_allgather(t3, dim=dim).numpy(), np.asarray(ref))
        ref = _shard_map(lambda b: jprim.allgather(b, "mpi", dim=dim + 1 if dim >= 0 else dim),
                         p)(x3)
        np.testing.assert_array_equal(prim.allgather(t3, dim=dim).numpy(), np.asarray(ref))
    xa = _x((p, p, 5), seed=40 + p)
    ta = torch.from_numpy(xa)
    ref = _shard_map(lambda b: jprim.ring_alltoall(b[0], "mpi")[None], p)(xa)
    np.testing.assert_array_equal(prim.ring_alltoall(ta).numpy(), np.asarray(ref))
    ref = _shard_map(lambda b: jprim.alltoall(b, "mpi", split_dim=1, concat_dim=1), p)(xa)
    np.testing.assert_array_equal(prim.alltoall(ta).numpy(), np.asarray(ref))
    ref = _shard_map(lambda b: jprim.sendreceive(b, 0, p - 1, "mpi"), p)(x3)
    np.testing.assert_array_equal(prim.sendreceive(t3, 0, p - 1).numpy(), np.asarray(ref))


@pytest.mark.parametrize("p", [2, 3, 8])
def test_vendor_reductions_match_primitives(p):
    """The vendor path sums in another order than XLA's psum: f32 within
    rtol 1e-6, ints exact."""
    for dtype in (np.float32, np.int32):
        x = _x((p, 3, 8 * p), seed=50 + p, dtype=dtype)
        tx = torch.from_numpy(x)
        for ours, ref_fn in (
            (prim.allreduce(tx), lambda b: jprim.allreduce(b, "mpi")),
            (prim.reduce(tx, p - 1), lambda b: jprim.reduce(b, p - 1, "mpi")),
            (prim.reduce_scatter(tx), lambda b: jprim.reduce_scatter(b, "mpi", dim=b.ndim - 1)),
        ):
            ref = np.asarray(_shard_map(ref_fn, p)(x))
            assert ours.shape == ref.shape
            if dtype == np.int32:
                np.testing.assert_array_equal(ours.numpy(), ref)
            else:
                np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_ring_leaves_its_input_alone():
    x = torch.from_numpy(_x((3, 6, 300), seed=60))
    before = x.clone()
    constants.set("wire_quant_min_elements", 1)
    prim.ring_allreduce(x)
    prim.ring_allreduce(x, wire_dtype="int8")
    prim.ring_reduce_scatter(x, wire_dtype="int8")
    prim.ring_reduce_scatter(x)
    prim.ring_reduce(x, 1)
    prim.ring_broadcast(x, 2)
    prim.ring_allgather(x)
    assert torch.equal(x, before)


def test_single_rank_and_float64():
    one = torch.ones(1, 9)
    for fn in (prim.ring_allreduce, prim.ring_allgather, prim.ring_reduce_scatter,
               prim.ring_broadcast, prim.tree_broadcast, prim.ring_alltoall):
        assert fn(one) is one
    # the ring carries what the kernels refuse: f64 sums in f64
    x = torch.from_numpy(np.random.RandomState(1).randn(3, 500))
    np.testing.assert_allclose(prim.ring_allreduce(x)[0].numpy(), x.sum(0).numpy(),
                               rtol=1e-12, atol=1e-12)
