"""The port's compressed wire (``torchmpi_tpu_torch``: the quantized ring,
the codec, the wire routing) against the JAX package, on the CPU.

The port's quantized ring wrappers run their plain PyTorch versions here
(a CPU tensor), and ``ring_allreduce_pallas`` / ``ring_reduce_scatter_pallas``
with ``wire_dtype=`` run ``_ring_quant_kernel`` in Pallas interpret mode
under ``shard_map``, as ``tests/test_wire_formats.py`` runs them. Inputs are
made with numpy from a seed and handed to both.

Tolerance: none. The plain version keeps the JAX wrapper's 128-row chunk
layout, the hop order and the rounding XLA's CPU backend gives the JAX
kernel (a product with the f32 reciprocal of 127 for the scale; the
decode-and-add rounded once, as XLA's single f32 FMA), so every rank's
result must be bitwise equal, on random payloads and on rows built so that
rounding the decode-and-add twice would differ
(``utils.tester.wire_midpoint_rows``). The codec and the routing decisions
are checked as values (exact).
"""

from fractions import Fraction

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torchmpi_tpu_torch as tmpi
from torchmpi_tpu import constants as jconstants
from torchmpi_tpu.collectives import eager as jeager
from torchmpi_tpu.collectives import primitives as jprim
from torchmpi_tpu.ops import ring_kernels as jring
from torchmpi_tpu_torch import constants, ops
from torchmpi_tpu_torch.collectives import CollectiveArgumentError, eager, primitives
from torchmpi_tpu_torch.ops import ring_kernels as tring
from torchmpi_tpu_torch.utils import tester


@pytest.fixture(autouse=True)
def _fresh_port():
    yield
    tmpi.runtime_state._reset_for_tests()
    constants._reset_for_tests()
    ops.reset_launch_counts()


def _engage_all():
    """Drop the min-elements cutoff in both packages so small payloads
    engage the wire (``tests/test_wire_formats.py:_engage_all``)."""
    jconstants.set("wire_quant_min_elements", 1)
    constants.set("wire_quant_min_elements", 1)


def _shard_map(fn, p):
    mesh = Mesh(np.array(jax.devices()[:p]), ("mpi",))
    return jax.jit(
        jax.shard_map(fn, mesh=mesh, in_specs=P("mpi"), out_specs=P("mpi"),
                      check_vma=False)
    )


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.int32)


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("wire", ["int8", "bf16"])
@pytest.mark.parametrize("n", [4096, 5000])  # tile-even and ragged
def test_quant_allreduce_bitwise_matches_pallas(p, wire, n):
    _engage_all()
    x = np.random.RandomState(p * 13 + n).randn(p, n).astype(np.float32)
    ref = np.asarray(_shard_map(
        lambda b: jring.ring_allreduce_pallas(
            b, "mpi", axis_size=p, interpret=True, wire_dtype=wire), p)(x))
    out = ops.ring_allreduce_quant(torch.from_numpy(x), wire).numpy()
    assert out.shape == ref.shape == (p, n)
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    assert ops.launch_counts()[f"ring_allreduce_quant_{wire}"] == 0  # plain on the CPU
    # the owner keeps its f32 sum, the others the wire's decoding: ranks
    # differ, by the wire's rounding only
    assert (out != out[0:1]).any()
    assert np.abs(out - x.sum(0)).max() <= 1e-2 * np.abs(x.sum(0)).max()


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("wire", ["int8", "bf16"])
def test_quant_reduce_scatter_bitwise_matches_pallas(p, wire):
    _engage_all()
    seg = 600  # ragged: not a multiple of 128 lanes
    x = np.random.RandomState(5 + p).randn(p, p * seg).astype(np.float32)
    ref = np.asarray(_shard_map(
        lambda b: jring.ring_reduce_scatter_pallas(
            b[0].reshape(p, seg), "mpi", axis_size=p, interpret=True,
            wire_dtype=wire)[None], p)(x.reshape(p, 1, p * seg)))
    out = ops.ring_reduce_scatter_quant(torch.from_numpy(x.reshape(p, p, seg)), wire)
    assert tuple(out.shape) == (p, 1, seg)
    np.testing.assert_array_equal(_bits(out.numpy().reshape(p, seg)), _bits(ref.reshape(p, seg)))


def _pallas_quant(x: np.ndarray, p: int, mode: str, wire: str) -> np.ndarray:
    """The interpret-mode Pallas kernel on the rank-stacked ``x``: the
    allreduce of ``[p, n]``, or the reduce-scatter of ``[p, p*seg]`` as
    ``[p, seg]``."""
    if mode == "allreduce":
        return np.asarray(_shard_map(
            lambda b: jring.ring_allreduce_pallas(
                b, "mpi", axis_size=p, interpret=True, wire_dtype=wire), p)(x))
    seg = x.shape[1] // p
    return np.asarray(_shard_map(
        lambda b: jring.ring_reduce_scatter_pallas(
            b[0].reshape(p, seg), "mpi", axis_size=p, interpret=True,
            wire_dtype=wire)[None], p)(x.reshape(p, 1, p * seg))).reshape(p, seg)


def _port_quant(x: np.ndarray, p: int, mode: str, wire: str) -> np.ndarray:
    if mode == "allreduce":
        return ops.ring_allreduce_quant(torch.from_numpy(x), wire).numpy()
    out = ops.ring_reduce_scatter_quant(torch.from_numpy(x.reshape(p, p, -1)), wire)
    return out.numpy().reshape(p, -1)


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("wire", ["int8", "bf16"])
@pytest.mark.parametrize("mode,n", [("allreduce", 4096), ("allreduce", 5000), ("rs", 600)])
def test_quant_rounds_once_like_pallas(p, wire, mode, n):
    """On rows whose last reduce-scatter hop puts a code's exact product on
    an f32 midpoint and a tiny local value beside it, the plain version
    rounds the decode-and-add once, as the interpret-mode kernel's f32 FMA
    does: every rank's result bitwise equal (the bf16 wire takes the same
    rows as an ordinary input)."""
    _engage_all()
    x = tester.wire_midpoint_rows(p, n, mode, seed=p)
    ref = _pallas_quant(x, p, mode, wire)
    out = _port_quant(x, p, mode, wire)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(_bits(out), _bits(ref))


def test_quant_rounds_once_on_the_reported_row():
    """The input that showed the double rounding: rank 0's row sets the
    scale s = 0.012620185 and holds RN(5 s), whose exact 5 s lies halfway
    between two f32 values; rank 1 adds 2^-60 there. The FMA rounds the sum
    up to bits 1031879439 at rank 1 (the owner); the old f64 sum fell back
    on the midpoint and rounded to even, 1031879438."""
    _engage_all()
    x = np.full((2, 256), 0.5, np.float32)
    x[0, 0] = np.float32(1.6027634)
    s = np.float32(x[0, 0]) * (np.float32(1) / np.float32(127))
    assert s == np.float32(0.012620185)
    x[0, 1] = np.float32(5 * s)
    x[1, :] = 0.25
    x[1, 1] = 2.0**-60
    ref = _pallas_quant(x, 2, "allreduce", "int8")
    out = _port_quant(x, 2, "allreduce", "int8")
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    assert _bits(out)[1, 1] == 1031879439


def _round_f32(r: Fraction) -> np.float32:
    """The exact rational ``r`` rounded to the nearest f32, ties to even."""
    c = np.float32(float(r))
    cands = [np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - r), int(_bits(np.array([v]))[0]) & 1))


def test_decode_add_rounds_once():
    """``_decode_add`` on int8 codes is ``local + code*scale`` rounded once
    to f32: against the exact rational sum rounded to the nearest f32 (ties
    to even), over 2,000 seeded midpoint triples, on which rounding in f64
    first gives the other neighbour, and 2,000 random ones (scales over 60
    binades, locals from far smaller to far larger than the product)."""
    rng = np.random.RandomState(8)
    _, s1, q1, l1 = tester.wire_midpoint_triples(2000, rng)
    s2 = np.exp(rng.uniform(-30, 30, 2000)).astype(np.float32)
    q2 = rng.randint(-127, 128, 2000)
    l2 = (rng.randn(2000) * s2 * np.exp(rng.uniform(-40, 10, 2000))).astype(np.float32)
    scale = np.concatenate([s1, s2])
    codes = np.concatenate([q1, q2]).astype(np.float32)
    local = np.concatenate([l1, l2])
    got = tring._decode_add(torch.from_numpy(codes), torch.from_numpy(scale),
                            torch.from_numpy(local)).numpy()
    want = np.array([_round_f32(Fraction(float(q)) * Fraction(float(s)) + Fraction(float(v)))
                     for q, s, v in zip(codes, scale, local)], np.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the midpoint triples are the ones two roundings get wrong
    twice = (codes[:2000].astype(np.float64) * scale[:2000] + local[:2000]).astype(np.float32)
    assert (_bits(twice) != _bits(want[:2000])).all()


def test_quant_reduce_scatter_owner_keeps_f32_sum():
    """Reduce-scatter output r is the allreduce's owner row for that
    chunk: at p=2, rank 1 owns chunk 0 of the allreduce, and the
    reduce-scatter of the same rows gives rank 0 the sum that started at
    rank 1."""
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 2, 300).astype(np.float32))
    rs = ops.ring_reduce_scatter_quant(x, "int8")
    # segment 0's sum starts at rank 1: the allreduce of [x[1], x[0]]
    # restricted to segment 0 starts at its rank 0 (chunk 0) and is owned by
    # its rank 1
    swapped = torch.stack([x[1, 0], x[0, 0]])
    ar = ops.ring_allreduce_quant(swapped.contiguous(), "int8")
    assert torch.equal(rs[0, 0], ar[1])


@pytest.mark.parametrize(
    "n,p,wire",
    [(805386, 8, "int8"), (857738, 8, "bf16"), (1000003, 8, "int8"), (4096, 2, "int8"),
     (5000, 3, "bf16"), (10**7, 4, "int8"), (1, 2, "bf16"), (300000, 16, "int8")],
)
def test_quant_layout_is_the_jax_wrappers(n, p, wire):
    """quant_chunk_elems is _segmented's seg_rows * 128 with row_align=128
    and the quantized VMEM bound, for the same inputs."""
    assert tring._quant_rows(-(-n // p)) == jring._quant_rows(-(-n // p))
    assert tring._max_rows_quant(p, wire) == jring._max_rows_quant(p, wire)
    seen = []
    jring._segmented(
        np.zeros(n, np.float32), p, np.float32, lambda chunk, rows: seen.append(rows),
        row_align=jring._QUANT_ROW_ALIGN, max_seg_rows=jring._max_rows_quant(p, wire),
    )
    assert tring.quant_chunk_elems(n, p, wire) == seen[0] * 128
    assert len(seen) == -(-n // (p * seen[0] * 128))


def test_main_path_layout():
    """LeNet's first async bucket at p=8: one segment of 8 chunks of 896
    rows (917,504 elements per rank); the sync-wire buffer the same."""
    assert tring.quant_chunk_elems(805386, 8, "int8") == 896 * 128
    assert tring.quant_chunk_elems(857738, 8, "bf16") == 896 * 128
    # above 8 * 896 * 128 a second segment starts
    assert tring.quant_chunk_elems(8 * 896 * 128 + 1, 8, "int8") == 896 * 128


def test_quant_wrappers_check_their_input():
    with pytest.raises(ValueError, match="float32"):
        ops.ring_allreduce_quant(torch.zeros(2, 10, dtype=torch.bfloat16), "int8")
    with pytest.raises(ValueError, match="wire"):
        ops.ring_allreduce_quant(torch.zeros(2, 10), "fp8")
    with pytest.raises(ValueError, match="divide"):
        ops.ring_reduce_scatter_quant(torch.zeros(3, 10), "int8")
    one = torch.ones(1, 50)
    assert ops.ring_allreduce_quant(one, "int8") is one


@pytest.mark.parametrize("n", [1000, 300])
def test_codec_matches_jax(n):
    x = np.random.RandomState(n).randn(n).astype(np.float32) * 3
    q, scale, m = primitives.quantize_blocks(torch.from_numpy(x), 128)
    jq, jscale = jax.jit(lambda v: jprim.quantize_blocks(v, 128)[:2])(x)
    assert m == n and q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(scale.numpy()), _bits(np.asarray(jscale)))
    back = primitives.dequantize_blocks(q, scale, n).numpy()
    np.testing.assert_array_equal(back, np.asarray(jprim.dequantize_blocks(jq, jscale, n)))
    assert primitives.WIRE_DTYPES == jprim.WIRE_DTYPES
    assert primitives._SCALE_FLOOR == np.float32(jprim._SCALE_FLOOR)
    for wire in ("full", "bf16", "int8"):
        assert primitives.wire_encoded_bytes(n, 4, wire, 128) == jprim.wire_encoded_bytes(n, 4, wire, 128)


@pytest.mark.parametrize(
    "op,nelem,dtype,requested",
    [("allreduce", 1 << 16, "float32", "int8"), ("allreduce", (1 << 16) - 1, "float32", "int8"),
     ("allreduce", 1 << 20, "int32", "bf16"), ("broadcast", 1 << 20, "float32", "int8"),
     ("reducescatter", 1 << 20, "float32", "bf16"), ("allreduce", 1 << 20, "float32", None),
     ("allreduce", 1 << 20, "float32", "full")],
)
def test_wire_routing_matches_jax(op, nelem, dtype, requested):
    tdtype = getattr(torch, dtype)
    for wire_constant in ("full", "bf16"):
        constants.set("wire_dtype", wire_constant)
        jconstants.set("wire_dtype", wire_constant)
        ours = eager.resolve_wire_dtype(op, nelem, tdtype, requested)
        assert ours == jeager.resolve_wire_dtype(op, nelem, np.dtype(dtype), requested)
        assert primitives.wire_engages(requested, tdtype, nelem) == jprim.wire_engages(
            requested, np.dtype(dtype), nelem)
    with pytest.raises(CollectiveArgumentError, match="unknown wire_dtype"):
        eager.resolve_wire_dtype("allreduce", 10, torch.float32, "fp8")


def test_eager_wire_engages_only_on_the_kernel_path():
    """The kernel backend with a wire runs the quantized ring when the
    gates pass; below the cutoff, for ints, and on the vendor path the
    payload travels exactly."""
    p = 3
    tmpi.start(ranks=p, device="cpu")
    constants.set("small_allreduce_size_cpu", 0)
    x = torch.from_numpy(np.random.RandomState(2).randn(p, 5000).astype(np.float32))
    exact = tmpi.allreduce_tensor(x, backend="kernel")
    assert torch.equal(exact, ops.ring_allreduce(x))
    # the default cutoff (65,536) keeps 5,000 elements exact
    assert torch.equal(tmpi.allreduce_tensor(x, backend="kernel", wire_dtype="int8"), exact)
    _engage_all()
    for wire in ("int8", "bf16"):
        out = tmpi.allreduce_tensor(x, backend="kernel", wire_dtype=wire)
        assert torch.equal(out, ops.ring_allreduce_quant(x, wire)) and not torch.equal(out, exact)
        assert torch.equal(tmpi.allreduce_tensor(x, backend="xla", wire_dtype=wire),
                           tmpi.allreduce_tensor(x, backend="xla"))
    ints = torch.arange(p * 5000, dtype=torch.int32).reshape(p, 5000)
    assert torch.equal(tmpi.allreduce_tensor(ints, backend="kernel", wire_dtype="int8"),
                       ints.sum(0, keepdim=True).expand_as(ints))
    # the constant is the default wire; an explicit argument wins
    constants.set("wire_dtype", "bf16")
    assert torch.equal(tmpi.allreduce_tensor(x, backend="kernel"), ops.ring_allreduce_quant(x, "bf16"))
    assert torch.equal(tmpi.allreduce_tensor(x, backend="kernel", wire_dtype="full"), exact)
    with pytest.raises(CollectiveArgumentError, match="unknown wire_dtype"):
        tmpi.allreduce_tensor(x, backend="xla", wire_dtype="int4")
