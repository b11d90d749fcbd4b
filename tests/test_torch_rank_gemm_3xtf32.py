"""The arithmetic of the per-rank kernels (``csrc/rank_gemm.cuh``, under
``csrc/conv_wgrad.cu`` and ``csrc/rank_bmm.cu``), modelled in numpy on the
CPU: there is no CUDA build here, so this checks the numeric design, not
the kernel.

The model follows the kernels step by step. The slices of K come from
``ops.rank_gemm.plan``. Within a slice, 32-deep stages in increasing k
each go into a zeroed f32 tile, which is then added to the slice's f32
sums. Within a stage, each 8-deep step is three tensor-core products,
``a_big b_small``, ``a_small b_big``, then ``a_big b_big``, where ``big``
is x rounded to TF32 (to nearest, ties away from zero: the bits plus
0x1000, the 13 low bits cleared) and ``small = x - big``, which the tensor
cores truncate to TF32 (they read an operand's top 19 bits). Each product
adds its 8 exact terms to the tile and rounds once to f32. The tensor
cores' rounding of that add is not documented, so the model runs both to
nearest and toward zero (truncation). The last block adds the slices'
partial tiles in slice order, in f32.

At a ``conv1``-like product (M = 64, K = 8232, LeNet's conv1 at 42 images)
and a ``dense0``-like one (M = 42, K = 3136), both narrowed in N, the
model is held within ``F64_RTOL`` (1e-6, ``chip_smoke.F64_RTOL``) times
max|f64| of the f64 sums. That is the limit the kernels meet on the card
at the full shapes. One TF32 term (``a_big b_big`` alone) misses even the
kernels' 1e-5 limit against the plain version (``chip_smoke.WGRAD_RTOL``),
which is why the kernels take three. ``test_one_tf32_term_misses_the_limit``
prints both errors.
"""

import numpy as np
import pytest

from torchmpi_tpu_torch.ops import rank_gemm

F64_RTOL = 1e-6  # chip_smoke.F64_RTOL
WGRAD_RTOL = 1e-5  # chip_smoke.WGRAD_RTOL
STAGE, STEP = 32, 8  # the kernels' stage depth and mma's k step
# (M, N, K): LeNet's conv1 weight gradient (N narrowed from 800) and its
# dense0 forward (N narrowed from 256)
SHAPES = {"conv1": (64, 96, 8232), "dense0": (42, 64, 3136)}


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away from
    zero: 0x1000 added to the bits, the low 13 cleared."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_trunc(x: np.ndarray) -> np.ndarray:
    """x truncated to TF32: what the tensor cores read of an f32 operand."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def to_f32(x: np.ndarray, rounding: str) -> np.ndarray:
    """f64 values rounded to f32 to nearest, or toward zero."""
    near = x.astype(np.float32)
    if rounding == "nearest":
        return near
    over = np.abs(near.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(near, np.float32(0)), near)


def terms(x: np.ndarray):
    big = tf32_rna(x)
    return big, tf32_trunc(x - big)


def kernel_model(a: np.ndarray, b: np.ndarray, rounding: str, three: bool = True) -> np.ndarray:
    """a [M, K] @ b [K, N] as the kernels sum it (see the module), f32."""
    (m, k), n = a.shape, b.shape[1]
    p = rank_gemm.plan(m, n, k)
    a_big, a_small = terms(a)
    b_big, b_small = terms(b)
    pairs = ([(a_big, b_small), (a_small, b_big)] if three else []) + [(a_big, b_big)]
    total = np.zeros((m, n), np.float32)
    for s in range(p.splits):
        acc = np.zeros((m, n), np.float32)
        for k0 in range(s * p.kc, min(k, (s + 1) * p.kc), STAGE):
            tile = np.zeros((m, n), np.float32)
            for j in range(k0, min(k, (s + 1) * p.kc, k0 + STAGE), STEP):
                for x, y in pairs:
                    # 8 products of TF32 values, exact in f64, added once
                    step = x[:, j:j + STEP].astype(np.float64) @ y[j:j + STEP].astype(np.float64)
                    tile = to_f32(tile.astype(np.float64) + step, rounding)
            acc = acc + tile  # an f32 FADD
        total = total + acc  # the slices in slice order, f32
    return total


def case(name: str, seed: int):
    m, n, k = SHAPES[name]
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    return a, b, a.astype(np.float64) @ b.astype(np.float64)


def rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("rounding", ["nearest", "toward_zero"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_three_tf32_terms_hold_f32_accuracy(name, rounding):
    """3xTF32 with a fresh tile a stage is within 1e-6 of max|f64|, as f32
    sums are, under either rounding of the tensor cores' adds."""
    a, b, want = case(name, 1)
    assert rel(kernel_model(a, b, rounding), want) <= F64_RTOL
    # the limit is tight enough to see a wrong result: a zeroed output and
    # one k step left out both fail it
    assert rel(np.zeros_like(want, dtype=np.float32), want) > F64_RTOL
    short = kernel_model(a[:, STEP:], b[STEP:], rounding)
    assert rel(short, want) > F64_RTOL


def test_tf32_rounding_pins_the_bits():
    """The kernels' split on hand-picked bit patterns: big rounds to
    nearest with ties away from zero, across a binade too, and small is
    what is left, exactly, before the tensor cores truncate it."""
    pats = np.array([0x3F800000, 0x3F800FFF, 0x3F801000, 0x3F803000, 0x3FFFF000, 0xBF801000,
                     0xBF800FFF], np.uint32)
    want = np.array([0x3F800000, 0x3F800000, 0x3F802000, 0x3F804000, 0x40000000, 0xBF802000,
                     0xBF800000], np.uint32)
    x = pats.view(np.float32)
    big, small = terms(x)
    assert np.array_equal(big.view(np.uint32), want)
    rest = x - big  # exact in f32
    assert np.array_equal(small, tf32_trunc(rest))
    assert np.array_equal(big.astype(np.float64) + rest.astype(np.float64), x.astype(np.float64))


def test_one_tf32_term_misses_the_limit(capsys):
    """``a_big b_big`` alone keeps about 11 bits a product: it misses the
    kernels' 1e-5 limit against the f32 plain version where three terms
    hold 1e-6 of the f64 sums."""
    for name in SHAPES:
        a, b, want = case(name, 2)
        one = rel(kernel_model(a, b, "nearest", three=False), want)
        three = rel(kernel_model(a, b, "nearest"), want)
        plain = rel((a @ b).astype(np.float32), want)
        with capsys.disabled():
            print(f"\n{name}: |model - f64| / max|f64|: 1xTF32 {one:.2e}, 3xTF32 {three:.2e}, "
                  f"f32 numpy {plain:.2e}")
        assert one > WGRAD_RTOL
        assert three <= F64_RTOL and plain <= F64_RTOL


def test_the_order_comes_from_the_shape():
    """The model's result, like the kernels', depends on a rank's operands
    and the plan of (M, N, K) alone: the same rows of A give the same bits
    whatever other rows lie beside them in a tile."""
    a, b, _ = case("dense0", 3)
    whole = kernel_model(a, b, "toward_zero")
    part = kernel_model(a[:16], b, "toward_zero")
    # a 16-row product plans its own slices, so it is held to the f64 limit,
    # and the 42-row plan gives the first rows the same bits with other
    # rows beside them
    assert rel(part, a[:16].astype(np.float64) @ b.astype(np.float64)) <= F64_RTOL
    rows = np.concatenate([a[:16], np.zeros_like(a[16:])])
    assert np.array_equal(kernel_model(rows, b, "toward_zero")[:16], whole[:16])
