"""Fused accumulation through hand-written CUDA kernels: ``out + in`` and
``out + alpha * in``, one tensor or a list of leaves in one launch.

The port of ``torchmpi_tpu/ops/reduce_kernel.py``: :func:`accumulate`
replaces its Pallas ``_accumulate_kernel`` (the analog of the reference's
``lib/detail/reduce_kernel.cu``), :func:`scale_accumulate` its
``_scale_add_kernel``, the parameter server's 'add'-with-scale fused form.
:func:`accumulate_many` and :func:`scale_accumulate_many` compute the same
per leaf over a list (a step's parameters) in one launch per
:func:`leaves_per_launch` leaves of one dtype; the single-tensor forms run
through the same kernel as a list of one. The kernels are
``csrc/reduce_kernel.cu``; the ``*_plain`` functions are their plain
PyTorch versions, which the wrappers take only for tensors on the CPU. The
ring allreduce fuses the plain add into its own kernel; this one is the
standalone primitive, and the engine's momentum trace and parameter update
(``params + updates``), the parameter server's 'add' rule and its
schedules run through it.

Every form takes ``out_=``, destinations that may be the ``out`` tensors
themselves, so that an update rule applies in place (``shard +=
incoming``). Every wrapper takes ``stream=``, the ``torch.cuda.Stream`` to
launch on (default: the current one).
"""

from __future__ import annotations

import array
import ctypes
import functools
import math
from typing import Dict, List, Optional, Sequence

import torch

from .ring_kernels import NATIVE_DTYPES

# launches since the last reset (ops.reset_launch_counts)
launches = {"accumulate": 0, "scale_accumulate": 0}

# the scaled form's payload types (codes of csrc/common.cuh's Dtype)
SCALE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.float64: 6}

_SIGNATURES = {
    "tm_accumulate_many": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "tm_scale_accumulate_many": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_void_p,
    ],
    "tm_leaves_per_launch": [],
    "tm_table_bytes": [],
}


def _lib():
    from ._build import library

    return library("reduce_kernel", _SIGNATURES)


@functools.lru_cache(maxsize=None)
def leaves_per_launch() -> int:
    """The most leaves one launch of the list kernels takes: 818 where the
    build takes a parameter table above the classic 4,096 bytes (CUDA 12.1
    or later), else 102 (asked of the library once, at the first call)."""
    return _lib().tm_leaves_per_launch()


def table_bytes() -> int:
    """The bytes of kernel parameters of the table that holds
    :func:`leaves_per_launch` leaves."""
    return _lib().tm_table_bytes()


def launch_groups(dtypes: Sequence[torch.dtype], per_launch: int) -> List[List[int]]:
    """The launches a list of leaves of ``dtypes`` takes: its indices
    grouped by dtype (in order of first appearance), each group cut into
    runs of at most ``per_launch``; ``ceil(leaves / per_launch)`` launches
    per dtype."""
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, dtype in enumerate(dtypes):
        by_dtype.setdefault(dtype, []).append(i)
    return [idx[k:k + per_launch] for idx in by_dtype.values()
            for k in range(0, len(idx), per_launch)]


def _check(what: str, out: torch.Tensor, inp: torch.Tensor,
           out_: Optional[torch.Tensor]) -> torch.Tensor:
    if out.shape != inp.shape:
        raise ValueError(
            f"{what} needs equal shapes, got {tuple(out.shape)} and "
            f"{tuple(inp.shape)}"
        )
    if out.device != inp.device:
        raise ValueError(f"{what} got tensors on {out.device} and {inp.device}")
    if out_ is not None and (
        out_.shape != out.shape or out_.dtype != out.dtype or out_.device != out.device
    ):
        raise ValueError(
            f"{what}: out_ must match out's shape, dtype and device, got "
            f"{tuple(out_.shape)} {out_.dtype} on {out_.device}"
        )
    return inp if inp.dtype == out.dtype else inp.to(out.dtype)


def _check_scale_dtype(dtype: torch.dtype) -> None:
    if dtype not in SCALE_DTYPES:
        raise ValueError(
            f"scale_accumulate takes float32, bfloat16, float16 or float64, "
            f"not {dtype}"
        )


def _store(result: torch.Tensor, out_: Optional[torch.Tensor]) -> torch.Tensor:
    return result if out_ is None else out_.copy_(result)


def _off_cpu(what: str, out: torch.Tensor) -> None:
    if out.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or the CPU, not {out.device}")


def _leaves(what: str, outs, inps, out_) -> tuple:
    """The list forms' leaves as lists ``(outs, inps, dests)`` (``dests``
    None where there is no ``out_``), all on one device."""
    outs, inps = list(outs), list(inps)
    dests = [None] * len(outs) if out_ is None else list(out_)
    if not len(outs) == len(inps) == len(dests):
        raise ValueError(
            f"{what} needs one input and one destination per leaf, got "
            f"{len(outs)} leaves, {len(inps)} inputs and {len(dests)} destinations"
        )
    devices = {t.device for t in outs + inps} | {d.device for d in dests if d is not None}
    if len(devices) > 1:
        raise ValueError(f"{what} needs every leaf on one device, got "
                         f"{sorted(str(d) for d in devices)}")
    return outs, inps, dests


def _launch(fn: str, outs, inps, dests, codes: Dict[torch.dtype, int],
            alpha: Optional[float], stream) -> List[torch.Tensor]:
    """Check the CUDA leaves and launch ``tm_{fn}_many`` of
    ``csrc/reduce_kernel.cu`` once per :func:`launch_groups` group; each
    result goes to its destination (a fresh tensor where None)."""
    results, todo = [], []
    for out, inp, dest in zip(outs, inps, dests):
        inp = _check(fn, out, inp, dest)
        if not todo and not results:
            _off_cpu(fn, out)  # the list forms hold every leaf on one device
        if out.dtype not in codes:
            if alpha is not None:
                _check_scale_dtype(out.dtype)
            raise ValueError(f"{fn} kernel does not take dtype {out.dtype}")
        if not (out.is_contiguous() and inp.is_contiguous()
                and (dest is None or dest.is_contiguous())):
            raise ValueError(f"{fn} expects contiguous tensors")
        result = torch.empty_like(out) if dest is None else dest
        results.append(result)
        if out.numel():
            todo.append((out, inp, result))
    if not todo:
        return results
    from ._build import check, launch

    lib = _lib()
    for group in launch_groups([leaf[0].dtype for leaf in todo], leaves_per_launch()):
        # the C side's LeafIn: a, b, out, n
        table = array.array("q")
        for i in group:
            out, inp, result = todo[i]
            table.extend((out.data_ptr(), inp.data_ptr(), result.data_ptr(), out.numel()))
        dtype = todo[group[0]][0].dtype
        ptr, count = table.buffer_info()[0], len(group)
        if alpha is None:
            err = launch(todo[0][0].device, lambda s: lib.tm_accumulate_many(
                ptr, count, codes[dtype], s), stream)
        else:
            scale = scale_in_dtype(alpha, dtype)
            err = launch(todo[0][0].device, lambda s: lib.tm_scale_accumulate_many(
                ptr, count, scale, codes[dtype], s), stream)
        check(err, fn)
        launches[fn] += 1
    return results


def accumulate_plain(out: torch.Tensor, inp: torch.Tensor, *,
                     out_: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`accumulate`."""
    return _store(out + _check("accumulate", out, inp, out_), out_)


def accumulate(out: torch.Tensor, inp: torch.Tensor, *,
               out_: Optional[torch.Tensor] = None, stream=None) -> torch.Tensor:
    """``out + inp`` (``inp`` cast to ``out``'s dtype), any shape, into
    ``out_`` (which may be ``out``) or a new tensor. The CUDA kernel for
    CUDA tensors (f32, bf16, f16, i32, i8, u8; contiguous), one launch,
    the plain version for CPU ones."""
    if out.device.type == "cpu":
        return accumulate_plain(out, inp, out_=out_)
    return _launch("accumulate", [out], [inp], [out_], NATIVE_DTYPES, None, stream)[0]


def accumulate_many_plain(outs: Sequence[torch.Tensor], inps: Sequence[torch.Tensor], *,
                          out_: Optional[Sequence[torch.Tensor]] = None) -> List[torch.Tensor]:
    """Plain PyTorch version of :func:`accumulate_many`: the plain
    :func:`accumulate` leaf by leaf."""
    outs, inps, dests = _leaves("accumulate_many", outs, inps, out_)
    return [accumulate_plain(o, i, out_=d) for o, i, d in zip(outs, inps, dests)]


def accumulate_many(outs: Sequence[torch.Tensor], inps: Sequence[torch.Tensor], *,
                    out_: Optional[Sequence[torch.Tensor]] = None,
                    stream=None) -> List[torch.Tensor]:
    """:func:`accumulate` leaf by leaf, ``outs[i] + inps[i]`` into
    ``out_[i]`` (which may be ``outs[i]``) or new tensors, every leaf on one
    device. On CUDA one launch per :func:`leaves_per_launch` leaves of one
    dtype (:func:`launch_groups`); on the CPU the plain version."""
    outs, inps, dests = _leaves("accumulate_many", outs, inps, out_)
    if outs and outs[0].device.type == "cpu":
        return accumulate_many_plain(outs, inps, out_=out_)
    return _launch("accumulate", outs, inps, dests, NATIVE_DTYPES, None, stream)


def scale_in_dtype(alpha: float, dtype: torch.dtype) -> float:
    """``alpha`` rounded to ``dtype``, as the JAX kernel casts its scale to
    the payload's dtype (``jnp.asarray([alpha], out.dtype)``)."""
    return float(torch.tensor(float(alpha), dtype=dtype))


def _two_sum(a, b):
    """``a + b`` rounded, and the exact rest (Knuth's TwoSum)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round_to_odd(s: torch.Tensor, rest: torch.Tensor) -> torch.Tensor:
    """``s + rest`` (``s`` its rounding to nearest) rounded to odd: where
    ``rest`` is not 0 and ``s``'s last bit is even, the neighbour of ``s``
    toward the exact sum. Rounding to odd in f64 and then to nearest in a
    type of at most 51 bits is the correct rounding of the exact sum."""
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(rest > 0, math.inf, -math.inf).to(s.dtype)
    return torch.where((rest != 0) & even, torch.nextafter(s, toward), s)


def _split(x):
    """Veltkamp's split of an f64 into two halves of 26 bits."""
    c = x * 134217729.0  # 2^27 + 1
    hi = c - (c - x)
    return hi, x - hi


def _fma_f64(a: torch.Tensor, b: torch.Tensor, alpha: float) -> torch.Tensor:
    """``fma(alpha, b, a)`` in f64, correctly rounded, from f64 operations:
    the exact product as two terms (Dekker), the exact three-term sum as
    r + rest with |rest| below half an ulp of r, and rest rounded to odd
    before the last addition (Boldo and Melquiond's rounding to odd)."""
    p = b * alpha
    bh, bl = _split(b)
    ah, al = _split(alpha)
    pl = (((bh * ah - p) + bh * al) + bl * ah) + bl * al
    s1, e1 = _two_sum(a, p)
    e2, e3 = _two_sum(e1, pl)
    r, e4 = _two_sum(s1, e2)
    t, rest = _two_sum(e4, e3)
    out = r + _round_to_odd(t, rest)
    # the error-free steps need finite intermediates; an inf or nan input
    # or an overflowing product takes the IEEE result of the plain form
    return torch.where(torch.isfinite(out), out, a + b * alpha)


def scale_accumulate_plain(out: torch.Tensor, inp: torch.Tensor, alpha: float, *,
                           out_: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`scale_accumulate`, rounding as the
    interpret-mode Pallas kernel does: f32 and f64 once (an FMA; f32 as
    the f64 sum of the exact product, rounded to odd, then to f32), bf16
    after the product and after the sum, f16 once from f32."""
    inp = _check("scale_accumulate", out, inp, out_)
    _check_scale_dtype(out.dtype)
    alpha = scale_in_dtype(alpha, out.dtype)
    if out.dtype == torch.float32:
        a, p = out.double(), inp.double() * alpha  # the product is exact in f64
        s, rest = _two_sum(a, p)
        result = _round_to_odd(s, rest).float()
        result = torch.where(torch.isfinite(s), result, out + inp * alpha)
    elif out.dtype == torch.float64:
        result = _fma_f64(out, inp, alpha)
    elif out.dtype == torch.bfloat16:
        product = (inp.float() * alpha).to(torch.bfloat16)
        result = (out.float() + product.float()).to(torch.bfloat16)
    else:
        result = (out.float() + inp.float() * alpha).to(torch.float16)
    return _store(result, out_)


def scale_accumulate(out: torch.Tensor, inp: torch.Tensor, alpha: float, *,
                     out_: Optional[torch.Tensor] = None, stream=None) -> torch.Tensor:
    """``out + alpha * inp`` (``alpha`` and ``inp`` cast to ``out``'s dtype),
    any shape, into ``out_`` (which may be ``out``) or a new tensor. The
    CUDA kernel for CUDA tensors (f32, bf16, f16, f64; contiguous), one
    launch, the plain version for CPU ones. Integer dtypes raise
    ``ValueError``."""
    if out.device.type == "cpu":
        return scale_accumulate_plain(out, inp, alpha, out_=out_)
    return _launch("scale_accumulate", [out], [inp], [out_], SCALE_DTYPES, alpha, stream)[0]


def scale_accumulate_many_plain(outs: Sequence[torch.Tensor], inps: Sequence[torch.Tensor],
                                alpha: float, *,
                                out_: Optional[Sequence[torch.Tensor]] = None) -> List[torch.Tensor]:
    """Plain PyTorch version of :func:`scale_accumulate_many`: the plain
    :func:`scale_accumulate` leaf by leaf."""
    outs, inps, dests = _leaves("scale_accumulate_many", outs, inps, out_)
    return [scale_accumulate_plain(o, i, alpha, out_=d) for o, i, d in zip(outs, inps, dests)]


def scale_accumulate_many(outs: Sequence[torch.Tensor], inps: Sequence[torch.Tensor],
                          alpha: float, *, out_: Optional[Sequence[torch.Tensor]] = None,
                          stream=None) -> List[torch.Tensor]:
    """:func:`scale_accumulate` leaf by leaf, ``outs[i] + alpha * inps[i]``
    into ``out_[i]`` (which may be ``outs[i]``) or new tensors, every leaf
    on one device. On CUDA one launch per :func:`leaves_per_launch` leaves
    of one dtype (:func:`launch_groups`); on the CPU the plain version.
    Integer dtypes raise ``ValueError``."""
    outs, inps, dests = _leaves("scale_accumulate_many", outs, inps, out_)
    if outs and outs[0].device.type == "cpu":
        return scale_accumulate_many_plain(outs, inps, alpha, out_=out_)
    return _launch("scale_accumulate", outs, inps, dests, SCALE_DTYPES, alpha, stream)
