"""Fused accumulation through hand-written CUDA kernels: ``out + in`` and
``out + alpha * in``.

The port of ``torchmpi_tpu/ops/reduce_kernel.py``: :func:`accumulate`
replaces its Pallas ``_accumulate_kernel`` (the analog of the reference's
``lib/detail/reduce_kernel.cu``), :func:`scale_accumulate` its
``_scale_add_kernel``, the parameter server's 'add'-with-scale fused form.
Both kernels are ``csrc/reduce_kernel.cu``; :func:`accumulate_plain` and
:func:`scale_accumulate_plain` are their plain PyTorch versions, which the
wrappers take only for tensors on the CPU. The ring allreduce fuses the
plain add into its own kernel; this one is the standalone primitive, and
the engine's parameter update (``params + updates``), the parameter
server's 'add' rule and its schedules run through the two.

Both take ``out_=``, a destination that may be ``out`` itself, so that an
update rule applies in place (``shard += incoming``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .ring_kernels import NATIVE_DTYPES

# launches since the last reset (ops.reset_launch_counts)
launches = {"accumulate": 0, "scale_accumulate": 0}

# the scaled form's payload types (codes of csrc/common.cuh's Dtype)
SCALE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.float64: 6}

_SIGNATURES = {
    "tm_accumulate": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p,
    ],
    "tm_scale_accumulate": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ],
}


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
    return inp.to(out.dtype)


def _check_scale_dtype(dtype: torch.dtype) -> None:
    if dtype not in SCALE_DTYPES:
        raise ValueError(
            f"scale_accumulate takes float32, bfloat16, float16 or float64, "
            f"not {dtype}"
        )


def _store(result: torch.Tensor, out_: Optional[torch.Tensor]) -> torch.Tensor:
    return result if out_ is None else out_.copy_(result)


def _launch(fn: str, out: torch.Tensor, inp: torch.Tensor,
            out_: Optional[torch.Tensor], code: int, *alpha) -> torch.Tensor:
    """Launch ``fn`` of ``csrc/reduce_kernel.cu`` on CUDA tensors; the
    result goes to ``out_`` (a fresh tensor when None)."""
    if not (out.is_contiguous() and inp.is_contiguous()
            and (out_ is None or out_.is_contiguous())):
        raise ValueError(f"{fn} expects contiguous tensors")
    result = torch.empty_like(out) if out_ is None else out_
    if out.numel():
        from ._build import check, library

        with torch.cuda.device(out.device):
            err = getattr(library("reduce_kernel", _SIGNATURES), f"tm_{fn}")(
                out.data_ptr(), inp.data_ptr(), result.data_ptr(), *alpha, code,
                out.numel(), torch.cuda.current_stream().cuda_stream,
            )
        check(err, fn)
        launches[fn] += 1
    return result


def _off_cpu(what: str, out: torch.Tensor) -> None:
    if out.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or the CPU, not {out.device}")


def accumulate_plain(out: torch.Tensor, inp: torch.Tensor, *,
                     out_: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`accumulate`."""
    return _store(out + _check("accumulate", out, inp, out_), out_)


def accumulate(out: torch.Tensor, inp: torch.Tensor, *,
               out_: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out + inp`` (``inp`` cast to ``out``'s dtype), any shape, into
    ``out_`` (which may be ``out``) or a new tensor. The CUDA kernel for
    CUDA tensors (f32, bf16, f16, i32, i8, u8; contiguous), the plain
    version for CPU ones."""
    if out.device.type == "cpu":
        return accumulate_plain(out, inp, out_=out_)
    inp = _check("accumulate", out, inp, out_)
    _off_cpu("accumulate", out)
    if out.dtype not in NATIVE_DTYPES:
        raise ValueError(f"accumulate kernel does not take dtype {out.dtype}")
    return _launch("accumulate", out, inp, out_, NATIVE_DTYPES[out.dtype])


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
                     out_: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out + alpha * inp`` (``alpha`` and ``inp`` cast to ``out``'s dtype),
    any shape, into ``out_`` (which may be ``out``) or a new tensor. The
    CUDA kernel for CUDA tensors (f32, bf16, f16, f64; contiguous), the
    plain version for CPU ones. Integer dtypes raise ``ValueError``."""
    if out.device.type == "cpu":
        return scale_accumulate_plain(out, inp, alpha, out_=out_)
    inp = _check("scale_accumulate", out, inp, out_)
    _off_cpu("scale_accumulate", out)
    _check_scale_dtype(out.dtype)
    return _launch("scale_accumulate", out, inp, out_, SCALE_DTYPES[out.dtype],
                   scale_in_dtype(alpha, out.dtype))
