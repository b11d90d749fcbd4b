"""Fused accumulation: ``out + in`` through a hand-written CUDA kernel.

The port of ``torchmpi_tpu/ops/reduce_kernel.py:accumulate`` (the Pallas
``_accumulate_kernel``), itself the analog of the reference's
``lib/detail/reduce_kernel.cu``. The kernel is ``csrc/reduce_kernel.cu``;
:func:`accumulate_plain` is its plain PyTorch version, which the wrapper
takes only for a tensor on the CPU. The ring allreduce fuses the same add
into its own kernel; this one is the standalone primitive, and the engine's
parameter update (``params + updates``) runs through it.

``scale_accumulate`` (``out + alpha * in``, the parameter server's scaled
'add' rule) is not ported yet: ROADMAP queue B.
"""

from __future__ import annotations

import ctypes

import torch

from .ring_kernels import NATIVE_DTYPES

# launches since the last reset (ops.reset_launch_counts)
launches = {"accumulate": 0}

_SIGNATURES = {
    "tm_accumulate": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p,
    ],
}


def _check(out: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
    if out.shape != inp.shape:
        raise ValueError(
            f"accumulate needs equal shapes, got {tuple(out.shape)} and "
            f"{tuple(inp.shape)}"
        )
    if out.device != inp.device:
        raise ValueError(f"accumulate got tensors on {out.device} and {inp.device}")
    return inp.to(out.dtype)


def accumulate_plain(out: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`accumulate`."""
    return out + _check(out, inp)


def accumulate(out: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
    """``out + inp`` (``inp`` cast to ``out``'s dtype) as a new tensor, any
    shape. The CUDA kernel for CUDA tensors (f32, bf16, f16, i32, i8, u8;
    contiguous), the plain version for CPU ones."""
    if out.device.type == "cpu":
        return accumulate_plain(out, inp)
    inp = _check(out, inp)
    if out.device.type != "cuda":
        raise ValueError(f"accumulate runs on CUDA or the CPU, not {out.device}")
    if out.dtype not in NATIVE_DTYPES:
        raise ValueError(f"accumulate kernel does not take dtype {out.dtype}")
    if not (out.is_contiguous() and inp.is_contiguous()):
        raise ValueError("accumulate expects contiguous tensors")
    result = torch.empty_like(out)
    if out.numel():
        from ._build import check, library

        with torch.cuda.device(out.device):
            err = library("reduce_kernel", _SIGNATURES).tm_accumulate(
                out.data_ptr(), inp.data_ptr(), result.data_ptr(),
                NATIVE_DTYPES[out.dtype], out.numel(),
                torch.cuda.current_stream().cuda_stream,
            )
        check(err, "accumulate")
        launches["accumulate"] += 1
    return result
