"""The block-quantized wire codec (EQuARX-style, arXiv:2506.17615).

The port of the codec half of ``torchmpi_tpu/collectives/primitives.py``
(``:109-180``): the bandwidth-path rings may ship each hop as int8 with one
f32 scale per block, or as a bf16 cast, and sum in f32. Compression lives
in the collective layer, not in the model: callers opt in through
``wire_dtype=`` or the ``wire_dtype`` constant. The quantized ring itself
is the hand kernel ``ops.ring_allreduce_quant``; the ``ppermute`` ring of
the JAX module (``ring_allreduce`` ``:312``) waits for the ``ring``
backend (ROADMAP queue A2).

The int8 scale of a block is ``max(max|block|, 1e-30) * (1/127)``, the
JAX package's ``max/127`` as XLA computes it: a product with the f32
reciprocal.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.ring_kernels import SCALE_FLOOR, row_scale

#: wire encodings the rings understand ('full' = ship the dtype verbatim)
WIRE_DTYPES = ("full", "bf16", "int8")

# smallest positive scale: a zero block must not divide by zero, and the
# dequantized zeros stay exactly zero
_SCALE_FLOOR = float(SCALE_FLOOR)


def quantize_blocks(x: torch.Tensor, block: int):
    """Quantize a float32 tensor to ``(q_int8, scales_f32, n)``: flattened,
    zero-padded to whole blocks of ``block`` elements, one symmetric scale
    per block (``[nblocks, 1]``). Exact for blocks whose values are all
    equal and for zeros."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    b = torch.nn.functional.pad(flat, (0, -n % block)).reshape(-1, block)
    scale = row_scale(b)
    return torch.round(b / scale).to(torch.int8), scale, n


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor, n: int, shape=None):
    """Inverse of :func:`quantize_blocks`; returns f32 of ``shape`` (flat
    length ``n`` when shape is None)."""
    out = (q.to(torch.float32) * scale).reshape(-1)[:n]
    return out if shape is None else out.reshape(shape)


def wire_encoded_bytes(nelem: int, itemsize: int, wire: str, block: int) -> int:
    """On-wire bytes for ``nelem`` elements under a wire encoding: the int8
    payload padded to whole blocks plus one f32 scale per block."""
    if wire == "int8":
        nblocks = -(-max(1, nelem) // block)
        return nblocks * block + nblocks * 4
    if wire == "bf16":
        return nelem * 2
    return nelem * itemsize


def wire_engages(wire: Optional[str], dtype: torch.dtype, nelem: int) -> bool:
    """Whether a compressed wire format applies: only f32 payloads (ints
    and bools pass uncompressed, exactness is their contract) at or above
    the ``wire_quant_min_elements`` cutoff."""
    from .. import constants

    return (
        wire in ("int8", "bf16")
        and dtype == torch.float32
        and nelem >= constants.get("wire_quant_min_elements")
    )
