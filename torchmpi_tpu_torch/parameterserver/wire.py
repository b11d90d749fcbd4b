"""Parameter-server wire precision for the in-process path.

The port of the part of ``torchmpi_tpu/parameterserver/wire.py`` that a
single process uses (``:79-143,179``): the wire codes, the per-payload
resolution of ``parameterserver_wire_dtype``, and :func:`roundtrip`, the
value a receiver reconstructs, which the in-process exchanges apply so a
single-process run sees the precision a socket peer would. Written in
torch on the payload's device, bit for bit equal to the JAX codec on the
same f32 input:

- ``full``: the values verbatim;
- ``bf16``: round-to-nearest-even truncation to bfloat16, by the JAX
  codec's integer formula on the f32 bits;
- ``int8``: symmetric per-block quantization, one f32 scale
  (``max(amax, 1e-30) / 127``) per ``block`` elements of the payload.

Shards stay f32 master copies: only the exchanged values are lossy. The
chunk container and the frame encoding (``:197-347``) belong to the socket
transport and wait for it (ROADMAP A13).
"""

from __future__ import annotations

import torch

WIRE_FULL = 0
WIRE_BF16 = 1
WIRE_INT8 = 2

WIRE_NAMES = {WIRE_FULL: "full", WIRE_BF16: "bf16", WIRE_INT8: "int8"}
WIRE_CODES = {v: k for k, v in WIRE_NAMES.items()}

# smallest positive scale: a zero block must not divide by zero, and its
# dequantized zeros stay exactly zero
_EPS = 1e-30


def wire_code(name: str) -> int:
    try:
        return WIRE_CODES[name]
    except KeyError:
        raise ValueError(
            f"unknown parameterserver wire dtype {name!r} "
            f"(have {sorted(WIRE_CODES)})"
        ) from None


def resolve_ps_wire(dtype: torch.dtype, explicit: str = None) -> int:
    """Effective wire code for a payload of ``dtype``: the quantized
    encodings engage only for float32 (f64 instances ship verbatim)."""
    from .. import constants

    name = explicit or constants.get("parameterserver_wire_dtype")
    if dtype != torch.float32:
        return WIRE_FULL
    return wire_code(name)


def _bf16_roundtrip(x: torch.Tensor) -> torch.Tensor:
    # the JAX codec's uint32 arithmetic, carried in int64
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rounded = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFFFFFF
    bits = (rounded >> 16) << 16
    return torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(torch.int32).view(torch.float32)


def _int8_roundtrip(x: torch.Tensor, block: int) -> torch.Tensor:
    flat = x.reshape(-1)
    n = flat.shape[0]
    pad = -n % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    b = flat.reshape(-1, block)
    amax = torch.clamp_min(b.abs().amax(dim=1), _EPS)
    # tensor divisors: a division by a host scalar may run as a product with
    # its reciprocal on the card, which is not the codec's f32 division
    scale = (amax / torch.full_like(amax, 127.0))[:, None]
    q = torch.clamp(torch.round(b / scale), -127, 127).to(torch.int8)
    return (q.float() * scale).reshape(-1)[:n]


def roundtrip(x: torch.Tensor, wire: int, block: int) -> torch.Tensor:
    """decode(encode(x)): the f32 value a receiver reconstructs from the
    ``wire`` encoding of ``x`` (``int8`` scales per ``block`` elements)."""
    if wire == WIRE_FULL:
        return x.to(torch.float32)
    x = x.to(torch.float32)
    if wire == WIRE_BF16:
        out = _bf16_roundtrip(x)
    elif wire == WIRE_INT8:
        out = _int8_roundtrip(x, block)
    else:
        raise ValueError(f"unknown wire code {wire}")
    return out.reshape(x.shape)
