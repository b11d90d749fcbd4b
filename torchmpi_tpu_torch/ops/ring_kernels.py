"""Ring allreduce and ring broadcast over virtual ranks on one CUDA card.

The port of the two ``torchmpi_tpu/ops/ring_kernels.py`` kernels on the
main path: ``_ring_phases_kernel`` in allreduce mode (via
``ring_allreduce_pallas``) and ``_ring_broadcast_kernel`` (via
``ring_broadcast_pallas``). The kernels are hand-written CUDA in
``csrc/ring_kernels.cu``; each has a plain PyTorch version here that
repeats its arithmetic. A wrapper takes the plain version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.

Inputs are rank-stacked: ``x[r]`` is rank r's buffer, and the leading axis
is the ring. Two contracts of the JAX kernels are kept:

- **Chunk layout and order of adds.** :func:`chunk_elems` is the JAX
  wrapper's integer arithmetic (``_tile_rows``, ``_max_rows`` and
  ``_segmented``): it cuts each rank's flat buffer into segments of p ring
  chunks. The chunk that holds an element is the rank its sum starts at,
  and the sum runs round the ring from there. Adds happen in the payload
  type. So a float allreduce gives the JAX ring's bits.
- **Dtypes.** f32, bf16, f16, i32, i8 and u8 are native; i16, u16 and bool
  reduce in an i32 carrier; anything else raises. The broadcast moves
  bytes, so it carries every dtype unchanged.
"""

from __future__ import annotations

import ctypes

import torch

_LANES = 128
# the JAX wrapper's VMEM budget: it no longer bounds memory here, but it
# sets the segment size and therefore which rank each chunk's sum starts at
_VMEM_BUDGET_BYTES = 8 * 1024 * 1024

# payload types the kernel reduces natively, with their tm::Dtype codes
NATIVE_DTYPES = {
    torch.float32: 0,
    torch.bfloat16: 1,
    torch.float16: 2,
    torch.int32: 3,
    torch.int8: 4,
    torch.uint8: 5,
}
# lossless carriers: these reduce as int32
_CARRIED = (torch.int16, torch.uint16, torch.bool)

# wire encodings of the quantized ring
WIRES = ("int8", "bf16")

# launches of each kernel since the last reset (ops.reset_launch_counts);
# the quantized ring counts per operation and wire
launches = {
    "ring_allreduce": 0,
    "ring_broadcast": 0,
    **{f"{op}_{wire}": 0 for op in ("ring_allreduce_quant", "ring_reduce_scatter_quant")
       for wire in WIRES},
}

_SIGNATURES = {
    "tm_ring_allreduce": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ],
    "tm_ring_broadcast": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p,
    ],
}


def _lib():
    from ._build import library

    return library("ring_kernels", _SIGNATURES)


def supports_dtype(dtype: torch.dtype) -> bool:
    """True when the ring reduces this dtype exactly (natively or in a
    lossless carrier)."""
    return dtype in NATIVE_DTYPES or dtype in _CARRIED


def carrier_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the ring adds in. Raises on dtypes a carrier would
    silently degrade (f64, complex, 64-bit and unsigned 32-bit ints)."""
    if dtype in NATIVE_DTYPES:
        return dtype
    if dtype in _CARRIED:
        return torch.int32
    raise ValueError(
        f"dtype {dtype} is not supported by the ring reduction kernel (a "
        "carrier cast would lose precision)"
    )


def _min_rows(itemsize: int) -> int:
    """Sublane tile of the JAX layout: 8 rows at 4B, 16 at 2B, 32 at 1B."""
    return 8 * (4 // itemsize)


def _tile_rows(n: int, min_rows: int) -> int:
    raw_rows = -(-n // _LANES)
    return max(min_rows, -(-raw_rows // min_rows) * min_rows)


def _max_rows(p: int, itemsize: int, min_rows: int) -> int:
    per_row_bytes = (2 * p + 2) * _LANES * itemsize
    rows = _VMEM_BUDGET_BYTES // per_row_bytes
    return max(min_rows, rows // min_rows * min_rows)


def chunk_elems(n: int, p: int, dtype: torch.dtype) -> int:
    """Elements per ring chunk for ``n`` elements per rank, as the JAX
    wrapper lays them out (``ring_kernels.py:100,322,352-382``): element i
    of a rank's buffer lies in chunk ``(i % (p * c)) // c`` of its segment,
    and that chunk's sum starts at that rank. Always a multiple of 128."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    min_rows = _min_rows(itemsize)
    rows = _tile_rows(-(-n // p), min_rows)
    return min(rows, _max_rows(p, itemsize, min_rows)) * _LANES


def _check_stacked(x: torch.Tensor, what: str) -> None:
    if x.ndim < 1:
        raise ValueError(f"{what} expects a rank-stacked [p, ...] tensor")
    if not x.is_contiguous():
        raise ValueError(f"{what} expects a contiguous tensor")


def _as_rows(x: torch.Tensor):
    """[p, ...] -> ([p, n] in the carrier dtype, carrier)."""
    carrier = carrier_dtype(x.dtype)
    rows = x.reshape(x.shape[0], -1)
    return (rows if carrier == x.dtype else rows.to(carrier)), carrier


def ring_allreduce_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`ring_allreduce`: the same chunk
    layout and the same order of adds, in the same payload type."""
    _check_stacked(x, "ring_allreduce")
    p = x.shape[0]
    if p == 1:
        return x
    rows, carrier = _as_rows(x)
    n = rows.shape[1]
    c = chunk_elems(n, p, carrier)
    start = (torch.arange(n, device=x.device) % (p * c)) // c
    acc = rows.gather(0, start[None])[0]
    for k in range(1, p):
        acc = acc + rows.gather(0, ((start + k) % p)[None])[0]
    return acc.expand(p, n).contiguous().to(x.dtype).reshape(x.shape)


def ring_allreduce(x: torch.Tensor) -> torch.Tensor:
    """Sum-allreduce the rank-stacked ``x`` (``[p, ...]``) round the ring;
    every rank's row of the result holds the same sum. ``p == 1`` returns
    ``x``. The CUDA kernel for a CUDA tensor, the plain version for a CPU
    one (``ring_allreduce_pallas``, ``ring_kernels.py:385``)."""
    if x.device.type == "cpu":
        return ring_allreduce_plain(x)
    _check_stacked(x, "ring_allreduce")
    if x.device.type != "cuda":
        raise ValueError(f"ring_allreduce runs on CUDA or the CPU, not {x.device}")
    p = x.shape[0]
    if p == 1:
        return x
    rows, carrier = _as_rows(x)
    n = rows.shape[1]
    out = torch.empty_like(rows)
    if n:
        from ._build import check

        with torch.cuda.device(x.device):
            err = _lib().tm_ring_allreduce(
                rows.data_ptr(), out.data_ptr(), NATIVE_DTYPES[carrier], p, n,
                chunk_elems(n, p, carrier), torch.cuda.current_stream().cuda_stream,
            )
        check(err, "ring_allreduce")
        launches["ring_allreduce"] += 1
    return out.to(x.dtype).reshape(x.shape)


def _check_root(root: int, p: int) -> None:
    if not 0 <= root < p:
        raise ValueError(f"root {root} out of range for {p} ranks")


def ring_broadcast_plain(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`ring_broadcast`: root's bytes
    copied to every rank's row."""
    _check_stacked(x, "ring_broadcast")
    p = x.shape[0]
    _check_root(root, p)
    if p == 1:
        return x
    src = x.reshape(p, -1)[root]
    return src.expand(p, src.shape[0]).contiguous().reshape(x.shape)


def ring_broadcast(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Broadcast rank ``root``'s buffer to every rank of the rank-stacked
    ``x``; non-root inputs are ignored and ``p == 1`` returns ``x``. Any
    dtype: the kernel copies bytes. The CUDA kernel for a CUDA tensor, the
    plain version for a CPU one (``ring_broadcast_pallas``,
    ``ring_kernels.py:1386``)."""
    if x.device.type == "cpu":
        return ring_broadcast_plain(x, root)
    _check_stacked(x, "ring_broadcast")
    if x.device.type != "cuda":
        raise ValueError(f"ring_broadcast runs on CUDA or the CPU, not {x.device}")
    p = x.shape[0]
    _check_root(root, p)
    if p == 1:
        return x
    out = torch.empty_like(x)
    row_bytes = x[0].numel() * x.element_size()
    if row_bytes:
        from ._build import check

        with torch.cuda.device(x.device):
            err = _lib().tm_ring_broadcast(
                x.data_ptr(), out.data_ptr(), p, row_bytes, root,
                torch.cuda.current_stream().cuda_stream,
            )
        check(err, "ring_broadcast")
        launches["ring_broadcast"] += 1
    return out


# ---------------------------------------------------------------------------
# block-quantized wire: int8 (one f32 scale per 128-lane row) or bf16 on
# every hop, f32 sums, requantized per hop (_ring_quant_kernel)
# ---------------------------------------------------------------------------

_WIRE_CODES = {"int8": 0, "bf16": 1}
_MODE_CODES = {"allreduce": 0, "rs": 1}
# the quantized kernels tile chunks to whole 128-row groups (the JAX
# wrapper's _QUANT_ROW_ALIGN, ring_kernels.py:521)
_QUANT_ROW_ALIGN = 128
# the int8 codec's constants as f32 (csrc/ring_quant.cu spells the same
# bits in hex): the scale floor, and 1/127 rounded once, because XLA turns
# the JAX kernel's division by 127.0 into a product with its reciprocal
SCALE_FLOOR = torch.tensor(1e-30, dtype=torch.float32)
INV_127 = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(127.0)

_QUANT_SIGNATURES = {
    "tm_ring_quant": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ],
}


def _quant_rows(nchunk: int) -> int:
    """Rows for an ``nchunk``-element ring chunk, 128-row aligned
    (``ring_kernels.py:524``)."""
    raw = -(-nchunk // _LANES)
    return max(_QUANT_ROW_ALIGN, -(-raw // _QUANT_ROW_ALIGN) * _QUANT_ROW_ALIGN)


def _max_rows_quant(p: int, wire: str) -> int:
    """The JAX wrapper's VMEM bound for the quantized kernels
    (``ring_kernels.py:540``); here it only sets the segment size."""
    wire_itemsize = 1 if wire == "int8" else 2
    per_row = (2 * p * 4 + 3 * wire_itemsize) * _LANES + 16
    rows = _VMEM_BUDGET_BYTES // per_row
    return max(_QUANT_ROW_ALIGN, rows // _QUANT_ROW_ALIGN * _QUANT_ROW_ALIGN)


def quant_chunk_elems(n: int, p: int, wire: str) -> int:
    """Elements per ring chunk of the quantized allreduce for ``n``
    elements per rank, as ``_segmented(..., row_align=128,
    max_seg_rows=_max_rows_quant(p, wire))`` lays them out
    (``ring_kernels.py:352-382``): element i lies in chunk
    ``(i % (p * c)) // c`` of its segment, whose sum starts at that rank,
    and in scale row ``i // 128``."""
    return min(_quant_rows(-(-n // p)), _max_rows_quant(p, wire)) * _LANES


def _check_quant(x: torch.Tensor, wire: str, what: str) -> None:
    if wire not in WIRES:
        raise ValueError(f"wire must be one of {WIRES}, got {wire!r}")
    _check_stacked(x, what)
    if x.dtype != torch.float32:
        raise ValueError(f"{what} carries float32 payloads, got {x.dtype}")


def row_scale(rows: torch.Tensor) -> torch.Tensor:
    """The int8 scale of each row of ``[..., block]`` f32 values:
    ``max(max|row|, 1e-30) * (1/127)``."""
    m = rows.abs().amax(dim=-1, keepdim=True)
    return torch.maximum(m, SCALE_FLOOR.to(rows.device)) * INV_127.to(rows.device)


def _encode(rows: torch.Tensor, wire: str):
    """The wire form of ``[..., 128]`` f32 rows: (codes as f32, scales or
    None). ``torch.round`` rounds half to even, as ``jnp.round``; the trip
    through int8 turns a code of -0.0 into +0.0, as the wire does."""
    if wire == "int8":
        scale = row_scale(rows)
        return torch.round(rows / scale).to(torch.int8).to(torch.float32), scale
    return rows.to(torch.bfloat16).to(torch.float32), None


def _decode(codes: torch.Tensor, scale) -> torch.Tensor:
    """An all-gather hop's install: the decoded f32 value."""
    return codes if scale is None else codes * scale


def _decode_add(codes: torch.Tensor, scale, local: torch.Tensor) -> torch.Tensor:
    """A reduce-scatter hop's receive, ``local + decode(codes)``. For int8
    the product is exact in f64 and the sum rounds there, then to f32: XLA
    fuses the JAX kernel's decode-and-add into one f32 FMA, which this
    equals but for double rounding when ``local`` is some 2^29 times
    smaller than the product."""
    if scale is None:
        return local + codes
    return (codes.double() * scale.double() + local.double()).float()


def _hop_chain(ranks: torch.Tensor, starts: torch.Tensor, wire: str, allreduce: bool):
    """The quantized ring over rows: ``ranks`` is ``[p, R, 128]`` (rank,
    row, lane) and ``starts[R]`` the rank each row's sum starts at. Returns
    the owners' f32 sums ``[R, 128]`` and, for ``allreduce``, every rank's
    result ``[p, R, 128]``: the owner (the start rank's left neighbour)
    keeps its sum, and each later hop installs the decoding of the wire
    form of the previous rank's value."""
    p, nrows = ranks.shape[0], ranks.shape[1]
    row = torch.arange(nrows, device=ranks.device)
    acc = ranks[starts, row]
    for k in range(1, p):
        acc = _decode_add(*_encode(acc, wire), ranks[(starts + k) % p, row])
    if not allreduce:
        return acc, None
    out = torch.empty_like(ranks)
    out[(starts - 1) % p, row] = acc
    v = acc
    for k in range(p - 1):
        v = _decode(*_encode(v, wire))
        out[(starts + k) % p, row] = v
    return acc, out


def ring_allreduce_quant_plain(x: torch.Tensor, wire: str) -> torch.Tensor:
    """Plain PyTorch version of :func:`ring_allreduce_quant`: the same
    chunk layout, hop chain and rounding."""
    _check_quant(x, wire, "ring_allreduce_quant")
    p = x.shape[0]
    if p == 1:
        return x
    flat = x.reshape(p, -1)
    n = flat.shape[1]
    nrows = -(-n // _LANES)
    padded = torch.nn.functional.pad(flat, (0, nrows * _LANES - n))
    c = quant_chunk_elems(n, p, wire)
    starts = (torch.arange(nrows, device=x.device) * _LANES % (p * c)) // c
    _, out = _hop_chain(padded.reshape(p, nrows, _LANES), starts, wire, True)
    return out.reshape(p, -1)[:, :n].reshape(x.shape)


def _rs_shape(x: torch.Tensor, what: str):
    p = x.shape[0]
    if x.ndim < 2 or x.shape[1] % p:
        raise ValueError(
            f"{what} scatters dim 1 of the rank-stacked input, which must "
            f"divide by p={p}; got shape {tuple(x.shape)}"
        )
    return (p, x.shape[1] // p) + tuple(x.shape[2:])


def ring_reduce_scatter_quant_plain(x: torch.Tensor, wire: str) -> torch.Tensor:
    """Plain PyTorch version of :func:`ring_reduce_scatter_quant`."""
    _check_quant(x, wire, "ring_reduce_scatter_quant")
    out_shape = _rs_shape(x, "ring_reduce_scatter_quant")
    p = x.shape[0]
    if p == 1:
        return x
    segs = x.reshape(p, p, -1)  # [rank, segment, seg_n]
    seg_n = segs.shape[2]
    rps = -(-seg_n // _LANES)
    padded = torch.nn.functional.pad(segs, (0, rps * _LANES - seg_n))
    # segment s's sums start at rank s + 1 (the JAX wrapper's pre-roll by
    # one, ring_kernels.py:814-815) and end at its owner, rank s
    starts = (torch.arange(p * rps, device=x.device) // rps + 1) % p
    acc, _ = _hop_chain(padded.reshape(p, p * rps, _LANES), starts, wire, False)
    return acc.reshape(p, rps * _LANES)[:, :seg_n].reshape(out_shape)


def _launch_quant(x: torch.Tensor, out: torch.Tensor, wire: str, mode: str,
                  n: int, chunk: int) -> None:
    from ._build import check, library

    with torch.cuda.device(x.device):
        err = library("ring_quant", _QUANT_SIGNATURES).tm_ring_quant(
            x.data_ptr(), out.data_ptr(), _WIRE_CODES[wire], _MODE_CODES[mode],
            x.shape[0], n, chunk, torch.cuda.current_stream().cuda_stream,
        )
    check(err, f"ring quant ({mode}, {wire})")


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or the CPU, not {x.device}")


def ring_allreduce_quant(x: torch.Tensor, wire: str) -> torch.Tensor:
    """Sum-allreduce the rank-stacked f32 ``x`` (``[p, ...]``) round the
    ring with ``wire`` ('int8' or 'bf16') on every hop and f32 sums
    (``ring_allreduce_quant_pallas``, ``ring_kernels.py:746``). Each
    chunk's owner keeps its f32 sum and every other rank gets the wire's
    decoding of it, so the ranks' rows may differ. The CUDA kernel for a
    CUDA tensor, the plain version for a CPU one."""
    if x.device.type == "cpu":
        return ring_allreduce_quant_plain(x, wire)
    _check_quant(x, wire, "ring_allreduce_quant")
    _check_cuda(x, "ring_allreduce_quant")
    p = x.shape[0]
    if p == 1:
        return x
    flat = x.reshape(p, -1)
    n = flat.shape[1]
    out = torch.empty_like(flat)
    if n:
        _launch_quant(flat, out, wire, "allreduce", n, quant_chunk_elems(n, p, wire))
        launches[f"ring_allreduce_quant_{wire}"] += 1
    return out.reshape(x.shape)


def ring_reduce_scatter_quant(x: torch.Tensor, wire: str) -> torch.Tensor:
    """Reduce-scatter the rank-stacked f32 ``x`` (``[p, d, ...]``, ``d``
    divisible by p) with ``wire`` on every hop: row r of the ``[p, d/p,
    ...]`` result is the f32 sum of every rank's slice r of dim 1
    (``ring_reduce_scatter_quant_pallas``, ``ring_kernels.py:782``: the
    kernel's 'rs' mode). The CUDA kernel for a CUDA tensor, the plain
    version for a CPU one."""
    if x.device.type == "cpu":
        return ring_reduce_scatter_quant_plain(x, wire)
    _check_quant(x, wire, "ring_reduce_scatter_quant")
    out_shape = _rs_shape(x, "ring_reduce_scatter_quant")
    _check_cuda(x, "ring_reduce_scatter_quant")
    p = x.shape[0]
    if p == 1:
        return x
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    seg_n = out[0].numel()
    if seg_n:
        _launch_quant(x, out, wire, "rs", seg_n, 0)
        launches[f"ring_reduce_scatter_quant_{wire}"] += 1
    return out
