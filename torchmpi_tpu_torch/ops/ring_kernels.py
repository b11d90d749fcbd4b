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

# launches of each kernel since the last reset (ops.reset_launch_counts)
launches = {"ring_allreduce": 0, "ring_broadcast": 0}

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
