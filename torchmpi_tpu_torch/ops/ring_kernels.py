"""The ring kernels over virtual ranks on one CUDA card.

The port of the ``torchmpi_tpu/ops/ring_kernels.py`` kernels:
``_ring_phases_kernel`` in its three modes (allreduce via
``ring_allreduce_pallas``, 'rs' via ``ring_reduce_scatter_pallas``, 'ag' via
``ring_allgather_pallas``), 'rs' followed by ``_ring_gather_root_kernel``
(``ring_reduce_pallas``), ``_ring_bidir_kernel``
(``ring_allreduce_bidir_pallas``), ``_ring_broadcast_kernel``
(``ring_broadcast_pallas``) and ``_ring_quant_kernel`` (the int8/bf16 wire),
and their forms across processes (the ``_xproc`` wrappers).
The kernels are hand-written CUDA in ``csrc/ring_kernels.cu`` and
``csrc/ring_quant.cu``; each has a plain PyTorch version here that repeats
its arithmetic. A wrapper takes the plain version only for a tensor on the
CPU; for a CUDA tensor it launches the kernel or raises.

Inputs are rank-stacked: ``x[r]`` is rank r's buffer, and the leading axis
is the ring. :func:`ring_allreduce`, :func:`ring_allgather` and
:func:`ring_broadcast` also take ``groups``: the rows then hold that many
rings of equal size in group-major order (group g is rows ``g*I ..
g*I+I-1``, the intra phase of a two-level communicator), every group's
result is that of its own ring, and one launch runs them all. Two
contracts of the JAX kernels are kept:

- **Chunk layout and order of adds.** :func:`chunk_elems` (and
  :func:`bidir_chunk_elems`, :func:`quant_chunk_elems`) is the JAX
  wrapper's integer arithmetic (``_tile_rows``, ``_max_rows`` and
  ``_segmented``): it cuts each rank's flat buffer into segments of p ring
  chunks. The chunk that holds an element is the rank its sum starts at,
  and the sum runs round the ring from there. Adds happen in the payload
  type. So a float reduction gives the JAX ring's bits.
- **Dtypes.** f32, bf16, f16, i32, i8 and u8 are native; i16, u16 and bool
  reduce in an i32 carrier; anything else raises. The broadcast and the
  allgather move bytes, so they carry every dtype but complex unchanged.
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
    "ring_reduce_scatter": 0,
    "ring_allgather": 0,
    "ring_reduce": 0,
    "ring_allreduce_bidir": 0,
    "ring_allreduce_xproc": 0,
    "ring_broadcast_xproc": 0,
    "ring_reduce_scatter_xproc": 0,
    "ring_allgather_xproc": 0,
    "ring_allreduce_bidir_xproc": 0,
    "ring_reduce_xproc": 0,
    **{f"{op}_{wire}": 0 for op in ("ring_allreduce_quant", "ring_reduce_scatter_quant",
                                    "ring_allreduce_quant_xproc",
                                    "ring_reduce_scatter_quant_xproc")
       for wire in WIRES},
}

_PTR, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # x, out, dtype, rows, groups, n, chunk_elems, stream
    "tm_ring_allreduce": [_PTR, _PTR, _INT, _INT, _INT, _LONG, _LONG, _PTR],
    # x, out, rows, groups, row_bytes, root, stream
    "tm_ring_broadcast": [_PTR, _PTR, _INT, _INT, _LONG, _INT, _PTR],
    # x, out, dtype, p, seg_n, stream
    "tm_ring_reduce_scatter": [_PTR, _PTR, _INT, _INT, _LONG, _PTR],
    # x, out, rows, groups, row_bytes, stream
    "tm_ring_allgather": [_PTR, _PTR, _INT, _INT, _LONG, _PTR],
    # x, out, dtype, p, n, chunk_elems, root, stream
    "tm_ring_reduce": [_PTR, _PTR, _INT, _INT, _LONG, _LONG, _INT, _PTR],
    # x, out, dtype, p, n, half, chunk_elems, stream
    "tm_ring_allreduce_bidir": [_PTR, _PTR, _INT, _INT, _LONG, _LONG, _LONG, _PTR],
    # rows (p addresses), p, out, local, dtype, n, chunk_elems, stream
    "tm_ring_allreduce_xproc": [ctypes.POINTER(ctypes.c_ulonglong), _INT, _PTR, _INT, _INT,
                                _LONG, _LONG, _PTR],
    # src, out, local, row_bytes, stream
    "tm_ring_broadcast_xproc": [_PTR, _PTR, _INT, _LONG, _PTR],
    # rows (p addresses), p, owned (local ranks), local, out, dtype, seg_n, stream
    "tm_ring_reduce_scatter_xproc": [ctypes.POINTER(ctypes.c_ulonglong), _INT,
                                     ctypes.POINTER(ctypes.c_int), _INT, _PTR, _INT, _LONG,
                                     _PTR],
    # rows (p addresses), p, out, local, row_bytes, stream
    "tm_ring_allgather_xproc": [ctypes.POINTER(ctypes.c_ulonglong), _INT, _PTR, _INT, _LONG,
                                _PTR],
    # rows (p addresses), p, out, local, dtype, n, half, chunk_elems, stream
    "tm_ring_allreduce_bidir_xproc": [ctypes.POINTER(ctypes.c_ulonglong), _INT, _PTR, _INT,
                                      _INT, _LONG, _LONG, _LONG, _PTR],
    # rows (p addresses), p, owned (local ranks), local, out, dtype, n,
    # chunk_elems, root, stream
    "tm_ring_reduce_xproc": [ctypes.POINTER(ctypes.c_ulonglong), _INT,
                             ctypes.POINTER(ctypes.c_int), _INT, _PTR, _INT, _LONG, _LONG, _INT,
                             _PTR],
}
# the cross-process K3's row table (csrc/ring_kernels.cu kMaxTableRows)
MAX_TABLE_ROWS = 32


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


def _group_size(x: torch.Tensor, groups: int, what: str) -> int:
    """Ranks per group of the group-major rows of ``x``."""
    if groups < 1 or x.shape[0] % groups:
        raise ValueError(
            f"{what}: {x.shape[0]} rows do not split into {groups} groups of equal size")
    return x.shape[0] // groups


def _as_rows(x: torch.Tensor):
    """[p, ...] -> ([p, n] in the carrier dtype, carrier)."""
    carrier = carrier_dtype(x.dtype)
    rows = x.reshape(x.shape[0], -1)
    return (rows if carrier == x.dtype else rows.to(carrier)), carrier


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or the CPU, not {x.device}")


def _launch(fn: str, x: torch.Tensor, *args, stream=None) -> None:
    """Launch ``fn`` of the ring_kernels library on ``x``'s card, on
    ``stream`` (default: the current stream); raise if the launch reports a
    CUDA error."""
    from ._build import check, launch

    call = getattr(_lib(), fn)
    check(launch(x.device, lambda s: call(*args, s), stream), fn)


def _ring_sum(rows: torch.Tensor, chunk: int, step: int = 1) -> torch.Tensor:
    """The ring's sum over the ``[..., p, n]`` rows, one ring over each
    ``[p, n]`` of the leading axes: element i's sum starts at the rank of
    its chunk, ``(i % (p * chunk)) // chunk``, and adds the ranks after it
    (``step`` 1, rightward) or before it (``step`` -1, leftward) round the
    ring, in the rows' dtype. Returns ``[..., n]``."""
    p, n = rows.shape[-2:]
    start = (torch.arange(n, device=rows.device) % (p * chunk)) // chunk

    def rank(k: int) -> torch.Tensor:
        index = ((start + step * k) % p).expand(rows.shape[:-2] + (1, n))
        return rows.gather(-2, index).squeeze(-2)

    acc = rank(0)
    for k in range(1, p):
        acc = acc + rank(k)
    return acc


def ring_allreduce_plain(x: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Plain PyTorch version of :func:`ring_allreduce`: the same chunk
    layout and the same order of adds, in the same payload type, every
    group's ring at once."""
    _check_stacked(x, "ring_allreduce")
    p = _group_size(x, groups, "ring_allreduce")
    if p == 1:
        return x
    rows, carrier = _as_rows(x)
    n = rows.shape[1]
    acc = _ring_sum(rows.reshape(groups, p, n), chunk_elems(n, p, carrier))
    return acc[:, None].expand(groups, p, n).contiguous().to(x.dtype).reshape(x.shape)


def ring_allreduce(x: torch.Tensor, groups: int = 1, stream=None) -> torch.Tensor:
    """Sum-allreduce the rank-stacked ``x`` (``[p, ...]``) round the ring;
    every rank's row of the result holds the same sum. With ``groups`` G,
    the rows are G rings of ``p / G`` ranks in group-major order, each
    summed on its own (the chunk layout of one ``p / G``-rank ring), in one
    launch. Rings of one rank return ``x``. The CUDA kernel for a CUDA
    tensor, the plain version for a CPU one (``ring_allreduce_pallas``,
    ``ring_kernels.py:385``)."""
    if x.device.type == "cpu":
        return ring_allreduce_plain(x, groups)
    _check_stacked(x, "ring_allreduce")
    _check_cuda(x, "ring_allreduce")
    p = _group_size(x, groups, "ring_allreduce")
    if p == 1:
        return x
    rows, carrier = _as_rows(x)
    n = rows.shape[1]
    out = torch.empty_like(rows)
    if n:
        _launch("tm_ring_allreduce", x, rows.data_ptr(), out.data_ptr(),
                NATIVE_DTYPES[carrier], x.shape[0], groups, n, chunk_elems(n, p, carrier),
                stream=stream)
        launches["ring_allreduce"] += 1
    return out.to(x.dtype).reshape(x.shape)


def _rs_shape(x: torch.Tensor, what: str):
    p = x.shape[0]
    if x.ndim < 2 or x.shape[1] % p:
        raise ValueError(
            f"{what} scatters dim 1 of the rank-stacked input, which must "
            f"divide by p={p}; got shape {tuple(x.shape)}"
        )
    return (p, x.shape[1] // p) + tuple(x.shape[2:])


def ring_reduce_scatter_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`ring_reduce_scatter`: segment s's
    sum starts at rank s + 1 and walks rightward to its owner, rank s, in
    the payload type."""
    _check_stacked(x, "ring_reduce_scatter")
    out_shape = _rs_shape(x, "ring_reduce_scatter")
    p = x.shape[0]
    if p == 1:
        return x
    rows, _ = _as_rows(x)
    segs = rows.reshape(p, p, -1)  # [rank, segment, seg_n]
    s = torch.arange(p, device=x.device)
    acc = segs[(s + 1) % p, s]
    for k in range(2, p + 1):
        acc = acc + segs[(s + k) % p, s]
    return acc.to(x.dtype).reshape(out_shape)


def ring_reduce_scatter(x: torch.Tensor, wire: str = "full", stream=None) -> torch.Tensor:
    """Reduce-scatter the rank-stacked ``x`` (``[p, m, ...]``, ``m``
    divisible by p) with ``lax.psum_scatter`` tiled semantics on each
    rank's dim 0: row r of the ``[p, m/p, ...]`` result is the sum of
    every rank's slice r (``ring_reduce_scatter_pallas``,
    ``ring_kernels.py:437``: the phases kernel's 'rs' mode after its
    pre-roll by one). A ``wire`` ('int8' or 'bf16') runs the quantized
    ring's 'rs' mode, :func:`ring_reduce_scatter_quant`. The CUDA kernel
    for a CUDA tensor, the plain version for a CPU one."""
    if wire != "full":
        return ring_reduce_scatter_quant(x, wire, stream=stream)
    if x.device.type == "cpu":
        return ring_reduce_scatter_plain(x)
    _check_stacked(x, "ring_reduce_scatter")
    out_shape = _rs_shape(x, "ring_reduce_scatter")
    _check_cuda(x, "ring_reduce_scatter")
    p = x.shape[0]
    if p == 1:
        return x
    rows, carrier = _as_rows(x)
    out = torch.empty((p, rows.shape[1] // p), dtype=carrier, device=x.device)
    seg_n = out.shape[1]
    if seg_n:
        _launch("tm_ring_reduce_scatter", x, rows.data_ptr(), out.data_ptr(),
                NATIVE_DTYPES[carrier], p, seg_n, stream=stream)
        launches["ring_reduce_scatter"] += 1
    return out.to(x.dtype).reshape(out_shape)


def _check_movable(x: torch.Tensor, what: str) -> None:
    _check_stacked(x, what)
    if x.dtype.is_complex:
        raise ValueError(f"{what}: complex dtypes are not supported ({x.dtype})")


def ring_allgather_plain(x: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Plain PyTorch version of :func:`ring_allgather`: every rank's row
    of the result is a copy of its group's rows of ``x``."""
    _check_movable(x, "ring_allgather")
    p = _group_size(x, groups, "ring_allgather")
    blocks = x.reshape((groups, 1, p) + tuple(x.shape[1:]))
    out = blocks.expand((groups, p, p) + tuple(x.shape[1:])).contiguous()
    return out.reshape((groups * p, p) + tuple(x.shape[1:]))


def ring_allgather(x: torch.Tensor, groups: int = 1, stream=None) -> torch.Tensor:
    """Allgather the rank-stacked ``x`` (``[p, *s]``) into ``[p, p, *s]``:
    every rank gets every rank's block, stacked in rank order
    (``ring_allgather_pallas``, ``ring_kernels.py:831``: the phases
    kernel's 'ag' mode). With ``groups`` G, the rows are G groups of ``I =
    p / G`` ranks in group-major order and the result ``[p, I, *s]``: every
    rank gets its group's blocks, all groups in one launch. Any dtype but
    complex: the kernel copies bytes, so bool and -0.0 survive. The CUDA
    kernel for a CUDA tensor, the plain version for a CPU one."""
    if x.device.type == "cpu":
        return ring_allgather_plain(x, groups)
    _check_movable(x, "ring_allgather")
    _check_cuda(x, "ring_allgather")
    p = _group_size(x, groups, "ring_allgather")
    out = torch.empty((x.shape[0], p) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    row_bytes = x[0].numel() * x.element_size()
    if row_bytes:
        _launch("tm_ring_allgather", x, x.data_ptr(), out.data_ptr(), x.shape[0], groups,
                row_bytes, stream=stream)
        launches["ring_allgather"] += 1
    return out


def _check_root(root: int, p: int) -> None:
    if not 0 <= root < p:
        raise ValueError(f"root {root} out of range for {p} ranks")


def ring_reduce_plain(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`ring_reduce`: the root's row is the
    ring allreduce's row, every other row the input."""
    _check_stacked(x, "ring_reduce")
    p = x.shape[0]
    _check_root(root, p)
    if p == 1:
        return x
    rows, carrier = _as_rows(x)
    out = rows.clone()
    out[root] = _ring_sum(rows, chunk_elems(rows.shape[1], p, carrier))
    return out.to(x.dtype).reshape(x.shape)


def ring_reduce(x: torch.Tensor, root: int = 0, stream=None) -> torch.Tensor:
    """Sum-reduce the rank-stacked ``x`` to rank ``root``; every other
    rank keeps its input (``ring_reduce_pallas``, ``ring_kernels.py:1232``:
    the phases kernel's 'rs' mode in the allreduce's chunk layout, then
    ``_ring_gather_root_kernel`` bringing the owned sums to the root). On
    one card the gather moves nothing: the kernel writes the sums straight
    into the root's row, so that row equals :func:`ring_allreduce`'s bit
    for bit. The CUDA kernel for a CUDA tensor, the plain version for a
    CPU one."""
    if x.device.type == "cpu":
        return ring_reduce_plain(x, root)
    _check_stacked(x, "ring_reduce")
    _check_cuda(x, "ring_reduce")
    p = x.shape[0]
    _check_root(root, p)
    if p == 1:
        return x
    rows, carrier = _as_rows(x)
    n = rows.shape[1]
    out = torch.empty_like(rows)
    if n:
        _launch("tm_ring_reduce", x, rows.data_ptr(), out.data_ptr(),
                NATIVE_DTYPES[carrier], p, n, chunk_elems(n, p, carrier), root, stream=stream)
        launches["ring_reduce"] += 1
    return out.to(x.dtype).reshape(x.shape)


def bidir_chunk_elems(half: int, p: int, dtype: torch.dtype) -> int:
    """Elements per ring chunk of each half of the bidirectional allreduce
    for ``half`` elements per half, as ``_segmented_pair_ready`` lays them
    out (``ring_kernels.py:1091-1112``): the tile rows of ``ceil(half /
    p)``, bounded by half the VMEM budget of :func:`chunk_elems`. Element i
    of a half lies in chunk ``(i % (p * c)) // c``."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    min_rows = _min_rows(itemsize)
    rows = _tile_rows(-(-half // p), min_rows)
    budget = max(min_rows, _max_rows(p, itemsize, min_rows) // 2 // min_rows * min_rows)
    return min(rows, budget) * _LANES


def ring_allreduce_bidir_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`ring_allreduce_bidir`."""
    _check_stacked(x, "ring_allreduce_bidir")
    p = x.shape[0]
    if p <= 2:
        return ring_allreduce_plain(x)
    rows, carrier = _as_rows(x)
    n = rows.shape[1]
    half = -(-n // 2)
    c = bidir_chunk_elems(half, p, carrier)
    acc = torch.cat([_ring_sum(rows[:, :half], c, 1), _ring_sum(rows[:, half:], c, -1)])
    return acc.expand(p, n).contiguous().to(x.dtype).reshape(x.shape)


def ring_allreduce_bidir(x: torch.Tensor, stream=None) -> torch.Tensor:
    """Sum-allreduce the rank-stacked ``x`` over two rings at once
    (``ring_allreduce_bidir_pallas``, ``ring_kernels.py:1005``): the first
    ``ceil(n/2)`` elements of each rank's flat buffer (half A) are summed
    rightward from their chunk's rank, the rest (half B) leftward, each
    half in the :func:`bidir_chunk_elems` layout. ``p <= 2`` runs
    :func:`ring_allreduce`, as the JAX wrapper delegates at p == 2. The
    CUDA kernel for a CUDA tensor, the plain version for a CPU one."""
    if x.device.type == "cpu":
        return ring_allreduce_bidir_plain(x)
    _check_stacked(x, "ring_allreduce_bidir")
    _check_cuda(x, "ring_allreduce_bidir")
    p = x.shape[0]
    if p <= 2:
        return ring_allreduce(x, stream=stream)
    rows, carrier = _as_rows(x)
    n = rows.shape[1]
    out = torch.empty_like(rows)
    if n:
        half = -(-n // 2)
        _launch("tm_ring_allreduce_bidir", x, rows.data_ptr(), out.data_ptr(),
                NATIVE_DTYPES[carrier], p, n, half, bidir_chunk_elems(half, p, carrier),
                stream=stream)
        launches["ring_allreduce_bidir"] += 1
    return out.to(x.dtype).reshape(x.shape)


def ring_broadcast_plain(x: torch.Tensor, root: int = 0, groups: int = 1) -> torch.Tensor:
    """Plain PyTorch version of :func:`ring_broadcast`: each group's root
    bytes copied to every row of the group."""
    _check_stacked(x, "ring_broadcast")
    p = _group_size(x, groups, "ring_broadcast")
    _check_root(root, p)
    if p == 1:
        return x
    src = x.reshape(groups, p, -1)[:, root]
    return src[:, None].expand(groups, p, src.shape[1]).contiguous().reshape(x.shape)


def ring_broadcast(x: torch.Tensor, root: int = 0, groups: int = 1,
                   stream=None) -> torch.Tensor:
    """Broadcast rank ``root``'s buffer to every rank of the rank-stacked
    ``x``; non-root inputs are ignored. With ``groups`` G, the rows are G
    groups of ``p / G`` ranks in group-major order and ``root`` the rank
    within each group: every group gets its own root's buffer, all in one
    launch. Groups of one rank return ``x``. Any dtype: the kernel copies
    bytes. The CUDA kernel for a CUDA tensor, the plain version for a CPU
    one (``ring_broadcast_pallas``, ``ring_kernels.py:1386``)."""
    if x.device.type == "cpu":
        return ring_broadcast_plain(x, root, groups)
    _check_stacked(x, "ring_broadcast")
    _check_cuda(x, "ring_broadcast")
    p = _group_size(x, groups, "ring_broadcast")
    _check_root(root, p)
    if p == 1:
        return x
    out = torch.empty_like(x)
    row_bytes = x[0].numel() * x.element_size()
    if row_bytes:
        _launch("tm_ring_broadcast", x, x.data_ptr(), out.data_ptr(), x.shape[0], groups,
                row_bytes, root, stream=stream)
        launches["ring_broadcast"] += 1
    return out


# ---------------------------------------------------------------------------
# the cross-process forms: ranks spread over several processes on one card
# (runtime/peers.py); the rows are read where they lie, in the slabs
# ---------------------------------------------------------------------------


def _check_table(rows, local: int, what: str) -> None:
    if not rows or not 1 <= len(rows) <= MAX_TABLE_ROWS:
        raise ValueError(f"{what} takes 1 to {MAX_TABLE_ROWS} rank rows, got {len(rows)}")
    if local < 1:
        raise ValueError(f"{what}: a process holds at least one rank, got {local}")
    first = rows[0]
    for r in rows:
        if r.shape != first.shape or r.dtype != first.dtype or r.device != first.device:
            raise ValueError(f"{what}: the rank rows differ in shape, dtype or device")
        if not r.is_contiguous():
            raise ValueError(f"{what} expects contiguous rank rows")


def _check_native_table(rows, what: str) -> None:
    if rows[0].dtype not in NATIVE_DTYPES:
        raise ValueError(f"{what} reduces {sorted(map(str, NATIVE_DTYPES))}, "
                         f"not {rows[0].dtype}")


def _check_distinct_owned(rows, owned, what: str) -> list:
    """``owned`` as a list of distinct global ranks of the table's
    ``len(rows)``, after the table's checks."""
    owned = [int(r) for r in owned]
    _check_table(rows, len(owned), what)
    p = len(rows)
    if len(owned) > MAX_TABLE_ROWS or len(set(owned)) != len(owned) or \
            any(not 0 <= r < p for r in owned):
        raise ValueError(f"{what}: owned ranks {owned} out of range or repeated for {p} ranks")
    return owned


def ring_allreduce_xproc_plain(rows, local: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`ring_allreduce_xproc`: the p rank
    rows stacked, the ring's sum in :func:`ring_allreduce`'s chunk layout
    and order of adds for a ring of p, copied to ``local`` rows."""
    _check_table(rows, local, "ring_allreduce_xproc")
    x = torch.stack(list(rows))
    if len(rows) == 1:
        return x.expand((local,) + tuple(x.shape[1:])).contiguous()
    out = ring_allreduce_plain(x)
    return out[:1].expand((local,) + tuple(x.shape[1:])).contiguous()


def ring_allreduce_xproc(rows, local: int, stream=None) -> torch.Tensor:
    """Sum-allreduce over ranks held by several processes: ``rows`` are
    the p rank rows in rank order (each a contiguous tensor where it lies:
    this process's or a peer's mapped slab), and the result is
    ``[local, ...]``, the process's own rows, each the ring's sum. The
    sum is :func:`ring_allreduce`'s on the stacked rows, bit for bit (the
    same chunk layout and order of adds). One launch of the cross-process
    K3 (``ring_allreduce_pallas`` across processes, ``ring_kernels.py:
    385``); the plain version for CPU rows. Natively reduced dtypes only:
    the caller casts to :func:`carrier_dtype` before it publishes."""
    first = rows[0]
    if first.device.type == "cpu":
        return ring_allreduce_xproc_plain(rows, local)
    _check_table(rows, local, "ring_allreduce_xproc")
    _check_cuda(first, "ring_allreduce_xproc")
    _check_native_table(rows, "ring_allreduce_xproc")
    p = len(rows)
    out = torch.empty((local,) + tuple(first.shape), dtype=first.dtype, device=first.device)
    n = first.numel()
    if n:
        table = (ctypes.c_ulonglong * p)(*[r.data_ptr() for r in rows])
        _launch("tm_ring_allreduce_xproc", first, table, p, out.data_ptr(), local,
                NATIVE_DTYPES[first.dtype], n, chunk_elems(n, p, first.dtype), stream=stream)
        launches["ring_allreduce_xproc"] += 1
    return out


def ring_broadcast_xproc_plain(src: torch.Tensor, local: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`ring_broadcast_xproc`: the root's
    row copied to ``local`` rows."""
    _check_table([src], local, "ring_broadcast_xproc")
    return src[None].expand((local,) + tuple(src.shape)).contiguous()


def ring_broadcast_xproc(src: torch.Tensor, local: int, stream=None) -> torch.Tensor:
    """Broadcast across processes: ``src`` is the root rank's row where it
    lies (this process's or a peer's mapped slab), the result ``[local,
    ...]`` its bytes in each of the process's own rows. One launch of the
    cross-process K7 (``ring_broadcast_pallas`` across processes,
    ``ring_kernels.py:1386``); the plain version for a CPU row. Any dtype
    but complex: the kernel copies bytes."""
    if src.device.type == "cpu":
        return ring_broadcast_xproc_plain(src, local)
    _check_table([src], local, "ring_broadcast_xproc")
    _check_cuda(src, "ring_broadcast_xproc")
    if src.dtype.is_complex:
        raise ValueError(f"ring_broadcast_xproc: complex dtypes are not supported ({src.dtype})")
    out = torch.empty((local,) + tuple(src.shape), dtype=src.dtype, device=src.device)
    row_bytes = src.numel() * src.element_size()
    if row_bytes:
        _launch("tm_ring_broadcast_xproc", src, src.data_ptr(), out.data_ptr(), local,
                row_bytes, stream=stream)
        launches["ring_broadcast_xproc"] += 1
    return out


def _check_owned(rows, owned, what: str) -> list:
    """``owned`` as a list of global ranks of the table's ``len(rows)``,
    after the table's checks; each rank row must be 1-D and divide into
    p segments."""
    owned = [int(r) for r in owned]
    _check_table(rows, len(owned), what)
    p = len(rows)
    if len(owned) > MAX_TABLE_ROWS or any(not 0 <= r < p for r in owned):
        raise ValueError(f"{what}: owned ranks {owned} out of range for {p} ranks")
    first = rows[0]
    if first.ndim != 1 or first.numel() % p:
        raise ValueError(f"{what} takes 1-D rank rows of p segments (p={p}), got "
                         f"{tuple(first.shape)}")
    return owned


def ring_reduce_scatter_xproc_plain(rows, owned) -> torch.Tensor:
    """Plain PyTorch version of :func:`ring_reduce_scatter_xproc`: the p
    rank rows stacked, :func:`ring_reduce_scatter`'s rows of the ranks in
    ``owned``."""
    owned = _check_owned(rows, owned, "ring_reduce_scatter_xproc")
    x = torch.stack(list(rows))
    out = ring_reduce_scatter_plain(x)
    return out[torch.tensor(owned, device=x.device)]


def ring_reduce_scatter_xproc(rows, owned, stream=None) -> torch.Tensor:
    """Reduce-scatter over ranks held by several processes: ``rows`` are
    the p rank rows ``[p m]`` in rank order, each where it lies (this
    process's or a peer's mapped slab), and ``owned`` the global rank of
    each of this process's rows, in any order. Row i of the ``[L, m]``
    result is the sum of every rank's segment ``owned[i]``, bit for bit
    :func:`ring_reduce_scatter`'s row of that rank on the stacked rows
    (segment s's sum starts at rank s + 1 and walks rightward to s). So a
    process reduces only its own segments, and the job's launches read
    the rows once. One launch of the cross-process K3 'rs'
    (``ring_reduce_scatter_pallas`` across processes, ``ring_kernels.py:
    437``); the plain version for CPU rows. Natively reduced dtypes only:
    the caller casts to :func:`carrier_dtype` before it publishes."""
    first = rows[0]
    if first.device.type == "cpu":
        return ring_reduce_scatter_xproc_plain(rows, owned)
    owned = _check_owned(rows, owned, "ring_reduce_scatter_xproc")
    _check_cuda(first, "ring_reduce_scatter_xproc")
    _check_native_table(rows, "ring_reduce_scatter_xproc")
    p, local = len(rows), len(owned)
    seg_n = first.numel() // p
    out = torch.empty((local, seg_n), dtype=first.dtype, device=first.device)
    if seg_n:
        table = (ctypes.c_ulonglong * p)(*[r.data_ptr() for r in rows])
        own = (ctypes.c_int * local)(*owned)
        _launch("tm_ring_reduce_scatter_xproc", first, table, p, own, local, out.data_ptr(),
                NATIVE_DTYPES[first.dtype], seg_n, stream=stream)
        launches["ring_reduce_scatter_xproc"] += 1
    return out


def ring_allgather_xproc_plain(rows, local: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`ring_allgather_xproc`: the p blocks
    stacked in rank order, copied to ``local`` rows."""
    _check_table(rows, local, "ring_allgather_xproc")
    x = torch.stack(list(rows))
    return x[None].expand((local,) + tuple(x.shape)).contiguous()


def ring_allgather_xproc(rows, local: int, stream=None) -> torch.Tensor:
    """Allgather over ranks held by several processes: ``rows`` are the p
    rank blocks (``[*s]`` each) in rank order, each where it lies, and the
    result ``[local, p, *s]``: every one of this process's rows gets every
    block, in rank order, as :func:`ring_allgather`'s rows do. One launch
    of the cross-process K3 'ag' (``ring_allgather_pallas`` across
    processes, ``ring_kernels.py:831``); the plain version for CPU
    blocks. Any dtype but complex: the kernel copies bytes."""
    first = rows[0]
    if first.device.type == "cpu":
        return ring_allgather_xproc_plain(rows, local)
    _check_table(rows, local, "ring_allgather_xproc")
    _check_cuda(first, "ring_allgather_xproc")
    if first.dtype.is_complex:
        raise ValueError(f"ring_allgather_xproc: complex dtypes are not supported "
                         f"({first.dtype})")
    p = len(rows)
    out = torch.empty((local, p) + tuple(first.shape), dtype=first.dtype, device=first.device)
    row_bytes = first.numel() * first.element_size()
    if row_bytes:
        table = (ctypes.c_ulonglong * p)(*[r.data_ptr() for r in rows])
        _launch("tm_ring_allgather_xproc", first, table, p, out.data_ptr(), local, row_bytes,
                stream=stream)
        launches["ring_allgather_xproc"] += 1
    return out


def ring_allreduce_bidir_xproc_plain(rows, local: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`ring_allreduce_bidir_xproc`: the p
    rank rows stacked, :func:`ring_allreduce_bidir_plain`'s row copied to
    ``local`` rows."""
    _check_table(rows, local, "ring_allreduce_bidir_xproc")
    x = torch.stack(list(rows))
    out = ring_allreduce_bidir_plain(x)
    return out[:1].expand((local,) + tuple(x.shape[1:])).contiguous()


def ring_allreduce_bidir_xproc(rows, local: int, stream=None) -> torch.Tensor:
    """The bidirectional allreduce over ranks held by several processes:
    ``rows`` are the p rank rows in rank order, each where it lies (this
    process's or a peer's mapped slab), and the result ``[local, ...]``,
    the process's own rows, each :func:`ring_allreduce_bidir`'s sum of the
    stacked rows bit for bit (half A rightward, half B leftward, the
    :func:`bidir_chunk_elems` layout). ``p <= 2`` runs
    :func:`ring_allreduce_xproc`, as the one-process wrapper delegates.
    One launch of the cross-process K5 (``ring_allreduce_bidir_pallas``
    across processes, ``ring_kernels.py:1005``); the plain version for CPU
    rows. Natively reduced dtypes only: the caller casts to
    :func:`carrier_dtype` before it publishes."""
    first = rows[0]
    if first.device.type == "cpu":
        return ring_allreduce_bidir_xproc_plain(rows, local)
    _check_table(rows, local, "ring_allreduce_bidir_xproc")
    _check_cuda(first, "ring_allreduce_bidir_xproc")
    _check_native_table(rows, "ring_allreduce_bidir_xproc")
    p = len(rows)
    if p <= 2:
        return ring_allreduce_xproc(rows, local, stream=stream)
    out = torch.empty((local,) + tuple(first.shape), dtype=first.dtype, device=first.device)
    n = first.numel()
    if n:
        half = -(-n // 2)
        table = (ctypes.c_ulonglong * p)(*[r.data_ptr() for r in rows])
        _launch("tm_ring_allreduce_bidir_xproc", first, table, p, out.data_ptr(), local,
                NATIVE_DTYPES[first.dtype], n, half, bidir_chunk_elems(half, p, first.dtype),
                stream=stream)
        launches["ring_allreduce_bidir_xproc"] += 1
    return out


def _check_reduce_owned(rows, owned, root: int, what: str) -> list:
    owned = _check_distinct_owned(rows, owned, what)
    if root not in owned:
        raise ValueError(f"{what}: the root {root} is not among the owned ranks {owned} (only "
                         "the root's process launches it)")
    return owned


def ring_reduce_xproc_plain(rows, owned, root: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`ring_reduce_xproc`: the p rank rows
    stacked, :func:`ring_reduce_plain`'s rows of the ranks in ``owned``."""
    owned = _check_reduce_owned(rows, owned, root, "ring_reduce_xproc")
    out = ring_reduce_plain(torch.stack(list(rows)), root)
    return out[torch.tensor(owned, device=out.device)]


def ring_reduce_xproc(rows, owned, root: int, stream=None) -> torch.Tensor:
    """Sum-reduce to rank ``root`` over ranks held by several processes,
    in the root's process: ``rows`` are the p rank rows in rank order,
    each where it lies (this process's or a peer's mapped slab), and
    ``owned`` the global rank of each of this process's rows, ``root``
    among them. Row i of the ``[L, ...]`` result is rank ``owned[i]``'s
    row of :func:`ring_reduce` on the stacked rows, bit for bit: the ring
    allreduce's sum for the root, its input for every other rank. Every
    other process's result is its input, and it reads no peer's slab
    (``runtime/peers.py`` ``Lane.reduce``). One launch of the
    cross-process K6 (``ring_reduce_pallas`` across processes,
    ``ring_kernels.py:1232``); the plain version for CPU rows. Natively
    reduced dtypes only: the caller casts to :func:`carrier_dtype` before
    it publishes."""
    first = rows[0]
    if first.device.type == "cpu":
        return ring_reduce_xproc_plain(rows, owned, root)
    owned = _check_reduce_owned(rows, owned, root, "ring_reduce_xproc")
    _check_cuda(first, "ring_reduce_xproc")
    _check_native_table(rows, "ring_reduce_xproc")
    p, local = len(rows), len(owned)
    out = torch.empty((local,) + tuple(first.shape), dtype=first.dtype, device=first.device)
    n = first.numel()
    if n:
        table = (ctypes.c_ulonglong * p)(*[r.data_ptr() for r in rows])
        own = (ctypes.c_int * local)(*owned)
        _launch("tm_ring_reduce_xproc", first, table, p, own, local, out.data_ptr(),
                NATIVE_DTYPES[first.dtype], n, chunk_elems(n, p, first.dtype), root,
                stream=stream)
        launches["ring_reduce_xproc"] += 1
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
    # rows (p addresses), p, owned (local ranks), local, out, wire, mode, n,
    # chunk_elems, stream
    "tm_ring_quant_xproc": [
        ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p,
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
    it is rounded once, as the single f32 FMA that XLA makes of the JAX
    kernel's decode-and-add (and ``__fmaf_rn`` in the kernel): the product
    of a code (an integer of at most 127) and a scale (24 bits) is
    exact in f64, the f64
    sum is rounded to odd and then to f32, the f32 branch of
    :func:`~.reduce_kernel.scale_accumulate_plain`."""
    if scale is None:
        return local + codes
    from .reduce_kernel import _round_to_odd, _two_sum

    s, rest = _two_sum(local.double(), codes.double() * scale.double())
    # the error-free sum needs finite operands; an inf or nan takes the
    # IEEE result of the plain form, which the FMA gives too
    return torch.where(torch.isfinite(s), _round_to_odd(s, rest).float(),
                       local + codes * scale)


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
                  n: int, chunk: int, stream=None) -> None:
    from ._build import check, launch, library

    call = library("ring_quant", _QUANT_SIGNATURES).tm_ring_quant
    err = launch(x.device, lambda s: call(
        x.data_ptr(), out.data_ptr(), _WIRE_CODES[wire], _MODE_CODES[mode],
        x.shape[0], n, chunk, s), stream)
    check(err, f"ring quant ({mode}, {wire})")


def ring_allreduce_quant(x: torch.Tensor, wire: str, stream=None) -> torch.Tensor:
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
        _launch_quant(flat, out, wire, "allreduce", n, quant_chunk_elems(n, p, wire), stream)
        launches[f"ring_allreduce_quant_{wire}"] += 1
    return out.reshape(x.shape)


def ring_reduce_scatter_quant(x: torch.Tensor, wire: str, stream=None) -> torch.Tensor:
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
        _launch_quant(x, out, wire, "rs", seg_n, 0, stream)
        launches[f"ring_reduce_scatter_quant_{wire}"] += 1
    return out


# ---------------------------------------------------------------------------
# the cross-process K4: the quantized ring over ranks held by several
# processes, each rank's row read where it lies (runtime/peers.py)
# ---------------------------------------------------------------------------


def _check_quant_table(rows, owned, wire: str, what: str) -> list:
    if wire not in WIRES:
        raise ValueError(f"wire must be one of {WIRES}, got {wire!r}")
    owned = _check_distinct_owned(rows, owned, what)
    if rows[0].dtype != torch.float32 or rows[0].ndim != 1:
        raise ValueError(f"{what} takes 1-D float32 rank rows, got {rows[0].dtype} "
                         f"{tuple(rows[0].shape)}")
    return owned


def ring_allreduce_quant_xproc_plain(rows, owned, wire: str) -> torch.Tensor:
    """Plain PyTorch version of :func:`ring_allreduce_quant_xproc`: the p
    rank rows stacked, :func:`ring_allreduce_quant_plain`'s rows of the
    ranks in ``owned``."""
    owned = _check_quant_table(rows, owned, wire, "ring_allreduce_quant_xproc")
    out = ring_allreduce_quant_plain(torch.stack(list(rows)), wire)
    return out[torch.tensor(owned, device=out.device)]


def ring_allreduce_quant_xproc(rows, owned, wire: str, stream=None) -> torch.Tensor:
    """The quantized allreduce over ranks held by several processes:
    ``rows`` are the p rank rows ``[n]`` f32 in rank order, each where it
    lies (this process's or a peer's mapped slab), ``owned`` the global
    rank of each of this process's rows. Row i of the ``[L, n]`` result is
    rank ``owned[i]``'s row of :func:`ring_allreduce_quant` on the stacked
    rows, bit for bit: each process walks every row position's full hop
    chain and stores its own ranks' values. One launch of the
    cross-process K4 (``ring_allreduce_quant_pallas`` across processes,
    ``ring_kernels.py:746``); the plain version for CPU rows."""
    first = rows[0]
    if first.device.type == "cpu":
        return ring_allreduce_quant_xproc_plain(rows, owned, wire)
    owned = _check_quant_table(rows, owned, wire, "ring_allreduce_quant_xproc")
    _check_cuda(first, "ring_allreduce_quant_xproc")
    p, n = len(rows), first.numel()
    out = torch.empty((len(owned), n), dtype=first.dtype, device=first.device)
    if n:
        _launch_quant_xproc(rows, owned, out, wire, "allreduce", n,
                            quant_chunk_elems(n, p, wire), stream)
        launches[f"ring_allreduce_quant_xproc_{wire}"] += 1
    return out


def ring_reduce_scatter_quant_xproc_plain(rows, owned, wire: str) -> torch.Tensor:
    """Plain PyTorch version of :func:`ring_reduce_scatter_quant_xproc`:
    the p rank rows stacked, :func:`ring_reduce_scatter_quant_plain`'s
    rows of the ranks in ``owned``."""
    owned = _check_quant_table(rows, owned, wire, "ring_reduce_scatter_quant_xproc")
    p = len(rows)
    if rows[0].numel() % p:
        raise ValueError(f"ring_reduce_scatter_quant_xproc takes rank rows of p segments "
                         f"(p={p}), got {tuple(rows[0].shape)}")
    out = ring_reduce_scatter_quant_plain(torch.stack(list(rows)).reshape(p, p, -1), wire)
    return out.reshape(p, -1)[torch.tensor(owned, device=out.device)]


def ring_reduce_scatter_quant_xproc(rows, owned, wire: str, stream=None) -> torch.Tensor:
    """The quantized reduce-scatter over ranks held by several processes:
    ``rows`` are the p rank rows ``[p m]`` f32 in rank order, each where it
    lies, ``owned`` the global rank of each of this process's rows. Row i
    of the ``[L, m]`` result is the f32 sum of every rank's segment
    ``owned[i]`` with ``wire`` on every hop, bit for bit
    :func:`ring_reduce_scatter_quant`'s row of that rank (segment s's sum
    starts at rank s + 1 and walks rightward to s): a process walks only
    its own segments. One launch of the cross-process K4 'rs'
    (``ring_reduce_scatter_quant_pallas`` across processes,
    ``ring_kernels.py:782``); the plain version for CPU rows."""
    first = rows[0]
    if first.device.type == "cpu":
        return ring_reduce_scatter_quant_xproc_plain(rows, owned, wire)
    owned = _check_quant_table(rows, owned, wire, "ring_reduce_scatter_quant_xproc")
    _check_cuda(first, "ring_reduce_scatter_quant_xproc")
    p = len(rows)
    if first.numel() % p:
        raise ValueError(f"ring_reduce_scatter_quant_xproc takes rank rows of p segments "
                         f"(p={p}), got {tuple(first.shape)}")
    seg_n = first.numel() // p
    out = torch.empty((len(owned), seg_n), dtype=first.dtype, device=first.device)
    if seg_n:
        _launch_quant_xproc(rows, owned, out, wire, "rs", seg_n, 0, stream)
        launches[f"ring_reduce_scatter_quant_xproc_{wire}"] += 1
    return out


def _launch_quant_xproc(rows, owned, out: torch.Tensor, wire: str, mode: str, n: int,
                        chunk: int, stream=None) -> None:
    from ._build import check, launch, library

    call = library("ring_quant", _QUANT_SIGNATURES).tm_ring_quant_xproc
    p, local = len(rows), len(owned)
    table = (ctypes.c_ulonglong * p)(*[r.data_ptr() for r in rows])
    own = (ctypes.c_int * local)(*owned)
    err = launch(out.device, lambda s: call(
        table, p, own, local, out.data_ptr(), _WIRE_CODES[wire], _MODE_CODES[mode], n,
        chunk, s), stream)
    check(err, f"cross-process ring quant ({mode}, {wire})")
