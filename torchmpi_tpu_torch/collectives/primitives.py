"""Collective primitives on the rank axis: the vendor path, the ``ring``
backend and the wire codec.

The port of ``torchmpi_tpu/collectives/primitives.py``. The JAX functions
run per device under ``shard_map``; these take the rank-stacked tensor
``x`` (``x[r]`` is rank r's block) and do every rank's part at once.

- **The vendor ops** (``reduce``, ``allgather``, ``reduce_scatter``,
  ``sendreceive``, ``alltoall``) are plain PyTorch over the rank axis,
  where the JAX package called one fused XLA collective.
- **The ring backend** (``ring_allreduce``, ``ring_reduce``,
  ``ring_reduce_scatter``, ``ring_allgather``, ``ring_broadcast``,
  ``tree_broadcast``, ``ring_alltoall``) is the JAX ``ppermute`` ring, hop
  by hop: a ``ppermute`` to the right neighbour is a ``torch.roll`` of the
  rank-stacked message by one. Each primitive keeps the JAX one's chunk
  layout (``_flatten_pad``, the byte-bounded segments, the pipeline
  segments), so a float sum starts at the same rank and adds in the same
  order as in the JAX ring. The ring is plain PyTorch, the part XLA did;
  it is not a kernel (the ``kernel`` backend is ``ops``). ``ring_allreduce``,
  ``ring_reduce``, ``ring_reduce_scatter`` and ``ring_allgather`` also run
  B independent rings at once (``batched=True``, ``[p, B, ...]``), one
  level of a two-level communicator, each ring as the JAX ring over one
  mesh axis. :func:`exchange` is one ``ppermute`` over any rank
  permutation, with the wire (the recursive-halving exchange's hop).
- **The wire codec** (EQuARX-style, arXiv:2506.17615): the rings may ship
  each hop as int8 with one f32 scale per block, or as a bf16 cast, and sum
  in f32. Callers opt in through ``wire_dtype=`` or the ``wire_dtype``
  constant. The int8 scale of a block is ``max(max|block|, 1e-30) *
  (1/127)``, the JAX package's ``max/127`` as XLA computes it: a product
  with the f32 reciprocal.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.ring_kernels import SCALE_FLOOR, row_scale

#: wire encodings the rings understand ('full' = ship the dtype verbatim)
WIRE_DTYPES = ("full", "bf16", "int8")

# smallest positive scale: a zero block must not divide by zero, and the
# dequantized zeros stay exactly zero
_SCALE_FLOOR = float(SCALE_FLOOR)


# ---------------------------------------------------------------------------
# vendor ops: plain PyTorch over the rank axis
# ---------------------------------------------------------------------------


def _block_dim(x: torch.Tensor, dim: int, lead: int = 1) -> int:
    """``dim`` of a rank's block (negative counts from the end) as a dim of
    the rank-stacked ``x``, whose block follows ``lead`` leading axes (the
    rank axis, and the ring axis of a batched ring)."""
    nd = x.ndim - lead
    if not -nd <= dim < nd:
        raise ValueError(f"dim {dim} out of range for blocks of {nd} dims")
    return dim % nd + lead


def allreduce(x: torch.Tensor) -> torch.Tensor:
    """Every rank gets the sum (``psum``)."""
    return x.sum(0, keepdim=True, dtype=x.dtype).expand_as(x).contiguous()


def broadcast(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Every rank gets the root's block."""
    return x[root : root + 1].expand_as(x).contiguous()


def reduce(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """The root gets the sum; every other rank keeps its input."""
    out = x.clone()
    out[root] = x.sum(0, dtype=x.dtype)
    return out


def allgather(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Every rank gets all blocks concatenated along ``dim`` of the block
    (``lax.all_gather`` tiled)."""
    d = _block_dim(x, dim)
    cat = torch.cat(x.unbind(0), dim=d - 1)
    return cat.unsqueeze(0).expand((x.shape[0],) + tuple(cat.shape)).contiguous()


def reduce_scatter(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Rank r gets slice r, along ``dim`` of the block, of the sum
    (``lax.psum_scatter`` tiled)."""
    p, d = x.shape[0], _block_dim(x, dim)
    if x.shape[d] % p:
        raise ValueError(
            f"reduce_scatter dim {d - 1} ({x.shape[d]}) must be divisible by "
            f"the axis size ({p})"
        )
    total = x.sum(0, dtype=x.dtype)
    return torch.stack(total.chunk(p, dim=d - 1))


def sendreceive(x: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """``dst`` gets ``src``'s block, every other rank keeps its own."""
    out = x.clone()
    out[dst] = x[src]
    return out


def alltoall(x: torch.Tensor) -> torch.Tensor:
    """``x[r, s]`` is rank r's block for rank s; rank r gets ``[x[j, r] for
    j]`` (``lax.all_to_all`` tiled on the block's dim 0)."""
    return x.transpose(0, 1).contiguous()


# ---------------------------------------------------------------------------
# block-quantized wire codec
# ---------------------------------------------------------------------------


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


def _shift(msg: torch.Tensor, offset: int = 1) -> torch.Tensor:
    """A ``ppermute`` of every rank's message to rank ``r + offset``: what
    rank r receives is what rank ``r - offset`` sent."""
    return torch.roll(msg, offset, dims=0)


def wire_transfer(msg: torch.Tensor, wire: Optional[str], block: int,
                  local: Optional[torch.Tensor] = None) -> torch.Tensor:
    """What a receiver installs for a message ``msg`` (``[..., m]``, one
    message per leading index) that travelled in the wire's form
    (``_wire_send_recv``): the decoded message or, given the receiver's
    ``local`` partial, ``local + decoded``. An int8 message is cut into
    blocks of ``block`` from its own start, zero-padded to whole blocks,
    as ``quantize_blocks`` cuts a flat message. Its decode-and-add is
    exact in f64 and rounds there, then to f32: XLA fuses the JAX ring's
    into one f32 FMA, which this equals but for double rounding when
    ``local`` is some 2^29 times smaller than the product."""
    if wire == "int8":
        m = msg.shape[-1]
        blocks = torch.nn.functional.pad(msg, (0, -m % block))
        blocks = blocks.reshape(msg.shape[:-1] + (-1, block))
        scale = row_scale(blocks)
        q = torch.round(blocks / scale).to(torch.int8)
        if local is None:
            return (q.float() * scale).reshape(msg.shape[:-1] + (-1,))[..., :m]
        prod = (q.double() * scale.double()).reshape(msg.shape[:-1] + (-1,))
        return (prod[..., :m] + local.double()).float()
    recv = msg.to(torch.bfloat16).float() if wire == "bf16" else msg
    return recv if local is None else local + recv


def _hop(buf: torch.Tensor, wire: Optional[str], block: int,
         local: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One ring hop: every rank's last-dim message in ``buf`` (``[p, ...,
    m]``) goes to its right neighbour in the wire's form; returns what
    each rank installs (:func:`wire_transfer`). Each rank's message is
    encoded on its own, so encoding before the shift is encoding after."""
    return wire_transfer(_shift(buf), wire, block, local)


def exchange(buf: torch.Tensor, perm, wire: Optional[str], block: int,
             local: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One exchange over a permutation of the ranks (``lax.ppermute(buf,
    perm)``, under a wire ``_wire_send_recv``, ``primitives.py:141``):
    ``perm`` holds a ``(src, dst)`` pair for every rank, and rank ``dst``
    receives rank ``src``'s message (``buf[src]``, ``[p, ..., m]``);
    returns what each rank installs (:func:`wire_transfer`: the decoded
    message or, given the receiver's ``local`` partial, ``local +
    decoded``, rounded once)."""
    src_of = {int(d): int(s) for s, d in perm}
    idx = torch.tensor([src_of[r] for r in range(buf.shape[0])], device=buf.device)
    return wire_transfer(buf.index_select(0, idx), wire, block, local)


# ---------------------------------------------------------------------------
# the ring backend
# ---------------------------------------------------------------------------


def _flatten_pad(x: torch.Tensor, p: int):
    """Every rank's block flattened and zero-padded to ``p`` chunks:
    ``([p, p * chunk], n, chunk)``."""
    flat = x.reshape(x.shape[0], -1)
    n = flat.shape[1]
    chunk = -(-n // p)
    return torch.nn.functional.pad(flat, (0, chunk * p - n)), n, chunk


def _ring_phases(ch: torch.Tensor, wire: Optional[str] = None,
                 block: int = 0) -> torch.Tensor:
    """The reduce-scatter and all-gather phases over ``ch``, ``[p, nb, p,
    chunk]``: rank r's ``nb`` independent segments of p ring chunks
    (``_ring_phases`` and, with a ``wire``, ``_ring_phases_wire``). At RS
    step s rank r sends chunk ``r - s`` and adds the incoming one into chunk
    ``r - s - 1``; after p-1 steps it owns chunk ``r + 1``, which the AG
    steps forward round the ring. The JAX ring walks the segments of a
    wave in lockstep and the waves one after another; each segment's sums
    are independent, so here all segments ride each hop together."""
    p = ch.shape[0]
    ch = ch.clone()
    ranks = torch.arange(p, device=ch.device)
    for s in range(p - 1):
        send, recv = (ranks - s) % p, (ranks - s - 1) % p
        ch[ranks, :, recv] = _hop(ch[ranks, :, send], wire, block, ch[ranks, :, recv])
    for s in range(p - 1):
        send, recv = (ranks + 1 - s) % p, (ranks - s) % p
        ch[ranks, :, recv] = _hop(ch[ranks, :, send], wire, block)
    return ch


def _pipeline_segments(flat: torch.Tensor, p: int, chunk: int, depth: int,
                       align: int = 1):
    """Each ring's ring-padded ``[p * chunk]`` buffer, ``flat`` being
    ``[p(rank), B(ring), p * chunk]``, as ``d`` interleaved pipeline
    segments, ``[p(rank), B * d, p, sub]``: segment j holds sub-span j of
    every ring chunk, so an element keeps its chunk (its start rank) and,
    with ``align`` the int8 block, its block grid. Returns ``(segments,
    d, sub)``."""
    sub = -(-chunk // max(1, depth))
    if align > 1:
        sub = -(-sub // align) * align
    sub = max(1, sub)
    d = max(1, -(-chunk // sub))
    r, b = flat.shape[:2]
    a = flat.reshape(r, b, p, chunk)
    a = torch.nn.functional.pad(a, (0, d * sub - chunk))
    return a.reshape(r, b, p, d, sub).transpose(2, 3).reshape(r, b * d, p, sub), d, sub


def _pipeline_unsegment(segs: torch.Tensor, rings: int, chunk: int) -> torch.Tensor:
    """Inverse of :func:`_pipeline_segments`: ``[p(rank), rings, p *
    chunk]`` again, the padding inside each chunk dropped."""
    r, bd, p, sub = segs.shape
    d = bd // rings
    out = segs.reshape(r, rings, d, p, sub).transpose(2, 3)
    return out.reshape(r, rings, p, d * sub)[..., :chunk].reshape(r, rings, -1)


def ring_allreduce(
    x: torch.Tensor,
    max_bytes_per_step: Optional[int] = None,
    min_bytes_per_step: Optional[int] = None,
    num_buffers: int = 1,
    wire_dtype: Optional[str] = None,
    wire_block: Optional[int] = None,
    pipeline_depth: int = 1,
    batched: bool = False,
) -> torch.Tensor:
    """Chunked ring allreduce of the rank-stacked ``x``: (p-1)
    reduce-scatter steps then (p-1) all-gather steps (``ring_allreduce``,
    ``primitives.py:312``). When a step's message (``ceil(n/p)`` elements)
    would exceed ``max_bytes_per_step``, each rank's buffer is cut into
    segments of p chunks of at most that many bytes (and at least
    ``min_bytes_per_step``), ``num_buffers`` segments to a wave. A
    ``wire_dtype`` ('int8' | 'bf16') that engages ships every hop encoded
    and sums in f32, unsegmented. ``pipeline_depth`` > 1 cuts each chunk
    into interleaved sub-spans, which changes no element's chunk: the
    result is bitwise the same.

    ``batched``: ``x`` is ``[p, B, ...]``, B independent rings of p ranks
    (ring b over ``x[:, b]``), one level of a two-level communicator.
    Each ring has the chunk layout, segments and order of adds of a ring
    over its own per-rank payload ``x[r, b]``, as the JAX ring over one
    mesh axis has; the rings ride every hop together."""
    p = x.shape[0]
    if p == 1:
        return x
    rows = x.reshape(p, x.shape[1] if batched else 1, -1)  # [rank, ring, payload]
    rings, nelem = rows.shape[1:]
    itemsize = x.element_size()
    chunk = -(-nelem // p)

    def padded(total: int) -> torch.Tensor:
        return torch.nn.functional.pad(rows, (0, total - nelem))

    wire, block = None, 0
    if wire_engages(wire_dtype, x.dtype, nelem):
        from .. import constants

        wire = wire_dtype
        block = wire_block or constants.get("wire_quant_block_size")
    if wire is not None or max_bytes_per_step is None or chunk * itemsize <= max_bytes_per_step:
        segs, _, _ = _pipeline_segments(padded(p * chunk), p, chunk, pipeline_depth,
                                        align=max(1, block))
        out = _ring_phases(segs, wire, block)
        return _pipeline_unsegment(out, rings, chunk)[..., :nelem].reshape(x.shape)

    # byte-bounded segments: per-step message size in [min, max] bytes
    seg_chunk = max(1, int(max_bytes_per_step) // itemsize)
    if min_bytes_per_step:
        floor = -(-int(min_bytes_per_step) // itemsize)
        seg_chunk = max(seg_chunk, min(chunk, floor))
    seg = seg_chunk * p
    nseg = -(-nelem // seg)
    nb = max(1, min(int(num_buffers), nseg))
    nwave = -(-nseg // nb)
    out = _ring_phases(padded(nwave * nb * seg).reshape(p, -1, p, seg_chunk))
    return out.reshape(p, rings, -1)[..., :nelem].reshape(x.shape)


def ring_reduce(
    x: torch.Tensor,
    root: int = 0,
    max_bytes_per_step: Optional[int] = None,
    min_bytes_per_step: Optional[int] = None,
    num_buffers: int = 1,
    wire_dtype: Optional[str] = None,
    batched: bool = False,
) -> torch.Tensor:
    """Reduce to ``root`` as the ring allreduce masked to the root; every
    other rank keeps its input (``ring_reduce``, ``primitives.py:493``).
    ``batched`` as :func:`ring_allreduce`: rank ``root`` of every ring."""
    total = ring_allreduce(
        x, max_bytes_per_step=max_bytes_per_step,
        min_bytes_per_step=min_bytes_per_step, num_buffers=num_buffers,
        wire_dtype=wire_dtype, batched=batched,
    )
    out = x.clone()
    out[root] = total[root]
    return out


def ring_reduce_scatter(
    x: torch.Tensor,
    dim: int = -1,
    wire_dtype: Optional[str] = None,
    wire_block: Optional[int] = None,
    batched: bool = False,
) -> torch.Tensor:
    """Reduce-scatter over ``dim`` of each rank's block as the (p-1)-step
    reduce-scatter phase of the ring (``ring_reduce_scatter``,
    ``primitives.py:518``): rank r gets slice r of the sum. The schedule is
    shifted one slot from the allreduce's, so slice s's sum starts at rank
    s + 1 and ends at rank s. ``wire_dtype`` encodes every hop (each
    slice in blocks from its own start) and sums in f32, as
    :func:`ring_allreduce`.

    ``batched``: ``x`` is ``[p, B, ...]``, B independent rings of p ranks
    (ring b over ``x[:, b]``, ``dim`` a dim of ``x[r, b]``), each with the
    shifted schedule and the wire of one JAX ring over its own payload."""
    p = x.shape[0]
    if p == 1:
        return x
    body = 2 if batched else 1
    d = _block_dim(x, dim, body)
    if x.shape[d] % p:
        raise ValueError(
            f"reduce_scatter dim {d - body} ({x.shape[d]}) must be divisible by "
            f"the axis size ({p})"
        )
    moved = x.movedim(d, body)
    rings = x.shape[1] if batched else 1
    rest = tuple(moved.shape[body + 1:])
    ch = moved.reshape(p, rings, p, -1).clone()  # [rank, ring, slice, slice elements]
    wire, block = None, 0
    if wire_engages(wire_dtype, x.dtype, math.prod(x.shape[body:])):
        from .. import constants

        wire = wire_dtype
        block = wire_block or constants.get("wire_quant_block_size")
    ranks = torch.arange(p, device=x.device)
    for s in range(p - 1):
        send, recv = (ranks - s - 1) % p, (ranks - s - 2) % p
        ch[ranks, :, recv] = _hop(ch[ranks, :, send], wire, block, ch[ranks, :, recv])
    mine = ch[ranks, :, ranks].reshape(tuple(moved.shape[:body]) + (moved.shape[body] // p,) + rest)
    return mine.movedim(body, d)


def ring_allgather(x: torch.Tensor, dim: int = -1, batched: bool = False) -> torch.Tensor:
    """Allgather as p-1 ring forwarding steps (``ring_allgather``,
    ``primitives.py:603``): every rank gets all blocks concatenated along
    ``dim`` of the block, in rank order. ``batched``: ``x`` is ``[p, B,
    ...]``, B independent rings (ring b over ``x[:, b]``)."""
    p = x.shape[0]
    if p == 1:
        return x
    d = _block_dim(x, dim, 2 if batched else 1)
    ranks = torch.arange(p, device=x.device)
    out = torch.empty((p, p) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    out[ranks, ranks] = x
    buf = x
    for s in range(p - 1):
        buf = _shift(buf)
        out[ranks, (ranks - s - 1) % p] = buf
    # [rank, source, *block] -> the sources concatenated along the block's dim
    moved = out.movedim(1, d)
    return moved.reshape(x.shape[:d] + (p * x.shape[d],) + x.shape[d + 1:])


def ring_broadcast(x: torch.Tensor, root: int = 0,
                   num_chunks: Optional[int] = None) -> torch.Tensor:
    """Pipelined chunked ring broadcast (``ring_broadcast``,
    ``primitives.py:427``): the root's buffer, cut into ``num_chunks``
    chunks (default p), flows down the ring; chunk c reaches the rank at
    distance d from the root at step c + d - 1."""
    p = x.shape[0]
    if p == 1:
        return x
    k = num_chunks or p
    flat, n, chunk = _flatten_pad(x, k)
    ch = flat.reshape(p, k, chunk)
    ranks = torch.arange(p, device=x.device)
    dist = (ranks - root) % p
    for t in range(k + p - 2):
        buf = ch[ranks, (t - dist).clamp(0, k - 1)]
        recv = _shift(buf)
        recv_idx = t - dist + 1
        valid = (dist > 0) & (recv_idx >= 0) & (recv_idx < k)
        rclip = recv_idx.clamp(0, k - 1)
        cur = ch[ranks, rclip]
        ch[ranks, rclip] = torch.where(valid[:, None], recv, cur)
    return ch.reshape(p, -1)[:, :n].reshape(x.shape)


def tree_broadcast(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Binomial-tree broadcast (``tree_broadcast``, ``primitives.py:468``):
    ceil(log2 p) steps, each doubling the ranks that hold the root's
    block; at step k the ranks at distance [2^k, 2^(k+1)) from the root
    receive from the rank 2^k before them."""
    p = x.shape[0]
    if p == 1:
        return x
    dist = (torch.arange(p, device=x.device) - root) % p
    for k in range(max(1, math.ceil(math.log2(p)))):
        span = 1 << k
        if span >= p:
            break
        receives = (dist >= span) & (dist < 2 * span)
        recv = _shift(x, span)
        x = torch.where(receives.reshape((p,) + (1,) * (x.ndim - 1)), recv, x)
    return x


def ring_alltoall(x: torch.Tensor) -> torch.Tensor:
    """All-to-all as p-1 pairwise exchanges (``ring_alltoall``,
    ``primitives.py:580``): ``x[r, s]`` is rank r's block for rank s; at
    offset k every rank r sends its block for rank r + k, so rank r gets
    ``[x[j, r] for j]``."""
    p = x.shape[0]
    if p == 1:
        return x
    ranks = torch.arange(p, device=x.device)
    out = torch.empty_like(x)
    out[ranks, ranks] = x[ranks, ranks]
    for k in range(1, p):
        recv = _shift(x[ranks, (ranks + k) % p], k)
        out[ranks, (ranks - k) % p] = recv
    return out
