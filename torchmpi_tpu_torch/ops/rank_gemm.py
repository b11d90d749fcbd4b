"""What the per-rank kernels (``csrc/conv_wgrad.cu``, ``csrc/rank_bmm.cu``)
share on the host: the plan of a launch's tiles and slices of K, and the
tickets of their split-K reduction.

:func:`plan` reads M, N and K alone, never the number of ranks, so a
rank's sums run in the same order in any stack (``csrc/rank_gemm.cuh``).
The tickets are zeroed once, when :func:`tickets` first makes or grows a
device's and stream's buffer: the last block of a tile sets its ticket
back to 0, so a launch leaves the buffer as it found it and no call
launches a memset.
"""

from __future__ import annotations

import threading
from typing import Dict, NamedTuple, Tuple

import torch

BK = 32  # the kernels' stage depth: a slice of K is a multiple of it
BLOCKS_PER_RANK = 48  # the slices of K aim at this many blocks a rank
MAX_SPLITS = 64
MIN_SLICE = 4 * BK  # a slice keeps a few stages in flight


class Plan(NamedTuple):
    bm: int  # the block tile's rows (of M)
    bn: int  # and columns (of N)
    tiles: int  # tiles of one rank's M x N output
    splits: int  # slices of K
    kc: int  # their length


def plan(m: int, n: int, k: int) -> Plan:
    """The tiles and slices of an ``m`` x ``n`` product over ``k``: the
    smallest of mma's 16-row steps (16, 32, 48) that holds ``m``, else 64
    rows; 32 columns when ``n`` fits, else 128 beside 64 rows and 64
    beside fewer; then about :data:`BLOCKS_PER_RANK` blocks a rank, each
    slice a multiple of :data:`BK` and, where there are several, at least
    :data:`MIN_SLICE` deep, at most :data:`MAX_SPLITS` slices."""
    if min(m, n, k) < 1:
        raise ValueError(f"plan takes a non-empty product, got m={m}, n={n}, k={k}")
    bm = next((b for b in (16, 32, 48) if m <= b), 64)
    bn = 32 if n <= 32 else 128 if bm == 64 else 64
    tiles = -(-m // bm) * -(-n // bn)
    want = max(1, min(MAX_SPLITS, -(-BLOCKS_PER_RANK // tiles), k // MIN_SLICE))
    kc = -(-(-(-k // want)) // BK) * BK
    return Plan(bm, bn, tiles, -(-k // kc), kc)


_lock = threading.Lock()
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def tickets(device: torch.device, stream: int, count: int) -> torch.Tensor:
    """At least ``count`` zero tickets for launches on ``stream`` (a CUDA
    stream handle) of ``device``, made (zeroed on that stream) the first
    time and grown only when a launch needs more; every launch leaves them
    zero."""
    key = (device.index, stream)
    with _lock:
        buf = _tickets.get(key)
        if buf is None or buf.numel() < count:
            with torch.cuda.stream(torch.cuda.ExternalStream(stream, device=device)):
                buf = torch.zeros(max(count, 4096), dtype=torch.int32, device=device)
            _tickets[key] = buf
        return buf


def scratch(device: torch.device, stream: int, ranks: int, p: Plan):
    """``(work, tickets)`` of a launch of ``ranks`` ranks under ``p`` on
    ``stream``: the partial tiles' workspace (a new tensor) and the
    tickets' pointer, both None for one slice."""
    if p.splits == 1:
        return None, None
    work = torch.empty(ranks * p.tiles * p.splits * p.bm * p.bn, dtype=torch.float32,
                       device=device)
    return work, tickets(device, stream, ranks * p.tiles).data_ptr()
