"""The chunk-pipeline primitive: one chunking rule, one pipeline driver.

The PS wire codec had a hand-rolled chunk pipeline (encode chunk k+1
while chunk k is on the wire), and the reshard executor another
(`reshard_chunk_bytes` pieces through one scratch buffer). This module lifts both into the schedule IR's vocabulary so
every plan family earns the same pipeline:

- :func:`split_spans` is the ONE span-splitting rule: cut ``n`` logical
  elements into ``(offset, nelem)`` chunks of at most ``chunk_elems``,
  optionally aligned (int8 wire encodings align to the quantization
  block grid so a chunk's scales reproduce the unchunked ones exactly —
  the bitwise-equivalence contract). The PS wire codec's ``plan_chunks``
  and the reshard executor's ``chunk_spans`` both delegate here.
- :func:`depth_candidates` is the compiler-side policy: which pipeline
  depths are worth pricing for a payload, per the ``plan_pipeline_*``
  knobs.
- :class:`ChunkPipeline` drives a host-side chunk stream (reshard
  transfers, PS frame chunks) and stamps each chunk's flight-recorder
  sub-entry ``(plan_id, chunk_idx)`` on the rank-local ``"chunks"``
  stream — visible in traces, EXCLUDED from the cross-rank desync diff,
  the straggler spread and the calibration sample extraction (chunk
  timings would land in the chunk-size payload bucket and bias the
  medians; the parent dispatch entry carries the logical payload).

Device-side pipelining (the ring collectives) does not run through this
class — a pipelined plan lowers to ONE XLA executable whose interleaved
segments the scheduler overlaps — but its depth policy and chunk
alignment rules are these.

Jax-free and stdlib-only: the offline CLI, the fleet aggregator and the
PS transport all import it.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple

from .. import constants
from ..telemetry import flightrecorder as _flight

#: the rank-local flight stream chunk sub-entries land on (excluded from
#: cross-rank diffs like the "handles" stream; see telemetry/analyze.py)
CHUNK_COMM = "chunks"

#: routing marker of a chunk sub-entry — the calibration extractor skips
#: entries so marked (they are sub-events of an already-sampled parent)
CHUNK_ROUTING = "chunk"


def split_spans(n: int, chunk_elems: int,
                align: int = 1) -> Iterator[Tuple[int, int]]:
    """Cut ``[0, n)`` into ``(offset, nelem)`` spans of at most
    ``chunk_elems`` elements each, with every BOUNDARY a multiple of
    ``align`` (the quantization block grid): chunk k of an aligned split
    quantizes on exactly the blocks the unchunked payload would, so
    chunked and monolithic encodings are bit-identical per block.
    ``chunk_elems <= 0`` disables splitting (one span)."""
    n = int(n)
    if n <= 0:
        return
    chunk = int(chunk_elems)
    if chunk <= 0:
        yield 0, n
        return
    if align > 1:
        # align DOWN so chunks never exceed the requested size (a chunk
        # smaller than one block degenerates to a single block) — and
        # do it BEFORE the single-span shortcut, so a payload just over
        # an unaligned chunk budget still splits on the block grid
        # instead of shipping one over-budget chunk
        chunk = max(int(align), (chunk // int(align)) * int(align))
    if chunk >= n:
        yield 0, n
        return
    for off in range(0, n, chunk):
        yield off, min(chunk, n - off)


def depth_candidates(nbytes: int, max_depth: Optional[int] = None,
                     min_chunk_bytes: Optional[int] = None) -> List[int]:
    """Pipeline depths worth pricing for a logical payload of ``nbytes``:
    powers of two from 2 up to ``plan_pipeline_max_depth`` whose chunks
    stay at or above ``plan_pipeline_min_chunk_bytes`` (alpha-dominated
    small chunks never win). Depth 1 — the unpipelined twin — is always
    implicitly a candidate and is not listed."""
    if max_depth is None:
        max_depth = int(constants.get("plan_pipeline_max_depth"))
    if min_chunk_bytes is None:
        min_chunk_bytes = int(constants.get("plan_pipeline_min_chunk_bytes"))
    out: List[int] = []
    d = 2
    while d <= max_depth and int(nbytes) // d >= max(1, min_chunk_bytes):
        out.append(d)
        d *= 2
    return out


class ChunkPipeline:
    """Drive a host-side chunk stream with per-chunk flight sub-entries.

    ``run(items, stage)`` walks the chunk iterator, calling ``stage(idx,
    item)`` per chunk — the stage callback owns the actual overlap
    (socket buffering drains chunk k while the caller encodes k+1; the
    reshard scratch read/write reuses one buffer) — and records one
    flight-recorder entry per chunk on the rank-local ``"chunks"``
    stream, stamped ``plan=<plan_id>#<chunk_idx>``. Entries are only
    recorded when the recorder is armed; the driver itself is
    allocation-light otherwise.
    """

    __slots__ = ("plan_id", "op", "nbytes_of")

    def __init__(self, plan_id: str, op: str,
                 nbytes_of: Optional[Callable[[Any], int]] = None):
        self.plan_id = plan_id
        self.op = op
        self.nbytes_of = nbytes_of

    def _record(self, idx: int, item) -> Optional[list]:
        if not _flight.enabled():
            return None
        nbytes = ""
        if self.nbytes_of is not None:
            try:
                nbytes = f"{int(self.nbytes_of(item))}B"
            except Exception:
                nbytes = ""
        return _flight.recorder.record(
            CHUNK_COMM, self.op, payload=nbytes or None,
            routing=CHUNK_ROUTING, plan=f"{self.plan_id}#{idx}",
        )

    def run(self, items: Iterable, stage: Callable[[int, Any], None]) -> int:
        """Run every chunk through ``stage``; returns the chunk count."""
        count = 0
        for idx, item in enumerate(items):
            entry = self._record(idx, item)
            try:
                stage(idx, item)
            except BaseException:
                if entry is not None:
                    _flight.FlightRecorder.fail(entry)
                raise
            if entry is not None:
                _flight.FlightRecorder.complete(entry)
            count += 1
        return count


__all__ = [
    "CHUNK_COMM",
    "CHUNK_ROUTING",
    "ChunkPipeline",
    "depth_candidates",
    "split_spans",
]
