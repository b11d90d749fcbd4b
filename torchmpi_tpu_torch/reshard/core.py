"""Portable array redistribution: the minimal-transfer reshard planner.

A copy of ``torchmpi_tpu/reshard/core.py`` on the port's own
``constants`` and schedule IR (``schedule/ir.py``, ``schedule/cost.py``,
``schedule/pipeline.py``). A redistribution moves a flat array between
any two ``(world size, sharding)`` layouts with bounded memory:

1. :func:`plan_transfers` computes the **minimal** transfer schedule
   between a source and target :class:`Layout` of the same flat array:
   every target element is received exactly once, from the unique source
   rank that holds it, and elements whose owner does not change never
   touch a wire (they appear as ``src_rank == dst_rank`` local copies).
2. :func:`build_plan` expresses that schedule as a schedule-compiler
   :class:`~..schedule.ir.Plan` (aggregated send/recv steps on the
   ``host`` link class, chunk counts in ``meta``), so a redistribution
   is cost-modeled, cached and introspectable like every collective.
3. :class:`Redistributor` executes the schedule with **bounded peak
   memory**: transfers are cut into ``reshard_chunk_bytes`` chunks and
   copied through one reusable scratch buffer, and
   :attr:`Redistributor.peak_scratch_bytes` makes the bound assertable.

Everything here is numpy and the standard library: plans are buildable
offline (``python -m torchmpi_tpu_torch.reshard``), and the same schedule
drives the checkpoint reshaper and the transparent cross-world restore
(:mod:`..utils.checkpoint`). The elastic exchange (``reshard/elastic.py``
of the JAX package) is ROADMAP A10.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from .. import constants
from ..schedule import cost as _cost
from ..schedule import pipeline as _sched_pipeline
from ..schedule.ir import Plan, Step


@dataclass(frozen=True)
class Layout:
    """One ``(world size, sharding)`` placement of a flat n-element array.

    ``kind``:

    - ``'sharded'`` — contiguous uniform partition over ``world`` ranks
      (the engine's fsdp/zero1 leaf layout, the PS ``shard_range``
      layout). ``rotation``
      places the ``n % world`` remainder on the cyclic rank interval
      ``[rotation, rotation + extra)`` (PS byte-aware placement).
    - ``'replicated'`` — every rank holds the full array (engine
      replicated params). A replicated *source* serves each target
      interval from the co-located rank when possible (zero wire
      bytes); a replicated *target* receives the full array on every
      rank.
    """

    world: int
    kind: str = "sharded"
    rotation: int = 0

    def __post_init__(self):
        if self.world < 1:
            raise ValueError(f"layout world must be >= 1, got {self.world}")
        if self.kind not in ("sharded", "replicated"):
            raise ValueError(
                f"layout kind must be 'sharded'|'replicated', got "
                f"{self.kind!r}"
            )

    def interval(self, n: int, rank: int) -> Tuple[int, int]:
        """[start, end) of ``rank``'s elements in the flat array."""
        if self.kind == "replicated":
            return 0, n
        from ..parameterserver.server import shard_range

        return shard_range(n, self.world, rank, self.rotation)

    def intervals(self, n: int) -> List[Tuple[int, int]]:
        return [self.interval(n, r) for r in range(self.world)]

    def token(self) -> str:
        tail = f"@rot{self.rotation}" if self.rotation else ""
        return f"{self.kind[:4]}{self.world}{tail}"


@dataclass(frozen=True)
class Transfer:
    """One contiguous span moving from a source rank to a target rank.

    Offsets are into the *local* shard buffers of each side (the flat
    global span is ``[global_start, global_start + n)``); a transfer
    with ``src == dst`` is a local copy and never touches a wire."""

    src: int
    dst: int
    src_off: int
    dst_off: int
    n: int
    global_start: int


def plan_transfers(n: int, src: Layout, dst: Layout) -> List[Transfer]:
    """The minimal transfer schedule from ``src`` to ``dst`` layout.

    Minimality: each target element appears in exactly ONE transfer
    (received once), sourced from a rank that holds it — and when the
    holding source rank IS the target rank the element moves locally
    (zero wire bytes). A replicated source always serves a target rank
    from itself when the target rank also exists in the source world,
    else from ``dst_rank % src.world`` (spreads the load of a grow from
    a replicated checkpoint over all sources)."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    out: List[Transfer] = []
    if n == 0:
        return out
    if src.kind == "replicated":
        for d in range(dst.world):
            ds, de = dst.interval(n, d)
            if de <= ds:
                continue
            s = d if d < src.world else d % src.world
            out.append(Transfer(s, d, ds, 0, de - ds, ds))
        return out
    # Both interval lists are ordered contiguous partitions of [0, n)
    # (shard_range is monotone in rank), so a two-pointer sweep finds
    # every overlap in O(src.world + dst.world + transfers). The naive
    # all-pairs scan was O(src.world * dst.world) — ~100M interval
    # comparisons for one 10k -> 9.9k resize, which the fleet simulator
    # measured as ~90s of coordinator-side planning per epoch.
    src_ivs = src.intervals(n)
    s = 0
    for d in range(dst.world):
        ds, de = dst.interval(n, d)
        if de <= ds:
            continue
        while s < src.world and src_ivs[s][1] <= ds:
            s += 1
        i = s
        while i < src.world and src_ivs[i][0] < de:
            ss, se = src_ivs[i]
            lo, hi = max(ds, ss), min(de, se)
            if hi > lo:
                out.append(Transfer(i, d, lo - ss, lo - ds, hi - lo, lo))
            if se >= de:
                break
            i += 1
    return out


def wire_elements(transfers: List[Transfer]) -> int:
    """Elements that actually cross ranks (the minimality metric)."""
    return sum(t.n for t in transfers if t.src != t.dst)


def chunk_spans(n: int, chunk: int) -> Iterator[Tuple[int, int]]:
    """Cut ``[0, n)`` into ``(start, end)`` spans of at most ``chunk``
    elements. The one chunking rule everywhere reshard bytes move (the
    checkpoint reshaper bounds its peak memory with it). The span math is the
    schedule IR's shared chunk-pipeline rule
    (:func:`~..schedule.pipeline.split_spans`), so reshard, the PS wire
    codec and the pipelined plan families cut payloads identically."""
    for off, ln in _sched_pipeline.split_spans(n, max(1, int(chunk))):
        yield off, off + ln


def chunk_transfers(
    transfers: List[Transfer], chunk_elems: int
) -> Iterator[Transfer]:
    """Split every transfer into <= ``chunk_elems``-element pieces (the
    bounded-memory execution unit)."""
    for t in transfers:
        for lo, hi in chunk_spans(t.n, chunk_elems):
            yield Transfer(
                t.src, t.dst, t.src_off + lo, t.dst_off + lo, hi - lo,
                t.global_start + lo,
            )


def chunk_elems_for(itemsize: int, chunk_bytes: Optional[int] = None) -> int:
    """Elements per chunk from the ``reshard_chunk_bytes`` knob."""
    if chunk_bytes is None:
        chunk_bytes = int(constants.get("reshard_chunk_bytes"))
    if chunk_bytes <= 0:
        return 1 << 62  # chunking disabled: one piece per transfer
    return max(1, chunk_bytes // max(1, int(itemsize)))


# ---------------------------------------------------------------------------
# plan IR: a redistribution as a schedule-compiler plan DAG
# ---------------------------------------------------------------------------


def build_plan(
    n: int,
    itemsize: int,
    src: Layout,
    dst: Layout,
    chunk_bytes: Optional[int] = None,
    platform: str = "cpu",
) -> Plan:
    """Express the minimal schedule as a schedule-IR plan: aggregated
    per-rank send/recv steps on the ``host`` link class, local copies as
    ``local_reduce``-priced moves, chunk counts in ``meta``. The plan's
    ``plan_id`` is the stable identity the chunk flight entries and the
    reshard cache share; it equals the JAX package's for the same
    request."""
    transfers = plan_transfers(n, src, dst)
    celems = chunk_elems_for(itemsize, chunk_bytes)
    wire_by_src: Dict[int, int] = {}
    local_elems = 0
    nchunks = 0
    for t in transfers:
        if t.src == t.dst:
            local_elems += t.n
        else:
            wire_by_src[t.src] = wire_by_src.get(t.src, 0) + t.n
            nchunks += (t.n + celems - 1) // celems
    steps: List[Step] = []
    if wire_by_src:
        worst = max(wire_by_src.values())
        senders = len(wire_by_src)
        steps.append(Step(
            "send", "host", worst * itemsize, count=senders,
            note="per-rank worst-case wire bytes",
        ))
        steps.append(Step(
            "recv", "host", worst * itemsize, count=senders,
        ))
    if local_elems:
        steps.append(Step(
            "local_reduce", "local", local_elems * itemsize,
            note="owner-stable elements (never on a wire)",
        ))
    return Plan(
        op="reshard",
        generator="reshard",
        backend="host",
        wire="full",
        topology_fp=f"{platform}:reshard:{src.token()}->{dst.token()}",
        steps=tuple(steps),
        meta=(
            ("chunks", nchunks),
            ("chunk_elems", min(celems, n) if n else 0),
            ("n", n),
            ("wire_elems", sum(wire_by_src.values())),
        ),
    )


# compiled-reshard cache: (n, itemsize, src, dst, chunk, version()) ->
# (plan, transfers). version() in the key is the coherence contract: any
# constants change (a chunk size, a resize epoch) drops every cached
# schedule together with the collective dispatch memos.
_plan_cache: Dict[tuple, Tuple[Plan, List[Transfer]]] = {}
_PLAN_CACHE_CAP = 128


def compile_reshard(
    n: int,
    itemsize: int,
    src: Layout,
    dst: Layout,
    chunk_bytes: Optional[int] = None,
) -> Tuple[Plan, List[Transfer]]:
    """Cached plan + transfer list for one redistribution request."""
    key = (n, itemsize, src, dst, chunk_bytes, constants.version())
    ent = _plan_cache.get(key)
    if ent is None:
        ent = (
            build_plan(n, itemsize, src, dst, chunk_bytes),
            plan_transfers(n, src, dst),
        )
        while len(_plan_cache) >= _PLAN_CACHE_CAP:
            _plan_cache.pop(next(iter(_plan_cache)))
        _plan_cache[key] = ent
    return ent


def estimate_us(plan: Plan) -> float:
    """Cost-model estimate (the ordering signal ``--explain`` prints)."""
    return _cost.estimate_us(plan)


# ---------------------------------------------------------------------------
# bounded-memory executor
# ---------------------------------------------------------------------------


class Redistributor:
    """Execute a reshard schedule chunk-by-chunk with bounded scratch.

    ``read(rank, off, out_view)`` must fill ``out_view`` with elements
    ``[off, off + len)`` of source rank ``rank``'s shard;
    ``write(rank, off, values)`` stores into target rank ``rank``'s
    shard. The executor never allocates more than one chunk of scratch
    at a time; ``peak_scratch_bytes`` is the asserted memory bound.

    This one class serves every consumer: in-process (reads/writes are
    numpy copies) and offline (reads are mmap'd checkpoint shard
    files)."""

    def __init__(
        self,
        n: int,
        dtype,
        src: Layout,
        dst: Layout,
        chunk_bytes: Optional[int] = None,
    ):
        self.n = int(n)
        self.dtype = np.dtype(dtype)
        self.src = src
        self.dst = dst
        self.plan, self.transfers = compile_reshard(
            self.n, self.dtype.itemsize, src, dst, chunk_bytes
        )
        self.chunk_elems = chunk_elems_for(self.dtype.itemsize, chunk_bytes)
        self.peak_scratch_bytes = 0
        self._scratch: Optional[np.ndarray] = None

    def _scratch_for(self, nelem: int) -> np.ndarray:
        if self._scratch is None or self._scratch.shape[0] < nelem:
            self._scratch = np.empty(nelem, self.dtype)
            self.peak_scratch_bytes = max(
                self.peak_scratch_bytes, self._scratch.nbytes
            )
        return self._scratch[:nelem]

    def run(
        self,
        read: Callable[[int, int, np.ndarray], None],
        write: Callable[[int, int, np.ndarray], None],
        ranks: Optional[set] = None,
    ) -> None:
        """Run every (chunked) transfer; ``ranks`` restricts execution to
        transfers whose source AND target live in the given rank set (the
        in-process case passes None = all). Execution flows through the
        shared :class:`~..schedule.pipeline.ChunkPipeline` driver — the
        read/write stages reuse one scratch buffer (the bounded-memory
        contract) and every chunk's flight sub-entry is stamped
        ``(plan_id, chunk_idx)`` on the rank-local ``chunks`` stream."""
        pieces = (
            t for t in chunk_transfers(self.transfers, self.chunk_elems)
            if ranks is None or (t.src in ranks and t.dst in ranks)
        )
        itemsize = self.dtype.itemsize

        def stage(idx: int, t: Transfer) -> None:
            buf = self._scratch_for(t.n)
            read(t.src, t.src_off, buf)
            write(t.dst, t.dst_off, buf)

        _sched_pipeline.ChunkPipeline(
            self.plan.plan_id, self.plan.op,
            nbytes_of=lambda t: t.n * itemsize,
        ).run(pieces, stage)


def redistribute_arrays(
    shards: Dict[int, np.ndarray],
    n: int,
    src: Layout,
    dst: Layout,
    chunk_bytes: Optional[int] = None,
) -> Tuple[Dict[int, np.ndarray], Redistributor]:
    """In-process reference executor: source shards in, freshly-allocated
    target shards out (bitwise-equal to a fresh ``dst`` scatter of the
    assembled array — the equivalence the tests pin). Returns the
    executor too so callers can assert its memory bound."""
    dt = None
    for a in shards.values():
        dt = np.asarray(a).dtype
        break
    if dt is None:
        raise ValueError("no source shards given")
    rd = Redistributor(n, dt, src, dst, chunk_bytes)
    out = {
        r: np.empty(max(0, e - s), dt)
        for r, (s, e) in enumerate(dst.intervals(n))
    }

    def read(rank: int, off: int, view: np.ndarray) -> None:
        view[:] = np.asarray(shards[rank]).reshape(-1)[off:off + view.shape[0]]

    def write(rank: int, off: int, values: np.ndarray) -> None:
        out[rank][off:off + values.shape[0]] = values

    rd.run(read, write)
    return out, rd
