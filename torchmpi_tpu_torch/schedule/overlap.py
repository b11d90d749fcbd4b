"""Gradient-overlap scheduling: bucket flush order as a plan property.

The port of ``torchmpi_tpu/schedule/overlap.py``. The bucketed gradient
path (:class:`~torchmpi_tpu_torch.nn.GradientBuckets`) cuts the leaves in
reverse-layer order: bucket 0 holds the LAST layers, whose gradients
exist first during the backward pass. This module decides *when* each
bucket's collective launches relative to the others:

- ``'reverse'`` — dispatch every bucket async in reverse-layer order as
  soon as it is packed, wait in reverse launch order
  (``nn.lua:207-212``): bucket k's collective overlaps bucket k+1's pack
  (and quantization), and the dispatch ordinal is stamped into the
  schedule IR as a plan *priority* (:func:`~.ir.prioritized`);
- ``'none'`` — the all-at-once baseline: every bucket is packed (and the
  packs finished) before the FIRST dispatch, then each bucket
  dispatches and waits serially. Same collectives, zero overlap.

Both run the identical per-bucket allreduce on identical packed
payloads, so their results are bitwise identical: the scheduler moves
time, not bits.

Each scheduled flush records one flight-recorder sub-entry per bucket on
the rank-local ``"chunks"`` stream, stamped ``plan=overlap-<schedule>:
<tag>#<b>``, spanning dispatch to wait, which the overlap ledger
(:func:`~torchmpi_tpu_torch.telemetry.criticalpath.overlap_ledger`) reads.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from .. import constants
from ..telemetry import flightrecorder as _flight
from .pipeline import CHUNK_COMM, CHUNK_ROUTING

#: recognized bucket flush orders (the ``overlap_schedule`` knob)
SCHEDULES = ("none", "reverse")


def resolve_schedule(explicit: Optional[str] = None) -> str:
    """The flush-order decision for one bucketed sync: the explicit
    argument wins, else the ``overlap_schedule`` constant."""
    sched = explicit if explicit is not None else constants.get("overlap_schedule")
    if sched in (None, "", "none"):
        return "none"
    if sched not in SCHEDULES:
        raise ValueError(
            f"unknown overlap_schedule {sched!r}; expected one of "
            f"{SCHEDULES}"
        )
    return sched


def schedule_base(schedule: str, tag: str) -> str:
    """The ledger grouping id of one scheduled flush: every bucket's
    sub-entry is ``<base>#<bucket>``."""
    return f"overlap-{schedule}:{tag}"


def register_priorities(bkts, comm, backend: Optional[str],
                        wire_dtype: Optional[str]) -> List[str]:
    """Stamp the reverse-layer flush order into the schedule IR: compile
    each bucket's plan (memoized, the decision the dispatch replays) and
    register a :func:`~.ir.prioritized` twin carrying the dispatch
    ordinal, so ``plan_by_id`` / ``--explain`` can show the order the
    scheduler chose. Returns the prioritized plan_ids (an empty string
    where compilation was not possible); registration is metadata, never
    a dispatch dependency."""
    from . import compiler as _compiler
    from . import ir as _ir

    if backend is None:
        # the memoized selector choice when it has run; before the first
        # dispatch the registered twin reflects the default route
        cache = getattr(comm, "_selector_cache", None) or {}
        backend = cache.get(("allreduce", "async")) or "xla"
    ids: List[str] = []
    for b in range(bkts.num_buckets):
        try:
            total = int(sum(bkts.sizes[i] for i in bkts.buckets[b]))
            ep = _compiler.compile_collective(
                "allreduce", (comm.size, total), bkts.bucket_dtype(b),
                comm, backend=backend, wire_dtype=wire_dtype,
            )
            twin = _ir.prioritized(ep.plan, b)
            _compiler._register_plans([twin])
            ids.append(twin.plan_id)
        except Exception:
            ids.append("")
    return ids


def _open_entry(base: str, b: int, buf: torch.Tensor) -> Optional[Any]:
    if not _flight.enabled():
        return None
    nbytes = buf.numel() * buf.element_size()
    return _flight.recorder.record(
        CHUNK_COMM, "allreduce", payload=f"{nbytes}B",
        routing=CHUNK_ROUTING, plan=f"{base}#{b}",
    )


def _packed(bkts, b: int, grads, comm, wire_dtype: Optional[str]) -> torch.Tensor:
    """Bucket ``b`` packed, error-feedback encoded where
    ``wire_error_feedback`` engages (the JAX ``_dispatch_bucket``)."""
    buf = bkts.pack(grads, b, comm.local_size)
    if constants.get("wire_error_feedback"):
        buf = bkts._error_feedback(b, buf, wire_dtype)
    return buf


def _dispatch(buf: torch.Tensor, comm, backend: Optional[str], wire_dtype: Optional[str]):
    from .. import collectives

    return collectives._dispatch("allreduce", buf, comm, "async", backend, wire_dtype=wire_dtype)


def run_bucketed_sync(
    bkts,
    grads,
    comm,
    backend: Optional[str] = None,
    wire_dtype: Optional[str] = None,
    average: bool = False,
    schedule: Optional[str] = None,
    tag: str = "grads",
):
    """One synchronous bucketed gradient sync under a flush schedule.

    ``bkts`` is a :class:`~torchmpi_tpu_torch.nn.GradientBuckets`;
    ``grads`` the rank-stacked gradient dict it was built for. Returns the
    synced dict (``average`` divides by the world size). ``tag`` names the
    flush in the flight entries (one ledger row per (schedule, tag))."""
    sched = resolve_schedule(schedule)
    p = comm.size
    base = schedule_base(sched, tag)
    nb = bkts.num_buckets
    results: List[Any] = [None] * nb

    if sched == "reverse":
        register_priorities(bkts, comm, backend, wire_dtype)
        entries: List[Any] = [None] * nb
        handles: List[Any] = [None] * nb
        for b in range(nb):
            buf = _packed(bkts, b, grads, comm, wire_dtype)
            entries[b] = _open_entry(base, b, buf)
            try:
                handles[b] = _dispatch(buf, comm, backend, wire_dtype)
            except BaseException:
                if entries[b] is not None:
                    _flight.FlightRecorder.fail(entries[b])
                raise
        # wait in reverse launch order: bucket nb-1 (the FIRST layers,
        # dispatched last) completes the flush; each sub-entry spans
        # dispatch -> wait
        for b in range(nb - 1, -1, -1):
            try:
                results[b] = handles[b].wait()
            except BaseException:
                if entries[b] is not None:
                    _flight.FlightRecorder.fail(entries[b])
                raise
            if entries[b] is not None:
                _flight.FlightRecorder.complete(entries[b])
    else:
        # all-at-once baseline: every bucket packed (and finished) before
        # the first dispatch, then dispatch and wait serially
        packed = [_packed(bkts, b, grads, comm, wire_dtype) for b in range(nb)]
        if comm.device.type == "cuda":
            torch.cuda.current_stream(comm.device).synchronize()
        for b, buf in enumerate(packed):
            entry = _open_entry(base, b, buf)
            try:
                results[b] = _dispatch(buf, comm, backend, wire_dtype).wait()
            except BaseException:
                if entry is not None:
                    _flight.FlightRecorder.fail(entry)
                raise
            if entry is not None:
                _flight.FlightRecorder.complete(entry)

    bkts._launch_comm = comm
    return bkts.unflatten_results(grads, results, average=average, p=p)


__all__ = [
    "SCHEDULES",
    "register_priorities",
    "resolve_schedule",
    "run_bucketed_sync",
    "schedule_base",
]
