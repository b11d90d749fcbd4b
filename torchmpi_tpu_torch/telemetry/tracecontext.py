"""Compact causal trace context: the cross-rank half of observability.

Spans and the flight recorder are rank-local. This module
defines the context that links them ACROSS ranks: a ``(trace_id,
span_id, parent_id)`` triple carried in-band on every wire protocol we
own — PS frame headers, the ``fwd:`` chain-forward hop, serve
REQUEST/REPLY, elastic barrier frames — and stamped onto flight-recorder
entries so the analyzer (:mod:`telemetry.criticalpath`) can assemble a
causal DAG and emit Perfetto flow events between pid=rank tracks.

Design constraints, in priority order:

- **Deterministic.** IDs are FNV-1a 64-bit hashes of structural parts
  (job step, comm, seq, rank …), never random. The simfleet dumps must
  stay byte-identical per seed, and two ranks deriving the id of the
  same logical collective MUST agree without talking to each other.
- **Cheap.** The ambient context is one ``contextvars.ContextVar``
  read; a wire stamp is two u64s packed into the existing header
  struct. Disabled telemetry costs the same one-branch check the
  recorder already pays.
- **Stdlib-only**, like the rest of :mod:`telemetry`.

Propagation contract (documented in PARITY.md, linted by TPL205):

- The **sender** stamps ``(trace, span)`` where ``span`` is the id of
  the RPC-send span it is recording locally.
- The **receiver** treats the received ``span`` as the *parent* of every
  local span it records for that frame, deriving fresh child span ids.
- **Replays carry origin context**: BUSY re-sends and reconnect replays
  reuse the retained encoded frame, so the original ids survive by
  construction. Chain-forwarded ``fwd:`` updates and replica-pump hops
  re-stamp ``span`` with the forwarding hop's span but keep
  ``trace_id``, so the chain is one trace with one hop per link.
- **Replies echo** the request's ``(trace, span)`` unchanged — a reply
  is the closing edge of the request span, not a new node.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional, Tuple

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def fnv1a64(*parts) -> int:
    """Deterministic 64-bit id from structural parts. A 0x1F separator
    byte follows every part so ``("ab", "c")`` and ``("a", "bc")`` hash
    differently; the result is never 0 (0 is the wire's 'no context'
    sentinel)."""
    h = _FNV_OFFSET
    for p in parts:
        for b in str(p).encode():
            h = ((h ^ b) * _FNV_PRIME) & _MASK64
        h = ((h ^ 0x1F) * _FNV_PRIME) & _MASK64
    return h or 1


class TraceContext:
    """One causal position: the trace we are in, the span we are in, and
    (locally only — never on the wire) that span's parent."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: int, span_id: int, parent_id: int = 0):
        self.trace_id = int(trace_id) & _MASK64
        self.span_id = int(span_id) & _MASK64
        self.parent_id = int(parent_id) & _MASK64

    def child(self, *parts) -> "TraceContext":
        """Derive a child context: same trace, fresh deterministic span
        whose parent is this context's span."""
        return TraceContext(
            self.trace_id,
            fnv1a64(self.trace_id, self.span_id, *parts),
            self.span_id,
        )

    def to_wire(self) -> Tuple[int, int]:
        """The (trace, span) pair stamped into a frame header."""
        return self.trace_id, self.span_id

    @classmethod
    def from_wire(cls, trace: int, span: int) -> Optional["TraceContext"]:
        """Receiver-side: the sender's span becomes our parent. Returns
        None for unstamped frames (trace == 0) — old peers, disabled
        telemetry — so callers fall back to 'no context' in one check."""
        if not trace:
            return None
        return cls(trace, span)

    def __repr__(self) -> str:  # debugging / test failure readability
        return (
            f"TraceContext(trace={self.trace_id:#x}, "
            f"span={self.span_id:#x}, parent={self.parent_id:#x})"
        )

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, TraceContext)
            and self.trace_id == other.trace_id
            and self.span_id == other.span_id
            and self.parent_id == other.parent_id
        )

    def __hash__(self) -> int:
        return hash((self.trace_id, self.span_id, self.parent_id))


_current: "contextvars.ContextVar[Optional[TraceContext]]" = (
    contextvars.ContextVar("torchmpi_tpu_trace_context", default=None)
)


def current() -> Optional[TraceContext]:
    """The ambient context, or None outside any trace."""
    return _current.get()


def set_current(ctx: Optional[TraceContext]) -> "contextvars.Token":
    """Install ``ctx`` as the ambient context; returns the reset token."""
    return _current.set(ctx)


@contextlib.contextmanager
def use(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """Scoped ambient context (restores the previous one on exit)."""
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def new_trace(*parts) -> TraceContext:
    """Root context for a new logical operation (an engine step, a serve
    request, a sim step). The root span doubles as the trace id's anchor
    so every rank deriving from the same parts lands on the same trace."""
    trace = fnv1a64("trace", *parts)
    return TraceContext(trace, fnv1a64(trace, "root"), 0)


def stamp(*parts) -> Tuple[int, int, int]:
    """Hot-path helper: ``(trace, span, parent)`` for a locally recorded
    event — a fresh child of the ambient context when one is installed,
    all zeros otherwise. One ContextVar read when tracing is off."""
    ctx = _current.get()
    if ctx is None:
        return 0, 0, 0
    return (
        ctx.trace_id,
        fnv1a64(ctx.trace_id, ctx.span_id, *parts),
        ctx.span_id,
    )
