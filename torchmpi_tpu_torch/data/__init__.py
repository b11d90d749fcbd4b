"""Streaming input pipeline: sharded sources, producer ring, device prefetch.

The port of ``torchmpi_tpu/data/__init__.py``. The engine's resident path
(``train_resident``) stages the whole dataset on the card before the
first step; this package streams it instead:

- :class:`ArraySource` — an indexable ``(x, y)`` sample source:
  in-memory arrays or memory-mapped ``.npy`` files (reads materialize
  per batch, so the dataset never has to fit in RAM).
- :class:`InputPipeline` — per-host **sharded iteration** (each rank
  draws from its own contiguous shard, per-epoch per-rank shuffle),
  assembled by ``input_workers`` background producer threads feeding a
  bounded **reorder ring** of ``input_prefetch_batches`` host batches,
  with the host-to-device transfer **double-buffered**: the pipeline
  issues batch k+1's copy before handing out batch k, so ``next()``
  returns a batch already on its way to the device while the caller's
  step runs on the previous one.

The device leg is where the port differs from the JAX package. On a CUDA
``device`` a producer hands its batch over as tensors in **pinned host
memory** (``pin_memory()`` per batch, through PyTorch's caching host
allocator, which gives a block back for reuse only once the copy that
read it has completed, so no buffer is refilled while its copy is in
flight). The consumer issues a ``non_blocking`` copy of each batch on
a **CUDA copy stream** of the pipeline's own and records an event after
it; when it hands the batch out, the consuming stream waits on that
event and the batch's tensors are marked as used there
(``record_stream``), so the caching allocator does not reuse their
memory before the step that reads them. On a CPU ``device`` a batch is
handed out as the host tensors the producer made, and nothing touches
``torch.cuda``.

Producers do host work only (numpy gathers, the ``transform``, pinning):
every call that enqueues work on the device runs on the consumer thread.

Delivery is **in-order and lossless** regardless of worker count: the
ring admits batch b only inside the reorder window
``[next_emit, next_emit + depth)`` and the consumer pops strictly
sequentially. A producer that dies mid-epoch fails the ring and the
consumer raises :class:`InputProducerError` — never a silent
truncation of the epoch.

``tm_input_*`` telemetry makes "input-bound" a measured verdict:
``tm_input_queue_depth`` (staged batches ahead of the consumer — 0
means the producers can't keep up), producer/consumer stall counters,
and a delivered-batch counter the engine's ``mfu_incl_input``
accounting joins against.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from .. import constants, telemetry as _telemetry

_MET = None


def _metric_handles():
    global _MET
    if _MET is None:
        m = _telemetry.metrics
        _MET = (
            m.gauge(
                "tm_input_queue_depth",
                "host batches staged ahead of the consumer in the input "
                "ring (sampled at each delivery; persistently 0 means "
                "the producers cannot keep up — input-bound)",
            ),
            m.counter(
                "tm_input_producer_stall_seconds",
                "seconds producer workers spent blocked on ring space "
                "(the consumer is the bottleneck — compute-bound)",
            ),
            m.counter(
                "tm_input_consumer_stall_seconds",
                "seconds the consumer spent waiting for the next host "
                "batch (the producers are the bottleneck — input-bound; "
                "the engine subtracts this window from its MFU step "
                "accounting)",
            ),
            m.counter(
                "tm_input_batches_total",
                "batches delivered by the input pipeline, by path "
                "(host=assembled by a producer, device=made resident)",
            ),
        )
    return _MET


class InputProducerError(RuntimeError):
    """A background input producer died; the epoch cannot complete.

    Raised by the consumer on its next fetch — producer death is LOUD,
    never a silently truncated epoch — with the producer's exception as
    ``__cause__``."""


class ArraySource:
    """An indexable ``(x, y)`` sample source.

    Accepts anything numpy can fancy-index — in-memory arrays or
    ``np.load(..., mmap_mode='r')`` memmaps (:meth:`from_npy`), so an
    on-disk dataset streams per batch instead of staging resident."""

    def __init__(self, x, y):
        if len(x) != len(y):
            raise ValueError(
                f"x has {len(x)} samples but y has {len(y)}"
            )
        self.x, self.y = x, y

    def __len__(self) -> int:
        return len(self.x)

    @classmethod
    def from_npy(cls, x_path, y_path, mmap: bool = True) -> "ArraySource":
        """Open on-disk ``.npy`` arrays, memory-mapped by default."""
        mode = "r" if mmap else None
        return cls(
            np.load(x_path, mmap_mode=mode), np.load(y_path, mmap_mode=mode)
        )

    def gather(self, idx: np.ndarray):
        """Materialize the samples at ``idx`` as contiguous host arrays
        (memmap reads land here)."""
        return (
            np.ascontiguousarray(self.x[idx]),
            np.ascontiguousarray(self.y[idx]),
        )


class _Ring:
    """Bounded reorder window between producer workers and the consumer.

    Workers insert batch ``b`` only when it falls inside
    ``[next_emit, next_emit + depth)`` (blocking otherwise — the
    bounded-buffer backpressure); the consumer pops strictly in order.
    One lock, one condition: every state change notifies everyone."""

    def __init__(self, depth: int):
        self.depth = max(1, int(depth))
        self.cv = threading.Condition()
        self.slots: dict = {}
        self.next_emit = 0
        self.next_ticket = 0
        self.error: Optional[BaseException] = None
        self.closed = False

    def ticket(self, total: int) -> Optional[int]:
        """Claim the next batch ordinal to assemble; None when the epoch
        is fully claimed (or the ring shut down)."""
        with self.cv:
            if self.closed or self.error is not None \
                    or self.next_ticket >= total:
                return None
            t = self.next_ticket
            self.next_ticket += 1
            return t

    def put(self, idx: int, item) -> float:
        """Insert batch ``idx``; returns seconds spent blocked on window
        space (the producer-stall telemetry)."""
        stall = 0.0
        with self.cv:
            while (
                idx >= self.next_emit + self.depth
                and self.error is None
                and not self.closed
            ):
                t0 = time.perf_counter()
                self.cv.wait(0.1)
                stall += time.perf_counter() - t0
            if self.error is None and not self.closed:
                self.slots[idx] = item
                self.cv.notify_all()
        return stall

    def fail(self, exc: BaseException) -> None:
        with self.cv:
            if self.error is None:
                self.error = exc
            self.cv.notify_all()

    def close(self) -> None:
        with self.cv:
            self.closed = True
            self.slots.clear()
            self.cv.notify_all()

    def get(self, alive: Callable[[], bool]) -> Tuple[Any, float, int]:
        """Pop the next in-order batch; returns ``(item, stall_seconds,
        staged_ahead)``. Raises :class:`InputProducerError` when a
        producer died (or silently vanished) before delivering it."""
        stall = 0.0
        with self.cv:
            while self.next_emit not in self.slots:
                if self.error is not None:
                    raise InputProducerError(
                        "input producer died mid-epoch"
                    ) from self.error
                if self.closed:
                    raise InputProducerError("input ring closed mid-epoch")
                if not alive():
                    raise InputProducerError(
                        "every input producer exited without delivering "
                        f"batch {self.next_emit}"
                    )
                t0 = time.perf_counter()
                self.cv.wait(0.1)
                stall += time.perf_counter() - t0
            item = self.slots.pop(self.next_emit)
            self.next_emit += 1
            depth_now = len(self.slots)
            self.cv.notify_all()
        return item, stall, depth_now


def _host_tensor(a, pin: bool) -> torch.Tensor:
    """A producer's array as a contiguous CPU tensor, pinned if asked."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    t = t.contiguous()
    return t.pin_memory() if pin else t


class InputPipeline:
    """Per-host sharded streaming iterator with producer ring + device
    prefetch (see the module notes for the full contract).

    Yields rank-stacked batches ``(x[p, B/p, ...], y[p, B/p])`` on
    ``device`` (default: the current CUDA device; ``'cpu'`` keeps them on
    the host), ready for the engine's ``[p, B, ...]`` batch format.
    ``__call__`` starts one epoch (the ``engine.train(iterator_fn)``
    shape); each epoch advances the per-rank shuffle like
    :class:`~torchmpi_tpu_torch.utils.data.DistributedIterator`. Partial
    tail batches are dropped (every step sees the same shapes).

    ``prefetch``/``workers`` default to the ``input_prefetch_batches``
    / ``input_workers`` constants; ``transform`` optionally runs per
    batch inside the producer (augmentation, casting — host code only;
    it may return numpy arrays or CPU tensors)."""

    def __init__(
        self,
        source,
        batch_size: int,
        num_ranks: int,
        shuffle: bool = True,
        seed: int = 0,
        device=None,
        prefetch: Optional[int] = None,
        workers: Optional[int] = None,
        transform: Optional[Callable] = None,
    ):
        if isinstance(source, tuple):
            source = ArraySource(*source)
        if batch_size < num_ranks or batch_size % num_ranks != 0:
            raise ValueError(
                f"global batch {batch_size} must be a positive multiple "
                f"of the {num_ranks} ranks (>= one sample per rank)"
            )
        self.source = source
        self.batch_size = batch_size
        self.p = num_ranks
        self.per_rank = batch_size // num_ranks
        self.shuffle = shuffle
        self.seed = seed
        self.device = torch.device(device if device is not None else "cuda")
        self.transform = transform
        self.prefetch = max(1, int(
            prefetch if prefetch is not None
            else constants.get("input_prefetch_batches")
        ))
        self.workers = max(1, int(
            workers if workers is not None
            else constants.get("input_workers")
        ))
        n = len(source)
        self.shard_len = n // num_ranks
        self.batches_per_epoch = self.shard_len // self.per_rank
        if self.batches_per_epoch == 0:
            raise ValueError(
                f"dataset of {n} samples is too small for {num_ranks} "
                f"ranks x {self.per_rank} per-rank batch"
            )
        self._epoch = 0
        # the copy stream, made by the consumer on its first CUDA batch
        self._copy_stream = None
        #: seconds the consumer stalled waiting on producers, summed
        #: over the pipeline's lifetime — the engine's input-stall join
        self.consumer_stall_s = 0.0

    def __len__(self) -> int:
        return self.batches_per_epoch

    # -- deterministic sharded index plan (pure; tests drive it directly)
    def epoch_order(self, epoch: int) -> np.ndarray:
        """The ``[p, shard_len]`` global-index plan of one epoch: rank r
        draws from its contiguous shard ``[r*shard_len, (r+1)*shard_len)``,
        permuted per epoch by ``RandomState(seed + epoch)`` — a pure
        function of (seed, epoch, world size), identical however many
        workers assemble it."""
        if not self.shuffle:
            return np.arange(self.shard_len * self.p).reshape(
                self.p, self.shard_len
            )
        rs = np.random.RandomState(self.seed + epoch)
        return np.stack([
            r * self.shard_len + rs.permutation(self.shard_len)
            for r in range(self.p)
        ])

    def batch_indices(self, epoch: int, b: int) -> np.ndarray:
        """Global sample indices ``[p, per_rank]`` of batch ``b``."""
        order = self.epoch_order(epoch)
        return order[:, b * self.per_rank:(b + 1) * self.per_rank]

    # -- producer side (host work only; see module notes)
    def _assemble(self, order: np.ndarray, b: int):
        idx = order[:, b * self.per_rank:(b + 1) * self.per_rank]
        xb, yb = self.source.gather(idx)
        if self.transform is not None:
            xb, yb = self.transform(xb, yb)
        pin = self.device.type == "cuda"
        return _host_tensor(xb, pin), _host_tensor(yb, pin)

    def _producer(self, ring: _Ring, order: np.ndarray, total: int) -> None:
        try:
            telemetry_on = _telemetry.enabled()
            while True:
                b = ring.ticket(total)
                if b is None:
                    return
                stall = ring.put(b, self._assemble(order, b))
                if telemetry_on:
                    _, prod_stall, _, batches = _metric_handles()
                    if stall:
                        prod_stall.inc(stall)
                    batches.inc(path="host")
        except BaseException as e:  # noqa: BLE001 - any producer death
            # must surface on the consumer, not vanish with the thread
            ring.fail(e)

    # -- consumer side
    def _stage(self, host_batch):
        """Issue the host batch's copy to the device on the copy stream
        (async — the double buffer's in-flight leg); returns the device
        tensors and the event recorded after the copy (None on the CPU,
        where the host tensors are the batch)."""
        xb, yb = host_batch
        if self.device.type != "cuda":
            return (xb, yb), None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            xd = xb.to(self.device, non_blocking=True)
            yd = yb.to(self.device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        return (xd, yd), copied

    def _hand_out(self, staged):
        """The staged batch, ordered on the consumer's current stream
        after its copy."""
        (xd, yd), copied = staged
        if copied is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(copied)
            xd.record_stream(stream)
            yd.record_stream(stream)
        return xd, yd

    def _run_epoch(self, epoch: int):
        order = self.epoch_order(epoch)
        total = self.batches_per_epoch
        ring = _Ring(self.prefetch)
        threads = [
            threading.Thread(
                target=self._producer, args=(ring, order, total),
                name=f"tm-input-{epoch}-{w}", daemon=True,
            )
            for w in range(min(self.workers, total))
        ]
        for t in threads:
            t.start()

        def alive() -> bool:
            return any(t.is_alive() for t in threads)

        telemetry_on = _telemetry.enabled()
        inflight = None
        try:
            for _ in range(total):
                host, stall, depth_now = ring.get(alive)
                self.consumer_stall_s += stall
                if telemetry_on:
                    qdepth, _, cons_stall, batches = _metric_handles()
                    qdepth.set(depth_now)
                    if stall:
                        cons_stall.inc(stall)
                    batches.inc(path="device")
                staged = self._stage(host)
                # hand out the PREVIOUS batch (its copy issued one
                # iteration ago, overlapped with this batch's host
                # assembly and the caller's training step)
                if inflight is not None:
                    yield self._hand_out(inflight)
                inflight = staged
            if inflight is not None:
                yield self._hand_out(inflight)
        finally:
            ring.close()

    def __iter__(self):
        epoch = self._epoch
        self._epoch += 1
        return self._run_epoch(epoch)

    def __call__(self):
        """One epoch's iterator — the ``engine.train(iterator_fn)``
        calling convention."""
        return iter(self)


__all__ = [
    "ArraySource",
    "InputPipeline",
    "InputProducerError",
]
