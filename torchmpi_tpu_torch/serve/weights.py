"""Atomic serving-weight snapshots keyed by a PS shard version vector.

The port of ``torchmpi_tpu/serve/weights.py``. The downpour group bumps a
per-shard version on every applied update (``_Instance.versions``); a
server's refresh fetch reads that vector and the assembled tensor and
swaps both in as ONE reference — request handlers read the current
``(weights, versions)`` pair without a lock (a single attribute load), so
weight refresh never pauses serving and no request ever observes weights
from one version and metadata from another.

A snapshot is a tensor the parameter server never writes again: the
port's PS applies its rules in place on its shards, and ``receive()``
assembles a fresh tensor from copies of them (``torch.cat`` on the
instance's stream), so a send after the fetch leaves the snapshot as it
was.
"""

from __future__ import annotations

import time
from typing import Tuple

import torch

from ..analysis import lockmon as _lockmon


def version_vector(ps, client: int = 0) -> Tuple[int, ...]:
    """The per-shard version vector a serving fetch pairs with its
    assembled tensor: local shards read the instance's applied-update
    counters directly.

    The JAX package also reads remote shards here, from the delta-fetch
    client cache or the shm lane of its socket transport (``-1`` for a
    shard never fetched). The port's parameter server has no transport
    yet (ROADMAP A7's rest): every shard is local and that branch stays inert,
    kept so the function reads like its reference when the transport
    lands."""
    inst = ps._inst
    transport = getattr(ps, "_transport", None)
    vec = []
    for r in range(inst.size):
        if transport is None or inst.has_storage(r):
            vec.append(int(inst.versions[r]))
        else:
            key = (inst.id, r, client)
            cached = transport._delta_cache.get(key)
            v = int(cached[1]) if cached is not None else -1
            shm_v = transport._read_versions.get(key)
            if shm_v is not None and int(shm_v) > v:
                v = int(shm_v)
            vec.append(v)
    return tuple(vec)


class WeightCache:
    """One snapshot slot: ``(weights, versions)`` swapped atomically.

    Readers call :meth:`get` (no lock: one tuple-reference load);
    the refresher calls :meth:`swap`, which installs the new pair only
    when the version vector actually changed — a fetch that raced no
    training updates is a no-op, keeping the swap counter an honest
    freshness signal. ``weights`` is a tensor (on any device) or an
    array, held as a contiguous tensor."""

    def __init__(self, weights, versions=(), clock=time.monotonic):
        self._clock = clock
        self._lock = _lockmon.make_lock("serve/weights.py:WeightCache")
        self._snap = (torch.as_tensor(weights).contiguous(), tuple(versions))
        self._swapped_at = clock()
        self.swaps = 0

    def get(self) -> Tuple[torch.Tensor, Tuple[int, ...]]:
        return self._snap

    @property
    def versions(self) -> Tuple[int, ...]:
        return self._snap[1]

    def age_s(self) -> float:
        """Seconds since the last applied swap (the staleness the
        brownout ladder is allowed to widen)."""
        with self._lock:
            return max(0.0, self._clock() - self._swapped_at)

    def swap(self, weights, versions) -> bool:
        """Install ``(weights, versions)`` iff the vector changed;
        returns whether a swap happened."""
        versions = tuple(versions)
        with self._lock:
            if versions == self._snap[1]:
                return False
            self._snap = (torch.as_tensor(weights).contiguous(), versions)
            self._swapped_at = self._clock()
            self.swaps += 1
            return True
