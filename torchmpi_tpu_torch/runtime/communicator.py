"""Hierarchical named communicator stack over virtual ranks on one device.

The PyTorch port of ``torchmpi_tpu/runtime/communicator.py``. The JAX
package is single-controller: its p ranks are p devices of one process,
and eager collectives take rank-stacked ``[p, ...]`` arrays. Here the p
ranks are *virtual*: they all live on one ``torch.device`` and a rank is
an index into the leading axis of a rank-stacked tensor.

Construction follows the reference (``lib/resources.cpp:187-350``) exactly
as the JAX class does: stable-sort members by ``(key, rank)``, group equal
keys into intra groups, mark the split cartesian iff every group has the
same size (and cartesian mode is on), and form the inter communicator from
same-intra-rank peers (cartesian) or group roots (tree). Only the
``jax.sharding.Mesh`` objects are gone: the groups are plain rank lists.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from .. import constants

KeySpec = Union[Sequence[str], Callable[[int], str]]


class CommunicatorError(RuntimeError):
    pass


@dataclass(frozen=True)
class _Member:
    """Per-rank placement inside a communicator (one reference rank)."""

    global_rank: int  # rank in the communicator this was split from
    intra_group: int  # which key-group this rank landed in
    intra_rank: int  # rank within the key-group
    inter_rank: int  # rank in the inter communicator (-1 if not a member)


class Communicator:
    """One level of the hierarchical communicator stack: ``ranks`` (the
    ids of the virtual ranks, in rank order) on ``device``."""

    def __init__(
        self,
        ranks: Sequence[int],
        device: torch.device,
        keys: Optional[Sequence[str]] = None,
        name: str = "global",
        cartesian: Optional[bool] = None,
    ):
        ranks = [int(r) for r in ranks]
        if keys is None:
            keys = [""] * len(ranks)
        if len(keys) != len(ranks):
            raise CommunicatorError(f"got {len(keys)} keys for {len(ranks)} ranks")
        keys = [str(k) for k in keys]
        for k in keys:
            if len(k.encode()) >= 1024:
                # reference: keys are fixed 1KB buffers (resources.cpp:203-213)
                raise CommunicatorError("communicator key must be < 1024 bytes")
        self.name = name
        self.device = torch.device(device)
        self._ranks = ranks
        self._keys = keys

        # Stable sort by (key, original rank) — resources.cpp:236-244.
        order = sorted(range(len(ranks)), key=lambda r: (keys[r], r))
        groups: List[List[int]] = []
        group_keys: List[str] = []
        for r in order:
            if not groups or keys[r] != group_keys[-1]:
                groups.append([])
                group_keys.append(keys[r])
            groups[-1].append(r)
        self._groups = groups
        self._group_keys = group_keys

        if cartesian is None:
            cartesian = constants.get("use_cartesian_communicator")
        # cartesian iff requested AND all intra groups equal size
        # (resources.cpp:266-280).
        self.cartesian = bool(cartesian) and len({len(g) for g in groups}) == 1

        self._members: List[_Member] = [None] * len(ranks)  # type: ignore
        for gi, g in enumerate(groups):
            for ir, r in enumerate(g):
                if self.cartesian:
                    inter_rank = gi  # every rank joins an inter ring of peers
                else:
                    inter_rank = gi if ir == 0 else -1  # roots only (tree)
                self._members[r] = _Member(r, gi, ir, inter_rank)

    # ------------------------------------------------------------------
    # introspection (reference lib/torch_mpi.cpp:105-127,257-280)
    # ------------------------------------------------------------------
    @property
    def ranks(self) -> List[int]:
        return list(self._ranks)

    @property
    def size(self) -> int:
        return len(self._ranks)

    @property
    def groups(self) -> List[List[int]]:
        """Intra groups as lists of ranks, in group order."""
        return [list(g) for g in self._groups]

    @property
    def num_intra_groups(self) -> int:
        return len(self._groups)

    @property
    def has_intra_collective(self) -> bool:
        """True when an intra group has more than one member."""
        return any(len(g) > 1 for g in self._groups)

    @property
    def has_inter_collective(self) -> bool:
        """True when there is more than one intra group."""
        return len(self._groups) > 1

    def member(self, rank: int) -> _Member:
        return self._members[rank]

    def num_nodes(self) -> int:
        """Distinct hosts spanned (``torch_mpi.cpp:321-350``): every
        virtual rank lives in this process on one device, so one."""
        return 1

    def describe(self) -> str:
        """Topology string (analog of the startup dump, init.lua:456-459)."""
        lines = [
            f"Communicator '{self.name}': size={self.size} "
            f"groups={self.num_intra_groups} "
            f"{'cartesian' if self.cartesian else 'tree'} "
            f"device={self.device}"
        ]
        for gi, g in enumerate(self._groups):
            ids = ",".join(str(self._ranks[r]) for r in g)
            lines.append(f"  intra[{gi}] key={self._group_keys[gi]!r} ranks=[{ids}]")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return (
            f"Communicator({self.name!r}, size={self.size}, "
            f"groups={self.num_intra_groups}, cartesian={self.cartesian}, "
            f"device={self.device})"
        )


class CommunicatorStack:
    """The mutable stack of communicators + collective span
    (``mainThreadCommunicators`` and the ``(begin, end)`` cursor,
    ``lib/torch_mpi.cpp:38-41,84-103``)."""

    def __init__(self, root: Communicator):
        self._stack: List[Communicator] = [root]
        self._span = (0, 0)
        self._lock = threading.Lock()

    def push(self, comm: Communicator) -> int:
        with self._lock:
            self._stack.append(comm)
            level = len(self._stack) - 1
            self._span = (level, level)
            return level

    def set_current(self, level: int) -> None:
        with self._lock:
            if not 0 <= level < len(self._stack):
                raise CommunicatorError(f"no communicator at level {level}")
            self._span = (level, level)

    def set_span(self, begin: int, end: int) -> None:
        """The hierarchical collective span (``torch_mpi.cpp:84-103``):
        levels ``begin`` to ``end``, the current communicator at ``end``."""
        with self._lock:
            if not (0 <= begin <= end < len(self._stack)):
                raise CommunicatorError(
                    f"invalid span ({begin}, {end}) for stack depth {len(self._stack)}"
                )
            self._span = (begin, end)

    @property
    def span(self) -> Tuple[int, int]:
        return self._span

    @property
    def current(self) -> Communicator:
        return self._stack[self._span[1]]

    @property
    def depth(self) -> int:
        return len(self._stack)

    def at(self, level: int) -> Communicator:
        return self._stack[level]

    def names(self) -> List[str]:
        return [c.name for c in self._stack]


def split_by_keys(
    parent: Communicator,
    keys: KeySpec,
    name: Optional[str] = None,
    cartesian: Optional[bool] = None,
) -> Communicator:
    """Create a child communicator by key-splitting the parent's ranks.

    ``keys`` is one key string per parent rank or a callable
    ``rank -> key`` (``torchmpi_push_communicator``,
    ``torch_mpi.cpp:251-255``). As in the JAX package, a nested split
    subdivides the parent's intra groups: each key is compounded with the
    parent's group index, so ranks of different parent groups never share
    a child group."""
    if callable(keys):
        key_list = [str(keys(r)) for r in range(parent.size)]
    else:
        key_list = [str(k) for k in keys]
    if len(key_list) != parent.size:
        raise CommunicatorError(
            f"got {len(key_list)} keys for communicator of size {parent.size}"
        )
    if parent.num_intra_groups > 1:
        key_list = [
            f"{parent.member(r).intra_group:06d}|{k}" for r, k in enumerate(key_list)
        ]
    return Communicator(
        parent.ranks,
        parent.device,
        key_list,
        name=name or f"{parent.name}/split",
        cartesian=cartesian,
    )
