"""Declared communication topology for the schedule compiler.

The legacy router asked the *communicator object* questions mid-dispatch
(``comm.cartesian``, ``has_inter_collective`` ...) and branched. The
compiler instead works against a :class:`Topology` — a frozen, declared
description of the fabric a plan will run on: how ranks group into
fast-link (ICI) islands, whether the islands are linked peer-to-peer
(cartesian) or root-to-root (tree/ragged), and whether the inter-island
hop has a direct device link at all or must stage through host memory
(``use_staged_collectives`` — the reference's no-GDR deployment,
``detail/collectives_cuda.cpp:390-683``).

Because a Topology is plain data (no jax, no devices), plans can be
generated and cost-modeled *offline* — the ``--explain`` CLI plans
against a purely declared fabric, and tests can ask for plans on
topologies no live communicator exists for (ragged multi-pod shapes the
old hardcoded rings could not express).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Tuple

#: link classes a plan step can ride; the cost model prices each
LINK_ICI = "ici"      # intra-group fast fabric (ICI / same-host)
LINK_DCN = "dcn"      # inter-group fabric (DCN / cross-host)
LINK_HOST = "host"    # host-staged hop (device->host->socket->device)
LINK_LOCAL = "local"  # on-device compute (pack/quantize/accumulate)


@dataclass(frozen=True)
class Topology:
    """Frozen fabric declaration one plan compiles against.

    ``group_sizes`` is the per-intra-group member count in group order —
    ``(4, 4)`` is two ICI islands of four, ``(1, 3, 4)`` a ragged
    three-island split. ``cartesian`` declares peer-linked islands
    (equal sizes required, like the reference's cartesian split);
    ``staged_inter`` declares that the inter-island hop has **no direct
    device link** and must stage through host memory.
    """

    platform: str
    group_sizes: Tuple[int, ...]
    cartesian: bool = False
    nodes: int = 1
    staged_inter: bool = False
    name: str = ""

    # ------------------------------------------------------------------
    @property
    def size(self) -> int:
        return sum(self.group_sizes)

    @property
    def num_groups(self) -> int:
        return len(self.group_sizes)

    @property
    def has_intra(self) -> bool:
        return any(s > 1 for s in self.group_sizes)

    @property
    def has_inter(self) -> bool:
        return len(self.group_sizes) > 1

    @property
    def two_level(self) -> bool:
        """Both levels populated — the precondition every hierarchical
        composition shares (the legacy ``has_inter and has_intra``)."""
        return self.has_inter and self.has_intra

    @property
    def ragged(self) -> bool:
        return len(set(self.group_sizes)) > 1

    def intra_size(self) -> int:
        """Representative intra size (the largest group: the binomial
        depth bound on ragged topologies)."""
        return max(self.group_sizes) if self.group_sizes else 0

    # ------------------------------------------------------------------
    def shape_token(self) -> str:
        """Compact human-readable group-shape token: '4x2' for two equal
        groups of 4, '1+3+4' for a ragged split, '8' for flat."""
        if not self.has_inter:
            return str(self.size)
        if not self.ragged:
            return f"{self.group_sizes[0]}x{self.num_groups}"
        return "+".join(str(s) for s in self.group_sizes)

    def fingerprint(self) -> str:
        """Stable cross-process identity of this declared fabric — one
        component of every plan-cache key. Human-readable prefix plus a
        short hash over the exact group vector (two ragged splits with
        the same shape_token but different order must not collide)."""
        mode = "cart" if self.cartesian else "tree"
        inter = "staged" if self.staged_inter else "direct"
        head = (
            f"{self.platform}:{self.shape_token()}:{mode}:"
            f"n{self.nodes}:{inter}"
        )
        h = hashlib.sha1(
            repr((self.platform, self.group_sizes, self.cartesian,
                  self.nodes, self.staged_inter)).encode()
        ).hexdigest()[:8]
        return f"{head}:{h}"

    # ------------------------------------------------------------------
    @classmethod
    def from_communicator(cls, comm) -> "Topology":
        """Declare the topology of a live :class:`Communicator`. The
        ``use_staged_collectives`` constant is read HERE — it is a
        statement about the fabric (no direct inter-island device link),
        so it belongs to the topology declaration, not to dispatch
        branching. It only takes effect when both levels exist and the
        hierarchical machinery is enabled, mirroring the legacy gate.
        The platform is the communicator's ``torch.device`` type ('cpu'
        or 'cuda'), which ``constants.platform_suffix`` maps to its
        column."""
        from .. import constants

        group_sizes = tuple(len(g) for g in comm._groups)
        two_level = len(group_sizes) > 1 and any(s > 1 for s in group_sizes)
        staged = bool(
            constants.get("use_staged_collectives")
            and constants.get("use_hierarchical_collectives")
            and two_level
            and comm.cartesian
        )
        return cls(
            platform=comm.device.type,
            group_sizes=group_sizes,
            cartesian=bool(comm.cartesian),
            nodes=comm.num_nodes(),
            staged_inter=staged,
            name=getattr(comm, "name", ""),
        )

    def describe(self) -> str:
        mode = "cartesian" if self.cartesian else "tree"
        inter = "host-staged" if self.staged_inter else "direct"
        return (
            f"{self.platform} topology {self.shape_token()} ({mode}, "
            f"{self.nodes} node(s), inter link {inter})"
        )
