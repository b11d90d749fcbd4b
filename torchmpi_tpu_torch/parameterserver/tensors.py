"""Parameter-server helpers over dicts of rank-stacked tensors.

The port of ``torchmpi_tpu/parameterserver/tensors.py`` (the reference's
``torchmpi/parameterserver/init.lua``, L6): one server per parameter
(``cache.parameterServers``), list-wise send / prefetch / integrate
(``parameterserver/init.lua:128-219``), and the DSGD gradient exchange of
``examples/mnist/mnist_parameterserver_dsgd.lua:63-89``.

Parameters are dicts of rank-stacked ``[p, ...]`` tensors on the
communicator's device (rank r's replica at index r), the port's
counterpart of the JAX package's rank-stacked pytrees. Every rank acts as
a PS client: sends contribute each rank's block, fetches return one
(possibly different, staleness included) center snapshot per rank.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..runtime.communicator import Communicator
from ..runtime.handles import SyncHandle
from .server import ParameterServer

Params = Dict[str, torch.Tensor]


def _comm(comm: Optional[Communicator]) -> Communicator:
    if comm is not None:
        return comm
    from .. import runtime_state

    return runtime_state.current_communicator()


class PSGroup:
    """One ParameterServer per parameter (the ``cache.parameterServers``
    registry, ``torchmpi/cache.lua:19-35``), initialised from rank 0's
    replica (``parameterserver/init.lua:128-151``)."""

    def __init__(self, params: Params, comm: Optional[Communicator] = None):
        self.comm = _comm(comm)
        self.p = self.comm.size
        self.names = list(params)
        self.servers: List[ParameterServer] = []
        for name in self.names:
            leaf = params[name]
            if leaf.ndim < 1 or leaf.shape[0] != self.p:
                raise ValueError(
                    f"PSGroup expects rank-stacked leaves [p={self.p}, ...]; "
                    f"got {tuple(leaf.shape)} for {name!r}"
                )
            self.servers.append(ParameterServer(leaf[0], comm=self.comm))
        self._prefetched: Optional[List[List[SyncHandle]]] = None
        self._prefetch_ranks: List[int] = []

    def _ranks(self, client_ranks: Optional[Sequence[int]]) -> List[int]:
        return list(range(self.p)) if client_ranks is None else list(client_ranks)

    # ------------------------------------------------------------------
    def send_tensors(
        self,
        values: Params,
        rule: str = "add",
        local_update: Optional[Callable] = None,
        scale: Optional[float] = None,
        client_ranks: Optional[Sequence[int]] = None,
    ) -> List[SyncHandle]:
        """Every client rank sends its block of each parameter
        (``sendTensors``, ``parameterserver/init.lua:187-219``).
        ``local_update`` preprocesses each block before sending
        (Downpour's ``t:mul(-lr)``)."""
        ranks = self._ranks(client_ranks)
        handles = []
        batch_add = rule == "add" and len(ranks) > 1
        for srv, name in zip(self.servers, self.names):
            arr = values[name]
            blocks = [arr[r] if local_update is None else local_update(arr[r]) for r in ranks]
            if batch_add:
                # 'add' is linear: pre-sum the client blocks, in rank order,
                # and make one server trip per parameter (the JAX package's
                # vectorized fan-out); local_update keeps its per-block
                # contract, as it need not be linear
                total = blocks[0]
                for block in blocks[1:]:
                    total = total + block
                handles.append(srv.send(total, rule="add", client=ranks[0], scale=scale))
                continue
            for r, block in zip(ranks, blocks):
                handles.append(srv.send(block, rule=rule, client=r, scale=scale))
        return handles

    def prefetch_tensors(self, client_ranks: Optional[Sequence[int]] = None) -> List[SyncHandle]:
        """Issue async fetches of every parameter for every client rank
        (``prefetchTensors``, ``parameterserver/init.lua:159-170``)."""
        ranks = self._ranks(client_ranks)
        self._prefetch_ranks = ranks
        self._prefetched = [[srv.receive(client=r) for r in ranks] for srv in self.servers]
        return [h for per_srv in self._prefetched for h in per_srv]

    def wait_prefetched_stacked(self, client_ranks=None):
        """Wait the outstanding prefetches (issuing them now when none are
        pending) and return ``(ranks, stacks)``: ``stacks[i]`` is the
        ``[k, *shape]`` stack of the k client fetches of parameter i."""
        if self._prefetched is None:
            self.prefetch_tensors(client_ranks=client_ranks)
        ranks = list(self._prefetch_ranks)
        stacks = [torch.stack([h.wait() for h in per_srv]) for per_srv in self._prefetched]
        self._prefetched = None
        return ranks, stacks

    def integrate_tensors_stacked(self, params: Params, fold: Callable, client_ranks=None):
        """Vectorized integration: ``fold(fetched, blocks)`` gets the whole
        ``[k, *shape]`` stack of fetches and the matching client blocks of
        one parameter and returns ``(new_blocks, extra)``. Returns
        ``(params, ranks, extras)``, ``extras[i]`` parameter i's extra.
        Ranks that did not prefetch keep their block."""
        ranks, stacks = self.wait_prefetched_stacked(client_ranks=client_ranks)
        out, extras = dict(params), []
        for name, fetched in zip(self.names, stacks):
            leaf = params[name]
            idx = torch.tensor(ranks, device=leaf.device)
            new_blocks, extra = fold(fetched, leaf[idx])
            arr = leaf.clone()
            arr[idx] = new_blocks
            out[name] = arr
            extras.append(extra)
        return out, ranks, extras

    def receive_full(self, client: int = 0) -> Params:
        """The center value of every parameter, all fetches issued before
        any is waited."""
        handles = [srv.receive(client=client) for srv in self.servers]
        return {name: h.wait() for name, h in zip(self.names, handles)}

    def prefetch_full(self, client: int = 0) -> List[SyncHandle]:
        """Instance-level prefetch of every parameter (double-buffered per
        server): the next :meth:`receive_full` consumes these."""
        return [srv.prefetch(client=client) for srv in self.servers]

    def free(self) -> None:
        for srv in self.servers:
            srv.free()


def synchronize_gradients_with_parameterserver(
    grads: Params,
    ps_group: Optional[PSGroup] = None,
    comm: Optional[Communicator] = None,
    average: bool = True,
):
    """Synchronous DSGD gradient exchange through the parameter server
    (``mnist_parameterserver_dsgd.lua:63-89``): rank 0 zeroes the center,
    every rank adds its gradients, every rank receives, divide by size.
    Returns ``(synced_grads, ps_group)``; each synced gradient is the
    center expanded over the rank axis. Pass the group back in to reuse
    the servers."""
    comm = _comm(comm)
    p = comm.size
    if ps_group is None:
        ps_group = PSGroup(grads, comm=comm)
    for h in ps_group.send_tensors(grads, rule="zero", client_ranks=[0]):
        h.wait()
    for h in ps_group.send_tensors(grads, rule="add"):
        h.wait()
    out = {}
    for srv, name in zip(ps_group.servers, ps_group.names):
        center = srv.receive().wait()
        if average:
            # a tensor divisor: the card would divide by a host scalar as a
            # product with its reciprocal, numpy divides
            center = center / torch.full_like(center, p)
        out[name] = center.expand(grads[name].shape)
    return out, ps_group
