"""Parameter-server update schedules: Update base, Downpour, EASGD.

The port of ``torchmpi_tpu/parameterserver/update.py`` (the reference's
``torchmpi/parameterserver/{update,downpourupdate,easgdupdate}.lua``, L7),
on dicts of rank-stacked tensors. The base class owns the step-counted
schedule (``update.py:64-67``):

- ``__shard`` at ``init_delay``: create the PS group on the *sharding*
  communicator level (``update.lua:49-55``);
- ``__fetch`` at ``init_delay + update_frequency + prefetch``, then every
  ``update_frequency``: issue async prefetches (``update.lua:58-65``);
- ``__integrate`` / ``__send``: subclass-defined;
- mixed PS x data-parallel: when a dataparallel communicator level is
  given, only each DP group's root integrates, and the integrated
  parameters are broadcast within the DP groups afterwards
  (``update.lua:82-113``).

``update(step, params, grads) -> params``; each rank's replica evolves on
its own between integrations, as the reference's async modes do.
Downpour's gradient accumulation runs through the accumulate kernel and
EASGD's fold through the scaled-accumulate kernel.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from .. import constants
from ..ops import accumulate, scale_accumulate
from ..runtime.communicator import Communicator
from ..runtime.handles import SyncHandle
from .tensors import Params, PSGroup


def _wait_all(handles: List[SyncHandle]) -> List:
    return [h.wait() for h in handles]


class Update:
    def __init__(
        self,
        comm: Optional[Communicator] = None,
        sharding_level: Optional[int] = None,
        dataparallel_level: Optional[int] = None,
        update_frequency: int = 10,
        init_delay: int = 100,
        prefetch: int = 0,
    ):
        if not 0 <= prefetch <= update_frequency:
            raise ValueError(f"prefetch must be in [0, {update_frequency}]")
        from .. import runtime_state

        self._state = runtime_state
        self.comm = comm
        self.sharding_level = sharding_level
        self.dataparallel_level = dataparallel_level
        self.update_frequency = update_frequency
        self.init_delay = init_delay
        self.prefetch = prefetch

        # schedule counters (update.lua:38-42)
        self.init_parameterserver = init_delay
        self.next_prefetch = init_delay + update_frequency + prefetch
        self.next_integration = init_delay + update_frequency

        self.ps: Optional[PSGroup] = None
        self.handles_send: List[SyncHandle] = []
        self.handles_prefetch: List[SyncHandle] = []

    # ------------------------------------------------------------------
    def _sharding_comm(self) -> Communicator:
        if self.sharding_level is not None:
            return self._state.stack().at(self.sharding_level)
        return self.comm or self._state.current_communicator()

    def _dataparallel_comm(self) -> Optional[Communicator]:
        if self.dataparallel_level is None:
            return None
        return self._state.stack().at(self.dataparallel_level)

    def _integrating_ranks(self) -> Optional[List[int]]:
        """All ranks fetch and integrate, unless a dataparallel
        communicator is given: then each DP group's root (update.lua:86-95)."""
        dp = self._dataparallel_comm()
        if dp is None:
            return None
        return [r for r in range(dp.size) if dp.member(r).intra_rank == 0]

    # ------------------------------------------------------------------
    def _shard(self, step: int, params: Params) -> None:
        if step == self.init_parameterserver:
            self.ps = PSGroup(params, comm=self._sharding_comm())

    def _fetch(self, step: int) -> None:
        if step == self.next_prefetch and self.ps is not None:
            _wait_all(self.handles_send)
            self.handles_send = []
            if not self.handles_prefetch:
                # nothing in flight; otherwise the eager post-integration
                # prefetch already issued this fetch
                self.handles_prefetch = self.ps.prefetch_tensors(
                    client_ranks=self._integrating_ranks()
                )
            self.next_prefetch += self.update_frequency

    def _integrate(self, step: int, params: Params):
        raise NotImplementedError

    def _send(self, step: int, params: Params, grads: Params) -> None:
        raise NotImplementedError

    def update(self, step: int, params: Params, grads: Params) -> Params:
        """One schedule tick (``Update.update``, update.lua:77-115):
        shard -> fetch -> integrate -> send, unconditionally like the
        reference (accumulation happens even before sharding)."""
        self._shard(step, params)
        self._fetch(step)
        params, integrated = self._integrate(step, params)
        if (
            integrated
            and self.prefetch == 0
            and self.ps is not None
            and not self.handles_prefetch
            and constants.get("ps_prefetch")
        ):
            # eager client-side prefetch: with a zero prefetch distance the
            # next fetch is issued now and rides the coming update_frequency
            # steps; it races this tick's sends, so the fetched center may or
            # may not include them (ps_prefetch=False: exact
            # fetch-at-integration semantics)
            self.handles_prefetch = self.ps.prefetch_tensors(
                client_ranks=self._integrating_ranks()
            )
        self._send(step, params, grads)

        # mixed PS x DP: broadcast integrated params within DP groups
        # (update.lua:104-112)
        dp = self._dataparallel_comm()
        if dp is not None and integrated:
            from ..collectives.eager import run_group_broadcast

            params = {k: run_group_broadcast(w, dp, root=0) for k, w in params.items()}
        return params

    def free(self) -> None:
        """Wait the sends still in flight (EASGD does not wait its own),
        then free the servers: every update sent is applied."""
        _wait_all(self.handles_send)
        self.handles_send = []
        if self.ps is not None:
            self.ps.free()
            self.ps = None


class DownpourUpdate(Update):
    """Downpour SGD (``downpourupdate.lua``): accumulate gradients locally,
    every ``send_frequency`` steps send the accumulated (locally scaled,
    e.g. multiplied by -lr) gradients with the ``add`` rule; integration
    copies the fetched center into the local replica."""

    def __init__(self, local_update: Callable = None, send_frequency: int = 1, **kw):
        super().__init__(**kw)
        self.send_frequency = send_frequency
        self.next_send = self.init_delay + send_frequency
        self.local_update = local_update or (lambda t: t)
        self._accum: Optional[Params] = None

    def _send(self, step: int, params: Params, grads: Params) -> None:
        # accumulate every step (downpourupdate.lua:47-52)
        if self._accum is None:
            self._accum = dict(grads)
        else:
            self._accum = {k: accumulate(a, grads[k]) for k, a in self._accum.items()}
        if step == self.next_send and self.ps is not None:
            self.handles_send = self.ps.send_tensors(
                self._accum, rule="add", local_update=self.local_update
            )
            _wait_all(self.handles_send)
            self.handles_send = []
            self._accum = {k: torch.zeros_like(a) for k, a in self._accum.items()}
            self.next_send += self.send_frequency

    def _integrate(self, step: int, params: Params):
        if step == self.next_integration and self.ps is not None:
            _wait_all(self.handles_prefetch)
            self.handles_prefetch = []
            # the fetched center replaces the replica
            params, _, _ = self.ps.integrate_tensors_stacked(
                params, lambda fetched, blocks: (fetched, None),
                client_ranks=self._integrating_ranks(),
            )
            self.next_integration += self.update_frequency
            return params, True
        return params, False


class EASGDUpdate(Update):
    """Elastic-averaging SGD (``easgdupdate.lua``): at each integration,
    with alpha = beta / size, the replica moves toward the fetched center
    (``x += alpha (center - x)``, one scaled-accumulate kernel per
    parameter) and the elastic difference ``-alpha (center - x_old)`` is
    sent back with ``add`` at the next send step (the center moves toward
    the replica)."""

    def __init__(self, beta: float = 0.9, **kw):
        super().__init__(**kw)
        self.beta = beta
        self.next_send = self.next_integration
        self._elastic: Optional[Params] = None

    def _send(self, step: int, params: Params, grads: Params) -> None:
        if step == self.next_send and self.ps is not None and self._elastic is not None:
            self.handles_send = self.ps.send_tensors(self._elastic, rule="add")
            self.next_send += self.update_frequency

    def _integrate(self, step: int, params: Params):
        if step == self.next_integration and self.ps is not None:
            _wait_all(self.handles_prefetch)
            self.handles_prefetch = []
            alpha = self.beta / self._sharding_comm().size

            # easgdupdate.lua:68-77 per client: old = fetched - x;
            # x += alpha*old; the elastic sent later is -alpha*old
            def fold(fetched, blocks):
                old = fetched - blocks
                return scale_accumulate(blocks, old, alpha), old * -alpha

            params, ranks, olds = self.ps.integrate_tensors_stacked(
                params, fold, client_ranks=self._integrating_ranks()
            )
            elastic = {}
            for name, e in zip(self.ps.names, olds):
                full = torch.zeros_like(params[name])
                full[torch.tensor(ranks, device=full.device)] = e
                elastic[name] = full
            self._elastic = elastic
            self.next_integration += self.update_frequency
            return params, True
        return params, False
