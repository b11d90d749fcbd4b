"""NN integration: parameter and gradient synchronization.

The port of the eager half of ``torchmpi_tpu/nn/__init__.py``
(``torchmpi/nn.lua``). A parameter or gradient "tree" is a dict of
rank-stacked tensors (name -> ``[p, ...]``, rank r's values at index r),
the port's counterpart of a rank-stacked pytree.

- :func:`synchronize_parameters` — one-shot sync before training:
  broadcast from ``root``, or allreduce and divide (``nn.lua:32-46``).
- :func:`synchronize_gradients` — sum-allreduce every gradient
  (``nn.lua:49-56``); ``average=True`` divides by the world size.
- :func:`check_with_allreduce` — the replica-consistency invariant
  (``init.lua:372-395``).

``GradientBuckets`` and the in-graph variants wait for later slices
(ROADMAP queue A3).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .. import collectives
from ..runtime.communicator import Communicator

Tree = Dict[str, torch.Tensor]


def _comm(comm: Optional[Communicator]) -> Communicator:
    if comm is not None:
        return comm
    from .. import runtime_state

    return runtime_state.current_communicator()


def _fused_apply(tree: Tree, p: int, sync_one: Callable) -> Tree:
    """Apply ``sync_one`` to one fused ``[p, total]`` buffer per dtype
    (``nn/__init__.py:58``): O(#dtypes) collectives, integer leaves exact."""
    by_dtype: Dict[torch.dtype, list] = {}
    for name, leaf in tree.items():
        by_dtype.setdefault(leaf.dtype, []).append(name)
    out = dict(tree)
    for names in by_dtype.values():
        buf = sync_one(torch.cat([tree[k].reshape(p, -1) for k in names], dim=1))
        off = 0
        for k in names:
            n = tree[k][0].numel()
            out[k] = buf[:, off : off + n].reshape(tree[k].shape)
            off += n
    return out


def synchronize_parameters(
    params: Tree,
    comm: Optional[Communicator] = None,
    with_allreduce: bool = False,
    root: int = 0,
    fused: bool = True,
) -> Tree:
    """Make every rank's parameters identical: broadcast from ``root`` or
    allreduce and divide by size (``nn.lua:32-46``)."""
    comm = _comm(comm)
    p = comm.size

    def sync_one(buf):
        if with_allreduce:
            return collectives.allreduce_tensor(buf, comm=comm) / p
        return collectives.broadcast_tensor(buf, root=root, comm=comm)

    if fused:
        return _fused_apply(params, p, sync_one)
    return {k: sync_one(v) for k, v in params.items()}


def synchronize_gradients(
    grads: Tree,
    comm: Optional[Communicator] = None,
    average: bool = False,
    fused: bool = True,
) -> Tree:
    """Sum-allreduce every gradient (``nn.lua:49-56``); ``average=True``
    divides by the world size. ``fused=True`` goes through the
    communicator's :class:`~torchmpi_tpu_torch.collectives.FusionBuffer`
    (when ``fusion_buffer_bytes`` > 0): one allreduce per dtype group of a
    flat ``[p, total]`` buffer."""
    comm = _comm(comm)
    p = comm.size

    def finish(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return (buf / p).to(like.dtype) if average else buf

    if fused:
        from .. import constants

        if constants.get("fusion_buffer_bytes") > 0:
            fb = collectives.get_fusion_buffer(comm)
            handles = {k: fb.submit("allreduce", g) for k, g in grads.items()}
            fb.flush_for(handles.values())
            return {k: finish(h.wait(), grads[k]) for k, h in handles.items()}
        return _fused_apply(
            grads, p, lambda buf: finish(collectives.allreduce_tensor(buf, comm=comm), buf)
        )
    return {
        k: finish(collectives.allreduce_tensor(g, comm=comm), g)
        for k, g in grads.items()
    }


def check_with_allreduce(
    params: Tree, comm: Optional[Communicator] = None, tol: float = 1e-7
) -> None:
    """Assert replicas are consistent: for each rank, the allreduced
    |mean| and |var| of its flattened parameters must equal size times its
    own (``init.lua:387-394``). Cheap, and catches desync bugs early."""
    comm = _comm(comm)
    p = comm.size
    buf = torch.cat(
        [v.reshape(p, -1).to(torch.float32) for v in params.values()], dim=1
    )
    stats = torch.stack(
        [buf.mean(dim=1).abs(), buf.var(dim=1, correction=0).abs()], dim=1
    )
    reduced = collectives.allreduce_tensor(stats, comm=comm)
    local = stats.cpu()
    err = float((reduced.cpu() / p - local).abs().max())
    if err > tol * max(1.0, float(local.abs().max())):
        raise AssertionError(
            f"replica desync detected: |allreduce/p - local| = {err:.3e} "
            f"(tol {tol})"
        )
