"""Expert parallelism (MoE) over a named rank axis.

The port of ``torchmpi_tpu/parallel/ep.py``. Each rank along the ``ep``
axis owns one expert (its parameters rank-stacked ``[p, ...]``) and a
shard of the tokens, ``x [p, T, d]``:

- top-k routing (k=1 Switch-style, k=2 the GShard default) with a fixed
  per-expert capacity; a route beyond its expert's capacity is dropped
  (its output contribution is zero), every first choice queueing before
  any second choice;
- the queue positions are counted choice-major in **int32**
  (``ep.py:87-95``): a bf16 count loses positions past 256;
- dispatch and combine are the ``[T, E, C]`` einsums of the
  Mesh-TensorFlow formulation, one a rank;
- the exchange each way is :func:`~.axis.axis_all_to_all` (its own
  transpose under autograd); :func:`moe_load_stats` sums the route counts
  with :func:`~.axis.axis_psum` (K3, int32, exact) and averages the
  gate statistics with :func:`~.axis.axis_pmean`.

``lax.top_k`` puts the lower index first among equal logits; the port
takes the top k of a stable descending sort, which does the same.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..collectives.axis import axis_all_to_all, axis_pmean, axis_psum
from .mesh import MeshLayout


def _top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    return torch.sort(logits, dim=-1, descending=True, stable=True).indices[..., :k]


def _einsum(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum``'s type promotion: both operands in their promoted
    dtype."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(equation, a.to(dtype), b.to(dtype))


def _one_hot(index: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside ``[0, n)`` gives a zero row."""
    return (index[..., None] == torch.arange(n, device=index.device)).to(dtype)


def moe_dispatch_combine(
    x: torch.Tensor,
    router_logits: torch.Tensor,
    expert_fn: Callable,
    expert_params,
    layout: MeshLayout,
    axis: str = "ep",
    capacity: Optional[int] = None,
    top_k: int = 1,
    renormalize: bool = True,
) -> torch.Tensor:
    """Route every rank's tokens to their top-k experts over ``axis``
    (``ep.py:31``).

    ``x`` ``[p, T, d]``: each rank's token shard; ``router_logits`` ``[p,
    T, E]`` (E the axis size); ``expert_fn(expert_params, tokens [p, N,
    d]) -> [p, N, d]``, every rank's expert on the tokens it received,
    rank-stacked. ``capacity``: slots per expert per source rank (default
    ``2 * ceil(k*T/E)``). ``renormalize``: for ``top_k > 1``, rescale the
    selected gates to sum to 1 per token (GShard); top-1 keeps the raw
    softmax probability (Switch). Returns ``[p, T, d]``, dropped routes
    contributing zeros."""
    E = layout.size(axis)
    p, T, d = x.shape
    k = top_k
    if not 1 <= k <= E:
        raise ValueError(f"top_k must be in [1, {E}], got {k}")
    if tuple(router_logits.shape) != (p, T, E):
        raise ValueError(
            f"router_logits must be [T={T}, E={E}], got {tuple(router_logits.shape[1:])}"
        )
    C = capacity if capacity is not None else 2 * (-(-(k * T) // E))
    if C <= 0:
        raise ValueError(f"capacity must be positive, got {C}")

    gates = torch.softmax(router_logits, dim=-1)  # [p, T, E]
    idxs = _top_k(router_logits, k)  # [p, T, k]
    onehots = _one_hot(idxs, E, x.dtype)  # [p, T, k, E]
    gate_vals = _einsum("pte,ptke->ptk", gates, onehots)
    if k > 1 and renormalize:
        gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)

    # per-expert queue positions, choice-major, counted in int32
    oh_i = _one_hot(idxs, E, torch.int32)
    oh_cm = oh_i.transpose(1, 2).reshape(p, k * T, E)
    pos_cm = torch.cumsum(oh_cm, dim=1, dtype=torch.int32) - oh_cm
    my_pos = (pos_cm * oh_cm).sum(-1, dtype=torch.int32).reshape(p, k, T).transpose(1, 2)
    keep = (my_pos < C).to(x.dtype)
    # per-choice dispatch [p, T, k, E, C]; slots are disjoint by construction
    disp_k = (onehots[..., None] * _one_hot(my_pos, C, x.dtype)[:, :, :, None, :]
              * keep[..., None, None])
    disp = disp_k.sum(2)  # [p, T, E, C]
    comb = _einsum("ptkec,ptk->ptec", disp_k, gate_vals)

    # [p, E, C, d]: slot (e, c) holds the token bound for expert e
    expert_inputs = _einsum("ptec,ptd->pecd", disp, x)
    # exchange: rank r gets [E_src, C, d], every block bound for its expert
    arrived = axis_all_to_all(expert_inputs, layout, axis)
    outs = expert_fn(expert_params, arrived.reshape(p, E * C, d)).reshape(p, E, C, d)
    returned = axis_all_to_all(outs, layout, axis)
    return _einsum("ptec,pecd->ptd", comb, returned)


def moe_load_stats(router_logits: torch.Tensor, layout: MeshLayout, axis: str = "ep",
                   top_k: int = 1):
    """``(tokens_per_expert [p, E], aux_loss [p])`` over every rank's token
    shard (``ep.py:126``): the routes to each expert (every selected route
    counts) summed exactly in int32 by :func:`axis_psum` and returned in
    the gates' dtype, and the mean-gate x mean-assignment load-balance loss
    with the GShard first-choice dispatch fraction for any ``top_k``."""
    E = layout.size(axis)
    gates = torch.softmax(router_logits, dim=-1)
    idxs = _top_k(router_logits, top_k)
    routes = _one_hot(idxs, E, torch.int32).sum((1, 2), dtype=torch.int32)  # [p, E]
    first = _one_hot(idxs[..., 0], E, gates.dtype)
    tokens_per_expert = axis_psum(routes, layout, axis).to(gates.dtype)
    me = axis_pmean(gates.mean(1), layout, axis)
    ce = axis_pmean(first.mean(1), layout, axis)
    return tokens_per_expert, E * (me * ce).sum(-1)
