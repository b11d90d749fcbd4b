"""Pipeline parallelism over a named rank axis (GPipe and 1F1B).

The port of ``torchmpi_tpu/parallel/pp.py``. Each rank along the ``pp``
axis owns one stage: the stage parameters are rank-stacked ``[p, ...]``
(rank r holds the stage of its pp coordinate), and so are the
activations, ``[p, mb, ...]``.

**Contract.** ``stage_fn(params, x)`` takes and returns rank-stacked
tensors, ``y`` of ``x``'s shape and dtype, and calls any collective it
needs itself (the 3-D stage of ``__graft_entry__.py:503-510`` sums over
``tp`` with :func:`~.axis.axis_psum`); the pipeline does not ``vmap`` it
over the ranks. ``microbatches`` and ``targets`` are ``[p, m, mb, ...]``,
every rank's own copy (only the first stage reads the inputs, only the
last the targets).

- GPipe, :func:`pipeline_forward` / :func:`pipeline_loss_fn`: a Python
  loop over the ``m + p - 1`` ticks of ``pp.py:42``'s ``lax.scan``; stage
  0 injects microbatch t, the hand-off is :func:`~.axis.axis_ppermute`
  (a roll), the replicated output a masked :func:`~.axis.axis_psum` (K3).
  Autograd through the loop is the GPipe backward; activations grow O(m).
- 1F1B, :func:`pipeline_1f1b_value_and_grad`: the static schedule of
  ``_one_f_one_b_plan`` (copied verbatim: numpy and the standard
  library), one ``torch.autograd.grad`` a tick against the stashed stage
  input (the stage forward recomputed, as ``pp.py:372-382``), stash
  buffers of the plan's ``x_buf``, ``in_buf`` and ``gy_buf`` slots. Where
  JAX's ``lax.cond`` skips an idle slot, only the active stages' rows
  run: ``stage_fn`` gets the rows of those ranks, so under 1F1B it must be
  row-local (no collective inside), as a collective inside JAX's
  per-device ``lax.cond`` would not be sound either.

Bubble fraction ``(p-1)/(m+p-1)`` in both.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..collectives.axis import axis_ppermute, axis_psum, axis_rank
from .mesh import MeshLayout


def _stage_mask(layout: MeshLayout, axis: str, stage: int, like: torch.Tensor) -> torch.Tensor:
    """``[p, 1, ...]`` bool: the ranks at coordinate ``stage`` of ``axis``."""
    return axis_rank(layout, axis, like.device, like.shape[1:]) == stage


def pipeline_forward(
    stage_fn: Callable,
    stage_params,
    microbatches: torch.Tensor,
    layout: MeshLayout,
    axis: str = "pp",
    replicate_outputs: bool = True,
) -> torch.Tensor:
    """Run the pp stages over ``m`` microbatches (``pp.py:42``).

    ``microbatches``: ``[p, m, mb, ...]``. Returns the last stage's outputs
    ``[p, m, mb, ...]``: with ``replicate_outputs`` (default) on every rank,
    through a masked :func:`axis_psum`, whose transpose sums the p
    identical cotangents (differentiate :func:`pipeline_loss_fn` instead,
    which masks the loss); without it each rank's own buffer (meaningful
    only on the last stage)."""
    p = layout.size(axis)
    m = microbatches.shape[1]
    first = _stage_mask(layout, axis, 0, microbatches[:, 0])
    incoming = torch.zeros_like(microbatches[:, 0])
    outputs = []
    for t in range(m + p - 1):
        # stage 0 injects microbatch t (the last again once t >= m), the
        # others take what their left neighbour made last tick
        x = torch.where(first, microbatches[:, min(t, m - 1)], incoming)
        y = stage_fn(stage_params, x)
        if t >= p - 1:
            outputs.append(y)
        if t < m + p - 2:
            incoming = axis_ppermute(y, layout, axis, 1)
    outputs = torch.stack(outputs, 1)
    if not replicate_outputs:
        return outputs
    last = _stage_mask(layout, axis, p - 1, outputs)
    return axis_psum(torch.where(last, outputs, torch.zeros_like(outputs)), layout, axis)


def pipeline_loss_fn(
    stage_fn: Callable,
    loss_of_outputs: Callable,
    layout: MeshLayout,
    axis: str = "pp",
    convention: str = "grad-inside",
) -> Callable:
    """``fn(stage_params, microbatches, targets) -> loss [p]``: the GPipe
    forward and ``loss_of_outputs(outputs [p, m, mb, ...], targets) ->
    [p]``, one lane a rank (``pp.py:114``). Every lane's value is the last
    stage's loss; the gradient flows only through the last stage's lane
    (``masked + (replicated - masked).detach()``).

    ``convention`` names how the caller reduces the lanes before
    ``backward``, JAX's two differentiation patterns on one card:

    - ``'grad-inside'`` (``shard_map(jax.value_and_grad(fn))``, every lane
      cotangent 1): ``loss.sum().backward()``;
    - ``'grad-outside'`` (``jax.grad(shard_map(fn, out_specs=P()))``,
      every lane cotangent 1/p): ``loss.mean().backward()``, with the
      differentiable lane scaled by p as at ``pp.py:165``.

    Under its own convention each gives every stage its sequential
    gradient; under the other they are off by exactly p or 1/p."""
    if convention not in ("grad-inside", "grad-outside"):
        raise ValueError(
            "convention must be 'grad-inside' (shard_map(grad(fn))) or "
            f"'grad-outside' (grad(shard_map(fn))), got {convention!r}"
        )

    def fn(stage_params, microbatches, targets):
        outs = pipeline_forward(stage_fn, stage_params, microbatches, layout, axis,
                                replicate_outputs=False)
        p = layout.size(axis)
        loss_local = loss_of_outputs(outs, targets)
        last = _stage_mask(layout, axis, p - 1, loss_local)
        masked = torch.where(last, loss_local, torch.zeros_like(loss_local))
        replicated = axis_psum(masked.detach(), layout, axis)
        # the differentiable lane: x1 when each lane's cotangent is 1
        # (grad-inside), xp when each lane gets 1/p (grad-outside)
        diff_lane = masked * p if convention == "grad-outside" else masked
        return diff_lane + (replicated - diff_lane).detach()

    return fn


# ---------------------------------------------------------------------------
# 1F1B (PipeDream-flush) schedule: torchmpi_tpu/parallel/pp.py:176-287
# ---------------------------------------------------------------------------


def _one_f_one_b_schedule(p: int, m: int):
    """Static greedy 1F1B schedule: per tick and stage, which microbatch to
    forward / backward (-1 = idle). One compute slot per tick per stage;
    activations/cotangents sent at the end of a tick are usable the next.

    Policy: each stage runs warmup forwards until ``min(m, p - s)``
    microbatches are in flight, then strictly prefers backward over forward
    (the 1F1B alternation) — bounding live activations at O(p) instead of
    GPipe's O(m). Dependencies (fwd needs left's fwd done, bwd needs
    right's bwd done and the local fwd) are enforced by construction."""
    fwd_next, bwd_next = [0] * p, [0] * p
    fwd_time: dict = {}
    bwd_time: dict = {}
    max_inflight = [min(m, p - s) for s in range(p)]
    rows_f, rows_b = [], []
    t = 0
    while any(b < m for b in bwd_next):
        row_f, row_b = [-1] * p, [-1] * p
        for s in range(p):
            jf, jb = fwd_next[s], bwd_next[s]
            # .get default t => "not yet happened" fails the < t check
            can_fwd = jf < m and (
                s == 0 or fwd_time.get((s - 1, jf), t) < t
            )
            can_bwd = (
                jb < m
                and jb < jf
                and (s == p - 1 or bwd_time.get((s + 1, jb), t) < t)
            )
            if can_bwd and (jf - jb >= max_inflight[s] or not can_fwd):
                row_b[s] = jb
                bwd_time[(s, jb)] = t
                bwd_next[s] += 1
            elif can_fwd and jf - jb < max_inflight[s]:
                # at capacity with no backward ready the stage IDLES (a
                # bubble): forwarding anyway would grow live activations
                # to O(m) and forfeit exactly the bound 1F1B exists for
                row_f[s] = jf
                fwd_time[(s, jf)] = t
                fwd_next[s] += 1
        rows_f.append(row_f)
        rows_b.append(row_b)
        t += 1
        if t > 4 * (m + p) + 8:
            raise AssertionError(
                f"1F1B schedule failed to converge for p={p}, m={m}"
            )
    return (
        np.asarray(rows_f, np.int32),
        np.asarray(rows_b, np.int32),
        fwd_time,
        bwd_time,
    )


def _min_safe_stash(m: int, lives) -> int:
    """Smallest circular-buffer size with no live-range collision: slots
    ``j % size`` may not alias while both live. ``lives`` is a list of
    (j, write_tick, read_tick) tuples; static schedule -> exact check."""
    for size in range(1, m + 1):
        ok = True
        for j, w, r in lives:
            for j2, w2, r2 in lives:
                if j2 <= j or (j2 - j) % size != 0:
                    continue
                if w2 <= r:  # j2 overwrites the slot before j is read
                    ok = False
                    break
            if not ok:
                break
        if ok:
            return size
    return m


def _one_f_one_b_plan(p: int, m: int):
    """Schedule arrays + exact minimal stash sizes (all static)."""
    rows_f, rows_b, fwd_time, bwd_time = _one_f_one_b_schedule(p, m)
    # x stash: written at the stage's own fwd tick, read at its bwd tick
    x_lives = [
        [
            (j, fwd_time[(s, j)], bwd_time[(s, j)])
            for j in range(m)
        ]
        for s in range(p)
    ]
    # incoming activations: written the tick after the LEFT stage's fwd,
    # read at this stage's fwd tick
    in_lives = [
        [
            (j, fwd_time[(s - 1, j)] + 1, fwd_time[(s, j)])
            for j in range(m)
        ]
        for s in range(1, p)
    ]
    # incoming cotangents: written the tick after the RIGHT stage's bwd,
    # read at this stage's bwd tick
    gy_lives = [
        [
            (j, bwd_time[(s + 1, j)] + 1, bwd_time[(s, j)])
            for j in range(m)
        ]
        for s in range(p - 1)
    ]
    x_buf = max(_min_safe_stash(m, lv) for lv in x_lives)
    in_buf = max(
        (_min_safe_stash(m, lv) for lv in in_lives), default=1
    )
    gy_buf = max(
        (_min_safe_stash(m, lv) for lv in gy_lives), default=1
    )
    return rows_f, rows_b, x_buf, in_buf, gy_buf


def pipeline_1f1b_value_and_grad(
    stage_fn: Callable,
    loss_of_microbatch: Callable,
    layout: MeshLayout,
    axis: str = "pp",
) -> Callable:
    """``fn(stage_params, microbatches, targets) -> (loss [p], grads)``
    under the 1F1B (PipeDream-flush) schedule (``pp.py:290``): the
    backward of microbatch j starts as soon as its forward clears the
    pipe, so live activations are the plan's O(p) stash slots. Each rank
    gets its own stage's parameter gradients (rank-stacked like
    ``stage_params``) and every rank the total loss ``(1/m) * sum_j
    loss_of_microbatch(y_j, t_j)``; ``loss_of_microbatch(y [k, mb, ...],
    target) -> [k]`` over the k rows it is given. It computes its
    gradients itself and is not differentiated again. ``stage_fn`` runs on
    the active stages' rows only (see the module docstring)."""

    def fn(stage_params, microbatches, targets):
        p = layout.size(axis)
        m = microbatches.shape[1]
        dev = microbatches.device
        mb_shape = microbatches.shape[2:]
        rows_f, rows_b, x_buf, in_buf, gy_buf = _one_f_one_b_plan(p, m)
        s = layout.axis_index(axis)
        ranks = layout.num_ranks
        leaves, spec = pytree.tree_flatten(stage_params)
        in_act = microbatches.new_zeros((in_buf, ranks) + mb_shape)
        gy = microbatches.new_zeros((gy_buf, ranks) + mb_shape)
        x_saved = microbatches.new_zeros((x_buf, ranks) + mb_shape)
        grads = [torch.zeros_like(leaf) for leaf in leaves]
        loss_sum = torch.zeros(ranks, dtype=torch.float32, device=dev)

        def rows_of(active):
            idx = np.nonzero(active)[0]
            return idx, torch.as_tensor(idx, device=dev)

        for t in range(rows_f.shape[0]):
            jf, jb = rows_f[t][s], rows_b[t][s]

            # ---- forward slot: the rows of the stages with a forward ----
            y = torch.zeros_like(x_saved[0])
            idx, rows = rows_of(jf >= 0)
            if idx.size:
                j = torch.as_tensor(jf[idx], device=dev)
                first = torch.as_tensor(s[idx] == 0, device=dev).reshape(
                    (-1,) + (1,) * len(mb_shape))
                x_in = torch.where(first, microbatches[rows, j], in_act[j % in_buf, rows])
                with torch.no_grad():
                    y[rows] = stage_fn(pytree.tree_unflatten(
                        [leaf.index_select(0, rows) for leaf in leaves], spec), x_in)
                x_saved[j % x_buf, rows] = x_in

            # ---- backward slot: the stage forward again, then its vjp ----
            gx = torch.zeros_like(x_saved[0])
            idx, rows = rows_of(jb >= 0)
            if idx.size:
                j = torch.as_tensor(jb[idx], device=dev)
                last = torch.as_tensor(s[idx] == p - 1, device=dev)
                w = [leaf.index_select(0, rows).detach().requires_grad_() for leaf in leaves]
                xx = x_saved[j % x_buf, rows].detach().requires_grad_()
                with torch.enable_grad():
                    yy = stage_fn(pytree.tree_unflatten(w, spec), xx)
                    l_b = loss_of_microbatch(yy, targets[rows, j])
                    cot_y = torch.where(last.reshape((-1,) + (1,) * len(mb_shape)),
                                        torch.zeros_like(yy), gy[j % gy_buf, rows])
                    cot_l = torch.where(last, 1.0 / m, 0.0).to(l_b.dtype)
                    pulled = torch.autograd.grad((yy, l_b), w + [xx], (cot_y, cot_l),
                                                 allow_unused=True)
                for acc, g in zip(grads, pulled[:-1]):
                    if g is not None:
                        acc.index_add_(0, rows, g)
                gx[rows] = pulled[-1]
                loss_sum.index_add_(0, rows, torch.where(last, l_b.detach().float() / m, 0.0))

            # ---- exchanges: activations ride right, cotangents left ----
            act_recv = axis_ppermute(y, layout, axis, 1)
            cot_recv = axis_ppermute(gx, layout, axis, -1)
            jf_left, jb_right = rows_f[t][(s - 1) % p], rows_b[t][(s + 1) % p]
            idx, rows = rows_of((jf_left >= 0) & (s > 0))
            if idx.size:
                j = torch.as_tensor(jf_left[idx] % in_buf, device=dev)
                in_act[j, rows] = act_recv[rows]
            idx, rows = rows_of((jb_right >= 0) & (s < p - 1))
            if idx.size:
                j = torch.as_tensor(jb_right[idx] % gy_buf, device=dev)
                gy[j, rows] = cot_recv[rows]
        return axis_psum(loss_sum, layout, axis), pytree.tree_unflatten(grads, spec)

    return fn
