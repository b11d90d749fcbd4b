"""Hand-written CUDA kernels of the port, each beside its plain version.

- ``ring_allreduce`` (``csrc/ring_kernels.cu``) replaces the JAX package's
  ``ops/ring_kernels.py:_ring_phases_kernel`` in allreduce mode;
- ``ring_reduce_scatter`` and ``ring_allgather`` (``csrc/ring_kernels.cu``)
  replace the same kernel in its 'rs' and 'ag' modes;
- ``ring_reduce`` (``csrc/ring_kernels.cu``) replaces the 'rs' mode followed
  by ``ops/ring_kernels.py:_ring_gather_root_kernel``;
- ``ring_allreduce_bidir`` (``csrc/ring_kernels.cu``) replaces
  ``ops/ring_kernels.py:_ring_bidir_kernel``;
- ``ring_broadcast`` (``csrc/ring_kernels.cu``) replaces
  ``ops/ring_kernels.py:_ring_broadcast_kernel``;
- ``ring_allreduce_xproc``, ``ring_reduce_scatter_xproc``,
  ``ring_allgather_xproc``, ``ring_broadcast_xproc``,
  ``ring_allreduce_bidir_xproc`` and ``ring_reduce_xproc`` (the same file)
  are K3's three modes, K7, K5 and K6 across processes: they read the
  rank rows from every process's slab (``runtime/peers.py``) and write
  the process's own rows;
- ``ring_allreduce_quant`` and ``ring_reduce_scatter_quant``
  (``csrc/ring_quant.cu``) replace ``ops/ring_kernels.py:_ring_quant_kernel``
  in its allreduce and 'rs' modes (int8 or bf16 on every hop);
  ``ring_allreduce_quant_xproc`` and ``ring_reduce_scatter_quant_xproc``
  (the same file) are its two modes across processes, read from every
  process's slab as K3's are;
- ``accumulate`` (``csrc/reduce_kernel.cu``) replaces
  ``ops/reduce_kernel.py:_accumulate_kernel``, and ``scale_accumulate``
  (the same file) ``ops/reduce_kernel.py:_scale_add_kernel``;
  ``accumulate_many`` and ``scale_accumulate_many`` run the same kernels
  over a list of leaves in one launch;
- ``ring_attention_fwd`` (``csrc/ring_attention.cu`` on f32 inputs,
  ``csrc/ring_attention_bf16.cu`` on bf16 ones) replaces
  ``ops/ring_attention_kernel.py:_ring_attn_kernel`` and, with
  ``bidir=True``, ``_ring_attn_bidir_kernel``; ``ring_attention_bwd``
  replaces ``_ring_attn_bwd_kernel``; ``RingAttention`` is the autograd
  function around them;
- ``conv2d_weight_grad_ranks`` (``csrc/conv_wgrad.cu``) replaces no TPU
  kernel (the JAX package takes it from XLA): each rank's convolution
  weight gradient in an order that does not depend on how many ranks a
  launch holds, the engine's vmap gradient on the card (ROADMAP C6);
- ``rank_bmm`` (``csrc/rank_bmm.cu``) replaces no TPU kernel either: each
  rank's matrix product (a dense layer's forward and gradients under the
  engine's vmap on the card) in an order that does not depend on how many
  ranks a launch holds (ROADMAP C6).

Every wrapper counts its launches; :func:`launch_counts` reads the counts
and :func:`reset_launch_counts` sets them to 0. ``ops.issue`` is the C++
issue path of a warm async allreduce (``csrc/issue.cpp``), which launches
``ring_allreduce``'s kernel itself and counts it under the same name.
"""

from __future__ import annotations

from typing import Dict

from . import conv_wgrad, rank_bmm_kernel, reduce_kernel, ring_attention_kernel, ring_kernels
from .conv_wgrad import conv2d_weight_grad_ranks, conv2d_weight_grad_ranks_plain
from .rank_bmm_kernel import rank_bmm, rank_bmm_plain
from .reduce_kernel import (
    accumulate,
    accumulate_many,
    accumulate_many_plain,
    accumulate_plain,
    scale_accumulate,
    scale_accumulate_many,
    scale_accumulate_many_plain,
    scale_accumulate_plain,
)
from .ring_attention_kernel import (
    RingAttention,
    ring_attention_bwd,
    ring_attention_bwd_plain,
    ring_attention_fwd,
    ring_attention_fwd_plain,
)
from .ring_kernels import (
    ring_allgather,
    ring_allgather_plain,
    ring_allgather_xproc,
    ring_allgather_xproc_plain,
    ring_allreduce,
    ring_allreduce_bidir,
    ring_allreduce_bidir_plain,
    ring_allreduce_bidir_xproc,
    ring_allreduce_bidir_xproc_plain,
    ring_allreduce_plain,
    ring_allreduce_quant,
    ring_allreduce_quant_plain,
    ring_allreduce_quant_xproc,
    ring_allreduce_quant_xproc_plain,
    ring_allreduce_xproc,
    ring_allreduce_xproc_plain,
    ring_broadcast,
    ring_broadcast_plain,
    ring_broadcast_xproc,
    ring_broadcast_xproc_plain,
    ring_reduce,
    ring_reduce_plain,
    ring_reduce_scatter,
    ring_reduce_scatter_plain,
    ring_reduce_scatter_quant,
    ring_reduce_scatter_quant_plain,
    ring_reduce_scatter_quant_xproc,
    ring_reduce_scatter_quant_xproc_plain,
    ring_reduce_scatter_xproc,
    ring_reduce_scatter_xproc_plain,
    ring_reduce_xproc,
    ring_reduce_xproc_plain,
)


def launch_counts() -> Dict[str, int]:
    return {**ring_kernels.launches, **reduce_kernel.launches, **ring_attention_kernel.launches,
            **conv_wgrad.launches, **rank_bmm_kernel.launches}


def reset_launch_counts() -> None:
    for counts in (ring_kernels.launches, reduce_kernel.launches, ring_attention_kernel.launches,
                   conv_wgrad.launches, rank_bmm_kernel.launches):
        for name in counts:
            counts[name] = 0


__all__ = [
    "RingAttention",
    "accumulate",
    "accumulate_many",
    "accumulate_many_plain",
    "accumulate_plain",
    "conv2d_weight_grad_ranks",
    "conv2d_weight_grad_ranks_plain",
    "launch_counts",
    "rank_bmm",
    "rank_bmm_plain",
    "reset_launch_counts",
    "ring_allgather",
    "ring_allgather_plain",
    "ring_allgather_xproc",
    "ring_allgather_xproc_plain",
    "ring_allreduce",
    "ring_allreduce_bidir",
    "ring_allreduce_bidir_plain",
    "ring_allreduce_bidir_xproc",
    "ring_allreduce_bidir_xproc_plain",
    "ring_allreduce_plain",
    "ring_allreduce_quant",
    "ring_allreduce_quant_plain",
    "ring_allreduce_quant_xproc",
    "ring_allreduce_quant_xproc_plain",
    "ring_allreduce_xproc",
    "ring_allreduce_xproc_plain",
    "ring_attention_bwd",
    "ring_attention_bwd_plain",
    "ring_attention_fwd",
    "ring_attention_fwd_plain",
    "ring_broadcast",
    "ring_broadcast_plain",
    "ring_broadcast_xproc",
    "ring_broadcast_xproc_plain",
    "ring_reduce",
    "ring_reduce_plain",
    "ring_reduce_scatter",
    "ring_reduce_scatter_plain",
    "ring_reduce_scatter_quant",
    "ring_reduce_scatter_quant_plain",
    "ring_reduce_scatter_quant_xproc",
    "ring_reduce_scatter_quant_xproc_plain",
    "ring_reduce_scatter_xproc",
    "ring_reduce_scatter_xproc_plain",
    "ring_reduce_xproc",
    "ring_reduce_xproc_plain",
    "scale_accumulate",
    "scale_accumulate_many",
    "scale_accumulate_many_plain",
    "scale_accumulate_plain",
]
