"""Ring attention: sequence parallelism over the virtual ranks of one card.

The port of ``torchmpi_tpu/parallel/ring_attention.py``. The sequence is
sharded over an ``sp`` ring of ranks: q, k and v are rank-stacked
``[sp, b, n_local, h, d]`` (rank r holds positions r*n_local ..), and
attention rotates the key/value blocks round the ring while the queries
stay put, with the streaming softmax (running max and normalizer) keeping
the result exact.

Backends of :func:`ring_self_attention`:

- ``'xla'``: the JAX ``ppermute`` ring (``ring_attention.py:119-156``) in
  plain PyTorch on the rank axis, ``torch.roll`` as the rotation: the
  kernels' plain forward (``ops.ring_attention_fwd_plain``), which
  autograd differentiates;
- ``'kernel'`` with the suffixes ``_bidir`` (the bidirectional forward,
  K9, in place of K8) and ``_full`` (the backward kernel K10 in place of
  the plain analytic backward), e.g. ``'kernel_bidir_full'``: the
  hand-written CUDA kernels through :class:`ops.RingAttention`;
- ``'auto'``: ``'kernel'`` for a CUDA tensor, ``'xla'`` for a CPU one. On
  the card the kernels raise for what they do not take (a dtype other
  than f32 or bf16, a head_dim outside
  ``ops.ring_attention_kernel.HEAD_DIMS``): nothing falls back to the
  plain version there.

The JAX ``interpret`` token has no counterpart: a CPU tensor runs each
kernel's plain version.
"""

from __future__ import annotations

from ..ops.ring_attention_kernel import (
    RingAttention,
    full_attention_with_lse,
    ring_attention_fwd_plain,
)

_KERNEL_TOKENS = {"kernel", "bidir", "full"}


def ring_self_attention(q, k, v, causal: bool = False, backend: str = "xla"):
    """Exact self-attention over a sequence sharded along the leading axis
    of ``[sp, b, n_local, h, d]`` tensors; returns the output of every
    rank's queries, equal (up to float error) to full attention over the
    gathered sequence. Causal masking uses global positions."""
    if backend == "auto":
        backend = "kernel" if q.device.type == "cuda" else "xla"
    if backend == "xla":
        return ring_attention_fwd_plain(q, k, v, causal)[0]
    tokens = set(backend.split("_"))
    if not (backend.startswith("kernel") and tokens <= _KERNEL_TOKENS):
        raise ValueError(f"unknown ring-attention backend {backend!r}")
    return RingAttention.apply(q, k, v, causal, "bidir" in tokens, "full" in tokens)


def full_self_attention(q, k, v, causal: bool = False):
    """Single-shard attention over ``[b, n, h, d]`` (the reference for parity
    tests, and sp = 1): ``ops.full_attention_with_lse``'s output, computed
    in f32 and cast to the input dtype."""
    return full_attention_with_lse(q, k, v, causal)[0]
