"""Long-context causal transformer with ring-attention sequence parallelism.

The port of ``torchmpi_tpu/models/transformer.py`` as ``torch.nn`` modules.
Tokens are rank-stacked ``[sp, B, t_local]``: rank r holds positions
r*t_local .. r*t_local + t_local - 1 of every sequence, and attention
runs over that ring (:func:`ring_self_attention`; full attention when
sp == 1, as the JAX model without ``sp_axis``). The modules compute the
flax modules' function, so weights carry over through :mod:`.convert`:

- flax ``LayerNorm`` (epsilon 1e-6, f32) and ``Dense`` (``x @ kernel +
  bias``; the port's weight is the kernel transposed);
- ``nn.gelu`` defaults to the tanh approximation: ``F.gelu(approximate=
  "tanh")``;
- one ``Dense(3*h*d)`` split into thirds on the last axis, each reshaped
  to ``(h, d)`` (q, k, v; not interleaved per head);
- position embeddings at global positions; the final LayerNorm and the
  vocabulary head in f32.

- ``dtype`` (``transformer.py:91-92``): the parameters stay f32 and
  ``dtype=torch.bfloat16`` follows flax's promotion with explicit casts
  (not ``torch.autocast``, whose rules differ): the embeddings and every
  ``Dense`` of a block compute in bf16 from their f32 parameters, so the
  residual stream is bf16; every LayerNorm runs in f32 on an f32 copy of
  its input, and the vocabulary head is f32. In f32 every cast is a
  no-op;
- ``remat=True`` (``transformer.py:110``) runs each block under
  ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: its
  activations are dropped and recomputed in the backward, the ring
  attention forward (K8) included. The parameter names are the same
  with or without it (JAX's "explicit name" rule,
  ``transformer.py:112-114``), so one ``state_dict`` drives both.

:func:`init_lm_params` draws flax's default initialisation from a seeded
``torch.Generator``; the numbers differ from flax's, the distributions
are the same.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.ring_attention import full_self_attention, ring_self_attention

LN_EPS = 1e-6  # flax LayerNorm's epsilon


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: input, kernel and bias cast to ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class RingAttentionBlock(nn.Module):
    def __init__(self, d_model: int, num_heads: int, head_dim: int, mlp_ratio: int = 4,
                 sp_backend: str = "xla", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads, self.head_dim, self.sp_backend = num_heads, head_dim, sp_backend
        self.dtype = dtype
        attn = num_heads * head_dim
        self.layernorm0 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dense0 = nn.Linear(d_model, 3 * attn)
        self.dense1 = nn.Linear(attn, d_model)
        self.layernorm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dense2 = nn.Linear(d_model, mlp_ratio * d_model)
        self.dense3 = nn.Linear(mlp_ratio * d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: [sp, B, t_local, d_model] in self.dtype; LayerNorm in f32
        dt = self.dtype
        q, k, v = _dense(self.dense0, self.layernorm0(x.float()), dt).chunk(3, dim=-1)
        shape = x.shape[:3] + (self.num_heads, self.head_dim)
        q, k, v = (a.reshape(shape) for a in (q, k, v))
        if x.shape[0] > 1:
            attn = ring_self_attention(q, k, v, causal=True, backend=self.sp_backend)
        else:
            attn = full_self_attention(q[0], k[0], v[0], causal=True)[None]
        x = x + _dense(self.dense1, attn.reshape(x.shape[:3] + (-1,)), dt)
        h = F.gelu(_dense(self.dense2, self.layernorm1(x.float()), dt), approximate="tanh")
        return x + _dense(self.dense3, h, dt)


class LongContextTransformer(nn.Module):
    """Decoder-only LM over rank-stacked tokens ``[sp, B, t_local]``;
    returns f32 logits ``[sp, B, t_local, vocab_size]``. ``sp_backend`` is
    the ring-attention backend (:func:`ring_self_attention`), ``dtype`` the
    compute dtype of the embeddings and blocks, ``remat`` recomputes each
    block in the backward (module docstring)."""

    def __init__(self, vocab_size: int = 256, num_layers: int = 2, num_heads: int = 4,
                 head_dim: int = 32, d_model: int = 128, max_len: int = 4096,
                 sp_backend: str = "xla", mlp_ratio: int = 4, remat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vocab_size, self.num_layers, self.num_heads = vocab_size, num_layers, num_heads
        self.head_dim, self.d_model, self.max_len = head_dim, d_model, max_len
        self.remat, self.dtype = remat, dtype
        self.embed0 = nn.Embedding(vocab_size, d_model)
        self.embed1 = nn.Embedding(max_len, d_model)
        self.blocks = nn.ModuleList(
            RingAttentionBlock(d_model, num_heads, head_dim, mlp_ratio, sp_backend, dtype)
            for _ in range(num_layers)
        )
        self.layernorm0 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dense0 = nn.Linear(d_model, vocab_size)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        sp, _, t_local = tokens.shape
        pos = torch.arange(sp * t_local, device=tokens.device).reshape(sp, t_local)
        # flax Embed(dtype=): the table cast, then looked up
        x = self.embed0(tokens).to(self.dtype) + self.embed1(pos).to(self.dtype)[:, None]
        for block in self.blocks:
            x = checkpoint(block, x, use_reentrant=False) if self.remat else block(x)
        return self.dense0(self.layernorm0(x.float()))


def make_lm_loss_fn(model: nn.Module) -> Callable:
    """Next-token loss ``loss_fn(params, batch)`` with ``batch = (tokens,
    targets)``, both ``[B, T]`` integers, on one shard: mean cross-entropy
    over every position (the JAX engine's batch contract)."""

    def loss_fn(params: Dict[str, torch.Tensor], batch: Tuple) -> torch.Tensor:
        tokens, targets = batch
        logits = torch.func.functional_call(model, params, (tokens[None],))[0]
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(-1, targets[..., None].long()).mean()

    return loss_fn


def init_lm_params(model: LongContextTransformer, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Flax's default initialisation of ``model``'s parameters, drawn from
    ``torch.Generator().manual_seed(seed)`` on the CPU: embeddings
    normal with variance 1/d_model, dense kernels lecun_normal (a normal
    truncated at two standard deviations, variance 1/fan_in), zero biases,
    LayerNorm scales 1. Returns a dict of CPU tensors for
    ``model.load_state_dict``."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, param in model.named_parameters():
        value = torch.zeros(param.shape, dtype=param.dtype)
        leaf = name.rsplit(".", 2)[-2]
        if leaf.startswith("embed"):
            value.normal_(0.0, 1.0 / math.sqrt(param.shape[1]), generator=gen)
        elif leaf.startswith("layernorm"):
            if name.endswith("weight"):
                value.fill_(1.0)
        elif name.endswith("weight"):
            # flax variance_scaling(1, 'fan_in', 'truncated_normal'): the
            # stddev is corrected for the truncation at two stddevs
            std = math.sqrt(1.0 / param.shape[1]) / 0.87962566103423978
            torch.nn.init.trunc_normal_(value, std=std, a=-2 * std, b=2 * std, generator=gen)
        out[name] = value
    return out
