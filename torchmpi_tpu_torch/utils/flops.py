"""Analytic FLOP model of the long-context LM and its utilization.

Copies of ``torchmpi_tpu/utils/flops.py``'s ``dense_flops``,
``transformer_forward_flops``, ``train_flops`` and ``mfu``, with the peak
table replaced by the CUDA card's data-sheet rates. Conventions: 1 MAC =
2 FLOPs; a training step is 3x the forward; the attention products are
counted over the full T x T (the reference's accounting, which does not
halve them for the causal mask); elementwise work is not counted.
"""

from __future__ import annotations

from typing import Optional

# Per-card dense peaks by dtype (NVIDIA's H100 SXM data sheet: f32 outside
# the tensor cores, bf16 on them), matched as a substring of the card's name.
CARD_PEAK_FLOPS = (
    ("H100", {"float32": 67e12, "bfloat16": 989e12}),
)


def dense_flops(cin: int, cout: int) -> int:
    return 2 * cin * cout


def transformer_forward_flops(seq: int, d_model: int, num_layers: int,
                              num_heads: int, head_dim: int, vocab: int,
                              mlp_ratio: int = 4) -> int:
    """Per-sequence forward FLOPs of ``models.LongContextTransformer``
    (divide by ``seq`` for per-token FLOPs)."""
    attn_dim = num_heads * head_dim
    per_layer = (
        dense_flops(d_model, 3 * attn_dim) * seq           # qkv projection
        + 2 * seq * seq * attn_dim                         # q @ k^T
        + 2 * seq * seq * attn_dim                         # softmax @ v
        + dense_flops(attn_dim, d_model) * seq             # output proj
        + dense_flops(d_model, mlp_ratio * d_model) * seq  # mlp up
        + dense_flops(mlp_ratio * d_model, d_model) * seq  # mlp down
    )
    return num_layers * per_layer + dense_flops(d_model, vocab) * seq


def train_flops(forward_flops: int) -> int:
    """Forward + backward (~2x forward) training FLOPs."""
    return 3 * forward_flops


def device_peak_flops(device_name: Optional[str], dtype: str = "float32") -> Optional[float]:
    """The card's peak FLOP/s for ``dtype``, or None for an unknown card
    (or no card: ``device_name`` None)."""
    for tag, peaks in CARD_PEAK_FLOPS:
        if device_name and tag in device_name:
            return peaks.get(dtype)
    return None


def mfu(samples_per_sec_per_chip: float, flops_per_sample: int,
        device_name: Optional[str], dtype: str = "float32") -> tuple[float, Optional[float]]:
    """(achieved FLOP/s per card, fraction of the card's peak or None)."""
    achieved = samples_per_sec_per_chip * flops_per_sample
    peak = device_peak_flops(device_name, dtype)
    return achieved, (achieved / peak if peak else None)
