"""Analytic FLOP models of the ResNet family and the long-context LM, and
their utilization.

Copies of ``torchmpi_tpu/utils/flops.py``'s ``conv2d_flops``,
``dense_flops``, ``resnet_forward_flops``, ``transformer_forward_flops``,
``train_flops`` and ``mfu``, with the peak table replaced by the CUDA
card's data-sheet rates. Conventions: 1 MAC = 2 FLOPs; a training step is
3x the forward; the attention products are counted over the full T x T
(the reference's accounting, which does not halve them for the causal
mask); elementwise work (batch norm, pooling, softmax) is not counted.
"""

from __future__ import annotations

import math
from typing import Optional

# Per-card dense peaks by dtype (NVIDIA's H100 SXM data sheet: f32 outside
# the tensor cores, bf16 on them), matched as a substring of the card's name.
CARD_PEAK_FLOPS = (
    ("H100", {"float32": 67e12, "bfloat16": 989e12}),
)


def conv2d_flops(h: int, w: int, cin: int, cout: int, kh: int, kw: int,
                 stride: int = 1) -> tuple[int, int, int]:
    """FLOPs of a SAME-padded conv; returns (flops, h_out, w_out)."""
    ho, wo = math.ceil(h / stride), math.ceil(w / stride)
    return 2 * kh * kw * cin * cout * ho * wo, ho, wo


def dense_flops(cin: int, cout: int) -> int:
    return 2 * cin * cout


def resnet_forward_flops(image: int = 224, stage_sizes=(3, 4, 6, 3),
                         bottleneck: bool = True, num_classes: int = 1000,
                         num_filters: int = 64) -> int:
    """Per-image forward FLOPs of ``models.resnet.ResNet`` by its module
    walk: the 7x7/2 stem, the 3x3/2 max-pool, then bottleneck (1x1 -> 3x3
    -> 1x1, x4 expansion) or basic (3x3 -> 3x3) stages, stride 2 at each
    stage entry (on the 3x3), a 1x1 projection wherever the shape changes,
    and the dense head. ResNet-50 at 224 px, 1000 classes: 8,178,368,512."""
    total, h, w = 0, image, image
    f, h, w = conv2d_flops(h, w, 3, num_filters, 7, 7, stride=2)
    total += f
    h, w = math.ceil(h / 2), math.ceil(w / 2)  # max_pool 3x3 s2 SAME
    cin = num_filters
    for i, count in enumerate(stage_sizes):
        feats = num_filters * 2 ** i
        cout = feats * 4 if bottleneck else feats
        for j in range(count):
            stride = 2 if (i > 0 and j == 0) else 1
            if bottleneck:
                f1, _, _ = conv2d_flops(h, w, cin, feats, 1, 1)
                f2, h2, w2 = conv2d_flops(h, w, feats, feats, 3, 3, stride)
                f3, _, _ = conv2d_flops(h2, w2, feats, cout, 1, 1)
                total += f1 + f2 + f3
            else:
                f2, h2, w2 = conv2d_flops(h, w, cin, feats, 3, 3, stride)
                f3, _, _ = conv2d_flops(h2, w2, feats, feats, 3, 3)
                total += f2 + f3
            if cin != cout or stride != 1:
                fp, _, _ = conv2d_flops(h, w, cin, cout, 1, 1, stride)
                total += fp
            h, w, cin = h2, w2, cout
    total += dense_flops(cin, num_classes)
    return total


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
