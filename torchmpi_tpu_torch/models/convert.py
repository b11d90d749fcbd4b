"""Carry the JAX package's model weights into the port's modules.

``from_jax_params`` takes the flax parameter tree of ``LeNet`` or
``LogisticRegression`` as nested dicts of numpy arrays (as
``jax.device_get`` returns it) and gives the matching ``state_dict`` of the
port's module: flax's ``Conv_i`` / ``Dense_i`` become ``conv{i}`` /
``dense{i}``, conv kernels ``[kh, kw, in, out]`` become ``[out, in, kh,
kw]``, and dense kernels ``[in, out]`` become ``[out, in]``. The port's
LeNet flattens channels-last like flax, so no row permutation is needed.

``lm_from_jax_params`` does the same for ``LongContextTransformer``'s
tree: ``Embed_0`` / ``Embed_1`` become ``embed0`` / ``embed1`` (the table
as it is), ``RingAttentionBlock_i/{LayerNorm_0, Dense_0..3, LayerNorm_1}``
become ``blocks.i.{layernorm0, dense0..3, layernorm1}``, and the top-level
``LayerNorm_0`` and ``Dense_0`` become ``layernorm0`` and ``dense0``; a
LayerNorm ``scale`` becomes ``weight``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def from_jax_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    out = {}
    for module, leaves in tree.items():
        m = re.fullmatch(r"(Conv|Dense)_(\d+)", module)
        if m is None:
            raise ValueError(f"no port counterpart for flax module {module!r}")
        name = f"{m.group(1).lower()}{m.group(2)}"
        kernel = np.asarray(leaves["kernel"])
        if m.group(1) == "Conv":
            weight = kernel.transpose(3, 2, 0, 1)
        else:
            weight = kernel.T
        out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(weight))
        out[f"{name}.bias"] = torch.from_numpy(np.array(leaves["bias"]))
    return out


def _leaf_modules(prefix: str, tree: Mapping) -> Dict[str, torch.Tensor]:
    out = {}
    for module, leaves in tree.items():
        m = re.fullmatch(r"(Dense|LayerNorm|Embed)_(\d+)", module)
        if m is None:
            raise ValueError(f"no port counterpart for flax module {module!r}")
        kind, i = m.groups()
        name = f"{prefix}{kind.lower()}{i}"
        if kind == "Embed":
            out[f"{name}.weight"] = torch.from_numpy(np.array(leaves["embedding"]))
            continue
        weight = np.asarray(leaves["kernel"]).T if kind == "Dense" else leaves["scale"]
        out[f"{name}.weight"] = torch.from_numpy(np.array(weight))
        out[f"{name}.bias"] = torch.from_numpy(np.array(leaves["bias"]))
    return out


def lm_from_jax_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """``LongContextTransformer``'s flax tree -> the port's ``state_dict``."""
    top, out = {}, {}
    for module, leaves in tree.items():
        m = re.fullmatch(r"RingAttentionBlock_(\d+)", module)
        if m is None:
            top[module] = leaves
        else:
            out.update(_leaf_modules(f"blocks.{m.group(1)}.", leaves))
    out.update(_leaf_modules("", top))
    return out
