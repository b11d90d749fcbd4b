"""Carry the JAX package's MNIST model weights into the port's modules.

``from_jax_params`` takes the flax parameter tree of ``LeNet`` or
``LogisticRegression`` as nested dicts of numpy arrays (as
``jax.device_get`` returns it) and gives the matching ``state_dict`` of the
port's module: flax's ``Conv_i`` / ``Dense_i`` become ``conv{i}`` /
``dense{i}``, conv kernels ``[kh, kw, in, out]`` become ``[out, in, kh,
kw]``, and dense kernels ``[in, out]`` become ``[out, in]``. The port's
LeNet flattens channels-last like flax, so no row permutation is needed.
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
