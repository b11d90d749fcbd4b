"""Carry the JAX package's model weights into the port's modules.

``from_jax_params`` takes the flax parameter tree of ``LeNet``,
``LogisticRegression`` or ``MLP6`` as nested dicts of numpy arrays (as
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

``resnet_from_jax_params`` takes a flax ``ResNet``'s ``params`` and
``batch_stats`` and gives the port's parameter and statistics dicts:
``conv_init`` / ``bn_init`` keep their names, ``BottleneckBlock_k`` or
``BasicBlock_k`` becomes ``blocks.k`` with its ``Conv_j`` / ``BatchNorm_j``
as ``conv{j}`` / ``bn{j}`` (``proj`` and ``proj_bn`` as they are), and
``Dense_0`` becomes ``dense``; conv kernels HWIO become OIHW, the dense
kernel ``[in, out]`` becomes ``[out, in]``, and a BN's ``scale`` becomes
``weight`` while its ``bias``, ``mean`` and ``var`` keep their names and
values.

The parallel strategies' parameters are rank-stacked over a
:class:`~torchmpi_tpu_torch.parallel.MeshLayout`:
``mplinear_from_jax`` gives an ``MPLinear``'s ``kernel [p, in / tp,
features]`` and ``bias [p, features]`` from flax's leaves: the full
``[in, features]`` kernel (as ``shard_map`` returns it under
``out_specs=P("tp")``) cut into tp shards, or ``[p, ...]`` per-device
shards as they are; and
``axis_stack_from_jax`` gives every rank its entry of a stack whose
leading dims are mesh axes: a pipeline's ``[pp, ...]`` stage stack, an
expert stack ``[ep, ...]``, or ``[pp, tp, ...]``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence, Tuple, Union

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


def _resnet_module_name(module: str) -> str:
    m = re.fullmatch(r"(?:BottleneckBlock|BasicBlock)_(\d+)", module)
    if m is not None:
        return f"blocks.{m.group(1)}"
    m = re.fullmatch(r"(Conv|BatchNorm)_(\d+)", module)
    if m is not None:
        return ("conv" if m.group(1) == "Conv" else "bn") + m.group(2)
    if module == "Dense_0":
        return "dense"
    if module in ("conv_init", "bn_init", "proj", "proj_bn"):
        return module
    raise ValueError(f"no port counterpart for flax module {module!r}")


def _resnet_leaves(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Flatten a flax ResNet tree to the port's dotted names."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_resnet_leaves(value, prefix + _resnet_module_name(key) + "."))
            continue
        value = np.asarray(value)
        if key == "kernel":
            # conv HWIO -> OIHW; dense [in, out] -> [out, in]
            value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
            key = "weight"
        elif key == "scale":
            key = "weight"
        elif key not in ("bias", "mean", "var"):
            raise ValueError(f"no port counterpart for flax leaf {prefix}{key!r}")
        out[prefix + key] = value
    return out


def resnet_from_jax_params(params: Mapping, batch_stats: Mapping
                           ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A flax ``ResNet``'s ``(params, batch_stats)`` -> the port's
    ``(params, batch_stats)`` dicts (CPU tensors)."""
    def tensors(tree):
        return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
                for k, v in _resnet_leaves(tree).items()}

    return tensors(params), tensors(batch_stats)


def axis_stack_from_jax(tree, layout, axes: Union[str, Sequence[str]] = "pp"):
    """A leaf (or a dict of leaves) whose leading dims are the sizes of the
    mesh ``axes``, in order -> rank-stacked ``[p, ...]``: rank r gets the
    entry at its coordinates along ``axes`` (the same on every rank of the
    other axes)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if isinstance(tree, Mapping):
        return {k: axis_stack_from_jax(v, layout, axes) for k, v in tree.items()}
    value = np.asarray(tree)
    sizes = tuple(layout.size(a) for a in axes)
    if value.shape[:len(axes)] != sizes:
        raise ValueError(f"leading dims {value.shape[:len(axes)]} are not the sizes {sizes} "
                         f"of axes {axes}")
    coords = tuple(layout.axis_index(a) for a in axes)
    return torch.from_numpy(np.ascontiguousarray(value[coords]))


def mplinear_from_jax(leaves: Mapping, layout, axis: str = "tp") -> Dict[str, torch.Tensor]:
    """flax ``MPLinear``'s ``{"kernel", "bias"}`` -> the port's
    ``MPLinear`` ``state_dict``. The kernel is the full ``[in, features]``
    (cut into ``layout.size(axis)`` shards over the input features, rank r
    taking the shard of its ``axis`` coordinate) or the per-device shards
    ``[p, in / tp, features]`` as they are; the bias ``[features]`` is
    given to every rank."""
    kernel = np.asarray(leaves["kernel"])
    tp, p = layout.size(axis), layout.num_ranks
    if kernel.ndim == 2:
        if kernel.shape[0] % tp:
            raise ValueError(f"MPLinear kernel {kernel.shape}: in not divisible by {axis}={tp}")
        shards = kernel.reshape(tp, kernel.shape[0] // tp, kernel.shape[1])
        kernel = np.asarray(axis_stack_from_jax(shards, layout, axis))
    elif kernel.ndim != 3 or kernel.shape[0] != p:
        raise ValueError(f"MPLinear kernel {kernel.shape}: want [in, features] or "
                         f"[{p}, in / {tp}, features]")
    out = {"kernel": torch.from_numpy(np.array(kernel, order="C"))}
    if "bias" in leaves:
        bias = np.asarray(leaves["bias"])
        out["bias"] = torch.from_numpy(np.array(np.broadcast_to(bias, (p,) + bias.shape[-1:])))
    return out
