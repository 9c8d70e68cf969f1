"""Flax parameter tree -> PyTorch state_dict of the port's models.

Takes the JAX package's parameter tree as **nested dicts of numpy
arrays** (the caller converts with ``np.asarray``; nothing here imports
jax or flax) and returns tensors named as the port's modules name them:

* Dense ``kernel[in, out]`` -> ``weight[out, in]``;
* q/k/v DenseGeneral ``kernel[H, A, D]`` -> ``weight[A*D, H]``, ``bias[A, D]``
  -> ``bias[A*D]``; output DenseGeneral ``kernel[A, D, H]`` -> ``weight[H, A*D]``;
* LayerNorm ``scale`` -> ``weight``;
* ``embedding_table``, ``relative_emb_table[V, A, D]``,
  ``absolute_position_embeddings``, the pretraining model's untied
  ``mlm_embedding_table`` and the MLM/MPP heads' ``output_bias`` keep
  their layout;
* ``transformer/layer_<i>`` -> ``transformer.layers.<i>``,
  ``cls_head_<name>`` -> ``cls_heads.<name>``.

A leaf that no rule consumes raises.  Given ``model``, the result must
name exactly the model's parameters with their shapes, or this raises.
``flax_paths(model)`` is the inverse map: each port parameter's Flax path,
and ``flax_from_state_dict(state, model)`` the inverse conversion.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

_TABLES = ("embedding_table", "relative_emb_table", "absolute_position_embeddings",
           "mlm_embedding_table", "output_bias")
_QKV = ("query", "key", "value")


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _unflatten(flat: Mapping[tuple, np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return tree


def _module_path(parts) -> list:
    names = []
    for part in parts:
        layer = re.fullmatch(r"layer_(\d+)", part)
        head = re.fullmatch(r"cls_head_(.+)", part)
        if layer:
            names += ["layers", layer.group(1)]
        elif head:
            names += ["cls_heads", head.group(1)]
        else:
            names.append(part)
    return names


def _convert_leaf(path: tuple, value: np.ndarray):
    """(port name, array) for one Flax leaf, or raise if no rule applies."""
    *parents, leaf = path
    owner = parents[-1] if parents else ""
    if leaf in _TABLES:
        return _module_path(path), value
    if leaf == "scale":
        return _module_path(parents) + ["weight"], value
    if leaf == "bias":
        return _module_path(parents) + ["bias"], value.reshape(-1)
    if leaf == "kernel":
        if value.ndim == 2:
            return _module_path(parents) + ["weight"], value.T
        if value.ndim == 3 and owner in _QKV:
            return _module_path(parents) + ["weight"], value.reshape(value.shape[0], -1).T
        if value.ndim == 3 and owner == "output":
            return _module_path(parents) + ["weight"], value.reshape(-1, value.shape[-1]).T
    raise KeyError(f"unconsumed Flax leaf {'/'.join(path)} with shape {value.shape}")


def params_from_flax(tree: Mapping, model: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """Converts a Flax param tree (``{"params": ...}`` or its contents).

    With ``model``, raises if a model parameter is left unfilled, if a
    converted leaf has no model parameter, or if a shape differs.
    """
    if set(tree) == {"params"}:
        tree = tree["params"]
    state = {}
    for path, value in _flatten(tree).items():
        names, array = _convert_leaf(path, value)
        state[".".join(names)] = torch.tensor(np.asarray(array, np.float32))
    if model is not None:
        expected = {k: v.shape for k, v in model.state_dict().items()}
        unfilled = sorted(set(expected) - set(state))
        unconsumed = sorted(set(state) - set(expected))
        if unfilled or unconsumed:
            raise KeyError(
                f"Flax tree does not match the model: unfilled port parameters "
                f"{unfilled}, unconsumed Flax leaves {unconsumed}")
        for name, shape in expected.items():
            if state[name].shape != shape:
                raise ValueError(
                    f"{name}: converted shape {tuple(state[name].shape)} != {tuple(shape)}")
    return state


def _flax_module_path(names) -> list:
    parts, it = [], iter(names)
    for name in it:
        if name in ("layers", "cls_heads"):
            child = next(it)
            parts.append(f"layer_{child}" if name == "layers" else f"cls_head_{child}")
        else:
            parts.append(name)
    return parts


def flax_paths(model: nn.Module) -> Dict[str, str]:
    """Port parameter name -> the ``/``-joined Flax path that
    ``params_from_flax`` maps to it (without the ``params`` root):
    LayerNorm ``weight`` -> ``scale``, Linear ``weight`` -> ``kernel``."""
    out = {}
    for module_name, module in model.named_modules():
        for leaf, _ in module.named_parameters(recurse=False):
            flax_leaf = leaf
            if leaf == "weight" and isinstance(module, nn.LayerNorm):
                flax_leaf = "scale"
            elif leaf == "weight" and isinstance(module, nn.Linear):
                flax_leaf = "kernel"
            parts = module_name.split(".") if module_name else []
            name = ".".join(parts + [leaf])
            out[name] = "/".join(_flax_module_path(parts) + [flax_leaf])
    return out


def flax_from_state_dict(state: Mapping[str, torch.Tensor], model: nn.Module) -> dict:
    """The inverse of ``params_from_flax``: ``state`` (the port's tensors,
    named as ``model`` names its parameters) as the Flax parameter tree of
    nested dicts of float32 numpy arrays (without the ``params`` root), in
    Flax's layouts.  q/k/v ``weight[A*D, H]`` -> ``kernel[H, A, D]``,
    ``bias[A*D]`` -> ``bias[A, D]``, output ``weight[H, A*D]`` ->
    ``kernel[A, D, H]``, with ``A`` the owning attention module's
    ``num_heads``; the relative table is ``[V, A, D]`` in both."""
    flat = {}
    modules = dict(model.named_modules())
    for name, path in flax_paths(model).items():
        value = state[name].detach().to("cpu", torch.float32).numpy()
        parts = tuple(path.split("/"))
        # q/k/v/output are children of the attention module.
        heads = getattr(modules.get(name.rsplit(".", 2)[0]), "num_heads", None)
        if parts[-1] == "kernel":
            value = value.T
            if heads and parts[-2] in _QKV:
                value = value.reshape(value.shape[0], heads, -1)
            elif heads and parts[-2] == "output":
                value = value.reshape(heads, -1, value.shape[-1])
        elif parts[-1] == "bias" and heads and parts[-2] in _QKV:
            value = value.reshape(heads, -1)
        flat[parts] = np.ascontiguousarray(value)
    return _unflatten(flat)
