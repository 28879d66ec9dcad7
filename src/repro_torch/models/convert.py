"""Carry weights and caches across from the JAX package, through numpy.

The reference keeps its parameters in a nested dict: ``embed/table``,
``final_norm/scale``, ``head/w`` (absent with tied embeddings), then the
layers in sections (``head_layers/g*``, ``scan`` with a leading
``(n_groups,)`` axis on every leaf, ``tail``), each layer as
``l{i}/{mixer,ffn}/...``: attention (``wq``, ``wk``, ``wv``, ``wo``) or
Mamba-2 (``wz``, ``wx``, ..., ``A_log``, ``D``, ``dt_bias``) mixers, dense
(``norm``, ``mlp/*``) or MoE (``norm``, ``router``, ``experts/{wi_gate,
wi_up,wo}`` as (E, d, f)/(E, f, d), ``shared/*``) FFNs.  The port holds the
layers in one list in the same order (``transformer.layer_layout``) and
names each module after the reference's keys, so these helpers map one onto
the other leaf by leaf.  They take numpy arrays (bfloat16 arrays from
``ml_dtypes`` too) and return CPU tensors.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.models.transformer import layer_layout


def to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def flatten(tree, prefix=""):
    """(dotted name, leaf) pairs of a nested dict."""
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from flatten(val, name + ".")
        else:
            yield name, val


def _take(node, group):
    """``node`` with every leaf indexed at ``group`` on its leading (scan) axis."""
    if isinstance(node, dict):
        return {k: _take(v, group) for k, v in node.items()}
    return node if group is None else np.asarray(node)[group]


def _layer_node(tree, section, group, li):
    """Layer ``li`` of ``section``.  The reference's params nest a section
    name (``head_layers`` -> ``g0``); its caches key it whole
    (``"head_layers/g0"``)."""
    if section in tree:
        node = tree[section]
    else:
        node = tree
        for part in section.split("/"):
            node = node[part]
    return _take(node[f"l{li}"], group)


def params_from_jax(np_params, cfg) -> Dict[str, torch.Tensor]:
    """The reference's param tree -> a state dict for the port's ``Model``."""
    sd = {"embed.table": to_tensor(np_params["embed"]["table"]),
          "final_norm.scale": to_tensor(np_params["final_norm"]["scale"])}
    if not cfg.tie_embeddings:
        sd["head.w"] = to_tensor(np_params["head"]["w"])
    for idx, (section, group, li, _) in enumerate(layer_layout(cfg)):
        node = _layer_node(np_params, section, group, li)
        for name, leaf in flatten(node):
            sd[f"stack.layers.{idx}.{name}"] = to_tensor(leaf)
    return sd


def caches_from_jax(np_caches, cfg) -> List[Dict[str, torch.Tensor]]:
    """The reference's cache tree (e.g. ``scan/l0/{k,v}`` of shape
    (G, B, S, Hkv, dh), or ``scan/l0/{state,conv}``) -> the port's per-layer
    list of ``{"k", "v"}`` / ``{"state", "conv"}``."""
    return [{name: to_tensor(leaf) for name, leaf in
             flatten(_layer_node(np_caches, section, group, li))}
            for section, group, li, _ in layer_layout(cfg)]
