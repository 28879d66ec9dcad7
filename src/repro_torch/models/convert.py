"""Carry weights and caches across from the JAX package, through numpy.

The reference keeps its parameters in a nested dict: ``embed/table``,
``final_norm/scale``, ``head/w`` (absent with tied embeddings),
``frontend/proj`` (vision and audio archs only), then the
layers in sections (``head_layers/g*``, ``scan`` with a leading
``(n_groups,)`` axis on every leaf, ``tail``), each layer as
``l{i}/{mixer,ffn}/...``: attention (``wq``, ``wk``, ``wv``, ``wo``) or
Mamba-2 (``wz``, ``wx``, ..., ``A_log``, ``D``, ``dt_bias``) mixers, dense
(``norm``, ``mlp/*``) or MoE (``norm``, ``router``, ``experts/{wi_gate,
wi_up,wo}`` as (E, d, f)/(E, f, d), ``shared/*``) FFNs.  The port holds the
layers in one list in the same order (``transformer.layer_layout``) and
names each module after the reference's keys, so these helpers map one onto
the other leaf by leaf.  They take numpy arrays (bfloat16 arrays from
``ml_dtypes`` too) or CPU tensors and return CPU tensors.

A training state carries trees shaped like the parameters (AdamW's ``m``
and ``v``, the error feedback ``ef``) or with a dict of slots at each
parameter's place (Adafactor's ``{"vr", "vc"}`` or ``{"v"}``);
``params_from_jax`` maps any of them, and ``train_state_from_jax`` a whole
state as the reference's ``CheckpointManager`` writes it (where Adafactor
factors a scanned stack of vectors, its shared column moment too).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.models.transformer import layer_layout


def to_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.require(a, requirements="C").view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.require(a, requirements="C").copy())


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
    if group is None:
        return node
    return node[group] if isinstance(node, torch.Tensor) else np.asarray(node)[group]


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


_TOP = ("embed", "final_norm", "head", "frontend")


def layer_prefixes(cfg) -> List[str]:
    """Per port layer, the reference's path to it: ``scan/l{i}``,
    ``head_layers/g{j}/l{i}`` or ``tail/l{i}`` (a scanned leaf also carries
    the leading group axis)."""
    return [f"{section}/l{li}" for section, _, li, _ in layer_layout(cfg)]


def reference_path(name: str, prefixes: List[str]) -> str:
    """A port parameter (or per-layer cache) name -> the reference's "/"-joined
    path of its leaf, e.g. ``stack.layers.3.mixer.wq`` -> ``scan/l1/mixer/wq``
    (``prefixes`` from ``layer_prefixes``)."""
    if name.startswith("stack.layers."):
        idx, rest = name[len("stack.layers."):].split(".", 1)
        return f"{prefixes[int(idx)]}/{rest.replace('.', '/')}"
    return name.replace(".", "/")


def params_from_jax(np_tree, cfg) -> Dict[str, torch.Tensor]:
    """The reference's param tree (or one shaped like it: gradients, AdamW's
    moments) -> a state dict for the port's ``Model``; where the tree holds
    a dict of slots at a parameter's place, each slot becomes
    ``<name>.<slot>``."""
    sd = {}
    for top in _TOP:
        if top in np_tree:
            sd.update((name, to_tensor(leaf)) for name, leaf in flatten(np_tree[top], top + "."))
    for idx, (section, group, li, _) in enumerate(layer_layout(cfg)):
        node = _layer_node(np_tree, section, group, li)
        for name, leaf in flatten(node):
            sd[f"stack.layers.{idx}.{name}"] = to_tensor(leaf)
    return sd


def unflatten(flat: Dict[str, object], sep: str = "/") -> Dict[str, object]:
    """``{"a/b/c": leaf}`` -> ``{"a": {"b": {"c": leaf}}}``."""
    tree: Dict[str, object] = {}
    for key, leaf in flat.items():
        node = tree
        *parents, last = key.split(sep)
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def _slots(flat: Dict[str, torch.Tensor], names) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"<param>.<slot>": t}`` -> ``{param: {slot: t}}`` for known params."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, t in flat.items():
        name, slot = key.rsplit(".", 1)
        if name not in names:
            raise KeyError(f"optimizer slot {key!r} names no parameter")
        out.setdefault(name, {})[slot] = t
    return out


def _copy_dicts(tree):
    return {k: _copy_dicts(v) if isinstance(v, dict) else v for k, v in tree.items()}


def _shared_column_moments(np_state, cfg):
    """Adafactor's slots with the column moments of scanned stacks of
    vectors taken out: (the reference's slot tree without them, {port slot
    key: vc}).  The reference factors a (G, d) stack of vectors with vr
    (G,) and one vc (d,) for the whole stack, which must not be indexed
    per group like every other scanned leaf; the port keeps it whole in
    the slots of the stack's first layer (``train.optimizer.adafactor``)."""
    slots = _copy_dicts(np_state["opt"]["slots"])
    shared = {}
    for idx, (section, group, li, _) in enumerate(layer_layout(cfg)):
        if group != 0:
            continue
        layer_params = dict(flatten(_layer_node(np_state["params"], section, None, li)))
        node = slots
        for part in ([section] if section in slots else section.split("/")):
            node = node[part]
        node = node[f"l{li}"]                       # in the copy, not through _take
        for name, leaf in list(flatten(node)):
            path, slot = name.rsplit(".", 1)
            if slot == "vc" and np.ndim(layer_params[path]) == 2:      # a stacked vector
                shared[f"stack.layers.{idx}.{name}"] = to_tensor(leaf)
                parent = node
                for part in path.split("."):
                    parent = parent[part]
                del parent["vc"]
    return slots, shared


def train_state_from_jax(np_state, cfg) -> Dict[str, object]:
    """The reference's train state (``{"params", "opt", "step", ["ef"]}``,
    nested dicts of numpy arrays, e.g. ``unflatten`` of a checkpoint's
    leaves) -> the port's: ``params`` and ``ef`` keyed by parameter name,
    AdamW's ``opt`` as ``{"m": {name: t}, "v": {name: t}}`` and
    Adafactor's as ``{"slots": {name: {"vr", "vc"} | {"vr"} | {"v"}}}``
    (a factored stack of vectors: a 0-d ``vr`` for each layer, its ``vc``
    with the first layer's)."""
    params = params_from_jax(np_state["params"], cfg)
    opt = np_state["opt"]
    if "slots" in opt:
        slots, shared = _shared_column_moments(np_state, cfg)
        port_opt = {"slots": _slots({**params_from_jax(slots, cfg), **shared}, params)}
    else:
        port_opt = {k: params_from_jax(v, cfg) for k, v in opt.items()}
    out = {"params": params, "opt": port_opt, "step": to_tensor(np_state["step"])}
    if "ef" in np_state:
        out["ef"] = params_from_jax(np_state["ef"], cfg)
    return out


def caches_from_jax(np_caches, cfg) -> List[Dict[str, torch.Tensor]]:
    """The reference's cache tree (e.g. ``scan/l0/{k,v}`` of shape
    (G, B, S, Hkv, dh), or ``scan/l0/{state,conv}``) -> the port's per-layer
    list of ``{"k", "v"}`` / ``{"state", "conv"}``."""
    return [{name: to_tensor(leaf) for name, leaf in
             flatten(_layer_node(np_caches, section, group, li))}
            for section, group, li, _ in layer_layout(cfg)]
