"""Model weights as npz archives that either package reads — the torch
port of pyp_tpu/models/io.py.

The JAX package flattens a flax parameter tree with `jax.tree.flatten`
and writes its leaves as `p0`, `p1`, ... beside `_treedef` and
`_meta_<key>` entries; its `load_params` reads back only `p{i}` (in a
template's leaf order) and `_meta_*`. Here a module's state dict stands
for the tree: the key `ConvBlock_0.Conv_0.kernel` is the flax path
("params", "ConvBlock_0", "Conv_0", "kernel"), the layer kind comes from
the layer's flax name, and the kernels change layout on the way
(conv (out, in, *k) <-> (*k, in, out); transposed conv flipped,
(in, out, *k) <-> (*k, in, out); dense (out, in) <-> (in, out)). The leaf
order is flax's: dict keys sorted as strings at every level, so
`ConvBlock_0` < `ConvTranspose_0` < `Conv_0` and `bias` < `kernel` <
`scale`. A tuple of state dicts (the heterogeneity model's encoder and
decoder) is flattened element by element, as jax flattens a tuple.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch


def _kind(path) -> str:
    """The flax layer class of a leaf: its parent's name without `_i`."""
    return re.sub(r"_\d+$", "", path[-2]) if len(path) > 1 else ""


def _to_flax_leaf(path, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if path[-1] != "kernel":
        return a
    kind = _kind(path)
    if kind == "Dense":
        return np.ascontiguousarray(a.T)
    nd = a.ndim - 2
    if kind == "ConvTranspose":
        a = np.flip(a, axis=tuple(range(2, 2 + nd)))
        return np.moveaxis(a, (0, 1), (nd, nd + 1)).copy(order="C")
    # Conv: (out, in, *k) -> (*k, in, out)
    return np.ascontiguousarray(np.moveaxis(a, (1, 0), (nd, nd + 1)))


def _from_flax_leaf(path, a) -> torch.Tensor:
    a = np.asarray(a, dtype=np.float32)
    if path[-1] == "kernel":
        kind = _kind(path)
        if kind == "Dense":
            a = a.T
        else:
            nd = a.ndim - 2
            if kind == "ConvTranspose":
                a = np.moveaxis(a, (nd, nd + 1), (0, 1))
                a = np.flip(a, axis=tuple(range(2, 2 + nd)))
            else:
                a = np.moveaxis(a, (nd, nd + 1), (1, 0))
    # a copy: flipping a length-1 axis leaves a negative stride
    return torch.from_numpy(a.copy(order="C"))


def _state(x) -> Mapping:
    return x.state_dict() if isinstance(x, torch.nn.Module) else x


def _paths(state: Mapping):
    """(flax path, state-dict key) pairs in flax's leaf order."""
    return sorted((("params",) + tuple(k.split(".")), k) for k in state)


def _parts(params):
    """A state dict (or module) alone, or a tuple of them."""
    if isinstance(params, (tuple, list)):
        return [_state(p) for p in params], True
    return [_state(params)], False


def _leaves(params):
    parts, _ = _parts(params)
    return [_to_flax_leaf(path, state[key])
            for state in parts for path, key in _paths(state)]


def to_flax(state) -> dict:
    """A state dict (or module) as flax's nested parameter dict of numpy
    arrays in flax's layout: {"params": {...}}."""
    tree: dict = {}
    for path, key in _paths(_state(state)):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _to_flax_leaf(path, _state(state)[key])
    return tree


def from_flax(tree) -> "OrderedDict[str, torch.Tensor]":
    """A flax parameter tree (nested dicts of arrays, as `model.init`
    returns them, with or without the top "params" level) as a state
    dict in torch's layout."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    out = OrderedDict()

    def walk(node, path):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, Mapping):
                walk(v, path + (k,))
            else:
                out[".".join(path + (k,))] = _from_flax_leaf(
                    ("params",) + path + (k,), np.asarray(v))

    walk(tree, ())
    return out


def _treedef_str(params) -> str:
    """`str(treedef)` of the flax tree, as jax prints it."""

    def render(node):
        if not isinstance(node, dict):
            return "*"
        return "{" + ", ".join(f"'{k}': {render(node[k])}"
                               for k in sorted(node)) + "}"

    parts, is_tuple = _parts(params)
    trees = [render(to_flax(s)) for s in parts]
    body = "(" + ", ".join(trees) + ")" if is_tuple else trees[0]
    return f"PyTreeDef({body})"


def save_params(params, path, **meta):
    """Write a state dict (or module, or a tuple of them) as the JAX
    package's `save_params` writes the matching flax tree."""
    arrays = {f"p{i}": a for i, a in enumerate(_leaves(params))}
    arrays["_treedef"] = np.frombuffer(_treedef_str(params).encode(),
                                       dtype=np.uint8)
    for k, v in meta.items():
        arrays[f"_meta_{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_params(path, like):
    """Load into the structure of `like` (a state dict or module, or a
    tuple of them, e.g. of freshly built models). Returns (state dict or
    tuple of them, meta)."""
    parts, is_tuple = _parts(like)
    with np.load(path) as z:
        meta = {k[6:]: z[k] for k in z.files if k.startswith("_meta_")}
        out, i = [], 0
        for state in parts:
            sd = OrderedDict()
            for p, key in _paths(state):
                sd[key] = _from_flax_leaf(p, z[f"p{i}"])
                i += 1
            out.append(OrderedDict((k, sd[k]) for k in state))
    return (tuple(out) if is_tuple else out[0]), meta
