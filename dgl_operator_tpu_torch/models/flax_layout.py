"""Weights across the packages: flax params trees and state dicts.

A flat flax tree holds one entry per layer, ``<Prefix>_<i>`` (the flax
module's class name and index: ``FanoutSAGEConv_0``, ``GATConv_1``,
``Dense_0``), whose leaves are a Dense's ``{"kernel": [in, out],
"bias": [out]}``, raw parameters (``attn_l``, a GraphConv's ``bias``),
or the layer's own kernel and bias when the layer is a Dense. The
port's models keep their layers in ``layers``, named as the flax
leaves, so ``<Prefix>_<i>/<sub>/kernel`` is ``layers.<i>.<sub>.weight``
transposed, ``<Prefix>_<i>/<name>`` is ``layers.<i>.<name>`` and
``Dense_<i>/kernel`` is ``layers.<i>.weight`` transposed.

A nested tree (``LinkPredModel``: ``GraphSAGE_0/SAGEConv_<i>`` and
``MLPPredictor_0/Dense_<j>``) maps each top-level entry to a child
module holding a flat stack. Its layout is a dict ``{child: (flax name,
layer prefix)}``; a flat model's layout is its layer prefix. A model
whose tree holds more than stacks of layers (``RGCNLinkPredict``'s
tables, ``GIN``'s adopted MLPs) brings its own :class:`Converter` as
its layout.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, NamedTuple, Optional, Set, Tuple, Union

import numpy as np
import torch

_LAYER_RE = re.compile(r"(.+)_(\d+)")


class Converter(NamedTuple):
    """A model's own converters: ``from_flax(tree) -> state dict`` and
    ``to_flax(state dict) -> tree`` (numpy leaves, under ``"params"``)."""

    from_flax: Callable[[dict], Dict[str, torch.Tensor]]
    to_flax: Callable[[Dict[str, torch.Tensor]], dict]


# a flat stack's layer prefix, a nested model's children, or a model's
# own converters
Layout = Union[str, Dict[str, Tuple[str, str]], Converter]


def prefixes(tree) -> Set[str]:
    """The layer prefixes of a flax params tree's top-level entries
    (with or without the top-level ``"params"`` key)."""
    found = set()
    for name in tree.get("params", tree):
        m = _LAYER_RE.fullmatch(name)
        if m is None:
            raise ValueError(f"unexpected params entry {name!r}; expected "
                             "<Prefix>_<i>")
        found.add(m.group(1))
    return found


def layer_prefix(tree) -> str:
    """The one layer prefix of a flax params tree; raises if its entries
    disagree."""
    found = prefixes(tree)
    if len(found) != 1:
        raise ValueError(f"a params tree of one layer family expected, got "
                         f"prefixes {sorted(found)}")
    return found.pop()


def _array(leaf) -> torch.Tensor:
    return torch.from_numpy(np.array(leaf, np.float32))


def _kernel(leaf) -> torch.Tensor:
    """A flax kernel ``[in, out]`` as a ``Linear`` weight ``[out, in]``."""
    return torch.from_numpy(np.array(np.asarray(leaf, np.float32).T,
                                     order="C"))


def state_dict_from_flax(tree, prefix: Optional[Layout] = None
                         ) -> Dict[str, torch.Tensor]:
    """The state dict of a flax params tree (numpy leaves, with or
    without the top-level ``"params"`` key): a flat tree whose entries
    are ``<prefix>_<i>`` (any one prefix when None), or a nested tree by
    its layout, or by a model's own :class:`Converter`."""
    if isinstance(prefix, Converter):
        return prefix.from_flax(tree)
    params = tree.get("params", tree)
    sd: Dict[str, torch.Tensor] = {}
    if isinstance(prefix, dict):
        children = {name: (child, sub)
                    for child, (name, sub) in prefix.items()}
        for name, node in params.items():
            if name not in children:
                raise ValueError(f"unexpected params entry {name!r}; "
                                 f"expected one of {sorted(children)}")
            child, sub = children[name]
            sd.update({f"{child}.{k}": v for k, v in
                       state_dict_from_flax(node, sub).items()})
        return sd
    for name, layer in params.items():
        m = _LAYER_RE.fullmatch(name)
        if m is None or (prefix is not None and m.group(1) != prefix):
            raise ValueError(f"unexpected params entry {name!r}; expected "
                             f"{prefix or '<Prefix>'}_<i>")
        for sub, leaves in layer.items():
            key = f"layers.{m.group(2)}.{sub}"
            if sub == "kernel":                 # the layer is a Dense
                sd[f"layers.{m.group(2)}.weight"] = _kernel(leaves)
            elif not isinstance(leaves, dict):
                sd[key] = _array(leaves)
            else:
                sd[f"{key}.weight"] = _kernel(leaves["kernel"])
                if "bias" in leaves:
                    sd[f"{key}.bias"] = _array(leaves["bias"])
    return sd


def state_dict_to_flax(state_dict: Dict[str, torch.Tensor], prefix: Layout
                       ) -> dict:
    """The flax params tree (numpy leaves, under ``"params"``) of a
    state dict, its layers named ``<prefix>_<i>`` (or, for a nested
    layout, each child's stack under its flax name) — the inverse of
    :func:`state_dict_from_flax`."""
    if isinstance(prefix, Converter):
        return prefix.to_flax(state_dict)
    params: dict = {}
    if isinstance(prefix, dict):
        rest = set(state_dict)
        for child, (name, sub) in prefix.items():
            part = {k[len(child) + 1:]: v for k, v in state_dict.items()
                    if k.startswith(child + ".")}
            rest -= {f"{child}.{k}" for k in part}
            if part:
                params[name] = state_dict_to_flax(part, sub)["params"]
        if rest:
            raise ValueError(f"state dict keys outside the layout "
                             f"{sorted(prefix)}: {sorted(rest)}")
        return {"params": params}
    for key, value in state_dict.items():
        parts = key.split(".")
        arr = value.detach().cpu().float().numpy()
        layer = params.setdefault(f"{prefix}_{parts[1]}", {})
        if len(parts) == 3:
            if parts[2] == "weight":            # the layer is a Linear
                layer["kernel"] = np.ascontiguousarray(arr.T)
            else:
                layer[parts[2]] = arr.copy()
            continue
        node = layer.setdefault(parts[2], {})
        if parts[3] == "weight":
            node["kernel"] = np.ascontiguousarray(arr.T)
        else:
            node["bias"] = arr.copy()
    return {"params": params}


def flax_path(key: str, prefix: str) -> Tuple[str, ...]:
    """The flax params path of the state dict key ``key`` of a flat
    stack of layers ``<prefix>_<i>`` (the layout of
    :func:`state_dict_to_flax`)."""
    parts = key.split(".")
    layer = f"{prefix}_{parts[1]}"
    if len(parts) == 3:
        return (layer, "kernel") if parts[2] == "weight" else (layer,
                                                                parts[2])
    return (layer, parts[2], "kernel" if parts[3] == "weight" else "bias")


def first_flax_param(model: torch.nn.Module) -> Tuple[str, torch.Tensor]:
    """The parameter holding the first leaf of ``model``'s flax params
    tree in flatten order (keys sorted at every level), with its name. A
    model of a flat stack (a string ``flax_prefix``) only."""
    prefix = getattr(model, "flax_prefix", None)
    if not isinstance(prefix, str):
        raise TypeError(f"{type(model).__name__} is not a flat stack of "
                        "layers")
    params = dict(model.named_parameters())
    name = min(params, key=lambda k: flax_path(k, prefix))
    return name, params[name]
