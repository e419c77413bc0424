"""Weights across the packages: flax params trees and state dicts.

A flax tree holds one entry per layer, ``<Prefix>_<i>`` (the flax
module's class name and index: ``FanoutSAGEConv_0``, ``GATConv_1``),
whose leaves are either a Dense's ``{"kernel": [in, out], "bias":
[out]}`` or a raw parameter (``attn_l``, a GraphConv's ``bias``). The
port's models keep their layers in ``layers``, named as the flax
leaves, so ``<Prefix>_<i>/<sub>/kernel`` is ``layers.<i>.<sub>.weight``
transposed and ``<Prefix>_<i>/<name>`` is ``layers.<i>.<name>``.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

_LAYER_RE = re.compile(r"(.+)_(\d+)")


def layer_prefix(tree) -> str:
    """The one layer prefix of a flax params tree (with or without the
    top-level ``"params"`` key); raises if its entries disagree."""
    params = tree.get("params", tree)
    found = set()
    for name in params:
        m = _LAYER_RE.fullmatch(name)
        if m is None:
            raise ValueError(f"unexpected params entry {name!r}; expected "
                             "<Prefix>_<i>")
        found.add(m.group(1))
    if len(found) != 1:
        raise ValueError(f"a params tree of one layer family expected, got "
                         f"prefixes {sorted(found)}")
    return found.pop()


def state_dict_from_flax(tree, prefix: Optional[str] = None
                         ) -> Dict[str, torch.Tensor]:
    """The state dict of a flax params tree (numpy leaves, with or
    without the top-level ``"params"`` key) whose entries are
    ``<prefix>_<i>`` (any one prefix when None). A flax kernel is ``[in,
    out]``; a ``Linear`` weight is its transpose."""
    params = tree.get("params", tree)
    sd: Dict[str, torch.Tensor] = {}
    for name, layer in params.items():
        m = _LAYER_RE.fullmatch(name)
        if m is None or (prefix is not None and m.group(1) != prefix):
            raise ValueError(f"unexpected params entry {name!r}; expected "
                             f"{prefix or '<Prefix>'}_<i>")
        for sub, leaves in layer.items():
            key = f"layers.{m.group(2)}.{sub}"
            if not isinstance(leaves, dict):
                sd[key] = torch.from_numpy(np.array(leaves, np.float32))
                continue
            sd[f"{key}.weight"] = torch.from_numpy(np.ascontiguousarray(
                np.asarray(leaves["kernel"], np.float32).T))
            if "bias" in leaves:
                sd[f"{key}.bias"] = torch.from_numpy(
                    np.array(leaves["bias"], np.float32))
    return sd


def state_dict_to_flax(state_dict: Dict[str, torch.Tensor], prefix: str
                       ) -> dict:
    """The flax params tree (numpy leaves, under ``"params"``) of a
    state dict, its layers named ``<prefix>_<i>`` — the inverse of
    :func:`state_dict_from_flax`."""
    params: dict = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        arr = value.detach().cpu().float().numpy()
        layer = params.setdefault(f"{prefix}_{parts[1]}", {})
        if len(parts) == 3:
            layer[parts[2]] = arr.copy()
            continue
        node = layer.setdefault(parts[2], {})
        if parts[3] == "weight":
            node["kernel"] = np.ascontiguousarray(arr.T)
        else:
            node["bias"] = arr.copy()
    return {"params": params}
