"""Params-only serving exports, in the JAX package's format.

An export is an ``.npz`` archive whose keys are the '/'-joined paths of
a nested params dict (``params/FanoutSAGEConv_0/self/kernel``, ...),
written atomically, with a ``.sha256`` sidecar that :func:`load_params`
verifies. Either package reads what the other wrote; the tree keeps the
flax layout (``models/sage.py`` converts it to and from a
``state_dict``). Training checkpoints come with the trainer.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Dict

import numpy as np
import torch

from dgl_operator_tpu_torch.obs import get_obs

SERVING_EXPORT = "serving_params.npz"


class CheckpointCorrupt(RuntimeError):
    """An export failed verification (checksum mismatch against its
    sidecar). Serving torn or corrupted weights is refused loudly."""


def _sha256_of(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return h.hexdigest()
            h.update(b)


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        # sorted keys: the leaf order jax's tree flattening gives
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}/{k}" if prefix else str(k), out)
        return
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    out[prefix] = np.asarray(tree)


def _write_tree_npz(path: str, tree: Any) -> int:
    """Atomic path-keyed npz write of a nested dict of arrays (numpy or
    tensors); returns the leaf count."""
    arrays: Dict[str, np.ndarray] = {}
    _flatten(tree, "", arrays)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return len(arrays)


def _read_tree_npz(path: str) -> Any:
    """Rebuild the nested dict a :func:`_write_tree_npz` archive
    describes (keys split on '/')."""
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return out


def _write_sidecar(path: str) -> str:
    """(Re)write ``path``'s sha256 sidecar atomically; returns the
    digest."""
    digest = _sha256_of(path)
    stmp = path + ".sha256.tmp"
    with open(stmp, "w") as f:
        f.write(digest + "\n")
    os.replace(stmp, path + ".sha256")
    return digest


def export_for_serving(path: str, params: Any) -> str:
    """Write the params tree alone, keyed by tree path, atomically, plus
    a sha256 sidecar. ``path`` may be a directory (the file is then
    ``serving_params.npz`` inside it). Returns the file path written."""
    if path.endswith(os.sep) or os.path.isdir(path):
        path = os.path.join(path, SERVING_EXPORT)
    n = _write_tree_npz(path, params)
    _write_sidecar(path)
    get_obs().emit("serving_export", path=path, leaves=n)
    return path


def load_params(path: str) -> Any:
    """Load an export back into the nested params dict of numpy arrays.
    ``path`` may be the file or its directory. A sha256 sidecar, when
    present, is verified; sidecar-less archives load unverified."""
    if os.path.isdir(path):
        path = os.path.join(path, SERVING_EXPORT)
    sidecar = path + ".sha256"
    if os.path.exists(sidecar):
        try:
            with open(sidecar) as f:
                expected = f.read().strip().split()[0]
        except (OSError, IndexError):
            expected = ""
        if expected and _sha256_of(path) != expected:
            raise CheckpointCorrupt(
                f"{path}: sha256 mismatch against its sidecar "
                "(torn or corrupted serving export)")
    return _read_tree_npz(path)
