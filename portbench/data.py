"""The cells' data: a frozen copy of the synthetic ogbn-products
generator, its cache inside the checkout, and each run's draws from
``--seed``.

The graph is the dataset. Its structure, labels and split come from the
configuration's ``graph`` entry, whose generator seed is fixed, so every
run of a cell trains on the same graph, as a training job does on its
dataset. ``--seed`` draws what a run varies: the features and the
initial weights (both on the card, in a few large calls), the program's
own seed (its dropout and its device sampler's draws) and each epoch's
permutation of the training ids.

:func:`synthetic_products` copies ``ogbn_products(with_feats=False)`` of
``dgl_operator_tpu_torch/graph/datasets.py`` (``_power_law_edges``, the
homophily rewiring, the reversed edges, ``_make_splits``), so that a
later change to the program's generator cannot move the yardstick. The
features follow the same construction (class centres plus 0.8 times
gaussian noise), drawn on the card instead of the host.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache")
# rows of the feature table finished a chunk at a time, so that no
# [N, D] temporary raises the run's peak memory
FEAT_CHUNK_ROWS = 1 << 18


def run_seeds(seed: int) -> Dict[str, int]:
    """The run's sub-seeds, each below 2^32, from ``--seed`` (any
    non-negative integer)."""
    words = np.random.SeedSequence(int(seed)).generate_state(4)
    return dict(zip(("weights", "features", "program", "order"),
                    (int(w) for w in words)))


# ----------------------------------------------------------------------
# the graph


def _power_law_edges(rng: np.random.Generator, num_nodes: int,
                     num_edges: int, alpha: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    dst = rng.choice(num_nodes, size=num_edges, p=probs).astype(np.int32)
    src = rng.integers(0, num_nodes, size=num_edges, dtype=np.int32)
    keep = src != dst
    return src[keep], dst[keep]


def synthetic_products(spec: Dict) -> Dict[str, np.ndarray]:
    """The graph of ``spec`` (a configuration's ``graph`` entry):
    ``src``, ``dst`` (int32, every generated edge and its reverse),
    ``labels`` (int32) and ``train_ids`` (int64, ascending)."""
    n, e = int(spec["num_nodes"]), int(spec["num_edges"])
    classes = int(spec["num_classes"])
    rng = np.random.default_rng(int(spec["seed"]))
    labels = rng.integers(0, classes, size=n)
    src, dst = _power_law_edges(rng, n, e, float(spec["alpha"]))
    same = rng.random(len(src)) < float(spec["homophily"])
    by_label = [np.nonzero(labels == c)[0] for c in range(classes)]
    src_label = labels[src]
    for c in range(classes):
        sel = np.nonzero(same & (src_label == c))[0]
        if len(sel) and len(by_label[c]):
            dst[sel] = rng.choice(by_label[c], size=len(sel))
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    perm = rng.permutation(n)
    train = np.sort(perm[:int(n * float(spec["train_frac"]))])
    return {"src": src.astype(np.int32), "dst": dst.astype(np.int32),
            "labels": labels.astype(np.int32),
            "train_ids": train.astype(np.int64)}


def graph_key(spec: Dict) -> str:
    """The cache key of a ``graph`` entry: a hash of its parameters."""
    blob = json.dumps(spec, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def load_graph(spec: Dict, cache: Optional[str] = None
               ) -> Dict[str, np.ndarray]:
    """:func:`synthetic_products` of ``spec``, from the cache directory
    ``<cache>/graphs/<graph_key>`` (``cache`` defaults to ``CACHE``)
    when a run in this checkout has made it, else generated and written
    there (by a rename, so a reader sees all of it or none)."""
    final = os.path.join(cache or CACHE, "graphs", graph_key(spec))
    names = ("src", "dst", "labels", "train_ids")
    if os.path.isdir(final):
        return {k: np.load(os.path.join(final, k + ".npy")) for k in names}
    arrays = synthetic_products(spec)
    tmp = f"{final}.part{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    for k in names:
        np.save(os.path.join(tmp, k + ".npy"), arrays[k])
    with open(os.path.join(tmp, "graph.json"), "w") as f:
        json.dump(spec, f, sort_keys=True)
    try:
        os.rename(tmp, final)
    except OSError:            # another run finished first
        shutil.rmtree(tmp, ignore_errors=True)
    return arrays


# ----------------------------------------------------------------------
# the run's draws


def fill_features(out: torch.Tensor, labels: torch.Tensor, seed: int,
                  noise: float) -> torch.Tensor:
    """Fill ``out`` ``[N, D]`` in place with class centres plus
    ``noise`` times gaussian noise, drawn on ``out``'s device from
    ``seed`` (the centres ``[C, D]`` first, then the noise in one call);
    ``labels`` ``[N]`` on the same device picks each row's centre.
    The same seed gives the same table on the same device."""
    gen = torch.Generator(device=out.device).manual_seed(int(seed))
    classes = int(labels.max()) + 1
    centers = torch.randn((classes, out.shape[1]), generator=gen,
                          device=out.device, dtype=out.dtype)
    out.normal_(generator=gen)
    for s in range(0, out.shape[0], FEAT_CHUNK_ROWS):
        e = min(s + FEAT_CHUNK_ROWS, out.shape[0])
        out[s:e].mul_(noise).add_(centers.index_select(
            0, labels[s:e].long()))
    return out


def init_weights(spec: Sequence[Tuple[str, Tuple[int, ...], str, float]],
                 seed: int, device) -> Dict[str, torch.Tensor]:
    """Initial weights of a model kind's ``param_spec`` (``(name, shape,
    init, bound)``): one uniform draw on ``device`` from ``seed`` for
    every ``"uniform"`` leaf together, each leaf scaled to
    ``[-bound, bound]``; ``"zeros"`` leaves draw nothing."""
    drawn = [(n, s, b) for n, s, init, b in spec if init == "uniform"]
    total = sum(int(np.prod(s)) for _, s, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0,
                                                      generator=gen)
    out, at = {}, 0
    for name, shape, bound in drawn:
        size = int(np.prod(shape))
        out[name] = (flat[at:at + size] * bound).view(shape).clone()
        at += size
    for name, shape, init, _ in spec:
        if init == "zeros":
            out[name] = torch.zeros(shape, device=device)
    return {name: out[name] for name, _, _, _ in spec}


def epoch_orders(train_ids: np.ndarray, seed: int):
    """Each epoch's permutation of ``train_ids``, from one numpy stream
    seeded with ``seed``."""
    rng = np.random.default_rng(int(seed))
    while True:
        yield rng.permutation(train_ids)

