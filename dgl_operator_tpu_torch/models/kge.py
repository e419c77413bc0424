"""The knowledge-graph-embedding model (the DGL-KE capability).

The counterpart of the JAX package's ``models/kge.py``: entity and
relation tables, a scorer from ``nn/kge.py`` and the logsigmoid loss
over chunked negatives with optional self-adversarial weighting (DGL-KE
``-adv``). Lookups go through ``ops/gather.py::gather_rows``, so on a
card they run the hand-written kernel.

Tables cross between the packages as numpy arrays:
:func:`kge_state_from_numpy` takes the JAX trainers' ``params`` and
``opt_state`` dicts or a JAX ``DistKGETrainer.state_dict()`` and returns
the port's tensors, in the layout of the port's ``state_dict``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dgl_operator_tpu_torch._device import DeviceLike, resolve_device
from dgl_operator_tpu_torch.nn import kge as K
from dgl_operator_tpu_torch.ops.gather import gather_rows

STATE_KEYS = ("entity", "entity_state", "relation", "relation_state")


@dataclasses.dataclass
class KGEConfig:
    model_name: str = "ComplEx"
    n_entities: int = 0
    n_relations: int = 0
    hidden_dim: int = 400          # the reference job's dim
    gamma: float = 12.0
    neg_sample_size: int = 256
    neg_adversarial_sampling: bool = False
    adversarial_temperature: float = 1.0
    emb_init: float = 0.0          # 0 -> (gamma + 2) / hidden_dim

    def emb_init_range(self) -> float:
        return self.emb_init or (self.gamma + 2.0) / self.hidden_dim


def relation_dim(cfg: KGEConfig) -> int:
    """Relation row width for ``cfg.model_name`` (``nn/kge.py``)."""
    return K.relation_dim(cfg.model_name, cfg.hidden_dim)


def init_kge_params(cfg: KGEConfig, generator: torch.Generator,
                    device: DeviceLike = "cpu") -> Dict[str, torch.Tensor]:
    """``{"entity": [Ne, D], "relation": [Nr, relation_dim]}`` drawn
    uniform in ``+-emb_init_range()`` from ``generator`` (a CPU generator:
    the entity table first, then the relation table), then moved to
    ``device``, so every device and process draws the same tables."""
    init = cfg.emb_init_range()
    out = {}
    for name, shape in (("entity", (cfg.n_entities, cfg.hidden_dim)),
                        ("relation", (cfg.n_relations, relation_dim(cfg)))):
        t = torch.empty(shape, dtype=torch.float32)
        t.uniform_(-init, init, generator=generator)
        out[name] = t.to(resolve_device(device))
    return out


def kge_state_from_numpy(params: Mapping, opt_state: Optional[Mapping] = None,
                         device: DeviceLike = "cpu"
                         ) -> Dict[str, torch.Tensor]:
    """The port's training state from the JAX package's numpy arrays.

    ``params`` is ``{"entity", "relation"}`` (a JAX ``KGETrainer``'s
    ``params``, or ``gathered_params()``) with ``opt_state`` its
    ``{"entity", "relation"}`` Adagrad sums (zeros when None), or a JAX
    ``DistKGETrainer.state_dict()``, which holds all four arrays. Returns
    contiguous float32 tensors on ``device`` under :data:`STATE_KEYS`."""
    if "entity_state" in params:
        arrays = {k: params[k] for k in STATE_KEYS}
    else:
        ent, rel = np.asarray(params["entity"]), np.asarray(params["relation"])
        if opt_state is None:
            opt_state = {"entity": np.zeros(len(ent), np.float32),
                         "relation": np.zeros(len(rel), np.float32)}
        arrays = {"entity": ent, "entity_state": opt_state["entity"],
                  "relation": rel, "relation_state": opt_state["relation"]}
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
            for k, v in arrays.items()}


def neg_log_sigmoid_loss(neg_scores: torch.Tensor,
                         cfg: KGEConfig) -> torch.Tensor:
    """Per-positive negative loss ``[B]``: the plain mean, or with ``-adv``
    the self-adversarial softmax weighting, whose weights take no
    gradient."""
    if cfg.neg_adversarial_sampling:
        w = torch.softmax(neg_scores * cfg.adversarial_temperature, dim=-1)
        return -(w.detach() * F.logsigmoid(-neg_scores)).sum(-1)
    return -F.logsigmoid(-neg_scores).mean(-1)


class KGEModel:
    """Functional KGE model over a params dict ``{"entity": [Ne, D],
    "relation": [Nr, relation_dim(cfg)]}``. :meth:`rows_loss` is the one
    objective every trainer of the port differentiates."""

    def __init__(self, cfg: KGEConfig):
        if cfg.model_name not in K.KGE_SCORERS:
            raise ValueError(f"unknown KGE model {cfg.model_name}")
        self.cfg = cfg
        self.scorer: Callable = K.KGE_SCORERS[cfg.model_name]
        # RotatE's phases are scaled by the init range, so r spans +-pi
        # at init (DGL-KE's emb_init convention)
        self._score_kw = ({"emb_init": cfg.emb_init_range()}
                          if cfg.model_name == "RotatE" else {})

    def score(self, h, r, t) -> torch.Tensor:
        return self.scorer(h, r, t, gamma=self.cfg.gamma, **self._score_kw)

    def neg_score(self, fixed, r, neg, chunk: int,
                  neg_mode: str) -> torch.Tensor:
        return K.neg_score(self.scorer, fixed, r, neg, chunk,
                           neg_mode=neg_mode, gamma=self.cfg.gamma,
                           **self._score_kw)

    def rows_loss(self, h, r, t, neg, neg_mode: str) -> torch.Tensor:
        """The loss of gathered rows: positives ``h, r, t`` ``[B, *]`` and
        the chunk-shared candidates ``neg`` ``[C, N, D]`` replacing the
        ``neg_mode`` side."""
        B, C = h.shape[0], neg.shape[0]
        pos = self.score(h, r, t)
        fixed = h if neg_mode == "tail" else t
        neg_loss = neg_log_sigmoid_loss(
            self.neg_score(fixed, r, neg, B // C, neg_mode), self.cfg)
        return ((-F.logsigmoid(pos)).mean() + neg_loss.mean()) / 2.0

    def loss(self, params, batch, neg_ids, neg_mode: str = "tail"
             ) -> torch.Tensor:
        """The loss of a batch ``(h_idx, r_idx, t_idx)`` (each ``[B]``)
        against ``neg_ids`` ``[C, N]``, entity ids shared by each chunk."""
        h_idx, r_idx, t_idx = batch
        ent = params["entity"]
        neg = gather_rows(ent, neg_ids.reshape(-1)).view(
            *neg_ids.shape, ent.shape[1])
        return self.rows_loss(gather_rows(ent, h_idx),
                              gather_rows(params["relation"], r_idx),
                              gather_rows(ent, t_idx), neg, neg_mode)
