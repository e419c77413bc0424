"""The reference's training steps: the plain model of ``models.py`` on
blocks that ``sampler.py`` draws, cross-entropy, and Adam written out.

:func:`follow` takes the run's inputs (the edge list's in-edge lists,
the features, the labels, the initial weights, each step's seeds and
key, the program's seed for the dropout draws) and trains ``len(steps)``
steps from the initial weights. It returns what the comparison reads:
each step's loss, the first step's gradients, the weights after the
last step and the blocks of the first ``block_steps`` steps. ``precision="tf32"`` runs the same steps with TF32 matrix
products on the card (the control that must fail the comparison), and
``fault="half_batch"`` leaves the second half of every batch out of the
loss (a fault that must fail it too).

Imports torch alone; nothing of the program.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from portbench.reference import models, sampler


@contextlib.contextmanager
def matmul_precision(precision: str):
    """Matrix products in ``precision`` (``"float32"``: TF32 off; or
    ``"tf32"``) inside the block; the previous settings after it."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def adam_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
              state: Dict[str, Tuple[torch.Tensor, torch.Tensor]], t: int,
              lr: float, betas: Sequence[float], eps: float) -> None:
    """Adam (Kingma and Ba 2015), step ``t`` (1-based), in place, every
    quantity in the parameters' float32, the bias corrections
    ``1 - beta^t`` too."""
    for name, g in grads.items():
        m, v = state[name]
        b1, b2 = (torch.tensor(float(b), dtype=g.dtype, device=g.device)
                  for b in betas)
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * g * (1 - b2))
        m_hat = m / (1 - b1 ** t)
        v_hat = v / (1 - b2 ** t)
        params[name].sub_(lr * m_hat / (v_hat.sqrt() + eps))


def follow(kind: str, model: Dict, optim: Dict, fanouts: Sequence[int],
           indptr: torch.Tensor, indices: torch.Tensor, feats: torch.Tensor,
           labels: torch.Tensor, init: Dict[str, torch.Tensor],
           steps: List[Tuple[torch.Tensor, int]], program_seed: int,
           dropout_p: float, precision: str = "float32",
           fault: Optional[str] = None, block_steps: int = 1) -> Dict:
    """Train ``steps`` (each ``(seeds [B], key)``) from ``init``; returns
    ``{"losses": [float], "grads": {name: first step's gradient},
    "params": {name: weights after the last step}, "blocks": [(masks,
    ids)] of the first block_steps steps}``."""
    params = {k: v.detach().clone() for k, v in init.items()}
    state = {k: (torch.zeros_like(v), torch.zeros_like(v))
             for k, v in params.items()}
    gen = torch.Generator(device=feats.device).manual_seed(int(program_seed))

    def drop(h):
        return models.dropout(h, dropout_p, gen) if dropout_p > 0 else h

    losses, first_grads, blocks = [], None, []
    with matmul_precision(precision):
        for t, (seeds, key) in enumerate(steps, start=1):
            masks, ids = sampler.sample_tree(indptr, indices, seeds,
                                             fanouts, key)
            if t <= block_steps:
                blocks.append((masks, ids))
            leaves = {k: v.clone().requires_grad_(True)
                      for k, v in params.items()}
            x = feats.index_select(0, ids)
            logits = models.forward(kind, leaves, masks, x, model, drop)
            used = seeds
            if fault == "half_batch":
                used = seeds.clone()
                used[seeds.shape[0] // 2:] = -1
            elif fault is not None:
                raise ValueError(f"unknown fault {fault!r}")
            loss = models.loss_of(logits, labels, used)
            names = list(leaves)
            g = torch.autograd.grad(loss, [leaves[k] for k in names])
            grads = dict(zip(names, g))
            if first_grads is None:
                first_grads = {k: v.detach().clone() for k, v in grads.items()}
            with torch.no_grad():
                adam_step(params, grads, state, t, float(optim["lr"]),
                          optim["betas"], float(optim["eps"]))
            losses.append(float(loss.detach()))
    return {"losses": losses, "grads": first_grads, "params": params,
            "blocks": blocks}
