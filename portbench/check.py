"""The comparison that decides ``correct`` for a training cell.

The program's first checked steps against the reference's, from the
same inputs:

- ``mask_gap``: slots of the first call's blocks (each of its K eager
  steps) whose validity, or whose place in the block, differs from the
  reference's draw (exact: limit 0).
- ``rows_gap``: rows of those steps' gathered input that differ from
  the features of the ids the reference drew (exact: limit 0).
  With random features a row names its node, so this also holds every
  sampled neighbour to be an in-edge of its node.
- ``loss_gap``: the largest relative gap of a checked step's loss.
- ``grad_gap``: the first step's gradient as the program's Adam holds
  it after one step (``exp_avg / (1 - beta1)``), by the worst leaf: the
  gap between the program's and the reference's norms over the larger
  of that leaf's and the median leaf's reference norm.
- ``delta_gap``: the weights' change over the checked steps, by the
  worst leaf likewise, leaving out each leaf whose reference gradient
  is under a thousandth of the median leaf's (its change is round-off).
- ``grad_median_gap``, ``delta_median_gap``: the same two by the median
  of the leaves' gaps, for a cell whose worst leaf swings from seed to
  seed (GAT: an attention logit that rounding puts on the other side of
  LeakyReLU's kink moves the small attention vectors' gradients).

A cell compares the numbers its ``limits`` name. A value that is not
finite fails; it is reported as null.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence

import torch

# a leaf whose first reference gradient is below this share of the
# median leaf's moves by round-off alone and is not compared
NOUGHT_GRAD = 1e-3
ORDER = ("mask_gap", "rows_gap", "loss_gap", "grad_gap", "grad_median_gap",
         "delta_gap", "delta_median_gap")


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              names: Optional[Sequence[str]] = None) -> List[float]:
    """Each leaf's ``|norm(prog) - norm(ref)| / max(norm(ref), median
    leaf norm(ref))``, over ``names`` (every leaf by default); the median
    is over every leaf of ``ref``."""
    rn, pn = _norms(ref), _norms(prog)
    med = statistics.median(rn.values())
    return [abs(pn[k] - rn[k]) / max(rn[k], med, 1e-300)
            for k in (names if names is not None else list(ref))]


def moving_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is at least ``NOUGHT_GRAD`` of
    the median leaf's."""
    rn = _norms(ref_grads)
    med = statistics.median(rn.values())
    return [k for k, v in rn.items() if v >= NOUGHT_GRAD * med]


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    if len(prog) != len(ref):
        return math.inf
    gaps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref)]
    return max(gaps) if all(map(math.isfinite, gaps)) else math.inf


def compare(prog: Dict, ref: Dict, init: Dict[str, torch.Tensor]
            ) -> Dict[str, float]:
    """The compared values. ``prog`` holds ``blocks`` (per checked step
    of the first call: ``masks`` and ``nbr`` of its blocks, ``rows`` its
    gathered input), ``losses``, ``grads`` and ``params``; ``ref`` is
    ``reference/train.py::follow``'s result with ``feats`` (the
    features) added; ``init`` the initial weights. A step that one side
    has and the other lacks counts every slot and row of it."""
    mask_bad = rows_bad = 0
    for i, (ref_masks, ref_ids) in enumerate(ref["blocks"]):
        step = prog["blocks"][i] if i < len(prog["blocks"]) else None
        for j, rm in enumerate(ref_masks):
            rm = rm.cpu()
            n, f = rm.shape
            pos = n + torch.arange(n * f).view(n, f)
            pm = step["masks"][j] if step and j < len(step["masks"]) \
                else None
            if pm is None or pm.shape != rm.shape:
                mask_bad += rm.numel()
                continue
            mask_bad += int(((pm > 0) != rm).sum())
            mask_bad += int((step["nbr"][j].long() != pos).sum())
        want = ref["feats"].index_select(0, ref_ids).cpu()
        rows = step["rows"] if step else None
        rows_bad += (int((rows != want).any(1).sum())
                     if rows is not None and rows.shape == want.shape
                     else int(want.shape[0]))
    extra = prog["blocks"][len(ref["blocks"]):]
    mask_bad += sum(m.numel() for s in extra for m in s["masks"])
    rows_bad += sum(int(s["rows"].shape[0]) for s in extra)
    delta_p = {k: prog["params"][k].double() - init[k].double()
               for k in init}
    delta_r = {k: ref["params"][k].cpu().double() - init[k].double()
               for k in init}
    ref_grads = {k: v.cpu() for k, v in ref["grads"].items()}
    grads = leaf_gaps(prog["grads"], ref_grads)
    deltas = leaf_gaps(delta_p, delta_r, moving_leaves(ref_grads))
    return {
        "mask_gap": float(mask_bad),
        "rows_gap": float(rows_bad),
        "loss_gap": loss_gap(prog["losses"], ref["losses"]),
        "grad_gap": _worst(grads),
        "grad_median_gap": _median(grads),
        "delta_gap": _worst(deltas),
        "delta_median_gap": _median(deltas),
    }


def _worst(gaps: List[float]) -> float:
    return max(gaps) if all(map(math.isfinite, gaps)) else math.inf


def _median(gaps: List[float]) -> float:
    return statistics.median(gaps) if all(map(math.isfinite, gaps)) \
        else math.inf


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, Optional[float]]]:
    """``{name: {"value", "limit"}}`` for each number the cell's
    ``limits`` name, in ``ORDER`` (a value that is not finite becomes
    None)."""
    unknown = set(limits) - set(ORDER)
    if unknown:
        raise ValueError(f"no compared number {sorted(unknown)}")
    out = {}
    for name in (n for n in ORDER if n in limits):
        v = values.get(name)
        out[name] = {"value": v if v is not None and math.isfinite(v)
                     else None, "limit": limits[name]}
    return out


def passes(judged: Dict[str, Dict[str, Optional[float]]]) -> bool:
    return all(j["value"] is not None and j["value"] <= j["limit"]
               for j in judged.values())
