#!/usr/bin/env python3
"""How far LeakyReLU branch flips move an attention stack's gradients.

    python3 leaky_branch_probe.py [--model gat|gatv2] [--scale 0.1]
                                  [--batches 3] [--seed 0]

A LeakyReLU input within rounding of 0 can fall on the other side in
two computations of the same function (card and CPU, float32 and
float64), and then its gradient term is scaled by the other slope. This
probe measures the effect on the CPU at the smoke's width: a full-width
``DistGATv2`` (or ``DistGAT``) on the synthetic ogbn-products graph at
``--scale``, one sampled batch of 1000 seeds at a time, gradients of
the masked loss in float32 and in float64, compared twice: as they are,
and with the float64 run given the float32 run's branches
(``chip_smoke.Branches``). The float64 run gathers with plain indexing,
since ``gather_rows`` takes float32 and bfloat16 only. Prints one JSON
line per batch: the largest gradient gap as a share of the parameter's
largest entry, and the branches that differ. ``chip_smoke.py`` sets its
card-against-CPU gradient limit on each side's own branches from these
gaps.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import Branches  # noqa: E402
from dgl_operator_tpu_torch.graph import datasets  # noqa: E402
from dgl_operator_tpu_torch.models import DistGAT, DistGATv2  # noqa: E402
from dgl_operator_tpu_torch.nn import conv  # noqa: E402
from dgl_operator_tpu_torch.ops.gather import gather_rows_plain  # noqa: E402
from dgl_operator_tpu_torch.runtime.forward import masked_loss  # noqa: E402
from dgl_operator_tpu_torch.runtime.loop import (  # noqa: E402
    SampledTrainer, TrainConfig)


def gradients(model, blocks, x, labels, seeds):
    """The parameters' gradients of the masked loss, in float64."""
    model.zero_grad(set_to_none=True)
    loss, _ = masked_loss(model(blocks, x.to(next(model.parameters()).dtype)),
                          labels, seeds)
    loss.backward()
    return {n: p.grad.double() for n, p in model.named_parameters()}


def plain_gathers():
    """The attention layers' gathers as plain indexing (float64 runs)."""
    return mock.patch.object(conv, "gather_rows",
                             lambda t, i, p=None: gather_rows_plain(t, i))


def worst_gap(a, b):
    gaps = {n: float((a[n] - b[n]).abs().max() / b[n].abs().max())
            for n in a}
    name = max(gaps, key=gaps.get)
    return name, gaps[name]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=["gat", "gatv2"], default="gatv2")
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    g = datasets.ogbn_products(seed=args.seed, scale=args.scale).graph
    ids = np.nonzero(g.ndata["train_mask"])[0][:40_000]
    cls = DistGATv2 if args.model == "gatv2" else DistGAT
    model = cls(100, 256, 47, num_heads=2, dropout=0.0, device="cpu",
                generator=torch.Generator().manual_seed(args.seed + 6))
    tr = SampledTrainer(model, g, TrainConfig(
        batch_size=1000, fanouts=(10, 25), dropout=0.0, seed=args.seed),
        train_ids=ids, device="cpu")
    m32, m64 = copy.deepcopy(model), copy.deepcopy(model).double()
    perm = np.random.default_rng(args.seed).permutation(ids)
    out = []
    for b in range(args.batches):
        blocks, inputs, seeds = tr.ship(tr.sample(
            perm[b * 1000:(b + 1) * 1000], b))
        x = tr.feats[inputs.long()]
        with plain_gathers():
            g64 = gradients(m64, blocks, x, tr.labels, seeds)
        with Branches(m32, m64) as br:
            g32 = gradients(m32, blocks, x, tr.labels, seeds)
            with plain_gathers():
                g64_shared = gradients(m64, blocks, x, tr.labels, seeds)
        name, gap = worst_gap(g32, g64)
        sname, sgap = worst_gap(g32, g64_shared)
        rec = {"batch": b, "model": args.model, "device": "cpu",
               "leaky_inputs": br.elems,
               "branches_differing": br.flips, "worst_gap": gap,
               "worst_gap_param": name, "worst_gap_same_branches": sgap,
               "worst_gap_same_branches_param": sname}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
