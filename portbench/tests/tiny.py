"""A cell's files at a size a CPU test run holds: the cell's own
configuration and traffic with the graph, the hidden width and the
batch cut down.

``gat.dev_k4`` is no cell of ``BENCHMARK.json``: it is the SAGE cell
with the ``dist_gat`` model kind in its place (the widths of the
program's GAT tests, 2 heads), which keeps the GAT model kind and the
reference's GAT equations under test until a published GAT
configuration brings its own cell."""

from __future__ import annotations

import copy

from portbench import spec

SAGE = "sage_products.dev_k4"
GAT = "gat.dev_k4"
CELLS = (SAGE, GAT)

GAT_MODEL = {"kind": "dist_gat", "in_feats": 100, "hidden": 256,
             "heads": 2, "out_feats": 47, "num_layers": 2,
             "negative_slope": 0.2, "dropout": 0.5}
# the limits a GAT cell would compare (its worst leaf swings from seed
# to seed: the median leaf's gradient and change stand in)
GAT_LIMITS = {"mask_gap": 0, "rows_gap": 0, "loss_gap": 0.01,
              "grad_median_gap": 5e-06, "delta_median_gap": 0.002}


def load(name: str) -> spec.Cell:
    """The cell ``name`` as its files give it (``GAT``: made here)."""
    if name != GAT:
        return spec.load_cell(name)
    cell = spec.load_cell(SAGE)
    cell.name, cell.config_name = GAT, "gat"
    cell.config = dict(copy.deepcopy(cell.config), name="gat",
                       model=dict(GAT_MODEL))
    cell.limits = dict(GAT_LIMITS)
    return cell


def tiny_cell(name: str, num_nodes: int = 3000, num_edges: int = 30000,
              hidden: int = 16, batch: int = 64) -> spec.Cell:
    cell = load(name)
    cfg = copy.deepcopy(cell.config)
    cfg["graph"].update(num_nodes=num_nodes, num_edges=num_edges, seed=1)
    cfg["model"].update(hidden=hidden)
    cfg["train"].update(batch_size=batch)
    cell.config = cfg
    return cell
