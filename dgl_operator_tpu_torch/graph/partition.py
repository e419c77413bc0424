"""Graph partitioning and partition books.

Computing an assignment, the port of the JAX package's
``graph/partition.py``:

- ``part_method="multilevel"`` (the default): heavy-edge-matching
  coarsening, a seed competition on the coarsest graph, and boundary
  refinement at every level on the way back up
  (:func:`multilevel_partition`);
- ``part_method="flat"``: a single-level seed competition (the greedy
  BFS partitioner, LDG streaming, LPA communities) followed by capped
  label-propagation refinement (:func:`partition_assignment`).

The greedy BFS seed, the coarsening and the boundary refinement run in
the C++ graph core (``graph/_native.py``); the rest is numpy, the JAX
package's code. The same graph, parts and seed give the same node map
in both packages.

The on-disk format is the JAX package's, so a book written by either
package reads in the other::

    out_path/graph_name.json
    out_path/node_map.npy, out_path/edge_map.npy
    out_path/part{i}/{graph.npz,node_feat.npz,edge_feat.npz}

Each part owns its *core* nodes (assignment == part id) plus the
one-hop *halo* source nodes of its in-edges; local ids are ordered
``[core | halo]`` and the halo ownership manifest (owner part and core
row there) rides in ``graph.npz``.

``partition_graph(ooc=True)`` bounds the writer's resident working set
(``graph/ooc.py``): coarsening levels spill to disk and node features
are written in chunks to file-referenced ``.npy`` files. Its
``feat_dtype`` ``"int8"`` or ``"uint8"`` stores the features as
per-column affine codes (``graph/quant.py``) with one global sidecar,
``feat_quant.npz``, for every part.
"""

from __future__ import annotations

import json
import os
from collections import deque
from typing import List, Optional

import numpy as np

from dgl_operator_tpu_torch.autotune.knobs import validate
from dgl_operator_tpu_torch.graph import _native, quant
from dgl_operator_tpu_torch.graph import ooc as _ooc
from dgl_operator_tpu_torch.graph.graph import Graph

PART_METHODS = ("multilevel", "flat")


# ----------------------------------------------------------------------
def ldg_partition(g: Graph, num_parts: int, seed: int = 0,
                  slack: float = 1.1,
                  balance_ntypes: Optional[np.ndarray] = None,
                  balance_edges: bool = False) -> np.ndarray:
    """Linear Deterministic Greedy streaming partitioning (Stanton &
    Kleinberg, KDD'12).

    Nodes arrive in BFS order over the undirected view (random restarts
    for components); each is placed in the part with the most
    already-placed neighbors, discounted by a load penalty ``(1 -
    size/capacity)``, ties to the least-loaded part. Returns int32 part
    id per node.

    ``balance_ntypes`` is a per-node group id (bool mask or int array);
    each group gets its own per-part capacity, a hard quota. With
    ``balance_edges`` the load penalty uses accumulated degree mass
    instead of node counts.
    """
    n, k = g.num_nodes, num_parts
    if k <= 1:
        return np.zeros(n, dtype=np.int32)
    cap = slack * n / k
    indptr, indices, _ = g.csr()
    cindptr, cindices, _ = g.csc()
    degree = (indptr[1:] - indptr[:-1]) + (cindptr[1:] - cindptr[:-1])
    if balance_ntypes is not None:
        ntype = np.asarray(balance_ntypes).astype(np.int64).reshape(-1)
        if ntype.shape[0] != n:
            raise ValueError("balance_ntypes must have one entry per node")
        n_types = int(ntype.max()) + 1 if n else 1
        type_total = np.bincount(ntype, minlength=n_types).astype(np.float64)
        type_cap = np.maximum(slack * type_total / k, 1.0)  # [T]
        type_sizes = np.zeros((n_types, k), dtype=np.int64)
    else:
        ntype = None
    if balance_edges:
        edge_cap = slack * float(degree.sum()) / k
        edge_sizes = np.zeros(k, dtype=np.float64)
    parts = np.full(n, -1, dtype=np.int32)
    sizes = np.zeros(k, dtype=np.int64)
    rng = np.random.default_rng(seed)
    order = np.empty(n, dtype=np.int64)
    visited = np.zeros(n, dtype=bool)
    pos = 0
    q = deque()
    for s in rng.permutation(n):
        if visited[s]:
            continue
        q.append(s)
        visited[s] = True
        while q:
            u = q.popleft()
            order[pos] = u
            pos += 1
            for nb in np.concatenate([indices[indptr[u]:indptr[u + 1]],
                                      cindices[cindptr[u]:cindptr[u + 1]]]):
                if not visited[nb]:
                    visited[nb] = True
                    q.append(nb)
    for u in order:
        nbrs = np.concatenate([indices[indptr[u]:indptr[u + 1]],
                               cindices[cindptr[u]:cindptr[u + 1]]])
        placed = parts[nbrs]
        placed = placed[placed >= 0]
        score = np.zeros(k)
        if len(placed):
            np.add.at(score, placed, 1.0)
        if balance_edges:
            load = np.maximum(0.0, 1.0 - edge_sizes / max(edge_cap, 1.0))
        else:
            load = np.maximum(0.0, 1.0 - sizes / cap)
        score *= load
        if ntype is not None:
            # hard per-group quota: a part already at its share of this
            # node's group is ineligible (unless every part is)
            tsz = type_sizes[ntype[u]]
            open_ = tsz < type_cap[ntype[u]]
            if open_.any():
                score = np.where(open_, score, -1.0)
        best = int(np.lexsort((sizes, -score))[0])
        parts[u] = best
        sizes[best] += 1
        if ntype is not None:
            type_sizes[ntype[u], best] += 1
        if balance_edges:
            edge_sizes[best] += degree[u]
    return parts


def _neighbor_part_hist(src: np.ndarray, dst: np.ndarray,
                        parts: np.ndarray, n: int, k: int) -> np.ndarray:
    """[n, k] count of each node's (undirected) neighbors per part, by
    bincount over flattened (node, part) keys."""
    keys = src.astype(np.int64) * k + parts[dst]
    keys2 = dst.astype(np.int64) * k + parts[src]
    h = (np.bincount(keys, minlength=n * k)
         + np.bincount(keys2, minlength=n * k))
    return h.reshape(n, k).astype(np.float32)


def refine_partition(g: Graph, parts: np.ndarray, num_parts: int,
                     iters: int = 12, slack: float = 1.1,
                     balance_ntypes: Optional[np.ndarray] = None,
                     balance_edges: bool = False,
                     seed: int = 0) -> np.ndarray:
    """Balance-capped label-propagation refinement.

    Each sweep histograms every node's neighbors by part, picks the
    majority part, and applies the highest-gain moves subject to
    per-part (and per-group, and degree-mass) capacity quotas. A seeded
    random half of the candidates moves per sweep to damp two-node
    oscillation.
    """
    n, k = g.num_nodes, num_parts
    if k <= 1 or n == 0:
        return parts
    parts = parts.astype(np.int32).copy()
    cap = slack * n / k
    rng = np.random.default_rng(seed)
    src, dst = g.src, g.dst
    if balance_ntypes is not None:
        ntype = np.asarray(balance_ntypes).astype(np.int64).reshape(-1)
        n_types = int(ntype.max()) + 1 if n else 1
        type_cap = np.maximum(
            slack * np.bincount(ntype, minlength=n_types) / k, 1.0)
    else:
        ntype = None
    if balance_edges:
        degree = (g.in_degrees().astype(np.float64)
                  + g.out_degrees().astype(np.float64))
        edge_cap = slack * float(degree.sum()) / k
    arange_n = np.arange(n)
    for _ in range(iters):
        hist = _neighbor_part_hist(src, dst, parts, n, k)
        cur = hist[arange_n, parts]
        best = hist.argmax(1).astype(np.int32)
        gain = hist.max(1) - cur
        cand = np.nonzero((gain > 0) & (best != parts))[0]
        if len(cand) == 0:
            break
        cand = cand[rng.random(len(cand)) < 0.5]
        if len(cand) == 0:
            continue
        sizes = np.bincount(parts, minlength=k).astype(np.int64)
        if ntype is not None:
            type_sizes = np.zeros((n_types, k), np.int64)
            np.add.at(type_sizes, (ntype, parts), 1)
            type_room = type_cap[:, None] - type_sizes  # [T, k]
        if balance_edges:
            edge_mass = np.zeros(k, np.float64)
            np.add.at(edge_mass, parts, degree)
        moved_any = False
        # per target part: admit the highest-gain movers up to capacity
        for b in range(k):
            into = cand[best[cand] == b]
            if len(into) == 0:
                continue
            into = into[np.argsort(-gain[into])]
            quota = int(cap - sizes[b])
            if quota <= 0:
                continue
            into = into[:quota]
            if balance_edges:
                # admit while the part's degree mass stays under cap
                room_mass = edge_cap - edge_mass[b]
                take = np.cumsum(degree[into]) <= room_mass
                into = into[take]
                if len(into) == 0:
                    continue
                edge_mass[b] += float(degree[into].sum())
            if ntype is not None:
                keep = []
                for u in into:
                    t = ntype[u]
                    if type_room[t, b] >= 1:
                        type_room[t, b] -= 1
                        keep.append(u)
                into = np.asarray(keep, dtype=np.int64)
                if len(into) == 0:
                    continue
            parts[into] = b
            moved_any = True
        if not moved_any:
            break
    return parts


def enforce_type_quotas(g: Graph, parts: np.ndarray, num_parts: int,
                        balance_ntypes: np.ndarray,
                        slack: float = 1.1) -> np.ndarray:
    """Move nodes out of over-quota (group, part) cells until every cell
    is within ``slack`` of its even share. Movers are the cell's
    least-attached nodes (fewest neighbors inside); targets are the
    under-quota parts where the node has the most neighbors."""
    n, k = g.num_nodes, num_parts
    parts = parts.astype(np.int32).copy()
    ntype = np.asarray(balance_ntypes).astype(np.int64).reshape(-1)
    n_types = int(ntype.max()) + 1 if n else 1
    type_cap = np.maximum(
        slack * np.bincount(ntype, minlength=n_types) / k, 1.0)
    hist = _neighbor_part_hist(g.src, g.dst, parts, n, k)
    for t in range(n_types):
        sel = np.nonzero(ntype == t)[0]
        counts = np.bincount(parts[sel], minlength=k).astype(np.float64)
        room = np.maximum(type_cap[t] - counts, 0.0)
        for b in np.nonzero(counts > type_cap[t])[0]:
            members = sel[parts[sel] == b]
            excess = int(counts[b] - np.floor(type_cap[t]))
            if excess <= 0 or len(members) == 0:
                continue
            # least attached to their current part move first
            movers = members[np.argsort(hist[members, b])][:excess]
            for u in movers:
                open_parts = np.nonzero(room >= 1.0)[0]
                if len(open_parts) == 0:
                    break
                tgt = open_parts[np.argmax(hist[u, open_parts])]
                parts[u] = tgt
                room[tgt] -= 1.0
    return parts


def lp_communities(g: Graph, rounds: int = 5, seed: int = 0,
                   edge_sample: Optional[int] = None) -> np.ndarray:
    """Community detection by synchronous mode-label propagation
    (Raghavan et al. 2007): each round every node adopts its most
    frequent (undirected) neighbor label, ties broken at random, by one
    lexsort and run-length pass over the edge list. ``edge_sample``
    bounds the edges consulted per round (a Bernoulli subsample). A
    round that would put more than 70% of the nodes in one community
    is reverted and ends the run. Deterministic given ``seed``."""
    n = g.num_nodes
    labels = np.arange(n, dtype=np.int64)
    if g.num_edges == 0 or n == 0:
        return labels
    rng = np.random.default_rng(seed)
    u_all = np.concatenate([g.src, g.dst]).astype(np.int64)
    v_all = np.concatenate([g.dst, g.src]).astype(np.int64)
    for _ in range(rounds):
        if edge_sample is not None and edge_sample < len(u_all):
            sel = rng.random(len(u_all)) < edge_sample / len(u_all)
            u, v = u_all[sel], v_all[sel]
        else:
            u, v = u_all, v_all
        if len(u) == 0:
            continue    # an empty subsample carries no votes
        lab_v = labels[v]
        order = np.lexsort((lab_v, u))
        us, ls = u[order], lab_v[order]
        # run-length encode (node, neighbor-label) groups
        new_run = np.empty(len(us), dtype=bool)
        new_run[0] = True
        new_run[1:] = (us[1:] != us[:-1]) | (ls[1:] != ls[:-1])
        starts = np.nonzero(new_run)[0]
        run_u = us[starts]
        run_l = ls[starts]
        run_len = np.diff(np.append(starts, len(us)))
        # per node keep the longest run, ties broken at random; nodes
        # with no sampled edge keep their label
        tie = rng.random(len(run_u))
        o2 = np.lexsort((tie, run_len, run_u))
        last = np.nonzero(np.append(run_u[o2][1:] != run_u[o2][:-1],
                                    True))[0]
        new_labels = labels.copy()
        new_labels[run_u[o2][last]] = run_l[o2][last]
        _, counts = np.unique(new_labels, return_counts=True)
        if counts.max() > 0.7 * n:
            break
        changed = int((new_labels != labels).sum())
        labels = new_labels
        if changed < max(n // 1000, 1):
            break
    return labels


def communities_to_parts(labels: np.ndarray, num_parts: int
                         ) -> np.ndarray:
    """Bin-pack communities into ``num_parts`` size-balanced parts
    (largest community first into the least-loaded part)."""
    uniq, inv, counts = np.unique(labels, return_inverse=True,
                                  return_counts=True)
    order = np.argsort(-counts)
    load = np.zeros(num_parts, dtype=np.int64)
    com2part = np.zeros(len(uniq), dtype=np.int32)
    for c in order:
        p = int(load.argmin())
        com2part[c] = p
        load[p] += counts[c]
    return com2part[inv].astype(np.int32)


# Above this size the per-node Python loop of ldg_partition is
# intractable; the greedy partitioner seeds alone, and the quota
# post-pass and refinement recover balance and cut.
_LDG_MAX_NODES = 500_000


def partition_assignment(g: Graph, num_parts: int, seed: int = 0,
                         balance_ntypes: Optional[np.ndarray] = None,
                         balance_edges: bool = False,
                         refine_iters: int = 12,
                         communities: Optional[np.ndarray] = None
                         ) -> np.ndarray:
    """Flat node->part assignment: candidate seeds (the greedy BFS
    partitioner unless a small graph balances; LDG on graphs of at most
    ``_LDG_MAX_NODES``; LPA communities and the ``communities`` hint,
    bin-packed) compete on edge cut plus a steep penalty past the
    balance slack, then quota enforcement and label-propagation
    refinement polish the winner."""
    if communities is not None:
        communities = np.asarray(communities).reshape(-1)
        if communities.shape[0] != g.num_nodes:
            raise ValueError("communities must have one entry per node")
    small = g.num_nodes <= _LDG_MAX_NODES
    seeds: List[np.ndarray] = []
    if not small or (balance_ntypes is None and not balance_edges):
        indptr, indices, _ = g.csr()
        seeds.append(_native.greedy_partition(indptr, indices, num_parts,
                                              seed))
    if small:
        seeds.append(ldg_partition(g, num_parts, seed,
                                   balance_ntypes=balance_ntypes,
                                   balance_edges=balance_edges))
    comm_cands = []
    if communities is not None:
        comm_cands.append(communities)
    if g.num_edges:
        try:
            comm_cands.append(lp_communities(
                g, rounds=5, seed=seed,
                edge_sample=(None if g.num_edges <= 20_000_000
                             else 40_000_000)))
        except MemoryError:    # a candidate seed, not a requirement
            pass
    for comm in comm_cands:
        # a near-singleton labeling carries no community structure
        if len(np.unique(comm)) > g.num_nodes // 2:
            continue
        cand = communities_to_parts(comm, num_parts)
        # one community dominating cannot seed a balanced partition
        if (np.bincount(cand, minlength=num_parts).max()
                <= 1.5 * g.num_nodes / num_parts):
            seeds.append(cand)

    def seed_score(p: np.ndarray) -> float:
        # edge cut + a steep penalty past the balance slack: a
        # degenerate all-one-part assignment has cut 0 and must lose
        over = (np.bincount(p, minlength=num_parts).max()
                / max(1.1 * g.num_nodes / num_parts, 1.0))
        return edge_cut(g, p) + 10.0 * max(0.0, over - 1.0)

    parts = min(seeds, key=seed_score)
    if balance_ntypes is not None:
        parts = enforce_type_quotas(g, parts, num_parts, balance_ntypes)
    if refine_iters > 0:
        parts = refine_partition(g, parts, num_parts, iters=refine_iters,
                                 balance_ntypes=balance_ntypes,
                                 balance_edges=balance_edges, seed=seed)
    return parts


def edge_cut(g: Graph, parts: np.ndarray) -> float:
    """Fraction of edges crossing partitions."""
    return float(np.mean(parts[g.src] != parts[g.dst]))


def core_rank_of(parts: np.ndarray, num_parts: int) -> np.ndarray:
    """Owner-local core row of every global node: its rank among its
    part's global ids, ascending — the local position the writer gives
    core nodes."""
    n = len(parts)
    counts = np.bincount(parts, minlength=num_parts).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    order = np.argsort(parts, kind="stable")  # part-major, id ascending
    rank = np.empty(n, dtype=np.int32)
    rank[order] = (np.arange(n, dtype=np.int64)
                   - np.repeat(starts, counts)).astype(np.int32)
    return rank


# ----------------------------------------------------------------------
# Multilevel coarsen -> partition -> refine (the METIS structure):
# heavy-edge-matching coarsening shrinks the graph level by level until
# the seed competition can see its global structure, then the
# assignment is projected back up with boundary-only refinement at every
# level. Coarsening and refinement run in the C++ graph core.

def _weighted_cut_score(u: np.ndarray, v: np.ndarray, w: np.ndarray,
                        vw: np.ndarray, total_w: float, num_parts: int,
                        parts: np.ndarray) -> float:
    """Weighted coarse cut (the fine edge-cut fraction of the projected
    partition, since contracted weights count fine edges) plus the flat
    competition's steep balance penalty."""
    cut = float(w[parts[u] != parts[v]].sum()) / max(total_w, 1.0)
    pw = np.bincount(parts, weights=vw.astype(np.float64),
                     minlength=num_parts)
    over = pw.max() / max(1.1 * vw.sum() / num_parts, 1.0)
    return cut + 10.0 * max(0.0, over - 1.0)


def multilevel_partition(g: Graph, num_parts: int, seed: int = 0,
                         balance_ntypes: Optional[np.ndarray] = None,
                         balance_edges: bool = False,
                         refine_iters: int = 4,
                         communities: Optional[np.ndarray] = None,
                         coarsen_to: Optional[int] = None,
                         slack: float = 1.1,
                         max_levels: int = 24,
                         spill_dir: Optional[str] = None) -> np.ndarray:
    """Multilevel node->part assignment:

    1. **Coarsen**: heavy-edge-matching levels (matched pairs contract,
       edge and vertex weights accumulate) until about ``30 *
       num_parts`` coarse vertices remain or matching stalls.
    2. **Partition the coarsest graph**: the flat seed competition
       (:func:`partition_assignment`) plus three size-balanced random
       restarts, each polished by weighted boundary refinement and
       scored on the weighted cut with the balance penalty.
    3. **Uncoarsen**: project level by level, refining the cut boundary
       at each level under a per-part vertex-weight cap.

    ``balance_ntypes`` and ``balance_edges`` are restored at the finest
    level by :func:`enforce_type_quotas`, a degree-weighted boundary
    pass and capped label-propagation refinement.

    ``spill_dir``: every coarsening level's arrays and its fine-to-
    coarse map are spilled there as they are made (``graph/ooc.py``)
    and read back as memmaps while uncoarsening, their pages dropped
    after each level's refinement, so one level is resident at a time.
    ``np.save`` keeps the bits, so the assignment is the resident
    run's.
    """
    n, k = g.num_nodes, num_parts
    if k <= 1 or n == 0:
        return np.zeros(n, dtype=np.int32)
    if communities is not None:
        communities = np.asarray(communities).reshape(-1)
        if communities.shape[0] != n:
            raise ValueError("communities must have one entry per node")
    coarsen_to = int(coarsen_to or max(30 * k, 128))
    u = np.ascontiguousarray(g.src, dtype=np.int32)
    v = np.ascontiguousarray(g.dst, dtype=np.int32)
    w = np.ones(g.num_edges, dtype=np.float32)
    vw = np.ones(n, dtype=np.float32)
    total_w = float(g.num_edges)
    levels: List[tuple] = []   # (u, v, w, vw) per fine level
    maps: List[np.ndarray] = []  # fine -> coarse id per level
    cur_n = n
    while cur_n > coarsen_to and len(maps) < max_levels:
        cid, nc, cu, cv, cw, cvw = _native.hem_coarsen(
            u, v, w, vw, cur_n, seed + 17 * len(maps) + 1)
        if nc >= 0.98 * cur_n:
            break   # matching stalled (e.g. star graph): stop here
        if spill_dir is not None:
            lvl = len(maps)
            levels.append(tuple(
                _ooc.spill(spill_dir, f"lvl{lvl}_{nm}", arr)
                for nm, arr in zip(("u", "v", "w", "vw"), (u, v, w, vw))))
            maps.append(_ooc.spill(spill_dir, f"lvl{lvl}_map", cid))
        else:
            levels.append((u, v, w, vw))
            maps.append(cid)
        u, v, w, vw, cur_n = cu, cv, cw, cvw, nc

    # ---- coarsest-level partition: seed competition + weighted polish
    cap = slack * float(vw.sum()) / k
    budget = max(refine_iters * 4, 8)
    comm_c = communities
    if comm_c is not None and maps:
        for cid in maps:
            nxt = np.zeros(int(cid.max()) + 1 if len(cid) else 0,
                           dtype=np.int64)
            nxt[cid] = comm_c  # representative member's community
            comm_c = nxt
    cands = [partition_assignment(Graph(u, v, cur_n), k, seed=seed,
                                  refine_iters=refine_iters,
                                  communities=comm_c)]
    rng = np.random.default_rng(seed)
    for _ in range(3):
        # size-balanced random restarts diversify the refinement's basin
        cands.append((rng.permutation(cur_n) * k
                      // max(cur_n, 1)).astype(np.int32))
    cands = [_native.refine_boundary(u, v, w, vw, cur_n, k, cap, budget, p)
             for p in cands]
    parts = min(cands, key=lambda p: _weighted_cut_score(
        u, v, w, vw, total_w, k, p))

    # ---- uncoarsen: project, refine the boundary at every level
    for (lu, lv, lw, lvw), cid in zip(reversed(levels), reversed(maps)):
        parts = parts[cid]
        cap_l = slack * float(lvw.sum()) / k
        parts = _native.refine_boundary(lu, lv, lw, lvw, len(lvw), k,
                                        cap_l, refine_iters, parts)
        if spill_dir is not None:
            # the spilled level's pages the refinement faulted in
            _ooc.release_pages(lu, lv, lw, lvw, cid)

    # ---- finest-level balance invariants
    if balance_ntypes is not None:
        parts = enforce_type_quotas(g, parts, k, balance_ntypes, slack)
    if balance_edges:
        # degree-weighted boundary pass: the refiner's drain move pushes
        # degree mass out of over-cap parts (the capped LP sweep below
        # only blocks further imbalance)
        fu, fv, fw, _ = levels[0] if levels else (u, v, w, vw)
        deg = (g.in_degrees() + g.out_degrees()).astype(np.float32)
        parts = _native.refine_boundary(
            fu, fv, fw, deg, n, k, slack * float(deg.sum()) / k,
            refine_iters, parts)
    if balance_ntypes is not None or balance_edges:
        parts = refine_partition(g, parts, k, iters=min(refine_iters, 2),
                                 slack=slack,
                                 balance_ntypes=balance_ntypes,
                                 balance_edges=balance_edges, seed=seed)
    if spill_dir is not None:
        _ooc.release_pages(*(levels[0] if levels else ()), g.src, g.dst)
    return parts.astype(np.int32)


# ----------------------------------------------------------------------
def partition_graph(g: Graph, graph_name: str, num_parts: int,
                    out_path: str,
                    balance_ntypes: Optional[np.ndarray] = None,
                    balance_edges: bool = False, seed: int = 0,
                    parts: Optional[np.ndarray] = None,
                    communities: Optional[np.ndarray] = None,
                    part_method: str = "multilevel",
                    refine_iters: Optional[int] = None,
                    ooc: bool = False,
                    ooc_budget_mb: Optional[int] = None,
                    feat_dtype: str = "float32") -> str:
    """Partition ``g`` and write its book; returns the book's JSON path.

    Without ``parts`` the assignment is computed by ``part_method``:
    ``"multilevel"`` (:func:`multilevel_partition`) or ``"flat"``
    (:func:`partition_assignment`), with ``balance_ntypes``,
    ``balance_edges``, ``communities`` and ``seed``; ``refine_iters``
    overrides the method's refinement pass count. ``parts`` (one part
    id per node) is used as given.

    ``ooc=True`` bounds the writer's resident working set: the
    multilevel coarsening spills to ``out_path/.ooc_spill`` level by
    level (removed after; its bytes are the book's ``ooc_spill_mib``),
    and 2-D float node features are written in chunks of
    ``ooc_budget_mb`` (the knob's default when None) into standalone
    mappable ``.npy`` files that each part names under
    ``node_feat_files``. The assignment, the halo manifest and every
    graph and map array are the in-memory run's, byte for byte.

    ``feat_dtype`` is the storage dtype of 2-D float node features:
    ``"float32"`` and ``"bfloat16"`` store float32 values, ``"int8"``
    and ``"uint8"`` per-column affine codes (``graph/quant.py``) with
    one global scale and zero per key in ``feat_quant.npz``, calibrated
    on the whole feature matrix, since an exchanged halo row is
    dequantized with the receiver's sidecar. A quantized book always
    stores its features in files.
    """
    feat_dtype = validate("feat_dtype", feat_dtype)
    if ooc:
        ooc_budget_mb = validate(
            "ooc_budget_mb",
            512 if ooc_budget_mb is None else ooc_budget_mb)
    spill_dir = os.path.join(out_path, ".ooc_spill") if ooc else None
    if parts is None:
        if part_method not in PART_METHODS:
            raise ValueError(f"unknown part_method {part_method!r}; "
                             "expected 'multilevel' or 'flat'")
        kwargs = dict(balance_ntypes=balance_ntypes,
                      balance_edges=balance_edges,
                      communities=communities)
        if refine_iters is not None:
            kwargs["refine_iters"] = validate("refine_iters", refine_iters)
        if part_method == "multilevel":
            parts = multilevel_partition(g, num_parts, seed,
                                         spill_dir=spill_dir, **kwargs)
        else:
            parts = partition_assignment(g, num_parts, seed, **kwargs)
    else:
        parts = np.asarray(parts)
        part_method = "caller-supplied"
        if parts.shape != (g.num_nodes,):
            raise ValueError("parts must assign every node")
        if len(parts) and (parts.min() < 0 or parts.max() >= num_parts):
            raise ValueError(
                f"parts values must be in [0, {num_parts}); got "
                f"[{parts.min()}, {parts.max()}] — a node outside the "
                "range would silently land in no partition")
        parts = parts.astype(np.int32)
    spill_mib = None
    if spill_dir is not None and os.path.isdir(spill_dir):
        import shutil
        spill_mib = round(_ooc.spilled_bytes(spill_dir) / 2**20, 1)
        shutil.rmtree(spill_dir, ignore_errors=True)
    os.makedirs(out_path, exist_ok=True)

    # an edge belongs to its destination's part (in-edges of core nodes
    # are local)
    edge_part = parts[g.dst]
    np.save(os.path.join(out_path, "node_map.npy"), parts)
    np.save(os.path.join(out_path, "edge_map.npy"), edge_part.astype(np.int32))
    core_rank = core_rank_of(parts, num_parts)
    meta = {
        "graph_name": graph_name,
        "num_parts": int(num_parts),
        "num_nodes": int(g.num_nodes),
        "num_edges": int(g.num_edges),
        "part_method": part_method + "-native",
        "node_map": "node_map.npy",
        "edge_map": "edge_map.npy",
        "halo_hops": 1,
        "halo_manifest": 1,
    }
    if spill_mib is not None:
        meta["ooc_spill_mib"] = spill_mib

    # 2-D float node features go to file-referenced .npy files when the
    # book is out-of-core or quantized; labels, masks and ids stay in
    # node_feat.npz
    quantized = quant.is_quantized_dtype(feat_dtype)
    fkeys = sorted(k for k, v_ in g.ndata.items()
                   if getattr(v_, "ndim", 0) == 2
                   and np.dtype(v_.dtype).kind == "f")
    file_keys = fkeys if (ooc or quantized) else []
    codecs = {}
    if quantized and fkeys:
        # one global calibration per key, shared by every part
        sidecars = {}
        for k_ in fkeys:
            scale, zero = quant.merge_column_stats(
                _ooc.column_stats(g.ndata[k_], ooc_budget_mb), feat_dtype)
            sidecars[k_] = {"scale": scale, "zero": zero,
                            "dtype": feat_dtype}
            codecs[k_] = (lambda rows, s=scale, z=zero:
                          quant.quantize(rows, s, z, feat_dtype))
        quant.save_sidecar(os.path.join(out_path, "feat_quant.npz"),
                           sidecars)
        meta["feat_quant"] = {k_: {"dtype": feat_dtype,
                                   "sidecar": "feat_quant.npz"}
                              for k_ in fkeys}
    if file_keys:
        meta["feat_files"] = 1
    store_dtype = np.dtype(feat_dtype) if quantized else np.float32

    for p in range(num_parts):
        pdir = os.path.join(out_path, f"part{p}")
        os.makedirs(pdir, exist_ok=True)
        core = np.nonzero(parts == p)[0]
        own_edges = np.nonzero(edge_part == p)[0]
        src, dst = g.src[own_edges], g.dst[own_edges]
        # local node set: core first (inner prefix), then halo sources
        halo = np.setdiff1d(np.unique(src), core)
        local_nodes = np.concatenate([core, halo]).astype(np.int64)
        g2l = np.full(g.num_nodes, -1, dtype=np.int32)
        g2l[local_nodes] = np.arange(len(local_nodes), dtype=np.int32)
        np.savez(os.path.join(pdir, "graph.npz"),
                 src=g2l[src], dst=g2l[dst],
                 orig_id=local_nodes,
                 orig_eid=own_edges.astype(np.int64),
                 inner_node=(np.arange(len(local_nodes)) < len(core)),
                 num_nodes=np.int64(len(local_nodes)),
                 halo_owner_part=parts[halo].astype(np.int32),
                 halo_owner_local=core_rank[halo].astype(np.int32))
        np.savez(os.path.join(pdir, "node_feat.npz"),
                 **{k: np.asarray(v)[local_nodes]
                    for k, v in g.ndata.items() if k not in file_keys})
        feat_paths = {}
        for k_ in file_keys:
            rel = f"part{p}/node_feat.{k_}.npy"
            _ooc.write_part_feature(
                os.path.join(out_path, rel), g.ndata[k_], local_nodes,
                budget_mb=ooc_budget_mb, codec=codecs.get(k_),
                dtype=store_dtype)
            feat_paths[k_] = rel
        np.savez(os.path.join(pdir, "edge_feat.npz"),
                 **{k: v[own_edges] for k, v in g.edata.items()})
        meta[f"part-{p}"] = {
            "node_feats": f"part{p}/node_feat.npz",
            "edge_feats": f"part{p}/edge_feat.npz",
            "part_graph": f"part{p}/graph.npz",
            "num_inner_nodes": int(len(core)),
            "num_local_nodes": int(len(local_nodes)),
            "num_edges": int(len(own_edges)),
        }
        if feat_paths:
            meta[f"part-{p}"]["node_feat_files"] = feat_paths
        if ooc:
            # the source pages this part's gathers faulted in
            _ooc.release_pages(g.src, g.dst, *g.ndata.values())
    cfg = os.path.join(out_path, f"{graph_name}.json")
    with open(cfg, "w") as f:
        json.dump(meta, f, sort_keys=True, indent=4)
    return cfg


class GraphPartition:
    """One loaded partition: local graph (``[core | halo]`` order, global
    ids in ``orig_id``) + features + the partition book's node map."""

    def __init__(self, part_dir_cfg: str, part_id: int):
        with open(part_dir_cfg) as f:
            self.meta = json.load(f)
        base = os.path.dirname(part_dir_cfg)
        self.part_id = part_id
        info = self.meta[f"part-{part_id}"]
        gz = np.load(os.path.join(base, info["part_graph"]))
        self.graph = Graph(gz["src"], gz["dst"], int(gz["num_nodes"]))
        self.orig_id = gz["orig_id"]
        self.orig_eid = gz["orig_eid"]
        self.inner_node = gz["inner_node"]
        self._halo_owner_part = (np.asarray(gz["halo_owner_part"])
                                 if "halo_owner_part" in gz.files
                                 else None)
        self._halo_owner_local = (np.asarray(gz["halo_owner_local"])
                                  if "halo_owner_local" in gz.files
                                  else None)
        nf = np.load(os.path.join(base, info["node_feats"]))
        self.graph.ndata.update({k: nf[k] for k in nf.files})
        # file-referenced feature entries: one .npy per key, opened
        # mmap'd so reads demand-page from disk
        for k, rel in info.get("node_feat_files", {}).items():
            self.graph.ndata[k] = np.load(os.path.join(base, rel),
                                          mmap_mode="r")
        ef = np.load(os.path.join(base, info["edge_feats"]))
        self.graph.edata.update({k: ef[k] for k in ef.files})
        self.node_map = np.load(os.path.join(base, self.meta["node_map"]))
        self._base = base
        self._sidecars = None
        # codes without their scales are meaningless: a quantized book
        # whose sidecar is missing fails at open, naming the key
        for k, q in self.meta.get("feat_quant", {}).items():
            if not os.path.exists(os.path.join(base, q["sidecar"])):
                raise ValueError(
                    f"partition book stores node feature {k!r} as "
                    f"{q['dtype']} codes but its scales sidecar "
                    f"{q['sidecar']!r} is missing next to the book "
                    "JSON — copy the book with its sidecar or "
                    "re-partition")

    @property
    def num_inner(self) -> int:
        return int(self.inner_node.sum())

    def node_split(self, mask_name: str) -> np.ndarray:
        """Local ids of the core nodes with ``mask_name`` set: the
        partition's seed set (``dgl.distributed.node_split``)."""
        sel = np.asarray(self.graph.ndata[mask_name], bool) & self.inner_node
        return np.nonzero(sel)[0].astype(np.int64)

    def _build_halo_manifest(self) -> None:
        """Reconstruct the halo ownership manifest from the node map
        (books written before the ``halo_manifest`` key)."""
        halo_gids = self.orig_id[~self.inner_node]
        rank = core_rank_of(self.node_map, int(self.meta["num_parts"]))
        self._halo_owner_part = self.node_map[halo_gids].astype(np.int32)
        self._halo_owner_local = rank[halo_gids].astype(np.int32)

    @property
    def halo_owner_part(self) -> np.ndarray:
        """[num_halo] int32 — owning part of each halo row."""
        if self._halo_owner_part is None:
            self._build_halo_manifest()
        return self._halo_owner_part

    @property
    def halo_owner_local(self) -> np.ndarray:
        """[num_halo] int32 — each halo row's core row in its owner."""
        if self._halo_owner_local is None:
            self._build_halo_manifest()
        return self._halo_owner_local

    def feat_sidecar(self, key: str) -> Optional[dict]:
        """The quantization sidecar of node feature ``key``:
        ``{"scale": [D] f32, "zero": [D] f32, "dtype": str}`` when the
        book stores ``key`` as codes, None for float storage. The
        scales are global, the same for every part."""
        q = self.meta.get("feat_quant", {})
        if key not in q:
            return None
        if self._sidecars is None:
            self._sidecars = quant.load_sidecar(
                os.path.join(self._base, q[key]["sidecar"]))
        return self._sidecars[key]
