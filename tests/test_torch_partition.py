"""The port's partitioner vs the JAX package's, both on their graph cores.

The JAX bridge is pointed at a build of its own ``graphcore.cc``
(``test_torch_native.use_jax_graphcore``). Then the same graph, part
count and seed must give the same node map from each piece of the
partitioner (LDG, LPA communities, quota enforcement, LP refinement,
``partition_assignment``, ``multilevel_partition``) and from
``partition_graph(parts=None)`` with either method, with and without
``balance_ntypes``, ``balance_edges`` and ``communities``; each
package's book reads identically in the other.
"""

import json

import numpy as np
import pytest

from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu.graph import partition as jax_partition
from dgl_operator_tpu.graph.graph import Graph as JaxGraph
from dgl_operator_tpu_torch.graph import datasets, partition
from dgl_operator_tpu_torch.graph.graph import Graph
from test_torch_native import use_jax_graphcore


@pytest.fixture(autouse=True)
def jax_library(monkeypatch, tmp_path_factory):
    use_jax_graphcore(monkeypatch, tmp_path_factory)


def _pair(name):
    """The same graph as a JAX and as a port ``Graph``, with features,
    labels and a train mask."""
    if name == "synth300":
        return (jax_datasets.synthetic_node_clf(300, 1500, 8, 3,
                                                seed=2).graph,
                datasets.synthetic_node_clf(300, 1500, 8, 3, seed=2).graph)
    if name == "karate":
        jg = jax_datasets.karate_club().graph
    else:   # a star: matching stalls at once
        leaf = np.arange(1, 81, dtype=np.int32)
        hub = np.zeros(80, dtype=np.int32)
        jg = JaxGraph(np.concatenate([leaf, hub]),
                      np.concatenate([hub, leaf]), 81)
        rng = np.random.default_rng(1)
        jg.ndata["feat"] = rng.random((81, 4), dtype=np.float32)
        jg.ndata["label"] = (np.arange(81) % 3).astype(np.int32)
        jg.ndata["train_mask"] = np.arange(81) % 4 == 0
    pg = Graph(jg.src, jg.dst, jg.num_nodes)
    pg.ndata = {k: np.asarray(v) for k, v in jg.ndata.items()}
    return jg, pg


GRAPHS = ["synth300", "karate", "star"]
VARIANTS = {
    "plain": {},
    "ntypes": {"balance_ntypes": "train_mask"},
    "edges": {"balance_edges": True},
    "communities": {"communities": "label"},
    "all": {"balance_ntypes": "train_mask", "balance_edges": True,
            "communities": "label"},
}


def _kwargs(variant, g):
    return {k: (g.ndata[v] if isinstance(v, str) else v)
            for k, v in VARIANTS[variant].items()}


def _same(got, want):
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_parts", [2, 3, 4])
@pytest.mark.parametrize("name", GRAPHS)
def test_seed_pieces_match_jax(name, num_parts):
    jg, pg = _pair(name)
    mask = pg.ndata["train_mask"]
    for kw in ({}, {"balance_ntypes": mask, "balance_edges": True}):
        _same(partition.ldg_partition(pg, num_parts, 3, **kw),
              jax_partition.ldg_partition(jg, num_parts, 3, **kw))
    labels = partition.lp_communities(pg, seed=4)
    np.testing.assert_array_equal(labels,
                                  jax_partition.lp_communities(jg, seed=4))
    np.testing.assert_array_equal(
        partition.lp_communities(pg, seed=4, edge_sample=pg.num_edges // 3),
        jax_partition.lp_communities(jg, seed=4,
                                     edge_sample=jg.num_edges // 3))
    _same(partition.communities_to_parts(labels, num_parts),
          jax_partition.communities_to_parts(labels, num_parts))
    start = (np.arange(pg.num_nodes) % num_parts).astype(np.int32)
    _same(partition.enforce_type_quotas(pg, start, num_parts, mask),
          jax_partition.enforce_type_quotas(jg, start, num_parts, mask))
    for kw in ({}, {"balance_ntypes": mask, "balance_edges": True}):
        _same(partition.refine_partition(pg, start, num_parts, iters=5,
                                         seed=2, **kw),
              jax_partition.refine_partition(jg, start, num_parts, iters=5,
                                             seed=2, **kw))
    assert partition.edge_cut(pg, start) == jax_partition.edge_cut(jg, start)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("num_parts", [2, 3])
@pytest.mark.parametrize("name", GRAPHS)
def test_partition_assignment_matches_jax(name, num_parts, variant):
    jg, pg = _pair(name)
    got = partition.partition_assignment(pg, num_parts, seed=1,
                                         **_kwargs(variant, pg))
    _same(got, jax_partition.partition_assignment(jg, num_parts, seed=1,
                                                  **_kwargs(variant, jg)))
    assert set(got.tolist()) == set(range(num_parts))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("num_parts", [2, 4])
@pytest.mark.parametrize("name", GRAPHS)
def test_multilevel_partition_matches_jax(name, num_parts, variant):
    jg, pg = _pair(name)
    got = partition.multilevel_partition(pg, num_parts, seed=2,
                                         **_kwargs(variant, pg))
    _same(got, jax_partition.multilevel_partition(jg, num_parts, seed=2,
                                                  **_kwargs(variant, jg)))
    sizes = np.bincount(got, minlength=num_parts)
    assert sizes.min() > 0


def test_multilevel_partition_edge_cases_match_jax():
    jg, pg = _pair("synth300")
    for k in (1, 2):
        _same(partition.multilevel_partition(pg, k, coarsen_to=40,
                                             refine_iters=0),
              jax_partition.multilevel_partition(jg, k, coarsen_to=40,
                                                 refine_iters=0))
    empty = (partition.multilevel_partition(Graph([], [], 0), 2),
             jax_partition.multilevel_partition(JaxGraph([], [], 0), 2))
    assert empty[0].shape == empty[1].shape == (0,)
    isolated = (Graph([], [], 9), JaxGraph([], [], 9))
    _same(partition.multilevel_partition(isolated[0], 3),
          jax_partition.multilevel_partition(isolated[1], 3))
    _same(partition.partition_assignment(isolated[0], 3),
          jax_partition.partition_assignment(isolated[1], 3))
    with pytest.raises(ValueError, match="communities"):
        partition.multilevel_partition(pg, 2, communities=np.zeros(5))


def _book(cfg):
    with open(cfg) as f:
        return json.load(f)


def _assert_books_read_alike(cfg, num_parts):
    for p in range(num_parts):
        a = jax_partition.GraphPartition(cfg, p)
        b = partition.GraphPartition(cfg, p)
        assert a.num_inner == b.num_inner
        np.testing.assert_array_equal(a.graph.src, b.graph.src)
        np.testing.assert_array_equal(a.graph.dst, b.graph.dst)
        for k in a.graph.ndata:
            np.testing.assert_array_equal(a.graph.ndata[k], b.graph.ndata[k])
        for name in ("orig_id", "orig_eid", "inner_node", "node_map",
                     "halo_owner_part", "halo_owner_local"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("variant", ["plain", "all"])
@pytest.mark.parametrize("method", ["multilevel", "flat"])
@pytest.mark.parametrize("name", GRAPHS)
def test_partition_graph_matches_jax(tmp_path, name, method, variant):
    jg, pg = _pair(name)
    kw = dict(seed=5, part_method=method, refine_iters=3)
    jcfg = jax_partition.partition_graph(jg, "g", 3, str(tmp_path / "jax"),
                                         **kw, **_kwargs(variant, jg))
    pcfg = partition.partition_graph(pg, "g", 3, str(tmp_path / "port"),
                                     **kw, **_kwargs(variant, pg))
    jmeta, pmeta = _book(jcfg), _book(pcfg)
    assert pmeta["part_method"] == jmeta["part_method"] == \
        f"{method}-native"
    assert pmeta == jmeta
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "node_map.npy"),
                                  np.load(tmp_path / "jax" / "node_map.npy"))
    _assert_books_read_alike(jcfg, 3)
    _assert_books_read_alike(pcfg, 3)


def test_partition_graph_default_is_multilevel(tmp_path):
    jg, pg = _pair("synth300")
    cfg = partition.partition_graph(pg, "g", 2, str(tmp_path))
    assert _book(cfg)["part_method"] == "multilevel-native"
    _same(np.load(tmp_path / "node_map.npy"),
          jax_partition.multilevel_partition(jg, 2))


@pytest.mark.parametrize("bad,match", [
    ({"part_method": "metis"}, "unknown part_method 'metis'"),
    ({"refine_iters": -1}, "refine_iters must be >= 0, got -1"),
])
def test_partition_graph_checks_its_knobs(tmp_path, bad, match):
    _, pg = _pair("karate")
    with pytest.raises(ValueError, match=match):
        partition.partition_graph(pg, "g", 2, str(tmp_path), **bad)
    jg, _ = _pair("karate")
    with pytest.raises(ValueError, match=match):
        jax_partition.partition_graph(jg, "g", 2, str(tmp_path), **bad)
