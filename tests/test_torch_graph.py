"""Port graph layer vs the JAX package's, bit for bit.

Datasets, CSR construction, fanout sampling, padding, caps and the
hot-halo cache must give identical arrays for the same seeds. The JAX
bridge runs a build of its own C++ graph core
(``test_torch_native.use_jax_graphcore``), which the port's library
must match; the port's plain numpy versions (``build_fanout_blocks(...,
plain=True)``) must match the JAX package's numpy fallbacks
(``_native._LIB = False``). Partition books written by either package
read identically in both.
"""

import json

import numpy as np
import pytest

from dgl_operator_tpu.graph import _native as jax_native
from dgl_operator_tpu.graph import blocks as jax_blocks
from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu.graph import partition as jax_partition
from dgl_operator_tpu.parallel import halo as jax_halo
from dgl_operator_tpu_torch.graph import _native, blocks, datasets, partition
from dgl_operator_tpu_torch.graph.featstore import PagedFeatureStore
from dgl_operator_tpu_torch.parallel import halo
from test_torch_native import use_jax_graphcore

FANOUTS = (3, 5)


@pytest.fixture(autouse=True)
def jax_library(monkeypatch, tmp_path_factory):
    use_jax_graphcore(monkeypatch, tmp_path_factory)


@pytest.fixture(scope="module")
def graphs():
    return (jax_datasets.synthetic_node_clf(300, 1500, 8, 3, seed=2),
            datasets.synthetic_node_clf(300, 1500, 8, 3, seed=2))


def _assert_graphs_equal(a, b):
    assert a.num_nodes == b.num_nodes
    np.testing.assert_array_equal(a.src, b.src)
    np.testing.assert_array_equal(a.dst, b.dst)
    assert sorted(a.ndata) == sorted(b.ndata)
    for k in a.ndata:
        np.testing.assert_array_equal(a.ndata[k], b.ndata[k])


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_node_clf_matches_jax(seed):
    _assert_graphs_equal(
        jax_datasets.synthetic_node_clf(250, 1200, 6, 4, seed=seed).graph,
        datasets.synthetic_node_clf(250, 1200, 6, 4, seed=seed).graph)


def test_ogbn_products_matches_jax():
    a = jax_datasets.ogbn_products(seed=1, scale=0.0005)
    b = datasets.ogbn_products(seed=1, scale=0.0005)
    assert (a.num_classes, b.num_classes) == (47, 47)
    assert b.graph.ndata["feat"].shape == (1224, 100)
    _assert_graphs_equal(a.graph, b.graph)


def test_build_csr_matches_jax(graphs):
    a, b = graphs
    for x, y in zip(a.graph.csc(), b.graph.csc()):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.graph.csr(), b.graph.csr()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.graph.in_degrees(), b.graph.in_degrees())
    np.testing.assert_array_equal(a.graph.out_degrees(),
                                  b.graph.out_degrees())
    assert b.graph.in_degrees().dtype == np.int32
    for x, y in zip(jax_native.build_csr(a.graph.src, a.graph.dst, 300),
                    _native.build_csr(b.graph.src, b.graph.dst, 300)):
        np.testing.assert_array_equal(x, y)


def test_plain_versions_match_jax_numpy_fallbacks(graphs, monkeypatch):
    a, b = graphs
    monkeypatch.setattr(jax_native, "_LIB", False)
    src, dst = b.graph.src, b.graph.dst
    for x, y in zip(jax_native.build_csr(src, dst, 300),
                    _native.build_csr_plain(src, dst, 300)):
        np.testing.assert_array_equal(x, y)
    indptr, indices, eids = b.graph.csc()
    seeds = np.arange(0, 300, 7, dtype=np.int64)
    for x, y in zip(jax_native.sample_fanout(indptr, indices, eids, seeds,
                                             4, 3),
                    _native.sample_fanout_plain(indptr, indices, eids,
                                                seeds, 4, 3)):
        np.testing.assert_array_equal(x, y)
    nbr, _ = _native.sample_fanout_plain(indptr, indices, eids, seeds, 4, 3)
    for cap in (None, len(seeds) + 20):
        for x, y in zip(jax_native.compact_frontier(seeds, nbr, cap, 8),
                        _native.compact_frontier_plain(seeds, nbr, cap, 8)):
            np.testing.assert_array_equal(x, y)
    w, vw = np.ones(len(src), np.float32), np.ones(300, np.float32)
    for x, y in zip(jax_native.hem_coarsen(src, dst, w, vw, 300, 2),
                    _native.hem_coarsen_plain(src, dst, w, vw, 300, 2)):
        np.testing.assert_array_equal(x, y)
    parts = (np.arange(300) % 3).astype(np.int32)
    np.testing.assert_array_equal(
        jax_native.refine_boundary(src, dst, w, vw, 300, 3, 110.0, 3, parts,
                                   seed=4),
        _native.refine_boundary_plain(src, dst, w, vw, 300, 3, 110.0, 3,
                                      parts, seed=4))


def _assert_minibatches_equal(a, b):
    np.testing.assert_array_equal(a.input_nodes, b.input_nodes)
    np.testing.assert_array_equal(a.seeds, b.seeds)
    assert len(a.blocks) == len(b.blocks)
    for x, y in zip(a.blocks, b.blocks):
        assert x.num_src == y.num_src
        np.testing.assert_array_equal(x.nbr, y.nbr)
        np.testing.assert_array_equal(x.mask, y.mask)
        assert np.asarray(x.mask).dtype == np.asarray(y.mask).dtype


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("src_caps", [None, (40, 120)])
@pytest.mark.parametrize("sample_seed", [0, 17])
def test_build_fanout_blocks_matches_jax(graphs, src_caps, sample_seed,
                                         plain, monkeypatch):
    """The port's library stream against the JAX library's; its plain
    stream against the JAX numpy fallbacks'."""
    a, b = graphs
    if plain:
        monkeypatch.setattr(jax_native, "_LIB", False)
    seeds = np.arange(0, 300, 23, dtype=np.int64)
    ma = jax_blocks.build_fanout_blocks(a.graph.csc(), seeds, FANOUTS,
                                        seed=sample_seed, src_caps=src_caps)
    mb = blocks.build_fanout_blocks(b.graph.csc(), seeds, FANOUTS,
                                    seed=sample_seed, src_caps=src_caps,
                                    plain=plain)
    _assert_minibatches_equal(ma, mb)
    caps = jax_blocks.fanout_caps(16, FANOUTS, 300)
    assert caps == blocks.fanout_caps(16, FANOUTS, 300)
    _assert_minibatches_equal(
        jax_blocks.pad_minibatch(ma, 16, FANOUTS, 300),
        blocks.pad_minibatch(mb, 16, FANOUTS, 300))


def test_fanout_caps_and_calibrate_caps_match_jax(graphs):
    a, b = graphs
    for n in (None, 50, 10_000):
        assert (jax_blocks.fanout_caps(8, (10, 25), n)
                == blocks.fanout_caps(8, (10, 25), n))
    ids = np.arange(120)
    assert (jax_blocks.calibrate_caps(a.graph.csc(), ids, 16, FANOUTS,
                                      300, n_probe=4, seed=3)
            == blocks.calibrate_caps(b.graph.csc(), ids, 16, FANOUTS, 300,
                                     n_probe=4, seed=3))


def test_pad_minibatch_rejects_overflow(graphs):
    _, b = graphs
    mb = blocks.build_fanout_blocks(b.graph.csc(),
                                    np.arange(16, dtype=np.int64), FANOUTS)
    with pytest.raises(ValueError, match="exceeds caps"):
        blocks.pad_minibatch(mb, 16, FANOUTS, caps=[16, 17, 18])


@pytest.mark.parametrize("cache_rows", [0, 5, 400])
def test_build_halo_cache_matches_jax(cache_rows):
    rng = np.random.default_rng(cache_rows)
    src = rng.integers(0, 90, size=600)
    for x, y in zip(jax_halo.build_halo_cache(src, 90, 60, cache_rows),
                    halo.build_halo_cache(src, 90, 60, cache_rows)):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype


def _parts(n, k=3):
    return np.random.default_rng(0).permutation(n) % k


def _assert_partitions_equal(a, b):
    assert a.num_inner == b.num_inner
    _assert_graphs_equal(a.graph, b.graph)
    for k in a.graph.edata:
        np.testing.assert_array_equal(a.graph.edata[k], b.graph.edata[k])
    for name in ("orig_id", "orig_eid", "inner_node", "node_map",
                 "halo_owner_part", "halo_owner_local"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("ooc", [False, True])
def test_jax_book_reads_identically_in_both(graphs, tmp_path, ooc):
    a, _ = graphs
    cfg = jax_partition.partition_graph(
        a.graph, "g", 3, str(tmp_path), parts=_parts(300), ooc=ooc)
    for p in range(3):
        ja = jax_partition.GraphPartition(cfg, p)
        pa = partition.GraphPartition(cfg, p)
        _assert_partitions_equal(ja, pa)
        store = PagedFeatureStore(pa.graph.ndata["feat"], pa.num_inner,
                                  np.arange(2))
        assert store.paged == ooc
        np.testing.assert_array_equal(
            store.core_rows(np.arange(3)),
            np.asarray(ja.graph.ndata["feat"][:3], np.float32))


def test_port_book_reads_in_jax(graphs, tmp_path):
    a, b = graphs
    jcfg = jax_partition.partition_graph(a.graph, "g", 3,
                                         str(tmp_path / "jax"),
                                         parts=_parts(300))
    pcfg = partition.partition_graph(b.graph, "g", 3,
                                     str(tmp_path / "port"),
                                     parts=_parts(300))
    with open(jcfg) as f:
        jmeta = json.load(f)
    with open(pcfg) as f:
        pmeta = json.load(f)
    jmeta.pop("part_method")
    pmeta.pop("part_method")
    assert jmeta == pmeta
    for p in range(3):
        _assert_partitions_equal(jax_partition.GraphPartition(jcfg, p),
                                 jax_partition.GraphPartition(pcfg, p))


def test_partition_graph_refuses_what_is_not_ported(graphs, tmp_path):
    """Computing the assignment is ported (``parts=None`` writes a
    multilevel book), and so are quantized and out-of-core storage:
    ``feat_dtype="int8"`` writes codes with a sidecar, ``ooc=True``
    file-referenced features; an out-of-range assignment, an unknown
    storage dtype and a negative budget are refused."""
    _, b = graphs
    cfg = partition.partition_graph(b.graph, "g", 2, str(tmp_path / "ml"))
    with open(cfg) as f:
        assert json.load(f)["part_method"] == "multilevel-native"
    assert sorted(set(np.load(tmp_path / "ml" / "node_map.npy"))) == [0, 1]
    q = partition.partition_graph(b.graph, "g", 2, str(tmp_path / "q"),
                                  parts=_parts(300, 2), feat_dtype="int8")
    p = partition.GraphPartition(q, 0)
    assert p.graph.ndata["feat"].dtype == np.int8
    assert p.feat_sidecar("feat")["dtype"] == "int8"
    o = partition.partition_graph(b.graph, "g", 2, str(tmp_path / "o"),
                                  ooc=True)
    with open(o) as f:
        assert "ooc_spill_mib" in json.load(f)
    assert isinstance(partition.GraphPartition(o, 1).graph.ndata["feat"],
                      np.memmap)
    with pytest.raises(ValueError, match="parts values"):
        partition.partition_graph(b.graph, "g", 2, str(tmp_path),
                                  parts=_parts(300, 3))
    with pytest.raises(ValueError):
        partition.partition_graph(b.graph, "g", 2, str(tmp_path),
                                  parts=_parts(300, 2), feat_dtype="int4")
    with pytest.raises(ValueError):
        partition.partition_graph(b.graph, "g", 2, str(tmp_path), ooc=True,
                                  ooc_budget_mb=-1)


def test_quantized_jax_book_is_refused(graphs, tmp_path):
    """A JAX int8 book reads in the port: its codes and sidecar, and a
    store that dequantizes them (codes without their sidecar are still
    refused)."""
    a, _ = graphs
    cfg = jax_partition.partition_graph(a.graph, "g", 2, str(tmp_path),
                                        parts=_parts(300, 2),
                                        feat_dtype="int8")
    p = partition.GraphPartition(cfg, 0)
    sc = p.feat_sidecar("feat")
    want = jax_partition.GraphPartition(cfg, 0).feat_sidecar("feat")
    np.testing.assert_array_equal(sc["scale"], want["scale"])
    store = PagedFeatureStore(p.graph.ndata["feat"], p.num_inner,
                              np.arange(2), sidecar=sc)
    rows = store.core_rows(np.arange(4))
    assert rows.dtype == np.float32
    np.testing.assert_allclose(rows, a.graph.ndata["feat"][p.orig_id[:4]],
                               atol=float(sc["scale"].max()) / 2 + 1e-6)
    with pytest.raises(ValueError, match="sidecar"):
        PagedFeatureStore(p.graph.ndata["feat"], p.num_inner, np.arange(2))


