"""The port's C++ graph core vs a build of the JAX package's, bit for bit.

The JAX package's ``native/graphcore.cc`` is compiled here with the
port's host flags into a temporary directory, and the JAX bridge is
pointed at that build (its own build output is never made or read).
All six functions must give identical outputs on karate club, a
300-node synthetic graph, a star and graphs without edges or nodes.
Where the contracts agree exactly, the port's plain numpy versions
must give the library's output too; elsewhere they must keep the
contract. A graph core that fails to build raises.

``use_jax_graphcore`` is shared with the other ``test_torch_*`` parity
files.
"""

import os
import subprocess

import numpy as np
import pytest

from dgl_operator_tpu.graph import _native as jax_native
from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu_torch.graph import _native, datasets
from dgl_operator_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SOURCE = os.path.join(REPO, "dgl_operator_tpu", "native", "graphcore.cc")
_JAX_BUILD = {}


def jax_graphcore(tmp_path_factory) -> str:
    """The JAX package's graph core compiled with the port's host flags
    into a temporary directory, once per test process."""
    if "path" not in _JAX_BUILD:
        out = tmp_path_factory.mktemp("jax_graphcore") / "libgraphcore.so"
        proc = subprocess.run(
            [_build.host_cxx(), *_build.HOST_CXXFLAGS, "-o", str(out),
             JAX_SOURCE], capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        _JAX_BUILD["path"] = str(out)
    return _JAX_BUILD["path"]


def use_jax_graphcore(monkeypatch, tmp_path_factory) -> None:
    """Point the JAX bridge at :func:`jax_graphcore` for one test."""
    monkeypatch.delenv(jax_native.LIB_PATH_ENV, raising=False)
    monkeypatch.delenv("DGL_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(jax_native, "_LIB_PATH",
                        jax_graphcore(tmp_path_factory))
    monkeypatch.setattr(jax_native, "_LIB", None)
    assert jax_native.native_available()


@pytest.fixture(autouse=True)
def jax_library(monkeypatch, tmp_path_factory):
    use_jax_graphcore(monkeypatch, tmp_path_factory)


def _star(leaves=60):
    """A hub with ``leaves`` in- and out-neighbours of degree 1."""
    leaf = np.arange(1, leaves + 1, dtype=np.int32)
    hub = np.zeros(leaves, dtype=np.int32)
    return np.concatenate([leaf, hub]), np.concatenate([hub, leaf]), \
        leaves + 1


def _graph(name):
    if name == "karate":
        g = jax_datasets.karate_club().graph
        return g.src, g.dst, g.num_nodes
    if name == "synth300":
        g = datasets.synthetic_node_clf(300, 1500, 8, 3, seed=2).graph
        return g.src, g.dst, g.num_nodes
    return _star()


GRAPHS = ["karate", "synth300", "star"]


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("name", GRAPHS)
def test_build_csr_matches_jax_library(name):
    src, dst, n = _graph(name)
    for rows, cols in ((src, dst), (dst, src)):
        got = _native.build_csr(rows, cols, n)
        _equal(got, jax_native.build_csr(rows, cols, n))
        _equal(got, _native.build_csr_plain(rows, cols, n))


def _csc(name):
    src, dst, n = _graph(name)
    return _native.build_csr(dst, src, n), src, dst, n


@pytest.mark.parametrize("fanout", [1, 3, 10])
@pytest.mark.parametrize("name", GRAPHS)
def test_sample_fanout_matches_jax_library(name, fanout):
    (indptr, indices, eids), src, dst, n = _csc(name)
    seeds = np.concatenate([np.arange(n), np.arange(n)[::3],
                            [-1, n, n + 7]]).astype(np.int64)
    for seed in (0, 9, 2**40 + 3):
        got = _native.sample_fanout(indptr, indices, eids, seeds, fanout,
                                    seed)
        _equal(got, jax_native.sample_fanout(indptr, indices, eids, seeds,
                                             fanout, seed))
    nbr, nbr_eid = got
    assert (nbr[-3:] == -1).all() and (nbr_eid[-3:] == -1).all()
    # the plain version: the same rows where the degree fits the fanout;
    # elsewhere both fill every slot with distinct in-edges of the seed
    inside = seeds[:-3]
    deg = (indptr[1:] - indptr[:-1])[inside]
    plain, plain_eid = _native.sample_fanout_plain(indptr, indices, eids,
                                                   inside, fanout, seed)
    small = deg <= fanout
    np.testing.assert_array_equal(nbr[:-3][small], plain[small])
    np.testing.assert_array_equal(nbr_eid[:-3][small], plain_eid[small])
    for rows, rows_eid in ((nbr[:-3], nbr_eid[:-3]), (plain, plain_eid)):
        for s, row, row_eid in zip(inside[~small], rows[~small],
                                   rows_eid[~small]):
            assert len(set(row_eid.tolist())) == fanout
            np.testing.assert_array_equal(dst[row_eid], s)
            np.testing.assert_array_equal(src[row_eid], row)


def _frontier_and_nbr(name, fanout=5):
    (indptr, indices, eids), _, _, n = _csc(name)
    frontier = np.arange(0, n, 4, dtype=np.int64)[:12]
    nbr, _ = _native.sample_fanout(indptr, indices, eids, frontier, fanout,
                                   3)
    return frontier, nbr


@pytest.mark.parametrize("cap", [None, "tight", "below_frontier"])
@pytest.mark.parametrize("name", GRAPHS)
def test_compact_frontier_matches_jax_library(name, cap):
    frontier, nbr = _frontier_and_nbr(name)
    nf = len(frontier)
    full = _native.compact_frontier(frontier, nbr, None, 4)
    cap = {None: None, "tight": nf + (len(full[0]) - nf) // 2,
           "below_frontier": nf - 3}[cap]
    for seed in (4, 2**63 + 11):
        got = _native.compact_frontier(frontier, nbr, cap, seed)
        _equal(got, jax_native.compact_frontier(frontier, nbr, cap, seed))
    if cap is None:
        _equal(got, _native.compact_frontier_plain(frontier, nbr, None, 4))
    for src, pos, mask in (got, _native.compact_frontier_plain(
            frontier, nbr, cap, 4)):
        np.testing.assert_array_equal(src[:nf], frontier)
        assert list(src[nf:]) == sorted(set(src[nf:].tolist()))
        if cap is not None:
            assert len(src) == max(cap, nf)
        resolved = src[pos.reshape(-1)].reshape(pos.shape)
        assert ((resolved == nbr) | (mask == 0)).all()
        assert ((nbr >= 0) | (mask == 0)).all()
        assert (pos[mask == 0] == 0).all()


@pytest.mark.parametrize("num_parts", [1, 2, 3, 4])
@pytest.mark.parametrize("name", GRAPHS)
def test_greedy_partition_matches_jax_library(name, num_parts):
    src, dst, n = _graph(name)
    indptr, indices, _ = _native.build_csr(src, dst, n)
    for seed in (0, 5):
        got = _native.greedy_partition(indptr, indices, num_parts, seed)
        want = jax_native.greedy_partition(indptr, indices, num_parts, seed)
        _equal([got], [want])
    assert sorted(set(got.tolist())) == list(range(num_parts))


def _weights(n_edges, n, seed):
    rng = np.random.default_rng(seed)
    # float weights whose sums depend on their order
    return (rng.random(n_edges, dtype=np.float32) * 3 + 0.1,
            rng.random(n, dtype=np.float32) * 2 + 0.5)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", GRAPHS)
def test_hem_coarsen_matches_jax_library(name, seed):
    src, dst, n = _graph(name)
    for unit, (w, vw) in (
            (True, (np.ones(len(src), np.float32), np.ones(n, np.float32))),
            (False, _weights(len(src), n, seed))):
        got = _native.hem_coarsen(src, dst, w, vw, n, seed)
        _equal(got, jax_native.hem_coarsen(src, dst, w, vw, n, seed))
        plain = _native.hem_coarsen_plain(src, dst, w, vw, n, seed)
        # the plain version sums weights in float64: exact where the
        # library's float32 sums are (integer weights, the partitioner's)
        _equal(got[:4], plain[:4])
        if unit:
            _equal(got[4:], plain[4:])
        else:
            for a, b in zip(got[4:], plain[4:]):
                np.testing.assert_allclose(a, b, rtol=1e-6)
        coarse_id, nc, cu, cv, cw, cvw = got
        assert (cu < cv).all() and nc == coarse_id.max() + 1
        np.testing.assert_allclose(cvw.sum(), vw.sum(), rtol=1e-5)


def _cut(src, dst, w, parts):
    return float(w[parts[src] != parts[dst]].sum())


@pytest.mark.parametrize("num_parts", [2, 3, 4])
@pytest.mark.parametrize("name", GRAPHS)
def test_refine_boundary_matches_jax_library(name, num_parts):
    src, dst, n = _graph(name)
    w, vw = _weights(len(src), n, num_parts)
    start = (np.random.default_rng(num_parts).permutation(n) * num_parts
             // n).astype(np.int32)
    cap = 1.1 * float(vw.sum()) / num_parts
    for iters in (1, 4):
        got = _native.refine_boundary(src, dst, w, vw, n, num_parts, cap,
                                      iters, start)
        want = jax_native.refine_boundary(src, dst, w, vw, n, num_parts,
                                          cap, iters, start)
        _equal([got], [want])
    assert _cut(src, dst, w, got) <= _cut(src, dst, w, start)
    plain = _native.refine_boundary_plain(src, dst, w, vw, n, num_parts,
                                          cap, 4, start)
    for parts in (got, plain):
        assert parts.dtype == np.int32 and parts.min() >= 0
        assert parts.max() < num_parts
        pw = np.bincount(parts, weights=vw.astype(np.float64),
                         minlength=num_parts)
        start_pw = np.bincount(start, weights=vw.astype(np.float64),
                               minlength=num_parts)
        # a part moves no vertex in past the cap it started within
        assert (pw <= np.maximum(cap, start_pw) + 1e-3).all()


@pytest.mark.parametrize("n", [0, 5])
def test_graphs_without_edges_match_jax_library(n):
    src = dst = np.zeros(0, dtype=np.int32)
    w, vw = np.zeros(0, np.float32), np.ones(n, np.float32)
    csr = _native.build_csr(src, dst, n)
    _equal(csr, jax_native.build_csr(src, dst, n))
    seeds = np.arange(n, dtype=np.int64)
    _equal(_native.sample_fanout(*csr, seeds, 3, 1),
           jax_native.sample_fanout(*csr, seeds, 3, 1))
    nbr = np.full((n, 3), -1, np.int32)
    for cap in (None, 2):
        _equal(_native.compact_frontier(seeds, nbr, cap, 1),
               jax_native.compact_frontier(seeds, nbr, cap, 1))
    for k in (1, 3):
        got = _native.greedy_partition(csr[0], csr[1], k, 2)
        want = jax_native.greedy_partition(csr[0], csr[1], k, 2)
        # with no nodes neither writes a part; compare what is assigned
        assert got.shape == want.shape == (n,)
        if n:
            _equal([got], [want])
    _equal(_native.hem_coarsen(src, dst, w, vw, n, 3),
           jax_native.hem_coarsen(src, dst, w, vw, n, 3))
    parts = np.arange(n, dtype=np.int32) % 2
    _equal([_native.refine_boundary(src, dst, w, vw, n, 2, 3.0, 2, parts)],
           [jax_native.refine_boundary(src, dst, w, vw, n, 2, 3.0, 2,
                                       parts)])


def test_library_refuses_ids_outside_the_graph():
    src, dst, n = _star(5)
    with pytest.raises(ValueError, match="rows must lie"):
        _native.build_csr(dst, src, n - 1)
    w, vw = np.ones(len(src), np.float32), np.ones(n, np.float32)
    with pytest.raises(ValueError, match="vw must hold"):
        _native.hem_coarsen(src, dst, w, vw[:-1], n)
    with pytest.raises(ValueError, match="parts must lie"):
        _native.refine_boundary(src, dst, w, vw, n, 2, 9.0, 1,
                                np.full(n, 2, np.int32))
    indptr, indices, eids = _native.build_csr(dst, src, n)
    with pytest.raises(ValueError, match="indptr ends"):
        _native.sample_fanout(indptr, indices[:-1], eids,
                              np.arange(n), 2, 0)


@pytest.mark.parametrize("cxx", ["/nonexistent/bin/c++", "false"])
def test_failed_graph_core_build_raises(tmp_path, monkeypatch, cxx):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError, match="not found|failed on graphcore"):
        _build.build_host("graphcore.cc")
    assert not [f for f in os.listdir(tmp_path / "build")
                if f.endswith(".so")]


def test_graph_core_builds_once_with_the_fixed_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    first = _build.build_host("graphcore.cc")
    again = _build.build_host("graphcore.cc")
    assert first.path == again.path and again.seconds == 0.0
    assert os.path.dirname(first.path) == str(tmp_path)
    assert _build.HOST_CXXFLAGS == ("-O2", "-std=c++17", "-fPIC", "-Wall",
                                    "-shared")


def test_threads_build_once_and_sample_alike(tmp_path, monkeypatch):
    """Sixteen threads (more than the cores) start on a fresh build
    directory at once, with a short switch interval: the graph core is
    built once, and every thread's batches equal the sequential ones
    (the library keeps no state between calls)."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from dgl_operator_tpu_torch.graph.blocks import build_fanout_blocks

    (indptr, indices, eids), _, _, n = _csc("synth300")
    csc = (indptr, indices, eids)
    jobs = [(np.arange(i, n, 17, dtype=np.int64), i) for i in range(16)]

    def run(job):
        seeds, seed = job
        return [build_fanout_blocks(csc, seeds, (3, 5), seed=seed,
                                    src_caps=(40, 120)) for _ in range(3)]

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            futures = [pool.submit(run, job) for job in jobs]
            results = [f.result(timeout=120) for f in futures]
    finally:
        sys.setswitchinterval(old)
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".so")]) == 1
    for job, runs in zip(jobs, results):
        want = run(job)[0]
        for got in runs:
            np.testing.assert_array_equal(got.input_nodes, want.input_nodes)
            for a, b in zip(got.blocks, want.blocks):
                np.testing.assert_array_equal(a.nbr, b.nbr)
                np.testing.assert_array_equal(a.mask, b.mask)
