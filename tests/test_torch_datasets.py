"""The port's dataset readers and the partitioner's entry point against
the JAX package's.

The OGB node-property reader (with a shipped split scheme, gzipped and
plain CSVs, and without a split) and the LINQS Cora reader on files
written into ``tmp_path``; ``ogbn_products(strict=True)`` refusing a
root without the layout; ``karate_club``; ``stage_dataset_url`` on a
zip, a tar (and a tar whose member escapes, refused), a directory and a
plain file, and refusing http(s); and
``examples/load_and_partition_graph.py`` writing the same book as the
JAX example, on the synthetic graph and on a staged OGB archive.
"""

import gzip
import importlib.util
import json
import os
import tarfile
import zipfile

import numpy as np
import pytest

from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu_torch.examples import load_and_partition_graph as lpg
from dgl_operator_tpu_torch.graph import datasets
from test_torch_native import use_jax_graphcore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_node_clf(a, b):
    assert (a.num_classes, a.name) == (b.num_classes, b.name)
    ga, gb = a.graph, b.graph
    assert ga.num_nodes == gb.num_nodes
    np.testing.assert_array_equal(ga.src, gb.src)
    np.testing.assert_array_equal(ga.dst, gb.dst)
    assert set(ga.ndata) == set(gb.ndata)
    for k in ga.ndata:
        assert ga.ndata[k].dtype == gb.ndata[k].dtype, k
        np.testing.assert_array_equal(ga.ndata[k], gb.ndata[k], err_msg=k)


def _write_csv(path, rows, gz):
    text = "\n".join(",".join(str(v) for v in np.atleast_1d(r))
                     for r in rows) + "\n"
    if gz:
        with gzip.open(path + ".gz", "wt") as f:
            f.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)


def _ogb_layout(root, n=50, split=True, gz=True, seed=0):
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "ogbn_products")
    raw = os.path.join(base, "raw")
    os.makedirs(raw)
    edges = rng.integers(0, n, size=(4 * n, 2))
    _write_csv(os.path.join(raw, "edge.csv"), edges, gz)
    _write_csv(os.path.join(raw, "node-feat.csv"),
               np.round(rng.normal(size=(n, 6)), 4), gz)
    _write_csv(os.path.join(raw, "node-label.csv"),
               rng.integers(0, 5, size=n), gz)
    if split:
        perm = rng.permutation(n)
        for name, part in (("train", perm[:30]), ("valid", perm[30:40]),
                           ("test", perm[40:])):
            sdir = os.path.join(base, "split", "sales_ranking")
            os.makedirs(sdir, exist_ok=True)
            _write_csv(os.path.join(sdir, f"{name}.csv"), part, gz)
    return root


@pytest.mark.parametrize("split,gz", [(True, True), (True, False),
                                      (False, True)])
def test_ogb_reader_matches_jax(tmp_path, split, gz):
    root = _ogb_layout(str(tmp_path), split=split, gz=gz)
    want = jax_datasets.ogbn_products(root=root)
    got = datasets.ogbn_products(root=root)
    _same_node_clf(got, want)
    assert got.graph.num_nodes == 50 and got.graph.num_edges == 400
    if split:
        assert got.graph.ndata["train_mask"].sum() == 30


def test_ogbn_products_strict_refuses_a_root_without_the_layout(tmp_path):
    with pytest.raises(FileNotFoundError, match="refusing synthetic"):
        datasets.ogbn_products(root=str(tmp_path), strict=True)
    with pytest.raises(FileNotFoundError):
        jax_datasets.ogbn_products(root=str(tmp_path), strict=True)
    # without strict a missing layout gives the synthetic graph
    _same_node_clf(datasets.ogbn_products(root=str(tmp_path), scale=0.0005),
                   jax_datasets.ogbn_products(root=str(tmp_path),
                                              scale=0.0005))


def _linqs(root, sub):
    base = os.path.join(root, sub) if sub else root
    os.makedirs(base, exist_ok=True)
    rng = np.random.default_rng(3)
    ids = [str(1000 + 7 * i) for i in range(40)]
    classes = ["Neural_Networks", "Theory", "Case_Based"]
    with open(os.path.join(base, "cora.content"), "w") as f:
        for i in ids:
            words = rng.integers(0, 2, size=12)
            f.write("\t".join([i] + [str(w) for w in words]
                              + [classes[int(rng.integers(0, 3))]]) + "\n")
        f.write("short\tline\n")
    with open(os.path.join(base, "cora.cites"), "w") as f:
        for _ in range(90):
            a, b = rng.integers(0, 40, size=2)
            f.write(f"{ids[a]}\t{ids[b]}\n")
        f.write("999\t1000\n")          # an unknown id is skipped
    return root


@pytest.mark.parametrize("sub", ["", "cora"])
def test_cora_reader_matches_jax(tmp_path, sub):
    root = _linqs(str(tmp_path), sub)
    want = jax_datasets.cora(root=root)
    got = datasets.cora(root=root)
    _same_node_clf(got, want)
    assert got.graph.num_nodes == 40 and got.num_classes == 3
    assert got.graph.ndata["feat"].shape == (40, 12)
    # an empty root falls back to the synthetic Cora, seeded as asked
    _same_node_clf(datasets.cora(root=str(tmp_path / "none"), seed=2),
                   jax_datasets.cora(root=str(tmp_path / "none"), seed=2))


def test_karate_club_matches_jax():
    got = datasets.karate_club()
    _same_node_clf(got, jax_datasets.karate_club())
    assert got.graph.num_nodes == 34 and got.graph.num_edges == 156


def _tree(path):
    out = {}
    for base, _, files in os.walk(path):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, path)] = fh.read()
    return out


def test_stage_dataset_url(tmp_path):
    src = _ogb_layout(str(tmp_path / "src"))
    want = _tree(src)
    # a directory is used in place, by path or file:// URL
    assert lpg.stage_dataset_url(src, str(tmp_path / "ws0")) == src
    assert lpg.stage_dataset_url("file://" + src, str(tmp_path)) == src
    zpath = str(tmp_path / "ds.zip")
    with zipfile.ZipFile(zpath, "w") as z:
        for rel in want:
            z.write(os.path.join(src, rel), rel)
    tpath = str(tmp_path / "ds.tar.gz")
    with tarfile.open(tpath, "w:gz") as t:
        t.add(src, arcname=".")
    for i, archive in enumerate((zpath, "file://" + tpath)):
        ws = str(tmp_path / f"ws{i + 1}")
        root = lpg.stage_dataset_url(archive, ws)
        assert root == os.path.join(ws, "dataset_download")
        assert _tree(root) == want
        _same_node_clf(datasets.ogbn_products(root=root, strict=True),
                       jax_datasets.ogbn_products(root=src))
    # a plain file is copied in
    plain = tmp_path / "notes.txt"
    plain.write_text("x")
    got = lpg.stage_dataset_url(str(plain), str(tmp_path / "ws3"))
    assert _tree(got) == {"notes.txt": b"x"}


def test_stage_dataset_url_refuses(tmp_path):
    for url in ("http://example.invalid/ds.zip",
                "https://example.invalid/ds.zip"):
        with pytest.raises(RuntimeError, match="no network access"):
            lpg.stage_dataset_url(url, str(tmp_path))
    with pytest.raises(FileNotFoundError, match="missing"):
        lpg.stage_dataset_url(str(tmp_path / "absent.zip"), str(tmp_path))
    evil = str(tmp_path / "evil.tar")
    payload = tmp_path / "payload"
    payload.write_text("x")
    with tarfile.open(evil, "w") as t:
        t.add(str(payload), arcname="../escaped")
    with pytest.raises(tarfile.TarError):
        lpg.stage_dataset_url(evil, str(tmp_path / "ws"))
    assert not (tmp_path / "escaped").exists()


def _load_jax_example():
    path = os.path.join(REPO, "examples", "GraphSAGE_dist",
                        "load_and_partition_graph.py")
    spec = importlib.util.spec_from_file_location("jax_example_partition",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flags", [
    ["--dataset_scale", "0.0005"],
    ["--dataset_scale", "0.0005", "--num_parts", "3", "--balance_train",
     "--balance_edges", "--community_hint", "label", "--part_method",
     "flat", "--refine_iters", "2"],
    ["--dataset_url", "ARCHIVE", "--balance_train"],
])
def test_partition_entry_point_writes_the_jax_book(tmp_path, monkeypatch,
                                                   tmp_path_factory, flags):
    use_jax_graphcore(monkeypatch, tmp_path_factory)
    if "ARCHIVE" in flags:
        src = _ogb_layout(str(tmp_path / "src"), n=80)
        archive = str(tmp_path / "ogb.zip")
        with zipfile.ZipFile(archive, "w") as z:
            for rel in _tree(src):
                z.write(os.path.join(src, rel), rel)
        flags = [archive if f == "ARCHIVE" else f for f in flags]
    cfgs = {}
    for side, main in (("jax", _load_jax_example().main), ("port", lpg.main)):
        cfgs[side] = main(flags + ["--workspace", str(tmp_path / side),
                                   "--graph_name", "g"])
    books = {}
    for side, cfg in cfgs.items():
        assert cfg == str(tmp_path / side / "dataset" / "g.json")
        with open(cfg) as f:
            books[side] = json.load(f)
    assert books["port"] == books["jax"]
    np.testing.assert_array_equal(
        np.load(tmp_path / "port" / "dataset" / "node_map.npy"),
        np.load(tmp_path / "jax" / "dataset" / "node_map.npy"))
