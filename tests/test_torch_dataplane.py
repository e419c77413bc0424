"""The port's data plane against the JAX package's: quantized and
out-of-core partition books, the quantized feature stores of
``DistTrainer`` and ``ServeEngine``, bfloat16 compute and per-layer
rematerialization.

Inputs are made with numpy from a seed and handed to both packages.
Host-side functions (the codec, the chunked CSR, the power-law stream,
the book writer) must agree bit for bit or byte for byte. Training
through a quantized store is held to the JAX trainer within the dist
parity tests' tolerance, and to the port's own float32 store filled
with the host-dequantized codes bit for bit, since both reconstruct
the rows with the same float32 algebra. bfloat16 forwards are held to
the JAX package's bfloat16 forwards within a bound stated from
bfloat16's unit roundoff; remat gradients equal the plain gradients bit
for bit. The 1-byte gather kernel and a captured remat run are held on
a card by ``tests/test_torch_dataplane_cuda.py``.
"""

import filecmp
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgl_operator_tpu.graph import _native as jax_native
from dgl_operator_tpu.graph import datasets as jax_datasets
from dgl_operator_tpu.graph import partition as jax_partition
from dgl_operator_tpu.graph import quant as jax_quant
from dgl_operator_tpu.graph.blocks import FanoutBlock as JaxFanoutBlock
from dgl_operator_tpu.models import gat as jax_gat
from dgl_operator_tpu.models.sage import DistSAGE as JaxDistSAGE
from dgl_operator_tpu.parallel import make_mesh
from dgl_operator_tpu.runtime import DistTrainer as JaxDistTrainer
from dgl_operator_tpu.runtime import TrainConfig as JaxTrainConfig
from dgl_operator_tpu.runtime.checkpoint import export_for_serving
from dgl_operator_tpu.serve.engine import ServeConfig as JaxServeConfig
from dgl_operator_tpu.serve.engine import ServeEngine as JaxServeEngine
from dgl_operator_tpu_torch import models
from dgl_operator_tpu_torch.graph import _native, datasets, ooc, partition
from dgl_operator_tpu_torch.graph import quant
from dgl_operator_tpu_torch.graph.blocks import (build_fanout_blocks,
                                                 pad_minibatch)
from dgl_operator_tpu_torch.graph.featstore import PagedFeatureStore
from dgl_operator_tpu_torch.models.gat import DistGAT, DistGATv2
from dgl_operator_tpu_torch.models.sage import DistSAGE
from dgl_operator_tpu_torch.obs import get_obs
from dgl_operator_tpu_torch.ops import gather
from dgl_operator_tpu_torch.runtime import forward
from dgl_operator_tpu_torch.runtime.dist import DistTrainer
from dgl_operator_tpu_torch.runtime.loop import SampledTrainer, TrainConfig
from dgl_operator_tpu_torch.serve.engine import ServeConfig, ServeEngine
from dgl_operator_tpu_torch.runtime.checkpoint import load_params
from dgl_operator_tpu_torch.runtime.checkpoint import \
    export_for_serving as port_export
from test_torch_multiprocess import _hostfile, _run_two_ranks
from test_torch_native import use_jax_graphcore
import torch_mp_worker as worker

FEAT, HIDDEN, CLASSES = 12, 16, 4
QDTYPES = ("int8", "uint8")
LAYOUTS = ("replicated", "owner")
# the dist parity tests' tolerance on a trajectory of float32 steps
TRAIN_TOL = dict(rtol=1e-4, atol=1e-4)
# bfloat16 keeps 8 significant bits: a rounding costs at most 2^-8 of
# the value (its unit roundoff). A sampled layer rounds its input, its
# aggregate, its two GEMM outputs and their sum, about 4 roundings that
# each package places differently, so two bfloat16 forwards of L layers
# may part by up to 4 * L * 2^-8 of the largest logit.
BF16_U = 2.0 ** -8


def bf16_tol(num_layers: int, ref: np.ndarray) -> float:
    return 4 * num_layers * BF16_U * max(1.0, float(np.abs(ref).max()))


@pytest.fixture(autouse=True)
def jax_library(monkeypatch, tmp_path_factory):
    use_jax_graphcore(monkeypatch, tmp_path_factory)
    monkeypatch.delenv("TPU_OPERATOR_TUNED_MANIFEST", raising=False)


def _feats(seed=0, n=200, d=FEAT):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32) * rng.uniform(
        0.1, 5.0, size=d).astype(np.float32)
    x[:, 3] = 0.0                        # a constant-zero column
    return x


# -- the codec ---------------------------------------------------------------
@pytest.mark.parametrize("dtype", QDTYPES)
def test_quant_functions_equal_jax_bit_for_bit(dtype):
    x = _feats(1)
    s, z = quant.compute_scale(x, dtype)
    js, jz = jax_quant.compute_scale(x, dtype)
    for got, want in ((s, js), (z, jz)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    stats = [(x[i:i + 50].min(0), x[i:i + 50].max(0))
             for i in range(0, 200, 50)]
    for got, want in zip(quant.merge_column_stats(stats, dtype),
                         jax_quant.merge_column_stats(stats, dtype)):
        np.testing.assert_array_equal(got, want)
    q = quant.quantize(x, s, z, dtype)
    np.testing.assert_array_equal(q, jax_quant.quantize(x, s, z, dtype))
    assert q.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(quant.dequantize(q, s, z),
                                  jax_quant.dequantize(q, s, z))
    np.testing.assert_array_equal(quant.max_abs_error_bound(s),
                                  jax_quant.max_abs_error_bound(s))
    assert quant.QUANT_RANGES == jax_quant.QUANT_RANGES
    with pytest.raises(ValueError, match="not a quantized dtype"):
        quant.compute_scale(x, "float32")


@pytest.mark.parametrize("dtype", QDTYPES)
def test_round_trip_within_error_bound(dtype):
    x = _feats(2)
    s, z = quant.compute_scale(x, dtype)
    back = quant.dequantize(quant.quantize(x, s, z, dtype), s, z)
    err = np.abs(back - x)
    # the half-step bound, plus float32 rounding of the reconstruction
    assert (err <= quant.max_abs_error_bound(s) * (1 + 1e-5)
            + 1e-6 * np.abs(x)).all()
    assert not back[:, 3].any()          # zero columns stay exact zeros
    if dtype == "int8":
        # the symmetric range keeps 0.0 exact and leaves -128 unused
        q = quant.quantize(np.zeros((1, FEAT), np.float32), s, z, dtype)
        assert not q.any()
        assert quant.quantize(x, s, z, dtype).min() >= -127


def test_sidecar_file_reads_in_either_package(tmp_path):
    x = _feats(3)
    sc = {}
    for key, dt in (("feat", "int8"), ("emb", "uint8")):
        s, z = quant.compute_scale(x, dt)
        sc[key] = {"scale": s, "zero": z, "dtype": dt}
    for writer, reader in ((quant, jax_quant), (jax_quant, quant)):
        path = str(tmp_path / f"{writer.__name__.split('.')[0]}.npz")
        writer.save_sidecar(path, sc)
        got = reader.load_sidecar(path)
        assert sorted(got) == sorted(sc)
        for key, want in sc.items():
            assert got[key]["dtype"] == want["dtype"]
            np.testing.assert_array_equal(got[key]["scale"], want["scale"])
            np.testing.assert_array_equal(got[key]["zero"], want["zero"])
    with pytest.raises(FileNotFoundError):
        quant.load_sidecar(str(tmp_path / "absent.npz"))


# -- out of core ---------------------------------------------------------------
@pytest.mark.parametrize("budget_mb", [None, 1])
def test_ooc_build_csr_equals_both_packages_build_csr(tmp_path, budget_mb,
                                                      monkeypatch):
    rng = np.random.default_rng(5)
    n, e = 300, 4000
    rows = rng.integers(0, n, e).astype(np.int32)
    cols = rng.integers(0, n, e).astype(np.int32)
    # a budget of one chunk of 100 edges: many chunks, rows across them
    monkeypatch.setattr(ooc, "_DEFAULT_CHUNK_BYTES", 100 * 4 * 8)
    got = ooc.ooc_build_csr(rows, cols, n, str(tmp_path), budget_mb)
    for want in (_native.build_csr(rows, cols, n),
                 jax_native.build_csr(rows, cols, n)):
        for a, b in zip(got, want):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a), b)
    g = datasets.synthetic_node_clf(100, 400, 4, 2, seed=1).graph
    ooc.attach_csr(g, got)
    assert g.csr() is not None and g.csr()[0] is got[0]


@pytest.mark.parametrize("out_dir", [False, True])
def test_synthetic_scale_graph_streams_equal_jax(tmp_path, out_dir):
    kw = dict(num_nodes=500, num_edges=3000, feat_dim=6, num_classes=3,
              alpha=1.3, seed=4, chunk_edges=700)
    got = datasets.synthetic_scale_graph(
        **kw, out_dir=str(tmp_path / "p") if out_dir else None)
    want = jax_datasets.synthetic_scale_graph(
        **kw, out_dir=str(tmp_path / "j") if out_dir else None)
    assert got.gen_params == want.gen_params
    assert got.name == want.name == "synthetic-scale"
    np.testing.assert_array_equal(got.graph.src, want.graph.src)
    np.testing.assert_array_equal(got.graph.dst, want.graph.dst)
    assert sorted(got.graph.ndata) == sorted(want.graph.ndata)
    for k, v in want.graph.ndata.items():
        np.testing.assert_array_equal(got.graph.ndata[k], v, k)
    if out_dir:
        assert isinstance(got.graph.ndata["feat"], np.memmap)
        assert ooc._backing_mmap(got.graph.src) is not None
    for a, b in zip(datasets.power_law_edge_stream(500, 3000, 1.0, 2, 999),
                    jax_datasets.power_law_edge_stream(500, 3000, 1.0, 2,
                                                       999)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_ogbn_products_without_feats_equals_jax():
    got = datasets.ogbn_products(scale=0.0005, with_feats=False).graph
    want = jax_datasets.ogbn_products(scale=0.0005, with_feats=False).graph
    np.testing.assert_array_equal(got.src, want.src)
    np.testing.assert_array_equal(got.dst, want.dst)
    for k, v in want.ndata.items():
        np.testing.assert_array_equal(got.ndata[k], v, k)
    assert got.ndata["feat"].strides == (0, 4) and not got.ndata["feat"].any()
    full = datasets.ogbn_products(scale=0.0005).graph
    np.testing.assert_array_equal(full.ndata["label"], got.ndata["label"])


def _same_book(a: str, b: str) -> None:
    """Two books' directories hold the same files, byte for byte (an
    npz compared array by array: its zip headers carry write times)."""
    da, db = os.path.dirname(a), os.path.dirname(b)
    with open(a) as f:
        ma = json.load(f)
    with open(b) as f:
        mb_ = json.load(f)
    assert ma == mb_
    files = sorted(os.path.relpath(f, da) for f in
                   glob.glob(os.path.join(da, "**", "*.np*"),
                             recursive=True))
    assert files == sorted(os.path.relpath(f, db) for f in
                           glob.glob(os.path.join(db, "**", "*.np*"),
                                     recursive=True))
    for rel in files:
        fa, fb = os.path.join(da, rel), os.path.join(db, rel)
        if rel.endswith(".npz"):
            with np.load(fa) as za, np.load(fb) as zb:
                assert sorted(za.files) == sorted(zb.files), rel
                for k in za.files:
                    assert za[k].dtype == zb[k].dtype, (rel, k)
                    np.testing.assert_array_equal(za[k], zb[k], f"{rel}:{k}")
        else:
            assert filecmp.cmp(fa, fb, shallow=False), rel


@pytest.fixture(scope="module")
def graphs():
    """The same 300-node graph in both packages."""
    args = dict(num_nodes=300, num_edges=1500, feat_dim=FEAT,
                num_classes=CLASSES, seed=2)
    return (jax_datasets.synthetic_node_clf(**args).graph,
            datasets.synthetic_node_clf(**args).graph)


@pytest.mark.parametrize("dtype", QDTYPES)
def test_ooc_quantized_book_byte_equal_to_jax(graphs, tmp_path, dtype):
    """``partition_graph(ooc=True, feat_dtype=...)`` in both packages:
    the same multilevel assignment, maps, graph arrays, code files and
    sidecar, byte for byte, and a JSON that spills and names them."""
    jg, pg = graphs
    kw = dict(ooc=True, ooc_budget_mb=1, feat_dtype=dtype)
    want = jax_partition.partition_graph(jg, "g", 2, str(tmp_path / "j"),
                                         **kw)
    got = partition.partition_graph(pg, "g", 2, str(tmp_path / "p"), **kw)
    _same_book(got, want)
    with open(got) as f:
        meta = json.load(f)
    assert meta["part_method"] == "multilevel-native"
    assert meta["feat_files"] == 1 and meta["ooc_spill_mib"] >= 0
    assert meta["feat_quant"] == {"feat": {"dtype": dtype,
                                           "sidecar": "feat_quant.npz"}}
    assert not os.path.exists(tmp_path / "p" / ".ooc_spill")
    p = partition.GraphPartition(got, 1)
    codes = p.graph.ndata["feat"]
    assert isinstance(codes, np.memmap) and codes.dtype == np.dtype(dtype)
    sc = p.feat_sidecar("feat")
    assert sc["dtype"] == dtype
    back = quant.dequantize(np.asarray(codes), sc["scale"], sc["zero"])
    ref = pg.ndata["feat"][p.orig_id]
    assert (np.abs(back - ref) <= quant.max_abs_error_bound(sc["scale"])
            * (1 + 1e-5) + 1e-6).all()
    assert p.feat_sidecar("label") is None


def test_ooc_float_book_equals_in_memory_book(graphs, tmp_path):
    """``ooc=True`` moves the features to files and spills the levels;
    the assignment, the maps and every graph array are the in-memory
    book's."""
    _, pg = graphs
    mem = partition.partition_graph(pg, "g", 2, str(tmp_path / "m"))
    spilled = partition.partition_graph(pg, "g", 2, str(tmp_path / "o"),
                                        ooc=True, ooc_budget_mb=1)
    for name in ("node_map.npy", "edge_map.npy"):
        assert filecmp.cmp(tmp_path / "m" / name, tmp_path / "o" / name,
                           shallow=False)
    for pid in range(2):
        a = partition.GraphPartition(mem, pid)
        b = partition.GraphPartition(spilled, pid)
        for k in ("orig_id", "orig_eid", "inner_node"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        np.testing.assert_array_equal(a.graph.src, b.graph.src)
        np.testing.assert_array_equal(a.halo_owner_local, b.halo_owner_local)
        assert isinstance(b.graph.ndata["feat"], np.memmap)
        np.testing.assert_array_equal(a.graph.ndata["feat"],
                                      b.graph.ndata["feat"])
        assert b.feat_sidecar("feat") is None


def test_missing_sidecar_raises_at_open(graphs, tmp_path):
    _, pg = graphs
    cfg = partition.partition_graph(pg, "g", 2, str(tmp_path),
                                    feat_dtype="int8")
    os.remove(tmp_path / "feat_quant.npz")
    for reader in (partition.GraphPartition, jax_partition.GraphPartition):
        with pytest.raises(ValueError, match="sidecar"):
            reader(cfg, 0)


def test_paged_feature_store_quantized(graphs, tmp_path):
    """A quantized store reads back the dequantized codes: the hot tier
    dequantized once at load, the cold tier on the way out, both equal
    to the JAX store's; a store of codes without its sidecar raises."""
    from dgl_operator_tpu.graph.featstore import \
        PagedFeatureStore as JaxStore
    _, pg = graphs
    cfg = partition.partition_graph(pg, "g", 2, str(tmp_path),
                                    feat_dtype="uint8", ooc=True)
    p = partition.GraphPartition(cfg, 0)
    codes, sc = p.graph.ndata["feat"], p.feat_sidecar("feat")
    cache_idx = np.array([1, 0, 3])
    st = PagedFeatureStore(codes, p.num_inner, cache_idx, sidecar=sc)
    js = JaxStore(codes, p.num_inner, cache_idx, sidecar=sc)
    idx = np.array([0, 5, 2, 5])
    want = quant.dequantize(np.asarray(codes[idx]), sc["scale"], sc["zero"])
    np.testing.assert_array_equal(st.core_rows(idx), want)
    np.testing.assert_array_equal(st.core_rows(idx), js.core_rows(idx))
    np.testing.assert_array_equal(st.cache_rows(np.array([2, 0])),
                                  js.cache_rows(np.array([2, 0])))
    assert st.cache.dtype == np.float32 and st.paged and st.quantized
    assert st.stats() == {**js.stats(), "paged_rows": st.paged_rows}
    assert st.stats()["dtype"] == "uint8" and st.paged_rows == 8
    assert st.backing_bytes == codes.size
    with pytest.raises(ValueError, match="sidecar"):
        PagedFeatureStore(codes, p.num_inner, cache_idx)


# -- the gather of codes and the reconstruction -------------------------------
@pytest.mark.parametrize("dtype", [torch.int8, torch.uint8])
def test_gather_rows_of_codes_on_the_cpu(dtype):
    table = torch.from_numpy(np.random.default_rng(6).integers(
        0, 127, size=(50, 7)).astype(np.int8)).to(dtype)
    idx = torch.tensor([4, 0, 49, 4], dtype=torch.int32)
    got = gather.gather_rows(table, idx)
    assert got.dtype == dtype and not got.requires_grad
    assert torch.equal(got, table[idx.long()])
    assert torch.equal(gather.gather_rows_plain(table, idx), got)


def test_dequant_rows_equals_host_dequantize():
    x = _feats(7)
    for dtype in QDTYPES:
        s, z = quant.compute_scale(x, dtype)
        q = quant.quantize(x, s, z, dtype)
        got = forward.dequant_rows(torch.from_numpy(q),
                                   torch.from_numpy(s), torch.from_numpy(z))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      quant.dequantize(q, s, z))
    h = torch.randn(3, 4).to(torch.bfloat16)
    assert torch.equal(forward.dequant_rows(h), h.float())
    f = torch.randn(3, 4)
    assert forward.dequant_rows(f) is f


# -- DistTrainer on quantized books -----------------------------------------
def _graph_args():
    return dict(num_nodes=800, num_edges=4000, feat_dim=FEAT,
                num_classes=CLASSES, seed=3)


def _cfg_kw(layout, **kw):
    return dict(dict(num_epochs=2, batch_size=32, lr=0.01, fanouts=(4, 4),
                     log_every=1000, eval_every=2, feats_layout=layout),
                **kw)


@pytest.fixture(scope="module")
def qbook(tmp_path_factory):
    """A 4-part int8 book of the JAX dist tests' graph, written by the
    JAX partitioner, and the same graph's float32 book."""
    with pytest.MonkeyPatch.context() as mp:
        use_jax_graphcore(mp, tmp_path_factory)
        ds = jax_datasets.synthetic_node_clf(**_graph_args())
        out = tmp_path_factory.mktemp("torch_dataplane")
        return (jax_partition.partition_graph(ds.graph, "synth", 4,
                                              str(out / "int8"),
                                              feat_dtype="int8"),
                jax_partition.partition_graph(ds.graph, "synth", 4,
                                              str(out / "f32")))


@pytest.fixture(scope="module")
def jax_int8_runs(qbook, tmp_path_factory):
    """Per layout: the JAX trainer's initial params and its run on the
    int8 book with an int8 store."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        use_jax_graphcore(mp, tmp_path_factory)
        mp.delenv("TPU_OPERATOR_TUNED_MANIFEST", raising=False)
        for layout in LAYOUTS:
            tr = JaxDistTrainer(
                JaxDistSAGE(hidden_feats=HIDDEN, out_feats=CLASSES,
                            dropout=0.0), qbook[0], make_mesh(num_dp=4),
                JaxTrainConfig(**_cfg_kw(layout), sentry=False,
                               feat_dtype="int8"))
            init = jax.device_get(tr._init_params())
            runs[layout] = (tr, init, tr.train())
    return runs


def _port(book, layout, feat_dtype, **kw):
    model = DistSAGE(FEAT, HIDDEN, CLASSES, dropout=0.0, device="cpu")
    cfg = TrainConfig(**_cfg_kw(layout, dropout=0.0, feat_dtype=feat_dtype,
                                **kw))
    return DistTrainer(model, book, cfg, device="cpu")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_int8_dist_trainer_matches_jax(qbook, jax_int8_runs, layout):
    jtr, init, want = jax_int8_runs[layout]
    tr = _port(qbook[0], layout, "int8")
    assert tr.feats.dtype == torch.int8
    assert tuple(tr.feats.shape) == tuple(jtr.feats.shape)
    np.testing.assert_array_equal(np.asarray(jtr.feats), tr.feats.numpy())
    np.testing.assert_array_equal(tr._feat_scale.numpy(),
                                  jtr._feat_scale_host)
    if layout == "owner":
        # int8 codes cross: the bill is a quarter of float32's payload
        assert tr.exchange_bytes_per_step == tr.num_parts * tr.pair_cap * (
            4 + FEAT)
    got = tr.train(init_params=init)
    assert got["step"] == want["step"]
    for g_rec, w_rec in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g_rec["loss"], w_rec["loss"],
                                   **TRAIN_TOL)
    for key in ("val_acc", "test_acc"):
        assert abs(got["history"][-1][key]
                   - want["history"][-1][key]) <= 1 / 160 + 1e-6, key
    gauge = get_obs().metrics.gauge("data_feat_mib_per_slot",
                                    labels=("role", "dtype"))
    assert gauge.value(role="dist", dtype="int8") == pytest.approx(
        tr.feats[0].numel() / 2**20, abs=1e-3)


@pytest.mark.parametrize("sampler", ["host", "device"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_int8_store_equals_float32_store_bit_for_bit(qbook, layout, sampler):
    """The int8 book into an int8 store (codes on the device,
    reconstructed after the gather and the exchange) and into a
    float32 store (dequantized on the host): the same losses and
    parameters, bit for bit; device K = 2 as well."""
    kw = dict(sampler=sampler, eval_every=0,
              steps_per_call=2 if sampler == "device" else 1)
    runs = []
    for fdt in ("int8", "float32"):
        tr = _port(qbook[0], layout, fdt, **kw)
        assert tr.feats.dtype == {"int8": torch.int8,
                                  "float32": torch.float32}[fdt]
        runs.append(tr.train())
    (a, b) = runs
    assert [h["losses"] for h in a["history"]] == \
        [h["losses"] for h in b["history"]]
    for k, v in a["params"].items():
        assert torch.equal(b["params"][k], v), k


def test_float_book_into_codes_and_bf16_store(qbook):
    """A float32 book read into int8 and uint8 stores calibrates one
    global sidecar (the JAX trainer's); a bfloat16 store holds the
    rounded values and trains."""
    jtr = JaxDistTrainer(
        JaxDistSAGE(hidden_feats=HIDDEN, out_feats=CLASSES, dropout=0.0),
        qbook[1], make_mesh(num_dp=4),
        JaxTrainConfig(**_cfg_kw("owner"), sentry=False, feat_dtype="uint8"))
    tr = _port(qbook[1], "owner", "uint8")
    np.testing.assert_array_equal(tr._feat_scale.numpy(),
                                  jtr._feat_scale_host)
    np.testing.assert_array_equal(tr._feat_zero.numpy(), jtr._feat_zero_host)
    np.testing.assert_array_equal(tr.feats.numpy(), np.asarray(jtr.feats))
    bf = _port(qbook[1], "replicated", "bfloat16", num_epochs=1,
               eval_every=0)
    assert bf.feats.dtype == torch.bfloat16 and bf._feat_scale is None
    out = bf.train()
    assert np.isfinite([x for r in out["history"] for x in r["losses"]]).all()


def test_recoding_a_quantized_book_raises(qbook):
    with pytest.raises(ValueError, match="re-coding"):
        _port(qbook[0], "replicated", "uint8")


def test_predict_reads_the_book_codes(qbook):
    """``predict`` on an int8 book dequantizes the gathered rows with
    the sidecar: the float32 store's trainer on the same book gives the
    same logits."""
    ids = np.arange(0, 800, 9)
    a = _port(qbook[0], "owner", "int8")
    b = _port(qbook[0], "replicated", "float32")
    b.model.load_state_dict(a.model.state_dict())
    np.testing.assert_array_equal(a.predict(ids, sample_seed=2),
                                  b.predict(ids, sample_seed=2))


def test_int8_exchange_in_a_gloo_group_equals_one_process(qbook, tmp_path):
    """Four parts of the int8 book on two gloo ranks, owner layout: the
    request collectives (host sampler) and the device sampler's
    all-gather and all-to-all move the raw codes; the losses equal one
    process's within float32 rounding of the gradient sum's order, and
    a cut run resumes to the end."""
    init = models.flax_params(DistSAGE(FEAT, HIDDEN, CLASSES, device="cpu"))
    init_path = port_export(str(tmp_path) + os.sep, init)
    jobs = [{"name": name, "book": qbook[0], "dims": [FEAT, HIDDEN, CLASSES],
             "cfg": dict(num_epochs=1, batch_size=32, lr=0.01,
                         fanouts=(4, 4), log_every=1000, eval_every=0,
                         feats_layout="owner", dropout=0.0,
                         feat_dtype="int8", **kw)}
            for name, kw in (("host", {}),
                             ("device", dict(sampler="device",
                                             steps_per_call=2)))]
    # the worker also cuts and resumes a run: the host job, at step 2
    spec = {"mode": "trainer", "hostfile": _hostfile(str(tmp_path)),
            "init": init_path, "jobs": jobs,
            "resume": {"job": jobs[0], "kill_at": 2,
                       "ckpt_dir": str(tmp_path / "ckpt")}}
    ranks = _run_two_ranks(spec, str(tmp_path))[1]
    params = load_params(init_path)
    for got in ranks:
        assert got["resumed/step"] == got["host/step"] > 2
    for job in jobs:
        want = worker.run_job(job, params)[f"{job['name']}/losses"]
        for r, got in enumerate(ranks):
            assert got[f"{job['name']}/my_parts"].tolist() == [2 * r,
                                                               2 * r + 1]
            np.testing.assert_allclose(got[f"{job['name']}/losses"], want,
                                       rtol=0,
                                       atol=1e-6 * np.abs(want).max())


# -- serving an int8 book -------------------------------------------------------
def test_serve_engine_on_int8_book_matches_jax(qbook, tmp_path):
    model = JaxDistSAGE(hidden_feats=HIDDEN, out_feats=CLASSES, dropout=0.0)
    blk = JaxFanoutBlock(jnp.zeros((2, 3), jnp.int32),
                         jnp.ones((2, 3), jnp.float32), 4)
    params = jax.device_get(model.init(jax.random.PRNGKey(0), [blk, blk],
                                       jnp.ones((4, FEAT))))
    path = export_for_serving(str(tmp_path / "export") + "/", params)
    kw = dict(fanouts=(3, 4), batch_size=16, cap_policy="worst",
              halo_cache_frac=0.25)
    jeng = JaxServeEngine(model, qbook[0], params_path=path,
                          cfg=JaxServeConfig(**kw))
    eng = ServeEngine(DistSAGE(FEAT, HIDDEN, CLASSES, device="cpu"),
                      qbook[0], params_path=path, cfg=ServeConfig(**kw),
                      device="cpu")
    ids = np.random.default_rng(1).choice(800, 40, replace=False)
    for seed in (0, 5):
        np.testing.assert_allclose(eng.predict_logits(ids, sample_seed=seed),
                                   jeng.predict_logits(ids, sample_seed=seed),
                                   rtol=1e-4, atol=1e-4)
    st = eng.stats()
    assert st["feat_dtype"] == "int8" == jeng.stats()["feat_dtype"]
    assert st["feat_backing_mib"] == jeng.stats()["feat_backing_mib"]
    assert all(s.quantized and s.paged for s in eng._stores)
    gauge = get_obs().metrics.gauge("data_feat_backing_mib",
                                    labels=("role", "dtype"))
    assert gauge.value(role="serve", dtype="int8") == st["feat_backing_mib"]


# -- bfloat16 compute and remat ---------------------------------------------------
IN, SEEDS_, BATCH_ = 12, 8, 12


@pytest.fixture(scope="module")
def batch():
    ds = datasets.synthetic_node_clf(200, 900, IN, 5, seed=4)
    mb = build_fanout_blocks(ds.graph.csc(), np.arange(SEEDS_), (3, 4),
                             seed=5)
    mb = pad_minibatch(mb, BATCH_, (3, 4), ds.graph.num_nodes)
    h = ds.graph.ndata["feat"][mb.input_nodes].astype(np.float32)
    return mb, h


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.normal(size=np.shape(x))
        .astype(np.float32), params)


STACKS = {"sage": (lambda **kw: JaxDistSAGE(hidden_feats=8, out_feats=4,
                                            **kw),
                   lambda **kw: DistSAGE(IN, 8, 4, device="cpu", **kw)),
          "gat": (lambda **kw: jax_gat.DistGAT(hidden_feats=8, out_feats=4,
                                               num_heads=2, **kw),
                  lambda **kw: DistGAT(IN, 8, 4, num_heads=2, device="cpu",
                                       **kw)),
          "gatv2": (lambda **kw: jax_gat.DistGATv2(hidden_feats=8,
                                                   out_feats=4, num_heads=2,
                                                   **kw),
                    lambda **kw: DistGATv2(IN, 8, 4, num_heads=2,
                                           device="cpu", **kw))}


@pytest.mark.parametrize("kind", list(STACKS))
def test_bf16_forward_matches_jax_bf16(batch, kind):
    """``compute_dtype="bfloat16"`` in both packages from the same
    params: float32 logits within the bfloat16 bound of 2 layers
    (:func:`bf16_tol`), and near the float32 forward as well."""
    mb, h = batch
    jblocks = [JaxFanoutBlock(jnp.asarray(b.nbr), jnp.asarray(b.mask),
                              b.num_src) for b in mb.blocks]
    jmodel = STACKS[kind][0](dropout=0.0, compute_dtype="bfloat16")
    params = _perturbed(jmodel.init(jax.random.PRNGKey(0), jblocks,
                                    jnp.asarray(h)), 3)
    want = np.asarray(jmodel.apply(params, jblocks, jnp.asarray(h),
                                   train=False))
    port = STACKS[kind][1](dropout=0.0, compute_dtype="bfloat16")
    port.load_state_dict(models.state_dict_from_flax(params))
    assert all(p.dtype == torch.float32 for p in port.parameters())
    port.eval()
    with torch.no_grad():
        got = port(mb.blocks, torch.from_numpy(h))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    tol = bf16_tol(2, want)
    assert float(np.abs(got.numpy() - want).max()) <= tol
    f32 = STACKS[kind][1](dropout=0.0)
    f32.load_state_dict(port.state_dict())
    f32.eval()
    with torch.no_grad():
        ref = f32(mb.blocks, torch.from_numpy(h)).numpy()
    assert float(np.abs(got.numpy() - ref).max()) <= bf16_tol(2, ref)
    assert not np.array_equal(got.numpy(), ref)     # bf16 did run


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("kind", list(STACKS))
def test_remat_gradients_equal_plain_bit_for_bit(batch, kind, dtype):
    """``remat=True`` recomputes each layer in the backward: the same
    parameter names, and the same loss and gradients, bit for bit, with
    dropout drawn between the layers from one seeded generator."""
    mb, h = batch
    labels = torch.from_numpy(np.random.default_rng(2).integers(0, 4,
                                                                BATCH_))
    grads = []
    for remat in (False, True):
        model = STACKS[kind][1](dropout=0.5, compute_dtype=dtype,
                                remat=remat,
                                generator=torch.Generator().manual_seed(1))
        model.train()
        gen = torch.Generator().manual_seed(9)
        logits = model(mb.blocks, torch.from_numpy(h), generator=gen)
        loss = torch.nn.functional.cross_entropy(logits, labels)
        loss.backward()
        grads.append((loss.detach(), {k: p.grad.clone() for k, p in
                                      model.named_parameters()}))
    (l0, g0), (l1, g1) = grads
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_remat_trainer_run_equals_plain(tmp_path):
    """``SampledTrainer`` with a remat stack, host K = 1 and device
    K = 2, dropout 0.5: the same losses and parameters as the plain
    stack, bit for bit."""
    g = datasets.synthetic_node_clf(400, 2000, IN, 4, seed=6).graph
    for sampler, k in (("host", 1), ("device", 2)):
        outs = []
        for remat in (False, True):
            model = DistSAGE(IN, 8, 4, device="cpu", remat=remat,
                             generator=torch.Generator().manual_seed(0))
            cfg = TrainConfig(num_epochs=1, batch_size=32, fanouts=(3, 4),
                              eval_every=0, sampler=sampler,
                              steps_per_call=k, seed=1)
            outs.append(SampledTrainer(model, g, cfg, device="cpu").train())
        assert outs[0]["history"][0]["losses"] == \
            outs[1]["history"][0]["losses"]
        for key, v in outs[0]["params"].items():
            assert torch.equal(outs[1]["params"][key], v), key


def test_compute_dtype_is_checked():
    with pytest.raises(ValueError, match="compute_dtype"):
        DistSAGE(IN, 8, 4, device="cpu", compute_dtype="float16")
