"""Port ops vs the JAX package's ops on the same numpy inputs.

The port's ``fanout_sum``/``fanout_mean``/``fanout_max`` run their plain
torch path on CPU tensors and must match ``dgl_operator_tpu.ops`` (its
XLA path, and at D=128 its Pallas kernel in interpreter mode) to 1e-5.
Cases cover masked slots, a dst row with no valid slot and the zero
rows ``pad_minibatch`` appends. ``gather_rows`` must equal the JAX
Pallas gather (interpreter mode) and its reference; the gradients of
``gather_rows`` and ``fanout_agg`` (the scatter-add backward) must
equal ``jax.grad`` through the JAX ops to 1e-5; ``gspmm`` must equal
the JAX ``gspmm``. The CUDA kernels run only on a card: the tests
marked ``cuda`` hold them against their plain versions there and skip
here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgl_operator_tpu.graph.blocks import FanoutBlock as JaxFanoutBlock
from dgl_operator_tpu.graph.graph import Graph as JaxGraph
from dgl_operator_tpu.ops import fanout as jax_fanout
from dgl_operator_tpu.ops import pallas_gather
from dgl_operator_tpu.ops import spmm as jax_spmm
from dgl_operator_tpu_torch.graph.blocks import FanoutBlock
from dgl_operator_tpu_torch.graph.graph import Graph
from dgl_operator_tpu_torch.ops import fanout, gather, scatter, spmm

# float32 sums of at most 25 unit-scale terms, taken in another order
TOL = dict(rtol=1e-5, atol=1e-5)
PAD_ROWS = 3


def _case(seed, n, d, nd, f):
    """h [n, d], nbr/mask [nd + PAD_ROWS, f]: ~30% masked slots, dst row
    1 with no valid slot, and PAD_ROWS padded rows (nbr 0, mask 0)."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, d)).astype(np.float32)
    nbr = rng.integers(0, n, size=(nd, f)).astype(np.int32)
    mask = (rng.random((nd, f)) < 0.7).astype(np.float32)
    mask[1] = 0.0
    nbr = np.concatenate([nbr, np.zeros((PAD_ROWS, f), np.int32)])
    mask = np.concatenate([mask, np.zeros((PAD_ROWS, f), np.float32)])
    return h, nbr, mask


def _both(h, nbr, mask):
    return (JaxFanoutBlock(jnp.asarray(nbr), jnp.asarray(mask), h.shape[0]),
            jnp.asarray(h), FanoutBlock(nbr, mask, h.shape[0]),
            torch.from_numpy(h))


@pytest.mark.parametrize("mask_dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("d", [37, 100, 128])
@pytest.mark.parametrize("f", [1, 10, 25])
def test_fanout_ops_match_jax(f, d, mask_dtype, monkeypatch):
    monkeypatch.setenv("DGL_TPU_PALLAS", "0")
    h, nbr, mask = _case(100 * f + d, 40, d, 12, f)
    jb, jh, tb, th = _both(h, nbr, mask.astype(mask_dtype))
    for jax_op, port_op in ((jax_fanout.fanout_sum, fanout.fanout_sum),
                            (jax_fanout.fanout_mean, fanout.fanout_mean),
                            (jax_fanout.fanout_max, fanout.fanout_max)):
        want = np.asarray(jax_op(jb, jh))
        got = port_op(tb, th).numpy()
        assert got.shape == want.shape == (12 + PAD_ROWS, d)
        np.testing.assert_allclose(got, want, **TOL)
    # the isolated row and the padded rows aggregate to exactly zero
    assert not fanout.fanout_mean(tb, th)[[1, 12, 13, 14]].any()


@pytest.mark.parametrize("f", [1, 10, 25])
def test_fanout_sum_mean_match_pallas_interpret(f, monkeypatch):
    """D=128 is the width the Pallas kernel accepts; run it in
    interpreter mode as the JAX package's own tests do."""
    monkeypatch.setenv("DGL_TPU_PALLAS", "interpret")
    h, nbr, mask = _case(7 + f, 30, 128, 9, f)
    jb, jh, tb, th = _both(h, nbr, mask.astype(np.uint8))
    np.testing.assert_allclose(fanout.fanout_sum(tb, th).numpy(),
                               np.asarray(jax_fanout.fanout_sum(jb, jh)),
                               **TOL)
    np.testing.assert_allclose(fanout.fanout_mean(tb, th).numpy(),
                               np.asarray(jax_fanout.fanout_mean(jb, jh)),
                               **TOL)


def test_masked_slots_are_skipped_not_multiplied():
    """A masked slot may name a row holding inf or nan: it is skipped,
    so it cannot poison the sum (0 * inf would)."""
    h = torch.ones(4, 3)
    h[2] = float("inf")
    h[3] = float("nan")
    nbr = torch.tensor([[0, 2, 3], [1, 1, 0]], dtype=torch.int32)
    mask = torch.tensor([[1, 0, 0], [1, 1, 0]], dtype=torch.uint8)
    out = fanout.fanout_agg(h, nbr, mask, mean=False)
    assert torch.equal(out, torch.tensor([[1.0] * 3, [2.0] * 3]))


def test_fanout_agg_cpu_path_counts_no_launch():
    h = torch.randn(5, 8)
    before = fanout.fanout_agg.launches
    out = fanout.fanout_agg(h, torch.zeros(0, 4, dtype=torch.int32),
                            torch.zeros(0, 4, dtype=torch.uint8), mean=True)
    assert out.shape == (0, 8)
    nbr = torch.randint(0, 5, (6, 4), dtype=torch.int32)
    mask = torch.ones(6, 4, dtype=torch.uint8)
    fanout.fanout_agg(h, nbr, mask, mean=True)
    assert fanout.fanout_agg.launches == before


@pytest.mark.parametrize("bad", ["h_dtype", "nbr_dtype", "mask_dtype",
                                 "shape", "h_rank"])
def test_fanout_agg_rejects_what_the_kernel_does_not_take(bad):
    h = torch.randn(5, 8)
    nbr = torch.zeros(3, 2, dtype=torch.int32)
    mask = torch.ones(3, 2, dtype=torch.uint8)
    if bad == "h_dtype":
        h = h.double()
    elif bad == "nbr_dtype":
        nbr = nbr.long()
    elif bad == "mask_dtype":
        mask = mask.float()
    elif bad == "shape":
        mask = mask[:2]
    else:
        h = h[None]
    with pytest.raises((TypeError, ValueError)):
        fanout.fanout_agg(h, nbr, mask, mean=False)


def test_fanout_agg_bf16_plain_within_bf16_rounding():
    """bf16 in, fp32 accumulation, bf16 out: the result is the fp32 sum
    of the bf16 inputs rounded once (relative error <= 2^-8)."""
    h, nbr, mask = _case(3, 50, 64, 20, 10)
    hb = torch.from_numpy(h).bfloat16()
    got = fanout.fanout_agg(hb, torch.from_numpy(nbr),
                            torch.from_numpy(mask.astype(np.uint8)),
                            mean=True)
    assert got.dtype == torch.bfloat16
    hf = hb.float().numpy().astype(np.float64)
    ref = (hf[nbr] * mask[..., None]).sum(1) / np.maximum(
        mask.sum(1), 1)[:, None]
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -8,
                               atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nd,f,d", [(1664, 10, 100), (64, 25, 256),
                                    (40, 1, 37), (0, 10, 100)])
def test_kernel_matches_plain_on_card(nd, f, d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    n = max(4 * nd, 8)
    h = torch.randn(n, d, device="cuda", generator=g).to(dtype)
    nbr = torch.randint(0, n, (nd, f), device="cuda", dtype=torch.int32,
                        generator=g)
    mask = (torch.rand(nd, f, device="cuda", generator=g) < 0.7).to(
        torch.uint8)
    if nd:
        mask[0] = 0
    for mean in (False, True):
        before = fanout.fanout_agg.launches
        got = fanout.fanout_agg(h, nbr, mask, mean)
        torch.cuda.synchronize()
        assert fanout.fanout_agg.launches == before + (1 if nd else 0)
        want = fanout.fanout_agg_plain(h, nbr, mask, mean)
        # f32: same terms in the same order; bf16: one rounding of
        # the fp32 result, either side of a tie
        tol = 1e-5 if dtype == torch.float32 else 2 ** -7
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


# -- gather_rows, scatter_add_rows and the gradients -------------------

def _gather_case(seed, n, d, m):
    """table [n, d]; idx [m + 4] with repeats and 4 trailing padded
    ids 0, as ``pad_minibatch`` pads input nodes."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n, d)).astype(np.float32)
    idx = np.concatenate([rng.integers(0, n, size=m),
                          np.zeros(4, np.int64)])
    return table, idx


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("d", [37, 100, 128])
def test_gather_rows_matches_pallas_and_reference(d, idx_dtype):
    table, idx = _gather_case(d, 50, d, 40)
    got = gather.gather_rows(torch.from_numpy(table),
                             torch.from_numpy(idx).to(idx_dtype))
    want = pallas_gather.gather_rows_pallas(
        jnp.asarray(table), jnp.asarray(idx, jnp.int32), True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), pallas_gather.gather_rows_reference(table, idx))


@pytest.mark.parametrize("d", [37, 128])
def test_gather_rows_grad_matches_jax(d):
    """The backward is the scatter-add of the cotangent: repeated and
    padded ids accumulate, as ``_gather_rows_bwd``'s segment_sum does."""
    table, idx = _gather_case(5 + d, 30, d, 60)
    w = np.random.default_rng(1).normal(size=(len(idx), d)).astype(
        np.float32)
    want = jax.grad(lambda t: (pallas_gather.gather_rows_pallas(
        t, jnp.asarray(idx, jnp.int32), True) * w).sum())(
            jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    (gather.gather_rows(t, torch.from_numpy(idx)) *
     torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), **TOL)


def _jax_mean(jb, jh, mean, pallas):
    """The JAX aggregation: its XLA path, or the Pallas kernel in
    interpreter mode on the zero-padded table with the mean's division
    outside (what ``ops.fanout_mean`` does on a TPU)."""
    if not pallas:
        op = jax_fanout.fanout_mean if mean else jax_fanout.fanout_sum
        return op(jb, jh)
    table, nbr = jax_fanout._zero_padded(jb, jh)
    out = pallas_gather.fanout_sum_pallas(table, nbr, True)
    if mean:
        cnt = jnp.maximum((jnp.asarray(jb.mask) > 0).sum(1), 1)
        out = out / cnt[:, None].astype(out.dtype)
    return out


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("f,d", [(10, 128), (25, 37), (1, 100)])
def test_fanout_agg_grad_matches_jax(f, d, mean, pallas, monkeypatch):
    monkeypatch.setenv("DGL_TPU_PALLAS", "0")
    h, nbr, mask = _case(31 * f + d, 40, d, 12, f)
    mask[3] = 0.0                        # an all-masked row besides row 1
    jb, jh, tb, th = _both(h, nbr, mask.astype(np.uint8))
    w = np.random.default_rng(f).normal(size=(len(nbr), d)).astype(
        np.float32)
    want = jax.grad(lambda x: (_jax_mean(jb, x, mean, pallas) * w).sum())(jh)
    th.requires_grad_()
    out = fanout.fanout_mean(tb, th) if mean else fanout.fanout_sum(tb, th)
    assert out.grad_fn is not None
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want), **TOL)


def test_fanout_agg_backward_skipped_without_input_grad():
    h = torch.randn(6, 4)
    nbr = torch.randint(0, 6, (3, 2), dtype=torch.int32)
    mask = torch.ones(3, 2, dtype=torch.uint8)
    out = fanout.fanout_agg(h, nbr, mask, mean=True)
    assert out.grad_fn is None and not out.requires_grad


def test_plain_versions_pass_gradcheck_in_float64():
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.normal(size=(7, 3))).requires_grad_()
    nbr = torch.from_numpy(rng.integers(0, 7, size=(5, 4)).astype(np.int32))
    mask = torch.from_numpy((rng.random((5, 4)) < 0.6).astype(np.uint8))
    mask[2] = 0
    for mean in (False, True):
        assert torch.autograd.gradcheck(
            lambda x: fanout.fanout_agg_plain(x, nbr, mask, mean), (h,))
    idx = torch.tensor([0, 3, 3, 6, 0])
    assert torch.autograd.gradcheck(
        lambda x: gather.gather_rows_plain(x, idx), (h,))
    g = torch.from_numpy(rng.normal(size=(5, 3))).requires_grad_()
    for m in (mask, None):
        assert torch.autograd.gradcheck(
            lambda x: scatter.scatter_add_rows_plain(x, nbr, m, 7, True),
            (g,))


@pytest.mark.parametrize("mean", [False, True])
def test_plain_scatter_add_equals_segment_sum(mean):
    rng = np.random.default_rng(3)
    nd, f, d, n = 9, 4, 6, 11
    g = rng.normal(size=(nd, d)).astype(np.float32)
    nbr = rng.integers(0, n, size=(nd, f)).astype(np.int32)
    mask = (rng.random((nd, f)) < 0.7).astype(np.uint8)
    mask[0] = 0
    cnt = np.maximum(mask.sum(1), 1) if mean else np.ones(nd)
    ge = np.broadcast_to((g / cnt[:, None].astype(np.float32))[:, None],
                         (nd, f, d))
    want = jax.ops.segment_sum(
        jnp.asarray(ge[mask > 0]), jnp.asarray(nbr[mask > 0]),
        num_segments=n)
    got = scatter.scatter_add_rows(torch.from_numpy(g),
                                   torch.from_numpy(nbr),
                                   torch.from_numpy(mask), n, mean)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the gather form: F = 1, no mask, every index counts
    idx = nbr[:, :1]
    got = scatter.scatter_add_rows(torch.from_numpy(g),
                                   torch.from_numpy(idx.astype(np.int64)),
                                   None, n, False)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax.ops.segment_sum(
            jnp.asarray(g), jnp.asarray(idx[:, 0]), num_segments=n)),
        **TOL)


def test_bf16_backward_accumulates_in_float32():
    h = torch.randn(8, 16).bfloat16().requires_grad_()
    nbr = torch.randint(0, 8, (5, 3), dtype=torch.int32)
    mask = torch.ones(5, 3, dtype=torch.uint8)
    out = fanout.fanout_agg(h, nbr, mask, mean=True)
    gout = torch.randn(5, 16).bfloat16()
    out.backward(gout)
    want = scatter.scatter_add_rows_plain(gout, nbr, mask, 8, True)
    assert h.grad.dtype == torch.bfloat16
    assert torch.equal(h.grad, want.bfloat16())


@pytest.mark.parametrize("bad", ["table_dtype", "idx_dtype", "idx_rank",
                                 "g_rows", "mask_shape", "mask_dtype"])
def test_gather_and_scatter_reject_what_the_kernels_do_not_take(bad):
    table, idx = torch.randn(5, 4), torch.tensor([0, 1])
    g, sidx = torch.randn(3, 4), torch.zeros(3, 2, dtype=torch.int32)
    mask = torch.ones(3, 2, dtype=torch.uint8)
    if bad == "table_dtype":
        table = table.double()
    elif bad == "idx_dtype":
        idx = idx.short()
    elif bad == "idx_rank":
        idx = idx[None]
    elif bad == "g_rows":
        g = g[:2]
    elif bad == "mask_shape":
        mask = mask[:, :1]
    else:
        mask = mask.bool()
    with pytest.raises((TypeError, ValueError)):
        if bad.startswith(("table", "idx")):
            gather.gather_rows(table, idx)
        else:
            scatter.scatter_add_rows(g, sidx, mask, 5, mean=False)


def test_cpu_paths_count_no_launch():
    before = (gather.gather_rows.launches,
              scatter.scatter_add_rows.launches)
    t = torch.randn(6, 3, requires_grad=True)
    gather.gather_rows(t, torch.tensor([1, 1, 5])).sum().backward()
    assert (gather.gather_rows.launches,
            scatter.scatter_add_rows.launches) == before


# -- gspmm --------------------------------------------------------------

@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_gspmm_matches_jax(reduce):
    """Repeated edges count each time; node 9 has no in-edge and gets
    0."""
    src = np.array([0, 1, 1, 2, 3, 3, 4, 5, 6, 7, 8, 0], np.int32)
    dst = np.array([1, 0, 0, 1, 2, 2, 2, 4, 4, 4, 7, 8], np.int32)
    x = np.random.default_rng(0).normal(size=(10, 5)).astype(np.float32)
    jg = JaxGraph(src, dst, 10)
    want = jax_spmm.gspmm(jg.to_device(), "copy_u", reduce,
                          ufeat=jnp.asarray(x))
    got = spmm.gspmm(Graph(src, dst, 10), "copy_u", reduce,
                     torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[9].any()


def test_gspmm_refuses_what_is_not_ported():
    g = Graph(np.array([0]), np.array([1]), 2)
    with pytest.raises(NotImplementedError):
        spmm.gspmm(g, "copy_u", "max", torch.ones(2, 3))
    with pytest.raises(NotImplementedError):
        spmm.gspmm(g, "u_mul_e", "sum", torch.ones(2, 3))


# -- the kernels on the card -------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,d", [(244902, 200000, 100), (18304, 18304, 100),
                                   (2048, 512, 37), (64, 0, 100)])
def test_gather_kernel_matches_plain_on_card(n, m, d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    table = torch.randn(n, d, device="cuda", generator=g).to(dtype)
    for idx_dtype in (torch.int32, torch.int64):
        idx = torch.randint(0, n, (m,), device="cuda", generator=g,
                            dtype=idx_dtype)
        before = gather.gather_rows.launches
        got = gather.gather_rows(table, idx)
        torch.cuda.synchronize()
        assert gather.gather_rows.launches == before + (1 if m else 0)
        assert torch.equal(got, gather.gather_rows_plain(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,nd,f,d", [(26000, 1000, 25, 256),
                                      (244902, 26000, 10, 100),
                                      (2048, 512, 1, 37), (64, 0, 4, 8)])
def test_scatter_kernel_matches_plain_on_card(n, nd, f, d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(1)
    grad = torch.randn(nd, d, device="cuda", generator=g).to(dtype)
    nbr = torch.randint(0, n, (nd, f), device="cuda", generator=g,
                        dtype=torch.int32)
    mask = (torch.rand(nd, f, device="cuda", generator=g) < 0.7).to(
        torch.uint8)
    for mean in (False, True):
        got = scatter.scatter_add_rows(grad, nbr, mask, n, mean)
        want = scatter.scatter_add_rows_plain(grad, nbr, mask, n, mean)
        torch.cuda.synchronize()
        # fp32 atomics land in another order than index_add_'s
        tol = 1e-5 * max(1.0, float(want.abs().max()) if nd else 0.0)
        torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.cuda
def test_fanout_gradient_flows_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    h, nbr, mask = _case(9, 300, 64, 40, 10)
    hc = torch.from_numpy(h).cuda().requires_grad_()
    hp = torch.from_numpy(h).requires_grad_()
    tb = FanoutBlock(nbr, mask, 300)
    w = torch.randn(43, 64)
    before = scatter.scatter_add_rows.launches
    out = fanout.fanout_mean(tb, hc)
    assert out.grad_fn is not None
    # both gradient paths into h: the prefix slice and the aggregation
    (out * w.cuda()).sum().backward(inputs=[hc])
    (hc[:43] * w.cuda()).sum().backward()
    (fanout.fanout_mean(tb, hp) * w).sum().backward()
    (hp[:43] * w).sum().backward()
    torch.cuda.synchronize()
    assert scatter.scatter_add_rows.launches == before + 1
    torch.testing.assert_close(hc.grad.cpu(), hp.grad, rtol=1e-5, atol=1e-5)
