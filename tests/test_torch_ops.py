"""Port ops vs the JAX package's ops on the same numpy inputs.

The port's ``fanout_sum``/``fanout_mean``/``fanout_max`` run their plain
torch path on CPU tensors and must match ``dgl_operator_tpu.ops`` (its
XLA path, and at D=128 its Pallas kernel in interpreter mode) to 1e-5.
Cases cover masked slots, a dst row with no valid slot and the zero
rows ``pad_minibatch`` appends. ``gather_rows`` must equal the JAX
Pallas gather (interpreter mode; at the KGE width D = 400 its
``jnp.take`` fallback) and its reference; the gradients of
``gather_rows`` and ``fanout_agg`` (the scatter-add backward) must
equal ``jax.grad`` through the JAX ops to 1e-5; ``gspmm`` must equal
the JAX ``gspmm``. ``scatter_plan`` (the host-built transpose the
backward kernel sums over) must equal a brute-force loop, and the
plain segmented sum over it must equal the plain scatter-add bit for
bit. The CUDA kernels run only on a card: the tests marked ``cuda``
hold them against their plain versions there (the gather bit for bit
at each edge of its register and bulk paths, and past 2^31 elements)
and skip here.
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


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_gather_rows_matches_pallas_at_the_kge_width(idx_dtype):
    """At D = 400 (the KGE tables' 1,600-byte rows) ``gather_rows_pallas``
    does not reach its Pallas kernel, which takes D % 128 == 0 only: it
    falls back to ``jnp.take``, and the port must equal that."""
    table, idx = _gather_case(400, 300, 400, 96)
    assert not pallas_gather.supported(400)
    got = gather.gather_rows(torch.from_numpy(table),
                             torch.from_numpy(idx).to(idx_dtype))
    want = pallas_gather.gather_rows_pallas(
        jnp.asarray(table), jnp.asarray(idx, jnp.int32), True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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
        table = table.half()
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


# -- the scatter plan ---------------------------------------------------

def _plan_case(kind):
    """idx [ND, F], mask or None, num_rows: masked slots and padded rows,
    targets with no entry, a hub named by every row (longer than
    CHUNK), and F = 1 with repeated ids and no mask."""
    rng = np.random.default_rng(len(kind))
    if kind == "fanout1_repeats":
        return rng.integers(0, 7, size=(90, 1)), None, 12
    nd, f, n = 60, 5, 40
    idx = rng.integers(0, n - 10, size=(nd, f)).astype(np.int32)
    mask = (rng.random((nd, f)) < 0.7).astype(np.uint8)
    mask[-4:] = 0
    idx[-4:] = 0                      # padded rows, as pad_minibatch pads
    if kind == "hub":
        idx[:, 2] = 33
        mask[:, 2] = 1                # 60 entries > CHUNK
    return idx, mask, n


def _brute_plan(idx, mask, n):
    nd, f = idx.shape
    valid = np.ones((nd, f), bool) if mask is None else mask > 0
    entries = [[] for _ in range(n)]
    for i in range(nd):
        for k in range(f):
            if valid[i, k]:
                entries[idx[i, k]].append(i)
    offsets = np.cumsum([0] + [len(e) for e in entries])
    chunks, long_rows, long_part = [], [], [0]
    for t, e in enumerate(entries):
        if len(e) > scatter.CHUNK:
            for b in range(0, len(e), scatter.CHUNK):
                chunks.append((offsets[t] + b,
                               offsets[t] + min(b + scatter.CHUNK, len(e))))
            long_rows.append(t)
            long_part.append(len(chunks))
    return dict(offsets=offsets, src=[i for e in entries for i in e],
                cnt=valid.sum(1), chunks=np.reshape(chunks, (-1, 2)),
                long_rows=long_rows, long_part=long_part)


def _segment_sum_plain(g, plan, mean):
    """Plain-torch segmented sum over a host plan: target ``t`` adds
    ``g[i] / denom_i`` for its entries one at a time in the plan's
    order, in float32."""
    plan = plan.to("cpu")
    rows = g.float()
    if mean:
        rows = rows / plan.cnt.clamp_min(1).to(rows)[:, None]
    start = plan.offsets[:-1].long()
    length = plan.offsets[1:].long() - start
    out = torch.zeros(plan.num_rows, g.shape[1])
    for r in range(int(length.max()) if plan.num_rows else 0):
        sel = (length > r).nonzero().squeeze(1)
        out[sel] += rows[plan.src[start[sel] + r].long()]
    return out


@pytest.mark.parametrize("kind", ["masked_padded", "hub",
                                  "fanout1_repeats"])
def test_scatter_plan_matches_brute_force(kind):
    idx, mask, n = _plan_case(kind)
    plan = scatter.scatter_plan(idx, mask, n)
    want = _brute_plan(idx, mask, n)
    for name in scatter.ScatterPlan.FIELDS:
        got = getattr(plan, name)
        assert got.dtype == np.int32, name
        np.testing.assert_array_equal(got, np.asarray(want[name]).reshape(
            got.shape), err_msg=name)
    assert (np.diff(plan.offsets) == 0).any()       # empty targets
    assert len(plan.long_rows) == (kind == "hub")


def test_scatter_plan_refuses_out_of_range_targets():
    with pytest.raises(ValueError, match="outside"):
        scatter.scatter_plan(np.array([[0, 5]]), None, 5)
    # a masked slot may hold anything
    scatter.scatter_plan(np.array([[0, 5]]), np.array([[1, 0]]), 5)


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("kind", ["masked_padded", "hub",
                                  "fanout1_repeats"])
def test_segment_sum_over_plan_is_bit_equal_to_plain(kind, mean):
    """Each target adds its entries one at a time in the plan's order:
    the order of the sequential ``index_add_``, so float32 sums agree
    to the bit."""
    idx, mask, n = _plan_case(kind)
    g = torch.from_numpy(np.random.default_rng(7).normal(
        size=(len(idx), 24)).astype(np.float32))
    plan = scatter.scatter_plan(idx, mask, n)
    got = _segment_sum_plain(g, plan, mean)
    want = scatter.scatter_add_rows_plain(
        g, torch.from_numpy(idx),
        None if mask is None else torch.from_numpy(mask), n, mean)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


def test_plan_ships_packed_and_cpu_scatter_ignores_it():
    idx, mask, n = _plan_case("hub")
    plan = scatter.scatter_plan(idx, mask, n)
    shipped = plan.to("cpu")
    assert shipped.to("cpu").offsets is shipped.offsets   # no copy
    for name in scatter.ScatterPlan.FIELDS:
        np.testing.assert_array_equal(getattr(shipped, name).numpy(),
                                      getattr(plan, name))
    assert shipped.num_rows == n
    assert shipped.num_chunks == -(-len(idx) // scatter.CHUNK)
    assert shipped.nbytes() == plan.nbytes()
    with pytest.raises(ValueError, match="ship the host plan"):
        shipped.to("meta")
    g = torch.randn(len(idx), 8)
    ti, tm = torch.from_numpy(idx), torch.from_numpy(mask)
    other = scatter.scatter_plan(np.zeros_like(idx), None, n)
    assert torch.equal(
        scatter.scatter_add_rows(g, ti, tm, n, True, plan=other),
        scatter.scatter_add_rows_plain(g, ti, tm, n, True))


def test_fanout_block_to_ships_the_plan():
    idx, mask, n = _plan_case("masked_padded")
    plan = scatter.scatter_plan(idx, mask, n)
    blk = FanoutBlock(idx, mask, n, plan=plan).to("cpu")
    assert isinstance(blk.plan.src, torch.Tensor)
    np.testing.assert_array_equal(blk.plan.src.numpy(), plan.src)
    assert FanoutBlock(idx, mask, n).to("cpu").plan is None
    # a block's forward hands its plan to the backward
    h = torch.randn(n, 6, requires_grad=True)
    fanout.fanout_mean(blk, h).sum().backward()
    want = _segment_sum_plain(torch.ones(len(idx), 6), plan, True)
    assert torch.equal(h.grad, want)


def test_sampled_batches_carry_plans_on_inner_blocks():
    """The trainer's sampler attaches a plan to every block but the
    first (whose source rows, the input features, need no gradient)."""
    from dgl_operator_tpu_torch.graph import datasets
    from dgl_operator_tpu_torch.models.sage import DistSAGE
    from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                     TrainConfig)

    g = datasets.synthetic_node_clf(num_nodes=300, num_edges=1500,
                                    feat_dim=8, num_classes=3,
                                    seed=2).graph
    tr = SampledTrainer(DistSAGE(8, 8, 3, num_layers=3, device="cpu"), g,
                        TrainConfig(batch_size=16, fanouts=(3, 4, 5)),
                        device="cpu")
    mb = tr.sample(tr.train_ids[:16], 0)
    assert mb.blocks[0].plan is None
    for blk in mb.blocks[1:]:
        want = scatter.scatter_plan(blk.nbr, blk.mask, blk.num_src)
        for name in scatter.ScatterPlan.FIELDS:
            np.testing.assert_array_equal(getattr(blk.plan, name),
                                          getattr(want, name))
    shipped = tr.ship(mb)[0]
    assert shipped[0].plan is None
    assert all(isinstance(b.plan.offsets, torch.Tensor)
               for b in shipped[1:])


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
    """A host ``Graph`` takes ``copy_u`` only (the other message ops run
    over ``Graph.to_device``); an unknown op or reduce is refused."""
    g = Graph(np.array([0]), np.array([1]), 2)
    with pytest.raises(NotImplementedError):
        spmm.gspmm(g, "copy_e", "max", torch.ones(2, 3))
    with pytest.raises(NotImplementedError):
        spmm.gspmm(g, "u_mul_e", "sum", torch.ones(2, 3))
    with pytest.raises(ValueError, match="unknown"):
        spmm.gspmm(g, "u_pow_e", "sum", torch.ones(2, 3))
    with pytest.raises(ValueError, match="unknown"):
        spmm.gspmm(g, "copy_u", "prod", torch.ones(2, 3))


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


def _card_gather_case(case, dtype, g):
    """(table, idx as int64) of one edge of the gather's two paths."""
    item = torch.tensor([], dtype=dtype).element_size()
    n = 14_951

    def ids(m, high=n):
        return torch.randint(0, high, (m,), device="cuda", generator=g)
    if case.startswith("rows1600_m"):        # the bulk path's rows
        m = int(case[len("rows1600_m"):])
        return (torch.randn(n, 1600 // item, device="cuda",
                            generator=g).to(dtype), ids(m))
    if case == "rows400_m2305":      # M not a multiple of a block's rows
        return (torch.randn(n, 400 // item, device="cuda",
                            generator=g).to(dtype), ids(2305))
    if case.startswith("repeats"):   # 6 rows named over and over
        d = int(case[len("repeats"):]) // item
        return (torch.randn(n, d, device="cuda", generator=g).to(dtype),
                ids(2304, 6))
    if case == "period40":           # repeats 40 rows apart
        return (torch.randn(n, 400 // item, device="cuda",
                            generator=g).to(dtype),
                torch.arange(2304, device="cuda") % 40)
    if case == "hub":                # every id the same row
        return (torch.randn(n, 1600 // item, device="cuda",
                            generator=g).to(dtype),
                torch.full((2304,), 7, device="cuda"))
    if case == "shifted8":           # 8 bytes past a 16-byte boundary
        d = 1600 // item
        flat = torch.randn(8 // item + n * d, device="cuda",
                           generator=g).to(dtype)
        table = flat[8 // item:8 // item + n * d].view(n, d)
        assert table.data_ptr() % 16 == 8
        return table, ids(2304)
    if case == "d100":               # 200-byte rows in bf16
        return (torch.randn(n, 100, device="cuda", generator=g).to(dtype),
                ids(2304))
    assert case == "d37"
    return (torch.randn(2048, 37, device="cuda", generator=g).to(dtype),
            ids(512, 2048))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["rows1600_m1", "rows1600_m1023",
                                  "rows1600_m1024", "rows1600_m2304",
                                  "rows400_m2305", "hub", "repeats1600",
                                  "repeats400", "period40", "shifted8",
                                  "d100", "d37"])
def test_gather_kernel_edges_on_card(case, dtype):
    """Both paths of ``csrc/gather_rows.cu`` at their edges, bit for bit
    against the plain gather with int32 and int64 ids: 1,600-byte rows
    (the bulk path) at 1 row, one short of 1,024, 1,024 and 2,304 rows;
    a row count no block size divides; one hub row; rows named again
    and again within a block, at both widths, and 40 rows apart; a
    table that starts 8 bytes past a 16-byte boundary, so it must take
    narrower register moves; 200-byte rows (bf16 at D = 100) and
    D = 37."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(3)
    table, idx = _card_gather_case(case, dtype, g)
    for idx_dtype in (torch.int32, torch.int64):
        i = idx.to(idx_dtype)
        before = gather.gather_rows.launches
        got = gather.gather_rows(table, i)
        torch.cuda.synchronize()
        assert gather.gather_rows.launches == before + 1
        assert torch.equal(got, gather.gather_rows_plain(table, i))


@pytest.mark.cuda
def test_gather_kernel_addresses_past_2e31_elements_on_card():
    """A 5,400,000 x 400 float32 table (2.16e9 elements, 8.6 GB): its
    last rows lie past 2^31 elements, and the gather must read them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    n, d = 5_400_000, 400
    g = torch.Generator(device="cuda").manual_seed(4)
    table = torch.zeros(n, d, device="cuda")
    table[-4096:] = torch.randn(4096, d, device="cuda", generator=g)
    idx = torch.randint(n - 4096, n, (3000,), device="cuda", generator=g)
    assert int(idx.min()) * d > 2 ** 31
    try:
        for idx_dtype in (torch.int32, torch.int64):
            got = gather.gather_rows(table, idx.to(idx_dtype))
            torch.cuda.synchronize()
            assert got.abs().sum() > 0
            assert torch.equal(got, gather.gather_rows_plain(table, idx))
    finally:
        del table
        torch.cuda.empty_cache()


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
    plan = scatter.scatter_plan(nbr.cpu().numpy(), mask.cpu().numpy(), n)
    for mean in (False, True):
        before = scatter.scatter_add_rows.launches
        got = scatter.scatter_add_rows(grad, nbr, mask, n, mean, plan=plan)
        want = scatter.scatter_add_rows_plain(grad, nbr, mask, n, mean)
        torch.cuda.synchronize()
        assert scatter.scatter_add_rows.launches == before + 1
        # targets of more than CHUNK entries add partial sums of their
        # pieces, not one entry at a time as index_add_ does
        tol = 1e-5 * max(1.0, float(want.abs().max()) if nd else 0.0)
        torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("hub", [False, True])
def test_scatter_kernel_is_deterministic_on_card(hub):
    """Two launches give the same bits, and so do two that share the
    plan on two streams at once; with no target above CHUNK entries,
    the CPU's sequential index_add_ does too. A hub target named by
    every row is cut into pieces: still deterministic, within the
    tolerance of the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(4)
    nd, f, d, n = 1000, 25, 256, 19200
    nbr = rng.integers(0, n, size=(nd, f)).astype(np.int32)
    mask = (rng.random((nd, f)) < 0.8).astype(np.uint8)
    if hub:
        nbr[:, 0], mask[:, 0] = 7, 1
    g = rng.normal(size=(nd, d)).astype(np.float32)
    plan = scatter.scatter_plan(nbr, mask, n)
    assert len(plan.long_rows) == int(hub)
    gc, nc, mc = (torch.from_numpy(a).cuda() for a in (g, nbr, mask))
    dev_plan = plan.to("cuda")
    first = scatter.scatter_add_rows(gc, nc, mc, n, True, plan=dev_plan)
    second = scatter.scatter_add_rows(gc, nc, mc, n, True, plan=dev_plan)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        third = scatter.scatter_add_rows(gc, nc, mc, n, True, plan=dev_plan)
    fourth = scatter.scatter_add_rows(gc, nc, mc, n, True, plan=dev_plan)
    want = scatter.scatter_add_rows_plain(*(torch.from_numpy(a) for a in
                                            (g, nbr, mask)), n, True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, third) and torch.equal(first, fourth)
    if hub:
        torch.testing.assert_close(first.cpu(), want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
        assert torch.equal(first.cpu()[:7], want[:7])
    else:
        assert torch.equal(first.cpu(), want)


@pytest.mark.cuda
def test_scatter_kernel_needs_a_plan_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.randn(4, 8, device="cuda")
    idx = torch.zeros(4, 2, dtype=torch.int32, device="cuda")
    before = scatter.scatter_add_rows.launches
    with pytest.raises(ValueError, match="scatter_plan"):
        scatter.scatter_add_rows(g, idx, None, 3, mean=False)
    assert scatter.scatter_add_rows.launches == before


@pytest.mark.cuda
def test_fanout_gradient_flows_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    h, nbr, mask = _case(9, 300, 64, 40, 10)
    hc = torch.from_numpy(h).cuda().requires_grad_()
    hp = torch.from_numpy(h).requires_grad_()
    tb = FanoutBlock(nbr, mask, 300,
                     plan=scatter.scatter_plan(nbr, mask, 300))
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


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["host", "device"])
def test_graphed_calls_equal_single_steps_on_card(sampler):
    """On the card a K-step call of the device sampler is a CUDA graph
    replay; the host sampler's runs eagerly. Both equal K = 1 bit for
    bit, dropout on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    from dgl_operator_tpu_torch.graph import datasets
    from dgl_operator_tpu_torch.models.sage import DistSAGE
    from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                     TrainConfig)

    graph = datasets.synthetic_node_clf(300, 1500, 12, 4, seed=11).graph

    def make(**kw):
        cfg = dict(num_epochs=2, batch_size=24, fanouts=(3, 4),
                   eval_every=0, log_every=1000, dropout=0.5, seed=5,
                   sampler=sampler, **kw)
        model = DistSAGE(12, 16, 4, device="cuda",
                         generator=torch.Generator().manual_seed(2))
        return SampledTrainer(model, graph, TrainConfig(**cfg))

    one = make().train()
    three = make(steps_per_call=3).train()
    assert [x for r in one["history"] for x in r["losses"]] == \
        [x for r in three["history"] for x in r["losses"]]
    for k, v in one["params"].items():
        assert torch.equal(v, three["params"][k]), k
    assert three["history"][0]["graph"] is (sampler == "device")
    if sampler == "device":
        assert three["history"][1]["graph_replays"] == 3
