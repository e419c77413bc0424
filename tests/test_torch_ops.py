"""Port ops vs the JAX package's ops on the same numpy inputs.

The port's ``fanout_sum``/``fanout_mean``/``fanout_max`` run their plain
torch path on CPU tensors and must match ``dgl_operator_tpu.ops`` (its
XLA path, and at D=128 its Pallas kernel in interpreter mode) to 1e-5.
Cases cover masked slots, a dst row with no valid slot and the zero
rows ``pad_minibatch`` appends. The CUDA kernel itself runs only on a
card: ``test_kernel_matches_plain_on_card`` is marked ``cuda`` and
skips here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgl_operator_tpu.graph.blocks import FanoutBlock as JaxFanoutBlock
from dgl_operator_tpu.ops import fanout as jax_fanout
from dgl_operator_tpu_torch.graph.blocks import FanoutBlock
from dgl_operator_tpu_torch.ops import fanout

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
