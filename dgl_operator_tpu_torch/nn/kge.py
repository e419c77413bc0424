"""Knowledge-graph-embedding scorers (the DGL-KE model family).

The counterpart of the JAX package's ``nn/kge.py``: TransE (L1 and L2),
DistMult, ComplEx, RotatE, RESCAL, TransR and SimplE as functions of
``(head, rel, tail)`` embedding blocks, written with the same operations
in the same order. TransR and RESCAL pack their per-relation matrices
into wider relation rows (:func:`relation_dim`).

Shapes: positive scoring takes ``[B, D]`` blocks; :func:`neg_score`
takes the fixed side ``[B, D]`` and the chunk-shared candidates
``[C, N, D]`` (the chunked negative-sampling layout of
``graph/kge_sampler.py``) and returns ``[B, N]``. DistMult, ComplEx and
SimplE reduce it to one batched GEMM (``torch.bmm``), as the JAX package
reduces it to an ``einsum`` outside any Pallas kernel. RESCAL and TransR
project before they contract, so no ``[C, chunk, N, D, D]`` operand is
ever built; the other scorers broadcast to ``[C, chunk, N, D]``.
"""

from __future__ import annotations

import math

import torch


def _split2(x):
    d = x.shape[-1] // 2
    return x[..., :d], x[..., d:]


def transe_score(h, r, t, gamma: float = 12.0, p: int = 1):
    """gamma - ||h + r - t||_p"""
    d = h + r - t
    if p == 1:
        dist = d.abs().sum(-1)
    else:
        dist = torch.sqrt((d * d).sum(-1) + 1e-10)
    return gamma - dist


def distmult_score(h, r, t, gamma: float = 0.0):
    return (h * r * t).sum(-1)


def complex_score(h, r, t, gamma: float = 0.0):
    hr, hi = _split2(h)
    rr, ri = _split2(r)
    tr, ti = _split2(t)
    return ((hr * rr - hi * ri) * tr + (hr * ri + hi * rr) * ti).sum(-1)


def rotate_score(h, r, t, gamma: float = 12.0, emb_init: float = 1.0):
    """gamma - ||h o e^{i r} - t||_2 with r as phase angles, read from the
    relation row's first D/2 columns."""
    hr, hi = _split2(h)
    tr, ti = _split2(t)
    half = h.shape[-1] // 2
    phase = r[..., :half] / (emb_init / math.pi)
    rr, ri = torch.cos(phase), torch.sin(phase)
    dr = hr * rr - hi * ri - tr
    di = hr * ri + hi * rr - ti
    dist = torch.sqrt(dr * dr + di * di + 1e-10).sum(-1)
    return gamma - dist


def _matrix(r, d: int):
    """The ``[..., D, D]`` matrix packed at the start of relation rows."""
    return r[..., : d * d].reshape(r.shape[:-1] + (d, d))


def rescal_score(h, r, t, gamma: float = 0.0):
    """Bilinear ``h^T M_r t``, the relation row a flattened ``[D, D]``
    matrix; no gamma term."""
    M = _matrix(r, h.shape[-1])
    return (h * torch.matmul(M, t.unsqueeze(-1)).squeeze(-1)).sum(-1)


def transr_score(h, r, t, gamma: float = 12.0):
    """TransE in a per-relation projected space: relation rows pack the
    flattened ``[D, D]`` projection, then the D-wide translation.
    ``gamma - ||h M_r + r_t - t M_r||_1``."""
    d = h.shape[-1]
    M = _matrix(r, d)
    rt = r[..., d * d:]
    hp = torch.matmul(h.unsqueeze(-2), M).squeeze(-2)
    tp = torch.matmul(t.unsqueeze(-2), M).squeeze(-2)
    return gamma - (hp + rt - tp).abs().sum(-1)


def simple_score(h, r, t, gamma: float = 0.0):
    """SimplE: entity rows pack (head-role, tail-role) halves, relation
    rows (forward, inverse) halves;
    ``1/2 [<h_head, r, t_tail> + <t_head, r_inv, h_tail>]``."""
    hi, hj = _split2(h)
    ti, tj = _split2(t)
    rf, rv = _split2(r)
    return 0.5 * (hi * rf * tj + ti * rv * hj).sum(-1)


def _transe_l1(h, r, t, **kw):
    return transe_score(h, r, t, p=1, **kw)


def _transe_l2(h, r, t, **kw):
    return transe_score(h, r, t, p=2, **kw)


KGE_SCORERS = {
    "TransE": transe_score,
    "TransE_l1": _transe_l1,
    "TransE_l2": _transe_l2,
    "DistMult": distmult_score,
    "ComplEx": complex_score,
    "RotatE": rotate_score,
    "RESCAL": rescal_score,
    "TransR": transr_score,
    "SimplE": simple_score,
}


def relation_dim(model_name: str, hidden_dim: int) -> int:
    """Relation-table row width of a scorer (entity rows are always
    ``hidden_dim`` wide): RESCAL rows hold a flattened ``[D, D]`` matrix,
    TransR also its D-wide translation."""
    if model_name == "RESCAL":
        return hidden_dim * hidden_dim
    if model_name == "TransR":
        return hidden_dim * hidden_dim + hidden_dim
    return hidden_dim


def _gemm_left(scorer, pp, rr, neg_mode: str):
    """The ``[C, chunk, D]`` vector whose dot product with a candidate row
    is the score, for the scorers that are bilinear in the candidate. It
    depends on which side is corrupted: ComplEx, SimplE and RESCAL are not
    symmetric in h and t."""
    if scorer is distmult_score:
        return pp * rr
    if scorer is simple_score:
        r_f, r_v = _split2(rr)
        p_i, p_j = _split2(pp)
        if neg_mode == "tail":   # pp is h; candidate rows are [t_i || t_j]
            return 0.5 * torch.cat([r_v * p_j, r_f * p_i], -1)
        return 0.5 * torch.cat([r_f * p_j, r_v * p_i], -1)
    if scorer is complex_score:
        pr, pi = _split2(pp)
        r_r, r_i = _split2(rr)
        if neg_mode == "tail":   # pp is h: score = f(h, r) . [tr || ti]
            return torch.cat([pr * r_r - pi * r_i, pr * r_i + pi * r_r], -1)
        return torch.cat([r_r * pr + r_i * pi, r_r * pi - r_i * pr], -1)
    M = _matrix(rr, pp.shape[-1])               # RESCAL
    if neg_mode == "tail":       # pp is h: (h^T M) . t
        return torch.matmul(pp.unsqueeze(-2), M).squeeze(-2)
    return torch.matmul(M, pp.unsqueeze(-1)).squeeze(-1)   # M t . h


def neg_score(scorer, pos_part, r, neg, chunk: int, neg_mode: str = "tail",
              **kw):
    """Chunked negative scoring.

    pos_part ``[B, D]`` the fixed side (heads for tail negatives and vice
    versa); r ``[B, D_r]``; neg ``[C, N, D]`` candidate replacements, with
    ``C = B // chunk``. Returns ``[B, N]``."""
    B = pos_part.shape[0]
    C, n = neg.shape[0], neg.shape[1]
    pp = pos_part.reshape(C, chunk, -1)
    rr = r.reshape(C, chunk, -1)
    if scorer in (distmult_score, complex_score, simple_score,
                  rescal_score):
        left = _gemm_left(scorer, pp, rr, neg_mode)
        out = torch.bmm(left, neg.transpose(1, 2))        # [C, chunk, N]
    elif scorer is transr_score:
        d = pp.shape[-1]
        M = _matrix(rr, d)                                 # [C, chunk, D, D]
        fixed = torch.matmul(pp.unsqueeze(-2), M).squeeze(-2)
        cand = torch.einsum("cnd,ckde->ckne", neg, M)      # [C, chunk, N, D]
        rt = rr[..., d * d:].unsqueeze(2)
        gamma = kw.get("gamma", 12.0)
        if neg_mode == "tail":
            out = gamma - (fixed.unsqueeze(2) + rt - cand).abs().sum(-1)
        else:
            out = gamma - (cand + rt - fixed.unsqueeze(2)).abs().sum(-1)
    elif neg_mode == "tail":
        out = scorer(pp[:, :, None, :], rr[:, :, None, :],
                     neg[:, None, :, :], **kw)
    else:
        out = scorer(neg[:, None, :, :], rr[:, :, None, :],
                     pp[:, :, None, :], **kw)
    return out.reshape(B, n)
