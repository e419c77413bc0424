#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Each phase prints JSON lines:

1. ``device``  — the card's name, the count of cards and the nvidia-smi
   name and power limit; TF32 is switched off for the whole run.
2. ``build``   — every ``dgl_operator_tpu_torch/csrc/*.cu`` built by
   nvcc for sm_90a (in parallel), with ptxas' register and spill lines.
3. ``setup``   — a synthetic ogbn-products graph (cut to ``--scale``),
   a full-width DistSAGE (100 -> 256 -> 47, fanouts 10 and 25, seeded
   random weights) and its ``SampledTrainer`` (batch 1000, calibrated
   caps), and one sampled training batch whose shapes the kernel phase
   uses.
4. ``kernel``  — one line per kernel and shape: each hand-written
   kernel (``fanout_agg``, ``gather_rows``, ``scatter_add_rows``)
   against its plain torch version on the card (max abs error and
   tolerance), and the times of the kernel, the plain version and one
   PyTorch call that computes the same function (a yardstick the port
   never calls), each with the L2 cache flushed before every launch,
   beside the least time the card's HBM allows for the bytes the call
   must move.
5. ``serve``   — the graph split in 2 parts, the model written as a
   serving export, a ``ServeEngine`` on the card answering
   ``--requests`` requests of 1 to 64 seeds through the
   ``MicroBatcher``, and the same fixed request run on the CPU engine
   for comparison.
6. ``train``   — one epoch of ``SampledTrainer.train`` over the first
   40,000 training ids (40 steps of 1000 seeds, dropout 0.5,
   evaluation at its end): losses, kernel launches per step, step
   times and the device time of one step's forward, backward and Adam.
7. ``train_cpu`` — the same seeded weights with dropout 0 stepped on the
   card and on the CPU over the first 5 batches: step-1 loss and
   gradients and step-5 loss must agree.

Then a ``{"kernels": [...]}`` line (one entry per hand-written kernel:
launches during the serving and training phases, worst error, and the
times of its calls in one training step), the nvidia-smi line, and
last ``{"ok": true, "device": {...}}``. Any failed check exits nonzero
before that last line is printed; without a CUDA card the script exits
1 at once.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks: HBM bandwidth and float32 (non-tensor-core)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
L2_FLUSH_BYTES = 256 << 20      # > the 50 MB L2
FEAT, HIDDEN, CLASSES = 100, 256, 47
FANOUTS = (10, 25)
BATCH = 64             # serving: seeds per forward
BATCH_TRAIN = 1000     # training: seeds per step
TRAIN_IDS = 40_000     # the train phase's epoch: 40 steps (a depth cut)
LR = 0.003
CPU_STEPS = 5          # steps of the card-against-CPU comparison


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_cold_ms(torch, fn, flush, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, with the L2
    cache evicted (a write of ``flush``) before each, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def time_warm_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches with its
    inputs left in L2 by the previous launch (when they fit). A spin
    kernel before each keeps the card busy while the host enqueues, so
    the events bracket the kernel and not the host's launch cost."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        torch.cuda._sleep(200_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def bound_ms(nbytes: int, ops: int):
    """The least time for a call: the larger of its bytes over HBM
    bandwidth and its operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fanout_bound(nbr, mask, d: int, itemsize: int):
    """One aggregation call must read each distinct valid source row
    once, write the output once and read nbr and mask once; it adds
    each valid row. Counts what this data needs."""
    nd, f = nbr.shape
    valid = mask > 0
    uniq = int(nbr[valid].unique().numel()) if nd else 0
    nbytes = uniq * d * itemsize + nd * d * itemsize + nd * f * 5
    return (*bound_ms(nbytes, int(valid.sum()) * d), uniq, nbytes)


def gather_bound(idx, d: int, itemsize: int):
    """A gather must read each distinct row once, write the output once
    and read idx once; it does no arithmetic."""
    m = idx.numel()
    uniq = int(idx.unique().numel()) if m else 0
    nbytes = (uniq + m) * d * itemsize + m * idx.element_size()
    return (*bound_ms(nbytes, 0), uniq, nbytes)


def scatter_bound(idx, mask, n: int, d: int, itemsize: int):
    """A scatter-add must write the [n, d] float32 output once and read
    g, idx and mask once; it adds (and divides) each valid slot's row.
    The kernel's zero fill then atomics also read and write each
    distinct target row once more: the design's cost, not the
    function's, so it is not in the bound (returned apart, last)."""
    nd, f = idx.shape
    valid = (mask > 0) if mask is not None else idx >= 0
    uniq = int(idx[valid].unique().numel()) if nd else 0
    nbytes = (n * d * 4 + nd * d * itemsize
              + nd * f * (idx.element_size() + (mask is not None)))
    return (*bound_ms(nbytes, int(valid.sum()) * d + nd * d), uniq, nbytes,
            2 * uniq * d * 4)


def time_record(torch, flush, iters: int, kernel, plain, library):
    """Cold (L2 flushed) and warm kernel times, the plain version's and
    the library yardstick's cold times, in ms."""
    return dict(
        ms=time_cold_ms(torch, kernel, flush, iters),
        warm_ms=time_warm_ms(torch, kernel, iters),
        plain_ms=time_cold_ms(torch, plain, flush, iters),
        library_ms=time_cold_ms(torch, library, flush, iters))


def err_of(got, want) -> Tuple[float, float]:
    """Max abs error of ``got`` against ``want`` and max |want| (at
    least 1), in float32."""
    if got.numel() == 0:
        return 0.0, 1.0
    err = float((got.float() - want.float()).abs().max())
    return err, max(1.0, float(want.float().abs().max()))


def fanout_records(torch, fanout, cases, flush, iters: int, card: str):
    """``fanout_agg`` against its plain version (sum and mean) on each
    case, timed for the mean, with ``F.embedding_bag`` as the
    yardstick."""
    import torch.nn.functional as F

    records = []
    for name, h, nbr, mask in cases:
        n, d = h.shape
        nd, f = nbr.shape
        rec = {"phase": "kernel", "kernel": "fanout_agg", "shape": name,
               "n": n, "nd": nd, "f": f, "d": d,
               "dtype": str(h.dtype).replace("torch.", ""), "card": card}
        worst = 0.0
        for mean in (False, True):
            before = fanout.fanout_agg.launches
            got = fanout.fanout_agg(h, nbr, mask, mean)
            torch.cuda.synchronize()
            check(fanout.fanout_agg.launches == before + (1 if nd else 0),
                  f"{name}: one launch per call with rows, none without")
            want = fanout.fanout_agg_plain(h, nbr, mask, mean)
            check(got.shape == want.shape == (nd, d) and
                  got.dtype == h.dtype, f"{name}: output shape and dtype")
            err, scale = err_of(got, want)
            # f32: the same fp32 terms summed in another order; bf16:
            # both round one fp32 sum, which may land either side of a
            # tie — one bf16 step (2^-7 relative) at the largest value
            tol = (1e-5 if h.dtype == torch.float32 else 2 ** -7) * scale
            check(err <= tol, f"{name} {rec['dtype']} mean={mean}: "
                  f"max abs err {err} > {tol}")
            if not (mask > 0).any():
                check(not got.any(), f"{name}: all-masked rows give 0")
            worst = max(worst, err)
        rec.update(max_abs_err=worst, tol_scale=scale)
        if nd:
            b_ms, b_by, uniq, nbytes = fanout_bound(nbr, mask, d,
                                                    h.element_size())
            pad = torch.where(mask > 0, nbr, torch.full_like(nbr, n)).long()
            table = torch.cat([h, torch.zeros(1, d, device="cuda",
                                              dtype=h.dtype)])
            lib = F.embedding_bag(pad, table, mode="mean", padding_idx=n)
            rec.update(
                **time_record(
                    torch, flush, iters,
                    lambda: fanout.fanout_agg(h, nbr, mask, True),
                    lambda: fanout.fanout_agg_plain(h, nbr, mask, True),
                    lambda: F.embedding_bag(pad, table, mode="mean",
                                            padding_idx=n)),
                library_max_abs_err=err_of(lib, fanout.fanout_agg_plain(
                    h, nbr, mask, True))[0],
                bound_ms=b_ms, bound_by=b_by, unique_rows=uniq,
                bytes=nbytes)
        records.append(rec)
        emit(**rec)
    return records


def gather_records(torch, gather, cases, flush, iters: int, card: str):
    """``gather_rows`` against its plain version (a copy: exact) on each
    case, with ``torch.index_select`` as the yardstick."""
    records = []
    for name, table, idx in cases:
        n, d = table.shape
        m = idx.numel()
        rec = {"phase": "kernel", "kernel": "gather_rows", "shape": name,
               "n": n, "m": m, "d": d,
               "dtype": str(table.dtype).replace("torch.", ""),
               "idx_dtype": str(idx.dtype).replace("torch.", ""),
               "card": card}
        before = gather.gather_rows.launches
        got = gather.gather_rows(table, idx)
        torch.cuda.synchronize()
        check(gather.gather_rows.launches == before + (1 if m else 0),
              f"{name}: one gather launch with rows, none without")
        want = gather.gather_rows_plain(table, idx)
        check(got.shape == (m, d) and got.dtype == table.dtype,
              f"{name}: gather shape and dtype")
        err, _ = err_of(got, want)
        check(torch.equal(got, want), f"{name}: gather is a copy, "
              f"max abs err {err}")
        rec.update(max_abs_err=err, tol=0.0)
        if m:
            b_ms, b_by, uniq, nbytes = gather_bound(idx, d,
                                                    table.element_size())
            rec.update(
                **time_record(
                    torch, flush, iters,
                    lambda: gather.gather_rows(table, idx),
                    lambda: gather.gather_rows_plain(table, idx),
                    lambda: torch.index_select(table, 0, idx)),
                bound_ms=b_ms, bound_by=b_by, unique_rows=uniq,
                bytes=nbytes)
        records.append(rec)
        emit(**rec)
    return records


def scatter_records(torch, scatter, cases, flush, iters: int, card: str):
    """``scatter_add_rows`` against its plain version on each case (the
    backward of an aggregation, or of a gather when ``mask`` is None),
    with the backward of ``F.embedding_bag`` (or ``index_add_`` for the
    gather's) as the yardstick."""
    import torch.nn.functional as F

    records = []
    for name, g, idx, mask, n, mean in cases:
        nd, f = idx.shape
        d = g.shape[1]
        rec = {"phase": "kernel", "kernel": "scatter_add_rows",
               "shape": name, "n": n, "nd": nd, "f": f, "d": d,
               "mean": mean, "masked": mask is not None,
               "dtype": str(g.dtype).replace("torch.", ""), "card": card}
        before = scatter.scatter_add_rows.launches
        got = scatter.scatter_add_rows(g, idx, mask, n, mean)
        torch.cuda.synchronize()
        check(scatter.scatter_add_rows.launches == before + (1 if nd else 0),
              f"{name}: one scatter launch with rows, none without")
        want = scatter.scatter_add_rows_plain(g, idx, mask, n, mean)
        check(got.shape == (n, d) and got.dtype == torch.float32,
              f"{name}: scatter shape and dtype")
        err, scale = err_of(got, want)
        # the same fp32 terms, added by atomics in another order
        tol = 1e-5 * scale
        check(err <= tol, f"{name} {rec['dtype']}: max abs err {err} > "
              f"{tol}")
        if mask is not None and not (mask > 0).any():
            check(not got.any(), f"{name}: all-masked rows add nothing")
        rec.update(max_abs_err=err, tol_scale=scale)
        if nd:
            b_ms, b_by, uniq, nbytes, rmw = scatter_bound(
                idx, mask, n, d, g.element_size())
            if mask is None:
                flat = idx[:, 0].long()

                def library():
                    return torch.zeros(n, d, device="cuda",
                                       dtype=g.dtype).index_add_(0, flat, g)
                lib = library()
            else:
                pad = torch.where(mask > 0, idx,
                                  torch.full_like(idx, n)).long()
                table = torch.zeros(n + 1, d, device="cuda", dtype=g.dtype,
                                    requires_grad=True)
                out = F.embedding_bag(pad, table,
                                      mode="mean" if mean else "sum",
                                      padding_idx=n)

                def library():
                    return torch.autograd.grad(out, table, g,
                                               retain_graph=True)[0]
                lib = library()[:n]
            rec.update(
                **time_record(
                    torch, flush, iters,
                    lambda: scatter.scatter_add_rows(g, idx, mask, n, mean),
                    lambda: scatter.scatter_add_rows_plain(g, idx, mask, n,
                                                           mean),
                    library),
                library_max_abs_err=err_of(lib, want)[0],
                bound_ms=b_ms, bound_by=b_by, unique_rows=uniq,
                bytes=nbytes, atomic_rmw_bytes=rmw)
        records.append(rec)
        emit(**rec)
    return records


def kernel_phase(torch, args, ops, trainer, mb, card: str):
    """Every kernel against its plain version on the card: at the
    serving shapes, at the training step's own shapes (one sampled
    batch: its input ids, its blocks' nbr and mask, the features on
    the card) in both dtypes, and at edge cases."""
    fanout, gather, scatter = ops
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    def rand_block(n, nd, f, kind="random"):
        nbr = torch.randint(0, n, (nd, f), device="cuda", generator=gen,
                            dtype=torch.int32)
        if kind == "none":
            return nbr, torch.zeros(nd, f, device="cuda", dtype=torch.uint8)
        mask = (torch.rand(nd, f, device="cuda", generator=gen)
                < 0.8).to(torch.uint8)
        if nd:
            mask[-nd // 8:] = 0      # padded dst rows
        return nbr, mask

    blocks, inputs, _ = trainer.ship(mb)
    (nbr0, mask0), (nbr1, mask1) = [(b.nbr, b.mask) for b in blocks]
    caps = trainer.caps
    feats = trainer.feats
    h0 = gather.gather_rows(feats, inputs)          # block 0's input rows
    h1 = randn(caps[1], HIDDEN)
    serve0, serve1 = rand_block(18304, 1664, 10), rand_block(1664, 64, 25)
    fan_cases = [
        ("serve_block0", randn(18304, FEAT), *serve0),
        ("serve_block1", randn(1664, HIDDEN), *serve1),
        ("serve_block0", randn(18304, FEAT, dtype=torch.bfloat16), *serve0),
        ("serve_block1", randn(1664, HIDDEN, dtype=torch.bfloat16),
         *serve1),
        ("train_block0", h0, nbr0, mask0),
        ("train_block1", h1, nbr1, mask1),
        ("train_block1", h1.bfloat16(), nbr1, mask1),
        ("fanout1_width37", randn(2048, 37), *rand_block(2048, 512, 1)),
        ("all_masked", randn(4096, 128), *rand_block(4096, 256, 10, "none")),
        ("no_rows", randn(4096, FEAT), *rand_block(4096, 0, 10)),
    ]
    records = fanout_records(torch, fanout, fan_cases, flush, args.iters,
                             card)
    feats16 = feats.bfloat16()
    gather_cases = [
        ("train_feats", feats, inputs),
        ("train_feats", feats16, inputs),
        ("train_feats_int64", feats, inputs.long()),
        ("serve_feats", feats, torch.randint(
            0, feats.shape[0], (18304,), device="cuda", generator=gen)),
        ("width37", randn(2048, 37), torch.randint(
            0, 2048, (512,), device="cuda", generator=gen,
            dtype=torch.int32)),
        ("no_rows", feats, inputs[:0]),
    ]
    records += gather_records(torch, gather, gather_cases, flush,
                              args.iters, card)
    g1 = randn(BATCH_TRAIN, HIDDEN)
    scatter_cases = [
        # name, g, idx, mask, rows of dst, mean
        ("train_block1_bwd", g1, nbr1, mask1, caps[1], True),
        ("train_block1_bwd", g1.bfloat16(), nbr1, mask1, caps[1], True),
        ("train_block0_bwd", randn(caps[1], FEAT), nbr0, mask0, caps[2],
         True),
        ("train_feats_bwd", randn(caps[2], FEAT), inputs.view(-1, 1), None,
         feats.shape[0], False),
        ("all_masked", randn(256, 128), *rand_block(4096, 256, 10, "none"),
         4096, True),
        ("no_rows", randn(0, FEAT), *rand_block(4096, 0, 10), 4096, True),
    ]
    records += scatter_records(torch, scatter, scatter_cases, flush,
                               args.iters, card)
    return records


def serve_phase(torch, args, wrappers, g, card: str):
    import numpy as np

    from dgl_operator_tpu_torch.graph.partition import partition_graph
    from dgl_operator_tpu_torch.models.sage import (DistSAGE,
                                                    state_dict_to_flax)
    from dgl_operator_tpu_torch.obs import get_obs
    from dgl_operator_tpu_torch.runtime.checkpoint import export_for_serving
    from dgl_operator_tpu_torch.serve.engine import ServeConfig, ServeEngine

    work = os.path.join(REPO, "_chip_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        parts = np.random.default_rng(args.seed).permutation(
            g.num_nodes) % 2
        cfg_json = partition_graph(g, "ogbn-products", 2,
                                   os.path.join(work, "book"), parts=parts)
        setup_s = time.perf_counter() - t0
        model = DistSAGE(FEAT, HIDDEN, CLASSES, device="cuda",
                         generator=torch.Generator().manual_seed(args.seed))
        export = export_for_serving(os.path.join(work, "export") + os.sep,
                                    state_dict_to_flax(model.state_dict()))
        cfg = ServeConfig(fanouts=FANOUTS, batch_size=BATCH,
                          halo_cache_frac=0.25, cap_policy="worst")
        eng = ServeEngine(model, cfg_json, params_path=export, cfg=cfg,
                          device="cuda")
        check(eng.ready, "engine warm")
        metrics = get_obs().metrics
        hits = metrics.counter("serve_halo_cache_hits_total")
        remote = metrics.counter("serve_halo_remote_rows_total")
        h0, r0 = hits.value(), remote.value()
        rng = np.random.default_rng(args.seed + 1)
        requests = [rng.choice(g.num_nodes, size=int(rng.integers(1, 65)),
                               replace=False) for _ in range(args.requests)]
        lat_ms = []
        # the main path: every kernel count starts at 0 here
        reset_counts(wrappers)
        forwards0 = eng.forward_calls
        served_from = time.perf_counter()
        batcher = eng.make_batcher()
        try:
            for ids in requests:
                t = time.perf_counter()
                pred = batcher.submit(ids).result(timeout=120)
                lat_ms.append((time.perf_counter() - t) * 1e3)
                check(pred.shape == ids.shape and pred.min() >= 0
                      and pred.max() < CLASSES,
                      "predictions are classes in [0, 47)")
        finally:
            batcher.stop()
        served_to = time.perf_counter()
        launches = read_counts(wrappers)
        forwards = eng.forward_calls - forwards0
        check(forwards >= len(requests) > 0,
              "at least one forward per request")
        check(launches == {"fanout_agg": 2 * forwards, "gather_rows": 0,
                           "scatter_add_rows": 0},
              f"2 fanout_agg launches per forward and no other: "
              f"{launches} launches, {forwards} forwards")
        check(eng.nonfinite_logits == 0, "finite logits")
        d_hits, d_remote = hits.value() - h0, remote.value() - r0
        check(d_hits > 0 and d_remote > 0,
              "halo cache hits and owner fetches counted")
        # one fixed request and sample seed, on the card and on the CPU
        fixed = np.sort(rng.choice(g.num_nodes, size=BATCH, replace=False))
        lg_gpu = eng.predict_logits(fixed, sample_seed=7)
        cpu_model = DistSAGE(FEAT, HIDDEN, CLASSES, device="cpu")
        eng_cpu = ServeEngine(cpu_model, cfg_json, params_path=export,
                              cfg=cfg, device="cpu", warm=False)
        lg_cpu = eng_cpu.predict_logits(fixed, sample_seed=7)
        check(bool(np.isfinite(lg_gpu).all()) and lg_gpu.shape ==
              (BATCH, CLASSES), "fixed request: finite [64, 47] logits")
        cpu_err = float(np.abs(lg_gpu - lg_cpu).max())
        cpu_tol = 1e-4 * max(1.0, float(np.abs(lg_cpu).max()))
        check(cpu_err <= cpu_tol,
              f"card vs CPU logits: max abs err {cpu_err} > {cpu_tol}")
        check(bool((lg_gpu.argmax(-1) == lg_cpu.argmax(-1)).all()),
              "card vs CPU predictions")
        lat = np.asarray(lat_ms)
        # the engine's spans over the served window: host sample+gather
        # per part chunk, and ship+forward+fetch (ends in a device sync)
        spans = [s for s in get_obs().spans
                 if served_from <= s["t0"] <= served_to]
        span_ms = {name: float(np.mean([(s["t1"] - s["t0"]) * 1e3
                                        for s in spans
                                        if s["name"] == name]))
                   for name in ("engine_fanout", "forward_dispatch")}
        emit(phase="serve", card=card, nodes=g.num_nodes, edges=g.num_edges,
             parts=2, setup_s=setup_s, warmup_s=eng.warmup_seconds,
             load_s=eng.load_seconds, caps=eng.caps,
             requests=len(requests),
             seeds=int(sum(len(r) for r in requests)),
             forwards=forwards, launches=launches,
             halo_cache_hits=d_hits, halo_remote_rows=d_remote,
             p50_ms=float(np.percentile(lat, 50)),
             p99_ms=float(np.percentile(lat, 99)),
             sample_gather_ms_mean=span_ms["engine_fanout"],
             forward_dispatch_ms_mean=span_ms["forward_dispatch"],
             max_wait_ms=cfg.max_wait_ms,
             cpu_max_abs_err=cpu_err, cpu_tol=cpu_tol)
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def reset_counts(wrappers) -> None:
    for w in wrappers:
        w.launches = 0


def read_counts(wrappers) -> dict:
    """Launches per kernel, by the wrapper's (and kernel's) name."""
    return {w.__name__: w.launches for w in wrappers}


def setup_phase(torch, args, card: str):
    """The graph, the full-width model, its trainer (calibrated caps)
    and one sampled batch of the training stream."""
    import numpy as np

    from dgl_operator_tpu_torch.graph import datasets
    from dgl_operator_tpu_torch.models.sage import DistSAGE
    from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                     TrainConfig)

    t0 = time.perf_counter()
    g = datasets.ogbn_products(seed=args.seed, scale=args.scale).graph
    graph_s = time.perf_counter() - t0
    train_ids = np.nonzero(g.ndata["train_mask"])[0][:TRAIN_IDS]
    model = DistSAGE(FEAT, HIDDEN, CLASSES, device="cuda",
                     generator=torch.Generator().manual_seed(args.seed))
    cfg = TrainConfig(batch_size=BATCH_TRAIN, fanouts=FANOUTS, lr=LR,
                      eval_every=1, num_epochs=1, seed=args.seed)
    t1 = time.perf_counter()
    trainer = SampledTrainer(model, g, cfg, train_ids=train_ids)
    trainer_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    mb = trainer.sample(train_ids[:BATCH_TRAIN], 0)
    sample_s = time.perf_counter() - t2
    emit(phase="setup", card=card, nodes=g.num_nodes, edges=g.num_edges,
         train_ids=len(train_ids), caps=trainer.caps, graph_s=graph_s,
         trainer_s=trainer_s, sample_one_batch_s=sample_s,
         valid_slots=[int((np.asarray(b.mask) > 0).sum())
                      for b in mb.blocks])
    return g, trainer, mb


def step_device_ms(torch, trainer, mbs):
    """Per batch: the host time of sampling and of shipping it to the
    card, then the device time of its step's forward (gather, model,
    loss), backward and Adam update by CUDA events. A spin kernel first
    keeps the card busy while the host enqueues the step, so the events
    bracket device work and not the host's launch cost."""
    import numpy as np

    rows = []
    for seeds, step_seed in mbs:
        t = time.perf_counter()
        mb = trainer.sample(seeds, step_seed)
        sample_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        t = time.perf_counter()
        batch = trainer.ship(mb)
        torch.cuda.synchronize()
        h2d_ms = (time.perf_counter() - t) * 1e3
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        trainer.optimizer.zero_grad(set_to_none=True)
        torch.cuda._sleep(100_000_000)
        ev[0].record()
        loss, _ = trainer.loss(batch)
        ev[1].record()
        loss.backward()
        ev[2].record()
        trainer.optimizer.step()
        ev[3].record()
        torch.cuda.synchronize()
        rows.append([sample_ms, h2d_ms] + [ev[k].elapsed_time(ev[k + 1])
                                           for k in range(3)])
    # the first batch pays one-time costs (Adam's state allocation)
    mean = np.mean(rows[1:], axis=0)
    nbytes = (sum(b.nbr.nbytes + b.mask.nbytes for b in mb.blocks)
              + mb.input_nodes.nbytes + mb.seeds.nbytes)
    return dict(sample_ms=mean[0], h2d_ms=mean[1], h2d_bytes=int(nbytes),
                forward_ms=mean[2], backward_ms=mean[3], adam_ms=mean[4])


def train_phase(torch, args, wrappers, trainer, card: str):
    """One epoch of ``SampledTrainer.train`` (the main path), then the
    device time of single steps."""
    import numpy as np

    # the main path: every kernel count starts at 0 here
    reset_counts(wrappers)
    t0 = time.perf_counter()
    out = trainer.train()
    wall_s = time.perf_counter() - t0
    launches = read_counts(wrappers)
    steps = out["step"]
    rec = out["history"][0]
    losses = np.asarray(rec["losses"])
    check(steps == len(trainer.train_ids) // BATCH_TRAIN == len(losses)
          > 2 * 5, f"{steps} steps over {len(trainer.train_ids)} ids")
    # the warm-up forward before the first step adds one gather and two
    # aggregations; each step launches 1 gather, 2 aggregations and the
    # backward of block 1's aggregation (block 0's input needs none)
    check(launches == {"fanout_agg": 2 * steps + 2,
                       "gather_rows": steps + 1,
                       "scatter_add_rows": steps},
          f"per step 1 gather_rows, 2 fanout_agg, 1 scatter_add_rows: "
          f"{launches} launches in {steps} steps")
    check(bool(np.isfinite(losses).all()), "finite losses")
    check(losses[-5:].mean() < losses[:5].mean(),
          f"loss decreases: first 5 {losses[:5].mean()}, last 5 "
          f"{losses[-5:].mean()}")
    val, test = rec.get("val_acc"), rec.get("test_acc")
    check(val is not None and test is not None and 0 <= val <= 1
          and 0 <= test <= 1, f"val_acc {val} and test_acc {test} in [0, 1]")
    step_ms = np.asarray(rec["step_s"]) * 1e3
    rng = np.random.default_rng(args.seed + 2)
    probe = [(rng.choice(trainer.train_ids, BATCH_TRAIN, replace=False),
              10_000 + i) for i in range(4)]
    dev = step_device_ms(torch, trainer, probe)
    device_ms = dev["forward_ms"] + dev["backward_ms"] + dev["adam_ms"]
    emit(phase="train", card=card, caps=trainer.caps, steps=steps,
         seeds=int(steps * BATCH_TRAIN), launches=launches,
         launches_per_step={k: (v - {"fanout_agg": 2, "gather_rows": 1}
                                .get(k, 0)) / steps
                            for k, v in launches.items()},
         loss_first5=float(losses[:5].mean()),
         loss_last5=float(losses[-5:].mean()), losses=losses.tolist(),
         step_ms_mean=float(step_ms.mean()),
         step_ms_p50=float(np.percentile(step_ms, 50)),
         **{f"{k}_ms_per_step": rec.get(k, 0.0) * 1e3 / steps
            for k in ("sample", "stall", "dispatch")},
         seeds_per_sec=rec["seeds_per_sec"], epoch_s=rec["time"],
         train_call_s=wall_s, eval_s=rec["eval_s"], val_acc=val,
         test_acc=test, **{f"probe_{k}": v for k, v in dev.items()},
         probe_device_ms=device_ms,
         device_busy_share=device_ms / float(step_ms.mean()))
    return launches


def train_cpu_phase(torch, args, g, trainer, card: str):
    """The same seeded weights, dropout 0 and the first batches of the
    training stream, stepped on the card and on the CPU."""
    import numpy as np

    from dgl_operator_tpu_torch.models.sage import DistSAGE
    from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                     TrainConfig)

    # caps do not matter here: both take the main trainer's batches
    cfg = TrainConfig(batch_size=BATCH_TRAIN, fanouts=FANOUTS, lr=LR,
                      dropout=0.0, cap_policy="worst", seed=args.seed)
    ids = np.random.default_rng(args.seed).permutation(trainer.train_ids)
    mbs = [trainer.sample(ids[b * BATCH_TRAIN:(b + 1) * BATCH_TRAIN], b)
           for b in range(CPU_STEPS)]
    runs = {}
    for dev in ("cuda", "cpu"):
        model = DistSAGE(FEAT, HIDDEN, CLASSES, device=dev,
                         generator=torch.Generator().manual_seed(
                             args.seed + 1))
        tr = SampledTrainer(model, g, cfg, train_ids=trainer.train_ids,
                            device=dev)
        t0 = time.perf_counter()
        losses, grads = [], None
        for i, mb in enumerate(mbs):
            loss, _ = tr.train_step(mb)
            losses.append(float(loss))
            if i == 0:
                grads = {n: p.grad.detach().cpu().clone()
                         for n, p in model.named_parameters()}
        runs[dev] = (losses, grads, time.perf_counter() - t0)
    (gl, gg, gs), (cl, cg, cs) = runs["cuda"], runs["cpu"]
    rel1 = abs(gl[0] - cl[0]) / abs(cl[0])
    rel5 = abs(gl[-1] - cl[-1]) / abs(cl[-1])
    check(rel1 <= 1e-5, f"step-1 loss card {gl[0]} vs CPU {cl[0]}: "
          f"relative {rel1} > 1e-5")
    grad_err = {}
    for name, want in cg.items():
        err = float((gg[name] - want).abs().max())
        tol = 1e-4 * float(want.abs().max())
        check(err <= tol, f"step-1 grad {name}: max abs err {err} > {tol}")
        grad_err[name] = err / max(float(want.abs().max()), 1e-30)
    check(rel5 <= 1e-3, f"step-{CPU_STEPS} loss card {gl[-1]} vs CPU "
          f"{cl[-1]}: relative {rel5} > 1e-3")
    emit(phase="train_cpu", card=card, steps=CPU_STEPS, card_losses=gl,
         cpu_losses=cl, step1_loss_rel_err=rel1,
         step5_loss_rel_err=rel5, step1_grad_rel_err=grad_err,
         card_s=gs, cpu_s=cs)


def kernel_entry(records, name, main_shapes, launches, replaces):
    """The kernels line's entry: worst error over every shape, times
    summed over the calls of one training step."""
    mine = [r for r in records if r["kernel"] == name]
    main = [r for r in mine if (r["shape"], r["dtype"]) in main_shapes]
    check(len(main) == len(main_shapes), f"{name}: main-path records")
    total = {k: sum(r[k] for r in main)
             for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    return {"name": name, "route": "cuda",
            "source": f"dgl_operator_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"],
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                        for r in main) else "operations"),
            "library_ms": total["library_ms"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=0.1,
                    help="ogbn-products graph size (1.0 = 2.45M nodes)")
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--iters", type=int, default=50,
                    help="launches per kernel timing")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from dgl_operator_tpu_torch.ops import _build, fanout, gather, scatter

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    emit(phase="device", kind=kind, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], tf32=False)

    ops = (fanout, gather, scatter)
    wrappers = (fanout.fanout_agg, gather.gather_rows,
                scatter.scatter_add_rows)
    sources = sorted(f for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    check(sources == sorted(f"{w.__name__}.cu" for w in wrappers),
          f"one source per kernel: {sources}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        builds = list(pool.map(_build.build, sources))
    for src, b in zip(sources, builds):
        emit(phase="build", source=src, seconds=b.seconds,
             wall_s=time.perf_counter() - t0,
             ptxas=[ln.strip() for ln in b.log.splitlines()
                    if "registers" in ln or "spill" in ln])

    g, trainer, mb = setup_phase(torch, args, smi)
    records = kernel_phase(torch, args, ops, trainer, mb, smi)
    served = serve_phase(torch, args, wrappers, g, smi)
    trained = train_phase(torch, args, wrappers, trainer, smi)
    train_cpu_phase(torch, args, g, trainer, smi)

    pg = "dgl_operator_tpu/ops/pallas_gather.py"
    emit(kernels=[
        kernel_entry(records, "fanout_agg",
                     {("train_block0", "float32"),
                      ("train_block1", "float32")},
                     served["fanout_agg"] + trained["fanout_agg"],
                     f"{pg}:221"),
        kernel_entry(records, "gather_rows", {("train_feats", "float32")},
                     served["gather_rows"] + trained["gather_rows"],
                     f"{pg}:120"),
        kernel_entry(records, "scatter_add_rows",
                     {("train_block1_bwd", "float32")},
                     served["scatter_add_rows"]
                     + trained["scatter_add_rows"], f"{pg}:234"),
    ])
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": kind, "count": count})
    return 0


if __name__ == "__main__":
    sys.exit(main())
