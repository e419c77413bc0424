#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Each phase prints one JSON line:

1. ``device``  — the card's name, the count of cards and the nvidia-smi
   name and power limit; TF32 is switched off for the whole run.
2. ``build``   — every ``dgl_operator_tpu_torch/csrc/*.cu`` built by
   nvcc for sm_90a (in parallel), with ptxas' register and spill lines.
3. ``kernel``  — one line per shape: the kernel against its plain torch
   version on the card (max abs error and tolerance), and the times of
   the kernel, the plain version and one ``F.embedding_bag`` call that
   computes the same function (a yardstick the port never calls),
   each with the L2 cache flushed before every launch, beside the
   least time the card's HBM allows for the bytes the call must move.
4. ``serve``   — a synthetic ogbn-products graph (cut to ``--scale``),
   split in 2 parts, a full-width DistSAGE (100 -> 256 -> 47, fanouts
   10 and 25) with seeded random weights written as a serving export,
   a ``ServeEngine`` on the card answering ``--requests`` requests of 1
   to 64 seeds through the ``MicroBatcher``, and the same fixed request
   run on the CPU engine for comparison.

Then a ``{"kernels": [...]}`` line (one entry per hand-written kernel:
launches during the serving phase, worst error, and the times of one
request's two aggregation calls), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failed check exits nonzero
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

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks: HBM bandwidth and float32 (non-tensor-core)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
L2_FLUSH_BYTES = 256 << 20      # > the 50 MB L2
FEAT, HIDDEN, CLASSES = 100, 256, 47
FANOUTS = (10, 25)
BATCH = 64


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


def bound(nbr, mask, d: int, itemsize: int):
    """Least time for one aggregation call: the larger of the bytes it
    must move over HBM bandwidth (each distinct valid source row read
    once, the output written once, nbr and mask read once) and its adds
    over the float32 rate. Counts what this data needs."""
    nd, f = nbr.shape
    valid = mask > 0
    uniq = int(nbr[valid].unique().numel()) if nd else 0
    nbytes = uniq * d * itemsize + nd * d * itemsize + nd * f * 5
    ops = int(valid.sum()) * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", uniq, nbytes)


def kernel_phase(torch, fanout, iters: int, card: str):
    """Kernel vs plain version on the card at the serving shapes (both
    dtypes), the trainer shapes and edge cases. Returns the per-shape
    records."""
    import torch.nn.functional as F

    shapes = [
        # name, N (rows of h), ND, F, D, dtype, mask kind
        ("serve_block0", 18304, 1664, 10, 100, torch.float32, "random"),
        ("serve_block1", 1664, 64, 25, 256, torch.float32, "random"),
        ("serve_block0", 18304, 1664, 10, 100, torch.bfloat16, "random"),
        ("serve_block1", 1664, 64, 25, 256, torch.bfloat16, "random"),
        ("train_block0", 286000, 26000, 10, 100, torch.float32, "random"),
        ("train_block1", 26000, 1000, 25, 256, torch.float32, "random"),
        ("fanout1_width37", 2048, 512, 1, 37, torch.float32, "random"),
        ("all_masked", 4096, 256, 10, 128, torch.float32, "none"),
        ("no_rows", 4096, 0, 10, 100, torch.float32, "random"),
    ]
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    for name, n, nd, f, d, dtype, kind in shapes:
        h = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
        nbr = torch.randint(0, n, (nd, f), device="cuda", generator=gen,
                            dtype=torch.int32)
        if kind == "none":
            mask = torch.zeros(nd, f, device="cuda", dtype=torch.uint8)
        else:
            mask = (torch.rand(nd, f, device="cuda", generator=gen)
                    < 0.8).to(torch.uint8)
            if nd:
                mask[-nd // 8:] = 0      # padded dst rows
        rec = {"phase": "kernel", "shape": name, "n": n, "nd": nd, "f": f,
               "d": d, "dtype": str(dtype).replace("torch.", ""),
               "card": card}
        worst = 0.0
        for mean in (False, True):
            before = fanout.fanout_agg.launches
            got = fanout.fanout_agg(h, nbr, mask, mean)
            torch.cuda.synchronize()
            check(fanout.fanout_agg.launches == before + (1 if nd else 0),
                  f"{name}: one launch per call with rows, none without")
            want = fanout.fanout_agg_plain(h, nbr, mask, mean)
            check(got.shape == want.shape == (nd, d) and
                  got.dtype == dtype, f"{name}: output shape and dtype")
            err = float((got.float() - want.float()).abs().max()) if nd \
                else 0.0
            scale = max(1.0, float(want.float().abs().max()) if nd else 0)
            # f32: the same fp32 terms summed in another order; bf16:
            # both round one fp32 sum, which may land either side of a
            # tie — one bf16 step (2^-7 relative) at the largest value
            tol = (1e-5 if dtype == torch.float32 else 2 ** -7) * scale
            check(err <= tol, f"{name} {rec['dtype']} mean={mean}: "
                  f"max abs err {err} > {tol}")
            if kind == "none":
                check(not got.any(), f"{name}: all-masked rows give 0")
            worst = max(worst, err)
        rec.update(max_abs_err=worst, tol_scale=scale)
        if nd:
            itemsize = h.element_size()
            b_ms, b_by, uniq, nbytes = bound(nbr, mask, d, itemsize)
            pad = torch.where(mask > 0, nbr, torch.full_like(nbr, n)).long()
            table = torch.cat([h, torch.zeros(1, d, device="cuda",
                                              dtype=dtype)])
            lib = F.embedding_bag(pad, table, mode="mean", padding_idx=n)
            lib_err = float((lib.float() - fanout.fanout_agg_plain(
                h, nbr, mask, True).float()).abs().max())
            rec.update(
                ms=time_cold_ms(torch, lambda: fanout.fanout_agg(
                    h, nbr, mask, True), flush, iters),
                warm_ms=time_warm_ms(torch, lambda: fanout.fanout_agg(
                    h, nbr, mask, True), iters),
                plain_ms=time_cold_ms(torch, lambda: fanout.fanout_agg_plain(
                    h, nbr, mask, True), flush, iters),
                library_ms=time_cold_ms(torch, lambda: F.embedding_bag(
                    pad, table, mode="mean", padding_idx=n), flush, iters),
                library_max_abs_err=lib_err,
                bound_ms=b_ms, bound_by=b_by, unique_rows=uniq,
                bytes=nbytes)
        records.append(rec)
        emit(**rec)
    return records


def serve_phase(torch, args, fanout, card: str):
    import numpy as np

    from dgl_operator_tpu_torch.graph import datasets
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
        ds = datasets.ogbn_products(seed=args.seed, scale=args.scale)
        g = ds.graph
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
        fanout.fanout_agg.launches = 0
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
        launches = fanout.fanout_agg.launches
        forwards = eng.forward_calls - forwards0
        check(forwards >= len(requests) > 0,
              "at least one forward per request")
        check(launches == 2 * forwards,
              f"2 fanout_agg launches per forward: {launches} launches, "
              f"{forwards} forwards")
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
             forwards=forwards, fanout_agg_launches=launches,
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
    from dgl_operator_tpu_torch.ops import _build, fanout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    emit(phase="device", kind=kind, count=count, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], tf32=False)

    sources = sorted(f for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        builds = list(pool.map(_build.build, sources))
    for src, b in zip(sources, builds):
        emit(phase="build", source=src, seconds=b.seconds,
             wall_s=time.perf_counter() - t0,
             ptxas=[ln.strip() for ln in b.log.splitlines()
                    if "registers" in ln or "spill" in ln])

    records = kernel_phase(torch, fanout, args.iters, smi)
    launches = serve_phase(torch, args, fanout, smi)

    serve = [r for r in records
             if r["shape"].startswith("serve") and r["dtype"] == "float32"]
    total = {k: sum(r[k] for r in serve)
             for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    bound_by = ("bytes" if all(r["bound_by"] == "bytes" for r in serve)
                else "operations")
    emit(kernels=[{
        "name": "fanout_agg", "route": "cuda",
        "source": "dgl_operator_tpu_torch/csrc/fanout_agg.cu",
        "replaces": "dgl_operator_tpu/ops/pallas_gather.py:221",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in records),
        "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"], "bound_by": bound_by,
        "library_ms": total["library_ms"]}])
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": kind, "count": count})
    return 0


if __name__ == "__main__":
    sys.exit(main())
