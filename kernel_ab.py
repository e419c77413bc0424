#!/usr/bin/env python3
"""Time two checkouts' aggregation and scatter kernels on one card.

    python3 kernel_ab.py inputs OUT.pt
    python3 kernel_ab.py time ROOT OUT.pt --label NAME

``inputs`` samples one training batch with this checkout's trainer (as
``chip_smoke.py``'s setup phase does: ogbn-products at scale 0.1, batch
1000, fanouts 10 and 25) and saves the main path's kernel operands.
``time`` imports ``dgl_operator_tpu_torch`` from ROOT (this checkout, or
another one unpacked with ``git archive``), builds its ``fanout_agg``
and ``scatter_add_rows``, holds each against its plain version, and
times it at ``chip_smoke.py``'s shapes with this checkout's timers, so
two checkouts are timed alike:

- ``ms``: L2 flushed by a write, then a spin kernel, then the kernel
  (``chip_smoke.time_cold_ms``);
- ``no_spin_ms``: the same without the spin kernel, so the host's time
  in the wrapper can fall between the events;
- ``clean_ms``: L2 flushed by a read; ``warm_ms``: L2 left warm.

One JSON line per case. Compare checkouts within one call, in the order
A, B, B, A.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_inputs(out: str, seed: int) -> None:
    import torch

    sys.path.insert(0, HERE)
    cs = _chip_smoke()
    args = argparse.Namespace(seed=seed, scale=0.1)
    _, trainer, mb = cs.setup_phase(torch, args, cs.nvidia_smi_line())
    (b0, b1), inputs, _ = trainer.ship(mb)
    torch.save(dict(nbr0=b0.nbr.cpu(), mask0=b0.mask.cpu(),
                    nbr1=b1.nbr.cpu(), mask1=b1.mask.cpu(),
                    inputs=inputs.cpu(), caps=list(trainer.caps),
                    n_feats=int(trainer.feats.shape[0]),
                    h0=trainer.feats[inputs.long()].cpu()), out)


def time_no_spin_ms(torch, fn, flush, iters: int) -> float:
    """Cold mean device time without a spin kernel after the flush."""
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


def time_root(root: str, path: str, label: str, seed: int,
              iters: int) -> None:
    import torch

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from dgl_operator_tpu_torch.ops import fanout, scatter
    for mod in (fanout, scatter):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}")
    cs = _chip_smoke()
    card = cs.nvidia_smi_line()
    t0 = time.perf_counter()
    for src in ("fanout_agg.cu", "scatter_add_rows.cu"):
        fanout._build.load(src)
    build_s = time.perf_counter() - t0
    takes_plan = "plan" in inspect.signature(
        scatter.scatter_add_rows).parameters
    x = torch.load(path)
    caps = x["caps"]
    dev = {k: v.cuda() for k, v in x.items() if torch.is_tensor(v)}
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    def rand_block(n, nd, f):
        nbr = torch.randint(0, n, (nd, f), device="cuda", generator=gen,
                            dtype=torch.int32)
        mask = (torch.rand(nd, f, device="cuda", generator=gen)
                < 0.8).to(torch.uint8)
        mask[-nd // 8:] = 0
        return nbr, mask

    # every random operand first, in one order, for every checkout
    h1 = randn(caps[1], 256)
    serve0 = (randn(18304, 100), *rand_block(18304, 1664, 10))
    serve1 = (randn(1664, 256), *rand_block(1664, 64, 25))
    g1, g0 = randn(1000, 256), randn(caps[1], 100)
    g_feats = randn(caps[2], 100)
    nbr1, mask1 = dev["nbr1"], dev["mask1"]
    hub_nbr, hub_mask = nbr1.clone(), mask1.clone()
    hub_nbr[:, 0], hub_mask[:, 0] = 7, 1
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, device="cuda")

    def timed(fn):
        return dict(ms=cs.time_cold_ms(torch, fn, flush, iters),
                    no_spin_ms=time_no_spin_ms(torch, fn, flush, iters),
                    clean_ms=cs.time_cold_ms(torch, fn, flush, iters,
                                             clean=True),
                    warm_ms=cs.time_warm_ms(torch, fn, iters))

    def emit(**rec):
        print(json.dumps(dict(label=label, card=card, build_s=build_s,
                              **rec)), flush=True)

    fan_cases = [
        ("train_block0", dev["h0"], dev["nbr0"], dev["mask0"]),
        ("train_block1", h1, nbr1, mask1),
        ("serve_block0", *serve0),
        ("serve_block1", *serve1),
        ("train_block1_bf16", h1.bfloat16(), nbr1, mask1),
    ]
    for name, h, nbr, mask in fan_cases:
        got = fanout.fanout_agg(h, nbr, mask, True)
        want = fanout.fanout_agg_plain(h, nbr, mask, True)
        err, scale = cs.err_of(got, want)
        tol = (1e-5 if h.dtype == torch.float32 else 2 ** -7) * scale
        cs.check(err <= tol, f"{label} {name}: max abs err {err} > {tol}")
        emit(kernel="fanout_agg", shape=name, max_abs_err=err,
             **timed(lambda: fanout.fanout_agg(h, nbr, mask, True)))

    scatter_cases = [
        ("train_block1_bwd", g1, nbr1, mask1, caps[1], True),
        ("train_block1_hub", g1, hub_nbr, hub_mask, caps[1], True),
        ("train_block1_none", g1, nbr1, torch.zeros_like(mask1), caps[1],
         True),
        ("train_block0_bwd", g0, dev["nbr0"], dev["mask0"], caps[2], True),
        ("train_feats_bwd", g_feats, dev["inputs"].view(-1, 1), None,
         x["n_feats"], False),
    ]
    for name, g, idx, mask, n, mean in scatter_cases:
        kw = {}
        if takes_plan:
            kw["plan"] = scatter.scatter_plan(
                idx.cpu().numpy(),
                None if mask is None else mask.cpu().numpy(), n).to("cuda")

        def run():
            return scatter.scatter_add_rows(g, idx, mask, n, mean, **kw)
        got, again = run(), run()
        want = scatter.scatter_add_rows_plain(g, idx, mask, n, mean)
        err, scale = cs.err_of(got, want)
        cs.check(err <= 1e-5 * scale,
                 f"{label} {name}: max abs err {err} > {1e-5 * scale}")
        emit(kernel="scatter_add_rows", shape=name, max_abs_err=err,
             two_launches_equal=bool(torch.equal(got, again)), **timed(run))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("inputs")
    p.add_argument("out")
    p = sub.add_parser("time")
    p.add_argument("root")
    p.add_argument("inputs")
    p.add_argument("--label", default="")
    p.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.cmd == "inputs":
        make_inputs(args.out, args.seed)
    else:
        time_root(args.root, args.inputs, args.label or args.root,
                  args.seed, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
