#!/usr/bin/env python3
"""Time two checkouts' hand-written kernels on one card.

    python3 kernel_ab.py inputs OUT.pt
    python3 kernel_ab.py time ROOT OUT.pt --label NAME [--kernels K,...]
    python3 kernel_ab.py sass ROOT --label NAME

``inputs`` samples one training batch with this checkout's trainer (as
``chip_smoke.py``'s setup phase does: ogbn-products at scale 0.1, batch
1000, fanouts 10 and 25) and saves the main path's kernel operands and
the features, then takes one tail-mode ``KGETrainer`` host step on
synthetic FB15k (ComplEx, dim 400, as ``chip_smoke.py``'s KGE phase)
and saves its two lookups' ids: the entity ids (2,304 int32 into
14,951 rows) and the relation ids (1,024 int32 into 1,345 rows).
``time`` imports ``dgl_operator_tpu_torch`` from ROOT (this checkout, or
another one unpacked with ``git archive``), builds its ``fanout_agg``,
``gather_rows`` and ``scatter_add_rows`` (or those named by
``--kernels``), holds each against its plain version (``gather_rows``
bit for bit), and times it at ``chip_smoke.py``'s shapes with this
checkout's timers, so two checkouts are timed alike:

- ``ms``: L2 flushed by a write, then a spin kernel, then the kernel
  (``chip_smoke.time_cold_ms``);
- ``no_spin_ms``: the same without the spin kernel, so the host's time
  in the wrapper can fall between the events;
- ``clean_ms``: L2 flushed by a read; ``warm_ms``: L2 left warm;
- for ``gather_rows``, ``index_select_ms``: ``torch.index_select`` on
  the same inputs under ``ms``'s timer, and the bound.

The gather's shapes are those of the ``kernel`` lines: the KGE lookups,
the training batch's input rows (f32 and bf16), 18,304 random serving
rows, width 37, and three dist shapes rebuilt without the dist phase at
their recorded sizes (``dist_slot_inputs``: the batch's first 94,656
input ids; ``dist_exchange`` and ``dist_mp_owner_serve``: int64 ids of
6,278 and 2,362 distinct rows, each request segment's padding naming
one zero row). A ROOT without the KGE modules skips the KGE shapes and
says so. A ``{"kernel": "floor"}`` line gives the same timers around a
near-empty launch (``torch.cuda._sleep(1)``).

``sass`` builds ROOT's ``gather_rows.cu`` and reads its machine code
with ``cuobjdump -sass``: per kernel, the global loads and stores, the
loads issued before the first store, and the branches.

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


KERNELS = ("fanout_agg", "gather_rows", "scatter_add_rows", "floor")


def kge_ids(torch, cs, seed: int) -> dict:
    """The two lookups of one tail-mode ``KGETrainer`` host step on
    synthetic FB15k (as ``chip_smoke.kge_kernel_records`` takes them)."""
    from dgl_operator_tpu_torch.graph import datasets
    from dgl_operator_tpu_torch.graph.kge_sampler import TrainDataset
    from dgl_operator_tpu_torch.runtime.kge import KGETrainer

    ds = datasets.fb15k(seed=seed)
    td = TrainDataset(ds.train, ds.n_entities, ds.n_relations, ranks=1)
    tr = KGETrainer(*cs.kge_configs(ds, seed), device="cuda")
    it = cs.kge_stream(td, 0, (seed, seed + 1))
    tail = next(b for b in it if b.neg_mode == "tail")
    hs = tr.host_step([tail])
    arrs = tr.ship(hs)
    ent = hs.ent_route.rebuilt(arrs[:hs.n_ent])
    return dict(kge_entity_ids=ent.serve.cpu(),
                kge_relation_ids=arrs[hs.n_ent].cpu(),
                kge_entities=ds.n_entities, kge_relations=ds.n_relations,
                kge_dim=cs.KGE_DIM)


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
                    feats=trainer.feats.cpu(),
                    h0=trainer.feats[inputs.long()].cpu(),
                    **kge_ids(torch, cs, seed)), out)


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


def padded_requests(torch, n: int, m: int, uniq: int, segments: int,
                    seed: int):
    """``m`` int64 ids into an [n, d] store whose last row is zeros:
    ``uniq - 1`` distinct rows, each named once, split over
    ``segments`` request segments, each segment's tail padded with the
    zero row ``n - 1`` (the layout of the owner exchange's requests)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    real = rng.choice(n - 1, size=uniq - 1, replace=False)
    out = []
    for k, part in enumerate(np.array_split(real, segments)):
        size = m // segments + (k < m % segments)
        out.append(np.concatenate([part, np.full(size - len(part), n - 1)]))
    return torch.from_numpy(np.concatenate(out)).to("cuda")


def gather_cases(torch, root: str, x: dict, dev: dict, randn, seed: int):
    """(name, table, idx) at the ``kernel`` lines' gather shapes, and
    whether ROOT has the KGE modules."""
    feats, inputs = dev["feats"], dev["inputs"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    cases = []
    has_kge = os.path.exists(os.path.join(
        root, "dgl_operator_tpu_torch", "runtime", "kge.py"))
    if has_kge:
        d = x["kge_dim"]
        cases += [
            ("kge_entity", randn(x["kge_entities"], d),
             dev["kge_entity_ids"]),
            ("kge_relation", randn(x["kge_relations"], d),
             dev["kge_relation_ids"])]
    store = torch.cat([randn(158_900, 100), feats.new_zeros(1, 100)])
    flat = torch.cat([randn(317_800, 100), feats.new_zeros(1, 100)])
    cases += [
        ("dist_mp_owner_serve", store,
         padded_requests(torch, store.shape[0], 10_624, 2_362, 2, seed)),
        ("dist_exchange", flat,
         padded_requests(torch, flat.shape[0], 21_248, 6_278, 4, seed)),
        ("serve_feats", feats, torch.randint(
            0, feats.shape[0], (18_304,), device="cuda", generator=gen)),
        ("train_feats", feats.bfloat16(), inputs),
        ("train_feats", feats, inputs),
        ("dist_slot_inputs", feats, inputs[:94_656]),
        ("width37", randn(2048, 37), torch.randint(
            0, 2048, (512,), device="cuda", generator=gen,
            dtype=torch.int32)),
    ]
    return cases, has_kge


def time_root(root: str, path: str, label: str, seed: int, iters: int,
              kernels) -> None:
    import torch

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from dgl_operator_tpu_torch.ops import fanout, gather, scatter
    for mod in (fanout, gather, scatter):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}")
    cs = _chip_smoke()
    card = cs.nvidia_smi_line()
    t0 = time.perf_counter()
    for name in kernels:
        if name != "floor":
            fanout._build.load(f"{name}.cu")
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
    gathers, has_kge = gather_cases(torch, root, x, dev, randn, seed)
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

    if "floor" in kernels:
        emit(kernel="floor", what="torch.cuda._sleep(1)",
             **timed(lambda: torch.cuda._sleep(1)))

    if "gather_rows" in kernels:
        if not has_kge:
            emit(kernel="gather_rows", skipped=["kge_entity", "kge_relation"],
                 why=f"{root} has no dgl_operator_tpu_torch/runtime/kge.py")
        for name, table, idx in gathers:
            got = gather.gather_rows(table, idx)
            want = gather.gather_rows_plain(table, idx)
            cs.check(torch.equal(got, want),
                     f"{label} gather_rows {name}: not bit-equal")
            b_ms, _, uniq, nbytes = cs.gather_bound(idx, table.shape[1],
                                                    table.element_size())
            emit(kernel="gather_rows", shape=name,
                 dtype=str(table.dtype).replace("torch.", ""),
                 idx_dtype=str(idx.dtype).replace("torch.", ""),
                 n=table.shape[0], m=idx.numel(), d=table.shape[1],
                 path=cs.gather_path(table), max_abs_err=0.0,
                 bound_ms=b_ms, unique_rows=uniq, bytes=nbytes,
                 index_select_ms=cs.time_cold_ms(
                     torch, lambda: torch.index_select(table, 0, idx),
                     flush, iters),
                 **timed(lambda: gather.gather_rows(table, idx)))

    if "fanout_agg" in kernels:
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
            cs.check(err <= tol,
                     f"{label} {name}: max abs err {err} > {tol}")
            emit(kernel="fanout_agg", shape=name, max_abs_err=err,
                 **timed(lambda: fanout.fanout_agg(h, nbr, mask, True)))

    if "scatter_add_rows" in kernels:
        scatter_cases = [
            ("train_block1_bwd", g1, nbr1, mask1, caps[1], True),
            ("train_block1_hub", g1, hub_nbr, hub_mask, caps[1], True),
            ("train_block1_none", g1, nbr1, torch.zeros_like(mask1),
             caps[1], True),
            ("train_block0_bwd", g0, dev["nbr0"], dev["mask0"], caps[2],
             True),
            ("train_feats_bwd", g_feats, dev["inputs"].view(-1, 1), None,
             x["n_feats"], False),
        ]
        for name, g, idx, mask, n, mean in scatter_cases:
            kw = {}
            if takes_plan:
                kw["plan"] = scatter.scatter_plan(
                    idx.cpu().numpy(),
                    None if mask is None else mask.cpu().numpy(),
                    n).to("cuda")

            def run():
                return scatter.scatter_add_rows(g, idx, mask, n, mean, **kw)
            got, again = run(), run()
            want = scatter.scatter_add_rows_plain(g, idx, mask, n, mean)
            err, scale = cs.err_of(got, want)
            cs.check(err <= 1e-5 * scale,
                     f"{label} {name}: max abs err {err} > {1e-5 * scale}")
            emit(kernel="scatter_add_rows", shape=name, max_abs_err=err,
                 two_launches_equal=bool(torch.equal(got, again)),
                 **timed(run))


def sass_root(root: str, label: str) -> None:
    """Per kernel of ROOT's ``gather_rows.cu``: global loads and stores
    by width, loads before the first store, and branches."""
    import re

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from dgl_operator_tpu_torch.ops import _build
    if not os.path.abspath(_build.__file__).startswith(root + os.sep):
        raise RuntimeError(f"_build came from {_build.__file__}")
    lib = _build.build("gather_rows.cu").path
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    import subprocess
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    for chunk in text.split("Function : ")[1:]:
        name, _, body = chunk.partition("\n")
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                         body)
        loads = [o for o in ops if o.startswith("LDG")]
        stores = [o for o in ops if o.startswith("STG")]
        first_store = next((i for i, o in enumerate(ops)
                            if o.startswith("STG")), len(ops))
        print(json.dumps(dict(
            label=label, sass=name.strip(), instructions=len(ops),
            loads={o: loads.count(o) for o in sorted(set(loads))},
            stores={o: stores.count(o) for o in sorted(set(stores))},
            loads_before_first_store=sum(
                o.startswith("LDG") for o in ops[:first_store]),
            branches=sum(o.startswith("BRA") for o in ops),
            bulk_copies=sum(o.startswith("UBLKCP") for o in ops))),
            flush=True)


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
    p.add_argument("--kernels", default=",".join(KERNELS),
                   help=f"comma-separated subset of {','.join(KERNELS)}")
    p = sub.add_parser("sass")
    p.add_argument("root")
    p.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.cmd == "sass":
        sass_root(args.root, args.label or args.root)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.cmd == "inputs":
        make_inputs(args.out, args.seed)
    else:
        kernels = args.kernels.split(",")
        unknown = set(kernels) - set(KERNELS)
        if unknown:
            ap.error(f"unknown kernels {sorted(unknown)}")
        time_root(args.root, args.inputs, args.label or args.root,
                  args.seed, args.iters, kernels)
    return 0


if __name__ == "__main__":
    sys.exit(main())
