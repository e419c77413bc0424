"""Probe runner + obs-artifact scorer for the knob search, and the
probe's entry point.

A probe is a short, seeded, few-step training run of the flagship
partition-parallel protocol (``DistTrainer`` over every slot of a
partition book, one process) under one knob configuration. Each runs in
a subprocess, ``python -m dgl_operator_tpu_torch.autotune.probe
--probe-steps N``, so every probe gets its own obs run and knob
environment that cannot leak between candidates. It runs on the card
unless the spec asks for the CPU; a probe that cannot reach its device
fails and scores ``-inf``.

Scoring reads ONLY the probe run's own ``obs/`` artifacts:

- throughput from the ``train_seeds_per_sec`` gauge in the run's
  ``metrics.json`` (set by the trainers on every heartbeat and in the
  epoch epilogue, ``runtime/loop.py``);
- imbalance from :func:`obs.analyze.skew_summary` over the folded
  PhaseTimer buckets (``phase_seconds_by_worker``) — a config that is
  fast on median but drags a straggling bucket is penalized, because
  the job runs at the straggler's pace. Buckets whose median is zero
  report ``ratio=None`` (the analyze zero-median contract) and are
  SKIPPED, never compared.

The port's copy of the JAX package's ``autotune/probe.py``; the entry
point is the counterpart of that package's probe fast path
(``benchmarks/bench_scale_full.py --probe-steps``), with its
environment, record and last line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Dict, Optional, Sequence

from dgl_operator_tpu_torch.obs._io import read_json
from dgl_operator_tpu_torch.obs.analyze import (DEFAULT_STRAGGLER_RATIO,
                                                phase_seconds_by_worker,
                                                skew_summary)
from dgl_operator_tpu_torch.obs.metrics import METRICS_JSON

_REPO = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
PROBE_MODULE = "dgl_operator_tpu_torch.autotune.probe"
# the variables a parent's run would leak into a probe child
_LEAKING_ENV = ("TPU_OPERATOR_TUNED_MANIFEST", "TPU_OPERATOR_OBS_DIR",
                "TPU_OPERATOR_OBS_RUN", "TPU_OPERATOR_NUM_SAMPLERS")


@dataclasses.dataclass
class ProbeSpec:
    """The fixed (non-searched) shape every probe shares: the
    pre-partitioned workspace, the training protocol, the seed and the
    device — so probe scores differ only by the knobs under test."""

    part_config: str               # partition book (probe graph)
    num_parts: int                 # slots (the book's partitions)
    batch_size: int = 32
    fanouts: Sequence[int] = (3, 3)
    seed: int = 0
    timeout_s: float = 600.0
    device: str = "cuda"


def run_probe(spec: ProbeSpec, knobs: Dict, steps: int,
              out_dir: str) -> Dict:
    """Execute one probe in a subprocess and score it from its obs
    artifacts. Returns ``{"score", "seeds_per_sec", "skew", "steps",
    "record"}``; a failed probe scores ``-inf`` with the error
    attached instead of raising (the search culls it like any other
    bad configuration)."""
    os.makedirs(out_dir, exist_ok=True)
    record = os.path.join(out_dir, "record.json")
    obs_dir = os.path.join(out_dir, "obs")
    env = dict(os.environ)
    for k in _LEAKING_ENV:
        env.pop(k, None)
    env.update(
        PYTHONPATH=os.pathsep.join(
            [_REPO] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p]),
        SCALE_RECORD=record,
        SCALE_PART_CONFIG=spec.part_config,
        SCALE_PARTS=str(spec.num_parts),
        SCALE_PROBE_KNOBS=json.dumps(knobs),
        SCALE_PROBE_BATCH=str(spec.batch_size),
        SCALE_PROBE_FANOUTS=",".join(str(f) for f in spec.fanouts),
        SCALE_PROBE_SEED=str(spec.seed),
        TPU_OPERATOR_OBS_DIR=obs_dir,
    )
    try:
        res = subprocess.run(
            [sys.executable, "-m", PROBE_MODULE, "--probe-steps",
             str(steps), "--device", spec.device],
            capture_output=True, text=True, timeout=spec.timeout_s,
            env=env)
    except subprocess.TimeoutExpired:
        return {"score": float("-inf"), "error": "probe timeout",
                "steps": steps, "record": record}
    if res.returncode != 0:
        return {"score": float("-inf"), "steps": steps,
                "record": record,
                "error": (res.stderr or res.stdout or "")[-400:]}
    out = score_probe(obs_dir, record_path=record)
    out["steps"] = steps
    out["record"] = record
    return out


def score_probe(obs_dir: str, record_path: Optional[str] = None,
                straggler_ratio: float = DEFAULT_STRAGGLER_RATIO
                ) -> Dict:
    """Score a finished probe from its obs artifacts alone.

    ``score = seeds_per_sec * min(1, straggler_ratio / worst_ratio)``
    — pure throughput when the run is balanced, discounted when any
    timing bucket's slowest subject runs past the straggler threshold
    (the skew the job-level analytics would flag). Zero-median
    buckets report ``ratio=None`` and are skipped (the analyze
    zero-median guard).
    """
    procs = read_json(os.path.join(obs_dir, METRICS_JSON),
                      {}).get("procs") or {}
    sps = 0.0
    for snap in procs.values():
        fam = (snap or {}).get("train_seeds_per_sec") or {}
        for s in fam.get("samples", []):
            sps += float(s.get("value", 0.0))
    skew = skew_summary(phase_seconds_by_worker(procs))
    # the zero-median guard: a bucket with median 0 has ratio None —
    # it carries no straggler signal and must never be compared
    ratios = [s["ratio"] for s in skew.values()
              if s.get("ratio") is not None]
    worst = max(ratios) if ratios else 1.0
    penalty = min(1.0, straggler_ratio / worst) if worst > 0 else 1.0
    out = {
        "score": (sps * penalty if sps > 0 else float("-inf")),
        "seeds_per_sec": round(sps, 3),
        "skew_worst_ratio": worst,
        "skew_penalty": round(penalty, 4),
        "skew": skew,
    }
    if record_path:
        rec = read_json(record_path, {})
        if rec.get("hbm_budget"):
            out["hbm_budget"] = rec["hbm_budget"]
        if rec.get("probe"):
            out["probe"] = rec["probe"]
    return out


def make_probe_fn(spec: ProbeSpec, work_dir: str):
    """Bind a spec to the ``probe_fn(knobs, steps, rung)`` shape
    :func:`autotune.search.successive_halving` consumes; each probe
    lands its artifacts under ``work_dir/<rung>/<config-dir>/``."""
    from dgl_operator_tpu_torch.autotune.search import config_key

    def probe_fn(knobs: Dict, steps: int, rung: int) -> Dict:
        safe = config_key(knobs).replace("'", "").replace(",", "_") \
            .replace("=", "-")[:120]
        return run_probe(spec, knobs, steps,
                         os.path.join(work_dir, f"r{rung}", safe))

    return probe_fn


# ---------------------------------------------------------------------
# the probe's entry point (the child run_probe starts)
# ---------------------------------------------------------------------
def _peak_rss_mib() -> float:
    """The process's high-water RSS in MiB (``VmHWM``, which an exec
    resets, so a child does not report its parent's peak)."""
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("VmHWM:"):
                    return round(int(ln.split()[1]) / 1024, 1)
    except OSError:
        pass
    import resource
    return round(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1)


def _emit(rec: dict, path: str) -> None:
    """Write the record atomically, with the process's peak RSS."""
    rec["peak_rss_mib"] = _peak_rss_mib()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def probe_main(steps: int, device: Optional[str] = None) -> dict:
    """A few-step, seeded run of ``DistTrainer`` (``DistSAGE``, hidden
    16, every slot of the book in this process) under ONE knob
    configuration, its throughput recorded by the trainer's own obs
    epilogue (``train_seeds_per_sec`` in the run's ``metrics.json``) —
    the scorer reads those artifacts, never a timer added here.

    Env: ``SCALE_PROBE_KNOBS`` (JSON knob map; train-layer knobs
    only — partition-layer knobs would need a re-partition per
    candidate and are rejected loudly), ``SCALE_PART_CONFIG``
    (pre-partitioned book; a toy graph is synthesized and
    partitioned into ``SCALE_PARTS`` parts when unset),
    ``SCALE_PROBE_BATCH`` / ``SCALE_PROBE_FANOUTS`` /
    ``SCALE_PROBE_SEED`` (the fixed protocol shape),
    ``SCALE_RECORD`` (the record's path) and ``TPU_OPERATOR_OBS_DIR``
    (the probe's obs run). ``device`` None is the card."""
    import math
    import shutil
    import tempfile

    from dgl_operator_tpu_torch.autotune import knobs as AK
    from dgl_operator_tpu_torch.obs import OBS_DIR_ENV, obs_run

    t0 = time.time()
    record = os.path.abspath(os.environ.get("SCALE_RECORD")
                             or "probe_record.json")
    knobs = json.loads(os.environ.get("SCALE_PROBE_KNOBS", "{}"))
    for name, value in knobs.items():
        if AK.get(name).layer != "train":
            raise ValueError(
                f"probe fast path tunes train-layer knobs only; "
                f"{name!r} targets {AK.get(name).layer!r} (probe "
                "against a workspace partitioned with that knob "
                "instead)")
        knobs[name] = AK.validate(name, value)
    batch = int(os.environ.get("SCALE_PROBE_BATCH", "32"))
    fanouts = tuple(int(f) for f in os.environ.get(
        "SCALE_PROBE_FANOUTS", "3,3").split(","))
    seed = int(os.environ.get("SCALE_PROBE_SEED", "0"))

    rec: dict = {"what": "autotune knob probe", "ok": False,
                 "knobs": knobs, "requested_steps": steps}
    part_cfg = os.environ.get("SCALE_PART_CONFIG")
    if part_cfg:
        with open(part_cfg) as f:
            num_parts = int(json.load(f)["num_parts"])
    else:
        num_parts = int(os.environ.get("SCALE_PARTS", "2"))
    obs_dir = os.environ.get(OBS_DIR_ENV) or os.path.join(
        os.path.dirname(record), "obs")

    import torch

    from dgl_operator_tpu_torch._device import resolve_device
    from dgl_operator_tpu_torch.graph import datasets
    from dgl_operator_tpu_torch.graph import partition as P
    from dgl_operator_tpu_torch.models.sage import DistSAGE
    from dgl_operator_tpu_torch.obs.prof import get_profiler
    from dgl_operator_tpu_torch.ops import fanout, gather, scatter
    from dgl_operator_tpu_torch.runtime.dist import DistTrainer
    from dgl_operator_tpu_torch.runtime.loop import TrainConfig

    dev = resolve_device(device)
    tmp_parts = None
    if not part_cfg:
        tmp_parts = tempfile.mkdtemp(prefix="probe_parts_")
        ds = datasets.synthetic_node_clf(600, 3000, 16, 8, seed=7)
        part_cfg = P.partition_graph(ds.graph, "probe", num_parts,
                                     tmp_parts)
    rec["part_config"] = part_cfg
    rec["num_parts"] = num_parts
    try:
        with obs_run(obs_dir, role="probe"):
            cfg = TrainConfig(num_epochs=1, batch_size=batch,
                              fanouts=fanouts, seed=seed,
                              eval_every=0, log_every=10**9,
                              resume="never", **knobs)
            # classes from the loaded partitions (probe graphs are
            # synthetic; the model head must cover every label)
            parts = [P.GraphPartition(part_cfg, p)
                     for p in range(num_parts)]
            n_classes = int(max(int(p.graph.ndata["label"].max())
                                for p in parts)) + 1
            feat_dim = int(parts[0].graph.ndata["feat"].shape[1])
            del parts
            model = DistSAGE(feat_dim, 16, n_classes, dropout=0.0,
                             device=dev, generator=torch.Generator()
                             .manual_seed(seed))
            tr = DistTrainer(model, part_cfg, cfg, device=dev)
            # hit the requested step budget by sizing epochs to the
            # partition's steps/epoch (throughput normalizes anyway)
            spe = tr.steps_per_epoch
            tr.cfg = dataclasses.replace(tr.cfg, num_epochs=max(
                1, math.ceil(steps / spe)))
            out = tr.train()
            itemsize = int(tr.feats.element_size())
            D = int(tr.feats.shape[-1])
            if tr._owner_layout:
                feats_slot = (tr.c_pad + tr.cache_rows) * D * itemsize
            else:
                feats_slot = tr.n_pad * D * itemsize
            rec["hbm_budget"] = {
                "feats_slot_mib": round(feats_slot / 2**20, 3),
                "exchange_mib_per_step": round(
                    tr.exchange_bytes_per_step / 2**20, 3),
            }
            rec["probe"] = {
                "steps": out["step"],
                "epochs": tr.cfg.num_epochs,
                "steps_per_epoch": spe,
                "final_loss": round(
                    float(out["history"][-1]["loss"]), 4),
            }
            # hardware-utilization rider (obs/prof.py): the probe's
            # rolling MFU, for autotune debugging — the scorer itself
            # still reads only the obs artifacts
            if get_profiler().last:
                rec["probe"]["mfu"] = get_profiler().last.get("mfu")
            # the port's kernels this probe launched (0 on the CPU,
            # where each wrapper runs its plain version)
            rec["probe"]["launches"] = {
                w.__name__: int(w.launches) for w in (
                    fanout.fanout_agg, gather.gather_rows,
                    scatter.scatter_add_rows)}
            rec["device"] = str(dev)
            rec["ok"] = True
    finally:
        if tmp_parts:
            shutil.rmtree(tmp_parts, ignore_errors=True)
    rec["total_s"] = round(time.time() - t0, 2)
    _emit(rec, record)
    print(json.dumps({"metric": "autotune_probe_steps",
                      "value": rec.get("probe", {}).get("steps", 0),
                      "ok": rec["ok"],
                      "record": os.path.relpath(record, _REPO)}))
    return rec


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        prog="probe", description="One autotune knob probe (the "
        "configuration comes from SCALE_PROBE_KNOBS)")
    ap.add_argument("--probe-steps", type=int, required=True)
    ap.add_argument("--device", default=None,
                    help="cuda (the default: the current card) or cpu")
    args = ap.parse_args(argv)
    probe_main(args.probe_steps, args.device)


if __name__ == "__main__":
    main()
