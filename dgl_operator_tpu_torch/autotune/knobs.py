"""The knob registry — each tunable's type, range, target layer,
default and probe grid — and the tuned-manifest overlay.

The port's own copy of the JAX package's ``autotune/knobs.py``: every
knob it declares, with the same kinds, defaults, choices, bounds, probe
grids and error messages, so a ``tuned.json`` either package writes
validates the same way in both. The configs (``TrainConfig``,
``KGETrainConfig``) and planes delegate their range and choice checks
here (:func:`validate`).

Manifest consumption: ``TPU_OPERATOR_TUNED_MANIFEST`` names a manifest
(:func:`write_manifest`); the trainers call :func:`apply_tuned` on their
config, which overrides only fields still at their dataclass default,
so an explicitly set value always wins over the manifest. The search
that writes manifests is not ported (``ROADMAP.md`` item 7).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

TUNED_MANIFEST_ENV = "TPU_OPERATOR_TUNED_MANIFEST"
MANIFEST_VERSION = 1

# the layers a knob applies to; apply_tuned routes a manifest by them
LAYERS = ("train", "kge", "partition", "slo", "prof", "quality",
          "shard", "serve", "comm")

_CHOICE_MSG = "unknown {label} {value!r} (expected {choices})"
_RANGE_MSG = "{name} must be in [{lo}, {hi}], got {value}"
_GE_MSG = "{name} must be >= {lo}, got {value}"


def _fmt_num(v: float) -> str:
    return f"{v:g}"


@dataclasses.dataclass(frozen=True)
class Knob:
    """One tunable: ``kind`` is ``"choice"`` (value in ``choices``),
    ``"int"`` / ``"float"`` (numeric in ``[lo, hi]``, ``hi=None``
    unbounded), ``"bool"`` or ``"opaque"`` (a structured value such as
    ``shard_rules``, passed through unvalidated and never searched).
    ``probe_values`` is the grid a search samples; ``label`` and
    ``choice_msg`` shape the error message."""

    name: str
    kind: str
    layer: str
    default: Any
    doc: str = ""
    choices: Optional[Tuple] = None
    lo: Optional[float] = None
    hi: Optional[float] = None
    probe_values: Tuple = ()
    label: Optional[str] = None
    choice_msg: str = _CHOICE_MSG

    def validate(self, value: Any) -> Any:
        """Return the value (coerced for numerics) or raise
        ``ValueError``."""
        if self.kind == "opaque":
            return value
        if self.kind in ("choice", "bool"):
            choices = ((True, False) if self.kind == "bool"
                       else tuple(self.choices or ()))
            if value not in choices:
                raise ValueError(self.choice_msg.format(
                    label=self.label or self.name, value=value,
                    choices=" or ".join(repr(c) for c in choices)))
            return value
        v = float(value) if self.kind == "float" else int(value)
        if self.lo is not None and v < self.lo:
            if self.hi is None:
                raise ValueError(_GE_MSG.format(
                    name=self.name, lo=_fmt_num(self.lo), value=v))
            raise ValueError(_RANGE_MSG.format(
                name=self.name, lo=_fmt_num(self.lo),
                hi=_fmt_num(self.hi), value=v))
        if self.hi is not None and v > self.hi:
            raise ValueError(_RANGE_MSG.format(
                name=self.name, lo=_fmt_num(self.lo),
                hi=_fmt_num(self.hi), value=v))
        return v


def _knob(*args, **kwargs) -> Tuple[str, Knob]:
    k = Knob(*args, **kwargs)
    if k.layer not in LAYERS:
        raise ValueError(f"knob {k.name}: unknown layer {k.layer!r}")
    return k.name, k


REGISTRY: Dict[str, Knob] = dict((
    # ---- training-loop layer (runtime/loop.py TrainConfig) ----------
    _knob("sampler", "choice", "train", "host",
          "where neighbor sampling runs",
          choices=("host", "device")),
    _knob("feats_layout", "choice", "train", "replicated",
          "feature storage layout on the dp mesh",
          choices=("replicated", "owner"),
          probe_values=("replicated", "owner")),
    _knob("feat_dtype", "choice", "train", "float32",
          "feature storage dtype: float storage exchanges its own "
          "bytes and upcasts at the gather; int8/uint8 store affine "
          "codes with per-column scale/zero sidecars, dequantized at "
          "the gather (graph/quant.py, runtime/forward.py)",
          choices=("float32", "bfloat16", "int8", "uint8"),
          probe_values=("float32", "bfloat16", "int8")),
    _knob("halo_cache_frac", "float", "train", 0.25,
          "owner layout: fraction of halo rows kept device-resident",
          lo=0.0, hi=1.0, probe_values=(0.0, 0.25, 0.5, 1.0)),
    _knob("num_samplers", "int", "train", 0,
          "host sampler pool width (0 = launcher plumb, else 1)",
          lo=0, probe_values=(1, 2, 4)),
    _knob("prefetch", "int", "train", 2,
          "cross-step staged-batch lookahead depth (0 = inline)",
          lo=0, probe_values=(0, 1, 2, 4)),
    _knob("pipeline_mode", "choice", "train", "fused",
          "owner-layout halo pipeline form (host sampler): 'fused' "
          "enqueues batch t+K's exchange before step t's compute, "
          "into a ring of K receive buffers; 'staged' enqueues batch "
          "t+1's exchange right after step t is dispatched",
          choices=("fused", "staged"),
          probe_values=("fused", "staged")),
    _knob("pipeline_depth", "int", "train", 1,
          "fused pipeline staging depth K: how many exchanged halo "
          "payloads stay in flight ahead of the consuming step "
          "(K=1 matches the staged form's one-batch lookahead)",
          lo=1, probe_values=(1, 2, 4)),
    _knob("steps_per_call", "int", "train", 1,
          "minibatches executed per device dispatch (K-step scan)",
          lo=1, probe_values=(1, 4)),
    _knob("donate", "bool", "train", True,
          "buffer donation in the DistTrainer step",
          probe_values=(True, False)),
    _knob("resume", "choice", "train", "auto",
          "checkpoint-resume policy", choices=("auto", "never"),
          label="resume policy"),
    _knob("cap_policy", "choice", "train", "auto",
          "padding-cap policy", choices=("auto", "worst")),
    _knob("shard_rules", "opaque", "train", None,
          "rule-driven state sharding (only None is ported) — "
          "structured, catalogued but not searched"),
    # ---- KGE layer (runtime/kge.py KGETrainConfig) ------------------
    _knob("neg_sampler", "choice", "kge", "host",
          "where negative entities are drawn",
          choices=("host", "device")),
    _knob("num_client", "int", "kge", 1,
          "logical trainer clients per mesh slot", lo=1,
          probe_values=(1, 2)),
    # ---- partitioner layer (graph/partition.py) ---------------------
    _knob("part_method", "choice", "partition", "multilevel",
          "partition assignment algorithm",
          choices=("multilevel", "flat"),
          choice_msg="unknown {label} {value!r}; expected {choices}",
          probe_values=("multilevel", "flat")),
    _knob("refine_iters", "int", "partition", 4,
          "boundary-refinement passes", lo=0,
          probe_values=(0, 2, 4, 8)),
    _knob("ooc_budget_mb", "int", "partition", 512,
          "out-of-core partitioning working-set budget (MiB): the "
          "chunked edge-ingest / feature-write chunk sizes are derived "
          "from it and coarsening levels spill to disk instead of "
          "staying resident (0 = unbudgeted chunking "
          "defaults)", lo=0, probe_values=(128, 512, 2048)),
    # ---- live SLO targets (obs/slo.py SLOMonitor) -------------------
    _knob("slo_p99_ms", "float", "slo", 250.0,
          "serving SLO: rolling-window p99 request latency ceiling "
          "(ms); breaches flip the micro-batcher to shedding",
          lo=0.0),
    _knob("slo_min_heartbeat_hz", "float", "slo", 0.0,
          "training SLO: minimum heartbeat rate (steps/s); 0 disables "
          "the floor (step cadence is workload-dependent)",
          lo=0.0),
    _knob("slo_window_s", "float", "slo", 10.0,
          "rolling burn-rate window the SLO monitor evaluates over",
          lo=0.1),
    # ---- model-health plane (obs/quality.py QualityMonitor) ---------
    _knob("sentry", "bool", "quality", True,
          "numerics sentry: compute the in-program stats pytree "
          "(grad/param norms, non-finite counts, per-partition loss) "
          "and run the rolling model-health detectors over it; "
          "trajectories are bit-identical either way",
          probe_values=(True, False)),
    _knob("quality_action", "choice", "quality", "rollback",
          "response to a numerics fault: 'warn' keeps training "
          "(events only), 'halt' raises NumericsFault at the step "
          "boundary, 'rollback' additionally quarantines post-fault "
          "checkpoints and marks the workspace so a launcher relaunches "
          "from the last-known-good",
          choices=("halt", "rollback", "warn")),
    _knob("quality_window", "int", "quality", 32,
          "rolling window (steps) of the EWMA divergence and "
          "grad-median detectors", lo=2),
    _knob("quality_z_max", "float", "quality", 6.0,
          "loss-divergence threshold: EWMA z-score above this emits "
          "loss_divergence", lo=0.0),
    _knob("quality_grad_ratio_max", "float", "quality", 50.0,
          "grad-explosion threshold: grad norm above this multiple "
          "of the rolling median emits grad_explosion (0 disables)",
          lo=0.0),
    _knob("quality_plateau_window", "int", "quality", 0,
          "plateau detector window (steps); 0 disables", lo=0),
    _knob("quality_plateau_rel", "float", "quality", 1e-3,
          "plateau threshold: loss range over the window below this "
          "fraction of its magnitude emits loss_plateau", lo=0.0),
    # ---- parameter-sharding layer (parallel/dp.py ZeRO-3 + TP) ------
    _knob("zero_stage", "choice", "shard", 1,
          "parameter-sharding stage of the dense DP step: 1 keeps "
          "params replicated between steps (optimizer state may still "
          "shard via shard_rules); 3 keeps rule-selected params "
          "RESIDENT as 1/N shards and gathers at use inside the step "
          "(parallel/dp.py param_allgather_start/done)",
          choices=(1, 3), probe_values=(1, 3)),
    _knob("tp_axis_size", "int", "shard", 1,
          "model-parallel mesh axis extent for rule-driven tensor "
          "parallelism on dense kernels (1 = no mp axis; >1 trains "
          "on a (dp, mp) mesh and rules may name the mp axis)",
          lo=1, probe_values=(1, 2)),
    _knob("gather_depth", "int", "shard", 2,
          "ZeRO-3 gather pipeline window: how many param all-gathers "
          "may be in flight at once (each gather's done is pinned "
          "behind the gather this many positions earlier)",
          lo=1, probe_values=(1, 2, 4)),
    # ---- replicated serving plane (serve/router.py) ------------------
    _knob("replicas", "int", "serve", 1,
          "serving fleet width: how many ServeEngine replicas the "
          "router fans requests out to (1 = the single-process plane)",
          lo=1, probe_values=(1, 2, 4)),
    _knob("canary_frac", "float", "serve", 0.1,
          "rolling promotion: fraction of routed traffic mirrored to "
          "the canary replica while a candidate checkpoint is staged "
          "(serve/router.py CanaryController)",
          lo=0.0, hi=1.0, probe_values=(0.05, 0.1, 0.25)),
    _knob("serve_aot_shapes", "int", "serve", 1,
          "AOT-warmed request-shape ladder depth: 1 compiles only the "
          "full batch_size shape; each extra rung adds a smaller "
          "padded shape (batch_size >> 2k) so a low-load dispatch "
          "stops paying the pad-to-capacity cost (serve/batcher.py "
          "small-shape fast path)",
          lo=1, hi=4, probe_values=(1, 2)),
    # ---- roofline peaks (the profiler plane, not ported) -------------
    _knob("peak_flops", "float", "prof", 0.0,
          "roofline peak FLOP/s the MFU denominator uses; 0 = "
          "auto-detect from the device", lo=0.0),
    _knob("peak_hbm_gbps", "float", "prof", 0.0,
          "roofline peak HBM GB/s for the memory/comm roofline "
          "fractions; 0 = auto-detect", lo=0.0),
    # ---- link peaks (the communication plane, not ported) -------------
    _knob("peak_ici_gbps", "float", "comm", 0.0,
          "per-device interconnect link peak GB/s the per-collective "
          "bandwidth gauges are scored against; 0 = auto-detect",
          lo=0.0),
    _knob("peak_dcn_gbps", "float", "comm", 0.0,
          "per-host network link peak GB/s for collectives that cross "
          "hosts; 0 = auto-detect", lo=0.0),
))


def get(name: str) -> Knob:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown knob {name!r}; registered: "
                       f"{', '.join(sorted(REGISTRY))}") from None


def validate(name: str, value: Any) -> Any:
    """Validate one value against its registry entry."""
    return get(name).validate(value)


def default_of(name: str) -> Any:
    return get(name).default


def search_space(names) -> Dict[str, Tuple]:
    """name -> probe-candidate tuple; refuses a knob with no probe grid
    (opaque and policy knobs are not searchable)."""
    space: Dict[str, Tuple] = {}
    for name in names:
        k = get(name)
        if not k.probe_values:
            raise ValueError(f"knob {name!r} has no probe grid "
                             "(not searchable)")
        space[name] = tuple(k.probe_values)
    return space


# ------------------------------------------------------ tuned.json --
def write_manifest(path: str, knobs: Dict[str, Any], *,
                   score: Optional[float] = None,
                   baseline_score: Optional[float] = None,
                   search: Optional[Dict] = None) -> Dict:
    """Validate and atomically write a tuned manifest; returns it."""
    man = {
        "version": MANIFEST_VERSION,
        "knobs": {n: validate(n, v) for n, v in sorted(knobs.items())},
        "score": score,
        "baseline_score": baseline_score,
        "search": search or {},
    }
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(man, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return man


def load_manifest(path: str) -> Dict:
    """Read and validate a tuned manifest: every knob registered and in
    range, so a corrupt manifest fails at load."""
    with open(path) as f:
        man = json.load(f)
    if man.get("version") != MANIFEST_VERSION:
        raise ValueError(f"tuned manifest {path}: version "
                         f"{man.get('version')!r} != {MANIFEST_VERSION}")
    kn = man.get("knobs")
    if not isinstance(kn, dict):
        raise ValueError(f"tuned manifest {path}: missing 'knobs' map")
    man["knobs"] = {n: validate(n, v) for n, v in kn.items()}
    return man


def overrides_for(manifest: Dict, layer: str) -> Dict[str, Any]:
    """The manifest's knob overrides of one layer."""
    return {n: v for n, v in manifest.get("knobs", {}).items()
            if get(n).layer == layer}


def apply_tuned(cfg, layer: str = "train",
                manifest_path: Optional[str] = None):
    """Overlay the tuned manifest (``manifest_path`` or
    ``TPU_OPERATOR_TUNED_MANIFEST``) of ``layer`` onto a config
    dataclass: only fields still at their dataclass default are
    replaced, so an explicitly set value always wins. Returns the
    (possibly replaced) config; without a manifest, ``cfg`` itself.
    Applied overrides are counted in ``autotune_overrides_applied_total
    {knob}`` and recorded as an ``autotune_applied`` event."""
    path = manifest_path or os.environ.get(TUNED_MANIFEST_ENV)
    if not path:
        return cfg
    man = load_manifest(path)
    defaults = {f.name: (f.default if f.default is not
                         dataclasses.MISSING else None)
                for f in dataclasses.fields(cfg)}
    applied = {}
    for name, value in overrides_for(man, layer).items():
        if name not in defaults:
            continue
        current = getattr(cfg, name)
        if current == defaults[name] and current != value:
            applied[name] = value
    if not applied:
        return cfg
    from dgl_operator_tpu_torch.obs import get_obs
    obs = get_obs()
    c = obs.metrics.counter(
        "autotune_overrides_applied_total",
        "tuned-manifest knob overrides applied to a config",
        labels=("knob",))
    for name in applied:
        c.inc(knob=name)
    obs.emit("autotune_applied", manifest=path, layer=layer,
             knobs={k: repr(v) for k, v in applied.items()})
    return dataclasses.replace(cfg, **applied)
