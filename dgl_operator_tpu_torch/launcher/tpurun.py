"""``tpurun`` — the phase-gated workflow driver (dglrun equivalent).

Reference: ``python/dglrun/exec/dglrun:119-239`` — a bash driver that
switches on ``DGL_OPERATOR_PHASE_ENV``:

- ``Launcher_Workload`` → 1 phase: run the train entrypoint locally
  (the ``partitionMode: Skip`` path, examples/v1alpha1/GraphSAGE.yaml);
- ``Partitioner`` → phases 1-2: partition the graph, deliver partitions
  to the launcher;
- otherwise (Launcher) → phases 3-5: dispatch partitions to workers,
  revise the hostfile per framework, launch distributed training.

Same phase structure and flag surface here (flags: dglrun:7-104),
driven from Python with per-phase wall-clock timing (dglrun prints
"Phase : N seconds" / "Total : N seconds"; we keep that shape so log
scrapers carry over). Phase env: ``TPU_OPERATOR_PHASE_ENV``.

Entry points invoked per phase are user scripts exactly as in the
reference (``--partition-entry-point``, ``--train-entry-point``), so the
driver is model-agnostic.

The port's copy of the JAX package's ``launcher/tpurun.py``, torch-free,
with its flags, environment variables, ledger format and exit codes, so
the operator's pods start either package's driver unchanged; its phases
start the port's entry points (by path, as the JAX driver does), and its
serve phase the port's ``serve.server``. What waits:

- ``--elastic`` and ``--placement`` raise ``NotImplementedError``: the
  elastic control plane (``launcher/elastic.py``) and the placement it
  reads (``autotune/placement.py``) are ``ROADMAP.md`` Queue 1 item 7c.
- The obs file plane is item 7b: the JAX driver's ``obs_run`` (one
  telemetry directory a run, exported to every process) and
  ``collect_obs`` (the merged job view) have no counterpart. The driver
  records its phases, retries and faults in the in-memory ``Obs``
  (``obs/__init__.py``) and prints the reference's console lines.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shlex
import subprocess
import sys
import time
from typing import Callable, List, Optional

from dgl_operator_tpu_torch.launcher.fabric import get_fabric
from dgl_operator_tpu_torch.launcher.dispatch import dispatch_partitions
from dgl_operator_tpu_torch.launcher import console
from dgl_operator_tpu_torch.launcher.launch import (launch_train,
                                                    run_copy_batch,
                                                    run_exec_batch)
from dgl_operator_tpu_torch.obs import get_obs, tracectx
from dgl_operator_tpu_torch.parallel.bootstrap import PHASE_ENV

DEFAULT_WORKSPACE = "/tpu_workspace"
DEFAULT_CONF_DIR = "/etc/tpugraph"   # /etc/dgl equivalent
LEDGER_NAME = ".tpurun_state.json"
NO_RESUME_ENV = "TPU_OPERATOR_NO_RESUME"


class PhaseLedger:
    """Per-workspace record of completed workflow phases, so a
    relaunched driver (preempted launcher pod, Failed-job requeue)
    skips partition/deliver/dispatch work that already landed instead
    of re-running the whole workflow from phase 1.

    The ledger is keyed by a *signature* of the job-defining arguments
    (graph name, partition count, entry points, workspace): a relaunch
    with different arguments is a different job and starts fresh.
    Writes are atomic (tmp + rename) — a driver preempted mid-write
    leaves the previous consistent ledger, never a truncated one."""

    def __init__(self, workspace: str, signature: str,
                 enabled: bool = True):
        self.path = os.path.join(workspace, LEDGER_NAME)
        self.signature = signature
        self.enabled = enabled
        self._phases = {}
        if not enabled:
            return
        try:
            with open(self.path) as f:
                data = json.load(f)
            if data.get("signature") == signature:
                self._phases = data.get("phases", {})
        except (OSError, ValueError):
            self._phases = {}

    @staticmethod
    def signature_of(args: argparse.Namespace, phase: str) -> str:
        ident = {k: getattr(args, k, None) for k in
                 ("graph_name", "num_partitions", "partition_entry_point",
                  "train_entry_point", "workspace", "conf_dir",
                  "num_epochs", "batch_size", "train_args",
                  "partition_args", "serve_entry_point", "serve_args",
                  # a different tuned manifest or a re-derived
                  # partition→host placement is a DIFFERENT job; the
                  # JAX driver's placement and elastic epoch set the
                  # last two (None here: item 7c), kept so both
                  # drivers sign a job alike
                  "tuned_manifest", "placement_sig", "elastic_sig")}
        ident["mode"] = phase or "Launcher"
        return hashlib.sha1(
            json.dumps(ident, sort_keys=True).encode()).hexdigest()[:16]

    def done(self, n: int) -> bool:
        return self.enabled and str(n) in self._phases

    def mark(self, n: int, title: str, seconds: float) -> None:
        if not self.enabled:
            return
        self._phases[str(n)] = {"title": title,
                                "seconds": round(seconds, 3)}
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"signature": self.signature,
                           "phases": self._phases}, f, indent=2,
                          sort_keys=True)
            os.replace(tmp, self.path)
        except OSError as exc:
            # an unwritable workspace must not fail the job — it only
            # costs the relaunch its skip
            console.log(f"tpurun: ledger write failed ({exc}); "
                        "relaunch will re-run completed phases",
                        event="ledger_write_failed", error=str(exc))


class _PhaseClock:
    """Prints the reference's per-phase timing block (dglrun:149-154),
    each line also a ``phase_*`` event (``launcher/console.py``)."""

    def __init__(self, total_phases: int):
        self.t0 = time.time()
        self.total = total_phases

    def start(self, n: int, title: str) -> float:
        console.log(f"Phase {n}/{self.total}: {title}", event="phase_start",
                    phase=n, total=self.total, title=title)
        console.line("-" * 10)
        return time.time()

    def finish(self, n: int, t_start: float) -> None:
        now = time.time()
        console.line("-" * 10)
        console.log(f"Phase {n}/{self.total} finished",
                    event="phase_finish", phase=n,
                    seconds=round(now - t_start, 3),
                    total_seconds=round(now - self.t0, 3))
        console.line(f"Phase : {now - t_start:.1f} seconds")
        console.line(f"Total : {now - self.t0:.1f} seconds")
        console.line("-" * 10)

    def fail(self, n: int) -> "SystemExit":
        console.line("-" * 10)
        console.log(f"Phase {n}/{self.total} error raised",
                    event="phase_error", phase=n)
        return SystemExit(1)

    def skip(self, n: int, title: str) -> None:
        console.log(f"Phase {n}/{self.total}: {title}", event="phase_start",
                    phase=n, total=self.total, title=title, skipped=True)
        console.log(f"Phase {n}/{self.total} already complete — skipped "
                    "(ledger)", event="phase_skip", phase=n, title=title)
        console.line("-" * 10)


def _phase(clock: _PhaseClock, ledger: Optional[PhaseLedger], n: int,
           title: str, fn: Callable[[], None]) -> None:
    """Run one workflow phase under the clock and a trace span,
    skipping it when the ledger says a previous driver already
    completed it, and marking it complete on success."""
    obs = get_obs()
    phases = obs.metrics.counter(
        "tpurun_phases_total", "workflow phases by outcome",
        labels=("phase", "status"))
    if ledger is not None and ledger.done(n):
        clock.skip(n, title)
        phases.inc(phase=n, status="skipped")
        return
    t = clock.start(n, title)
    try:
        # export_env: subprocesses the phase spawns (entry points,
        # trainers over the fabric) inherit TPU_OPERATOR_TRACE_* and
        # root their spans under this phase — the driver→worker leg of
        # the cross-process trace (obs/tracectx.py)
        with tracectx.span(f"phase {n}: {title}", cat="tpurun",
                           export_env=True, phase=n):
            fn()
    except Exception:
        phases.inc(phase=n, status="error")
        raise clock.fail(n)
    clock.finish(n, t)
    phases.inc(phase=n, status="ok")
    obs.metrics.histogram(
        "tpurun_phase_seconds", "workflow phase wall-clock",
        labels=("phase",)).observe(time.time() - t, phase=n)
    if ledger is not None:
        ledger.mark(n, title, time.time() - t)


def _run(cmd: List[str]) -> None:
    # bounded by the same policy as every fabric verb (a phase
    # entrypoint that runs TPU_OPERATOR_EXEC_TIMEOUT_S without
    # finishing is hung, not slow; 0 disables)
    from dgl_operator_tpu_torch.launcher.fabric import env_exec_timeout
    res = subprocess.run(cmd, timeout=env_exec_timeout())
    if res.returncode != 0:
        raise subprocess.CalledProcessError(res.returncode, cmd)


def _load_tuned(args: argparse.Namespace) -> Optional[dict]:
    """Load + registry-validate ``--tuned-manifest`` and export it to
    every child process (``TPU_OPERATOR_TUNED_MANIFEST`` — the env
    both trainers' ``apply_tuned`` reads). A malformed manifest fails
    HERE, at the driver, not deep inside a trainer. Returns the
    manifest (None when the flag is absent)."""
    if not args.tuned_manifest:
        return None
    from dgl_operator_tpu_torch.autotune import knobs as AK
    man = AK.load_manifest(args.tuned_manifest)
    os.environ[AK.TUNED_MANIFEST_ENV] = os.path.abspath(
        args.tuned_manifest)
    obs = get_obs()
    obs.metrics.counter(
        "autotune_manifest_loaded_total",
        "tuned manifests validated and exported by the driver").inc()
    obs.emit("tuned_manifest_loaded",
             manifest=os.path.abspath(args.tuned_manifest),
             knobs={k: repr(v)
                    for k, v in man.get("knobs", {}).items()},
             score=man.get("score"),
             baseline_score=man.get("baseline_score"))
    return man


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tpurun",
        description="Phase-gated distributed graph-training workflow "
                    "driver (dglrun equivalent)")
    ap.add_argument("-g", "--graph-name", dest="graph_name")
    # load and partition
    ap.add_argument("--num-partitions", type=int, default=1)
    ap.add_argument("--partition-entry-point")
    ap.add_argument("--balance-train", action="store_true")
    ap.add_argument("--balance-edges", action="store_true")
    ap.add_argument("--dataset-url", default="")
    # dispatch and launch
    ap.add_argument("--launch-entry-point", default=None,
                    help="override the builtin launch module")
    # train
    ap.add_argument("--train-entry-point")
    ap.add_argument("--workspace", "--worksapce", dest="workspace",
                    default=DEFAULT_WORKSPACE)   # dglrun's flag has the typo
    ap.add_argument("--num-epochs", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=1000)
    ap.add_argument("--partition-config-path", default=None)
    ap.add_argument("--num-servers", type=int, default=1)
    ap.add_argument("--num-workers", type=int, default=1,
                    help="accepted for dglrun CLI parity; the train "
                         "entrypoint's --num_workers is driven by "
                         "--num-samplers")
    ap.add_argument("--num-trainers", type=int, default=1)
    ap.add_argument("--num-samplers", type=int, default=0)
    ap.add_argument("--conf-dir", default=DEFAULT_CONF_DIR,
                    help="where the operator rendered hostfile/partfile/"
                         "leadfile (default /etc/tpugraph)")
    ap.add_argument("--fabric", default=None)
    ap.add_argument("--train-args", default="",
                    help="extra args appended to the train entrypoint")
    # serving phase (TPU_OPERATOR_PHASE_ENV=Launcher_Serve, alias
    # Serve): materialize an inference service over an already-
    # partitioned workspace + serving export (docs/serving.md)
    ap.add_argument("--serve-entry-point", default=None,
                    help="serving entrypoint script (default: the "
                         "builtin tpu-serve server, "
                         "dgl_operator_tpu_torch.serve.server)")
    ap.add_argument("--serve-args", default="",
                    help="args for the serve entrypoint (e.g. "
                         "'--part-config ... --params ... --port 8378')")
    ap.add_argument("--partition-args", default="",
                    help="extra args appended to the partition "
                         "entrypoint (e.g. '--community_hint label' or "
                         "'--part_method multilevel|flat' to pick the "
                         "partition algorithm)")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore the workspace phase ledger and re-run "
                         "every phase (also: TPU_OPERATOR_NO_RESUME=1)")
    # telemetry-driven auto-tuning (docs/autotune.md)
    ap.add_argument("--tuned-manifest", default=None,
                    help="tuned.json emitted by the autotune search "
                         "(the autotune search): validated "
                         "against the knob registry, exported as "
                         "TPU_OPERATOR_TUNED_MANIFEST so trainers "
                         "override their default-valued knobs, and "
                         "partition-layer knobs are appended to the "
                         "partition entrypoint")
    ap.add_argument("--placement", default=None,
                    help="skew-aware partition→host placement: not "
                         "ported (ROADMAP.md Queue 1 item 7c)")
    ap.add_argument("--elastic", action="store_true",
                    help="elastic shrink/regrow: not ported "
                         "(ROADMAP.md Queue 1 item 7c)")
    ap.add_argument("--elastic-max-shrinks", type=int, default=2,
                    help="bound on shrink edges within one driver run "
                         "(with --elastic)")
    # model-health rollback (docs/observability.md "Model health")
    ap.add_argument("--numerics-retries", type=int, default=1,
                    help="bound on numerics-fault rollback relaunches "
                         "within one driver run: when a trainer's "
                         "sentry halts on non-finite state "
                         "(obs/quality.py) it quarantines post-fault "
                         "checkpoints and leaves a workspace marker; "
                         "the driver relaunches phase 5 that many "
                         "times so training resumes from the "
                         "last-known-good instead of failing (0 "
                         "disables the retry)")
    return ap


def check_unported(args: argparse.Namespace) -> None:
    """Refuse the flags whose machinery is not ported, rather than take
    and ignore them."""
    if getattr(args, "elastic", False) or getattr(args, "placement", None):
        flag = "--elastic" if getattr(args, "elastic", False) \
            else "--placement"
        raise NotImplementedError(
            f"{flag}: the elastic control plane and the partition "
            "placement are not ported (ROADMAP.md Queue 1 item 7c)")


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    check_unported(args)
    ws = args.workspace
    get_obs().emit("tpurun_start", phase_env=os.environ.get(PHASE_ENV),
                   graph=args.graph_name,
                   num_partitions=args.num_partitions, workspace=ws)
    # the run's trace root: every phase span (and through the exported
    # environment, every worker process's spans) hangs under it
    with tracectx.span("tpurun", cat="tpurun", export_env=True,
                       graph=args.graph_name):
        _workflow(args, ws)


def _workflow(args: argparse.Namespace, ws: str) -> None:
    hostfile = os.path.join(args.conf_dir, "hostfile")
    leadfile = os.path.join(args.conf_dir, "leadfile")
    part_cfg = (args.partition_config_path
                or os.path.join(ws, "dataset", f"{args.graph_name}.json"))
    worker_part_cfg = os.path.join(ws, "workload", f"{args.graph_name}.json")
    # the workspace root is cross-process state (chaos dead-host
    # markers, fault markers): the driver's OWN fabric needs it in
    # env, not just the trainers launch_train exports it to
    os.environ["TPU_OPERATOR_WORKSPACE"] = os.path.abspath(ws)
    fabric = get_fabric(args.fabric)
    phase = os.environ.get(PHASE_ENV)
    py = sys.executable
    resume = not (args.fresh or os.environ.get(NO_RESUME_ENV))
    manifest = _load_tuned(args)
    ledger = PhaseLedger(ws, PhaseLedger.signature_of(args, phase),
                         enabled=resume)

    if phase == "Launcher_Workload":
        # ---- Skip mode: single phase, local training (dglrun:119-131)
        clock = _PhaseClock(1)
        _phase(clock, ledger, 1, "launch the training",
               lambda: _run([py, args.train_entry_point]
                            + shlex.split(args.train_args)))

    elif phase in ("Launcher_Serve", "Serve"):
        # ---- serve mode: single phase, materialize the inference
        # service (serve/server.py) over an already-partitioned
        # workspace + serving export — the operator's serving job
        # shape (no partition/dispatch phases: serving consumes what
        # the training workflow already staged)
        clock = _PhaseClock(1)
        serve_cmd = ([py, args.serve_entry_point]
                     if args.serve_entry_point
                     else [py, "-m", "dgl_operator_tpu_torch.serve.server"])
        # ledger=None: a serving process that exited must RESTART on
        # relaunch, never be skipped as a "completed" phase
        _phase(clock, None, 1, "launch the serving plane",
               lambda: _run(serve_cmd + shlex.split(args.serve_args)))

    elif phase == "Partitioner":
        clock = _PhaseClock(5)

        # ---- Phase 1/5: load and partition (dglrun:133-147)
        def partition():
            cmd = [py, args.partition_entry_point,
                   "--graph_name", args.graph_name,
                   "--workspace", ws,
                   "--rel_data_path", "dataset",
                   "--num_parts", str(args.num_partitions)]
            if args.dataset_url:
                cmd += ["--dataset_url", args.dataset_url]
            if args.balance_train:
                cmd += ["--balance_train"]
            if args.balance_edges:
                cmd += ["--balance_edges"]
            if manifest is not None:
                # tuned partitioner knobs (part_method/refine_iters)
                # ride ahead of --partition-args, so an explicit user
                # flag still wins (argparse last-wins)
                from dgl_operator_tpu_torch.autotune import knobs as AK
                for k, v in sorted(AK.overrides_for(
                        manifest, "partition").items()):
                    cmd += [f"--{k}", str(v)]
            cmd += shlex.split(args.partition_args)
            _run(cmd)

        _phase(clock, ledger, 1, "load and partition graph", partition)

        # ---- Phase 2/5: deliver partitions to the launcher (dglrun:156-168)
        _phase(clock, ledger, 2, "deliver partitions",
               lambda: run_copy_batch(
                   leadfile, [os.path.join(ws, "dataset")], ws,
                   fabric, container="watcher-partitioner"))

    else:
        clock = _PhaseClock(5)
        numerics_retries = 0
        while True:
            try:
                _launcher_phases(args, ws, clock, ledger, hostfile,
                                 worker_part_cfg, part_cfg, fabric, py)
                break
            except (Exception, SystemExit):
                if numerics_retries < getattr(args, "numerics_retries",
                                              0) \
                        and _numerics_rollback(ws):
                    # model-health rollback (obs/quality.py): the
                    # sentry halted a trainer on non-finite state and
                    # already quarantined the post-fault checkpoints —
                    # a relaunch of phase 5 (ledger-unchanged: 3-4
                    # skip, 5 never marked) resumes from the
                    # last-known-good
                    numerics_retries += 1
                    clock = _PhaseClock(5)
                    continue
                raise


def _numerics_rollback(ws: str) -> bool:
    """Classify a launcher-phase failure for the model-health plane:
    True when a trainer's numerics sentry left the workspace fault
    marker (obs/quality.py) — the bad checkpoints are already
    quarantined, so a relaunch resumes from the last-known-good.
    Consumes the marker (one marker = one retry)."""
    from dgl_operator_tpu_torch.obs import quality
    rec = quality.take_fault_marker(ws)
    if rec is None:
        return False
    obs = get_obs()
    obs.metrics.counter(
        "tpurun_numerics_rollbacks_total",
        "launcher relaunches after a numerics-fault halt").inc()
    console.log(
        f"numerics fault at step {rec.get('step')}"
        + (f" (partition {rec.get('partition')})"
           if rec.get("partition") is not None else "")
        + f": {rec.get('kind')} — post-fault checkpoints quarantined; "
        "relaunching from the last-known-good checkpoint",
        event="numerics_rollback", step=rec.get("step"),
        partition=rec.get("partition"), kind=rec.get("kind"))
    return True


def _launcher_phases(args: argparse.Namespace, ws: str,
                     clock: _PhaseClock, ledger: Optional[PhaseLedger],
                     hostfile: str, worker_part_cfg: str, part_cfg: str,
                     fabric, py: str) -> None:
    """Phases 3-5 of the Launcher mode (dispatch / revise / train),
    split out so the failure path can collect the job view."""
    # ---- Phase 3/5: dispatch partitions (dglrun:178-186)
    _phase(clock, ledger, 3, "dispatch partitions",
           lambda: dispatch_partitions(ws, "workload", part_cfg,
                                       hostfile, fabric))

    # ---- Phase 4/5: batch revise hostfile (dglrun:188-207)
    revise_cmd = (
        f"{shlex.quote(py)} -m dgl_operator_tpu_torch.launcher.revise "
        f"--workspace {shlex.quote(ws)} "
        f"--ip_config {shlex.quote(hostfile)} --framework JAX")
    _phase(clock, ledger, 4, "batch revise hostfile",
           lambda: run_exec_batch(hostfile, revise_cmd, fabric))

    # ---- Phase 5/5: launch the training (dglrun:209-230)
    def train():
        train_cmd = (
            f"{shlex.quote(py)} {shlex.quote(args.train_entry_point)}"
            f" --graph_name {shlex.quote(args.graph_name)}"
            f" --ip_config "
            f"{shlex.quote(os.path.join(ws, 'hostfile_revised'))}"
            f" --part_config {shlex.quote(worker_part_cfg)}"
            f" --num_epochs {args.num_epochs}"
            f" --batch_size {args.batch_size}"
            f" --num_workers {args.num_samplers}")
        if args.train_args:
            train_cmd += f" {args.train_args}"
        launch_train(hostfile, train_cmd, args.num_partitions,
                     worker_part_cfg, ws,
                     num_trainers=args.num_trainers,
                     num_samplers=args.num_samplers,
                     num_servers=args.num_servers, fabric=fabric)

    _phase(clock, ledger, 5, "launch the training", train)


if __name__ == "__main__":
    main()
