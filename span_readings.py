"""Run one cell of ``portbench`` with the program's spans and phase
counters read, as its readers will read them once ``closed_train``
fills their keys.

    python3 span_readings.py --workload sage_products.dev_k4 \
        --seed 2147483701 --seconds 20 [--chrome trace.json]

The readers ``portbench/metrics/{permute_ms,stage_ms,loss_fetch_ms,
obs_us_per_call,sampler_us_per_step,model_us_per_step,
update_us_per_step,sentry_us_per_step,idle_unspanned_pct}.py`` read
keys that ``portbench/drivers/closed_train.py`` does not fill yet
(``portbench/spans.py``). This script turns the program's trace switch
on (``TPU_OPERATOR_TRACE=1``), fills the keys by wrapping ``closed_train``'s
window and the trace's summary at run time, and runs the cell as
``portbench/run.py --trace 1`` does, with the nine readers on its result
line. It goes once ``closed_train`` fills the keys itself.

Its last line of standard output is one JSON object: each epoch
boundary's program spans against the harness's time for it, the idle
gaps of 1 ms or more by span, the program's ranges in the profiler's
trace, the phases against the traced busy µs a step, and the bytes of
the aggregates. Needs a CUDA card.
"""

import json
import os
import runpy
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
READERS = ("permute_ms", "stage_ms", "loss_fetch_ms", "obs_us_per_call",
           "sampler_us_per_step", "model_us_per_step", "update_us_per_step",
           "sentry_us_per_step", "idle_unspanned_pct")
# the spans that run between two calls, none inside another
BOUNDARY = ("loop.loss_fetch", "loop.ckpt", "loop.sentry", "loop.heartbeat",
            "devrun.phases", "epoch.drain", "epoch.losses", "epoch.eval",
            "epoch.record", "epoch.ckpt", "epoch.permute", "devrun.stage")


def install(got):
    """Wrap ``closed_train``'s window, its run and the trace's summary."""
    from portbench import devtrace, spans, spec
    from portbench.drivers import closed_train as ct

    from dgl_operator_tpu_torch.obs import trace

    W, snap = ct.Window, trace.snapshot
    open_, close, timed, profiled = (W._open, W._close, W._timed,
                                     W._profiled)
    run, summarize, cell_metrics = ct.run, devtrace.summarize, \
        spec.cell_metrics
    got["boundaries"] = []

    def _open(self):
        open_(self)
        got["open"] = snap()

    def _close(self):
        close(self)
        got["close"] = snap()

    def _timed(self, batch, now, step):
        if step % self.spe == 0 and "exit" in got:
            gap = trace.window(got.pop("exit"), snap())["spans"]
            got["boundaries"].append({
                "epoch_end_ms": (now - self._t_exit) * 1e3,
                "spanned_ms": sum(gap[n]["seconds"] for n in BOUNDARY
                                  if n in gap) * 1e3,
                "spans_ms": {n: s["seconds"] * 1e3 for n, s in gap.items()}})
        out = timed(self, batch, now, step)
        if "open" in got and (step + batch[2]) % self.spe == 0:
            got["exit"] = snap()
        return out

    def _profiled(self, batch):
        try:
            return profiled(self, batch)
        except ct.WindowClosed:
            if got.get("chrome"):
                self.profiler.export_chrome_trace(got["chrome"])
            raise

    def run_filled(*a, **kw):
        rec = run(*a, **kw)
        if "close" in got:
            win = trace.window(got["open"], got["close"])
            rec["ctx"]["program_spans"] = win["spans"]
            rec["ctx"]["program_phases"] = win["phases"]
        return rec

    def summarize_more(events):
        from torch.autograd import DeviceType

        events = list(events)
        out = summarize(events)
        out["idle_by_span"] = spans.idle_by_span(events)
        got["long_gaps"] = spans.long_gaps(events)
        got["ranges"] = ranges = {}
        for e in events:
            if e.device_type == DeviceType.CPU \
                    and spans.is_program_span(e.name):
                c = ranges.setdefault(e.name, [0, 0.0])
                c[0] += 1
                c[1] += (e.time_range.end - e.time_range.start) * 1e-3
        got["trace"] = out
        return out

    W._open, W._close, W._timed, W._profiled = (_open, _close, _timed,
                                                _profiled)
    ct.run, devtrace.summarize = run_filled, summarize_more
    spec.cell_metrics = lambda cell, tr, path=None: (
        cell_metrics(cell, tr, path) + (list(READERS) if tr else []))


def extras(got):
    """What the result line leaves out (see the module's docstring)."""
    from dgl_operator_tpu_torch.obs import trace

    ph = trace.window(got["open"], got["close"])["phases"]
    tr = got.get("trace") or {}
    out = {"boundaries": got["boundaries"],
           "idle_by_span": tr.get("idle_by_span"),
           "long_gaps": got.get("long_gaps"), "ranges": got.get("ranges"),
           "phases": ph, "aggregate_bytes": sys.getsizeof(trace._spans)
           + sum(sys.getsizeof(n) + sys.getsizeof(a)
                 + sum(sys.getsizeof(x) for x in a)
                 for n, a in trace._spans.items())}
    if tr.get("steps") and ph["steps"]:
        out["busy_us_per_step"] = tr["busy_s"] * 1e6 / tr["steps"]
        out["phases_us_per_step"] = sum(ph["us"].values()) / ph["steps"]
    return out


def main(argv):
    os.environ["TPU_OPERATOR_TRACE"] = "1"
    got = {}
    if "--chrome" in argv:
        i = argv.index("--chrome")
        got["chrome"] = argv[i + 1]
        del argv[i:i + 2]
    # portbench/run.py's environment and import path, without its main
    runpy.run_path(os.path.join(ROOT, "portbench", "run.py"),
                   run_name="portbench_env")
    from portbench import harness

    install(got)
    rc = harness.main(argv + ["--trace", "1"], harness.process_start())
    if rc != 0 or "close" not in got:
        return rc or 1
    print(json.dumps(extras(got)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
