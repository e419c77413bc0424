"""Pinned key sets of the benchmark records and telemetry summaries, the
port's copy of the JAX package's ``benchkeys.py`` with every value
unchanged. A summary asserts that it returns exactly these keys, so a
reader of either package's records finds the same fields; lint rule
TPU006 (``analysis/rules.py``) flags any other module that re-defines
one of the record tuples as a literal, so a drifted copy cannot land.

Standard library only and import-light: a harness may import it
before torch.

Renaming a key here is an interface change: every harness and reader
of the records consumes these names.
"""

# scale-record keys: the memory-scaling evidence of a dist run (owner
# layout footprint and exchange cost, replicated against sharded
# parameter and optimizer bytes, the ZeRO-3 residency and its ratio,
# the feature store's bytes by storage dtype, the quantized exchange
# and the out-of-core partitioner's peak RSS against in-memory)
SCALE_FULL_KEYS = ("halo_exchange_mib_per_step", "feats_slot_owner_mib",
                   "feats_slot_replicated_mib",
                   "exchange_staging_mib_per_slot",
                   "params_mib_per_slot_replicated",
                   "params_mib_per_slot_sharded",
                   "opt_state_mib_per_slot_replicated",
                   "opt_state_mib_per_slot_sharded",
                   "params_mib_per_slot_zero3",
                   "params_zero3_vs_replicated",
                   "feats_mib_per_slot_float32",
                   "feats_mib_per_slot_bfloat16",
                   "feats_mib_per_slot_int8",
                   "feats_int8_vs_float32",
                   "halo_exchange_mib_per_step_int8",
                   "ooc_peak_rss_vs_inmem")

# headline keys of the ring-scaling record: edges/s on 1 and 8 slots,
# the owner layout's, the overlap and pipeline depth, sampler width,
# the scaling efficiency and KGE steps/s
SCALING_KEYS = ("eps_1", "eps_8", "eps_8_owner_layout",
                "owner_vs_replicated_eps", "overlap_ratio",
                "pipeline_depth",
                "num_samplers", "scaling_efficiency",
                "kge_steps_per_sec")

# serving headline keys; max_sustainable_qps_under_slo is the capacity
# headline: the highest offered rate whose windowed p99 still clears
# the SLO target
SERVE_KEYS = ("qps", "p50_ms", "p95_ms", "p99_ms", "batch_occupancy",
              "requests", "batches", "max_sustainable_qps_under_slo")

# knob-search headline keys: default against tuned seeds/s, the tuned
# knobs, the probes run and the rungs of the search
TUNE_KEYS = ("default_seeds_per_sec", "tuned_seeds_per_sec",
             "tuned_vs_default", "tuned_knobs", "probes_run",
             "rungs")

# utilization summary (obs/prof.py prof_summary): the rolling MFU, the
# binding roofline resource and its fraction, throughput, the HBM
# watermark against the analytic bill, and the compile count
PROF_KEYS = ("train_mfu", "roofline_bound", "roofline_frac",
             "train_seeds_per_sec", "hbm_watermark_mib",
             "hbm_predicted_mib", "jit_compiles")

# numerics-sentry overhead record: sentry-on against sentry-off
# throughput of the same seeded run, the overhead fraction, the
# bit-identity verdict and the compile counts of both
QUALITY_KEYS = ("sentry_on_seeds_per_sec", "sentry_off_seeds_per_sec",
                "sentry_overhead_frac", "bit_identical",
                "jit_compiles_on", "jit_compiles_off")

# communication-plane summary (obs/comm.py comm_summary): the op kinds
# seen, total analytic bytes and in-flight seconds, the heaviest op
# and its achieved GB/s, the peak link utilization and the pipeline's
# overlap ratio
COMM_KEYS = ("comm_ops", "comm_bytes_total", "comm_seconds",
             "top_op", "top_op_gbps", "axis_util_max",
             "overlap_ratio")

# step-anatomy summary (obs/xray.py xray_summary): critical-path
# fractions per category (disjoint layering: they sum to 1), the
# dominant critical-path owner, the what-if estimates and the periodic
# spike interval
XRAY_KEYS = ("steps", "workers", "step_wall_mean_s",
             "critpath_frac_compute", "critpath_frac_comm",
             "critpath_frac_stall", "critpath_frac_ckpt",
             "critpath_frac_other", "critical_owner",
             "critical_owner_frac", "whatif_comm_free_frac",
             "whatif_stall_free_frac", "whatif_owner_at_median_frac",
             "periodic_spike_every")

# aggregation-kernel benchmark record: one entry per measured (rows,
# D, fanout) shape, each arm a structured result, never a raw
# compiler-error string
KERNEL_SHAPE_KEYS = ("rows", "D", "fanout")
KERNEL_RESULT_KEYS = ("rows", "D", "fanout", "xla", "pallas",
                      "recommendation")
KERNEL_TIMING_KEYS = ("status", "fanout_sum_us", "gather_rows_us")
KERNEL_ERROR_KEYS = ("status", "detail")
KERNEL_RECORD_KEYS = ("version", "platform", "pallas_mode",
                      "recommendation", "results")


def kernel_error_record(detail: str,
                        status: str = "compile_error") -> dict:
    """The structured failure entry a kernel-bench arm records when
    its executable cannot be built or run: ``{status, detail}`` with
    ``detail`` reduced to the first line, ANSI escapes stripped and
    length-capped, so a failing toolchain never turns a benchmark
    record into a log file."""
    import re
    text = re.sub(r"\x1b\[[0-9;]*[A-Za-z]", "", str(detail)).strip()
    first = text.splitlines()[0].strip() if text else ""
    return {"status": status, "detail": first[:200]}
