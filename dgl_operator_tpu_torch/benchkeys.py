"""Pinned key sets of the telemetry summaries, the port's copy of three
tuples of the JAX package's ``benchkeys.py``. A summary asserts that it
returns exactly these keys, so a reader of either package's records
finds the same fields.
"""

# utilization summary (obs/prof.py prof_summary): the rolling MFU, the
# binding roofline resource and its fraction, throughput, the HBM
# watermark against the analytic bill, and the compile count
PROF_KEYS = ("train_mfu", "roofline_bound", "roofline_frac",
             "train_seeds_per_sec", "hbm_watermark_mib",
             "hbm_predicted_mib", "jit_compiles")

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
