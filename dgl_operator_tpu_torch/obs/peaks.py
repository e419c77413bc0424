"""The card's peak rates, typed once from the NVIDIA H100 SXM5 data
sheet: the roofline denominators of the utilization gauges
(``obs/prof.py``, ``obs/comm.py``) and of ``chip_smoke.py``'s kernel
bounds, which loads this file by its path.

No imports: a reader that has only the file can use it.
"""

# HBM3 bandwidth (GB/s) and the dense peak FLOP/s of each compute kind:
# float32 on the CUDA cores, TF32 and BF16 on the tensor cores (without
# sparsity)
H100_PEAKS = {"hbm_gbps": 3350.0, "fp32": 67e12, "tf32": 494.7e12,
              "bf16": 989.4e12}
# NVLink: 900 GB/s of bidirectional bandwidth a GPU, counted in one
# direction (a collective's bytes are what each GPU sends)
H100_NVLINK_GBPS = 450.0
