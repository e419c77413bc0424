"""The card's peak rates, from NVIDIA's H100 SXM5 data sheet (dense,
without sparsity, at the 700 W limit): the denominators of the rooflines
and of ``train_mfu``. A copy of the program's ``obs/peaks.py``, kept here
so that a change to the program cannot move the yardstick."""

HBM_BYTES_PER_S = 3350e9
# the peak of each compute precision a configuration can state
FLOPS = {"float32": 67e12, "tf32": 494.7e12, "bfloat16": 989.4e12}
