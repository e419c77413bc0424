"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The kernels' build directory is the
program's own, inside the checkout (``dgl_operator_tpu_torch/_build``);
PyTorch's extension and Triton caches and the graph cache live under
``portbench/.cache``. See ``portbench/README.md``.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
# one host thread for PyTorch's and numpy's CPU work: the window's host
# side is one loop issuing calls, and idle worker threads spinning beside
# it make runs spread
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
# plans that would change what a run does
for var in ("TPU_OPERATOR_TUNED_MANIFEST", "TPU_OPERATOR_CHAOS",
            "TPU_OPERATOR_OBS_DIR", "TPU_OPERATOR_LIVE_PORT"):
    os.environ.pop(var, None)
# the checkout's root, not this directory, heads the import path
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path[0] = ROOT
else:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], harness.process_start()))
