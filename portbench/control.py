"""The readings that the limits of ``correct`` are set from, on the card
at a cell's own size (the benchmark's own runs never run this).

    python3 portbench/control.py --workload <cell> --seeds 11,12,... \
        [--controls 3] [--out readings.json]

In one process (the graph and the program's graph core are made once):
for each seed, the program's checked steps, run through
``SampledTrainer.train`` as in a benchmark run, against the reference's
(the lower readings: sound runs); for the first ``--controls`` seeds also the reference in TF32 put in the
program's place (the control) and the reference with half of every
batch left out of the loss (a fault). A step that leaves the state
unchanged reads 1 by the comparison's measure and needs no run. Prints
one JSON line a seed and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if __name__ == "__main__":
    sys.path[0] = os.path.dirname(HERE)

import torch  # noqa: E402

from portbench import data, spec  # noqa: E402
from portbench.drivers import closed_train as ct  # noqa: E402


def leaves(prog, ref, inputs) -> dict:
    """Per leaf: the norms of the first gradient and of the change over
    the checked steps, the program's and the reference's."""
    out = {}
    for k, p0 in inputs["init"].items():
        p0 = p0.cpu().double()
        out[k] = {"grad": [float(prog["grads"][k].double().norm()),
                           float(ref["grads"][k].cpu().double().norm())],
                  "delta": [float((prog["params"][k].double() - p0).norm()),
                            float((ref["params"][k].cpu().double()
                                   - p0).norm())]}
    return out


def readings(cell, seed: int, arrays, device, controls: bool,
             graph=None) -> dict:
    """One seed's readings: the program's checked calls through
    ``SampledTrainer.train`` (``graph``: the program's graph of
    ``arrays``, reused across seeds) against the reference, and with
    ``controls`` the control and the half-batch fault against it."""
    seeds = data.run_seeds(seed)
    win, error = ct.drive(cell, seeds, arrays, device, 0.0, False, {},
                          checked_only=True, graph=graph)
    if error is not None or win.prog is None:
        raise RuntimeError(f"seed {seed}: the checked calls failed: "
                           f"{error}")
    prog = win.prog
    steps = ct.checked_steps(win, arrays["train_ids"], seeds["program"],
                             int(cell.config["train"]["batch_size"]))
    del win
    gc.collect()
    torch.cuda.empty_cache()
    inputs = ct.reference_inputs(cell, seeds, arrays, steps, device)
    ref = ct.follow(cell, inputs)
    out = {"seed": seed, "sound": ct.compare(prog, ref, inputs),
           "losses": prog["losses"], "ref_losses": ref["losses"],
           "leaves": leaves(prog, ref, inputs)}
    if controls:
        for name, variant in (("tf32", {"precision": "tf32"}),
                              ("half_batch", {"fault": "half_batch"})):
            alt = ct.follow(cell, inputs, **variant)
            out[name] = ct.compare(ct.as_program(alt, inputs), ref, inputs)
            out[name + "_losses"] = alt["losses"]
    del inputs, ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    arrays = data.load_graph(cell.config["graph"])
    device = torch.device("cuda", torch.cuda.current_device())
    graph = ct.program_graph(cell, arrays, {})
    rows = []
    for i, s in enumerate(int(x) for x in args.seeds.split(",")):
        row = readings(cell, s, arrays, device, i < args.controls, graph)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload,
                       "card": torch.cuda.get_device_name(device),
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
