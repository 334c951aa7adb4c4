"""The control of a cell's check: the plain reference, computed in
bfloat16, the precision below the f32 the configurations state, put in the
program's place and judged by the same comparison.  It has to come out as not correct.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...] \\
        [--batches <timed batches of a run>]

Prints one JSON line a seed with the readings beside the cell's limits.
The window family's control covers the windows a run of ``--batches``
timed batches has due; the graph family's, one job.  On the card: the
control runs at the cell's own size.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def readings(cell, seed: int, batches: int, device):
    """(attempted, failed, readings) of the control on ``seed``."""
    import torch
    driver = cell.module("drivers", cell.config["driver"]).Driver(
        cell, seed, device)
    return driver.control(torch.bfloat16, batches)


def main() -> int:
    import torch

    from portbench.lib import harness
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--batches", type=int, default=2000)
    args = p.parse_args()
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA card is visible (the control runs at the "
              "cell's own size)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        attempted, failed, got = readings(cell, seed, args.batches, device)
        correct = all(got[k] <= v for k, v in cell.limits.items())
        print(json.dumps({"seed": seed, "dtype": "bfloat16",
                          "attempted": attempted, "correct": correct,
                          "readings": got, "limits": cell.limits}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
