"""The control of a cell's `correct`: the plain reference one precision
below what the configuration states, put in the program's place and
judged by the same comparison.  The benchmark's own runs never run it.

    python3 -m ltebench.control --workload <cell> --seeds <n> [<n> ...]

For each seed it makes the cell's inputs as a run does, sends as many
calls of each stratum as a run's check samples through the control (the
first ones), compares them with the reference, and prints one JSON line:
the seed, each number and its limit, whether the run would be judged
correct (it must not be), and the driver's info.  Where the
card is missing it runs on the CPU (for the tests, at small sizes).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ltebench import harness


def control_numbers(root, workload: str, seed: int, device: torch.device) -> dict:
    cell = harness.load_cell(root, workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    drv = cell.system.Driver(cell.config, cell.traffic, seed, device)
    drv.use(cell.system.control_steps(cell.config))
    kept = {c: drv.call(c) for c in range(drv.strata * drv.per_stratum)}
    numbers = drv.check(kept)
    correct, rows = harness.judge(numbers, cell.limits)
    return {"workload": workload, "seed": seed, "correct": correct,
            "check": {n: {"value": v, "limit": lim} for n, v, lim in rows}, "info": drv.info()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m ltebench.control", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for seed in args.seeds:
        print(json.dumps(control_numbers(harness.HERE.parent, args.workload, seed, dev)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
