"""Runs of one cell in a row, and the spread of each metric over them.

    python3 -m ltebench.sets --workload <cell> --seeds <n> [<n> ...] [--seconds S]
        [--trace 0|1] [--out FILE]

Runs `python3 -m ltebench.run` once per seed, one process after the
other, each waited for; appends each run's result line (with its seed,
exit code and wall seconds) to --out as JSON lines; then prints, for each
metric, the median and the spread: the distance between the first and
third quartiles (statistics.quantiles, n=4) as a share of the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m ltebench.sets", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.seconds is None:
        with open("BENCHMARK.json") as f:
            args.seconds = json.load(f)["run_seconds"]
    lines = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "ltebench.run", "--workload", args.workload,
                              "--seed", str(seed), "--seconds", str(args.seconds),
                              "--trace", str(args.trace)], capture_output=True, text=True,
                             check=False)
        wall = time.perf_counter() - t0
        try:
            line = json.loads(res.stdout.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            line = {"error": res.stderr[-2000:]}
        line.update(seed=seed, rc=res.returncode, wall_s=wall, workload=args.workload)
        lines.append(line)
        print(json.dumps({k: line.get(k) for k in ("seed", "rc", "wall_s", "correct", "metrics",
                                                   "check", "error")}), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    ok = [x for x in lines if x["rc"] == 0 and "metrics" in x]
    if len(ok) >= 2:
        for name in ok[0]["metrics"]:
            vals = [x["metrics"][name]["value"] for x in ok if name in x["metrics"]]
            if len(vals) >= 2:
                print(json.dumps({"metric": name, "n": len(vals), "median": statistics.median(vals),
                                  "spread": spread(vals), "values": vals}), flush=True)
    return 0 if all(x["rc"] == 0 for x in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
