"""The benchmark's general part: it reads BENCHMARK.json, finds a cell's
configuration, traffic and per-layer metrics by name, and drives one run.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
The configuration is `configs/<name>.json` under this folder (its `system`
key names the driver in `systems/`, and its `check` key the limits in
`checks/`); the traffic mix is `traffic/<name>.json`, the parameters that
the driver's one generator reads; each per-layer metric is
`metrics/<metric>.py`, whose `read(ctx)` returns a number or None.  A
later cell or metric is new files and new entries: nothing here changes.

A system's driver (`systems/<name>.py`, class `Driver`) makes the
inputs from the seed, hands out the program's steps, submits call c,
resets and reads the program's counters, and compares the calls that the
check sampled with the plain reference; it names its rate metric and
the units a call completes.  The harness does the rest, the same for
every system: set-up (imports, CUDA, the inputs, the program's kernels,
graph capture and warm-up), then a closed loop of calls for `seconds`,
each timed and waited for (`CallTimer`), with a sample of them kept
from the whole window (`Sample`), then the rate, the p95 call time and
the set-up time, then the check after the peak memory is read.  With
trace, a short profiled window of the same calls comes after the set-up,
and the line carries the per-layer metrics instead of the end-to-end
ones.  The check for forbidden modules comes last, after the readers.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import pathlib
import random
import statistics
import sys
import time

from . import trace as trace_mod

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "srslte_emane_tpu")


def load_spec(root: pathlib.Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _entry(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    system: object  # the driver module of systems/
    limits: dict


def load_cell(root: pathlib.Path, name: str) -> Cell:
    """The cell `name` of root's BENCHMARK.json with its files read."""
    spec = load_spec(root)
    cell = _entry(spec["workloads"], name, "workload")
    conf_entry = _entry(spec["configs"], cell["config"], "configuration")
    config = json.loads((root / conf_entry["file"]).read_text())
    bench_dir = root / "ltebench"
    traffic = json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((bench_dir / "checks" / f"{config['check']}.json").read_text())
    system = _load(bench_dir / "systems" / f"{config['system']}.py", f"system {config['system']}")
    return Cell(name, config, traffic,
                [m for m in spec["end_to_end"] if applies(m, name)],
                [m for m in spec["per_layer"] if applies(m, name)], system, limits)


def _load(path: pathlib.Path, what: str):
    if not path.is_file():
        raise FileNotFoundError(f"{what}: no file {path}")
    mod_spec = importlib.util.spec_from_file_location(f"ltebench_{path.stem}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(root: pathlib.Path, metric: str):
    """metrics/<metric>.py's read(ctx)."""
    return _load(root / "ltebench" / "metrics" / f"{metric}.py", f"metric {metric}").read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [[name, value, limit]]): each number at or under its limit."""
    rows = [[k, v, limits[k]["limit"]] for k, v in numbers.items()]
    return all(v <= lim for _, v, lim in rows), rows


class Sample:
    """`per` calls of each stratum (call c is in stratum c % strata), drawn
    uniformly from all of that stratum's calls however many the window
    holds (reservoir sampling), with draws from the seed.  Calls are
    offered in order from 0."""

    def __init__(self, strata: int, per: int, seed: int):
        self.strata, self.per = strata, per
        self.rng = random.Random(seed)
        self.slots = [[] for _ in range(strata)]

    def offer(self, c: int, out) -> None:
        slot, n = self.slots[c % self.strata], c // self.strata
        if n < self.per:
            slot.append((c, out))
        else:
            j = self.rng.randrange(n + 1)
            if j < self.per:
                slot[j] = (c, out)

    def kept(self) -> dict:
        return dict(x for slot in self.slots for x in slot)


class CallTimer:
    """Each call's time in ms.  On the card: CUDA events recorded on the
    stream before the call's first work is queued and after its last, the
    second waited for, so that the call's outputs are ready before the next
    is submitted; the device's clock reads the span.  Off the card (the
    tests) the call runs to its end in the host's clock."""

    def __init__(self, device):
        import torch

        self.event = torch.cuda.Event if device.type == "cuda" else None
        self.spans, self.host_ms = [], []

    def start(self) -> None:
        if self.event:
            self.begin = self.event(enable_timing=True)
            self.begin.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.event:
            end = self.event(enable_timing=True)
            end.record()
            end.synchronize()
            self.spans.append((self.begin, end))
        else:
            self.host_ms.append(1e3 * (time.perf_counter() - self.t0))

    def ms(self) -> list:
        return [a.elapsed_time(b) for a, b in self.spans] if self.event else self.host_ms


def run(root: pathlib.Path, workload: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, wrap=None) -> dict:
    """One run of a cell on `device`; returns the result line as a dict.
    `wrap`, for tests, is handed the program's steps to break them."""
    import torch

    parts = {"start": time.perf_counter() - t_start}
    t = time.perf_counter()
    cell = load_cell(root, workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
        torch.empty(1, device=device)  # the CUDA context
    parts["context"], t = time.perf_counter() - t, time.perf_counter()
    drv = cell.system.Driver(cell.config, cell.traffic, seed, device)
    parts["inputs"], t = time.perf_counter() - t, time.perf_counter()
    steps = drv.program()
    parts["program"], t = time.perf_counter() - t, time.perf_counter()
    drv.warm(wrap(*steps) if wrap is not None else steps)
    parts["warm_up"] = time.perf_counter() - t
    ctx = {}
    if trace:
        drv.counters_reset()

        def traced():  # the same closed loop as the measured window's
            timer = CallTimer(device)
            for i in range(drv.trace_calls):
                timer.start()
                drv.call(i)
                timer.stop()

        events = trace_mod.record(traced)
        ctx.update(events=events, traced_calls=drv.trace_calls,
                   traced_map_rows=drv.counters()["map_rows"])
        busy_s, window_s = trace_mod.busy(events)
    sample = Sample(drv.strata, drv.per_stratum, seed)
    timer = CallTimer(device)
    drv.counters_reset(stages=trace)
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    c = 0
    while time.perf_counter() - t0 < seconds or c < drv.strata * drv.per_stratum:
        timer.start()
        out = drv.call(c)
        timer.stop()
        sample.offer(c, out)
        c += 1
    window_s_host = time.perf_counter() - t0
    calls_ms = timer.ms()
    measured = {drv.rate_metric: c * drv.units_per_call / window_s_host,
                "call_p95_ms": statistics.quantiles(calls_ms, n=20, method="inclusive")[-1],
                "setup_s": setup_s}
    ctx.update(drv.counters(), calls=c, driver=drv)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    del out, timer
    t = time.perf_counter()
    numbers = drv.check(sample.kept())
    check_s = time.perf_counter() - t
    del sample
    correct, rows = judge(numbers, cell.limits)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = reader(root, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"loaded in the benchmark's process: {', '.join(found)}")
    dev_info = {"platform": "gpu" if on_card else device.type,
                "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": c,
           "failed": sum(1 for _, v, lim in rows if v > lim), "metrics": metrics,
           "device": dev_info}
    if trace:
        dev_info.update(busy_s=busy_s, window_s=window_s)
        out["breakdown"] = {"device_ops": trace_mod.device_ops(ctx["events"]),
                            "idle_gaps": trace_mod.idle_gaps(ctx["events"])}
    out["info"] = dict(drv.info(), setup_parts_s=parts, check_s=check_s,
                       call_mean_ms=statistics.fmean(calls_ms),
                       call_median_ms=statistics.median(calls_ms))
    out["check"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    del drv, ctx
    gc.collect()
    return out


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python3 -m ltebench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = HERE.parent
    spec = load_spec(root)
    chips = _entry(spec["workloads"], args.workload, "workload")["chips"]

    import torch

    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"ltebench: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = run(root, args.workload, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0), t_start)
    out["info"]["setup_parts_s"]["imports"] = t_torch - t_start
    power = _power_limit()
    if power is not None:
        out["device"]["power_limit_w"] = power
    for name, c in out["check"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def _power_limit():
    """The card's power limit in W from nvidia-smi, or None."""
    import subprocess

    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=20, check=False)
        return float(res.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None
