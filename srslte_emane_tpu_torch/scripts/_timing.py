"""What the measuring entry points share: where they run, their argument
convention, their gates, and their clocks.

Rates come from the host clock over runs of calls bracketed by a
synchronise; beside them, on the card, the CUDA-event time of the same
runs (the stream's time from the first call's first launch to the last
call's end, so the waits the host leaves inside a call are in it).
"""

from __future__ import annotations

import argparse
import statistics
import time
import typing

import torch


def parser(doc: str, eager: bool = False) -> argparse.ArgumentParser:
    """An argument parser with the entry points' flag --cpu, and with
    `eager` the flag --eager of the scripts whose JAX twins time jitted
    steps (`jit`)."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (device='cpu') instead of the card")
    if eager:
        ap.add_argument("--eager", action="store_true",
                        help="run each jitted step eagerly, op by op from the host (the plain "
                             "version its CUDA graph is held against)")
    return ap


def jit(fn, eager: bool = False):
    """fn as the JAX script's `jax.jit(fn)`: a `graphs.jit` step (on the
    card one CUDA graph per argument signature, captured at its first call
    and replayed at every call; off the card fn itself), or with `eager`
    fn run op by op."""
    from ..runtime import graphs

    return fn if eager else graphs.jit(fn)


def captured(steps) -> int:
    """The CUDA graphs that the `jit` steps among `steps` captured."""
    return sum(len(getattr(s, "graphs", ())) for s in steps)


def device(cpu: bool, who: str) -> torch.device:
    """The card unless `cpu`; raises where there is no card."""
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device (pass --cpu to run on the CPU)")
    return torch.device("cpu" if cpu else "cuda")


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def stamp(dev: torch.device) -> dict:
    """The keys every entry point adds to its twin's JSON line."""
    return {"backend": dev.type, "device": device_name(dev)}


def require(cond, msg: str):
    """A gate: raises RuntimeError when `cond` is false (kept under -O)."""
    if not cond:
        raise RuntimeError(msg)


def sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _events(dev: torch.device):
    if dev.type != "cuda":
        return None
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


class Rate(typing.NamedTuple):
    median: float  # per_call * iters / seconds, median over the runs
    spread_pct: float  # (max - min) / median, in percent
    rates: list
    event_ms: float | None  # median CUDA-event ms per call; None on the CPU
    out: typing.Any  # the last call's output


def median_rate(fn, per_call: float, iters: int, n_runs: int, dev: torch.device,
                check=None) -> Rate:
    """n_runs runs of `iters` calls of fn, each run bracketed by a
    synchronise.  `check(out)` gates each run's last output."""
    rates, event_ms = [], []
    for _ in range(n_runs):
        ev = _events(dev)
        sync(dev)
        t0 = time.perf_counter()
        if ev:
            ev[0].record()
        for _ in range(iters):
            out = fn()
        if ev:
            ev[1].record()
        sync(dev)
        dt = time.perf_counter() - t0
        rates.append(per_call * iters / dt)
        if ev:
            event_ms.append(ev[0].elapsed_time(ev[1]) / iters)
        if check is not None:
            require(check(out), "a timed run produced a wrong result")
    med = statistics.median(rates)
    return Rate(med, 100.0 * (max(rates) - min(rates)) / med, rates,
                statistics.median(event_ms) if event_ms else None, out)


def per_call_ms(fn, n: int, dev: torch.device):
    """(host ms, CUDA-event ms or None on the CPU) per call over n
    back-to-back calls of fn, bracketed by synchronises."""
    ev = _events(dev)
    sync(dev)
    t0 = time.perf_counter()
    if ev:
        ev[0].record()
    for _ in range(n):
        fn()
    if ev:
        ev[1].record()
    sync(dev)
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    return host_ms, (ev[0].elapsed_time(ev[1]) / n if ev else None)


def kernel_time(fn, dev: torch.device):
    """One call of fn under torch.profiler on the card: (the CUDA kernels'
    own device time in ms, their launches); None on the CPU."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync(dev)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    return (sum(e.self_device_time_total for e in kernels) / 1e3,
            sum(e.count for e in kernels))


def profile_stage(fn, n: int, dev: torch.device):
    """One untimed call of fn (a `jit` step's capture), then `per_call_ms`
    over n calls with the MAP kernels' launches counted (a replay counts
    its graph's): (the untimed call's output, {"ms" (CUDA events, None on
    the CPU), "host_ms", "turbo_map_launches", "turbo_map_v1_launches"},
    all per call, and "first_s", the untimed call's host seconds)."""
    from ..ops.fec import turbodecoder_cuda as tdc

    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    first_s = time.perf_counter() - t0
    tdc.launches = tdc.launches_v1 = 0
    host_ms, event_ms = per_call_ms(fn, n, dev)
    return out, dict(ms=event_ms, host_ms=host_ms, turbo_map_launches=tdc.launches / n,
                     turbo_map_v1_launches=tdc.launches_v1 / n, first_s=first_s)


def stage_ms(rec: dict) -> float:
    """A `profile_stage` record's time: CUDA events on the card, the host
    clock on the CPU."""
    return rec["host_ms"] if rec["ms"] is None else rec["ms"]
