"""The program's own spans, read for the stage metrics, and the device's
idle time under the program's graph replays.

`traced(ctx)` runs one traced pass of the cell's calls and keeps, in
ctx, the program's spans and the number of calls in the pass; every
stage reader then takes its mean from there (`mean_ms`).  The harness's
traced window is over by then, and its graphs were captured with tracing
off: so the pass takes the program's steps anew from the driver
(`Driver.program`, no `warm`, so the set-up's numbers stay as they
were), turns the program's tracing on (`utils/trace.enable`), runs one
call per SNR (the captures), then `trace_calls` calls in a closed loop,
call c inside `trace.request(c)` and waited for, reads the spans, turns
tracing off and lets the steps go.  A program without that tracing
(`enable` missing) gives no spans: every stage reader then returns None.

On the card the stages are read on the device's clock; off it (the
tests) on the host's.
"""

from __future__ import annotations

import gc

from ltebench import trace as trace_mod

GRAPHS = "graphs."  # the prefix of the program's graph-layer spans


def traced(ctx: dict):
    """(spans, calls) of the traced pass, run once per ctx; None when the
    program keeps no spans."""
    if "span_records" not in ctx:
        ctx["span_records"], ctx["span_calls"] = _pass(ctx["driver"])
    if ctx["span_records"] is None:
        return None
    return ctx["span_records"], ctx["span_calls"]


def _pass(drv) -> tuple:
    import torch

    from srslte_emane_tpu_torch.utils import trace

    if not all(hasattr(trace, f) for f in ("enable", "request", "spans", "reset")):
        return None, 0
    on_card = drv.dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(drv.dev)) if on_card else (lambda: None)
    info = dict(drv.info_)
    trace.reset()
    trace.enable(True)
    try:
        drv.use(drv.program())
        for c in range(drv.strata):
            drv.call(c)
        sync()
        trace.reset()
        for c in range(drv.trace_calls):
            with trace.request(c):
                drv.call(c)
                sync()
        records = trace.spans()
    finally:
        trace.enable(False)
        trace.reset()
        drv.use((None, None))
        drv.info_.clear()
        drv.info_.update(info)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    return [r for r in records if r.clock == ("device" if on_card else "host")], drv.trace_calls


def stage_ms(records: list, calls: int, names: tuple) -> float | None:
    """The mean over `calls` requests of the summed ms of the spans named
    `names` in each; None when no such span was recorded."""
    picked = [r for r in records if r.name in names and 0 <= r.request < calls]
    if not picked or not calls:
        return None
    return sum(r.end_ns - r.start_ns for r in picked) / 1e6 / calls


def mean_ms(ctx: dict, *names: str) -> float | None:
    """A stage metric: `stage_ms` over the traced pass."""
    got = traced(ctx)
    return None if got is None else stage_ms(got[0], got[1], names)


def idle_under(events: list, prefix: str = GRAPHS) -> float | None:
    """Seconds of the device's idle time within the traced window whose
    midpoint lies under a host span whose name starts with `prefix`; None
    when the window holds no such span."""
    start, end = trace_mod.window(events)
    host = sorted((e.start_ns, e.end_ns) for e in events
                  if not e.device and e.name.startswith(prefix))
    if not host:
        return None
    busy = trace_mod.device_intervals(events, start, end)
    edges = [start] + [x for s in busy for x in s] + [end]
    idle = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        mid = (a + b) // 2
        if b > a and any(s <= mid <= e for s, e in host):
            idle += b - a
    return idle / 1e9
