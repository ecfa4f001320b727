"""A short profiler window and the readings taken from it.

`record(fn)` runs fn under torch.profiler (host and device activities)
inside one user annotation, and turns what the profiler kept into plain
`Event`s: name, whether it ran on the device, start and end in
nanoseconds on one clock.  The readers below take such a list, so they
can be checked on a made-up trace.  A trace with no device event raises
`EmptyTrace`: the run then fails instead of reading an empty window.
"""

from __future__ import annotations

import collections
import typing

WINDOW = "ltebench.traced_window"
# host-side API calls that start work on the device: graph launches and
# kernel launches (the runtime's and the driver's names)
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch")


class Event(typing.NamedTuple):
    name: str
    device: bool
    start_ns: int
    end_ns: int


class EmptyTrace(RuntimeError):
    pass


def base_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters: `void (anonymous namespace)::map_kernel<...>(...)`
    is `map_kernel`."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in "<(":
        name = name.split(stop, 1)[0]
    return name.rsplit("::", 1)[-1].strip()


def record(fn) -> list:
    """fn() under the profiler, inside the annotation WINDOW; returns its events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
        torch.cuda.synchronize()
    out = []
    for e in prof.profiler.kineto_results.events():
        device = e.device_type() != torch.autograd.DeviceType.CPU
        if device and e.name() == WINDOW:
            continue  # the annotation's copy on the device's timeline: no work
        out.append(Event(e.name(), device, int(e.start_ns()), int(e.end_ns())))
    return out


def window(events: list) -> tuple:
    """(start, end) in ns of the traced window: the WINDOW annotation."""
    marks = [e for e in events if e.name == WINDOW and not e.device]
    if not marks:
        raise EmptyTrace(f"the trace has no {WINDOW} annotation")
    return marks[0].start_ns, marks[0].end_ns


def device_intervals(events: list, start: int, end: int) -> list:
    """The device's busy intervals within [start, end], merged and sorted."""
    spans = sorted((max(e.start_ns, start), min(e.end_ns, end)) for e in events
                   if e.device and e.end_ns > start and e.start_ns < end)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


def busy(events: list) -> tuple:
    """(busy_s, window_s): seconds in which some kernel, copy or set ran on
    the device, and the window's length.  Raises EmptyTrace when no device
    event falls in the window."""
    start, end = window(events)
    spans = device_intervals(events, start, end)
    if not spans:
        raise EmptyTrace("the traced window holds no device event")
    return sum(b - a for a, b in spans) / 1e9, (end - start) / 1e9


def host_launches(events: list) -> int:
    """Graph and kernel launches the host made within the window."""
    start, end = window(events)
    return sum(1 for e in events if not e.device and e.name in LAUNCHES
               and start <= e.start_ns <= end)


def kernel_seconds(events: list, kernel: str) -> tuple:
    """(summed seconds, count) of the device events of the kernel named
    `kernel` (`base_name`)."""
    start, end = window(events)
    total, n = 0, 0
    for e in events:
        if e.device and e.start_ns >= start and e.end_ns <= end:
            if base_name(e.name) == kernel:
                total += e.end_ns - e.start_ns
                n += 1
    return total / 1e9, n


def device_ops(events: list, top: int = 10) -> list:
    """[[name, seconds]] of the device operations that took the most time."""
    start, end = window(events)
    acc = collections.Counter()
    for e in events:
        if e.device and e.start_ns >= start and e.end_ns <= end:
            acc[e.name[:160]] += (e.end_ns - e.start_ns) / 1e9
    return [[n, s] for n, s in acc.most_common(top)]


def idle_gaps(events: list, top: int = 10) -> list:
    """[[host activity, seconds]]: the device's idle time within the window,
    each gap named by the innermost host event under its midpoint (the
    annotation itself when nothing else is), summed by name, the largest
    first."""
    start, end = window(events)
    spans = device_intervals(events, start, end)
    edges = [start] + [x for s in spans for x in s] + [end]
    host = [e for e in events if not e.device and e.name != WINDOW]
    acc = collections.Counter()
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        under = [e for e in host if e.start_ns <= mid <= e.end_ns]
        name = min(under, key=lambda e: e.end_ns - e.start_ns).name if under else WINDOW
        acc[name[:160]] += (b - a) / 1e9
    return [[n, s] for n, s in acc.most_common(top)]
