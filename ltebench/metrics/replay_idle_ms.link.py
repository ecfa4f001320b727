"""The device's idle ms a call while the host is inside the program's
graph replays: the idle gaps of the traced window whose midpoint lies
under a `graphs.*` host span (runtime/graphs.py), over the window's
calls.  The rest of the idle time is the benchmark's loop and the
profiler's.  The idle time while the host enqueues a call's first load
lies in `graph_io_ms.link` as well (its `graphs.load` span opens the call
on an idle stream)."""

from ltebench import spans


def read(ctx):
    idle_s = spans.idle_under(ctx["events"])
    return None if idle_s is None else 1e3 * idle_s / ctx["traced_calls"]
