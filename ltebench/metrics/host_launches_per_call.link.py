"""Host launches per link call: the graph and kernel launches that the
profiler saw the host make in the traced window, over the calls in it
(the two graph replays and the harness's noise kernels)."""

from ltebench import trace


def read(ctx):
    return trace.host_launches(ctx["events"]) / ctx["traced_calls"]
