"""The share of the traced window in which no kernel, copy or set ran on
the device."""

from ltebench import trace


def read(ctx):
    busy_s, window_s = trace.busy(ctx["events"])
    return 100.0 * (1.0 - busy_s / window_s)
