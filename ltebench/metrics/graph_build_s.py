"""Seconds that the program's graph builds (warm-up and capture of each
graph) took in this run's set-up: `runtime.graphs.STATS`."""


def read(ctx):
    return ctx["driver"].info().get("graph_build_s")
