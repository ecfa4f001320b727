"""turbo_map's share of its roofline in the traced window: the least time
of the MAP passes' work (`roofline.map_bound` on the rows the passes
worked, split over the call's code-block sizes) over the summed time of
the kernel's launches, idle passes included."""

from ltebench import roofline, trace


def read(ctx):
    seconds, n = trace.kernel_seconds(ctx["events"], "map_kernel")
    if not n or not ctx["traced_map_rows"]:
        return None
    work = ctx["driver"].map_work(ctx["traced_map_rows"])
    return 100.0 * sum(roofline.map_bound(k, rows, w, narrow) for k, rows, w, narrow in work) / seconds
