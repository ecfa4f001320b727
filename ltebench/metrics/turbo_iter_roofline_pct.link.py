"""turbo_iter's share of its roofline in the traced window: the least time
of the epilogues' work (`roofline.iter_bound` on the rows the passes
worked, split over the code-block sizes, each size's tables counted
once) over the summed time of the epilogue kernel's launches, idle
passes included."""

from ltebench import roofline, trace


def read(ctx):
    seconds, n = trace.kernel_seconds(ctx["events"], "iter_kernel")
    if not n or not ctx["traced_map_rows"]:
        return None
    work = ctx["driver"].map_work(ctx["traced_map_rows"])
    return 100.0 * sum(roofline.iter_bound(rows, k) for k, rows, _, _ in work) / seconds
