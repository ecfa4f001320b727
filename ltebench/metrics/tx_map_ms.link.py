"""The encode's scrambling, modulation and grid assembly with the CRS: the
mean ms a call of the program's stage span `tx.map` (utils/trace.py) in
the traced pass of `ltebench/spans.py`."""

from ltebench import spans


def read(ctx):
    return spans.mean_ms(ctx, "tx.map")
