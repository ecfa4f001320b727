"""The decode's turbo decodes, one per code-block size: the mean ms a call
of the program's stage span `rx.turbo` (utils/trace.py) in the traced
pass of `ltebench/spans.py`."""

from ltebench import spans


def read(ctx):
    return spans.mean_ms(ctx, "rx.turbo")
