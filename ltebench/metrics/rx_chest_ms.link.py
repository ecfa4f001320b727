"""The decode's channel estimate, RE gathers and equaliser: the mean ms a
call of the program's stage span `rx.chest` (utils/trace.py) in the
traced pass of `ltebench/spans.py`."""

from ltebench import spans


def read(ctx):
    return spans.mean_ms(ctx, "rx.chest")
