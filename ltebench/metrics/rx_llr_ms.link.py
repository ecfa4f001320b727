"""The decode's soft demodulation, CSI weights, descrambling and soft
combining: the mean ms a call of the program's stage span `rx.llr`
(utils/trace.py) in the traced pass of `ltebench/spans.py`."""

from ltebench import spans


def read(ctx):
    return spans.mean_ms(ctx, "rx.llr")
