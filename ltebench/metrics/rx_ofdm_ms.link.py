"""The decode's OFDM demodulation: the mean ms a call of the program's
stage span `rx.ofdm` (utils/trace.py) in the traced pass of
`ltebench/spans.py`."""

from ltebench import spans


def read(ctx):
    return spans.mean_ms(ctx, "rx.ofdm")
