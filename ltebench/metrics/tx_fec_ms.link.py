"""The encode's DL-SCH coding (segmentation, CRCs, turbo encoding, rate
matching): the mean ms a call of the program's stage span `tx.fec`
(utils/trace.py) in the traced pass of `ltebench/spans.py`."""

from ltebench import spans


def read(ctx):
    return spans.mean_ms(ctx, "tx.fec")
