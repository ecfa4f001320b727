"""The program's decode (rx_subframe's graph replay) in ms: CUDA events
around each call's decode, averaged over every call of the window."""


def read(ctx):
    ms = ctx.get("decode_ms")
    return sum(ms) / len(ms) if ms else None
