"""The program's encode (tx_subframe's graph replay) in ms: CUDA events
around each call's encode, averaged over every call of the window."""


def read(ctx):
    ms = ctx.get("encode_ms")
    return sum(ms) / len(ms) if ms else None
