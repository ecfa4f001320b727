"""MAP rows per link call: the code-block rows of every MAP pass that ran
in the window (the program's on-card count, `read_map_rows`), over the
calls; early stop and the cascade lower it."""


def read(ctx):
    return ctx["map_rows"] / ctx["calls"] if ctx["calls"] else None
