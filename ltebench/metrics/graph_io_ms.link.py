"""The program's graph I/O: ms a call of the two replays' input copies
and fills (`graphs.load`) and output clones (`graphs.clone`), device spans
of runtime/graphs.py, over the traced pass of `ltebench/spans.py`.

Each span runs from an event recorded before the host enqueues the
copies to one after them, on the device's clock.  The clones and the
decode's load queue behind device work and read the copies' own time;
the encode's load opens the call on an idle stream, so it reads the
host's pace of enqueueing the copies, and its idle part is also counted
by `replay_idle_ms.link` (under the host span `graphs.load`)."""

from ltebench import spans


def read(ctx):
    return spans.mean_ms(ctx, "graphs.load", "graphs.clone")
