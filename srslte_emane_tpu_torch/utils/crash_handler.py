"""Crash handler: fatal-signal backtrace dump.

Reference behavior: `lib/src/common/crash_handler.c` + `backtrace.c` — a
signal handler that appends a backtrace to a crash file so field failures of
daemonized nodes are diagnosable.  Python equivalent: `faulthandler` armed
for SIGSEGV/SIGABRT/etc. plus an excepthook appending uncaught tracebacks.
"""

from __future__ import annotations

import datetime
import faulthandler
import sys
import traceback

_file = None


def install(path: str = "/tmp/srslte_emane_tpu.backtrace"):
    """Arm fault handlers; crash info appends to `path`."""
    global _file
    _file = open(path, "a")
    faulthandler.enable(file=_file, all_threads=True)

    prev = sys.excepthook

    def hook(tp, val, tb):
        _file.write(f"--- uncaught exception {datetime.datetime.now()} ---\n")
        traceback.print_exception(tp, val, tb, file=_file)
        _file.flush()
        prev(tp, val, tb)

    sys.excepthook = hook
    return path
