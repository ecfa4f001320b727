"""Per-module leveled logging with hex dumps.

Reference behavior: `lib/src/common/{log_filter.cc,logger_file.cc}` — per
module levels, hex dump limits, async file backend; the fork adds thread-id
and hex-sum options (patches/log_threadid.patch).
"""

from __future__ import annotations

import logging

_LEVELS = {"none": logging.CRITICAL + 10, "error": logging.ERROR,
           "warning": logging.WARNING, "info": logging.INFO,
           "debug": logging.DEBUG}


def get_logger(module: str, level: str = "info", filename: str = None,
               hex_limit: int = 32):
    log = logging.getLogger(f"srslte_tpu.{module}")
    log.setLevel(_LEVELS.get(level, logging.INFO))
    if not log.handlers:
        h = logging.FileHandler(filename) if filename else logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s.%(msecs)03d [%(name)-18s] [%(levelname).1s] "
            "[tid=%(thread)d] %(message)s", datefmt="%H:%M:%S"))
        log.addHandler(h)
        log.propagate = False
    log.hex_limit = hex_limit
    return log


def hexdump(log, level: str, msg: str, data: bytes):
    limit = getattr(log, "hex_limit", 32)
    shown = data[:limit]
    dump = " ".join(f"{b:02x}" for b in shown)
    extra = f" ... (+{len(data)-limit}B, sum={sum(data) & 0xFFFF:04x})" if len(data) > limit else ""
    getattr(log, level)(f"{msg} [{len(data)}B] {dump}{extra}")
