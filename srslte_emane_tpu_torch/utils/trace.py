"""Lightweight ring-buffer tracer + device-timing helpers.

Reference behavior: `lib/include/srslte/common/trace.h:38-79` —
`srslte::trace<T>` with push_cur_time_us(tti) and binary dump; per-call
`meas_time_en` timing in PDSCH/PUSCH cfg.

Twin of the reference's `utils/trace.py`: `device_timer` times a callable's
steady state with CUDA events where its outputs lie on the card (the host
clock on the CPU); `torch_profile` drives `torch.profiler` and writes a
Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import struct
import time

import numpy as np
import torch


class Trace:
    """Fixed-size ring buffer of (tag, value, t_us) samples."""

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = capacity
        self.tags = np.zeros(capacity, dtype=np.int32)
        self.values = np.zeros(capacity, dtype=np.float64)
        self.t_us = np.zeros(capacity, dtype=np.int64)
        self.n = 0
        self._t0 = time.monotonic()

    def push(self, tag: int, value: float = 0.0):
        i = self.n % self.capacity
        self.tags[i] = tag
        self.values[i] = value
        self.t_us[i] = int((time.monotonic() - self._t0) * 1e6)
        self.n += 1

    def push_cur_time_us(self, tti: int):
        self.push(tti)

    def dump(self, path: str):
        """Binary dump: n records of (i32 tag, f64 value, i64 t_us)."""
        k = min(self.n, self.capacity)
        with open(path, "wb") as f:
            f.write(struct.pack("<I", k))
            for i in range(k):
                f.write(struct.pack("<iqd", int(self.tags[i]),
                                    int(self.t_us[i]), float(self.values[i])))

    @staticmethod
    def load(path: str):
        with open(path, "rb") as f:
            (k,) = struct.unpack("<I", f.read(4))
            out = []
            for _ in range(k):
                tag, t, v = struct.unpack("<iqd", f.read(20))
                out.append((tag, t, v))
        return out


def _tensors(out):
    """The tensors of a (nested) tuple / list / dict result."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def device_timer(fn, *args, iters: int = 10) -> float:
    """Steady-state seconds per call of fn(*args): one warm-up call, then
    `iters` calls timed with CUDA events on the device of the first output
    tensor that lies on the card (synchronised), or with the host clock."""
    out = fn(*args)
    cuda = [t for t in _tensors(out) if t.is_cuda]
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    with torch.cuda.device(cuda[0].device):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / iters


@contextlib.contextmanager
def torch_profile(logdir: str):
    """torch.profiler session over the host and, where there is one, the
    card; writes `logdir/trace.json` (Chrome trace format) on exit and
    yields the profiler (`key_averages()` for sums by kernel)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
