"""Paced (real-time) block-mode latency benchmark of the port.

Twin of the JAX repository's `scripts/bench_waveform_paced.py`: the SPS
waveform block of `bench_waveform_tpu` (cfi 1, DL and UL at MCS 20, 30 dB,
llr_bits=16) run as a deployed emulation must run it, one T-TTI block
every T milliseconds at the LTE 1 kHz TTI cadence, and what matters there:

  - deadline misses of the depth-1 pipeline: block k is dispatched at tick
    k; its three counts are copied (non_blocking) into pinned host memory
    and a CUDA event is recorded after the copy; at tick k + 1 the host
    waits on that event before it dispatches block k + 1.  A miss is the
    host slipping a tick, or a wait longer than one tick (the source's
    rule); the stderr line also counts the blocks whose event had not
    completed at their deadline (`late`);
  - the device compute per block: CUDA events over 10 back-to-back
    blocks (the host clock on the CPU), and the headroom T ms / compute
    (2.0 = the card could run the cell at twice real time);
  - the serialised round trip (dispatch to synchronise, host clock).

The port dispatches from Python: a block enqueues a few hundred kernels,
and the turbo decoder syncs the host once per half-iteration, so the
host's dispatch time per block (on the stderr line) is part of what the
cadence must absorb.  Payloads are two device-resident buffers, used in
turn, each with its torch.Generator (seeds 0 and 1).

Usage: python -m srslte_emane_tpu_torch.scripts.bench_waveform_paced
           [n_prb] [n_ues] [T] [blocks] [--cpu]

Prints one JSON line with the source's keys (deadline_misses among them)
plus "backend"; "device" is the card's name.  Every paced block must pass
every DL and UL CRC and detect every ACK.
"""

from __future__ import annotations

import itertools
import json
import statistics
import sys
import time

import numpy as np
import torch

from ..runtime import waveblock
from . import _timing
from .bench_waveform_tpu import check_counts, sps_block_config


def main(argv=None) -> int:
    ap = _timing.parser(__doc__)
    for name, default in (("n_prb", 100), ("n_ues", 8), ("T", 40), ("blocks", 100)):
        ap.add_argument(name, type=int, nargs="?", default=default)
    args = ap.parse_args(argv)
    dev = _timing.device(args.cpu, "bench_waveform_paced")
    n_prb, n_ues, T, n_blocks = args.n_prb, args.n_ues, args.T, args.blocks
    cuda = dev.type == "cuda"

    cfg = sps_block_config(n_prb, n_ues, T)
    bench = waveblock.make_bench_step(cfg, sfn0=4, device=dev)
    rng = np.random.default_rng(0)
    bufs = [tuple(torch.from_numpy(rng.integers(0, 2, (T, n_ues, tbs), np.int8)).to(dev)
                  for tbs in (cfg.dl_tbs, cfg.ul_tbs)) for _ in range(2)]
    gens = [torch.Generator(device=dev) for _ in range(2)]
    for s, g in enumerate(gens):
        g.manual_seed(s)
    tti0s = [(k * T) % 10240 for k in range(n_blocks)]
    block = lambda k: bench(*bufs[k % 2], gens[k % 2], tti0s[k % n_blocks])
    want = T * n_ues

    # warm: the first block (host tables, the kernel's build) and one more
    t0 = time.perf_counter()
    counts = block(0)
    _timing.sync(dev)
    compile_s = time.perf_counter() - t0
    check_counts(counts, want, want)
    block(1)
    _timing.sync(dev)

    # 1) device compute per block, back to back
    ks = itertools.count()
    host_ms, event_ms = _timing.per_call_ms(lambda: block(next(ks)), 10, dev)
    compute_ms = host_ms if event_ms is None else event_ms

    # 2) serialised round trip: dispatch, then synchronise
    lat_ser = []
    for k in range(20):
        t0 = time.perf_counter()
        block(k)
        _timing.sync(dev)
        lat_ser.append(time.perf_counter() - t0)
    rtt_ms = statistics.median(lat_ser) * 1e3

    # 3) the paced depth-1 pipeline at the 1 kHz TTI cadence
    period_s = T / 1000.0
    host = torch.zeros((n_blocks, 3), dtype=torch.int64, pin_memory=cuda)
    misses, late, waits, dispatch = 0, 0, [], []
    prev = None
    t_start = time.perf_counter() + 0.05
    for k in range(n_blocks):
        tick = t_start + k * period_s
        now = time.perf_counter()
        if now < tick:
            time.sleep(tick - now)
        else:
            misses += 1  # the host itself slipped the tick
        if prev is not None:  # block k - 1's counts must be host-visible now
            late += not prev.query()
            t0 = time.perf_counter()
            prev.synchronize()
            waits.append(time.perf_counter() - t0)
            if waits[-1] > period_s:
                misses += 1  # block k - 1 not retrievable within a tick
        t0 = time.perf_counter()
        host[k].copy_(torch.stack(block(k)), non_blocking=True)
        if cuda:
            prev = torch.cuda.Event()
            prev.record()
        dispatch.append(time.perf_counter() - t0)
    if prev is not None:
        prev.synchronize()
    for k, row in enumerate(host.tolist()):
        _timing.require(row == [want] * 3, f"paced block {k} lost CRCs or ACKs: {row} of {want}")

    headroom = T / compute_ms
    per_tti_us = compute_ms * 1000.0 / T
    wait_txt = (f", wait on the previous block median {statistics.median(waits) * 1e3:.3f} ms "
                f"max {max(waits) * 1e3:.3f} ms, late {late}/{n_blocks - 1}") if waits else ""
    print(f"# paced {n_prb} PRB x {n_ues} UEs, T={T} ({period_s * 1e3:.0f} ms tick) x "
          f"{n_blocks} blocks: compute={compute_ms:.2f} ms/block ({per_tti_us:.0f} us/TTI), "
          f"host dispatch median {statistics.median(dispatch) * 1e3:.2f} ms max "
          f"{max(dispatch) * 1e3:.2f} ms per block{wait_txt}, serialized rtt latency="
          f"{rtt_ms:.1f} ms, misses={misses}/{n_blocks}, headroom={headroom:.2f}x, "
          f"compile={compile_s:.1f}s device={_timing.device_name(dev)}", file=sys.stderr)
    print(json.dumps({
        "metric": "waveform_paced_headroom_x",
        "value": round(headroom, 2),
        "unit": "x (T ms tick / device compute per block)",
        "vs_baseline": round(headroom, 2),  # the reference paces at exactly 1x
        "n_prb": n_prb, "n_ues": n_ues, "block_ttis": T,
        "blocks": n_blocks, "deadline_misses": misses,
        "compute_ms": round(compute_ms, 2),
        "serialized_rtt_ms": round(rtt_ms, 2),
        "per_tti_us": round(per_tti_us, 1),
        "compile_s": round(compile_s, 1),
        **_timing.stamp(dev),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
