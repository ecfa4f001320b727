"""BLER and throughput against SNR for the 20 MHz bench link (the port's slice 8).

Twin of the JAX repository's `scripts/snr_sweep.py`: the bench cell of
`srslte_emane_tpu_torch.bench` (100 PRB, 64QAM, rate 0.55, llr_bits=16)
at each SNR in turn.  At waterfall SNRs the turbo decoder runs up to its
full iteration budget and its compaction cascade runs the MAP kernel on
the straggler rows, so the rate falls with the iteration count.  One default_rng(0) stream draws each
SNR's payload in order; the noise comes from a torch.Generator seeded 1 at
each SNR.  As the source jits its encode and its decode per SNR, both are
`runtime.graphs.jit` steps (`snr_case`): on the card the first call at
each SNR captures each as a CUDA graph and every call replays it; with
--eager (and on the CPU) they run op by op.  The first call at each SNR
is untimed; then `iters` calls on the host clock, bracketed by
synchronises.

Usage: python -m srslte_emane_tpu_torch.scripts.snr_sweep [batch] [iters] [snrs...] [--cpu] [--eager]

Prints one JSON line per SNR, {snr_db, bler, sf_per_s, goodput_mbps} and
the MAP kernel's launches per decode call, "turbo_map_launches" (0 on the
CPU, which runs the kernel's plain version; on the card the decoder's loop
enqueues a fixed budget of predicated launches, 2 * max_iter per phase,
whatever the SNR; a replay counts its graph's), and "device_ms", the
CUDA-event ms per decode call over the same calls (null on the CPU); then
{"snr_sweep": rows} with "captured_graphs" (on the card 2 per SNR, the
encode's and the decode's; 0 on the CPU and with --eager), "backend" and
"device".
"""

from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np
import torch

from .. import bench
from ..models import pdsch_link
from ..ops import channel
from ..ops.fec import turbodecoder_cuda as tdc
from . import _timing

SNRS_DB = (8.0, 9.0, 10.0, 11.0, 12.0, 14.0, 20.0)


def snr_case(snr: float, payload: torch.Tensor, eager: bool = False):
    """The sweep at one SNR: (the encode step, the decode step, the
    received samples).  The steps are the source's per-SNR jits (`_timing.
    jit`); the noise is drawn from a generator seeded 1 on the payload's
    device; the decode returns (payload bits, CRC flags)."""
    cfg = dataclasses.replace(bench.bench_config(16), snr_db=snr)
    tx_fn = _timing.jit(lambda p: pdsch_link.tx_subframe(p, cfg), eager)
    gen = torch.Generator(device=payload.device)
    gen.manual_seed(1)
    rx = channel.awgn(gen, tx_fn(payload), snr)
    rx_fn = _timing.jit(lambda s: pdsch_link.rx_subframe(s, cfg)[:2], eager)
    return tx_fn, rx_fn, rx


def main(argv=None) -> int:
    ap = _timing.parser(__doc__, eager=True)
    ap.add_argument("batch", type=int, nargs="?", default=128)
    ap.add_argument("iters", type=int, nargs="?", default=10)
    ap.add_argument("snrs", type=float, nargs="*")
    args = ap.parse_args(argv)
    dev = _timing.device(args.cpu, "snr_sweep")
    batch, iters = args.batch, args.iters

    rng = np.random.default_rng(0)
    rows, steps = [], []
    tbs = bench.bench_config(16).tbs
    for snr in args.snrs or SNRS_DB:
        payload = torch.from_numpy(
            rng.integers(0, 2, size=(batch, tbs), dtype=np.int8)).to(dev)
        tx_fn, rx_fn, rx = snr_case(snr, payload, args.eager)
        steps += [tx_fn, rx_fn]
        decode = lambda: rx_fn(rx)[1]
        decode()  # the first call: host tables, the kernel's build, the graph's capture
        launches = tdc.launches
        timed = _timing.median_rate(decode, batch, iters, 1, dev)
        sf_s, bler = timed.median, 1.0 - float(timed.out.float().mean())
        rows.append(dict(snr_db=snr, bler=round(bler, 4), sf_per_s=round(sf_s, 1),
                         goodput_mbps=round(sf_s * (1 - bler) * tbs / 1e6, 1),
                         turbo_map_launches=(tdc.launches - launches) / iters,
                         device_ms=timed.event_ms))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"snr_sweep": rows, "captured_graphs": _timing.captured(steps),
                      **_timing.stamp(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
