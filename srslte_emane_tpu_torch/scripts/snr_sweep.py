"""BLER and throughput against SNR for the 20 MHz bench link (the port's slice 8).

Twin of the JAX repository's `scripts/snr_sweep.py`: the bench cell of
`srslte_emane_tpu_torch.bench` (100 PRB, 64QAM, rate 0.55, llr_bits=16)
at each SNR in turn.  At waterfall SNRs the turbo decoder runs up to its
full iteration budget and its compaction cascade runs the MAP kernel on
the straggler rows, so the rate falls with the iteration count.  One default_rng(0) stream draws each
SNR's payload in order; the noise comes from a torch.Generator seeded 1 at
each SNR.  The first call at each SNR is untimed; then `iters` calls on the
host clock, bracketed by synchronises.

Usage: python -m srslte_emane_tpu_torch.scripts.snr_sweep [batch] [iters] [snrs...] [--cpu]

Prints one JSON line per SNR, {snr_db, bler, sf_per_s, goodput_mbps} and
the MAP kernel's launches per decode call, "turbo_map_launches" (0 on the
CPU, which runs the kernel's plain version; on the card the decoder's loop
enqueues a fixed budget of predicated launches, 2 * max_iter per phase,
whatever the SNR), then {"snr_sweep": rows} with "backend" and "device".
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


def main(argv=None) -> int:
    ap = _timing.parser(__doc__)
    ap.add_argument("batch", type=int, nargs="?", default=128)
    ap.add_argument("iters", type=int, nargs="?", default=10)
    ap.add_argument("snrs", type=float, nargs="*")
    args = ap.parse_args(argv)
    dev = _timing.device(args.cpu, "snr_sweep")
    batch, iters = args.batch, args.iters

    rng = np.random.default_rng(0)
    rows = []
    for snr in args.snrs or SNRS_DB:
        cfg = dataclasses.replace(bench.bench_config(16), snr_db=snr)
        payload = torch.from_numpy(
            rng.integers(0, 2, size=(batch, cfg.tbs), dtype=np.int8)).to(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        rx = channel.awgn(gen, pdsch_link.tx_subframe(payload, cfg), snr)
        decode = lambda: pdsch_link.rx_subframe(rx, cfg)[1]
        decode()  # the first call: host tables (and the kernel's build)
        launches = tdc.launches
        timed = _timing.median_rate(decode, batch, iters, 1, dev)
        sf_s, bler = timed.median, 1.0 - float(timed.out.float().mean())
        rows.append(dict(snr_db=snr, bler=round(bler, 4), sf_per_s=round(sf_s, 1),
                         goodput_mbps=round(sf_s * (1 - bler) * cfg.tbs / 1e6, 1),
                         turbo_map_launches=(tdc.launches - launches) / iters))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"snr_sweep": rows, **_timing.stamp(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
