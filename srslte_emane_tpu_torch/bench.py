"""Benchmark of record of the port: 20 MHz downlink PDSCH subframes/s on one card.

Twin of the JAX repository's root `bench.py`: the same cell (100 PRB,
cell_id 1, cfi 1, sf 1, 64QAM at code rate 0.55, 20 dB, batch 128,
`llr_bits=16`: TBS 49,472 in 9 code blocks) through the port's full UE
receive chain (OFDM demodulation, CRS channel estimation, ZF equalisation,
soft demodulation, descrambling, de-rate-matching, turbo decoding through
the `turbo_map` CUDA kernel with CRC early stop).  The payload comes from
numpy's default_rng(0) and stays on the card; the noise comes from a
torch.Generator seeded 0.  The first call must pass every CRC and return
the payload bit for bit.  There is no fallback: if the kernel does not
build or launch, the run fails.  As bench.py jits its encode and its
decode, both run as `runtime.graphs.jit` steps: on the card the first call
captures each as a CUDA graph, and every call replays it.

Usage: python -m srslte_emane_tpu_torch.bench [batch] [iters] [n_runs] [llr_bits] [--cpu]

Prints one JSON line: bench.py's keys ("value" = the median decode rate
of n_runs runs of `iters` calls, host clock bracketed by synchronises)
plus "backend", "device", "device_ms" (the CUDA-event time per decode
call in the same runs, null on the CPU) and "captured_graphs" (2 on the
card: the encode's and the decode's; 0 on the CPU).  "compile_s" is the
first call, the kernel's build and the decode's warm-up and capture
included; "cache_state" is "warm" when the kernel's library was already
under build/ and "cold" when this run built it (null on the CPU, which
runs the kernel's plain version).  The stderr line adds
the encode rate and the decode's kernel time from torch.profiler.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from .models import pdsch_link
from .ops import channel
from .phch import grid as grid_mod
from .runtime import graphs
from .scripts import _timing


def bench_config(llr_bits: int = 16) -> pdsch_link.LinkConfig:
    """bench.py:46-56: 20 MHz SISO 64QAM, rate ~0.55, 20 dB."""
    return pdsch_link.LinkConfig(
        cell=grid_mod.CellConfig(n_prb=100, cell_id=1, cfi=1), qm=6, code_rate=0.55,
        snr_db=20.0, sf_idx=1, llr_bits=llr_bits)


def main(argv=None) -> int:
    ap = _timing.parser(__doc__)
    ap.add_argument("batch", type=int, nargs="?", default=128)
    ap.add_argument("iters", type=int, nargs="?", default=30)
    ap.add_argument("n_runs", type=int, nargs="?", default=3)
    ap.add_argument("llr_bits", type=int, nargs="?", default=16)
    args = ap.parse_args(argv)
    dev = _timing.device(args.cpu, "bench")
    batch, iters, n_runs = args.batch, args.iters, args.n_runs

    cfg = bench_config(args.llr_bits)
    payload = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2, size=(batch, cfg.tbs), dtype=np.int8)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tx_fn = graphs.jit(lambda p: pdsch_link.tx_subframe(p, cfg))
    rx_samples = channel.awgn(gen, tx_fn(payload), cfg.snr_db)
    rx_fn = graphs.jit(lambda s: pdsch_link.rx_subframe(s, cfg)[:2])
    decode = lambda: rx_fn(rx_samples)

    _timing.sync(dev)
    t0 = time.perf_counter()
    out, ok = decode()
    _timing.sync(dev)
    compile_s = time.perf_counter() - t0
    _timing.require(bool(ok.all()), f"decode failed at bench SNR: {ok.cpu().numpy()}")
    _timing.require(torch.equal(out, payload), "decoded payload differs")
    cache_state = None
    if dev.type == "cuda":
        from .ops.fec import turbodecoder_cuda as tdc

        cache_state = "warm" if tdc.build(tdc.SOURCE).seconds == 0.0 else "cold"

    sf_per_s, spread_pct, rates, device_ms, _ = _timing.median_rate(
        lambda: decode()[1], batch, iters, n_runs, dev, check=lambda ok_: bool(ok_.all()))

    # secondary: encode rate, the waveform reduced to a scalar on the device
    encode = lambda: tx_fn(payload).abs().sum()
    s = float(encode())
    _timing.require(np.isfinite(s) and s > 0.0, f"encode gave {s}")
    enc_sf_per_s = _timing.median_rate(encode, batch, iters, 1, dev).median
    kernels = _timing.kernel_time(decode, dev)

    mbps = sf_per_s * cfg.tbs / 1e6
    dev_txt = "" if device_ms is None else f" device={device_ms:.3f} ms/call (CUDA events)"
    ker_txt = "" if kernels is None else (f" kernels={kernels[0]:.3f} ms in {kernels[1]} "
                                          f"launches/call (torch.profiler)")
    print(f"# compile={compile_s:.1f}s ({cache_state} cache) "
          f"decode={sf_per_s:.1f} sf/s median of {n_runs} "
          f"(spread {spread_pct:.1f}%: {[round(r) for r in rates]}) "
          f"({mbps:.1f} Mb/s payload) encode={enc_sf_per_s:.1f} sf/s{dev_txt}{ker_txt} "
          f"tbs={cfg.tbs} batch={batch} device={_timing.device_name(dev)}", file=sys.stderr)
    print(json.dumps({
        "metric": "pdsch_20mhz_decode_subframes_per_sec_per_chip",
        "value": round(sf_per_s, 2),
        "unit": "subframes/s",
        "vs_baseline": round(sf_per_s / 1000.0, 3),
        "median_of": n_runs,
        "spread_pct": round(spread_pct, 2),
        "cache_state": cache_state,
        "compile_s": round(compile_s, 1),
        "device_ms": None if device_ms is None else round(device_ms, 3),
        "captured_graphs": len(tx_fn.graphs) + len(rx_fn.graphs),
        **_timing.stamp(dev),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
