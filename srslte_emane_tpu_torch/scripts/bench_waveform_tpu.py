"""TTIs/s of the port's device-resident SPS waveform block (runtime/waveblock.py).

Twin of the JAX repository's `scripts/bench_waveform_tpu.py`: T TTIs x
n_ues of the full PHY both ways (eNB PDSCH encode, AWGN, UE channel
estimation and decode, PUCCH ACK and SPS PUSCH, superposition, eNB
estimation and decode, the ACK matched filter) in one block step, reduced
on the device to three counts.  The payloads come from default_rng(0)
and stay on the device; the noise comes from a torch.Generator seeded 0.
The first block must pass every DL (per codeword with tm3) and UL CRC and
detect every ACK.  The 6th argument "tm3" switches the downlink to TM3
2x2 (two codewords per TTI and UE).

Usage: python -m srslte_emane_tpu_torch.scripts.bench_waveform_tpu
           [n_prb] [n_ues] [T] [iters] [runs] [tm3] [--cpu]

Prints one JSON line with the source's keys ("value" = the median TTIs/s
of `runs` runs of `iters` blocks, host clock bracketed by synchronises)
plus "backend"; "device" is the card's name.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ..phch import grid as grid_mod, pdcch, pusch
from ..runtime import waveblock
from . import _timing


def sps_block_config(n_prb: int, n_ues: int, T: int, tm3: bool = False) -> waveblock.BlockConfig:
    """The source's SPS steady state (`bench_waveform_tpu.py:50-69`): cfi 1,
    DL packed around the centre PRBs at MCS 20, UL at MCS 20 on the widest
    valid equal width, one PUCCH resource per UE after the CCEs, 30 dB."""
    cell = grid_mod.CellConfig(n_prb=n_prb, cell_id=1, cfi=1, n_ports=2 if tm3 else 1)
    n_cce = pdcch.n_cce(cell)
    c0, c1 = waveblock.centre_prbs(n_prb)
    dl_starts, dl_w = waveblock._pack_segments(n_prb, n_ues, [(0, c0), (c1, n_prb)])
    ul_w = max(1, (n_prb - 2) // n_ues)
    while ul_w > 1 and not pusch.valid_n_prb(ul_w):
        ul_w -= 1
    return waveblock.BlockConfig(
        cell=cell, rntis=tuple(70 + i for i in range(n_ues)),
        dl_rb_start=dl_starts, dl_l_crbs=dl_w,
        dl_mcs=20,  # 64QAM-class steady-state link adaptation point
        ul_rb_start=tuple(1 + ul_w * i for i in range(n_ues)),
        ul_l_prb=ul_w, ul_mcs=20,
        ack_res=tuple(n_cce + i for i in range(n_ues)),
        snr_db=(30.0,) * n_ues, T=T, llr_bits=16, tm3=tm3)


def check_counts(counts, want_dl: int, want: int):
    """The block's gate on its (DL CRCs, UL CRCs, ACKs) counts."""
    d_ok, u_ok, a_ok = (int(x) for x in counts)
    _timing.require(d_ok == want_dl, f"DL CRCs failed: {d_ok}/{want_dl}")
    _timing.require(u_ok == want, f"UL CRCs failed: {u_ok}/{want}")
    _timing.require(a_ok == want, f"ACKs missing: {a_ok}/{want}")


def main(argv=None) -> int:
    ap = _timing.parser(__doc__)
    for name, default in (("n_prb", 100), ("n_ues", 8), ("T", 20), ("iters", 10), ("runs", 3)):
        ap.add_argument(name, type=int, nargs="?", default=default)
    ap.add_argument("mode", nargs="?", default="", choices=("", "tm3"))
    args = ap.parse_args(argv)
    dev = _timing.device(args.cpu, "bench_waveform_tpu")
    n_prb, n_ues, T, iters, n_runs = args.n_prb, args.n_ues, args.T, args.iters, args.runs
    tm3 = args.mode == "tm3"

    cfg = sps_block_config(n_prb, n_ues, T, tm3)
    bench = waveblock.make_bench_step(cfg, sfn0=4, device=dev)
    rng = np.random.default_rng(0)
    n_cw = 2 if tm3 else 1
    dl_shape = (T, n_ues, 2, cfg.dl_tbs) if tm3 else (T, n_ues, cfg.dl_tbs)
    dl = torch.from_numpy(rng.integers(0, 2, dl_shape, dtype=np.int8)).to(dev)
    ul = torch.from_numpy(rng.integers(0, 2, (T, n_ues, cfg.ul_tbs), dtype=np.int8)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    block = lambda: bench(dl, ul, gen, 0)

    _timing.sync(dev)
    t0 = time.perf_counter()
    counts = block()
    _timing.sync(dev)
    compile_s = time.perf_counter() - t0
    check_counts(counts, T * n_ues * n_cw, T * n_ues)

    r = _timing.median_rate(block, T, iters, n_runs, dev)
    ttis_s, spread = r.median, r.spread_pct
    dl_mbps = ttis_s * n_ues * n_cw * cfg.dl_tbs / 1e6
    ul_mbps = ttis_s * n_ues * cfg.ul_tbs / 1e6
    ev = "" if r.event_ms is None else f"; CUDA-event time {r.event_ms:.3f} ms/block"
    print(f"# waveform-block {n_prb} PRB x {n_ues} UEs, T={T}{' TM3 2x2' if tm3 else ''}: "
          f"compile={compile_s:.1f}s {ttis_s:.0f} TTIs/s (spread {spread:.1f}%) = "
          f"{ttis_s / 1000.0:.1f}x real time; cell DL {dl_mbps:.0f} Mb/s + UL {ul_mbps:.0f} "
          f"Mb/s{ev} device={_timing.device_name(dev)}", file=sys.stderr)
    print(json.dumps({
        "metric": "waveform_block_tm3_ttis_per_sec" if tm3 else "waveform_block_ttis_per_sec",
        "value": round(ttis_s, 1),
        "unit": "TTIs/s",
        "vs_baseline": round(ttis_s / 1000.0, 3),
        "n_prb": n_prb, "n_ues": n_ues, "block_ttis": T,
        "dl_mbps": round(dl_mbps, 1), "ul_mbps": round(ul_mbps, 1),
        "median_of": n_runs, "spread_pct": round(spread, 2),
        "compile_s": round(compile_s, 1),
        **_timing.stamp(dev),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
