"""TTIs/s of the port's dynamic device-resident waveform block (runtime/waveblock_dyn.py).

Twin of the JAX repository's `scripts/bench_waveblock_dyn.py`: R rounds x
8 TTIs x n_ues of the dynamic PHY loop (per-TTI PDCCH DCI, the UE's blind
decode, PDSCH/PUSCH with 8-process IR-HARQ soft buffers, PUCCH HARQ-ACK
and PHICH) in one block step, reduced on the device to six counts.  With
cells > 1 the block runs that many independent cells (make_bench_step's
n_cells: each cell its own payloads, schedule, generator and HARQ state)
and the rate is the aggregate.  The payloads come from default_rng(0) and
stay on the device; cell c's schedule is make_schedule(seed=3 + c) and its
noise a torch.Generator seeded c (one generator seeded 0 for one cell).
The first block must pass every DL and UL CRC, detect every ACK and miss
no DCI.  On the card that first call also captures the block's round as a
CUDA graph, which every block then replays R times: its time is
`compile_s`, as the source's jit compile is.

Usage: python -m srslte_emane_tpu_torch.scripts.bench_waveblock_dyn
           [n_ues] [R] [iters] [runs] [cells] [--cpu]

Prints one JSON line with the source's keys plus "backend"; "device" is
the card's name.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ..phch import grid as grid_mod
from ..runtime import waveblock_dyn as wbd
from . import _timing


def dyn_block_config(n_ues: int, R: int) -> wbd.DynBlockConfig:
    """The source's dynamic block (`bench_waveblock_dyn.py:48-60`): 100 PRB,
    cfi 2, feasible RNTIs, DL at MCS 25, UL at MCS 20, 30 dB."""
    cell = grid_mod.CellConfig(n_prb=100, cell_id=1, cfi=2)
    return wbd.DynBlockConfig(
        cell=cell, rntis=wbd.feasible_rntis(cell, n_ues),
        dl_l_crbs={8: 11, 16: 5}.get(n_ues, 94 // n_ues),
        dl_mcs=25,  # 64QAM steady-state link-adaptation point
        ul_l_prb={8: 10, 16: 5}.get(n_ues, 80 // n_ues), ul_mcs=20,
        snr_db=(30.0,) * n_ues, R=R, llr_bits=16)


def main(argv=None) -> int:
    ap = _timing.parser(__doc__)
    for name, default in (("n_ues", 8), ("R", 20), ("iters", 5), ("runs", 3), ("cells", 1)):
        ap.add_argument(name, type=int, nargs="?", default=default)
    args = ap.parse_args(argv)
    dev = _timing.device(args.cpu, "bench_waveblock_dyn")
    n_ues, R, iters, n_runs, cells = args.n_ues, args.R, args.iters, args.runs, args.cells

    cfg = dyn_block_config(n_ues, R)
    bench = wbd.make_bench_step(cfg, n_cells=cells, device=dev)
    rng = np.random.default_rng(0)
    T = cfg.T

    def put(a):
        return torch.from_numpy(a if cells > 1 else a[0]).to(dev)

    dl_q = put(rng.integers(0, 2, (cells, T, n_ues, cfg.dl_tbs), dtype=np.int8))
    ul_q = put(rng.integers(0, 2, (cells, T, n_ues, cfg.ul_tbs), dtype=np.int8))
    scheds = [wbd.make_schedule(cfg, seed=3 + ci) for ci in range(cells)]
    rb_dl = put(np.stack([s[0] for s in scheds]))
    rb_ul = put(np.stack([s[1] for s in scheds]))
    gens = [torch.Generator(device=dev) for _ in range(cells)]
    for ci, g in enumerate(gens):
        g.manual_seed(ci)
    gen = gens if cells > 1 else gens[0]
    block = lambda: bench(dl_q, ul_q, rb_dl, rb_ul, gen, 0)

    _timing.sync(dev)
    t0 = time.perf_counter()
    out = block()
    _timing.sync(dev)
    compile_s = time.perf_counter() - t0
    d_ok, u_ok, a_ok, d_rtx, u_rtx, miss = (int(x) for x in out)
    tot = cells * T * n_ues
    _timing.require(d_ok == tot, f"DL CRCs failed: {d_ok}/{tot}")
    _timing.require(u_ok == tot, f"UL CRCs failed: {u_ok}/{tot}")
    _timing.require(a_ok == tot, f"ACKs missing: {a_ok}/{tot}")
    _timing.require(miss == 0, f"DCI misses at 30 dB: {miss}")

    r = _timing.median_rate(block, cells * T, iters, n_runs, dev)
    ttis_s, spread = r.median, r.spread_pct
    dl_mbps = ttis_s * n_ues * cfg.dl_tbs / 1e6
    ul_mbps = ttis_s * n_ues * cfg.ul_tbs / 1e6
    agg = f" x {cells} cells AGGREGATE" if cells > 1 else ""
    ev = "" if r.event_ms is None else f"; CUDA-event time {r.event_ms:.3f} ms/block"
    print(f"# dyn-block 100 PRB x {n_ues} UEs, T={T}{agg}: compile={compile_s:.1f}s "
          f"{ttis_s:.0f} TTIs/s (spread {spread:.1f}%) = {ttis_s / 1000.0:.1f}x real time; "
          f"DL {dl_mbps:.0f} Mb/s + UL {ul_mbps:.0f} Mb/s; per-TTI DCI x{2 * n_ues} "
          f"blind-decoded, 8-process IR-HARQ live; retransmissions DL {d_rtx} UL {u_rtx} in "
          f"the first block{ev}; device={_timing.device_name(dev)}", file=sys.stderr)
    print(json.dumps({
        "metric": "waveform_dyn_block_ttis_per_sec",
        "value": round(ttis_s, 1),
        "unit": "TTIs/s" if cells == 1 else "cell-TTIs/s aggregate",
        "vs_baseline": round(ttis_s / 1000.0, 3),
        "n_prb": 100, "n_ues": n_ues, "block_ttis": T, "n_cells": cells,
        "dl_mbps": round(dl_mbps, 1), "ul_mbps": round(ul_mbps, 1),
        "median_of": n_runs, "spread_pct": round(spread, 2),
        "compile_s": round(compile_s, 1),
        **_timing.stamp(dev),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
