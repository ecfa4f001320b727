"""Per-stage time of the port's 20 MHz PDSCH bench cell.

Twin of the JAX repository's `scripts/profile_stages.py`: each stage of
the bench cell's transmit and receive chains (100 PRB, 64QAM, rate 0.55,
20 dB, the f32 decoder of the source's config) timed on its own on
device-resident inputs: one untimed call, then `iters` back-to-back calls
bracketed by CUDA events (and by synchronises on the host clock).  The
turbo decoder runs at a fixed 1, 2 and 8 iterations (no CRC, no early
stop) and with the CRC early stop at up to 8.

Usage: python -m srslte_emane_tpu_torch.scripts.profile_stages [batch] [iters] [--cpu]

Prints one line per stage (CUDA-event ms per call; the host clock on the
CPU), the decode and encode rates, then one JSON line: {"stages": {stage:
{"ms", "host_ms"}}, "decode_sf_per_s", "encode_sf_per_s", "batch", "tbs"}
plus "backend" and "device".  "ms" is null on the CPU, which has no device
clock.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..models import pdsch_link
from ..ops import channel, cplx, modem, ofdm, scrambling
from ..ops.fec import crc, rm_turbo, turbodecoder
from ..phch import chest, grid as grid_mod, pdsch, sch
from . import _timing


def main(argv=None) -> int:
    ap = _timing.parser(__doc__)
    ap.add_argument("batch", type=int, nargs="?", default=128)
    ap.add_argument("iters", type=int, nargs="?", default=20)
    args = ap.parse_args(argv)
    dev = _timing.device(args.cpu, "profile_stages")
    batch, iters = args.batch, args.iters
    stages = {}

    def timeit(name, fn, n=iters):
        out = fn()
        host_ms, event_ms = _timing.per_call_ms(fn, n, dev)
        stages[name] = dict(ms=None if event_ms is None else round(event_ms, 4),
                            host_ms=round(host_ms, 4))
        print(f"{name:34s} {host_ms if event_ms is None else event_ms:8.2f} ms/iter "
              f"(host {host_ms:8.2f})", flush=True)
        return out, host_ms if event_ms is None else event_ms

    cfg = pdsch_link.LinkConfig(cell=grid_mod.CellConfig(n_prb=100, cell_id=1, cfi=1),
                                qm=6, code_rate=0.55, snr_db=20.0, sf_idx=1)
    scfg = cfg.sch_cfg
    s = scfg.segm
    print(f"# batch={batch} tbs={cfg.tbs} G={cfg.G} C={s.C} "
          f"cb_sizes={sorted(set(s.cb_sizes))} e={sorted(set(scfg.e_sizes))}")
    payload = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2, size=(batch, cfg.tbs), dtype=np.int8)).to(dev)

    # ---- TX stages ----
    cw, _ = timeit("tx: sch.encode_tb", lambda: sch.encode_tb(payload, scfg))
    re_idx = torch.from_numpy(
        grid_mod.pdsch_re_indices(cfg.cell, cfg.sf_idx, cfg.prb_mask)).to(dev)
    c_init = scrambling.pdsch_cinit(cfg.rnti, 0, cfg.sf_idx, cfg.cell.cell_id)
    n_sym, nre = cfg.cell.n_sym, cfg.cell.nre

    def mod_map():
        syms = modem.modulate(scrambling.scramble_bits(cw, c_init), modem.MOD_FROM_QM[scfg.Qm])
        flat = cplx.zeros((batch, n_sym * nre), device=dev)
        flat[:, re_idx] = syms
        return pdsch.put_crs(flat.reshape(batch, n_sym, nre, 2), cfg.cell, cfg.sf_idx)

    g, _ = timeit("tx: scramble+mod+REmap+CRS", mod_map)
    tx, _ = timeit("tx: ofdm.modulate", lambda: ofdm.modulate(g, cfg.cell.n_prb))
    _, t_tx = timeit("tx: full tx_subframe", lambda: pdsch_link.tx_subframe(payload, cfg))

    # ---- channel ----
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rx = channel.awgn(gen, tx, cfg.snr_db)

    # ---- RX stages ----
    rxg, _ = timeit("rx: ofdm.demodulate", lambda: ofdm.demodulate(rx, cfg.cell.n_prb))

    def frontend():
        ch = chest.estimate(rxg, cfg.cell, cfg.sf_idx)
        y = rxg.reshape(batch, n_sym * nre, 2)[:, re_idx]
        h = ch.ce.reshape(batch, n_sym * nre, 2)[:, re_idx]
        x_eq, csi = chest.equalize_zf(y, h)
        llr = modem.demod_soft(x_eq, modem.MOD_FROM_QM[scfg.Qm])
        llr = llr * torch.repeat_interleave(csi, scfg.Qm, dim=-1)
        return scrambling.scramble_llrs(llr, c_init)

    llrs, _ = timeit("rx: chest+eq+demod+descr", frontend)

    def derm():  # de-rate-match, every code-block group
        offs = np.concatenate([[0], np.cumsum(scfg.e_sizes)])
        softbuf = sch.init_softbuffer(batch, scfg, device=dev)
        out = []
        for (kr, f, e), rs in sch._groups(scfg).items():
            e_llr = torch.cat([llrs[:, offs[r]: offs[r + 1]] for r in rs], dim=0)
            wbuf = torch.cat([softbuf[r] for r in rs], dim=0)
            wbuf = rm_turbo.rate_unmatch_rx(e_llr, wbuf, kr, f, e, 0, 0)
            out.append(rm_turbo.wbuf_to_d_llrs(wbuf, kr, f))
        return out

    dl, _ = timeit("rx: de-rate-match", derm)

    # turbo decode at a fixed 1, 2 and 8 iterations (crc=None), then early stop
    l0, l1, l2 = dl[0]
    kr = sorted(sch._groups(scfg).keys())[0][0]
    nB = l0.shape[0]
    valid = torch.ones((nB,), dtype=torch.bool, device=dev)
    for n_it in (1, 2, 8):
        timeit(f"rx: turbo fixed {n_it} iter (C={nB // batch}cb)",
               lambda n=n_it: turbodecoder.turbo_decode(l0, l1, l2, valid, kr, n, None),
               n=max(4, iters // (2 * n_it)))
    timeit("rx: turbo early-stop max8",
           lambda: turbodecoder.turbo_decode(l0, l1, l2, valid, kr, 8, crc.LTE_CRC24B))
    (_, ok), t_rx = timeit("rx: full rx_subframe", lambda: pdsch_link.rx_subframe(rx, cfg)[:2])
    _timing.require(bool(ok.all()), f"rx_subframe: {int((~ok).sum())} of {batch} CRCs failed")

    dec, enc = batch * 1000.0 / t_rx, batch * 1000.0 / t_tx
    print(f"# decode {dec:.0f} sf/s   encode {enc:.0f} sf/s")
    print(json.dumps({"stages": stages, "decode_sf_per_s": round(dec, 1),
                      "encode_sf_per_s": round(enc, 1), "batch": batch, "tbs": cfg.tbs,
                      **_timing.stamp(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
