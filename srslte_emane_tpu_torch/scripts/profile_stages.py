"""Per-stage time of the port's 20 MHz PDSCH bench cell.

Twin of the JAX repository's `scripts/profile_stages.py`: each stage of
the bench cell's transmit and receive chains (100 PRB, 64QAM, rate 0.55,
20 dB, the f32 decoder of the source's config) timed on its own on
device-resident inputs: one untimed call, then `iters` back-to-back calls
bracketed by CUDA events (and by synchronises on the host clock).  The
turbo decoder runs at a fixed 1, 2 and 8 iterations (no CRC, no early
stop) and with the CRC early stop at up to 8.  Each stage is the source's
`jax.jit` of it (`_timing.jit`), called on the previous stages' outputs
as the source calls it: on the card the untimed call captures the stage
as a CUDA graph and the timed calls replay it (12 graphs: 10 jit sites,
the fixed-iteration one jitted once per count); with --eager (and on the
CPU) each stage runs op by op.  The turbo stages decode with
`turbodecoder.turbo_decode(read=False)`, which leaves n_iter on the
device, as a graph must.

Usage: python -m srslte_emane_tpu_torch.scripts.profile_stages [batch] [iters] [--cpu] [--eager]

Prints one line per stage (CUDA-event ms per call; the host clock on the
CPU), the decode and encode rates, then one JSON line: {"stages": {stage:
{"ms", "host_ms", "turbo_map_launches", "turbo_map_v1_launches",
"first_s"}}, "decode_sf_per_s", "encode_sf_per_s", "batch", "tbs",
"captured_graphs"} plus "backend" and "device" (`_timing.profile_stage`'s
records).  "ms" is null on the CPU, which has no device clock.
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


TX_STAGES = ("tx: sch.encode_tb", "tx: scramble+mod+REmap+CRS", "tx: ofdm.modulate",
             "tx: full tx_subframe")
DEMOD, FRONT, DERM = "rx: ofdm.demodulate", "rx: chest+eq+demod+descr", "rx: de-rate-match"
EARLY, FULL = "rx: turbo early-stop max8", "rx: full rx_subframe"
FIXED_ITERS = (1, 2, 8)


def fixed(n_it: int, n_cb: int) -> str:
    return f"rx: turbo fixed {n_it} iter (C={n_cb}cb)"


def setup(batch: int, dev: torch.device) -> dict:
    """The source's cell (its config: the f32 decoder) and payload on `dev`."""
    cfg = pdsch_link.LinkConfig(cell=grid_mod.CellConfig(n_prb=100, cell_id=1, cfi=1),
                                qm=6, code_rate=0.55, snr_db=20.0, sf_idx=1)
    payload = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2, size=(batch, cfg.tbs), dtype=np.int8)).to(dev)
    return dict(cfg=cfg, payload=payload, steps=[])


def stages(ctx: dict, outs: dict, eager: bool = False):
    """Yields (label, zero-argument callable) in the source's order; each callable calls the stage's jit (`_timing.jit`, kept in
    ctx["steps"]) on the earlier stages' outputs, which it reads from
    `outs`, which the caller fills (outs[label] = the stage's output)
    before taking the next.  The channel between the TX and RX stages is
    drawn from a generator seeded 0, as the source draws it from its key."""
    cfg, payload = ctx["cfg"], ctx["payload"]
    scfg = cfg.sch_cfg
    dev = payload.device
    n_sym, nre = cfg.cell.n_sym, cfg.cell.nre
    # a table the mod_map and frontend steps read by address: their closures keep it
    re_idx = torch.from_numpy(
        grid_mod.pdsch_re_indices(cfg.cell, cfg.sf_idx, cfg.prb_mask)).to(dev)
    c_init = scrambling.pdsch_cinit(cfg.rnti, 0, cfg.sf_idx, cfg.cell.cell_id)

    def stage(fn, *args):
        step = _timing.jit(fn, eager)
        ctx["steps"].append(step)
        return lambda: step(*(a() if callable(a) else a for a in args))

    def out(label):  # an argument read when the stage runs
        return lambda: outs[label]

    # ---- TX stages ----
    def mod_map(cw):
        syms = modem.modulate(scrambling.scramble_bits(cw, c_init), modem.MOD_FROM_QM[scfg.Qm])
        flat = cplx.zeros((cw.shape[0], n_sym * nre), device=cw.device)
        flat[:, re_idx] = syms
        return pdsch.put_crs(flat.reshape(cw.shape[0], n_sym, nre, 2), cfg.cell, cfg.sf_idx)

    enc, mm, mod, tx = TX_STAGES
    yield enc, stage(lambda p: sch.encode_tb(p, scfg), payload)
    yield mm, stage(mod_map, out(enc))
    yield mod, stage(lambda g: ofdm.modulate(g, cfg.cell.n_prb), out(mm))
    yield tx, stage(lambda p: pdsch_link.tx_subframe(p, cfg), payload)

    # ---- channel ----
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rx = channel.awgn(gen, outs[mod], cfg.snr_db)

    # ---- RX stages ----
    yield DEMOD, stage(lambda s_: ofdm.demodulate(s_, cfg.cell.n_prb), rx)

    def frontend(rx_grid):
        ch = chest.estimate(rx_grid, cfg.cell, cfg.sf_idx)
        y = rx_grid.reshape(-1, n_sym * nre, 2)[:, re_idx]
        h = ch.ce.reshape(-1, n_sym * nre, 2)[:, re_idx]
        x_eq, csi = chest.equalize_zf(y, h)
        llr = modem.demod_soft(x_eq, modem.MOD_FROM_QM[scfg.Qm])
        llr = llr * torch.repeat_interleave(csi, scfg.Qm, dim=-1)
        return scrambling.scramble_llrs(llr, c_init)

    yield FRONT, stage(frontend, out(DEMOD))

    def derm(llrs):  # de-rate-match, every code-block group
        offs = np.concatenate([[0], np.cumsum(scfg.e_sizes)])
        softbuf = sch.init_softbuffer(llrs.shape[0], scfg, device=llrs.device)
        d = []
        for (kr, f, e), rs in sch._groups(scfg).items():
            e_llr = torch.cat([llrs[:, offs[r]: offs[r + 1]] for r in rs], dim=0)
            wbuf = torch.cat([softbuf[r] for r in rs], dim=0)
            wbuf = rm_turbo.rate_unmatch_rx(e_llr, wbuf, kr, f, e, 0, 0)
            d.append(rm_turbo.wbuf_to_d_llrs(wbuf, kr, f))
        return d

    yield DERM, stage(derm, out(FRONT))

    # turbo decode at a fixed 1, 2 and 8 iterations (crc=None), then early stop
    l0, l1, l2 = outs[DERM][0]
    kr = sorted(sch._groups(scfg).keys())[0][0]
    valid = torch.ones((l0.shape[0],), dtype=torch.bool, device=dev)
    for n_it in FIXED_ITERS:
        yield fixed(n_it, l0.shape[0] // payload.shape[0]), stage(
            lambda a, b, c_, v, n=n_it: turbodecoder.turbo_decode(a, b, c_, v, kr, n, None,
                                                                  read=False), l0, l1, l2, valid)
    yield EARLY, stage(lambda a, b, c_, v: turbodecoder.turbo_decode(
        a, b, c_, v, kr, 8, crc.LTE_CRC24B, read=False), l0, l1, l2, valid)
    yield FULL, stage(lambda s_: pdsch_link.rx_subframe(s_, cfg)[:2], rx)


def main(argv=None) -> int:
    ap = _timing.parser(__doc__, eager=True)
    ap.add_argument("batch", type=int, nargs="?", default=128)
    ap.add_argument("iters", type=int, nargs="?", default=20)
    args = ap.parse_args(argv)
    dev = _timing.device(args.cpu, "profile_stages")
    batch, iters = args.batch, args.iters
    ctx = setup(batch, dev)
    cfg = ctx["cfg"]
    scfg = cfg.sch_cfg
    s = scfg.segm
    print(f"# batch={batch} tbs={cfg.tbs} G={cfg.G} C={s.C} "
          f"cb_sizes={sorted(set(s.cb_sizes))} e={sorted(set(scfg.e_sizes))}")
    outs, res = {}, {}
    for label, fn in stages(ctx, outs, args.eager):
        n_it = next((n for n in FIXED_ITERS if label.startswith(f"rx: turbo fixed {n} ")), None)
        n = iters if n_it is None else max(4, iters // (2 * n_it))
        outs[label], rec = _timing.profile_stage(fn, n, dev)
        res[label] = {k: v if v is None else round(v, 4) for k, v in rec.items()}
        print(f"{label:34s} {_timing.stage_ms(rec):8.2f} ms/iter (host {rec['host_ms']:8.2f})",
              flush=True)
    _, ok = outs[FULL]
    _timing.require(bool(ok.all()), f"rx_subframe: {int((~ok).sum())} of {batch} CRCs failed")
    t = {label: _timing.stage_ms(r) for label, r in res.items()}
    dec, enc = batch * 1000.0 / t[FULL], batch * 1000.0 / t[TX_STAGES[-1]]
    print(f"# decode {dec:.0f} sf/s   encode {enc:.0f} sf/s")
    print(json.dumps({"stages": res, "decode_sf_per_s": round(dec, 1),
                      "encode_sf_per_s": round(enc, 1), "batch": batch, "tbs": cfg.tbs,
                      "captured_graphs": _timing.captured(ctx["steps"]), **_timing.stamp(dev)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
