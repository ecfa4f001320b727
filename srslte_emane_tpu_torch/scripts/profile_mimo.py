"""Stage-level profile of the 2x2 MIMO TM3 decode path.

Twin of the JAX repository's `scripts/profile_mimo.py`: the 20 MHz 2x2 TM3
cell (100 PRB, cell_id 7, 2 ports, cfi 1, 64QAM at code rate 0.5 per
codeword, sf 1, RNTI 0x46) through a flat channel N(0, 1) + 3.5 I per row
at 30 dB, drawn as the source draws it (one default_rng(0) stream for the
payloads then the channel; its jax.random key 2 becomes a torch.Generator
seeded 2).  Six stages, each timed on its own on the previous stage's
output:

  - `pdsch.estimate_mimo`;
  - take + effective channel (the per-RE TM3 precoder W D(i) U as torch
    einsums, as the source builds it inline) + `mimo.decode_zf2` +
    `mimo.layer_demap`;
  - soft demod + CSI weighting + descrambling of both codewords;
  - `sch.decode_tb` once per codeword, then once over both merged (2B rows);
  - `pdsch.decode_tm` in full, whose every CRC must pass (the source's
    assertion).

Each stage, and the source's two set-up jits (the encode and the
demodulation of the received grid), is its `jax.jit` (`_timing.jit`),
called on the earlier stages' outputs as the source calls it: on the card
one CUDA graph each (8 in all), captured at its first call and replayed
at every call after it; with --eager (and on the CPU) op by op.  The
decodes leave n_iter on the device (`sch.decode_tb(read=False)`), as a
graph must.

Usage: python -m srslte_emane_tpu_torch.scripts.profile_mimo [batch] [iters] [--cpu] [--eager]

Each stage: one untimed call, then `iters` calls (CUDA events on the card,
the host clock on the CPU).  Prints the source's lines, then one JSON line:
{"stages": {label: {"ms", "host_ms", "turbo_map_launches",
"turbo_map_v1_launches", "first_s"}}, "sf_per_s", "mb_per_s",
"stage_sum_ms", "full_ms", "batch", "tbs", "G", "C", "n_re",
"captured_graphs"} plus "backend" and "device".
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..ops import channel, cplx, mimo, modem, ofdm, scrambling
from ..phch import grid as grid_mod, pdsch, sch
from . import _timing

SF_IDX, RNTI = 1, 0x46
EST = "estimate_mimo"
FRONT = "take+heff+zf2+demap"
DEM = "demod+csi+descramble x2"
SEP = "decode_tb x2 (separate)"
MERGED = "decode_tb (merged 2B)"
FULL = "decode_tm full"


def setup(batch: int, dev: torch.device, n_prb: int = 100, eager: bool = False) -> dict:
    """The source's cell, payloads and received grids (rg2: (batch, 2, 14,
    NRE, 2)) on `dev`, through its two set-up jits ("steps")."""
    rng = np.random.default_rng(0)
    cell = grid_mod.CellConfig(n_prb=n_prb, cell_id=7, n_ports=2, cfi=1)
    prb_mask = (1,) * n_prb
    n_re = grid_mod.nof_re(cell, SF_IDX, prb_mask)
    qm = 6
    cfgs = [sch.SchConfig(tbs=(int(n_re * qm * 0.5) - 24) // 8 * 8, G=n_re * qm, Qm=qm, Nl=1)
            for _ in range(2)]
    tbs_list = [torch.from_numpy(rng.integers(0, 2, (batch, c.tbs), dtype=np.int8)).to(dev)
                for c in cfgs]
    enc = _timing.jit(lambda a, b: ofdm.modulate(
        pdsch.encode_tm([a, b], cfgs, cell, SF_IDX, RNTI, prb_mask, "tm3"), n_prb), eager)
    tx2 = enc(*tbs_list)
    h = (rng.normal(size=(batch, 2, 2)) + 1j * rng.normal(size=(batch, 2, 2))).astype(np.complex64)
    h = h + 3.5 * np.eye(2)[None]
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    rx2 = channel.mimo_flat(gen, tx2, cplx.from_numpy(h, dev), 30.0)
    demod = _timing.jit(lambda s_: ofdm.demodulate(s_, n_prb), eager)
    return dict(cell=cell, prb_mask=prb_mask, n_re=n_re, qm=qm, cfgs=cfgs, tbs_list=tbs_list,
                tx2=tx2, rg2=demod(rx2), steps=[enc, demod])


def stages(ctx: dict, outs: dict, eager: bool = False):
    """Yields (label, zero-argument callable) in the source's order; each
    callable calls the stage's jit (`_timing.jit`, kept in ctx["steps"]) on
    the earlier stages' outputs, which it reads from `outs`, which the
    caller fills (outs[label] = the stage's output) before taking the
    next.  A jit's arguments are tensors: the source's lists of two come
    as two arguments."""
    cell, cfgs, qm = ctx["cell"], ctx["cfgs"], ctx["qm"]
    rg2 = ctx["rg2"]
    dev = rg2.device
    # tables the front step reads by address: its closure keeps them
    re_idx = torch.from_numpy(
        grid_mod.pdsch_re_indices(cell, SF_IDX, ctx["prb_mask"]).astype(np.int64)).to(dev)
    # the per-RE precoder W D(i) U as (m, tx, layer) real and imaginary parts
    w = pdsch._layer_weights("tm3", 0, len(re_idx), dev).permute(2, 0, 1, 3)
    wr, wi = w[..., 0].contiguous(), w[..., 1].contiguous()

    def jit(fn):
        step = _timing.jit(fn, eager)
        ctx["steps"].append(step)
        return step

    est = jit(lambda g: pdsch.estimate_mimo(g, cell, SF_IDX, 2))
    yield EST, lambda: est(rg2)

    def front(rx_grids, ce):
        take = lambda a: a.reshape(a.shape[:-3] + (cell.n_sym * cell.nre, 2))[..., re_idx, :]
        y, hh = take(rx_grids), take(ce)
        hr, hi = hh[..., 0], hh[..., 1]
        heff_r = torch.einsum("brtm,mtl->brlm", hr, wr) - torch.einsum("brtm,mtl->brlm", hi, wi)
        heff_i = torch.einsum("brtm,mtl->brlm", hr, wi) + torch.einsum("brtm,mtl->brlm", hi, wr)
        x, csi = mimo.decode_zf2(y, torch.stack([heff_r, heff_i], dim=-1), noise=None)
        return mimo.layer_demap(x, 2), [csi[..., 0, :], csi[..., 1, :]]

    front_step = jit(front)
    yield FRONT, lambda: front_step(rg2, outs[EST][0])

    def dem(s0, s1, c0, c1):
        out = []
        for q, (stream, csi) in enumerate(((s0, c0), (s1, c1))):
            llr = modem.demod_soft(stream, modem.MOD_FROM_QM[qm])
            llr = llr * torch.repeat_interleave(csi, qm, dim=-1)
            out.append(scrambling.scramble_llrs(
                llr, scrambling.pdsch_cinit(RNTI, q, SF_IDX, cell.cell_id)))
        return out

    dem_step = jit(dem)
    yield DEM, lambda: dem_step(*outs[FRONT][0], *outs[FRONT][1])
    sep = jit(lambda l0, l1: [sch.decode_tb(l, cfgs[q], None, 8, read=False)[:2]
                              for q, l in enumerate((l0, l1))])
    yield SEP, lambda: sep(*outs[DEM])
    merged = jit(lambda l0, l1: sch.decode_tb(torch.cat([l0, l1], dim=0), cfgs[0], None, 8,
                                              read=False)[:2])
    yield MERGED, lambda: merged(*outs[DEM])
    full = jit(lambda g: pdsch.decode_tm(g, cfgs, cell, SF_IDX, RNTI, ctx["prb_mask"],
                                         "tm3")[:2])
    yield FULL, lambda: full(rg2)


def main(argv=None) -> int:
    ap = _timing.parser(__doc__, eager=True)
    ap.add_argument("batch", type=int, nargs="?", default=32)
    ap.add_argument("iters", type=int, nargs="?", default=20)
    args = ap.parse_args(argv)
    dev = _timing.device(args.cpu, "profile_mimo")
    batch, iters = args.batch, args.iters
    ctx = setup(batch, dev, eager=args.eager)
    cfgs = ctx["cfgs"]
    s = cfgs[0].segm
    print(f"# batch={batch} tbs={cfgs[0].tbs} G={cfgs[0].G} C={s.C} "
          f"n_re={ctx['n_re']} kernel={dev.type == 'cuda'}", flush=True)
    outs, res = {}, {}
    for label, fn in stages(ctx, outs, args.eager):
        outs[label], res[label] = _timing.profile_stage(fn, iters, dev)
        print(f"{label:40s} {_timing.stage_ms(res[label]):8.2f} ms/iter", flush=True)
    _timing.require(all(bool(ok.all()) for ok in outs[FULL][1]), "CRC failed")
    _timing.require(all(torch.equal(p, t) for p, t in zip(outs[FULL][0], ctx["tbs_list"])),
                    "a codeword passed its CRC with wrong bits")
    t = {label: _timing.stage_ms(r) for label, r in res.items()}
    total_bits = sum(c.tbs for c in cfgs)
    sf_s = batch / (t[FULL] / 1e3)
    mb_s = batch * total_bits / (t[FULL] / 1e3) / 1e6
    stage_sum = t[EST] + t[FRONT] + t[DEM] + t[SEP]
    print(f"# full: {sf_s:.0f} sf/s, {mb_s:.0f} Mb/s")
    print(f"# stage sum: {stage_sum:.2f} ms (vs full {t[FULL]:.2f})")
    print(json.dumps({"stages": res, "sf_per_s": sf_s, "mb_per_s": mb_s,
                      "stage_sum_ms": stage_sum, "full_ms": t[FULL], "batch": batch,
                      "tbs": cfgs[0].tbs, "G": cfgs[0].G, "C": s.C, "n_re": ctx["n_re"],
                      "captured_graphs": _timing.captured(ctx["steps"]), **_timing.stamp(dev)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
