"""TDD radio-frame loop: D/S/U subframes end to end through the waveform.

Twin of the reference's `models/tdd_frame.py` (the TDD paths of
`enb_dl.c`/`ue_dl.c`/`enb_ul.c` driven by srslte_sfidx_tdd_type,
phy_common.c:104): downlink on D subframes, DwPTS-truncated downlink on S,
uplink on U, with HARQ-ACK feedback at the k-set subframes of 36.213 Table
10.1.3.1-1.  The type pattern is host-side (static per sf_config); the
noise of every subframe comes from one `torch.Generator`.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import channel, ofdm
from ..phch import grid as grid_mod, pdsch, pusch, sch, tdd


@dataclasses.dataclass(frozen=True)
class TddFrameConfig:
    cell: grid_mod.CellConfig
    sf_config: int = 1
    ss_config: int = 7
    rnti: int = 0x46
    qm: int = 4
    ul_l_prb: int = 8

    def dl_cfg(self, sf_idx: int) -> sch.SchConfig:
        prb_mask = (1,) * self.cell.n_prb
        max_sym = tdd.pdsch_max_sym(self.sf_config, self.ss_config, sf_idx)
        n_re = grid_mod.nof_re(self.cell, sf_idx, prb_mask, max_sym)
        tbs = max(16, (n_re * self.qm // 3) // 8 * 8)
        return sch.SchConfig(tbs=tbs, G=n_re * self.qm, Qm=self.qm, Nl=1)

    def ul_cfg(self) -> sch.SchConfig:
        g = 12 * self.ul_l_prb * 12 * self.qm
        return sch.SchConfig(tbs=(g // 3) // 8 * 8, G=g, Qm=self.qm, Nl=1)


def run_frame(cfg: TddFrameConfig, dl_tbs: dict, ul_tbs: dict, gen: torch.Generator,
              snr_db: float = 20.0):
    """Run one 10-subframe TDD frame.

    dl_tbs: {sf_idx: (B, tbs)} payloads for D/S subframes;
    ul_tbs: {sf_idx: (B, tbs)} payloads for U subframes.
    Returns dict with per-sf decode results and the HARQ-ACK report map
    {ul_sf: [(dl_sf, ok (B,)), ...]} built from the 36.213 k-sets."""
    prb_mask = (1,) * cfg.cell.n_prb
    n_prb = cfg.cell.n_prb
    out = {"dl": {}, "ul": {}, "acks": {}}
    pending_acks = {}  # ack_sf -> list of (dl_sf, ok)
    for sf in range(10):
        t = tdd.sf_type(cfg.sf_config, sf)
        if t in ("D", "S") and sf in dl_tbs:
            scfg = cfg.dl_cfg(sf)
            max_sym = tdd.pdsch_max_sym(cfg.sf_config, cfg.ss_config, sf)
            g = pdsch.encode(dl_tbs[sf], scfg, cfg.cell, sf, cfg.rnti, prb_mask,
                             max_sym=max_sym)
            rx = channel.awgn(gen, ofdm.modulate(g, n_prb), snr_db)
            bits, ok, _, _ = pdsch.decode(ofdm.demodulate(rx, n_prb), scfg, cfg.cell, sf,
                                          cfg.rnti, prb_mask, max_sym=max_sym)
            out["dl"][sf] = (bits, ok)
            ack_sf = tdd.ack_subframe_for_dl(cfg.sf_config, sf) % 10
            pending_acks.setdefault(ack_sf, []).append((sf, ok))
        elif t == "U" and sf in ul_tbs:
            ucfg = cfg.ul_cfg()
            g = pusch.encode(ul_tbs[sf], ucfg, cfg.cell, sf, cfg.rnti, 0, cfg.ul_l_prb)
            rx = channel.awgn(gen, ofdm.modulate(g, n_prb), snr_db)
            bits, ok, _, _ = pusch.decode(ofdm.demodulate(rx, n_prb), ucfg, cfg.cell, sf,
                                          cfg.rnti, 0, cfg.ul_l_prb)
            out["ul"][sf] = (bits, ok)
        if t == "U" and sf in pending_acks:
            out["acks"][sf] = pending_acks.pop(sf)
    # k-sets can point into the next frame; report leftovers at their sf
    for ack_sf, items in pending_acks.items():
        out["acks"].setdefault(ack_sf, []).extend(items)
    return out
