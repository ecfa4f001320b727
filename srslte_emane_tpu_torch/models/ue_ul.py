"""UE uplink subframe builder + eNB uplink receiver composites.

Twin of the reference's `models/ue_ul.py` (`lib/src/phy/ue/ue_ul.c`:
PUSCH/PUCCH/SRS encode into one SC-FDMA subframe; `lib/src/phy/enb/
enb_ul.c`: FFT + chest_ul + get_pucch/get_pusch), batched over B subframes.
`use_kernel=True` runs the PUSCH turbo decoder's MAP passes through the
CUDA kernels (the reference's `use_pallas=True`; the default, None, does
so when the samples lie on a CUDA device); `llr_bits` is the
decoder's storage width, as in models/pdsch_link.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import cplx, ofdm
from ..phch import grid as grid_mod, pucch as pucch_mod, pusch as pusch_mod, \
    sch, srs as srs_mod


@dataclasses.dataclass(frozen=True)
class UlSubframeConfig:
    """Static shape of one TTI's uplink."""
    cell: grid_mod.CellConfig
    sf_idx: int
    rnti: int = 0
    # PUSCH grant (l_prb 0 = no data this TTI)
    rb_start: int = 0
    l_prb: int = 0
    qm: int = 4
    tbs: int = 0
    # PUCCH resources
    n_pucch_1: int = -1  # format 1a ACK resource (-1 = absent)
    n_pucch_2: int = -1  # format 2 CQI resource
    # SRS (last symbol)
    srs_rb_start: int = -1
    srs_l_prb: int = 0

    @property
    def sch_cfg(self) -> sch.SchConfig:
        g = 12 * self.l_prb * pusch_mod.N_DATA_SYMS * self.qm
        return sch.SchConfig(tbs=self.tbs, G=g, Qm=self.qm, Nl=1)


def build_subframe(cfg: UlSubframeConfig, tb_bits=None, ack_bits=None,
                   cqi_bits=None) -> torch.Tensor:
    """Compose one UL subframe grid and SC-FDMA-modulate it.

    tb_bits (B, tbs) PUSCH payload; ack_bits (B, 2) cf symbol for format 1a;
    cqi_bits (B, <=13) for format 2.  Returns (B, SF_LEN, 2)."""
    cell = cfg.cell
    x = next(x for x in (tb_bits, ack_bits, cqi_bits) if x is not None)
    grid = cplx.zeros((x.shape[0], grid_mod.N_SYM, cell.nre), device=x.device)
    if tb_bits is not None and cfg.l_prb:
        grid = pusch_mod.encode(tb_bits, cfg.sch_cfg, cell, cfg.sf_idx,
                                cfg.rnti, cfg.rb_start, cfg.l_prb, grid=grid)
    if ack_bits is not None and cfg.n_pucch_1 >= 0:
        grid = pucch_mod.encode_f1(ack_bits, cell, cfg.sf_idx, cfg.n_pucch_1, grid)
    if cqi_bits is not None and cfg.n_pucch_2 >= 0:
        grid = pucch_mod.encode_f2(cqi_bits, cell, cfg.sf_idx, cfg.n_pucch_2, grid)
    if cfg.srs_rb_start >= 0 and cfg.srs_l_prb:
        grid = srs_mod.put_srs(grid, cell, cfg.sf_idx, cfg.srs_rb_start, cfg.srs_l_prb)
    return ofdm.modulate(grid, cell.n_prb)


def enb_receive(samples: torch.Tensor, cfg: UlSubframeConfig, softbuf=None,
                n_cqi_bits: int = 0, use_kernel: bool | None = None, llr_bits: int = 32) -> dict:
    """eNB-side composite UL receive: OFDM demod then per-channel decode.

    Returns dict with pusch (payload, ok), pucch_ack (corr), pucch_cqi,
    srs channel estimate — whichever resources are configured."""
    cell = cfg.cell
    rx_grid = ofdm.demodulate(samples, cell.n_prb)
    out = {}
    if cfg.l_prb:
        payload, ok, sb, noise = pusch_mod.decode(
            rx_grid, cfg.sch_cfg, cell, cfg.sf_idx, cfg.rnti, cfg.rb_start, cfg.l_prb,
            softbuf=softbuf, use_kernel=use_kernel, llr_bits=llr_bits)
        out["pusch"] = (payload, ok)
        out["softbuf"] = sb
        out["noise"] = noise
    if cfg.n_pucch_1 >= 0:
        corr, energy = pucch_mod.detect_f1(rx_grid, cell, cfg.sf_idx, cfg.n_pucch_1)
        out["pucch_ack"] = corr
        out["pucch_energy"] = energy
    if cfg.n_pucch_2 >= 0 and n_cqi_bits:
        bits, _ = pucch_mod.decode_f2(rx_grid, cell, cfg.sf_idx, cfg.n_pucch_2, n_cqi_bits)
        out["pucch_cqi"] = bits
    if cfg.srs_rb_start >= 0 and cfg.srs_l_prb:
        out["srs_ce"] = srs_mod.estimate_srs(rx_grid, cell, cfg.sf_idx,
                                             cfg.srs_rb_start, cfg.srs_l_prb)
    return out
