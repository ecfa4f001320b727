"""End-to-end PDSCH link: eNB encode -> OFDM -> AWGN -> UE decode.

Twin of the reference's `models/pdsch_link.py` (the pdsch_test /
phy_dl_test harnesses, `lib/src/phy/phch/test/pdsch_test.c:325`): a batch
axis of B subframes replaces the reference's sf_worker thread pipeline.
`use_kernel=True` runs the turbo decoder's MAP passes through the CUDA
kernel (the reference's `use_pallas=True`); the default (None) does so
when the samples lie on a CUDA device.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..ops import channel, ofdm
from ..phch import grid as grid_mod
from ..phch import pdsch, sch


@dataclasses.dataclass(frozen=True)
class LinkConfig:
    cell: grid_mod.CellConfig = grid_mod.CellConfig()
    sf_idx: int = 1
    rnti: int = 0x46
    qm: int = 2
    prb_mask: tuple = None  # default: all PRBs
    code_rate: float = 0.5  # target rate -> tbs derived from G
    snr_db: float = 10.0
    max_iter: int = 8
    # 32 = f32 LLRs end-to-end; 16 = the reference's default decoder width
    # (SRSLTE_TDEC_16BIT): quantized inputs + bf16 kernel storage
    llr_bits: int = 32

    def __post_init__(self):
        if self.prb_mask is None:
            object.__setattr__(self, "prb_mask", (1,) * self.cell.n_prb)

    @functools.cached_property
    def n_re(self) -> int:
        return grid_mod.nof_re(self.cell, self.sf_idx, self.prb_mask)

    @functools.cached_property
    def G(self) -> int:
        return self.n_re * self.qm

    @functools.cached_property
    def tbs(self) -> int:
        # largest multiple of 8 with rate <= code_rate (incl. TB CRC)
        return max(8, (int(self.G * self.code_rate) - 24) // 8 * 8)

    @functools.cached_property
    def sch_cfg(self) -> sch.SchConfig:
        return sch.SchConfig(tbs=self.tbs, G=self.G, Qm=self.qm, Nl=1)


def tx_subframe(payload: torch.Tensor, cfg: LinkConfig) -> torch.Tensor:
    """(B, tbs) bits -> (B, SF_LEN, 2) time-domain eNB subframe."""
    g = pdsch.encode(payload, cfg.sch_cfg, cfg.cell, cfg.sf_idx, cfg.rnti, cfg.prb_mask)
    return ofdm.modulate(g, cfg.cell.n_prb)


def rx_subframe(samples: torch.Tensor, cfg: LinkConfig, softbuf=None,
                use_kernel: bool | None = None):
    """(B, SF_LEN, 2) -> (payload (B, tbs), ok (B,), softbuf, chest)."""
    g = ofdm.demodulate(samples, cfg.cell.n_prb)
    return pdsch.decode(
        g, cfg.sch_cfg, cfg.cell, cfg.sf_idx, cfg.rnti, cfg.prb_mask,
        softbuf=softbuf, max_iter=cfg.max_iter, use_kernel=use_kernel,
        llr_bits=cfg.llr_bits,
    )


def link_step(payload: torch.Tensor, gen: torch.Generator, cfg: LinkConfig,
              use_kernel: bool | None = None):
    """Full eNB -> channel -> UE step; `gen` draws the channel noise."""
    tx = tx_subframe(payload, cfg)
    rx = channel.awgn(gen, tx, cfg.snr_db)
    out, ok, _, ch = rx_subframe(rx, cfg, use_kernel=use_kernel)
    return out, ok, ch.snr_db


def make_link_step(cfg: LinkConfig, use_kernel: bool | None = None):
    """link_step bound to cfg: step(payload, gen) -> (out, ok, snr_db)."""
    return functools.partial(link_step, cfg=cfg, use_kernel=use_kernel)


def make_ca_link_step(cfg: LinkConfig, n_cc: int, use_kernel: bool | None = None):
    """Carrier-aggregation link step: n_cc component carriers, carrier i a
    cell of its own with cell_id + 3 i (distinct scrambling c_init and CRS
    sequences, as the UE's per-SCell cc_worker sees —
    srsue/src/phy/scell/scell_recv.cc role).

    step(payloads (n_cc, B, tbs), gen) -> (out (n_cc, B, tbs), ok (n_cc, B));
    `gen` draws each carrier's channel noise in carrier order."""
    cfgs = [dataclasses.replace(cfg, cell=dataclasses.replace(
        cfg.cell, cell_id=cfg.cell.cell_id + 3 * i)) for i in range(n_cc)]

    def step(payloads: torch.Tensor, gen: torch.Generator):
        outs, oks = [], []
        for i, c in enumerate(cfgs):
            out, ok, _ = link_step(payloads[i], gen, c, use_kernel=use_kernel)
            outs.append(out)
            oks.append(ok)
        return torch.stack(outs), torch.stack(oks)

    return step
