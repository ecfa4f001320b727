"""UE downlink receiver: the `ue_dl.c` equivalent.

Twin of the reference's `models/ue_dl.py` (`lib/src/phy/ue/ue_dl.c`:
decode_fft_estimate (OFDM + chest), PCFICH, PDCCH blind search
(ue_dl.c:422-478), PDSCH/PHICH decode (ue_dl.c:334-533); driven per TTI by
cc_worker::work_dl_regular, cc_worker.cc:209).  The blind search runs
batched (all candidates at once); PDSCH decodes against the grant's static
shape, and the decoded PCFICH is reported for the caller to check against
the configured CFI.  `use_kernel` is the turbo decoder's, as in
models/pdsch_link: None (default) takes the CUDA MAP kernel for samples on
a CUDA device.
"""

from __future__ import annotations

import typing

import torch

from ..ops import ofdm
from ..phch import chest, dci as dci_mod
from ..phch import pcfich as pcfich_mod
from ..phch import pdcch as pdcch_mod
from ..phch import pdsch as pdsch_mod
from ..phch import phich as phich_mod
from .enb_dl import DlSubframeConfig


class UeDlResult(typing.NamedTuple):
    cfi: torch.Tensor  # (B,) detected CFI
    dci_found: torch.Tensor  # (B, n_grants) blind search hit for each grant
    payloads: list  # per grant: (B, tbs) bits
    crc_ok: list  # per grant: (B,)
    snr_db: torch.Tensor
    phich: torch.Tensor  # (B, groups, 8) soft ACK metrics (or None)


def decode_subframe(samples: torch.Tensor, cfg: DlSubframeConfig, softbufs=None,
                    max_iter: int = 8, with_phich: bool = False,
                    use_kernel: bool | None = None):
    """samples: (B, SF_LEN, 2) -> (UeDlResult, per-grant HARQ soft buffers)."""
    cell, sf = cfg.cell, cfg.sf_idx
    rx_grid = ofdm.demodulate(samples, cell.n_prb)
    ch = chest.estimate(rx_grid, cell, sf)
    cfi_det, _ = pcfich_mod.decode(rx_grid, ch.ce, cell, sf)
    founds, payloads, oks = [], [], []
    if softbufs is None:
        softbufs = [None] * len(cfg.grants)
    new_bufs = []
    dci_len = dci_mod.format0_1a_len(cell.n_prb)
    for gi, (rnti, prb_mask, qm, tbs, l_aggr, cce_start) in enumerate(cfg.grants):
        _, ok_c, cands = pdcch_mod.blind_search(rx_grid, ch.ce, cell, sf, rnti, dci_len)
        founds.append(ok_c[:, cands.index((l_aggr, cce_start))])
        payload, ok, sb, _ = pdsch_mod.decode(
            rx_grid, cfg.sch_cfg(gi), cell, sf, rnti, prb_mask,
            softbuf=softbufs[gi], max_iter=max_iter, use_kernel=use_kernel)
        payloads.append(payload)
        oks.append(ok)
        new_bufs.append(sb)
    ph = None
    if with_phich and cfg.phich_groups:
        ph = phich_mod.decode(rx_grid, ch.ce, cell, sf)
    return UeDlResult(cfi_det, torch.stack(founds, 1) if founds else None,
                      payloads, oks, ch.snr_db, ph), new_bufs
