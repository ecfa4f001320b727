"""eNB downlink subframe assembly: the `enb_dl.c` equivalent.

Twin of the reference's `models/enb_dl.py` (`lib/src/phy/enb/enb_dl.c`:
put_base (CRS/PSS/SSS/PBCH) + put_pcfich/pdcch/pdsch/phich -> gen_signal
IFFT, enb_dl.c:342-458).  One call builds complete batched subframes from a
TTI's scheduling decisions, on the device of its inputs.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from ..ops import cplx, ofdm
from ..phch import dci as dci_mod
from ..phch import grid as grid_mod
from ..phch import pbch as pbch_mod
from ..phch import pcfich as pcfich_mod
from ..phch import pdcch as pdcch_mod
from ..phch import pdsch as pdsch_mod
from ..phch import phich as phich_mod
from ..phch import sch, sync as sync_mod


@dataclasses.dataclass(frozen=True)
class DlSubframeConfig:
    """Static shape of one TTI's downlink."""
    cell: grid_mod.CellConfig
    sf_idx: int
    # PDSCH grants: (rnti, prb_mask, Qm, tbs, l_aggr, cce_start)
    grants: tuple = ()
    with_pbch_sfn: int = -1  # >=0: include PBCH for this SFN
    phich_groups: int = 0

    def sch_cfg(self, gi: int) -> sch.SchConfig:
        rnti, prb_mask, qm, tbs, _, _ = self.grants[gi]
        n_re = grid_mod.nof_re(self.cell, self.sf_idx, prb_mask)
        return sch.SchConfig(tbs=tbs, G=n_re * qm, Qm=qm, Nl=1)


def build_subframe(cfg: DlSubframeConfig, tb_payloads: typing.Sequence,
                   mib_bits=None, acks=None, device=None) -> torch.Tensor:
    """Returns time-domain samples (B, SF_LEN, 2).

    tb_payloads: list matching cfg.grants of (B, tbs) bit tensors;
    mib_bits (B, 24) and acks (B, groups, 8) tensors where used.  The batch
    and the device come from the payloads, else from mib_bits; with
    neither, `device` must be given (B = 1)."""
    cell, sf = cfg.cell, cfg.sf_idx
    if tb_payloads:
        B, device = tb_payloads[0].shape[0], tb_payloads[0].device
    elif mib_bits is not None:
        B, device = mib_bits.shape[0], mib_bits.device
    elif device is None:
        raise ValueError("build_subframe: no payload or MIB to take the device from; "
                         "pass device=")
    else:
        B = 1
    grid = cplx.zeros((B, grid_mod.N_SYM, cell.nre), device=device)
    grid = sync_mod.put_pss_sss(grid, cell, sf)
    grid = pcfich_mod.encode(cell.cfi, cell, sf, grid)
    if cfg.with_pbch_sfn >= 0 and sf == 0:
        grid = pbch_mod.encode(mib_bits, cell, cfg.with_pbch_sfn, grid)
    if acks is not None and cfg.phich_groups:
        grid = phich_mod.encode(acks, cell, sf, grid)
    for gi, (rnti, prb_mask, qm, tbs, l_aggr, cce_start) in enumerate(cfg.grants):
        # DCI 1A on PDCCH
        s, l = _mask_to_riv(prb_mask)
        d = dci_mod.DciDl("1A", mcs=0, rb_start=s, l_crbs=l)
        bits = torch.from_numpy(np.tile(dci_mod.pack_dl(d, cell.n_prb), (B, 1))).to(device)
        grid = pdcch_mod.encode(bits, rnti, l_aggr, cce_start, cell, sf, grid)
        grid = pdsch_mod.encode(tb_payloads[gi], cfg.sch_cfg(gi), cell, sf,
                                rnti, prb_mask, grid=grid)
    return ofdm.modulate(grid, cell.n_prb)


def _mask_to_riv(prb_mask):
    on = [i for i, v in enumerate(prb_mask) if v]
    return on[0], len(on)
