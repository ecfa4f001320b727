"""SRS: uplink sounding reference signal (36.211 §5.5.3).

Twin of the reference's `phch/srs.py`: srsLTE generates SRS within
`refsignal_ul.c` (r_SRS from the same base sequences) and `ue_ul.c` /
`enb_ul.c` place/extract it on the last SC-FDMA symbol with transmission
comb 2.  The sequence is host numpy; placement and estimate are one
scatter and one gather on the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import cplx
from . import grid as grid_mod, refsignal_ul

SRS_SYMBOL = 13  # last symbol of the subframe


@functools.lru_cache(maxsize=None)
def srs_sequence(cell_id: int, sf_idx: int, m_srs_prb: int, cyclic_shift: int,
                 comb: int) -> np.ndarray:
    """(m_srs_prb*6,) complex: comb-2 SRS over m_srs_prb PRBs
    (r_SRS = r_uv over M_sc_RS = m_srs/2 subcarriers, 36.211)."""
    m_sc = 6 * m_srs_prb  # every other subcarrier
    u = cell_id % 30
    r = refsignal_ul.base_sequence(u, 0, max(12, m_sc))[:m_sc]
    alpha = 2 * np.pi * cyclic_shift / 8.0
    return (r * np.exp(1j * alpha * np.arange(m_sc))).astype(np.complex64)


@functools.lru_cache(maxsize=32)
def _device_tables(cell: grid_mod.CellConfig, sf_idx: int, rb_start: int, m_srs_prb: int,
                   cyclic_shift: int, comb: int, device: torch.device):
    """(flat grid indices (6*m_srs,), SRS values (6*m_srs, 2)) on `device`."""
    ks = 12 * rb_start + comb + 2 * np.arange(6 * m_srs_prb)
    idx = torch.from_numpy((SRS_SYMBOL * cell.nre + ks).astype(np.int64)).to(device)
    seq = srs_sequence(cell.cell_id, sf_idx, m_srs_prb, cyclic_shift, comb)
    return idx, cplx.from_numpy(seq, device)


def put_srs(grid: torch.Tensor, cell: grid_mod.CellConfig, sf_idx: int, rb_start: int,
            m_srs_prb: int, cyclic_shift: int = 0, comb: int = 0) -> torch.Tensor:
    """Place SRS on the last symbol, comb-2 (into a copy of grid)."""
    idx, v = _device_tables(cell, sf_idx, rb_start, m_srs_prb, cyclic_shift, comb, grid.device)
    B = grid.shape[0]
    flat = grid.reshape(B, -1, 2).clone()
    flat[:, idx] = v
    return flat.reshape(grid.shape)


def estimate_srs(rx_grid: torch.Tensor, cell: grid_mod.CellConfig, sf_idx: int,
                 rb_start: int, m_srs_prb: int, cyclic_shift: int = 0, comb: int = 0):
    """eNB-side wideband channel estimate + SNR from SRS.
    Returns (h (B, 6*m_srs, 2), snr_db (B,))."""
    idx, seq = _device_tables(cell, sf_idx, rb_start, m_srs_prb, cyclic_shift, comb,
                              rx_grid.device)
    B = rx_grid.shape[0]
    h = cplx.mul_conj(rx_grid.reshape(B, -1, 2)[:, idx], seq)
    # noise from neighbor-difference residual
    noise = cplx.abs2(h[:, 1:] - h[:, :-1]).mean(dim=-1) / 2.0
    p = cplx.abs2(h).mean(dim=-1)
    snr = 10.0 * torch.log10(torch.clamp(p / torch.clamp(noise, min=1e-12), min=1e-12))
    return h, snr
