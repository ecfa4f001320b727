"""PMCH: MBSFN multicast channel (eMBMS).

Twin of the reference's `phch/pmch.py` (`lib/src/phy/phch/pmch.c`): a PDSCH
variant carried in the extended-CP MBSFN region with MBSFN reference
signals (refsignal_dl.c:363-381: c_init = 512(7(ns+1)+l+1)(2 N_mbsfn_id+1)
+ N_mbsfn_id), scrambling c_init = floor(ns/2)*2^9 + N_mbsfn_area_id,
always full-bandwidth allocation.  The region grid is assembled with one
gather, and the receiver's pilot interpolation matrix is built once per
bandwidth.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import cplx, modem, ofdm, scrambling, sequence
from . import chest as chest_mod, grid as grid_mod, sch

# pilot layout inside the 10-symbol MBSFN region: 3 pilot symbols with
# frequency offsets (0, 1, 0), 6 pilots/PRB (every other subcarrier)
PILOT_SYMS = (0, 4, 8)
PILOT_FIDX = (0, 1, 0)


@functools.lru_cache(maxsize=None)
def mbsfn_rs(area_id: int, sf_idx: int, n_prb: int) -> np.ndarray:
    """(3, 6*n_prb) complex pilots for the 3 MBSFN-RS symbols."""
    out = np.zeros((3, 6 * n_prb), dtype=np.complex64)
    # pilots at extended-CP slot symbols l = 2 (slot 0) and l = 0, 4 (slot 1)
    slot_l = (2, 0, 4)
    for i, lsym in enumerate(PILOT_SYMS):
        ns = 2 * sf_idx + (0 if i == 0 else 1)
        lp = slot_l[i]
        c_init = (512 * (7 * (ns + 1) + lp + 1) * (2 * area_id + 1) + area_id) % (1 << 31)
        c = sequence.gold_sequence_host(c_init, 12 * grid_mod.MAX_PRB)
        m = np.arange(6 * n_prb)
        mp = m + 3 * (grid_mod.MAX_PRB - n_prb)
        out[i] = ((1 - 2 * c[2 * mp]) + 1j * (1 - 2 * c[2 * mp + 1])) / np.sqrt(2)
    return out


@functools.lru_cache(maxsize=None)
def pilot_k(n_prb: int):
    return tuple(PILOT_FIDX[i] + 2 * np.arange(6 * n_prb) for i in range(3))


@functools.lru_cache(maxsize=None)
def data_indices(n_prb: int):
    """Flat (sym*NRE + k) indices of PMCH data REs in the 10-sym region."""
    nre = 12 * n_prb
    res = np.zeros((ofdm.N_SYM_MBSFN, nre), dtype=bool)
    for i, l in enumerate(PILOT_SYMS):
        res[l, PILOT_FIDX[i] :: 2] = True
    idx = []
    for l in range(ofdm.N_SYM_MBSFN):
        ks = np.flatnonzero(~res[l])
        idx.append(l * nre + ks)
    return np.concatenate(idx).astype(np.int32)


def nof_re(n_prb: int) -> int:
    return len(data_indices(n_prb))


@functools.lru_cache(maxsize=32)
def _device_tables(n_prb: int, area_id: int, sf_idx: int, device: torch.device):
    """(data positions (n_re,), pilot positions (3, 6*n_prb), pilot values
    (3, 6*n_prb, 2), region gather table (10*NRE,), frequency matrix
    (NRE, 6*n_prb)) on `device`.  The gather table reads each region
    position from [data syms (n_re) | pilots (3*6*n_prb) | zero]."""
    nre = 12 * n_prb
    data = data_indices(n_prb).astype(np.int64)
    pidx = np.stack([l * nre + k for l, k in zip(PILOT_SYMS, pilot_k(n_prb))])
    table = np.full(ofdm.N_SYM_MBSFN * nre, len(data) + pidx.size, dtype=np.int64)
    table[data] = np.arange(len(data))
    table[pidx.reshape(-1)] = len(data) + np.arange(pidx.size)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (f(data), f(pidx.astype(np.int64)), cplx.from_numpy(mbsfn_rs(area_id, sf_idx, n_prb),
                                                              device),
            f(table), f(chest_mod.interp_matrix(tuple(range(0, nre, 2)), nre)))


def encode(tb_bits: torch.Tensor, cfg: sch.SchConfig, n_prb: int, area_id: int,
           sf_idx: int) -> torch.Tensor:
    """-> MBSFN region grid (B, 10, NRE, 2) with PMCH + MBSFN-RS."""
    cw = sch.encode_tb(tb_bits, cfg)
    scr = scrambling.scramble_bits(cw, (sf_idx << 9) + area_id)
    syms = modem.modulate(scr, modem.MOD_FROM_QM[cfg.Qm])
    B = syms.shape[0]
    _, _, rs, table, _ = _device_tables(n_prb, area_id, sf_idx, syms.device)
    src = torch.cat([syms, rs.reshape(1, -1, 2).expand(B, -1, -1).to(syms.dtype),
                     syms.new_zeros((B, 1, 2))], dim=1)
    return src[:, table].reshape(B, ofdm.N_SYM_MBSFN, 12 * n_prb, 2)


def decode(mbsfn_grid: torch.Tensor, cfg: sch.SchConfig, n_prb: int, area_id: int,
           sf_idx: int, max_iter: int = 8):
    """MBSFN-region grid -> (payload, ok)."""
    B = mbsfn_grid.shape[0]
    data, pidx, rs, _, fm = _device_tables(n_prb, area_id, sf_idx, mbsfn_grid.device)
    flat = mbsfn_grid.reshape(B, -1, 2)
    # LS at pilots, average over the 3 pilot symbols, freq linear interp
    h_syms = [cplx.mul_conj(flat[:, pidx[i]], rs[i]) for i in range(len(PILOT_SYMS))]
    h_p = sum(h_syms) / len(h_syms)  # (B, 6*n_prb, 2)
    ce = fm @ h_p  # (B, NRE, 2), the same on every symbol of the region
    y = flat[:, data]
    h = ce[:, data % (12 * n_prb)]
    x_eq, csi = chest_mod.equalize_zf(y, h)
    llr = modem.demod_soft(x_eq, modem.MOD_FROM_QM[cfg.Qm])
    llr = llr * torch.repeat_interleave(csi, cfg.Qm, dim=-1)
    llr = scrambling.scramble_llrs(llr, (sf_idx << 9) + area_id)
    payload, ok, _, _ = sch.decode_tb(llr, cfg, max_iter=max_iter)
    return payload, ok
