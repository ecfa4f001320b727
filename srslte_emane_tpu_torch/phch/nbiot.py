"""NB-IoT downlink channels: NRS, NPBCH (MIB-NB) and NPDSCH.

Twin of the reference's `phch/nbiot.py` (srsLTE 19.09's NB-IoT additions:
`npbch.c`, `npdsch.c`, `ch_estimation/chest_dl_nbiot.c`): single-PRB
(12-subcarrier) downlink, tail-biting convolutional code (no turbo in
NB-IoT DL), QPSK only, narrowband reference signals (NRS) on the last two
symbols of each slot.  One anchor-PRB subframe is a (14, 12) grid; NPBCH's
8 blocks and NPDSCH's subframes batch along the leading axes, and the TBCC
decode is the port's batched Viterbi (ops/fec/viterbi.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import cplx, modem, scrambling, sequence
from ..ops.fec import convcoder, crc as crc_mod, viterbi
from . import chest, grid as grid_mod

NRE = 12
N_SYM = 14
# NRS: port-0 positions, symbols 5, 6 of each slot (l = 5, 6, 12, 13),
# 2 pilots per symbol at spacing 6
NRS_SYMS = (5, 6, 12, 13)


@functools.lru_cache(maxsize=None)
def nrs_k(n_id_ncell: int) -> np.ndarray:
    """(4, 2) NRS subcarriers: v = {0, 3} alternating + cell shift."""
    vshift = n_id_ncell % 6
    out = np.zeros((len(NRS_SYMS), 2), dtype=np.int32)
    for i in range(len(NRS_SYMS)):
        v = 0 if i % 2 == 0 else 3
        out[i] = (v + vshift) % 6 + 6 * np.arange(2)
    return out


@functools.lru_cache(maxsize=None)
def nrs_values(n_id_ncell: int, sf_idx: int) -> np.ndarray:
    """(4, 2) complex NRS values (gold sequence, CRS-style c_init with the
    narrowband cell id)."""
    out = np.zeros((len(NRS_SYMS), 2), dtype=np.complex64)
    for i, sym in enumerate(NRS_SYMS):
        ns = 2 * sf_idx + sym // 7
        l = sym % 7
        c_init = (1024 * (7 * (ns + 1) + l + 1) * (2 * n_id_ncell + 1)
                  + 2 * n_id_ncell + 1)
        c = sequence.gold_sequence_host(c_init, 4 * grid_mod.MAX_PRB)
        m = np.arange(2) + grid_mod.MAX_PRB - 1
        out[i] = ((1 - 2 * c[2 * m]) + 1j * (1 - 2 * c[2 * m + 1])) / np.sqrt(2)
    return out


@functools.lru_cache(maxsize=None)
def _re_indices(n_id_ncell: int, sf_idx: int, l_start: int) -> np.ndarray:
    """Data RE indices (sym*12 + k) of one anchor-PRB subframe, skipping the
    NRS and the first l_start symbols (NB-IoT in-band leaves the legacy
    control symbols empty)."""
    res = np.zeros((N_SYM, NRE), dtype=bool)
    res[:l_start] = True
    ks = nrs_k(n_id_ncell)
    for i, sym in enumerate(NRS_SYMS):
        res[sym, ks[i]] = True
    idx = []
    for sym in range(l_start, N_SYM):
        idx.append(sym * NRE + np.flatnonzero(~res[sym]))
    return np.concatenate(idx).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _sf_tables(n_id_ncell: int, sf_idx: int, l_start: int, device: torch.device):
    """(data REs (n,), NRS REs (8,), NRS values (8, 2), the two NRS of each
    distinct pilot subcarrier (4, 2), the (NRE, 4) frequency interpolation)
    of one subframe on `device`.  Symbols (5, 12) share v = 0 and (6, 13)
    v = 3, so each of the 4 pilot subcarriers, in ascending order, carries
    a pair of the 8 NRS."""
    ks = nrs_k(n_id_ncell)
    vals = nrs_values(n_id_ncell, sf_idx)
    nrs_idx = (np.asarray(NRS_SYMS)[:, None] * NRE + ks).reshape(-1)
    pk = sorted(set(ks.reshape(-1).tolist()))
    pairs = [np.flatnonzero(ks.reshape(-1) == k) for k in pk]
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(device)
    return (t(_re_indices(n_id_ncell, sf_idx, l_start)), t(nrs_idx),
            cplx.from_numpy(vals.reshape(-1), device), t(pairs),
            torch.from_numpy(chest.interp_matrix(tuple(pk), NRE)).to(device))


def put_nrs(grid: torch.Tensor, n_id_ncell: int, sf_idx: int) -> torch.Tensor:
    """grid (B, 14, 12, 2) with NRS placed (into a copy)."""
    _, nrs_idx, v, _, _ = _sf_tables(n_id_ncell, sf_idx, 0, grid.device)
    flat = grid.reshape(grid.shape[0], N_SYM * NRE, 2).clone()
    flat[:, nrs_idx, :] = v
    return flat.reshape(grid.shape)


def _chest_nrs(rx: torch.Tensor, n_id_ncell: int, sf_idx: int) -> torch.Tensor:
    """LS at NRS, averaged over the subframe per pilot subcarrier (the
    channel is static within 1 ms at NB-IoT speeds; chest_dl_nbiot averages
    likewise), then one frequency interpolation from the 4 distinct pilot
    subcarriers.  Returns (B, NRE, 2), the same for every symbol."""
    B = rx.shape[0]
    _, nrs_idx, v, pairs, fm = _sf_tables(n_id_ncell, sf_idx, 0, rx.device)
    h_ls = cplx.mul_conj(rx.reshape(B, N_SYM * NRE, 2)[:, nrs_idx], v)  # (B, 8, 2)
    h_p = (h_ls[:, pairs[:, 0]] + h_ls[:, pairs[:, 1]]) / 2  # (B, 4, 2)
    return torch.einsum("kp,bpc->bkc", fm, h_p)


def _llrs(rx: torch.Tensor, n_id_ncell: int, sf_idx: int, l_start: int, c_init: int):
    """One subframe's descrambled QPSK LLRs, ZF-equalized with the NRS
    estimate."""
    B = rx.shape[0]
    e_idx = _sf_tables(n_id_ncell, sf_idx, l_start, rx.device)[0]
    ce = _chest_nrs(rx, n_id_ncell, sf_idx)  # (B, NRE, 2)
    y = rx.reshape(B, N_SYM * NRE, 2)[:, e_idx]
    h = ce[:, e_idx % NRE]
    x, _ = chest.equalize_zf(y, h)
    return scrambling.scramble_llrs(modem.demod_soft(x, modem.QPSK), c_init)


def _place(syms: torch.Tensor, n_id_ncell: int, sf_idx: int, l_start: int) -> torch.Tensor:
    """(B, n, 2) QPSK symbols -> (B, 14, 12, 2) subframe with NRS."""
    B = syms.shape[0]
    e_idx = _sf_tables(n_id_ncell, sf_idx, l_start, syms.device)[0]
    flat = cplx.zeros((B, N_SYM * NRE), device=syms.device)
    flat[:, e_idx, :] = syms
    return put_nrs(flat.reshape(B, N_SYM, NRE, 2), n_id_ncell, sf_idx)


def _tbcc_encode_block(bits: torch.Tensor, e: int) -> torch.Tensor:
    """CRC16 + tail-biting convolutional code + rate matching to e bits."""
    with_crc = crc_mod.crc_attach(bits, crc_mod.LTE_CRC16)
    return convcoder.rate_match_cc(convcoder.conv_encode(with_crc), e)


def _tbcc_decode_block(cw_llr: torch.Tensor, n_bits: int):
    """(B, e) LLRs -> (bits (B, n_bits), crc ok (B,))."""
    bits = viterbi.viterbi_decode(convcoder.rate_unmatch_cc(cw_llr, n_bits + 16))
    return bits[:, :n_bits], crc_mod.crc_ok(bits, crc_mod.LTE_CRC16)


# ---------------- NPBCH (36.211 §10.2.4, 36.212 §5.3.1.1) ----------------

MIB_NB_BITS = 34


def npbch_encode(mib_bits: torch.Tensor, n_id_ncell: int) -> torch.Tensor:
    """(B, 34) MIB-NB -> (B, 8, 14, 12, 2): the 8 self-decodable blocks of
    the 640 ms NPBCH TTI (each block repeats over 8 frames on sf 0)."""
    e = len(_re_indices(n_id_ncell, 0, 3)) * 2  # NPBCH starts at symbol 3
    cw = _tbcc_encode_block(mib_bits, 8 * e)  # (B, 8e) whole-TTI codeword
    grids = []
    for blk in range(8):
        scr = scrambling.scramble_bits(cw[:, blk * e : (blk + 1) * e], n_id_ncell + 1)
        grids.append(_place(modem.modulate(scr, modem.QPSK), n_id_ncell, 0, 3))
    return torch.stack(grids, dim=1)


def npbch_decode(rx_blocks: torch.Tensor, n_id_ncell: int):
    """(B, 8, 14, 12, 2) -> (mib (B, 34), crc_ok (B,))."""
    llrs = [_llrs(rx_blocks[:, blk], n_id_ncell, 0, 3, n_id_ncell + 1) for blk in range(8)]
    return _tbcc_decode_block(torch.cat(llrs, dim=1), MIB_NB_BITS)


# ---------------- NPDSCH (36.211 §10.2.3) ----------------

def _npdsch_cinit(rnti: int, sf_idx: int, n_id_ncell: int) -> int:
    return (rnti << 15) + (sf_idx << 9) + n_id_ncell


def npdsch_encode(tb_bits: torch.Tensor, n_sf: int, n_id_ncell: int, rnti: int,
                  sf_indices: tuple = None, l_start: int = 0) -> torch.Tensor:
    """(B, tbs) -> (B, n_sf, 14, 12, 2): TBCC-coded QPSK over n_sf anchor
    subframes."""
    if sf_indices is None:
        sf_indices = tuple(4 + i for i in range(n_sf))
    e_per_sf = [len(_re_indices(n_id_ncell, s, l_start)) * 2 for s in sf_indices]
    cw = _tbcc_encode_block(tb_bits, sum(e_per_sf))
    grids = []
    off = 0
    for s, e in zip(sf_indices, e_per_sf):
        scr = scrambling.scramble_bits(cw[:, off : off + e], _npdsch_cinit(rnti, s, n_id_ncell))
        off += e
        grids.append(_place(modem.modulate(scr, modem.QPSK), n_id_ncell, s, l_start))
    return torch.stack(grids, dim=1)


def npdsch_decode(rx_sfs: torch.Tensor, tbs: int, n_id_ncell: int, rnti: int,
                  sf_indices: tuple = None, l_start: int = 0):
    """(B, n_sf, 14, 12, 2) -> (bits (B, tbs), ok (B,))."""
    if sf_indices is None:
        sf_indices = tuple(4 + i for i in range(rx_sfs.shape[1]))
    llrs = [_llrs(rx_sfs[:, i], n_id_ncell, s, l_start, _npdsch_cinit(rnti, s, n_id_ncell))
            for i, s in enumerate(sf_indices)]
    return _tbcc_decode_block(torch.cat(llrs, dim=1), tbs)
