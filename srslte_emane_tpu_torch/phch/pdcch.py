"""PDCCH: control channel encode + batched blind search decode.

Twin of the reference's `phch/pdcch.py` (`lib/src/phy/phch/pdcch.c`: DCI
CRC16 scrambled by RNTI, K=7 conv code + rate matching to 72*L bits, CCE
aggregation L in {1,2,4,8}, REG interleaving via regs.c; the UE's serial
candidate walk of `lib/src/phy/ue/ue_dl.c:422-478`).

The blind search is a dense hypothesis tensor: every candidate
(aggregation x CCE offset) is equalised, descrambled and de-rate-matched
per aggregation level, and then all levels' candidates, which share the
shape (3, dci_len + 16), go through ONE Viterbi call; RNTI-masked CRCs
adjudicate.  The search spaces, hashes and CCE tables are host numpy.
"""

from __future__ import annotations

import functools
import numbers

import numpy as np
import torch

from ..ops import modem, scrambling, sequence
from ..ops.fec import convcoder, crc as crc_mod, viterbi
from ..utils.devices import row, table_cache
from . import chest, grid as grid_mod, regs as regs_mod

CCE_BITS = 72  # 9 REGs x 4 REs x 2 bits (QPSK)


@functools.lru_cache(maxsize=None)
def n_cce(cell: grid_mod.CellConfig) -> int:
    ch = regs_mod.channel_regs(cell.n_prb, cell.cell_id, cell.n_ports)
    return len(ch["pdcch"][cell.cfi]) // 9


@functools.lru_cache(maxsize=None)
def cce_re_indices(cell: grid_mod.CellConfig) -> np.ndarray:
    """(n_cce, 36) flat grid RE indices per CCE (sequence order -> regs)."""
    ch = regs_mod.channel_regs(cell.n_prb, cell.cell_id, cell.n_ports)
    seq = ch["pdcch"][cell.cfi]
    ncce = len(seq) // 9
    res = regs_mod.reg_re_indices(
        cell.n_prb, cell.cell_id, cell.n_ports, seq[: ncce * 9]
    )  # (9*ncce, 4)
    return res.reshape(ncce, 36)


def _region_sequence(cell: grid_mod.CellConfig, sf_idx: int) -> np.ndarray:
    """(72*n_cce,) int8 control-region scrambling bits of subframe sf_idx."""
    c_init = scrambling.pdcch_cinit(sf_idx, cell.cell_id)
    return sequence.gold_sequence_host(c_init, CCE_BITS * n_cce(cell))


@table_cache(32)
def _device_tables(cell: grid_mod.CellConfig, sf_idx: int, device: torch.device):
    """(CCE RE indices (n_cce, 36) int64, control-region scrambling bits
    c (72*n_cce,) int8) on `device`."""
    return (torch.from_numpy(cce_re_indices(cell).astype(np.int64)).to(device),
            torch.from_numpy(_region_sequence(cell, sf_idx)).to(device))


@table_cache(8)
def _sequence10(cell: grid_mod.CellConfig, device: torch.device) -> torch.Tensor:
    """(10, 72*n_cce) int8: the control-region bits of every subframe, the
    gather table for an sf_idx given as a tensor."""
    return torch.from_numpy(np.stack([_region_sequence(cell, s) for s in range(10)])).to(device)


@table_cache(256)
def _rnti_mask(rnti: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(((rnti >> np.arange(15, -1, -1)) & 1).astype(np.int8)).to(device)


def rnti_mask_bits(rnti, device=None) -> torch.Tensor:
    """(16,) int8 MSB-first CRC16 mask from an rnti (int or 0-dim tensor);
    an int's mask comes from a table, so a graph captures no copy."""
    if isinstance(rnti, numbers.Integral):
        return _rnti_mask(int(rnti), torch.device(device if device is not None else "cpu"))
    r = torch.as_tensor(rnti, dtype=torch.int64, device=device)
    sh = torch.arange(15, -1, -1, device=r.device)
    return ((r[..., None] >> sh) & 1).to(torch.int8)


def _crc_rnti_attach(dci_bits: torch.Tensor, rnti) -> torch.Tensor:
    """(B, n) -> (B, n+16) with CRC16 xored by RNTI (pdcch.c)."""
    w = crc_mod.crc_attach(dci_bits.to(torch.int8), crc_mod.LTE_CRC16)
    n = dci_bits.shape[-1]
    return torch.cat([w[:, :n], w[:, n:] ^ rnti_mask_bits(rnti, w.device)], dim=1)


def _place(dci_bits, rnti, l_aggr: int, rows: torch.Tensor, c: torch.Tensor,
           grid: torch.Tensor) -> torch.Tensor:
    """Code, scramble with c, modulate and write onto the REs `rows`."""
    coded = convcoder.conv_encode(_crc_rnti_attach(dci_bits, rnti))
    bits = convcoder.rate_match_cc(coded, CCE_BITS * l_aggr)
    syms = modem.modulate(bits ^ c, modem.QPSK)  # (B, 36 l, 2)
    flat = grid.reshape(grid.shape[0], -1, 2).clone()
    flat[:, rows.reshape(-1), :] = syms
    return flat.reshape(grid.shape)


def encode(dci_bits: torch.Tensor, rnti: int, l_aggr: int, cce_start: int,
           cell: grid_mod.CellConfig, sf_idx: int, grid: torch.Tensor) -> torch.Tensor:
    """Encode one DCI onto CCEs [cce_start, cce_start+l_aggr) of a copy of
    `grid`, scrambled with the position's slice of the control-region
    sequence."""
    idx_all, c_all = _device_tables(cell, sf_idx, grid.device)
    e = CCE_BITS * l_aggr
    c = c_all[CCE_BITS * cce_start : CCE_BITS * cce_start + e]
    return _place(dci_bits, rnti, l_aggr, idx_all[cce_start : cce_start + l_aggr], c, grid)


def encode_dyn(dci_bits: torch.Tensor, rnti, l_aggr: int, cce_start,
               cell: grid_mod.CellConfig, sf_idx: int, grid: torch.Tensor) -> torch.Tensor:
    """encode() with rnti, cce_start and sf_idx as ints or 0-dim tensors on
    the grid's device: the position is applied as device indices and a
    tensor sf_idx gathers its control-region bits from the (10, ...) table,
    so no value is read back to the host (the reference's one kernel per
    aggregation level)."""
    if isinstance(sf_idx, torch.Tensor):
        idx_all, _ = _device_tables(cell, 0, grid.device)
        c_all = row(_sequence10(cell, grid.device), sf_idx)
    else:
        idx_all, c_all = _device_tables(cell, sf_idx, grid.device)
    e = CCE_BITS * l_aggr
    start = torch.as_tensor(cce_start, dtype=torch.int64, device=grid.device)
    c = c_all[start * CCE_BITS + torch.arange(e, device=grid.device)]
    rows = idx_all[start + torch.arange(l_aggr, device=grid.device)]
    return _place(dci_bits, rnti, l_aggr, rows, c, grid)


@functools.lru_cache(maxsize=None)
def full_space(cell: grid_mod.CellConfig) -> tuple:
    """Every l-aligned (l_aggr, cce_start) position — the superset of any
    RNTI's 36.213 search space (common and UE-specific starts are both
    multiples of l)."""
    ncce = n_cce(cell)
    return tuple((l, s) for l in (1, 2, 4, 8)
                 for s in range(0, ncce - l + 1, l))


@table_cache(64)
def _level_tables(cell: grid_mod.CellConfig, sf_idx: int, positions: tuple,
                  device: torch.device) -> tuple:
    """Per aggregation level of `positions`, in their order: (l, number of
    candidates n, their REs (n*36*l,) int64, their scrambling bits (n, 72 l)
    int8) on `device`."""
    idx_all, c_all = cce_re_indices(cell), _region_sequence(cell, sf_idx)
    out = []
    for l in dict.fromkeys(l for l, _ in positions):
        starts = np.array([s for ll, s in positions if ll == l])
        idx = idx_all[starts[:, None] + np.arange(l)].reshape(-1).astype(np.int64)
        c = c_all[starts[:, None] * CCE_BITS + np.arange(CCE_BITS * l)]
        out.append((l, len(starts), torch.from_numpy(idx).to(device),
                    torch.from_numpy(c).to(device)))
    return tuple(out)


def _decode_candidates(rx_grid: torch.Tensor, ce: torch.Tensor, cell: grid_mod.CellConfig,
                       sf_idx: int, positions: list, dci_len: int) -> torch.Tensor:
    """Viterbi-decoded bits (B, n, dci_len+16) of the (l_aggr, cce_start)
    `positions`, which come grouped by aggregation level: each level is
    equalised, descrambled and de-rate-matched apart (e = 72 l differs),
    then every candidate goes through ONE Viterbi call."""
    B = rx_grid.shape[0]
    flat_rx = rx_grid.reshape(B, -1, 2)
    flat_ce = ce.reshape(B, -1, 2)
    d = dci_len + 16
    streams = []
    for l, n, idx, c in _level_tables(cell, sf_idx, tuple(positions), rx_grid.device):
        x_eq, csi = chest.equalize_zf(flat_rx[:, idx], flat_ce[:, idx])
        llr = modem.demod_soft(x_eq, modem.QPSK) * torch.repeat_interleave(csi, 2, dim=-1)
        llr = llr.reshape(B, n, CCE_BITS * l) * (1.0 - 2.0 * c.to(llr.dtype))
        streams.append(convcoder.rate_unmatch_cc(llr.reshape(B * n, CCE_BITS * l), d)
                       .reshape(B, n, 3, d))
    streams = torch.cat(streams, dim=1)
    bits = viterbi.viterbi_decode(streams.reshape(-1, 3, d))  # (B*n_all, d)
    return bits.reshape(B, -1, d)


@table_cache(8)
def _crc_weights(device: torch.device) -> torch.Tensor:
    """(16,) int32 MSB-first bit weights of a CRC16 residual."""
    return torch.tensor([1 << (15 - i) for i in range(16)], dtype=torch.int32, device=device)


def blind_search_all(rx_grid: torch.Tensor, ce: torch.Tensor, cell: grid_mod.CellConfig,
                     sf_idx: int, dci_len: int):
    """Decode EVERY aligned CCE position once per subframe.

    Returns (bits (B, n_pos, dci_len), resid (B, n_pos) int32, positions):
    a candidate decoded for RNTI r iff resid == r (the CRC16 residual IS
    the scrambling RNTI).  One call adjudicates all listeners: the
    per-RNTI check is a host-side integer compare, so the waveform UE's
    blind search costs the same whether it watches one RNTI or ten
    (ue_dl.c:422-478 runs the candidate loop per RNTI instead)."""
    pos = list(full_space(cell))
    bits = _decode_candidates(rx_grid, ce, cell, sf_idx, pos, dci_len)
    calc = crc_mod.crc_bits(bits[..., :dci_len], crc_mod.LTE_CRC16)
    resid = ((calc ^ bits[..., dci_len:]).to(torch.int32) * _crc_weights(bits.device)).sum(-1)
    return bits[..., :dci_len], resid.to(torch.int32), pos


def ue_yk(rnti: int, sf_idx: int) -> int:
    """UE-specific search space hash Y_k (36.213 §9.1.1)."""
    y = rnti
    for _ in range(sf_idx + 1):
        y = (39827 * y) % 65537
    return y


@functools.lru_cache(maxsize=65536)
def candidates(cell: grid_mod.CellConfig, rnti: int, sf_idx: int) -> list:
    """(l_aggr, cce_start) candidate list: common (L=4,8) + UE-specific."""
    ncce = n_cce(cell)
    out = []
    # common search space
    for l, n_cand in ((4, 4), (8, 2)):
        for m in range(n_cand):
            start = m * l
            if start + l <= ncce:
                out.append((l, start))
    # UE-specific
    yk = ue_yk(rnti, sf_idx)
    for l, n_cand in ((1, 6), (2, 6), (4, 2), (8, 2)):
        if ncce // l == 0:
            continue
        for m in range(n_cand):
            start = l * ((yk + m) % (ncce // l))
            if start + l <= ncce:
                out.append((l, start))
    # dedupe preserving order
    seen, uniq = set(), []
    for c in out:
        if c not in seen:
            seen.add(c)
            uniq.append(c)
    return uniq


def allocate_cces(cell: grid_mod.CellConfig, rntis, sf_idx: int,
                  l_pref: int = 1) -> dict:
    """Greedy per-TTI CCE allocation over each UE's true 36.213 search
    space: every grant gets a candidate from candidates(cell, rnti, sf_idx)
    whose CCEs overlap no earlier grant (scheduler_grid.cc alloc_dci role).

    Returns {rnti: (l_aggr, cce_start)}; UEs that cannot be placed without
    a collision are OMITTED (the scheduler must defer them a TTI)."""
    used = set()
    out = {}
    for rnti in rntis:
        cands = candidates(cell, rnti, sf_idx)
        # prefer the requested aggregation level, then smaller ones (more
        # candidates -> fewer collisions), then larger
        cands = sorted(cands, key=lambda c: (c[0] != l_pref, c[0]))
        for l, start in cands:
            cces = set(range(start, start + l))
            if not (cces & used):
                used |= cces
                out[rnti] = (l, start)
                break
    return out


def blind_search(rx_grid: torch.Tensor, ce: torch.Tensor, cell: grid_mod.CellConfig,
                 sf_idx: int, rnti: int, dci_len: int):
    """Decode every candidate for (rnti, dci_len) as one batch.

    rx_grid/ce: (B, 14, NRE, 2).  Returns (bits (B, n_cand, dci_len),
    ok (B, n_cand), cand list in the order of the outputs: by aggregation
    level, then as candidates() gives them) — caller picks the passing
    candidate(s)."""
    cands = candidates(cell, rnti, sf_idx)
    pos = [(l, s) for l in sorted({l for l, _ in cands}) for (ll, s) in cands if ll == l]
    bits = _decode_candidates(rx_grid, ce, cell, sf_idx, pos, dci_len)
    unmasked = torch.cat(
        [bits[..., :dci_len], bits[..., dci_len:] ^ rnti_mask_bits(rnti, bits.device)], dim=-1)
    return bits[..., :dci_len], crc_mod.crc_ok(unmasked, crc_mod.LTE_CRC16), pos
