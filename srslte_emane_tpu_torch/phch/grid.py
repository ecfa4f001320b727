"""Downlink resource grid: CRS values, RE hole maps, PDSCH RE indexing.

Host-side numpy tables, copied from the reference's `phch/grid.py` (which
cannot be imported without jax): all placement logic runs once per static
cell configuration and yields flat index tables into the flattened (14*NRE)
grid; the device only gathers.  Flat index = sym*NRE + k.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..ops import sequence

MAX_PRB = 110
N_SYM = 14  # normal CP
N_SYM_EXT = 12  # extended CP
PILOT_SYMS_P01 = (0, 4, 7, 11)  # subframe symbol indices for ports 0/1
PILOT_SYMS_P23 = (1, 8)
PILOT_SYMS_P01_EXT = (0, 3, 6, 9)
PILOT_SYMS_P23_EXT = (1, 7)


@dataclasses.dataclass(frozen=True)
class CellConfig:
    n_prb: int = 6
    cell_id: int = 0
    n_ports: int = 1
    cfi: int = 1
    cp: str = "normal"  # "normal" | "ext"

    @property
    def nre(self) -> int:
        return 12 * self.n_prb

    @property
    def n_sym(self) -> int:
        return N_SYM if self.cp == "normal" else N_SYM_EXT


def n_ctrl_symbols(cfi: int, n_prb: int) -> int:
    """CFI -> control-region length in OFDM symbols (regs.c:88-91)."""
    return cfi + (1 if n_prb <= 10 else 0)


def cs_v(port: int, ref_sym_idx: int) -> int:
    """Frequency offset v (refsignal_dl.c:134-165 / 36.211 §6.10.1.2)."""
    if port == 0:
        return 0 if ref_sym_idx % 2 == 0 else 3
    if port == 1:
        return 3 if ref_sym_idx % 2 == 0 else 0
    if port == 2:
        return 0 if ref_sym_idx == 0 else 3
    return 3 if ref_sym_idx == 0 else 0


def pilot_syms(port: int, cp: str = "normal") -> tuple:
    if cp == "normal":
        return PILOT_SYMS_P01 if port < 2 else PILOT_SYMS_P23
    return PILOT_SYMS_P01_EXT if port < 2 else PILOT_SYMS_P23_EXT


@functools.lru_cache(maxsize=None)
def crs_values(cell_id: int, sf_idx: int, n_prb: int, port: int,
               cp: str = "normal") -> np.ndarray:
    """CRS pilot values: (n_pilot_syms, 2*n_prb) complex64.

    r(m') = ((1-2c(2m')) + j(1-2c(2m'+1)))/sqrt(2) with
    c_init = 1024(7(ns+1)+l+1)(2 cell_id+1) + 2 cell_id + N_CP."""
    syms = pilot_syms(port, cp)
    n_slot_sym = 7 if cp == "normal" else 6
    n_cp = 1 if cp == "normal" else 0
    out = np.zeros((len(syms), 2 * n_prb), dtype=np.complex64)
    for i, sym in enumerate(syms):
        ns = 2 * sf_idx + sym // n_slot_sym
        l = sym % n_slot_sym
        c_init = 1024 * (7 * (ns + 1) + l + 1) * (2 * cell_id + 1) + 2 * cell_id + n_cp
        c = sequence.gold_sequence_host(c_init, 4 * MAX_PRB)
        m = np.arange(2 * n_prb)
        mp = m + MAX_PRB - n_prb
        out[i] = ((1 - 2 * c[2 * mp]) + 1j * (1 - 2 * c[2 * mp + 1])) / np.sqrt(2)
    return out


@functools.lru_cache(maxsize=None)
def crs_k(cell_id: int, n_prb: int, port: int, cp: str = "normal") -> np.ndarray:
    """CRS subcarrier indices: (n_pilot_syms, 2*n_prb) int."""
    syms = pilot_syms(port, cp)
    out = np.zeros((len(syms), 2 * n_prb), dtype=np.int32)
    for i in range(len(syms)):
        fidx = (cs_v(port, i) + cell_id % 6) % 6
        out[i] = fidx + 6 * np.arange(2 * n_prb)
    return out


@functools.lru_cache(maxsize=None)
def reserved_mask(cell: CellConfig, sf_idx: int) -> np.ndarray:
    """(14, NRE) bool mask of REs NOT available to PDSCH: control region,
    own-cell CRS of all configured ports, PSS/SSS (sf 0/5), PBCH (sf 0)."""
    m = np.zeros((cell.n_sym, cell.nre), dtype=bool)
    m[: n_ctrl_symbols(cell.cfi, cell.n_prb), :] = True  # control region
    assert cell.n_ports in (1, 2, 4)
    for p in range(cell.n_ports):
        ks = crs_k(cell.cell_id, cell.n_prb, p, cell.cp)
        for i, sym in enumerate(pilot_syms(p, cell.cp)):
            m[sym, ks[i]] = True
    center = cell.nre // 2
    n_slot_sym = cell.n_sym // 2
    if sf_idx in (0, 5):
        # PSS on the last, SSS on the second-to-last symbol of slot 0
        m[n_slot_sym - 2, center - 36 : center + 36] = True  # SSS
        m[n_slot_sym - 1, center - 36 : center + 36] = True  # PSS
    if sf_idx == 0:
        for sym in range(n_slot_sym, n_slot_sym + 4):
            m[sym, center - 36 : center + 36] = True
    return m


@functools.lru_cache(maxsize=None)
def pdsch_re_indices(cell: CellConfig, sf_idx: int, prb_mask: tuple) -> np.ndarray:
    """Ordered flat RE indices (sym*NRE + k) for a PDSCH allocation:
    frequency first within each symbol l = cfi..13 (36.211 §6.3.5), over
    allocated PRBs only, skipping reserved REs."""
    res = reserved_mask(cell, sf_idx)
    k_allowed = np.zeros(cell.nre, dtype=bool)
    for prb, on in enumerate(prb_mask):
        if on:
            k_allowed[12 * prb : 12 * (prb + 1)] = True
    idx = []
    for sym in range(n_ctrl_symbols(cell.cfi, cell.n_prb), cell.n_sym):
        ks = np.flatnonzero(k_allowed & ~res[sym])
        idx.append(sym * cell.nre + ks)
    return np.concatenate(idx).astype(np.int32)


def nof_re(cell: CellConfig, sf_idx: int, prb_mask: tuple) -> int:
    return len(pdsch_re_indices(cell, sf_idx, prb_mask))


@functools.lru_cache(maxsize=None)
def tx_gather_table(cell: CellConfig, sf_idx: int, prb_mask: tuple,
                    port: int = 0) -> np.ndarray:
    """(n_sym*NRE,) int32 inverse placement map for one TX port: each grid
    position reads from [pdsch syms (n_re) | own-port CRS (n_crs) | zero],
    so subframe assembly is one device gather."""
    re_idx = pdsch_re_indices(cell, sf_idx, prb_mask)
    ks = crs_k(cell.cell_id, cell.n_prb, port, cell.cp)
    syms = pilot_syms(port, cell.cp)
    pidx = (np.asarray(syms)[:, None] * cell.nre + ks).reshape(-1)
    n_re, n_crs = len(re_idx), len(pidx)
    table = np.full(cell.n_sym * cell.nre, n_re + n_crs, dtype=np.int32)
    table[re_idx] = np.arange(n_re, dtype=np.int32)
    table[pidx] = n_re + np.arange(n_crs, dtype=np.int32)
    return table
