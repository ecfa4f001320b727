"""Uplink reference signals: ZC base sequences, group hopping, PUSCH DMRS.

Host-side numpy, copied from the reference's `phch/refsignal_ul.py` (which
cannot be imported without jax), with its table file `ul_rs_tables.npz`
copied byte for byte: `lib/src/phy/ch_estimation/refsignal_ul.c` — base
sequences (1/2-PRB phi tables from ul_rs_tables.h, ZC for >=3 PRB,
refsignal_ul.c:240-293), alpha cyclic shift from n_dmrs_1/n_dmrs_2/n_prs
(:295-305), group hopping f_gh and n_prs gold sequences (:117-140).

All generation is static per cell/grant configuration and cached; values
enter the device as cf constants.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np

from ..ops import sequence

_DATA = np.load(pathlib.Path(__file__).parent / "ul_rs_tables.npz")
PHI12 = _DATA["phi12"]  # 36.211 Table 5.5.1.2-1
PHI24 = _DATA["phi24"]  # 36.211 Table 5.5.1.2-2

# 36.211 Tables 5.5.2.1.1-1 / 5.5.2.1.1-2
N_DMRS_2 = np.array([0, 6, 3, 4, 2, 8, 10, 9])
N_DMRS_1 = np.array([0, 2, 3, 4, 6, 8, 9, 10])

N_SYMB_SLOT = 7  # normal CP


def _largest_prime_below(x: int) -> int:
    for n in range(x - 1, 1, -1):
        if all(n % d for d in range(2, int(n**0.5) + 1)):
            return n
    return 2


@functools.lru_cache(maxsize=None)
def base_sequence(u: int, v: int, m_sc: int) -> np.ndarray:
    """r_uv (m_sc,) complex64 (36.211 §5.5.1)."""
    if m_sc == 12:
        arg = PHI12[u] * np.pi / 4
    elif m_sc == 24:
        arg = PHI24[u] * np.pi / 4
    else:
        n_zc = _largest_prime_below(m_sc)
        q_hat = n_zc * (u + 1) / 31
        if int(2 * q_hat) % 2 == 0:
            q = int(q_hat + 0.5) + v
        else:
            q = int(q_hat + 0.5) - v
        m = np.arange(m_sc) % n_zc
        arg = -np.pi * q * m * (m + 1) / n_zc
    return np.exp(1j * arg).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def n_prs_table(cell_id: int, delta_ss: int = 0) -> np.ndarray:
    """(20,) per-slot pseudo-random cyclic shift contribution."""
    c_init = ((cell_id // 30) << 5) + ((cell_id % 30 + delta_ss) % 30)
    c = sequence.gold_sequence_host(c_init, 8 * N_SYMB_SLOT * 20)
    out = np.zeros(20, dtype=np.int64)
    for ns in range(20):
        out[ns] = sum(int(c[8 * N_SYMB_SLOT * ns + i]) << i for i in range(8))
    return out


@functools.lru_cache(maxsize=None)
def f_gh_table(cell_id: int, enabled: bool) -> np.ndarray:
    """(20,) group hopping pattern (36.211 §5.5.1.3)."""
    if not enabled:
        return np.zeros(20, dtype=np.int64)
    c = sequence.gold_sequence_host(cell_id // 30, 8 * 20)
    out = np.zeros(20, dtype=np.int64)
    for ns in range(20):
        out[ns] = sum(int(c[8 * ns + i]) << i for i in range(8)) % 30
    return out


@functools.lru_cache(maxsize=None)
def pusch_dmrs(cell_id: int, sf_idx: int, n_prb: int, cyclic_shift: int = 0,
               cyclic_shift_dmrs: int = 0, delta_ss: int = 0,
               group_hopping: bool = False) -> np.ndarray:
    """PUSCH DMRS for both slots: (2, 12*n_prb) complex64."""
    m_sc = 12 * n_prb
    out = np.zeros((2, m_sc), dtype=np.complex64)
    n_prs = n_prs_table(cell_id, delta_ss)
    f_gh = f_gh_table(cell_id, group_hopping)
    for i, ns in enumerate((2 * sf_idx, 2 * sf_idx + 1)):
        u = (int(f_gh[ns]) + cell_id % 30 + delta_ss) % 30
        v = 0
        n_cs = (int(N_DMRS_1[cyclic_shift]) + int(N_DMRS_2[cyclic_shift_dmrs]) + int(n_prs[ns])) % 12
        alpha = 2 * np.pi * n_cs / 12
        r = base_sequence(u, v, m_sc)
        out[i] = r * np.exp(1j * alpha * np.arange(m_sc))
    return out
