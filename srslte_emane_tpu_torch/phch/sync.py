"""PSS/SSS synchronization signals, eNB side.

Twin of the eNB part of the reference's `phch/sync.py` (`lib/src/phy/sync/
pss.c`: ZC roots u in {25, 29, 34}; `sync/sss.c`: m-sequence SSS): the
sequences are host numpy, and `put_pss_sss` writes them into a subframe
grid on the device (enb_dl.c put_base).  The UE-side search (PSS
correlation, SSS detection, cell search) is not in the port yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import cplx, ofdm

PSS_ROOTS = {0: 25, 1: 29, 2: 34}


@functools.lru_cache(maxsize=None)
def pss_freq(n_id_2: int) -> np.ndarray:
    """62-length ZC PSS (36.211 §6.11.1)."""
    u = PSS_ROOTS[n_id_2]
    n = np.arange(31)
    a = np.exp(-1j * np.pi * u * n * (n + 1) / 63)
    b = np.exp(-1j * np.pi * u * (n + 31 + 1) * (n + 31 + 2) / 63)
    return np.concatenate([a, b]).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def pss_time(n_id_2: int, fft_size: int = 128) -> np.ndarray:
    """Time-domain PSS replica (one OFDM symbol, no CP), unit energy."""
    x = np.zeros(fft_size, dtype=np.complex64)
    d = pss_freq(n_id_2)
    # subcarriers -31..-1, +1..+31
    x[fft_size - 31 :] = d[:31]
    x[1:32] = d[31:]
    t = np.fft.ifft(x)
    return (t / np.linalg.norm(t)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _mseq(poly_taps: tuple) -> np.ndarray:
    """31-length m-sequence in bipolar form, x(0..4) init = (0,0,0,0,1)."""
    x = np.zeros(31, dtype=np.int64)
    x[4] = 1
    for i in range(26):
        x[i + 5] = sum(x[i + t] for t in poly_taps) % 2
    return (1 - 2 * x).astype(np.float32)


def _s_tilde():
    return _mseq((0, 2))  # x^5 + x^2 + 1


def _c_tilde():
    return _mseq((0, 3))  # x^5 + x^3 + 1


def _z_tilde():
    return _mseq((0, 1, 2, 4))  # x^5 + x^4 + x^2 + x + 1


def _m0m1(n_id_1: int):
    qp = n_id_1 // 30
    q = (n_id_1 + qp * (qp + 1) // 2) // 30
    mp = n_id_1 + q * (q + 1) // 2
    m0 = mp % 31
    m1 = (m0 + mp // 31 + 1) % 31
    return m0, m1


@functools.lru_cache(maxsize=None)
def sss_sequence(n_id_1: int, n_id_2: int, sf_idx: int) -> np.ndarray:
    """62-length bipolar SSS (36.211 §6.11.2); sf_idx in {0, 5}."""
    m0, m1 = _m0m1(n_id_1)
    s, c, z = _s_tilde(), _c_tilde(), _z_tilde()
    n = np.arange(31)
    s0 = s[(n + m0) % 31]
    s1 = s[(n + m1) % 31]
    c0 = c[(n + n_id_2) % 31]
    c1 = c[(n + n_id_2 + 3) % 31]
    z0 = z[(n + (m0 % 8)) % 31]
    z1 = z[(n + (m1 % 8)) % 31]
    d = np.zeros(62, dtype=np.float32)
    if sf_idx == 0:
        d[0::2] = s0 * c0
        d[1::2] = s1 * c1 * z0
    else:
        d[0::2] = s1 * c0
        d[1::2] = s0 * c1 * z1
    return d


@functools.lru_cache(maxsize=32)
def _device_tables(cell, sf_idx: int, device: torch.device):
    """(flat PSS REs, flat SSS REs, PSS values, SSS values) on `device`."""
    nre = cell.nre
    l_pss = 6 if cell.cp == "normal" else 5
    ks = np.arange(nre // 2 - 31, nre // 2 + 31, dtype=np.int64)
    sss = sss_sequence(cell.cell_id // 3, cell.cell_id % 3, sf_idx).astype(np.complex64)
    return (torch.from_numpy(l_pss * nre + ks).to(device),
            torch.from_numpy((l_pss - 1) * nre + ks).to(device),
            cplx.from_numpy(pss_freq(cell.cell_id % 3), device),
            cplx.from_numpy(sss, device))


def put_pss_sss(grid: torch.Tensor, cell, sf_idx: int) -> torch.Tensor:
    """eNB-side: place PSS (last symbol of slot 0) and SSS (one earlier) on
    sf 0/5 (enb_dl.c put_base equivalent), into a copy of grid.  Normal CP:
    symbols 6/5; extended CP: symbols 5/4 (6-symbol slots, 36.211 6.11)."""
    if sf_idx not in (0, 5):
        return grid
    pss_re, sss_re, pss, sss = _device_tables(cell, sf_idx, grid.device)
    flat = grid.reshape(grid.shape[0], -1, 2).clone()
    flat[:, pss_re, :] = pss
    flat[:, sss_re, :] = sss
    return flat.reshape(grid.shape)


def pss_symbol_start(n_prb: int) -> int:
    """Sample index of the PSS symbol (no CP) within the subframe, normal CP
    (the port's OFDM is normal-CP only)."""
    p = ofdm.params(n_prb)
    return (p["cp0"] + p["n"]) + 5 * (p["cp"] + p["n"]) + p["cp"]
