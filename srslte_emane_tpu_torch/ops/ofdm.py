"""CP-OFDM modulation/demodulation (normal and extended CP, and the
hybrid-CP MBSFN subframe) over ops/dft.py.

Twin of the reference's `ops/ofdm.py`.  Grid convention: a subframe resource
grid is a cf tensor (..., n_sym, NRE, 2) with NRE = 12*n_prb (n_sym 14 for
normal CP, 12 for extended); subcarrier k maps to FFT bin (k - NRE/2) mod N
for the negative half and k - NRE/2 + 1 for the positive half (DC
punctured), per 36.211 §6.12.  Time-domain subframes are
(..., SF_LEN, 2).  All symbols transform as one batched FFT; CP insertion
and removal are each one gather with a host-built index table.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import dft


@functools.lru_cache(maxsize=None)
def params(n_prb: int, n_fft: int = None, cp: str = "normal"):
    """FFT size, CP lengths and subframe length.  n_fft overrides the
    power-of-2 default: srsLTE's reduced rates use 384/768/1152/1536 for
    25/50/75/100 PRB (phy_common.c srslte_symbol_sz).  cp="ext": 6 symbols
    per slot, every CP N/4."""
    n = n_fft or dft.OFDM_SYMBOL_SZ[n_prb]
    if cp == "normal":
        cp0 = 160 * n // 2048
        cpl = 144 * n // 2048
        sf_len = 2 * (cp0 + n + 6 * (cpl + n))
        n_sym = 14
    else:
        cp0 = cpl = 512 * n // 2048
        sf_len = 2 * 6 * (cpl + n)
        n_sym = 12
    return dict(n=n, cp0=cp0, cp=cpl, sf_len=sf_len, nre=12 * n_prb, n_sym=n_sym)


@functools.lru_cache(maxsize=None)
def _bin_map(n_prb: int, n_fft: int = None) -> np.ndarray:
    p = params(n_prb, n_fft)
    nre, n = p["nre"], p["n"]
    k = np.arange(nre)
    return np.where(k < nre // 2, (k - nre // 2) % n, k - nre // 2 + 1).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _symbol_starts(n_prb: int, cp: str = "normal") -> tuple:
    """(start, cp_len) of each OFDM symbol within the subframe."""
    p = params(n_prb, cp=cp)
    out = []
    t = 0
    for _ in range(2):
        for l in range(p["n_sym"] // 2):
            cpl = p["cp0"] if l == 0 else p["cp"]
            out.append((t, cpl))
            t += cpl + p["n"]
    assert t == p["sf_len"]
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _cp_tables(n_prb: int, cp: str = "normal"):
    """(add (SF_LEN,), remove (n_sym*N,)): the (symbol, sample) position in
    the flattened (n_sym*N) symbol array of every subframe sample, and the
    subframe sample read for every (symbol, sample) position."""
    n = params(n_prb)["n"]
    add, remove = [], []
    for l, (start, cpl) in enumerate(_symbol_starts(n_prb, cp)):
        add.append(l * n + np.concatenate([np.arange(n - cpl, n), np.arange(n)]))
        remove.append(start + cpl + np.arange(n))
    return np.concatenate(add), np.concatenate(remove)


@functools.lru_cache(maxsize=16)
def _device_tables(n_prb: int, device: torch.device, cp: str = "normal"):
    add, remove = _cp_tables(n_prb, cp)
    f = lambda a: torch.from_numpy(a).to(device)
    return f(_bin_map(n_prb)), f(add), f(remove)


def modulate(grid: torch.Tensor, n_prb: int, cp: str = "normal") -> torch.Tensor:
    """Resource grid (..., n_sym, NRE, 2) -> time samples (..., SF_LEN, 2)."""
    p = params(n_prb, cp=cp)
    bins, add, _ = _device_tables(n_prb, grid.device, cp)
    x = grid.new_zeros(grid.shape[:-3] + (p["n_sym"], p["n"], 2))
    x[..., bins, :] = grid
    time = dft.idft(x)  # (..., n_sym, N, 2)
    flat = time.reshape(grid.shape[:-3] + (p["n_sym"] * p["n"], 2))
    return flat[..., add, :]


def demodulate(samples: torch.Tensor, n_prb: int, cp: str = "normal") -> torch.Tensor:
    """Time samples (..., SF_LEN, 2) -> resource grid (..., n_sym, NRE, 2)."""
    p = params(n_prb, cp=cp)
    bins, _, remove = _device_tables(n_prb, samples.device, cp)
    x = samples[..., remove, :].reshape(samples.shape[:-2] + (p["n_sym"], p["n"], 2))
    return dft.dft(x)[..., bins, :]


# ---------------- MBSFN hybrid-CP subframes (ofdm.c mbsfn path) ----------------

N_SYM_MBSFN = 10  # extended-CP symbols after the 2-symbol non-MBSFN region


@functools.lru_cache(maxsize=None)
def mbsfn_layout(n_prb: int, n_fft: int = None):
    """(starts, cps) of the 2 normal-CP control symbols, the guard length,
    and the 10 extended-CP MBSFN symbols (ofdm.c:122-147)."""
    p = params(n_prb, n_fft)
    n = p["n"]
    cp_ext = 512 * n // 2048
    out = [(0, p["cp0"]), (p["cp0"] + n, p["cp"])]
    t = p["cp0"] + p["cp"] + 2 * n
    guard = 2 * cp_ext - p["cp0"] - p["cp"]
    t += guard
    mb = []
    for _ in range(N_SYM_MBSFN):
        mb.append((t, cp_ext))
        t += cp_ext + n
    assert t == p["sf_len"], (t, p["sf_len"])
    return tuple(out), guard, tuple(mb)


@functools.lru_cache(maxsize=None)
def _mbsfn_cp_tables(n_prb: int, n_fft: int = None):
    """(add (SF_LEN,), remove (12*N,)) for the 2 + 10 symbols of an MBSFN
    subframe, as `_cp_tables`; the guard samples read position 12*N, a
    zero row appended after the symbols."""
    n = params(n_prb, n_fft)["n"]
    ctrl, guard, mb = mbsfn_layout(n_prb, n_fft)
    add, remove = [], []
    for l, (start, cpl) in enumerate(ctrl + mb):
        if l == len(ctrl):
            add.append(np.full(guard, (len(ctrl) + len(mb)) * n))
        add.append(l * n + np.concatenate([np.arange(n - cpl, n), np.arange(n)]))
        remove.append(start + cpl + np.arange(n))
    return np.concatenate(add), np.concatenate(remove)


@functools.lru_cache(maxsize=16)
def _mbsfn_device_tables(n_prb: int, device: torch.device, n_fft: int = None):
    add, remove = _mbsfn_cp_tables(n_prb, n_fft)
    f = lambda a: torch.from_numpy(a).to(device)
    return f(_bin_map(n_prb, n_fft)), f(add), f(remove)


def modulate_mbsfn(ctrl_grid: torch.Tensor, mbsfn_grid: torch.Tensor, n_prb: int) -> torch.Tensor:
    """(B, 2, NRE, 2) control (normal CP) + (B, 10, NRE, 2) MBSFN (ext CP)
    -> (B, SF_LEN, 2)."""
    n = params(n_prb)["n"]
    bins, add, _ = _mbsfn_device_tables(n_prb, ctrl_grid.device)
    grid = torch.cat([ctrl_grid, mbsfn_grid.to(ctrl_grid.dtype)], dim=-3)
    x = grid.new_zeros(grid.shape[:-3] + (grid.shape[-3], n, 2))
    x[..., bins, :] = grid
    flat = dft.idft(x).reshape(grid.shape[:-3] + (-1, 2))
    flat = torch.cat([flat, flat.new_zeros(flat.shape[:-2] + (1, 2))], dim=-2)
    return flat[..., add, :]


def demodulate_mbsfn(samples: torch.Tensor, n_prb: int, n_fft: int = None):
    """-> (ctrl (B, 2, NRE, 2), mbsfn (B, 10, NRE, 2)); n_fft as `params`."""
    n = params(n_prb, n_fft)["n"]
    bins, _, remove = _mbsfn_device_tables(n_prb, samples.device, n_fft)
    x = samples[..., remove, :].reshape(samples.shape[:-2] + (2 + N_SYM_MBSFN, n, 2))
    grid = dft.dft(x)[..., bins, :]
    return grid[..., :2, :, :], grid[..., 2:, :, :]
