"""CP-OFDM modulation/demodulation (normal CP) over ops/dft.py.

Twin of the reference's `ops/ofdm.py`.  Grid convention: a subframe resource
grid is a cf tensor (..., 14, NRE, 2) with NRE = 12*n_prb; subcarrier k maps
to FFT bin (k - NRE/2) mod N for the negative half and k - NRE/2 + 1 for the
positive half (DC punctured), per 36.211 §6.12.  Time-domain subframes are
(..., SF_LEN, 2).  All 14 symbols transform as one batched FFT; CP insertion
and removal are each one gather with a host-built index table.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import dft


@functools.lru_cache(maxsize=None)
def params(n_prb: int):
    """FFT size, CP lengths and subframe length at the power-of-2 rate."""
    n = dft.OFDM_SYMBOL_SZ[n_prb]
    cp0 = 160 * n // 2048
    cpl = 144 * n // 2048
    sf_len = 2 * (cp0 + n + 6 * (cpl + n))
    return dict(n=n, cp0=cp0, cp=cpl, sf_len=sf_len, nre=12 * n_prb, n_sym=14)


@functools.lru_cache(maxsize=None)
def _bin_map(n_prb: int) -> np.ndarray:
    p = params(n_prb)
    nre, n = p["nre"], p["n"]
    k = np.arange(nre)
    return np.where(k < nre // 2, (k - nre // 2) % n, k - nre // 2 + 1).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _symbol_starts(n_prb: int) -> tuple:
    """(start, cp_len) of each OFDM symbol within the subframe."""
    p = params(n_prb)
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
def _cp_tables(n_prb: int):
    """(add (SF_LEN,), remove (14*N,)): the (symbol, sample) position in the
    flattened (14*N) symbol array of every subframe sample, and the subframe
    sample read for every (symbol, sample) position."""
    n = params(n_prb)["n"]
    add, remove = [], []
    for l, (start, cpl) in enumerate(_symbol_starts(n_prb)):
        add.append(l * n + np.concatenate([np.arange(n - cpl, n), np.arange(n)]))
        remove.append(start + cpl + np.arange(n))
    return np.concatenate(add), np.concatenate(remove)


@functools.lru_cache(maxsize=16)
def _device_tables(n_prb: int, device: torch.device):
    add, remove = _cp_tables(n_prb)
    f = lambda a: torch.from_numpy(a).to(device)
    return f(_bin_map(n_prb)), f(add), f(remove)


def modulate(grid: torch.Tensor, n_prb: int) -> torch.Tensor:
    """Resource grid (..., 14, NRE, 2) -> time samples (..., SF_LEN, 2)."""
    p = params(n_prb)
    bins, add, _ = _device_tables(n_prb, grid.device)
    x = grid.new_zeros(grid.shape[:-3] + (p["n_sym"], p["n"], 2))
    x[..., bins, :] = grid
    time = dft.idft(x)  # (..., 14, N, 2)
    flat = time.reshape(grid.shape[:-3] + (p["n_sym"] * p["n"], 2))
    return flat[..., add, :]


def demodulate(samples: torch.Tensor, n_prb: int) -> torch.Tensor:
    """Time samples (..., SF_LEN, 2) -> resource grid (..., 14, NRE, 2)."""
    p = params(n_prb)
    bins, _, remove = _device_tables(n_prb, samples.device)
    x = samples[..., remove, :].reshape(samples.shape[:-2] + (p["n_sym"], p["n"], 2))
    return dft.dft(x)[..., bins, :]
