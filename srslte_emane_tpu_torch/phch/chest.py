"""Downlink channel estimation: LS at CRS + freq/time linear interpolation.

Twin of the reference's `phch/chest.py` (chest_dl.c:125-141): LS estimates
at the pilot REs, then interpolation as two constant matrices built on the
host once per layout — (pilots -> NRE) in frequency, (pilot symbols -> 14)
in time — applied as float32 products.  Noise comes from the residual
between raw LS pilots and their 3-tap smoothing (chest_dl.h:70-74).
"""

from __future__ import annotations

import functools
import typing

import numpy as np
import torch

from ..ops import cplx
from . import grid as grid_mod


@functools.lru_cache(maxsize=None)
def _freq_interp_matrix(n_prb: int, fidx0: int) -> np.ndarray:
    """(NRE, 2*n_prb) linear interp/extrapolation from pilots at
    k = fidx0 + 6m to all NRE subcarriers."""
    nre = 12 * n_prb
    npil = 2 * n_prb
    pk = fidx0 + 6 * np.arange(npil)
    m = np.zeros((nre, npil), dtype=np.float32)
    for k in range(nre):
        j = np.clip((k - fidx0) / 6.0, 0, npil - 1)
        j0 = int(np.clip(np.floor(j), 0, npil - 2))
        t = (k - pk[j0]) / 6.0
        m[k, j0] = 1 - t
        m[k, j0 + 1] = t
    return m


@functools.lru_cache(maxsize=None)
def _time_interp_matrix(syms: tuple, n_sym: int = grid_mod.N_SYM) -> np.ndarray:
    """(n_sym, len(syms)) linear interp/extrapolation across OFDM symbols."""
    s = np.asarray(syms, dtype=np.float64)
    m = np.zeros((n_sym, len(s)), dtype=np.float32)
    for l in range(n_sym):
        if l <= s[0]:
            j0 = 0
        elif l >= s[-1]:
            j0 = len(s) - 2
        else:
            j0 = int(np.searchsorted(s, l, side="right")) - 1
            j0 = min(j0, len(s) - 2)
        t = (l - s[j0]) / (s[j0 + 1] - s[j0])
        m[l, j0] = 1 - t
        m[l, j0 + 1] = t
    return m


class ChestResult(typing.NamedTuple):
    ce: torch.Tensor  # (..., 14, NRE, 2) channel estimate
    noise_est: torch.Tensor  # (...,) noise variance estimate
    rsrp: torch.Tensor  # (...,) reference signal received power
    snr_db: torch.Tensor  # (...,)
    rssi: torch.Tensor = None  # (...,) mean RE power over the grid
    rsrq_db: torch.Tensor = None  # (...,) N_PRB * RSRP / RSSI
    sync_err: torch.Tensor = None  # (...,) timing offset estimate (samples)


@functools.lru_cache(maxsize=None)
def _crs_values10(cell_id: int, n_prb: int, port: int, cp: str) -> np.ndarray:
    """(10, S, P) CRS values for every subframe: the gather table for an
    sf_idx given as a tensor (pilot positions do not depend on sf)."""
    return np.stack([grid_mod.crs_values(cell_id, s, n_prb, port, cp) for s in range(10)])


@functools.lru_cache(maxsize=32)
def _device_tables(cell: grid_mod.CellConfig, sf_idx: int, port: int,
                   device: torch.device):
    """(pilot flat indices (S*P,), pilot values (S, P, 2), frequency
    matrices (S, NRE, P), time matrix (n_sym, S)) on `device`."""
    ks = grid_mod.crs_k(cell.cell_id, cell.n_prb, port, cell.cp)  # (S, P)
    syms = grid_mod.pilot_syms(port, cell.cp)
    pidx = (np.asarray(syms)[:, None] * cell.nre + ks).reshape(-1).astype(np.int64)
    vals = grid_mod.crs_values(cell.cell_id, sf_idx, cell.n_prb, port, cell.cp)
    fms = np.stack([_freq_interp_matrix(cell.n_prb, int(ks[i][0]))
                    for i in range(len(syms))])
    tm = _time_interp_matrix(tuple(syms), cell.n_sym)
    return (torch.from_numpy(pidx).to(device), cplx.from_numpy(vals, device),
            torch.from_numpy(fms).to(device), torch.from_numpy(tm).to(device))


def estimate(rx_grid: torch.Tensor, cell: grid_mod.CellConfig, sf_idx: int,
             port: int = 0) -> ChestResult:
    """LS + 2D linear interpolation channel estimate from port-`port` CRS.
    rx_grid: (..., n_sym, NRE, 2) received grid."""
    lead = rx_grid.shape[:-3]
    pidx, r_p, fms, tm = _device_tables(cell, int(sf_idx), port, rx_grid.device)
    S, P = r_p.shape[:2]
    flat = rx_grid.reshape(lead + (cell.n_sym * cell.nre, 2))
    y_p = flat[..., pidx, :].reshape(lead + (S, P, 2))
    h_ls = cplx.mul_conj(y_p, r_p)  # |r|^2 = 1

    # frequency interpolation per pilot symbol (offsets differ by symbol),
    # then time interpolation; the batch rides the products' wide dimension
    h = h_ls.reshape(-1, S, P, 2).permute(1, 2, 0, 3).reshape(S, P, -1)
    h_f = torch.bmm(fms, h)  # (S, NRE, batch*2)
    ce = (tm @ h_f.reshape(S, -1)).reshape(cell.n_sym, cell.nre, -1, 2)
    ce = ce.permute(2, 0, 1, 3).reshape(lead + (cell.n_sym, cell.nre, 2))

    # noise: residual between raw LS pilots and their 3-tap smoothing; 1.5
    # compensates the variance reduction of the 3-tap average (2/3 factor)
    ce_flat = ce.reshape(lead + (cell.n_sym * cell.nre, 2))
    h_at_p = ce_flat[..., pidx, :].reshape(y_p.shape)
    h_sm = (h_ls + torch.roll(h_ls, 1, dims=-2) + torch.roll(h_ls, -1, dims=-2)) / 3.0
    resid = cplx.abs2(h_ls - h_sm)
    noise = resid.reshape(lead + (-1,)).mean(dim=-1) * 1.5
    rsrp = cplx.abs2(h_at_p).reshape(lead + (-1,)).mean(dim=-1)
    snr = rsrp / torch.clamp(noise, min=1e-12)
    # RSSI / RSRQ (36.214 wideband definitions; chest_dl.h:49-68 outputs)
    rssi = cplx.abs2(rx_grid).reshape(lead + (-1,)).mean(dim=-1)
    rsrq = cell.n_prb * rsrp / torch.clamp(rssi * cell.nre / 12.0, min=1e-12)
    # timing offset from the mean per-subcarrier phase ramp of the LS pilots
    prod = cplx.mul_conj(h_ls[..., 1:, :], h_ls[..., :-1, :])
    acc = prod.reshape(lead + (-1, 2)).sum(dim=-2)
    ang = torch.atan2(acc[..., 1], acc[..., 0])
    n_fft = {6: 128, 15: 256, 25: 512, 50: 1024, 75: 1536, 100: 2048}[cell.n_prb]
    sync_err = -ang * n_fft / (2.0 * np.pi * 6.0)  # pilots are 6 sc apart
    return ChestResult(ce, noise, rsrp,
                       10.0 * torch.log10(torch.clamp(snr, min=1e-12)),
                       rssi, 10.0 * torch.log10(torch.clamp(rsrq, min=1e-12)),
                       sync_err)


def equalize_zf(rx, ce, eps: float = 1e-9):
    """ZF: x = y * conj(h) / |h|^2 ; also returns the per-RE CSI weight |h|^2
    (the csi-weighted LLR scaling of pdsch.c:574-686)."""
    csi = cplx.abs2(ce)
    x = cplx.mul_conj(rx, ce) / torch.clamp(csi, min=eps)[..., None]
    return x, csi


def equalize_mmse(rx, ce, noise, eps: float = 1e-9):
    csi = cplx.abs2(ce)
    noise = torch.as_tensor(noise, dtype=csi.dtype, device=csi.device)
    noise_b = noise.reshape(noise.shape + (1,) * (csi.ndim - noise.ndim))
    den = csi + noise_b + eps
    x = cplx.mul_conj(rx, ce) / den[..., None]
    return x, csi


@functools.lru_cache(maxsize=None)
def interp_matrix(pk: tuple, nre: int) -> np.ndarray:
    """(NRE, len(pk)) linear interp/extrapolation from pilots at arbitrary
    subcarriers pk (ascending) to all NRE subcarriers."""
    pk = np.asarray(pk, dtype=np.float64)
    m = np.zeros((nre, len(pk)), dtype=np.float32)
    for k in range(nre):
        if k <= pk[0]:
            j0 = 0
        elif k >= pk[-1]:
            j0 = len(pk) - 2
        else:
            j0 = min(int(np.searchsorted(pk, k, side="right")) - 1, len(pk) - 2)
        t = (k - pk[j0]) / (pk[j0 + 1] - pk[j0])
        m[k, j0] = 1 - t
        m[k, j0 + 1] = t
    return m
