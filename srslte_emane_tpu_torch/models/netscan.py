"""Beacon synthesis with the cell id as data: N heterogeneous cells in one
call, and the network scan over them.

Twin of the reference's `models/netscan.py` (srsLTE specializes every cell
object to its PCI at init: CRS sequences in `refsignal_dl.c`, PSS/SSS in
`sync/pss.c`, `sss.c`; a scan walks them serially, `intra_measure.cc`).
Here the CRS c_init arithmetic runs on the device for a tensor of cell ids
and the Gold sequences are one GF(2) product (`ops/sequence.py`); the
frequency shift (cell_id mod 6) is an index computed per cell; PSS/SSS
come from 3- and 504-row tables gathered by id.  The scan superposes the
beacons through a gain matrix and runs one batched cell search.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import cplx, ofdm, sequence
from ..phch import grid as grid_mod, sync
from ..utils.devices import resolve

MAX_PRB = 110


@functools.lru_cache(maxsize=4)
def _sss_table(sf_idx: int) -> np.ndarray:
    """(504, 62) bipolar SSS for every cell id at subframe 0 or 5."""
    out = np.zeros((504, 62), np.float32)
    for cid in range(504):
        out[cid] = sync.sss_sequence(cid // 3, cid % 3, sf_idx)
    return out


@functools.lru_cache(maxsize=2)
def _pss_table() -> np.ndarray:
    """(3, 62) complex PSS replicas."""
    return np.stack([sync.pss_freq(h) for h in range(3)])


@functools.lru_cache(maxsize=8)
def _sync_tables(sf_idx: int, device: torch.device):
    """(PSS (3, 62, 2), SSS (504, 62, 2)) on `device`."""
    sss = _sss_table(sf_idx)
    return (cplx.from_numpy(_pss_table(), device),
            torch.from_numpy(np.stack([sss, np.zeros_like(sss)], -1)).to(device))


def _crs_values_traced(cell_ids: torch.Tensor, sf_idx: int, n_prb: int) -> torch.Tensor:
    """(N, 4, 2*n_prb, 2) port-0 CRS pilot values for a tensor of cell ids:
    grid.crs_values with c_init computed on the device (36.211 §6.10.1.1),
    c_init = 2^10 (7(ns+1)+l+1)(2 cid+1) + 2 cid + 1 [normal CP]."""
    cid = torch.as_tensor(cell_ids, dtype=torch.int64)
    N = cid.shape[0]
    syms = grid_mod.pilot_syms(0)  # (0, 4, 7, 11)
    ns_l = np.array([(2 * sf_idx + s // 7, s % 7) for s in syms], np.int64)
    sym_f = torch.from_numpy(7 * (ns_l[:, 0] + 1) + ns_l[:, 1] + 1).to(cid.device)
    c_init = 1024 * sym_f[None, :] * (2 * cid[:, None] + 1) + 2 * cid[:, None] + 1  # (N, 4)
    c = sequence.gold_sequence(c_init.reshape(-1), 4 * MAX_PRB)
    c = c.reshape(N, len(syms), 4 * MAX_PRB).to(torch.float32)
    mp = torch.arange(2 * n_prb, device=cid.device) + MAX_PRB - n_prb
    re = (1.0 - 2.0 * c[..., 2 * mp]) / np.sqrt(2.0)
    im = (1.0 - 2.0 * c[..., 2 * mp + 1]) / np.sqrt(2.0)
    return cplx.make(re, im)


def build_beacons(cell_ids, n_prb: int = 6, sf_idx: int = 0, device="cuda") -> torch.Tensor:
    """(N, 14, 12*n_prb, 2) beacon grids (port-0 CRS + PSS/SSS) for (N,)
    cell ids (array or tensor), built on `device` ("cuda" by default: it
    raises where there is no card)."""
    dev = resolve(device, "build_beacons")
    cid = torch.as_tensor(cell_ids, dtype=torch.int64).to(dev)
    N, nre = cid.shape[0], 12 * n_prb
    vals = _crs_values_traced(cid, sf_idx, n_prb)  # (N, 4, 2*n_prb, 2)
    # pilot subcarriers: k = (v + cid % 6) % 6 + 6m
    v = torch.tensor([grid_mod.cs_v(0, i) for i in range(4)], device=dev)  # 0, 3, 0, 3
    k = ((v[None, :, None] + (cid % 6)[:, None, None]) % 6
         + 6 * torch.arange(2 * n_prb, device=dev)[None, None, :])  # (N, 4, P)
    syms = torch.tensor(grid_mod.pilot_syms(0), device=dev)
    grid = torch.zeros((N, 14, nre, 2), device=dev)
    grid[torch.arange(N, device=dev)[:, None, None], syms[None, :, None], k] = vals
    # PSS (symbol 6) / SSS (symbol 5): constant tables gathered by id
    ks = torch.arange(nre // 2 - 31, nre // 2 + 31, device=dev)
    pss, sss = _sync_tables(sf_idx, dev)
    grid[:, 6, ks] = pss[cid % 3]
    grid[:, 5, ks] = sss[cid]
    return grid


def beacon_waveforms(cell_ids, n_prb: int = 6, sf_idx: int = 0, device="cuda") -> torch.Tensor:
    """(N, T, 2) time-domain beacon subframes (1.92 Msps at 6 PRB) on `device`."""
    return ofdm.modulate(build_beacons(cell_ids, n_prb, sf_idx, device), n_prb)


def network_scan(mesh, cell_ids, gains, gen: torch.Generator = None,
                 noise_std: float = 0.0, n_prb: int = 6, device="cuda"):
    """Scan: synthesize all cells' beacons, superpose them through the link
    matrix, and run a batched cell search on every observation point's
    capture.

    cell_ids: (N,) ints (array or tensor); the scan runs on `device`
    ("cuda" by default: it raises where there is no card); gains:
    (N, N) complex rx-by-tx link matrix (diagonal ignored).  Returns the
    `sync.cell_search` dict per row: observation point i sees the
    gain-weighted sum of all OTHER cells, plus noise_std complex white noise
    from `gen`.  mesh must be None: the sharded medium
    (parallel/ota_collective.py) is not in the port yet."""
    if mesh is not None:
        raise NotImplementedError(
            "network_scan over a device mesh needs parallel/ota_collective.py, which the "
            "port does not have yet (ROADMAP.md slice 14); pass mesh=None")
    tx = beacon_waveforms(cell_ids, n_prb, device=device)  # (N, T, 2)
    g = np.asarray(gains, np.complex64) * (1.0 - np.eye(tx.shape[0], dtype=np.float32))
    gr = torch.from_numpy(np.ascontiguousarray(g.real)).to(tx.device)
    gi = torch.from_numpy(np.ascontiguousarray(g.imag)).to(tx.device)
    xr, xi = tx[..., 0], tx[..., 1]
    rx = cplx.make(gr @ xr - gi @ xi, gr @ xi + gi @ xr)
    if noise_std and gen is not None:
        rx = rx + noise_std * torch.randn(rx.shape, generator=gen, device=rx.device) / np.sqrt(2.0)
    return sync.cell_search(rx)
