"""Neighbour-cell measurement: RSRP/RSRQ from CRS, over many cell ids.

Twin of the reference's `models/measure.py` (`srsue/src/phy/scell/
intra_measure.cc` neighbour RSRP over `chest_dl.c`'s measurement outputs).
The CRS positions and values of every candidate PCI are host tables,
uploaded once per (n_prb, sf, PCI list) and device; all candidates are one
gather and one product.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import cplx
from ..phch import grid as grid_mod


@functools.lru_cache(maxsize=16)
def _pilot_tables(n_prb: int, sf_idx: int, pci_list: tuple, port: int, device: torch.device):
    """(flat pilot positions (n_pci, n_pil), pilot values (n_pci, n_pil, 2))."""
    nre = 12 * n_prb
    pidx, vals = [], []
    for pci in pci_list:
        ks = grid_mod.crs_k(pci, n_prb, port)
        syms = grid_mod.pilot_syms(port)
        pidx.append((np.asarray(syms)[:, None] * nre + ks).reshape(-1))
        vals.append(grid_mod.crs_values(pci, sf_idx, n_prb, port).reshape(-1))
    return (torch.from_numpy(np.stack(pidx).astype(np.int64)).to(device),
            cplx.from_numpy(np.stack(vals), device))


def measure_cells(rx_grid: torch.Tensor, n_prb: int, sf_idx: int, pci_list, port: int = 0):
    """rx_grid: (B, 14, NRE, 2).  Returns dict pci -> (rsrp (B,), rsrq (B,)).

    RSRP = power of the LS estimate at that PCI's CRS, averaged coherently
    over each pilot pair and in power across pairs; RSRQ = N_PRB * RSRP /
    RSSI (36.214 definitions, wideband), with RSSI each row's mean RE power.
    (The reference averages RSSI over the batch and the symbols instead, per
    subcarrier, so its RSRQ has shape (NRE,) and fails to broadcast for
    1 < B != NRE.)"""
    B = rx_grid.shape[0]
    nre = 12 * n_prb
    pidx, r = _pilot_tables(n_prb, sf_idx, tuple(pci_list), port, rx_grid.device)
    flat = rx_grid.reshape(B, -1, 2)
    rssi = cplx.abs2(rx_grid).reshape(B, -1).mean(dim=-1)  # each row's mean RE power
    y = flat[:, pidx]  # (B, n_pci, n_pil, 2)
    h = cplx.mul_conj(y, r)
    coh = h.reshape(B, len(pci_list), -1, 2, 2).mean(dim=-2)  # (B, n_pci, groups, cf)
    rsrp = cplx.abs2(coh).mean(dim=-1)  # (B, n_pci)
    rsrq = n_prb * rsrp / (torch.clamp(rssi, min=1e-12) * nre / 12.0)[:, None]
    return {pci: (rsrp[:, i], rsrq[:, i]) for i, pci in enumerate(pci_list)}


def strongest_cell(rx_grid: torch.Tensor, n_prb: int, sf_idx: int, pci_list):
    meas = measure_cells(rx_grid, n_prb, sf_idx, pci_list)
    rsrps = torch.stack([meas[p][0] for p in pci_list], dim=1)
    best = rsrps.argmax(dim=1)  # the first maximum
    return [pci_list[int(b)] for b in best.cpu()], meas
