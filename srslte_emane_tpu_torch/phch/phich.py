"""PHICH: HARQ indicator channel (normal duration, normal CP).

Twin of the reference's `phch/phich.py` (`lib/src/phy/phch/phich.c`): BPSK
ACK/NACK, 3x repetition, length-4 orthogonal Walsh spreading (8 sequences:
4 real, 4 imaginary), cell/subframe scrambling, superposition of up to 8
PHICHs per group on 3 REGs.  Encode and decode of all groups and sequence
indices are one einsum each against the (8, 12) spread-scramble matrix.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import sequence as seq_mod
from ..utils.devices import table_cache
from . import chest, grid as grid_mod, regs as regs_mod

NSF = 4  # spreading factor, normal CP
# 36.211 Table 6.9.1-2 orthogonal sequences (seq 0-3 real, 4-7 = j * seq 0-3)
WALSH = np.array(
    [[1, 1, 1, 1], [1, -1, 1, -1], [1, 1, -1, -1], [1, -1, -1, 1]], dtype=np.float32
)


def n_groups(n_prb: int, ng: str = "1") -> int:
    return int(np.ceil(regs_mod.PHICH_NG[ng] * n_prb / 8))


def alloc(i_prb_lowest: int, n_dmrs: int, n_group: int) -> tuple:
    """(n_group, n_seq) for a PUSCH's HARQ indicator (36.213 §9.1.2):
    derived from the PUSCH's lowest PRB and its DMRS cyclic shift —
    the mapping the eNB and UE must agree on without signalling
    (lib/src/phy/phch/phich.c:131-134 ngroup/nseq calc)."""
    g = (i_prb_lowest + n_dmrs) % n_group
    s = (i_prb_lowest // n_group + n_dmrs) % (2 * NSF)
    return g, s


@functools.lru_cache(maxsize=None)
def re_indices(cell: grid_mod.CellConfig, ng: str = "1") -> np.ndarray:
    ch = regs_mod.channel_regs(cell.n_prb, cell.cell_id, cell.n_ports, ng)
    return regs_mod.reg_re_indices(
        cell.n_prb, cell.cell_id, cell.n_ports, ch["phich"]
    ).reshape(ch["phich"].shape[0], 12)


@functools.lru_cache(maxsize=None)
def _spread_matrix(cell_id: int, sf_idx: int) -> np.ndarray:
    """(8, 12, 2) cf: sequence nseq -> spread+scrambled unit-ACK waveform.
    d(i) = w(i mod 4) * (1 - 2 c(i)), repeated x3 (phich.c)."""
    c_init = ((sf_idx + 1) * (2 * cell_id + 1) << 9) + cell_id
    c = seq_mod.gold_sequence_host(c_init, 12).astype(np.float32)
    scr = 1.0 - 2.0 * c
    out = np.zeros((8, 12, 2), dtype=np.float32)
    for nseq in range(8):
        w = WALSH[nseq % 4]
        d = np.tile(w, 3) * scr
        if nseq < 4:
            out[nseq, :, 0] = d
        else:
            out[nseq, :, 1] = d
    return out


@table_cache(32)
def _device_tables(cell: grid_mod.CellConfig, sf_idx: int, ng: str, device: torch.device):
    """(RE indices (G, 12) int64, spread matrix (8, 12, 2)) on `device`."""
    return (torch.from_numpy(re_indices(cell, ng).astype(np.int64)).to(device),
            torch.from_numpy(_spread_matrix(cell.cell_id, sf_idx)).to(device))


def encode(acks: torch.Tensor, cell: grid_mod.CellConfig, sf_idx: int, grid: torch.Tensor,
           ng: str = "1") -> torch.Tensor:
    """acks: (B, ngroups, 8) in {-1 (nack), 0 (off), +1 (ack)} — superposed.
    Places all PHICH groups into a copy of grid."""
    idx, sm = _device_tables(cell, sf_idx, ng, grid.device)
    d = torch.einsum("bgs,sic->bgic", acks.to(torch.float32), sm)  # (B, G, 12, 2)
    flat = grid.reshape(grid.shape[0], -1, 2).clone()
    flat[:, idx[: d.shape[1]].reshape(-1), :] = d.reshape(d.shape[0], -1, 2)
    return flat.reshape(grid.shape)


def decode(rx_grid: torch.Tensor, ce: torch.Tensor, cell: grid_mod.CellConfig, sf_idx: int,
           ng: str = "1") -> torch.Tensor:
    """Despread all (group, nseq) hypotheses.  Returns soft metrics
    (B, ngroups, 8): >0 means ACK."""
    idx, sm = _device_tables(cell, sf_idx, ng, rx_grid.device)
    B = rx_grid.shape[0]
    y = rx_grid.reshape(B, -1, 2)[:, idx.reshape(-1)]
    h = ce.reshape(B, -1, 2)[:, idx.reshape(-1)]
    x_eq, csi = chest.equalize_zf(y, h)
    x = (x_eq * csi[..., None]).reshape(B, idx.shape[0], 12, 2)
    # correlate: real part of <x, conj(spread)>
    return torch.einsum("bgic,sic->bgs", x, sm) / 12.0
