"""PCFICH: control format indicator channel.

Twin of the reference's `phch/pcfich.py` (`lib/src/phy/phch/pcfich.c`):
32-bit CFI codewords, cell/subframe scrambling, QPSK, 4 REG quadruplets
(placement from phch/regs.py).  Encode is a table lookup, scramble and
modulate; decode correlates the 32 descrambled LLRs with the 3 codewords,
batched (soft ML detection, as pcfich.c does).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import mimo, modem, scrambling
from . import chest, grid as grid_mod, regs as regs_mod

# 36.212 Table 5.3.4-1: repeating patterns (0,1,1) / (1,0,1) / (1,1,0), 32 bits
CFI_CODEWORDS = np.stack(
    [np.tile(np.array(p, dtype=np.int8), 11)[:32]
     for p in ((0, 1, 1), (1, 0, 1), (1, 1, 0))]
)


@functools.lru_cache(maxsize=None)
def re_indices(cell: grid_mod.CellConfig) -> np.ndarray:
    ch = regs_mod.channel_regs(cell.n_prb, cell.cell_id, cell.n_ports)
    return regs_mod.reg_re_indices(
        cell.n_prb, cell.cell_id, cell.n_ports, ch["pcfich"]
    ).reshape(-1)


@functools.lru_cache(maxsize=32)
def _device_tables(cell: grid_mod.CellConfig, device: torch.device):
    """(RE indices (16,), codewords (3, 32) int8, bipolar codewords (32, 3))."""
    bip = 1.0 - 2.0 * CFI_CODEWORDS.astype(np.float32)
    return (torch.from_numpy(re_indices(cell).astype(np.int64)).to(device),
            torch.from_numpy(CFI_CODEWORDS).to(device),
            torch.from_numpy(np.ascontiguousarray(bip.T)).to(device))


def encode(cfi, cell: grid_mod.CellConfig, sf_idx: int, grid: torch.Tensor) -> torch.Tensor:
    """Place PCFICH for CFI (int, or (B,) tensor, values 1..3) into a copy
    of grid (B, 14, NRE, 2)."""
    idx, codewords, _ = _device_tables(cell, grid.device)
    bits = codewords[torch.as_tensor(cfi, device=grid.device) - 1]
    if bits.ndim == 1:
        bits = bits.expand(grid.shape[0], 32)
    scr = scrambling.scramble_bits(bits, scrambling.pcfich_cinit(sf_idx, cell.cell_id))
    syms = modem.modulate(scr, modem.QPSK)  # (B, 16, 2)
    flat = grid.reshape(grid.shape[0], -1, 2).clone()
    flat[:, idx, :] = syms
    return flat.reshape(grid.shape)


def decode(rx_grid: torch.Tensor, ce: torch.Tensor, cell: grid_mod.CellConfig, sf_idx: int,
           ce_port1=None):
    """Soft-ML CFI detection.  Returns (cfi (B,) int32 in 1..3, corr (B, 3));
    on equal correlations the smaller CFI wins, as with the reference's argmax.

    With ce_port1 given, uses SFBC/Alamouti combining (2-port cells)."""
    idx, _, bip = _device_tables(cell, rx_grid.device)
    B = rx_grid.shape[0]
    y = rx_grid.reshape(B, -1, 2)[:, idx]
    h = ce.reshape(B, -1, 2)[:, idx]
    if ce_port1 is not None:
        h1 = ce_port1.reshape(B, -1, 2)[:, idx]
        layers, csi = mimo.decode_sfbc(y, torch.stack([h, h1], dim=1))
        x_eq = mimo.layer_demap(layers, 1)[0]
        w = csi.transpose(-1, -2).reshape(B, -1)
    else:
        x_eq, w = chest.equalize_zf(y, h)
    llr = modem.demod_soft(x_eq, modem.QPSK) * torch.repeat_interleave(w, 2, dim=-1)
    llr = scrambling.scramble_llrs(llr, scrambling.pcfich_cinit(sf_idx, cell.cell_id))
    corr = llr @ bip  # correlation with bipolar codewords (positive llr = bit 0)
    return corr.argmax(dim=-1).to(torch.int32) + 1, corr
