"""PDSCH symbol chain, SISO (TM1).

Twin of the SISO part of the reference's `phch/pdsch.py` (pdsch.c:81-233
encode, pdsch.c:574-686 decode): scrambling -> modulation -> RE mapping
around the holes; decode: channel estimate -> equalize -> soft demod with
CSI weights -> descramble -> DL-SCH decode.  The RE map is a host table
(phch/grid.py) uploaded once per configuration and device; everything is
batched over subframes (axis B).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import cplx, modem, scrambling
from ..ops.fec import turbodecoder as _td
from . import chest, grid as grid_mod, sch


@functools.lru_cache(maxsize=32)
def _crs_table(cell: grid_mod.CellConfig, sf_idx: int, port: int, device: torch.device):
    """(flat CRS positions (n_crs,), CRS values (n_crs, 2)) of one port."""
    ks = grid_mod.crs_k(cell.cell_id, cell.n_prb, port, cell.cp)
    syms = grid_mod.pilot_syms(port, cell.cp)
    pidx = (np.asarray(syms)[:, None] * cell.nre + ks).reshape(-1).astype(np.int64)
    vals = grid_mod.crs_values(cell.cell_id, sf_idx, cell.n_prb, port, cell.cp)
    return torch.from_numpy(pidx).to(device), cplx.from_numpy(vals.reshape(-1), device)


@functools.lru_cache(maxsize=32)
def _re_table(cell: grid_mod.CellConfig, sf_idx: int, prb_mask: tuple,
              device: torch.device) -> torch.Tensor:
    idx = grid_mod.pdsch_re_indices(cell, sf_idx, prb_mask)
    return torch.from_numpy(idx.astype(np.int64)).to(device)


@functools.lru_cache(maxsize=32)
def _tx_gather(cell: grid_mod.CellConfig, sf_idx: int, prb_mask: tuple, port: int,
               device: torch.device) -> torch.Tensor:
    tbl = grid_mod.tx_gather_table(cell, sf_idx, prb_mask, port)
    return torch.from_numpy(tbl.astype(np.int64)).to(device)


def put_crs(grid: torch.Tensor, cell: grid_mod.CellConfig, sf_idx: int,
            port: int = 0) -> torch.Tensor:
    """Write the CRS pilots of `port` into grid (..., 14, NRE, 2)."""
    pidx, v = _crs_table(cell, int(sf_idx), port, grid.device)
    flat = grid.reshape(grid.shape[:-3] + (cell.n_sym * cell.nre, 2)).clone()
    flat[..., pidx, :] = v
    return flat.reshape(grid.shape)


def assemble_grid(syms: torch.Tensor, cell: grid_mod.CellConfig, sf_idx: int,
                  prb_mask: tuple, port: int = 0) -> torch.Tensor:
    """(B, n_re, 2) PDSCH symbols -> (B, 14, NRE, 2) grid with CRS, as ONE
    gather (see grid.tx_gather_table).  Unused REs are zero."""
    tbl = _tx_gather(cell, sf_idx, prb_mask, port, syms.device)
    _, crs_v = _crs_table(cell, sf_idx, port, syms.device)
    B = syms.shape[0]
    src = torch.cat([syms, crs_v.expand((B,) + crs_v.shape).to(syms.dtype),
                     syms.new_zeros((B, 1, 2))], dim=-2)
    return src[:, tbl].reshape(B, cell.n_sym, cell.nre, 2)


def encode(tb_bits: torch.Tensor, cfg: sch.SchConfig, cell: grid_mod.CellConfig,
           sf_idx: int, rnti: int, prb_mask: tuple, grid=None) -> torch.Tensor:
    """Encode one PDSCH grant into a subframe grid.

    tb_bits: (B, tbs).  Returns grid (B, 14, NRE, 2) with CRS + PDSCH placed
    (into a copy of `grid` if given)."""
    re_idx = _re_table(cell, sf_idx, prb_mask, tb_bits.device)
    assert cfg.G == len(re_idx) * cfg.Qm, (cfg.G, len(re_idx), cfg.Qm)
    cw = sch.encode_tb(tb_bits, cfg)  # (B, G)
    c_init = scrambling.pdsch_cinit(rnti, 0, sf_idx, cell.cell_id)
    scr = scrambling.scramble_bits(cw, c_init)
    syms = modem.modulate(scr, modem.MOD_FROM_QM[cfg.Qm])  # (B, n_re, 2)
    if grid is None:
        return assemble_grid(syms, cell, sf_idx, prb_mask)
    B = syms.shape[0]
    flat = grid.reshape(B, cell.n_sym * cell.nre, 2).clone()
    flat[:, re_idx, :] = syms
    return put_crs(flat.reshape(B, cell.n_sym, cell.nre, 2), cell, sf_idx)


def decode(rx_grid: torch.Tensor, cfg: sch.SchConfig, cell: grid_mod.CellConfig,
           sf_idx: int, rnti: int, prb_mask: tuple, softbuf=None, max_iter: int = 8,
           use_kernel: bool | None = None, llr_bits: int = 32):
    """Decode one PDSCH grant from a received subframe grid (B, 14, NRE, 2).

    Returns (payload bits (B, tbs), crc ok (B,), softbuf', ChestResult)."""
    re_idx = _re_table(cell, sf_idx, prb_mask, rx_grid.device)
    ch = chest.estimate(rx_grid, cell, sf_idx)
    flat_rx = rx_grid.reshape(rx_grid.shape[:-3] + (cell.n_sym * cell.nre, 2))
    flat_ce = ch.ce.reshape(flat_rx.shape)
    y = flat_rx[..., re_idx, :]
    h = flat_ce[..., re_idx, :]
    x_eq, csi = chest.equalize_zf(y, h)
    llr = modem.demod_soft(x_eq, modem.MOD_FROM_QM[cfg.Qm])  # (B, G)
    llr = llr * torch.repeat_interleave(csi, cfg.Qm, dim=-1)
    if _td.LOGMAP:
        # log-MAP needs true natural-log LLRs: the 2/sigma^2 term the
        # scale-invariant max-log default never needed (pdsch.py:303-308)
        llr = llr * (2.0 / torch.clamp(ch.noise_est, min=1e-9))[..., None]
    c_init = scrambling.pdsch_cinit(rnti, 0, sf_idx, cell.cell_id)
    llr = scrambling.scramble_llrs(llr, c_init)
    payload, ok, softbuf, _ = sch.decode_tb(llr, cfg, softbuf, max_iter,
                                            use_kernel=use_kernel, llr_bits=llr_bits)
    return payload, ok, softbuf, ch
