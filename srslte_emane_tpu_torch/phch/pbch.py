"""PBCH: physical broadcast channel (MIB).

Twin of the reference's `phch/pbch.py` (`lib/src/phy/phch/pbch.c`): 24-bit
MIB + CRC16 masked by the antenna-port pattern, K=7 tail-biting conv code,
rate match to 1920 bits (normal CP), 40 ms scrambling period, QPSK, 4
radio frames x 240 symbols on subframe 0 symbols 7-10 (center 72
subcarriers, CRS holes assume 4 ports).  The decoder tries all 4 frame
offsets and 3 port hypotheses (pbch.c:153); the 2- and 4-port hypotheses
share their LLRs, so 8 distinct rows go through ONE Viterbi call and the
CRC masks of the 12 hypotheses adjudicate.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import mimo, modem, scrambling
from ..ops.fec import convcoder, crc as crc_mod, viterbi
from ..utils.devices import table_cache
from . import chest, grid as grid_mod

MIB_LEN = 24
CODED = 1920  # normal CP
SEG = CODED // 4  # 480 bits / 240 symbols per radio frame

# 36.212 Table 5.3.1.1-1 CRC masks
PORT_MASKS = {
    1: np.zeros(16, dtype=np.int8),
    2: np.ones(16, dtype=np.int8),
    4: np.tile(np.array([0, 1], dtype=np.int8), 8),
}
PORT_HYPOTHESES = (1, 2, 4)


@functools.lru_cache(maxsize=None)
def re_indices(cell: grid_mod.CellConfig) -> np.ndarray:
    """(240,) flat grid indices of PBCH REs in one subframe-0 grid."""
    nre = cell.nre
    center = nre // 2
    vshift3 = cell.cell_id % 3
    idx = []
    for sym in (7, 8, 9, 10):
        for k in range(center - 36, center + 36):
            if sym in (7, 8) and (k % 3) == vshift3:
                continue  # CRS holes (4-port assumption per spec)
            idx.append(sym * nre + k)
    out = np.array(idx, dtype=np.int32)
    assert len(out) == 240
    return out


@table_cache(32)
def _device_tables(cell: grid_mod.CellConfig, device: torch.device):
    """(RE indices (240,) int64, CRC masks of the port hypotheses (3, 16)
    int8, the hypotheses' port counts (3,), the LLR row of each hypothesis
    (1-port, SFBC, SFBC) (3,))."""
    masks = np.stack([PORT_MASKS[p] for p in PORT_HYPOTHESES])
    return (torch.from_numpy(re_indices(cell).astype(np.int64)).to(device),
            torch.from_numpy(masks).to(device), torch.tensor(PORT_HYPOTHESES, device=device),
            torch.tensor([0, 1, 1], device=device))


@table_cache(8)
def _port_mask(n_ports: int, device: torch.device) -> torch.Tensor:
    """(16,) int8 CRC mask of a port count on `device`."""
    return torch.from_numpy(PORT_MASKS[n_ports]).to(device)


def _coded_bits(mib_bits: torch.Tensor, n_ports: int) -> torch.Tensor:
    """(B, 24) -> (B, 1920) coded bits (before scrambling)."""
    mask = _port_mask(n_ports, mib_bits.device)
    with_crc = crc_mod.crc_attach(mib_bits.to(torch.int8), crc_mod.LTE_CRC16)
    with_crc = torch.cat([with_crc[:, :MIB_LEN], with_crc[:, MIB_LEN:] ^ mask], dim=1)
    streams = convcoder.conv_encode(with_crc)  # (B, 3, 40)
    return convcoder.rate_match_cc(streams, CODED)


def encode(mib_bits: torch.Tensor, cell: grid_mod.CellConfig, sfn: int,
           grid: torch.Tensor) -> torch.Tensor:
    """Place this radio frame's PBCH segment (sfn mod 4) into a copy of
    the sf0 grid."""
    off = sfn % 4
    coded = _coded_bits(mib_bits, cell.n_ports)
    scr = scrambling.scramble_bits(coded, scrambling.pbch_cinit(cell.cell_id))
    syms = modem.modulate(scr[:, off * SEG : (off + 1) * SEG], modem.QPSK)  # (B, 240, 2)
    idx = _device_tables(cell, grid.device)[0]
    flat = grid.reshape(grid.shape[0], -1, 2).clone()
    flat[:, idx, :] = syms
    return flat.reshape(grid.shape)


def _llrs_port_hyp(rx_grid, ces, cell: grid_mod.CellConfig, n_ports: int):
    """PBCH symbol LLRs under a port-count hypothesis: SISO ZF for 1 port,
    SFBC/Alamouti combining over ports 0/1 for 2 (and, approximately, 4)."""
    B = rx_grid.shape[0]
    idx = _device_tables(cell, rx_grid.device)[0]
    y = rx_grid.reshape(B, -1, 2)[:, idx]
    if n_ports == 1:
        x_eq, csi = chest.equalize_zf(y, ces[0].reshape(B, -1, 2)[:, idx])
        return modem.demod_soft(x_eq, modem.QPSK) * torch.repeat_interleave(csi, 2, dim=-1)
    h = torch.stack([ces[p].reshape(B, -1, 2)[:, idx] for p in (0, 1)], dim=1)  # (B, 2, 240, 2)
    layers, csi = mimo.decode_sfbc(y, h)  # (B, 2, 120, 2), (B, 2, 120)
    x = mimo.layer_demap(layers, 1)[0]  # (B, 240, 2) symbol stream
    w = csi.transpose(-1, -2).reshape(B, -1)  # interleave layers
    return modem.demod_soft(x, modem.QPSK) * torch.repeat_interleave(w, 2, dim=-1)


def decode(rx_grid: torch.Tensor, ce: torch.Tensor, cell: grid_mod.CellConfig,
           ce_port1=None):
    """Hypothesis decode over (4 frame offsets x 3 port counts).

    ce: port-0 channel estimate; ce_port1: optional port-1 estimate (enables
    true SFBC hypotheses for 2/4-port cells).
    Returns (mib (B, 24), n_ports (B,), sfn_offset (B,), ok (B,)); where
    several hypotheses pass, the first in (offset, port) order wins, as with
    the reference's argmax."""
    B = rx_grid.shape[0]
    ces = [ce, ce_port1 if ce_port1 is not None else ce]
    # the 2- and 4-port hypotheses share their LLRs (both combine ports 0/1),
    # so only the 4 offsets x {1-port, SFBC} LLRs are decoded
    llr = torch.stack([_llrs_port_hyp(rx_grid, ces, cell, n) for n in (1, 2)], dim=1)
    # each frame offset places the segment in its quarter of the 1920 bits
    hyp = llr.new_zeros((B, 4, 2, 4, SEG))
    for off in range(4):
        hyp[:, off, :, off] = llr
    hyp = scrambling.scramble_llrs(hyp.reshape(B * 8, CODED), scrambling.pbch_cinit(cell.cell_id))
    streams = convcoder.rate_unmatch_cc(hyp, 40)
    bits = viterbi.viterbi_decode(streams).reshape(B, 4, 2, 40)
    # hypothesis = off*3 + port, ports (1, 2, 4) on LLR rows (1-port, SFBC, SFBC)
    _, masks, ports, llr_row = _device_tables(cell, rx_grid.device)
    bits = bits[:, :, llr_row].reshape(B, 12, 40)
    unmasked = torch.cat([bits[..., :MIB_LEN],
                          bits[..., MIB_LEN:] ^ masks.repeat(4, 1)], dim=-1)
    flat_ok = crc_mod.crc_ok(unmasked, crc_mod.LTE_CRC16)  # (B, 12)
    best = flat_ok.to(torch.int32).argmax(dim=1)  # first passing hypothesis
    mib = bits.gather(1, best[:, None, None].expand(B, 1, 40))[:, 0, :MIB_LEN]
    return mib.to(torch.int8), ports[best % 3], best // 3, flat_ok.any(dim=1)


def pack_mib(n_prb: int, sfn: int, phich_res: str = "1", phich_dur: int = 0) -> np.ndarray:
    """MIB payload bits (24,): bw(3) phich_dur(1) phich_res(2) sfn_msb(8) spare(10)."""
    bw_map = {6: 0, 15: 1, 25: 2, 50: 3, 75: 4, 100: 5}
    res_map = {"1/6": 0, "1/2": 1, "1": 2, "2": 3}
    bits = np.zeros(24, dtype=np.int8)
    v = bw_map[n_prb]
    bits[0:3] = [(v >> (2 - i)) & 1 for i in range(3)]
    bits[3] = phich_dur
    r = res_map[phich_res]
    bits[4:6] = [(r >> 1) & 1, r & 1]
    s = (sfn >> 2) & 0xFF
    bits[6:14] = [(s >> (7 - i)) & 1 for i in range(8)]
    return bits


def unpack_mib(bits: np.ndarray) -> dict:
    bits = np.asarray(bits)
    bw_inv = {0: 6, 1: 15, 2: 25, 3: 50, 4: 75, 5: 100}
    res_inv = {0: "1/6", 1: "1/2", 2: "1", 3: "2"}
    v = int("".join(map(str, bits[0:3])), 2)
    s = int("".join(map(str, bits[6:14])), 2)
    return dict(
        n_prb=bw_inv.get(v, -1),
        phich_dur=int(bits[3]),
        phich_res=res_inv[int("".join(map(str, bits[4:6])), 2)],
        sfn_msb=s,
    )
