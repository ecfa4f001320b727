"""PUCCH: uplink control channel, formats 1/1a/1b (SR/ACK), 2/2a/2b (CQI,
CQI + ACK) and 3 (multi-bit ACK).

Twin of the reference's `phch/pucch.py` (`lib/src/phy/phch/pucch.c`):
cyclic-shifted base sequences with per-symbol cell shifts n_cs_cell,
orthogonal covers (format 1), (20,A)-coded QPSK (format 2), DMRS per
`refsignal_ul.c` pucch section, edge-PRB mapping with slot hopping,
eNB-side correlation detection.  Config defaults: deltaPUCCH-Shift=1,
n_cs_1=0, n_rb_2=0 (the srsLTE defaults).

Each format's reference waveform is built on the host once per
(cell, subframe, resource) as a (2 slots, 7 symbols, 12) table; a TX call
is one scatter of all 14 symbols into the grid, an RX call one gather of
them, where the reference loops over slots and symbols.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import cplx, modem, sequence
from ..utils.devices import table_cache
from . import grid as grid_mod, refsignal_ul, uci

# normal CP, format 1: per slot, data symbols and DMRS symbols
F1_DATA_SYMS = (0, 1, 5, 6)
F1_DMRS_SYMS = (2, 3, 4)
F2_DATA_SYMS = (0, 2, 3, 4, 6)
F2_DMRS_SYMS = (1, 5)
# orthogonal covers (36.211 Table 5.4.1-2), length 4 for data
W_F1_DATA = np.array([[1, 1, 1, 1], [1, -1, 1, -1], [1, -1, -1, 1]], dtype=np.float32)
# length-3 DFT covers for DMRS (Table 5.5.2.2.1-2)
W_F1_DMRS = np.stack([
    np.ones(3, np.complex64),
    np.exp(2j * np.pi / 3 * np.arange(3) * 1).astype(np.complex64),
    np.exp(2j * np.pi / 3 * np.arange(3) * 2).astype(np.complex64),
])
F3_DATA_SYMS = (0, 2, 3, 4, 6)
F3_DMRS_SYMS = (1, 5)
# length-5 DFT orthogonal covers (36.211 Table 5.4.2A-1)
W_F3 = np.exp(-2j * np.pi / 5 *
              np.outer(np.arange(5), np.arange(5))).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def n_cs_cell(cell_id: int) -> np.ndarray:
    """(20 slots, 7 symbols) cell cyclic shifts (36.211 §5.4)."""
    c = sequence.gold_sequence_host(cell_id, 8 * 7 * 20)
    out = np.zeros((20, 7), dtype=np.int64)
    for ns in range(20):
        for l in range(7):
            out[ns, l] = sum(int(c[8 * 7 * ns + 8 * l + i]) << i for i in range(8)) % 12
    return out


def _f1_resources(n_pucch: int):
    """(cyclic shift index per symbol base, orthogonal cover index).
    With delta_shift=1: n'(ns) = n_pucch % 36 within the resource's PRB
    (c=3 covers x 12 shifts per PRB; the PRB itself is n_pucch // 36,
    pucch_prb)."""
    r = n_pucch % 36
    return r % 12, r // 12


def pucch_prb(n_pucch: int, ns: int, n_prb_cell: int) -> int:
    """Edge PRB with slot hopping (36.211 §5.4.3): m=0 resources at the band
    edges, alternating per slot."""
    m = n_pucch // 36  # resources per PRB region (12 shifts x 3 covers)
    if (m + ns) % 2 == 0:
        return m // 2
    return n_prb_cell - 1 - m // 2


def _shifted_base(cell_id: int, ns: int, l: int, shift: int) -> np.ndarray:
    """Base sequence of slot ns, cyclically shifted by (shift + n_cs_cell)."""
    u = (int(refsignal_ul.f_gh_table(cell_id, False)[ns]) + cell_id % 30) % 30
    alpha = 2 * np.pi * ((shift + int(n_cs_cell(cell_id)[ns, l])) % 12) / 12
    return refsignal_ul.base_sequence(u, 0, 12) * np.exp(1j * alpha * np.arange(12))


def _flat_idx(cell: grid_mod.CellConfig, prbs) -> np.ndarray:
    """(2, 7, 12) flat grid indices of the 14 symbols on each slot's PRB."""
    ks = 12 * np.asarray(prbs)[:, None, None] + np.arange(12)
    return (7 * np.arange(2)[:, None, None] + np.arange(7)[None, :, None]) * cell.nre + ks


@functools.lru_cache(maxsize=None)
def _f1_waveform(cell_id: int, sf_idx: int, n_pucch: int):
    """Unit reference waveform per slot for format 1: (2 slots, 7 syms, 12)
    complex, to be scaled by d(0) on the data symbols."""
    alpha_base, n_oc = _f1_resources(n_pucch)
    out = np.zeros((2, 7, 12), dtype=np.complex64)
    for s, ns in enumerate((2 * sf_idx, 2 * sf_idx + 1)):
        for i, l in enumerate(F1_DATA_SYMS):
            out[s, l] = _shifted_base(cell_id, ns, l, alpha_base) * W_F1_DATA[n_oc][i]
        for i, l in enumerate(F1_DMRS_SYMS):
            out[s, l] = _shifted_base(cell_id, ns, l, alpha_base) * W_F1_DMRS[n_oc][i]
    return out


@functools.lru_cache(maxsize=None)
def _f2_waveform(cell_id: int, sf_idx: int, n_pucch2: int) -> np.ndarray:
    """(2, 7, 12) format-2 reference: shifted base per slot and symbol."""
    return np.stack([np.stack([_shifted_base(cell_id, 2 * sf_idx + s, l, n_pucch2 % 12)
                               for l in range(7)]) for s in range(2)]).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _f3_dmrs(cell_id: int, sf_idx: int) -> np.ndarray:
    """(2, 7, 12) format-3 DMRS reference (no resource shift)."""
    return np.stack([np.stack([_shifted_base(cell_id, 2 * sf_idx + s, l, 0)
                               for l in range(7)]) for s in range(2)]).astype(np.complex64)


@table_cache(64)
def _device_tables(kind: str, cell: grid_mod.CellConfig, sf_idx: int, n: int,
                   device: torch.device):
    """(flat grid indices (2, 7, 12) int64, reference waveform (2, 7, 12, 2))
    of one PUCCH resource on `device`; kind is "f1", "f2" or "f3"."""
    if kind == "f3":
        m = n // 5
        prbs = [m // 2 if (m + 2 * sf_idx + s) % 2 == 0 else cell.n_prb - 1 - m // 2
                for s in range(2)]
        wf = _f3_dmrs(cell.cell_id, sf_idx)
    else:
        prbs = [pucch_prb(n, 2 * sf_idx + s, cell.n_prb) for s in range(2)]
        wf = (_f1_waveform if kind == "f1" else _f2_waveform)(cell.cell_id, sf_idx, n)
    idx = torch.from_numpy(_flat_idx(cell, prbs).astype(np.int64)).to(device)
    return idx, cplx.from_numpy(wf, device)


@table_cache(8)
def _f1_data_mask(device: torch.device) -> torch.Tensor:
    """(7,) bool: the data symbols of a format-1 slot, on `device` (a list
    index would be copied from the host at every call)."""
    mask = torch.zeros(7, dtype=torch.bool)
    mask[list(F1_DATA_SYMS)] = True
    return mask.to(device)


def _put(grid: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Scatter (B, *idx.shape, 2) values into a copy of grid."""
    B = grid.shape[0]
    flat = grid.reshape(B, -1, 2).clone()
    flat[:, idx.reshape(-1)] = vals.reshape(B, -1, 2).to(flat.dtype)
    return flat.reshape(grid.shape)


def _take(rx_grid: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather (B, *idx.shape, 2) from a grid."""
    B = rx_grid.shape[0]
    return rx_grid.reshape(B, -1, 2)[:, idx.reshape(-1)].reshape((B,) + idx.shape + (2,))


def _unit_modulus(d: torch.Tensor) -> torch.Tensor:
    return d / (torch.sqrt(cplx.abs2(d))[..., None] + 1e-9)


def encode_f1(d0: torch.Tensor, cell: grid_mod.CellConfig, sf_idx: int, n_pucch: int,
              grid: torch.Tensor) -> torch.Tensor:
    """Format 1/1a/1b: d0 (B, 2) cf symbol (1+0j for format 1/SR).
    Places PUCCH into the UL grid (B, 14, NRE, 2)."""
    idx, wf = _device_tables("f1", cell, sf_idx, n_pucch, grid.device)
    # DMRS symbols carry the bare waveform; data symbols carry d0 * waveform
    data = _f1_data_mask(grid.device)
    sig = torch.where(data[None, None, :, None, None],
                      cplx.mul(d0[:, None, None, None, :], wf[None]), wf[None])
    return _put(grid, idx, sig)


def detect_f1(rx_grid: torch.Tensor, cell: grid_mod.CellConfig, sf_idx: int, n_pucch: int):
    """eNB format-1 detection: returns (corr (B, 2) cf — the matched-filter
    estimate of d0 per slot-combined, energy (B,)).

    Caller thresholds |corr| for SR and takes sign for 1a/1b bits."""
    idx, wf = _device_tables("f1", cell, sf_idx, n_pucch, rx_grid.device)
    syms = _sym_index(F1_DATA_SYMS, rx_grid.device)
    y = _take(rx_grid, idx[:, syms])  # (B, 2, 4, 12, 2)
    corr = cplx.mul_conj(y, wf[:, syms]).sum(dim=-2).sum(dim=(1, 2)) / (12 * 2 * len(syms))
    return corr, cplx.abs2(corr)


def _f2_signal(cqi_bits: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(B, <=13) CQI bits -> (B, 2, 7, 12, 2): the 10 QPSK symbols of the
    (20, A) code times the reference, one per data symbol of each slot; the
    DMRS symbols carry the bare reference."""
    d = modem.modulate(uci.encode_rm20(cqi_bits), modem.QPSK).reshape(-1, 2, 5, 2)
    sig = ref[None].expand(d.shape[0], -1, -1, -1, -1).clone()
    syms = _sym_index(F2_DATA_SYMS, ref.device)
    sig[:, :, syms] = cplx.mul(d[:, :, :, None, :], ref[None, :, syms])
    return sig


@table_cache(16)
def _sym_index(syms: tuple, device: torch.device) -> torch.Tensor:
    """The symbol numbers `syms` as an int64 index on `device` (a Python
    list as an index would be copied there at every call)."""
    return torch.tensor(syms, device=device)


def encode_f2(cqi_bits: torch.Tensor, cell: grid_mod.CellConfig, sf_idx: int, n_pucch2: int,
              grid: torch.Tensor) -> torch.Tensor:
    """Format 2: (B, <=13) CQI bits -> (20, A) code -> QPSK -> 10 symbols."""
    idx, ref = _device_tables("f2", cell, sf_idx, n_pucch2, grid.device)
    return _put(grid, idx, _f2_signal(cqi_bits, ref))


def _f2_despread(rx_grid, cell, sf_idx, n_pucch2):
    """(B, 2, 7, 12, 2) received symbols of a format-2 resource with its
    shifted base sequence removed."""
    idx, ref = _device_tables("f2", cell, sf_idx, n_pucch2, rx_grid.device)
    return cplx.mul_conj(_take(rx_grid, idx), ref)


def _f2_cqi(z: torch.Tensor, h: torch.Tensor, n_bits: int):
    """Combine the data symbols of each slot over the 12 subcarriers with the
    slot's channel weights h (B, 2, 12, 2), then RM20 ML decode."""
    d = cplx.mul_conj(z[:, :, list(F2_DATA_SYMS)], h[:, :, None]).sum(dim=-2)  # (B, 2, 5, 2)
    llr = modem.demod_soft(_unit_modulus(d.reshape(-1, 10, 2)), modem.QPSK)
    return uci.decode_rm(llr, n_bits, "rm20")


def decode_f2(rx_grid: torch.Tensor, cell: grid_mod.CellConfig, sf_idx: int, n_pucch2: int,
              n_bits: int):
    """eNB format-2 decode: DMRS channel estimate -> equalize -> RM20 ML."""
    z = _f2_despread(rx_grid, cell, sf_idx, n_pucch2)
    h = (z[:, :, F2_DMRS_SYMS[0]] + z[:, :, F2_DMRS_SYMS[1]]) / 2  # (B, 2, 12, 2)
    return _f2_cqi(z, h, n_bits)


# ---------------- formats 2a/2b: CQI + 1-2 ACK bits (36.211 §5.4.2) --------

def _ack_symbol_2ab(ack_bits: torch.Tensor) -> torch.Tensor:
    """(B, 1|2) ACK bits -> (B, 2) cf modulation symbol d(10).
    2a (1 bit): BPSK 0->+1, 1->-1.  2b (2 bits): Table 5.4.2-1."""
    if ack_bits.shape[-1] == 1:
        re = 1.0 - 2.0 * ack_bits[..., 0].to(torch.float32)
        return cplx.make(re, torch.zeros_like(re))
    b0 = ack_bits[..., 0].to(torch.float32)
    b1 = ack_bits[..., 1].to(torch.float32)
    # (0,0)->1, (0,1)->-j, (1,0)->j, (1,1)->-1
    return cplx.make((1 - b0) * (1 - b1) - b0 * b1, b0 * (1 - b1) - (1 - b0) * b1)


def encode_f2ab(cqi_bits: torch.Tensor, ack_bits: torch.Tensor, cell: grid_mod.CellConfig,
                sf_idx: int, n_pucch2: int, grid: torch.Tensor) -> torch.Tensor:
    """Format 2a/2b: format-2 CQI with d(10) = ACK symbol modulating the
    SECOND DMRS symbol (l=5) of each slot (pucch.c format2a/2b path)."""
    idx, ref = _device_tables("f2", cell, sf_idx, n_pucch2, grid.device)
    sig = _f2_signal(cqi_bits, ref)
    l = F2_DMRS_SYMS[1]  # the modulated DMRS symbol
    sig[:, :, l] = cplx.mul(_ack_symbol_2ab(ack_bits)[:, None, None, :], ref[None, :, l])
    return _put(grid, idx, sig)


def decode_f2ab(rx_grid: torch.Tensor, cell: grid_mod.CellConfig, sf_idx: int,
                n_pucch2: int, n_cqi_bits: int, n_ack_bits: int):
    """Format 2a/2b decode: CQI via the format-2 path with the channel taken
    from the FIRST DMRS only; ACK by correlating the second DMRS against it."""
    z = _f2_despread(rx_grid, cell, sf_idx, n_pucch2)
    h = z[:, :, F2_DMRS_SYMS[0]]  # unmodulated DMRS
    # z at l=5 carries d(10) * h
    d10 = cplx.mul_conj(z[:, :, F2_DMRS_SYMS[1]], h).sum(dim=-2).sum(dim=1)
    cqi_bits, metric = _f2_cqi(z, h, n_cqi_bits)
    if n_ack_bits == 1:
        ack = (d10[..., 0] < 0).to(torch.int8)[:, None]
    else:
        # invert Table 5.4.2-1: sign(re)/sign(im) quadrants
        re, im = d10[..., 0], d10[..., 1]
        b0 = (im > re.abs()) | (re < -im.abs())  # j or -1 side
        b1 = (im < -re.abs()) | (re < -im.abs())
        ack = torch.stack([b0, b1], dim=-1).to(torch.int8)
    return cqi_bits, ack, metric


# ---------------- format 3: multi-bit ACK (Rel-10, 36.211 §5.4.2A) ---------

def encode_f3_bits(ack_bits: torch.Tensor) -> torch.Tensor:
    """(B, O<=11) -> (B, 48) coded bits: RM(32,O) + circular repetition
    (36.212 §5.2.3.1 for O <= 11)."""
    c32 = uci.encode_rm(ack_bits, 32)
    return torch.cat([c32, c32[:, :16]], dim=1)


def _occ(n_pucch3: int, device) -> torch.Tensor:
    """(5, 2) length-5 orthogonal cover of the resource, one per data symbol."""
    return cplx.from_numpy(W_F3[n_pucch3 % 5], device)


def encode_f3(ack_bits: torch.Tensor, cell: grid_mod.CellConfig, sf_idx: int,
              n_pucch3: int, grid: torch.Tensor) -> torch.Tensor:
    """Format 3: 48 coded bits -> 24 QPSK -> 12 per slot, block-spread with a
    length-5 OCC over the data symbols; DMRS on l=1,5 per slot."""
    idx, ref = _device_tables("f3", cell, sf_idx, n_pucch3, grid.device)
    d = modem.modulate(encode_f3_bits(ack_bits), modem.QPSK).reshape(-1, 2, 12, 2)
    B = d.shape[0]
    sig = ref[None].expand(B, -1, -1, -1, -1).clone()
    sig[:, :, list(F3_DATA_SYMS)] = cplx.mul(d[:, :, None], _occ(n_pucch3, grid.device)[:, None])
    return _put(grid, idx, sig)


def decode_f3(rx_grid: torch.Tensor, cell: grid_mod.CellConfig, sf_idx: int,
              n_pucch3: int, n_bits: int):
    """Format 3 decode: DMRS channel estimate, OCC despread, RM32 ML over the
    48 repeated coded bits."""
    idx, ref = _device_tables("f3", cell, sf_idx, n_pucch3, rx_grid.device)
    y = _take(rx_grid, idx)  # (B, 2, 7, 12, 2)
    z = cplx.mul_conj(y[:, :, list(F3_DMRS_SYMS)], ref[:, list(F3_DMRS_SYMS)])
    h = (z[:, :, 0] + z[:, :, 1]) / 2.0  # (B, 2, 12, 2)
    zz = cplx.mul_conj(cplx.mul_conj(y[:, :, list(F3_DATA_SYMS)],
                                     _occ(n_pucch3, rx_grid.device)[:, None]), h[:, :, None])
    d = (zz.sum(dim=2) / len(F3_DATA_SYMS)).reshape(-1, 24, 2)
    llr = modem.demod_soft(_unit_modulus(d), modem.QPSK)  # (B, 48)
    # fold the circular repetition back onto the 32 coded positions
    llr32 = torch.cat([llr[:, :16] + llr[:, 32:], llr[:, 16:32]], dim=1)
    return uci.decode_rm(llr32, n_bits, "rm32")
