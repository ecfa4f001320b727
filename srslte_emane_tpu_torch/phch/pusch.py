"""PUSCH: uplink shared channel with SC-FDMA transform precoding.

Twin of the reference's `phch/pusch.py` (`lib/src/phy/phch/pusch.c`:
UL-SCH + UCI mux + DFT precoding + PUSCH scrambling; eNB-side decode;
`lib/src/phy/dft/dft_precoding.c`: transform precoding, valid sizes
2^a 3^b 5^c).  The UL channel interleaver
(36.212 §5.2.2.8) is a reshape/transpose; transform precoding is
torch.fft (see ops/dft.py on how that differs from the reference's bf16
product); the DMRS-based UL channel estimate smooths each slot's pilot in
frequency and interpolates linearly in time.  Data symbols: l in
{0..6}\\{3} per slot (DMRS at l=3).  RE index tables and DMRS values are
built on the host once per configuration and device.  sf_idx, rb_start and
rnti may each be an int or a 0-d integer tensor on the device (a CUDA
graph's inputs): a tensor rb_start gives the RE indices by arithmetic and a
tensor sf_idx gathers its DMRS from the (10, ...) table, to the same values.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import cplx, dft, modem, scrambling
from ..utils.devices import row, table_cache
from . import chest as chest_dl  # for equalize helpers
from . import grid as grid_mod, refsignal_ul, sch

DATA_SYMS = tuple(l for l in range(14) if l not in (3, 10))
DMRS_SYMS = (3, 10)
N_DATA_SYMS = len(DATA_SYMS)  # 12
SMOOTH_TAPS = 5  # frequency smoothing of the DMRS estimate (chest_ul.c)


def valid_n_prb(n_prb: int) -> bool:
    """Transform precoding sizes: 2^a 3^b 5^c (dft_precoding.c)."""
    n = n_prb
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


def interleave(bits: torch.Tensor, qm: int) -> torch.Tensor:
    """UL channel interleaver, data-only (36.212 §5.2.2.8): write row-wise in
    Qm-bit groups over C_mux=12 columns, read column-wise."""
    B, G = bits.shape
    r = G // (qm * N_DATA_SYMS)
    return bits.reshape(B, r, N_DATA_SYMS, qm).transpose(1, 2).reshape(B, G)


def deinterleave(llrs: torch.Tensor, qm: int) -> torch.Tensor:
    B, G = llrs.shape
    r = G // (qm * N_DATA_SYMS)
    return llrs.reshape(B, N_DATA_SYMS, r, qm).transpose(1, 2).reshape(B, G)


@functools.lru_cache(maxsize=None)
def re_indices(n_prb_cell: int, rb_start: int, l_prb: int):
    """(12, 12*l_prb) flat grid indices of PUSCH data REs (freq within symbol),
    plus (2, 12*l_prb) DMRS indices."""
    nre = 12 * n_prb_cell
    ks = 12 * rb_start + np.arange(12 * l_prb)
    data = np.stack([l * nre + ks for l in DATA_SYMS]).astype(np.int32)
    dmrs = np.stack([l * nre + ks for l in DMRS_SYMS]).astype(np.int32)
    return data, dmrs


@functools.lru_cache(maxsize=None)
def _dmrs10(cell_id: int, l_prb: int) -> np.ndarray:
    """(10, 2, 12*l_prb) PUSCH DMRS for every subframe: the gather table for
    an sf_idx given as a tensor (group/sequence hopping varies per slot)."""
    return np.stack([refsignal_ul.pusch_dmrs(cell_id, s, l_prb) for s in range(10)])


@table_cache(64)
def _dmrs10_device(cell_id: int, l_prb: int, device: torch.device) -> torch.Tensor:
    """`_dmrs10` on `device`: (10, 2, 12*l_prb, 2)."""
    return cplx.from_numpy(_dmrs10(cell_id, l_prb), device)


def _dmrs_for(cell_id: int, sf_idx, l_prb: int, device=None) -> torch.Tensor:
    """(..., 2, 12*l_prb, 2) cf DMRS values; sf_idx an int, or an int tensor
    of any shape (one table row per element)."""
    if isinstance(sf_idx, (int, np.integer)):
        return cplx.from_numpy(refsignal_ul.pusch_dmrs(cell_id, int(sf_idx), l_prb), device)
    d10 = cplx.from_numpy(_dmrs10(cell_id, l_prb), sf_idx.device)
    return d10[sf_idx.long()]


@table_cache(8)
def _sym_offsets(n_prb_cell: int, device: torch.device):
    """(data symbols (12, 1), DMRS symbols (2, 1)) times NRE, int64 on
    `device`: `_re_idx`'s row offsets."""
    nre = 12 * n_prb_cell
    f = lambda syms: torch.tensor(syms, device=device)[:, None] * nre
    return f(DATA_SYMS), f(DMRS_SYMS)


def _re_idx(n_prb_cell: int, rb_start, l_prb: int):
    """re_indices that also takes rb_start as an int tensor (of any shape,
    giving (..., 12, m_sc) and (..., 2, m_sc)): the tables are plain
    arithmetic, so one code path serves every contiguous allocation of the
    same width."""
    if isinstance(rb_start, (int, np.integer)):
        return re_indices(n_prb_cell, int(rb_start), l_prb)
    dev = rb_start.device
    ks = 12 * rb_start.long()[..., None, None] + torch.arange(12 * l_prb, device=dev)
    data, dmrs = _sym_offsets(n_prb_cell, dev)
    return data + ks, dmrs + ks


@table_cache(32)
def _device_tables(n_prb_cell: int, cell_id: int, sf_idx: int, rb_start: int, l_prb: int,
                   device: torch.device):
    """(data RE indices (12*m_sc,), DMRS RE indices (2*m_sc,), DMRS values
    (2, m_sc, 2)) on `device`."""
    data, dmrs = re_indices(n_prb_cell, rb_start, l_prb)
    f = lambda a: torch.from_numpy(a.reshape(-1).astype(np.int64)).to(device)
    return f(data), f(dmrs), cplx.from_numpy(refsignal_ul.pusch_dmrs(cell_id, sf_idx, l_prb),
                                             device)


def _tables(cell: grid_mod.CellConfig, sf_idx, rb_start, l_prb: int, device: torch.device):
    """`_device_tables` for ints, or with sf_idx and rb_start as 0-d
    integer tensors on `device` (indices by arithmetic, DMRS gathered from
    the (10, ...) table)."""
    if not isinstance(sf_idx, torch.Tensor) and not isinstance(rb_start, torch.Tensor):
        return _device_tables(cell.n_prb, cell.cell_id, int(sf_idx), int(rb_start), l_prb,
                              device)
    if isinstance(rb_start, torch.Tensor):
        data, dmrs = (a.reshape(-1) for a in _re_idx(cell.n_prb, rb_start, l_prb))
    else:
        data, dmrs, _ = _device_tables(cell.n_prb, cell.cell_id, 0, int(rb_start), l_prb,
                                       device)
    if isinstance(sf_idx, torch.Tensor):
        return data, dmrs, row(_dmrs10_device(cell.cell_id, l_prb, device), sf_idx)
    return data, dmrs, _device_tables(cell.n_prb, cell.cell_id, int(sf_idx), 0, l_prb, device)[2]


def uci_dims(l_prb: int, qm: int, n_ack: int, n_ri: int, n_cqi: int,
             beta_ack: float = 20.0, beta_ri: float = 12.5, beta_cqi: float = 5.0):
    """(q_ack, q_ri, q_cqi) coded bit counts and the SCH data size G_data."""
    from . import pusch_uci

    g_total = 12 * l_prb * N_DATA_SYMS * qm
    q_ack = pusch_uci.n_uci_symbols(n_ack, beta_ack, qm, g_total) * qm if n_ack else 0
    q_ri = pusch_uci.n_uci_symbols(n_ri, beta_ri, qm, g_total) * qm if n_ri else 0
    q_cqi = pusch_uci.n_uci_symbols(max(n_cqi, 32 // max(qm, 1)), beta_cqi, qm, g_total) * qm if n_cqi else 0
    g_data = g_total - q_ri - q_cqi
    return q_ack, q_ri, q_cqi, g_data


def encode(tb_bits: torch.Tensor, cfg: sch.SchConfig, cell: grid_mod.CellConfig, sf_idx: int,
           rnti: int, rb_start: int, l_prb: int, grid=None, uci=None) -> torch.Tensor:
    """UE-side PUSCH encode into a UL subframe grid (B, 14, NRE, 2) (into a
    copy of `grid` if given).

    uci: optional dict(ack=(B,n) bits, ri=(B,n) bits, cqi=(B,n) bits) —
    multiplexed per 36.212 §5.2.2.6/5.2.2.8 (sch.c UL-SCH path)."""
    from . import pusch_uci, uci as uci_codes

    assert valid_n_prb(l_prb), l_prb
    m_sc = 12 * l_prb
    g_total = m_sc * N_DATA_SYMS * cfg.Qm
    cw = sch.encode_tb(tb_bits, cfg)
    if uci:
        def _nz(x):
            return x if x is not None and x.shape[-1] else None

        ack, ri, cqi = (_nz(uci.get(name)) for name in ("ack", "ri", "cqi"))
        q_ack, q_ri, q_cqi, g_data = uci_dims(
            l_prb, cfg.Qm, 0 if ack is None else ack.shape[-1],
            0 if ri is None else ri.shape[-1], 0 if cqi is None else cqi.shape[-1])
        assert cfg.G == g_data, (cfg.G, g_data)
        data = cw if cqi is None else torch.cat([uci_codes.encode_cqi_pusch(cqi, q_cqi), cw], -1)
        ri_c = pusch_uci.encode_ack_ri(ri, q_ri // cfg.Qm, cfg.Qm) if ri is not None else None
        ack_c = pusch_uci.encode_ack_ri(ack, q_ack // cfg.Qm, cfg.Qm) if ack is not None else None
        il = pusch_uci.multiplex(data, ri_c, ack_c, cfg.Qm)
    else:
        assert cfg.G == g_total
        il = interleave(cw, cfg.Qm)
    scr = scrambling.scramble_bits(il, scrambling.pusch_cinit(rnti, sf_idx, cell.cell_id))
    syms = modem.modulate(scr, modem.MOD_FROM_QM[cfg.Qm])  # (B, 12*m_sc, 2)
    B = syms.shape[0]
    # transform precoding per SC-FDMA symbol
    x = dft.dft(syms.reshape(B, N_DATA_SYMS, m_sc, 2))
    data_idx, dmrs_idx, dmrs = _tables(cell, sf_idx, rb_start, l_prb, syms.device)
    if grid is None:
        flat = cplx.zeros((B, grid_mod.N_SYM * cell.nre), device=syms.device)
    else:
        flat = grid.reshape(B, -1, 2).clone()
    flat[:, torch.cat([data_idx, dmrs_idx])] = torch.cat(
        [x.reshape(B, -1, 2), dmrs.reshape(1, -1, 2).expand(B, -1, -1)], dim=1)
    return flat.reshape(B, grid_mod.N_SYM, cell.nre, 2)


@table_cache(8)
def _time_weights(device: torch.device):
    """(1 - t, t) of each data symbol, (1, 12, 1, 1) on `device`: the linear
    time interpolation from the DMRS at symbols 3 and 10."""
    t = (np.array(DATA_SYMS, np.float32) - 3.0) / 7.0  # 0 at sym3, 1 at sym10
    return (torch.from_numpy(1.0 - t).to(device)[None, :, None, None],
            torch.from_numpy(t).to(device)[None, :, None, None])


def estimate_ul(rx_grid: torch.Tensor, cell: grid_mod.CellConfig, sf_idx: int,
                rb_start: int, l_prb: int):
    """eNB UL channel estimate from the two DMRS symbols (chest_ul.c): LS per
    slot pilot, 5-tap frequency smoothing, linear time interpolation.
    Returns (ce (B, 12, M_sc, 2) at data symbols, noise_est (B,))."""
    m_sc = 12 * l_prb
    _, dmrs_idx, r = _tables(cell, sf_idx, rb_start, l_prb, rx_grid.device)
    B = rx_grid.shape[0]
    y = rx_grid.reshape(B, -1, 2)[:, dmrs_idx].reshape(B, 2, m_sc, 2)
    h_ls = cplx.mul_conj(y, r)  # (B, 2, m_sc, 2)
    # frequency smoothing (moving average, 5 taps, edge-padded)
    k = SMOOTH_TAPS
    edge = torch.arange(-(k // 2), m_sc + k // 2, device=rx_grid.device).clamp(0, m_sc - 1)
    pad = h_ls[:, :, edge]
    tap = float(np.float32(1.0 / k))
    sm = sum(pad[:, :, i : i + m_sc] * tap for i in range(k))
    noise = cplx.abs2(h_ls - sm).reshape(B, -1).mean(dim=-1) * (k / max(k - 1, 1))
    w1, w2 = _time_weights(rx_grid.device)
    return w1 * sm[:, 0:1] + w2 * sm[:, 1:2], noise


def decode(rx_grid: torch.Tensor, cfg: sch.SchConfig, cell: grid_mod.CellConfig, sf_idx: int,
           rnti: int, rb_start: int, l_prb: int, softbuf=None, max_iter: int = 8,
           uci_dims_in=None, use_kernel: bool | None = None, llr_bits: int = 32):
    """eNB-side PUSCH decode.  Returns (payload, ok, softbuf, noise_est)
    or, with uci_dims_in=(q_ack, q_ri, q_cqi, n_ack, n_ri, n_cqi), a dict
    also carrying decoded ack/ri/cqi.  use_kernel and llr_bits go to
    sch.decode_tb (the MAP kernel, and the decoder's storage width)."""
    m_sc = 12 * l_prb
    data_idx, _, _ = _tables(cell, sf_idx, rb_start, l_prb, rx_grid.device)
    B = rx_grid.shape[0]
    y = rx_grid.reshape(B, -1, 2)[:, data_idx].reshape(B, N_DATA_SYMS, m_sc, 2)
    ce, noise = estimate_ul(rx_grid, cell, sf_idx, rb_start, l_prb)
    x_eq, csi = chest_dl.equalize_mmse(y, ce, noise)
    # inverse transform precoding
    x_td = dft.idft(x_eq)  # (B, 12, m_sc, 2)
    llr = modem.demod_soft(x_td.reshape(B, N_DATA_SYMS * m_sc, 2), modem.MOD_FROM_QM[cfg.Qm])
    # per-symbol CSI weight: SC-FDMA spreads each QAM symbol over the whole
    # allocation; weight by the mean CSI of its SC-FDMA symbol
    w = csi.mean(dim=-1)  # (B, 12)
    llr = llr * torch.repeat_interleave(w, m_sc * cfg.Qm, dim=-1)
    llr = scrambling.scramble_llrs(llr, scrambling.pusch_cinit(rnti, sf_idx, cell.cell_id))
    if uci_dims_in is not None:
        from . import pusch_uci, uci as uci_codes

        q_ack, q_ri, q_cqi, n_ack, n_ri, n_cqi = uci_dims_in
        data, ri_llr, ack_llr = pusch_uci.demultiplex(llr, cfg.Qm, q_ri, q_ack)
        cqi_bits = None
        if q_cqi:
            cqi_llr, data = data[..., :q_cqi], data[..., q_cqi:]
            cqi_bits, _ = uci_codes.decode_cqi_pusch(cqi_llr, n_cqi)
        payload, ok, softbuf, _ = sch.decode_tb(data, cfg, softbuf, max_iter,
                                                use_kernel=use_kernel, llr_bits=llr_bits,
                                                read=False)
        return dict(payload=payload, ok=ok, softbuf=softbuf, noise=noise, cqi=cqi_bits,
                    ri=pusch_uci.decode_ack_ri(ri_llr, n_ri, cfg.Qm) if q_ri else None,
                    ack=pusch_uci.decode_ack_ri(ack_llr, n_ack, cfg.Qm) if q_ack else None)
    payload, ok, softbuf, _ = sch.decode_tb(deinterleave(llr, cfg.Qm), cfg, softbuf, max_iter,
                                            use_kernel=use_kernel, llr_bits=llr_bits, read=False)
    return payload, ok, softbuf, noise
