"""PDSCH symbol chain: SISO (TM1), transmit diversity, CDD and codebook
spatial multiplexing (TM2-TM6), UE-RS beamforming (TM7, TM8).

Twin of the reference's `phch/pdsch.py` (pdsch.c:81-233 encode,
pdsch.c:574-686 decode): scrambling -> modulation -> layer map ->
precoding -> RE mapping around the holes; decode: channel estimate ->
equalize or predecode -> soft demod with CSI weights -> descramble ->
DL-SCH decode.  The RE map is a host table
(phch/grid.py) uploaded once per configuration and device; everything is
batched over subframes (axis B).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import cplx, mimo, modem, scrambling
from ..ops.fec import turbodecoder as _td
from ..utils import trace
from ..utils.devices import row, table_cache
from . import chest, grid as grid_mod, sch


@table_cache(32)
def _crs_table(cell: grid_mod.CellConfig, sf_idx: int, port: int, device: torch.device):
    """(flat CRS positions (n_crs,), CRS values (n_crs, 2)) of one port."""
    ks = grid_mod.crs_k(cell.cell_id, cell.n_prb, port, cell.cp)
    syms = grid_mod.pilot_syms(port, cell.cp)
    pidx = (np.asarray(syms)[:, None] * cell.nre + ks).reshape(-1).astype(np.int64)
    vals = grid_mod.crs_values(cell.cell_id, sf_idx, cell.n_prb, port, cell.cp)
    return torch.from_numpy(pidx).to(device), cplx.from_numpy(vals.reshape(-1), device)


@table_cache(32)
def _crs_table10(cell: grid_mod.CellConfig, port: int, device: torch.device):
    """(flat CRS positions (n_crs,), CRS values (10, n_crs, 2) of every
    subframe) of one port: the gather table for an sf_idx given as a
    tensor."""
    pidx, _ = _crs_table(cell, 0, port, device)
    v10 = chest._crs_values10(cell.cell_id, cell.n_prb, port, cell.cp)
    return pidx, cplx.from_numpy(v10.reshape(10, -1), device)


def _crs_of(cell: grid_mod.CellConfig, sf_idx, port: int, device: torch.device):
    """`_crs_table` for an int sf_idx or a 0-d integer tensor on `device`."""
    if isinstance(sf_idx, torch.Tensor):
        pidx, v10 = _crs_table10(cell, port, device)
        return pidx, row(v10, sf_idx)
    return _crs_table(cell, int(sf_idx), port, device)


# one table per (subframe, allocation): the waveform network's DL grants
# vary in both from TTI to TTI
@table_cache(256)
def _re_table(cell: grid_mod.CellConfig, sf_idx: int, prb_mask: tuple,
              device: torch.device, max_sym: int = 0) -> torch.Tensor:
    idx = grid_mod.pdsch_re_indices(cell, sf_idx, prb_mask, max_sym)
    return torch.from_numpy(idx.astype(np.int64)).to(device)


@table_cache(32)
def _tx_gather(cell: grid_mod.CellConfig, sf_idx: int, prb_mask: tuple, port: int,
               device: torch.device, max_sym: int = 0) -> torch.Tensor:
    tbl = grid_mod.tx_gather_table(cell, sf_idx, prb_mask, port, max_sym)
    return torch.from_numpy(tbl.astype(np.int64)).to(device)


def put_crs(grid: torch.Tensor, cell: grid_mod.CellConfig, sf_idx: int,
            port: int = 0) -> torch.Tensor:
    """Write the CRS pilots of `port` into grid (..., 14, NRE, 2); sf_idx
    an int or a 0-d integer tensor on the grid's device."""
    pidx, v = _crs_of(cell, sf_idx, port, grid.device)
    flat = grid.reshape(grid.shape[:-3] + (cell.n_sym * cell.nre, 2)).clone()
    flat[..., pidx, :] = v
    return flat.reshape(grid.shape)


def assemble_grid(syms: torch.Tensor, cell: grid_mod.CellConfig, sf_idx: int,
                  prb_mask: tuple, port: int = 0, max_sym: int = 0) -> torch.Tensor:
    """(B, n_re, 2) PDSCH symbols -> (B, 14, NRE, 2) grid with CRS, as ONE
    gather (see grid.tx_gather_table).  Unused REs are zero."""
    tbl = _tx_gather(cell, sf_idx, prb_mask, port, syms.device, max_sym)
    _, crs_v = _crs_table(cell, sf_idx, port, syms.device)
    B = syms.shape[0]
    src = torch.cat([syms, crs_v.expand((B,) + crs_v.shape).to(syms.dtype),
                     syms.new_zeros((B, 1, 2))], dim=-2)
    return src[:, tbl].reshape(B, cell.n_sym, cell.nre, 2)


def encode(tb_bits: torch.Tensor, cfg: sch.SchConfig, cell: grid_mod.CellConfig,
           sf_idx: int, rnti: int, prb_mask: tuple, grid=None,
           max_sym: int = 0, codeword_q: int = 0, re_idx=None) -> torch.Tensor:
    """Encode one PDSCH grant into a subframe grid.

    tb_bits: (B, tbs).  Returns grid (B, 14, NRE, 2) with CRS + PDSCH placed
    (into a copy of `grid` if given); max_sym truncates the PDSCH symbols
    (TDD DwPTS); codeword_q picks the scrambling c_init of codeword q;
    re_idx, an optional (n_re,) RE index tensor, overrides prb_mask's
    table.  With re_idx, sf_idx and rnti may be 0-d integer tensors on the
    device (a CUDA graph's inputs): nothing reads them on the host.

    Inside an open stage (utils/trace.py), the DL-SCH encode is its phase
    `tx.fec`, and the scrambling, modulation and grid assembly with the
    CRS its phase `tx.map` (`_codeword_syms` begins both)."""
    static_idx = re_idx is None
    if static_idx:
        re_idx = _re_table(cell, sf_idx, prb_mask, tb_bits.device, max_sym)
    else:
        re_idx = torch.as_tensor(re_idx, dtype=torch.int64, device=tb_bits.device)
    assert cfg.G == len(re_idx) * cfg.Qm, (cfg.G, len(re_idx), cfg.Qm)
    syms = _codeword_syms(tb_bits, cfg, codeword_q, cell, sf_idx, rnti)  # (B, n_re, 2)
    if grid is None and static_idx:
        return assemble_grid(syms, cell, sf_idx, prb_mask, 0, max_sym)
    B = syms.shape[0]
    if grid is None:
        flat = cplx.zeros((B, cell.n_sym * cell.nre), device=syms.device)
    else:
        flat = grid.reshape(B, cell.n_sym * cell.nre, 2).clone()
    flat[:, re_idx, :] = syms
    return put_crs(flat.reshape(B, cell.n_sym, cell.nre, 2), cell, sf_idx)


def decode(rx_grid: torch.Tensor, cfg: sch.SchConfig, cell: grid_mod.CellConfig,
           sf_idx: int, rnti: int, prb_mask: tuple, softbuf=None, max_iter: int = 8,
           use_kernel: bool | None = None, llr_bits: int = 32, max_sym: int = 0,
           equalizer: str = "zf", codeword_q: int = 0, use_csi: bool = True,
           re_idx=None):
    """Decode one PDSCH grant from a received subframe grid (B, 14, NRE, 2).
    equalizer: "zf" or "mmse" (with the estimate's noise variance);
    codeword_q: the scrambling c_init of codeword q; use_csi: weight the
    LLRs by the equalizer's CSI; re_idx: as in `encode`, and with it
    sf_idx and rnti may be 0-d tensors, as there.

    Returns (payload bits (B, tbs), crc ok (B,), softbuf', ChestResult).

    Inside an open stage (utils/trace.py), the estimate, the RE gathers
    and the equaliser are its phase `rx.chest`; the soft demodulation, CSI
    weights, descrambling and `sch.decode_tb`'s soft combining its phase
    `rx.llr`, and decode_tb begins `rx.turbo` and `rx.tb`."""
    trace.phase("rx.chest")
    if re_idx is None:
        re_idx = _re_table(cell, sf_idx, prb_mask, rx_grid.device, max_sym)
    else:
        re_idx = torch.as_tensor(re_idx, dtype=torch.int64, device=rx_grid.device)
    ch = chest.estimate(rx_grid, cell, sf_idx)
    flat_rx = rx_grid.reshape(rx_grid.shape[:-3] + (cell.n_sym * cell.nre, 2))
    flat_ce = ch.ce.reshape(flat_rx.shape)
    y = flat_rx[..., re_idx, :]
    h = flat_ce[..., re_idx, :]
    if equalizer == "mmse":
        x_eq, csi = chest.equalize_mmse(y, h, ch.noise_est)
    else:
        x_eq, csi = chest.equalize_zf(y, h)
    trace.phase("rx.llr")
    llr = modem.demod_soft(x_eq, modem.MOD_FROM_QM[cfg.Qm])  # (B, G)
    if use_csi:
        llr = llr * torch.repeat_interleave(csi, cfg.Qm, dim=-1)
    if _td.LOGMAP:
        # log-MAP needs true natural-log LLRs: the 2/sigma^2 term the
        # scale-invariant max-log default never needed (pdsch.py:303-308)
        llr = llr * (2.0 / torch.clamp(ch.noise_est, min=1e-9))[..., None]
    c_init = scrambling.pdsch_cinit(rnti, codeword_q, sf_idx, cell.cell_id)
    llr = scrambling.scramble_llrs(llr, c_init)
    payload, ok, softbuf, _ = sch.decode_tb(llr, cfg, softbuf, max_iter, use_kernel=use_kernel,
                                            llr_bits=llr_bits, read=False)
    return payload, ok, softbuf, ch


# ---------------- multi-antenna transmission modes (TM2-TM6) ----------------

def _codeword_syms(tb: torch.Tensor, cfg: sch.SchConfig, q: int, cell: grid_mod.CellConfig,
                   sf_idx: int, rnti: int) -> torch.Tensor:
    """Codeword q: encode, scramble with c_init(q), modulate -> (B, M_q, 2)."""
    trace.phase("tx.fec")
    cw = sch.encode_tb(tb, cfg)
    trace.phase("tx.map")
    scr = scrambling.scramble_bits(cw, scrambling.pdsch_cinit(rnti, q, sf_idx, cell.cell_id))
    return modem.modulate(scr, modem.MOD_FROM_QM[cfg.Qm])


def _codeword_symbols(tb_list, cfg_list, cell: grid_mod.CellConfig, sf_idx: int,
                      rnti: int) -> list:
    """Per codeword q: `_codeword_syms`."""
    return [_codeword_syms(tb, cfg, q, cell, sf_idx, rnti)
            for q, (tb, cfg) in enumerate(zip(tb_list, cfg_list))]


def _codeword_llrs(stream, csi, cfg: sch.SchConfig, q: int, cell: grid_mod.CellConfig,
                   sf_idx: int, rnti: int) -> torch.Tensor:
    """Soft demod of codeword q's symbols, CSI-weighted, descrambled."""
    llr = modem.demod_soft(stream, modem.MOD_FROM_QM[cfg.Qm])
    llr = llr * torch.repeat_interleave(csi, cfg.Qm, dim=-1)
    return scrambling.scramble_llrs(llr, scrambling.pdsch_cinit(rnti, q, sf_idx, cell.cell_id))


def _put_crs_ports(flat: torch.Tensor, cell: grid_mod.CellConfig, sf_idx: int,
                   n_ports: int) -> None:
    """Write each port's CRS into flat (B, n_port, n_sym*NRE, 2), in place."""
    for p in range(n_ports):
        pidx, v = _crs_of(cell, sf_idx, p, flat.device)
        flat[:, p, pidx, :] = v


def encode_tm(tb_list, cfg_list, cell: grid_mod.CellConfig, sf_idx: int, rnti: int,
              prb_mask: tuple, tm: str, pmi: int = 0, grids=None) -> torch.Tensor:
    """Multi-antenna PDSCH encode (TM2 at 2 or 4 ports, TM3, TM4, TM5/TM6).

    tb_list: list of (B, tbs) payloads (1 cw for TM2/TM5/TM6, 2 for TM3/TM4).
    Returns per-port grids (B, n_ports, 14, NRE, 2) with CRS on every port
    (into a copy of `grids` if given)."""
    re_idx = _re_table(cell, sf_idx, prb_mask, tb_list[0].device)
    n_re = len(re_idx)
    cw_syms = _codeword_symbols(tb_list, cfg_list, cell, sf_idx, rnti)
    B = cw_syms[0].shape[0]
    if tm == "tm2" and cell.n_ports == 4:
        assert n_re % 4 == 0, "4-port SFBC-FSTD needs n_re % 4 == 0"
        ports = mimo.precode_sfbc_fstd(mimo.layer_map(cw_syms, 4))  # (B, 4, n_re, 2)
    elif tm == "tm2":
        ports = mimo.precode_sfbc(mimo.layer_map(cw_syms, 2))  # one cw -> 2 layers
    elif tm == "tm3":
        ports = mimo.precode_cdd2(mimo.layer_map(cw_syms, 2))
    elif tm == "tm4":
        ports = mimo.precode_sm2(mimo.layer_map(cw_syms, 2), pmi)
    elif tm in ("tm5", "tm6"):
        # rank-1 closed loop (TM6); TM5 is the same transmission with the
        # MU-MIMO power offset handled at scheduling level
        ports = mimo.precode_sm1(mimo.layer_map(cw_syms, 1), pmi)
    else:
        raise ValueError(tm)
    n_ports = ports.shape[-3]
    assert ports.shape[-2] == n_re, (ports.shape, n_re)
    if grids is None:
        # fresh grids: one gather per port
        return torch.stack([assemble_grid(ports[:, p], cell, sf_idx, prb_mask, port=p)
                            for p in range(n_ports)], dim=1)
    flat = grids.reshape(B, n_ports, cell.n_sym * cell.nre, 2).clone()
    flat[:, :, re_idx, :] = ports
    _put_crs_ports(flat, cell, sf_idx, n_ports)
    return flat.reshape(B, n_ports, cell.n_sym, cell.nre, 2)


def estimate_mimo(rx_grids: torch.Tensor, cell: grid_mod.CellConfig, sf_idx: int,
                  n_tx: int = 2):
    """Per-(rx, tx) channel estimates.

    rx_grids: (B, n_rx, 14, NRE, 2) -> ce (B, n_rx, n_tx, 14, NRE, 2), noise (B,)."""
    B, n_rx = rx_grids.shape[:2]
    flat = rx_grids.reshape((B * n_rx,) + rx_grids.shape[2:])
    ces, noises = [], []
    for p in range(n_tx):
        ch = chest.estimate(flat, cell, sf_idx, port=p)
        ces.append(ch.ce.reshape((B, n_rx) + ch.ce.shape[1:]))
        noises.append(ch.noise_est.reshape(B, n_rx))
    return torch.stack(ces, dim=2), torch.stack(noises, dim=2).mean(dim=(1, 2))


@table_cache(32)
def _layer_weights(tm: str, pmi: int, m: int, device: torch.device) -> torch.Tensor:
    """Per-RE precoder of TM3 (W D(i) U, W = I/sqrt2) or TM4 (codebook PMI)
    as a cf tensor (tx, layer, m, 2)."""
    if tm == "tm3":
        u = np.array([[1, 1], [1, -1]], dtype=np.complex64) / np.sqrt(2)
        base = (np.eye(2) / np.sqrt(2)).astype(np.complex64)
        w0 = base @ np.diag([1.0, 1.0]).astype(np.complex64) @ u
        w1 = base @ np.diag([1.0, -1.0]).astype(np.complex64) @ u
        w_eff = np.where((np.arange(m) % 2 == 0)[:, None, None], w0[None], w1[None])
    else:
        w_eff = np.broadcast_to(np.asarray(mimo.PMI_2TX_2L[pmi], dtype=np.complex64), (m, 2, 2))
    return cplx.from_numpy(np.ascontiguousarray(w_eff.transpose(1, 2, 0)), device)


def _decode_codewords(llr_list, cfg_list, softbufs, max_iter, use_kernel=None, llr_bits=32):
    """One sch.decode_tb per codeword -> (payload list, ok list, softbuf list)."""
    outs, oks, sbs = [], [], []
    for q, cfg in enumerate(cfg_list):
        payload, ok, sb, _ = sch.decode_tb(llr_list[q], cfg, softbufs[q], max_iter,
                                           use_kernel=use_kernel, llr_bits=llr_bits, read=False)
        outs.append(payload)
        oks.append(ok)
        sbs.append(sb)
    return outs, oks, sbs


def decode_tm(rx_grids: torch.Tensor, cfg_list, cell: grid_mod.CellConfig, sf_idx: int,
              rnti: int, prb_mask: tuple, tm: str, pmi: int = 0, softbufs=None,
              max_iter: int = 8, use_kernel: bool | None = None, llr_bits: int = 32):
    """Multi-antenna PDSCH decode.  rx_grids: (B, n_rx, 14, NRE, 2).

    Returns (payload list, ok list, softbuf list)."""
    re_idx = _re_table(cell, sf_idx, prb_mask, rx_grids.device)
    B, n_rx = rx_grids.shape[:2]
    n_tx = 4 if (tm == "tm2" and cell.n_ports == 4) else 2
    ce, _ = estimate_mimo(rx_grids, cell, sf_idx, n_tx)
    take = lambda a: a.reshape(a.shape[:-3] + (cell.n_sym * cell.nre, 2))[..., re_idx, :]
    y = take(rx_grids)  # (B, n_rx, n_re, 2)
    h = take(ce)  # (B, n_rx, n_tx, n_re, 2)
    del ce
    n_cw = len(cfg_list)
    if tm == "tm2":
        # SFBC: combine across rx antennas by summing per-antenna combiners
        dec = mimo.decode_sfbc_fstd if n_tx == 4 else mimo.decode_sfbc
        xs, csis = [], []
        for r in range(n_rx):
            x_r, csi_r = dec(y[:, r], h[:, r])
            xs.append(x_r * csi_r[..., None])
            csis.append(csi_r)
        csi = sum(csis)
        streams = mimo.layer_demap(sum(xs) / csi[..., None], 1)
        csi_streams = [csi.transpose(-1, -2).reshape(B, -1)]
    elif tm in ("tm5", "tm6"):
        # rank-1 closed loop: fold the codebook vector into the channel
        x, csi = mimo.decode_mrc_eff(y, mimo.rank1_channel(h, mimo.PMI_2TX_1L[pmi]))
        streams, csi_streams = [x], [csi]
    elif tm in ("tm3", "tm4"):
        w = _layer_weights(tm, pmi if tm == "tm4" else 0, len(re_idx), rx_grids.device)
        # effective channel per layer: sum over tx of h[tx] w[tx, layer]
        heff = (cplx.mul(h[:, :, 0, None], w[0]) + cplx.mul(h[:, :, 1, None], w[1]))
        x, csi = mimo.decode_zf2(y, heff)
        streams = mimo.layer_demap(x, n_cw)
        if n_cw == 2:
            csi_streams = [csi[..., 0, :], csi[..., 1, :]]
        else:
            csi_streams = [csi.transpose(-1, -2).reshape(B, -1)]
    else:
        raise ValueError(tm)

    if softbufs is None:
        softbufs = [None] * n_cw
    llr_list = [_codeword_llrs(streams[q], csi_streams[q], cfg, q, cell, sf_idx, rnti)
                for q, cfg in enumerate(cfg_list)]
    # At small batch the MAP passes are latency-bound, so two equal-shaped
    # codewords share one decode_tb call (2B rows), as the reference does
    # up to B = 64 (pdsch.py:242-263); mixed None/non-None soft buffers take
    # the per-codeword path (merging would drop the one HARQ buffer).
    if (n_cw == 2 and cfg_list[0] == cfg_list[1] and B <= 64
            and (softbufs[0] is None) == (softbufs[1] is None)):
        sb_in = None
        if softbufs[0] is not None:
            sb_in = [torch.cat([a, b], dim=0) for a, b in zip(softbufs[0], softbufs[1])]
        payload, ok, sb, _ = sch.decode_tb(torch.cat(llr_list, dim=0), cfg_list[0], sb_in,
                                           max_iter, use_kernel=use_kernel, llr_bits=llr_bits,
                                           read=False)
        return ([payload[:B], payload[B:]], [ok[:B], ok[B:]],
                [[w_[:B] for w_ in sb], [w_[B:] for w_ in sb]])
    return _decode_codewords(llr_list, cfg_list, softbufs, max_iter, use_kernel, llr_bits)


# ---------------- TM7: single-layer beamforming on port 5 ----------------

@functools.lru_cache(maxsize=32)
def _uers5_tables(cell: grid_mod.CellConfig, sf_idx: int, rnti: int, prb_mask: tuple,
                  device: torch.device):
    """(flat UE-RS positions inside the allocation (n,), their values (n, 2);
    every UE-RS position (4, 3*n_prb), values (4, 3*n_prb, 2), frequency
    matrices (4, NRE, 3*n_prb), time matrix (n_sym, 4)) on `device`."""
    ks = grid_mod.uers5_k(cell.cell_id, cell.n_prb)
    vals = grid_mod.uers5_values(cell.cell_id, sf_idx, rnti, cell.n_prb)
    alloc = grid_mod.alloc_mask(cell.nre, prb_mask)
    syms = np.asarray(grid_mod.UERS5_SYMS)
    sel = alloc[ks]
    tx_idx = np.concatenate([sym * cell.nre + ks[i][sel[i]] for i, sym in enumerate(syms)])
    tx_vals = np.concatenate([vals[i][sel[i]] for i in range(len(syms))])
    fms = np.stack([chest.interp_matrix(tuple(ks[i].tolist()), cell.nre)
                    for i in range(len(syms))])
    tm = chest._time_interp_matrix(grid_mod.UERS5_SYMS, cell.n_sym)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (f(tx_idx.astype(np.int64)), cplx.from_numpy(tx_vals, device),
            f((syms[:, None] * cell.nre + ks).astype(np.int64)), cplx.from_numpy(vals, device),
            f(fms), f(tm))


@functools.lru_cache(maxsize=32)
def _re_table_tm(cell: grid_mod.CellConfig, sf_idx: int, prb_mask: tuple, tm: str,
                 device: torch.device) -> torch.Tensor:
    fn = grid_mod.pdsch_re_indices_tm7 if tm == "tm7" else grid_mod.pdsch_re_indices_tm8
    return torch.from_numpy(fn(cell, sf_idx, prb_mask).astype(np.int64)).to(device)


def encode_tm7(tb_bits: torch.Tensor, cfg: sch.SchConfig, cell: grid_mod.CellConfig,
               sf_idx: int, rnti: int, prb_mask: tuple, beam: torch.Tensor) -> torch.Tensor:
    """TM7: one layer beamformed over the physical antennas with UE-specific
    RS on port 5 (pdsch.c TM7 / refsignal_dl.c UE-RS; 36.211 §6.10.3).

    beam: (n_tx, 2) cf beamforming vector (transparent to the UE).
    Returns per-antenna grids (B, n_tx, n_sym, NRE, 2) with CRS per cell port
    and the UE-RS + PDSCH beamformed."""
    dev = tb_bits.device
    re_idx = _re_table_tm(cell, sf_idx, prb_mask, "tm7", dev)
    assert cfg.G == len(re_idx) * cfg.Qm, (cfg.G, len(re_idx), cfg.Qm)
    x = _codeword_symbols([tb_bits], [cfg], cell, sf_idx, rnti)[0]  # (B, n_re, 2)
    uers_idx, uers_vals = _uers5_tables(cell, sf_idx, rnti, prb_mask, dev)[:2]
    B, n_tx = x.shape[0], beam.shape[0]
    beam = beam.to(dev)
    flat = cplx.zeros((B, n_tx, cell.n_sym * cell.nre), device=dev)
    flat[:, :, re_idx, :] = cplx.mul(x[:, None], beam[None, :, None, :])
    flat[:, :, uers_idx, :] = cplx.mul(uers_vals[None], beam[:, None, :])
    _put_crs_ports(flat, cell, sf_idx, min(cell.n_ports, n_tx))
    return flat.reshape(B, n_tx, cell.n_sym, cell.nre, 2)


def decode_tm7(rx_grids: torch.Tensor, cfg: sch.SchConfig, cell: grid_mod.CellConfig,
               sf_idx: int, rnti: int, prb_mask: tuple, softbuf=None, max_iter: int = 8):
    """TM7 decode: effective (beamformed) channel estimated directly from the
    port-5 UE-RS — the beam is transparent; MRC over rx antennas.
    Returns sch.decode_tb's (payload, ok, softbuf, n_iter)."""
    B, n_rx = rx_grids.shape[:2]
    dev = rx_grids.device
    re_idx = _re_table_tm(cell, sf_idx, prb_mask, "tm7", dev)
    _, _, pidx, r, fms, tm = _uers5_tables(cell, sf_idx, rnti, prb_mask, dev)
    flat = rx_grids.reshape(B, n_rx, cell.n_sym * cell.nre, 2)
    # LS at every UE-RS, then freq + time interpolation to the full grid
    h_ls = cplx.mul_conj(flat[:, :, pidx, :], r)  # (B, rx, 4, P, 2)
    h_f = torch.stack([fms[i] @ h_ls[:, :, i] for i in range(len(fms))], dim=-3)
    ce = torch.einsum("ls,...skc->...lkc", tm, h_f)
    ce_flat = ce.reshape(B, n_rx, cell.n_sym * cell.nre, 2)
    x, csi = mimo.decode_mrc_eff(flat[:, :, re_idx, :], ce_flat[:, :, re_idx, :])
    llr = _codeword_llrs(x, csi, cfg, 0, cell, sf_idx, rnti)
    return sch.decode_tb(llr, cfg, softbuf, max_iter)


# ---------------- TM8: dual-layer beamforming on ports 7/8 ----------------

@functools.lru_cache(maxsize=32)
def _uers78_tables(cell: grid_mod.CellConfig, sf_idx: int, prb_mask: tuple,
                   device: torch.device):
    """(flat DMRS positions inside the allocation (4, n), their values
    (4, n, 2), frequency matrix (NRE, n), time matrix of the two symbol
    pairs (n_sym, 2)) on `device`."""
    ks = grid_mod.uers78_k(cell.cell_id, cell.n_prb)
    vals = grid_mod.uers78_values(cell.cell_id, sf_idx, 0, cell.n_prb)
    sel = grid_mod.alloc_mask(cell.nre, prb_mask)[ks]
    kp = ks[sel]
    syms = np.asarray(grid_mod.UERS78_SYMS)
    pair_syms = (grid_mod.UERS78_SYMS[0], grid_mod.UERS78_SYMS[2])
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (f((syms[:, None] * cell.nre + kp).astype(np.int64)),
            cplx.from_numpy(vals[:, sel], device),
            f(chest.interp_matrix(tuple(kp.tolist()), cell.nre)),
            f(chest._time_interp_matrix(pair_syms, cell.n_sym)))


def encode_tm8(tb_list, cfg_list, cell: grid_mod.CellConfig, sf_idx: int, rnti: int,
               prb_mask: tuple, beams: torch.Tensor) -> torch.Tensor:
    """TM8 (Rel-9): up to 2 layers, each beamformed over the physical
    antennas, DMRS on ports 7/8 sharing REs separated by a length-2 OCC
    over adjacent symbol pairs (36.211 §6.10.3; pdsch.c TM8).

    beams: (n_layers, n_tx, 2) cf.  Returns (B, n_tx, n_sym, NRE, 2)."""
    n_layers, n_tx = beams.shape[:2]
    assert len(tb_list) == len(cfg_list) <= 2
    dev = tb_list[0].device
    beams = beams.to(dev)
    re_idx = _re_table_tm(cell, sf_idx, prb_mask, "tm8", dev)
    layers = mimo.layer_map(_codeword_symbols(tb_list, cfg_list, cell, sf_idx, rnti),
                            n_layers)  # (B, L, n_re, 2)
    B = layers.shape[0]
    assert layers.shape[-2] == len(re_idx), (layers.shape, len(re_idx))
    pidx, vals = _uers78_tables(cell, sf_idx, prb_mask, dev)[:2]
    flat = cplx.zeros((B, n_tx, cell.n_sym * cell.nre), device=dev)
    for a in range(n_tx):
        # PDSCH: sum of beamformed layers
        acc = cplx.mul(layers[:, 0], beams[0, a])
        for l in range(1, n_layers):
            acc = acc + cplx.mul(layers[:, l], beams[l, a])
        flat[:, a, re_idx, :] = acc / np.sqrt(n_layers)
        # DMRS: per port OCC over each adjacent symbol pair; the layers' DMRS
        # share REs, so they add, one layer after the other
        for l in range(n_layers):
            occ = grid_mod.UERS78_OCC[7 + l]
            for i in range(len(grid_mod.UERS78_SYMS)):
                br = cplx.mul(vals[i] * occ[i % 2], beams[l, a])
                flat[:, a, pidx[i], :] = flat[:, a, pidx[i], :] + br
    _put_crs_ports(flat, cell, sf_idx, min(cell.n_ports, n_tx))
    return flat.reshape(B, n_tx, cell.n_sym, cell.nre, 2)


def decode_tm8(rx_grids: torch.Tensor, cfg_list, cell: grid_mod.CellConfig, sf_idx: int,
               rnti: int, prb_mask: tuple, softbufs=None, max_iter: int = 8):
    """TM8 decode: OCC despreading separates the per-layer effective
    channels from the shared DMRS REs; 2x2 ZF across layers.
    Returns (payload list, ok list, softbuf list)."""
    B, n_rx = rx_grids.shape[:2]
    n_layers = 2
    dev = rx_grids.device
    re_idx = _re_table_tm(cell, sf_idx, prb_mask, "tm8", dev)
    pidx, r, fm, tmm = _uers78_tables(cell, sf_idx, prb_mask, dev)
    flat = rx_grids.reshape(B, n_rx, cell.n_sym * cell.nre, 2)
    h_ls = [cplx.mul_conj(flat[:, :, pidx[i], :], r[i]) for i in range(len(pidx))]  # LS
    ces = []
    for l in range(n_layers):
        occ = grid_mod.UERS78_OCC[7 + l]
        # despread each symbol pair -> one estimate per pair
        pair_h = [(h_ls[0] * occ[0] + h_ls[1] * occ[1]) / 2.0,
                  (h_ls[2] * occ[0] + h_ls[3] * occ[1]) / 2.0]
        h_f = torch.stack([fm @ ph for ph in pair_h], dim=-3)
        ces.append(torch.einsum("ls,...skc->...lkc", tmm, h_f))
    ce_flat = torch.stack(ces, dim=2).reshape(B, n_rx, n_layers, cell.n_sym * cell.nre, 2)
    # data REs carry sum(b_l x_l)/sqrt(L) while DMRS carries b_l unscaled:
    # scale the estimated channel down to match the data REs
    x, csi = mimo.decode_zf2(flat[:, :, re_idx, :], ce_flat[..., re_idx, :] / np.sqrt(n_layers))
    n_cw = len(cfg_list)
    streams = mimo.layer_demap(x, n_cw)
    if n_cw == 2:
        csi_streams = [csi[..., 0, :], csi[..., 1, :]]
    else:
        csi_streams = [csi.transpose(-1, -2).reshape(B, -1)]
    llr_list = [_codeword_llrs(streams[q], csi_streams[q], cfg, q, cell, sf_idx, rnti)
                for q, cfg in enumerate(cfg_list)]
    return _decode_codewords(llr_list, cfg_list, softbufs or [None] * n_cw, max_iter)
