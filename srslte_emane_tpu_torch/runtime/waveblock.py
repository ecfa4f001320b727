"""Device-resident waveform steady state: T TTIs per device call.

Twin of the reference's `runtime/waveblock.py`.  After attach, an
SPS-configured cell's steady state is a fixed per-UE periodic grant pattern
with no per-TTI PDCCH (36.213 §10.1/§8.1.2 semi-persistent scheduling).  One
call of the block step runs T TTIs x n_ues of the full PHY in both
directions:

  eNB DL:  per-sf base grid (CRS / PSS+SSS / PCFICH / PBCH, gathered from a
           (10, ...) table) + all UEs' SPS PDSCH encodes -> OFDM modulate
  UE rx:   OFDM demod -> per-link AWGN on the REs each UE reads -> CRS
           chest restricted to those REs -> per-UE equalize/demod/descramble
           -> turbo decode + CRC
  UE tx:   SPS PUSCH (SC-FDMA) + PUCCH format-1 HARQ-ACK on the UE's
           dedicated resource -> one shared UL grid -> OFDM modulate + AWGN
  eNB rx:  OFDM demod -> per-UE DMRS chest -> PUSCH decode + CRC -> PUCCH
           matched filter (ACK detect + value)

The T axis is a batch axis: given the payloads, TTIs are independent (SPS
TBs carry no per-TTI HARQ state), so the block is a (T * n_ues)-deep batch
that reaches the turbo decoder as one call per direction.  The tables are
built once per block step on its device; the host only moves payload bits
in and decoded bits out.

All SPS DL allocations avoid the centre 6 PRBs (PSS/SSS/PBCH region), so
one per-UE PDSCH RE table serves every subframe (checked at build).  The
PBCH content is the block-start frame's MIB.  With `tm3` the DL is
large-delay-CDD 2x2 (36.211 §6.3.4.2.2) through a fixed per-UE 2x2 channel.

Noise is drawn through `_randn`, in the reference's order, from the
`torch.Generator` given to the step (the reference's `jax.random` key).
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from ..ops import cplx, dft, mimo, modem, ofdm, scrambling
from ..phch import chest, grid as grid_mod, pbch as pbch_mod
from ..phch import pcfich as pcfich_mod, pdsch as pdsch_mod
from ..phch import pucch as pucch_mod, pusch as pusch_mod, ra
from ..phch import sch, sync as sync_mod
from ..utils.devices import resolve


MIMO_SEED = 1  # the TM3 channel's draw (the reference's mimo_seed default)


class BlockConfig(typing.NamedTuple):
    """Static SPS steady-state description."""

    cell: grid_mod.CellConfig
    rntis: tuple  # per-UE C-RNTI
    dl_rb_start: tuple  # per-UE DL alloc start (contiguous, equal width)
    dl_l_crbs: int
    dl_mcs: int
    ul_rb_start: tuple  # per-UE UL alloc start
    ul_l_prb: int
    ul_mcs: int
    ack_res: tuple  # per-UE dedicated PUCCH format-1 resource
    snr_db: tuple  # per-UE link SNR (pathloss + powers folded in)
    T: int  # TTIs per block
    # the MAP kernel: None follows the inputs' device (the kernel on the
    # card), False runs the plain version (turbodecoder.turbo_decode)
    use_kernel: bool | None = None
    llr_bits: int = 32
    # TM3 large-delay-CDD 2x2 downlink: two codewords, one per layer,
    # through a fixed unitary per-UE 2x2 channel (MIMO_SEED).  Requires
    # cell.n_ports == 2.  Sync/PBCH/PCFICH stay on port 0.  UL stays SISO.
    tm3: bool = False

    @property
    def n_ues(self) -> int:
        return len(self.rntis)

    @property
    def dl_tbs(self) -> int:
        return ra.dl_tbs(self.dl_mcs, self.dl_l_crbs)

    @property
    def ul_tbs(self) -> int:
        return ra.ul_tbs(self.ul_mcs, self.ul_l_prb)


def centre_prbs(n_prb: int) -> tuple:
    """[lo, hi) PRBs touched by the centre-72-subcarrier PSS/SSS/PBCH
    region (not PRB-aligned for odd n_prb: 4.5..10.5 at 15 PRB)."""
    lo = (6 * n_prb - 36) // 12
    hi = -(-(6 * n_prb + 36) // 12)
    return lo, hi


def _randn(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard-normal noise of `shape` from `gen`: every draw of the block
    steps goes through here (the tests replay the reference's draws)."""
    return torch.randn(tuple(shape), generator=gen, device=device)


def _cf(x: np.ndarray) -> np.ndarray:
    """complex numpy -> (..., 2) float32 numpy."""
    return np.stack([x.real, x.imag], -1).astype(np.float32)


def _dl_re_tables(cfg: BlockConfig) -> np.ndarray:
    """(n_ues, n_re) PDSCH RE indices, checked subframe-invariant."""
    cell = cfg.cell
    c0, c1 = centre_prbs(cell.n_prb)
    idx = []
    for rb in cfg.dl_rb_start:
        assert rb + cfg.dl_l_crbs <= c0 or rb >= c1, (
            f"SPS DL alloc [{rb}, {rb + cfg.dl_l_crbs}) overlaps the"
            f" centre PRBs [{c0}, {c1}) (PSS/SSS/PBCH region)")
        mask = ra.type2_to_prb_mask(rb, cfg.dl_l_crbs, cell.n_prb)
        per_sf = [grid_mod.pdsch_re_indices(cell, sf, mask) for sf in (0, 1, 5)]
        assert all(np.array_equal(per_sf[0], p) for p in per_sf[1:]), \
            "DL RE map varies with sf despite centre avoidance"
        idx.append(np.asarray(per_sf[0], np.int32))
    lens = {len(i) for i in idx}
    assert len(lens) == 1, f"unequal DL RE counts: {lens}"
    return np.stack(idx)


def _base_grids(cfg, sfn0: int) -> np.ndarray:
    """(10, n_sym, NRE, 2) base subframes: CRS + PSS/SSS + PCFICH + PBCH
    (phase sfn0 % 4, MIB of frame sfn0).  With tm3: (10, 2, n_sym, NRE, 2)
    per-port grids; port 1 carries only its own CRS."""
    cell = cfg.cell
    mib = torch.from_numpy(np.asarray(pbch_mod.pack_mib(cell.n_prb, sfn0))[None].astype(np.int8))
    outs = []
    for sf in range(10):
        g = cplx.zeros((1, grid_mod.N_SYM, cell.nre))
        g = sync_mod.put_pss_sss(g, cell, sf)
        g = pdsch_mod.put_crs(g, cell, sf)
        g = pcfich_mod.encode(torch.full((1,), cell.cfi, dtype=torch.int64), cell, sf, g)
        if sf == 0:
            g = pbch_mod.encode(mib, cell, sfn0 % 4, g)
        if cfg.tm3:
            g1 = pdsch_mod.put_crs(cplx.zeros((1, grid_mod.N_SYM, cell.nre)), cell, sf, port=1)
            outs.append(np.stack([g[0].numpy(), g1[0].numpy()]))
        else:
            outs.append(g[0].numpy())
    return np.stack(outs)


def _pucch_tables(cfg: BlockConfig):
    """Per-UE format-1 tables on the UE's dedicated resource.

    Returns (pos (n, 2, 7, 12) int32 flat grid indices,
             vals (10, n, 2, 7, 12, 2) float per-sf unit waveforms,
             data_mask (7,) float 1.0 on data symbols).
    Positions are sf-independent (checked)."""
    cell = cfg.cell
    n = cfg.n_ues
    pos = np.zeros((n, 2, 7, 12), np.int32)
    vals = np.zeros((10, n, 2, 7, 12), np.complex64)
    for u, res in enumerate(cfg.ack_res):
        for sf in range(10):
            vals[sf, u] = pucch_mod._f1_waveform(cell.cell_id, sf, res)
        for s in range(2):
            prb = pucch_mod.pucch_prb(res, s, cell.n_prb)
            for sf in range(10):
                assert pucch_mod.pucch_prb(res, 2 * sf + s, cell.n_prb) == prb
            ks = 12 * prb + np.arange(12)
            for l in range(7):
                pos[u, s, l] = (7 * s + l) * cell.nre + ks
    dmask = np.zeros(7, np.float32)
    for l in pucch_mod.F1_DATA_SYMS:
        dmask[l] = 1.0
    return pos, _cf(vals), dmask


def _cell_consts(cfg: BlockConfig, sfn0: int = 0) -> dict:
    """Every cell-dependent table the block body needs, as numpy arrays.

    The DL CRS chest is RE-sparse: per UE, its K unique PDSCH subcarriers
    (dl_kfm = frequency-interp rows at those columns), a column index per
    data RE (dl_col) and the time-interp weights per data RE (dl_tw)."""
    cell = cfg.cell
    dl_idx = _dl_re_tables(cfg)
    ul_data = np.stack([pusch_mod.re_indices(cell.n_prb, rb, cfg.ul_l_prb)[0]
                        for rb in cfg.ul_rb_start])  # (n, 12, m_sc)
    ul_dmrs = np.stack([pusch_mod.re_indices(cell.n_prb, rb, cfg.ul_l_prb)[1]
                        for rb in cfg.ul_rb_start])  # (n, 2, m_sc)
    # the shared UL grid is written with a set: PUSCH allocs must be disjoint
    flat_ul = np.concatenate([ul_data.reshape(-1), ul_dmrs.reshape(-1)])
    assert len(np.unique(flat_ul)) == flat_ul.size, "overlapping UL PUSCH allocations"
    p_pos, p_vals, p_dmask = _pucch_tables(cfg)
    ports = (0, 1) if cfg.tm3 else (0,)
    pidx_p, crs10_p, kfm_p = [], [], []
    K = 12 * cfg.dl_l_crbs
    dl_col, dl_tw = [], []
    for port in ports:
        ks = grid_mod.crs_k(cell.cell_id, cell.n_prb, port, cell.cp)
        syms = grid_mod.pilot_syms(port, cell.cp)
        assert syms == grid_mod.pilot_syms(0, cell.cp)  # shared dl_tw
        pidx_p.append((np.asarray(syms)[:, None] * cell.nre + ks).astype(np.int32))
        crs10_p.append(chest._crs_values10(cell.cell_id, cell.n_prb, port, cell.cp))
        fm = np.stack([chest._freq_interp_matrix(cell.n_prb, int(ks[i][0]))
                       for i in range(len(syms))])  # (S_pil, NRE, P)
        tmat = chest._time_interp_matrix(tuple(syms), cell.n_sym)
        kfm_u = []
        for u in range(cfg.n_ues):
            sym_u, k_u = dl_idx[u] // cell.nre, dl_idx[u] % cell.nre
            kcols, inv = np.unique(k_u, return_inverse=True)
            assert len(kcols) == K, (len(kcols), K)
            if port == 0:
                dl_col.append(inv)
                dl_tw.append(tmat[sym_u])  # (n_re, S_pil)
            kfm_u.append(fm[:, kcols, :])  # (S_pil, K, P)
        kfm_p.append(np.stack(kfm_u))
    pidx = pidx_p[0] if not cfg.tm3 else np.stack(pidx_p)
    crs10 = crs10_p[0] if not cfg.tm3 else np.stack(crs10_p)
    extra = {}
    if cfg.tm3:
        assert cell.n_ports == 2, "tm3 requires CellConfig(n_ports=2)"
        # fixed per-UE 2x2 channel: unitary x unitary (the reference's
        # default condition number, 0 dB), mean |h|^2 normalized to 1
        rng = np.random.default_rng(MIMO_SEED)
        h2 = np.zeros((cfg.n_ues, 2, 2, 2), np.float32)
        for u in range(cfg.n_ues):
            q1 = np.linalg.qr(rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2)))[0]
            q2 = np.linalg.qr(rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2)))[0]
            h = q1 @ q2.conj().T
            h = h / np.sqrt((np.abs(h) ** 2).mean())
            h2[u, ..., 0], h2[u, ..., 1] = h.real, h.imag
        extra["h2"] = h2
    return dict(
        **extra,
        rntis=np.asarray(cfg.rntis, np.int64),
        amp=(10.0 ** (-np.asarray(cfg.snr_db, np.float32) / 20.0)),
        base10=_base_grids(cfg, sfn0),
        dl_idx=dl_idx.astype(np.int64),
        ul_data=ul_data.astype(np.int64), ul_dmrs=ul_dmrs.astype(np.int64),
        dmrs10=_cf(pusch_mod._dmrs10(cell.cell_id, cfg.ul_l_prb)),
        p_pos=p_pos.astype(np.int64), p_vals=p_vals, p_dmask=p_dmask,
        ch_pidx=pidx.astype(np.int64), ch_vals10=_cf(crs10),
        dl_col=np.stack(dl_col).astype(np.int64),
        dl_tw=np.stack(dl_tw).astype(np.float32),
        dl_kfm=(kfm_p[0] if not cfg.tm3 else np.stack(kfm_p)).astype(np.float32),
    )


def _on(consts: dict, device: torch.device) -> dict:
    """The tables as tensors on `device` (uploaded once per block step)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in consts.items()}


def _gather_cols(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """jnp.take_along_axis(x, idx, dim) with idx broadcast against x on
    every other axis (torch.gather wants the shapes spelled out)."""
    shape = list(torch.broadcast_shapes(x.shape[:dim] + (1,) + x.shape[dim + 1:],
                                        idx.shape[:dim] + (1,) + idx.shape[dim + 1:]))
    x_shape = list(shape)
    x_shape[dim] = x.shape[dim]
    shape[dim] = idx.shape[dim]
    return x.expand(x_shape).gather(dim, idx.expand(shape))


def _ul_estimate(yd: torch.Tensor, rref: torch.Tensor):
    """eNB DMRS chest of the blocks: LS, 5-tap edge-padded smoothing,
    linear time interpolation.  yd (..., 2, m_sc, 2) received DMRS; rref
    broadcastable to it.  Returns (ce (..., 12, m_sc, 2), noise (...))."""
    h_ls = cplx.mul_conj(yd, rref)
    m_sc = yd.shape[-2]
    k5 = 5
    edge = torch.arange(-(k5 // 2), m_sc + k5 // 2, device=yd.device).clamp(0, m_sc - 1)
    pad = h_ls[..., edge, :]
    sm = sum(pad[..., i : i + m_sc, :] for i in range(k5)) / k5
    lead = h_ls.shape[:-3]
    noise = cplx.abs2(h_ls - sm).reshape(lead + (-1,)).mean(-1) * 1.25
    t_w = torch.from_numpy((np.array(pusch_mod.DATA_SYMS, np.float32) - 3.0) / 7.0).to(yd.device)
    ce = ((1.0 - t_w)[:, None, None] * sm[..., 0:1, :, :]
          + t_w[:, None, None] * sm[..., 1:2, :, :])
    return ce, noise


def _ul_llrs(yu, ce, noise, qm: int, cinit) -> torch.Tensor:
    """PUSCH data REs (B..., 12, m_sc, 2) -> descrambled, deinterleaved
    LLRs (B, G): MMSE, inverse transform precoding, per-symbol CSI weight."""
    m_sc = yu.shape[-2]
    xeq, csi = chest.equalize_mmse(yu, ce, noise)
    B = xeq.numel() // (12 * m_sc * 2)
    xtd = dft.idft(xeq.reshape(B, 12, m_sc, 2))
    llr = modem.demod_soft(xtd.reshape(B, 12 * m_sc, 2), modem.MOD_FROM_QM[qm])
    w = csi.reshape(B, 12, m_sc).mean(-1)
    llr = llr * torch.repeat_interleave(w, m_sc * qm, dim=-1)
    llr = scrambling.scramble_llrs(llr, cinit)
    return pusch_mod.deinterleave(llr, qm)


def _pucch_corr(yp, pv, dmask):
    """PUCCH format-1 matched filter: (..., 2, 7, 12, 2) received and unit
    waveforms -> (..., 2) correlation over the data symbols."""
    prod = cplx.mul_conj(yp, pv)
    return (prod * dmask[:, None, None]).sum(dim=(-4, -3, -2)) / (
        12 * 2 * len(pucch_mod.F1_DATA_SYMS))


def _step_body(cfg: BlockConfig, c: dict, dl_bits, ul_bits, gen, tti0):
    """One T-TTI block on the tables `c` (tensors on one device)."""
    cell = cfg.cell
    n, T = cfg.n_ues, cfg.T
    dev = c["rntis"].device
    qm_d = ra.dl_mcs_to_qm(cfg.dl_mcs)
    qm_u = ra.ul_mcs_to_qm(cfg.ul_mcs)
    n_re_d = c["dl_idx"].shape[-1]
    cfg_d = sch.SchConfig(tbs=cfg.dl_tbs, G=n_re_d * qm_d, Qm=qm_d, Nl=1)
    m_sc = 12 * cfg.ul_l_prb
    cfg_u = sch.SchConfig(tbs=cfg.ul_tbs, G=m_sc * 12 * qm_u, Qm=qm_u, Nl=1)
    S = grid_mod.N_SYM * cell.nre
    dl_idx, ul_data, ul_dmrs = c["dl_idx"], c["ul_data"], c["ul_dmrs"]
    p_pos, p_vals, p_dmask = c["p_pos"], c["p_vals"], c["p_dmask"]
    rntis, amp = c["rntis"], c["amp"]
    decode = dict(use_kernel=cfg.use_kernel, llr_bits=cfg.llr_bits)
    sfs = (torch.as_tensor(tti0, device=dev) + torch.arange(T, device=dev)) % 10  # (T,)

    # ---------------- eNB DL encode ----------------
    cinit_d = ((rntis[None, :] << 14) + (sfs[:, None] << 9) + cell.cell_id).reshape(-1)
    if cfg.tm3:
        # two codewords, one per layer; q rides bit 13 of the scrambling cinit
        cinits = [cinit_d + (q << 13) for q in (0, 1)]
        layers = torch.stack([
            modem.modulate(scrambling.scramble_bits(
                sch.encode_tb(dl_bits[:, :, q].reshape(T * n, cfg.dl_tbs), cfg_d), cinits[q]),
                modem.MOD_FROM_QM[qm_d])
            for q in (0, 1)], dim=-3)  # (T*n, 2, n_re, 2)
        ports = mimo.precode_cdd2(layers)  # (T*n, 2p, n_re, 2)
        flat = c["base10"][sfs].reshape(T, 2, S, 2)
        pp = ports.reshape(T, n, 2, n_re_d, 2)
        for p in (0, 1):
            flat[:, p, dl_idx.reshape(-1), :] = pp[:, :, p].reshape(T, n * n_re_d, 2)
        tx = ofdm.modulate(flat.reshape(T * 2, grid_mod.N_SYM, cell.nre, 2), cell.n_prb)
    else:
        cw = sch.encode_tb(dl_bits.reshape(T * n, cfg.dl_tbs), cfg_d)
        syms = modem.modulate(scrambling.scramble_bits(cw, cinit_d), modem.MOD_FROM_QM[qm_d])
        flat = c["base10"][sfs].reshape(T, S, 2)
        flat[:, dl_idx.reshape(-1), :] = syms.reshape(T, n * n_re_d, 2)
        tx = ofdm.modulate(flat.reshape(T, grid_mod.N_SYM, cell.nre, 2), cell.n_prb)

    # ---------------- DL channel + UE receive (RE-sparse) ----------------
    # one OFDM demod of the cell waveform serves every UE; each link's AWGN
    # is drawn on the demodulated REs that UE reads (the DFT is unitary, so
    # white noise per RE is distributed as time-domain noise)
    S_pil, P = c["ch_pidx"].shape[-2:]
    a2 = amp / np.sqrt(2)
    if cfg.tm3:
        rg_tx = ofdm.demodulate(tx, cell.n_prb).reshape(T, 2, S, 2)
        h2 = c["h2"]  # (n, 2rx, 2tx, 2)
        tp = torch.stack([rg_tx[:, p][:, dl_idx.reshape(-1)].reshape(T, n, n_re_d, 2)
                          for p in (0, 1)], dim=2)  # (T, n, 2tx, re, 2)
        y = (cplx.mul(h2[None, :, :, :, None], tp[:, :, None]).sum(3)
             + a2[None, :, None, None, None] * _randn(gen, (T, n, 2, n_re_d, 2), dev))
        # at port-p CRS positions the other port is silent: LS per (rx, port)
        pt = torch.stack([rg_tx[:, p][:, c["ch_pidx"][p].reshape(-1)] for p in (0, 1)],
                         dim=1)  # (T, 2tx, S_pil*P, 2)
        y_pil = (cplx.mul(h2[None, :, :, :, None], pt.reshape(T, 1, 1, 2, S_pil * P, 2))
                 + a2[None, :, None, None, None, None]
                 * _randn(gen, (T, n, 2, 2, S_pil * P, 2), dev))
        r_p = c["ch_vals10"][:, sfs]  # (2, T, S_pil, P, 2)
        h_ls = cplx.mul_conj(y_pil.reshape(T, n, 2, 2, S_pil, P, 2),
                             r_p.movedim(0, 1)[:, None, None])  # (T,n,a,p,S,P,2)
        # a = rx antenna, p = tx port, s = pilot symbol, k = unique
        # subcarrier column, q = pilot index, e = data RE
        h_f = torch.einsum("puskq,tuapsqc->tuapskc", c["dl_kfm"], h_ls)
        h_re = _gather_cols(h_f, c["dl_col"][None, :, None, None, None, :, None], 5)
        h = torch.einsum("ues,tuapsec->tuapec", c["dl_tw"], h_re)
        # fold the CDD precoder into the channel:
        # P(i) = (1/2) [[1, 1], [s_i, -s_i]]  (s_i = (-1)^i)
        sgn = 1.0 - 2.0 * (torch.arange(n_re_d, device=dev) % 2).float()
        hp0, hp1 = h[:, :, :, 0], h[:, :, :, 1]  # (T, n, r, re, 2)
        heff = torch.stack([(hp0 + hp1 * sgn[:, None]) * 0.5,
                            (hp0 - hp1 * sgn[:, None]) * 0.5], dim=3)
        x_eq, csi2 = mimo.decode_zf2(y, heff)
        oks, outs = [], []
        for q in (0, 1):
            llr = modem.demod_soft(x_eq[:, :, q].reshape(T * n, n_re_d, 2),
                                   modem.MOD_FROM_QM[qm_d])
            llr = llr * torch.repeat_interleave(
                csi2[:, :, q].clamp(0.0, 1e3).reshape(T * n, n_re_d), qm_d, dim=-1)
            llr = scrambling.scramble_llrs(llr, cinits[q])
            o, k, _, _ = sch.decode_tb(llr, cfg_d, **decode)
            outs.append(o)
            oks.append(k)
        dl_out = torch.stack(outs, dim=1).reshape(T, n, 2, -1)
        dl_ok2 = torch.stack(oks, dim=1).reshape(T, n, 2)
        dl_ok = dl_ok2.all(-1)  # spatially bundled ACK (both codewords)
    else:
        rg_tx = ofdm.demodulate(tx, cell.n_prb).reshape(T, S, 2)
        y = (rg_tx[:, dl_idx.reshape(-1)].reshape(T, n, n_re_d, 2)
             + a2[None, :, None, None] * _randn(gen, (T, n, n_re_d, 2), dev))
        p_tx = rg_tx[:, c["ch_pidx"].reshape(-1)]
        y_p = (p_tx.reshape(T, 1, S_pil, P, 2)
               + a2[None, :, None, None, None] * _randn(gen, (T, n, S_pil, P, 2), dev))
        r_p = c["ch_vals10"][sfs]  # (T, S_pil, P, 2)
        h_ls = cplx.mul_conj(y_p, r_p[:, None])  # (T, n, S_pil, P, 2)
        h_f = torch.einsum("uskp,tuspc->tuskc", c["dl_kfm"], h_ls)
        h_re = _gather_cols(h_f, c["dl_col"][None, :, None, :, None], 3)
        h = torch.einsum("urs,tusrc->turc", c["dl_tw"], h_re)
        x_eq, csi = chest.equalize_zf(y, h)
        llr = modem.demod_soft(x_eq.reshape(T * n, n_re_d, 2), modem.MOD_FROM_QM[qm_d])
        llr = llr * torch.repeat_interleave(csi.reshape(T * n, n_re_d), qm_d, dim=-1)
        llr = scrambling.scramble_llrs(llr, cinit_d)
        dl_out, dl_ok, _, _ = sch.decode_tb(llr, cfg_d, **decode)

    # ---------------- UE transmit: SPS PUSCH + PUCCH ACK ----------------
    cinit_u = cinit_d
    cw_u = sch.encode_tb(ul_bits.reshape(T * n, cfg.ul_tbs), cfg_u)
    scr_u = scrambling.scramble_bits(pusch_mod.interleave(cw_u, qm_u), cinit_u)
    s_u = modem.modulate(scr_u, modem.MOD_FROM_QM[qm_u])
    x_u = dft.dft(s_u.reshape(T * n, 12, m_sc, 2))
    # one shared UL grid per TTI: allocations are disjoint and the IDFT is
    # linear, so the per-UE grids collapse into one scatter + one modulate;
    # PUCCH is added, so overlapping format-1 resources superpose
    ug = torch.zeros((T, S, 2), device=dev)
    ug[:, ul_data.reshape(-1), :] = x_u.reshape(T, n * 12 * m_sc, 2)
    dv = c["dmrs10"].reshape(10, -1, 2)[sfs]  # (T, 2*m_sc, 2)
    ug[:, ul_dmrs.reshape(-1), :] = dv.repeat(1, n, 1)
    # PUCCH format 1a on the dedicated resource: d0 = +1 ack, -1 nack
    d0 = torch.where(dl_ok.reshape(T, n), 1.0, -1.0)  # (T, n)
    pv = p_vals[sfs]  # (T, n, 2, 7, 12, 2)
    scale = (p_dmask[:, None] * d0[..., None, None, None] + (1.0 - p_dmask)[:, None])
    pcontrib = pv * scale[..., None]
    for u in range(n):  # one UE per add: its positions are distinct, so the sums
        # of overlapping resources come in one fixed order (u = 0..n-1) on any device
        ug[:, p_pos[u].reshape(-1)] += pcontrib[:, u].reshape(T, 2 * 7 * 12, 2)
    # superpose at the eNB: unit power per UE, one noise floor at the worst link
    utx = ofdm.modulate(ug.reshape(T, grid_mod.N_SYM, cell.nre, 2), cell.n_prb)
    un = _randn(gen, utx.shape, dev) / np.sqrt(2)
    urx = utx + amp.max() * un

    # ---------------- eNB receive ----------------
    urg = ofdm.demodulate(urx, cell.n_prb).reshape(T, S, 2)
    yd = urg[:, ul_dmrs.reshape(-1)].reshape(T, n, 2, m_sc, 2)
    rref = c["dmrs10"][sfs]  # (T, 2, m_sc, 2)
    ce_u, noise_u = _ul_estimate(yd, rref[:, None])
    yu = urg[:, ul_data.reshape(-1)].reshape(T, n, 12, m_sc, 2)
    llr_u = _ul_llrs(yu, ce_u, noise_u, qm_u, cinit_u)
    ul_out, ul_ok, _, _ = sch.decode_tb(llr_u, cfg_u, **decode)

    # PUCCH matched filter on each UE's dedicated resource
    yp = urg[:, p_pos.reshape(-1)].reshape(T, n, 2, 7, 12, 2)
    corr = _pucch_corr(yp, pv, p_dmask)
    return dict(
        dl_ok=dl_ok.reshape(T, n), dl_out=dl_out.reshape(T, n, -1),
        ul_ok=ul_ok.reshape(T, n), ul_out=ul_out.reshape(T, n, -1),
        ack_energy=cplx.abs2(corr), ack_val=corr[..., 0],
        **({"dl_ok_cw": dl_ok2} if cfg.tm3 else {}))


def make_block_step(cfg: BlockConfig, sfn0: int = 0, device="cuda"):
    """Build the single-cell T-TTI block step on `device` (the card by
    default; raises where there is none).

    Returns fn(dl_bits (T, n, dl_tbs) int8 (tm3: (T, n, 2, dl_tbs)),
               ul_bits (T, n, ul_tbs) int8,
               gen torch.Generator on the device, tti0 int)
      -> dict(dl_ok (T, n) bool, dl_out (T, n, dl_tbs) int8 (tm3: (T, n,
              2*dl_tbs), both codewords, and dl_ok_cw (T, n, 2)), ul_ok (T, n) bool,
              ul_out (T, n, ul_tbs) int8, ack_energy (T, n), ack_val (T, n))
    The bits may be numpy arrays or tensors; they are moved to the device.
    """
    dev = resolve(device, "make_block_step")
    consts = _on(_cell_consts(cfg, sfn0), dev)

    def step(dl_bits, ul_bits, gen, tti0):
        return _step_body(cfg, consts, torch.as_tensor(dl_bits, device=dev),
                          torch.as_tensor(ul_bits, device=dev), gen, tti0)

    return step


def _pack_segments(n_prb: int, n: int, segments) -> tuple:
    """Pack n equal-width contiguous allocations into the PRB segments.
    Returns (starts tuple, width)."""
    total = sum(b - a for a, b in segments)
    w = max(1, total // n)
    while w > 1:
        fit = sum((b - a) // w for a, b in segments)
        if fit >= n:
            break
        w -= 1
    starts, si = [], 0
    cur = segments[0][0]
    for _ in range(n):
        while cur + w > segments[si][1]:
            si += 1
            assert si < len(segments), f"{n} UEs don't fit {segments}"
            cur = segments[si][0]
        starts.append(cur)
        cur += w
    return tuple(starts), w


def _mux(rlc_map, tbs_bytes: int) -> bytes:
    """One MAC PDU from a dict of RLC entities (36.321 mux role), padded to
    the TBS with real padding subheaders."""
    from ..stack import pdu as pdu_mod

    subs, room = [], tbs_bytes - 4
    for lcid in sorted(rlc_map):
        while room > 8 and rlc_map[lcid].has_data():
            p = rlc_map[lcid].read_pdu(room - 4)
            if p is None:
                break
            subs.append((lcid, p))
            room -= len(p) + 3
    return pdu_mod.pack(subs, tb_size=tbs_bytes)


def _mux_block(net, rntis, ue_idx, T: int, dl_tbs: int, ul_tbs: int):
    """T TTIs of MAC PDUs per UE drained from the eNB's and the UEs' RLC
    entities (the MAC ticking once per TTI): ((T, n, dl_tbs), (T, n,
    ul_tbs)) int8 bits."""
    mac = net.enb.mac
    dtb, utb = dl_tbs // 8, ul_tbs // 8
    dl = np.zeros((T, len(rntis), dtb), np.uint8)
    ul = np.zeros((T, len(rntis), utb), np.uint8)
    for t in range(T):
        for i, r in enumerate(rntis):
            dl[t, i] = np.frombuffer(_mux(mac.ues[r].rlc, dtb), np.uint8)
            ul[t, i] = np.frombuffer(_mux(net.ues[ue_idx[i]].stack.rlc, utb), np.uint8)
        getattr(mac, "tick", lambda: None)()
    return (np.unpackbits(dl, axis=-1).astype(np.int8),
            np.unpackbits(ul, axis=-1).astype(np.int8))


def _link_snrs(net, rntis) -> tuple:
    """(UE index of each RNTI in net.ues, per-RNTI DL link SNR in dB)."""
    med = net.medium
    by_crnti = {ue.stack.crnti: i for i, ue in enumerate(net.ues)}
    ue_idx = [by_crnti[r] for r in rntis]
    snr = tuple(float(med.tx_power_dbm - med.pathloss_db[i] - med.noise_floor_dbm)
                for i in ue_idx)
    return ue_idx, snr


class SpsBlockRunner:
    """Bridge between an ATTACHED WaveformNetwork's L2/L3 stacks and the
    device-resident block program: per block, the host drains T TTIs of
    MAC PDUs from the eNB's and UEs' RLC entities (pure byte work), runs
    ONE block step for the whole block's PHY on the network's device, and
    feeds the decoded TBs back into the stacks.  Feedback loops (RLC AM
    status, etc.) see a T-TTI latency — the block is the speculation
    window, the same trade the reference makes pipelining TTIs across
    sf_workers (txrx.cc:105-145), deepened to a device batch.

    The per-UE dedicated SR PUCCH resource doubles as the SPS persistent
    HARQ-ACK resource (the n1PUCCH-AN-persistentList role — rrc_wire.py
    sps-config carries that list).  The block's noise comes from a
    torch.Generator seeded net.tti + 17."""

    def __init__(self, net, T: int = 20, dl_mcs: int = 10, ul_mcs: int = 10):
        self.net = net
        mac = net.enb.mac
        cell = net.cell
        rntis = sorted(r for r, u in mac.ues.items()
                       if u.state == "RRC_CONNECTED"
                       and getattr(u, "sr_pucch_res", None) is not None)
        assert rntis, "no RRC-connected UEs to run in block mode"
        n_prb = cell.n_prb
        c0, c1 = centre_prbs(n_prb)
        dl_starts, dl_w = _pack_segments(
            n_prb, len(rntis), [(0, c0), (c1, n_prb)])
        lo, hi = mac.ul_prb_lo, mac.ul_prb_hi
        wu = max(1, (hi - lo) // len(rntis))
        while wu > 1 and not pusch_mod.valid_n_prb(wu):
            wu -= 1
        ul_starts = tuple(lo + i * wu for i in range(len(rntis)))
        self.ue_idx, snr = _link_snrs(net, rntis)
        self.cfg = BlockConfig(
            cell=cell, rntis=tuple(rntis),
            dl_rb_start=dl_starts, dl_l_crbs=dl_w, dl_mcs=dl_mcs,
            ul_rb_start=ul_starts, ul_l_prb=wu, ul_mcs=ul_mcs,
            ack_res=tuple(mac.ues[r].sr_pucch_res for r in rntis),
            snr_db=snr, T=T)
        self.step = make_block_step(self.cfg, sfn0=(net.tti // 10) % 1024,
                                    device=net.device)
        self._gen = torch.Generator(device=net.device)
        self._gen.manual_seed(net.tti + 17)
        self.metrics = dict(blocks=0, dl_tb=0, dl_ok=0, ul_tb=0, ul_ok=0,
                            ack_det=0)

    def run_block(self) -> dict:
        """Run T TTIs device-resident.  Returns the block's outputs (as
        numpy arrays)."""
        net, cfg = self.net, self.cfg
        mac = net.enb.mac
        dl, ul = _mux_block(net, cfg.rntis, self.ue_idx, cfg.T, cfg.dl_tbs, cfg.ul_tbs)
        out = self.step(dl, ul, self._gen, net.tti % 10240)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        dl_out = np.packbits(out["dl_out"].astype(np.uint8), axis=-1)
        ul_out = np.packbits(out["ul_out"].astype(np.uint8), axis=-1)
        ack = out["ack_energy"] > 0.25
        for t in range(cfg.T):
            tti = net.tti + t
            for i, r in enumerate(cfg.rntis):
                ust = net.ues[self.ue_idx[i]].stack
                self.metrics["dl_tb"] += 1
                self.metrics["ul_tb"] += 1
                if out["dl_ok"][t, i]:
                    self.metrics["dl_ok"] += 1
                    ust.tb_decoded(tti, dl_out[t, i].tobytes(),
                                   cfg.snr_db[i], rnti=r)
                    ust.get_pucch(tti)  # PHY-level ACK already carried
                if out["ul_ok"][t, i]:
                    self.metrics["ul_ok"] += 1
                    mac.ul_pdu(tti, r, ul_out[t, i].tobytes(),
                               cfg.snr_db[i])
                self.metrics["ack_det"] += int(ack[t, i])
                if hasattr(ust, "tick"):
                    ust.tick()
        net.tti += cfg.T
        self.metrics["blocks"] += 1
        return out


def make_bench_step(cfg: BlockConfig, sfn0: int = 0, device="cuda"):
    """The block step reduced on the device to three counts: (DL CRCs
    passed (per codeword with tm3), UL CRCs passed, ACKs detected with
    ack_energy > 1e-2)."""
    step = make_block_step(cfg, sfn0, device)

    def bench(dl_bits, ul_bits, gen, tti0):
        out = step(dl_bits, ul_bits, gen, tti0)
        dl_ok = out["dl_ok_cw"] if cfg.tm3 else out["dl_ok"]
        return dl_ok.sum(), out["ul_ok"].sum(), (out["ack_energy"] > 1e-2).sum()

    return bench
