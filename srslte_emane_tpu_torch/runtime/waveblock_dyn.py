"""Device-resident dynamic waveform block: per-TTI PDCCH DCI + 8-process
IR-HARQ, R rounds per device call.

Twin of the reference's `runtime/waveblock_dyn.py` (the analogue of
srsenb's per-TTI loop, `sf_worker.cc:354` work_imp: per-subframe DL/UL
grants as DCI on PDCCH, 8-process HARQ with IR soft combining,
`scheduler_harq.cc`, `fec/softbuffer.c`, `phch/sch.c:389-414`):

  per TTI, on the device:
    eNB tx: DCI-1A (DL) + DCI-0 (UL) packed as bit tensors -> PDCCH (conv
        code + CRC16^RNTI at 36.213 search-space CCEs) -> PDSCH at the
        TTI's rb_start with NDI/RV from the live HARQ state -> PHICH (the
        previous round's UL CRCs, §9.1.2 mapping) -> OFDM modulate.
    UE rx: blind-decode its search-space candidates from the waveform
        (batched Viterbi + CRC16^RNTI), follow only what was decoded (RIV
        -> rb_start, NDI -> new data, RV -> combine position), PDSCH decode
        with per-(ue, pid) soft buffers (an NDI toggle resets them), PHICH.
    UE tx: HARQ-ACK on PUCCH format 1a at n1 = nCCE(DL DCI) (DTX when the
        DCI was missed), PUSCH with synchronous non-adaptive UL HARQ.
    eNB rx: PUSCH decode with per-(ue, pid) soft buffers + RV cycling,
        PUCCH ACK matched filter with DTX detection -> the next round's
        retransmission / NDI / drop decisions (max_tx cap).

A round is 8 TTIs, one per HARQ process; they run as one batch.  The rounds
are the reference's `lax.scan`, carrying the protocol's state: soft
buffers, NDI toggles, retransmission counts, queue pointers, the previous
RBs, the PHICH payload and the counters.  The round body keeps that state
in tensors that it writes back in place, reads its schedule entries at a
round index held on the device and writes its outputs there, so no Python
value depends on the round or on the data: on the card one round is
captured once as a CUDA graph (`graphs.RoundGraph`) and replayed R times,
and the host enqueues R replays and a few copies per block; elsewhere, and
with jit=False, the same body runs as a Python loop of R rounds.

Modeling simplifications, as in the reference: the 4 ms HARQ-ACK/PHICH
delay is folded into the TTI; grant widths and MCS are static per block
(rb_start hops per TTI); one aggregation level per block; PHICH (group,
seq) uses n_dmrs = UE index.

Where the reference relies on JAX's index clamping (dynamic_slice starts,
the payload-queue gathers), the port clamps by the same rule.  Noise is
drawn through `waveblock._randn` in the reference's order.
"""

from __future__ import annotations

import types
import typing

import numpy as np
import torch

from ..ops import cplx, dft, modem, ofdm, scrambling, sequence
from ..ops.fec import convcoder, crc as crc_mod, turbodecoder_cuda, viterbi
from ..phch import chest, dci as dci_mod, grid as grid_mod
from ..phch import pdcch as pdcch_mod, phich as phich_mod
from ..phch import pucch as pucch_mod, pusch as pusch_mod, ra, sch
from ..utils.devices import resolve
from . import graphs, waveblock

RV_SEQ = np.array([0, 2, 3, 1], np.int32)  # scheduler_harq.cc RV cycle
N_PID = 8
# the per-round outputs, by dtype, and the block's counters
ROUND_FLAGS = ("dl_ok", "dl_new", "dl_found", "ack_det", "ul_ok", "ul_new", "ul_tx")
ROUND_INTS = ("rb_ue", "rv_dl")
COUNTERS = ("dl_retx_tx", "dl_drop", "ul_retx_tx", "ul_drop", "dci_dl_miss", "dci_ul_miss")


class DynBlockConfig(typing.NamedTuple):
    """Static shape parameters of the dynamic block."""

    cell: grid_mod.CellConfig
    rntis: tuple
    dl_l_crbs: int
    dl_mcs: int
    ul_l_prb: int
    ul_mcs: int
    snr_db: tuple  # per-UE link SNR
    R: int  # HARQ rounds (T = 8*R TTIs)
    l_aggr: int = 1  # the PDCCH aggregation level of every DCI
    max_tx: int = 4  # transmissions before drop (mac max-harq-tx)
    ack_thresh: float = 0.25  # PUCCH energy DTX threshold
    # the MAP kernel: None follows the inputs' device, False the plain version
    use_kernel: bool | None = None
    llr_bits: int = 32
    combine: bool = True  # False = chase combining (retx-only control)

    @property
    def n_ues(self) -> int:
        return len(self.rntis)

    @property
    def T(self) -> int:
        return N_PID * self.R

    @property
    def dl_tbs(self) -> int:
        return ra.dl_tbs(self.dl_mcs, self.dl_l_crbs)

    @property
    def ul_tbs(self) -> int:
        return ra.ul_tbs(self.ul_mcs, self.ul_l_prb)


# ---------------------------------------------------------------------------
# host-side table construction
# ---------------------------------------------------------------------------

def _alloc_cces(cfg) -> tuple:
    """(cce_dl (10, n), cce_ul (10, n), cand (10, n, n_cand)) int32:
    per-sf collision-free CCE choices for both grants from each UE's 36.213
    search space at the block's aggregation level, plus the candidate lists
    the UE blind-decodes."""
    cell, l = cfg.cell, cfg.l_aggr
    cands_per = {}
    for sf in range(10):
        for rnti in cfg.rntis:
            cs = [s for (ll, s) in pdcch_mod.candidates(cell, rnti, sf) if ll == l]
            assert cs, (rnti, sf, l, "no candidates at this aggregation")
            cands_per[(sf, rnti)] = cs
    n_cand = max(len(v) for v in cands_per.values())
    cce_dl = np.zeros((10, cfg.n_ues), np.int32)
    cce_ul = np.zeros((10, cfg.n_ues), np.int32)
    cand = np.zeros((10, cfg.n_ues, n_cand), np.int32)
    for sf in range(10):
        for u, rnti in enumerate(cfg.rntis):
            cs = cands_per[(sf, rnti)]
            cand[sf, u] = (cs * n_cand)[:n_cand]  # pad by cycling
        # backtracking assignment (scheduler_grid.cc alloc_dci role):
        # 2 disjoint candidates per UE, most-constrained UE first
        order = sorted(range(cfg.n_ues), key=lambda u: len(cands_per[(sf, cfg.rntis[u])]))
        choice = {}
        budget = [20000]  # node cap: cap-exceeded counts as infeasible

        def place(i, used):
            budget[0] -= 1
            if budget[0] <= 0:
                return False
            if i == len(order):
                return True
            u = order[i]
            cs = cands_per[(sf, cfg.rntis[u])]
            for a in range(len(cs)):
                ca = set(range(cs[a], cs[a] + l))
                if ca & used:
                    continue
                for b in range(len(cs)):
                    if b == a:
                        continue
                    cb = set(range(cs[b], cs[b] + l))
                    if cb & (used | ca):
                        continue
                    choice[u] = (cs[a], cs[b])
                    if place(i + 1, used | ca | cb):
                        return True
            choice.pop(u, None)
            return False

        assert place(0, set()), f"sf {sf}: cannot place 2 grants x {cfg.n_ues} UEs at L={l}"
        for u in range(cfg.n_ues):
            cce_dl[sf, u], cce_ul[sf, u] = choice[u]
    return cce_dl, cce_ul, cand


def feasible_rntis(cell: grid_mod.CellConfig, n: int, l_aggr: int = 1,
                   start: int = 64) -> tuple:
    """First RNTI set whose 36.213 Y_k candidate positions admit 2 disjoint
    grants per UE in every subframe (a static block needs an all-sf-feasible
    set: the eNB's RNTI-assignment freedom)."""
    picked = []
    rnti = start
    while len(picked) < n:
        assert rnti < start + 4096, "no feasible RNTI set found"
        trial = picked + [rnti]
        shim = types.SimpleNamespace(cell=cell, rntis=tuple(trial), l_aggr=l_aggr,
                                     n_ues=len(trial))
        try:
            _alloc_cces(shim)
            picked = trial
        except AssertionError:
            pass
        rnti += 1
    return tuple(picked)


def _chest_taps(cell: grid_mod.CellConfig):
    """Sparse 2-tap frequency-interp tables: h(sym, k) = sum_s tmat[sym, s]
    * sum_j fw[s, k, j] * h_ls[s, fidx[s, k, j]], chest.estimate's linear
    interpolation factored so that REs chosen at run time can be estimated
    without a full-grid CE."""
    ks = grid_mod.crs_k(cell.cell_id, cell.n_prb, 0, cell.cp)
    syms = grid_mod.pilot_syms(0, cell.cp)
    npil = 2 * cell.n_prb
    fidx = np.zeros((len(syms), cell.nre, 2), np.int32)
    fw = np.zeros((len(syms), cell.nre, 2), np.float32)
    for i in range(len(syms)):
        f0 = int(ks[i][0])
        pk = f0 + 6 * np.arange(npil)
        for k in range(cell.nre):
            j = np.clip((k - f0) / 6.0, 0, npil - 1)
            j0 = int(np.clip(np.floor(j), 0, npil - 2))
            t = (k - pk[j0]) / 6.0
            fidx[i, k] = (j0, j0 + 1)
            fw[i, k] = (1.0 - t, t)
    tmat = chest._time_interp_matrix(tuple(syms), cell.n_sym)
    pidx = (np.asarray(syms)[:, None] * cell.nre + ks).astype(np.int32)
    return fidx, fw, tmat.astype(np.float32), pidx


def _dl_window_taps(cfg: DynBlockConfig, base_idx: np.ndarray):
    """Static within-window chest taps for the PDSCH REs.

    The per-TTI rb_start only shifts which pilots matter: with the pilot
    axis padded by one replicated pilot on each side, the window
    h_pad[2*rb : 2*rb + W] (W = 2*w + 2) covers every tap of every RE of
    the allocation, and the within-window tap index of RE column kappa =
    k - 12*rb is static: jl = floor((kappa - f0_s)/6) + 1 (edge half-PRBs
    get constant instead of linear extrapolation from the pad pilot)."""
    cell = cfg.cell
    ks = grid_mod.crs_k(cell.cell_id, cell.n_prb, 0, cell.cp)
    syms = grid_mod.pilot_syms(0, cell.cp)
    tmat = chest._time_interp_matrix(tuple(syms), cell.n_sym)
    K = 12 * cfg.dl_l_crbs
    W = 2 * cfg.dl_l_crbs + 2
    S_pil = len(syms)
    re_col = (base_idx % cell.nre).astype(np.int64)
    re_sym = (base_idx // cell.nre).astype(np.int64)
    assert re_col.max() < K
    tap_idx = np.zeros((S_pil, len(base_idx), 2), np.int32)
    tap_w = np.zeros((S_pil, len(base_idx), 2), np.float32)
    for i in range(S_pil):
        f0 = int(ks[i][0])
        jl = np.floor((re_col - f0) / 6.0).astype(np.int64)
        t = (re_col - f0 - 6.0 * jl) / 6.0
        tap_idx[i, :, 0] = jl + 1  # +1: padded pilot axis
        tap_idx[i, :, 1] = jl + 2
        tap_w[i, :, 0] = 1.0 - t
        tap_w[i, :, 1] = t
    assert tap_idx.min() >= 0 and tap_idx.max() < W
    return tap_idx, tap_w, tmat[re_sym].astype(np.float32), W


def _cand_taps(cfg: DynBlockConfig, cand_re: np.ndarray):
    """Static flattened chest taps for the PDCCH candidate REs (positions
    known per (sf, ue, candidate)): 2*S_pil taps per RE into the flattened
    (S_pil*P) LS-pilot axis, with the time-interp weight folded in."""
    cell = cfg.cell
    ks = grid_mod.crs_k(cell.cell_id, cell.n_prb, 0, cell.cp)
    syms = grid_mod.pilot_syms(0, cell.cp)
    tmat = chest._time_interp_matrix(tuple(syms), cell.n_sym)
    S_pil = len(syms)
    P = 2 * cell.n_prb
    sh = cand_re.shape  # (10, n, npos)
    k = cand_re % cell.nre
    sym = cand_re // cell.nre
    idx = np.zeros(sh + (2 * S_pil,), np.int32)
    w = np.zeros(sh + (2 * S_pil,), np.float32)
    for i in range(S_pil):
        f0 = int(ks[i][0])
        j0 = np.clip(np.floor((k - f0) / 6.0), 0, P - 2).astype(np.int64)
        t = (k - (f0 + 6.0 * j0)) / 6.0
        tw = tmat[sym, i]
        idx[..., 2 * i] = i * P + j0
        idx[..., 2 * i + 1] = i * P + j0 + 1
        w[..., 2 * i] = tw * (1.0 - t)
        w[..., 2 * i + 1] = tw * t
    return idx, w


def _dl_base_idx(cfg: DynBlockConfig) -> np.ndarray:
    """(n_re,) PDSCH RE indices for a width-w alloc at rb_start=0, checked
    subframe-invariant and shift-covariant (idx(rb) = idx(0) + 12*rb): the
    within-PRB CRS pattern repeats every PRB and the centre 6 PRBs are
    outside the schedulable region."""
    cell, w = cfg.cell, cfg.dl_l_crbs
    base = np.asarray(grid_mod.pdsch_re_indices(
        cell, 1, ra.type2_to_prb_mask(0, w, cell.n_prb)), np.int64)
    c0, c1 = waveblock.centre_prbs(cell.n_prb)
    for sf in (0, 1, 5):
        for rb in (0, max(0, c0 - w), c1, cell.n_prb - w):
            if c0 - w < rb < c1 or rb < 0:
                continue
            chk = grid_mod.pdsch_re_indices(cell, sf, ra.type2_to_prb_mask(rb, w, cell.n_prb))
            assert np.array_equal(np.asarray(chk, np.int64), base + 12 * rb), (
                sf, rb, "PDSCH RE table is not shift-covariant")
    return base.astype(np.int32)


def _pucch_region(cell: grid_mod.CellConfig) -> int:
    """Outer PRBs consumed by the dynamic-ACK region [0, nCCE)."""
    m = 0
    for res in range(pdcch_mod.n_cce(cell)):
        for ns in (0, 1):
            p = pucch_mod.pucch_prb(res, ns, cell.n_prb)
            m = max(m, min(p, cell.n_prb - 1 - p) + 1)
    return m


def _consts(cfg: DynBlockConfig) -> dict:
    """Every table of the block, as numpy arrays."""
    cell = cfg.cell
    n = cfg.n_ues
    cce_dl, cce_ul, cand = _alloc_cces(cfg)
    fidx, fw, tmat, pidx = _chest_taps(cell)
    ncce = pdcch_mod.n_cce(cell)
    c_all10 = np.stack([
        sequence.gold_sequence_host(scrambling.pdcch_cinit(sf, cell.cell_id), 72 * ncce)
        for sf in range(10)]).astype(np.int8)
    cce_re = pdcch_mod.cce_re_indices(cell)  # (ncce, 36)
    l = cfg.l_aggr
    cand_re = np.zeros((10, n, cand.shape[2], 36 * l), np.int32)
    for sf in range(10):
        for u in range(n):
            for ci in range(cand.shape[2]):
                s = cand[sf, u, ci]
                cand_re[sf, u, ci] = cce_re[s : s + l].reshape(-1)
    # PUCCH format-1 tables for the whole dynamic ACK region [0, ncce)
    p_pos = np.zeros((ncce, 2, 7, 12), np.int32)
    p_vals = np.zeros((10, ncce, 2, 7, 12), np.complex64)
    for res in range(ncce):
        for sf in range(10):
            p_vals[sf, res] = pucch_mod._f1_waveform(cell.cell_id, sf, res)
        for s in range(2):
            prb = pucch_mod.pucch_prb(res, s, cell.n_prb)
            ks = 12 * prb + np.arange(12)
            for li in range(7):
                p_pos[res, s, li] = (7 * s + li) * cell.nre + ks
    dmask = np.zeros(7, np.float32)
    for li in pucch_mod.F1_DATA_SYMS:
        dmask[li] = 1.0
    ngrp = phich_mod.n_groups(cell.n_prb)
    ph_re = phich_mod.re_indices(cell)[:ngrp]  # (G, 12)
    ph_sm = np.stack([phich_mod._spread_matrix(cell.cell_id, sf) for sf in range(10)])
    ul_data0, ul_dmrs0 = pusch_mod.re_indices(cell.n_prb, 0, cfg.ul_l_prb)
    base10 = waveblock._base_grids(types.SimpleNamespace(cell=cell, tm3=False), 0)
    base_idx = _dl_base_idx(cfg)
    dl_tap_idx, dl_tap_w, dl_tw, dl_W = _dl_window_taps(cfg, base_idx)
    # window-relative static RE tables: every per-(t, u) RX gather over the
    # full grid becomes one contiguous frequency window + a static take.
    # Shift covariance (asserted above for DL; DMRS and data occupy whole
    # PRBs for UL) makes the within-window pattern rb-independent.
    wd_sc = 12 * cfg.dl_l_crbs
    assert (base_idx % cell.nre < wd_sc).all()
    dl_win_idx = (base_idx // cell.nre) * wd_sc + base_idx % cell.nre
    wu_sc = 12 * cfg.ul_l_prb
    assert (ul_data0 % cell.nre < wu_sc).all()
    assert (ul_dmrs0 % cell.nre < wu_sc).all()
    ul_d_win = ((ul_data0 // cell.nre) * wu_sc + ul_data0 % cell.nre).reshape(-1)
    ul_m_win = ((ul_dmrs0 // cell.nre) * wu_sc + ul_dmrs0 % cell.nre).reshape(-1)
    ct_idx, ct_w = _cand_taps(cfg, cand_re.reshape(10, n, -1))
    cf = waveblock._cf
    return dict(
        rntis=np.asarray(cfg.rntis, np.int64),
        amp=10.0 ** (-np.asarray(cfg.snr_db, np.float32) / 20.0),
        base10=base10,
        base_idx=base_idx,
        dl_tap_idx=dl_tap_idx, dl_tap_w=dl_tap_w, dl_tw=dl_tw,
        dl_W=np.int32(dl_W),
        ct_idx=ct_idx, ct_w=ct_w,
        dl_win_idx=dl_win_idx.astype(np.int32),
        ul_d_win=ul_d_win.astype(np.int32),
        ul_m_win=ul_m_win.astype(np.int32),
        cce_dl=cce_dl, cce_ul=cce_ul, cand=cand, cand_re=cand_re, cce_re=cce_re,
        c_all10=c_all10,
        fidx=fidx, fw=fw, tmat=tmat, pidx=pidx,
        ch_vals10=cf(chest._crs_values10(cell.cell_id, cell.n_prb, 0, cell.cp)),
        p_pos=p_pos, p_vals=cf(p_vals), p_dmask=dmask,
        ph_re=ph_re.astype(np.int32), ph_sm=ph_sm,
        ul_data0=ul_data0.astype(np.int32),
        ul_dmrs0=ul_dmrs0.astype(np.int32),
        ul_dmrs10=cf(pusch_mod._dmrs10(cell.cell_id, cfg.ul_l_prb)),
    )


def make_schedule(cfg: DynBlockConfig, seed: int = 0):
    """(rb_dl (R, 8, n), rb_ul (R, 8, n)) int32: per-TTI hopped, per-TTI
    disjoint contiguous allocations (the get_dl_sched/get_ul_sched choice,
    precomputed for the block)."""
    cell, n = cfg.cell, cfg.n_ues
    rng = np.random.default_rng(seed)
    c0, c1 = waveblock.centre_prbs(cell.n_prb)
    w = cfg.dl_l_crbs
    # width-aligned slots inside the two centre-avoiding segments: a random
    # subset of these per TTI is disjoint by construction
    slots = []
    for lo_s, hi_s in ((0, c0), (c1, cell.n_prb)):
        slots += [lo_s + i * w for i in range((hi_s - lo_s) // w)]
    assert len(slots) >= n, f"{n} UEs x {w} PRB do not fit the centre-avoiding segments"
    rb_dl = np.zeros((cfg.R, N_PID, n), np.int32)
    for r in range(cfg.R):
        for t in range(N_PID):
            rb_dl[r, t] = rng.choice(slots, size=n, replace=False)
    lo = _pucch_region(cell)
    wu = cfg.ul_l_prb
    hi = cell.n_prb - lo
    assert lo + n * wu <= hi, "UL allocations do not fit above PUCCH region"
    rb_ul = np.zeros((cfg.R, N_PID, n), np.int32)
    for r in range(cfg.R):
        for t in range(N_PID):
            off = int(rng.integers(0, hi - lo - n * wu + 1))
            for j, u in enumerate(rng.permutation(n)):
                rb_ul[r, t, u] = lo + off + j * wu
    return rb_dl, rb_ul


# ---------------------------------------------------------------------------
# helpers on tensors
# ---------------------------------------------------------------------------

def _bits_of(v: torch.Tensor, width: int) -> torch.Tensor:
    """int (...,) -> (..., width) MSB-first bits."""
    sh = torch.arange(width - 1, -1, -1, device=v.device)
    return ((v.long()[..., None] >> sh) & 1).to(torch.int8)


def _int_of(bits: torch.Tensor) -> torch.Tensor:
    """(..., width) bits -> int (...,)."""
    sh = torch.arange(bits.shape[-1] - 1, -1, -1, device=bits.device)
    return (bits.long() << sh).sum(-1)


def _riv(rb: torch.Tensor, w: int, n_prb: int) -> torch.Tensor:
    if w - 1 <= n_prb // 2:
        return n_prb * (w - 1) + rb
    return n_prb * (n_prb - w + 1) + (n_prb - 1 - rb)


def _unriv(riv: torch.Tensor, w: int, n_prb: int) -> torch.Tensor:
    if w - 1 <= n_prb // 2:
        rb = riv - n_prb * (w - 1)
    else:
        rb = n_prb - 1 - (riv - n_prb * (n_prb - w + 1))
    return rb.clamp(0, n_prb - w)


def _pack_dci1a(cfg: DynBlockConfig, rb, pid, ndi, rv) -> torch.Tensor:
    """DCI format-1A bits (dci.pack_dl layout) from int tensors."""
    n_prb = cfg.cell.n_prb
    nlen = dci_mod.format0_1a_len(n_prb)
    rl = dci_mod.riv_len(n_prb)
    z = lambda k: torch.zeros(rb.shape + (k,), dtype=torch.int8, device=rb.device)
    out = torch.cat([
        z(1) + 1,  # flag = 1A
        z(1),  # localized
        _bits_of(_riv(rb, cfg.dl_l_crbs, n_prb), rl),
        _bits_of(torch.full_like(rb, cfg.dl_mcs), 5),
        _bits_of(pid, 3),
        _bits_of(ndi, 1),
        _bits_of(rv, 2),
        z(2),  # tpc
    ], dim=-1)
    return torch.cat([out, z(nlen - out.shape[-1])], dim=-1)


def _pack_dci0(cfg: DynBlockConfig, rb, ndi) -> torch.Tensor:
    """DCI format-0 bits (dci.pack_ul layout) from int tensors."""
    n_prb = cfg.cell.n_prb
    nlen = dci_mod.format0_1a_len(n_prb)
    rl = dci_mod.riv_len(n_prb)
    z = lambda k: torch.zeros(rb.shape + (k,), dtype=torch.int8, device=rb.device)
    out = torch.cat([
        z(2),  # flag = 0, hopping = 0
        _bits_of(_riv(rb, cfg.ul_l_prb, n_prb), rl),
        _bits_of(torch.full_like(rb, cfg.ul_mcs), 5),
        _bits_of(ndi, 1),
        z(6),  # tpc(2) + dmrs(3) + cqi(1)
    ], dim=-1)
    return torch.cat([out, z(nlen - out.shape[-1])], dim=-1)


def _scatter_rows(grids_flat, idx, vals, add=False):
    """Per-row scatter: grids_flat (T8, S, 2), idx (T8, N), vals (T8, N, 2),
    into a copy.  Out-of-range indices are dropped (they land in a spare
    column that is cut off), as the reference's mode="drop"."""
    T8, S = grids_flat.shape[:2]
    g = torch.cat([grids_flat, grids_flat.new_zeros((T8, 1, 2))], dim=1)
    idx = torch.where((idx >= 0) & (idx < S), idx.long(), S)
    rows = torch.arange(T8, device=idx.device)[:, None].expand_as(idx)
    g.index_put_((rows, idx), vals, accumulate=add)
    return g[:, :S]


def _clamped(i: torch.Tensor, n: int) -> torch.Tensor:
    """An index as JAX's x[i] reads it: negative wraps once, then clamped
    into [0, n)."""
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def _take_rows(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[t, u, ...] = tbl[t, idx[t, u]] for tbl (T8, Q, ...)."""
    rows = torch.arange(tbl.shape[0], device=idx.device)[:, None]
    return tbl[rows, _clamped(idx.long(), tbl.shape[1])]


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

def make_dyn_block_step(cfg: DynBlockConfig, device="cuda", n_cells: int = 1,
                        jit: bool = True):
    """Build the R-round dynamic block on `device` (the card by default;
    raises where there is none).

    Returns fn(dl_q (Qd, n, dl_tbs) i8, ul_q (Qu, n, ul_tbs) i8,
               rb_dl (R, 8, n), rb_ul (R, 8, n) int,
               gen torch.Generator on the device, tti0 int [multiple of 8])
      -> dict of per-round stacked outputs:
         dl_ok/dl_new/dl_found/ack_det/ul_ok/ul_new/ul_tx (R, 8, n) bool,
         dl_out (R, 8, n, dl_tbs) i8, ul_out (R, 8, n, ul_tbs) i8,
         rb_ue/rv_dl (R, 8, n) int, scalar counters (dl_retx_tx, dl_drop,
         ul_retx_tx, ul_drop, dci_dl_miss, dci_ul_miss) and
         dl_consumed/ul_consumed (n,).
    n_cells > 1 runs that many independent cells in one block (the
    reference's vmap of the block): the queues and schedules take a leading
    cells axis, `gen` is a sequence of one generator per cell, tti0 is
    shared, and every output gains a leading cells axis.  The cells ride
    the TTI-row axis of every tensor (C x 8 rows), so a block of C cells
    launches the kernels of one; they share nothing else: each row's grid,
    PUCCH and UL superposition hold its own cell's UEs only, and each cell
    draws its noise from its own generator as a block of one would.
    Array arguments may be numpy arrays or tensors; they are moved to the
    device.

    jit (the reference's jit=): on the card, the first call for a set of
    queue shapes warms one round, captures it as a CUDA graph with one
    graph-safe generator per cell, and every call then copies its inputs
    in, resets the carry, replays the round R times from the state of
    `gen` (which it advances as the eager block would) and returns fresh
    tensors, with no host sync from the first replay to the return; the
    outputs equal the eager block's bit for bit.  A capture or replay that
    fails raises.  jit=False runs the rounds as a Python loop of the same
    body (the plain version, for stage timers and recorded noise); off the
    card jit changes nothing.
    """
    dev = resolve(device, "make_dyn_block_step")
    c = waveblock._on(_consts(cfg), dev)
    c = {k: (v.long() if v.dtype == torch.int32 else v) for k, v in c.items()}
    cell = cfg.cell
    n, R, l = cfg.n_ues, cfg.R, cfg.l_aggr
    qm_d = ra.dl_mcs_to_qm(cfg.dl_mcs)
    qm_u = ra.ul_mcs_to_qm(cfg.ul_mcs)
    n_re_d = c["base_idx"].shape[0]
    cfg_d = sch.SchConfig(tbs=cfg.dl_tbs, G=n_re_d * qm_d, Qm=qm_d, Nl=1)
    m_sc = 12 * cfg.ul_l_prb
    cfg_u = sch.SchConfig(tbs=cfg.ul_tbs, G=m_sc * 12 * qm_u, Qm=qm_u, Nl=1)
    S = grid_mod.N_SYM * cell.nre
    C = n_cells
    T8 = C * N_PID  # TTI rows: cell-major, 8 HARQ processes per cell
    B = T8 * n
    dci_len = dci_mod.format0_1a_len(cell.n_prb)
    rl = dci_mod.riv_len(cell.n_prb)
    ngrp = c["ph_re"].shape[0]
    rntis, amp = c["rntis"], c["amp"]
    S_pil, P = c["pidx"].shape
    n_cand = c["cand"].shape[2]
    rvseq = torch.from_numpy(RV_SEQ).long().to(dev)
    uidx = torch.arange(n, device=dev)
    rows8 = torch.arange(T8, device=dev)[:, None]
    cells = torch.arange(C, device=dev)[:, None, None]
    syms14 = torch.arange(grid_mod.N_SYM, device=dev)
    steps = N_PID * torch.arange(R, device=dev)  # the rounds' first TTIs after tti0
    sdt = torch.bfloat16 if cfg.llr_bits <= 16 else torch.float32
    decode = dict(use_kernel=cfg.use_kernel, llr_bits=cfg.llr_bits)

    def randn(gens, shape):
        """(T8, ...) noise: each cell's (8, ...) rows from its own generator,
        in the order a one-cell block draws them."""
        tail = tuple(shape)
        if C == 1:
            return waveblock._randn(gens[0], (N_PID,) + tail, dev)
        return torch.cat([waveblock._randn(g, (N_PID,) + tail, dev) for g in gens])

    def per_cell(x):
        """(T8, n) -> (C, 8, n)."""
        return x.reshape(C, N_PID, n)

    def from_queue(q, ptr, take):
        """Each (cell, process, UE)'s next queue entry: the cells' queues q
        (C, Q, n, tbs) read from ptr (C, n) on, one entry per process that
        takes one ((T8, n) mask), as the reference's cumsum over the 8
        processes; returns the (T8, n, tbs) entries and the new pointers."""
        tk = per_cell(take.long())
        idx = ptr[:, None, :] + torch.cumsum(tk, 1) - tk
        fresh = q[cells, _clamped(idx, q.shape[1]), uidx[None, None, :]]
        return fresh.reshape(T8, n, -1), ptr + tk.sum(1)
    W = int(c["dl_W"])

    def _win_cols(rb, w_sc):
        """(T8, n, w_sc) subcarriers of the window at 12*rb[t, u], its start
        clamped into the band as lax.dynamic_slice clamps it (garbage rb
        from undecoded DCIs; those rows are masked off downstream)."""
        start = (12 * rb).clamp(0, cell.nre - w_sc)
        return start[..., None] + torch.arange(w_sc, device=dev)

    def _win_slice(rg, rb, w_sc):
        """(T8, S, 2) grid -> (T8, n, N_SYM*w_sc, 2) contiguous frequency
        windows; pair with a static window-relative take."""
        T8 = rg.shape[0]
        g14 = rg.reshape(T8, grid_mod.N_SYM, cell.nre, 2)
        cols = _win_cols(rb, w_sc)
        win = g14[rows8[:, :, None, None], syms14[:, None], cols[:, :, None, :]]
        return win.reshape(T8, rb.shape[1], grid_mod.N_SYM * w_sc, 2)

    def _win_add(flat_g, rb, wcont, w_sc):
        """Add per-(t, u) (N_SYM*w_sc, 2) window contents into the (T8, S, 2)
        grid at 12*rb[t, u], the TX inverse of _win_slice.  UE by UE, as the
        reference adds them: the scheduled allocations of a TTI are
        disjoint, but a UL retransmission keeps its previous RBs, which may
        be another UE's new grant; one add per UE keeps the reference's sum
        order there and no two writes of one add meet."""
        T8 = flat_g.shape[0]
        cols = _win_cols(rb, w_sc)
        pos = (rows8[:, :, None, None] * S + syms14[:, None] * cell.nre
               + cols[:, :, None, :])  # (T8, n, N_SYM, w_sc)
        w4 = wcont.reshape(T8, rb.shape[1], -1, 2)
        out = flat_g.reshape(T8 * S, 2).clone()
        for u in range(rb.shape[1]):
            out.index_add_(0, pos[:, u].reshape(-1), w4[:, u].reshape(-1, 2))
        return out.reshape(T8, S, 2)

    def _chest_at(h_ls, k, sym):
        """CE at REs chosen per row: h_ls (T8, n, S_pil, P, 2); k/sym
        (T8, n, Np).  Returns (T8, n, Np, 2)."""
        gi = c["fidx"][:, k].movedim(0, 3)  # (T8, n, Np, S_pil, 2)
        gw = c["fw"][:, k].movedim(0, 3)
        sp = torch.arange(S_pil, device=dev)
        h = h_ls[rows8[:, :, None, None, None], uidx[None, :, None, None, None],
                 sp[:, None], gi]  # (T8, n, Np, S_pil, 2, 2)
        h_f = (h * gw[..., None]).sum(-2)  # (T8, n, Np, S_pil, 2)
        sw = c["tmat"][sym]  # (T8, n, Np, S_pil)
        return (h_f * sw[..., None]).sum(-2)

    def _pdcch_tx(dci_bits, cce, sfs):
        """(T8, n, dci_len) bits at per-row CCEs -> (idx, syms) scatter."""
        T8 = dci_bits.shape[0]
        w = crc_mod.crc_attach(dci_bits.reshape(T8 * n, -1), crc_mod.LTE_CRC16)
        mask = pdcch_mod.rnti_mask_bits(rntis[None].expand(T8, n))
        masked = torch.cat([w[:, :dci_len], w[:, dci_len:] ^ mask.reshape(T8 * n, 16)], dim=1)
        e = pdcch_mod.CCE_BITS * l
        bits = convcoder.rate_match_cc(convcoder.conv_encode(masked), e)
        coff = (cce * pdcch_mod.CCE_BITS)[..., None] + torch.arange(e, device=dev)
        call = c["c_all10"][sfs]  # (T8, L)
        cseq = call[rows8[:, :, None], coff]  # (T8, n, e)
        scr = (bits.reshape(T8, n, e) ^ cseq).to(torch.int8)
        syms = modem.modulate(scr.reshape(T8 * n, e), modem.QPSK)
        rows = c["cce_re"][cce[..., None] + torch.arange(l, device=dev)]  # (T8, n, l, 36)
        return rows.reshape(T8, n * l * 36), syms.reshape(T8, n * l * 36, 2)

    def round_body(b, gen):
        """One HARQ round of 8 TTIs in each cell, the reference's scan body,
        on the block's tensors `b` (`new_block`): its xs are the entries of
        the schedules and TTIs at the round index b["r"] (a tensor), its
        carry b["st"] is written back in place, its (T8, n) outputs go into
        b's (R, T8, n, ...) tensors at the round index, which then steps."""
        r, dl_q, ul_q = b["r"], b["dl_q"], b["ul_q"]
        st = dict(b["st"])  # this round's carry: entries are rebound, then copied back
        rb_dl_r, rb_ul_r = (b[k].index_select(0, r)[0] for k in ("rb_dl", "rb_ul"))
        tti_r = b["ttis"].index_select(0, r)  # (1,)
        sfs = ((tti_r + torch.arange(N_PID, device=dev)) % 10).repeat(C)
        pid = torch.arange(N_PID, device=dev).repeat(C)[:, None].expand(T8, n)

        # ------------- eNB scheduling decisions -------------
        new_dl = ~st["dl_pend"]
        fresh, st["dl_ptr"] = from_queue(dl_q, st["dl_ptr"], new_dl)
        st["dl_tb"] = torch.where(new_dl[..., None], fresh, st["dl_tb"])
        st["dl_ndi"] = st["dl_ndi"] ^ new_dl
        rv_dl = torch.where(new_dl, 0, rvseq[st["dl_retx"].clamp(max=3)])

        new_ul = ~st["enb_pend"]
        st["enb_ndi_ul"] = st["enb_ndi_ul"] ^ new_ul
        rv_ul_enb = torch.where(new_ul, 0, rvseq[st["enb_retx"].clamp(max=3)])
        rb_enb = torch.where(new_ul, rb_ul_r, st["enb_rb_prev"])

        # ------------- eNB DL encode -------------
        cce_d = c["cce_dl"][sfs]
        cce_u = c["cce_ul"][sfs]
        d1a = _pack_dci1a(cfg, rb_dl_r, pid, st["dl_ndi"].long(), rv_dl)
        d0b = _pack_dci0(cfg, rb_ul_r, st["enb_ndi_ul"].long())
        i1, s1 = _pdcch_tx(d1a, cce_d, sfs)
        i0, s0 = _pdcch_tx(d0b, cce_u, sfs)

        cinit_d = ((rntis[None, :] << 14) + (sfs[:, None] << 9) + cell.cell_id).reshape(-1)
        cw = sch.encode_tb(st["dl_tb"].reshape(B, cfg.dl_tbs), cfg_d, rv_b=rv_dl.reshape(B))
        syms_d = modem.modulate(scrambling.scramble_bits(cw, cinit_d), modem.MOD_FROM_QM[qm_d])
        flat = c["base10"][sfs].reshape(T8, S, 2)
        flat = _scatter_rows(flat, i1, s1)
        flat = _scatter_rows(flat, i0, s0)
        # PDSCH onto the grid as per-(t, u) windows (data REs are zero in
        # the base grid, so add == set)
        wd_sc = 12 * cfg.dl_l_crbs
        wc = torch.zeros((T8, n, grid_mod.N_SYM * wd_sc, 2), device=dev)
        wc[:, :, c["dl_win_idx"]] = syms_d.reshape(T8, n, n_re_d, 2)
        flat = _win_add(flat, rb_dl_r, wc, wd_sc)
        # PHICH: previous round's UL CRCs at (group, seq) from the previous
        # round's PRBs + n_dmrs = u (36.213 §9.1.2)
        g_ph = (st["enb_rb_prev"] + uidx[None]) % ngrp
        s_ph = (st["enb_rb_prev"] // ngrp + uidx[None]) % (2 * phich_mod.NSF)
        ph = torch.zeros((T8, ngrp, 8), device=dev)
        val = torch.where(st["phich_tx"], 1.0, -1.0)
        ph.index_put_((rows8.expand(T8, n), g_ph, s_ph), val, accumulate=True)
        sm = c["ph_sm"][sfs]
        phs = torch.einsum("tgs,tsic->tgic", ph, sm)
        flat = _scatter_rows(flat, c["ph_re"].reshape(1, -1).expand(T8, ngrp * 12),
                             phs.reshape(T8, -1, 2))
        tx = ofdm.modulate(flat.reshape(T8, grid_mod.N_SYM, cell.nre, 2), cell.n_prb)

        # ------------- DL channel + UE receive (RE-sparse) -------
        rg_tx = ofdm.demodulate(tx, cell.n_prb).reshape(T8, S, 2)
        a2 = amp / np.sqrt(2)
        p_tx = rg_tx[:, c["pidx"].reshape(-1)]
        y_p = (p_tx.reshape(T8, 1, S_pil, P, 2)
               + a2[None, :, None, None, None] * randn(gen, (n, S_pil, P, 2)))
        r_p = c["ch_vals10"][sfs]
        h_ls = cplx.mul_conj(y_p, r_p[:, None])

        # PDCCH blind decode over the candidate set; chest via the static
        # flattened tap tables (_cand_taps)
        cre = c["cand_re"][sfs]
        npos = n_cand * 36 * l
        y_c = (rg_tx[rows8, cre.reshape(T8, -1)].reshape(T8, n, npos, 2)
               + a2[None, :, None, None] * randn(gen, (n, npos, 2)))
        cti = c["ct_idx"][sfs]
        ctw = c["ct_w"][sfs]
        hflat = h_ls.reshape(T8, n, S_pil * P, 2)
        g_c = hflat[rows8[:, :, None], uidx[None, :, None], cti.reshape(T8, n, -1)]
        h_c = (g_c.reshape(T8, n, npos, -1, 2) * ctw[..., None]).sum(-2)
        x_eq, csi = chest.equalize_zf(y_c, h_c)
        llr_c = modem.demod_soft(x_eq.reshape(-1, npos, 2), modem.QPSK)
        llr_c = (llr_c.reshape(T8, n, npos * 2)
                 * torch.repeat_interleave(csi.reshape(T8, n, npos), 2, dim=-1))
        cnd = c["cand"][sfs]
        e = 72 * l
        coff = (cnd * 72)[..., None] + torch.arange(e, device=dev)
        call = c["c_all10"][sfs]
        cseq = call[rows8[:, :, None, None], coff]  # (8, n, n_cand, e)
        sgn = 1.0 - 2.0 * cseq.float()
        llr_c = llr_c.reshape(T8, n, n_cand, e) * sgn
        streams = convcoder.rate_unmatch_cc(llr_c.reshape(-1, e), dci_len + 16)
        bits_c = viterbi.viterbi_decode(streams)
        calc = crc_mod.crc_bits(bits_c[:, :dci_len], crc_mod.LTE_CRC16)
        resid = (calc ^ bits_c[:, dci_len:]).long()
        w16 = 1 << torch.arange(15, -1, -1, device=dev)
        resid = (resid * w16).sum(-1).reshape(T8, n, n_cand)
        ok_c = resid == rntis[None, :, None]
        bits_c = bits_c[:, :dci_len].reshape(T8, n, n_cand, dci_len)

        def pick(hit):
            # first passing candidate: argmax over an int copy (bool argmax
            # is not supported on every backend); torch.argmax returns the
            # first maximum, as jnp.argmax does
            i = torch.argmax(hit.to(torch.int32), dim=-1)
            b = bits_c.gather(2, i[..., None, None].expand(T8, n, 1, dci_len))[:, :, 0]
            cpos = cnd.gather(2, i[..., None])[..., 0]
            return hit.any(-1), b, cpos

        dl_found, dl_bits, dl_cce_ue = pick(ok_c & (bits_c[..., 0] == 1))
        ul_found, ul_bits, _ = pick(ok_c & (bits_c[..., 0] == 0))

        rb_ue = _unriv(_int_of(dl_bits[..., 2 : 2 + rl]), cfg.dl_l_crbs, cell.n_prb)
        off = 2 + rl + 5
        ndi_d = dl_bits[..., off + 3].long()
        rv_d_ue = _int_of(dl_bits[..., off + 4 : off + 6])
        rb_u_ue = _unriv(_int_of(ul_bits[..., 2 : 2 + rl]), cfg.ul_l_prb, cell.n_prb)
        ndi_u = ul_bits[..., 2 + rl + 5].long()

        # UE PHICH decode from the waveform (previous round's feedback)
        php = c["ph_re"][(st["ue_rb_prev"] + uidx[None]) % ngrp]  # (8, n, 12)
        y_ph = (rg_tx[rows8, php.reshape(T8, -1)].reshape(T8, n, 12, 2)
                + a2[None, :, None, None] * randn(gen, (n, 12, 2)))
        h_ph = _chest_at(h_ls, php % cell.nre, php // cell.nre)
        x_ph, csi_ph = chest.equalize_zf(y_ph, h_ph)
        x_ph = x_ph * csi_ph[..., None]
        smt = c["ph_sm"][sfs]  # (8, 8, 12, 2)
        s_ue = (st["ue_rb_prev"] // ngrp + uidx[None]) % (2 * phich_mod.NSF)
        w_ph = _take_rows(smt, s_ue)  # (8, n, 12, 2)
        phich_ack_ue = (x_ph[..., 0] * w_ph[..., 0] + x_ph[..., 1] * w_ph[..., 1]).sum(-1) > 0

        # UE PDSCH decode at the DECODED allocation (soft combining); chest
        # via the padded-pilot window (_dl_window_taps)
        dwin = _win_slice(rg_tx, rb_ue, 12 * cfg.dl_l_crbs)
        y_d = (dwin[:, :, c["dl_win_idx"]]
               + a2[None, :, None, None] * randn(gen, (n, n_re_d, 2)))
        h_pad = torch.cat([h_ls[..., :1, :], h_ls, h_ls[..., -1:, :]], dim=-2)
        widx = (2 * rb_ue)[..., None] + torch.arange(W, device=dev)  # (8, n, W)
        win = h_pad.gather(3, widx[:, :, None, :, None].expand(T8, n, S_pil, W, 2))
        h_f = torch.stack([
            (win[:, :, i][:, :, c["dl_tap_idx"][i]] * c["dl_tap_w"][i][:, :, None]).sum(-2)
            for i in range(S_pil)], dim=2)  # (8, n, S_pil, n_re, 2)
        h_d = torch.einsum("rs,tusrc->turc", c["dl_tw"], h_f)
        x_eq, csi = chest.equalize_zf(y_d, h_d)
        llr = modem.demod_soft(x_eq.reshape(B, n_re_d, 2), modem.MOD_FROM_QM[qm_d])
        llr = llr * torch.repeat_interleave(csi.reshape(B, n_re_d), qm_d, dim=-1)
        llr = scrambling.scramble_llrs(llr, cinit_d)
        is_new_ue = dl_found & (ndi_d != st["ue_ndi"])
        st["ue_ndi"] = torch.where(dl_found, ndi_d, st["ue_ndi"])
        keep = ((~is_new_ue).reshape(B, 1) if cfg.combine
                else torch.zeros((B, 1), dtype=torch.bool, device=dev))
        ue_soft = [sb * keep for sb in st["ue_soft"]]
        llr = llr * dl_found.reshape(B, 1)  # a missed DCI adds nothing
        dl_out, dl_ok, st["ue_soft"], _ = sch.decode_tb(
            llr, cfg_d, softbuf=ue_soft, rv_b=rv_d_ue.reshape(B), read=False, **decode)
        dl_ok = dl_ok.reshape(T8, n) & dl_found

        # ------------- UE transmit -------------
        is_new_ul = ul_found & (ndi_u != st["ue_ndi_ul"])
        st["ue_ndi_ul"] = torch.where(ul_found, ndi_u, st["ue_ndi_ul"])
        retx_now = (st["ue_pend"] & (~phich_ack_ue) & (~is_new_ul)
                    & (st["ue_retx"] < cfg.max_tx))
        fresh_u, st["ul_ptr"] = from_queue(ul_q, st["ul_ptr"], is_new_ul)
        st["ul_tb_ue"] = torch.where(is_new_ul[..., None], fresh_u, st["ul_tb_ue"])
        tx_ul = is_new_ul | retx_now
        rv_ue = torch.where(is_new_ul, 0, rvseq[st["ue_retx"].clamp(max=3)])
        st["ue_retx"] = torch.where(is_new_ul, 1,
                                    torch.where(retx_now, st["ue_retx"] + 1, st["ue_retx"]))
        rb_ul_ue = torch.where(is_new_ul, rb_u_ue, st["ue_rb_prev"])
        st["ue_rb_prev"] = torch.where(tx_ul, rb_ul_ue, st["ue_rb_prev"])
        st["ue_pend"] = tx_ul  # awaiting feedback iff we just transmitted

        cinit_u = cinit_d
        cw_u = sch.encode_tb(st["ul_tb_ue"].reshape(B, cfg.ul_tbs), cfg_u,
                             rv_b=rv_ue.reshape(B))
        scr_u = scrambling.scramble_bits(pusch_mod.interleave(cw_u, qm_u), cinit_u)
        s_u = modem.modulate(scr_u, modem.MOD_FROM_QM[qm_u])
        x_u = dft.dft(s_u.reshape(B, 12, m_sc, 2))
        # per-UE arrival gain: the link-budget difference rides the UE's
        # signal into the shared eNB noise floor (min-amp link)
        gain = amp.min() / amp  # (n,)
        gtx = tx_ul * gain[None]  # 0 = DTX without a grant
        x_u = x_u * gtx.reshape(B, 1, 1, 1)
        ug = torch.zeros((T8, S, 2), device=dev)
        # data + DMRS as one per-(t, u) window add; a DTX UE's gain gate
        # zeroes its window, so its stale rb adds nothing
        dv = c["ul_dmrs10"][sfs]
        dvb = dv[:, None] * gtx[..., None, None, None]
        uwc = torch.zeros((T8, n, grid_mod.N_SYM * m_sc, 2), device=dev)
        uwc[:, :, c["ul_d_win"]] = x_u.reshape(T8, n, -1, 2)
        uwc[:, :, c["ul_m_win"]] = dvb.reshape(T8, n, -1, 2)
        ug = _win_add(ug, rb_ul_ue, uwc, m_sc)
        # PUCCH HARQ-ACK at n1 = nCCE of the decoded DL DCI (N1 = 0)
        pvals = c["p_vals"][sfs]
        pv = _take_rows(pvals, dl_cce_ue)  # (8, n, 2, 7, 12, 2)
        d0a = torch.where(dl_ok, 1.0, -1.0)
        dmask = c["p_dmask"]
        scale = dmask[:, None] * d0a[..., None, None, None] + (1.0 - dmask)[:, None]
        pcon = (pv * scale[..., None]
                * (dl_found * gain[None])[..., None, None, None, None])
        ppos = c["p_pos"][dl_cce_ue]
        for u in range(n):  # one UE per add: a fixed summation order on any device
            ug = _scatter_rows(ug, ppos[:, u].reshape(T8, -1),
                               pcon[:, u].reshape(T8, -1, 2), add=True)
        utx = ofdm.modulate(ug.reshape(T8, grid_mod.N_SYM, cell.nre, 2), cell.n_prb)
        urx = utx + amp.min() * randn(gen, utx.shape[1:]) / np.sqrt(2)

        # ------------- eNB receive -------------
        urg = ofdm.demodulate(urx, cell.n_prb).reshape(T8, S, 2)
        uwin = _win_slice(urg, rb_enb, m_sc)
        yd = uwin[:, :, c["ul_m_win"]].reshape(T8, n, 2, m_sc, 2)
        rref = c["ul_dmrs10"][sfs]
        ce_u, noise_u = waveblock._ul_estimate(yd, rref[:, None])
        yu = uwin[:, :, c["ul_d_win"]].reshape(T8, n, 12, m_sc, 2)
        llr_u = waveblock._ul_llrs(yu, ce_u, noise_u, qm_u, cinit_u)
        enb_soft = [sb * (~new_ul).reshape(B, 1) for sb in st["enb_soft"]]
        ul_out, ul_ok, st["enb_soft"], _ = sch.decode_tb(
            llr_u, cfg_u, softbuf=enb_soft, rv_b=rv_ul_enb.reshape(B), read=False, **decode)
        ul_ok = ul_ok.reshape(T8, n)

        # PUCCH ACK matched filter at the eNB's own CCE (DTX-aware)
        pv_e = _take_rows(pvals, cce_d)
        yp = urg[rows8, c["p_pos"][cce_d].reshape(T8, -1)].reshape(T8, n, 2, 7, 12, 2)
        # normalize by the known per-UE power-control gain so one DTX
        # threshold serves every link budget
        corr = waveblock._pucch_corr(yp, pv_e, dmask) / gain[None, :, None]
        ack_det = (cplx.abs2(corr) > cfg.ack_thresh) & (corr[..., 0] > 0)

        # ------------- HARQ state updates -------------
        dl_txs = torch.where(new_dl, 1, st["dl_retx"] + 1)
        dl_drop = (~ack_det) & (dl_txs >= cfg.max_tx)
        st["dl_pend"] = (~ack_det) & (~dl_drop)
        st["dl_retx"] = torch.where(st["dl_pend"], dl_txs, 0)

        ul_txs = torch.where(new_ul, 1, st["enb_retx"] + 1)
        ul_drop = (~ul_ok) & (ul_txs >= cfg.max_tx)
        st["enb_pend"] = (~ul_ok) & (~ul_drop)
        st["enb_retx"] = torch.where(st["enb_pend"], ul_txs, 0)
        st["enb_rb_prev"] = rb_enb
        st["phich_tx"] = ul_ok  # next round's PHICH payload

        st["counters"] = st["counters"] + torch.stack([
            x.reshape(C, -1).sum(1) for x in (~new_dl, dl_drop, retx_now, ul_drop, ~dl_found,
                                              ~ul_found)])
        for k, v in st.items():  # the carry, in place
            dst = b["st"][k]
            for d, x in (zip(dst, v) if isinstance(dst, list) else ((dst, v),)):
                if d is not x:
                    d.copy_(x)
        b["flags"].index_copy_(1, r, torch.stack([dl_ok, new_dl, dl_found, ack_det, ul_ok,
                                                  is_new_ul, tx_ul])[:, None])
        b["ints"].index_copy_(1, r, torch.stack([rb_ue, rv_dl])[:, None])
        b["dl_out"].index_copy_(0, r, dl_out.reshape(1, T8, n, -1))
        b["ul_out"].index_copy_(0, r, ul_out.reshape(1, T8, n, -1))
        r.add_(1)

    def new_block(dl_shape, ul_shape):
        """The block's tensors on the device: the queues (C, Q, n, tbs) of
        the inputs' shapes, the schedules as rounds of rows (R, T8, n), the
        TTIs (R,), the round index r (1,), the carry st, and the per-round
        outputs (R, T8, n, ...), the flags and ints stacked."""
        i64, u8 = dict(dtype=torch.int64, device=dev), dict(dtype=torch.bool, device=dev)
        z8n, f8n = (lambda: torch.zeros((T8, n), **i64)), (lambda: torch.zeros((T8, n), **u8))
        st = dict(
            dl_tb=torch.zeros((T8, n, cfg.dl_tbs), dtype=torch.int8, device=dev),
            dl_pend=f8n(), dl_retx=z8n(), dl_ndi=f8n(), ue_ndi=z8n(),
            ue_soft=sch.init_softbuffer(B, cfg_d, sdt, dev),
            dl_ptr=torch.zeros((C, n), **i64),
            ul_tb_ue=torch.zeros((T8, n, cfg.ul_tbs), dtype=torch.int8, device=dev),
            ue_pend=f8n(), ue_retx=z8n(), ue_ndi_ul=z8n(),
            ul_ptr=torch.zeros((C, n), **i64), ue_rb_prev=z8n(),
            enb_pend=f8n(), enb_retx=z8n(), enb_ndi_ul=f8n(), enb_rb_prev=z8n(),
            enb_soft=sch.init_softbuffer(B, cfg_u, sdt, dev),
            phich_tx=f8n(),
            counters=torch.zeros((len(COUNTERS), C), **i64),
        )
        return dict(
            dl_q=torch.zeros((C,) + dl_shape, dtype=torch.int8, device=dev),
            ul_q=torch.zeros((C,) + ul_shape, dtype=torch.int8, device=dev),
            rb_dl=torch.zeros((R, T8, n), **i64), rb_ul=torch.zeros((R, T8, n), **i64),
            ttis=torch.zeros((R,), **i64), r=torch.zeros((1,), **i64), st=st,
            flags=torch.zeros((len(ROUND_FLAGS), R, T8, n), **u8),
            ints=torch.zeros((len(ROUND_INTS), R, T8, n), **i64),
            dl_out=torch.zeros((R, T8, n, cfg.dl_tbs), dtype=torch.int8, device=dev),
            ul_out=torch.zeros((R, T8, n, cfg.ul_tbs), dtype=torch.int8, device=dev))

    def load(b, dl_q, ul_q, rb_dl, rb_ul, tti0):
        """A call's inputs into the block's tensors: the queues, the
        schedules (C, R, 8, n) as rounds of every cell's rows (R, T8, n),
        and the reference's ttis = tti0 + 8 * arange(R)."""
        b["dl_q"].copy_(dl_q.reshape(b["dl_q"].shape))
        b["ul_q"].copy_(ul_q.reshape(b["ul_q"].shape))
        for k, a in (("rb_dl", rb_dl), ("rb_ul", rb_ul)):
            b[k].copy_(torch.as_tensor(a).reshape(C, R, N_PID, n).transpose(0, 1)
                       .reshape(R, T8, n))
        torch.add(steps, int(tti0), out=b["ttis"])  # on the device: no copy from the host

    def reset(b):
        """The carry to the reference's carry0 (all zero but the PHICH
        payload, all ACK) and the round index to 0."""
        for v in b["st"].values():
            for t in (v if isinstance(v, list) else (v,)):
                t.zero_()
        b["st"]["phich_tx"].fill_(True)
        b["r"].zero_()

    def outputs(b):
        """The block's results as new tensors (a later call overwrites b):
        the per-round outputs (C, R, 8, n, ...), the counters (C,) and the
        queue pointers (C, n); one cell drops the cells axis."""
        per_round = dict(zip(ROUND_FLAGS, b["flags"].clone()))
        per_round.update(zip(ROUND_INTS, b["ints"].clone()))
        per_round.update(dl_out=b["dl_out"].clone(), ul_out=b["ul_out"].clone())
        outs = {k: v.reshape((R, C, N_PID) + v.shape[2:]).transpose(0, 1)
                for k, v in per_round.items()}
        outs.update(zip(COUNTERS, b["st"]["counters"].clone()))
        outs["dl_consumed"] = b["st"]["dl_ptr"].clone()
        outs["ul_consumed"] = b["st"]["ul_ptr"].clone()
        if C == 1:
            outs = {k: v[0] for k, v in outs.items()}
        return outs

    graphed = {}  # queue shapes -> (the block's tensors, its RoundGraph)
    on_card = jit and turbodecoder_cuda._on_card(rvseq, rvseq.device)

    def step(dl_q, ul_q, rb_dl, rb_ul, gen, tti0):
        gens = list(gen) if C > 1 else [gen]
        assert len(gens) == C, "one generator per cell"
        dl_q, ul_q = torch.as_tensor(dl_q), torch.as_tensor(ul_q)
        shapes = tuple(dl_q.shape[-3:]), tuple(ul_q.shape[-3:])
        b, graph = graphed.get(shapes) or (new_block(*shapes), None)
        load(b, dl_q, ul_q, rb_dl, rb_ul, tti0)
        if not on_card:
            reset(b)
            for _ in range(R):
                round_body(b, gens)
            return outputs(b)
        if graph is None:
            graph = graphs.RoundGraph(lambda g: round_body(b, g), lambda: reset(b), C, dev)
            graphed[shapes] = b, graph
        graph.run(R, gens)
        return outputs(b)

    return step


class DynBlockRunner:
    """Bridge between an ATTACHED WaveformNetwork's L2/L3 stacks and the
    dynamic block program: per block, the host muxes T TTIs of MAC PDUs
    per UE from the RLC entities into the payload queues, runs ONE block
    step for R rounds of dynamically-scheduled HARQ-carrying PHY on the
    network's device, and feeds the decoded TBs back into the stacks in
    queue order.

    The mux window is SPECULATIVE: TBs the block did not consume (their
    slots were taken by retransmissions) are dropped and recover via RLC
    AM — the same T-TTI speculation trade as SpsBlockRunner, extended to
    a dynamic grant/HARQ loop.  Delivery happens at recovery time, so a
    TB that needed two IR transmissions arrives 8 TTIs late, exactly the
    8-process cadence.  The block's noise comes from a torch.Generator
    seeded net.tti + 23, carried from block to block.  On the card the
    step is make_dyn_block_step's default: the first block captures a
    round as a CUDA graph, and every block replays it R times."""

    def __init__(self, net, R: int = 3, dl_mcs: int = 10, ul_mcs: int = 10):
        self.net = net
        mac = net.enb.mac
        cell = net.cell
        rntis = sorted(r for r, u in mac.ues.items()
                       if u.state == "RRC_CONNECTED")
        assert rntis, "no RRC-connected UEs to run in dyn-block mode"
        n = len(rntis)
        c0, c1 = waveblock.centre_prbs(cell.n_prb)
        usable = c0 + (cell.n_prb - c1)
        w = max(1, usable // n)
        lo = _pucch_region(cell)
        wu = max(1, (cell.n_prb - 2 * lo) // n)
        while wu > 1 and not pusch_mod.valid_n_prb(wu):
            wu -= 1
        self.ue_idx, snr = waveblock._link_snrs(net, rntis)
        self.cfg = DynBlockConfig(
            cell=cell, rntis=tuple(rntis), dl_l_crbs=w, dl_mcs=dl_mcs,
            ul_l_prb=wu, ul_mcs=ul_mcs, snr_db=snr, R=R)
        self.step = make_dyn_block_step(self.cfg, device=net.device)
        self._gen = torch.Generator(device=net.device)
        self._gen.manual_seed(net.tti + 23)
        self._sched_seed = net.tti
        self.metrics = dict(blocks=0, dl_tb=0, dl_ok=0, ul_tb=0, ul_ok=0,
                            dl_retx=0, ul_retx=0, dl_drop=0, ul_drop=0,
                            dci_miss=0)

    def run_block(self) -> dict:
        """Run R rounds device-resident.  Returns the block's outputs (as
        numpy arrays)."""
        net, cfg = self.net, self.cfg
        mac = net.enb.mac
        dl, ul = waveblock._mux_block(net, cfg.rntis, self.ue_idx, cfg.T,
                                     cfg.dl_tbs, cfg.ul_tbs)
        self._sched_seed += 1
        rb_dl, rb_ul = make_schedule(cfg, seed=self._sched_seed)
        out = self.step(dl, ul, rb_dl, rb_ul, self._gen,
                        (net.tti + 7) // 8 * 8 % 10240)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        dl_out = np.packbits(out["dl_out"].astype(np.uint8), axis=-1)
        ul_out = np.packbits(out["ul_out"].astype(np.uint8), axis=-1)
        m = self.metrics
        for r in range(cfg.R):
            for t in range(N_PID):
                tti = net.tti + r * N_PID + t
                for i, rnti in enumerate(cfg.rntis):
                    ust = net.ues[self.ue_idx[i]].stack
                    if out["dl_new"][r, t, i]:
                        m["dl_tb"] += 1
                    if out["ul_new"][r, t, i]:
                        m["ul_tb"] += 1
                    if out["dl_ok"][r, t, i]:
                        m["dl_ok"] += 1
                        ust.tb_decoded(tti, dl_out[r, t, i].tobytes(),
                                       cfg.snr_db[i], rnti=rnti)
                        ust.get_pucch(tti)
                    if out["ul_ok"][r, t, i]:
                        m["ul_ok"] += 1
                        mac.ul_pdu(tti, rnti, ul_out[r, t, i].tobytes(),
                                   cfg.snr_db[i])
                    if hasattr(ust, "tick"):
                        ust.tick()
        m["dl_retx"] += int(out["dl_retx_tx"])
        m["ul_retx"] += int(out["ul_retx_tx"])
        m["dl_drop"] += int(out["dl_drop"])
        m["ul_drop"] += int(out["ul_drop"])
        m["dci_miss"] += int(out["dci_dl_miss"]) + int(out["dci_ul_miss"])
        m["blocks"] += 1
        net.tti += cfg.T
        return out


def make_bench_step(cfg: DynBlockConfig, n_cells: int = 1, device="cuda"):
    """The dynamic block reduced on the device to six counts: (DL CRCs
    passed, UL CRCs passed, ACKs detected, DL retransmissions, UL
    retransmissions, DCI misses).  n_cells > 1 runs that many independent
    cells in one block (make_dyn_block_step's cells axis: leading cells
    axis on the queues and schedules, one generator per cell, one tti0) and
    sums each count over them, on the device.  The block is
    make_dyn_block_step's default: on the card, a captured round replayed R
    times."""
    step = make_dyn_block_step(cfg, device, n_cells)

    def bench(dl_q, ul_q, rb_dl, rb_ul, gen, tti0):
        o = step(dl_q, ul_q, rb_dl, rb_ul, gen, tti0)
        return (o["dl_ok"].sum(), o["ul_ok"].sum(), o["ack_det"].sum(),
                o["dl_retx_tx"].sum(), o["ul_retx_tx"].sum(),
                (o["dci_dl_miss"] + o["dci_ul_miss"]).sum())

    return bench
