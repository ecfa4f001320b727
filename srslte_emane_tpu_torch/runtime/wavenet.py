"""Waveform-native network: the FULL UE life cycle through the device PHY.

Twin of the reference's `runtime/wavenet.py`.  No message bus below RRC: cell search -> PSS/SSS/CP detect -> MIB ->
SIB1/SIB2 -> PRACH (detected by eNB root-sequence correlation) -> RAR ->
Msg3/contention resolution -> RRC + NAS attach -> IP traffic, every step
carried as OFDM waveforms through per-link pathloss + AWGN channels.

Reference behavior: the stock srsLTE ZMQ IQ mode (`lib/src/phy/rf/
rf_zmq_imp.c`) where UE and eNB exchange raw samples, the UE sync state
machine (`srsue/src/phy/sync.cc:364-470` CELL_SEARCH -> SFN_SYNC ->
CAMPING), `srsenb/src/phy/sf_worker.cc` (UL decode then DL encode per TTI)
and `srsue/src/phy/cc_worker.cc` (fft/chest -> PDCCH blind search ->
PDSCH decode; PUSCH/PUCCH/PRACH encode).

The SAME L2/L3 stacks as the message-level path (`stack/enb_stack.py`,
`stack/ue_stack.py`) drive these adapters — MAC/RLC/PDCP/RRC/NAS are
shared, only the PHY transport differs, exactly the reference's layering.
What crosses between the PHY and the stacks is host data (Python ints,
bytes, numpy arrays), never a tensor.

Device design: the reference's 25 jitted stages are `_CellKernels`
factories, keyed as the reference keys them; on the card each key is one
CUDA graph (`runtime/graphs.jit`), captured at its first call and replayed
at every later one, with rnti, cce_start, rb_start, sf and the RE index
table as device inputs where the reference traces them.  `jit=False` runs
the same stages eagerly (the graphed network's plain version).  The stacks,
the EPC, the host reads between stages and `WaveMedium` stay eager, as in
the reference.  The UE's blind
search decodes the FULL aligned CCE space once per subframe for every UE
in one call, with per-RNTI adjudication as a host integer compare
(pdcch.blind_search_all), and PUCCH detection batches all resources of the
format-1 region into one matched-filter tensor.

Transport-format convention: the DCI carries (RIV, I_MCS) and BOTH sides
derive the transport block size from the same 36.213 tables (phch/ra.py);
the MAC PDU is padded to the TBS with real 36.321 padding subheaders
(stack/pdu.py pack(tb_size=...)), so the waveform-path TB image IS the
stack's own MAC wire format end-to-end and dissects as MAC-LTE.

Spec resource mappings (36.213): the HARQ-ACK PUCCH resource is
n_pucch = n_CCE + N1 derived from the DL DCI's first CCE (§10.1,
ue_ul.c:533-557; N1 = the SIB2 n1-PUCCH-AN = 0 here), the SR resource is
the RRC-dedicated sr-PUCCH-ResourceIndex (SchedulingRequestConfig), and
PHICH rides (n_group, n_seq) derived from the PUSCH's lowest PRB (§9.1.2,
phich.c:131-134).  The UE's subframe/SFN timing comes from SSS + the
decoded MIB through an SFN_SYNC state (sync.cc:408), never from the
network loop's tick counter.

Options, as the reference's: the 2x2 TM3 downlink (`mimo=`, `mimo_cond=`:
two port waveforms, RI reports on PUCCH format 2, rank-2 grants on DCI
format 2A), TDD frames (`tdd_config=`, `ss_config=`: DwPTS-truncated PDSCH
in the special subframe, UL only on U subframes, bundled HARQ-ACKs) and the
medium's impairments (`fading_profile=`, `doppler_hz=`, `dyn_delay=`,
`hst_fd_hz=`, `rlf=`), which may also be set on `net.medium` later.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cplx, fading as fading_mod, modem, ofdm
from ..phch import chest, dci as dci_mod, grid as grid_mod, pbch as pbch_mod
from ..phch import pcfich as pcfich_mod, pdcch as pdcch_mod
from ..phch import pdsch as pdsch_mod, phich as phich_mod, prach as prach_mod
from ..phch import pucch as pucch_mod, pusch as pusch_mod, ra
from ..phch import refsignal_ul, sch, sync as sync_mod, tdd as tdd_mod
from ..phch import uci as uci_mod
from ..utils.devices import resolve, row, table_cache
from . import graphs
from .waveblock import _randn


PRACH_SF = 1  # PRACH occasion subframe (prach-ConfigIndex 3 role)
PRACH_K0 = 12  # first PRACH bin (prach-FreqOffset 1 PRB at 1.25 kHz x12)
N1_PUCCH = 0  # SIB2 n1-PUCCH-AN: dynamic ACK region starts at resource 0
FADING_SEED = 77  # the fading's sinusoids are drawn anew every TTI from (77, tti)


def _dwpts(tdd_config, ss_config: int, sf: int) -> int:
    """DwPTS symbols of subframe sf when it is a TDD special subframe, else
    0 (no truncation)."""
    if tdd_config is None or tdd_mod.sf_type(tdd_config, sf) != "S":
        return 0
    return tdd_mod.nof_dw(ss_config)


def _srate_div(n_prb: int) -> int:
    """PRACH synthesis decimation: 30.72 Msps / cell sample rate."""
    return 30720 // ofdm.params(n_prb)["sf_len"]


def _dl_mcs_for(payload_len: int, n_prb_alloc: int, n_re: int = 0) -> int:
    """Smallest EVEN I_MCS whose 36.213 TBS fits the MAC PDU after
    padding-subheader repacking (worst case +3 bytes of header growth;
    both sides derive the TBS from the DCI so any consistent choice is
    valid).  n_re > 0 additionally requires a legal code rate (<= 0.93)
    over the grant's TRUE RE count — sf 0/5 allocations lose REs to
    PSS/SSS/PBCH."""
    need = (payload_len + 3) * 8
    for mcs in list(range(0, 29, 2)) + [27]:
        tbs = ra.dl_tbs(mcs, n_prb_alloc)
        if tbs < need:
            continue
        if n_re and tbs + 24 > 0.93 * n_re * ra.dl_mcs_to_qm(mcs):
            continue
        return mcs
    raise ValueError(f"payload {payload_len}B exceeds any TBS on "
                     f"{n_prb_alloc} PRBs (n_re={n_re})")


def _dl_mcs_clamp(pref: int, payload_len: int, n_prb_alloc: int,
                  n_re: int) -> int:
    """Largest even MCS <= pref that fits the payload at a legal code
    rate, falling back to the smallest fitting MCS."""
    lo = _dl_mcs_for(payload_len, n_prb_alloc, n_re)
    for mcs in range(min(pref, 28) & ~1, lo, -2):
        tbs = ra.dl_tbs(mcs, n_prb_alloc)
        if tbs + 24 <= 0.93 * n_re * ra.dl_mcs_to_qm(mcs):
            return mcs
    return lo


def _frame(payload: bytes, tbs: int) -> np.ndarray:
    """(1, tbs) bits: the MAC PDU padded to the TBS with real 36.321
    padding subheaders (pdu.pack tb_size).  RAR PDUs zero-pad the tail —
    their grammar is subheader-count-driven (36.321 §6.1.5), so trailing
    octets are ignored by every parser."""
    from ..stack import pdu as pdu_mod

    nb = tbs // 8
    payload = bytes(payload)
    if pdu_mod.is_rar(payload):
        buf = payload + bytes(nb - len(payload))
    else:
        buf = pdu_mod.pack(pdu_mod.unpack(payload), tb_size=nb)
    arr = np.frombuffer(buf, np.uint8)
    return np.unpackbits(arr)[None, :tbs].astype(np.int8)


def _unframe(bits: np.ndarray) -> bytes:
    """Full TB image: padding subheaders are the MAC parser's problem
    (pdu.unpack drops them), exactly as on a real transport block."""
    return np.packbits(np.asarray(bits, np.uint8).ravel()).tobytes()


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


# ---- the stages' device tables (graphs.py: a table a graph reads comes
# from a table_cache, which the graph holds) ----

@table_cache(32)
def _base_table(cell: grid_mod.CellConfig, sf_idx: int, device: torch.device) -> torch.Tensor:
    """(1, 14, NRE, 2) PSS/SSS + CRS + PCFICH of subframe sf_idx."""
    g = cplx.zeros((1, grid_mod.N_SYM, cell.nre), device=device)
    g = sync_mod.put_pss_sss(g, cell, sf_idx)
    # CRS on every subframe (put_base role) — pdsch.encode would
    # re-place them, but control-only subframes (and the PBCH
    # subframe itself) must still carry pilots for UE chest
    g = pdsch_mod.put_crs(g, cell, sf_idx)
    return pcfich_mod.encode(torch.full((1,), cell.cfi, device=device), cell, sf_idx, g)


@table_cache(32)
def _base_p1_table(cell: grid_mod.CellConfig, sf_idx: int, device: torch.device) -> torch.Tensor:
    """(1, 14, NRE, 2) CRS of antenna port 1 alone."""
    g = cplx.zeros((1, grid_mod.N_SYM, cell.nre), device=device)
    return pdsch_mod.put_crs(g, cell, sf_idx, port=1)


@table_cache(8)
def _sb_layout(cell: grid_mod.CellConfig, device: torch.device):
    """(n_sb, k_sb, pad, per-subband RE counts (n_sb,) on `device`)."""
    n_sb = max(1, uci_mod.cqi_hl_subband_size(cell.n_prb))
    k_sb = -(-cell.n_prb // n_sb) * 12
    pad = n_sb * k_sb - cell.nre
    cnt = np.maximum(np.minimum(k_sb, cell.nre - k_sb * np.arange(n_sb)), 1)
    return n_sb, k_sb, pad, torch.from_numpy(cnt.astype(np.float32)).to(device)


@table_cache(20)
def _pucch_wf(cell: grid_mod.CellConfig, n_res: int, sf_idx: int, device: torch.device):
    """(N_RES, sf_len, 2) x2 on `device`: time-domain DMRS part and data
    part per format-1 resource; a UE's transmission is W_dmrs[r] +
    d0*W_data[r] (format 1 is affine in d(0); OFDM is linear)."""
    g0 = cplx.zeros((1, grid_mod.N_SYM, cell.nre), device=device)
    d0s = (torch.tensor([[0.0, 0.0]], device=device), torch.tensor([[1.0, 0.0]], device=device))
    grids = torch.cat([pucch_mod.encode_f1(d0, cell, sf_idx, r, g0)
                       for d0 in d0s for r in range(n_res)], dim=0)
    wf = ofdm.modulate(grids, cell.n_prb)
    return wf[:n_res], wf[n_res:] - wf[:n_res]


@table_cache(32)
def _f2_tables(cell: grid_mod.CellConfig, n: int, f2_base: int, sf_idx: int,
               device: torch.device):
    """(pos (n*2*7*12,) int64, conj(ref) (n, 2, 7, 12, 2)) on `device` for
    the whole format-2 region [f2_base, f2_base + n)."""
    pos = np.zeros((n, 2, 7, 12), np.int32)
    ref = np.zeros((n, 2, 7, 12), np.complex64)
    ncs = pucch_mod.n_cs_cell(cell.cell_id)
    u_tab = refsignal_ul.f_gh_table(cell.cell_id, False)
    for i in range(n):
        res = f2_base + i
        for s in range(2):
            ns = 2 * sf_idx + s
            u = (int(u_tab[ns]) + cell.cell_id % 30) % 30
            base = refsignal_ul.base_sequence(u, 0, 12)
            prb = pucch_mod.pucch_prb(res, ns, cell.n_prb)
            ks = 12 * prb + np.arange(12)
            for l in range(7):
                alpha = 2 * np.pi * ((res % 12 + int(ncs[ns, l]))
                                     % 12) / 12
                ref[i, s, l] = base * np.exp(1j * alpha
                                             * np.arange(12))
                pos[i, s, l] = (7 * s + l) * cell.nre + ks
    return (torch.from_numpy(pos.reshape(-1).astype(np.int64)).to(device),
            cplx.from_numpy(np.conj(ref), device))


@table_cache(32)
def _pucch_rx_tables(cell: grid_mod.CellConfig, n_res: int, sf_idx: int,
                     device: torch.device):
    """(RE indices (n_res*n_mf*12,) int64, conj(ref) (n_res, n_mf, 12, 2))
    of every format-1 resource's data symbols, on `device`."""
    n_mf = 2 * len(pucch_mod.F1_DATA_SYMS)
    # per-resource RE indices: resources above 36 live in inner PRB
    # regions (pucch_prb m = n_pucch//36), so each row gathers its own
    idx = np.zeros((n_res, n_mf, 12), np.int32)
    ref = np.zeros((n_res, n_mf, 12), np.complex64)
    for r in range(n_res):
        wf = pucch_mod._f1_waveform(cell.cell_id, sf_idx, r)
        k = 0
        for s in range(2):
            prb = pucch_mod.pucch_prb(r, 2 * sf_idx + s, cell.n_prb)
            ks = 12 * prb + np.arange(12)
            for l in pucch_mod.F1_DATA_SYMS:
                idx[r, k] = (7 * s + l) * cell.nre + ks
                ref[r, k] = wf[s, l]
                k += 1
    return (torch.from_numpy(idx.reshape(-1).astype(np.int64)).to(device),
            cplx.from_numpy(np.conj(ref), device))


class _CellKernels:
    """Per-cell stage cache, shared by the eNB and every UE: the twin of the
    reference's 25 jitted stages.  Each stage is a factory, cached per
    instance and keyed by the reference's static arguments; it returns the
    stage's function (with the reference's extras: a TBS, the blind
    search's positions).  With `jit` on the card that function is a
    `graphs.jit` step: each key (and argument signature) is captured once as
    a CUDA graph and replayed at every call, the numbers filled into its
    0-d inputs.  Otherwise it runs eagerly, with its numbers as 0-d tensors
    and its arrays as tensors on the device, so that the tensor path the
    graph captures is the one that runs.  rnti, cce_start, the RE index
    table and sf are device inputs of add_dl_grant and pdsch_rx, and rnti,
    rb_start and sf of the four PUSCH stages: one graph per (width, MCS,
    ...), never per (sf, rb_start).

    n_pucch_res sizes the format-1 region scanned by the eNB's one-shot
    matched filter: [0, n_cce) dynamic HARQ-ACK (36.213 §10.1 with N1=0)
    plus the dedicated SR pool above it."""

    def __init__(self, cell: grid_mod.CellConfig, n_pucch_res: int = 32,
                 n_f2_res: int = 0, f2_base: int = 0, n_cce: int = 0,
                 device="cuda", jit: bool = True):
        self.cell = cell
        self.dci_len = dci_mod.format0_1a_len(cell.n_prb)
        self.n_pucch_res = n_pucch_res
        # format-2 (periodic CQI) region: resources [f2_base, f2_base +
        # n_f2_res) in a PRB region above the format-1 space; a UE's CQI
        # resource is f2_base + (sr_pucch_res - n_cce) — the
        # cqi-PUCCH-ResourceIndex role keyed off the same dedicated index
        self.n_f2_res = n_f2_res
        self.f2_base = f2_base
        self.n_cce = n_cce
        self.device = torch.device(device)
        self.jit = jit
        self._memo = {}
        self.steps = {}  # (stage, key...) -> its graphs.jit step (graphed only)

    def _stage(self, run, *key):
        """`run` as the stage `key` (`graphs.step`): graphed on the card with
        jit, else eager on tensor arguments."""
        step = graphs.step(run, self.device, self.jit)
        if hasattr(step, "graphs"):
            self.steps[key] = step
        return step

    def graph_counts(self) -> dict:
        """{(stage, key...): graphs captured} over the graphed stages."""
        return {k: len(s.graphs) for k, s in self.steps.items()}

    @graphs.per_instance
    def cell_search(self):
        """PSS/SSS+CP search on (B, sf_len, 2) cell-rate samples — ONE call
        covers every still-searching UE in the network.  -> (quality,
        cell_id, sf_idx)."""
        fft = ofdm.params(self.cell.n_prb)["n"]

        def run(samples):
            res = sync_mod.cell_search(samples, fft_size=fft, detect_cp=True)
            return res["quality"], res["cell_id"], res["sf_idx"]

        return self._stage(run, "cell_search")

    # ---- eNB side ----

    @graphs.per_instance
    def base_grid(self, sf_idx: int, with_pbch: int):
        """Base subframe: PSS/SSS + PCFICH (+ PBCH for sfn%4 phase
        with_pbch >= 0 on sf 0).  Takes the (1, 24) MIB bits; returns the
        (1, 14, NRE, 2) grid."""
        cell, dev = self.cell, self.device

        def run(mib_bits):
            g = _base_table(cell, sf_idx, dev)
            if with_pbch >= 0 and sf_idx == 0:
                return pbch_mod.encode(mib_bits, cell, with_pbch, g)
            return g.clone()

        return self._stage(run, "base_grid", sf_idx, with_pbch)

    def base_grid_p1(self, sf_idx: int) -> torch.Tensor:
        """Port-1 base grid: CRS on antenna port 1 only (the MIMO mode's
        second transmit waveform; control stays on port 0).  A constant
        table: no stage."""
        return _base_p1_table(self.cell, sf_idx, self.device)

    def _dl_cfg(self, sf: int, rb_start: int, l_crbs: int, mcs: int,
                max_sym: int = 0):
        """(PRB mask, SchConfig) of a type-2 DL alloc; max_sym > 0
        truncates it to the TDD DwPTS symbol range."""
        mask = ra.type2_to_prb_mask(rb_start, l_crbs, self.cell.n_prb)
        qm = ra.dl_mcs_to_qm(mcs)
        g = grid_mod.nof_re(self.cell, sf, mask, max_sym) * qm
        return mask, sch.SchConfig(tbs=ra.dl_tbs(mcs, l_crbs), G=g, Qm=qm, Nl=1)

    def _tm3_cfgs(self, sf: int, rb_start: int, l_crbs: int, mcs1: int, mcs2: int):
        """(PRB mask, [SchConfig of each codeword]) of a rank-2 grant."""
        cfgs = [self._dl_cfg(sf, rb_start, l_crbs, m)[1] for m in (mcs1, mcs2)]
        return ra.type2_to_prb_mask(rb_start, l_crbs, self.cell.n_prb), cfgs

    @graphs.per_instance
    def add_dl_grant_tm3(self, sf_idx: int, rb_start: int, l_crbs: int,
                         mcs1: int, mcs2: int, l_aggr: int):
        """Rank-2 TM3 grant: DCI format 2A on the port-0 PDCCH + both
        codewords large-delay-CDD precoded onto the two port grids
        (lib/src/phy/mimo/precoding.c tm3; pdsch.encode_tm).  -> (fn, (tbs1,
        tbs2)); fn(grid, grid_p1, dci_bits, tb1, tb2, rnti, cce_start) ->
        (grid, grid_p1)."""
        cell = self.cell
        mask, cfgs = self._tm3_cfgs(sf_idx, rb_start, l_crbs, mcs1, mcs2)

        def run(g0, g1, dci_bits, tb1, tb2, rnti, cce_start):
            g0 = pdcch_mod.encode_dyn(dci_bits, rnti, l_aggr, cce_start, cell, sf_idx, g0)
            grids = pdsch_mod.encode_tm([tb1, tb2], cfgs, cell, sf_idx, rnti, mask, "tm3",
                                        grids=torch.stack([g0, g1], dim=1))
            return grids[:, 0], grids[:, 1]

        return (self._stage(run, "add_dl_grant_tm3", sf_idx, rb_start, l_crbs, mcs1, mcs2,
                            l_aggr),
                tuple(c.tbs for c in cfgs))

    @graphs.per_instance
    def pdsch_rx_tm3(self, sf_idx: int, rb_start: int, l_crbs: int,
                     mcs1: int, mcs2: int):
        """UE-side TM3 decode: fn(the (1, 2_rx, 14, NRE, 2) grids, rnti) ->
        (payload 1, payload 2, ok 1, ok 2)."""
        cell = self.cell
        mask, cfgs = self._tm3_cfgs(sf_idx, rb_start, l_crbs, mcs1, mcs2)

        def run(rx_grids, rnti):
            pls, oks, _ = pdsch_mod.decode_tm(rx_grids, cfgs, cell, sf_idx, rnti, mask, "tm3")
            return pls[0], pls[1], oks[0], oks[1]

        return self._stage(run, "pdsch_rx_tm3", sf_idx, rb_start, l_crbs, mcs1, mcs2)

    @graphs.per_instance
    def blind_all2(self, sf_idx: int):
        """blind_all for the DCI format-2A length (rank-2 grants)."""
        return self._blind(sf_idx, dci_mod.format2_len(self.cell.n_prb, "2A"), "blind_all2")

    @graphs.per_instance
    def ri_probe(self, sf_idx: int):
        """Wideband rank probe from the per-(rx, tx) channel estimates of
        the (1, 2, 14, NRE, 2) grids: the 2x2 singular-value ratio decides
        RI (cqi.c RI report role).  fn(grids) -> (s2 / s1, s1)."""
        cell = self.cell

        def run(rx_grids):
            ce, _ = pdsch_mod.estimate_mimo(rx_grids, cell, sf_idx, 2)
            h = ce[0].mean(dim=(2, 3))  # (2rx, 2tx, 2) wideband
            hc = torch.complex(h[..., 0], h[..., 1])
            g = hc.conj().T @ hc  # 2x2 Gram
            tr = (g[0, 0] + g[1, 1]).real
            det = (g[0, 0] * g[1, 1] - g[0, 1] * g[1, 0]).real
            disc = torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=0.0))
            s1 = torch.sqrt(torch.clamp((tr + disc) / 2.0, min=1e-12))
            s2 = torch.sqrt(torch.clamp((tr - disc) / 2.0, min=0.0))
            return s2 / s1, s1

        return self._stage(run, "ri_probe", sf_idx)

    def dl_re_idx(self, sf_idx: int, rb_start: int, l_crbs: int,
                  max_sym: int = 0) -> torch.Tensor:
        """(n_re,) int64 RE index table of a type-2 DL alloc, built on the
        host and kept on the device (pdsch's table cache); max_sym > 0
        truncates it to the TDD DwPTS symbol range.  add_dl_grant and
        pdsch_rx take it as an input."""
        mask = ra.type2_to_prb_mask(rb_start, l_crbs, self.cell.n_prb)
        return pdsch_mod._re_table(self.cell, sf_idx, mask, self.device, max_sym)

    @graphs.per_instance
    def add_dl_grant(self, l_crbs: int, mcs: int, l_aggr: int, n_re: int):
        """Place one DCI-1A + its PDSCH into the grid.  rnti, cce_start, the
        RE index table AND sf are inputs — one graph per (width, mcs, L,
        n_re), NOT per (sf, rb_start): the graph population stays O(shapes),
        not O(shapes x positions x 10) (per-sf CRS and scrambling ride
        (10, ...) table gathers).  -> (fn, tbs); fn(grid, dci_bits,
        payload_bits, rnti, cce_start, re_idx, sf) -> grid."""
        cell = self.cell
        tbs = ra.dl_tbs(mcs, l_crbs)
        qm = ra.dl_mcs_to_qm(mcs)
        cfg = sch.SchConfig(tbs=tbs, G=n_re * qm, Qm=qm, Nl=1)

        def run(grid, dci_bits, payload_bits, rnti, cce_start, re_idx, sf):
            g = pdcch_mod.encode_dyn(dci_bits, rnti, l_aggr, cce_start, cell, sf, grid)
            return pdsch_mod.encode(payload_bits, cfg, cell, sf, rnti, None, grid=g,
                                    re_idx=re_idx)

        return self._stage(run, "add_dl_grant", l_crbs, mcs, l_aggr, n_re), tbs

    @graphs.per_instance
    def add_ul_dci(self, sf_idx: int, l_aggr: int):
        """fn(grid, dci_bits, rnti, cce_start) -> grid with the DCI-0."""
        cell = self.cell

        def run(grid, dci_bits, rnti, cce_start):
            return pdcch_mod.encode_dyn(dci_bits, rnti, l_aggr, cce_start, cell, sf_idx, grid)

        return self._stage(run, "add_ul_dci", sf_idx, l_aggr)

    @graphs.per_instance
    def add_phich(self, sf_idx: int):
        """fn(grid, acks (1, n_groups, 8)) -> grid with the PHICH."""
        cell = self.cell
        return self._stage(lambda grid, acks: phich_mod.encode(acks, cell, sf_idx, grid),
                           "add_phich", sf_idx)

    @graphs.per_instance
    def modulate(self):
        """fn(grids (B, 14, NRE, 2)) -> (B, sf_len, 2)."""
        n_prb = self.cell.n_prb
        return self._stage(lambda g: ofdm.modulate(g, n_prb), "modulate")

    @graphs.per_instance
    def demodulate(self):
        """fn(samples (B, sf_len, 2)) -> (B, 14, NRE, 2): the eNB's UL grid,
        demodulated once per TTI for every decoder, and the UE's PBCH grid."""
        n_prb = self.cell.n_prb
        return self._stage(lambda s: ofdm.demodulate(s, n_prb), "demodulate")

    @graphs.per_instance
    def mask_dwpts(self, dw_sym: int):
        """Zero GP/UpPTS symbols of a TDD special subframe's grid."""

        def run(grid):
            g = grid.clone()
            g[:, dw_sym:] = 0.0
            return g

        return self._stage(run, "mask_dwpts", dw_sym)

    # ---- UE side ----

    @graphs.per_instance
    def rx_front(self, sf_idx: int):
        """OFDM demod + channel estimate + per-subband SNR (the cqi.c
        subband measurement input).  fn(samples) -> (rg, ce, snr_db,
        sb_snr)."""
        cell, dev = self.cell, self.device

        def run(samples):
            n_sb, k_sb, pad, cnt = _sb_layout(cell, dev)
            rg = ofdm.demodulate(samples, cell.n_prb)
            ch = chest.estimate(rg, cell, sf_idx)
            p = cplx.abs2(ch.ce).mean(-2)  # (B, NRE): mean over symbols
            p = torch.nn.functional.pad(p, (0, pad))
            p_sb = p.reshape(p.shape[0], n_sb, k_sb).sum(-1) / cnt
            sb_snr = 10.0 * torch.log10(torch.clamp(
                p_sb / torch.clamp(ch.noise_est, min=1e-12)[:, None], min=1e-12))
            return rg, ch.ce, ch.snr_db, sb_snr

        return self._stage(run, "rx_front", sf_idx)

    def _blind(self, sf_idx: int, dci_len: int, name: str):
        cell = self.cell

        def run(rg, ce):
            bits, resid, _ = pdcch_mod.blind_search_all(rg, ce, cell, sf_idx, dci_len)
            return bits, resid

        return self._stage(run, name, sf_idx), list(pdcch_mod.full_space(cell))

    @graphs.per_instance
    def blind_all(self, sf_idx: int):
        """Decode the FULL aligned CCE space once; per-RNTI adjudication
        happens on the host (resid == rnti).  -> (fn, positions); fn(rg,
        ce) -> (bits, resid), whatever the number of RNTIs watched."""
        return self._blind(sf_idx, self.dci_len, "blind_all")

    @graphs.per_instance
    def pdsch_rx(self, l_crbs: int, mcs: int, n_re: int):
        """One graph per (width, mcs, n_re) — rb_start rides the RE index
        table, sf the per-sf table gathers.  fn(rg, rnti, re_idx, sf) ->
        (payload, ok)."""
        cell = self.cell
        tbs = ra.dl_tbs(mcs, l_crbs)
        qm = ra.dl_mcs_to_qm(mcs)
        cfg = sch.SchConfig(tbs=tbs, G=n_re * qm, Qm=qm, Nl=1)

        def run(rg, rnti, re_idx, sf):
            payload, ok, _, _ = pdsch_mod.decode(rg, cfg, cell, sf, rnti, None, re_idx=re_idx)
            return payload, ok

        return self._stage(run, "pdsch_rx", l_crbs, mcs, n_re)

    @graphs.per_instance
    def phich_rx(self, sf_idx: int):
        """fn(rg, ce) -> (B, n_groups, 8) PHICH soft metrics."""
        cell = self.cell
        return self._stage(lambda rg, ce: phich_mod.decode(rg, ce, cell, sf_idx),
                           "phich_rx", sf_idx)

    @graphs.per_instance
    def pbch_rx(self):
        """fn(rg of subframe 0) -> (mib, n_ports, sfn offset, ok)."""
        cell = self.cell

        def run(rg):
            ch0 = chest.estimate(rg, cell, 0, port=0)
            ch1 = chest.estimate(rg, cell, 0, port=1)
            return pbch_mod.decode(rg, ch0.ce, cell, ce_port1=ch1.ce)

        return self._stage(run, "pbch_rx")

    # ---- uplink ----

    def _ul_cfg(self, l_prb: int, mcs: int, n_cqi: int = 0):
        """(SchConfig, q_cqi): the PUSCH TB, with room for n_cqi UCI bits."""
        tbs = ra.ul_tbs(min(mcs, 28), l_prb)
        qm = ra.ul_mcs_to_qm(min(mcs, 28))
        _, _, q_cqi, g_data = pusch_mod.uci_dims(l_prb, qm, 0, 0, n_cqi)
        return sch.SchConfig(tbs=tbs, G=g_data, Qm=qm, Nl=1), q_cqi

    @graphs.per_instance
    def pusch_tx(self, l_prb: int, mcs: int):
        """rb_start and sf are inputs (the RE indices by arithmetic, the
        DMRS by table gather): one graph per (width, mcs).  -> (fn, tbs);
        fn(bits, rnti, rb_start, sf) -> (1, sf_len, 2)."""
        cell = self.cell
        cfg, _ = self._ul_cfg(l_prb, mcs)

        def run(bits, rnti, rb_start, sf):
            g = pusch_mod.encode(bits, cfg, cell, sf, rnti, rb_start, l_prb)
            return ofdm.modulate(g, cell.n_prb)

        return self._stage(run, "pusch_tx", l_prb, mcs), cfg.tbs

    @graphs.per_instance
    def pusch_tx_cqi(self, l_prb: int, mcs: int, n_cqi: int):
        """PUSCH with an aperiodic CQI report as REAL multiplexed UCI
        (36.212 §5.2.2.6 coding + §5.2.2.8 interleaver placement).  -> (fn,
        tbs); fn(bits, cqi_bits, rnti, rb_start, sf) -> (1, sf_len, 2)."""
        cell = self.cell
        cfg, _ = self._ul_cfg(l_prb, mcs, n_cqi)

        def run(bits, cqi_bits, rnti, rb_start, sf):
            g = pusch_mod.encode(bits, cfg, cell, sf, rnti, rb_start, l_prb,
                                 uci=dict(cqi=cqi_bits))
            return ofdm.modulate(g, cell.n_prb)

        return self._stage(run, "pusch_tx_cqi", l_prb, mcs, n_cqi), cfg.tbs

    @graphs.per_instance
    def pusch_rx_cqi(self, l_prb: int, mcs: int, n_cqi: int):
        """fn(the eNB's UL grid, rnti, rb_start, sf) -> (payload, ok, cqi
        bits)."""
        cell = self.cell
        cfg, q_cqi = self._ul_cfg(l_prb, mcs, n_cqi)
        dims = (0, 0, q_cqi, 0, 0, n_cqi)

        def run(rg, rnti, rb_start, sf):
            out = pusch_mod.decode(rg, cfg, cell, sf, rnti, rb_start, l_prb, uci_dims_in=dims)
            return out["payload"], out["ok"], out["cqi"]

        return self._stage(run, "pusch_rx_cqi", l_prb, mcs, n_cqi)

    @graphs.per_instance
    def pusch_rx(self, l_prb: int, mcs: int):
        """fn(the eNB's UL grid, rnti, rb_start, sf) -> (payload, ok)."""
        cell = self.cell
        cfg, _ = self._ul_cfg(l_prb, mcs)

        def run(rg, rnti, rb_start, sf):
            payload, ok, _, _ = pusch_mod.decode(rg, cfg, cell, sf, rnti, rb_start, l_prb)
            return payload, ok

        return self._stage(run, "pusch_rx", l_prb, mcs)

    # ---- PUCCH: every format-1 resource of the region as ONE tensor ----

    @graphs.per_instance
    def pucch_tx(self, sf_idx: int):
        """fn(resource, d0 (1, 2)) -> (1, sf_len, 2) format-1 waveform; the
        resource is an input."""
        cell, dev, n_res = self.cell, self.device, self.n_pucch_res

        def run(r, d0):
            wd, wx = _pucch_wf(cell, n_res, sf_idx, dev)
            return row(wd, r)[None] + cplx.mul(d0[:, None, :], row(wx, r)[None])

        return self._stage(run, "pucch_tx", sf_idx)

    # ---- PUCCH format 2/2a: periodic wideband CQI (+1 ACK bit) ----

    @graphs.per_instance
    def pucch2_tx(self, sf_idx: int, res_rel: int, n_ack: int = 0):
        """UE-side format-2 (n_ack=0) or 2a (n_ack=1) transmit on CQI
        resource f2_base + res_rel: fn(cqi_bits (1, 4)[, ack (1, 1)]) ->
        (1, sf_len, 2)."""
        cell = self.cell
        res = self.f2_base + res_rel
        g0 = lambda: cplx.zeros((1, grid_mod.N_SYM, cell.nre), device=self.device)

        if n_ack == 0:
            def run(cqi_bits):
                g = pucch_mod.encode_f2(cqi_bits, cell, sf_idx, res, g0())
                return ofdm.modulate(g, cell.n_prb)
        else:
            def run(cqi_bits, ack_bits):
                g = pucch_mod.encode_f2ab(cqi_bits, ack_bits, cell, sf_idx, res, g0())
                return ofdm.modulate(g, cell.n_prb)

        return self._stage(run, "pucch2_tx", sf_idx, res_rel, n_ack)

    @graphs.per_instance
    def pucch2_rx_all(self, sf_idx: int):
        """eNB: decode EVERY format-2 resource in one stage.  fn(rg) ->
        (cqi_bits (n,4), metric (n,), dmrs_energy (n,), ack_corr (n,2)).
        The channel comes from the FIRST DMRS symbol pair only, so the
        same decode serves plain f2 and f2a (whose second DMRS carries
        d(10)); ack_corr is <dmrs2, h> — its real-part sign is the 2a
        ACK bit, and for plain f2 it sits at +|h|^2 (reads as ACK, used
        only when one was expected)."""
        cell, dev, n, base = self.cell, self.device, self.n_f2_res, self.f2_base
        d_syms = pucch_mod.F2_DATA_SYMS
        l_dm1, l_dm2 = pucch_mod.F2_DMRS_SYMS

        def run(rg):
            pos, refc = _f2_tables(cell, n, base, sf_idx, dev)
            y = rg.reshape(1, -1, 2)[:, pos].reshape(n, 2, 7, 12, 2)
            z = cplx.mul(y, refc)  # ref removed
            h = z[:, :, l_dm1]  # (n, 2, 12, 2) per-slot channel
            energy = cplx.abs2(h).mean(dim=(-2, -1))  # (n,)
            # slot-major data symbol order matches encode_f2's di index
            parts = [cplx.mul_conj(z[:, s, l], h[:, s]).sum(dim=-2)
                     for s in range(2) for l in d_syms]
            d = torch.stack(parts, dim=1)  # (n, 10, 2)
            llr = modem.demod_soft(d / (torch.sqrt(cplx.abs2(d))[..., None] + 1e-9),
                                   modem.QPSK)
            bits, metric = uci_mod.decode_rm(llr, 4, "rm20")
            ack = sum(cplx.mul_conj(z[:, s, l_dm2], h[:, s]).sum(dim=-2)
                      for s in range(2))  # (n, 2)
            return bits, metric, energy, ack

        return self._stage(run, "pucch2_rx_all", sf_idx)

    @graphs.per_instance
    def pucch_rx_all(self, sf_idx: int):
        """eNB: matched-filter ALL format-1 resources in one stage.
        fn(rg (B, 14, NRE, 2)) -> (corr (B, N_RES, 2), energy (B, N_RES))."""
        cell, dev, n_res = self.cell, self.device, self.n_pucch_res

        def run(rg):
            idx, refc = _pucch_rx_tables(cell, n_res, sf_idx, dev)
            n_mf = refc.shape[1]
            B = rg.shape[0]
            y = rg.reshape(B, -1, 2)[:, idx].reshape(B, n_res, n_mf, 12, 2)
            corr = cplx.mul(y, refc[None]).sum(dim=(-3, -2)) / (12 * n_mf)
            return corr, cplx.abs2(corr)

        return self._stage(run, "pucch_rx_all", sf_idx)


class WaveEnbPhy:
    """eNB waveform PHY: UL decode then DL encode per TTI (sf_worker.cc)."""

    PUCCH_DETECT = 4.0  # matched-filter energy threshold vs noise
    # format-2 DMRS mean-|h|^2 presence threshold: pure noise sits near
    # 1.0 (per-RE, no despreading gain), any usable link far above
    F2_DETECT = 4.0

    def __init__(self, medium: "WaveMedium", cell: grid_mod.CellConfig,
                 mac, kern: _CellKernels, pcap=None, mimo: bool = False,
                 tdd_config: int = None, ss_config: int = 4):
        self.medium = medium
        self.cell = cell
        self.mac = mac
        self.k = kern
        self.mimo = mimo
        self.tdd = tdd_config
        self.ss = ss_config
        self._silence = None  # cached zero waveform for U subframes
        self.pcap = pcap  # utils.pcap.MacPcap: DL+UL TB wire images
        self._pending_ul = {}  # tti -> [(UlGrant, tbs)]
        # tti -> [(rnti, n_pucch)]: where each DL grant's HARQ-ACK will
        # arrive (36.213 §10.1: n_CCE + N1, recorded at DCI placement)
        self._ack_expect = {}
        self.metrics = {"prach_det": 0, "pusch_ok": 0, "pusch_crc": 0,
                        "pucch_det": 0, "dl_tx": 0}

    def run_tti(self, tti: int):
        self._rx(tti)
        getattr(self.mac, "tick", lambda: None)()
        self._tx(tti)

    # ---- uplink (previous TTI's superposed samples) ----
    def _rx(self, tti: int):
        rx = self.medium.ul_take()
        if rx is None:
            return
        samples, had_prach, prev_tti = rx
        sf = prev_tti % 10
        if self.tdd is not None and tdd_mod.sf_type(self.tdd, sf) != "U":
            return  # TDD: uplink arrives only on U subframes
        n_prb = self.cell.n_prb
        div = _srate_div(n_prb)
        prach_sf = 2 if self.tdd is not None else PRACH_SF
        if had_prach and sf == prach_sf:
            freq = prach_mod.rx_waveform_to_freq(
                samples[:, : prach_mod.waveform_len(0, div)],
                k0=PRACH_K0, srate_div=div)
            det, _, _ = prach_mod.detect(freq, 0, 1)
            for idx in np.nonzero(_host(det)[0])[0]:
                self.metrics["prach_det"] += 1
                self.mac.rach_detected(prev_tti, int(idx))
        rg = self.k.demodulate()(samples)  # one UL grid for every decoder
        for g, tbs in self._pending_ul.pop(prev_tti, ()):
            cqi_rep = None
            n_cqi = 0
            if getattr(g, "cqi_request", 0):
                n_cqi = 4 + 2 * uci_mod.cqi_hl_subband_size(n_prb)
            if n_cqi:
                bits, ok, cqi_bits = self.k.pusch_rx_cqi(g.l_prb, g.mcs, n_cqi)(
                    rg, g.rnti, g.rb_start, sf)
                cqi_rep = uci_mod.unpack_cqi_hl_subband(_host(cqi_bits)[0], n_prb)
            else:
                bits, ok = self.k.pusch_rx(g.l_prb, g.mcs)(rg, g.rnti, g.rb_start, sf)
            ok = bool(_host(ok)[0])
            if ok and cqi_rep is not None and hasattr(self.mac, "cqi_info"):
                # aperiodic HL-subband report -> frequency-selective
                # link adaptation (scheduler_ue.cc sb_cqi)
                self.mac.cqi_info(tti, g.rnti, cqi_rep["wideband_cqi"],
                                  sb=cqi_rep["subband_diff_cqi"])
            self.mac.ul_crc_info(tti, g.rnti, ok, rb_start=g.rb_start)
            if ok:
                payload = _unframe(_host(bits)[0])
                self.metrics["pusch_ok"] += 1
                if self.pcap is not None:
                    self.pcap.write_pdu(payload, g.rnti, prev_tti,
                                        is_dl=False)
                self.mac.ul_pdu(tti, g.rnti, payload, 20.0)
            else:
                self.metrics["pusch_crc"] += 1
        # PUCCH: ONE matched-filter tensor covers every resource; per-UE
        # adjudication is an array lookup.  HARQ-ACKs arrive on
        # n_CCE + N1 (recorded at DCI placement); a positive SR moves the
        # ACK onto the UE's dedicated SR resource (36.213 §10.1, the
        # ue_ul.c simultaneous SR+ACK rule).
        expect = self._ack_expect.pop(prev_tti, ())
        acked_f2 = set()
        # f32 OFDM roundoff leaks ~1e-3 of the TOTAL UL amplitude into
        # every RE: on very-high-SNR links (large UE amplitudes) the
        # leakage energy after despreading approaches the fixed detect
        # thresholds, so the floors scale with the received power
        p_tot = float(cplx.abs2(samples).mean())
        f2_thresh = max(self.F2_DETECT, 3e-5 * p_tot)
        if getattr(self.mac, "ues", None) and self.k.n_f2_res:
            # format-2 region: periodic CQI (+f2a HARQ bit) for every
            # resource in ONE call; per-UE adjudication by DMRS energy
            f2_bits, _, f2_energy, f2_ack = (
                _host(v) for v in self.k.pucch2_rx_all(sf)(rg))
            expect_rntis = {r for r, _ in expect}
            for rnti in list(self.mac.ues):
                sr_r = getattr(self.mac.ues[rnti], "sr_pucch_res", None)
                rel = None if sr_r is None else sr_r - self.k.n_cce
                if rel is None or not 0 <= rel < self.k.n_f2_res:
                    continue
                if f2_energy[rel] < f2_thresh:
                    continue
                val = int("".join(str(int(b)) for b in f2_bits[rel]), 2)
                if hasattr(self.mac, "cqi_info"):
                    if self.mimo and (prev_tti % WaveUePhy.RI_PERIOD
                                      ) < WaveUePhy.RI_WIN:
                        # RI reporting instance: the 4-bit field is the
                        # rank (WaveUePhy RI schedule, both ends by TTI)
                        self.mac.cqi_info(tti, rnti, None,
                                          ri=min(2, val + 1))
                    else:
                        self.mac.cqi_info(tti, rnti, val)
                self.metrics["pucch_det"] += 1
                if rnti in expect_rntis:
                    # format 2a: the HARQ bit rides the second DMRS
                    ack = bool(f2_ack[rel, 0] > 0)
                    acked_f2.add(rnti)
                    try:
                        self.mac.ack_info(tti, rnti, ack, cc=0)
                    except TypeError:
                        self.mac.ack_info(tti, rnti, ack)
        if getattr(self.mac, "ues", None):
            corr, energy = self.k.pucch_rx_all(sf)(rg)
            corr = _host(corr)[0]
            energy = _host(energy)[0]
            sr_hit = set()
            for rnti in list(self.mac.ues):
                sr_r = getattr(self.mac.ues[rnti], "sr_pucch_res", None)
                if sr_r is not None and sr_r < len(energy) \
                        and energy[sr_r] > self.PUCCH_DETECT:
                    sr_hit.add(rnti)
                    self.mac.sr_detected(tti, rnti)
            for rnti, res in expect:
                ue = self.mac.ues.get(rnti)
                if ue is None or rnti in acked_f2:
                    continue
                if rnti in sr_hit:  # ACK rode the SR resource
                    res = ue.sr_pucch_res
                elif not (res < len(energy)
                          and energy[res] > self.PUCCH_DETECT):
                    continue  # DTX: UE missed the DL grant entirely
                ack = bool(corr[res, 0] > 0)
                self.metrics["pucch_det"] += 1
                try:
                    self.mac.ack_info(tti, rnti, ack, cc=0)
                except TypeError:
                    self.mac.ack_info(tti, rnti, ack)

    def _next_u(self, tti: int) -> int:
        """First TTI > tti whose subframe is uplink (ACK arrival slot)."""
        for d in range(1, 11):
            if tdd_mod.sf_type(self.tdd, (tti + d) % 10) == "U":
                return tti + d
        raise AssertionError("TDD config without uplink subframes")

    # ---- downlink ----
    def _tx(self, tti: int):
        sf = tti % 10
        n_prb = self.cell.n_prb
        if self.tdd is not None and tdd_mod.sf_type(self.tdd, sf) == "U":
            # uplink subframe: the eNB radiates nothing (phy_adapter.cc
            # TDD gate); the medium still rotates on a silent waveform
            if self._silence is None:
                sf_len = ofdm.params(n_prb)["sf_len"]
                self._silence = torch.zeros((1, sf_len, 2), device=self.k.device)
            self.medium.dl_put(tti, self._silence)
            return
        sfn = (tti // 10) % 1024
        dl_grants = self.mac.get_dl_sched(tti)
        if self.tdd is not None and sf not in tdd_mod.UL_GRANT_K[self.tdd]:
            # DCI-0 only on subframes with a PUSCH k-association
            # (36.213 Table 8-2); others defer the UL scheduling pass
            ul_grants = []
        else:
            ul_grants = self.mac.get_ul_sched(tti)
        phich = self.mac.get_phich(tti)
        dw_sym = _dwpts(self.tdd, self.ss, sf)
        mib = np.zeros((1, 24), np.int8)
        with_pbch = sfn % 4 if sf == 0 else -1
        if sf == 0:
            mib = np.asarray(pbch_mod.pack_mib(n_prb, sfn))[None].astype(np.int8)
        grid = self.k.base_grid(sf, with_pbch)(mib)
        grid_p1 = self.k.base_grid_p1(sf) if self.mimo else None
        for g in dl_grants:
            prbs = [i for i, on in enumerate(g.prb_mask) if on]
            rb_start, l_crbs = prbs[0], len(prbs)
            if getattr(g, "tm", "1") == "tm3" and self.mimo:
                grid, grid_p1 = self._tx_tm3(tti, g, rb_start, l_crbs, grid,
                                             grid_p1)
                continue
            # honor the MAC's CQI-driven link adaptation (scheduler_ue.cc
            # MCS selection, fed by the waveform PUCCH format-2 reports):
            # its MCS rounded to even, floored at whatever fits the payload
            # + padding headers and capped at a legal code rate over the
            # grant's TRUE RE count
            re_idx = self.k.dl_re_idx(sf, rb_start, l_crbs, dw_sym)
            pref = min(g.mcs, 27) + 1
            sb = getattr(self.mac.ues.get(g.rnti),
                         "sb_cqi", None) if getattr(
                self.mac, "ues", None) else None
            if sb:
                # frequency-selective link adaptation: shift the MCS by
                # the worst subband differential of the ALLOCATED PRBs
                # (36.213 Table 7.2.1-2 offsets {0:+0, 1:+1, 2:+2, 3:-1};
                # scheduler_ue.cc sb_cqi role)
                k_sb = -(-n_prb // max(1, len(sb)))
                offs = [{0: 0, 1: 1, 2: 2, 3: -1}[sb[min(p // k_sb,
                                                         len(sb) - 1)]]
                        for p in range(rb_start, rb_start + l_crbs)]
                pref = max(0, min(28, pref + 2 * min(offs)))
            mcs = _dl_mcs_clamp(pref, len(g.payload),
                                l_crbs, len(re_idx))
            fn, tbs = self.k.add_dl_grant(l_crbs, mcs, g.l_aggr, len(re_idx))
            d = dci_mod.DciDl("1A", mcs=mcs, harq_pid=g.harq_pid & 7,
                              ndi=g.ndi & 1, rv=g.rv & 3,
                              rb_start=rb_start, l_crbs=l_crbs)
            bits = dci_mod.pack_dl(d, n_prb)[None]
            tb = _frame(g.payload, tbs)
            grid = fn(grid, bits, tb, g.rnti, g.cce_start, re_idx, sf)
            self.metrics["dl_tx"] += 1
            if g.rnti in getattr(self.mac, "ues", {}):
                # C-RNTI TB: its HARQ-ACK will arrive on n_CCE + N1, on
                # the next UPLINK subframe in TDD (bundled per 36.213)
                arr = tti if self.tdd is None else self._next_u(tti)
                self._ack_expect.setdefault(arr, []).append(
                    (g.rnti, N1_PUCCH + g.cce_start))
            if self.pcap is not None:
                self.pcap.write_pdu(np.packbits(tb[0]).tobytes(),
                                    g.rnti, tti, is_dl=True)
        for g in ul_grants:
            # the MAC's shared _CceAlloc already placed this DCI-0 on a
            # true search-space candidate, collision-free vs the DL DCIs.
            # Quantize link-adaptation MCS to even (see _dl_mcs_for) —
            # the UE reads the DCI, so both ends agree per grant
            g.mcs = min(g.mcs, 28) & ~1
            d = dci_mod.DciUl(mcs=min(g.mcs, 28), ndi=g.ndi & 1,
                              rb_start=g.rb_start, l_crbs=max(1, g.l_prb),
                              cqi_req=g.cqi_request & 1)
            bits = dci_mod.pack_ul(d, n_prb)[None]
            grid = self.k.add_ul_dci(sf, g.l_aggr)(grid, bits, g.rnti, g.cce_start)
            tbs = ra.ul_tbs(min(g.mcs, 28), max(1, g.l_prb))
            # TDD: the UE drains the grant queue on its next UPLINK
            # subframe, so that is where this PUSCH will arrive
            arr_ul = tti if self.tdd is None else self._next_u(tti)
            self._pending_ul.setdefault(arr_ul, []).append((g, tbs))
        if phich:
            ngrp = phich_mod.n_groups(n_prb)
            acks = np.zeros((1, ngrp, 8), np.float32)
            for ph in phich:
                # 36.213 §9.1.2: (n_group, n_seq) from the PUSCH's lowest
                # PRB (+ DMRS shift, 0 for DCI-0 without the field)
                gi, si = phich_mod.alloc(ph.get("rb_start", 0), 0, ngrp)
                acks[0, gi, si] = 1.0 if ph["ack"] else -1.0
            grid = self.k.add_phich(sf)(grid, acks)
        # prune ACK expectations never collected (UL never arrived)
        if len(self._ack_expect) > 16:
            self._ack_expect = {t: v for t, v in self._ack_expect.items()
                                if t >= tti - 8}
        if dw_sym:
            # special subframe: silence everything past DwPTS (GP/UpPTS
            # guard honored at IQ level, phy_common.c:90-163)
            grid = self.k.mask_dwpts(dw_sym)(grid)
            if self.mimo:
                grid_p1 = self.k.mask_dwpts(dw_sym)(grid_p1)
        if self.mimo:
            grid = torch.cat([grid, grid_p1], dim=0)  # (2 ports, ...)
        self.medium.dl_put(tti, self.k.modulate()(grid))

    def _tx_tm3(self, tti, g, rb_start, l_crbs, grid, grid_p1):
        """Rank-2 TM3 grant: DCI 2A (RA type 0 must express the PRB mask
        exactly: the scheduler aligns rank-2 allocations to RBG boundaries,
        asserted here) + both codewords."""
        sf = tti % 10
        n_prb = self.cell.n_prb
        p = ra.rbg_size(n_prb)
        n_rbg = -(-n_prb // p)
        bitmap = 0
        for gi in range(n_rbg):
            span = range(gi * p, min((gi + 1) * p, n_prb))
            if all(g.prb_mask[i] for i in span):
                bitmap |= 1 << (n_rbg - 1 - gi)
        assert ra.type0_to_prb_mask(bitmap, n_prb) == \
            tuple(g.prb_mask), "rank-2 allocation not RBG-aligned"
        n_re = grid_mod.nof_re(self.cell, sf,
                               ra.type2_to_prb_mask(rb_start, l_crbs, n_prb))
        mcs1 = _dl_mcs_clamp(min(g.mcs, 27) + 1, len(g.payload),
                             l_crbs, n_re)
        mcs2 = _dl_mcs_clamp(min(g.mcs2, 27) + 1, len(g.payload2),
                             l_crbs, n_re)
        d = dci_mod.DciDl2("2A", rbg_bitmap=bitmap,
                           harq_pid=g.harq_pid & 7, mcs1=mcs1,
                           ndi1=g.ndi & 1, rv1=g.rv & 3, mcs2=mcs2)
        bits = dci_mod.pack_dl_2(d, n_prb)[None]
        fn, (tbs1, tbs2) = self.k.add_dl_grant_tm3(sf, rb_start, l_crbs, mcs1, mcs2,
                                                   g.l_aggr)
        tb1 = _frame(g.payload, tbs1)
        tb2 = _frame(g.payload2, tbs2)
        grid, grid_p1 = fn(grid, grid_p1, bits, tb1, tb2, g.rnti, g.cce_start)
        self.metrics["dl_tx"] += 1
        self.metrics["tm3_tx"] = self.metrics.get("tm3_tx", 0) + 1
        if g.rnti in getattr(self.mac, "ues", {}):
            self._ack_expect.setdefault(tti, []).append(
                (g.rnti, N1_PUCCH + g.cce_start))
        if self.pcap is not None:
            for tb in (tb1, tb2):
                self.pcap.write_pdu(np.packbits(tb[0]).tobytes(), g.rnti,
                                    tti, is_dl=True)
        return grid, grid_p1


class WaveUePhy:
    """UE waveform PHY: sync state machine + per-TTI full receive chain
    (sync.cc:364-470 + cc_worker.cc), driving the unmodified UeStack.

    The UE keeps its OWN tti counter: CELL_SEARCH fixes the subframe
    phase from the SSS (sf 0 vs 5), SFN_SYNC reads the frame number from
    the decoded MIB (8 MSBs) + the PBCH segment offset (2 LSBs) — the
    sync.cc:408 SFN_SYNC role.  Nothing below trusts the network loop's tick."""

    RI_PERIOD = 40  # RI reporting instances: tti % 40 < 8 (36.213 §7.2.2)
    RI_WIN = 8

    def __init__(self, medium: "WaveMedium", cell: grid_mod.CellConfig,
                 stack, kern: _CellKernels, ue_idx: int, mimo: bool = False,
                 tdd_config: int = None, ss_config: int = 4):
        self.medium = medium
        self.cell = cell
        self.stack = stack
        self.k = kern
        self.ue_idx = ue_idx
        self.mimo = mimo
        self.tdd = tdd_config
        self.ss = ss_config
        self._ri = 1
        self._rg_mimo = None  # this TTI's (1, 2, 14, NRE, 2) for TM3
        self._ack_bundle = None  # spatially-bundled 2-codeword HARQ bit
        self.state = "CELL_SEARCH"
        self.tti = None  # known only after SFN_SYNC
        self._sf_local = None  # subframe phase, known after CELL_SEARCH
        self._ack_cce = None  # first CCE of this TTI's DL DCI (36.213 §10.1)
        self._phich_wait = None  # (n_group, n_seq) of the pending PHICH
        self.metrics = {"dci_hit": 0, "tb_ok": 0, "tb_err": 0,
                        "prach_tx": 0, "pusch_tx": 0, "pucch_tx": 0}
        if getattr(stack, "serving_pci", None) is None:
            stack.serving_pci = cell.cell_id

    def run_tti(self, tti_hint: int, samples=None, batch=None, search=None):
        """samples: this UE's (1, sf_len, 2) row (antenna 0's in MIMO mode);
        None takes the UE's own impaired DL from the medium (`dl_take`).
        batch: the network's shared per-TTI front-end products
        (rg/ce/snr/resid for ALL UEs, computed in one device call); None
        falls back to this UE's own front end (`_camp_rx`).  search: this
        UE's (quality, cell_id, sf_idx) row of the shared batched cell
        search; None searches `samples`.  tti_hint is the network loop's
        clock and is not read: protocol time is self.tti."""
        if samples is None:
            samples = self.medium.dl_take(self.ue_idx)
        if self.state == "CELL_SEARCH":
            self._cell_search(samples, search)
        else:
            self._sf_local = (self._sf_local + 1) % 10
            if self.tti is not None:
                self.tti += 1
            sft = (tdd_mod.sf_type(self.tdd, self._sf_local)
                   if self.tdd is not None else "D")
            if self.state == "SFN_SYNC":
                if self._sf_local == 0:
                    self._sfn_sync(samples)
            elif sft == "U":
                pass  # TDD uplink subframe: nothing to receive
            elif batch is not None:
                self._camp_rx_row(batch)
            else:
                self._camp_rx(samples)
        if getattr(self.stack, "tick", None) is not None:
            self.stack.tick()
        # TDD: the UE transmits only on uplink subframes
        if self.state == "CAMP" and (
                self.tdd is None or tdd_mod.sf_type(self.tdd, self.tti % 10) == "U"):
            self._tx()

    def _cell_search(self, samples, search=None):
        """PSS/SSS + CP detection (sync.cc CELL_SEARCH via ue_cell_search).
        The SSS hypothesis fixes the subframe phase (PSS rides sf 0 AND 5;
        only the SSS word differs), seeding the local subframe counter."""
        if search is None:
            q, cid, sfi = (_host(v)[0] for v in self.k.cell_search()(self._port0(samples)))
        else:
            q, cid, sfi = search
        if float(q) > 10.0 and int(cid) == self.cell.cell_id:
            self._sf_local = int(sfi)
            self.state = "SFN_SYNC"

    def _sfn_sync(self, samples):
        """PBCH decode fixes the SFN: 8 MSBs ride the MIB payload, the
        2 LSBs are the blind-decoded 40 ms segment offset
        (srsue/src/phy/sync.cc:408 SFN_SYNC)."""
        rg = self.k.demodulate()(self._port0(samples))
        mib, ports, off, ok = (_host(v) for v in self.k.pbch_rx()(rg))
        if bool(ok[0]):
            info = pbch_mod.unpack_mib(mib[0])
            sfn = ((info["sfn_msb"] << 2) | int(off[0])) % 1024
            self.tti = sfn * 10  # we are in subframe 0 of frame `sfn`
            self.stack.mib_received(self.tti, dict(
                num_prb=info["n_prb"], num_antennas=int(ports[0]),
                phich_resources=info.get("phich_res", "1"),
                phich_length=info.get("phich_dur", 0)))
            self.state = "CAMP"

    def _port0(self, samples):
        """Antenna 0's (1, sf_len, 2) row of a MIMO UE's own (2, sf_len, 2)
        samples, which sync and the PBCH read."""
        return samples[0:1] if self.mimo and samples.shape[0] == 2 else samples

    def _camp_rx(self, samples):
        """This UE's own front end and blind searches (no shared batch),
        then `_camp_rx_row` on its one-row batch."""
        sf = self.tti % 10
        if self.mimo:
            rg2, ce2, snr2, sb2 = self.k.rx_front(sf)(samples)
            self._rg_mimo = rg2[None]  # (1, 2, 14, NRE, 2)
            rg, ce, snr, sb = rg2[0:1], ce2[0:1], snr2[0:1], sb2[0:1]
        else:
            rg, ce, snr, sb = self.k.rx_front(sf)(samples)
        self.stack.last_sb_snr_db = _host(sb)[0]
        fn, positions = self.k.blind_all(sf)
        bits_dev, resid = fn(rg, ce)
        batch = dict(rg=rg, ce=ce, snr=_host(snr), resid=_host(resid),
                     bits_dev=bits_dev, bits=None, positions=positions, row=0)
        if self.mimo and getattr(self.stack, "crnti", None):
            fn2, positions2 = self.k.blind_all2(sf)
            bits2_dev, resid2 = fn2(rg, ce)
            batch.update(bits2_dev=bits2_dev, bits2=None, resid2=_host(resid2),
                         positions2=positions2)
        self._camp_rx_row(batch)

    def _camp_rx_row(self, batch):
        """Consume row `batch['row']` (else this UE's row) of the shared
        batched front-end (rg/ce/resid computed once for every UE)."""
        tti = self.tti
        sf = tti % 10
        row = batch.get("row", self.ue_idx)
        rg = batch["rg"]
        snr_db = float(batch["snr"][row])
        resid = batch["resid"][row]
        sync_cb = getattr(self.stack, "sync_indication", None)
        if sync_cb is not None:
            # Qout-style out-of-sync: the CRS chest's SNR estimate floors
            # near 0 dB on pure noise (rsrp ~= residual there), so the
            # in-sync threshold sits above it — the ~Qout point where
            # PDCCH BLER makes the link unusable (36.133 §7.6 role;
            # srsue/src/phy/sync.cc out-of-sync on SNR/PDCCH quality)
            sync_cb(tti, snr_db > 5.0, snr_db)
        pos_idx = {p: i for i, p in enumerate(batch["positions"])}
        rg_row = None
        done = set()
        while True:
            # processing a RAR can assign a C-RNTI mid-subframe whose
            # DCI-0 (msg3 grant) rides THIS subframe: the CCE space is
            # already decoded, so re-adjudicating the new RNTI is a host
            # integer compare — loop until the listen set stops growing
            todo = sorted(self.stack.listen_rntis(tti) - done)
            if not todo:
                break
            done.update(todo)
            for rnti in todo:
                hit_is = [i for c in
                          pdcch_mod.candidates(self.cell, rnti, sf)
                          if (i := pos_idx.get(c)) is not None
                          and resid[i] == rnti]
                if not hit_is:
                    continue
                if batch["bits"] is None:
                    # one host copy for the WHOLE batch, shared across UEs
                    batch["bits"] = _host(batch["bits_dev"])
                bits = batch["bits"][row]
                if rg_row is None:
                    rg_row = rg[row : row + 1]
                seen = set()
                for ci in hit_is:
                    key = bits[ci].tobytes()
                    if key in seen:
                        continue  # same DCI visible at nested aggregations
                    seen.add(key)
                    self.metrics["dci_hit"] += 1
                    self._handle_dci(rg_row, rnti, bits[ci], snr_db,
                                     batch["positions"][ci][1])
        # rank-2 grants ride DCI format 2A (a second blind-search length,
        # computed once for the whole network in mimo mode)
        crnti = getattr(self.stack, "crnti", None)
        if self.mimo and crnti is not None and "resid2" in batch:
            resid2 = batch["resid2"][row]
            pos_idx2 = {p: i for i, p in enumerate(batch["positions2"])}
            hit2 = [i for c in pdcch_mod.candidates(self.cell, crnti, sf)
                    if (i := pos_idx2.get(c)) is not None
                    and resid2[i] == crnti]
            if hit2:
                if batch["bits2"] is None:
                    batch["bits2"] = _host(batch["bits2_dev"])
                seen2 = set()
                for ci in hit2:
                    b = batch["bits2"][row][ci]
                    key = b.tobytes()
                    if key in seen2:
                        continue
                    seen2.add(key)
                    self.metrics["dci_hit"] += 1
                    self._handle_dci2(crnti, b, snr_db,
                                      batch["positions2"][ci][1])
        # PHICH (UL HARQ feedback) on the (n_group, n_seq) derived from
        # our last PUSCH's lowest PRB (36.213 §9.1.2)
        if self._phich_wait is not None and \
                getattr(self.stack, "crnti", None) and \
                getattr(self.stack, "_ul_harq_buf", None) is not None:
            gi, si = self._phich_wait
            ce = batch["ce"]
            ph = _host(self.k.phich_rx(sf)(rg[row : row + 1], ce[row : row + 1]))
            m = float(ph[0, gi, si])
            if abs(m) > 0.3:
                self.stack.harq_ack(tti, m > 0)
        self._phich_wait = None

    def _handle_dci(self, rg, rnti, bits, snr_db, cce_start):
        tti = self.tti
        if dci_mod.is_format0(bits):
            if rnti != getattr(self.stack, "crnti", None):
                return  # UL grants only address our C-RNTI
            u = dci_mod.unpack_ul(bits, self.cell.n_prb)
            if (u.l_crbs < 1 or u.rb_start + u.l_crbs > self.cell.n_prb
                    or not pusch_mod.valid_n_prb(u.l_crbs)):
                # CRC alias: an allocation no scheduler makes (the reference
                # has no such check and fails in pusch.encode)
                return
            from .phy_adapter import UlGrant

            self.stack.ul_grant(tti, UlGrant(
                rnti, u.rb_start, u.l_crbs,
                0 if u.mcs >= 29 else u.mcs, u.ndi,
                u.mcs - 28 if u.mcs >= 29 else 0,
                cqi_request=u.cqi_req))
            return
        d = dci_mod.unpack_dl(bits, self.cell.n_prb, "1A")
        if d.l_crbs < 1 or d.rb_start + d.l_crbs > self.cell.n_prb or d.mcs > 28:
            # CRC alias: impossible allocation, or an MCS without a TBS (the
            # eNB never sends 29-31; the reference fails in ra.dl_tbs there)
            return
        re_idx = self.k.dl_re_idx(tti % 10, d.rb_start, d.l_crbs,
                                  _dwpts(self.tdd, self.ss, tti % 10))
        payload_bits, ok = self.k.pdsch_rx(d.l_crbs, d.mcs, len(re_idx))(
            rg, rnti, re_idx, tti % 10)
        ok = bool(_host(ok)[0])
        payload = _unframe(_host(payload_bits)[0]) if ok else None
        self.metrics["tb_ok" if ok else "tb_err"] += 1
        if rnti == getattr(self.stack, "crnti", None):
            # this DCI's first CCE fixes the HARQ-ACK PUCCH resource
            self._ack_cce = cce_start
        try:
            self.stack.tb_decoded(tti, payload, snr_db, rnti=rnti)
        except TypeError:
            self.stack.tb_decoded(tti, payload, snr_db)

    def _handle_dci2(self, rnti, bits, snr_db, cce_start):
        """Rank-2 TM3 grant (DCI format 2A): decode both codewords from
        the 2-antenna grids; the HARQ-ACK is spatially bundled."""
        tti = self.tti
        d = dci_mod.unpack_dl_2(bits, self.cell.n_prb, "2A")
        mask = ra.type0_to_prb_mask(d.rbg_bitmap, self.cell.n_prb)
        prbs = [i for i, on in enumerate(mask) if on]
        if not prbs or prbs != list(range(prbs[0], prbs[0] + len(prbs))):
            return  # CRC alias: non-contiguous mask we never schedule
        if max(d.mcs1, d.mcs2) > 28:
            return  # CRC alias: an MCS without a TBS, as in _handle_dci
        if self._rg_mimo is None:
            return
        p1, p2, ok1, ok2 = self.k.pdsch_rx_tm3(tti % 10, prbs[0], len(prbs), d.mcs1,
                                               d.mcs2)(self._rg_mimo, rnti)
        ok1 = bool(_host(ok1)[0])
        ok2 = bool(_host(ok2)[0])
        self._ack_cce = cce_start
        self._ack_bundle = ok1 and ok2  # spatial HARQ-ACK bundling
        for ok, pl in ((ok1, p1), (ok2, p2)):
            self.metrics["tb_ok" if ok else "tb_err"] += 1
            payload = _unframe(_host(pl)[0]) if ok else None
            try:
                self.stack.tb_decoded(tti, payload, snr_db, rnti=rnti)
            except TypeError:
                self.stack.tb_decoded(tti, payload, snr_db)

    def _tx(self):
        tti = self.tti
        sf = tti % 10
        n_prb = self.cell.n_prb
        div = _srate_div(n_prb)
        sf_len = ofdm.params(n_prb)["sf_len"]
        out = None
        prach_idx = None
        prach_sf = 2 if self.tdd is not None else PRACH_SF
        if sf == prach_sf:
            # get_prach consumes the pending preamble and records the
            # occasion TTI (RA-RNTI epoch) — only probe ON the occasion
            prach_idx = self.stack.get_prach(tti)
            if prach_idx is not None:
                w = prach_mod.gen_waveform([prach_idx], 0, 1, k0=PRACH_K0,
                                           srate_div=div, device=self.k.device)
                out = torch.nn.functional.pad(w, (0, 0, 0, sf_len - w.shape[1]))
                self.metrics["prach_tx"] += 1
        for g, payload in self.stack.get_pusch(tti):
            cqi_bits = None
            if getattr(g, "cqi_request", 0) and hasattr(
                    self.stack, "aperiodic_cqi"):
                # DCI-0 CSI request: the aperiodic HL-subband report is
                # REAL UCI multiplexed on this PUSCH (cqi.c aperiodic,
                # sch.c UL-SCH UCI mux) — fed by the PHY's per-subband
                # SNR measurement (rx_front)
                rep = self.stack.aperiodic_cqi(n_prb)
                cqi_bits = np.asarray(uci_mod.pack_cqi_hl_subband(
                    rep["wideband_cqi"], rep["subband_diff_cqi"], n_prb))[None]
            if cqi_bits is None:
                fn, tbs = self.k.pusch_tx(g.l_prb, g.mcs)
            else:
                fn, tbs = self.k.pusch_tx_cqi(g.l_prb, g.mcs, cqi_bits.shape[-1])
            assert (len(payload) + 3) * 8 <= tbs, \
                f"MAC PDU {len(payload)}B cannot pad into TBS {tbs}"
            bits = _frame(payload, tbs)
            s = (fn(bits, g.rnti, g.rb_start, sf) if cqi_bits is None
                 else fn(bits, cqi_bits, g.rnti, g.rb_start, sf))
            out = s if out is None else out + s
            self.metrics["pusch_tx"] += 1
            # where the eNB will answer: 36.213 §9.1.2 from our lowest PRB
            self._phich_wait = phich_mod.alloc(
                g.rb_start, 0, phich_mod.n_groups(n_prb))
        # periodic RI probe + report instances (36.213 §7.2.2 role): the
        # wideband 2x2 singular-value ratio picks the transmission rank
        ri_window = self.mimo and (tti % self.RI_PERIOD) < self.RI_WIN
        if (self.mimo and self._rg_mimo is not None
                and tti % self.RI_PERIOD == 0):
            ratio, _ = self.k.ri_probe(sf)(self._rg_mimo)
            self._ri = 2 if float(ratio) > 0.3 else 1
        pucch = self.stack.get_pucch(tti)
        if pucch:
            acks = pucch.get("ack", [])
            if self.mimo and len(acks) >= 2:
                # spatial HARQ-ACK bundling: one bit for both codewords
                acks = [self._ack_bundle if self._ack_bundle is not None
                        else (acks[0] and acks[1])]
            elif self.tdd is not None and len(acks) >= 2:
                # TDD HARQ-ACK bundling: the D/S subframes since the
                # last U slot share one AND-bundled bit (36.213 §10.1)
                acks = [all(acks)]
            sr = bool(pucch.get("sr"))
            sr_res = getattr(self.stack, "sr_pucch_res", None)
            cqi = pucch.get("cqi")
            cqi_rel = (sr_res - self.k.n_cce
                       if sr_res is not None else None)
            if (cqi is not None and not sr and self.k.n_f2_res
                    and cqi_rel is not None
                    and 0 <= cqi_rel < self.k.n_f2_res):
                # periodic wideband CQI rides format 2 on the UE's
                # dedicated resource; a pending HARQ bit upgrades it to
                # format 2a (ACK on the second DMRS, 36.211 §5.4.2).
                # SR+CQI in one TTI: SR wins, the CQI is dropped
                # (36.213 §7.2.2 collision rule).  On RI instances the
                # 4-bit field carries the rank instead (both ends know
                # the reporting schedule from the TTI).
                rpt = (self._ri - 1) if ri_window else cqi
                cqi_bits = np.asarray(
                    [[(rpt >> (3 - i)) & 1 for i in range(4)]], np.int8)
                ab = None
                if acks:
                    ab = np.asarray([[0 if acks[0] else 1]], np.int8)
                    acks = []  # the ACK rides the f2a DMRS
                s = (self.k.pucch2_tx(sf, cqi_rel)(cqi_bits) if ab is None
                     else self.k.pucch2_tx(sf, cqi_rel, 1)(cqi_bits, ab))
                out = s if out is None else out + s
                self.metrics["pucch_tx"] += 1
            if acks:
                # positive SR moves the ACK onto the dedicated SR resource
                # (36.213 §10.1 simultaneous SR+HARQ rule); otherwise the
                # resource is n_CCE + N1 from the DL DCI we are acking
                if sr and sr_res is not None:
                    res = sr_res
                elif self._ack_cce is not None:
                    res = N1_PUCCH + self._ack_cce
                else:
                    res = None  # no DCI this TTI (SPS TBs carry no HARQ)
                if res is not None and res < self.k.n_pucch_res:
                    d0 = np.array([[1.0 if acks[0] else -1.0, 0.0]],
                                  np.float32)
                    s = self.k.pucch_tx(sf)(res, d0)
                    out = s if out is None else out + s
                    self.metrics["pucch_tx"] += 1
            elif sr and sr_res is not None and sr_res < self.k.n_pucch_res:
                d0 = np.array([[1.0, 0.0]], np.float32)
                s = self.k.pucch_tx(sf)(sr_res, d0)
                out = s if out is None else out + s
                self.metrics["pucch_tx"] += 1
        self._ack_cce = None
        self._ack_bundle = None
        if out is not None:
            self.medium.ul_put(tti, self.ue_idx, out,
                               is_prach=prach_idx is not None)


class WaveMedium:
    """Per-link pathloss + AWGN, optionally through a 36.101 Annex B.2
    tapped-delay-line fading profile (EPA/EVA/ETU, block fading per
    subframe, the role of the reference's `lib/src/phy/channel/fading.c`
    over its ZMQ path); UL superposes at the eNB with one TTI of latency
    (the eNB decodes TTI n-1's uplink while building TTI n).

    Every noise draw goes through `_randn` with one torch.Generator on the
    device, seeded from `seed` (the reference's PRNG key).  The fading's
    sinusoids are drawn anew every TTI (`fading.draw_phases`) from a
    generator seeded from (FADING_SEED, tti), as the reference draws them
    from fold_in(PRNGKey(77), tti): only the DL is faded."""

    def __init__(self, n_ues: int, pathloss_db, tx_power_dbm: float = 30.0,
                 ue_power_dbm: float = 23.0, noise_floor_dbm: float = -104.0,
                 seed: int = 0, fading_profile: str = None,
                 doppler_hz: float = 5.0, srate_hz: float = None,
                 dyn_delay: tuple = None, hst_fd_hz: float = None,
                 rlf: tuple = None, mimo_h=None, device="cuda"):
        """Dynamic impairments (the reference's channel plugin stack,
        lib/src/phy/channel/{delay,hst,rlf}.c over its ZMQ path):
        dyn_delay=(min_us, max_us, period_s) sweeps the path delay
        sinusoidally; hst_fd_hz enables the 36.101 B.3 high-speed-train
        Doppler trajectory; rlf=(period_s, outage_s) zeroes the signal
        during periodic outage windows (both directions — the UE loses
        sync, the eNB loses PUSCH).  Each is read at every TTI, so it may
        be set on the medium after construction."""
        self.n_ues = n_ues
        self.pathloss_db = np.asarray(pathloss_db, np.float32)
        self.tx_power_dbm = tx_power_dbm
        self.ue_power_dbm = ue_power_dbm
        self.noise_floor_dbm = noise_floor_dbm
        self.fading_profile = fading_profile
        self.doppler_hz = doppler_hz
        self.srate_hz = srate_hz
        self.dyn_delay = dyn_delay
        self.hst_fd_hz = hst_fd_hz
        self.rlf = rlf
        self.device = torch.device(device)
        # 2x2 MIMO downlink: per-UE channel matrices (n_ues, 2, 2, 2); the
        # eNB transmits 2 port waveforms, each UE receives y[a] = sum_p
        # H[a, p] x[p] + noise on 2 antennas (the role of lib/src/phy/mimo
        # + channel over the reference's ZMQ path)
        self.mimo_h = None
        if mimo_h is not None:
            assert fading_profile is None, "mimo + TDL fading not combined"
            h = np.asarray(mimo_h, np.complex64)
            assert h.shape == (n_ues, 2, 2), h.shape
            self.mimo_h = cplx.from_numpy(h, self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._fading_gen = torch.Generator(device=self.device)
        self._dl = None  # (tti, samples)
        self._ul_acc = None
        self._ul_meta = None  # (tti, had_prach)
        self._ul_ready = None

    def _noise(self, shape) -> torch.Tensor:
        return _randn(self._gen, shape, self.device) / np.sqrt(2.0)

    def _dl_amp(self) -> torch.Tensor:
        """(n_ues,) noise amplitude of each link against the unit-power DL."""
        snr_db = (self.tx_power_dbm - self.pathloss_db
                  - self.noise_floor_dbm)  # (n_ues,)
        return torch.from_numpy(np.asarray(10.0 ** (-snr_db / 20.0))).to(self.device)

    def _impair(self, x, tti: int):
        """Dynamic per-TTI impairments on a (B, T, 2) signal."""
        t_s = tti * 1e-3
        if self.dyn_delay is not None:
            mn, mx, period = self.dyn_delay
            d = fading_mod.dynamic_delay_samples(
                t_s, mn * 1e-6 * self.srate_hz, mx * 1e-6 * self.srate_hz,
                period)
            x = fading_mod.apply_delay_dyn(x, int(round(d)))
        if self.hst_fd_hz is not None:
            fd = float(fading_mod.hst_doppler_hz(t_s, self.hst_fd_hz))
            x = fading_mod.apply_cfo_dyn(x, fd, self.srate_hz)
        if self.in_outage(tti):
            x = x * 0.0
        return x

    def in_outage(self, tti: int) -> bool:
        if self.rlf is None:
            return False
        period, outage = self.rlf
        return (tti * 1e-3 % period) < outage

    # eNB -> UEs
    def dl_put(self, tti: int, samples):
        self._dl = (tti, samples)
        # rotate UL: what UEs sent last TTI becomes available to the eNB
        self._ul_ready = (self._ul_acc, self._ul_meta)
        self._ul_acc = None
        self._ul_meta = None

    def dl_take_all(self):
        """(n_ues, sf_len, 2): every UE's receive samples in ONE batch —
        one noise draw, per-link amplitudes broadcast down the batch
        axis.  The whole network's downlink front-end then runs as a
        single call per TTI.  MIMO mode: tx is the (2, T, 2) port pair
        and the return is (n_ues, 2_rx, T, 2) through each link's 2x2
        matrix (no fading or impairment, as in the reference)."""
        tti, tx = self._dl
        if self.mimo_h is not None:
            # y[u, a] = sum_p h[u, a, p] * x[p]
            y = cplx.mul(self.mimo_h[:, :, :, None, :], tx[None, None]).sum(2)
            return y + self._dl_amp()[:, None, None, None] * self._noise(tuple(y.shape))
        if self.fading_profile is not None:
            x = tx.expand((self.n_ues,) + tuple(tx.shape[1:]))
            self._fading_gen.manual_seed((FADING_SEED << 32) + tti)
            tx, _ = fading_mod.apply_fading(
                x, self._fading_gen, self.fading_profile, self.srate_hz,
                doppler_hz=self.doppler_hz, sf_time_s=tti * 1e-3)
        tx = self._impair(tx, tti)
        noise = self._noise((self.n_ues,) + tuple(tx.shape[-2:]))
        return tx + self._dl_amp()[:, None, None] * noise

    def dl_take(self, ue_idx: int):
        """One UE's impaired DL samples, noise scaled to its link SNR (no
        fading and no MIMO channel, as in the reference's per-UE path)."""
        tti, tx = self._dl
        tx = self._impair(tx, tti)
        snr_db = (self.tx_power_dbm - float(self.pathloss_db[ue_idx])
                  - self.noise_floor_dbm)
        # unit-power signal + noise scaled for the link SNR
        noise_amp = 10.0 ** (-snr_db / 20.0)
        return tx + noise_amp * _randn(self._gen, tuple(tx.shape), self.device) / np.sqrt(2.0)

    # UEs -> eNB
    def ul_put(self, tti: int, ue_idx: int, samples, is_prach: bool = False):
        snr_db = (self.ue_power_dbm - float(self.pathloss_db[ue_idx])
                  - self.noise_floor_dbm)
        amp = 10.0 ** (snr_db / 20.0)
        s = samples * amp
        self._ul_acc = s if self._ul_acc is None else self._ul_acc + s
        self._ul_meta = (tti, (self._ul_meta or (tti, False))[1] or is_prach)

    def ul_take(self):
        if self._ul_ready is None or self._ul_ready[0] is None:
            return None
        acc, (tti, had_prach) = self._ul_ready
        self._ul_ready = None
        if self.in_outage(tti):
            acc = acc * 0.0  # outage is reciprocal: the eNB hears nothing
        return acc + self._noise(acc.shape), had_prach, tti


class WaveformNetwork:
    """One eNB + N UEs, everything over waveforms.  run(n_ttis) drives the
    TTI loop; the eNB transmits first each TTI (UEs see tti's DL, their UL
    reaches the eNB at tti+1 — the 1-TTI turnaround of txrx.cc).

    start_tti seeds the eNB's frame counter only: UEs derive their own
    timing from SSS + MIB (SFN_SYNC), so a nonzero start proves nothing
    leaks through the loop's tick.  pcap (a utils.pcap.MacPcap) captures
    every decoded TB's wire image at the eNB, both directions.

    Runs on `device`, the card by default; pass device="cpu" for the CPU.
    On the card every `_CellKernels` stage is a replayed CUDA graph;
    jit=False runs them eagerly instead (their plain version, bit for bit
    the same), as `waveblock_dyn.make_dyn_block_step(jit=)` does."""

    def __init__(self, enb_mac, ue_stacks, pathloss_db, n_prb: int = 6,
                 cell_id: int = 1, seed: int = 0, cfi: int = 2,
                 fading_profile: str = None, doppler_hz: float = 5.0,
                 start_tti: int = 0, pcap=None, dyn_delay: tuple = None,
                 hst_fd_hz: float = None, rlf: tuple = None,
                 mimo: bool = False, mimo_cond=None,
                 tdd_config: int = None, ss_config: int = 4, device="cuda",
                 jit: bool = True):
        """mimo=True: 2x2 downlink spatial multiplexing (TM3) — the eNB
        transmits two port waveforms (control stays on port 0), each UE
        receives through its own 2x2 matrix on 2 antennas, reports RI,
        and rank-2 grants carry two codewords on DCI format 2A.
        mimo_cond: per-UE singular-value ratio sigma2/sigma1 of the link
        matrix (1.0 well-conditioned, ~0 rank-deficient -> RI falls back
        to 1); default 1.0 everywhere."""
        self.device = resolve(device, "WaveformNetwork")
        self.mimo = mimo
        self.cell = grid_mod.CellConfig(n_prb=n_prb, cell_id=cell_id, cfi=cfi,
                                        n_ports=2 if mimo else 1)
        # the waveform grid runs at ONE cfi, so the MAC's CCE search
        # spaces must be computed at the same one: pin it (message mode
        # instead escalates CFI with demand, enb_stack.get_dl_sched)
        assert enb_mac.n_prb == n_prb, "MAC/PHY bandwidth mismatch"
        enb_mac.fixed_cfi = cfi
        # capacity-aware grant sizing: the scheduler bounds TBs by the
        # subframe's true RE count (enb_stack._dl_cap_bytes)
        enb_mac.phy_cell = self.cell
        self.tdd = tdd_config
        if tdd_config is not None:
            # DwPTS-truncated capacity for special subframes; a chest
            # with all four pilot symbols needs DwPTS >= 12 (ss 4)
            assert tdd_mod.nof_dw(ss_config) >= 12, \
                "waveform TDD supports special-subframe configs with " \
                "DwPTS covering the pilot symbols (ss_config 4)"
            enb_mac.phy_max_sym = {
                s: tdd_mod.nof_dw(ss_config) for s in range(10)
                if tdd_mod.sf_type(tdd_config, s) == "S"}
            enb_mac.tdd_config = tdd_config
        # PUCCH format-1 region: [0, n_cce) dynamic HARQ-ACK (36.213
        # §10.1, N1=0 as broadcast in SIB2), then the dedicated SR pool.
        # Edge PRB pairs carrying the region are reserved from PUSCH.
        n_cce = pdcch_mod.n_cce(self.cell)
        sr_pool = max(4, len(ue_stacks))
        n_edge = -(-(n_cce + sr_pool) // 36)  # PRB pairs (36 res per PRB)
        max_edge = max(1, (n_prb - 4) // 2)  # keep >=4 PRBs for msg3
        if n_edge > max_edge:
            n_edge = max_edge
            sr_pool = max(4, 36 * n_edge - n_cce)
        # format-2 CQI region above the format-1 space (one resource per
        # UE, keyed by the same dedicated index); needs its own edge PRB
        # pair, so only on cells wide enough to still fit msg3
        f2_base = 36 * n_edge
        n_f2 = sr_pool if n_prb >= 15 else 0
        if n_f2:
            n_edge = -(-(f2_base + n_f2) // 36)
        self.kern = _CellKernels(self.cell, n_pucch_res=n_cce + sr_pool,
                                 n_f2_res=n_f2, f2_base=f2_base,
                                 n_cce=n_cce, device=self.device, jit=jit)
        if hasattr(enb_mac, "sr_res_base"):
            enb_mac.sr_res_base = n_cce
            enb_mac.sr_res_pool = sr_pool
            enb_mac.ul_prb_lo = n_edge
            enb_mac.ul_prb_hi = n_prb - n_edge
        mimo_h = None
        if mimo:
            enb_mac.mimo = True
            rng = np.random.default_rng(seed + 13)
            n = len(ue_stacks)
            cond = np.ones(n) if mimo_cond is None \
                else np.asarray(mimo_cond, np.float64)
            mimo_h = np.zeros((n, 2, 2), np.complex64)
            for u in range(n):
                # H = U diag(1, cond) V*: random unitaries, controlled
                # singular-value ratio, Frobenius norm fixed at 2 so the
                # per-element mean gain stays ~1 (SNR bookkeeping intact)
                a = (rng.normal(size=(2, 2))
                     + 1j * rng.normal(size=(2, 2)))
                uq, _ = np.linalg.qr(a)
                b = (rng.normal(size=(2, 2))
                     + 1j * rng.normal(size=(2, 2)))
                vq, _ = np.linalg.qr(b)
                s = np.array([1.0, cond[u]])
                s *= np.sqrt(2.0 / (s ** 2).sum())
                mimo_h[u] = (uq * s) @ vq.conj().T
        self.medium = WaveMedium(
            len(ue_stacks), pathloss_db, seed=seed,
            fading_profile=fading_profile, doppler_hz=doppler_hz,
            srate_hz=ofdm.params(n_prb)["sf_len"] * 1e3,
            dyn_delay=dyn_delay, hst_fd_hz=hst_fd_hz, rlf=rlf,
            mimo_h=mimo_h, device=self.device)
        self.enb = WaveEnbPhy(self.medium, self.cell, enb_mac, self.kern,
                              pcap=pcap, mimo=mimo, tdd_config=tdd_config,
                              ss_config=ss_config)
        self.ues = [WaveUePhy(self.medium, self.cell, st, self.kern, i,
                              mimo=mimo, tdd_config=tdd_config,
                              ss_config=ss_config)
                    for i, st in enumerate(ue_stacks)]
        self.tti = start_tti

    def run(self, n_ttis: int):
        for _ in range(n_ttis):
            self.enb.run_tti(self.tti)
            sf = self.tti % 10
            # ONE noise draw and ONE front-end/blind-search call for the
            # whole UE population: the batch axis replaces the per-UE
            # receive loop
            samples = self.medium.dl_take_all()
            n = len(self.ues)
            batch = None
            search = None
            if any(ue.state == "CAMP" for ue in self.ues):
                if self.mimo:
                    # (n, 2, T, 2): both antennas ride the front-end batch;
                    # control decodes use the antenna-0 rows, TM3 uses both
                    flat = samples.reshape((2 * n,) + tuple(samples.shape[2:]))
                    rg2, ce2, snr2, sb2 = self.kern.rx_front(sf)(flat)
                    rg_mimo = rg2.reshape((n, 2) + tuple(rg2.shape[1:]))
                    rg, ce, snr, sb = rg2[0::2], ce2[0::2], snr2[0::2], sb2[0::2]
                else:
                    rg, ce, snr, sb = self.kern.rx_front(sf)(samples)
                fn, positions = self.kern.blind_all(sf)
                bits_dev, resid = fn(rg, ce)
                batch = dict(rg=rg, ce=ce, snr=_host(snr), resid=_host(resid),
                             bits_dev=bits_dev, bits=None, positions=positions,
                             sb=_host(sb))
                if self.mimo and any(getattr(u.stack, "crnti", None)
                                     for u in self.ues):
                    fn2, positions2 = self.kern.blind_all2(sf)
                    bits2_dev, resid2 = fn2(rg, ce)
                    batch.update(bits2_dev=bits2_dev, bits2=None,
                                 resid2=_host(resid2), positions2=positions2)
            if any(ue.state == "CELL_SEARCH" for ue in self.ues):
                # one batched PSS/SSS search for every still-searching UE
                ss = samples[:, 0] if self.mimo else samples
                search = tuple(_host(v) for v in self.kern.cell_search()(ss))
            for i, ue in enumerate(self.ues):
                if batch is not None:
                    ue.stack.last_sb_snr_db = batch["sb"][i]
                    if self.mimo:
                        ue._rg_mimo = rg_mimo[i : i + 1]
                srow = None
                if search is not None and ue.state == "CELL_SEARCH":
                    srow = (search[0][i], search[1][i], search[2][i])
                # the UEs share `batch`: the first that needs the DCI bits
                # on the host copies them for all
                ue.run_tti(self.tti, samples[i, 0:1] if self.mimo else samples[i : i + 1],
                           batch, srow)
            self.tti += 1
