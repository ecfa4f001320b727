"""eNB stack: MAC (LC mux + scheduler) / RLC / PDCP / RRC / S1AP / GTP-U.

Reference behavior: `srsenb/src/stack/` — enb_stack_lte.cc wiring, mac/ with
the RR scheduler, rrc/rrc.cc per-UE state machines (setup, security mode,
capability, reconfiguration with DRB+GTP TEIDs), upper/{s1ap.cc,gtpu.cc}.
Message-level PHY coupling via runtime/phy_adapter (the -emane build's path).
"""

from __future__ import annotations

import collections
import functools
import struct

from ..epc import spgw as spgw_mod
from ..phch import grid as grid_mod, pdcch as pdcch_mod, ra
from ..runtime.phy_adapter import DlGrant, UlGrant
from . import (cb, codec, nas_wire, pdcp as pdcp_mod, pdu,
               rlc as rlc_mod, rrc_msgs, rrc_wire, security, x2_msgs)
from ..epc import mme as mme_mod

SRB0, SRB1, SRB2 = 0, 1, 2
DRB1_LCID = 3
TB_BYTES = 1500  # per-TTI transport block budget at message level
N_HARQ_PROC = 8  # DL HARQ processes per UE (36.213 FDD)
PF_ALPHA = 0.01  # proportional-fair throughput EWMA coefficient


class _CceAlloc:
    """One TTI's PDCCH CCE allocation over the true 36.213 search spaces
    (scheduler_grid.cc alloc_dci role): every DCI gets a candidate from its
    RNTI's own search space whose CCEs collide with no earlier DCI; grants
    that cannot be placed are deferred to a later TTI."""

    def __init__(self, cell, sf_idx: int):
        self.cell = cell
        self.sf = sf_idx
        self.n_cce = pdcch_mod.n_cce(cell)
        self.used = set()

    def _try(self, cands, l_pref):
        cands = sorted(cands, key=lambda c: (c[0] != l_pref,
                                             abs(c[0] - l_pref)))
        for l, start in cands:
            cces = set(range(start, start + l))
            if not (cces & self.used):
                self.used |= cces
                return (l, start)
        return None

    def alloc(self, rnti: int, l_pref: int = 1):
        return self._try(pdcch_mod.candidates(self.cell, rnti, self.sf),
                         l_pref)

    def alloc_common(self, l_pref: int = 4):
        """Common search space only (SI/RAR/paging: L=4/8, first 16 CCEs)."""
        cands = [(l, m * l) for l, n in ((4, 4), (8, 2))
                 for m in range(n) if (m + 1) * l <= self.n_cce]
        return self._try(cands, l_pref)


@functools.lru_cache(maxsize=None)
def _dl_cap_bytes_cached(cell, sf: int, n_prb_alloc: int,
                         max_sym: int = 0) -> int:
    n_re = grid_mod.worst_nof_re(cell, sf, n_prb_alloc, max_sym)
    best = 8
    for mcs in list(range(0, 29, 2)) + [27]:
        tbs = ra.dl_tbs(mcs, n_prb_alloc)
        if tbs + 24 <= 0.93 * n_re * ra.dl_mcs_to_qm(mcs):
            best = max(best, tbs // 8 - 4)
    return best


def _l_aggr_pref(mcs: int) -> int:
    """Aggregation level from link quality (the reference maps CQI -> L in
    sched_ue.cc): robust MCS -> wide DCI."""
    if mcs == 0:
        return 8
    if mcs < 7:
        return 4
    if mcs < 15:
        return 2
    return 1


class _CcHarq:
    """Per-component-carrier DL HARQ entity (dl_harq.cc has one per cc)."""

    def __init__(self):
        self.dl_harq = {}
        self.harq_fifo = collections.deque()
        self.harq_retx_q = collections.deque()
        self.harq_tx_tti = {}


class UeContext:
    def __init__(self, rnti, stack, birth_tti=0):
        self.rnti = rnti
        self.stack = stack
        self.birth_tti = birth_tti
        self.enb_ue_id = rnti
        self.mme_ue_id = None
        self.state = "RRC_IDLE"
        self.kenb = None
        self.teid_spgw = None  # TEID for UL toward SPGW
        self.teid_enb = None  # our RX TEID
        self.eps_bearer = None
        self.rlc = {}
        self.pdcp = {}
        # DL HARQ: 8 explicit processes (dl_harq.cc). pid -> (payload, n_prb,
        # mcs, rv); in-flight order tracked FIFO (synchronous ACK timing means
        # PUCCH ACKs arrive in TX order at message level).
        self.dl_harq = {}
        self.harq_fifo = collections.deque()
        self.harq_retx_q = collections.deque()
        self.harq_tx_tti = {}  # pid -> last tx tti (DTX detection)
        self.avg_thr = 1.0  # bits/TTI EWMA for proportional-fair
        # carrier aggregation (srsenb rrc.cc SCell config + mac.cc CE):
        # scell_idx -> cc; activation state; per-SCell HARQ entities
        self.scells_cfg = {}
        self.scells_ready = False  # UE confirmed the SCell reconfiguration
        self.scells_act = set()
        self.scell_act_pending = set()
        self.scell_harq = {}  # cc -> _CcHarq
        self._setup_srb(SRB1)

    def _setup_srb(self, lcid):
        self.rlc[lcid] = rlc_mod.RlcAm(
            deliver=cb.Cb(self.stack, "_rx_pdcp", self, lcid))
        self.pdcp[lcid] = pdcp_mod.PdcpEntity(
            deliver=cb.Cb(self.stack, "_rx_rrc", self, lcid),
            is_srb=True, bearer_id=lcid, is_ue=False)

    def setup_drb(self, lcid, mode="am"):
        cls = rlc_mod.RlcAm if mode == "am" else rlc_mod.RlcUm
        self.rlc[lcid] = cls(
            deliver=cb.Cb(self.stack, "_rx_pdcp", self, lcid))
        self.pdcp[lcid] = pdcp_mod.PdcpEntity(
            deliver=cb.Cb(self.stack, "_ul_user_data", self),
            is_srb=False, bearer_id=lcid,
            ciph_algo=security.EEA2 if self.kenb else security.EEA0,
            k_enc=security.kdf_rrc_up_key(self.kenb, security.EEA2, 0x05)
            if self.kenb else b"\x00" * 16,
            is_ue=False)

    def send_rrc(self, lcid, msg):
        if lcid == SRB0:
            # DL-CCCH + the 36.321 Contention Resolution Identity CE
            # echoing the UE's Msg3 UL-CCCH SDU prefix
            self.stack.ccch_dl.append(
                (self.rnti, rrc_wire.encode_dl_ccch(msg),
                 getattr(self, "msg3_prefix", None)))
        else:
            data = rrc_wire.encode_dl_dcch(msg)
            self.rlc[lcid].write_sdu(self.pdcp[lcid].write_sdu(data))
            self.stack._dl_hint.add(self.rnti)


class EnbStack:
    """The enb_stack_lte.cc equivalent; exposes the FAPI-like MAC interface
    toward runtime.phy_adapter.EnbPhyAdapter."""

    def __init__(self, mme: mme_mod.Mme, enb_id: int = 1, n_prb: int = 25,
                 mcs: int = 9, pci: int = 1, sched_policy: str = "rr",
                 n_carriers: int = 1, scell_pcis: tuple = (),
                 plmn: int = 1):
        assert sched_policy in ("rr", "pf")
        self.sched_policy = sched_policy
        # broadcast in SIB1 (UE PLMN selection, 36.304); the simplified
        # int rides the SIB1 MNC digits, so only 0..99 encode faithfully
        assert 0 <= plmn <= 99, f"plmn {plmn} does not fit the MNC digits"
        self.plmn = plmn
        self.enb_id = enb_id
        self.cell_pci = pci
        self.n_prb = n_prb
        # carrier aggregation: cc index 1..n-1 are SCells, each its own
        # (PCI, carrier) — srsue/src/phy/scell/scell_recv.cc's view
        self.n_carriers = n_carriers
        self.scell_pcis = tuple(scell_pcis) or tuple(
            (pci + 100 * cc) % 504 for cc in range(1, n_carriers))
        self.mcs = mcs
        self.mme = mme
        self.ues = {}
        self.next_rnti = 0x46 + 0x100 * enb_id
        self.rar_pending = []
        # RACH-overload level: raised by drops at a full RAR queue, decayed
        # each scheduling pass; maps to the RAR Backoff Indicator index
        self._ra_congestion = 0
        self.ccch_dl = collections.deque()
        self.phich_queue = []
        self.by_teid = {}
        # X2 (x2ap role): direct neighbor eNBs by PCI + DL forwarding tunnels
        self.x2_neighbors = {}
        self.by_fwd_teid = {}
        self._next_fwd_teid = 0x8000_0000 + enb_id * 0x1000
        self.dedicated_preambles = {}  # preamble -> rnti (contention-free HO)
        self._next_ded_preamble = 60
        # measurement parameters pushed to UEs in their first
        # reconfiguration (36.331 measConfig reportConfigEUTRA; the flat
        # fields are the legacy single-A3 shorthand, .reports carries
        # multi-event configs)
        self.meas_config = rrc_msgs.MeasConfig()
        # reportConfig pushed when a UE reports A2 (serving degraded):
        # rrc.cc's "A2 -> configure neighbour/inter-freq measurement" step.
        # None disables the follow-up.
        self.a2_followup = None
        self._rr = 0
        self._page_buf = {}  # teid -> DL packets buffered while UE idle
        self.metrics = collections.Counter()
        # event-driven scheduler hints: rntis that MAY have DL data (every
        # RLC write adds one; get_dl_sched filters by actual has_data and
        # a low-rate full rescan bounds any missed-site starvation)
        self._dl_hint = set()
        # same idea for the UL: only rntis with msg3/SR/BSR/retx state are
        # visited by get_ul_sched (O(active), not O(UEs), per TTI)
        self._ul_hint = set()
        # and for DL HARQ: only rntis with in-flight processes (harq_fifo /
        # harq_retx_q non-empty) are visited by the per-TTI DTX-expiry and
        # retransmission scans
        self._harq_hint = set()
        # rntis whose RLC entities may hold timer state (rx state or
        # unacked AM data): the only UEs tick() visits per TTI
        self._tick_set = set()
        # eMBMS (rrc.cc SIB13/MCCH + MAC PMCH scheduling role):
        # service_id -> lcid, announced by M2AP Session Start; the M1-U
        # sink (epc.mbms_gw.enb_pmch_sink) fills mbms_queue with
        # (area_id, ip_packet) for MTCH transmission on MBSFN subframes
        self.mbms_sessions = {}
        self.mbms_area_id = 1
        self.mbms_queue = []
        # SIB3 reselection hysteresis broadcast to idle UEs (36.304 Qhyst)
        self.q_hyst_db = 2
        # admission control: None = unlimited; else RRCConnectionReject
        # once this many RRC_CONNECTED users exist (rrc.cc max_users)
        self.max_rrc_users = None
        # waveform mode pins the control region: the PHY grid is compiled
        # at one CFI, so the CCE search spaces the allocator draws from
        # must use the same CFI (message mode keeps demand escalation)
        self.fixed_cfi = None
        # PUCCH region reservation (waveform mode): UL PRBs [lo, hi) are
        # schedulable for PUSCH; the edge PRBs outside carry PUCCH
        # (sched.cc reserves the same region via pucch_cfg)
        self.ul_prb_lo = 0
        self.ul_prb_hi = n_prb
        # dedicated SR resource pool (36.213 §10.1 N_pucch_sr region):
        # waveform mode sets base = n_cce so SR sits above the dynamic
        # ACK region n_pucch = n_cce_start + N1 (N1=0, the SIB2 value)
        self.sr_res_base = 0
        self.sr_res_pool = 2048
        self._sr_ctr = 0
        mme.s1_setup(enb_id, self)

    @staticmethod
    def _ul_prb_fit(l_prb: int) -> int:
        """Largest transform-precodable PRB count <= l_prb (2^a 3^b 5^c,
        dft_precoding.c srslte_dft_precoding_valid_prb — the scheduler
        only hands out DFT-sized UL allocations, sched.cc)."""
        from ..phch.pusch import valid_n_prb

        while l_prb > 0 and not valid_n_prb(l_prb):
            l_prb -= 1
        return l_prb

    def _alloc_sr_res(self, ue) -> int:
        """Assign (or return) the UE's dedicated sr-PUCCH-ResourceIndex."""
        if getattr(ue, "sr_pucch_res", None) is None:
            ue.sr_pucch_res = self.sr_res_base + self._sr_ctr % self.sr_res_pool
            self._sr_ctr += 1
        return ue.sr_pucch_res

    # ================= MAC interface (stack_interface_phy_lte) =================
    RAR_QUEUE_MAX = 16  # PRACH detector capacity per RAR window

    def rach_detected(self, tti, preamble):
        if preamble in self.dedicated_preambles:
            # contention-free RA of an incoming handover UE
            rnti = self.dedicated_preambles.pop(preamble)
            self.rar_pending.append((tti, preamble, rnti))
            self.metrics["rach_ho"] += 1
            return
        if len(self.rar_pending) >= self.RAR_QUEUE_MAX:
            # congestion valve (36.321 §7.2): excess detections are dropped
            # (a saturated detector cannot answer them inside the response
            # window anyway) and subsequent RARs carry a Backoff Indicator
            # sized to the overload so the herd spreads out instead of
            # re-colliding every response window
            self.metrics["rach_drop"] += 1
            self._ra_congestion = min(200, self._ra_congestion + 2)
            return
        rnti = self.next_rnti
        self.next_rnti += 1
        self.ues[rnti] = UeContext(rnti, self, tti)
        self.rar_pending.append((tti, preamble, rnti))
        self.metrics["rach"] += 1

    def sr_detected(self, tti, rnti):
        if rnti in self.ues:
            self.ues[rnti].sr = True
            self._ul_hint.add(rnti)

    LINK_FAILURE_NOF_ERR = 50  # expert.link_failure_nof_err (srsenb main.cc:146)

    # UL outer-loop link adaptation (scheduler_ue.cc OLLA): converge on a
    # ~10% PUSCH BLER target — each CRC failure steps the offset down hard,
    # each success nudges it up
    OLLA_UP, OLLA_DOWN = 0.1, 1.0

    def ul_crc_info(self, tti, rnti, ok, rb_start=0):
        # rb_start = the decoded PUSCH's lowest PRB: the 36.213 §9.1.2
        # PHICH (n_group, n_seq) mapping derives from it (phich.c:131-134)
        self.phich_queue.append(dict(rnti=rnti, ack=ok, rb_start=rb_start))
        # eNB-side radio-link failure: N consecutive PUSCH CRC failures ->
        # release the UE context (rl_failure, enb_interfaces.h:95)
        ue = self.ues.get(rnti)
        if ue is None:
            return
        ue.ul_olla = max(-float(self.mcs), min(
            8.0, getattr(ue, "ul_olla", 0.0)
            + (self.OLLA_UP if ok else -self.OLLA_DOWN)))
        # eNB-side UL HARQ entity (scheduler_harq.cc): CRC failure schedules
        # an adaptive retransmission grant; 4 attempts then drop
        ent = getattr(ue, "ul_harq_ent", None)
        if ent is not None:
            if ok:
                ue.ul_harq_ent = None
            elif ent["n_tx"] >= 4:
                ue.ul_harq_ent = None
                self.metrics["ul_harq_drop"] += 1
            else:
                ent["retx_due"] = True
                self._ul_hint.add(rnti)
        if ok:
            ue.ul_err_streak = 0
        else:
            ue.ul_err_streak = getattr(ue, "ul_err_streak", 0) + 1
            if ue.ul_err_streak >= self.LINK_FAILURE_NOF_ERR:
                ue.ul_err_streak = 0
                self.metrics["rl_failure"] += 1
                self.release_ue(rnti, cause="rl-failure")

    def ack_info(self, tti, rnti, ack, cc: int = 0):
        self.metrics["dl_ack" if ack else "dl_nack"] += 1
        ue = self.ues.get(rnti)
        if ue is None:
            return
        h = ue if cc == 0 else ue.scell_harq.get(cc)
        if h is None or not h.harq_fifo:
            return
        # MAC HARQ (scheduler_harq.cc / dl_harq.cc): ACKs pop the oldest
        # in-flight process; NACK queues that process for retransmission.
        pid = h.harq_fifo.popleft()
        if ack:
            h.dl_harq.pop(pid, None)
        elif pid in h.dl_harq:
            payload, n_prb, mcs, n_tx = h.dl_harq[pid]
            if n_tx >= 4:  # max 4 transmissions, then drop
                h.dl_harq.pop(pid, None)
                self.metrics["harq_drop"] += 1
            else:
                h.dl_harq[pid] = (payload, n_prb, mcs, n_tx + 1)
                h.harq_retx_q.append(pid)
                self._harq_hint.add(rnti)
                self.metrics["harq_retx"] += 1

    def _dl_cap_bytes(self, sf: int, n_prb_alloc: int, mcs: int) -> int:
        """Max MAC PDU bytes a width-n allocation can LEGALLY carry at
        this subframe on the waveform PHY: the largest DISCRETE 36.213
        TBS whose code rate stays <= 0.93 over the worst-case RE count
        (sf 0/5 masks lose REs to PSS/SSS/PBCH).  Unconstrained at
        message level, where no waveform cell is attached
        (scheduler_ue.cc alloc_tbs/nof_re role; `mcs` is advisory —
        the waveform eNB re-clamps per grant)."""
        cell = getattr(self, "phy_cell", None)
        if cell is None:
            return 1 << 30
        max_sym = getattr(self, "phy_max_sym", {}).get(sf, 0)
        return _dl_cap_bytes_cached(cell, sf, n_prb_alloc, max_sym)

    def cqi_info(self, tti, rnti, cqi: int, ri: int = None, pmi: int = None,
                 sb: list = None):
        """CQI(/RI/PMI) report -> link adaptation (scheduler_ue.cc MCS
        selection; RI picks the transmission rank, PMI the TM4/TM6
        closed-loop precoder for waveform-mode transmissions).  `sb` is an
        aperiodic HL-subband report's per-subband differential CQI list
        (cqi.c) kept for frequency-selective scheduling."""
        ue = self.ues.get(rnti)
        if ue is None:
            return
        if sb is not None:
            ue.sb_cqi = list(sb)
            self.metrics["aperiodic_cqi"] += 1
        if cqi is not None:
            # simple CQI->MCS map (monotone subset of 36.213 tables)
            ue.dl_mcs = max(0, min(28, 2 * cqi - 2))
        if ri is not None:
            ue.ri = ri
            self.metrics["ri_reports"] = self.metrics.get(
                "ri_reports", 0) + 1
        if pmi is not None:
            ue.pmi = pmi
        self.metrics["cqi_reports"] += 1

    def ul_pdu(self, tti, rnti, payload, sinr):
        ue = self.ues.get(rnti)
        if ue is None:
            return
        for lcid, sdu in pdu.unpack(payload):
            if lcid == pdu.LCID_CCCH:
                self._rx_ccch(ue, sdu)
            elif lcid == pdu.LCID_SBSR:
                # short BSR: 2-bit LCG + 6-bit table index (36.321)
                ue.bsr = pdu.BSR_TABLE[sdu[0] & 0x3F] if sdu else 0
                if ue.bsr:
                    self._ul_hint.add(rnti)
            elif lcid == pdu.LCID_LBSR:
                ue.bsr = sum(pdu.long_bsr_bytes(sdu))
                self._ul_hint.add(rnti)
                self.metrics["long_bsr_rx"] += 1
            elif lcid == pdu.LCID_PHR:
                # Power Headroom CE -> UL link adaptation input
                # (scheduler_ue.cc uses PHR to bound the UL allocation)
                ue.phr_db = pdu.phr_db(sdu)
                self.metrics["phr_rx"] += 1
            elif lcid in ue.rlc:
                ue.rlc[lcid].write_pdu(sdu)
                self._dl_hint.add(rnti)  # AM rx may queue a status PDU
        self.metrics["ul_bytes"] += len(payload)

    SI_RNTI = 0xFFFF

    def get_dl_sched(self, tti):
        """Per-TTI PRB grid packing (scheduler_grid.cc equivalent): grants in
        the same subframe never overlap in PRBs, and every DCI is placed on
        collision-free CCEs from its RNTI's true search space — when the
        control region fills, remaining UEs defer to a later TTI."""
        # every RLC write site raises _dl_hint; capture it into the RLC
        # timer registry BEFORE serving drains the hint (AM drains create
        # tx_window state that needs t-PollRetransmit ticks)
        self._tick_set |= self._dl_hint
        grants = []
        cursor = 0

        # hint-driven pending scan: only rntis touched by an RLC write are
        # checked each TTI; a periodic full rescan (every 512 TTIs) bounds
        # starvation if a write site ever misses the hint
        if tti % 512 == 1:
            self._dl_hint.update(self.ues.keys())
        data_pending = []
        for r in list(self._dl_hint):
            u = self.ues.get(r)
            if u is None:
                self._dl_hint.discard(r)
            elif any(e.has_data() for e in u.rlc.values()):
                data_pending.append(r)
            else:
                self._dl_hint.discard(r)
        # CFI escalation with demand (the reference widens the control
        # region under load): smallest CFI whose CCE count covers the
        # common search space plus the expected DCI load; the allocator
        # then enforces per-candidate CCE collisions
        demand = (len(self.rar_pending) + len(self.ccch_dl)
                  + len(data_pending) + len(self._ul_hint))
        cfis = (1, 2, 3) if self.fixed_cfi is None else (self.fixed_cfi,)
        for cfi in cfis:
            cell = grid_mod.CellConfig(n_prb=self.n_prb,
                                       cell_id=self.cell_pci, cfi=cfi)
            if pdcch_mod.n_cce(cell) >= 4 + 2 * demand:
                break
        cce = _CceAlloc(cell, tti % 10)
        # get_ul_sched(tti) draws its DCI-0 CCEs from this same allocator:
        # DL and UL DCIs share one control region (scheduler_grid.cc)
        self._cce_cache = (tti, cce)

        # expire zombie contexts: a RACH that never completed Msg3 (its UE
        # lost contention resolution or gave up) leaves an RRC_IDLE context
        # that would otherwise linger in every scheduler loop forever
        if tti % 100 == 3:
            for r in [r for r, u in self.ues.items()
                      if u.state == "RRC_IDLE" and u.kenb is None
                      and u.mme_ue_id is None
                      and (tti - u.birth_tti) % 10240 > 200]:
                del self.ues[r]
                self.metrics["ctx_expired"] += 1

        # SI broadcast (rrc.cc SIB scheduling): SIB1 every 20 ms at sf 5,
        # SIB2 in its SI window every 80 ms
        def si(msg):
            la = cce.alloc_common(l_pref=8) or (4, 0)  # SI pre-reserved
            grants.append(DlGrant(
                rnti=self.SI_RNTI, prb_mask=alloc(3), mcs=0,
                payload=pdu.pack([(pdu.LCID_CCCH,
                                   rrc_wire.encode_bcch(msg))]),
                l_aggr=la[0], cce_start=la[1]))
            self.metrics["si_tx"] += 1

        def alloc(n):
            nonlocal cursor
            n = min(n, self.n_prb - cursor)
            if n <= 0:
                return None
            mask = tuple(1 if cursor <= i < cursor + n else 0
                         for i in range(self.n_prb))
            cursor += n
            return mask

        self._drain_paging(tti)
        if tti % 20 == 5:
            si(rrc_msgs.Sib1(tac=self.enb_id, cell_identity=self.enb_id << 8,
                             plmn=self.plmn))
        if tti % 80 == 16:
            si(rrc_msgs.Sib2())
        if tti % 160 == 48:
            si(rrc_msgs.Sib3(q_hyst_db=self.q_hyst_db))
        if self.mbms_sessions and tti % 160 == 88:
            # SIB13: MBSFN area + MCCH config (rrc.cc SIB13 broadcast).
            # Offset 88 keeps the SI occasions disjoint (sib1 %20==5,
            # sib2 %80==16, sib3 %160==48): two SI messages in one TTI
            # would alias on the shared SI-RNTI in the UE's pdsch lookup.
            si(rrc_msgs.Sib13(area_id=self.mbms_area_id,
                              mcch_offset=1, mcch_rep_rf=32))
        while self.rar_pending and cursor < self.n_prb:
            la = cce.alloc_common(l_pref=4)
            if la is None:
                self.metrics["cce_defer"] += 1
                break  # control region full: RARs wait a TTI
            prach_tti, preamble, rnti = self.rar_pending.pop(0)
            u = self.ues.get(rnti)
            if u is None:
                # context expired while the RAR sat in a congested queue
                # (mass attach backs rar_pending up past the zombie window)
                continue
            # Backoff Indicator under RACH overload: index scales with the
            # measured drop pressure (36.321 Table 7.2-1 via pdu.BI_TABLE_MS)
            bi = 0
            if self._ra_congestion:
                bi = min(12, 6 + self._ra_congestion // 16)
                self._ra_congestion = max(0, self._ra_congestion - 1)
            rar = pdu.pack_rar(rapid=preamble, ta=0, ul_grant=0, t_crnti=rnti,
                               bi=bi)
            m = alloc(2)
            if m is None:
                break
            # RA-RNTI from the PRACH OCCASION tti (36.321 §5.1.4 / prach.c
            # ra_rnti role), not the RAR's own TX tti: the UE predicts it
            # and listens for exactly this RNTI during the response window
            grants.append(DlGrant(rnti=1 + prach_tti % 10, prb_mask=m, mcs=0,
                                  payload=rar, l_aggr=la[0], cce_start=la[1]))
            # RAR includes an UL grant for Msg3 (proc_ra contention)
            u.msg3_grant = True
            self._ul_hint.add(rnti)
        # CCCH (SRB0) messages ride dedicated grants
        while self.ccch_dl and cursor < self.n_prb - 4:
            la = cce.alloc(self.ccch_dl[0][0], l_pref=4)
            if la is None:
                self.metrics["cce_defer"] += 1
                break
            rnti, data, ce = self.ccch_dl.popleft()
            subs = [(pdu.LCID_CON_RES, ce)] if ce else []
            subs.append((pdu.LCID_CCCH, data))
            mac_pdu = pdu.pack(subs)
            grants.append(DlGrant(rnti=rnti, prb_mask=alloc(4),
                                  mcs=self.mcs, payload=mac_pdu,
                                  l_aggr=la[0], cce_start=la[1]))
        # HARQ retransmissions take precedence (scheduler_harq.cc); the
        # retransmission keeps its original PRB count and MCS, rv follows
        # the LTE redundancy-version sequence 0,2,3,1 (dl_harq.cc).
        RV_SEQ = (0, 2, 3, 1)
        # DTX detection (scheduler_harq.cc): a process whose HARQ feedback
        # never arrived (UE missed the PDCCH grant entirely, or the PUCCH
        # was lost) is treated as NACKed after a timeout — otherwise all 8
        # processes wedge and the UE starves forever.
        DTX_TIMEOUT = 12
        harq_rntis = sorted(self._harq_hint)
        for rnti in harq_rntis:
            u = self.ues.get(rnti)
            if u is None:
                self._harq_hint.discard(rnti)
                continue
            while (u.harq_fifo and
                   tti - u.harq_tx_tti.get(u.harq_fifo[0], tti) > DTX_TIMEOUT):
                pid = u.harq_fifo.popleft()
                if pid not in u.dl_harq:
                    continue
                payload, n_prb, mcs, n_tx = u.dl_harq[pid]
                if n_tx >= 4:
                    u.dl_harq.pop(pid, None)
                    self.metrics["harq_drop"] += 1
                else:
                    u.dl_harq[pid] = (payload, n_prb, mcs, n_tx + 1)
                    u.harq_retx_q.append(pid)
                    self.metrics["harq_dtx_retx"] += 1
        for rnti in harq_rntis:
            u = self.ues.get(rnti)
            if u is None:
                continue
            while u.harq_retx_q and cursor < self.n_prb:
                pid = u.harq_retx_q[0]
                if pid not in u.dl_harq:
                    u.harq_retx_q.popleft()
                    continue
                payload, n_prb_tx, mcs_tx, n_tx = u.dl_harq[pid]
                # adaptive retransmission (scheduler_harq.cc adaptive path):
                # widen the allocation and drop MCS so the effective code
                # rate falls with every attempt
                n_prb_tx = min(self.n_prb - cursor,
                               n_prb_tx + (n_tx - 1) * max(1, n_prb_tx // 2))
                mcs_tx = max(0, mcs_tx - 2 * (n_tx - 1))
                if n_prb_tx <= 0 or cursor + n_prb_tx > self.n_prb:
                    break
                if (ra.dl_tbs(27, n_prb_tx) < (len(payload) + 3) * 8
                        or self._dl_cap_bytes(tti % 10, n_prb_tx, 27)
                        < len(payload)):
                    break  # grid too full to refit this TB: defer a TTI
                la = cce.alloc(rnti, l_pref=_l_aggr_pref(mcs_tx))
                if la is None:
                    self.metrics["cce_defer"] += 1
                    break  # retx stays queued for the next TTI
                u.harq_retx_q.popleft()
                u.harq_fifo.append(pid)
                u.harq_tx_tti[pid] = tti
                u.dl_harq[pid] = (payload, n_prb_tx, mcs_tx, n_tx)
                grants.append(DlGrant(rnti=rnti, prb_mask=alloc(n_prb_tx),
                                      mcs=mcs_tx, payload=payload,
                                      harq_pid=pid, rv=RV_SEQ[(n_tx - 1) % 4],
                                      l_aggr=la[0], cce_start=la[1]))
        for rnti in harq_rntis:
            u = self.ues.get(rnti)
            if u is not None and not u.harq_fifo and not u.harq_retx_q:
                self._harq_hint.discard(rnti)
        # SCell activation (36.321 §5.13): a configured-but-inactive SCell
        # activates when DL backlog appears; the Activation/Deactivation CE
        # rides the UE's next PCell MAC PDU
        if self.n_carriers > 1:
            for r in data_pending:
                u = self.ues.get(r)
                if u is not None and u.scells_cfg and u.scells_ready:
                    todo = set(u.scells_cfg) - u.scells_act
                    if todo:
                        u.scell_act_pending |= todo
        # semi-persistent scheduling (36.321 §5.10, srsenb sched SPS):
        # activation rides ONE PDCCH DCI to the SPS C-RNTI; every interval
        # thereafter the allocation recurs with NO PDCCH (no CCE cost).
        # SPS losses are recovered by RLC AM (no eNB HARQ entity for SPS).
        sps_served = set()
        for rnti in data_pending:
            u = self.ues.get(rnti)
            sps = getattr(u, "sps", None) if u is not None else None
            if sps is None or cursor >= self.n_prb - 2:
                continue
            # SPS carries USER-plane bearers only; SRB traffic (including
            # the sps-Config reconfiguration itself) rides dynamic grants
            if any(l <= SRB2 and u.rlc[l].has_data() for l in u.rlc):
                continue
            tb = None
            if not sps["active"]:
                la = cce.alloc(sps["crnti"], l_pref=4)
                if la is None:
                    self.metrics["cce_defer"] += 1
                    continue
                tb = self._drain_tb(u, sps["bytes"])
                if tb is None:
                    continue
                sps["active"] = True
                sps["act_tti"] = tti
                self.metrics["sps_activation_tx"] += 1
                grants.append(DlGrant(
                    rnti=sps["crnti"], prb_mask=alloc(sps["n_prb"]), mcs=0,
                    payload=tb, l_aggr=la[0], cce_start=la[1]))
                sps_served.add(rnti)
            elif (tti - sps["act_tti"]) % sps["interval"] == 0:
                tb = self._drain_tb(u, sps["bytes"])
                if tb is None:
                    continue
                self.metrics["sps_tx"] += 1
                grants.append(DlGrant(
                    rnti=sps["crnti"], prb_mask=alloc(sps["n_prb"]), mcs=0,
                    payload=tb, sps_no_dci=1))
                sps_served.add(rnti)
        # new transmissions: RR or proportional-fair over UEs with RLC data
        # and a free HARQ process (data_pending computed once above)
        active = [r for r in data_pending
                  if r in self.ues and r not in sps_served
                  and self._free_pid(self.ues[r]) is not None]
        if self.n_carriers > 1:
            active += [r for r, u in self.ues.items()
                       if u.scell_act_pending and r not in active
                       and self._free_pid(u) is not None]
        # PF bookkeeping: averages decay lazily via (1-a)^(dt) on access
        # (a per-TTI decay loop over every UE is O(UEs) at 200-UE scale)
        # pack MULTIPLE UEs per TTI until the PRB grid or the PDCCH control
        # region is exhausted — scheduler_grid.cc behavior with real CCE
        # candidate collisions (UEs that can't be placed defer a TTI)
        served = set()
        while cursor < self.n_prb - 2:
            cand = [r for r in active if r not in served]
            if not cand:
                break
            if self.sched_policy == "pf":
                n_free = self.n_prb - cursor
                rnti = max(cand, key=lambda r: ra.dl_tbs(
                    getattr(self.ues[r], "dl_mcs", self.mcs), n_free)
                    / self._pf_avg(self.ues[r], tti))
            else:
                rnti = cand[self._rr % len(cand)]
                self._rr += 1
            served.add(rnti)
            u = self.ues[rnti]
            # SRB traffic rides the most robust MCS (cell-edge delivery of
            # RRC messages, e.g. the handover command); the TB size follows
            # from (mcs, free PRBs) like a real TBS lookup, and RLC segments
            # larger messages across TTIs.
            has_srb = any(l <= SRB2 and u.rlc[l].has_data() for l in u.rlc)
            mcs = 0 if has_srb else getattr(u, "dl_mcs", self.mcs)
            want_rank2 = (getattr(self, "mimo", False) and not has_srb
                          and getattr(u, "ri", 1) >= 2)
            # CCE placement BEFORE touching RLC: a UE whose DCI cannot be
            # placed keeps its data for a later TTI
            la = cce.alloc(rnti, l_pref=_l_aggr_pref(mcs))
            if la is None:
                self.metrics["cce_defer"] += 1
                continue
            if want_rank2:
                # DCI format 2A is RA type 0: align to RBG boundaries
                # BEFORE sizing so the bitmap expresses the mask exactly
                cursor += (-cursor) % ra.rbg_size(self.n_prb)
            n_prb_free = self.n_prb - cursor
            if n_prb_free <= 0:
                continue
            tb_bytes = min(TB_BYTES, max(8, ra.dl_tbs(mcs, n_prb_free) // 8))
            if want_rank2:
                tb_bytes = max(8, tb_bytes - 8)  # framing headroom
            tb_bytes = min(tb_bytes, self._dl_cap_bytes(
                tti % 10, n_prb_free, mcs))
            subs = []
            room = tb_bytes
            if u.scell_act_pending:
                u.scells_act |= u.scell_act_pending
                u.scell_act_pending = set()
                subs.append((pdu.LCID_SCELL_ACT,
                             pdu.scell_act_ce(u.scells_act)))
                room -= 3
                self.metrics["scell_act_ce"] += 1
            for lcid in sorted(u.rlc):
                while room > 8 and u.rlc[lcid].has_data():
                    p = u.rlc[lcid].read_pdu(room - 4)
                    if p is None:
                        break
                    subs.append((lcid, p))
                    room -= len(p) + 3
            if subs:
                n_bytes = tb_bytes - room
                # exact allocation sizing: smallest n whose 36.213 TBS
                # fits the PDU + framing headroom (TBS is NOT linear in
                # n_prb; the per-PRB heuristic undersized at high MCS)
                # Rank-2 grants consider only type-0-bitmap-expressible
                # widths (RBG multiples, or the band-edge remainder)
                # DIRECTLY: capacity is not monotone in n_prb (a width
                # can flip the top MCS rate-illegal), so post-hoc
                # rounding is unsafe.
                if want_rank2:
                    P = ra.rbg_size(self.n_prb)
                    cand_ns = [n for n in range(P, n_prb_free + 1)
                               if n % P == 0] + [n_prb_free]
                else:
                    cand_ns = list(range(2, n_prb_free + 1))
                n_prb = n_prb_free
                for n_try in cand_ns:
                    if (ra.dl_tbs(mcs, n_try) >= (n_bytes + 3) * 8
                            and self._dl_cap_bytes(tti % 10, n_try, mcs)
                            >= n_bytes):
                        n_prb = n_try
                        break
                payload = pdu.pack(subs)
                pid = self._free_pid(u)
                u.dl_harq[pid] = (payload, n_prb, mcs, 1)
                u.harq_fifo.append(pid)
                u.harq_tx_tti[pid] = tti
                self._harq_hint.add(rnti)
                u.avg_thr = self._pf_avg(u, tti) + PF_ALPHA * 8 * n_bytes
                u.pf_tti = tti
                g = DlGrant(rnti=rnti, prb_mask=alloc(n_prb),
                            mcs=mcs, payload=payload, harq_pid=pid,
                            l_aggr=la[0], cce_start=la[1])
                # rank-2 spatial multiplexing (waveform TM3): the UE's RI
                # report opens a SECOND codeword on the same allocation —
                # the scheduler drains another TB sized for the SAME PRBs
                # (scheduler_ue.cc two-TB grant; DCI format 2A).  CW2
                # losses recover via RLC AM (the HARQ entity tracks CW1).
                if want_rank2:
                    # -8: MAC subheader/padding headroom so the waveform
                    # encoder can always frame payload2 at mcs2 <= 28
                    tb2_bytes = max(8, min(
                        ra.dl_tbs(mcs, n_prb) // 8 - 8,
                        self._dl_cap_bytes(tti % 10, n_prb, mcs)))
                    subs2, room2 = [], tb2_bytes
                    for lcid in sorted(u.rlc):
                        while room2 > 8 and u.rlc[lcid].has_data():
                            p = u.rlc[lcid].read_pdu(room2 - 4)
                            if p is None:
                                break
                            subs2.append((lcid, p))
                            room2 -= len(p) + 3
                    if subs2:
                        g.tm = "tm3"
                        g.payload2 = pdu.pack(subs2)
                        g.mcs2 = mcs
                        n_bytes += tb2_bytes - room2
                        self.metrics["tm3_tx"] = self.metrics.get(
                            "tm3_tx", 0) + 1
                grants.append(g)
                self.metrics["dl_bytes"] += n_bytes
        return grants

    def get_dl_sched_cc(self, tti, cc):
        """DL grants for SCell component carrier `cc` (>=1): dedicated data
        only — no SI/RAR/paging/CCCH, which live on the PCell (36.331 SCells
        carry no common channels in this deployment, srsenb cc_worker role).
        HARQ entities are per-carrier (dl_harq.cc one per cc)."""
        assert cc >= 1
        grants = []
        cursor = 0
        RV_SEQ = (0, 2, 3, 1)
        DTX_TIMEOUT = 12

        def alloc(n):
            nonlocal cursor
            n = min(n, self.n_prb - cursor)
            if n <= 0:
                return None
            mask = tuple(1 if cursor <= i < cursor + n else 0
                         for i in range(self.n_prb))
            cursor += n
            return mask

        users = [(r, u) for r, u in self.ues.items()
                 if cc in u.scells_act and cc in u.scell_harq]
        # DTX + retransmissions first, same policy as the PCell
        for rnti, u in users:
            h = u.scell_harq[cc]
            while (h.harq_fifo and
                   tti - h.harq_tx_tti.get(h.harq_fifo[0], tti) > DTX_TIMEOUT):
                pid = h.harq_fifo.popleft()
                if pid not in h.dl_harq:
                    continue
                payload, n_prb, mcs, n_tx = h.dl_harq[pid]
                if n_tx >= 4:
                    h.dl_harq.pop(pid, None)
                    self.metrics["harq_drop"] += 1
                else:
                    h.dl_harq[pid] = (payload, n_prb, mcs, n_tx + 1)
                    h.harq_retx_q.append(pid)
                    self.metrics["harq_dtx_retx"] += 1
            while h.harq_retx_q and cursor < self.n_prb:
                pid = h.harq_retx_q[0]
                if pid not in h.dl_harq:
                    h.harq_retx_q.popleft()
                    continue
                payload, n_prb_tx, mcs_tx, n_tx = h.dl_harq[pid]
                if cursor + n_prb_tx > self.n_prb:
                    break
                h.harq_retx_q.popleft()
                h.harq_fifo.append(pid)
                h.harq_tx_tti[pid] = tti
                grants.append(DlGrant(rnti=rnti, prb_mask=alloc(n_prb_tx),
                                      mcs=mcs_tx, payload=payload,
                                      harq_pid=pid, rv=RV_SEQ[(n_tx - 1) % 4]))
        # new transmissions: serve RLC backlog on the secondary carrier
        served = set()
        while cursor < self.n_prb - 2 and len(served) < 8:
            cand = [(r, u) for r, u in users
                    if r not in served and self._free_pid(u.scell_harq[cc])
                    is not None and any(e.has_data() for e in u.rlc.values())]
            if not cand:
                break
            rnti, u = cand[0]
            served.add(rnti)
            h = u.scell_harq[cc]
            mcs = getattr(u, "dl_mcs", self.mcs)
            n_prb_free = self.n_prb - cursor
            tb_bytes = min(TB_BYTES, max(8, ra.dl_tbs(mcs, n_prb_free) // 8))
            subs = []
            room = tb_bytes
            for lcid in sorted(u.rlc):
                if lcid <= SRB2:
                    continue  # SRBs are PCell-only (36.331)
                while room > 8 and u.rlc[lcid].has_data():
                    p = u.rlc[lcid].read_pdu(room - 4)
                    if p is None:
                        break
                    subs.append((lcid, p))
                    room -= len(p) + 3
            if subs:
                n_bytes = tb_bytes - room
                # exact allocation sizing: smallest n whose 36.213 TBS
                # fits the PDU + framing headroom (TBS is NOT linear in
                # n_prb; the per-PRB heuristic undersized at high MCS)
                n_prb = n_prb_free
                for n_try in range(2, n_prb_free + 1):
                    if (ra.dl_tbs(mcs, n_try) >= (n_bytes + 3) * 8
                            and self._dl_cap_bytes(tti % 10, n_try, mcs)
                            >= n_bytes):
                        n_prb = n_try
                        break
                payload = pdu.pack(subs)
                pid = self._free_pid(h)
                h.dl_harq[pid] = (payload, n_prb, mcs, 1)
                h.harq_fifo.append(pid)
                h.harq_tx_tti[pid] = tti
                u.avg_thr += PF_ALPHA * 8 * n_bytes
                grants.append(DlGrant(rnti=rnti, prb_mask=alloc(n_prb),
                                      mcs=mcs, payload=payload, harq_pid=pid))
                self.metrics["dl_bytes"] += n_bytes
                self.metrics["scell_dl_bytes"] += n_bytes
        return grants

    RV_SEQ_UL = (0, 2, 3, 1)

    def get_ul_sched(self, tti):
        """UL PRB packing: HARQ retransmission grants first (eNB-side UL
        HARQ entities, scheduler_harq.cc ul_harq_proc: adaptive retx widens
        the allocation and drops MCS, rv follows 0,2,3,1), then msg3, then
        SR/BSR grants."""
        grants = []
        cursor = self.ul_prb_lo  # PUCCH edge PRBs are not PUSCH-schedulable
        # DCI-0s share the TTI's control region with the DL DCIs: reuse
        # get_dl_sched(tti)'s allocator so CCEs never collide across the
        # two, and every placement is a true search-space candidate that
        # the waveform UE's blind decoder will actually check
        cached = getattr(self, "_cce_cache", None)
        if cached is not None and cached[0] == tti:
            cce = cached[1]
        else:
            cell = grid_mod.CellConfig(n_prb=self.n_prb,
                                       cell_id=self.cell_pci,
                                       cfi=self.fixed_cfi or 3)
            cce = _CceAlloc(cell, tti % 10)
        if tti % 512 == 1:  # backstop for any hint site missed
            self._ul_hint.update(self.ues.keys())
        hinted = sorted(self._ul_hint)
        for rnti in hinted:
            u = self.ues.get(rnti)
            if u is None:
                self._ul_hint.discard(rnti)
                continue
            ent = getattr(u, "ul_harq_ent", None)
            if ent is None or not ent.get("retx_due"):
                continue
            n_tx = ent["n_tx"] + 1
            l_prb = self._ul_prb_fit(
                min(self.ul_prb_hi - cursor,
                    ent["l_prb"] + (n_tx - 1) * max(1, ent["l_prb"] // 2)))
            if l_prb <= 0:
                break
            la = cce.alloc(rnti, l_pref=4)
            if la is None:
                self.metrics["cce_defer_ul"] += 1
                continue  # control region full: retx stays due
            mcs = max(0, ent["mcs"] - 2 * (n_tx - 1))
            u.ul_harq_ent = dict(l_prb=ent["l_prb"], mcs=ent["mcs"],
                                 n_tx=n_tx, retx_due=False)
            grants.append(UlGrant(rnti=rnti, rb_start=cursor, l_prb=l_prb,
                                  mcs=mcs, ndi=0,
                                  rv=self.RV_SEQ_UL[(n_tx - 1) % 4],
                                  l_aggr=la[0], cce_start=la[1]))
            cursor += l_prb
            self.metrics["ul_harq_retx"] += 1
        for rnti in hinted:
            u = self.ues.get(rnti)
            if u is None:
                continue
            if cursor + 4 > self.ul_prb_hi:
                break
            if getattr(u, "msg3_grant", False):
                la = cce.alloc(rnti, l_pref=4)
                if la is None:
                    self.metrics["cce_defer_ul"] += 1
                    continue  # msg3_grant stays set for a later TTI
                u.msg3_grant = False
                grants.append(UlGrant(rnti=rnti, rb_start=cursor, l_prb=4,
                                      mcs=self.mcs,
                                      l_aggr=la[0], cce_start=la[1]))
                cursor += 4
        for rnti in hinted:
            u = self.ues.get(rnti)
            if u is None:
                continue
            # nominal 8-PRB SR/BSR grant, shrunk to what the cell has left
            # (a 1.4 MHz cell only has 6 PRB total) and rounded down to a
            # DFT-precodable size
            l_prb = self._ul_prb_fit(min(8, self.ul_prb_hi - cursor))
            if l_prb < 2:
                break
            if getattr(u, "sr", False) or getattr(u, "bsr", 0) > 0:
                la = cce.alloc(rnti, l_pref=4)
                if la is None:
                    self.metrics["cce_defer_ul"] += 1
                    continue  # sr/bsr flags persist; retry next TTI
                u.sr = False
                u.bsr = 0
                ul_mcs = max(0, min(20, self.mcs
                                    + int(getattr(u, "ul_olla", 0.0))))
                # power-limited UEs (low PHR) can't sustain high UL MCS:
                # cap it (scheduler_ue.cc PHR-driven UL adaptation)
                phr = getattr(u, "phr_db", None)
                if phr is not None and phr < 5:
                    ul_mcs = min(ul_mcs, max(0, int(phr) + 5))
                # periodic aperiodic-CQI solicitation (scheduler_ue.cc
                # sets the DCI-0 CSI request every few PUSCH grants)
                cqi_req = 0
                if tti - getattr(u, "last_cqi_req", -100) >= 40:
                    u.last_cqi_req = tti
                    cqi_req = 1
                grants.append(UlGrant(rnti=rnti, rb_start=cursor,
                                      l_prb=l_prb, mcs=ul_mcs, ndi=1,
                                      cqi_request=cqi_req,
                                      l_aggr=la[0], cce_start=la[1]))
                u.ul_harq_ent = dict(l_prb=l_prb, mcs=ul_mcs, n_tx=1,
                                     retx_due=False)
                cursor += l_prb
        for rnti in hinted:
            u = self.ues.get(rnti)
            if u is None:
                continue
            ent = getattr(u, "ul_harq_ent", None)
            # a completed UL HARQ entity (no retx due) does NOT pin the
            # hint: a later PUSCH CRC failure re-adds the rnti when it
            # sets retx_due (ul_crc_info) — otherwise every UE that ever
            # transmitted stays in the per-TTI UL scan forever
            if not (getattr(u, "msg3_grant", False) or getattr(u, "sr", False)
                    or getattr(u, "bsr", 0) > 0
                    or (ent is not None and ent.get("retx_due"))):
                self._ul_hint.discard(rnti)
        return grants

    # ---------------- eMBMS (srsenb rrc.cc SIB13/MCCH + MAC PMCH) --------
    MBSFN_SFS = (1, 2, 3, 6, 7, 8)  # FDD MBSFN-able subframes (36.211)

    def m2_endpoint(self):
        """M2AP control endpoint for `epc.mbms_gw.add_enb_m2`: decodes the
        real 36.443 Session Start Request bytes, records the session, and
        assigns its MTCH logical channel (announced on the MCCH)."""
        from ..epc import mbms_gw as gw_mod

        def endpoint(req_bytes: bytes) -> bytes:
            req = gw_mod._m2_decode_request(req_bytes)
            if req.mbms_service_id not in self.mbms_sessions:
                self.mbms_sessions[req.mbms_service_id] = \
                    1 + len(self.mbms_sessions)
            self.mbms_area_id = req.area_id
            self.metrics["m2_sessions"] += 1
            return gw_mod._m2_encode_response(gw_mod.M2SessionStartResponse(
                mbms_service_id=req.mbms_service_id, ok=True))

        return endpoint

    def get_mbsfn_tx(self, tti):
        """One PMCH emission for this tti, or None: the MCCH area config
        (true 36.331 MBSFNAreaConfiguration UPER bytes) on its repetition
        occasion, else one queued M1-U packet as MTCH on an MBSFN subframe
        (sf_worker PMCH role).  With several announced sessions the MTCH
        data rides the lowest LCID — the M1-U sink carries no per-service
        tag (one service per area in this runtime, like the GW's
        area-scoped multicast)."""
        if not self.mbms_sessions:
            return None
        if tti % 320 == 11:  # MCCH occasion (SIB13 advertises rf32, sf 1)
            cfg = rrc_msgs.MbsfnAreaConfig(
                area_id=self.mbms_area_id, data_mcs=2,
                sessions=sorted((sid, lcid) for sid, lcid
                                in self.mbms_sessions.items()))
            self.metrics["mcch_tx"] += 1
            return dict(kind="mcch", area_id=self.mbms_area_id, lcid=0,
                        data=rrc_wire.encode_mcch(cfg))
        if self.mbms_queue and tti % 10 in self.MBSFN_SFS:
            area_id, pkt = self.mbms_queue.pop(0)
            self.metrics["mtch_tx"] += 1
            return dict(kind="mtch", area_id=area_id,
                        lcid=min(self.mbms_sessions.values()), data=pkt)
        return None

    def get_phich(self, tti):
        out = self.phich_queue
        self.phich_queue = []
        return out

    def get_pci(self):
        return self.cell_pci

    def tick(self):
        # event-driven: only UEs whose RLC entities CAN have timer work
        # (rx state or unacked data) are visited.  rntis enter through
        # the _dl_hint funnel (every RLC write site raises it; the union
        # happens in get_dl_sched before the hint is drained) and leave
        # when their entities go fully idle — a 1000-UE registered-idle
        # cell costs nothing here.  A 256-TTI full rescan backstops any
        # missed mutation site.
        self._tick_count = getattr(self, "_tick_count", 0) + 1
        if self._tick_count % 256 == 0:
            self._tick_set.update(
                r for r, u in self.ues.items()
                if any(e.needs_tick() for e in u.rlc.values()))
        drop = None
        for r in self._tick_set:
            u = self.ues.get(r)
            live = False
            if u is not None:
                for e in u.rlc.values():
                    if e.needs_tick():
                        live = True
                        if e.timer_tick():
                            self._dl_hint.add(r)  # timer created data
            if not live:
                if drop is None:
                    drop = []
                drop.append(r)
        if drop:
            self._tick_set.difference_update(drop)

    def _alloc(self, n):
        return tuple(1 if i < n else 0 for i in range(self.n_prb))

    def configure_sps(self, rnti: int, interval: int = 20,
                      n_prb_sps: int = 4, tb_bytes: int = 120):
        """Configure DL semi-persistent scheduling for a UE: pushes
        sps-Config (SPS C-RNTI + interval) in an RRC reconfiguration; the
        scheduler activates it via one PDCCH DCI once DL data appears and
        then recurs the allocation PDCCH-free (36.331 sps-Config /
        36.321 §5.10; srsenb sched SPS role for VoLTE-class flows)."""
        u = self.ues[rnti]
        sps_crnti = 0x3000 | (rnti & 0x0FFF)
        u.sps = dict(crnti=sps_crnti, interval=interval, n_prb=n_prb_sps,
                     bytes=tb_bytes, active=False, act_tti=-1)
        u.send_rrc(SRB1, rrc_msgs.RrcConnectionReconfiguration(
            sps_config=rrc_msgs.SpsConfig(sps_crnti=sps_crnti,
                                          interval_dl=interval)))
        self.metrics["sps_configured"] += 1

    @staticmethod
    def _drain_tb(u, max_bytes: int, min_lcid: int = DRB1_LCID):
        """Drain RLC data (lcid >= min_lcid) into one MAC PDU of at most
        max_bytes; None when nothing is pending."""
        subs = []
        room = max_bytes
        for lcid in sorted(l for l in u.rlc if l >= min_lcid):
            while room > 8 and u.rlc[lcid].has_data():
                p = u.rlc[lcid].read_pdu(room - 4)
                if p is None:
                    break
                subs.append((lcid, p))
                room -= len(p) + 3
        return pdu.pack(subs) if subs else None

    @staticmethod
    def _pf_avg(u, tti: int) -> float:
        """Proportional-fair average with lazy exponential decay: the
        per-TTI decay loop over every UE context becomes a pow() on
        access (served UEs re-anchor u.pf_tti)."""
        dt = tti - getattr(u, "pf_tti", tti)
        if dt <= 0:
            return max(1.0, u.avg_thr)
        return max(1.0, u.avg_thr * (1.0 - PF_ALPHA) ** dt)

    @staticmethod
    def _free_pid(u):
        """Lowest DL HARQ process id not in flight and not holding a TB."""
        for pid in range(N_HARQ_PROC):
            if pid not in u.dl_harq:
                return pid
        return None

    def _scells_for(self, ue: UeContext) -> list:
        """SCellToAddMod-r10 list for a UE's first data-bearer
        reconfiguration (rrc.cc sends sCellToAddModList-r10 with it);
        installs the per-cc HARQ entities."""
        if self.n_carriers <= 1 or ue.scells_cfg:
            return []
        scells = []
        for cc in range(1, self.n_carriers):
            scells.append(rrc_msgs.ScellToAdd(
                scell_idx=cc, pci=self.scell_pcis[cc - 1], earfcn=cc))
            ue.scells_cfg[cc] = cc
            ue.scell_harq[cc] = _CcHarq()
        self.metrics["scell_cfg"] += len(scells)
        return scells

    # ================= RRC (rrc.cc) =================
    def _rx_ccch(self, ue: UeContext, sdu: bytes):
        msg = rrc_wire.decode_ul_ccch(sdu)
        # first 6 octets of the Msg3 UL-CCCH SDU: echoed back as the
        # 36.321 Contention Resolution Identity CE with the setup
        ue.msg3_prefix = (bytes(sdu) + b"\x00" * 6)[:6]
        if isinstance(msg, rrc_msgs.RrcConnectionRequest):
            if ue.state == "RRC_CONNECTED":
                # contention: a second Msg3 on an already-resolved C-RNTI
                # (two UEs answered the same RAR) — first request won; the
                # loser sees the foreign con_res_id and re-runs RA
                self.metrics["contention_lost"] += 1
                return
            if self.max_rrc_users is not None:
                # one O(n) recount per TTI, shared by every Msg3 that
                # TTI (overload bursts are exactly when this path is hot)
                cc = getattr(self, "_conn_count", None)
                tti = getattr(self, "_tick_count", 0)
                if cc is None or cc[0] != tti:
                    cc = (tti, sum(1 for u in self.ues.values()
                                   if u.state == "RRC_CONNECTED"))
                    self._conn_count = cc
                if cc[1] >= self.max_rrc_users:
                    # admission control (rrc.cc rejects at max users):
                    # waitTime starts the UE's T302 back-off
                    ue.send_rrc(SRB0, rrc_msgs.RrcConnectionReject(
                        wait_time_s=2))
                    self.metrics["rrc_reject"] += 1
                    return
            ue.state = "RRC_CONNECTED"
            # a registered UE presents its S-TMSI: forwarded to the MME in
            # the InitialUEMessage (s1ap.cc includes the s-TMSI IE)
            ue.s_tmsi = msg.ue_identity if msg.is_s_tmsi else None
            # contention resolution rides the MAC CE (ue.msg3_prefix),
            # not the RRC message
            ue.send_rrc(SRB0, rrc_msgs.RrcConnectionSetup(
                sr_pucch_res_idx=self._alloc_sr_res(ue)))
            self.metrics["rrc_setup"] += 1
        elif isinstance(msg, rrc_msgs.RrcConnectionReestablishmentRequest):
            self.handle_reestablishment(ue, msg)

    def _rx_pdcp(self, ue: UeContext, lcid: int, rlc_sdu: bytes):
        ue.pdcp[lcid].write_pdu(rlc_sdu)

    def _rx_rrc(self, ue: UeContext, lcid: int, sdu: bytes):
        msg = rrc_wire.decode_ul_dcch(sdu)
        if isinstance(msg, rrc_msgs.RrcConnectionSetupComplete):
            self.mme.initial_ue_message(self.enb_id, mme_mod.InitialUEMessage(
                enb_ue_id=ue.enb_ue_id, nas_pdu=msg.nas_pdu,
                s_tmsi=getattr(ue, "s_tmsi", None)))
        elif isinstance(msg, rrc_msgs.UlInformationTransfer):
            self.mme.uplink_nas(self.enb_id, mme_mod.UplinkNASTransport(
                mme_ue_id=ue.mme_ue_id, enb_ue_id=ue.enb_ue_id,
                nas_pdu=msg.nas_pdu))
        elif isinstance(msg, rrc_msgs.SecurityModeComplete):
            # activate AS security on SRB1 (rrc.cc security mode proc)
            k_rrc_enc = security.kdf_rrc_up_key(ue.kenb, security.EEA2, 0x03)
            k_rrc_int = security.kdf_rrc_up_key(ue.kenb, security.EIA2, 0x04)
            ue.pdcp[SRB1].config_security(security.EEA2, security.EIA2,
                                          k_rrc_enc, k_rrc_int)
            ue.as_secured = True
            ue.send_rrc(SRB1, rrc_msgs.UECapabilityEnquiry())
        elif isinstance(msg, rrc_msgs.UECapabilityInformation):
            ue.setup_drb(DRB1_LCID)
            self.by_teid[ue.teid_enb] = ue
            # deliver DL data buffered while the UE was idle (RLC AM takes
            # care of ordering vs anything arriving after)
            for ip_pkt in self._page_buf.pop(ue.teid_enb, []):
                ue.rlc[DRB1_LCID].write_sdu(
                    ue.pdcp[DRB1_LCID].write_sdu(ip_pkt))
                self._dl_hint.add(ue.rnti)
            ue.send_rrc(SRB1, rrc_msgs.RrcConnectionReconfiguration(
                drbs_to_add=[rrc_msgs.DrbToAdd(drb_id=1, lcid=DRB1_LCID,
                                               eps_bearer_id=ue.eps_bearer or 5)],
                nas_pdu=ue.pending_nas, scells_to_add=self._scells_for(ue),
                # network-pushed measurement configuration (rrc.cc
                # measConfig in the first reconfiguration): the UE's A3
                # event parameters come from HERE, not UE hardcoding
                meas_config=self.meas_config))
        elif isinstance(msg, rrc_msgs.RrcConnectionReconfigurationComplete):
            self.metrics["reconfig_ok"] += 1
            if getattr(ue, "csfb_pending", False):
                ue.csfb_pending = False
                self._csfb_release(ue)
            # SCells may be activated only once the UE confirmed the
            # reconfiguration that configured them (36.331 §5.3.5.3)
            if ue.scells_cfg:
                ue.scells_ready = True
            if getattr(ue, "is_ho", False):
                ue.is_ho = False
                # the UE reset its measConfig at HO execution; the TARGET
                # owns measurement policy now — push ours (rrc.cc puts the
                # target's measConfig in the handover command container)
                ue.send_rrc(SRB1, rrc_msgs.RrcConnectionReconfiguration(
                    meas_config=self.meas_config))
                # X2: deliver forwarded DL data first, then switch the S1-U
                # path — preserves in-order delivery across the handover
                for ip_pkt in getattr(ue, "fwd_buffer", None) or []:
                    ue.rlc[DRB1_LCID].write_sdu(
                        ue.pdcp[DRB1_LCID].write_sdu(ip_pkt))
                    self._dl_hint.add(ue.rnti)
                ue.fwd_buffer = None
                self.mme.path_switch(self.enb_id, mme_mod.PathSwitchRequest(
                    mme_ue_id=ue.mme_ue_id, target_enb_ue_id=ue.enb_ue_id))
                self.metrics["ho_complete"] += 1
        elif isinstance(msg, rrc_msgs.MeasurementReport):
            self.metrics["meas_reports"] += 1
            # which configured event fired? (rrc.cc keys its actions off
            # the measId it configured)
            event = "a3"
            for e in self.meas_config.entries():
                if e.meas_id == getattr(msg, "meas_id", 1):
                    event = e.event
                    break
            else:
                pushed = getattr(ue, "meas_followup", None)
                if pushed is not None \
                        and pushed.meas_id == getattr(msg, "meas_id", 1):
                    event = pushed.event
            self.metrics[f"meas_report_{event}"] += 1
            if event == "a2" and self.a2_followup is not None \
                    and getattr(ue, "meas_followup", None) is None:
                # serving degraded below threshold: configure the follow-up
                # measurement (rrc.cc: A2 -> set up inter-freq/neighbour
                # measurement, typically an A4/A5 reportConfig)
                ue.meas_followup = self.a2_followup
                full = rrc_msgs.MeasConfig(
                    reports=self.meas_config.entries() + [self.a2_followup],
                    s_measure=self.meas_config.s_measure)
                ue.send_rrc(SRB1, rrc_msgs.RrcConnectionReconfiguration(
                    meas_config=full))
                self.metrics["meas_followup_cfg"] += 1
            elif event in ("a3", "a4", "a5") and msg.neigh:
                # coverage/quality-triggered HO decision: neighbor
                # sufficiently above serving -> X2 HO when a direct
                # neighbor relation exists, else S1 via MME
                pci, snr = max(msg.neigh, key=lambda x: x[1])
                # >= : RSRP rides the wire in 1 dB steps (36.133 range),
                # so a UE-side margin of just over 1 dB can quantize to
                # exactly 1 — the UE already applied the event's offset +
                # hysteresis + timeToTrigger before reporting.  A4/A5 are
                # threshold events: the UE vetted the neighbor against the
                # configured threshold, so no serving margin applies.
                good = (snr >= msg.rsrp_dbm + 1.0) if event == "a3" else True
                if good and pci != self.cell_pci:
                    if pci in self.x2_neighbors and ue.kenb is not None:
                        self._x2_handover(ue, pci)
                    else:
                        self.mme.handover_required(self.enb_id, mme_mod.HandoverRequired(
                            mme_ue_id=ue.mme_ue_id, enb_ue_id=ue.enb_ue_id,
                            target_pci=pci))
                        self.metrics["ho_required"] += 1

    # ================= RRC procedures: paging / release / reestablishment ==
    PAGING_T = 32  # DRX cycle in radio frames (36.304 T; defaultPagingCycle)

    @staticmethod
    def paging_frame(ue_identity: int, t: int = PAGING_T) -> int:
        """Paging frame: SFN mod T == (T div N)(UE_ID mod N) with N = T
        (nB = T, Ns = 1 -> single paging occasion per PF, 36.304 §7.1)."""
        return ue_identity % t

    def page(self, ue_identity: int, cn_domain: str = "ps"):
        """Queue a page; it transmits at the UE's paging occasion."""
        self._paging_q = getattr(self, "_paging_q", [])
        self._paging_q.append((ue_identity, cn_domain))
        self.metrics["paging_queued"] += 1

    def _drain_paging(self, tti):
        """Emit queued pages whose paging frame matches this TTI's SFN."""
        q = getattr(self, "_paging_q", [])
        if not q:
            return
        sfn = (tti // 10) % 1024
        rest = []
        for ident, dom in q:
            if sfn % self.PAGING_T == self.paging_frame(ident):
                self.ccch_dl.append((0xFFFE, rrc_wire.encode_pcch(
                    rrc_msgs.Paging(ident, cn_domain=dom)), None))
                self.metrics["paging_tx"] += 1
            else:
                rest.append((ident, dom))
        self._paging_q = rest

    def release_ue(self, rnti: int, cause: str = "user-inactivity"):
        ue = self.ues.get(rnti)
        if ue:
            ue.send_rrc(SRB1, rrc_msgs.RrcConnectionRelease(cause=cause))
            ue.state = "RRC_IDLE"
            self.metrics["rrc_release"] += 1
            # S1AP UE Context Release notification: the MME tracks ECM
            # state itself (the eNB may live in another process)
            notify = getattr(self.mme, "ue_ctx_released", None)
            if notify is not None and ue.mme_ue_id is not None:
                notify(ue.mme_ue_id)

    def handle_reestablishment(self, ue, msg):
        """Reestablishment after RLF (rrc.cc): adopt the old UE context —
        bearers, PDCP security state, TEIDs — under the new C-RNTI."""
        old = self.ues.get(msg.c_rnti)
        if old is None or old.kenb is None or old is ue:
            return  # reject: no context -> UE will fall back to full attach
        del self.ues[msg.c_rnti]
        old.rnti = ue.rnti
        # the contention-resolution CE must echo THIS RA's Msg3 (the
        # reestablishment request), not the adopted context's original
        old.msg3_prefix = getattr(ue, "msg3_prefix", None)
        self.ues[ue.rnti] = old
        old.state = "RRC_CONNECTED"
        old.send_rrc(SRB0, rrc_msgs.RrcConnectionSetup(
            sr_pucch_res_idx=self._alloc_sr_res(old)))
        self.metrics["rrc_reest"] += 1

    # ================= S1AP callbacks (from MME) =================
    def dl_nas(self, msg: mme_mod.DownlinkNASTransport):
        ue = self._by_enb_ue_id(msg.enb_ue_id)
        ue.mme_ue_id = msg.mme_ue_id
        ue.send_rrc(SRB1, rrc_msgs.DlInformationTransfer(nas_pdu=msg.nas_pdu))

    def ctx_setup(self, msg: mme_mod.InitialContextSetupRequest):
        ue = self._by_enb_ue_id(msg.enb_ue_id)
        # service-request contexts reach here without a prior DL NAS, so
        # the MME UE id must be recorded now (s1ap.cc ctx setup)
        ue.mme_ue_id = msg.mme_ue_id
        ue.kenb = msg.kenb
        ue.teid_spgw = msg.teid_spgw
        ue.teid_enb = msg.teid_enb
        ue.eps_bearer = msg.eps_bearer_id
        ue.pending_nas = msg.nas_pdu
        ue.send_rrc(SRB1, rrc_msgs.SecurityModeCommand(
            ciph_algo=security.EEA2, int_algo=security.EIA2))

    def ctx_modification(self, msg):
        """S1AP UE Context Modification (s1ap.cc): the CS Fallback
        Indicator makes the eNB release the UE toward a CS-capable RAT
        with redirectedCarrierInfo (rrc.cc CSFB release path — srsenb
        rrc.cc `release` with redirection on csfb)."""
        cands = [u for u in self.ues.values() if u.mme_ue_id == msg.mme_ue_id]
        # a stale RRC_IDLE context (pre-service-request release) may share
        # the mme_ue_id: the live connection is the one to act on
        live = [u for u in cands if u.state == "RRC_CONNECTED"] or cands
        if live and msg.csfb_indicator:
            u = live[-1]
            if getattr(u, "as_secured", False):
                self._csfb_release(u)
            else:
                # mid-service-request: messages queued before the UE's
                # security-mode completion would be written under stale
                # PDCP keys and dropped — defer the release until the
                # connection setup finishes (rrc.cc orders CSFB release
                # after the ongoing procedure too)
                u.csfb_pending = True

    def _csfb_release(self, u):
        u.send_rrc(SRB1, rrc_msgs.RrcConnectionRelease(
            cause="cs-FallbackHighPriority",
            redirect_rat="geran", redirect_arfcn=514))
        u.state = "RRC_IDLE"
        self.metrics["csfb_release"] += 1

    def erab_setup(self, msg):
        """S1AP E-RAB Setup (dedicated bearer): add the DRB, install the
        TFT for downlink classification, push the RRC reconfiguration with
        the piggybacked NAS activate-dedicated-bearer request."""
        from . import tft as tft_mod

        ue = self._by_enb_ue_id(msg.enb_ue_id)
        lcid = DRB1_LCID + (msg.eps_bearer_id - 5)
        try:
            filters = []
            data = msg.tft
            while data:
                f, data = tft_mod.PacketFilter.unpack(data)
                filters.append(f)
        except (ValueError, IndexError, struct.error):
            # malformed TFT: reject the E-RAB, don't touch bearer state
            self.metrics["erab_fail"] += 1
            return
        ue.setup_drb(lcid)
        if getattr(ue, "tft", None) is None:
            ue.tft = tft_mod.TftMatcher(DRB1_LCID)
        for f in filters:
            ue.tft.add_filter(f, lcid)
        ue.send_rrc(SRB1, rrc_msgs.RrcConnectionReconfiguration(
            drbs_to_add=[rrc_msgs.DrbToAdd(
                drb_id=msg.eps_bearer_id - 4, lcid=lcid,
                eps_bearer_id=msg.eps_bearer_id)],
            nas_pdu=msg.nas_pdu, scells_to_add=self._scells_for(ue)))
        self.metrics["erab_setup"] += 1

    def release(self, msg):
        ue = self._by_enb_ue_id(msg.enb_ue_id)
        ue.send_rrc(SRB1, rrc_msgs.RrcConnectionRelease())
        ue.state = "RRC_IDLE"

    # ---- S1 handover (target side) ----
    def ho_request(self, req: mme_mod.HandoverRequest) -> dict:
        """Admission at the target: prepare a UE context + contention-free
        preamble; keys from KeNB* (rrc.cc HO preparation)."""
        rnti = self.next_rnti
        self.next_rnti += 1
        ue = UeContext(rnti, self)
        ue.state = "HO_PREP"
        ue.is_ho = True
        ue.mme_ue_id = req.mme_ue_id
        ue.kenb = req.kenb_star
        ue.teid_spgw = req.teid_spgw
        ue.teid_enb = req.teid_enb
        k_rrc_enc = security.kdf_rrc_up_key(ue.kenb, security.EEA2, 0x03)
        k_rrc_int = security.kdf_rrc_up_key(ue.kenb, security.EIA2, 0x04)
        ue.pdcp[SRB1].config_security(security.EEA2, security.EIA2,
                                      k_rrc_enc, k_rrc_int)
        ue.setup_drb(DRB1_LCID)
        self.by_teid[ue.teid_enb] = ue
        self.ues[rnti] = ue
        preamble = self._next_ded_preamble
        self._next_ded_preamble = 60 + (self._next_ded_preamble - 59) % 4
        self.dedicated_preambles[preamble] = rnti
        self.metrics["ho_admitted"] += 1
        return dict(new_rnti=rnti, preamble=preamble)

    # ---- X2 handover (x2ap.cc role: direct eNB-eNB, no MME in the prep) ----
    def x2_setup(self, other: "EnbStack"):
        """X2AP Setup: bidirectional neighbor relation keyed by PCI."""
        self.x2_neighbors[other.cell_pci] = other
        other.x2_neighbors[self.cell_pci] = self

    def _x2_handover(self, ue: UeContext, target_pci: int):
        """Source side: prepare at target over X2, command the UE, and start
        forwarding DL data (36.423 Handover Preparation + SN Status Transfer
        + data forwarding, message level)."""
        target = self.x2_neighbors[target_pci]
        # X2 key derivation: KeNB* from the CURRENT KeNB (33.401 §7.2.8.4
        # horizontal derivation), unlike S1 which uses a fresh NH from MME
        kenb_star = security.kdf(ue.kenb, 0x13, target_pci.to_bytes(2, "big"))
        # typed X2AP message on the wire (stack/x2_msgs.py)
        req_bytes = codec.encode(x2_msgs.X2HandoverRequest(
            mme_ue_id=ue.mme_ue_id, kenb_star=kenb_star,
            teid_spgw=ue.teid_spgw, teid_enb=ue.teid_enb,
            source_pci=self.cell_pci, target_pci=target_pci))
        ack = codec.decode(target.x2_ho_request(req_bytes))
        ue.x2_fwd = (target, ack.teid_fwd)
        ue.state = "HO_OUT"
        ue.send_rrc(SRB1, rrc_msgs.RrcConnectionReconfiguration(
            mobility=rrc_msgs.MobilityControlInfo(
                target_pci=target_pci, new_rnti=ack.new_rnti,
                dedicated_preamble=ack.preamble, key_change="x2")))
        self.metrics["ho_x2"] += 1

    def x2_ho_request(self, req_bytes: bytes) -> bytes:
        """Target side admission over X2; also allocates a DL data-forwarding
        GTP tunnel endpoint whose packets buffer until the UE completes."""
        m = codec.decode(req_bytes)
        req = dict(mme_ue_id=m.mme_ue_id, kenb_star=m.kenb_star,
                   teid_spgw=m.teid_spgw, teid_enb=m.teid_enb)
        rnti = self.next_rnti
        self.next_rnti += 1
        ue = UeContext(rnti, self)
        ue.state = "HO_PREP"
        ue.is_ho = True
        ue.mme_ue_id = req["mme_ue_id"]
        ue.kenb = req["kenb_star"]
        ue.teid_spgw = req["teid_spgw"]
        ue.teid_enb = req["teid_enb"]
        k_rrc_enc = security.kdf_rrc_up_key(ue.kenb, security.EEA2, 0x03)
        k_rrc_int = security.kdf_rrc_up_key(ue.kenb, security.EIA2, 0x04)
        ue.pdcp[SRB1].config_security(security.EEA2, security.EIA2,
                                      k_rrc_enc, k_rrc_int)
        ue.setup_drb(DRB1_LCID)
        self.by_teid[ue.teid_enb] = ue
        self.ues[rnti] = ue
        preamble = self._next_ded_preamble
        self._next_ded_preamble = 60 + (self._next_ded_preamble - 59) % 4
        self.dedicated_preambles[preamble] = rnti
        teid_fwd = self._next_fwd_teid
        self._next_fwd_teid += 1
        ue.fwd_buffer = []
        self.by_fwd_teid[teid_fwd] = ue
        self.metrics["ho_admitted_x2"] += 1
        return codec.encode(x2_msgs.X2HandoverRequestAck(
            new_rnti=rnti, preamble=preamble, teid_fwd=teid_fwd))

    def x2_gtpu_fwd(self, pkt: bytes):
        """X2-U: forwarded DL data from the source eNB.  Buffered until the
        UE completes the handover, then delivered in order before any
        post-path-switch S1-U traffic."""
        teid, ip_pkt = spgw_mod.gtpu_decap(pkt)
        ue = self.by_fwd_teid.get(teid)
        if ue is None:
            return
        if ue.fwd_buffer is None:  # UE already arrived: deliver directly
            ue.rlc[DRB1_LCID].write_sdu(ue.pdcp[DRB1_LCID].write_sdu(ip_pkt))
            self._dl_hint.add(ue.rnti)
        else:
            ue.fwd_buffer.append(ip_pkt)
        self.metrics["x2_fwd_pkts"] += 1

    # ---- S1 handover (source side) ----
    def ho_command(self, cmd: mme_mod.HandoverCommand):
        ue = self._by_enb_ue_id(cmd.enb_ue_id)
        ue.send_rrc(SRB1, rrc_msgs.RrcConnectionReconfiguration(
            mobility=rrc_msgs.MobilityControlInfo(
                target_pci=cmd.target_pci, new_rnti=cmd.new_rnti,
                dedicated_preamble=cmd.dedicated_preamble)))
        ue.state = "HO_OUT"
        self.metrics["ho_command"] += 1

    def _by_enb_ue_id(self, enb_ue_id):
        # fast path: enb_ue_id == the creation rnti for every context
        # that never went through reestablishment or handover (O(1) at
        # mass-attach scale); linear fallback stays correct for the rest
        u = self.ues.get(enb_ue_id)
        if u is not None and u.enb_ue_id == enb_ue_id:
            return u
        for u in self.ues.values():
            if u.enb_ue_id == enb_ue_id:
                return u
        raise KeyError(enb_ue_id)

    # ================= GTP-U (gtpu.cc) =================
    def gtpu_dl(self, pkt: bytes):
        """S1-U downlink from SPGW -> PDCP DRB (or X2 forwarding tunnel when
        the UE is mid-handover)."""
        teid, ip_pkt = spgw_mod.gtpu_decap(pkt)
        ue = self.by_teid.get(teid)
        if ue is None or DRB1_LCID not in ue.pdcp or ue.state == "RRC_IDLE":
            # DL data for a UE without active bearers (idle after release,
            # or mid service-request): buffer until the context resumes —
            # the SGW downlink-data buffering role (spgw.cc) — and page the
            # UE back into connected (Downlink Data Notification -> paging)
            buf = self._page_buf.setdefault(teid, [])
            if not buf and ue is not None and ue.state == "RRC_IDLE":
                self.page(0)
            if len(buf) < 64:
                buf.append(ip_pkt)
            return
        fwd = getattr(ue, "x2_fwd", None)
        if ue.state == "HO_OUT" and fwd is not None:
            target, teid_fwd = fwd
            target.x2_gtpu_fwd(spgw_mod.gtpu_encap(teid_fwd, ip_pkt))
            return
        # downlink TFT classification (tft_packet_filter.cc): dedicated
        # bearers take matching flows, the default bearer the rest
        lcid = DRB1_LCID
        if getattr(ue, "tft", None) is not None:
            lcid = ue.tft.route(ip_pkt, uplink=False)
            if lcid not in ue.rlc:
                lcid = DRB1_LCID
        ue.rlc[lcid].write_sdu(ue.pdcp[lcid].write_sdu(ip_pkt))
        self._dl_hint.add(ue.rnti)

    def _ul_user_data(self, ue: UeContext, ip_pkt: bytes):
        """PDCP DRB uplink -> GTP-U to SPGW."""
        self.mme.spgw.handle_s1u_pdu(spgw_mod.gtpu_encap(ue.teid_spgw, ip_pkt))
