"""Message-level PHY adapters: grants <-> OTA messages, SINR-gated decode.

Reference behavior: `srsenb/src/phy/phy_adapter.cc` (build ENB_DL_Message per
TTI from MAC's get_dl_sched, extract PRACH/PUCCH/PUSCH from UE_UL_Messages
gated by SINRTester.sinrCheck, :1366-1497) and `srsue/src/phy/phy_adapter.cc`
(mirror; "PDSCH decode = payload copy when SINR test passes; CRC always true;
SNR injected into chest results", :1283-1323).

The adapters talk upward through FAPI-like duck-typed stack callbacks
(get_dl_sched/get_ul_sched/rach_detected/ul_pdu/... on the MAC objects in
stack/enb_stack.py and stack/ue_stack.py), exactly the layering of the
reference's stack_interface_phy_lte / phy_interface_stack_lte.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np

from ..phch import dci as dci_mod, ra
from . import otabus, otamsg


def _prbs_of_mask(prb_mask) -> tuple:
    return tuple(int(i) for i, on in enumerate(prb_mask) if on)


# ---- true DCI payload bits on the wire (phy_adapter.cc:384-431 packs the
# real dci_msg into the protobuf and the UE runs dci unpack on it; SURVEY §8
# calls for explicit schema fields instead of raw side-band blobs) ----

def _bits_to_bytes(bits) -> bytes:
    return np.packbits(np.asarray(bits, dtype=np.uint8)).tobytes()


def _bytes_to_bits(data: bytes, n: int) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, np.uint8))[:n]


def _mask_is_contiguous(prbs: tuple) -> bool:
    return bool(prbs) and prbs[-1] - prbs[0] + 1 == len(prbs)


def _rbg_bitmap_of_prbs(prbs: tuple, n_prb: int) -> int:
    """Type-0 RBG bitmap (36.213 §7.1.6.1), RBG0 at the MSB of the
    n_rbg-bit field — matching pack_dl's MSB-first bit packing."""
    p = ra.rbg_size(n_prb)
    n_rbg = -(-n_prb // p)
    bitmap = 0
    for prb in prbs:
        bitmap |= 1 << (n_rbg - 1 - prb // p)
    return bitmap


def pack_dl_grant_dci(g: "DlGrant", n_prb: int) -> otamsg.DciMsg:
    """DlGrant -> DciMsg with real packed 36.212 payload bits.

    Contiguous allocations ride format 1A (type-2 RIV — the reference uses
    1A for SI/RAR/paging and compact C-RNTI grants); scattered masks ride
    format 1 (type-0 RBG bitmap)."""
    prbs = _prbs_of_mask(g.prb_mask)
    if _mask_is_contiguous(prbs):
        d = dci_mod.DciDl("1A", mcs=g.mcs & 0x1F, harq_pid=g.harq_pid & 7,
                          ndi=g.ndi & 1, rv=g.rv & 3,
                          rb_start=prbs[0], l_crbs=len(prbs))
    else:
        d = dci_mod.DciDl("1", mcs=g.mcs & 0x1F, harq_pid=g.harq_pid & 7,
                          ndi=g.ndi & 1, rv=g.rv & 3,
                          rbg_bitmap=_rbg_bitmap_of_prbs(prbs, n_prb))
    bits = dci_mod.pack_dl(d, n_prb)
    return otamsg.DciMsg(rnti=g.rnti, format=d.format, l_level=g.l_aggr,
                         l_ncce=g.cce_start, num_bits=len(bits),
                         data=_bits_to_bytes(bits))


def pack_ul_grant_dci(g: "UlGrant", n_prb: int) -> otamsg.DciMsg:
    """UlGrant -> format-0 DciMsg with real packed bits.  Per 36.213
    Table 8.6.1-1 an explicit I_MCS 0-28 implies RV 0 (this scheduler's
    adaptive retransmissions re-signal a lowered MCS); I_MCS 29-31 keeps
    the previous modulation and signals RV 1/2/3."""
    mcs = 28 + min(g.rv, 3) if g.rv and g.mcs > 28 else g.mcs & 0x1F
    d = dci_mod.DciUl(mcs=mcs, ndi=g.ndi & 1, rb_start=g.rb_start,
                      l_crbs=max(1, g.l_prb), cqi_req=g.cqi_request & 1)
    bits = dci_mod.pack_ul(d, n_prb)
    return otamsg.DciMsg(rnti=g.rnti, format="0", l_level=4, l_ncce=0,
                         num_bits=len(bits), data=_bits_to_bytes(bits))


def unpack_ul_grant_dci(dci: otamsg.DciMsg, n_prb: int) -> "UlGrant":
    """Recover the UL grant ENTIRELY from the packed format-0 bits (the
    rnti addresses the search space, as in the reference's dci_msg)."""
    bits = _bytes_to_bits(dci.data, dci.num_bits)
    u = dci_mod.unpack_ul(bits, n_prb)
    rv = u.mcs - 28 if u.mcs >= 29 else 0
    return UlGrant(dci.rnti, u.rb_start, u.l_crbs,
                   0 if u.mcs >= 29 else u.mcs, u.ndi, rv,
                   cqi_request=u.cqi_req)


def unpack_dl_grant_dci(dci: otamsg.DciMsg, n_prb: int) -> "dci_mod.DciDl":
    bits = _bytes_to_bits(dci.data, dci.num_bits)
    return dci_mod.unpack_dl(bits, n_prb, dci.format)


# wideband QPSK reference probe: empty PRB list = full-band mean (the
# SinrTester fast path); shared — building per-call tuples dominated the
# 100-UE receive loop
_WB_PROBE = otamsg.ChannelMessage(otamsg.Chan.PDCCH, otamsg.Mod.QPSK, 0)
M_RNTI = 0xFFFD  # MBMS RNTI (36.321 Table 7.1-1): addresses MCCH/MTCH


@dataclasses.dataclass
class DlGrant:
    rnti: int
    prb_mask: tuple
    mcs: int
    payload: bytes
    harq_pid: int = 0
    ndi: int = 0
    rv: int = 0
    # PDCCH CCE placement from the scheduler's allocation over the UE's
    # true 36.213 search space (scheduler_grid.cc alloc_dci)
    l_aggr: int = 4
    cce_start: int = 0
    # SPS occasion: transmit on the semi-persistent allocation with NO
    # PDCCH DCI (36.321 §5.10 — only activation/release use the PDCCH)
    sps_no_dci: int = 0
    # rank-2 spatial multiplexing (waveform mode): tm "tm3"/"tm4" carries
    # a second transport block on the second codeword (DCI format 2A/2)
    tm: str = "1"
    payload2: bytes = b""
    mcs2: int = 0


@dataclasses.dataclass
class UlGrant:
    rnti: int
    rb_start: int
    l_prb: int
    mcs: int
    ndi: int = 0
    rv: int = 0
    cqi_request: int = 0  # DCI-0 CSI request: aperiodic CQI on this PUSCH
    # PDCCH placement of the DCI-0 (allocated from the rnti's true 36.213
    # search space by the MAC's shared per-TTI _CceAlloc; the message path
    # carries them in the bus DciMsg, the waveform path maps them onto the
    # physical CCEs so the UE's blind search can find the grant)
    l_aggr: int = 4
    cce_start: int = 0


class EnbPhyAdapter:
    """eNB-side message-level PHY (enb_dl_* / enb_ul_* of phy_adapter.cc)."""

    def __init__(self, bus: otabus.OtaBus, node_id: int, cell_id: int,
                 n_prb: int, mac, tx_power_mw: float = 1.0,
                 freq_idx: int = 0, tdd_config: int = None):
        self.bus = bus
        self.node_id = node_id
        self.cell_id = cell_id
        self.n_prb = n_prb
        self.mac = mac  # stack_interface_phy_lte equivalent
        self.tx_power_mw = tx_power_mw
        # TDD (36.211 Table 4.2-2): UL/DL configuration index, or None
        # for FDD.  Downlink transmits only on D/S subframes; DCI-0s go
        # out only on subframes with a 36.213 Table 8-2 k-association
        # (phch/tdd.py UL_GRANT_K; phy_common.c:90-163 tables)
        self.tdd_config = tdd_config
        # carrier slot (EARFCN role): cells on different carriers are
        # independent SINR domains — no co-channel interference between
        # them (sinr.py adjudicates per (is_downlink, freq_idx))
        self.freq_idx = freq_idx
        self._seq = 0
        # publish pci -> carrier so UEs can tag their UPLINK with the
        # serving cell's domain (an untagged UL would interfere across
        # carriers that are supposed to be isolated)
        fmap = getattr(bus, "freq_of_cell", None)
        if fmap is None:
            fmap = {}
            try:
                bus.freq_of_cell = fmap
            except AttributeError:
                fmap = None
        if fmap is not None:
            fmap[cell_id] = freq_idx
            for cc_i, pci in enumerate(getattr(mac, "scell_pcis", ()), 1):
                fmap[pci] = cc_i

    def run_tti(self, tti: int):
        self._rx(tti)
        getattr(self.mac, "tick", lambda: None)()
        self._tx(tti)

    # --- uplink receive (enb_ul_get_* , phy_adapter.cc:1366-1497) ---
    def _rx(self, tti: int):
        for frame, tester in self.bus.get_messages(self.node_id):
            msg = frame.msg
            if not isinstance(msg, otamsg.UeUlMessage):
                continue
            if msg.phy_cell_id != self.cell_id:
                continue
            chans = {c.channel_type: c for c in frame.txc.channels}
            # one UL message may carry several PUSCH grants on distinct
            # PRB allocations: the UE appends one ChannelMessage per
            # grant in msg.pusch order, so match them positionally —
            # keying by type alone would adjudicate grant A against
            # grant B's PRBs
            pusch_cms = [c for c in frame.txc.channels
                         if c.channel_type == otamsg.Chan.PUSCH]
            if msg.prach is not None and otamsg.Chan.PRACH in chans:
                passed, _ = tester.check(chans[otamsg.Chan.PRACH])
                if passed:
                    # msg.tti = the PRACH OCCASION tti (not the detection
                    # tti, one later): the RA-RNTI is derived from it, so
                    # both sides must use the same epoch (prach.c ra_rnti)
                    self.mac.rach_detected(msg.tti, msg.prach["preamble_index"])
            for g, cm in zip(msg.pusch, pusch_cms):
                passed, sinr = tester.check(cm)
                self.mac.ul_crc_info(tti, g["rnti"], passed)
                if passed:
                    self.mac.ul_pdu(tti, g["rnti"], g["payload"], sinr)
                    cqi = g.get("cqi")
                    if cqi is not None and hasattr(self.mac, "cqi_info"):
                        try:
                            self.mac.cqi_info(
                                tti, g["rnti"], cqi["wideband_cqi"],
                                sb=cqi.get("subband_diff_cqi"))
                        except TypeError:  # MACs without subband support
                            self.mac.cqi_info(tti, g["rnti"],
                                              cqi["wideband_cqi"])
            for p in msg.pucch:
                if otamsg.Chan.PUCCH not in chans:
                    continue
                passed, _ = tester.check(chans[otamsg.Chan.PUCCH])
                if passed:
                    if p.get("sr"):
                        self.mac.sr_detected(tti, p["rnti"])
                    ccs = p.get("ack_cc") or [0] * len(p.get("ack", []))
                    for ack, cc in zip(p.get("ack", []), ccs):
                        try:
                            self.mac.ack_info(tti, p["rnti"], bool(ack),
                                              cc=cc)
                        except TypeError:  # MACs without CA support
                            self.mac.ack_info(tti, p["rnti"], bool(ack))
                    if p.get("cqi") is not None and hasattr(self.mac, "cqi_info"):
                        self.mac.cqi_info(tti, p["rnti"], p["cqi"],
                                          ri=p.get("ri"), pmi=p.get("pmi"))

    # --- downlink transmit (enb_dl_put_* + send, phy_adapter.cc:795-975) ---
    def _tx(self, tti: int):
        if self.tdd_config is not None:
            from ..phch import tdd as tdd_mod

            if tdd_mod.sf_type(self.tdd_config, tti) == "U":
                return  # uplink subframe: the eNB radiates nothing
            dl_grants = self.mac.get_dl_sched(tti)
            # DCI-0 only on subframes with a PUSCH k-association
            # (36.213 Table 8-2); others defer the UL scheduling pass
            if tti % 10 in tdd_mod.UL_GRANT_K[self.tdd_config]:
                ul_grants = self.mac.get_ul_sched(tti)
            else:
                ul_grants = []
            phich = self.mac.get_phich(tti)
            return self._tx_body(tti, dl_grants, ul_grants, phich)
        dl_grants: typing.List[DlGrant] = self.mac.get_dl_sched(tti)
        ul_grants: typing.List[UlGrant] = self.mac.get_ul_sched(tti)
        phich = self.mac.get_phich(tti)
        return self._tx_body(tti, dl_grants, ul_grants, phich)

    def _tx_body(self, tti: int, dl_grants, ul_grants, phich):
        msg = otamsg.EnbDlMessage(tti=tti, cfi=1, phy_cell_id=self.cell_id)
        txc = otamsg.TxControl(
            tti_tx=tti, phy_cell_id=self.cell_id, is_downlink=True,
            tx_seqnum=self._seq, num_resource_blocks=self.n_prb, cfi=1,
            reference_signal_power_mw=self.tx_power_mw,
            freq_idx=self.freq_idx,
        )
        self._seq += 1
        sf = tti % 10
        all_prbs = tuple(range(self.n_prb))
        if sf in (0, 5):
            msg.pss_sss = True
            txc.channels.append(otamsg.ChannelMessage(
                otamsg.Chan.PBCH, otamsg.Mod.QPSK, 40,
                prb_slot0=all_prbs, prb_slot1=all_prbs))
        if sf == 0:
            msg.pbch = dict(num_prb=self.n_prb, num_antennas=1,
                            phich_resources="1", phich_length=0)
        for g in dl_grants:
            prbs = _prbs_of_mask(g.prb_mask)
            if not g.sps_no_dci:
                msg.pdcch_dl.append(pack_dl_grant_dci(g, self.n_prb))
                txc.channels.append(otamsg.ChannelMessage(
                    otamsg.Chan.PDCCH, otamsg.Mod.QPSK, 72 * g.l_aggr,
                    rnti=g.rnti, prb_slot0=all_prbs, prb_slot1=all_prbs))
            msg.pdsch.append(otamsg.PdschData(
                refid=g.rnti, tb=0, tbs=len(g.payload) * 8, data=g.payload))
            qm = {2: otamsg.Mod.QPSK, 4: otamsg.Mod.QAM16, 6: otamsg.Mod.QAM64}[
                ra.dl_mcs_to_qm(g.mcs)]
            txc.channels.append(otamsg.ChannelMessage(
                otamsg.Chan.PDSCH, qm, len(g.payload) * 8, rnti=g.rnti,
                prb_slot0=prbs, prb_slot1=prbs))
        for g in ul_grants:
            msg.pdcch_ul.append(pack_ul_grant_dci(g, self.n_prb))
            txc.channels.append(otamsg.ChannelMessage(
                otamsg.Chan.PDCCH, otamsg.Mod.QPSK, 72 * 4, rnti=g.rnti,
                prb_slot0=all_prbs, prb_slot1=all_prbs))
        for ph in phich:
            msg.phich.append(ph)
            txc.channels.append(otamsg.ChannelMessage(
                otamsg.Chan.PHICH, otamsg.Mod.BPSK, 1, rnti=ph["rnti"],
                prb_slot0=all_prbs, prb_slot1=all_prbs))
        # eMBMS: MCCH/MTCH on PMCH over the whole MBSFN region
        # (enb phy_adapter.cc PMCH path; addressed to the M-RNTI so
        # MBMS-interested sleepers wake through the listen index)
        mbsfn = getattr(self.mac, "get_mbsfn_tx", None)
        pm = mbsfn(tti) if mbsfn else None
        if pm is not None:
            msg.pmch = dict(area_id=pm["area_id"], kind=pm["kind"],
                            lcid=pm["lcid"], tbs=len(pm["data"]) * 8,
                            rnti=M_RNTI, data=pm["data"])
            txc.channels.append(otamsg.ChannelMessage(
                otamsg.Chan.PMCH, otamsg.Mod.QPSK, len(pm["data"]) * 8,
                rnti=M_RNTI, prb_slot0=all_prbs, prb_slot1=all_prbs))
        self.bus.send_msg(otamsg.OtaFrame(self.node_id, msg, txc))
        # carrier aggregation: one ENB_DL_Message per SCell component
        # carrier (srsenb runs one cc_worker per carrier); SCells carry
        # dedicated data only
        for cc in range(1, getattr(self.mac, "n_carriers", 1)):
            cc_grants = self.mac.get_dl_sched_cc(tti, cc)
            if not cc_grants:
                continue
            pci = self.mac.scell_pcis[cc - 1]
            cmsg = otamsg.EnbDlMessage(tti=tti, cfi=1, phy_cell_id=pci,
                                       carrier_idx=cc)
            ctxc = otamsg.TxControl(
                tti_tx=tti, phy_cell_id=pci, is_downlink=True,
                tx_seqnum=self._seq, num_resource_blocks=self.n_prb, cfi=1,
                reference_signal_power_mw=self.tx_power_mw, freq_idx=cc)
            self._seq += 1
            for g in cc_grants:
                prbs = _prbs_of_mask(g.prb_mask)
                cmsg.pdcch_dl.append(pack_dl_grant_dci(g, self.n_prb))
                ctxc.channels.append(otamsg.ChannelMessage(
                    otamsg.Chan.PDCCH, otamsg.Mod.QPSK, 72 * 4, rnti=g.rnti,
                    prb_slot0=all_prbs, prb_slot1=all_prbs))
                cmsg.pdsch.append(otamsg.PdschData(
                    refid=g.rnti, tb=0, tbs=len(g.payload) * 8,
                    data=g.payload))
                qm = {2: otamsg.Mod.QPSK, 4: otamsg.Mod.QAM16,
                      6: otamsg.Mod.QAM64}[ra.dl_mcs_to_qm(g.mcs)]
                ctxc.channels.append(otamsg.ChannelMessage(
                    otamsg.Chan.PDSCH, qm, len(g.payload) * 8, rnti=g.rnti,
                    prb_slot0=prbs, prb_slot1=prbs))
            self.bus.send_msg(otamsg.OtaFrame(self.node_id, cmsg, ctxc))


class UePhyAdapter:
    """UE-side message-level PHY (srsue phy_adapter.cc)."""

    def __init__(self, bus: otabus.OtaBus, node_id: int, cell_id: int,
                 n_prb: int, stack, tx_power_mw: float = 1.0,
                 tdd_config: int = None):
        self.bus = bus
        self.node_id = node_id
        self.cell_id = cell_id
        self.n_prb = n_prb
        self.stack = stack  # UE MAC/stack callbacks
        self.tx_power_mw = tx_power_mw
        # TDD UL/DL configuration (SIB1 tdd-Config role): the UE transmits
        # PRACH/PUSCH/PUCCH only on 'U' subframes — pending grants, ACKs
        # and preambles are HELD in the stack queues until one arrives
        # (the 36.213 §8 TDD association; ue_stack consumes on call)
        self.tdd_config = tdd_config
        self._seq = 0
        self.last_snr_db = None  # injected into "chest results" (:1307)
        # bind optional callbacks once: getattr per TTI per UE is real cost
        # at 200-UE deployment scale
        self._stack_tick = getattr(stack, "tick", None)
        self._sync_cb = getattr(stack, "sync_indication", None)
        self._neigh_cb = getattr(stack, "neighbor_meas", None)
        self._scells_cb = getattr(stack, "active_scell_pcis", None)
        self._mbsfn_cb = getattr(stack, "mbsfn_received", None)
        self._dormant_cb = getattr(stack, "is_dormant", None)
        self._dorm_w = -1  # stride window of the cached dormancy state
        self._dorm = False
        self._listen_cache = frozenset()
        # sleep/wake scheduling (ttiloop skips us between wakes); the
        # stride adapts upward with consecutive quiet windows (DRX short ->
        # long cycle, 36.321 §5.7 role)
        self._sleep_until = 0
        self._quiet = 0
        self._last_tick_tti = None
        self._tick_n = getattr(stack, "tick_n", None)
        # seed the serving cell so idle-mode reselection has a baseline
        if getattr(stack, "serving_pci", None) is None:
            stack.serving_pci = cell_id

    @property
    def crnti(self):
        return self.stack.crnti

    def run_tti(self, tti: int):
        self._rx(tti)
        if self._tick_n is not None:
            last = self._last_tick_tti
            self._last_tick_tti = tti
            # bus TTIs wrap at 10240: a sleep window spanning the wrap
            # must still deliver its full catch-up tick count
            self._tick_n((tti - last) % 10240 if last is not None else 1)
        elif self._stack_tick is not None:
            self._stack_tick()
        self._tx(tti)
        # schedule the next sleep window: a dormant, transmit-quiet UE
        # sleeps to the next sync-sampling stride boundary
        st = self.stack
        if (self._dormant_cb is not None and self._dormant_cb()
                # REGISTERED, or mid-attach but already RRC-connected: the
                # remaining NAS steps are network-driven and every DL
                # message addresses the C-RNTI, so wake-on-delivery covers
                # them.  A DEREGISTERED *idle* UE must stay awake (it
                # initiates RA itself).
                and (st.emm_state == "REGISTERED"
                     or (st.mac_state == "CONNECTED"
                         and st.rrc_state == "CONNECTED"))
                and not st._acks and not st._ul_grants
                and not st.gw_tx and not st.ul_ccch
                and (st.mac_state != "CONNECTED"
                     or not st._pending_ul_bytes())):
            # consecutive quiet windows double the stride (8 -> 512): a
            # long-idle UE wakes ~2x/s for sync sampling, an active one
            # returns to the short cycle instantly via the else branch.
            # Long strides are safe because any frame actually delivered
            # to a sleeper (paging, grant, neighbor subframe) wakes it
            # immediately through the bus's listen-RNTI index.
            stride = self.LITE_STRIDE << min(self._quiet >> 1, 6)
            self._quiet += 1
            self._sleep_until = tti + stride - ((tti + self.node_id) % stride)
            # register with the bus: sleeping receivers get no delivery
            # (and no SINR testers) for unaddressed serving-cell frames.
            # The adapter's own skip-filter cache must agree (a stale set
            # here would silently eat frames the bus delivered).
            listen = self.stack.listen_rntis(tti)
            self._listen_cache = listen
            self._listen_crnti = self.stack.crnti
            set_sleep = getattr(self.bus, "set_sleep", None)
            if set_sleep is not None:
                set_sleep(self.node_id, self._sleep_until, listen,
                          self.serving_cell)
        elif (self._dormant_cb is not None
              and st.mac_state == "IDLE" and st.rrc_state == "IDLE"
              and max(getattr(st, "_ra_backoff", 0) or 0,
                      getattr(st, "_conn_barred", 0)) > 1
              and not st._acks and not st._ul_grants and not st.gw_tx
              and not st.ul_ccch
              and st.sib1 is not None and st.sib2 is not None):
            # mass-attach wait window (RA backoff and/or T302 barring):
            # the UE has no RNTI yet, so no DL frame can address it, and
            # its only pending event is the window expiry -> sleep exactly
            # through it.  tick_n catch-up burns the countdown on wake and
            # get_prach fires on that TTI.  SI_RNTI is deliberately not
            # listened for: the SIBs are in hand (RA eligibility requires
            # them) and periodic SI broadcasts would otherwise wake every
            # backoff sleeper.  This is where the 500-UE attach storm's
            # time went: 75% of awake UE-TTIs were backoff countdowns.
            self._quiet = 0
            win = max(getattr(st, "_ra_backoff", 0) or 0,
                      getattr(st, "_conn_barred", 0))
            self._sleep_until = tti + win
            set_sleep = getattr(self.bus, "set_sleep", None)
            if set_sleep is not None:
                listen = {r for r in self.stack.listen_rntis(tti)
                          if r != st.SI_RNTI}
                self._listen_cache = listen
                self._listen_crnti = self.stack.crnti
                set_sleep(self.node_id, self._sleep_until, listen,
                          self.serving_cell)
        elif (self._dormant_cb is not None
              and st.mac_state == "PRACH_SENT"
              and not st._acks and not st._ul_grants and not st.ul_ccch
              and getattr(st, "_ra_timer", 0) < 19):
            # RAR wait: the UE listens on the RA-RNTIs (listen_rntis
            # returns them in this state), so any RAR frame wakes it
            # through the bus index; otherwise sleep to the RA-window
            # supervision deadline (tick_n advances _ra_timer in bulk and
            # tick() fires the retry/backoff exactly once on wake).
            self._quiet = 0
            self._sleep_until = tti + (20 - getattr(st, "_ra_timer", 0))
            set_sleep = getattr(self.bus, "set_sleep", None)
            if set_sleep is not None:
                listen = self.stack.listen_rntis(tti)
                self._listen_cache = listen
                self._listen_crnti = self.stack.crnti
                set_sleep(self.node_id, self._sleep_until, listen,
                          self.serving_cell)
        else:
            self._quiet = 0
            if self._sleep_until:
                clear = getattr(self.bus, "clear_sleep", None)
                if clear is not None:
                    clear(self.node_id)
            self._sleep_until = 0

    @property
    def serving_cell(self):
        pci = getattr(self.stack, "serving_pci", None)
        return self.cell_id if pci is None else pci  # PCI 0 is valid

    # dormant-UE receive stride: a UE with no protocol activity samples
    # sync/measurements every Nth TTI and otherwise only reacts to frames
    # that actually address one of its RNTIs — the per-UE-per-TTI work at
    # 200-UE deployment scale collapses to a set intersection
    LITE_STRIDE = 8

    def _rx(self, tti: int):
        # dormancy re-checked every TTI (cheap attribute test); the listen
        # set is cached per stride window, revalidated on C-RNTI change so
        # a mid-window RA completion can't leave a stale set
        stride_tti = (tti + self.node_id) % self.LITE_STRIDE == 0
        dormant = (self._dormant_cb is not None and not stride_tti
                   and self._dormant_cb())
        if dormant:
            w = (tti + self.node_id) // self.LITE_STRIDE
            crnti = self.stack.crnti
            if w != self._dorm_w or crnti != getattr(self, "_listen_crnti",
                                                     -1):
                self._dorm_w = w
                self._listen_crnti = crnti
                self._listen_cache = self.stack.listen_rntis(tti)
            listen = self._listen_cache
        else:
            listen = self.stack.listen_rntis(tti)
        # non-connected UEs (mass-attach phase, RA backoff, SI camping)
        # also skip unaddressed serving-cell subframes off the sync
        # stride: all their protocol triggers (RAR, setup, SI, grants)
        # arrive on listened RNTIs.  CONNECTED UEs keep per-TTI
        # processing — in-sync/out-of-sync RLF sampling needs it.
        lite = (dormant or (self._dormant_cb is not None and not stride_tti
                            and self.stack.rrc_state != "CONNECTED"))
        for frame, tester in self.bus.get_messages(self.node_id):
            msg = frame.msg
            if not isinstance(msg, otamsg.EnbDlMessage):
                continue
            if lite and msg.phy_cell_id == self.serving_cell:
                # serving-cell frame not addressing any of our RNTIs:
                # skip (sync sampling happens on the stride TTIs);
                # neighbor-cell frames always measure below
                if not (otabus.frame_rnti_set(frame) & listen):
                    continue  # nothing for this UE in this subframe
            if msg.phy_cell_id != self.serving_cell:
                # activated SCell carrier? (scell_recv / cc_worker role)
                scells = self._scells_cb() if self._scells_cb else {}
                if msg.phy_cell_id in scells and msg.carrier_idx:
                    self._rx_scell(tti, msg, frame, tester,
                                   scells[msg.phy_cell_id])
                    continue
                # neighbor-cell measurement (intra_measure role)
                _, snr = tester.check(_WB_PROBE)
                if self._neigh_cb:
                    self._neigh_cb(tti, msg.phy_cell_id, snr)
                continue
            # per-frame channel map is receiver-independent: build once and
            # share across the (possibly hundreds of) receiving UEs
            chans = getattr(frame, "_chans", None)
            if chans is None:
                chans = {}
                for c in frame.txc.channels:
                    chans.setdefault((c.channel_type, c.rnti), c)
                frame._chans = chans
            # sync monitoring (36.331 in-sync/out-of-sync -> T310): evaluate
            # a wideband QPSK reference against the serving cell's SINR
            in_sync, snr = tester.check(_WB_PROBE)
            if self._sync_cb:
                self._sync_cb(tti, in_sync, snr)
            if msg.pbch is not None:
                cm = chans.get((otamsg.Chan.PBCH, 0))
                if cm:
                    passed, snr = tester.check(cm)
                    if passed:
                        self.stack.mib_received(msg.tti, msg.pbch)
            pm = msg.pmch
            if pm is not None and self._mbsfn_cb is not None:
                # MCCH/MTCH reception (ue phy_adapter.cc PMCH path): SINR
                # adjudicated like any channel, payload copied on pass
                cm = chans.get((otamsg.Chan.PMCH, pm.get("rnti", M_RNTI)))
                if cm and tester.check(cm)[0]:
                    self._mbsfn_cb(msg.tti, pm)
            # DCI search gated by sinrCheck2(CHAN_PDCCH, rnti) (:306-366)
            if dormant:
                listen = self.stack.listen_rntis(tti)
            for dci in msg.pdcch_dl:
                if dci.rnti not in listen:
                    continue
                cm = chans.get((otamsg.Chan.PDCCH, dci.rnti))
                if not cm or not tester.check(cm)[0]:
                    continue
                # decode the grant from the packed DCI bits (the reference
                # UE runs dci unpack on the protobuf payload,
                # srsue phy_adapter.cc:306-366) — an unparseable payload is
                # a blind-search miss, not a delivered grant
                try:
                    unpack_dl_grant_dci(dci, frame.txc.num_resource_blocks)
                except (ValueError, IndexError):
                    continue
                data = next((d for d in msg.pdsch if d.refid == dci.rnti), None)
                if data is None:
                    continue
                pm = chans.get((otamsg.Chan.PDSCH, dci.rnti))
                passed, snr = tester.check(pm) if pm else (False, -99.0)
                self.last_snr_db = snr
                # message-level decode: payload copy, CRC == sinr pass (:1283)
                try:
                    self.stack.tb_decoded(msg.tti, data.data if passed else None,
                                          snr, rnti=dci.rnti)
                except TypeError:  # legacy MACs without the rnti kwarg
                    self.stack.tb_decoded(msg.tti, data.data if passed else None, snr)
            # SPS occasions: decode the semi-persistent allocation with NO
            # PDCCH DCI in this subframe (36.321 §5.10)
            sps_cb = getattr(self.stack, "sps_occasion", None)
            sps_rnti = sps_cb(msg.tti) if sps_cb else None
            if sps_rnti:
                data = next((d for d in msg.pdsch if d.refid == sps_rnti),
                            None)
                if data is not None:
                    pm = chans.get((otamsg.Chan.PDSCH, sps_rnti))
                    passed, snr = tester.check(pm) if pm else (False, -99.0)
                    self.stack.tb_decoded(
                        msg.tti, data.data if passed else None, snr,
                        rnti=sps_rnti)
            for dci in msg.pdcch_ul:
                if dci.rnti != self.crnti:
                    continue
                cm = chans.get((otamsg.Chan.PDCCH, dci.rnti))
                if not cm or not tester.check(cm)[0]:
                    continue
                # the grant content comes ENTIRELY from the format-0 bits
                self.stack.ul_grant(msg.tti, unpack_ul_grant_dci(
                    dci, frame.txc.num_resource_blocks))
            for ph in msg.phich:
                if ph["rnti"] == self.crnti:
                    self.stack.harq_ack(msg.tti, bool(ph["ack"]))

    def _rx_scell(self, tti, msg, frame, tester, cc):
        """DCI search + PDSCH decode on an activated SCell carrier; HARQ
        feedback rides the PCell PUCCH tagged with the cc index."""
        chans = getattr(frame, "_chans", None)
        if chans is None:
            chans = {}
            for c in frame.txc.channels:
                chans.setdefault((c.channel_type, c.rnti), c)
            frame._chans = chans
        crnti = self.crnti
        for dci in msg.pdcch_dl:
            if dci.rnti != crnti:
                continue
            cm = chans.get((otamsg.Chan.PDCCH, dci.rnti))
            if not cm or not tester.check(cm)[0]:
                continue
            try:
                unpack_dl_grant_dci(dci, frame.txc.num_resource_blocks)
            except (ValueError, IndexError):
                continue
            data = next((d for d in msg.pdsch if d.refid == dci.rnti), None)
            if data is None:
                continue
            pm = chans.get((otamsg.Chan.PDSCH, dci.rnti))
            passed, snr = tester.check(pm) if pm else (False, -99.0)
            self.stack.tb_decoded(msg.tti, data.data if passed else None,
                                  snr, rnti=dci.rnti, cc=cc)

    def _tx(self, tti: int):
        if self.tdd_config is not None:
            from ..phch import tdd as tdd_mod

            if tdd_mod.sf_type(self.tdd_config, tti) != "U":
                # D/S subframe: hold everything (queues keep pending
                # preambles/grants/ACKs until the next UL subframe)
                return
        serving = self.serving_cell
        prach_idx = self.stack.get_prach(tti)
        pusch = self.stack.get_pusch(tti)
        pucch = self.stack.get_pucch(tti)
        if prach_idx is None and not pusch and not pucch:
            return  # idle UE: skip message/txc construction entirely
        msg = otamsg.UeUlMessage(tti=tti, crnti=self.crnti or 0,
                                 phy_cell_id=serving)
        txc = otamsg.TxControl(
            tti_tx=tti, phy_cell_id=serving, is_downlink=False,
            tx_seqnum=self._seq, num_resource_blocks=self.n_prb,
            reference_signal_power_mw=self.tx_power_mw,
            # uplink rides the serving cell's carrier (EARFCN role): UL of
            # different-carrier cells must not pool as interference
            freq_idx=getattr(self.bus, "freq_of_cell", {}).get(serving, 0),
        )
        self._seq += 1
        any_tx = False
        if prach_idx is not None:
            msg.prach = dict(preamble_index=prach_idx)
            prach_prbs = tuple(range(6))
            txc.channels.append(otamsg.ChannelMessage(
                otamsg.Chan.PRACH, otamsg.Mod.BPSK, 839,
                prb_slot0=prach_prbs, prb_slot1=prach_prbs))
            any_tx = True
        for g, payload in pusch:
            prbs = tuple(range(g.rb_start, g.rb_start + g.l_prb))
            entry = dict(rnti=g.rnti, rb_start=g.rb_start,
                         l_prb=g.l_prb, mcs=g.mcs, payload=payload)
            if g.cqi_request and hasattr(self.stack, "aperiodic_cqi"):
                # DCI-0 CSI request: the aperiodic HL-subband report rides
                # this PUSCH (cqi.c aperiodic on UL-SCH, sch.c UCI mux)
                entry["cqi"] = self.stack.aperiodic_cqi(self.n_prb)
            msg.pusch.append(entry)
            qm = {2: otamsg.Mod.QPSK, 4: otamsg.Mod.QAM16, 6: otamsg.Mod.QAM64}[
                ra.ul_mcs_to_qm(g.mcs)]
            txc.channels.append(otamsg.ChannelMessage(
                otamsg.Chan.PUSCH, qm, len(payload) * 8, rnti=g.rnti,
                prb_slot0=prbs, prb_slot1=prbs))
            any_tx = True
        if pucch:
            msg.pucch.append(pucch)
            # PUCCH region: resource index -> edge PRB pair (code-multiplexed
            # UEs in the same pair are orthogonal; model them in distinct
            # pairs so same-cell PUCCHs don't self-interfere)
            m = pucch["rnti"] % 4
            edge = (m % self.n_prb, self.n_prb - 1 - (m % self.n_prb))
            txc.channels.append(otamsg.ChannelMessage(
                otamsg.Chan.PUCCH, otamsg.Mod.BPSK, 2, rnti=pucch["rnti"],
                prb_slot0=edge, prb_slot1=edge))
            any_tx = True
        if any_tx:
            self.bus.send_msg(otamsg.OtaFrame(self.node_id, msg, txc))
