"""UE stack: MAC (RA + LC mux) / RLC / PDCP / RRC / NAS / USIM / GW.

Reference behavior: `srsue/src/stack/` — ue_stack_lte.cc wiring, mac/ RA
procedure + mux/demux, rrc/rrc.cc (connection establishment, security,
reconfiguration), upper/nas.cc (EMM attach/auth/SMC), upper/usim.cc
(Milenage), upper/gw.cc (IP loop; TUN device optional at the edges).
"""

from __future__ import annotations

import collections
import zlib

import numpy as np

from . import (cb, codec, nas_msgs, nas_wire, pdcp as pdcp_mod, pdu,
               rlc as rlc_mod, rrc_msgs, rrc_wire, security)
from ..runtime.phy_adapter import UlGrant

SRB0, SRB1 = 0, 1
DRB1_LCID = 3


class Usim:
    """Soft USIM (usim.cc): Milenage AKA on the UE side, with SQN
    freshness checking and AUTS resynchronisation (usim.cc:gen_auth_res
    AUTH_SYNCH_FAILURE path / TS 33.102 §6.3.3)."""

    def __init__(self, imsi: str, key: bytes, opc: bytes, sqn_ms: int = 0):
        self.imsi = imsi
        self.key = key
        self.opc = opc
        self.sqn_ms = sqn_ms  # highest SQN accepted so far

    def authenticate(self, rand: bytes, autn: bytes):
        """Returns (res, kasme) on success; raises MacFailure when the
        network's MAC-A does not verify (a false base station / corrupt
        AUTN — 24.301 §5.4.2.6, usim.cc) or SqnSyncFailure carrying the
        AUTS token when the network's SQN is stale."""
        res, ck, ik, ak = security.milenage_f2345(self.key, self.opc, rand)
        sqn = bytes(a ^ b for a, b in zip(autn[:6], ak))
        amf, mac_a = autn[6:8], autn[8:16]
        if security.milenage_f1(self.key, self.opc, rand, sqn,
                                amf) != mac_a:
            raise MacFailure()
        sqn_i = int.from_bytes(sqn, "big")
        if sqn_i <= self.sqn_ms:
            # out-of-order SQN: build AUTS = (SQN_ms ^ AK*) || MAC-S
            sqn_ms = self.sqn_ms.to_bytes(6, "big")
            ak_star = security.milenage_f5_star(self.key, self.opc, rand)
            mac_s = security.milenage_f1_star(
                self.key, self.opc, rand, sqn_ms, b"\x00\x00")
            auts = bytes(a ^ b for a, b in zip(sqn_ms, ak_star)) + mac_s
            raise SqnSyncFailure(auts)
        self.sqn_ms = sqn_i
        kasme = security.kdf_kasme(ck, ik, b"\x00\xf1\x10", autn[:6])
        return res, kasme


class MacFailure(Exception):
    """AKA MAC-A verification failed (AUTN not authentic)."""


class SqnSyncFailure(Exception):
    """AKA sequence-number mismatch; .auts carries the resync token."""

    def __init__(self, auts: bytes):
        super().__init__("SQN out of range")
        self.auts = auts


class UeStack:
    """ue_stack_lte.cc equivalent; exposes the MAC pulls/pushes used by
    runtime.phy_adapter.UePhyAdapter."""

    def __init__(self, usim: Usim, preamble: int = 7, hplmn: int = 1):
        self.usim = usim
        self.preamble = preamble
        # home PLMN + cells barred by PLMN mismatch (rrc.cc plmn_select /
        # nas.cc PLMN selection role; 36.304 suitable-cell criterion)
        assert 0 <= hplmn <= 99, f"hplmn {hplmn} does not fit the MNC digits"
        self.hplmn = hplmn
        self.forbidden_pcis = set()
        # deterministic per-UE salt for backoff randomization (python hash()
        # is per-process seeded, which would make runs irreproducible)
        self._salt = zlib.crc32(usim.imsi.encode())
        self.crnti = None
        self.mac_state = "IDLE"
        self.rrc_state = "IDLE"
        self.emm_state = "DEREGISTERED"
        self.kasme = None
        self.kenb = None
        self.ip_addr = None
        self.ip6_addr = None  # composed prefix + IID (gw.cc IPv6 path)
        self.pdn_type = "ipv4"  # requested PDN type (ipv4 / ipv6 / ipv4v6)
        self.rlc = {}
        self.pdcp = {}
        self.ul_ccch = collections.deque()
        self._ul_grants = collections.deque()
        self._acks = collections.deque()
        self.gw_rx = []  # downlink IP packets delivered to the "TUN"
        self.gw_tx = collections.deque()  # uplink IP packets queued by apps
        self.metrics = collections.Counter()
        self.mib = None
        self.tft = None  # TftMatcher once a dedicated bearer is active
        # carrier aggregation (36.331 SCellToAddMod-r10 / 36.321 §5.13):
        # scell_idx -> {pci, earfcn, active}; configured by reconfiguration,
        # activated by the MAC Activation/Deactivation CE
        self.scells = {}
        # TTI timer wheel (utils/timers.py; nas.cc EMM timers): T3410
        # supervises attach — a UE stuck ATTACHING (connection died before
        # the Accept) falls back to deregistered and re-runs the attach
        from ..utils import timers as timers_mod

        self.timers = timers_mod.TimerHandler()
        self.t3410 = self.timers.get_unique_timer().set(
            1000, self._t3410_expired)
        # 36.331 RRC supervision timers, all on the same TTI wheel
        # (rrc.cc t300/t301/t304/t311 via the timers.h framework):
        self.t300 = self.timers.get_unique_timer().set(
            100, self._t300_expired)  # connection establishment
        self.t301 = self.timers.get_unique_timer().set(
            100, self._t301_expired)  # reestablishment
        self.t304 = self.timers.get_unique_timer().set(
            200, self._t304_expired)  # handover execution
        self.t311 = self.timers.get_unique_timer().set(
            1000, self._t311_expired)  # RLF recovery window
        # T3412 periodic tracking-area-update timer (24.301 §5.3.5): runs
        # while registered-idle; expiry triggers a TAU
        self.t3412 = self.timers.get_unique_timer().set(
            500, self._t3412_expired)

    # ================= bearers =================
    def _rlc_to_pdcp(self, lcid, sdu):
        self.pdcp[lcid].write_pdu(sdu)

    def _setup_srb1(self):
        self.rlc[SRB1] = rlc_mod.RlcAm(deliver=cb.Cb(self, "_rlc_to_pdcp", SRB1))
        self.pdcp[SRB1] = pdcp_mod.PdcpEntity(
            deliver=self._rx_rrc_srb1, is_srb=True, bearer_id=SRB1, is_ue=True)

    def _setup_drb(self, lcid, mode="am"):
        cls = rlc_mod.RlcAm if mode == "am" else rlc_mod.RlcUm
        self.rlc[lcid] = cls(deliver=cb.Cb(self, "_rlc_to_pdcp", lcid))
        k_up = (security.kdf_rrc_up_key(self.kenb, security.EEA2, 0x05)
                if self.kenb else b"\x00" * 16)
        self.pdcp[lcid] = pdcp_mod.PdcpEntity(
            deliver=self._gw_deliver, is_srb=False, bearer_id=lcid,
            ciph_algo=security.EEA2 if self.kenb else security.EEA0,
            k_enc=k_up, is_ue=True)

    # ================= phy adapter interface =================
    P_RNTI = 0xFFFE
    SI_RNTI = 0xFFFF
    sib1 = None
    sib2 = None

    def listen_rntis(self, tti):
        if self.mac_state == "PRACH_SENT":
            # RA-RNTI of OUR prach occasion (36.321 §5.1.4): the RAR-wait
            # sleep only wakes for RARs that can actually answer us
            pt = getattr(self, "_prach_tti", None)
            return {1 + pt % 10} if pt is not None else set(range(1, 11))
        out = {self.crnti} if self.crnti else set()
        if self.sps_cfg is not None and self.crnti:
            out.add(self.sps_cfg.sps_crnti)  # SPS activation/release DCIs
        if self.sib1 is None or self.sib2 is None or self.rrc_state == "IDLE":
            out.add(self.SI_RNTI)  # system information acquisition
        if self.rrc_state == "IDLE" and self.emm_state == "REGISTERED":
            out.add(self.P_RNTI)  # paging occasions while registered-idle
        if getattr(self, "mbms_services", None):
            if self.sib13 is None:
                out.add(self.SI_RNTI)  # must still acquire SIB13
            else:
                out.add(self.M_RNTI)  # MCCH/MTCH on PMCH (MBMS interest)
        return out

    def mib_received(self, tti, pbch):
        self.mib = pbch

    # ---------------- eMBMS reception (rrc.cc mbms_service_start /
    # parse_pdu_mch / add_mrb + gw.cc mbms port) ----------------
    M_RNTI = 0xFFFD
    sib13 = None
    mbsfn_cfg = None  # MbsfnAreaConfig from the MCCH

    def mbms_service_start(self, service_id: int, port: int = 0):
        """Subscribe to an MBMS service by TMGI service id: once the MCCH
        announces it, MTCH payloads on its LCID deliver to mbms_rx."""
        if not hasattr(self, "mbms_services"):
            self.mbms_services = {}
            self.mbms_rx = []
        self.mbms_services[int(service_id)] = port
        self.metrics["mbms_service_start"] += 1

    def mbsfn_received(self, tti, pm: dict):
        """PMCH delivery from the PHY adapter: MCCH (area config, true
        36.331 UPER bytes) or MTCH (one M1-U IP packet)."""
        if pm.get("kind") == "mcch":
            self.mbsfn_cfg = rrc_wire.decode_mcch(pm["data"])
            self.metrics["mcch_rx"] += 1
            return
        cfg = self.mbsfn_cfg
        subs = getattr(self, "mbms_services", None)
        if cfg is None or not subs:
            return  # MTCH before MCCH/subscription: nothing bound yet
        lcid = int(pm.get("lcid", 0))
        for sid, s_lcid in cfg.sessions:
            if int(s_lcid) == lcid and int(sid) in subs:
                self.mbms_rx.append(pm["data"])
                self.metrics["mtch_rx"] += 1
                return

    def is_dormant(self) -> bool:
        """No RECEIVE-side protocol activity in flight: the PHY adapter
        may skip this UE's per-TTI receive work except for frames
        addressing its RNTIs (deployment-scale DRX-like shortcut).  The
        transmit path (PUCCH SR/ACK/CQI, PUSCH, PRACH) runs every TTI
        regardless, so pending uplink state is irrelevant here; frames
        that address this UE (grants, paging, RARs after PRACH — which
        exits dormancy via mac_state) always process."""
        return (self.mac_state in ("CONNECTED", "IDLE")
                and self.rrc_state in ("CONNECTED", "IDLE")
                and not getattr(self, "_connect_pending", False)
                and not getattr(self, "_csfb_pending", None)
                and self.sib1 is not None and self.sib2 is not None)

    # ---- measurements + event reporting (rrc.cc measurement section) ----
    serving_pci = None
    _neigh_snr = None
    _meas_state = None  # meas_id -> dict(count, last_tti, sent)
    # defaults until the network pushes measConfig in a reconfiguration
    # (36.331 reportConfigEUTRA; rrc.cc applies it the same way)
    meas_cfg = rrc_msgs.MeasConfig()

    # message-level medium measures SNR; reports carry true RSRP dBm by
    # referencing it to the noise floor (relative comparisons unchanged)
    _RSRP_REF_DB = -110.0

    def neighbor_meas(self, tti, pci, snr_db):
        if self._neigh_snr is None:
            self._neigh_snr = {}
        prev = self._neigh_snr.get(pci, snr_db)
        self._neigh_snr[pci] = 0.8 * prev + 0.2 * snr_db
        self._eval_measurements(tti)

    def _eval_measurements(self, tti):
        """Evaluate every configured reportConfigEUTRA entry (36.331
        §5.5.4 events A1-A5 + periodical) against the current serving and
        neighbor measurements; entering conditions must hold for
        timeToTrigger evaluations before a report fires."""
        # mac_state gate: no report generation while a handover's RA is in
        # flight (36.331 resets measId state at HO; a report built against
        # the old geometry would steer the target straight back); meas_cfg
        # None = post-HO, awaiting the target's measConfig push
        if self.meas_cfg is None or self.rrc_state != "CONNECTED" \
                or self.mac_state != "CONNECTED":
            return
        serving = getattr(self, "last_rsrp_snr", None)
        if serving is None:
            return
        cfg = self.meas_cfg
        serving_dbm = serving + self._RSRP_REF_DB
        # forbidden-PLMN cells are not reportable (36.331 blacklisted
        # cells / 36.304 suitable-cell criterion): never steer a handover
        # toward a PCI this UE barred at PLMN selection
        cands = {p: v for p, v in (self._neigh_snr or {}).items()
                 if p not in self.forbidden_pcis}
        best = max(cands.items(), key=lambda kv: kv[1]) if cands else None
        # s-Measure (36.331 §5.5.3.1): neighbour measurements are only
        # performed while serving RSRP is below s-Measure
        s_meas = getattr(cfg, "s_measure", 0)
        neigh_ok = not s_meas or serving_dbm < rrc_msgs.rsrp_dbm(s_meas)
        if self._meas_state is None:
            self._meas_state = {}
        for e in cfg.entries():
            st = self._meas_state.setdefault(
                e.meas_id, dict(count=0, last_tti=-(1 << 30), sent=0))
            hy = e.hysteresis_db
            thr = rrc_msgs.rsrp_dbm(e.threshold)
            ev = e.event
            if ev == "a1":
                cond = serving_dbm > thr + hy
            elif ev == "a2":
                cond = serving_dbm < thr - hy
            elif ev == "periodical":
                cond = True
            elif best is None or not neigh_ok:
                cond = False
            elif ev == "a3":
                cond = best[1] > serving + e.offset_db + hy
            elif ev == "a4":
                cond = best[1] + self._RSRP_REF_DB > thr + hy
            elif ev == "a5":
                cond = (serving_dbm < thr - hy
                        and best[1] + self._RSRP_REF_DB
                        > rrc_msgs.rsrp_dbm(e.threshold2) + hy)
            else:
                cond = False
            st["count"] = st["count"] + 1 if cond else 0
            if (st["count"] >= e.time_to_trigger
                    and tti - st["last_tti"] > e.report_interval
                    and (e.report_amount == 0
                         or st["sent"] < e.report_amount)):
                st["last_tti"] = tti
                st["count"] = 0 if ev != "periodical" else st["count"]
                st["sent"] += 1
                neigh = []
                if best is not None and neigh_ok \
                        and ev in ("a3", "a4", "a5", "periodical"):
                    neigh = [[best[0], best[1] + self._RSRP_REF_DB]]
                self._send_srb1(rrc_msgs.MeasurementReport(
                    rsrp_dbm=serving_dbm, neigh=neigh, meas_id=e.meas_id))
                self.metrics["meas_reports"] += 1
                self.metrics[f"meas_report_{ev}"] += 1

    # ---- MIMO channel feedback (precoding.h:45-129 PMI selection /
    # condition number; cqi.c RI/PMI reporting) ----
    _ri = None
    _pmi = None

    # 36.211 Table 6.3.4.2.3-1 two-port rank-1 codebook (second element)
    _CODEBOOK_2TX = (1.0, -1.0, 1j, -1j)

    def mimo_meas(self, tti, h):
        """Feed a (..., 2, 2) DL channel estimate; derives RI from the mean
        2x2 condition number (mat.c srslte_mat_2x2_cn) and the rank-1 PMI
        by codebook power maximization; both ride the next CQI report."""
        h = np.asarray(h, dtype=np.complex64).reshape(-1, 2, 2)
        s = np.linalg.svd(h, compute_uv=False)
        cond_db = float(np.mean(20.0 * np.log10(
            np.maximum(s[:, 0], 1e-9) / np.maximum(s[:, 1], 1e-9))))
        self._ri = 2 if cond_db < 12.0 else 1
        powers = [float(np.mean(np.abs(h[:, :, 0] + w * h[:, :, 1]) ** 2))
                  for w in self._CODEBOOK_2TX]
        self._pmi = int(np.argmax(powers))
        self.metrics["mimo_meas"] += 1

    def get_prach(self, tti):
        if self.mac_state == "HO_PRACH":
            self.mac_state = "PRACH_SENT"
            self._prach_tti = tti  # RA-RNTI epoch (36.321 §5.1.4)
            self._ho_pending = True
            return self._ho_preamble
        if self.mac_state == "IDLE":
            # RA requires system information (rrc.cc cell selection: SIB1 for
            # access, SIB2 for the RACH configuration)...
            if self.sib1 is None or self.sib2 is None:
                return None
            # ...and a connection REASON: initial attach, a page (mobile
            # terminated), or pending UL data (service request) — a released
            # UE otherwise camps in idle (nas.cc/rrc.cc connection triggers)
            want = (self.emm_state != "REGISTERED"
                    or self.rrc_state == "REESTABLISHING"
                    or getattr(self, "_connect_pending", False)
                    or self._pending_ul_bytes() > 0)
            if getattr(self, "emm_forbidden", False):
                want = (self.rrc_state == "REESTABLISHING"
                        or self._pending_ul_bytes() > 0)
            if not want or getattr(self, "_conn_barred", 0) > 0:
                return None
            if getattr(self, "rat", "eutra") != "eutra":
                return None  # camped on the CSFB target RAT, off LTE
            # randomized access stagger (proc_ra.cc backoff): avoids the
            # synchronized-collision livelock when many UEs power on together
            if getattr(self, "_ra_backoff", None) is None:
                # imsi-salted so UEs sharing a (wrapped) preamble index
                # still transmit PRACH in different TTIs
                self._ra_backoff = self._salt % 8
            if self._ra_backoff > 0:
                # counts down in tick() so a backoff-sleeping UE's tick_n
                # catch-up burns the window correctly on wake
                return None
            self._ra_backoff = None
            # NOTE: _connect_pending persists until the connection SUCCEEDS
            # (cleared on RrcConnectionSetup) — a PRACH the eNB never heard
            # must not consume the NAS trigger (nas.cc T3417 retry role)
            self.mac_state = "PRACH_SENT"
            self._prach_tti = tti  # RA-RNTI epoch (36.321 §5.1.4)
            # the index actually transmitted (preambles above the cell's
            # contention pool wrap); RAR matching must use this value
            self._sent_preamble = self.preamble % self.sib2.n_preambles
            return self._sent_preamble
        return None

    _consec_err = 0
    N310 = 10  # consecutive out-of-sync indications before RLF (36.331 T310)

    def sync_indication(self, tti, in_sync: bool, snr_db: float):
        """Per-TTI serving-cell quality indication from the PHY adapter."""
        self.last_rsrp_snr = snr_db
        # serving-quality events (A1/A2) and periodical reports evaluate on
        # every serving measurement, not only when a neighbor frame arrives
        if self.meas_cfg is not None and self.meas_cfg.reports:
            self._eval_measurements(tti)
        if in_sync:
            self._consec_err = 0
            return
        self._consec_err += 1
        if self.rrc_state == "CONNECTED" and self._consec_err >= self.N310:
            # radio link failure -> reestablishment (rrc.cc RLF handling)
            self.metrics["rlf"] += 1
            self._consec_err = 0
            self._old_crnti = self.crnti
            self.rrc_state = "REESTABLISHING"
            self.mac_state = "IDLE"
            self.crnti = None
            self.t311.run()  # 36.331 §5.3.7.3 RLF recovery window

    def active_scell_pcis(self):
        """{pci: scell_idx} of activated SCells — what the PHY monitors
        (srsue scell_recv / set_activation_deactivation_scell)."""
        return {s["pci"]: idx for idx, s in self.scells.items()
                if s["active"]}

    # ---- semi-persistent scheduling (36.321 §5.10) ----
    sps_cfg = None  # SpsConfig once the network pushes it
    _sps_act_tti = None  # activation TTI (PDCCH to SPS C-RNTI)

    def sps_occasion(self, tti):
        """SPS C-RNTI to decode WITHOUT a PDCCH grant at this TTI, or
        None.  Occasions recur every interval from the activation TTI;
        the activation itself arrives WITH a DCI and is excluded."""
        if self.sps_cfg is None or self._sps_act_tti is None:
            return None
        d = tti - self._sps_act_tti
        if d > 0 and d % self.sps_cfg.interval_dl == 0:
            return self.sps_cfg.sps_crnti
        return None

    def tb_decoded(self, tti, payload, snr_db, rnti=None, cc=0):
        # HARQ feedback only for C-RNTI-addressed TBs: broadcast (SI-RNTI /
        # P-RNTI) carries no HARQ (and acking it floods the PUCCH)
        sps_rnti = self.sps_cfg.sps_crnti if self.sps_cfg else None
        if rnti is not None and rnti == sps_rnti:
            if self._sps_act_tti is None:
                # PDCCH to the SPS C-RNTI = activation (36.321 §5.10.1)
                self._sps_act_tti = tti
                self.metrics["sps_activated"] += 1
            self.metrics["sps_rx"] += 1
        own = rnti is None or rnti == self.crnti or rnti == sps_rnti
        # SPS TBs carry no eNB-side HARQ process (losses recover via RLC
        # AM), so they generate no PUCCH HARQ feedback either
        harq_fb = self.crnti and (rnti is None or rnti == self.crnti)
        if payload is None:
            self.metrics["dl_crc_err"] += 1
            if harq_fb:  # HARQ NACK -> eNB retransmits
                self._acks.append(dict(rnti=self.crnti, ack=[0],
                                       ack_cc=[cc]))
            return
        if pdu.is_rar(payload):
            # RARs never parse as ordinary MAC PDUs; a RAR for someone
            # else's preamble (shared RA-RNTI) is simply ignored
            if self.mac_state != "PRACH_SENT":
                return
            rar = pdu.unpack_rar(payload)
            # Backoff Indicator (36.321 §7.2): remember the cell's current
            # backoff window for the next retry, matched or not
            self._ra_bi_ms = rar.get("backoff_ms", 0)
            if getattr(self, "_ho_pending", False) and rar["rapid"] == self._ho_preamble:
                # contention-free RA at the handover target completed
                self._ho_pending = False
                self.t304.stop()
                self.crnti = rar["t_crnti"]
                self.mac_state = "CONNECTED"
                self.rrc_state = "CONNECTED"
                self._send_srb1(rrc_msgs.RrcConnectionReconfigurationComplete())
                self.metrics["ho_complete"] += 1
                return
            if rar["rapid"] == getattr(self, "_sent_preamble", self.preamble):
                self.crnti = rar["t_crnti"]
                self.mac_state = "CONNECTED"
                self._start_rrc_connection()
            return
        for lcid, sdu in pdu.unpack(payload):
            if lcid == pdu.LCID_CCCH:
                self._rx_ccch(sdu, rnti)
            elif lcid == pdu.LCID_CON_RES and len(sdu) == 6:
                # 36.321 §5.1.5 UE Contention Resolution Identity CE:
                # must echo our Msg3 UL-CCCH SDU prefix, else another
                # UE won this C-RNTI
                sent = getattr(self, "_msg3_prefix", None)
                if sent is not None and sdu != sent \
                        and self.rrc_state in ("CONNECTING",
                                               "REESTABLISHING"):
                    self._contention_lost()
                    return
            elif lcid == pdu.LCID_SCELL_ACT and len(sdu) == 1:
                # Activation/Deactivation CE (36.321 §6.1.3.8)
                bitmap = sdu[0]
                for idx, s in self.scells.items():
                    was = s["active"]
                    s["active"] = bool(bitmap & (1 << idx))
                    if s["active"] and not was:
                        self.metrics["scell_activated"] += 1
            elif lcid in self.rlc:
                self.rlc[lcid].write_pdu(sdu)
        # re-check crnti: processing the PDU above may have released the
        # connection (e.g. contention resolution lost cleared the C-RNTI)
        if harq_fb and self.crnti:
            self._acks.append(dict(rnti=self.crnti, ack=[1], ack_cc=[cc]))

    def ul_grant(self, tti, grant):
        self._ul_grants.append(grant)

    _ul_retx = None
    _ul_harq_buf = None

    def harq_ack(self, tti, ack):
        self.metrics["phich_ack" if ack else "phich_nack"] += 1
        if not ack and self._ul_harq_buf is not None:
            self._ul_retx = self._ul_harq_buf  # synchronous UL HARQ retx
        if ack:
            self._ul_harq_buf = None

    def get_pusch(self, tti):
        out = []
        while self._ul_grants:
            g = self._ul_grants.popleft()
            # UL HARQ (ul_harq.cc): a PHICH NACK requeues the stored TB —
            # the retransmission takes this grant before new data
            if getattr(self, "_ul_retx", None) is not None:
                payload = self._ul_retx
                from ..phch import ra as _ra_mod

                if (len(payload) + 3) * 8 > _ra_mod.ul_tbs(
                        min(g.mcs, 28), max(1, g.l_prb)):
                    # link adaptation shrank the grant below the stored
                    # TB: the retransmission cannot ride it — drop and
                    # let RLC AM recover (ul_harq.cc new_grant_ul resets
                    # the process when the adaptive grant changes size)
                    self._ul_retx = None
                    self._ul_harq_buf = None
                    self.metrics["ul_harq_drop"] += 1
                else:
                    self._ul_retx = None
                    self._ul_harq_buf = payload
                    g2 = UlGrant(self.crnti, g.rb_start, g.l_prb, g.mcs,
                                 g.ndi, 2, cqi_request=g.cqi_request)
                    out.append((g2, payload))
                    self.metrics["ul_harq_retx"] += 1
                    continue
            subs = []
            # mux to the grant's transport block size (36.321 mux.cc): the
            # waveform path carries exactly TBS bits, and the message path
            # should not pretend a small grant fits a kilobyte either
            from ..phch import ra as _ra

            room = max(8, min(1000, _ra.ul_tbs(min(g.mcs, 28),
                                               max(1, g.l_prb)) // 8 - 8))
            if self.ul_ccch:
                subs.append((pdu.LCID_CCCH, self.ul_ccch.popleft()))
            # periodic Power Headroom Report CE (36.321 §5.4.6 / proc_phr):
            # PH estimated from the serving DL SNR (channel-symmetric proxy
            # at message level) rides the next PUSCH after the timer
            if (self.mac_state == "CONNECTED"
                    and tti - getattr(self, "_last_phr", -10**6) >= 100
                    and getattr(self, "last_rsrp_snr", None) is not None):
                self._last_phr = tti
                ph = max(-23.0, min(40.0, self.last_rsrp_snr - 17.0))
                subs.append((pdu.LCID_PHR, pdu.phr_ce(ph)))
                self.metrics["phr_tx"] += 1
            for lcid in sorted(self.rlc):
                while room > 8 and self.rlc[lcid].has_data():
                    p = self.rlc[lcid].read_pdu(room - 4)
                    if p is None:
                        break
                    subs.append((lcid, p))
                    room -= len(p) + 3
            if self._pending_ul_bytes():
                # BSR (36.321 §5.4.5): short when one LCG has data, long
                # (four 6-bit table indices) when several do.  LCG0 = SRBs,
                # LCG2 = DRBs (rr.conf default mapping).
                srb_b = (sum(len(s) for s in self.ul_ccch)
                         + sum(100 for l in self.rlc
                               if l <= 2 and self.rlc[l].has_data()))
                drb_b = sum(100 for l in self.rlc
                            if l >= 3 and self.rlc[l].has_data())
                if srb_b and drb_b:
                    subs.append((pdu.LCID_LBSR,
                                 pdu.long_bsr_ce([srb_b, 0, drb_b, 0])))
                    self.metrics["long_bsr_tx"] += 1
                else:
                    lcg = 0 if srb_b else 2
                    n = srb_b or drb_b
                    subs.append((pdu.LCID_SBSR,
                                 bytes([(lcg << 6) | pdu.bsr_index(n)])))
            if subs:
                payload = pdu.pack(subs)
                self._ul_harq_buf = payload  # kept until the PHICH verdict
                g2 = UlGrant(self.crnti, g.rb_start, g.l_prb, g.mcs, g.ndi,
                             g.rv, cqi_request=g.cqi_request)
                out.append((g2, payload))
            elif g.cqi_request:
                # CSI request with no pending data: CQI-only PUSCH
                # (36.213 §7.2.1 aperiodic reporting without UL-SCH data)
                g2 = UlGrant(self.crnti, g.rb_start, g.l_prb, g.mcs, g.ndi,
                             g.rv, cqi_request=1)
                out.append((g2, pdu.pack([])))
        return out

    _cqi_timer = None

    def get_pucch(self, tti):
        # fast path: a UE that is not connected and has nothing pending
        # transmits no PUCCH — at deployment scale this is most UEs most
        # TTIs, so skip the SR/CQI bookkeeping entirely
        if not self._acks and self.mac_state != "CONNECTED":
            return None
        out = None
        if self._acks:
            # multiplex every pending HARQ bit into one PUCCH (format 3 /
            # 1b-CS role): with carrier aggregation there is one bit per
            # component carrier per TTI
            out = self._acks.popleft()
            out.setdefault("ack_cc", [0] * len(out["ack"]))
            while self._acks:
                nxt = self._acks.popleft()
                out["ack"].extend(nxt["ack"])
                out["ack_cc"].extend(
                    nxt.get("ack_cc", [0] * len(nxt["ack"])))
            out["sr"] = self._pending_ul_bytes() > 0
        elif self.mac_state == "CONNECTED" and self._pending_ul_bytes():
            out = dict(rnti=self.crnti, sr=True, ack=[])
        # periodic wideband CQI from the serving-cell SNR (cqi.c reporting)
        if self._cqi_timer is None:
            # wall-TTI based so sleeping TTIs still count toward the period
            self._cqi_timer = tti + self.preamble % 20
        if (self.mac_state == "CONNECTED"
                and (tti - self._cqi_timer) % 10240 >= 20
                and getattr(self, "last_rsrp_snr", None) is not None):
            self._cqi_timer = tti
            cqi = min(15, max(1, int(round(float(self.last_rsrp_snr) / 2.0 + 2))))
            if out is None:
                out = dict(rnti=self.crnti, sr=False, ack=[])
            out["cqi"] = cqi
            if self._ri is not None:  # RI/PMI accompany periodic CQI
                out["ri"] = self._ri
                out["pmi"] = self._pmi
        return out

    def _pending_ul_bytes(self):
        n = sum(len(s) for s in self.ul_ccch)
        for e in self.rlc.values():
            if e.has_data():
                n += 100
        return n

    _ra_timer = 0
    _t300 = 0

    RESEL_HYST_DB = 2.0  # Qhyst (36.304 cell reselection)
    _resel_count = 0

    def tick_n(self, k: int):
        """Catch-up tick after k skipped TTIs (sleeping dormant UE): the
        timer wheel steps exactly k; RLC timer work and the barring
        counter collapse to one pass (idle entities have none anyway)."""
        if k > 1:
            self.timers.step(k - 1)
            if getattr(self, "_conn_barred", 0) > 0:
                self._conn_barred = max(0, self._conn_barred - (k - 1))
            bo = getattr(self, "_ra_backoff", None)
            if bo is not None and bo > 0:
                self._ra_backoff = max(0, bo - (k - 1))
            if self.mac_state == "PRACH_SENT":
                # RAR-window supervision advances through sleep; tick()'s
                # >20 check below then fires the retry exactly once
                self._ra_timer += k - 1
        self.tick()

    def tick(self):
        self.timers.step()
        for e in self.rlc.values():
            e.timer_tick()
        if getattr(self, "_conn_barred", 0) > 0:
            self._conn_barred -= 1
        # RA backoff countdown (here, not in get_prach, so the countdown is
        # tick_n-catch-up safe for the adapter's backoff sleep window)
        bo = getattr(self, "_ra_backoff", None)
        if bo is not None and bo > 0:
            self._ra_backoff = bo - 1
        # idle-mode cell reselection (36.304 §5.2 R-criterion, simplified):
        # a neighbor consistently above serving + Qhyst becomes serving
        if (self.rrc_state == "IDLE" and self.mac_state == "IDLE"
                and self._neigh_snr and self.serving_pci is not None):
            serving = getattr(self, "last_rsrp_snr", None)
            others = {p: v for p, v in self._neigh_snr.items()
                      if p != self.serving_pci
                      and p not in self.forbidden_pcis}
            if serving is not None and others:
                best = max(others.items(), key=lambda kv: kv[1])
                if best[1] > serving + self.RESEL_HYST_DB:
                    self._resel_count += 1
                else:
                    self._resel_count = 0
                if self._resel_count >= 5:
                    self._resel_count = 0
                    self.serving_pci = best[0]
                    self.sib1 = self.sib2 = None  # re-acquire SI on the new cell
                    self.metrics["reselection"] += 1
        # RA supervision (proc_ra.cc backoff/retry): retry PRACH if no RAR
        if self.mac_state == "PRACH_SENT":
            self._ra_timer += 1
            if self._ra_timer > 20:
                self._ra_timer = 0
                # handover RA retries stay contention-free at the target
                self.mac_state = "HO_PRACH" if getattr(self, "_ho_pending", False) else "IDLE"
                self.metrics["ra_retries"] += 1
                # randomized backoff before the next attempt: the window is
                # the larger of the cell-advertised Backoff Indicator
                # (36.321 §7.2, set under RACH overload) and an exponential
                # per-UE ramp — colliding herds spread out instead of
                # re-colliding every response window
                n = self.metrics["ra_retries"]
                win = max(getattr(self, "_ra_bi_ms", 0),
                          min(512, 8 << min(n, 6)))
                self._ra_backoff = (self._salt * 7 + n * 13) % max(8, win)
        else:
            self._ra_timer = 0
        # drain app uplink queue into the DRBs, TFT-classified
        # (gw.cc + tft_packet_filter.cc: dedicated bearers take matching
        # flows in precedence order, everything else rides the default)
        while self.gw_tx and DRB1_LCID in self.pdcp:
            ip_pkt = self.gw_tx.popleft()
            lcid = DRB1_LCID
            if self.tft is not None:
                lcid = self.tft.route(ip_pkt, uplink=True)
                if lcid not in self.rlc:
                    lcid = DRB1_LCID
            self.rlc[lcid].write_sdu(self.pdcp[lcid].write_sdu(ip_pkt))

    # ================= RRC (rrc.cc procedures) =================
    def _start_rrc_connection(self):
        if self.rrc_state == "REESTABLISHING":
            self.t311.stop()  # a cell answered: recovery window met
            self.t301.run()
            data = rrc_wire.encode_ul_ccch(
                rrc_msgs.RrcConnectionReestablishmentRequest(
                    c_rnti=getattr(self, "_old_crnti", 0) or 0,
                    cause="otherFailure"))
            self._msg3_prefix = (data + b"\x00" * 6)[:6]
            self.ul_ccch.append(data)
            return
        self._setup_srb1()
        self.rrc_state = "CONNECTING"
        self.t300.run()
        if self.emm_state == "REGISTERED" and self.guti:
            ident, is_s_tmsi = self.guti, True  # 36.331 s-TMSI choice
        else:
            ident, is_s_tmsi = self._salt & 0xFFFF, False
        data = rrc_wire.encode_ul_ccch(
            rrc_msgs.RrcConnectionRequest(ue_identity=ident,
                                          is_s_tmsi=is_s_tmsi))
        # first 6 octets of the UL-CCCH SDU = the identity the eNB echoes
        # in the 36.321 Contention Resolution CE
        self._msg3_prefix = (data + b"\x00" * 6)[:6]
        self.ul_ccch.append(data)

    def _contention_lost(self):
        """36.321 §5.1.5: another UE's Msg3 won this C-RNTI — back to
        idle, new random access after backoff."""
        self.metrics["contention_lost"] += 1
        self.t300.stop()
        self.rrc_state = "IDLE"
        self.mac_state = "IDLE"
        self.crnti = None
        self._ra_backoff = (self._salt // 7 + 11) % 40
        self._connect_pending = True

    def _rx_ccch(self, sdu, rnti=None):
        # logical channel by addressed RNTI: BCCH (SI-RNTI), PCCH
        # (P-RNTI), else DL-CCCH — each with its real 36.331 schema
        if rnti == self.SI_RNTI:
            msg = rrc_wire.decode_bcch(sdu)
        elif rnti == self.P_RNTI:
            msg = rrc_wire.decode_pcch(sdu)
        else:
            msg = rrc_wire.decode_dl_ccch(sdu)
        if isinstance(msg, rrc_msgs.Sib1):
            if msg.plmn != self.hplmn:
                # PLMN mismatch: this cell is not suitable (36.304 §4.3) —
                # bar its PCI and reselect to the best measured neighbor
                # (rrc.cc plmn_select / cell_selection_criteria role)
                self.metrics["plmn_barred"] += 1
                if self.serving_pci is not None:
                    self.forbidden_pcis.add(self.serving_pci)
                self.sib1 = self.sib2 = None
                alts = {p: v for p, v in (self._neigh_snr or {}).items()
                        if p not in self.forbidden_pcis}
                if alts:
                    self.serving_pci = max(alts.items(),
                                           key=lambda kv: kv[1])[0]
                    self.metrics["plmn_reselect"] += 1
                return
            self.sib1 = msg
            self.metrics["sib1_rx"] += 1
            return
        if isinstance(msg, rrc_msgs.Sib2):
            self.sib2 = msg
            self.metrics["sib2_rx"] += 1
            return
        if isinstance(msg, rrc_msgs.Sib3):
            # network-configured reselection parameters (36.304 §5.2)
            self.RESEL_HYST_DB = float(msg.q_hyst_db)
            self.metrics["sib3_rx"] += 1
            return
        if isinstance(msg, rrc_msgs.Sib13):
            # MBSFN area + MCCH location (rrc.cc handle_sib13): once known,
            # the UE monitors the M-RNTI for MCCH/MTCH on PMCH
            self.sib13 = msg
            self.metrics["sib13_rx"] += 1
            return
        if isinstance(msg, rrc_msgs.RrcConnectionReject):
            # 36.331 §5.3.3.8: start T302 = waitTime; no connection
            # attempts until it expires (the barring counter reuses the
            # access-barring back-off machinery)
            self.metrics["rrc_rejected"] += 1
            self.t300.stop()
            self.rrc_state = "IDLE"
            self.mac_state = "IDLE"
            self.crnti = None
            self._conn_barred = msg.wait_time_s * 1000  # T302 in TTIs
            self._connect_pending = True
            return
        if isinstance(msg, rrc_msgs.RrcConnectionSetup):
            self._connect_pending = False
            # dedicated SchedulingRequestConfig (36.331): the waveform PHY
            # transmits SR on exactly this PUCCH format-1 resource
            if getattr(msg, "sr_pucch_res_idx", -1) >= 0:
                self.sr_pucch_res = msg.sr_pucch_res_idx
            if self.rrc_state == "REESTABLISHING":
                self.t301.stop()
                self.rrc_state = "CONNECTED"
                self.metrics["reest_ok"] += 1
                return
            # contention resolution happens via the 36.321 MAC CE in the
            # demux loop (LCID_CON_RES); reaching here means we won (or
            # an ideal-PHY driver sent no CE)
            self.t300.stop()
            self.rrc_state = "CONNECTED"
            if self.emm_state == "REGISTERED" and getattr(self, "guti", None) is not None:
                # registered-idle reconnect (page / pending UL data): Service
                # Request resumes the existing session (nas.cc), never a
                # fresh attach — keys advance with the NAS uplink count
                self._nas_count = getattr(self, "_nas_count", 0) + 1
                self.kenb = security.kdf_kenb(self.kasme, self._nas_count)
                if getattr(self, "_csfb_pending", None):
                    # CS call from idle (MO or answering a CS page):
                    # Extended Service Request instead (24.301 §5.6.1.2)
                    req = nas_msgs.ExtendedServiceRequest(
                        guti=self.guti, service_type=self._csfb_pending)
                    self._csfb_pending = None
                    self.metrics["ext_service_req"] += 1
                elif getattr(self, "_tau_pending", False):
                    # periodic TAU (T3412 expiry, 24.301 §5.5.3)
                    req = nas_msgs.TrackingAreaUpdateRequest(guti=self.guti)
                    self._tau_pending = False
                    self.metrics["tau_req"] += 1
                else:
                    req = nas_msgs.ServiceRequest(guti=self.guti)
                    self.metrics["service_req"] += 1
                if isinstance(req, nas_msgs.ServiceRequest) \
                        and self.nas_sec is not None:
                    # real 4-byte format with a genuine short MAC; the
                    # network finds us from the RRC S-TMSI (§9.3.1)
                    data = self.nas_sec.service_request()
                else:
                    data = nas_wire.encode(req)
                    if self.nas_sec is not None and not isinstance(
                            req, nas_msgs.ServiceRequest):
                        # integrity-protect with the existing EPS security
                        # context; NOT ciphered (24.301 §4.4.5: initial
                        # NAS like the TAU request stays readable so the
                        # network can route it before context lookup)
                        data = self.nas_sec.protect(data, downlink=False,
                                                    cipher=False)
                self._send_srb1(rrc_msgs.RrcConnectionSetupComplete(
                    nas_pdu=data))
                return
            if getattr(self, "guti", None):
                # previously registered: attach with the stored GUTI
                # (24.301 §5.5.1.2.2); the network asks for the IMSI via
                # the identity procedure if it lost our context
                attach = nas_msgs.AttachRequest(imsi="", guti=self.guti,
                                                pdn_type=self.pdn_type)
            else:
                attach = nas_msgs.AttachRequest(imsi=self.usim.imsi,
                                                pdn_type=self.pdn_type)
            self.nas_sec = None  # fresh registration: new security context
            self._send_srb1(rrc_msgs.RrcConnectionSetupComplete(
                nas_pdu=nas_wire.encode(attach)))
            self.emm_state = "ATTACHING"
            self.t3410.run()
        elif isinstance(msg, rrc_msgs.Paging):
            # identity match: our S-TMSI (GUTI) when registered, the
            # random access identity otherwise; 0 = broadcast wildcard
            my_ids = {0, self._salt & 0xFFFF}
            if getattr(self, "guti", None):
                my_ids.add(self.guti)
            if msg.ue_identity in my_ids:
                self.metrics["paged"] += 1
                if msg.cn_domain == "cs":
                    # CS-domain page = incoming voice call: answer with an
                    # Extended Service Request once connected (23.272 MT
                    # CSFB)
                    self._csfb_pending = "mt-csfb"
                if self.rrc_state == "IDLE":
                    self.mac_state = "IDLE"  # trigger service request via RA
                    self.crnti = None
                    self._connect_pending = True

    def _send_srb1(self, msg):
        self.rlc[SRB1].write_sdu(
            self.pdcp[SRB1].write_sdu(rrc_wire.encode_ul_dcch(msg)))

    def _rx_rrc_srb1(self, sdu):
        msg = rrc_wire.decode_dl_dcch(sdu)
        if isinstance(msg, rrc_msgs.DlInformationTransfer):
            self._rx_nas_pdu(msg.nas_pdu)
        elif isinstance(msg, rrc_msgs.SecurityModeCommand):
            self._send_srb1(rrc_msgs.SecurityModeComplete())
            k_rrc_enc = security.kdf_rrc_up_key(self.kenb, security.EEA2, 0x03)
            k_rrc_int = security.kdf_rrc_up_key(self.kenb, security.EIA2, 0x04)
            self.pdcp[SRB1].config_security(security.EEA2, security.EIA2,
                                            k_rrc_enc, k_rrc_int)
        elif isinstance(msg, rrc_msgs.UECapabilityEnquiry):
            self._send_srb1(rrc_msgs.UECapabilityInformation())
        elif isinstance(msg, rrc_msgs.RrcConnectionReconfiguration):
            if msg.mobility is not None:
                self._execute_handover(msg.mobility)
                return
            for drb in msg.drbs_to_add:
                self._setup_drb(drb.lcid, drb.rlc_mode)
            for sc in getattr(msg, "scells_to_add", []) or []:
                self.scells[sc.scell_idx] = dict(
                    pci=sc.pci, earfcn=sc.earfcn, active=False)
                self.metrics["scell_configured"] += 1
            if getattr(msg, "meas_config", None) is not None:
                # apply the network's measurement configuration (36.331
                # §5.5.2); replaces the defaults wholesale, resetting the
                # per-measId TTT/report state
                self.meas_cfg = msg.meas_config
                self._meas_state = None
                self.metrics["meas_config_applied"] += 1
            if getattr(msg, "sps_config", None) is not None:
                self.sps_cfg = msg.sps_config
                self._sps_act_tti = None  # awaits PDCCH activation
                self.metrics["sps_configured"] += 1
            self._send_srb1(rrc_msgs.RrcConnectionReconfigurationComplete())
            if msg.nas_pdu:
                self._rx_nas_pdu(msg.nas_pdu)
        elif isinstance(msg, rrc_msgs.RrcConnectionRelease):
            self.rrc_state = "IDLE"
            self.mac_state = "IDLE"  # C-RNTI released with the connection
            self.crnti = None
            self._conn_barred = 60  # T302-style wait before re-access
            if self.emm_state == "REGISTERED":
                self.t3412.run()  # periodic TAU supervision in idle
            if msg.redirect_rat != "none":
                # CSFB: leave E-UTRA for the redirected CS RAT; the voice
                # call proceeds there (36.331 redirectedCarrierInfo)
                self.rat = msg.redirect_rat
                self.cs_call_active = True
                self.metrics["csfb_fallback"] += 1
            # tear down bearers (rrc.cc leave_connected): stale RLC state
            # must not retrigger a service request
            for lcid in [l for l in self.rlc if l != SRB1]:
                del self.rlc[lcid], self.pdcp[lcid]
            self._setup_srb1()

    def _execute_handover(self, mob):
        """36.331 handover execution: switch serving cell, re-key from
        KeNB* (from Kasme for S1 HO, from the current KeNB for X2 — the
        keyChangeIndicator distinction), contention-free RA."""
        self.serving_pci = mob.target_pci
        root = self.kasme if getattr(mob, "key_change", "s1") == "s1" else self.kenb
        self.kenb = security.kdf(root, 0x13,
                                 mob.target_pci.to_bytes(2, "big"))
        self._ho_preamble = mob.dedicated_preamble
        # re-establish SRB1/DRB with the new keys (PDCP re-establishment)
        self._setup_srb1()
        k_rrc_enc = security.kdf_rrc_up_key(self.kenb, security.EEA2, 0x03)
        k_rrc_int = security.kdf_rrc_up_key(self.kenb, security.EIA2, 0x04)
        self.pdcp[SRB1].config_security(security.EEA2, security.EIA2,
                                        k_rrc_enc, k_rrc_int)
        self._setup_drb(DRB1_LCID)
        self._neigh_snr = {}
        # measurement config + TTT/report state reset at HO: NO reporting
        # until the target pushes its measConfig (the reference target puts
        # it in the handover command container) — keeping the source's
        # config would ping-pong straight back from the cell edge
        self._meas_state = None
        self.meas_cfg = None
        self.crnti = mob.new_rnti
        self.mac_state = "HO_PRACH"
        self.t304.run()  # 36.331 §5.3.5.6 handover supervision
        self.metrics["ho_exec"] += 1

    # ================= NAS (nas.cc EMM) =================
    nas_sec = None  # EPS NAS security context (set at SMC)

    def _rx_nas_pdu(self, data):
        """Verify-then-dispatch a DL NAS PDU (nas.cc integrity_check):
        the protected Security Mode Command (sec-hdr 3, new context)
        activates the context derived from KASME; thereafter bad-MAC
        messages are dropped."""
        data = bytes(data)
        if (self.nas_sec is None and data and (data[0] & 0x0F) == 7
                and data[0] >> 4 == 3 and self.kasme):
            peek = nas_wire.decode(data)
            if isinstance(peek, nas_msgs.NasSecurityModeCommand):
                self.nas_sec = nas_wire.NasSecurity(self.kasme,
                                                    eia=peek.eia,
                                                    eea=peek.eea)
        if self.nas_sec is None and data and data[0] >> 4 in (2, 4):
            # ciphered NAS without a context: undecipherable — drop
            self.metrics["nas_mac_fail"] += 1
            return
        if self.nas_sec is not None:
            plain, ok = self.nas_sec.unprotect(data, downlink=True)
            if not ok:
                # 24.301 §4.4.4.3: a short list of messages is processed
                # WITHOUT integrity protection even with a live context —
                # the network may have lost ours (Service Reject, fresh
                # authentication, identity, attach reject)
                if data[0] >> 4 == 0:
                    try:
                        msg = nas_wire.decode(data)
                    except Exception:
                        msg = None
                    if isinstance(msg, (nas_msgs.ServiceReject,
                                        nas_msgs.AuthenticationRequest,
                                        nas_msgs.AuthenticationReject,
                                        nas_msgs.IdentityRequest)):
                        self._rx_nas(msg)
                        return
                self.metrics["nas_mac_fail"] += 1
                return
            data = plain
        self._rx_nas(nas_wire.decode(data))

    def _rx_nas(self, msg):
        if isinstance(msg, nas_msgs.AuthenticationRequest):
            try:
                res, kasme = self.usim.authenticate(msg.rand, msg.autn)
            except MacFailure:
                # 24.301 §5.4.2.6: the AUTN is not authentic
                self.metrics["auth_mac_failure"] += 1
                self._send_nas(nas_msgs.AuthenticationFailure(
                    cause="mac-failure"))
                return
            except SqnSyncFailure as e:
                # 24.301 §5.4.2.6: Authentication Failure with the AUTS
                # resync token; the MME resynchronises the HSS and retries
                self.metrics["auth_sync_failure"] += 1
                self._send_nas(nas_msgs.AuthenticationFailure(
                    cause="synch-failure", auts=e.auts))
                return
            self.kasme = kasme
            self._send_nas(nas_msgs.AuthenticationResponse(res=res))
        elif isinstance(msg, nas_msgs.NasSecurityModeCommand):
            if self.nas_sec is None:
                # 24.301 §4.4.4.2: an UNPROTECTED Security Mode Command
                # must not activate security — drop it (the protected
                # sec-hdr-3 path in _rx_nas_pdu is the only activation)
                self.metrics["smc_unprotected_drop"] += 1
                return
            self.kenb = security.kdf_kenb(self.kasme, 0)
            self._send_nas(nas_msgs.NasSecurityModeComplete())
        elif isinstance(msg, nas_msgs.AttachAccept):
            self.ip_addr = msg.ip_addr or None
            if msg.ip6_iid:
                # compose the global address: shared /64 prefix + the
                # network-assigned interface identifier (the RA step of
                # gw.cc collapsed into the emulation's known prefix)
                import socket as _s

                from ..epc import spgw as _spgw

                self.ip6_addr = _s.inet_ntop(
                    _s.AF_INET6,
                    _s.inet_pton(_s.AF_INET6, _spgw.IP6_PREFIX)[:8]
                    + bytes(msg.ip6_iid))
            self.guti = msg.guti
            self._nas_count = 0
            self.emm_state = "REGISTERED"
            self.t3410.stop()
            self._send_nas(nas_msgs.AttachComplete())
            self.metrics["attach_ok"] += 1
        elif isinstance(msg, nas_msgs.AttachReject):
            # 24.301 §5.5.1.2.5: permanent causes (#3, #7, #8, #11, #14)
            # forbid further attach attempts on this PLMN (nas.cc)
            self.metrics["attach_reject"] += 1
            self.t3410.stop()
            self.emm_state = "DEREGISTERED"
            if msg.cause in (3, 7, 8, 11, 14):
                self.emm_forbidden = True
        elif isinstance(msg, nas_msgs.AuthenticationReject):
            # 24.301 §5.4.2.5: the USIM is considered invalid until
            # switch-off — no further attach/service attempts
            self.metrics["auth_reject"] += 1
            self.t3410.stop()
            self.emm_state = "DEREGISTERED"
            self.emm_forbidden = True
        elif isinstance(msg, nas_msgs.DetachRequest):
            # network-initiated detach (24.301 §5.5.2.3): acknowledge
            # and drop to deregistered; re-attach unless switch-off type
            self.metrics["nw_detach"] += 1
            self._send_nas(nas_msgs.DetachAccept())
            self.guti = None
            self.emm_state = "DEREGISTERED"
        elif isinstance(msg, nas_msgs.IdentityRequest):
            self._send_nas(nas_msgs.IdentityResponse(imsi=self.usim.imsi))
            self.metrics["identity_resp"] += 1
        elif isinstance(msg, nas_msgs.EmmInformation):
            self.network_name = msg.full_name
            self.metrics["emm_info_rx"] += 1
        elif isinstance(msg, nas_msgs.ServiceAccept):
            self.metrics["service_ok"] += 1
        elif isinstance(msg, nas_msgs.TrackingAreaUpdateAccept):
            self.metrics["tau_ok"] += 1
            self.t3412.set(msg.t3412)  # refreshed period; restarts in idle
        elif isinstance(msg, nas_msgs.CsServiceNotification):
            # mobile-terminated CS call while connected (24.301 §5.6.2.2):
            # accept by requesting CSFB
            self.metrics["cs_notification"] += 1
            self.metrics["ext_service_req"] += 1
            self._send_nas(nas_msgs.ExtendedServiceRequest(
                guti=self.guti, service_type="mt-csfb"))
        elif isinstance(msg, nas_msgs.ServiceReject):
            # network lost our context: full re-attach (nas.cc T3417/reject)
            self.metrics["service_reject"] += 1
            self.guti = None
            self.emm_state = "DEREGISTERED"
            self.rrc_state = "IDLE"
            self.mac_state = "IDLE"
            self.crnti = None
        elif isinstance(msg, nas_msgs.ActivateDedicatedEpsBearerRequest):
            # ESM dedicated bearer (nas.cc): DRB added by the accompanying
            # RRC reconfiguration; install the TFT for uplink routing
            from . import tft as tft_mod

            lcid = DRB1_LCID + (msg.eps_bearer_id - 5)
            try:
                filters = []
                data = msg.tft
                while data:
                    f, data = tft_mod.PacketFilter.unpack(data)
                    filters.append(f)
            except (ValueError, IndexError):
                self.metrics["ded_bearer_reject"] += 1
                return
            if self.tft is None:
                self.tft = tft_mod.TftMatcher(DRB1_LCID)
            for f in filters:
                self.tft.add_filter(f, lcid)
            self._send_nas(nas_msgs.ActivateDedicatedEpsBearerAccept(
                eps_bearer_id=msg.eps_bearer_id))
            self.metrics["ded_bearer"] += 1

    def _t3410_expired(self, _tid):
        """nas.cc T3410 expiry: the attach never completed — drop to idle
        deregistered and let the connection trigger re-run the attach."""
        if self.emm_state != "ATTACHING":
            return
        self.metrics["t3410_expiry"] += 1
        self.emm_state = "DEREGISTERED"
        self.rrc_state = "IDLE"
        self.mac_state = "IDLE"
        self.crnti = None
        self._ra_backoff = (self._salt // 3 + 23) % 40

    # ---- 36.331 RRC timer expiries (wheel callbacks) ----

    def _t300_expired(self, _tid):
        """Connection establishment failed (Setup never arrived: msg3
        contention loss, CCCH drop): back to idle, redo random access."""
        if self.rrc_state != "CONNECTING":
            return
        self.metrics["t300_expiry"] += 1
        self.rrc_state = "IDLE"
        self.mac_state = "IDLE"
        self.crnti = None
        n = self.metrics["t300_expiry"]
        self._ra_backoff = (self._salt * 5 + n * 17) % 40

    def _t301_expired(self, _tid):
        """Reestablishment unanswered: leave RRC entirely (36.331
        §5.3.7.7 -> RRC_IDLE); NAS stays registered and will service-
        request back."""
        if self.rrc_state != "REESTABLISHING":
            return
        self.metrics["t301_expiry"] += 1
        self.rrc_state = "IDLE"
        self.mac_state = "IDLE"
        self.crnti = None
        self._connect_pending = True

    def _t304_expired(self, _tid):
        """Handover execution failed (no RAR / no target): reestablish on
        the best cell (36.331 §5.3.5.6)."""
        if not getattr(self, "_ho_pending", False) and \
                self.mac_state != "HO_PRACH":
            return
        self.metrics["t304_expiry"] += 1
        self._ho_pending = False
        self._old_crnti = self.crnti
        self.rrc_state = "REESTABLISHING"
        self.mac_state = "IDLE"
        self.crnti = None
        self.t311.run()

    def _t3412_expired(self, _tid):
        """Periodic TAU timer fired while registered-idle: connect and
        run a tracking-area update (24.301 §5.3.5)."""
        if self.emm_state != "REGISTERED" or self.rrc_state != "IDLE":
            return
        self._tau_pending = True
        self._connect_pending = True

    def _t311_expired(self, _tid):
        """No suitable cell answered during the RLF recovery window: give
        up reestablishment and go idle (36.331 §5.3.7.6)."""
        if self.rrc_state != "REESTABLISHING":
            return
        self.metrics["t311_expiry"] += 1
        self.rrc_state = "IDLE"
        self.mac_state = "IDLE"
        self.crnti = None
        self._connect_pending = True

    def _send_nas(self, msg):
        data = nas_wire.encode(msg)
        if self.nas_sec is not None:
            data = self.nas_sec.protect(
                data, downlink=False,
                new_ctx=isinstance(msg, nas_msgs.NasSecurityModeComplete))
        self._send_srb1(rrc_msgs.UlInformationTransfer(nas_pdu=data))

    def aperiodic_cqi(self, n_prb: int) -> dict:
        """Aperiodic HL-subband CQI for a DCI-0 CSI request (cqi.c
        aperiodic on PUSCH).  Wideband CQI from the serving SNR; per-
        subband differentials from the per-subband SNR spread when the PHY
        provides one (flat channel at message level -> diffs of 0).  The
        report round-trips through the REAL 36.212 bit packing."""
        from ..phch import uci

        wb = int(np.clip(round(getattr(self, "last_rsrp_snr", 0.0) / 2.0 + 2),
                         1, 15))
        n_sb = uci.cqi_hl_subband_size(n_prb)
        sb_snr = getattr(self, "last_sb_snr_db", None)
        if sb_snr is not None and len(sb_snr) == n_sb:
            # per-subband CQI from the PHY's subband SNR, coded as the
            # 36.213 Table 7.2.1-2 2-bit differential vs wideband
            diffs = []
            for s_db in sb_snr:
                sb_cqi = int(np.clip(round(float(s_db) / 2.0 + 2), 1, 15))
                off = sb_cqi - wb
                diffs.append(0 if off == 0 else 1 if off == 1
                             else 2 if off >= 2 else 3)
        else:
            diffs = [0] * n_sb
        bits = uci.pack_cqi_hl_subband(wb, diffs, n_prb)
        self.metrics["aperiodic_cqi_tx"] += 1
        return uci.unpack_cqi_hl_subband(bits, n_prb)

    # ---- CSFB (23.272): voice calls fall back to a CS RAT ----
    rat = "eutra"
    cs_call_active = False
    _csfb_pending = None

    def start_cs_call(self):
        """Mobile-originated voice call: request CSFB.  Connected UEs send
        the Extended Service Request directly; idle UEs connect first
        (nas.cc start_service_request with CSFB type)."""
        if self.rrc_state == "CONNECTED":
            self._send_nas(nas_msgs.ExtendedServiceRequest(
                guti=self.guti, service_type="mo-csfb"))
            self.metrics["ext_service_req"] += 1
        else:
            self._csfb_pending = "mo-csfb"
            self._connect_pending = True

    def end_cs_call(self):
        """CS call ended: return to E-UTRA.  The next connection trigger
        (pending data / page) resumes the PS session via Service Request;
        a TAU would run first if the tracking area changed (23.272 §6.5)."""
        self.rat = "eutra"
        self.cs_call_active = False
        self._conn_barred = 0
        self.metrics["csfb_return"] += 1

    def switch_off(self):
        """NAS detach (ue_stack_lte.cc switch_off -> nas detach request)."""
        if self.emm_state == "REGISTERED":
            self._send_nas(nas_msgs.DetachRequest(switch_off=True))
            self.emm_state = "DEREGISTERED"
            self.metrics["detach"] += 1

    # ================= GW (gw.cc) =================
    def _gw_deliver(self, ip_pkt):
        self.gw_rx.append(ip_pkt)
        self.metrics["dl_ip_bytes"] += len(ip_pkt)

    def gw_send(self, ip_pkt: bytes):
        self.gw_tx.append(ip_pkt)
