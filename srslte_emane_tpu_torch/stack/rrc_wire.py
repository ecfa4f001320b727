"""True 36.331 UPER bytes on the live RRC SRB wire.

Reference behavior: every RRC message srsenb/srsue exchange is UPER
encoded by the generated `lib/src/asn1/rrc_asn1.cc` codec.  This module
gives the emulation the same property: it bridges the typed
`stack/rrc_msgs.py` dataclasses the stacks act on to real 36.331
messages through the capture-proven `stack/asn1/rrc36331.py` schema
runtime (byte-exact against the reference's rrc_asn1_test.cc vectors),
one encoder/decoder pair per logical channel:

  UL-CCCH  RRCConnectionRequest (S-TMSI / random ue-Identity),
           RRCConnectionReestablishmentRequest
  DL-CCCH  RRCConnectionSetup (srb1 radioResourceConfigDedicated),
           RRCConnectionReestablishment
  PCCH     Paging (s-TMSI paging records, cn-Domain)
  UL-DCCH  SetupComplete (dedicatedInfoNAS), SecurityModeComplete,
           ReconfigurationComplete, ULInformationTransfer,
           MeasurementReport, UECapabilityInformation
  DL-DCCH  SecurityModeCommand, RRCConnectionReconfiguration (DRBs,
           measConfig, mobilityControlInfo, sps-Config,
           sCellToAddModList-r10, dedicatedInfoNASList),
           RRCConnectionRelease (redirectedCarrierInfo),
           DLInformationTransfer, UECapabilityEnquiry

Quantized fields snap to their spec granularity on the wire (a3-offset /
hysteresis in 0.5 dB steps, timeToTrigger / reportInterval to the
36.331 enumerations, RSRP/RSRQ to their 36.133 ranges) — decode returns
the quantized value, exactly like the reference.

The UE Contention Resolution Identity does NOT ride in
RRCConnectionSetup (the internal codec's shortcut): it is a real 36.321
MAC CE (pdu.LCID_CON_RES) built from the first 6 octets of the UE's
Msg3 UL-CCCH SDU, packed by the eNB next to the setup message.
"""

from __future__ import annotations

from . import rrc_msgs
from .asn1 import rrc36331 as r
from .asn1.runtime import BitReader, DecodeError, uper_encode


def _bits(v: int, n: int) -> str:
    return format(int(v) & ((1 << n) - 1), f"0{n}b")


def _unbits(s: str) -> int:
    return int(s, 2) if s else 0


def _dec(typ, data: bytes):
    return typ.dec(BitReader(bytes(data)))


# ---- enumeration maps ------------------------------------------------------

_EST_CAUSE = {  # rrc_msgs cause <-> 36.331 EstablishmentCause
    "emergency": "emergency", "highPriorityAccess": "high_prio_access",
    "mt-Access": "mt_access", "mo-Signalling": "mo_sig",
    "mo-Data": "mo_data",
}
_EST_CAUSE_INV = {v: k for k, v in _EST_CAUSE.items()}

_REEST_CAUSE = {"reconfigurationFailure": "recfg_fail",
                "handoverFailure": "ho_fail", "otherFailure": "other_fail"}
_REEST_CAUSE_INV = {v: k for k, v in _REEST_CAUSE.items()}

_REL_CAUSE = {"loadBalancingTAUrequired": "load_balancing_ta_urequired",
              "other": "other",
              "cs-FallbackHighPriority": "cs_fallback_high_prio_v1020"}
_REL_CAUSE_INV = {v: k for k, v in _REL_CAUSE.items()}

_SPS_IVL = (10, 20, 32, 40, 64, 80, 128, 160, 320, 640)
_TTT_MS = (0, 40, 64, 80, 100, 128, 160, 256, 320, 480, 512, 640, 1024,
           1280, 2560, 5120)
_REPORT_IVL_MS = (120, 240, 480, 640, 1024, 2048, 5120, 10240)
_AMOUNTS = (1, 2, 4, 8, 16, 32, 64)  # reportAmount enum r1..r64


def _nearest(values, x):
    return min(range(len(values)), key=lambda i: abs(values[i] - x))


def _rsrp_range(dbm: float) -> int:
    return max(0, min(97, int(round(dbm + 140.0))))


def _rsrq_range(db: float) -> int:
    return max(0, min(34, int(round(2.0 * (db + 19.5)))))


# canonical RadioResourceConfigCommon for mobilityControlInfo (the target
# cell's common config; netsim cells share one profile)
def _rr_cfg_common() -> dict:
    return dict(
        prach_cfg=dict(root_seq_idx=0),
        pusch_cfg_common=dict(
            pusch_cfg_basic=dict(n_sb=1, hop_mode="inter_sub_frame",
                                 pusch_hop_offset=0, enable64_qam=True),
            ul_ref_sigs_pusch=dict(group_hop_enabled=False,
                                   group_assign_pusch=0,
                                   seq_hop_enabled=False, cyclic_shift=0)),
        ul_cp_len="len1",
    )


_AM_RLC = ("am", dict(
    ul_am_rlc=dict(t_poll_retx="ms45", poll_pdu="p64", poll_byte="kb500",
                   max_retx_thres="t4"),
    dl_am_rlc=dict(t_reordering="ms35", t_status_prohibit="ms0")))
_UM_RLC = ("um_bi_dir", dict(ul_um_rlc=dict(sn_field_len="size10"),
                             dl_um_rlc=dict(sn_field_len="size10",
                                            t_reordering="ms35")))


# ---- UL-CCCH ---------------------------------------------------------------

def encode_ul_ccch(msg) -> bytes:
    if isinstance(msg, rrc_msgs.RrcConnectionRequest):
        if msg.is_s_tmsi:
            ident = ("s_tmsi", dict(mmec=_bits(1, 8),
                                    m_tmsi=_bits(msg.ue_identity, 32)))
        else:
            ident = ("random_value", _bits(msg.ue_identity, 40))
        tree = dict(msg=("c1", ("rrc_conn_request", dict(
            crit_exts=("rrc_conn_request_r8", dict(
                ue_id=ident,
                establishment_cause=_EST_CAUSE[msg.cause],
                spare="0"))))))
        return uper_encode(r.UL_CCCH_MSG, tree)
    if isinstance(msg, rrc_msgs.RrcConnectionReestablishmentRequest):
        tree = dict(msg=("c1", ("rrc_conn_reest_request", dict(
            crit_exts=("rrc_conn_reest_request_r8", dict(
                ue_id=dict(c_rnti=_bits(msg.c_rnti, 16), pci=0,
                           short_mac_i=_bits(0, 16)),
                reest_cause=_REEST_CAUSE[msg.cause],
                spare="00"))))))
        return uper_encode(r.UL_CCCH_MSG, tree)
    raise TypeError(f"no UL-CCCH mapping for {type(msg).__name__}")


def decode_ul_ccch(data: bytes):
    _alt, (name, val) = _dec(r.UL_CCCH_MSG, data)["msg"]
    if name == "rrc_conn_request":
        _r8, body = val["crit_exts"]
        kind, ident = body["ue_id"]
        if kind == "s_tmsi":
            ue_id, is_s = _unbits(ident["m_tmsi"]), True
        else:
            ue_id, is_s = _unbits(ident), False
        return rrc_msgs.RrcConnectionRequest(
            ue_identity=ue_id,
            cause=_EST_CAUSE_INV[body["establishment_cause"]],
            is_s_tmsi=is_s)
    _r8, body = val["crit_exts"]
    return rrc_msgs.RrcConnectionReestablishmentRequest(
        c_rnti=_unbits(body["ue_id"]["c_rnti"]),
        cause=_REEST_CAUSE_INV[body["reest_cause"]])


# ---- DL-CCCH ---------------------------------------------------------------

def encode_dl_ccch(msg) -> bytes:
    if isinstance(msg, rrc_msgs.RrcConnectionSetup):
        rr = dict(srb_to_add_mod_list=[dict(
            srb_id=1, rlc_cfg=("default_value", None),
            lc_ch_cfg=("default_value", None))])
        if getattr(msg, "sr_pucch_res_idx", -1) >= 0:
            # dedicated SchedulingRequestConfig (36.331 §6.3.2): the
            # waveform UE's SR rides exactly this PUCCH format-1 resource
            rr["phys_cfg_ded"] = dict(sched_request_cfg=("setup", dict(
                sr_pucch_res_idx=msg.sr_pucch_res_idx,
                sr_cfg_idx=0, dsr_trans_max="n64")))
        tree = dict(msg=("c1", ("rrc_conn_setup", dict(
            rrc_transaction_id=0,
            crit_exts=("c1", ("r8", dict(rr_cfg_ded=rr)))))))
        return uper_encode(r.DL_CCCH_MSG, tree)
    if isinstance(msg, rrc_msgs.RrcConnectionReject):
        tree = dict(msg=("c1", ("rrc_conn_reject", dict(
            crit_exts=("c1", ("r8", dict(
                wait_time=max(1, min(16, msg.wait_time_s)))))))))
        return uper_encode(r.DL_CCCH_MSG, tree)
    raise TypeError(f"no DL-CCCH mapping for {type(msg).__name__}")


def decode_dl_ccch(data: bytes):
    _alt, (name, val) = _dec(r.DL_CCCH_MSG, data)["msg"]
    if name == "rrc_conn_setup":
        # the contention-resolution identity rides the 36.321 MAC CE,
        # not this message: 0 = resolved by CE (or wildcard)
        _c1, (_r8, body) = val["crit_exts"]
        sr_idx = -1
        phys = (body.get("rr_cfg_ded") or {}).get("phys_cfg_ded")
        if phys and phys.get("sched_request_cfg"):
            which, cfg = phys["sched_request_cfg"]
            if which == "setup":
                sr_idx = cfg["sr_pucch_res_idx"]
        return rrc_msgs.RrcConnectionSetup(con_res_id=0,
                                           sr_pucch_res_idx=sr_idx)
    if name == "rrc_conn_reject":
        _c1, (_r8, body) = val["crit_exts"]
        return rrc_msgs.RrcConnectionReject(wait_time_s=body["wait_time"])
    raise DecodeError(f"unhandled DL-CCCH {name}")


# ---- PCCH ------------------------------------------------------------------

def encode_pcch(msg: rrc_msgs.Paging) -> bytes:
    tree = dict(msg=("c1", ("paging", dict(
        paging_record_list=[dict(
            ue_identity=("s_tmsi", dict(
                mmec=_bits(1, 8), m_tmsi=_bits(msg.ue_identity, 32))),
            cn_domain=msg.cn_domain)]))))
    return uper_encode(r.PCCH_MSG, tree)


def decode_pcch(data: bytes) -> rrc_msgs.Paging:
    _alt, (_name, val) = _dec(r.PCCH_MSG, data)["msg"]
    recs = val.get("paging_record_list") or []
    if not recs:
        return rrc_msgs.Paging(ue_identity=0)
    kind, ident = recs[0]["ue_identity"]
    ue_id = _unbits(ident["m_tmsi"]) if kind == "s_tmsi" else 0
    return rrc_msgs.Paging(ue_identity=ue_id,
                           cn_domain=recs[0]["cn_domain"])


# ---- BCCH-DL-SCH (SIB1 / SystemInformation+SIB2) ---------------------------

def _snap_enum(values, x, fmt):
    return fmt.format(values[_nearest(values, x)])


def encode_bcch(msg) -> bytes:
    """SI content is static per cell but broadcast every SI period: cache
    the UPER encoding by message value (deployment-scale hot path)."""
    import dataclasses as _dc

    key = (type(msg).__name__, _dc.astuple(msg))
    hit = _BCCH_ENC_CACHE.get(key)
    if hit is None:
        hit = _encode_bcch(msg)
        if len(_BCCH_ENC_CACHE) > 64:
            _BCCH_ENC_CACHE.clear()
        _BCCH_ENC_CACHE[key] = hit
    return hit


_BCCH_ENC_CACHE: dict = {}


def _encode_bcch(msg) -> bytes:
    if isinstance(msg, rrc_msgs.Sib1):
        sib1 = dict(
            cell_access_related_info=dict(
                plmn_id_list=[dict(
                    # simplified PLMN int rides the MNC digits (mcc 001)
                    plmn_id=dict(mcc=[0, 0, 1],
                                 mnc=[(msg.plmn // 10) % 10, msg.plmn % 10]),
                    cell_reserved_for_oper="not_reserved")],
                tac=_bits(msg.tac, 16),
                cell_id=_bits(msg.cell_identity, 28),
                cell_barred="not_barred",
                intra_freq_resel="allowed", csg_ind=False),
            cell_sel_info=dict(q_rx_lev_min=max(-70, min(-22, int(
                round(msg.q_rx_lev_min_dbm / 2.0))))),
            freq_band_ind=1,
            sched_info_list=[dict(si_periodicity="rf8",
                                  sib_map_info=[])],
            si_win_len=_snap_enum((1, 2, 5, 10, 15, 20, 40),
                                  msg.si_window_ms, "ms{}"),
            sys_info_value_tag=0)
        tree = dict(msg=("c1", ("sib_type1", sib1)))
        return uper_encode(r.BCCH_DL_SCH_MSG, tree)
    if isinstance(msg, rrc_msgs.Sib2):
        rach = dict(
            preamb_info=dict(nof_ra_preambs=_snap_enum(
                tuple(range(4, 65, 4)), msg.n_preambles, "n{}")),
            pwr_ramp_params=dict(
                pwr_ramp_step="db2",
                preamb_init_rx_target_pwr="dbm_minus104"),
            ra_supervision_info=dict(
                preamb_trans_max="n10",
                ra_resp_win_size=_snap_enum((2, 3, 4, 5, 6, 7, 8, 10),
                                            msg.ra_response_window,
                                            "sf{}"),
                mac_contention_resolution_timer=_snap_enum(
                    tuple(range(8, 65, 8)), msg.mac_con_res_timer,
                    "sf{}")),
            max_harq_msg3_tx=4)
        rr = dict(
            rach_cfg_common=rach,
            bcch_cfg=dict(mod_period_coeff="n4"),
            pcch_cfg=dict(default_paging_cycle="rf128", nb="one_t"),
            prach_cfg=dict(root_seq_idx=0, prach_cfg_info=dict(
                prach_cfg_idx=msg.prach_config_index,
                high_speed_flag=False, zero_correlation_zone_cfg=11,
                prach_freq_offset=msg.prach_freq_offset)),
            pdsch_cfg_common=dict(ref_sig_pwr=0, p_b=0),
            pusch_cfg_common=_rr_cfg_common()["pusch_cfg_common"],
            pucch_cfg_common=dict(delta_pucch_shift="ds1", n_rb_cqi=1,
                                  n_cs_an=0, n1_pucch_an=0),
            srs_ul_cfg_common=("release", None),
            ul_pwr_ctrl_common=dict(
                p0_nominal_pusch=-85, alpha="al07",
                p0_nominal_pucch=-107,
                delta_flist_pucch=dict(
                    delta_f_pucch_format1="delta_f0",
                    delta_f_pucch_format1b="delta_f3",
                    delta_f_pucch_format2="delta_f1",
                    delta_f_pucch_format2a="delta_f0",
                    delta_f_pucch_format2b="delta_f0"),
                delta_preamb_msg3=4),
            ul_cp_len="len1")
        sib2 = dict(
            rr_cfg_common=rr,
            ue_timers_and_constants=dict(
                t300="ms100", t301="ms100", t310="ms1000", n310="n10",
                t311="ms1000", n311="n1"),
            freq_info=dict(add_spec_emission=1),
            time_align_timer_common="infinity")
        tree = dict(msg=("c1", ("sys_info", dict(
            crit_exts=("sys_info_r8", dict(
                sib_type_and_info=[("sib2", sib2)]))))))
        return uper_encode(r.BCCH_DL_SCH_MSG, tree)
    if isinstance(msg, rrc_msgs.Sib3):
        q_vals = (0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24)
        sib3 = dict(
            cell_resel_info_common=dict(
                q_hyst=f"db{q_vals[_nearest(q_vals, msg.q_hyst_db)]}"),
            cell_resel_serving_freq_info=dict(
                thresh_serving_low=0, cell_resel_prio=4),
            intra_freq_cell_resel_info=dict(
                q_rx_lev_min=-65, presence_ant_port1=False,
                neigh_cell_cfg="01",
                t_resel_eutra=max(0, min(7, msg.t_resel_s))))
        tree = dict(msg=("c1", ("sys_info", dict(
            crit_exts=("sys_info_r8", dict(
                sib_type_and_info=[("sib3", sib3)]))))))
        return uper_encode(r.BCCH_DL_SCH_MSG, tree)
    if isinstance(msg, rrc_msgs.Sib13):
        rep = {32: "rf32", 64: "rf64", 128: "rf128", 256: "rf256"}
        mcs = {2: "n2", 7: "n7", 13: "n13", 19: "n19"}
        sib13 = dict(
            mbsfn_area_info_list_r9=[dict(
                mbsfn_area_id_r9=msg.area_id,
                non_mbsfn_region_len="s2",
                notif_ind_r9=0,
                mcch_cfg_r9=dict(
                    mcch_repeat_period_r9=rep.get(msg.mcch_rep_rf, "rf32"),
                    mcch_offset_r9=msg.mcch_offset,
                    mcch_mod_period_r9="rf512",
                    sf_alloc_info_r9="100000",
                    sig_mcs_r9=mcs.get(msg.sig_mcs, "n2")))],
            notif_cfg_r9=dict(notif_repeat_coeff_r9="n2",
                              notif_offset_r9=0, notif_sf_idx_r9=1))
        tree = dict(msg=("c1", ("sys_info", dict(
            crit_exts=("sys_info_r8", dict(
                sib_type_and_info=[("sib13_v920", sib13)]))))))
        return uper_encode(r.BCCH_DL_SCH_MSG, tree)
    raise TypeError(f"no BCCH mapping for {type(msg).__name__}")


def encode_mcch(cfg) -> bytes:
    """MbsfnAreaConfig -> true 36.331 MCCH-Message UPER bytes
    (MBSFNAreaConfiguration-r9; schema stack/asn1/rrc36331.py MCCH_MSG)."""
    sessions = [dict(
        tmgi_r9=dict(plmn_id_r9=("plmn_idx_r9", 1),
                     service_id_r9=int(sid).to_bytes(3, "big")),
        lc_ch_id_r9=int(lcid),
    ) for sid, lcid in cfg.sessions]
    tree = dict(msg=("c1", ("mbsfn_area_cfg_r9", dict(
        common_sf_alloc_r9=[dict(
            radioframe_alloc_period="n1", radioframe_alloc_offset=0,
            sf_alloc=("one_frame", "100110"))],
        common_sf_alloc_period_r9="rf8",
        pmch_info_list_r9=[dict(
            pmch_cfg_r9=dict(
                sf_alloc_end_r9=cfg.sf_alloc_end,
                data_mcs_r9=cfg.data_mcs,
                mch_sched_period_r9="rf8"),
            mbms_session_info_list_r9=sessions)]))))
    return uper_encode(r.MCCH_MSG, tree)


def decode_mcch(data: bytes):
    """MCCH-Message UPER bytes -> MbsfnAreaConfig."""
    _name, cfg = _dec(r.MCCH_MSG, data)["msg"][1]
    pmchs = cfg["pmch_info_list_r9"]
    sessions = []
    data_mcs, sf_alloc_end = 2, 64
    for p in pmchs:
        data_mcs = p["pmch_cfg_r9"]["data_mcs_r9"]
        sf_alloc_end = p["pmch_cfg_r9"]["sf_alloc_end_r9"]
        for s in p["mbms_session_info_list_r9"]:
            sid = int.from_bytes(s["tmgi_r9"]["service_id_r9"], "big")
            sessions.append((sid, int(s["lc_ch_id_r9"])))
    return rrc_msgs.MbsfnAreaConfig(
        area_id=0, sf_alloc_end=sf_alloc_end, data_mcs=data_mcs,
        sessions=sessions)


def decode_bcch(data: bytes):
    """Every idle UE re-reads the same broadcast SI bytes each SI cycle:
    memoize by the wire bytes.  Each caller gets its OWN shallow copy —
    the dataclasses are mutable, and one UE tweaking 'its' SIB must not
    corrupt the SI every other UE decoded."""
    import dataclasses as _dc

    data = bytes(data)
    hit = _BCCH_DEC_CACHE.get(data)
    if hit is None:
        hit = _decode_bcch(data)
        if len(_BCCH_DEC_CACHE) > 64:
            _BCCH_DEC_CACHE.clear()
        _BCCH_DEC_CACHE[data] = hit
    return _dc.replace(hit)


_BCCH_DEC_CACHE: dict = {}


def _decode_bcch(data: bytes):
    _alt, (name, val) = _dec(r.BCCH_DL_SCH_MSG, data)["msg"]
    if name == "sib_type1":
        acc = val["cell_access_related_info"]
        mnc = acc["plmn_id_list"][0]["plmn_id"]["mnc"]
        return rrc_msgs.Sib1(
            plmn=mnc[-2] * 10 + mnc[-1], tac=_unbits(acc["tac"]),
            cell_identity=_unbits(acc["cell_id"]),
            q_rx_lev_min_dbm=2.0 * val["cell_sel_info"]["q_rx_lev_min"],
            si_window_ms=int(val["si_win_len"][2:]))
    if name == "sys_info":
        _r8, body = val["crit_exts"]
        for kind, sib in body["sib_type_and_info"]:
            if kind == "sib13_v920":
                ai = sib["mbsfn_area_info_list_r9"][0]
                mc = ai["mcch_cfg_r9"]
                return rrc_msgs.Sib13(
                    area_id=ai["mbsfn_area_id_r9"],
                    mcch_offset=mc["mcch_offset_r9"],
                    mcch_rep_rf=int(mc["mcch_repeat_period_r9"][2:]),
                    sig_mcs=int(mc["sig_mcs_r9"][1:]))
            if kind == "sib3":
                return rrc_msgs.Sib3(
                    q_hyst_db=int(
                        sib["cell_resel_info_common"]["q_hyst"][2:]),
                    t_resel_s=sib["intra_freq_cell_resel_info"]
                    ["t_resel_eutra"])
            if kind != "sib2":
                continue
            rr = sib["rr_cfg_common"]
            rach = rr["rach_cfg_common"]
            pi = rr["prach_cfg"].get("prach_cfg_info") or {}
            return rrc_msgs.Sib2(
                n_preambles=int(
                    rach["preamb_info"]["nof_ra_preambs"][1:]),
                ra_response_window=int(
                    rach["ra_supervision_info"]["ra_resp_win_size"][2:]),
                mac_con_res_timer=int(
                    rach["ra_supervision_info"]
                    ["mac_contention_resolution_timer"][2:]),
                prach_config_index=pi.get("prach_cfg_idx", 3),
                prach_freq_offset=pi.get("prach_freq_offset", 4))
    raise DecodeError(f"unhandled BCCH {name}")


# ---- DL-DCCH ---------------------------------------------------------------

def _enc_reconfig(msg: rrc_msgs.RrcConnectionReconfiguration) -> bytes:
    r8 = {}
    rr_ded = {}
    if msg.drbs_to_add:
        rr_ded["drb_to_add_mod_list"] = [dict(
            eps_bearer_id=d.eps_bearer_id, drb_id=d.drb_id,
            rlc_cfg=_AM_RLC if d.rlc_mode == "am" else _UM_RLC,
            lc_ch_id=d.lcid) for d in msg.drbs_to_add]
    if msg.sps_config is not None:
        s = msg.sps_config
        rr_ded["sps_cfg"] = dict(
            semi_persist_sched_c_rnti=_bits(s.sps_crnti, 16),
            sps_cfg_dl=("setup", dict(
                semi_persist_sched_interv_dl=(
                    f"sf{_SPS_IVL[_nearest(_SPS_IVL, s.interval_dl)]}"),
                nof_conf_sps_processes=1,
                n1_pucch_an_persistent_list=[0])))
    if rr_ded:
        r8["rr_cfg_ded"] = rr_ded
    if msg.nas_pdu:
        r8["ded_info_nas_list"] = [bytes(msg.nas_pdu)]
    if msg.mobility is not None:
        m = msg.mobility
        r8["mob_ctrl_info"] = dict(
            target_pci=m.target_pci, t304="ms200",
            new_ue_id=_bits(m.new_rnti, 16),
            rr_cfg_common=_rr_cfg_common(),
            rach_cfg_ded=dict(ra_preamb_idx=m.dedicated_preamble,
                              ra_prach_mask_idx=0))
        r8["security_cfg_ho"] = dict(ho_type=("intra_lte", dict(
            key_change_ind=m.key_change == "x2",
            next_hop_chaining_count=0)))
    if msg.meas_config is not None:
        c = msg.meas_config
        rcfgs, mids = [], []
        for e in c.entries():
            ttt = _TTT_MS[_nearest(_TTT_MS, e.time_to_trigger * 40)]
            ivl = _REPORT_IVL_MS[_nearest(_REPORT_IVL_MS,
                                          e.report_interval)]
            hy = max(0, min(30, int(round(2 * e.hysteresis_db))))
            if e.event == "periodical":
                trig = ("periodical",
                        dict(purpose="report_strongest_cells"))
            else:
                if e.event == "a3":
                    ev = ("event_a3", dict(
                        a3_offset=max(-30, min(30, int(round(
                            2 * e.offset_db)))),
                        report_on_leave=False))
                elif e.event == "a5":
                    ev = ("event_a5", dict(
                        a5_thres1=("thres_rsrp", e.threshold),
                        a5_thres2=("thres_rsrp", e.threshold2)))
                else:  # a1 / a2 / a4: one RSRP threshold
                    ev = (f"event_{e.event}", {
                        f"{e.event}_thres": ("thres_rsrp", e.threshold)})
                trig = ("event", dict(event_id=ev, hysteresis=hy,
                                      time_to_trigger=f"ms{ttt}"))
            amount = "infinity" if e.report_amount == 0 else \
                f"r{_AMOUNTS[_nearest(_AMOUNTS, e.report_amount)]}"
            rcfgs.append(dict(
                report_cfg_id=e.meas_id,
                report_cfg=("report_cfg_eutra", dict(
                    trigger_type=trig, trigger_quant="rsrp",
                    report_quant="both", max_report_cells=8,
                    report_interv=f"ms{ivl}", report_amount=amount))))
            mids.append(dict(meas_id=e.meas_id, meas_obj_id=1,
                             report_cfg_id=e.meas_id))
        mc = dict(
            meas_obj_to_add_mod_list=[dict(
                meas_obj_id=1,
                meas_obj=("meas_obj_eutra", dict(
                    carrier_freq=0, allowed_meas_bw="mbw100",
                    presence_ant_port1=False,
                    neigh_cell_cfg="01")))],
            report_cfg_to_add_mod_list=rcfgs,
            meas_id_to_add_mod_list=mids)
        if getattr(c, "s_measure", 0):
            mc["s_measure"] = c.s_measure
        r8["meas_cfg"] = mc
    if msg.scells_to_add:
        r8["non_crit_ext"] = dict(non_crit_ext=dict(non_crit_ext=dict(
            scell_to_add_mod_list_r10=[dict(
                scell_idx_r10=s.scell_idx,
                cell_identif_r10=dict(pci_r10=s.pci,
                                      dl_carrier_freq_r10=s.earfcn))
                for s in msg.scells_to_add])))
    tree = dict(msg=("c1", ("rrc_conn_recfg", dict(
        rrc_transaction_id=0, crit_exts=("c1", ("r8", r8))))))
    return uper_encode(r.DL_DCCH_MSG, tree)


def _dec_reconfig(val) -> rrc_msgs.RrcConnectionReconfiguration:
    _c1, (_r8, body) = val["crit_exts"]
    out = rrc_msgs.RrcConnectionReconfiguration()
    rr_ded = body.get("rr_cfg_ded") or {}
    for d in rr_ded.get("drb_to_add_mod_list") or []:
        out.drbs_to_add.append(rrc_msgs.DrbToAdd(
            drb_id=d["drb_id"], lcid=d.get("lc_ch_id", 3),
            eps_bearer_id=d.get("eps_bearer_id", 5),
            rlc_mode="am" if d.get("rlc_cfg", _AM_RLC)[0] == "am"
            else "um"))
    sps = rr_ded.get("sps_cfg")
    if sps is not None:
        ivl = 20
        dl = sps.get("sps_cfg_dl")
        if dl is not None and dl[0] == "setup":
            ivl = int(dl[1]["semi_persist_sched_interv_dl"][2:])
        out.sps_config = rrc_msgs.SpsConfig(
            sps_crnti=_unbits(sps.get("semi_persist_sched_c_rnti", "")),
            interval_dl=ivl)
    nas_list = body.get("ded_info_nas_list")
    if nas_list:
        out.nas_pdu = bytes(nas_list[0])
    mci = body.get("mob_ctrl_info")
    if mci is not None:
        ho = body.get("security_cfg_ho") or {}
        kind = "s1"
        ht = ho.get("ho_type")
        if ht is not None and ht[0] == "intra_lte" \
                and ht[1].get("key_change_ind"):
            kind = "x2"
        rach = mci.get("rach_cfg_ded") or {}
        out.mobility = rrc_msgs.MobilityControlInfo(
            target_pci=mci["target_pci"],
            new_rnti=_unbits(mci["new_ue_id"]),
            dedicated_preamble=rach.get("ra_preamb_idx", 0),
            key_change=kind)
    mc = body.get("meas_cfg")
    if mc is not None:
        entries = []
        for rc in mc.get("report_cfg_to_add_mod_list") or []:
            kind, cfg = rc["report_cfg"]
            if kind != "report_cfg_eutra":
                continue
            e = rrc_msgs.ReportConfigEutra(
                meas_id=rc["report_cfg_id"],
                report_interval=int(cfg["report_interv"][2:]))
            am = cfg.get("report_amount", "infinity")
            e.report_amount = 0 if am == "infinity" else int(am[1:])
            tkind, trig = cfg["trigger_type"]
            if tkind == "periodical":
                e.event = "periodical"
                e.time_to_trigger = 0
            else:
                e.hysteresis_db = trig["hysteresis"] / 2.0
                e.time_to_trigger = int(trig["time_to_trigger"][2:]) // 40
                ekind, ev = trig["event_id"]
                e.event = ekind.replace("event_", "").replace("_r10", "")
                if e.event == "a3":
                    e.offset_db = ev["a3_offset"] / 2.0
                elif e.event == "a5":
                    e.threshold = ev["a5_thres1"][1]
                    e.threshold2 = ev["a5_thres2"][1]
                elif e.event in ("a1", "a2", "a4"):
                    e.threshold = ev[f"{e.event}_thres"][1]
            entries.append(e)
        if entries:
            # keep the legacy flat A3 fields mirroring the first A3 entry
            first_a3 = next((e for e in entries if e.event == "a3"),
                            entries[0])
            out.meas_config = rrc_msgs.MeasConfig(
                a3_offset_db=first_a3.offset_db,
                hysteresis_db=first_a3.hysteresis_db,
                time_to_trigger=first_a3.time_to_trigger,
                report_interval=first_a3.report_interval,
                reports=entries, s_measure=mc.get("s_measure", 0))
    ext = body.get("non_crit_ext") or {}
    v1020 = (ext.get("non_crit_ext") or {}).get("non_crit_ext") or {}
    for s in v1020.get("scell_to_add_mod_list_r10") or []:
        ci = s.get("cell_identif_r10") or {}
        out.scells_to_add.append(rrc_msgs.ScellToAdd(
            scell_idx=s["scell_idx_r10"], pci=ci.get("pci_r10", 0),
            earfcn=ci.get("dl_carrier_freq_r10", 0)))
    return out


def encode_dl_dcch(msg) -> bytes:
    if isinstance(msg, rrc_msgs.SecurityModeCommand):
        ciph = "eea3_v1130" if msg.ciph_algo == 3 else f"eea{msg.ciph_algo}"
        integ = {0: "eia0_v920", 3: "eia3_v1130"}.get(
            msg.int_algo, f"eia{msg.int_algo}")
        alg = dict(security_algorithm_cfg=dict(
            ciphering_algorithm=ciph, integrity_prot_algorithm=integ))
        smc = dict(rrc_transaction_id=0,
                   crit_exts=("c1", ("r8", dict(security_cfg_smc=alg))))
        tree = dict(msg=("c1", ("security_mode_cmd", smc)))
        return uper_encode(r.DL_DCCH_MSG, tree)
    if isinstance(msg, rrc_msgs.RrcConnectionReconfiguration):
        return _enc_reconfig(msg)
    if isinstance(msg, rrc_msgs.RrcConnectionRelease):
        body = dict(release_cause=_REL_CAUSE.get(msg.cause, "other"))
        if msg.redirect_rat == "geran":
            body["redirected_carrier_info"] = ("geran", dict(
                starting_arfcn=msg.redirect_arfcn & 0x3FF,
                band_ind="dcs1800",
                following_arfcns=("explicit_list_of_arfcns", [])))
        elif msg.redirect_rat == "utran":
            body["redirected_carrier_info"] = ("utra_fdd",
                                               msg.redirect_arfcn)
        tree = dict(msg=("c1", ("rrc_conn_release", dict(
            rrc_transaction_id=0, crit_exts=("c1", ("r8", body))))))
        return uper_encode(r.DL_DCCH_MSG, tree)
    if isinstance(msg, rrc_msgs.DlInformationTransfer):
        tree = dict(msg=("c1", ("dl_info_transfer", dict(
            rrc_transaction_id=0,
            crit_exts=("c1", ("r8", dict(
                ded_info_type=("ded_info_nas", bytes(msg.nas_pdu)))))))))
        return uper_encode(r.DL_DCCH_MSG, tree)
    if isinstance(msg, rrc_msgs.UECapabilityEnquiry):
        tree = dict(msg=("c1", ("ue_cap_enquiry", dict(
            rrc_transaction_id=0,
            crit_exts=("c1", ("r8", dict(
                ue_cap_request=list(msg.rat_types))))))))
        return uper_encode(r.DL_DCCH_MSG, tree)
    raise TypeError(f"no DL-DCCH mapping for {type(msg).__name__}")


def decode_dl_dcch(data: bytes):
    _alt, (name, val) = _dec(r.DL_DCCH_MSG, data)["msg"]
    if name == "security_mode_cmd":
        _c1, (_r8, body) = val["crit_exts"]
        alg = body["security_cfg_smc"]["security_algorithm_cfg"]
        ciph = alg["ciphering_algorithm"]
        integ = alg["integrity_prot_algorithm"]
        return rrc_msgs.SecurityModeCommand(
            ciph_algo=int(ciph[3]), int_algo=int(integ[3]))
    if name == "rrc_conn_recfg":
        return _dec_reconfig(val)
    if name == "rrc_conn_release":
        _c1, (_r8, body) = val["crit_exts"]
        cause = _REL_CAUSE_INV.get(body["release_cause"], "other")
        rat, arfcn = "none", 0
        rci = body.get("redirected_carrier_info")
        if rci is not None:
            kind, v = rci
            if kind == "geran":
                rat, arfcn = "geran", v["starting_arfcn"]
            elif kind in ("utra_fdd", "utra_tdd"):
                rat, arfcn = "utran", v
        return rrc_msgs.RrcConnectionRelease(
            cause=cause, redirect_rat=rat, redirect_arfcn=arfcn)
    if name == "dl_info_transfer":
        _c1, (_r8, body) = val["crit_exts"]
        _kind, nas = body["ded_info_type"]
        return rrc_msgs.DlInformationTransfer(nas_pdu=bytes(nas))
    if name == "ue_cap_enquiry":
        _c1, (_r8, body) = val["crit_exts"]
        return rrc_msgs.UECapabilityEnquiry(
            rat_types=tuple(body["ue_cap_request"]))
    raise DecodeError(f"unhandled DL-DCCH {name}")


# ---- UL-DCCH ---------------------------------------------------------------

def encode_ul_dcch(msg) -> bytes:
    if isinstance(msg, rrc_msgs.RrcConnectionSetupComplete):
        tree = dict(msg=("c1", ("rrc_conn_setup_complete", dict(
            rrc_transaction_id=0,
            crit_exts=("c1", ("rrc_conn_setup_complete_r8", dict(
                sel_plmn_id=msg.selected_plmn,
                ded_info_nas=bytes(msg.nas_pdu))))))))
        return uper_encode(r.UL_DCCH_MSG, tree)
    if isinstance(msg, rrc_msgs.SecurityModeComplete):
        tree = dict(msg=("c1", ("security_mode_complete", dict(
            rrc_transaction_id=0, crit_exts=("r8", {})))))
        return uper_encode(r.UL_DCCH_MSG, tree)
    if isinstance(msg, rrc_msgs.RrcConnectionReconfigurationComplete):
        tree = dict(msg=("c1", ("rrc_conn_recfg_complete", dict(
            rrc_transaction_id=0, crit_exts=("r8", {})))))
        return uper_encode(r.UL_DCCH_MSG, tree)
    if isinstance(msg, rrc_msgs.UlInformationTransfer):
        tree = dict(msg=("c1", ("ul_info_transfer", dict(
            crit_exts=("c1", ("ul_info_transfer_r8", dict(
                ded_info_type=("ded_info_nas", bytes(msg.nas_pdu)))))))))
        return uper_encode(r.UL_DCCH_MSG, tree)
    if isinstance(msg, rrc_msgs.MeasurementReport):
        res = dict(
            meas_id=max(1, getattr(msg, "meas_id", 1)),
            meas_result_pcell=dict(rsrp_result=_rsrp_range(msg.rsrp_dbm),
                                   rsrq_result=_rsrq_range(msg.rsrq_db)))
        if msg.neigh:
            res["meas_result_neigh_cells"] = ("meas_result_list_eutra", [
                dict(pci=int(pci), meas_result=dict(
                    rsrp_result=_rsrp_range(rsrp)))
                for pci, rsrp in msg.neigh[:8]])
        tree = dict(msg=("c1", ("meas_report", dict(
            crit_exts=("c1", ("meas_report_r8", dict(
                meas_results=res)))))))
        return uper_encode(r.UL_DCCH_MSG, tree)
    if isinstance(msg, rrc_msgs.UECapabilityInformation):
        # real nested container: a standalone-UPER UE-EUTRA-Capability
        # inside the rat-container octet string, exactly how
        # rrc_asn1_test.cc's rrc_ue_cap_info_test builds it
        cap = dict(
            access_stratum_release="rel8",
            ue_category=max(1, min(5, msg.category)),
            pdcp_params=dict(supported_rohc_profiles={
                f[0]: False for f in r.ROHC_PROFILES.fields}),
            phy_layer_params=dict(ue_tx_ant_sel_supported=False,
                                  ue_specific_ref_sigs_supported=False),
            rf_params=dict(supported_band_list_eutra=[dict(
                band_eutra=8, half_duplex=False)]),
            meas_params=dict(band_list_eutra=[dict(
                inter_freq_band_list=[dict(
                    inter_freq_need_for_gaps=True)])]),
            feature_group_inds=_bits(0xE6041C00, 32),
            inter_rat_params={})
        blob = uper_encode(r.UE_EUTRA_CAPABILITY, cap)
        tree = dict(msg=("c1", ("ue_cap_info", dict(
            rrc_transaction_id=0,
            crit_exts=("c1", ("ue_cap_info_r8", dict(
                ue_cap_rat_container_list=[dict(
                    rat_type="eutra", ue_cap_rat_container=blob)])))))))
        return uper_encode(r.UL_DCCH_MSG, tree)
    raise TypeError(f"no UL-DCCH mapping for {type(msg).__name__}")


def decode_ul_dcch(data: bytes):
    _alt, (name, val) = _dec(r.UL_DCCH_MSG, data)["msg"]
    if name == "rrc_conn_setup_complete":
        _c1, (_r8, body) = val["crit_exts"]
        return rrc_msgs.RrcConnectionSetupComplete(
            selected_plmn=body["sel_plmn_id"],
            nas_pdu=bytes(body["ded_info_nas"]))
    if name == "security_mode_complete":
        return rrc_msgs.SecurityModeComplete()
    if name == "rrc_conn_recfg_complete":
        return rrc_msgs.RrcConnectionReconfigurationComplete()
    if name == "ul_info_transfer":
        _c1, (_r8, body) = val["crit_exts"]
        _kind, nas = body["ded_info_type"]
        return rrc_msgs.UlInformationTransfer(nas_pdu=bytes(nas))
    if name == "meas_report":
        _c1, (_r8, body) = val["crit_exts"]
        res = body["meas_results"]
        pcell = res["meas_result_pcell"]
        neigh = []
        nc = res.get("meas_result_neigh_cells")
        if nc is not None and nc[0] == "meas_result_list_eutra":
            for item in nc[1]:
                mr = item.get("meas_result") or {}
                neigh.append((item["pci"],
                              float(mr.get("rsrp_result", 0) - 140)))
        return rrc_msgs.MeasurementReport(
            rsrp_dbm=float(pcell["rsrp_result"] - 140),
            rsrq_db=pcell["rsrq_result"] / 2.0 - 19.5,
            neigh=neigh, meas_id=res["meas_id"])
    if name == "ue_cap_info":
        _c1, (_r8, body) = val["crit_exts"]
        cat = 4
        for item in body["ue_cap_rat_container_list"]:
            if item["rat_type"] != "eutra":
                continue
            cap = _dec(r.UE_EUTRA_CAPABILITY,
                       item["ue_cap_rat_container"])
            cat = cap["ue_category"]
        # 36.306: UL 64QAM support is a category property (cat 5)
        return rrc_msgs.UECapabilityInformation(
            category=cat, supports_64qam_ul=cat >= 5)
    raise DecodeError(f"unhandled UL-DCCH {name}")
