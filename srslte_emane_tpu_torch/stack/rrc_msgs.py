"""RRC message schemas (36.331 content carried on SRB0/SRB1/SRB2).

Reference behavior: the procedures of `srsenb/src/stack/rrc/rrc.cc` and
`srsue/src/stack/rrc/rrc.cc` — connection setup, security mode, capability,
reconfiguration (DRB setup), release, paging, measurements, reestablishment.
"""

from __future__ import annotations

import dataclasses

from . import codec, per


@codec.register
@per.schema(("ue_identity", "int"),
            ("cause", "enum", ("emergency", "highPriorityAccess",
                               "mt-Access", "mo-Signalling", "mo-Data")),
            ("is_s_tmsi", "bool"))
@dataclasses.dataclass
class RrcConnectionRequest:
    # 36.331 ue-Identity CHOICE: a registered UE presents its S-TMSI so
    # the network can route idle-resume NAS by identity; otherwise a
    # 40-bit random value
    ue_identity: int  # s-TMSI (m-TMSI part) or random
    cause: str = "mo-Data"
    is_s_tmsi: bool = False


@codec.register
@per.schema(("wait_time_s", "cint", 1, 16))
@dataclasses.dataclass
class RrcConnectionReject:
    """36.331 RRCConnectionReject: admission control under overload —
    the UE backs off waitTime seconds (T302) before retrying
    (srsenb rrc.cc rejects when at max users)."""
    wait_time_s: int = 2


@codec.register
@per.schema(("con_res_id", "int"), ("sr_pucch_res_idx", "cint", -1, 2047))
@dataclasses.dataclass
class RrcConnectionSetup:
    # echo of the Msg3 ue_identity = the 36.321 UE Contention Resolution
    # Identity MAC CE (proc_ra.cc contention resolution); 0 = wildcard
    # (ideal-PHY/syssim drivers that never contend)
    con_res_id: int = 0
    srb1_config: dict = dataclasses.field(default_factory=dict)
    # 36.331 SchedulingRequestConfig sr-PUCCH-ResourceIndex (dedicated
    # physicalConfigDedicated); -1 = not configured (message-level PHY).
    # The waveform UE transmits its SR on exactly this format-1 resource
    # (36.213 §10.1; lib/src/phy/ue/ue_ul.c pucch_sched.n_pucch_sr).
    sr_pucch_res_idx: int = -1


@codec.register
@per.schema(("selected_plmn", "cint", 1, 6), ("nas_pdu", "bytes", "?"))
@dataclasses.dataclass
class RrcConnectionSetupComplete:
    selected_plmn: int = 1
    nas_pdu: bytes = b""


@codec.register
@per.schema(("nas_pdu", "bytes"))
@dataclasses.dataclass
class DlInformationTransfer:
    nas_pdu: bytes = b""


@codec.register
@per.schema(("nas_pdu", "bytes"))
@dataclasses.dataclass
class UlInformationTransfer:
    nas_pdu: bytes = b""


@codec.register
@per.schema(("ciph_algo", "cint", 0, 7), ("int_algo", "cint", 0, 7))
@dataclasses.dataclass
class SecurityModeCommand:
    ciph_algo: int = 0
    int_algo: int = 2


@codec.register
@per.schema()
@dataclasses.dataclass
class SecurityModeComplete:
    pass


@codec.register
@per.schema(("rat_types", "seqof", ("str",)))
@dataclasses.dataclass
class UECapabilityEnquiry:
    rat_types: tuple = ("eutra",)


@codec.register
@per.schema(("category", "cint", 1, 12), ("supports_64qam_ul", "bool"))
@dataclasses.dataclass
class UECapabilityInformation:
    category: int = 4
    supports_64qam_ul: bool = False


@codec.register
@per.schema(("drb_id", "cint", 1, 32), ("lcid", "cint", 3, 10),
            ("eps_bearer_id", "cint", 0, 15),
            ("rlc_mode", "enum", ("am", "um")))
@dataclasses.dataclass
class DrbToAdd:
    drb_id: int
    lcid: int
    eps_bearer_id: int
    rlc_mode: str = "am"  # "am" | "um"


@codec.register
@per.schema(("target_pci", "cint", 0, 503), ("new_rnti", "cint", 0, 65535),
            ("dedicated_preamble", "cint", 0, 63),
            ("key_change", "enum", ("s1", "x2")))
@dataclasses.dataclass
class MobilityControlInfo:
    """Handover command content (36.331 mobilityControlInfo).

    key_change mirrors keyChangeIndicator: "s1" -> KeNB* from Kasme (fresh
    NH via MME), "x2" -> horizontal derivation from the current KeNB."""
    target_pci: int
    new_rnti: int
    dedicated_preamble: int
    key_change: str = "s1"


@codec.register
@per.schema(("scell_idx", "cint", 1, 7), ("pci", "cint", 0, 503),
            ("earfcn", "cint", 0, 65535))
@dataclasses.dataclass
class ScellToAdd:
    """sCellToAddModList-r10 entry (36.331 SCellToAddMod-r10): secondary
    component carrier identified by (PCI, EARFCN)."""
    scell_idx: int
    pci: int
    earfcn: int = 0


def rsrp_range(dbm: float) -> int:
    """36.133 §9.1.4 RSRP_range: -140 dBm -> 0, -44 dBm -> 97."""
    return max(0, min(97, int(round(dbm + 140.0))))


def rsrp_dbm(rng: int) -> float:
    return float(rng) - 140.0


@codec.register
@per.schema(("meas_id", "cint", 1, 32),
            ("event", "enum", ("a1", "a2", "a3", "a4", "a5", "periodical")),
            ("threshold", "cint", 0, 97), ("threshold2", "cint", 0, 97),
            ("offset_db", "float"), ("hysteresis_db", "float"),
            ("time_to_trigger", "cint", 0, 255),
            ("report_interval", "cint", 0, 65535),
            ("report_amount", "cint", 0, 64))
@dataclasses.dataclass
class ReportConfigEutra:
    """One measId's reportConfigEUTRA (36.331 §5.5.4 events + periodical;
    rrc.cc measurement section):
      a1: serving > threshold        a2: serving < threshold
      a3: neigh > serving + offset   a4: neigh > threshold
      a5: serving < threshold AND neigh > threshold2
      periodical: every report_interval, report_amount times
    Thresholds ride as 36.133 RSRP_range (0..97 = -140..-44 dBm);
    report_amount 0 = infinity."""
    meas_id: int = 1
    event: str = "a3"
    threshold: int = 40  # RSRP_range units
    threshold2: int = 40
    offset_db: float = 1.0
    hysteresis_db: float = 0.0
    time_to_trigger: int = 3
    report_interval: int = 120  # ms/TTIs; wire-exact reportInterval value
    report_amount: int = 0


@codec.register
@per.schema(("a3_offset_db", "float"), ("hysteresis_db", "float"),
            ("time_to_trigger", "cint", 0, 255),
            ("report_interval", "cint", 0, 65535),
            ("reports", "seqof", ("msg",), "?"),
            ("s_measure", "cint", 0, 97))
@dataclasses.dataclass(eq=False)
class MeasConfig:
    """36.331 measConfig (rrc.cc meas_cfg handling): a list of
    reportConfigEUTRA entries plus s-Measure.  The flat A3 fields remain
    as the legacy single-event shorthand — when `reports` is empty the UE
    synthesizes one A3 entry from them."""
    a3_offset_db: float = 1.0
    hysteresis_db: float = 0.0
    time_to_trigger: int = 3
    report_interval: int = 50
    reports: list = dataclasses.field(default_factory=list)
    # s-Measure as RSRP_range; 0 = disabled (measure neighbors always)
    s_measure: int = 0

    def entries(self):
        if self.reports:
            return self.reports
        return [ReportConfigEutra(
            meas_id=1, event="a3", offset_db=self.a3_offset_db,
            hysteresis_db=self.hysteresis_db,
            time_to_trigger=self.time_to_trigger,
            report_interval=self.report_interval)]

    def __eq__(self, other):
        """Two configs are equal iff they configure the same measurements
        (the flat-A3 shorthand equals its explicit single-entry form)."""
        if not isinstance(other, MeasConfig):
            return NotImplemented
        return (self.entries() == other.entries()
                and self.s_measure == other.s_measure)


@codec.register
@per.schema(("sps_crnti", "cint", 0, 65535),
            ("interval_dl", "cint", 1, 640))
@dataclasses.dataclass
class SpsConfig:
    """36.331 sps-Config subset: SPS C-RNTI + semiPersistSchedIntervalDL
    (in TTIs).  Activation/release ride PDCCH addressed to the SPS C-RNTI
    (36.321 §5.10; srsenb sched SPS role)."""
    sps_crnti: int = 0
    interval_dl: int = 20


@codec.register
@per.schema(("drbs_to_add", "seqof", ("msg",), "?"),
            ("nas_pdu", "bytes", "?"), ("mobility", "msg", "?"),
            ("scells_to_add", "seqof", ("msg",), "?"),
            ("meas_config", "msg", "?"), ("sps_config", "msg", "?"))
@dataclasses.dataclass
class RrcConnectionReconfiguration:
    drbs_to_add: list = dataclasses.field(default_factory=list)
    nas_pdu: bytes = b""
    mobility: object = None  # MobilityControlInfo for handover
    scells_to_add: list = dataclasses.field(default_factory=list)
    meas_config: object = None  # MeasConfig pushed by the network
    sps_config: object = None  # SpsConfig (semi-persistent scheduling)


@codec.register
@per.schema()
@dataclasses.dataclass
class RrcConnectionReconfigurationComplete:
    pass


@codec.register
@per.schema(("cause", "enum", ("loadBalancingTAUrequired", "other",
                               "cs-FallbackHighPriority", "user-inactivity",
                               "rl-failure")),
            ("redirect_rat", "enum", ("none", "geran", "utran")),
            ("redirect_arfcn", "cint", 0, 65535))
@dataclasses.dataclass
class RrcConnectionRelease:
    """36.331 RRCConnectionRelease; redirectedCarrierInfo carries the CSFB
    target RAT/ARFCN (rrc.cc release with redirection)."""

    cause: str = "other"
    redirect_rat: str = "none"
    redirect_arfcn: int = 0


@codec.register
@per.schema(("rsrp_dbm", "float"), ("rsrq_db", "float"), ("neigh", "pairs"),
            ("meas_id", "cint", 1, 32))
@dataclasses.dataclass
class MeasurementReport:
    rsrp_dbm: float = -100.0
    rsrq_db: float = -12.0
    neigh: list = dataclasses.field(default_factory=list)
    meas_id: int = 1  # which configured measId triggered (36.331 measId)


@codec.register
@per.schema(("ue_identity", "int"), ("cn_domain", "enum", ("ps", "cs")))
@dataclasses.dataclass
class Paging:
    ue_identity: int = 0
    cn_domain: str = "ps"  # "cs" pages announce a CSFB voice call (36.331)


@codec.register
@per.schema(("c_rnti", "cint", 0, 65535),
            ("cause", "enum", ("reconfigurationFailure", "handoverFailure",
                               "otherFailure")))
@dataclasses.dataclass
class RrcConnectionReestablishmentRequest:
    c_rnti: int = 0
    cause: str = "otherFailure"


@codec.register
@per.schema(("plmn", "int"), ("tac", "cint", 0, 65535),
            ("cell_identity", "int"), ("q_rx_lev_min_dbm", "float"),
            ("si_window_ms", "cint", 1, 40))
@dataclasses.dataclass
class Sib1:
    """SystemInformationBlockType1 content (36.331 §6.3.1): cell access and
    SI scheduling."""
    plmn: int = 1
    tac: int = 1
    cell_identity: int = 0x19B01
    q_rx_lev_min_dbm: float = -130.0
    si_window_ms: int = 20


@codec.register
@per.schema(("q_hyst_db", "cint", 0, 24), ("t_resel_s", "cint", 0, 7))
@dataclasses.dataclass
class Sib3:
    """SystemInformationBlockType3 content (36.331 §6.3.1): idle-mode
    cell reselection parameters — Qhyst and TreselectionEUTRA (36.304
    §5.2); the UE applies them instead of hardcoded defaults
    (srsue rrc.cc handle_sib3)."""
    q_hyst_db: int = 2
    t_resel_s: int = 1


@codec.register
@per.schema(("area_id", "cint", 0, 255), ("mcch_offset", "cint", 0, 10),
            ("mcch_rep_rf", "cint", 32, 256), ("sig_mcs", "cint", 0, 28))
@dataclasses.dataclass
class Sib13:
    """SystemInformationBlockType13-r9 content: MBSFN area + MCCH config
    (srsue rrc.cc handle_sib13 role).  The UE uses it to locate the MCCH
    and learn the MBSFN region before any MBMS service can start."""
    area_id: int = 1
    mcch_offset: int = 0  # subframe offset of the MCCH occasion
    mcch_rep_rf: int = 32  # repetition period in radio frames
    sig_mcs: int = 2


@codec.register
@per.schema(("area_id", "cint", 0, 255), ("sf_alloc_end", "cint", 0, 1535),
            ("data_mcs", "cint", 0, 28), ("sessions", "pairs"))
@dataclasses.dataclass
class MbsfnAreaConfig:
    """MCCH MBSFNAreaConfiguration-r9 content: the PMCH info list mapping
    each announced session (TMGI service id) to its MTCH logical channel
    (srsue rrc.cc parse_pdu_mch / mbms_service_start role)."""
    area_id: int = 1
    sf_alloc_end: int = 64
    data_mcs: int = 2
    sessions: list = dataclasses.field(default_factory=list)  # [(service_id, lcid)]


@codec.register
@per.schema(("n_preambles", "cint", 4, 64), ("ra_response_window", "cint", 2, 10),
            ("mac_con_res_timer", "cint", 8, 64), ("prach_config_index", "cint", 0, 63),
            ("prach_freq_offset", "cint", 0, 94))
@dataclasses.dataclass
class Sib2:
    """SystemInformationBlockType2 content: RACH/PRACH common config."""
    n_preambles: int = 52
    ra_response_window: int = 10
    mac_con_res_timer: int = 64
    prach_config_index: int = 3
    prach_freq_offset: int = 4
