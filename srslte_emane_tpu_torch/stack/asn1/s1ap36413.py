"""S1AP (36.413) aligned-PER codec — reference-vector subset.

The reference's S1AP codec is `lib/src/asn1/liblte_s1ap.cc` (~50k LoC of
generated pack/unpack); its test (`lib/test/asn1/s1ap_test.cc`) pins a
captured S1SetupResponse carrying ServedGUMMEIs with six PLMNs.  The
ALIGNED-PER rules live in `aper.py`; this module adds the
S1SetupRequest/Response message schemas over them — decoding that capture
byte-exact and generating valid wire messages of its own.

Beyond the capture interop surface, this codec is LIVE on the
inter-process S1-MME wire: epc/s1ap_wire.py encodes the NAS-transport,
UE-context-release, paging, InitialContextSetup, S1 mobility
(HandoverPreparation/ResourceAllocation/Notification, PathSwitch) and
E-RAB Setup/Release procedures (incl. the
E-RAB-to-be-setup list) as these APER PDUs over the apps/rpc.py framing."""

from __future__ import annotations

import dataclasses

from .aper import (AperError, BitReader, BitWriter, read_constrained,
                   write_constrained, read_length, write_length,
                   read_open_type, write_open_type)

# ---- S1AP structures -------------------------------------------------------

CRITICALITY = ("reject", "ignore", "notify")

# procedure codes (36.413 §9.3.7; liblte_s1ap.h LIBLTE_S1AP_PROC_ID_*)
PROC_HANDOVER_PREPARATION = 0
PROC_HANDOVER_RESOURCE_ALLOCATION = 1
PROC_HANDOVER_NOTIFICATION = 2
PROC_PATH_SWITCH_REQUEST = 3
PROC_ERAB_SETUP = 5
PROC_ERAB_RELEASE = 7
PROC_INITIAL_CONTEXT_SETUP = 9
PROC_PAGING = 10
PROC_DOWNLINK_NAS_TRANSPORT = 11
PROC_INITIAL_UE_MESSAGE = 12
PROC_UPLINK_NAS_TRANSPORT = 13
PROC_S1SETUP = 17
PROC_UE_CONTEXT_RELEASE_REQUEST = 18
PROC_UE_CONTEXT_RELEASE = 23

# protocol IE ids (liblte_s1ap.h LIBLTE_S1AP_IE_ID_*)
ID_MME_UE_S1AP_ID = 0
ID_CAUSE = 2
ID_ENB_UE_S1AP_ID = 8
ID_NAS_PDU = 26
ID_UE_PAGING_ID = 43
ID_TAI_LIST = 46
ID_TAI_ITEM = 47
ID_UE_IDENTITY_INDEX = 80
ID_GLOBAL_ENB_ID = 59
ID_ENB_NAME = 60
ID_MME_NAME = 61
ID_SUPPORTED_TAS = 64
ID_TAI = 67
ID_SECURITY_KEY = 73
ID_ERAB_TO_BE_SETUP_LIST_CTXT = 24
ID_ERAB_TO_BE_SETUP_ITEM_CTXT = 52
ID_UE_AGGREGATE_MAX_BITRATE = 66
# mobility + E-RAB management IEs (liblte_s1ap.h ids)
ID_HANDOVER_TYPE = 1
ID_TARGET_ID = 4
ID_ERAB_RELEASE_ITEM_BEARER_REL_COMP = 15
ID_ERAB_TO_BE_SETUP_LIST_BEARER_SU_REQ = 16
ID_ERAB_TO_BE_SETUP_ITEM_BEARER_SU_REQ = 17
ID_ERAB_ADMITTED_LIST = 18
ID_ERAB_ADMITTED_ITEM = 20
ID_ERAB_TO_BE_SWITCHED_DL_LIST = 22
ID_ERAB_TO_BE_SWITCHED_DL_ITEM = 23
ID_ERAB_TO_BE_SETUP_ITEM_HO_REQ = 27
ID_ERAB_SETUP_LIST_BEARER_SU_RES = 28
ID_ERAB_TO_BE_RELEASED_LIST = 33
ID_ERAB_ITEM = 35
ID_ERAB_SETUP_ITEM_BEARER_SU_RES = 39
ID_SECURITY_CONTEXT = 40
ID_ERAB_TO_BE_SETUP_LIST_HO_REQ = 53
ID_ERAB_RELEASE_LIST_BEARER_REL_COMP = 69
ID_SOURCE_MME_UE_S1AP_ID = 88
ID_ERAB_TO_BE_SWITCHED_UL_ITEM = 94
ID_ERAB_TO_BE_SWITCHED_UL_LIST = 95
ID_SOURCE_TO_TARGET_CONTAINER = 104
ID_TARGET_TO_SOURCE_CONTAINER = 123

HANDOVER_TYPES = ("intralte", "ltetoutran", "ltetogeran", "utrantolte",
                  "gerantolte")
# emulation-private extension IE (outside 36.413's assigned range): the
# reference returns the eNB-side DL GTP TEID in the InitialContextSetup
# RESPONSE; this emulation's MME/SPGW pre-allocate it, so the request
# carries it as an unknown-IE (criticality ignore) the spec's
# extensibility rules let any decoder skip
ID_EMU_DL_TEID = 59999
ID_RELATIVE_MME_CAPACITY = 87
ID_UE_S1AP_IDS = 99
ID_S_TMSI = 96
ID_EUTRAN_CGI = 100
ID_SERVED_GUMMEIS = 105
ID_UE_SECURITY_CAPABILITIES = 107
ID_CN_DOMAIN = 109
ID_RRC_ESTABLISHMENT_CAUSE = 134
ID_DEFAULT_PAGING_DRX = 137

# Cause CHOICE arms (36.413 §9.2.1.3) and RRC establishment causes
CAUSE_GROUPS = ("radioNetwork", "transport", "nas", "protocol", "misc")
RRC_CAUSES = ("emergency", "highPriorityAccess", "mt-Access",
              "mo-Signalling", "mo-Data")


@dataclasses.dataclass
class ProtocolIE:
    id: int
    criticality: str
    value: object  # decoded per-IE python value


@dataclasses.dataclass
class S1apPdu:
    pdu_type: str  # initiatingMessage | successfulOutcome | unsuccessfulOutcome
    procedure_code: int
    criticality: str
    ies: list


def _read_gummei_list(r: BitReader) -> list:
    """ServedGUMMEIs ::= SEQUENCE (SIZE(1..8)) OF ServedGUMMEIsItem."""
    n = read_constrained(r, 1, 8)
    out = []
    for _ in range(n):
        ext = r.read_bits(1)
        has_exts = r.read_bits(1)  # iE-Extensions OPTIONAL
        if ext or has_exts:
            raise AperError("ServedGUMMEIsItem extensions not supported")
        n_plmn = read_constrained(r, 1, 32)
        plmns = [r.read_octets(3) for _ in range(n_plmn)]
        n_grp = read_constrained(r, 1, 65535)
        groups = [r.read_octets(2) for _ in range(n_grp)]
        n_mmec = read_constrained(r, 1, 256)
        codes = [r.read_octets(1) for _ in range(n_mmec)]
        out.append(dict(plmns=plmns, group_ids=groups, mme_codes=codes))
    return out


def _write_gummei_list(w: BitWriter, items: list):
    write_constrained(w, len(items), 1, 8)
    for it in items:
        w.write_bits(0, 2)  # ext + no iE-Extensions
        write_constrained(w, len(it["plmns"]), 1, 32)
        for p in it["plmns"]:
            w.write_octets(bytes(p))
        write_constrained(w, len(it["group_ids"]), 1, 65535)
        for g in it["group_ids"]:
            w.write_octets(bytes(g))
        write_constrained(w, len(it["mme_codes"]), 1, 256)
        for c in it["mme_codes"]:
            w.write_octets(bytes(c))


def _read_mme_name(r: BitReader) -> str:
    # PrintableString SIZE(1..150, ...)
    n = read_constrained(r, 1, 150)
    return r.read_octets(n).decode()


def _read_nas_pdu(r: BitReader) -> bytes:
    return r.read_octets(read_length(r))  # unconstrained OCTET STRING


def _read_tai(r: BitReader) -> dict:
    ext, opt = r.read_bits(1), r.read_bits(1)
    if ext:
        raise AperError("TAI extension")
    out = dict(plmn=r.read_octets(3), tac=r.read_octets(2))
    if opt:
        raise AperError("TAI iE-Extensions")
    return out


def _write_tai(w: BitWriter, v: dict):
    w.write_bits(0, 2)
    w.write_octets(bytes(v["plmn"]))
    w.write_octets(bytes(v["tac"]))


def _read_cgi(r: BitReader) -> dict:
    ext, opt = r.read_bits(1), r.read_bits(1)
    if ext or opt:
        raise AperError("EUTRAN-CGI extensions")
    plmn = r.read_octets(3)
    r.align()  # BIT STRING SIZE(28) > 16 bits: aligned (X.691 §15.11)
    return dict(plmn=plmn, cell_id=r.read_bits(28))


def _write_cgi(w: BitWriter, v: dict):
    w.write_bits(0, 2)
    w.write_octets(bytes(v["plmn"]))
    w.align()
    w.write_bits(v["cell_id"], 28)


def _read_cause(r: BitReader) -> tuple:
    if r.read_bits(1):
        raise AperError("Cause extension")
    group = CAUSE_GROUPS[r.read_bits(3)]
    ext = r.read_bits(1)  # each arm is an extensible ENUMERATED
    n_max = {"radioNetwork": 35, "transport": 1, "nas": 3,
             "protocol": 6, "misc": 5}[group]
    val = read_constrained(r, 0, n_max) if not ext else read_length(r)
    return (group, val)


def _write_cause(w: BitWriter, v: tuple):
    group, val = v
    w.write_bits(0, 1)
    w.write_bits(CAUSE_GROUPS.index(group), 3)
    w.write_bits(0, 1)
    n_max = {"radioNetwork": 35, "transport": 1, "nas": 3,
             "protocol": 6, "misc": 5}[group]
    write_constrained(w, val, 0, n_max)


def _read_rrc_cause(r: BitReader):
    if r.read_bits(1):
        raise AperError("establishment-cause extension")
    return RRC_CAUSES[read_constrained(r, 0, len(RRC_CAUSES) - 1)]


def _read_ue_paging_id(r: BitReader):
    if r.read_bits(1):
        raise AperError("UEPagingID extension")
    if r.read_bits(1) == 0:  # s-TMSI
        ext, opt = r.read_bits(1), r.read_bits(1)
        if ext or opt:
            raise AperError("S-TMSI extensions")
        # MMEC is OCTET STRING SIZE(1): <=2 octets stay UNALIGNED
        # (X.691 §16.6); m-TMSI SIZE(4) is aligned
        return ("s_tmsi", dict(mmec=bytes([r.read_bits(8)]),
                               m_tmsi=r.read_octets(4)))
    n = read_constrained(r, 3, 8)
    return ("imsi", r.read_octets(n))


def _write_ue_paging_id(w: BitWriter, v: tuple):
    kind, val = v
    w.write_bits(0, 1)
    if kind == "s_tmsi":
        w.write_bits(0, 1)
        w.write_bits(0, 2)
        w.write_bits(val["mmec"][0], 8)  # <=2-octet string: unaligned
        w.write_octets(bytes(val["m_tmsi"]))
    else:
        w.write_bits(1, 1)
        write_constrained(w, len(val), 3, 8)
        w.write_octets(bytes(val))


def _read_ue_s1ap_ids(r: BitReader):
    if r.read_bits(1):
        raise AperError("UE-S1AP-IDs extension")
    if r.read_bits(1) == 0:  # uE-S1AP-ID-pair
        ext, opt = r.read_bits(1), r.read_bits(1)
        if ext or opt:
            raise AperError("pair extensions")
        return ("pair", dict(mme_ue_id=read_constrained(r, 0, 4294967295),
                             enb_ue_id=read_constrained(r, 0, 16777215)))
    return ("mme_ue_id", read_constrained(r, 0, 4294967295))


def _write_ue_s1ap_ids(w: BitWriter, v: tuple):
    kind, val = v
    w.write_bits(0, 1)
    if kind == "pair":
        w.write_bits(0, 1)
        w.write_bits(0, 2)
        write_constrained(w, val["mme_ue_id"], 0, 4294967295)
        write_constrained(w, val["enb_ue_id"], 0, 16777215)
    else:
        w.write_bits(1, 1)
        write_constrained(w, val, 0, 4294967295)


def _read_security_caps(r: BitReader) -> dict:
    ext, opt = r.read_bits(1), r.read_bits(1)
    if ext or opt:
        raise AperError("UESecurityCapabilities extensions")
    # Encryption/IntegrityProtectionAlgorithms are EXTENSIBLE BIT
    # STRINGs (SIZE(16), ...): each carries its own extension bit
    # before the 16 value bits (liblte_s1ap.cc pack_encryptionalgorithms)
    if r.read_bits(1):
        raise AperError("EncryptionAlgorithms extension")
    eea = r.read_bits(16)
    if r.read_bits(1):
        raise AperError("IntegrityProtectionAlgorithms extension")
    return dict(eea=eea, eia=r.read_bits(16))


def _write_security_caps(w: BitWriter, v: dict):
    w.write_bits(0, 2)
    w.write_bits(0, 1)  # EncryptionAlgorithms ext
    w.write_bits(v["eea"], 16)
    w.write_bits(0, 1)  # IntegrityProtectionAlgorithms ext
    w.write_bits(v["eia"], 16)


def _read_tai_list(r: BitReader) -> list:
    """TAIList ::= SEQUENCE (SIZE(1..256)) OF
    ProtocolIE-SingleContainer{TAIItem}."""
    n = read_constrained(r, 1, 256)
    out = []
    for _ in range(n):
        ie_id = read_constrained(r, 0, 65535)
        crit = CRITICALITY[r.read_bits(2)]
        body = BitReader(read_open_type(r))
        ext, opt = body.read_bits(1), body.read_bits(1)
        if ie_id != ID_TAI_ITEM or ext or opt:
            raise AperError("unexpected TAIList element")
        out.append(_read_tai(body))
    return out


def _write_tai_list(w: BitWriter, items: list):
    write_constrained(w, len(items), 1, 256)
    for tai in items:
        write_constrained(w, ID_TAI_ITEM, 0, 65535)
        w.write_bits(CRITICALITY.index("ignore"), 2)
        bw = BitWriter()
        bw.write_bits(0, 2)  # TAIItem ext + no iE-Extensions
        _write_tai(bw, tai)
        write_open_type(w, bw.to_bytes())


def _read_security_key(r: BitReader) -> bytes:
    r.align()  # BIT STRING SIZE(256): aligned
    return bytes((r.read_bits(8)) for _ in range(32))


def _read_s_tmsi(r: BitReader) -> dict:
    """S-TMSI ::= SEQUENCE { mMEC OCTET STRING(1), m-TMSI OCTET
    STRING(4) } (liblte_s1ap.cc pack_s_tmsi).  MMEC is a <=2-octet
    string so it stays UNALIGNED (X.691 §16.6); m-TMSI SIZE(4) aligns."""
    ext, opt = r.read_bits(1), r.read_bits(1)
    if ext or opt:
        raise AperError("S-TMSI extensions")
    mmec = r.read_bits(8)
    m_tmsi = int.from_bytes(r.read_octets(4), "big")
    return dict(mmec=mmec, m_tmsi=m_tmsi)


def _write_s_tmsi(w: BitWriter, v: dict):
    w.write_bits(0, 2)
    w.write_bits(v["mmec"], 8)  # <=2-octet string: unaligned
    w.write_octets(int(v["m_tmsi"]).to_bytes(4, "big"))


def _read_bitrate(r: BitReader) -> int:
    """BitRate ::= INTEGER (0..10000000000): range > 64K encodes a 3-bit
    octet-count-1, aligns, then the value octets (liblte_s1ap.cc
    pack_bitrate)."""
    n_oct = r.read_bits(3) + 1
    r.align()
    v = 0
    for _ in range(n_oct):
        v = (v << 8) | r.read_bits(8)
    return v


def _write_bitrate(w: BitWriter, v: int):
    v = int(v)
    n_oct = max(1, (v.bit_length() + 7) // 8)
    w.write_bits(n_oct - 1, 3)
    w.align()
    for i in reversed(range(n_oct)):
        w.write_bits((v >> (8 * i)) & 0xFF, 8)


def _read_ue_ambr(r: BitReader) -> dict:
    ext, opt = r.read_bits(1), r.read_bits(1)
    if ext or opt:
        raise AperError("UEAggregateMaximumBitrate extensions")
    return dict(dl=_read_bitrate(r), ul=_read_bitrate(r))


def _write_ue_ambr(w: BitWriter, v: dict):
    w.write_bits(0, 2)
    _write_bitrate(w, v["dl"])
    _write_bitrate(w, v["ul"])


def _read_erab_setup_item(r: BitReader) -> dict:
    """E-RABToBeSetupItemCtxtSUReq (liblte_s1ap.cc
    pack_e_rabtobesetupitemctxtsureq bit layout)."""
    if r.read_bits(1):
        raise AperError("E-RAB item extension")
    nas_present, exts = r.read_bits(1), r.read_bits(1)
    if exts:
        raise AperError("E-RAB item iE-Extensions")
    if r.read_bits(1):
        raise AperError("E-RAB-ID extension")
    erab_id = r.read_bits(4)
    # E-RABLevelQoSParameters: ext, gbr-present, exts preamble
    qext, gbr, qexts = r.read_bits(1), r.read_bits(1), r.read_bits(1)
    if qext or gbr or qexts:
        raise AperError("QoS parameter options unsupported")
    r.align()
    qci = r.read_bits(8)
    # AllocationAndRetentionPriority
    aext, aexts = r.read_bits(1), r.read_bits(1)
    if aext or aexts:
        raise AperError("ARP extensions")
    prio = r.read_bits(4)
    pre_cap, pre_vuln = r.read_bits(1), r.read_bits(1)
    # TransportLayerAddress: BIT STRING (1..160, ...)
    if r.read_bits(1):
        raise AperError("TransportLayerAddress extension")
    n_bits = r.read_bits(8) + 1
    r.align()
    addr = bytes(r.read_bits(8) for _ in range((n_bits + 7) // 8))
    r.align()
    # GTP-TEID: OCTET STRING (SIZE(4)): aligned
    teid = int.from_bytes(r.read_octets(4), "big")
    nas = _read_nas_pdu(r) if nas_present else None
    return dict(erab_id=erab_id, qci=qci, arp_priority=prio,
                pre_emption_capability=pre_cap,
                pre_emption_vulnerability=pre_vuln,
                addr=addr, addr_bits=n_bits, teid=teid, nas_pdu=nas)


def _write_erab_setup_item(w: BitWriter, v: dict):
    nas = v.get("nas_pdu")
    w.write_bits(0, 1)                      # ext
    w.write_bits(1 if nas is not None else 0, 1)
    w.write_bits(0, 1)                      # iE-Extensions
    w.write_bits(0, 1)                      # E-RAB-ID ext
    w.write_bits(v["erab_id"], 4)
    w.write_bits(0, 3)                      # QoS: ext, gbr, exts
    w.align()
    w.write_bits(v["qci"], 8)
    w.write_bits(0, 2)                      # ARP: ext, exts
    w.write_bits(v.get("arp_priority", 15), 4)
    w.write_bits(v.get("pre_emption_capability", 0), 1)
    w.write_bits(v.get("pre_emption_vulnerability", 0), 1)
    addr = bytes(v["addr"])
    n_bits = v.get("addr_bits", 8 * len(addr))
    w.write_bits(0, 1)                      # TransportLayerAddress ext
    w.write_bits(n_bits - 1, 8)
    w.align()
    w.write_octets(addr)
    w.align()
    w.write_octets(int(v["teid"]).to_bytes(4, "big"))
    if nas is not None:
        write_length(w, len(nas))
        w.write_octets(bytes(nas))


def _read_erab_setup_list(r: BitReader) -> list:
    """SEQUENCE (SIZE(1..256)) OF ProtocolIE-SingleContainer, each
    wrapping an E-RABToBeSetupItemCtxtSUReq (id 52)."""
    n = r.read_bits(8) + 1
    r.align()
    items = []
    for _ in range(n):
        ie_id = read_constrained(r, 0, 65535)
        _crit = CRITICALITY[r.read_bits(2)]
        body = read_open_type(r)
        if ie_id != ID_ERAB_TO_BE_SETUP_ITEM_CTXT:
            raise AperError(f"unexpected E-RAB list member {ie_id}")
        items.append(_read_erab_setup_item(BitReader(body)))
    return items


def _write_erab_setup_list(w: BitWriter, items: list):
    w.write_bits(len(items) - 1, 8)
    w.align()
    for v in items:
        iw = BitWriter()
        _write_erab_setup_item(iw, v)
        write_constrained(w, ID_ERAB_TO_BE_SETUP_ITEM_CTXT, 0, 65535)
        w.write_bits(CRITICALITY.index("reject"), 2)
        write_open_type(w, iw.to_bytes())


# ---- mobility + E-RAB management IEs (36.413 §9.1.5/§8.2) -----------------
# Bit layouts match liblte_s1ap.cc's generated pack/unpack functions
# (pack_handovertype:4871, pack_targetid:12824, pack_securitycontext:7910,
# pack_e_rabtobesetupitemhoreq:15586, pack_e_rabadmitteditem:15671,
# pack_e_rabtobeswitcheddlitem:15871, pack_e_rabitem:9152) — proven
# byte-exact by the differential fuzzer (scripts/s1ap_interop).

def _read_handover_type(r: BitReader) -> str:
    if r.read_bits(1):
        raise AperError("HandoverType extension")
    v = HANDOVER_TYPES[r.read_bits(3)]
    r.align()
    return v


def _write_handover_type(w: BitWriter, v: str):
    w.write_bits(0, 1)
    w.write_bits(HANDOVER_TYPES.index(v), 3)
    w.align()


def _read_global_enb_id(r: BitReader) -> dict:
    ext, opt = r.read_bits(1), r.read_bits(1)
    if ext or opt:
        raise AperError("Global-ENB-ID extensions")
    plmn = r.read_octets(3)
    if r.read_bits(1):
        raise AperError("ENB-ID extension")
    home = r.read_bits(1)
    # the eNB-ID bit strings are aligned BEFORE *AND AFTER* the value
    # bits — the reference codec's convention for every static bit
    # string (liblte_s1ap.cc pack_macroenb_id:1486 aligns on both
    # sides), which X.691 does not require but the wire must match
    r.align()
    if home:
        out = dict(plmn=plmn, home_enb_id=r.read_bits(28))
    else:
        out = dict(plmn=plmn, macro_enb_id=r.read_bits(20))
    r.align()
    return out


def _write_global_enb_id(w: BitWriter, v: dict):
    w.write_bits(0, 2)
    w.write_octets(bytes(v["plmn"]))
    w.write_bits(0, 1)  # ENB-ID ext
    if "home_enb_id" in v:
        w.write_bits(1, 1)
        w.align()
        w.write_bits(v["home_enb_id"], 28)
    else:
        w.write_bits(0, 1)
        w.align()
        w.write_bits(v["macro_enb_id"], 20)
    w.align()  # liblte aligns after static bit strings (see reader)


def _read_target_id(r: BitReader) -> dict:
    """TargetID: only the targeteNB-ID arm (the LTE-HO one; RNC/CGI arms
    are inter-RAT)."""
    if r.read_bits(1):
        raise AperError("TargetID extension")
    if r.read_bits(2) != 0:
        raise AperError("non-eNB TargetID arm")
    ext, opt = r.read_bits(1), r.read_bits(1)
    if ext or opt:
        raise AperError("TargeteNB-ID extensions")
    enb = _read_global_enb_id(r)
    tai = _read_tai(r)
    return dict(global_enb_id=enb, tai=tai)


def _write_target_id(w: BitWriter, v: dict):
    w.write_bits(0, 1)
    w.write_bits(0, 2)  # targeteNB-ID arm
    w.write_bits(0, 2)  # TargeteNB-ID ext + iE-Extensions
    _write_global_enb_id(w, v["global_enb_id"])
    _write_tai(w, v["tai"])


def _read_security_context(r: BitReader) -> dict:
    ext, opt = r.read_bits(1), r.read_bits(1)
    if ext or opt:
        raise AperError("SecurityContext extensions")
    nhcc = r.read_bits(3)  # NextHopChainingCount INTEGER (0..7)
    return dict(nhcc=nhcc, nh=_read_security_key(r))


def _write_security_context(w: BitWriter, v: dict):
    w.write_bits(0, 2)
    w.write_bits(v["nhcc"], 3)
    w.align()
    for b in bytes(v["nh"]):
        w.write_bits(b, 8)


def _read_addr(r: BitReader):
    """TransportLayerAddress: BIT STRING (1..160, ...)."""
    if r.read_bits(1):
        raise AperError("TransportLayerAddress extension")
    n_bits = r.read_bits(8) + 1
    r.align()
    addr = bytes(r.read_bits(8) for _ in range((n_bits + 7) // 8))
    return addr, n_bits


def _write_addr(w: BitWriter, addr: bytes, n_bits: int = None):
    addr = bytes(addr)
    n_bits = n_bits or 8 * len(addr)
    w.write_bits(0, 1)
    w.write_bits(n_bits - 1, 8)
    w.align()
    w.write_octets(addr)


def _read_erab_teid_item(r: BitReader) -> dict:
    """E-RAB-ID + address + GTP-TEID triple: the shared shape of
    E-RABToBeSwitchedDL/ULItem and E-RABSetupItemBearerSURes."""
    if r.read_bits(1):
        raise AperError("item extension")
    if r.read_bits(1):
        raise AperError("item iE-Extensions")
    if r.read_bits(1):
        raise AperError("E-RAB-ID extension")
    erab_id = r.read_bits(4)
    addr, n_bits = _read_addr(r)
    r.align()
    teid = int.from_bytes(r.read_octets(4), "big")
    return dict(erab_id=erab_id, addr=addr, addr_bits=n_bits, teid=teid)


def _write_erab_teid_item(w: BitWriter, v: dict):
    w.write_bits(0, 3)  # ext, iE-Extensions, E-RAB-ID ext
    w.write_bits(v["erab_id"], 4)
    _write_addr(w, v["addr"], v.get("addr_bits"))
    w.align()
    w.write_octets(int(v["teid"]).to_bytes(4, "big"))


def _read_qos(r: BitReader) -> dict:
    qext, gbr, qexts = r.read_bits(1), r.read_bits(1), r.read_bits(1)
    if qext or gbr or qexts:
        raise AperError("QoS parameter options unsupported")
    r.align()
    qci = r.read_bits(8)
    aext, aexts = r.read_bits(1), r.read_bits(1)
    if aext or aexts:
        raise AperError("ARP extensions")
    return dict(qci=qci, arp_priority=r.read_bits(4),
                pre_emption_capability=r.read_bits(1),
                pre_emption_vulnerability=r.read_bits(1))


def _write_qos(w: BitWriter, v: dict):
    w.write_bits(0, 3)
    w.align()
    w.write_bits(v["qci"], 8)
    w.write_bits(0, 2)
    w.write_bits(v.get("arp_priority", 15), 4)
    w.write_bits(v.get("pre_emption_capability", 0), 1)
    w.write_bits(v.get("pre_emption_vulnerability", 0), 1)


def _read_erab_horeq_item(r: BitReader) -> dict:
    """E-RABToBeSetupItemHOReq: id, address, TEID, THEN QoS (note the
    order differs from the ctxt/SUReq items)."""
    if r.read_bits(1):
        raise AperError("HOReq item extension")
    if r.read_bits(1):
        raise AperError("HOReq item iE-Extensions")
    if r.read_bits(1):
        raise AperError("E-RAB-ID extension")
    erab_id = r.read_bits(4)
    addr, n_bits = _read_addr(r)
    r.align()
    teid = int.from_bytes(r.read_octets(4), "big")
    out = dict(erab_id=erab_id, addr=addr, addr_bits=n_bits, teid=teid)
    out.update(_read_qos(r))
    return out


def _write_erab_horeq_item(w: BitWriter, v: dict):
    w.write_bits(0, 3)
    w.write_bits(v["erab_id"], 4)
    _write_addr(w, v["addr"], v.get("addr_bits"))
    w.align()
    w.write_octets(int(v["teid"]).to_bytes(4, "big"))
    _write_qos(w, v)


def _read_erab_sureq_item(r: BitReader) -> dict:
    """E-RABToBeSetupItemBearerSUReq: like the ctxt item but the NAS PDU
    is MANDATORY."""
    if r.read_bits(1):
        raise AperError("SUReq item extension")
    if r.read_bits(1):
        raise AperError("SUReq item iE-Extensions")
    if r.read_bits(1):
        raise AperError("E-RAB-ID extension")
    erab_id = r.read_bits(4)
    out = dict(erab_id=erab_id)
    out.update(_read_qos(r))
    addr, n_bits = _read_addr(r)
    r.align()
    out.update(addr=addr, addr_bits=n_bits,
               teid=int.from_bytes(r.read_octets(4), "big"),
               nas_pdu=_read_nas_pdu(r))
    return out


def _write_erab_sureq_item(w: BitWriter, v: dict):
    w.write_bits(0, 3)
    w.write_bits(v["erab_id"], 4)
    _write_qos(w, v)
    _write_addr(w, v["addr"], v.get("addr_bits"))
    w.align()
    w.write_octets(int(v["teid"]).to_bytes(4, "big"))
    nas = bytes(v["nas_pdu"])
    write_length(w, len(nas))
    w.write_octets(nas)


def _read_erab_admitted_item(r: BitReader) -> dict:
    if r.read_bits(1):
        raise AperError("admitted item extension")
    opts = [r.read_bits(1) for _ in range(5)]  # dlA dlT ulA ulT exts
    if opts[4]:
        raise AperError("admitted item iE-Extensions")
    if r.read_bits(1):
        raise AperError("E-RAB-ID extension")
    erab_id = r.read_bits(4)
    addr, n_bits = _read_addr(r)
    r.align()
    out = dict(erab_id=erab_id, addr=addr, addr_bits=n_bits,
               teid=int.from_bytes(r.read_octets(4), "big"))
    for flag, a_key, t_key in ((opts[0], "dl_addr", None),
                               (opts[1], None, "dl_teid"),
                               (opts[2], "ul_addr", None),
                               (opts[3], None, "ul_teid")):
        if not flag:
            continue
        if a_key:
            out[a_key] = _read_addr(r)[0]
        else:
            r.align()
            out[t_key] = int.from_bytes(r.read_octets(4), "big")
    return out


def _write_erab_admitted_item(w: BitWriter, v: dict):
    w.write_bits(0, 1)
    for key in ("dl_addr", "dl_teid", "ul_addr", "ul_teid"):
        w.write_bits(1 if key in v else 0, 1)
    w.write_bits(0, 1)  # iE-Extensions
    w.write_bits(0, 1)  # E-RAB-ID ext
    w.write_bits(v["erab_id"], 4)
    _write_addr(w, v["addr"], v.get("addr_bits"))
    w.align()
    w.write_octets(int(v["teid"]).to_bytes(4, "big"))
    if "dl_addr" in v:
        _write_addr(w, v["dl_addr"])
    if "dl_teid" in v:
        w.align()
        w.write_octets(int(v["dl_teid"]).to_bytes(4, "big"))
    if "ul_addr" in v:
        _write_addr(w, v["ul_addr"])
    if "ul_teid" in v:
        w.align()
        w.write_octets(int(v["ul_teid"]).to_bytes(4, "big"))


def _read_erab_cause_item(r: BitReader) -> dict:
    """E-RABItem (E-RAB-ID + Cause) — E-RABList members."""
    if r.read_bits(1):
        raise AperError("E-RABItem extension")
    if r.read_bits(1):
        raise AperError("E-RABItem iE-Extensions")
    if r.read_bits(1):
        raise AperError("E-RAB-ID extension")
    erab_id = r.read_bits(4)
    return dict(erab_id=erab_id, cause=_read_cause(r))


def _write_erab_cause_item(w: BitWriter, v: dict):
    w.write_bits(0, 3)
    w.write_bits(v["erab_id"], 4)
    _write_cause(w, v["cause"])


def _read_erab_id_item(r: BitReader) -> dict:
    """E-RABReleaseItemBearerRelComp: just the E-RAB-ID."""
    if r.read_bits(1):
        raise AperError("item extension")
    if r.read_bits(1):
        raise AperError("item iE-Extensions")
    if r.read_bits(1):
        raise AperError("E-RAB-ID extension")
    return dict(erab_id=r.read_bits(4))


def _write_erab_id_item(w: BitWriter, v: dict):
    w.write_bits(0, 3)
    w.write_bits(v["erab_id"], 4)


def _erab_list_reader(item_id: int, item_reader):
    """SEQUENCE (SIZE(1..256)) OF ProtocolIE-SingleContainer{item}."""
    def read(r: BitReader) -> list:
        n = r.read_bits(8) + 1
        r.align()
        items = []
        for _ in range(n):
            ie_id = read_constrained(r, 0, 65535)
            _crit = CRITICALITY[r.read_bits(2)]
            body = read_open_type(r)
            if ie_id != item_id:
                raise AperError(f"unexpected list member {ie_id}")
            items.append(item_reader(BitReader(body)))
        return items
    return read


def _write_erab_list(w: BitWriter, items: list, item_id: int, item_writer,
                     crit: str = "reject"):
    w.write_bits(len(items) - 1, 8)
    w.align()
    for v in items:
        iw = BitWriter()
        item_writer(iw, v)
        write_constrained(w, item_id, 0, 65535)
        w.write_bits(CRITICALITY.index(crit), 2)
        write_open_type(w, iw.to_bytes())


_IE_DECODERS = {
    ID_SERVED_GUMMEIS: _read_gummei_list,
    ID_RELATIVE_MME_CAPACITY: lambda r: read_constrained(r, 0, 255),
    ID_MME_NAME: _read_mme_name,
    ID_MME_UE_S1AP_ID: lambda r: read_constrained(r, 0, 4294967295),
    ID_ENB_UE_S1AP_ID: lambda r: read_constrained(r, 0, 16777215),
    ID_NAS_PDU: _read_nas_pdu,
    ID_TAI: _read_tai,
    ID_EUTRAN_CGI: _read_cgi,
    ID_CAUSE: _read_cause,
    ID_RRC_ESTABLISHMENT_CAUSE: _read_rrc_cause,
    ID_UE_PAGING_ID: _read_ue_paging_id,
    ID_UE_S1AP_IDS: _read_ue_s1ap_ids,
    ID_CN_DOMAIN: lambda r: ("ps", "cs")[r.read_bits(1)],
    ID_TAI_LIST: _read_tai_list,
    ID_UE_IDENTITY_INDEX: lambda r: r.read_bits(10),
    ID_UE_SECURITY_CAPABILITIES: _read_security_caps,
    ID_SECURITY_KEY: _read_security_key,
    ID_UE_AGGREGATE_MAX_BITRATE: _read_ue_ambr,
    ID_ERAB_TO_BE_SETUP_LIST_CTXT: _read_erab_setup_list,
    ID_S_TMSI: _read_s_tmsi,
    # mobility + E-RAB management
    ID_HANDOVER_TYPE: _read_handover_type,
    ID_TARGET_ID: _read_target_id,
    ID_SECURITY_CONTEXT: _read_security_context,
    ID_SOURCE_TO_TARGET_CONTAINER: _read_nas_pdu,  # dynamic octet string
    ID_TARGET_TO_SOURCE_CONTAINER: _read_nas_pdu,
    ID_SOURCE_MME_UE_S1AP_ID: lambda r: read_constrained(r, 0, 4294967295),
    ID_ERAB_TO_BE_SETUP_LIST_HO_REQ: _erab_list_reader(
        ID_ERAB_TO_BE_SETUP_ITEM_HO_REQ, _read_erab_horeq_item),
    ID_ERAB_ADMITTED_LIST: _erab_list_reader(
        ID_ERAB_ADMITTED_ITEM, _read_erab_admitted_item),
    ID_ERAB_TO_BE_SWITCHED_DL_LIST: _erab_list_reader(
        ID_ERAB_TO_BE_SWITCHED_DL_ITEM, _read_erab_teid_item),
    ID_ERAB_TO_BE_SWITCHED_UL_LIST: _erab_list_reader(
        ID_ERAB_TO_BE_SWITCHED_UL_ITEM, _read_erab_teid_item),
    ID_ERAB_TO_BE_SETUP_LIST_BEARER_SU_REQ: _erab_list_reader(
        ID_ERAB_TO_BE_SETUP_ITEM_BEARER_SU_REQ, _read_erab_sureq_item),
    ID_ERAB_SETUP_LIST_BEARER_SU_RES: _erab_list_reader(
        ID_ERAB_SETUP_ITEM_BEARER_SU_RES, _read_erab_teid_item),
    ID_ERAB_TO_BE_RELEASED_LIST: _erab_list_reader(
        ID_ERAB_ITEM, _read_erab_cause_item),
    ID_ERAB_RELEASE_LIST_BEARER_REL_COMP: _erab_list_reader(
        ID_ERAB_RELEASE_ITEM_BEARER_REL_COMP, _read_erab_id_item),
}


def _encode_ie_value(ie: ProtocolIE) -> bytes:
    w = BitWriter()
    if ie.id == ID_SERVED_GUMMEIS:
        _write_gummei_list(w, ie.value)
    elif ie.id == ID_RELATIVE_MME_CAPACITY:
        write_constrained(w, ie.value, 0, 255)
    elif ie.id == ID_MME_NAME:
        write_constrained(w, len(ie.value), 1, 150)
        w.write_octets(ie.value.encode())
    elif ie.id == ID_MME_UE_S1AP_ID:
        write_constrained(w, ie.value, 0, 4294967295)
    elif ie.id == ID_ENB_UE_S1AP_ID:
        write_constrained(w, ie.value, 0, 16777215)
    elif ie.id == ID_NAS_PDU:
        write_length(w, len(ie.value))
        w.write_octets(bytes(ie.value))
    elif ie.id == ID_TAI:
        _write_tai(w, ie.value)
    elif ie.id == ID_EUTRAN_CGI:
        _write_cgi(w, ie.value)
    elif ie.id == ID_CAUSE:
        _write_cause(w, ie.value)
    elif ie.id == ID_RRC_ESTABLISHMENT_CAUSE:
        w.write_bits(0, 1)
        write_constrained(w, RRC_CAUSES.index(ie.value), 0,
                          len(RRC_CAUSES) - 1)
    elif ie.id == ID_UE_PAGING_ID:
        _write_ue_paging_id(w, ie.value)
    elif ie.id == ID_UE_S1AP_IDS:
        _write_ue_s1ap_ids(w, ie.value)
    elif ie.id == ID_CN_DOMAIN:
        w.write_bits(("ps", "cs").index(ie.value), 1)
    elif ie.id == ID_TAI_LIST:
        _write_tai_list(w, ie.value)
    elif ie.id == ID_UE_IDENTITY_INDEX:
        w.write_bits(ie.value, 10)  # BIT STRING SIZE(10): unaligned
    elif ie.id == ID_UE_SECURITY_CAPABILITIES:
        _write_security_caps(w, ie.value)
    elif ie.id == ID_SECURITY_KEY:
        w.align()
        for b in ie.value:
            w.write_bits(b, 8)
    elif ie.id == ID_UE_AGGREGATE_MAX_BITRATE:
        _write_ue_ambr(w, ie.value)
    elif ie.id == ID_ERAB_TO_BE_SETUP_LIST_CTXT:
        _write_erab_setup_list(w, ie.value)
    elif ie.id == ID_S_TMSI:
        _write_s_tmsi(w, ie.value)
    elif ie.id == ID_HANDOVER_TYPE:
        _write_handover_type(w, ie.value)
    elif ie.id == ID_TARGET_ID:
        _write_target_id(w, ie.value)
    elif ie.id == ID_SECURITY_CONTEXT:
        _write_security_context(w, ie.value)
    elif ie.id in (ID_SOURCE_TO_TARGET_CONTAINER,
                   ID_TARGET_TO_SOURCE_CONTAINER):
        write_length(w, len(ie.value))
        w.write_octets(bytes(ie.value))
    elif ie.id == ID_SOURCE_MME_UE_S1AP_ID:
        write_constrained(w, ie.value, 0, 4294967295)
    elif ie.id == ID_ERAB_TO_BE_SETUP_LIST_HO_REQ:
        _write_erab_list(w, ie.value, ID_ERAB_TO_BE_SETUP_ITEM_HO_REQ,
                         _write_erab_horeq_item)
    elif ie.id == ID_ERAB_ADMITTED_LIST:
        _write_erab_list(w, ie.value, ID_ERAB_ADMITTED_ITEM,
                         _write_erab_admitted_item, crit="ignore")
    elif ie.id == ID_ERAB_TO_BE_SWITCHED_DL_LIST:
        _write_erab_list(w, ie.value, ID_ERAB_TO_BE_SWITCHED_DL_ITEM,
                         _write_erab_teid_item)
    elif ie.id == ID_ERAB_TO_BE_SWITCHED_UL_LIST:
        _write_erab_list(w, ie.value, ID_ERAB_TO_BE_SWITCHED_UL_ITEM,
                         _write_erab_teid_item, crit="ignore")
    elif ie.id == ID_ERAB_TO_BE_SETUP_LIST_BEARER_SU_REQ:
        _write_erab_list(w, ie.value, ID_ERAB_TO_BE_SETUP_ITEM_BEARER_SU_REQ,
                         _write_erab_sureq_item)
    elif ie.id == ID_ERAB_SETUP_LIST_BEARER_SU_RES:
        _write_erab_list(w, ie.value, ID_ERAB_SETUP_ITEM_BEARER_SU_RES,
                         _write_erab_teid_item, crit="ignore")
    elif ie.id == ID_ERAB_TO_BE_RELEASED_LIST:
        _write_erab_list(w, ie.value, ID_ERAB_ITEM, _write_erab_cause_item,
                         crit="ignore")
    elif ie.id == ID_ERAB_RELEASE_LIST_BEARER_REL_COMP:
        _write_erab_list(w, ie.value, ID_ERAB_RELEASE_ITEM_BEARER_REL_COMP,
                         _write_erab_id_item, crit="ignore")
    elif isinstance(ie.value, (bytes, bytearray)):
        w.write_octets(bytes(ie.value))  # raw passthrough
    else:
        raise AperError(f"cannot encode IE {ie.id}")
    return w.to_bytes()


def _read_ie_container(r: BitReader) -> list:
    n = read_constrained(r, 0, 65535)
    ies = []
    for _ in range(n):
        ie_id = read_constrained(r, 0, 65535)
        crit = CRITICALITY[r.read_bits(2)]
        body = read_open_type(r)
        dec = _IE_DECODERS.get(ie_id)
        val = dec(BitReader(body)) if dec else body
        ies.append(ProtocolIE(ie_id, crit, val))
    return ies


def decode_pdu(data: bytes) -> S1apPdu:
    r = BitReader(bytes(data))
    if r.read_bits(1):
        raise AperError("extended PDU choice")
    idx = r.read_bits(2)
    pdu_type = ("initiatingMessage", "successfulOutcome",
                "unsuccessfulOutcome")[idx]
    proc = read_constrained(r, 0, 255)
    crit = CRITICALITY[r.read_bits(2)]
    body = read_open_type(r)
    br = BitReader(body)
    if br.read_bits(1):
        raise AperError("extended message sequence")
    ies = _read_ie_container(br)
    return S1apPdu(pdu_type, proc, crit, ies)


# ---- procedure builders (36.413 §8/§9.1) ----------------------------------
# 36.413-conformant PDUs for the runtime's S1 procedures: the simulator's
# typed messages (epc/mme.py dataclasses) map onto these for wire interop
# with a real MME/eNB (srsepc s1ap.cc / srsenb s1ap.cc message shapes).

def _ie(id_, crit, value):
    return ProtocolIE(id_, crit, value)


def initial_ue_message(enb_ue_id: int, nas_pdu: bytes, tai: dict, cgi: dict,
                       cause: str = "mo-Signalling",
                       s_tmsi: dict = None) -> S1apPdu:
    ies = [
        _ie(ID_ENB_UE_S1AP_ID, "reject", enb_ue_id),
        _ie(ID_NAS_PDU, "reject", bytes(nas_pdu)),
        _ie(ID_TAI, "reject", tai),
        _ie(ID_EUTRAN_CGI, "ignore", cgi),
        _ie(ID_RRC_ESTABLISHMENT_CAUSE, "ignore", cause),
    ]
    if s_tmsi is not None:
        # 36.413 §9.1.7.1 IE order puts S-TMSI AFTER the establishment
        # cause (the reference's packer emits this order; fuzz-verified)
        ies.append(_ie(ID_S_TMSI, "reject", s_tmsi))
    return S1apPdu("initiatingMessage", PROC_INITIAL_UE_MESSAGE, "ignore",
                   ies)


def downlink_nas_transport(mme_ue_id: int, enb_ue_id: int,
                           nas_pdu: bytes) -> S1apPdu:
    return S1apPdu("initiatingMessage", PROC_DOWNLINK_NAS_TRANSPORT,
                   "ignore", [
                       _ie(ID_MME_UE_S1AP_ID, "reject", mme_ue_id),
                       _ie(ID_ENB_UE_S1AP_ID, "reject", enb_ue_id),
                       _ie(ID_NAS_PDU, "reject", bytes(nas_pdu)),
                   ])


def uplink_nas_transport(mme_ue_id: int, enb_ue_id: int, nas_pdu: bytes,
                         cgi: dict, tai: dict) -> S1apPdu:
    return S1apPdu("initiatingMessage", PROC_UPLINK_NAS_TRANSPORT,
                   "ignore", [
                       _ie(ID_MME_UE_S1AP_ID, "reject", mme_ue_id),
                       _ie(ID_ENB_UE_S1AP_ID, "reject", enb_ue_id),
                       _ie(ID_NAS_PDU, "reject", bytes(nas_pdu)),
                       _ie(ID_EUTRAN_CGI, "ignore", cgi),
                       _ie(ID_TAI, "ignore", tai),
                   ])


def ue_context_release_command(mme_ue_id: int, enb_ue_id: int,
                               cause=("nas", 0)) -> S1apPdu:
    ids = ("pair", dict(mme_ue_id=mme_ue_id, enb_ue_id=enb_ue_id))
    return S1apPdu("initiatingMessage", PROC_UE_CONTEXT_RELEASE, "reject", [
        _ie(ID_UE_S1AP_IDS, "reject", ids),
        _ie(ID_CAUSE, "ignore", cause),
    ])


def ue_context_release_request(mme_ue_id: int, enb_ue_id: int,
                               cause=("radioNetwork", 21)) -> S1apPdu:
    return S1apPdu("initiatingMessage", PROC_UE_CONTEXT_RELEASE_REQUEST,
                   "ignore", [
                       _ie(ID_MME_UE_S1AP_ID, "reject", mme_ue_id),
                       _ie(ID_ENB_UE_S1AP_ID, "reject", enb_ue_id),
                       _ie(ID_CAUSE, "ignore", cause),
                   ])


def paging(mmec: bytes, m_tmsi: bytes, tai: dict, cn_domain: str = "ps",
           ue_identity_index: int = None) -> S1apPdu:
    pid = ("s_tmsi", dict(mmec=bytes(mmec), m_tmsi=bytes(m_tmsi)))
    if ue_identity_index is None:
        # UE_ID mod 1024 (36.304 §7: index drives the paging frame)
        ue_identity_index = int.from_bytes(m_tmsi, "big") % 1024
    return S1apPdu("initiatingMessage", PROC_PAGING, "ignore", [
        _ie(ID_UE_IDENTITY_INDEX, "ignore", ue_identity_index),
        _ie(ID_UE_PAGING_ID, "ignore", pid),
        _ie(ID_CN_DOMAIN, "ignore", cn_domain),
        _ie(ID_TAI_LIST, "ignore", [tai]),
    ])


def initial_context_setup_request(mme_ue_id: int, enb_ue_id: int,
                                  kenb: bytes, erab_items: list,
                                  ambr_dl: int = 1_000_000_000,
                                  ambr_ul: int = 1_000_000_000,
                                  security_caps: dict = None,
                                  dl_teid: int = None) -> S1apPdu:
    """36.413 §8.3.1 InitialContextSetupRequest with the mandatory IEs the
    reference's liblte_s1ap packs (MME/eNB ids, UE-AMBR, E-RAB list, UE
    security capabilities, SecurityKey = KeNB)."""
    caps = security_caps or dict(eea=0xE000, eia=0x6000)  # EEA1-3 / EIA1-2
    ies = [
        _ie(ID_MME_UE_S1AP_ID, "reject", mme_ue_id),
        _ie(ID_ENB_UE_S1AP_ID, "reject", enb_ue_id),
        _ie(ID_UE_AGGREGATE_MAX_BITRATE, "reject",
            dict(dl=ambr_dl, ul=ambr_ul)),
        _ie(ID_ERAB_TO_BE_SETUP_LIST_CTXT, "reject", list(erab_items)),
        _ie(ID_UE_SECURITY_CAPABILITIES, "reject", caps),
        _ie(ID_SECURITY_KEY, "reject", bytes(kenb)),
    ]
    if dl_teid is not None:
        ies.append(_ie(ID_EMU_DL_TEID, "ignore",
                       int(dl_teid).to_bytes(4, "big")))
    return S1apPdu("initiatingMessage", PROC_INITIAL_CONTEXT_SETUP,
                   "reject", ies)


# ---- S1 mobility + E-RAB management (36.413 §8.4/§8.2) --------------------

def handover_required(mme_ue_id: int, enb_ue_id: int, target_enb: dict,
                      tai: dict, container: bytes,
                      cause=("radioNetwork", 0),
                      ho_type: str = "intralte") -> S1apPdu:
    """36.413 §8.4.1 HandoverRequired (source eNB -> MME);
    liblte_s1ap.cc:22996 pack_handoverrequired IE order."""
    return S1apPdu("initiatingMessage", PROC_HANDOVER_PREPARATION,
                   "reject", [
                       _ie(ID_MME_UE_S1AP_ID, "reject", mme_ue_id),
                       _ie(ID_ENB_UE_S1AP_ID, "reject", enb_ue_id),
                       _ie(ID_HANDOVER_TYPE, "reject", ho_type),
                       _ie(ID_CAUSE, "ignore", cause),
                       _ie(ID_TARGET_ID, "reject",
                           dict(global_enb_id=target_enb, tai=tai)),
                       _ie(ID_SOURCE_TO_TARGET_CONTAINER, "reject",
                           bytes(container)),
                   ])


def handover_command(mme_ue_id: int, enb_ue_id: int, container: bytes,
                     ho_type: str = "intralte") -> S1apPdu:
    """36.413 §8.4.1 HandoverCommand (MME -> source eNB,
    successfulOutcome of HandoverPreparation)."""
    return S1apPdu("successfulOutcome", PROC_HANDOVER_PREPARATION,
                   "reject", [
                       _ie(ID_MME_UE_S1AP_ID, "reject", mme_ue_id),
                       _ie(ID_ENB_UE_S1AP_ID, "reject", enb_ue_id),
                       _ie(ID_HANDOVER_TYPE, "reject", ho_type),
                       _ie(ID_TARGET_TO_SOURCE_CONTAINER, "reject",
                           bytes(container)),
                   ])


def handover_request(mme_ue_id: int, erab_items: list, container: bytes,
                     nh: bytes, nhcc: int = 0,
                     cause=("radioNetwork", 0),
                     ho_type: str = "intralte",
                     ambr_dl: int = 1_000_000_000,
                     ambr_ul: int = 1_000_000_000,
                     security_caps: dict = None) -> S1apPdu:
    """36.413 §8.4.2 HandoverRequest (MME -> target eNB).  erab_items:
    E-RABToBeSetupItemHOReq dicts (erab_id/addr/teid/qci...)."""
    caps = security_caps or dict(eea=0xE000, eia=0x6000)
    return S1apPdu("initiatingMessage", PROC_HANDOVER_RESOURCE_ALLOCATION,
                   "reject", [
                       _ie(ID_MME_UE_S1AP_ID, "reject", mme_ue_id),
                       _ie(ID_HANDOVER_TYPE, "reject", ho_type),
                       _ie(ID_CAUSE, "ignore", cause),
                       _ie(ID_UE_AGGREGATE_MAX_BITRATE, "reject",
                           dict(dl=ambr_dl, ul=ambr_ul)),
                       _ie(ID_ERAB_TO_BE_SETUP_LIST_HO_REQ, "reject",
                           list(erab_items)),
                       _ie(ID_SOURCE_TO_TARGET_CONTAINER, "reject",
                           bytes(container)),
                       _ie(ID_UE_SECURITY_CAPABILITIES, "reject", caps),
                       _ie(ID_SECURITY_CONTEXT, "reject",
                           dict(nhcc=nhcc, nh=bytes(nh))),
                   ])


def handover_request_acknowledge(mme_ue_id: int, enb_ue_id: int,
                                 admitted: list,
                                 container: bytes) -> S1apPdu:
    """36.413 §8.4.2 HandoverRequestAcknowledge (target eNB -> MME)."""
    return S1apPdu("successfulOutcome", PROC_HANDOVER_RESOURCE_ALLOCATION,
                   "reject", [
                       _ie(ID_MME_UE_S1AP_ID, "ignore", mme_ue_id),
                       _ie(ID_ENB_UE_S1AP_ID, "ignore", enb_ue_id),
                       _ie(ID_ERAB_ADMITTED_LIST, "ignore", list(admitted)),
                       _ie(ID_TARGET_TO_SOURCE_CONTAINER, "reject",
                           bytes(container)),
                   ])


def handover_notify(mme_ue_id: int, enb_ue_id: int, cgi: dict,
                    tai: dict) -> S1apPdu:
    """36.413 §8.4.3 HandoverNotify (target eNB -> MME: UE arrived)."""
    return S1apPdu("initiatingMessage", PROC_HANDOVER_NOTIFICATION,
                   "ignore", [
                       _ie(ID_MME_UE_S1AP_ID, "reject", mme_ue_id),
                       _ie(ID_ENB_UE_S1AP_ID, "reject", enb_ue_id),
                       _ie(ID_EUTRAN_CGI, "ignore", cgi),
                       _ie(ID_TAI, "ignore", tai),
                   ])


def path_switch_request(enb_ue_id: int, switched: list,
                        source_mme_ue_id: int, cgi: dict, tai: dict,
                        security_caps: dict = None) -> S1apPdu:
    """36.413 §8.4.4 PathSwitchRequest (X2-HO target eNB -> MME;
    liblte_s1ap.cc:24316 family).  switched: E-RABToBeSwitchedDLItem
    dicts (erab_id/addr/teid: the TARGET eNB's new DL endpoints)."""
    caps = security_caps or dict(eea=0xE000, eia=0x6000)
    return S1apPdu("initiatingMessage", PROC_PATH_SWITCH_REQUEST,
                   "reject", [
                       _ie(ID_ENB_UE_S1AP_ID, "reject", enb_ue_id),
                       _ie(ID_ERAB_TO_BE_SWITCHED_DL_LIST, "reject",
                           list(switched)),
                       _ie(ID_SOURCE_MME_UE_S1AP_ID, "reject",
                           source_mme_ue_id),
                       _ie(ID_EUTRAN_CGI, "ignore", cgi),
                       _ie(ID_TAI, "ignore", tai),
                       _ie(ID_UE_SECURITY_CAPABILITIES, "ignore", caps),
                   ])


def path_switch_request_acknowledge(mme_ue_id: int, enb_ue_id: int,
                                    nh: bytes, nhcc: int = 0) -> S1apPdu:
    """36.413 §8.4.4 PathSwitchRequestAcknowledge (MME -> eNB): fresh
    {NH, NCC} pair for the next X2 handover (33.401 §7.2.8.4)."""
    return S1apPdu("successfulOutcome", PROC_PATH_SWITCH_REQUEST,
                   "reject", [
                       _ie(ID_MME_UE_S1AP_ID, "ignore", mme_ue_id),
                       _ie(ID_ENB_UE_S1AP_ID, "ignore", enb_ue_id),
                       _ie(ID_SECURITY_CONTEXT, "reject",
                           dict(nhcc=nhcc, nh=bytes(nh))),
                   ])


def erab_setup_request(mme_ue_id: int, enb_ue_id: int, erab_items: list,
                       ambr_dl: int = 1_000_000_000,
                       ambr_ul: int = 1_000_000_000) -> S1apPdu:
    """36.413 §8.2.1 E-RABSetupRequest (dedicated bearer setup).
    erab_items: E-RABToBeSetupItemBearerSUReq dicts (nas_pdu MANDATORY)."""
    return S1apPdu("initiatingMessage", PROC_ERAB_SETUP, "reject", [
        _ie(ID_MME_UE_S1AP_ID, "reject", mme_ue_id),
        _ie(ID_ENB_UE_S1AP_ID, "reject", enb_ue_id),
        _ie(ID_UE_AGGREGATE_MAX_BITRATE, "reject",
            dict(dl=ambr_dl, ul=ambr_ul)),
        _ie(ID_ERAB_TO_BE_SETUP_LIST_BEARER_SU_REQ, "reject",
            list(erab_items)),
    ])


def erab_setup_response(mme_ue_id: int, enb_ue_id: int,
                        items: list) -> S1apPdu:
    """36.413 §8.2.1 E-RABSetupResponse.  items: erab_id/addr/teid."""
    return S1apPdu("successfulOutcome", PROC_ERAB_SETUP, "reject", [
        _ie(ID_MME_UE_S1AP_ID, "ignore", mme_ue_id),
        _ie(ID_ENB_UE_S1AP_ID, "ignore", enb_ue_id),
        _ie(ID_ERAB_SETUP_LIST_BEARER_SU_RES, "ignore", list(items)),
    ])


def erab_release_command(mme_ue_id: int, enb_ue_id: int, items: list,
                         nas_pdu: bytes = None,
                         ambr_dl: int = 1_000_000_000,
                         ambr_ul: int = 1_000_000_000) -> S1apPdu:
    """36.413 §8.2.3 E-RABReleaseCommand.  items: erab_id + cause."""
    ies = [
        _ie(ID_MME_UE_S1AP_ID, "reject", mme_ue_id),
        _ie(ID_ENB_UE_S1AP_ID, "reject", enb_ue_id),
        _ie(ID_UE_AGGREGATE_MAX_BITRATE, "reject",
            dict(dl=ambr_dl, ul=ambr_ul)),
        _ie(ID_ERAB_TO_BE_RELEASED_LIST, "ignore", list(items)),
    ]
    if nas_pdu is not None:
        ies.append(_ie(ID_NAS_PDU, "ignore", bytes(nas_pdu)))
    return S1apPdu("initiatingMessage", PROC_ERAB_RELEASE, "reject", ies)


def erab_release_response(mme_ue_id: int, enb_ue_id: int,
                          released: list) -> S1apPdu:
    """36.413 §8.2.3 E-RABReleaseResponse.  released: erab_id dicts."""
    return S1apPdu("successfulOutcome", PROC_ERAB_RELEASE, "reject", [
        _ie(ID_MME_UE_S1AP_ID, "ignore", mme_ue_id),
        _ie(ID_ENB_UE_S1AP_ID, "ignore", enb_ue_id),
        _ie(ID_ERAB_RELEASE_LIST_BEARER_REL_COMP, "ignore",
            list(released)),
    ])


def encode_pdu(pdu: S1apPdu) -> bytes:
    w = BitWriter()
    idx = ("initiatingMessage", "successfulOutcome",
           "unsuccessfulOutcome").index(pdu.pdu_type)
    w.write_bits(0, 1)
    w.write_bits(idx, 2)
    write_constrained(w, pdu.procedure_code, 0, 255)
    w.write_bits(CRITICALITY.index(pdu.criticality), 2)
    # message body: sequence ext bit + IE container
    bw = BitWriter()
    bw.write_bits(0, 1)
    write_constrained(bw, len(pdu.ies), 0, 65535)
    for ie in pdu.ies:
        write_constrained(bw, ie.id, 0, 65535)
        bw.write_bits(CRITICALITY.index(ie.criticality), 2)
        write_open_type(bw, _encode_ie_value(ie))
    write_open_type(w, bw.to_bytes())
    return w.to_bytes()
