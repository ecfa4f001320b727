"""Real 36.413 APER S1AP PDUs on the live inter-process S1-MME wire.

Reference behavior: srsenb/srsepc exchange actual S1AP APER bytes over
SCTP (`srsenb/src/stack/upper/s1ap.cc`, `srsepc/src/mme/s1ap.cc`,
encoded by `lib/src/asn1/liblte_s1ap.cc`).  Here the NAS-transport and
UE-context procedures ride the wire as the same spec bytes, produced and
parsed by the capture-proven `stack/asn1/s1ap36413.py` codec (byte-exact
against the reference's s1ap_test.cc vectors); this module is the bridge
between the typed `epc/mme.py` dataclasses the stacks exchange in-process
and those on-the-wire PDUs.  SCTP itself is unavailable in this kernel
(IPPROTO_SCTP -> EPROTONOSUPPORT), so the PDUs ride the length-prefixed
TCP framing of `apps/rpc.py` — the byte payloads are unchanged.

InitialContextSetup rides as a real PDU too (E-RAB-to-be-setup list with
QoS/ARP, transport address, GTP TEID, piggybacked NAS; SecurityKey =
KeNB), with one emulation-private extension IE for the eNB-side DL TEID
that the reference instead returns in the ICS Response.  Only the
handover containers continue as typed RPC arguments.
"""

from __future__ import annotations

import socket

from ..stack.asn1 import s1ap36413 as s1
from . import mme as mme_mod

# emulation-wide defaults (netsim single-PLMN): mcc 001 / mnc 01, tac 1
PLMN = bytes.fromhex("00f110")
TAI = dict(plmn=PLMN, tac=(1).to_bytes(2, "big"))


def _cgi(cell_id: int = 0x0100) -> dict:
    return dict(plmn=PLMN, cell_id=cell_id)


def _ies(pdu: s1.S1apPdu) -> dict:
    return {ie.id: ie.value for ie in pdu.ies}


# UEContextReleaseCommand.cause strings <-> 36.413 Cause (group, value);
# the eNB ignores the cause, so unmapped strings go through "nas"/0
_CAUSE_TO_WIRE = {
    "user-inactivity": ("radioNetwork", 20),
    "cs-fallback-triggered": ("radioNetwork", 14),
    "detach": ("nas", 2),
    "normal-release": ("nas", 0),
}
_CAUSE_FROM_WIRE = {v: k for k, v in _CAUSE_TO_WIRE.items()}


def _enc_initial_ue(msg: mme_mod.InitialUEMessage) -> bytes:
    s_tmsi = None
    if msg.s_tmsi is not None:
        s_tmsi = dict(mmec=1, m_tmsi=msg.s_tmsi)
    return s1.encode_pdu(s1.initial_ue_message(
        msg.enb_ue_id, msg.nas_pdu, TAI, _cgi(), s_tmsi=s_tmsi))


def _dec_initial_ue(data: bytes) -> mme_mod.InitialUEMessage:
    ies = _ies(s1.decode_pdu(data))
    st = ies.get(s1.ID_S_TMSI)
    return mme_mod.InitialUEMessage(
        enb_ue_id=ies[s1.ID_ENB_UE_S1AP_ID], nas_pdu=ies[s1.ID_NAS_PDU],
        s_tmsi=st["m_tmsi"] if st is not None else None)


def _enc_ul_nas(msg: mme_mod.UplinkNASTransport) -> bytes:
    return s1.encode_pdu(s1.uplink_nas_transport(
        msg.mme_ue_id, msg.enb_ue_id, msg.nas_pdu, _cgi(), TAI))


def _dec_ul_nas(data: bytes) -> mme_mod.UplinkNASTransport:
    ies = _ies(s1.decode_pdu(data))
    return mme_mod.UplinkNASTransport(
        mme_ue_id=ies[s1.ID_MME_UE_S1AP_ID],
        enb_ue_id=ies[s1.ID_ENB_UE_S1AP_ID], nas_pdu=ies[s1.ID_NAS_PDU])


def _enc_dl_nas(msg: mme_mod.DownlinkNASTransport) -> bytes:
    return s1.encode_pdu(s1.downlink_nas_transport(
        msg.mme_ue_id, msg.enb_ue_id, msg.nas_pdu))


def _dec_dl_nas(data: bytes) -> mme_mod.DownlinkNASTransport:
    ies = _ies(s1.decode_pdu(data))
    return mme_mod.DownlinkNASTransport(
        mme_ue_id=ies[s1.ID_MME_UE_S1AP_ID],
        enb_ue_id=ies[s1.ID_ENB_UE_S1AP_ID], nas_pdu=ies[s1.ID_NAS_PDU])


def _enc_release(msg: mme_mod.UEContextReleaseCommand) -> bytes:
    cause = _CAUSE_TO_WIRE.get(msg.cause, ("nas", 0))
    return s1.encode_pdu(s1.ue_context_release_command(
        msg.mme_ue_id, msg.enb_ue_id, cause))


def _dec_release(data: bytes) -> mme_mod.UEContextReleaseCommand:
    ies = _ies(s1.decode_pdu(data))
    kind, ids = ies[s1.ID_UE_S1AP_IDS]
    if kind == "pair":
        mme_id, enb_id = ids["mme_ue_id"], ids["enb_ue_id"]
    else:  # mME-UE-S1AP-ID choice alternative
        mme_id, enb_id = ids, 0
    cause = _CAUSE_FROM_WIRE.get(tuple(ies.get(s1.ID_CAUSE, ("nas", 0))),
                                 "normal-release")
    return mme_mod.UEContextReleaseCommand(
        mme_ue_id=mme_id, enb_ue_id=enb_id, cause=cause)


def _enc_ctx_setup(msg: mme_mod.InitialContextSetupRequest) -> bytes:
    item = dict(erab_id=msg.eps_bearer_id, qci=9, arp_priority=15,
                pre_emption_capability=0, pre_emption_vulnerability=0,
                addr=socket.inet_aton(msg.ue_ip), addr_bits=32,
                teid=msg.teid_spgw,
                nas_pdu=msg.nas_pdu if msg.nas_pdu else None)
    return s1.encode_pdu(s1.initial_context_setup_request(
        msg.mme_ue_id, msg.enb_ue_id, msg.kenb, [item],
        dl_teid=msg.teid_enb))


def _dec_ctx_setup(data: bytes) -> mme_mod.InitialContextSetupRequest:
    ies = _ies(s1.decode_pdu(data))
    item = ies[s1.ID_ERAB_TO_BE_SETUP_LIST_CTXT][0]
    return mme_mod.InitialContextSetupRequest(
        mme_ue_id=ies[s1.ID_MME_UE_S1AP_ID],
        enb_ue_id=ies[s1.ID_ENB_UE_S1AP_ID],
        kenb=ies[s1.ID_SECURITY_KEY],
        ue_ip=socket.inet_ntoa(item["addr"]),
        teid_spgw=item["teid"],
        teid_enb=int.from_bytes(ies[s1.ID_EMU_DL_TEID], "big"),
        eps_bearer_id=item["erab_id"],
        nas_pdu=item["nas_pdu"] or b"")


# ---- S1 mobility (36.413 §8.4) --------------------------------------------
# The typed HO dataclasses ride as the real HandoverPreparation /
# HandoverResourceAllocation / PathSwitchRequest PDUs.  The emulation's
# transparent containers carry exactly what the reference's RRC
# containers carry at these points: HandoverPreparationInformation's
# role (source -> target: here the target PCI) and the RRC
# HandoverCommand's role (mobilityControlInfo: target PCI, new C-RNTI,
# dedicated preamble, plus KeNB* which the reference passes alongside).

def _enc_ho_required(msg: mme_mod.HandoverRequired) -> bytes:
    genb = dict(plmn=PLMN, macro_enb_id=msg.target_pci)
    return s1.encode_pdu(s1.handover_required(
        msg.mme_ue_id, msg.enb_ue_id, genb, TAI,
        container=int(msg.target_pci).to_bytes(2, "big"),
        cause=("radioNetwork", 2)))  # handover-desirable-for-radio-reasons


def _dec_ho_required(data: bytes) -> mme_mod.HandoverRequired:
    ies = _ies(s1.decode_pdu(data))
    tgt = ies[s1.ID_TARGET_ID]["global_enb_id"]
    return mme_mod.HandoverRequired(
        mme_ue_id=ies[s1.ID_MME_UE_S1AP_ID],
        enb_ue_id=ies[s1.ID_ENB_UE_S1AP_ID],
        target_pci=tgt["macro_enb_id"])


def _enc_ho_request(msg: mme_mod.HandoverRequest) -> bytes:
    ip = msg.ue_ip or "0.0.0.0"
    item = dict(erab_id=5, addr=socket.inet_aton(ip), addr_bits=32,
                teid=msg.teid_spgw, qci=9, arp_priority=15,
                pre_emption_capability=0, pre_emption_vulnerability=0)
    # the eNB-side DL TEID rides the transparent container (the same
    # emulation-private convention as ICS's EMU_DL_TEID extension; the
    # reference returns it in the HandoverRequestAcknowledge instead)
    return s1.encode_pdu(s1.handover_request(
        msg.mme_ue_id, [item],
        container=int(msg.teid_enb).to_bytes(4, "big"),
        nh=msg.kenb_star, nhcc=0))


def _dec_ho_request(data: bytes) -> mme_mod.HandoverRequest:
    ies = _ies(s1.decode_pdu(data))
    item = ies[s1.ID_ERAB_TO_BE_SETUP_LIST_HO_REQ][0]
    ip = socket.inet_ntoa(item["addr"])
    return mme_mod.HandoverRequest(
        mme_ue_id=ies[s1.ID_MME_UE_S1AP_ID],
        kenb_star=ies[s1.ID_SECURITY_CONTEXT]["nh"],
        ue_ip=None if ip == "0.0.0.0" else ip,
        teid_spgw=item["teid"],
        teid_enb=int.from_bytes(ies[s1.ID_SOURCE_TO_TARGET_CONTAINER],
                                "big"))


def _enc_ho_command(msg: mme_mod.HandoverCommand) -> bytes:
    container = (int(msg.target_pci).to_bytes(2, "big")
                 + int(msg.new_rnti).to_bytes(2, "big")
                 + bytes([msg.dedicated_preamble])
                 + bytes(msg.kenb_star))
    return s1.encode_pdu(s1.handover_command(
        msg.mme_ue_id, msg.enb_ue_id, container))


def _dec_ho_command(data: bytes) -> mme_mod.HandoverCommand:
    ies = _ies(s1.decode_pdu(data))
    c = ies[s1.ID_TARGET_TO_SOURCE_CONTAINER]
    return mme_mod.HandoverCommand(
        mme_ue_id=ies[s1.ID_MME_UE_S1AP_ID],
        enb_ue_id=ies[s1.ID_ENB_UE_S1AP_ID],
        target_pci=int.from_bytes(c[0:2], "big"),
        new_rnti=int.from_bytes(c[2:4], "big"),
        dedicated_preamble=c[4], kenb_star=c[5:37])


def _enc_path_switch(msg: mme_mod.PathSwitchRequest) -> bytes:
    # the switched-DL endpoint is resolved MME-side from the eNB's
    # registered GTP-U sink (mme.path_switch -> spgw.path_switch), so
    # the wire item carries the E-RAB id with a null TLA (cataloged
    # asymmetry: the reference's eNB fills its real DL address here)
    item = dict(erab_id=5, addr=b"\x00\x00\x00\x00", teid=0)
    return s1.encode_pdu(s1.path_switch_request(
        msg.target_enb_ue_id, [item], msg.mme_ue_id, _cgi(), TAI))


def _dec_path_switch(data: bytes) -> mme_mod.PathSwitchRequest:
    ies = _ies(s1.decode_pdu(data))
    return mme_mod.PathSwitchRequest(
        mme_ue_id=ies[s1.ID_SOURCE_MME_UE_S1AP_ID],
        target_enb_ue_id=ies[s1.ID_ENB_UE_S1AP_ID])


def _enc_ho_request_ack(req: mme_mod.HandoverRequest, result: dict) -> bytes:
    """The ho_request RPC's return value as the real 36.413
    HandoverRequestAcknowledge: the target's new C-RNTI is its
    eNB-UE-S1AP-ID, and (rnti, preamble) ride the Target-ToSource
    transparent container (the RRC HandoverCommand payload role)."""
    adm = [dict(erab_id=5, addr=b"\x00\x00\x00\x00", teid=0)]
    container = (int(result["new_rnti"]).to_bytes(2, "big")
                 + bytes([result["preamble"]]))
    return s1.encode_pdu(s1.handover_request_acknowledge(
        req.mme_ue_id, result["new_rnti"], adm, container))


def _dec_ho_request_ack(data: bytes) -> dict:
    ies = _ies(s1.decode_pdu(data))
    c = ies[s1.ID_TARGET_TO_SOURCE_CONTAINER]
    return dict(new_rnti=int.from_bytes(c[0:2], "big"), preamble=c[2])


def _enc_page(ue_identity: int, cn_domain: str = "ps") -> bytes:
    return s1.encode_pdu(s1.paging(
        mmec=b"\x01", m_tmsi=int(ue_identity).to_bytes(4, "big"),
        tai=TAI, cn_domain=cn_domain))


def _dec_page(data: bytes) -> tuple:
    ies = _ies(s1.decode_pdu(data))
    _kind, pid = ies[s1.ID_UE_PAGING_ID]
    ident = int.from_bytes(pid["m_tmsi"], "big")
    return ident, ies.get(s1.ID_CN_DOMAIN, "ps")


# RPC path -> (argument index of the message, encoder, decoder).  The
# decoder returns either the typed dataclass or (for `page`) the expanded
# positional arguments.
_TABLE = {
    "initial_ue_message": (1, _enc_initial_ue, _dec_initial_ue),
    "uplink_nas": (1, _enc_ul_nas, _dec_ul_nas),
    "dl_nas": (0, _enc_dl_nas, _dec_dl_nas),
    "release": (0, _enc_release, _dec_release),
    "ctx_setup": (0, _enc_ctx_setup, _dec_ctx_setup),
    # S1 mobility: HandoverPreparation / ResourceAllocation / PathSwitch
    "handover_required": (1, _enc_ho_required, _dec_ho_required),
    "ho_request": (0, _enc_ho_request, _dec_ho_request),
    "ho_command": (0, _enc_ho_command, _dec_ho_command),
    "path_switch": (1, _enc_path_switch, _dec_path_switch),
}

# RPC results that ride as real successfulOutcome PDUs: (encoder taking
# (decoded request msg, result), decoder taking wire bytes)
_RESULT_TABLE = {
    "ho_request": (_enc_ho_request_ack, _dec_ho_request_ack),
}


def encode_result(path: str, args: tuple, result):
    """Server side: swap an RPC return value for its successfulOutcome
    APER bytes (args are the already-decoded typed arguments)."""
    ent = _RESULT_TABLE.get(path.rsplit(".", 1)[-1])
    if ent is None or result is None:
        return result
    enc, _dec = ent
    try:
        return {"__s1ap__": enc(args[0], result)}
    except (AttributeError, TypeError, KeyError, IndexError):
        return result


def decode_result(path: str, result):
    """Client side: parse a successfulOutcome PDU back to the value."""
    ent = _RESULT_TABLE.get(path.rsplit(".", 1)[-1])
    if ent is None or not isinstance(result, dict) \
            or "__s1ap__" not in result:
        return result
    _enc, dec = ent
    return dec(result["__s1ap__"])


def encode_args(path: str, args: tuple, kwargs: dict = None):
    """Client side: swap the typed S1AP message for its APER wire bytes.
    For `page` the cn_domain may arrive as a keyword — it is folded into
    the PDU and must not also ride the frame (the server re-expands the
    PDU positionally)."""
    leaf = path.rsplit(".", 1)[-1]
    if leaf == "page" and args and isinstance(args[0], int):
        kw = dict(kwargs) if kwargs else {}
        data = _enc_page(*args, **kw)
        if kwargs is not None:
            kwargs.pop("cn_domain", None)
        return ({"__s1ap__": data},)
    ent = _TABLE.get(leaf)
    if ent is None:
        return args
    idx, enc, _dec = ent
    if idx >= len(args):
        return args
    try:
        data = enc(args[idx])
    except (AttributeError, TypeError, KeyError):
        return args  # unexpected shape: fall back to typed transport
    out = list(args)
    out[idx] = {"__s1ap__": data}
    return tuple(out)


def decode_args(path: str, args: tuple):
    """Server side: parse APER wire bytes back to the typed message."""
    leaf = path.rsplit(".", 1)[-1]
    if leaf == "page" and args and isinstance(args[0], dict) \
            and "__s1ap__" in args[0]:
        return _dec_page(args[0]["__s1ap__"])
    ent = _TABLE.get(leaf)
    if ent is None:
        return args
    idx, _enc, dec = ent
    if idx < len(args) and isinstance(args[idx], dict) \
            and "__s1ap__" in args[idx]:
        out = list(args)
        out[idx] = dec(args[idx]["__s1ap__"])
        return tuple(out)
    return args
