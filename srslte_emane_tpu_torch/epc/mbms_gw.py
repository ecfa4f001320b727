"""MBMS gateway: SGi-mb ingress -> GTP-U multicast -> eNB PMCH queues.

Reference behavior: `srsepc/src/mbms-gw/mbms-gw.cc` — reads the SGi-mb TUN,
wraps packets in GTP-U and multicasts them on M1-U (mbms-gw.cc:210-231),
pairing with the eNB's eMBMS/PMCH transmission.
"""

from __future__ import annotations

from . import spgw as spgw_mod

M1U_TEID = 0xFFFF0001  # common multicast TEID


class MbmsGw:
    def __init__(self, area_id: int = 1):
        self.area_id = area_id
        self.enb_sinks = []  # callables receiving (area_id, gtpu_packet)
        self.metrics = dict(mcast_bytes=0, pkts=0)

    def add_enb(self, sink):
        self.enb_sinks.append(sink)

    def handle_sgi_mb_pdu(self, ip_pkt: bytes):
        """Multicast one downlink packet to every attached eNB (M1-U)."""
        frame = spgw_mod.gtpu_encap(M1U_TEID, ip_pkt)
        for sink in self.enb_sinks:
            sink(self.area_id, frame)
        self.metrics["mcast_bytes"] += len(ip_pkt)
        self.metrics["pkts"] += 1


def enb_pmch_sink(queue):
    """eNB-side M1-U receiver: decap and queue for PMCH scheduling."""

    def sink(area_id, gtpu_frame):
        teid, payload = spgw_mod.gtpu_decap(gtpu_frame)
        if teid == M1U_TEID:
            queue.append((area_id, payload))

    return sink


# ---------------- M2AP session control (liblte_m2ap.cc role) ----------------

import dataclasses

from ..stack import codec, per


@codec.register
@per.schema(("mbms_service_id", "int"), ("area_id", "cint", 0, 255),
            ("tmgi", "bytes"), ("gbr_bps", "int"))
@dataclasses.dataclass
class M2SessionStartRequest:
    """M2AP MBMS Session Start Request content (36.443 §8.2)."""
    mbms_service_id: int
    area_id: int = 1
    tmgi: bytes = b"\x00\xf1\x10\x00\x00\x01"
    gbr_bps: int = 1_000_000


@codec.register
@per.schema(("mbms_service_id", "int"), ("ok", "bool"))
@dataclasses.dataclass
class M2SessionStartResponse:
    mbms_service_id: int
    ok: bool = True


def _m2_encode_request(msg: "M2SessionStartRequest") -> bytes:
    """Typed request -> real 36.443 Session Start Request PDU (same IE
    set as the srslte_asn1_m2ap_test.cc capture: MCE-MBMS-M2AP-ID, TMGI,
    MBMS-Service-Area, TNL-Information); the emulation's GBR rides a
    private raw IE (59998) the spec's unknown-IE rule skips."""
    from ..stack.asn1 import m2ap36443 as m2
    from ..stack.asn1.aper import Pdu, ProtocolIE

    ies = [
        ProtocolIE(m2.ID_MCE_MBMS_M2AP_ID, "reject",
                   msg.mbms_service_id & 0xFFFFFF),
        ProtocolIE(m2.ID_TMGI, "reject",
                   dict(plmn=bytes(msg.tmgi[:3]),
                        service_id=bytes(msg.tmgi[3:6]))),
        ProtocolIE(m2.ID_MBMS_SERVICE_AREA, "reject",
                   int(msg.area_id).to_bytes(2, "big")),
        ProtocolIE(m2.ID_TNL_INFORMATION, "reject",
                   dict(ipmc=bytes([239, 255, 0, msg.area_id & 0xFF]),
                        ipsource=bytes([127, 0, 0, 1]),
                        gtp_teid=msg.mbms_service_id.to_bytes(4, "big"))),
        ProtocolIE(59998, "ignore", int(msg.gbr_bps).to_bytes(4, "big")),
    ]
    return m2.encode_pdu(Pdu("initiatingMessage", m2.PROC_SESSION_START,
                             "reject", ies))


def _m2_decode_request(data: bytes) -> "M2SessionStartRequest":
    from ..stack.asn1 import m2ap36443 as m2

    ies = {ie.id: ie.value for ie in m2.decode_pdu(data).ies}
    tmgi = ies[m2.ID_TMGI]
    gbr = int.from_bytes(ies.get(59998, b"\x00\x0fB@"), "big")
    return M2SessionStartRequest(
        mbms_service_id=ies[m2.ID_MCE_MBMS_M2AP_ID],
        area_id=int.from_bytes(ies[m2.ID_MBMS_SERVICE_AREA], "big"),
        tmgi=bytes(tmgi["plmn"]) + bytes(tmgi["service_id"]),
        gbr_bps=gbr)


def _m2_encode_response(msg: "M2SessionStartResponse") -> bytes:
    from ..stack.asn1 import m2ap36443 as m2
    from ..stack.asn1.aper import Pdu, ProtocolIE

    pdu_type = "successfulOutcome" if msg.ok else "unsuccessfulOutcome"
    ies = [ProtocolIE(m2.ID_MCE_MBMS_M2AP_ID, "ignore",
                      msg.mbms_service_id & 0xFFFFFF),
           ProtocolIE(m2.ID_ENB_MBMS_M2AP_ID, "ignore", 0)]
    return m2.encode_pdu(Pdu(pdu_type, m2.PROC_SESSION_START, "reject",
                             ies))


def _m2_decode_response(data: bytes) -> "M2SessionStartResponse":
    from ..stack.asn1 import m2ap36443 as m2

    pdu = m2.decode_pdu(data)
    ies = {ie.id: ie.value for ie in pdu.ies}
    return M2SessionStartResponse(
        mbms_service_id=ies[m2.ID_MCE_MBMS_M2AP_ID],
        ok=pdu.pdu_type == "successfulOutcome")


def _session_start(self, service_id: int, tmgi: bytes = b"\x00\xf1\x10\x00\x00\x01"):
    """Announce an MBMS session over M2 to every attached eNB; data flows
    only after all eNBs acknowledge (mbms-gw/m2ap session setup).  The
    request/response cross the control channel as real 36.443 APER PDUs."""
    req = _m2_encode_request(M2SessionStartRequest(
        mbms_service_id=service_id, area_id=self.area_id, tmgi=tmgi))
    acks = []
    for ctl in getattr(self, "m2_endpoints", []):
        resp = _m2_decode_response(ctl(req))
        acks.append(resp.ok)
    self.sessions = getattr(self, "sessions", set())
    if all(acks):
        self.sessions.add(service_id)
    return all(acks)


def _add_enb_m2(self, control_endpoint):
    """control_endpoint(req_bytes) -> resp_bytes (the M2 control channel)."""
    self.m2_endpoints = getattr(self, "m2_endpoints", [])
    self.m2_endpoints.append(control_endpoint)


MbmsGw.session_start = _session_start
MbmsGw.add_enb_m2 = _add_enb_m2


def enb_m2_endpoint(state: dict):
    """eNB-side M2 control endpoint: records announced sessions."""

    def endpoint(req_bytes: bytes) -> bytes:
        req = _m2_decode_request(req_bytes)
        state.setdefault("sessions", {})[req.mbms_service_id] = req
        return _m2_encode_response(M2SessionStartResponse(
            mbms_service_id=req.mbms_service_id, ok=True))

    return endpoint
