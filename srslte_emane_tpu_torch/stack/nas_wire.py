"""True 24.301 bytes on the live NAS wire.

Reference behavior: the UE and MME exchange NAS PDUs encoded by
`lib/src/asn1/liblte_mme.cc` (`srsue/src/stack/upper/nas.cc`,
`srsepc/src/mme/nas.cc`) — every PDU crossing RRC DedicatedInfoNAS and
S1AP NAS-transport IEs is a spec-layout EMM/ESM message.  This module
gives the emulation the same property: it bridges the typed
`stack/nas_msgs.py` dataclasses the stacks act on to real 24.301 wire
messages through the capture-proven `stack/asn1/nas24301.py` codec
(byte-exact against liblte_mme-packed golden vectors).

encode(dataclass) -> spec bytes; decode(bytes) -> dataclass.  Every NAS
message the live stacks exchange has a mapping; an unmapped dataclass is
a bug and raises.

One documented liberty: the plain Service Request's 4-byte format
(24.301 §9.3.1) has no identity field — a real network resolves the UE
from the RRC/S1AP S-TMSI and validates the short MAC.  This emulation's
MME looks the UE up by GUTI, so until NAS integrity counts supply a real
short MAC the (seq, short MAC) bits carry the M-TMSI lookup token
(21 bits; GUTIs here are small MME-assigned integers).
"""

from __future__ import annotations

from . import nas_msgs, security, snow3g, zuc
from .asn1 import nas24301 as w

_EIA_FUNCS = {1: snow3g.eia1, 2: security.eia2, 3: zuc.eia3}
_EEA_FUNCS = {1: snow3g.eea1, 2: security.eea2, 3: zuc.eea3}


class NasSecurity:
    """NAS security (24.301 §4.4): the security-protected NAS header
    (sec-hdr | MAC | seq | message) with the EIA MAC computed over
    seq||message under the KASME-derived K_NAS_int, and EEA ciphering of
    the inner message under K_NAS_enc — matching srsue
    `nas.cc integrity_generate/integrity_check/cipher_*` and srsepc
    `nas.cc`.  One instance per EPS security context; separate
    per-direction NAS COUNTs.  Header types: 1 integrity only,
    2 integrity+ciphered, 3 integrity w/ new context (the SMC itself),
    4 integrity+ciphered w/ new context (the SMC complete)."""

    def __init__(self, kasme: bytes, eia: int = 2, eea: int = 0):
        self.eia = eia
        self.eea = eea
        self.k_int = security.kdf_nas_key(kasme, eia, is_enc=False)
        self.k_enc = security.kdf_nas_key(kasme, eea, is_enc=True)
        self.count = [0, 0]  # [uplink, downlink]

    def _mac(self, count: int, direction: int, seq: int,
             body: bytes) -> bytes:
        if self.eia == 0:
            return b"\x00" * 4
        return _EIA_FUNCS[self.eia](self.k_int, count, 0, direction,
                                    bytes([seq]) + body)[:4]

    def _cipher(self, count: int, direction: int, data: bytes) -> bytes:
        if self.eea == 0:
            return data
        return _EEA_FUNCS[self.eea](self.k_enc, count, 0, direction, data)

    def protect(self, plain: bytes, downlink: bool, new_ctx: bool = False,
                cipher: bool = True) -> bytes:
        d = 1 if downlink else 0
        count = self.count[d]
        seq = count & 0xFF
        ciphered = self.eea != 0 and cipher
        body = self._cipher(count, d, plain) if ciphered else plain
        # MAC over SQN || (ciphered) message (24.301 §4.4.3.3)
        mac = self._mac(count, d, seq, body)
        if new_ctx:
            hdr_type = 4 if ciphered else 3
        else:
            hdr_type = 2 if ciphered else 1
        self.count[d] = count + 1
        return bytes([(hdr_type << 4) | w.PD_EMM]) + mac \
            + bytes([seq]) + body

    def service_request(self, ksi: int = 0) -> bytes:
        """Real 24.301 §9.3.1 Service Request: KSI+SQN octet, then the
        short MAC = bytes [2:4] of the EIA MAC over the first two octets
        (srsue nas.cc gen_service_request)."""
        count = self.count[0]
        head = bytes([(w.SEC_SERVICE_REQUEST << 4) | w.PD_EMM,
                      ((ksi & 0x07) << 5) | (count & 0x1F)])
        if self.eia == 0:
            mac = b"\x00" * 4
        else:
            mac = _EIA_FUNCS[self.eia](self.k_int, count, 0, 0, head)
        self.count[0] = count + 1
        return head + mac[2:4]

    def verify_service_request(self, data: bytes) -> bool:
        data = bytes(data)
        if len(data) != 4 or data[0] != (w.SEC_SERVICE_REQUEST << 4 | w.PD_EMM):
            return False
        seq = data[1] & 0x1F
        count = (self.count[0] & ~0x1F) | seq
        if count < self.count[0]:
            count += 0x20
        if self.eia == 0:
            ok = True
        else:
            mac = _EIA_FUNCS[self.eia](self.k_int, count, 0, 0, data[:2])
            ok = mac[2:4] == data[2:4]
        if ok:
            self.count[0] = count + 1
        return ok

    def unprotect(self, data: bytes, downlink: bool):
        """-> (plain bytes, mac_ok).  Once this security context exists,
        a PLAIN EMM message is a downgrade and fails verification
        (24.301 §4.4.4.2: after activation the receiver discards
        unprotected NAS) — callers without a context never reach here;
        a bad MAC returns the body undeciphered with mac_ok=False
        (`nas.cc integrity_check` behavior); a good MAC deciphers
        headers 2/4."""
        data = bytes(data)
        first = data[0]
        hdr_type = first >> 4
        if (first & 0x0F) != w.PD_EMM:
            # a bare ESM header (ebi nibble) or garbage: with a live
            # context every legitimate peer wraps ESM inside the EMM
            # security header, so plain ESM is a downgrade too
            return data, False
        if hdr_type == w.SEC_SERVICE_REQUEST:
            return data, True  # own format; verify_service_request covers
        if hdr_type == w.SEC_PLAIN:
            return data, False
        mac, seq, body = data[1:5], data[5], data[6:]
        d = 1 if downlink else 0
        # resync the low COUNT byte from the received SQN (24.301 §4.4.3.3)
        count = (self.count[d] & ~0xFF) | seq
        if count < self.count[d]:
            count += 0x100
        ok = self._mac(count, d, seq, body) == mac
        if not ok:
            return body, False
        self.count[d] = count + 1
        if hdr_type in (2, 4):
            body = self._cipher(count, d, body)
        return body, True


def strip_security(data: bytes) -> bytes:
    """Drop a security-protected header without verifying.  Only valid
    for integrity-only headers (1/3) — a ciphered body (headers 2/4)
    cannot be read without the context, so that raises."""
    data = bytes(data)
    first = data[0]
    hdr_type = first >> 4
    if (first & 0x0F) == w.PD_EMM and hdr_type not in (
            w.SEC_PLAIN, w.SEC_SERVICE_REQUEST):
        if hdr_type in (2, 4):
            raise w.NasDecodeError(
                "ciphered NAS: unprotect with the security context first")
        return data[6:]
    return data

PLMN = bytes.fromhex("00f110")  # mcc 001 / mnc 01, the netsim-wide PLMN
TAC = 1
APN = "tpu.lte"

_PDN_TYPES = ("ipv4", "ipv6", "ipv4v6")  # 24.301 §9.9.4.10: codes 1/2/3


# ---- IE builders (inverses of nas24301's parse_* helpers) -----------------

def _imsi_identity(imsi: str) -> bytes:
    """EPS mobile identity, IMSI flavor (24.008 §10.5.1.4 BCD)."""
    d = [int(c) for c in imsi]
    odd = len(d) % 2
    out = bytearray([(d[0] << 4) | (odd << 3) | 0x01])
    rest = d[1:]
    for i in range(0, len(rest), 2):
        lo = rest[i]
        hi = rest[i + 1] if i + 1 < len(rest) else 0xF
        out.append((hi << 4) | lo)
    return bytes(out)


def _parse_imsi_identity(b: bytes) -> str:
    assert b[0] & 0x07 == 0x01, "not an IMSI mobile identity"
    digits = [b[0] >> 4]
    for byte in b[1:]:
        digits.append(byte & 0x0F)
        if byte >> 4 != 0xF:
            digits.append(byte >> 4)
    return "".join(str(x) for x in digits)


def _guti_identity(m_tmsi: int, group: int = 1, code: int = 1) -> bytes:
    """EPS mobile identity, GUTI flavor (24.301 §9.9.3.12; inverse of
    nas24301.parse_guti)."""
    return (bytes([0xF6]) + PLMN + group.to_bytes(2, "big")
            + bytes([code]) + int(m_tmsi).to_bytes(4, "big"))


def _tai_list() -> bytes:
    """TAI list, one entry, list type 01 = one PLMN with non-consecutive
    TACs (24.301 §9.9.3.33) — the type srsepc's liblte_mme packs and the
    only one its unpack supports."""
    return bytes([0x20]) + PLMN + TAC.to_bytes(2, "big")


def _tai() -> bytes:
    return PLMN + TAC.to_bytes(2, "big")


def _apn_bytes(apn: str = APN) -> bytes:
    out = bytearray()
    for label in apn.split("."):
        out.append(len(label))
        out += label.encode()
    return bytes(out)


def _pdn_address(ip: str, pdn_type: str = "ipv4",
                 ip6_iid: bytes = b"") -> bytes:
    """24.301 §9.9.4.9 PDN address: ipv4 = 4 octets; ipv6 = 8-octet
    interface identifier; ipv4v6 = IID then IPv4."""
    v4 = bytes(int(x) for x in ip.split(".")) if ip else b""
    if pdn_type == "ipv6":
        return bytes([0x02]) + bytes(ip6_iid[:8])
    if pdn_type == "ipv4v6":
        return bytes([0x03]) + bytes(ip6_iid[:8]) + v4
    return bytes([0x01]) + v4


def _gprs_timer(seconds: int) -> bytes:
    """GPRS timer octet (24.008 §10.5.7.3): 3-bit unit + 5-bit value.
    Lossy to the spec granularity (2 s / 1 min / decihour)."""
    if seconds <= 0:
        return bytes([0xE0])  # deactivated
    if seconds <= 62:
        return bytes([max(1, round(seconds / 2))])
    if seconds <= 31 * 60:
        return bytes([0x20 | min(31, round(seconds / 60))])
    return bytes([0x40 | min(31, round(seconds / 360))])


def _parse_gprs_timer(b: bytes) -> int:
    unit, val = b[0] >> 5, b[0] & 0x1F
    return {0: 2, 1: 60, 2: 360}.get(unit, 0) * val


def _bcd_number(digits: str) -> bytes:
    out = bytearray([0x81])  # type: unknown, plan: ISDN
    d = [int(c) for c in digits if c.isdigit()]
    for i in range(0, len(d), 2):
        lo = d[i]
        hi = d[i + 1] if i + 1 < len(d) else 0xF
        out.append((hi << 4) | lo)
    return bytes(out)


def _parse_bcd_number(b: bytes) -> str:
    digits = []
    for byte in b[1:]:
        digits.append(byte & 0x0F)
        if byte >> 4 != 0xF:
            digits.append(byte >> 4)
    return "".join(str(x) for x in digits)


_UE_CAPS = bytes([0xE0, 0xE0])  # EEA0-2 / EIA1-2 supported


def _gsm7_pack(text: str) -> bytes:
    """GSM 7-bit default-alphabet septet packing (23.038; ASCII subset —
    letters/digits/space share code points)."""
    acc = shift = 0
    out = bytearray()
    for ch in text:
        sept = ord(ch) & 0x7F
        acc |= sept << shift
        shift += 7
        while shift >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            shift -= 8
    if shift:
        out.append(acc & 0xFF)
    return bytes(out)


def _gsm7_unpack(data: bytes, n_spare: int) -> str:
    bits = 8 * len(data) - n_spare
    acc = int.from_bytes(data, "little")
    out = []
    for i in range(bits // 7):
        out.append(chr((acc >> (7 * i)) & 0x7F))
    return "".join(out)


def _network_name(text: str) -> bytes:
    """NetworkName IE value (24.008 §10.5.3.5a): ext=1, coding scheme 0
    (GSM 7-bit), add-CI 0, 3-bit spare-bit count, then the septets."""
    packed = _gsm7_pack(text)
    n_spare = (8 * len(packed) - 7 * len(text)) % 8
    return bytes([0x80 | (n_spare & 0x07)]) + packed


def _parse_network_name(b: bytes) -> str:
    return _gsm7_unpack(b[1:], b[0] & 0x07)


def _esm(ebi: int, pti: int, msg_type: int, **fields) -> dict:
    return dict(protocol_discriminator=w.PD_ESM, eps_bearer_id=ebi,
                pti=pti, msg_type=msg_type, **fields)


def _emm(msg_type: int, **fields) -> dict:
    return dict(protocol_discriminator=w.PD_EMM, msg_type=msg_type,
                **fields)


# ---- per-message bridges ---------------------------------------------------

def _enc_attach_request(m: nas_msgs.AttachRequest) -> dict:
    esm = b""
    if m.esm_pdn_connectivity:
        esm = w.encode(_esm(0, 1, w.PDN_CONNECTIVITY_REQUEST,
                            pdn_request_type=(
                                _PDN_TYPES.index(m.pdn_type) + 1, 1)))
    if m.guti is not None and not m.imsi:
        ident = _guti_identity(m.guti)  # GUTI attach (§5.5.1.2.2)
    else:
        ident = _imsi_identity(m.imsi)
    return _emm(w.ATTACH_REQUEST, ksi_attach_type=(0, 1),
                eps_mobile_identity=ident,
                ue_network_capability=_UE_CAPS, esm_container=esm)


def _dec_attach_request(d: dict) -> nas_msgs.AttachRequest:
    esm = d.get("esm")
    pdn = "ipv4"
    if esm is not None:
        pdn = _PDN_TYPES[esm["pdn_request_type"][0] - 1]
    ident = d["eps_mobile_identity"]
    if ident[0] & 0x07 == 0x06:  # GUTI flavor
        imsi, guti = "", w.parse_guti(ident)["m_tmsi"]
    else:
        imsi, guti = _parse_imsi_identity(ident), None
    return nas_msgs.AttachRequest(
        imsi=imsi, pdn_type=pdn,
        esm_pdn_connectivity=bool(d["esm_container"]), guti=guti)


def _enc_attach_accept(m: nas_msgs.AttachAccept) -> dict:
    esm = w.encode(_esm(m.eps_bearer_id, 1, w.ACT_DEFAULT_BEARER_REQ,
                        eps_qos=bytes([9]), apn=_apn_bytes(),
                        pdn_address=_pdn_address(m.ip_addr, m.pdn_type,
                                                 m.ip6_iid)))
    return _emm(w.ATTACH_ACCEPT, attach_result=(0, 1),
                t3412=_gprs_timer(500), tai_list=_tai_list(),
                esm_container=esm, guti=_guti_identity(m.guti))


def _dec_attach_accept(d: dict) -> nas_msgs.AttachAccept:
    esm = d["esm"]
    addr = w.parse_pdn_address(esm["pdn_address"])
    return nas_msgs.AttachAccept(
        ip_addr=addr.get("ipv4", ""),
        guti=w.parse_guti(d["guti"])["m_tmsi"],
        eps_bearer_id=esm["eps_bearer_id"], pdn_type=addr["type"],
        ip6_iid=addr.get("ip6_iid", b""))


_CAUSE_NAMES = {20: "mac-failure", 21: "synch-failure"}
_CAUSE_CODES = {v: k for k, v in _CAUSE_NAMES.items()}


_SERVICE_TYPES = ("mo-csfb", "mt-csfb", "mo-csfb-emergency")


def encode(msg) -> bytes:
    """Typed NAS dataclass -> real 24.301 wire bytes."""
    t = type(msg)
    if t is nas_msgs.AttachRequest:
        return w.encode(_enc_attach_request(msg))
    if t is nas_msgs.AttachAccept:
        return w.encode(_enc_attach_accept(msg))
    if t is nas_msgs.AttachComplete:
        esm = w.encode(_esm(5, 1, w.ACT_DEFAULT_BEARER_ACCEPT))
        return w.encode(_emm(w.ATTACH_COMPLETE, esm_container=esm))
    if t is nas_msgs.AuthenticationRequest:
        return w.encode(_emm(w.AUTHENTICATION_REQUEST, ksi=(0, 0),
                             rand=bytes(msg.rand), autn=bytes(msg.autn)))
    if t is nas_msgs.AuthenticationResponse:
        return w.encode(_emm(w.AUTHENTICATION_RESPONSE, res=bytes(msg.res)))
    if t is nas_msgs.AuthenticationFailure:
        return w.encode(_emm(
            w.AUTHENTICATION_FAILURE,
            emm_cause=bytes([_CAUSE_CODES[msg.cause]]),
            auts=bytes(msg.auts) if msg.auts else None))
    if t is nas_msgs.AuthenticationReject:
        return w.encode(_emm(w.AUTHENTICATION_REJECT))
    if t is nas_msgs.AttachReject:
        return w.encode(_emm(w.ATTACH_REJECT,
                             emm_cause=bytes([msg.cause])))
    if t is nas_msgs.DetachAccept:
        return w.encode(_emm(w.DETACH_ACCEPT))
    if t is nas_msgs.NasSecurityModeCommand:
        return w.encode(_emm(
            w.SECURITY_MODE_COMMAND,
            selected_nas_algs=bytes([(msg.eea << 4) | msg.eia]),
            ksi=(0, 0), replayed_ue_capabilities=_UE_CAPS))
    if t is nas_msgs.NasSecurityModeComplete:
        return w.encode(_emm(w.SECURITY_MODE_COMPLETE))
    if t is nas_msgs.IdentityRequest:
        return w.encode(_emm(
            w.IDENTITY_REQUEST,
            identity_type=(0, 1 if msg.identity_type == "imsi" else 2)))
    if t is nas_msgs.IdentityResponse:
        return w.encode(_emm(w.IDENTITY_RESPONSE,
                             mobile_identity=_imsi_identity(msg.imsi)))
    if t is nas_msgs.EmmInformation:
        return w.encode(_emm(
            w.EMM_INFORMATION,
            full_network_name=_network_name(msg.full_name),
            short_network_name=_network_name(msg.short_name)))
    if t is nas_msgs.DetachRequest:
        dt = (0x08 if msg.switch_off else 0) | 0x01  # EPS detach
        return w.encode(_emm(w.DETACH_REQUEST, ksi_detach_type=(0, dt),
                             eps_mobile_identity=_guti_identity(0)))
    if t is nas_msgs.ServiceRequest:
        # 4-byte format; see module docstring for the lookup-token note
        return w.encode(dict(msg_name="service_request", ksi=0,
                             seq=(msg.guti >> 16) & 0x1F,
                             short_mac=(msg.guti & 0xFFFF).to_bytes(2, "big")))
    if t is nas_msgs.ExtendedServiceRequest:
        return w.encode(_emm(
            w.EXTENDED_SERVICE_REQUEST,
            ksi_service_type=(0, _SERVICE_TYPES.index(msg.service_type)),
            m_tmsi=int(msg.guti).to_bytes(4, "big")))
    if t is nas_msgs.CsServiceNotification:
        return w.encode(_emm(
            w.CS_SERVICE_NOTIFICATION, paging_identity=b"\x01",
            cli=_bcd_number(msg.caller_id) if msg.caller_id else None))
    if t is nas_msgs.ServiceAccept:
        return w.encode(_emm(w.SERVICE_ACCEPT))
    if t is nas_msgs.ServiceReject:
        return w.encode(_emm(w.SERVICE_REJECT,
                             emm_cause=bytes([msg.cause])))
    if t is nas_msgs.TrackingAreaUpdateRequest:
        return w.encode(_emm(
            w.TAU_REQUEST, ksi_update_type=(0, 0),
            old_guti=_guti_identity(msg.guti),
            last_visited_tai=PLMN + int(msg.tac).to_bytes(2, "big")))
    if t is nas_msgs.TrackingAreaUpdateAccept:
        return w.encode(_emm(w.TAU_ACCEPT, update_result=(0, 0),
                             t3412=_gprs_timer(msg.t3412)))
    if t is nas_msgs.ActivateDedicatedEpsBearerRequest:
        return w.encode(_esm(
            msg.eps_bearer_id, 0, w.ACT_DEDICATED_BEARER_REQ,
            # 24.007 half-octet order: the first V IE (linked EBI)
            # occupies bits 1-4, the spare half octet bits 5-8
            linked_ebi=(0, msg.linked_bearer_id),
            eps_qos=bytes([msg.qci]), tft=bytes(msg.tft)))
    if t is nas_msgs.ActivateDedicatedEpsBearerAccept:
        return w.encode(_esm(msg.eps_bearer_id, 0,
                             w.ACT_DEDICATED_BEARER_ACCEPT))
    raise TypeError(f"no 24.301 wire mapping for {t.__name__}")


def decode(data: bytes):
    """Real 24.301 wire bytes -> typed NAS dataclass.  A security-
    protected wrapper is stripped transparently (integrity verification
    is the caller's job via NasSecurity.unprotect; ciphering is EEA0)."""
    d = w.decode(strip_security(data))
    name = d["msg_name"]
    if name == "service_request":
        return nas_msgs.ServiceRequest(
            guti=(d["seq"] << 16)
            | int.from_bytes(d["short_mac"], "big"))
    if d["protocol_discriminator"] == w.PD_ESM:
        if name == "activate_dedicated_eps_bearer_context_request":
            return nas_msgs.ActivateDedicatedEpsBearerRequest(
                eps_bearer_id=d["eps_bearer_id"],
                linked_bearer_id=d["linked_ebi"][1],
                qci=d["eps_qos"][0], tft=d["tft"])
        if name == "activate_dedicated_eps_bearer_context_accept":
            return nas_msgs.ActivateDedicatedEpsBearerAccept(
                eps_bearer_id=d["eps_bearer_id"])
        raise TypeError(f"no dataclass mapping for ESM {name}")
    mt = d["msg_type"]
    if mt == w.ATTACH_REQUEST:
        return _dec_attach_request(d)
    if mt == w.ATTACH_ACCEPT:
        return _dec_attach_accept(d)
    if mt == w.ATTACH_COMPLETE:
        return nas_msgs.AttachComplete()
    if mt == w.AUTHENTICATION_REQUEST:
        return nas_msgs.AuthenticationRequest(rand=d["rand"],
                                              autn=d["autn"])
    if mt == w.AUTHENTICATION_RESPONSE:
        return nas_msgs.AuthenticationResponse(res=d["res"])
    if mt == w.AUTHENTICATION_FAILURE:
        return nas_msgs.AuthenticationFailure(
            cause=_CAUSE_NAMES[d["emm_cause"][0]],
            auts=d.get("auts", b""))
    if mt == w.AUTHENTICATION_REJECT:
        return nas_msgs.AuthenticationReject()
    if mt == w.ATTACH_REJECT:
        return nas_msgs.AttachReject(cause=d["emm_cause"][0])
    if mt == w.DETACH_ACCEPT:
        return nas_msgs.DetachAccept()
    if mt == w.SECURITY_MODE_COMMAND:
        algs = d["selected_nas_algs"][0]
        return nas_msgs.NasSecurityModeCommand(eea=algs >> 4,
                                               eia=algs & 0x0F)
    if mt == w.SECURITY_MODE_COMPLETE:
        return nas_msgs.NasSecurityModeComplete()
    if mt == w.IDENTITY_REQUEST:
        return nas_msgs.IdentityRequest(
            identity_type="imsi" if d["identity_type"][1] == 1 else "imei")
    if mt == w.IDENTITY_RESPONSE:
        return nas_msgs.IdentityResponse(
            imsi=_parse_imsi_identity(d["mobile_identity"]))
    if mt == w.EMM_INFORMATION:
        return nas_msgs.EmmInformation(
            full_name=_parse_network_name(d["full_network_name"])
            if "full_network_name" in d else "",
            short_name=_parse_network_name(d["short_network_name"])
            if "short_network_name" in d else "")
    if mt == w.DETACH_REQUEST:
        return nas_msgs.DetachRequest(
            switch_off=bool(d["ksi_detach_type"][1] & 0x08))
    if mt == w.EXTENDED_SERVICE_REQUEST:
        return nas_msgs.ExtendedServiceRequest(
            guti=int.from_bytes(d["m_tmsi"], "big"),
            service_type=_SERVICE_TYPES[d["ksi_service_type"][1]])
    if mt == w.CS_SERVICE_NOTIFICATION:
        return nas_msgs.CsServiceNotification(
            caller_id=_parse_bcd_number(d["cli"]) if "cli" in d else "")
    if mt == w.SERVICE_ACCEPT:
        return nas_msgs.ServiceAccept()
    if mt == w.SERVICE_REJECT:
        return nas_msgs.ServiceReject(cause=d["emm_cause"][0])
    if mt == w.TAU_REQUEST:
        return nas_msgs.TrackingAreaUpdateRequest(
            guti=w.parse_guti(d["old_guti"])["m_tmsi"],
            tac=int.from_bytes(d["last_visited_tai"][3:5], "big"))
    if mt == w.TAU_ACCEPT:
        return nas_msgs.TrackingAreaUpdateAccept(
            t3412=_parse_gprs_timer(d["t3412"]))
    raise TypeError(f"no dataclass mapping for EMM {name}")
