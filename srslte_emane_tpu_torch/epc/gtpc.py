"""GTPv2-C codec: byte-exact control messages for session management.

Reference behavior: `srsepc/src/spgw/gtpc.cc` + `srsepc/src/mme/mme_gtpc.cc`
and the `lib/include/srslte/asn1/gtpc*.h` structs — Create Session
Request/Response and Modify Bearer Request over S11, with IMSI (TBCD),
F-TEID, PAA, Cause, EBI and grouped Bearer Context IEs (29.274 subset).

The in-process transport passes these exact bytes between MME and SPGW, so
captures and a later UDP transport are wire-compatible at the subset level.
"""

from __future__ import annotations

import struct

# message types (29.274 §6.1)
CREATE_SESSION_REQUEST = 32
CREATE_SESSION_RESPONSE = 33
MODIFY_BEARER_REQUEST = 34
MODIFY_BEARER_RESPONSE = 35

# IE types
IE_IMSI = 1
IE_CAUSE = 2
IE_PAA = 79
IE_EBI = 73
IE_FTEID = 87
IE_BEARER_CONTEXT = 93
IE_PDN_TYPE = 99

CAUSE_ACCEPTED = 16

# 29.274 §8.14/§8.34 PDN type values
PDN_TYPES = {"ipv4": 1, "ipv6": 2, "ipv4v6": 3}
PDN_NAMES = {v: k for k, v in PDN_TYPES.items()}


def _paa(pdn_type: str, ue_ip: str, ue_ip6: str = None) -> bytes:
    """PDN Address Allocation IE value (29.274 §8.14): v6 carries prefix
    length + 16 bytes; v4v6 = prefix len + v6 + v4."""
    import socket as _s

    v4 = bytes(int(x) for x in ue_ip.split(".")) if ue_ip else b""
    if pdn_type == "ipv4":
        return b"\x01" + v4
    v6 = bytes([64]) + _s.inet_pton(_s.AF_INET6, ue_ip6)
    if pdn_type == "ipv6":
        return b"\x02" + v6
    return b"\x03" + v6 + v4


def parse_paa(val: bytes) -> dict:
    import socket as _s

    typ = PDN_NAMES.get(val[0] & 0x07, "ipv4")
    out = dict(pdn_type=typ)
    if typ == "ipv4":
        out["ue_ip"] = ".".join(str(b) for b in val[1:5])
        return out
    out["ue_ip6"] = _s.inet_ntop(_s.AF_INET6, val[2:18])
    if typ == "ipv4v6":
        out["ue_ip"] = ".".join(str(b) for b in val[18:22])
    return out


def _tbcd(digits: str) -> bytes:
    out = bytearray()
    for i in range(0, len(digits), 2):
        lo = int(digits[i])
        hi = int(digits[i + 1]) if i + 1 < len(digits) else 0xF
        out.append((hi << 4) | lo)
    return bytes(out)


def _tbcd_decode(b: bytes) -> str:
    out = []
    for byte in b:
        out.append(str(byte & 0xF))
        if byte >> 4 != 0xF:
            out.append(str(byte >> 4))
    return "".join(out)


def ie(t: int, data: bytes, instance: int = 0) -> bytes:
    return struct.pack("!BHB", t, len(data), instance & 0xF) + data


def fteid(iface: int, teid: int, ipv4: str) -> bytes:
    ip = bytes(int(x) for x in ipv4.split("."))
    return ie(IE_FTEID, bytes([0x80 | (iface & 0x3F)]) +
              struct.pack("!I", teid) + ip)


def header(msg_type: int, teid: int, seq: int, body: bytes) -> bytes:
    # version 2, TEID flag set
    length = len(body) + 8  # teid(4) + seq(3) + spare(1)
    return struct.pack("!BBH", 0x48, msg_type, length) + \
        struct.pack("!I", teid) + seq.to_bytes(3, "big") + b"\x00" + body


def parse(pkt: bytes):
    flags, msg_type, length = struct.unpack("!BBH", pkt[:4])
    assert flags >> 5 == 2, "not GTPv2"
    teid = struct.unpack("!I", pkt[4:8])[0]
    seq = int.from_bytes(pkt[8:11], "big")
    body = pkt[12 : 4 + length]
    ies = []
    pos = 0
    while pos < len(body):
        t, n, inst = struct.unpack("!BHB", body[pos : pos + 4])
        ies.append((t, inst & 0xF, body[pos + 4 : pos + 4 + n]))
        pos += 4 + n
    return dict(msg_type=msg_type, teid=teid, seq=seq, ies=ies)


def find_ie(ies, t: int, instance: int = 0):
    for it, inst, data in ies:
        if it == t and inst == instance:
            return data
    return None


def create_session_request(imsi: str, mme_fteid_teid: int,
                           mme_ip: str = "127.0.1.1", seq: int = 1,
                           pdn_type: str = "ipv4") -> bytes:
    body = ie(IE_IMSI, _tbcd(imsi))
    body += fteid(10, mme_fteid_teid, mme_ip)  # S11 MME GTP-C
    body += ie(IE_PDN_TYPE, bytes([PDN_TYPES.get(pdn_type, 1)]))
    return header(CREATE_SESSION_REQUEST, 0, seq, body)


def create_session_response(ue_ip: str, spgw_teid: int, enb_rx_teid: int,
                            spgw_ip: str = "127.0.1.2", ebi: int = 5,
                            seq: int = 1, pdn_type: str = "ipv4",
                            ue_ip6: str = None) -> bytes:
    body = ie(IE_CAUSE, bytes([CAUSE_ACCEPTED, 0]))
    body += ie(IE_PAA, _paa(pdn_type, ue_ip, ue_ip6))
    # grouped bearer context: EBI + S1-U SPGW F-TEID (UL) + eNB rx TEID (DL)
    bc = ie(IE_EBI, bytes([ebi]))
    bc += fteid(1, spgw_teid, spgw_ip)  # S1-U SGW
    bc += ie(IE_FTEID, bytes([0x80]) + struct.pack("!I", enb_rx_teid) +
             bytes(4), instance=1)
    body += ie(IE_BEARER_CONTEXT, bc)
    return header(CREATE_SESSION_RESPONSE, 0, seq, body)


def parse_create_session_response(pkt: bytes) -> dict:
    p = parse(pkt)
    assert p["msg_type"] == CREATE_SESSION_RESPONSE
    ies = p["ies"]
    cause = find_ie(ies, IE_CAUSE)[0]
    paa = parse_paa(find_ie(ies, IE_PAA))
    ue_ip = paa.get("ue_ip", "")
    bc = find_ie(ies, IE_BEARER_CONTEXT)
    # parse the grouped IEs
    sub_ies = []
    pos = 0
    while pos < len(bc):
        t, n, inst = struct.unpack("!BHB", bc[pos : pos + 4])
        sub_ies.append((t, inst & 0xF, bc[pos + 4 : pos + 4 + n]))
        pos += 4 + n
    ebi = find_ie(sub_ies, IE_EBI)[0]
    spgw_ft = find_ie(sub_ies, IE_FTEID, 0)
    enb_ft = find_ie(sub_ies, IE_FTEID, 1)
    return dict(cause=cause, ue_ip=ue_ip, eps_bearer_id=ebi,
                teid_in=struct.unpack("!I", spgw_ft[1:5])[0],
                teid_out=struct.unpack("!I", enb_ft[1:5])[0],
                pdn_type=paa["pdn_type"], ue_ip6=paa.get("ue_ip6"))


def parse_create_session_request(pkt: bytes) -> dict:
    p = parse(pkt)
    assert p["msg_type"] == CREATE_SESSION_REQUEST
    imsi = _tbcd_decode(find_ie(p["ies"], IE_IMSI))
    ft = find_ie(p["ies"], IE_FTEID)
    pt = find_ie(p["ies"], IE_PDN_TYPE)
    return dict(imsi=imsi, mme_teid=struct.unpack("!I", ft[1:5])[0],
                seq=p["seq"],
                pdn_type=PDN_NAMES.get(pt[0] & 7, "ipv4") if pt else "ipv4")
