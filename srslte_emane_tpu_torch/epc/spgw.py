"""SPGW: GTP-C session management + GTP-U user-plane tunneling.

Reference behavior: `srsepc/src/spgw/{spgw.cc,gtpc.cc,gtpu.cc}` — select loop
over the S1-U socket and SGi TUN (spgw.cc:114-158), GTP-C create-session
(TEID allocation), GTP-U encap/decap keyed by TEID / UE IP.

Transport here is in-process callable hooks (eNB gtpu <-> spgw) with the
GTP-U v1 header encoded exactly (so PCAPs and later UDP transport are
byte-compatible); SGi is an in-memory IP packet sink/source (TUN optional).
"""

from __future__ import annotations

import socket
import struct

# IPv6 /64 PDN prefix (gw.cc learns it from the router advertisement; the
# emulation collapses that step into a shared constant — the SPGW assigns
# the interface identifier via NAS and both sides compose prefix + IID)
IP6_PREFIX = "fd00:abcd::"


def gtpu_encap(teid: int, payload: bytes) -> bytes:
    """GTP-U v1 G-PDU header (8 bytes): flags=0x30, type=0xFF (gtpu.cc)."""
    return struct.pack("!BBHI", 0x30, 0xFF, len(payload), teid) + payload


def gtpu_decap(pkt: bytes):
    flags, mtype, length, teid = struct.unpack("!BBHI", pkt[:8])
    assert mtype == 0xFF, mtype
    return teid, pkt[8 : 8 + length]


class Spgw:
    def __init__(self, ip_pool_base: str = "172.16.0."):
        self.ip_pool_base = ip_pool_base
        self.next_ip = 2
        self.next_teid = 1
        # bearers: ue_ip -> dict(teid_out (eNB side), enb_tx fn)
        self.by_ip = {}
        self.by_ip6 = {}  # 16-byte packed v6 -> same session dict
        self.by_teid_in = {}
        self.sgi_out = []  # packets leaving toward the internet
        self.metrics = dict(dl_bytes=0, ul_bytes=0)

    # ---- GTP-C (create session, gtpc.cc) ----
    def handle_gtpc(self, pkt: bytes, enb_tx) -> bytes:
        """S11 endpoint: byte-exact GTPv2-C Create Session Request ->
        Response (the in-process S1-U delivery hook rides alongside the
        message, standing in for the F-TEID's transport address)."""
        from . import gtpc

        req = gtpc.parse_create_session_request(pkt)
        sess = self.create_session(req["imsi"], enb_tx,
                                   pdn_type=req.get("pdn_type", "ipv4"))
        return gtpc.create_session_response(
            sess["ue_ip"], sess["teid_in"], sess["teid_out"], seq=req["seq"],
            pdn_type=sess["pdn_type"], ue_ip6=sess.get("ue_ip6"))

    def create_session(self, imsi: str, enb_tx, pdn_type: str = "ipv4"):
        """enb_tx(bytes): callable delivering S1-U packets to the eNB.
        Returns dict(ue_ip, teid_in (SPGW's), teid_out (eNB's), pdn_type
        [, ue_ip6]).  pdn_type ipv4v6/ipv6 also allocates an IPv6 address
        from the IP6_PREFIX /64 pool (spgw.cc paa_type ipv4v6 role)."""
        # /16 pool: the host index spills into the third octet so more
        # than 253 sessions allocate valid addresses (sgw_sgi pool role)
        hi, lo = divmod(self.next_ip, 256)
        base = self.ip_pool_base.rstrip(".").rsplit(".", 1)[0]
        ue_ip = f"{base}.{hi}.{lo}"
        self.next_ip += 1
        if lo == 254:
            self.next_ip += 2  # skip .255 (broadcast) and .0
        teid_in = self.next_teid  # our rx teid (eNB sends UL with this)
        teid_out = self.next_teid + 1  # eNB's rx teid (we send DL with it)
        self.next_teid += 2
        sess = dict(teid_out=teid_out, teid_in=teid_in,
                    enb_tx=enb_tx, imsi=imsi, pdn_type=pdn_type)
        self.by_ip[ue_ip] = sess
        self.by_teid_in[teid_in] = ue_ip
        out = dict(ue_ip=ue_ip, teid_in=teid_in, teid_out=teid_out,
                   pdn_type=pdn_type)
        if pdn_type in ("ipv6", "ipv4v6"):
            # interface identifier derived from the session index; full
            # address = shared /64 prefix + IID
            iid = struct.pack("!Q", 0x100 + self.next_ip)
            ue_ip6 = socket.inet_ntop(
                socket.AF_INET6,
                socket.inet_pton(socket.AF_INET6, IP6_PREFIX)[:8] + iid)
            sess["ue_ip6"] = ue_ip6
            self.by_ip6[socket.inet_pton(socket.AF_INET6, ue_ip6)] = sess
            out["ue_ip6"] = ue_ip6
        return out

    def path_switch(self, ue_ip: str, enb_tx):
        """S1 path switch after handover (gtpc.cc modify-bearer): point the
        DL tunnel at the target eNB; TEIDs are preserved."""
        sess = self.by_ip.get(ue_ip)
        if sess is None:
            return False
        sess["enb_tx"] = enb_tx
        return True

    # ---- user plane (spgw.cc:114-158 select loop bodies) ----
    def release_session(self, ue_ip: str):
        """Delete-session (gtpc role): drop the bearer so DL routing to a
        stale tunnel stops and the address mappings do not leak."""
        sess = self.by_ip.pop(ue_ip, None)
        if sess is not None:
            self.by_teid_in.pop(sess["teid_in"], None)
            if sess.get("ue_ip6"):
                self.by_ip6.pop(
                    socket.inet_pton(socket.AF_INET6, sess["ue_ip6"]), None)

    def handle_sgi_pdu(self, ip_pkt: bytes):
        """Downlink: IP packet from SGi -> lookup by dst IP (v4 or v6) ->
        GTP-U to eNB (the dual-stack routing of spgw.cc's SGi loop)."""
        version = ip_pkt[0] >> 4
        if version == 6:
            sess = self.by_ip6.get(bytes(ip_pkt[24:40]))
        else:
            sess = self.by_ip.get(".".join(str(b) for b in ip_pkt[16:20]))
        if sess is None:
            return False
        sess["enb_tx"](gtpu_encap(sess["teid_out"], ip_pkt))
        self.metrics["dl_bytes"] += len(ip_pkt)
        return True

    def handle_s1u_pdu(self, pkt: bytes):
        """Uplink: GTP-U from eNB -> decap -> SGi."""
        teid, ip_pkt = gtpu_decap(pkt)
        if teid not in self.by_teid_in:
            return False
        self.sgi_out.append(ip_pkt)
        self.metrics["ul_bytes"] += len(ip_pkt)
        return True


def make_ipv4(src: str, dst: str, payload: bytes) -> bytes:
    """Minimal IPv4 header for tests/gw loopback."""
    src_b = bytes(int(x) for x in src.split("."))
    dst_b = bytes(int(x) for x in dst.split("."))
    total = 20 + len(payload)
    hdr = struct.pack("!BBHHHBBH", 0x45, 0, total, 0, 0, 64, 17, 0) + src_b + dst_b
    return hdr + payload


def make_ipv6(src: str, dst: str, payload: bytes,
              next_header: int = 17) -> bytes:
    """Minimal IPv6 header (RFC 8200) for tests/gw loopback."""
    hdr = struct.pack("!IHBB", 0x6000_0000, len(payload), next_header, 64)
    hdr += socket.inet_pton(socket.AF_INET6, src)
    hdr += socket.inet_pton(socket.AF_INET6, dst)
    return hdr + payload


def _icmp6_checksum(src_b: bytes, dst_b: bytes, icmp: bytes) -> int:
    """ICMPv6 checksum over the v6 pseudo-header (RFC 8200 §8.1)."""
    pseudo = src_b + dst_b + struct.pack("!IHBB", len(icmp), 0, 0, 58)
    data = pseudo + icmp
    if len(data) % 2:
        data += b"\x00"
    s = sum(struct.unpack(f"!{len(data) // 2}H", data))
    while s >> 16:
        s = (s & 0xFFFF) + (s >> 16)
    return (~s) & 0xFFFF


def make_icmp6_echo(src: str, dst: str, ident: int = 1, seq: int = 1,
                    payload: bytes = b"ping", reply: bool = False) -> bytes:
    """ICMPv6 Echo Request/Reply in a full IPv6 packet (RFC 4443 §4)."""
    src_b = socket.inet_pton(socket.AF_INET6, src)
    dst_b = socket.inet_pton(socket.AF_INET6, dst)
    typ = 129 if reply else 128
    icmp = struct.pack("!BBHHH", typ, 0, 0, ident, seq) + payload
    ck = _icmp6_checksum(src_b, dst_b, icmp)
    icmp = icmp[:2] + struct.pack("!H", ck) + icmp[4:]
    return make_ipv6(src, dst, icmp, next_header=58)


def icmp6_echo_reply(pkt: bytes) -> bytes:
    """Reply to an ICMPv6 Echo Request packet (what the kernel behind the
    UE's TUN does; the in-memory GW test harness calls this)."""
    src = socket.inet_ntop(socket.AF_INET6, pkt[8:24])
    dst = socket.inet_ntop(socket.AF_INET6, pkt[24:40])
    assert pkt[40] == 128, "not an echo request"
    ident, seq = struct.unpack("!HH", pkt[44:48])
    return make_icmp6_echo(dst, src, ident, seq, pkt[48:], reply=True)
