"""Traffic Flow Template packet filters (24.008 §10.5.6.12).

Reference behavior: `srsue/src/stack/upper/tft_packet_filter.cc` — dedicated
EPS bearers carry a TFT whose packet-filter components (addresses, ports,
protocol, ToS) classify uplink IP packets onto the right bearer; filters
evaluate in precedence order (lower value = higher priority) and unmatched
traffic rides the default bearer.
"""

from __future__ import annotations

import dataclasses
import struct

# packet-filter component type identifiers (24.008 table 10.5.162)
IPV4_REMOTE_ADDR = 0x10
IPV4_LOCAL_ADDR = 0x11
PROTOCOL_ID = 0x30
SINGLE_LOCAL_PORT = 0x40
LOCAL_PORT_RANGE = 0x41
SINGLE_REMOTE_PORT = 0x50
REMOTE_PORT_RANGE = 0x51
SECURITY_PARAMETER_INDEX = 0x60
TYPE_OF_SERVICE = 0x70

# filter direction (24.008 §10.5.6.12 packet filter direction)
DIR_DOWNLINK = 1
DIR_UPLINK = 2
DIR_BIDIRECTIONAL = 3


def _ip(s: str) -> int:
    a, b, c, d = (int(x) for x in s.split("."))
    return (a << 24) | (b << 16) | (c << 8) | d


@dataclasses.dataclass
class PacketFilter:
    """One packet filter: a list of (component_type, value) constraints,
    ALL of which must match (logical AND within a filter)."""

    filter_id: int
    precedence: int
    direction: int = DIR_BIDIRECTIONAL
    components: tuple = ()

    def match(self, pkt: bytes, uplink: bool = True) -> bool:
        if uplink and not (self.direction & DIR_UPLINK):
            return False
        if not uplink and not (self.direction & DIR_DOWNLINK):
            return False
        if len(pkt) < 20 or pkt[0] >> 4 != 4:
            return False
        ihl = (pkt[0] & 0xF) * 4
        proto = pkt[9]
        src = struct.unpack("!I", pkt[12:16])[0]
        dst = struct.unpack("!I", pkt[16:20])[0]
        tos = pkt[1]
        sport = dport = None
        if proto in (6, 17) and len(pkt) >= ihl + 4:  # TCP/UDP
            sport, dport = struct.unpack("!HH", pkt[ihl : ihl + 4])
        # uplink: local = src, remote = dst; downlink mirrored
        local_addr, remote_addr = (src, dst) if uplink else (dst, src)
        local_port, remote_port = (sport, dport) if uplink else (dport, sport)
        for ctype, val in self.components:
            if ctype == IPV4_REMOTE_ADDR:
                addr, mask = val
                if (remote_addr & mask) != (addr & mask):
                    return False
            elif ctype == IPV4_LOCAL_ADDR:
                addr, mask = val
                if (local_addr & mask) != (addr & mask):
                    return False
            elif ctype == PROTOCOL_ID:
                if proto != val:
                    return False
            elif ctype == SINGLE_LOCAL_PORT:
                if local_port != val:
                    return False
            elif ctype == SINGLE_REMOTE_PORT:
                if remote_port != val:
                    return False
            elif ctype == LOCAL_PORT_RANGE:
                lo, hi = val
                if local_port is None or not lo <= local_port <= hi:
                    return False
            elif ctype == REMOTE_PORT_RANGE:
                lo, hi = val
                if remote_port is None or not lo <= remote_port <= hi:
                    return False
            elif ctype == TYPE_OF_SERVICE:
                t, mask = val
                if (tos & mask) != (t & mask):
                    return False
            else:
                return False  # unsupported component -> no match
        return True

    # ---- 24.008 wire encoding (packet filter content) ----
    def pack(self) -> bytes:
        body = b""
        for ctype, val in self.components:
            if ctype in (IPV4_REMOTE_ADDR, IPV4_LOCAL_ADDR):
                body += bytes([ctype]) + struct.pack("!II", *val)
            elif ctype == PROTOCOL_ID:
                body += bytes([ctype, val])
            elif ctype in (SINGLE_LOCAL_PORT, SINGLE_REMOTE_PORT):
                body += bytes([ctype]) + struct.pack("!H", val)
            elif ctype in (LOCAL_PORT_RANGE, REMOTE_PORT_RANGE):
                body += bytes([ctype]) + struct.pack("!HH", *val)
            elif ctype == TYPE_OF_SERVICE:
                body += bytes([ctype, val[0], val[1]])
            else:
                raise ValueError(ctype)
        hdr = bytes([(self.direction << 4) | self.filter_id, self.precedence,
                     len(body)])
        return hdr + body

    @classmethod
    def unpack(cls, data: bytes) -> tuple:
        b0, precedence, n = data[0], data[1], data[2]
        body, rest = data[3 : 3 + n], data[3 + n :]
        comps = []
        i = 0
        while i < len(body):
            t = body[i]
            if t in (IPV4_REMOTE_ADDR, IPV4_LOCAL_ADDR):
                comps.append((t, struct.unpack("!II", body[i + 1 : i + 9])))
                i += 9
            elif t == PROTOCOL_ID:
                comps.append((t, body[i + 1]))
                i += 2
            elif t in (SINGLE_LOCAL_PORT, SINGLE_REMOTE_PORT):
                comps.append((t, struct.unpack("!H", body[i + 1 : i + 3])[0]))
                i += 3
            elif t in (LOCAL_PORT_RANGE, REMOTE_PORT_RANGE):
                comps.append((t, struct.unpack("!HH", body[i + 1 : i + 5])))
                i += 5
            elif t == TYPE_OF_SERVICE:
                comps.append((t, (body[i + 1], body[i + 2])))
                i += 3
            else:
                raise ValueError(f"component {t:#x}")
        return cls(filter_id=b0 & 0xF, precedence=precedence,
                   direction=(b0 >> 4) & 0x3, components=tuple(comps)), rest


class TftMatcher:
    """Set of (bearer, filter) pairs evaluated in precedence order
    (tft_packet_filter.cc check_tft_filter_match role)."""

    def __init__(self, default_bearer: int):
        self.default_bearer = default_bearer
        self._filters = []  # (precedence, filter, bearer_lcid)

    def add_filter(self, f: PacketFilter, bearer_lcid: int):
        self._filters.append((f.precedence, f, bearer_lcid))
        self._filters.sort(key=lambda x: x[0])

    def remove_bearer(self, bearer_lcid: int):
        self._filters = [x for x in self._filters if x[2] != bearer_lcid]

    def route(self, pkt: bytes, uplink: bool = True) -> int:
        for _, f, lcid in self._filters:
            if f.match(pkt, uplink):
                return lcid
        return self.default_bearer
