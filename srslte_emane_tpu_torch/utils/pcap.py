"""PCAP writers for per-layer captures (Wireshark-compatible).

Reference behavior: `lib/src/common/{mac_pcap,nas_pcap,rlc_pcap,s1ap_pcap}.cc`
— MAC-LTE frames under DLT 147 with the Wireshark mac-lte context header
(mac_pcap.h:41-49), NAS under DLT 148, RLC-LTE DLT 147-variants.

The MAC-LTE context framing follows Wireshark's packet-mac-lte.h UDP-heuristic
format: radioType, direction, rntiType + tagged fields, PAYLOAD tag, PDU.
"""

from __future__ import annotations

import struct
import time

DLT_USER0 = 147  # MAC-LTE
DLT_USER1 = 148  # NAS-EPS

# mac-lte context constants (packet-mac-lte.h)
FDD_RADIO = 1
DIR_UL, DIR_DL = 0, 1
RNTI_NO, RNTI_P, RNTI_RA, RNTI_C, RNTI_SI, RNTI_SPS = 0, 1, 2, 3, 4, 5
TAG_RNTI, TAG_UEID, TAG_SUBFRAME, TAG_PAYLOAD = 0x02, 0x03, 0x04, 0x01


class PcapWriter:
    def __init__(self, path: str, dlt: int):
        self.f = open(path, "wb")
        # pcap global header
        self.f.write(struct.pack("!IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, dlt))

    def write(self, payload: bytes, ts: float = None):
        ts = time.time() if ts is None else ts
        sec = int(ts)
        usec = int((ts - sec) * 1e6)
        self.f.write(struct.pack("!IIII", sec, usec, len(payload), len(payload)))
        self.f.write(payload)
        self.f.flush()

    def close(self):
        self.f.close()


class MacPcap:
    """MAC-LTE capture (mac_pcap.cc equivalent)."""

    def __init__(self, path: str):
        self.w = PcapWriter(path, DLT_USER0)

    def write_pdu(self, pdu: bytes, rnti: int, tti: int, is_dl: bool,
                  ueid: int = 1, rnti_type: int = RNTI_C):
        ctx = bytes([FDD_RADIO, DIR_DL if is_dl else DIR_UL, rnti_type])
        ctx += bytes([TAG_RNTI]) + struct.pack("!H", rnti)
        ctx += bytes([TAG_UEID]) + struct.pack("!H", ueid)
        ctx += bytes([TAG_SUBFRAME]) + struct.pack("!H", tti % 10)
        ctx += bytes([TAG_PAYLOAD])
        self.w.write(ctx + pdu)

    def close(self):
        self.w.close()


class NasPcap:
    """NAS-EPS capture (nas_pcap.cc equivalent)."""

    def __init__(self, path: str):
        self.w = PcapWriter(path, DLT_USER1)

    def write_pdu(self, pdu: bytes):
        self.w.write(pdu)

    def close(self):
        self.w.close()


DLT_USER2 = 149  # RLC-LTE
DLT_USER3 = 150  # S1AP


class RlcPcap:
    """RLC-LTE capture (rlc_pcap.cc equivalent): the Wireshark rlc-lte
    UDP-framed context header (packet-rlc-lte.h; pcap.h:355-420) ahead of
    each RLC PDU — a dummy UDP header, the "rlc-lte" magic, the rlcMode
    byte, tagged fields, then the PAYLOAD tag.  Dissects directly in
    Wireshark with DLT_USER2 (149) mapped to the udp protocol."""

    # packet-rlc-lte.h mode values (pcap.h RLC_*_MODE)
    MODE_TM, MODE_UM, MODE_AM = 1, 2, 4
    # channel types (pcap.h CHANNEL_TYPE_*)
    CH_CCCH, CH_BCCH_BCH, CH_PCCH, CH_SRB, CH_DRB = 1, 2, 3, 4, 5
    _MAGIC = b"rlc-lte"
    _TAG_SN_LENGTH, _TAG_DIRECTION, _TAG_PRIORITY = 0x02, 0x03, 0x04
    _TAG_UEID, _TAG_CHANNEL_TYPE, _TAG_CHANNEL_ID = 0x05, 0x06, 0x07
    _TAG_PAYLOAD = 0x01

    def __init__(self, path: str):
        self.w = PcapWriter(path, DLT_USER2)

    def write_pdu(self, pdu: bytes, rnti: int, lcid: int, is_dl: bool,
                  mode: int = MODE_AM, sn_bits: int = 10,
                  channel_type: int = None):
        if channel_type is None:
            channel_type = self.CH_SRB if lcid <= 2 else self.CH_DRB
        ctx = self._MAGIC + bytes([mode])
        if mode == self.MODE_UM:
            ctx += bytes([self._TAG_SN_LENGTH, sn_bits])
        ctx += bytes([self._TAG_DIRECTION, DIR_DL if is_dl else DIR_UL])
        ctx += bytes([self._TAG_PRIORITY, 0])
        ctx += bytes([self._TAG_UEID]) + struct.pack("!H", rnti)
        ctx += bytes([self._TAG_CHANNEL_TYPE]) + struct.pack("!H",
                                                             channel_type)
        ctx += bytes([self._TAG_CHANNEL_ID]) + struct.pack("!H", lcid & 0xFF)
        ctx += bytes([self._TAG_PAYLOAD])
        # dummy UDP header ahead of the framing (ports 0xdead/0xbeef)
        udp = struct.pack("!HHHH", 0xDEAD, 0xBEEF,
                          8 + len(ctx) + len(pdu), 0xDEAD)
        self.w.write(udp + ctx + pdu)

    def close(self):
        self.w.close()


class S1apPcap:
    """S1AP capture (s1ap_pcap.cc equivalent): raw control messages."""

    def __init__(self, path: str):
        self.w = PcapWriter(path, DLT_USER3)

    def write_pdu(self, pdu: bytes):
        self.w.write(pdu)

    def close(self):
        self.w.close()
