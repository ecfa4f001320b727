"""PDCP layer (36.323): SN handling, ciphering, integrity (SRB/DRB entities).

Reference behavior: `lib/src/upper/{pdcp.cc,pdcp_entity_lte.cc,
pdcp_entity_base.cc}` — SRBs: 5-bit SN + MAC-I; DRBs: 12-bit SN;
COUNT = HFN || SN; EEA/EIA via the security lib.
"""

from __future__ import annotations

import struct

from . import security


class PdcpEntity:
    def __init__(self, deliver, is_srb: bool, bearer_id: int = 1,
                 ciph_algo: int = security.EEA0, int_algo: int = security.EIA0,
                 k_enc: bytes = b"\x00" * 16, k_int: bytes = b"\x00" * 16,
                 is_ue: bool = True):
        self.deliver = deliver
        self.is_srb = is_srb
        self.bearer = bearer_id - 1  # BEARER field = bearer identity - 1
        self.sn_bits = 5 if is_srb else 12
        self.sn_mod = 1 << self.sn_bits
        self.tx_count = 0
        self.rx_hfn = 0
        self.rx_next_sn = 0
        self.ciph_algo = ciph_algo
        self.int_algo = int_algo
        self.k_enc = k_enc
        self.k_int = k_int
        # direction: UE uplink tx = 0, downlink = 1 (33.401)
        self.tx_dir = 0 if is_ue else 1
        self.rx_dir = 1 if is_ue else 0
        self.integrity_failures = 0

    def config_security(self, ciph_algo, int_algo, k_enc, k_int):
        self.ciph_algo = ciph_algo
        self.int_algo = int_algo
        self.k_enc = k_enc
        self.k_int = k_int

    # ---- tx: SDU -> PDU ----
    def write_sdu(self, sdu: bytes) -> bytes:
        count = self.tx_count
        sn = count % self.sn_mod
        self.tx_count += 1
        if self.is_srb:
            hdr = bytes([sn & 0x1F])
            mac = security.integrity(self.int_algo, self.k_int, count,
                                     self.bearer, self.tx_dir, hdr + sdu)
            body = security.cipher(self.ciph_algo, self.k_enc, count,
                                   self.bearer, self.tx_dir, sdu + mac)
            return hdr + body
        hdr = struct.pack("!H", 0x8000 | (sn & 0xFFF))  # D/C=1 data
        body = security.cipher(self.ciph_algo, self.k_enc, count,
                               self.bearer, self.tx_dir, sdu)
        return hdr + body

    # ---- rx: PDU -> SDU ----
    def write_pdu(self, pdu: bytes):
        if self.is_srb:
            sn = pdu[0] & 0x1F
            count = self._rx_count(sn)
            body = security.decipher(self.ciph_algo, self.k_enc, count,
                                     self.bearer, self.rx_dir, pdu[1:])
            sdu, mac = body[:-4], body[-4:]
            exp = security.integrity(self.int_algo, self.k_int, count,
                                     self.bearer, self.rx_dir, pdu[:1] + sdu)
            if exp != mac:
                self.integrity_failures += 1
                return
            self.deliver(sdu)
        else:
            sn = struct.unpack("!H", pdu[:2])[0] & 0xFFF
            count = self._rx_count(sn)
            sdu = security.decipher(self.ciph_algo, self.k_enc, count,
                                    self.bearer, self.rx_dir, pdu[2:])
            self.deliver(sdu)

    def _rx_count(self, sn: int) -> int:
        # HFN handling with wraparound detection
        if sn < self.rx_next_sn - self.sn_mod // 2:
            self.rx_hfn += 1
        self.rx_next_sn = sn + 1
        return self.rx_hfn * self.sn_mod + sn


class PdcpEntityNr:
    """Early NR PDCP entity (38.323 subset; reference behavior:
    `lib/src/upper/pdcp_entity_nr.cc`): 12- or 18-bit SN, MAC-I appended on
    SRBs and (optionally) DRBs, COUNT = HFN||SN with window-based RCVD_COUNT
    inference (38.323 §5.2.2), out-of-order delivery (no reordering timer,
    matching the reference's early implementation)."""

    def __init__(self, deliver, is_srb: bool, sn_bits: int = 12,
                 bearer_id: int = 1, ciph_algo: int = security.EEA0,
                 int_algo: int = security.EIA0, k_enc: bytes = b"\x00" * 16,
                 k_int: bytes = b"\x00" * 16, is_ue: bool = True,
                 drb_integrity: bool = False):
        assert sn_bits in (12, 18)
        self.deliver = deliver
        self.is_srb = is_srb
        self.sn_bits = 12 if is_srb else sn_bits  # NR SRBs are always 12-bit
        self.sn_mod = 1 << self.sn_bits
        self.window = self.sn_mod // 2
        self.bearer = bearer_id - 1
        self.tx_next = 0
        self.rx_next = 0  # COUNT of next expected PDU
        self.ciph_algo = ciph_algo
        self.int_algo = int_algo
        self.k_enc = k_enc
        self.k_int = k_int
        self.tx_dir = 0 if is_ue else 1
        self.rx_dir = 1 if is_ue else 0
        self.has_integrity = is_srb or drb_integrity
        self.integrity_failures = 0
        self._rcvd = set()  # COUNTs received inside the window (dup discard)

    def _hdr(self, sn: int) -> bytes:
        if self.sn_bits == 12:
            return struct.pack("!H", (0 if self.is_srb else 0x8000) | sn)
        return bytes([(0x80 | (sn >> 16)) & 0xFF, (sn >> 8) & 0xFF, sn & 0xFF])

    def write_sdu(self, sdu: bytes) -> bytes:
        count = self.tx_next
        self.tx_next += 1
        hdr = self._hdr(count % self.sn_mod)
        if self.has_integrity:
            sdu = sdu + security.integrity(self.int_algo, self.k_int, count,
                                           self.bearer, self.tx_dir, hdr + sdu)
        return hdr + security.cipher(self.ciph_algo, self.k_enc, count,
                                     self.bearer, self.tx_dir, sdu)

    def write_pdu(self, pdu: bytes):
        nh = 2 if self.sn_bits == 12 else 3
        if self.sn_bits == 12:
            sn = struct.unpack("!H", pdu[:2])[0] & 0xFFF
        else:
            sn = ((pdu[0] & 0x03) << 16) | (pdu[1] << 8) | pdu[2]
        count = self._rcvd_count(sn)
        if count in self._rcvd or count < self.rx_next - self.window:
            return  # duplicate discard (38.323 §5.2.2.1)
        body = security.decipher(self.ciph_algo, self.k_enc, count,
                                 self.bearer, self.rx_dir, pdu[nh:])
        if self.has_integrity:
            body, mac = body[:-4], body[-4:]
            exp = security.integrity(self.int_algo, self.k_int, count,
                                     self.bearer, self.rx_dir, pdu[:nh] + body)
            if exp != mac:
                self.integrity_failures += 1
                return
        self._rcvd.add(count)
        if count >= self.rx_next:
            self.rx_next = count + 1
            self._rcvd = {c for c in self._rcvd
                          if c >= self.rx_next - self.window}
        self.deliver(body)

    def _rcvd_count(self, sn: int) -> int:
        # 38.323 §5.2.2: pick the HFN putting RCVD_COUNT nearest RX_NEXT
        ref_sn = self.rx_next % self.sn_mod
        hfn = self.rx_next // self.sn_mod
        if sn < ref_sn - self.window:
            hfn += 1
        elif sn >= ref_sn + self.window:
            hfn -= 1
        return max(0, hfn * self.sn_mod + sn)
