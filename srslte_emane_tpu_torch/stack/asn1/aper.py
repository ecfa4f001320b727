"""X.691 ALIGNED-PER runtime primitives shared by the S1AP (36.413) and
M2AP (36.443) codecs: bit-level reader/writer with octet alignment,
range-dependent constrained whole numbers, length determinants, and
octet-aligned open types.  See `s1ap36413.py` for the protocol context
and the reference-capture tests that pin the rules."""

from __future__ import annotations




class AperError(ValueError):
    pass


class BitReader:
    def __init__(self, data: bytes):
        self.d = data
        self.bit = 0

    def read_bits(self, n: int) -> int:
        out = 0
        for _ in range(n):
            byte, off = divmod(self.bit, 8)
            if byte >= len(self.d):
                raise AperError("truncated")
            out = (out << 1) | ((self.d[byte] >> (7 - off)) & 1)
            self.bit += 1
        return out

    def align(self):
        self.bit = (self.bit + 7) & ~7

    def read_octets(self, n: int) -> bytes:
        self.align()
        byte = self.bit // 8
        if byte + n > len(self.d):
            raise AperError("truncated octets")
        self.bit += 8 * n
        return self.d[byte : byte + n]

    @property
    def exhausted(self):
        return self.bit >= 8 * len(self.d)


class BitWriter:
    def __init__(self):
        self.bits = []

    def write_bits(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bits.append((v >> i) & 1)

    def align(self):
        while len(self.bits) % 8:
            self.bits.append(0)

    def write_octets(self, b: bytes):
        self.align()
        for x in b:
            self.write_bits(x, 8)

    def to_bytes(self) -> bytes:
        self.align()
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            v = 0
            for bit in self.bits[i : i + 8]:
                v = (v << 1) | bit
            out.append(v)
        return bytes(out)


# ---- X.691 aligned-PER primitives ----------------------------------------

def read_constrained(r: BitReader, lo: int, hi: int) -> int:
    """Constrained whole number (X.691 §10.5, ALIGNED): range <= 255 is an
    unaligned bit-field; range == 256 one aligned octet; <= 65536 two."""
    rng = hi - lo + 1
    if rng == 1:
        return lo
    if rng <= 255:
        return lo + r.read_bits((rng - 1).bit_length())
    if rng == 256:
        return lo + r.read_octets(1)[0]
    if rng <= 65536:
        return lo + int.from_bytes(r.read_octets(2), "big")
    # X.691 §10.5.7.4: large range — octet count as a constrained whole
    # number, then the value in that many aligned octets
    n_max = ((hi - lo).bit_length() + 7) // 8
    n = read_constrained(r, 1, n_max)
    return lo + int.from_bytes(r.read_octets(n), "big")


def write_constrained(w: BitWriter, v: int, lo: int, hi: int):
    rng = hi - lo + 1
    if rng == 1:
        return
    if rng <= 255:
        w.write_bits(v - lo, (rng - 1).bit_length())
    elif rng == 256:
        w.write_octets(bytes([v - lo]))
    elif rng <= 65536:
        w.write_octets((v - lo).to_bytes(2, "big"))
    else:
        n_max = ((hi - lo).bit_length() + 7) // 8
        n = max(1, ((v - lo).bit_length() + 7) // 8)
        write_constrained(w, n, 1, n_max)
        w.write_octets((v - lo).to_bytes(n, "big"))


def read_length(r: BitReader) -> int:
    """Unconstrained length determinant (X.691 §10.9, aligned)."""
    r.align()
    b0 = r.read_octets(1)[0]
    if b0 < 0x80:
        return b0
    if b0 < 0xC0:
        return ((b0 & 0x3F) << 8) | r.read_octets(1)[0]
    raise AperError("fragmented lengths not supported")


def write_length(w: BitWriter, n: int):
    w.align()
    if n < 0x80:
        w.write_octets(bytes([n]))
    elif n < 0x4000:
        w.write_octets(bytes([0x80 | (n >> 8), n & 0xFF]))
    else:
        raise AperError("fragmented lengths not supported")


def read_open_type(r: BitReader) -> bytes:
    return r.read_octets(read_length(r))


def write_open_type(w: BitWriter, b: bytes):
    write_length(w, len(b))
    w.write_octets(b)



# ---- generic 3GPP-AP PDU / ProtocolIE container (shared S1AP/M2AP shape) --

import dataclasses

CRITICALITY = ("reject", "ignore", "notify")
PDU_TYPES = ("initiatingMessage", "successfulOutcome", "unsuccessfulOutcome")


@dataclasses.dataclass
class ProtocolIE:
    id: int
    criticality: str
    value: object  # decoded per-IE python value (bytes = raw passthrough)


@dataclasses.dataclass
class Pdu:
    pdu_type: str
    procedure_code: int
    criticality: str
    ies: list


def read_ie_container(r: BitReader, ie_decoders: dict) -> list:
    """ProtocolIE-Container: every IE without a registered decoder keeps
    its raw open-type bytes (re-encoded verbatim -> byte-exact round trips
    even for IEs the caller doesn't model semantically)."""
    n = read_constrained(r, 0, 65535)
    ies = []
    for _ in range(n):
        ie_id = read_constrained(r, 0, 65535)
        crit = CRITICALITY[r.read_bits(2)]
        body = read_open_type(r)
        dec = ie_decoders.get(ie_id)
        val = dec(BitReader(body)) if dec else body
        ies.append(ProtocolIE(ie_id, crit, val))
    return ies


def write_ie_container(w: BitWriter, ies: list, ie_encoders: dict):
    write_constrained(w, len(ies), 0, 65535)
    for ie in ies:
        write_constrained(w, ie.id, 0, 65535)
        w.write_bits(CRITICALITY.index(ie.criticality), 2)
        enc = ie_encoders.get(ie.id)
        if enc is not None:
            bw = BitWriter()
            enc(bw, ie.value)
            body = bw.to_bytes()
        elif isinstance(ie.value, (bytes, bytearray)):
            body = bytes(ie.value)
        else:
            raise AperError(f"no encoder for IE {ie.id}")
        write_open_type(w, body)


def decode_ap_pdu(data: bytes, ie_decoders: dict) -> Pdu:
    r = BitReader(bytes(data))
    if r.read_bits(1):
        raise AperError("extended PDU choice")
    pdu_type = PDU_TYPES[r.read_bits(2)]
    proc = read_constrained(r, 0, 255)
    crit = CRITICALITY[r.read_bits(2)]
    body = read_open_type(r)
    br = BitReader(body)
    if br.read_bits(1):
        raise AperError("extended message sequence")
    return Pdu(pdu_type, proc, crit, read_ie_container(br, ie_decoders))


def encode_ap_pdu(pdu: Pdu, ie_encoders: dict) -> bytes:
    w = BitWriter()
    w.write_bits(0, 1)
    w.write_bits(PDU_TYPES.index(pdu.pdu_type), 2)
    write_constrained(w, pdu.procedure_code, 0, 255)
    w.write_bits(CRITICALITY.index(pdu.criticality), 2)
    bw = BitWriter()
    bw.write_bits(0, 1)
    write_ie_container(bw, pdu.ies, ie_encoders)
    write_open_type(w, bw.to_bytes())
    return w.to_bytes()
