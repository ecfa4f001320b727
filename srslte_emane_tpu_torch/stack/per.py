"""Unaligned-PER (UPER) style bit-level codec runtime + RRC message schemas.

Reference behavior: `lib/src/asn1/asn1_utils.cc` (the hand-written bit_ref
pack/unpack runtime under the 132k-LoC generated `rrc_asn1.cc`) — this module
is the equivalent runtime: constrained/unconstrained integers, booleans,
enums, length determinants, octet strings, optional-field bitmaps,
sequences-of and a message-set choice, all packed at bit granularity with no
padding between fields (the UPER property).

Schemas are declared per message as field specs instead of being generated
from the 36.331 ASN.1 module; the bit-level encoding rules follow X.691:
  - constrained int in [lo, hi]: ceil(log2(hi-lo+1)) bits of (v - lo)
  - boolean: 1 bit
  - enum of n values: constrained int [0, n-1]
  - length determinant (X.691 §10.9, <16384): 1 bit 0 + 7 bits, or
    bits 10 + 14 bits
  - unconstrained int: length det + minimal two's-complement octets
  - octet string / UTF8 string: length det + raw octets
  - sequence: leading presence bitmap for OPTIONAL fields, then fields
  - sequence-of: length det + elements
  - choice over the registered message set: constrained index
"""

from __future__ import annotations

import dataclasses


class BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.bitpos = 0  # bits used in the last byte

    def put_bits(self, v: int, n: int):
        for i in range(n - 1, -1, -1):
            if self.bitpos == 0:
                self.buf.append(0)
            bit = (v >> i) & 1
            self.buf[-1] |= bit << (7 - self.bitpos)
            self.bitpos = (self.bitpos + 1) % 8

    def put_bytes(self, b: bytes):
        for byte in b:
            self.put_bits(byte, 8)

    def getvalue(self) -> bytes:
        return bytes(self.buf)


class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # absolute bit position

    def get_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def get_bytes(self, n: int) -> bytes:
        return bytes(self.get_bits(8) for _ in range(n))


# ---------------- X.691 primitives ----------------

def _nbits(n_values: int) -> int:
    return max(1, (n_values - 1).bit_length())


def put_cint(w: BitWriter, v: int, lo: int, hi: int):
    assert lo <= v <= hi, (v, lo, hi)
    w.put_bits(v - lo, _nbits(hi - lo + 1))


def get_cint(r: BitReader, lo: int, hi: int) -> int:
    return lo + r.get_bits(_nbits(hi - lo + 1))


def put_len(w: BitWriter, n: int):
    if n < 128:
        w.put_bits(n, 8)  # leading 0 + 7 bits
    else:
        assert n < 16384
        w.put_bits(0b10, 2)
        w.put_bits(n, 14)


def get_len(r: BitReader) -> int:
    if r.get_bits(1) == 0:
        return r.get_bits(7)
    assert r.get_bits(1) == 0, "fragmented lengths not supported"
    return r.get_bits(14)


def put_uint(w: BitWriter, v: int):
    """Unconstrained integer: length det + minimal two's-complement octets."""
    n = max(1, (v.bit_length() + 8) // 8) if v >= 0 else max(1, ((-v - 1).bit_length() + 8) // 8)
    b = v.to_bytes(n, "big", signed=True)
    put_len(w, len(b))
    w.put_bytes(b)


def get_uint(r: BitReader) -> int:
    n = get_len(r)
    return int.from_bytes(r.get_bytes(n), "big", signed=True)


def put_octets(w: BitWriter, b: bytes):
    put_len(w, len(b))
    w.put_bytes(b)


def get_octets(r: BitReader) -> bytes:
    return r.get_bytes(get_len(r))


# ---------------- schema-driven sequences ----------------
# Field spec forms:
#   ("name", "cint", lo, hi)        constrained integer
#   ("name", "int")                 unconstrained integer
#   ("name", "bool")
#   ("name", "enum", (values...))   encoded as index into the value tuple
#   ("name", "bytes") / ("name", "str")
#   ("name", "float")               milli-unit fixed point as int
#   ("name", "seqof", spec)         list of `spec`-typed elements
#   ("name", "msg")                 nested registered message
#   ("name", "pairs")               list of (int, float) pairs (measurements)
# A spec tuple may end with "?" marking the field OPTIONAL (None/default
# empty => absent); all optionals contribute to the leading presence bitmap.

_SCHEMAS: dict = {}  # cls -> field specs
_MSG_IDS: dict = {}  # cls name -> 16-bit choice id
_BY_ID: dict = {}  # id -> cls


def _msg_id(name: str) -> int:
    """Stable 16-bit message id from the class name — identical in every
    process regardless of module import order (unlike a registration
    counter, which would desynchronize the multi-process apps)."""
    import zlib

    return zlib.crc32(name.encode()) & 0xFFFF


def schema(*specs):
    def deco(cls):
        mid = _msg_id(cls.__name__)
        assert mid not in _BY_ID, f"PER msg-id collision: {cls.__name__}"
        _SCHEMAS[cls] = specs
        _MSG_IDS[cls.__name__] = mid
        _BY_ID[mid] = cls
        return cls
    return deco


def _is_absent(v):
    return v is None or v == [] or v == b"" or v == {} or v == ()


def _enc_field(w, spec, v):
    kind = spec[1]
    if kind == "cint":
        put_cint(w, int(v), spec[2], spec[3])
    elif kind == "int":
        put_uint(w, int(v))
    elif kind == "bool":
        w.put_bits(1 if v else 0, 1)
    elif kind == "enum":
        put_cint(w, spec[2].index(v), 0, len(spec[2]) - 1)
    elif kind in ("bytes",):
        put_octets(w, bytes(v))
    elif kind == "str":
        put_octets(w, str(v).encode())
    elif kind == "float":
        put_uint(w, int(round(float(v) * 1000)))
    elif kind == "seqof":
        put_len(w, len(v))
        for item in v:
            _enc_field(w, ("", *spec[2]), item)
    elif kind == "msg":
        encode_msg(w, v)
    elif kind == "pairs":
        put_len(w, len(v))
        for a, b in v:
            put_uint(w, int(a))
            put_uint(w, int(round(float(b) * 1000)))
    else:
        raise TypeError(kind)


def _dec_field(r, spec):
    kind = spec[1]
    if kind == "cint":
        return get_cint(r, spec[2], spec[3])
    if kind == "int":
        return get_uint(r)
    if kind == "bool":
        return bool(r.get_bits(1))
    if kind == "enum":
        return spec[2][get_cint(r, 0, len(spec[2]) - 1)]
    if kind == "bytes":
        return get_octets(r)
    if kind == "str":
        return get_octets(r).decode()
    if kind == "float":
        return get_uint(r) / 1000.0
    if kind == "seqof":
        return [_dec_field(r, ("", *spec[2])) for _ in range(get_len(r))]
    if kind == "msg":
        return decode_msg(r)
    if kind == "pairs":
        return [(get_uint(r), get_uint(r) / 1000.0) for _ in range(get_len(r))]
    raise TypeError(kind)


def encode_msg(w: BitWriter, msg):
    cls = type(msg)
    specs = _SCHEMAS[cls]
    w.put_bits(_MSG_IDS[cls.__name__], 16)
    opt = [s for s in specs if s[-1] == "?"]
    for s in opt:
        w.put_bits(0 if _is_absent(getattr(msg, s[0])) else 1, 1)
    for s in specs:
        v = getattr(msg, s[0])
        if s[-1] == "?" and _is_absent(v):
            continue
        _enc_field(w, s, v)


def decode_msg(r: BitReader):
    cls = _BY_ID[r.get_bits(16)]
    specs = _SCHEMAS[cls]
    present = {}
    for s in specs:
        if s[-1] == "?":
            present[s[0]] = bool(r.get_bits(1))
    kw = {}
    for s in specs:
        if s[-1] == "?" and not present[s[0]]:
            continue
        kw[s[0]] = _dec_field(r, s)
    return cls(**kw)


def encode(msg) -> bytes:
    w = BitWriter()
    encode_msg(w, msg)
    return w.getvalue()


def decode(data: bytes):
    return decode_msg(BitReader(data))


def has_schema(msg) -> bool:
    return type(msg) in _SCHEMAS
