"""X.691 PER codec runtime — UNALIGNED (UPER, used by 36.331 RRC) and
ALIGNED (APER, used by 36.413 S1AP / 36.443 M2AP) variants.

Reference behavior: `lib/src/asn1/asn1_utils.cc` (bit_ref pack/unpack under
the generated `rrc_asn1.cc`) and `lib/src/asn1/liblte_s1ap.cc` — this module
is the equivalent codec core, but schema-driven: ASN.1 types are declared as
Python objects (Seq / Choice / Enum / Int / BitStr / OctStr / SeqOf) that
mirror the 3GPP ASN.1 modules, and pack/unpack walk the declarations.

Implements the X.691 subset the 3GPP protocols use:
  - constrained / semi-constrained / unconstrained whole numbers (§10.5-10.8)
  - normally-small non-negative whole numbers (§10.6) for extension indices
  - length determinants, constrained and unconstrained (§10.9)
  - BOOLEAN, ENUMERATED with extension marker (§12, §13)
  - BIT STRING / OCTET STRING, fixed and variable size (§15, §16)
  - SEQUENCE with OPTIONAL/DEFAULT bitmap, extension marker and extension
    addition groups encoded as open types (§18)
  - SEQUENCE OF with constrained length (§19)
  - CHOICE with extension alternatives (§22)
  - open type encoding (§10.2): unconstrained length + octet-aligned value
  - ALIGNED variant alignment rules: align before length determinants,
    before constrained ints with range > 256, and around open-type contents

Decoded values are plain Python: dict for SEQUENCE (absent optionals have no
key), ("alt", value) for CHOICE, str name for ENUMERATED, '0'/'1' string for
BIT STRING, bytes for OCTET STRING, list for SEQUENCE OF, int/bool/None for
the scalars.  Unknown extension additions survive a decode/re-encode round
trip as raw bytes under the "_ext<N>" / "_rawext" keys.
"""

from __future__ import annotations


class DecodeError(Exception):
    pass


class BitWriter:
    def __init__(self, aligned: bool = False):
        self.aligned = aligned
        self.buf = bytearray()
        self.nbits = 0  # total bits written

    def put_bits(self, v: int, n: int):
        if n == 0:
            return
        assert 0 <= v < (1 << n), (v, n)
        for i in range(n - 1, -1, -1):
            if self.nbits % 8 == 0:
                self.buf.append(0)
            if (v >> i) & 1:
                self.buf[-1] |= 1 << (7 - (self.nbits % 8))
            self.nbits += 1

    def put_bytes(self, b: bytes):
        if self.nbits % 8 == 0:
            self.buf.extend(b)
            self.nbits += 8 * len(b)
        else:
            for byte in b:
                self.put_bits(byte, 8)

    def align(self):
        if self.aligned and self.nbits % 8:
            self.put_bits(0, 8 - self.nbits % 8)

    def getvalue(self) -> bytes:
        return bytes(self.buf)


class BitReader:
    def __init__(self, data: bytes, aligned: bool = False):
        self.data = data
        self.aligned = aligned
        self.pos = 0

    def get_bits(self, n: int) -> int:
        if self.pos + n > 8 * len(self.data):
            raise DecodeError(f"out of data at bit {self.pos} (+{n})")
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def get_bytes(self, n: int) -> bytes:
        if self.pos % 8 == 0:
            if (self.pos >> 3) + n > len(self.data):
                raise DecodeError("out of data")
            out = self.data[self.pos >> 3:(self.pos >> 3) + n]
            self.pos += 8 * n
            return out
        return bytes(self.get_bits(8) for _ in range(n))

    def align(self):
        if self.aligned and self.pos % 8:
            self.pos += 8 - self.pos % 8


# ---------------- whole-number / length primitives ----------------

def _nbits(range_: int) -> int:
    return (range_ - 1).bit_length()


def put_cint(w: BitWriter, v: int, lo: int, hi: int):
    """Constrained whole number (§10.5; ALIGNED §10.5.7)."""
    if not lo <= v <= hi:
        raise ValueError(f"int {v} outside [{lo},{hi}]")
    range_ = hi - lo + 1
    if range_ == 1:
        return
    if not w.aligned:
        w.put_bits(v - lo, _nbits(range_))
    elif range_ <= 255:
        w.put_bits(v - lo, _nbits(range_))
    elif range_ == 256:
        w.align()
        w.put_bits(v - lo, 8)
    elif range_ <= 65536:
        w.align()
        w.put_bits(v - lo, 16)
    else:
        n = max(1, ((v - lo).bit_length() + 7) // 8)
        put_cint(w, n - 1, 0, (hi - lo).bit_length() // 8)
        w.align()
        w.put_bits(v - lo, 8 * n)


def get_cint(r: BitReader, lo: int, hi: int) -> int:
    range_ = hi - lo + 1
    if range_ == 1:
        return lo
    if not r.aligned:
        return lo + r.get_bits(_nbits(range_))
    if range_ <= 255:
        return lo + r.get_bits(_nbits(range_))
    if range_ == 256:
        r.align()
        return lo + r.get_bits(8)
    if range_ <= 65536:
        r.align()
        return lo + r.get_bits(16)
    n = 1 + get_cint(r, 0, (hi - lo).bit_length() // 8)
    r.align()
    return lo + r.get_bits(8 * n)


def put_small(w: BitWriter, v: int):
    """Normally-small non-negative whole number (§10.6): ext indices/counts."""
    if v < 64:
        w.put_bits(0, 1)
        w.put_bits(v, 6)
    else:
        w.put_bits(1, 1)
        put_len(w, v)


def get_small(r: BitReader) -> int:
    if r.get_bits(1) == 0:
        return r.get_bits(6)
    return get_len(r)


def put_len(w: BitWriter, n: int):
    """Unconstrained length determinant (§10.9.3.6-8)."""
    w.align()
    if n < 128:
        w.put_bits(n, 8)
    elif n < 16384:
        w.put_bits(0b10, 2)
        w.put_bits(n, 14)
    else:
        raise ValueError("fragmented lengths not supported")


def get_len(r: BitReader) -> int:
    r.align()
    if r.get_bits(1) == 0:
        return r.get_bits(7)
    if r.get_bits(1) == 1:
        raise DecodeError("fragmented length")
    return r.get_bits(14)


def put_semiint(w: BitWriter, v: int, lo: int):
    """Semi-constrained whole number (§10.7): length + offset octets."""
    off = v - lo
    n = max(1, (off.bit_length() + 7) // 8)
    put_len(w, n)
    w.put_bits(off, 8 * n)


def get_semiint(r: BitReader, lo: int) -> int:
    n = get_len(r)
    return lo + r.get_bits(8 * n)


def put_uncint(w: BitWriter, v: int):
    """Unconstrained whole number (§10.8): length + 2's-complement octets."""
    n = max(1, (v.bit_length() + 8) // 8) if v >= 0 \
        else max(1, ((-v - 1).bit_length() + 8) // 8)
    b = v.to_bytes(n, "big", signed=True)
    put_len(w, len(b))
    w.put_bytes(b)


def get_uncint(r: BitReader) -> int:
    n = get_len(r)
    return int.from_bytes(r.get_bytes(n), "big", signed=True)


# ---------------- type objects ----------------

class Type:
    def enc(self, w: BitWriter, v):
        raise NotImplementedError

    def dec(self, r: BitReader):
        raise NotImplementedError


class Null(Type):
    def enc(self, w, v):
        pass

    def dec(self, r):
        return None


class Bool(Type):
    def enc(self, w, v):
        w.put_bits(1 if v else 0, 1)

    def dec(self, r):
        return bool(r.get_bits(1))


class Int(Type):
    """INTEGER.  lo=None → unconstrained; hi=None → semi-constrained;
    ext=True → extensible range (1-bit escape to unconstrained)."""

    def __init__(self, lo=None, hi=None, ext: bool = False):
        self.lo, self.hi, self.ext = lo, hi, ext

    def enc(self, w, v):
        v = int(v)
        if self.ext:
            in_root = self.lo is not None and self.hi is not None \
                and self.lo <= v <= self.hi
            w.put_bits(0 if in_root else 1, 1)
            if not in_root:
                put_uncint(w, v)
                return
        if self.lo is None:
            put_uncint(w, v)
        elif self.hi is None:
            put_semiint(w, v, self.lo)
        else:
            put_cint(w, v, self.lo, self.hi)

    def dec(self, r):
        if self.ext and r.get_bits(1):
            return get_uncint(r)
        if self.lo is None:
            return get_uncint(r)
        if self.hi is None:
            return get_semiint(r, self.lo)
        return get_cint(r, self.lo, self.hi)


class Enum(Type):
    """ENUMERATED; names beyond n_root are extension additions (§13)."""

    def __init__(self, names, ext: bool = False, n_root: int | None = None):
        self.names = tuple(names)
        self.ext = ext
        self.n_root = len(self.names) if n_root is None else n_root

    def enc(self, w, v):
        i = self.names.index(v) if isinstance(v, str) else int(v)
        if self.ext:
            if i < self.n_root:
                w.put_bits(0, 1)
                put_cint(w, i, 0, self.n_root - 1)
            else:
                w.put_bits(1, 1)
                put_small(w, i - self.n_root)
        else:
            put_cint(w, i, 0, self.n_root - 1)

    def dec(self, r):
        if self.ext and r.get_bits(1):
            i = self.n_root + get_small(r)
        else:
            i = get_cint(r, 0, self.n_root - 1)
        return self.names[i] if i < len(self.names) else f"_enum{i}"


class BitStr(Type):
    """BIT STRING, value as a '0'/'1' string."""

    def __init__(self, lo: int, hi: int | None = None, ext: bool = False):
        self.lo, self.hi, self.ext = lo, lo if hi is None else hi, ext

    def enc(self, w, v):
        n = len(v)
        if self.ext:
            w.put_bits(0 if self.lo <= n <= self.hi else 1, 1)
        if self.lo != self.hi:
            put_cint(w, n, self.lo, self.hi)
        elif n != self.lo:
            raise ValueError(f"bitstr len {n} != {self.lo}")
        if w.aligned and n > 16:
            w.align()
        for ch in v:
            w.put_bits(1 if ch == "1" else 0, 1)

    def dec(self, r):
        if self.ext and r.get_bits(1):
            raise DecodeError("bitstr ext length")
        n = self.lo if self.lo == self.hi else get_cint(r, self.lo, self.hi)
        if r.aligned and n > 16:
            r.align()
        return "".join("1" if r.get_bits(1) else "0" for _ in range(n))


class UncBitStr(Type):
    """BIT STRING with no size constraint (§15.11): unconstrained length
    determinant + bits (e.g. codebookSubsetRestriction-r10)."""

    def enc(self, w, v):
        put_len(w, len(v))
        if w.aligned and len(v) > 16:
            w.align()
        for ch in v:
            w.put_bits(1 if ch == "1" else 0, 1)

    def dec(self, r):
        n = get_len(r)
        if r.aligned and n > 16:
            r.align()
        return "".join("1" if r.get_bits(1) else "0" for _ in range(n))


class OctStr(Type):
    """OCTET STRING, value as bytes.  lo==hi → fixed size (no length)."""

    def __init__(self, lo: int = 0, hi: int | None = None, ext: bool = False):
        self.lo = lo
        self.hi = hi
        self.ext = ext

    def enc(self, w, v):
        v = bytes(v)
        n = len(v)
        if self.ext:
            in_root = self.hi is not None and self.lo <= n <= self.hi
            w.put_bits(0 if in_root else 1, 1)
            if not in_root:
                put_len(w, n)
                w.put_bytes(v)
                return
        if self.hi is None:
            put_len(w, n)
        elif self.lo != self.hi:
            put_cint(w, n, self.lo, self.hi)
            if w.aligned and self.hi > 2:
                w.align()
        else:
            if n != self.lo:
                raise ValueError(f"octstr len {n} != {self.lo}")
            if w.aligned and n > 2:
                w.align()
        w.put_bytes(v)

    def dec(self, r):
        if self.ext and r.get_bits(1):
            return r.get_bytes(get_len(r))
        if self.hi is None:
            n = get_len(r)
        elif self.lo != self.hi:
            n = get_cint(r, self.lo, self.hi)
            if r.aligned and self.hi > 2:
                r.align()
        else:
            n = self.lo
            if r.aligned and n > 2:
                r.align()
        return r.get_bytes(n)


def put_open(w: BitWriter, inner: Type, v):
    """Open type (§10.2): contents as octet-aligned string + length."""
    iw = BitWriter(aligned=w.aligned)
    inner.enc(iw, v)
    b = iw.getvalue() or b"\x00"
    put_len(w, len(b))
    w.put_bytes(b)


def get_open(r: BitReader, inner: Type | None):
    n = get_len(r)
    b = r.get_bytes(n)
    if inner is None:
        return b
    ir = BitReader(b, aligned=r.aligned)
    return inner.dec(ir)


class Seq(Type):
    """SEQUENCE.  fields: (name, type, flag) with flag '' mandatory,
    '?' optional, ('=', default) DEFAULT.  ext_fields: post-marker
    extension additions in order; a nested list groups one version's
    additions into a single extension-addition group (§18.7)."""

    def __init__(self, fields, ext: bool = False, ext_fields=()):
        self.fields = [(f[0], f[1], f[2] if len(f) > 2 else "")
                       for f in fields]
        self.ext = ext
        self.ext_fields = list(ext_fields)

    def _group_type(self, grp) -> "Seq":
        return Seq([(n, t, fl) for (n, t, fl) in
                    [(g[0], g[1], g[2] if len(g) > 2 else "") for g in grp]])

    def enc(self, w, v: dict):
        exts_present = [
            (i, g) for i, g in enumerate(self.ext_fields)
            if (any(gf[0] in v for gf in g) if isinstance(g, list)
                else g[0] in v)]
        n_raw = len(v.get("_rawext", ()))
        n_seen = v.get("_extn", 0)
        if self.ext:
            w.put_bits(1 if (exts_present or n_raw or n_seen) else 0, 1)
        for name, typ, flag in self.fields:
            if flag == "?" or (isinstance(flag, tuple) and flag[0] == "="):
                w.put_bits(1 if name in v else 0, 1)
        for name, typ, flag in self.fields:
            if name in v:
                typ.enc(w, v[name])
            elif not (flag == "?" or (isinstance(flag, tuple)
                                      and flag[0] == "=")):
                raise ValueError(f"missing mandatory field {name}")
        if self.ext and (exts_present or n_raw or n_seen):
            n_ext = (exts_present[-1][0] + 1 if exts_present else 0)
            n_ext = max(n_ext, n_raw, n_seen)
            put_small(w, n_ext - 1)
            present = set(i for i, _ in exts_present)
            raw = v.get("_rawext", ())
            for i in range(n_ext):
                is_p = i in present or (i < len(raw) and raw[i] is not None)
                w.put_bits(1 if is_p else 0, 1)
            for i, g in exts_present:
                if isinstance(g, list):
                    gt = self._group_type(g)
                    put_open(w, gt, v)
                else:
                    put_open(w, g[1], v[g[0]])
            for i in range(len(self.ext_fields), n_ext):
                if i < len(raw) and raw[i] is not None:
                    put_len(w, len(raw[i]))
                    w.put_bytes(raw[i])

    def dec(self, r):
        has_ext = bool(self.ext and r.get_bits(1))
        present = {}
        for name, typ, flag in self.fields:
            if flag == "?" or (isinstance(flag, tuple) and flag[0] == "="):
                present[name] = bool(r.get_bits(1))
        out = {}
        for name, typ, flag in self.fields:
            if present.get(name, True):
                out[name] = typ.dec(r)
        if has_ext:
            n_ext = get_small(r) + 1
            pres = [bool(r.get_bits(1)) for _ in range(n_ext)]
            raw = []
            for i in range(n_ext):
                if not pres[i]:
                    raw.append(None)
                    continue
                if i < len(self.ext_fields):
                    g = self.ext_fields[i]
                    if isinstance(g, list):
                        out.update(get_open(r, self._group_type(g)))
                    else:
                        out[g[0]] = get_open(r, g[1])
                    raw.append(None)
                else:
                    raw.append(get_open(r, None))
            if any(x is not None for x in raw):
                out["_rawext"] = raw
            # a canonical re-encode would shrink the addition count to the
            # last *present* group; the reference's generated packer always
            # writes every group it knows (trailing absent flags included),
            # so preserve the observed count for byte-exact round trips
            last = max((i for i, p in enumerate(pres) if p), default=-1)
            if n_ext != last + 1:
                out["_extn"] = n_ext
        return out


class SeqOf(Type):
    def __init__(self, elem: Type, lo: int = 0, hi: int | None = None):
        self.elem, self.lo, self.hi = elem, lo, hi

    def enc(self, w, v):
        if self.hi is None:
            put_len(w, len(v))
        else:
            put_cint(w, len(v), self.lo, self.hi)
        for item in v:
            self.elem.enc(w, item)

    def dec(self, r):
        n = get_len(r) if self.hi is None else get_cint(r, self.lo, self.hi)
        return [self.elem.dec(r) for _ in range(n)]


class Choice(Type):
    """CHOICE, value = (alt_name, alt_value).  alts: (name, type); names
    beyond n_root are extension alternatives encoded as open types."""

    def __init__(self, alts, ext: bool = False, n_root: int | None = None):
        self.alts = [(a[0], a[1]) for a in alts]
        self.ext = ext
        self.n_root = len(self.alts) if n_root is None else n_root

    def index(self, name: str) -> int:
        for i, (n, _) in enumerate(self.alts):
            if n == name:
                return i
        raise KeyError(name)

    def enc(self, w, v):
        name, val = v
        i = self.index(name)
        if self.ext:
            if i < self.n_root:
                w.put_bits(0, 1)
                if self.n_root > 1:
                    put_cint(w, i, 0, self.n_root - 1)
                self.alts[i][1].enc(w, val)
            else:
                w.put_bits(1, 1)
                put_small(w, i - self.n_root)
                put_open(w, self.alts[i][1], val)
        else:
            put_cint(w, i, 0, self.n_root - 1)
            self.alts[i][1].enc(w, val)

    def dec(self, r):
        if self.ext and r.get_bits(1):
            i = self.n_root + get_small(r)
            if i >= len(self.alts):
                return (f"_alt{i}", get_open(r, None))
            return (self.alts[i][0], get_open(r, self.alts[i][1]))
        i = get_cint(r, 0, self.n_root - 1) if self.n_root > 1 else 0
        if i >= len(self.alts):
            raise DecodeError(f"choice index {i}")
        name, typ = self.alts[i]
        return (name, typ.dec(r))


class Ref(Type):
    """Late-bound reference for recursive / forward type definitions."""

    def __init__(self):
        self.target: Type | None = None

    def enc(self, w, v):
        self.target.enc(w, v)

    def dec(self, r):
        return self.target.dec(r)


# `setup ::= CHOICE { release NULL, setup T }` appears all over 36.331
def setup_release(t: Type) -> Choice:
    return Choice([("release", Null()), ("setup", t)])


def uper_encode(t: Type, v) -> bytes:
    w = BitWriter(aligned=False)
    t.enc(w, v)
    return w.getvalue()


def uper_decode(t: Type, data: bytes):
    return t.dec(BitReader(data, aligned=False))


def aper_encode(t: Type, v) -> bytes:
    w = BitWriter(aligned=True)
    t.enc(w, v)
    return w.getvalue()


def aper_decode(t: Type, data: bytes):
    return t.dec(BitReader(data, aligned=True))
