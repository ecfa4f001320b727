"""MAC PDU codec: subheader multiplexing of logical channels + control elements.

Reference behavior: `lib/src/common/pdu.cc` (subheader/CE pack-unpack,
pdu.h:205-368) — R/F2/E/LCID subheaders with 7/15-bit length fields, padding,
and MAC control elements (C-RNTI, contention resolution, BSR, TA).
"""

from __future__ import annotations

# LCIDs (36.321 Table 6.2.1-1/2)
LCID_CCCH = 0
LCID_PAD = 31
LCID_CRNTI = 27  # UL CE
LCID_CON_RES = 28  # DL CE (UE contention resolution identity)
LCID_SBSR = 29  # short BSR
LCID_TA = 29  # DL: timing advance (context-dependent)

LCID_SCELL_ACT = 27  # DL CE: SCell Activation/Deactivation (36.321 §6.1.3.8)

LCID_PHR = 26  # UL CE: Power Headroom Report (36.321 §6.1.3.6)
LCID_LBSR = 30  # UL CE: Long BSR (four LCGs, 36.321 §6.1.3.1)
CE_SIZES_UL = {LCID_CRNTI: 2, LCID_SBSR: 1, LCID_PHR: 1, LCID_LBSR: 3}

# 36.321 Table 6.1.3.1-1: buffer-size levels (bytes) per 6-bit index
BSR_TABLE = (
    0, 10, 12, 14, 17, 19, 22, 26, 31, 36, 42, 49, 57, 67, 78, 91,
    107, 125, 146, 171, 200, 234, 274, 321, 376, 440, 515, 603, 706, 826,
    967, 1132, 1326, 1552, 1817, 2127, 2490, 2915, 3413, 3995, 4677, 5476,
    6411, 7505, 8787, 10287, 12043, 14099, 16507, 19325, 22624, 26487,
    31009, 36304, 42502, 49759, 58255, 68201, 79846, 93479, 109439, 128125,
    150000, 150001)


def bsr_index(n_bytes: int) -> int:
    """Smallest index whose level is >= the buffer size (pdu.cc
    buff_size_table lookup)."""
    for i, lvl in enumerate(BSR_TABLE):
        if n_bytes <= lvl:
            return i
    return 63


def long_bsr_ce(lcg_bytes) -> bytes:
    """Long BSR CE: four 6-bit indices packed into 3 bytes."""
    idx = [bsr_index(b) for b in lcg_bytes]
    v = (idx[0] << 18) | (idx[1] << 12) | (idx[2] << 6) | idx[3]
    return v.to_bytes(3, "big")


def long_bsr_bytes(ce: bytes) -> list:
    """Inverse: per-LCG buffer-size estimates (table levels)."""
    v = int.from_bytes(ce[:3], "big")
    return [BSR_TABLE[(v >> s) & 0x3F] for s in (18, 12, 6, 0)]


def phr_ce(ph_db: float) -> bytes:
    """Power Headroom CE: 6-bit level, PH = (-23 + level) dB
    (36.133 Table 9.1.8.4-1; pdu.cc phr pack)."""
    level = int(max(0, min(63, round(ph_db + 23))))
    return bytes([level])


def phr_db(ce: bytes) -> float:
    return (ce[0] & 0x3F) - 23.0
CE_SIZES_DL = {LCID_CON_RES: 6, LCID_TA: 1, LCID_SCELL_ACT: 1}


def scell_act_ce(active: set) -> bytes:
    """Activation/Deactivation CE: one octet, bit i (1..7) = SCellIndex i
    activated, bit 0 reserved (36.321 §6.1.3.8 / pdu.cc)."""
    b = 0
    for i in active:
        assert 1 <= i <= 7
        b |= 1 << i
    return bytes([b])


def _len_hdr(lcid: int, n: int, e: int) -> bytes:
    """R/R/E/LCID/F/L subheader with explicit length (7 or 15-bit L)."""
    if n < 128:
        return bytes([(e << 5) | (lcid & 0x1F), n & 0x7F])
    return bytes([(e << 5) | (lcid & 0x1F), 0x80 | (n >> 8), n & 0xFF])


def pack(subpdus, tb_size: int = None) -> bytes:
    """subpdus: list of (lcid, payload bytes).  Returns a MAC PDU.

    With tb_size, pads to exactly tb_size bytes using 36.321 §6.1.2
    padding subheaders (pdu.h:277-278 / pdu.cc):
      - 1-2 bytes short: that many one-byte padding subheaders (E=1,
        LCID=31, no L field) PREPENDED to the header chain;
      - more: every real subPDU gets an explicit length field and a final
        padding subheader (E=0, LCID=31) owns the remainder of the PDU.
    Without padding the last subheader keeps the implicit rest-of-PDU
    length, so the image is the shortest legal encoding either way."""
    subpdus = list(subpdus)
    headers = b""
    payloads = b""
    for i, (lcid, payload) in enumerate(subpdus):
        last = i == len(subpdus) - 1
        if last:
            headers += bytes([lcid & 0x1F])
        else:
            headers += _len_hdr(lcid, len(payload), 1)
        payloads += payload
    base = headers + payloads
    if tb_size is None or len(base) == tb_size:
        return base
    need = tb_size - len(base)
    assert need > 0, f"MAC PDU {len(base)}B exceeds TBS {tb_size}B"
    if not subpdus:
        # padding-only PDU: one padding subheader owns the whole TB
        return bytes([LCID_PAD]) + bytes(tb_size - 1)
    if need <= 2:
        # leading padding subheaders (one byte each, no payload)
        return bytes([(1 << 5) | LCID_PAD]) * need + base
    headers = b"".join(_len_hdr(lcid, len(p), 1) for lcid, p in subpdus)
    pdu = headers + bytes([LCID_PAD]) + payloads
    return pdu + bytes(tb_size - len(pdu))


# 36.321 Table 7.2-1: Backoff Parameter index -> ms (reserved indices -> 960)
BI_TABLE_MS = (0, 10, 20, 30, 40, 60, 80, 120, 160, 240, 320, 480, 960,
               960, 960, 960)


def pack_rar(rapid: int, ta: int, ul_grant: int, t_crnti: int,
             bi: int = 0) -> bytes:
    """Random Access Response MAC PDU (36.321 §6.1.5 / §6.2.2):
    optional BI subheader [E=1|T=0|R|R|BI(4)], then
    subheader [E=0|T=1|RAPID(6)] + payload [R|TA(11)|UL grant(20)|T-CRNTI(16)].
    A nonzero `bi` broadcasts the Backoff Indicator (36.321 §7.2) — every
    contending UE that reads the RAR applies a random backoff <= BI ms
    before its next PRACH (the congestion-collapse valve at mass attach)."""
    hdr = b""
    if bi:
        hdr += bytes([0x80 | (bi & 0x0F)])
    hdr += bytes([0x40 | (rapid & 0x3F)])
    body = (
        ((ta & 0x7FF) << 36) | ((ul_grant & 0xFFFFF) << 16) | (t_crnti & 0xFFFF)
    ).to_bytes(6, "big")
    return hdr + body


def is_rar(pdu_bytes: bytes) -> bool:
    if len(pdu_bytes) >= 8 and (pdu_bytes[0] & 0xC0) == 0x80:
        return (pdu_bytes[1] & 0xC0) == 0x40  # BI subheader then RAPID
    return len(pdu_bytes) >= 7 and (pdu_bytes[0] & 0xC0) == 0x40


def unpack_rar(pdu_bytes: bytes) -> dict:
    bi = 0
    if (pdu_bytes[0] & 0xC0) == 0x80:  # leading Backoff Indicator subheader
        bi = pdu_bytes[0] & 0x0F
        pdu_bytes = pdu_bytes[1:]
    rapid = pdu_bytes[0] & 0x3F
    v = int.from_bytes(pdu_bytes[1:7], "big")
    return dict(rapid=rapid, ta=(v >> 36) & 0x7FF,
                ul_grant=(v >> 16) & 0xFFFFF, t_crnti=v & 0xFFFF,
                backoff_ms=BI_TABLE_MS[bi])


def unpack(pdu: bytes):
    """Returns list of (lcid, payload), padding subPDUs dropped.

    The final non-padding subPDU takes the rest of the PDU; padding
    subheaders (LCID=31) carry no length field — leading ones (E=1) have
    no payload, a final one (E=0) owns the rest of the PDU as padding."""
    if not pdu:
        return []  # CQI-only PUSCH carries no MAC subPDUs (36.213 §7.2.1)
    out = []
    pos = 0
    sizes = []
    lcids = []
    while True:
        b0 = pdu[pos]
        e = (b0 >> 5) & 1
        lcid = b0 & 0x1F
        pos += 1
        if lcid == LCID_PAD:
            if e:
                continue  # leading padding subheader: no L, no payload
            lcids.append(lcid)
            sizes.append(None)  # final padding owns the rest — dropped
            break
        if e:
            n = pdu[pos]
            pos += 1
            if n & 0x80:
                n = ((n & 0x7F) << 8) | pdu[pos]
                pos += 1
            lcids.append(lcid)
            sizes.append(n)
        else:
            lcids.append(lcid)
            sizes.append(None)  # rest of PDU
            break
    for lcid, n in zip(lcids, sizes):
        if n is None:
            if lcid != LCID_PAD:
                out.append((lcid, pdu[pos:]))
            pos = len(pdu)
        else:
            out.append((lcid, pdu[pos : pos + n]))
            pos += n
    return out
