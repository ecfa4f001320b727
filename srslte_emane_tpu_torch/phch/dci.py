"""DCI pack/unpack, all formats 0/1/1A/1B/1C/1D/2/2A/2B — host-side
control plane.

Host-side numpy, copied from the reference's `phch/dci.py` (the port
imports nothing of the reference package; a test holds the two equal).

Reference behavior: `lib/src/phy/phch/dci.c` (1,586 LoC).  The eNB
scheduler and UE blind search exercise 1A (compact DL, type-2 RA), 1 (DL,
type-0 RA), and 0 (UL grant) end-to-end; 1B/1C/1D/2/2A/2B are packed and
unpacked below for the MIMO TMs and paging/RAR paths.  Bit packing is
MSB-first, matching srsLTE/36.212 §5.3.3.1.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import ra


def _ceil_log2(x: int) -> int:
    return max(1, math.ceil(math.log2(x)))


def riv_len(n_prb: int) -> int:
    return _ceil_log2(n_prb * (n_prb + 1) // 2)


def _put(bits, off, val, n):
    for i in range(n):
        bits[off + i] = (val >> (n - 1 - i)) & 1
    return off + n


def _get(bits, off, n):
    v = 0
    for i in range(n):
        v = (v << 1) | int(bits[off + i])
    return v, off + n


@dataclasses.dataclass
class DciDl:
    """DL grant content (formats 1/1A)."""
    format: str  # "1" or "1A"
    mcs: int = 0
    harq_pid: int = 0
    ndi: int = 0
    rv: int = 0
    tpc: int = 0
    # format 1A (type-2 RA)
    rb_start: int = 0
    l_crbs: int = 1
    # format 1 (type-0 RA)
    rbg_bitmap: int = 0


@dataclasses.dataclass
class DciUl:
    """UL grant content (format 0)."""
    mcs: int = 0
    ndi: int = 0
    tpc: int = 0
    rb_start: int = 0
    l_crbs: int = 1
    dmrs_cs: int = 0
    cqi_req: int = 0
    hopping: int = 0


def format0_1a_len(n_prb: int) -> int:
    """Formats 0 and 1A are padded to equal length (36.212 §5.3.3.1.3)."""
    # format 0: flag(1)+hop(1)+riv+mcs(5)+ndi(1)+tpc(2)+dmrs(3)+cqi(1)
    f0 = 1 + 1 + riv_len(n_prb) + 5 + 1 + 2 + 3 + 1
    # format 1A: flag(1)+la/dist(1)+riv+mcs(5)+harq(3)+ndi(1)+rv(2)+tpc(2)
    f1a = 1 + 1 + riv_len(n_prb) + 5 + 3 + 1 + 2 + 2
    n = max(f0, f1a)
    # avoid ambiguous sizes (36.212 Table 5.3.3.1.2-1 forbidden lengths)
    while n in (12, 14, 16, 20, 24, 26, 32, 40, 44, 56):
        n += 1
    return n


def format1_len(n_prb: int) -> int:
    n_rbg = -(-n_prb // ra.rbg_size(n_prb))
    n = 1 + n_rbg + 5 + 3 + 1 + 2 + 2  # ra_type flag only for >10 PRB in spec;
    # srsLTE format1: resource allocation header (1, absent for <=10 PRB)
    if n_prb <= 10:
        n -= 1
    while n == format0_1a_len(n_prb) or n in (12, 14, 16, 20, 24, 26, 32, 40, 44, 56):
        n += 1
    return n


def pack_dl(d: DciDl, n_prb: int) -> np.ndarray:
    if d.format == "1A":
        n = format0_1a_len(n_prb)
        bits = np.zeros(n, dtype=np.int8)
        off = 0
        off = _put(bits, off, 1, 1)  # flag: 1 = format 1A
        off = _put(bits, off, 0, 1)  # localized
        riv = ra.riv_encode(d.rb_start, d.l_crbs, n_prb)
        off = _put(bits, off, riv, riv_len(n_prb))
        off = _put(bits, off, d.mcs, 5)
        off = _put(bits, off, d.harq_pid, 3)
        off = _put(bits, off, d.ndi, 1)
        off = _put(bits, off, d.rv, 2)
        off = _put(bits, off, d.tpc, 2)
        return bits
    if d.format == "1":
        n = format1_len(n_prb)
        n_rbg = -(-n_prb // ra.rbg_size(n_prb))
        bits = np.zeros(n, dtype=np.int8)
        off = 0
        if n_prb > 10:
            off = _put(bits, off, 0, 1)  # RA type 0
        off = _put(bits, off, d.rbg_bitmap, n_rbg)
        off = _put(bits, off, d.mcs, 5)
        off = _put(bits, off, d.harq_pid, 3)
        off = _put(bits, off, d.ndi, 1)
        off = _put(bits, off, d.rv, 2)
        off = _put(bits, off, d.tpc, 2)
        return bits
    raise ValueError(d.format)


def unpack_dl(bits: np.ndarray, n_prb: int, fmt: str) -> DciDl:
    off = 0
    if fmt == "1A":
        flag, off = _get(bits, off, 1)
        _, off = _get(bits, off, 1)
        riv, off = _get(bits, off, riv_len(n_prb))
        mcs, off = _get(bits, off, 5)
        harq, off = _get(bits, off, 3)
        ndi, off = _get(bits, off, 1)
        rv, off = _get(bits, off, 2)
        tpc, off = _get(bits, off, 2)
        s, l = ra.riv_decode(riv, n_prb)
        return DciDl("1A", mcs, harq, ndi, rv, tpc, rb_start=s, l_crbs=l)
    if fmt == "1":
        n_rbg = -(-n_prb // ra.rbg_size(n_prb))
        if n_prb > 10:
            _, off = _get(bits, off, 1)
        bitmap, off = _get(bits, off, n_rbg)
        mcs, off = _get(bits, off, 5)
        harq, off = _get(bits, off, 3)
        ndi, off = _get(bits, off, 1)
        rv, off = _get(bits, off, 2)
        tpc, off = _get(bits, off, 2)
        return DciDl("1", mcs, harq, ndi, rv, tpc, rbg_bitmap=bitmap)
    raise ValueError(fmt)


def pack_ul(d: DciUl, n_prb: int) -> np.ndarray:
    n = format0_1a_len(n_prb)
    bits = np.zeros(n, dtype=np.int8)
    off = 0
    off = _put(bits, off, 0, 1)  # flag: 0 = format 0
    off = _put(bits, off, d.hopping, 1)
    off = _put(bits, off, ra.riv_encode(d.rb_start, d.l_crbs, n_prb), riv_len(n_prb))
    off = _put(bits, off, d.mcs, 5)
    off = _put(bits, off, d.ndi, 1)
    off = _put(bits, off, d.tpc, 2)
    off = _put(bits, off, d.dmrs_cs, 3)
    off = _put(bits, off, d.cqi_req, 1)
    return bits


def unpack_ul(bits: np.ndarray, n_prb: int) -> DciUl:
    off = 0
    _, off = _get(bits, off, 1)
    hop, off = _get(bits, off, 1)
    riv, off = _get(bits, off, riv_len(n_prb))
    mcs, off = _get(bits, off, 5)
    ndi, off = _get(bits, off, 1)
    tpc, off = _get(bits, off, 2)
    dmrs, off = _get(bits, off, 3)
    cqi, off = _get(bits, off, 1)
    s, l = ra.riv_decode(riv, n_prb)
    return DciUl(mcs, ndi, tpc, rb_start=s, l_crbs=l, dmrs_cs=dmrs, cqi_req=cqi, hopping=hop)


def is_format0(bits: np.ndarray) -> bool:
    return int(bits[0]) == 0


# ---------------- additional DL formats (dci.c parity) ----------------

@dataclasses.dataclass
class DciDl2:
    """Two-codeword DL grants (formats 2/2A/2B) — TM4/TM3/TM8."""
    format: str  # "2" | "2A" | "2B"
    rbg_bitmap: int = 0
    tpc: int = 0
    harq_pid: int = 0
    cw_swap: int = 0
    mcs1: int = 0
    ndi1: int = 0
    rv1: int = 0
    mcs2: int = 0
    ndi2: int = 0
    rv2: int = 0
    precoding_info: int = 0  # format 2 (3 bits, 2 ports)
    n_scid: int = 0  # format 2B scrambling identity


def _rbg_bits(n_prb: int) -> int:
    return -(-n_prb // ra.rbg_size(n_prb))


def format1c_len(n_prb: int) -> int:
    """Format 1C (36.212 §5.3.3.1.4): gap flag (N>=50) + reduced RIV + 5-bit
    TBS index."""
    step = 2 if n_prb < 50 else 4
    nvrb = n_prb // step
    n = _ceil_log2(nvrb * (nvrb + 1) // 2) + 5
    if n_prb >= 50:
        n += 1
    return n


def format1bd_len(n_prb: int) -> int:
    """Formats 1B/1D (2 tx ports): 1A fields + 2-bit TPMI + 1 bit
    (PMI confirmation for 1B / power offset for 1D)."""
    n = 1 + riv_len(n_prb) + 5 + 3 + 1 + 2 + 2 + 2 + 1
    while n in (12, 14, 16, 20, 24, 26, 32, 40, 44, 56) or n == format0_1a_len(n_prb):
        n += 1
    return n


def format2_len(n_prb: int, fmt: str) -> int:
    n = (1 if n_prb > 10 else 0) + _rbg_bits(n_prb) + 2 + 3 + 1 + 2 * (5 + 1 + 2)
    if fmt == "2":
        n += 3  # precoding information, 2 ports
    elif fmt == "2B":
        n += 1  # scrambling identity
    while n in (12, 14, 16, 20, 24, 26, 32, 40, 44, 56) or n == format0_1a_len(n_prb):
        n += 1
    return n


def pack_dl_1c(rb_start: int, l_crbs: int, tbs_idx: int, n_prb: int) -> np.ndarray:
    step = 2 if n_prb < 50 else 4
    nvrb = n_prb // step
    bits = np.zeros(format1c_len(n_prb), dtype=np.int8)
    off = 0
    if n_prb >= 50:
        off = _put(bits, off, 0, 1)  # gap 1
    riv = ra.riv_encode(rb_start // step, max(1, l_crbs // step), nvrb)
    off = _put(bits, off, riv, _ceil_log2(nvrb * (nvrb + 1) // 2))
    off = _put(bits, off, tbs_idx, 5)
    return bits


def unpack_dl_1c(bits: np.ndarray, n_prb: int):
    step = 2 if n_prb < 50 else 4
    nvrb = n_prb // step
    off = 0
    if n_prb >= 50:
        _, off = _get(bits, off, 1)
    riv, off = _get(bits, off, _ceil_log2(nvrb * (nvrb + 1) // 2))
    tbs_idx, off = _get(bits, off, 5)
    s, l = ra.riv_decode(riv, nvrb)
    return dict(rb_start=s * step, l_crbs=l * step, tbs_idx=tbs_idx)


def pack_dl_1bd(d: DciDl, n_prb: int, fmt: str, tpmi: int = 0,
                extra_bit: int = 0) -> np.ndarray:
    """Formats 1B (rank-1 w/ PMI, TM6) and 1D (MU-MIMO, TM5).
    extra_bit = PMI confirmation (1B) or DL power offset (1D)."""
    bits = np.zeros(format1bd_len(n_prb), dtype=np.int8)
    off = 0
    off = _put(bits, off, 0, 1)  # localized
    off = _put(bits, off, ra.riv_encode(d.rb_start, d.l_crbs, n_prb),
               riv_len(n_prb))
    off = _put(bits, off, d.mcs, 5)
    off = _put(bits, off, d.harq_pid, 3)
    off = _put(bits, off, d.ndi, 1)
    off = _put(bits, off, d.rv, 2)
    off = _put(bits, off, d.tpc, 2)
    off = _put(bits, off, tpmi, 2)
    off = _put(bits, off, extra_bit, 1)
    return bits


def unpack_dl_1bd(bits: np.ndarray, n_prb: int, fmt: str):
    off = 0
    _, off = _get(bits, off, 1)
    riv, off = _get(bits, off, riv_len(n_prb))
    mcs, off = _get(bits, off, 5)
    harq, off = _get(bits, off, 3)
    ndi, off = _get(bits, off, 1)
    rv, off = _get(bits, off, 2)
    tpc, off = _get(bits, off, 2)
    tpmi, off = _get(bits, off, 2)
    extra, off = _get(bits, off, 1)
    s, l = ra.riv_decode(riv, n_prb)
    d = DciDl(fmt, mcs, harq, ndi, rv, tpc, rb_start=s, l_crbs=l)
    return d, tpmi, extra


def pack_dl_2(d: DciDl2, n_prb: int) -> np.ndarray:
    bits = np.zeros(format2_len(n_prb, d.format), dtype=np.int8)
    off = 0
    if n_prb > 10:
        off = _put(bits, off, 0, 1)  # RA type 0
    off = _put(bits, off, d.rbg_bitmap, _rbg_bits(n_prb))
    off = _put(bits, off, d.tpc, 2)
    off = _put(bits, off, d.harq_pid, 3)
    off = _put(bits, off, d.cw_swap, 1)
    off = _put(bits, off, d.mcs1, 5)
    off = _put(bits, off, d.ndi1, 1)
    off = _put(bits, off, d.rv1, 2)
    off = _put(bits, off, d.mcs2, 5)
    off = _put(bits, off, d.ndi2, 1)
    off = _put(bits, off, d.rv2, 2)
    if d.format == "2":
        off = _put(bits, off, d.precoding_info, 3)
    elif d.format == "2B":
        off = _put(bits, off, d.n_scid, 1)
    return bits


def unpack_dl_2(bits: np.ndarray, n_prb: int, fmt: str) -> DciDl2:
    off = 0
    if n_prb > 10:
        _, off = _get(bits, off, 1)
    bitmap, off = _get(bits, off, _rbg_bits(n_prb))
    tpc, off = _get(bits, off, 2)
    harq, off = _get(bits, off, 3)
    swap, off = _get(bits, off, 1)
    mcs1, off = _get(bits, off, 5)
    ndi1, off = _get(bits, off, 1)
    rv1, off = _get(bits, off, 2)
    mcs2, off = _get(bits, off, 5)
    ndi2, off = _get(bits, off, 1)
    rv2, off = _get(bits, off, 2)
    d = DciDl2(fmt, bitmap, tpc, harq, swap, mcs1, ndi1, rv1, mcs2, ndi2, rv2)
    if fmt == "2":
        d.precoding_info, off = _get(bits, off, 3)
    elif fmt == "2B":
        d.n_scid, off = _get(bits, off, 1)
    return d
