"""Resource allocation + MCS/TBS computation (36.213 §7.1.6/7.1.7).

Host-side numpy, copied from the reference's `phch/ra.py` with its table
file `tbs_tables.npz` byte for byte (the port imports nothing of the
reference package; a test holds the two equal).

Reference behavior: `lib/src/phy/phch/{ra.c,ra_dl.c,ra_ul.c}` + the
I_TBS x N_PRB table in `tbs_tables.h` (extracted to tbs_tables.npz by
scripts/extract_tbs_tables.py — pure 3GPP spec data).
"""

from __future__ import annotations

import pathlib

import numpy as np

_DATA = np.load(pathlib.Path(__file__).parent / "tbs_tables.npz")
TBS_TABLE = _DATA["tbs_table"]  # (34, 110): I_TBS x (n_prb - 1)
DL_MCS_TO_ITBS = _DATA["dl_mcs_to_itbs"]  # (29,)
DL_MCS_TO_ITBS_256 = _DATA["dl_mcs_to_itbs_256"]  # (28,)
UL_MCS_TO_ITBS = _DATA["ul_mcs_to_itbs"]  # (29,)


def dl_mcs_to_qm(mcs: int, use_256qam: bool = False) -> int:
    """36.213 Table 7.1.7.1-1 (/-1A) modulation order."""
    if use_256qam:
        if mcs < 5:
            return 2
        if mcs < 11:
            return 4
        if mcs < 20:
            return 6
        if mcs < 28:
            return 8
        raise ValueError(mcs)
    if mcs < 10:
        return 2
    if mcs < 17:
        return 4
    if mcs < 29:
        return 6
    raise ValueError(f"reserved MCS {mcs}")


def ul_mcs_to_qm(mcs: int) -> int:
    if mcs < 11:
        return 2
    if mcs < 21:
        return 4
    if mcs < 29:
        return 6
    raise ValueError(f"reserved MCS {mcs}")


def dl_tbs(mcs: int, n_prb: int, use_256qam: bool = False) -> int:
    itbs = (DL_MCS_TO_ITBS_256 if use_256qam else DL_MCS_TO_ITBS)[mcs]
    return int(TBS_TABLE[itbs, n_prb - 1])


def ul_tbs(mcs: int, n_prb: int) -> int:
    return int(TBS_TABLE[UL_MCS_TO_ITBS[mcs], n_prb - 1])


def dl_tbs_ra_format1a_common(mcs: int, tpc: int) -> int:
    """DCI format 1A addressed to SI/P/RA-RNTI: I_TBS = I_MCS directly and
    the TBS column is N_PRB_1A in {2, 3} from the TPC LSB (36.213 §7.1.7.2),
    regardless of the actual allocation width."""
    n_prb_1a = 2 + (tpc & 1)
    return int(TBS_TABLE[mcs, n_prb_1a - 1])


def rbg_size(n_prb: int) -> int:
    """Type-0 RBG size P (36.213 Table 7.1.6.1-1)."""
    if n_prb <= 10:
        return 1
    if n_prb <= 26:
        return 2
    if n_prb <= 63:
        return 3
    return 4


def type0_to_prb_mask(rbg_bitmap: int, n_prb: int) -> tuple:
    """RBG bitmap (MSB = RBG 0) -> per-PRB mask tuple."""
    p = rbg_size(n_prb)
    n_rbg = -(-n_prb // p)
    mask = [0] * n_prb
    for g in range(n_rbg):
        if (rbg_bitmap >> (n_rbg - 1 - g)) & 1:
            for k in range(g * p, min((g + 1) * p, n_prb)):
                mask[k] = 1
    return tuple(mask)


def riv_encode(rb_start: int, l_crbs: int, n_prb: int) -> int:
    """Type-2 contiguous allocation RIV (36.213 §7.1.6.3)."""
    if l_crbs - 1 <= n_prb // 2:
        return n_prb * (l_crbs - 1) + rb_start
    return n_prb * (n_prb - l_crbs + 1) + (n_prb - 1 - rb_start)


def riv_decode(riv: int, n_prb: int) -> tuple:
    """RIV -> (rb_start, l_crbs)."""
    l = riv // n_prb + 1
    s = riv % n_prb
    if l - 1 <= n_prb // 2 and s + l <= n_prb:
        return s, l
    return n_prb - 1 - s, n_prb - l + 2


def type2_to_prb_mask(rb_start: int, l_crbs: int, n_prb: int) -> tuple:
    return tuple(1 if rb_start <= i < rb_start + l_crbs else 0 for i in range(n_prb))


def type1_to_prb_mask(subset: int, shift: int, bitmap: int, n_prb: int) -> tuple:
    """RA type 1 (36.213 §7.1.6.2 / ra_dl.c type-1 path): the bitmap
    addresses PRBs of RBG-subset `subset`, optionally shifted to cover the
    subset's tail."""
    import math

    p = rbg_size(n_prb)
    n_rbg = -(-n_prb // p)
    subset_prbs = [n for n in range(n_prb) if (n // p) % p == subset]
    # type-1 bitmap is shorter than type-0's by the subset+shift header
    n_type1 = n_rbg - math.ceil(math.log2(p)) - 1
    offset = max(0, len(subset_prbs) - n_type1) if shift else 0
    mask = [0] * n_prb
    for i in range(min(n_type1, len(subset_prbs) - offset)):
        if (bitmap >> (n_type1 - 1 - i)) & 1:
            mask[subset_prbs[offset + i]] = 1
    return tuple(mask)
