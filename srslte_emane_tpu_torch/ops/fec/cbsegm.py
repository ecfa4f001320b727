"""36.212 §5.1.2 code-block segmentation (host-side parameter computation),
copied from the reference package's `ops/fec/cbsegm.py` so that the port
loads nothing of that package.  Segmentation is shape logic: it runs on the
host once per transport-block size and fixes the shapes of the device work.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

# 36.212 Table 5.1.3-3: the 188 valid turbo code block sizes.
TC_CB_SIZES = np.array(
    [40 + 8 * i for i in range(59)]  # 40..504 step 8
    + [512 + 16 * i for i in range(32)]  # 512..1008 step 16
    + [1024 + 32 * i for i in range(32)]  # 1024..2016 step 32
    + [2048 + 64 * i for i in range(64)],  # 2048..6080 step 64
    dtype=np.int64,
)
TC_CB_SIZES = np.append(TC_CB_SIZES, 6144)
assert len(TC_CB_SIZES) == 188 and TC_CB_SIZES[-1] == 6144

MAX_CB_SIZE = 6144
TB_CRC_LEN = 24
CB_CRC_LEN = 24


def cb_size_index(k: int) -> int:
    """Index of K in the CB-size table (reference: srslte_cbsegm_cbindex)."""
    idx = int(np.searchsorted(TC_CB_SIZES, k))
    if idx >= len(TC_CB_SIZES) or TC_CB_SIZES[idx] != k:
        raise ValueError(f"invalid turbo CB size {k}")
    return idx


@dataclasses.dataclass(frozen=True)
class CbSegm:
    tbs: int  # transport block size (payload bits, pre-CRC)
    C: int  # number of code blocks
    C_plus: int  # blocks of size K_plus
    C_minus: int  # blocks of size K_minus
    K_plus: int
    K_minus: int
    F: int  # filler bits (prepended to first CB)

    @property
    def cb_sizes(self) -> list:
        return [self.K_minus] * self.C_minus + [self.K_plus] * self.C_plus


@functools.lru_cache(maxsize=None)
def cbsegm(tbs: int) -> CbSegm:
    """36.212 §5.1.2 — matches srslte_cbsegm (`cbsegm.c:53-110`)."""
    if tbs == 0:
        return CbSegm(0, 0, 0, 0, 0, 0, 0)
    B = tbs + TB_CRC_LEN
    Z = MAX_CB_SIZE
    if B <= Z:
        L = 0
        C = 1
        Bp = B
    else:
        L = CB_CRC_LEN
        C = int(np.ceil(B / (Z - L)))
        Bp = B + C * L
    # first K in table >= Bp / C
    idx1 = int(np.searchsorted(TC_CB_SIZES, int(np.ceil(Bp / C))))
    K_plus = int(TC_CB_SIZES[idx1])
    if C == 1:
        K_minus = 0
        C_plus, C_minus = 1, 0
    else:
        K_minus = int(TC_CB_SIZES[idx1 - 1])
        dK = K_plus - K_minus
        C_minus = (C * K_plus - Bp) // dK
        C_plus = C - C_minus
    F = C_plus * K_plus + C_minus * K_minus - Bp
    return CbSegm(tbs, C, C_plus, C_minus, K_plus, K_minus, F)
