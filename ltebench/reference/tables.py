"""Host tables of the plain LTE reference, from 3GPP TS 36.211 and 36.212.

Everything here is numpy, built once per configuration: the Gold sequence
(36.211 7.2), the cell-specific reference signal of antenna port 0 (6.10.1),
the PDSCH resource elements (6.3.5), the OFDM subcarrier and cyclic-prefix
layout (6.12), code-block segmentation (36.212 5.1.2), the QPP interleaver
(5.1.3.2.3), the turbo code's sub-block interleaver and circular buffer
(5.1.4.1), and CRC remainders (5.1.1).  Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

MAX_PRB = 110
N_SYM = 14  # normal cyclic prefix
CRS_SYMS = (0, 4, 7, 11)  # port 0, normal CP
FFT_SIZE = {6: 128, 15: 256, 25: 512, 50: 1024, 75: 1536, 100: 2048}
CRC24A = (0x1864CFB, 24)
CRC24B = (0x1800063, 24)
CB_CRC = 24
FILLER_LLR = 127.0  # a known-zero filler bit's LLR in the decoder's input


@dataclasses.dataclass(frozen=True)
class Link:
    """One PDSCH link as a configuration file states it (port 0, normal CP,
    every PRB allocated, redundancy version 0, no soft-buffer limit)."""
    n_prb: int
    cell_id: int
    cfi: int
    sf_idx: int
    rnti: int
    qm: int
    code_rate: float
    max_iter: int
    llr_bits: int

    @property
    def nre(self) -> int:
        return 12 * self.n_prb

    @functools.cached_property
    def re_idx(self) -> np.ndarray:
        return pdsch_re(self.n_prb, self.cell_id, self.cfi, self.sf_idx)

    @property
    def G(self) -> int:
        return len(self.re_idx) * self.qm

    @property
    def tbs(self) -> int:
        """The largest multiple of 8 whose rate, TB CRC included, is at most code_rate."""
        return max(8, (int(self.G * self.code_rate) - 24) // 8 * 8)

    @functools.cached_property
    def segm(self):
        return segmentation(self.tbs)

    @functools.cached_property
    def e_sizes(self) -> list:
        """36.212 5.1.4.1.2: E_r of each code block (one layer)."""
        C = self.segm.C
        gp = self.G // self.qm
        gamma = gp % C
        return [self.qm * (gp // C) if r <= C - gamma - 1 else self.qm * -(-gp // C)
                for r in range(C)]


def gold(c_init: int, n: int) -> np.ndarray:
    """36.211 7.2: c(0..n-1), 28 steps of both LFSRs at a time."""
    nc = 1600
    total = nc + n
    x1 = np.zeros(total + 31, np.uint8)
    x2 = np.zeros(total + 31, np.uint8)
    x1[0] = 1
    x2[:31] = (c_init >> np.arange(31)) & 1
    for s in range(0, total, 28):
        e = min(s + 28, total)
        x1[s + 31:e + 31] = x1[s + 3:e + 3] ^ x1[s:e]
        x2[s + 31:e + 31] = x2[s + 3:e + 3] ^ x2[s + 2:e + 2] ^ x2[s + 1:e + 1] ^ x2[s:e]
    return x1[nc:total] ^ x2[nc:total]


@functools.lru_cache(maxsize=None)
def crs(n_prb: int, cell_id: int, sf_idx: int):
    """Port 0's pilots: for each pilot symbol (CRS_SYMS), the subcarriers
    (2 n_prb,) and the values (2 n_prb,) complex128."""
    out = []
    for l_sf in CRS_SYMS:
        ns, l = 2 * sf_idx + l_sf // 7, l_sf % 7
        c = gold(1024 * (7 * (ns + 1) + l + 1) * (2 * cell_id + 1) + 2 * cell_id + 1,
                 4 * MAX_PRB).astype(np.float64)
        m = np.arange(2 * n_prb) + MAX_PRB - n_prb
        r = ((1 - 2 * c[2 * m]) + 1j * (1 - 2 * c[2 * m + 1])) / np.sqrt(2)
        v = 0 if l == 0 else 3
        out.append((6 * np.arange(2 * n_prb) + (v + cell_id % 6) % 6, r))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def pdsch_re(n_prb: int, cell_id: int, cfi: int, sf_idx: int) -> np.ndarray:
    """Flat indices sym * NRE + k of the PDSCH's REs in mapping order:
    frequency first, symbols after the control region, port 0's CRS left
    out.  Subframes 0 and 5 (PSS, SSS, PBCH) are not modelled."""
    if sf_idx % 5 == 0:
        raise ValueError("the reference models no PSS, SSS or PBCH: use a subframe other than 0, 5")
    nre = 12 * n_prb
    taken = np.zeros((N_SYM, nre), bool)
    for l_sf, (k, _) in zip(CRS_SYMS, crs(n_prb, cell_id, sf_idx)):
        taken[l_sf, k] = True
    n_ctrl = cfi + (1 if n_prb <= 10 else 0)
    return np.concatenate([l * nre + np.flatnonzero(~taken[l])
                           for l in range(n_ctrl, N_SYM)]).astype(np.int64)


def ofdm_layout(n_prb: int):
    """(FFT size, the FFT bin of each subcarrier, the CP length of each symbol)."""
    n = FFT_SIZE[n_prb]
    nre = 12 * n_prb
    k = np.arange(nre)
    bins = np.where(k < nre // 2, k - nre // 2 + n, k - nre // 2 + 1)
    cps = [(160 if l % 7 == 0 else 144) * n // 2048 for l in range(N_SYM)]
    return n, bins, cps


@dataclasses.dataclass(frozen=True)
class Segm:
    C: int
    F: int
    sizes: tuple  # K of each code block, K- first


# 36.212 Table 5.1.3-3: the 188 code-block sizes and their QPP (f1, f2)
CB_SIZES = np.array([40 + 8 * i for i in range(59)] + [512 + 16 * i for i in range(32)]
                    + [1024 + 32 * i for i in range(32)] + [2048 + 64 * i for i in range(65)])
F1 = np.array([
    3, 7, 19, 7, 7, 11, 5, 11, 7, 41, 103, 15, 9, 17, 9, 21, 101, 21, 57, 23,
    13, 27, 11, 27, 85, 29, 33, 15, 17, 33, 103, 19, 19, 37, 19, 21, 21, 115,
    193, 21, 133, 81, 45, 23, 243, 151, 155, 25, 51, 47, 91, 29, 29, 247, 29,
    89, 91, 157, 55, 31, 17, 35, 227, 65, 19, 37, 41, 39, 185, 43, 21, 155, 79,
    139, 23, 217, 25, 17, 127, 25, 239, 17, 137, 215, 29, 15, 147, 29, 59, 65,
    55, 31, 17, 171, 67, 35, 19, 39, 19, 199, 21, 211, 21, 43, 149, 45, 49, 71,
    13, 17, 25, 183, 55, 127, 27, 29, 29, 57, 45, 31, 59, 185, 113, 31, 17,
    171, 209, 253, 367, 265, 181, 39, 27, 127, 143, 43, 29, 45, 157, 47, 13,
    111, 443, 51, 51, 451, 257, 57, 313, 271, 179, 331, 363, 375, 127, 31, 33,
    43, 33, 477, 35, 233, 357, 337, 37, 71, 71, 37, 39, 127, 39, 39, 31, 113,
    41, 251, 43, 21, 43, 45, 45, 161, 89, 323, 47, 23, 47, 263])
F2 = np.array([
    10, 12, 42, 16, 18, 20, 22, 24, 26, 84, 90, 32, 34, 108, 38, 120, 84, 44,
    46, 48, 50, 52, 36, 56, 58, 60, 62, 32, 198, 68, 210, 36, 74, 76, 78, 120,
    82, 84, 86, 44, 90, 46, 94, 48, 98, 40, 102, 52, 106, 72, 110, 168, 114,
    58, 118, 180, 122, 62, 84, 64, 66, 68, 420, 96, 74, 76, 234, 80, 82, 252,
    86, 44, 120, 92, 94, 48, 98, 80, 102, 52, 106, 48, 110, 112, 114, 58, 118,
    60, 122, 124, 84, 64, 66, 204, 140, 72, 74, 76, 78, 240, 82, 252, 86, 88,
    60, 92, 846, 48, 28, 80, 102, 104, 954, 96, 110, 112, 114, 116, 354, 120,
    610, 124, 420, 64, 66, 136, 420, 216, 444, 456, 468, 80, 164, 504, 172, 88,
    300, 92, 188, 96, 28, 240, 204, 104, 212, 192, 220, 336, 228, 232, 236,
    120, 244, 248, 168, 64, 130, 264, 134, 408, 138, 280, 142, 480, 146, 444,
    120, 152, 462, 234, 158, 80, 96, 902, 166, 336, 170, 86, 174, 176, 178,
    120, 182, 184, 186, 94, 190, 480])


@functools.lru_cache(maxsize=None)
def segmentation(tbs: int) -> Segm:
    """36.212 5.1.2 for a transport block of tbs bits plus its CRC24A."""
    B = tbs + 24
    if B <= 6144:
        C, Bp = 1, B
    else:
        C = -(-B // (6144 - CB_CRC))
        Bp = B + C * CB_CRC
    i = int(np.searchsorted(CB_SIZES, -(-Bp // C)))
    k_plus = int(CB_SIZES[i])
    if C == 1:
        c_minus, k_minus = 0, 0
    else:
        k_minus = int(CB_SIZES[i - 1])
        c_minus = (C * k_plus - Bp) // (k_plus - k_minus)
    F = (C - c_minus) * k_plus + c_minus * k_minus - Bp
    return Segm(C, F, (k_minus,) * c_minus + (k_plus,) * (C - c_minus))


@functools.lru_cache(maxsize=None)
def qpp(k: int) -> np.ndarray:
    i = int(np.flatnonzero(CB_SIZES == k)[0])
    n = np.arange(k, dtype=np.int64)
    return (int(F1[i]) * n + int(F2[i]) * n * n) % k


PERM32 = np.array([0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
                   1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31])
NULL = -1


@functools.lru_cache(maxsize=None)
def circular_buffer(k: int, f: int) -> np.ndarray:
    """36.212 5.1.4.1.1-2: w_k of the circular buffer (3 Kp,) as the index
    stream * D + i into d0|d1|d2 (D = k + 4), NULL for a dummy or filler bit."""
    D = k + 4
    R = -(-D // 32)
    Kp = 32 * R
    nd = Kp - D

    def y(stream):
        src = stream * D + np.arange(D)
        if stream < 2:
            src[:f] = NULL  # the fillers of d0 and d1
        return np.concatenate([np.full(nd, NULL), src])

    v = [y(s).reshape(R, 32)[:, PERM32].T.reshape(-1) for s in (0, 1)]
    n = np.arange(Kp)
    v.append(y(2)[(PERM32[n // R] + 32 * (n % R) + 1) % Kp])
    w = np.empty(3 * Kp, np.int64)
    w[:Kp] = v[0]
    w[Kp::2] = v[1]
    w[Kp + 1::2] = v[2]
    return w


@functools.lru_cache(maxsize=None)
def selection(k: int, f: int, e: int, rv: int = 0) -> np.ndarray:
    """36.212 5.1.4.1.2 with N_cb = 3 Kp: the circular-buffer positions that
    bits e_0..e_{E-1} are read from, NULLs skipped."""
    w = circular_buffer(k, f)
    R = len(w) // 96
    k0 = R * (2 * -(-len(w) // (8 * R)) * rv + 2)
    pos = np.roll(np.arange(len(w)), -k0)
    pos = pos[w[pos] != NULL]
    return pos[np.arange(e) % len(pos)]


@functools.lru_cache(maxsize=None)
def crc_matrix(poly: int, order: int, n: int) -> np.ndarray:
    """(n, order) float64: row i holds the bits, most significant first, of
    x^(n - 1 - i + order) mod g(x); a message's CRC is its bits times this
    matrix, mod 2."""
    m = np.zeros((n, order))
    state = poly & ((1 << order) - 1)  # x^order mod g
    shifts = np.arange(order - 1, -1, -1)
    for d in range(n):
        m[n - 1 - d] = (state >> shifts) & 1
        state <<= 1
        if state >> order & 1:
            state ^= poly
    return m


@functools.lru_cache(maxsize=None)
def trellis():
    """The 8-state constituent code (state r0 * 4 + r1 * 2 + r2): next state
    and parity of each (state, input), and each state's tail-bit signs."""
    ns = np.zeros((8, 2), np.int64)
    pz = np.zeros((8, 2), np.int64)
    tails = np.zeros((8, 6), np.float32)
    for s in range(8):
        r0, r1, r2 = s >> 2 & 1, s >> 1 & 1, s & 1
        for u in (0, 1):
            a = u ^ r1 ^ r2
            ns[s, u] = a * 4 + r0 * 2 + r1
            pz[s, u] = u ^ r0 ^ r1
        t = s
        for step in range(3):
            r0, r1, r2 = t >> 2 & 1, t >> 1 & 1, t & 1
            tails[s, 2 * step] = 1 - 2 * (r1 ^ r2)
            tails[s, 2 * step + 1] = 1 - 2 * (r0 ^ r2)
            t = r0 * 2 + r1
    return ns, pz, tails
