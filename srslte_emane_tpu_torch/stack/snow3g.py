"""SNOW 3G stream cipher + UEA2/UIA2 modes (128-EEA1 / 128-EIA1).

Implemented from the public ETSI/SAGE SNOW 3G specification (the algorithm
the reference wraps in `lib/src/common/snow_3g.cc`); S-box constants are spec
data (snow3g_tables.npz).  Validated against the 3GPP 35.203/35.204 test sets
(tests/test_snow3g.py).

Structure: 16x32-bit LFSR over GF(2^32) via MULalpha/DIValpha byte maps,
3-register FSM with S1 (Rijndael-based) and S2 (Dickson-based) substitutions.
Keystream generation is word-serial (control-plane message sizes); the byte
maps are precomputed tables so each clock is table lookups + xors.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np

_T = np.load(pathlib.Path(__file__).parent / "snow3g_tables.npz")
SR = _T["SR"].astype(np.uint32)
SQ = _T["SQ"].astype(np.uint32)

M32 = 0xFFFFFFFF


def _mulx(v: int, c: int) -> int:
    return ((v << 1) ^ c) & 0xFF if v & 0x80 else (v << 1) & 0xFF


def _mulxpow(v: int, i: int, c: int) -> int:
    for _ in range(i):
        v = _mulx(v, c)
    return v


@functools.lru_cache(maxsize=None)
def _alpha_tables():
    mula = np.zeros(256, dtype=np.uint32)
    diva = np.zeros(256, dtype=np.uint32)
    for b in range(256):
        mula[b] = ((_mulxpow(b, 23, 0xA9) << 24) | (_mulxpow(b, 245, 0xA9) << 16)
                   | (_mulxpow(b, 48, 0xA9) << 8) | _mulxpow(b, 239, 0xA9))
        diva[b] = ((_mulxpow(b, 16, 0xA9) << 24) | (_mulxpow(b, 39, 0xA9) << 16)
                   | (_mulxpow(b, 6, 0xA9) << 8) | _mulxpow(b, 64, 0xA9))
    return mula, diva


@functools.lru_cache(maxsize=None)
def _sbox_word_tables():
    """32-bit lookup tables for S1/S2 applied per input byte position, so a
    substitution is 4 lookups + 3 xors (the MixColumn fold precomputed)."""
    def build(box, c):
        t = np.zeros((4, 256), dtype=np.uint32)
        for b in range(256):
            s = int(box[b])
            sx = _mulx(s, c)
            # contribution of input byte at position p (0 = MSB) to the word
            # r0..r3 per the spec's MixColumn-style diffusion
            t[0, b] = (sx << 24) | ((sx ^ s) << 16) | (s << 8) | s
            t[1, b] = (s << 24) | (sx << 16) | ((sx ^ s) << 8) | s
            t[2, b] = (s << 24) | (s << 16) | (sx << 8) | (sx ^ s)
            t[3, b] = ((sx ^ s) << 24) | (s << 16) | (s << 8) | sx
        return t
    return build(SR, 0x1B), build(SQ, 0x69)


class Snow3G:
    def __init__(self, k: list, iv: list):
        t1, t2 = _sbox_word_tables()
        self.t1, self.t2 = t1, t2
        mula, diva = _alpha_tables()
        self.mula, self.diva = mula, diva
        s = [0] * 16
        ones = 0xFFFFFFFF
        s[15], s[14], s[13], s[12] = k[3] ^ iv[0], k[2], k[1], k[0] ^ iv[1]
        s[11], s[10], s[9], s[8] = k[3] ^ ones, k[2] ^ ones ^ iv[2], k[1] ^ ones ^ iv[3], k[0] ^ ones
        s[7], s[6], s[5], s[4] = k[3], k[2], k[1], k[0]
        s[3], s[2], s[1], s[0] = k[3] ^ ones, k[2] ^ ones, k[1] ^ ones, k[0] ^ ones
        self.s = s
        self.r1 = self.r2 = self.r3 = 0
        for _ in range(32):
            f = self._clock_fsm()
            self._clock_lfsr(f)

    def _sub(self, t, w):
        return int(t[0, (w >> 24) & 0xFF] ^ t[1, (w >> 16) & 0xFF]
                   ^ t[2, (w >> 8) & 0xFF] ^ t[3, w & 0xFF])

    def _clock_fsm(self):
        f = ((self.s[15] + self.r1) & M32) ^ self.r2
        r = (self.r2 + (self.r3 ^ self.s[5])) & M32
        self.r3 = self._sub(self.t2, self.r2)
        self.r2 = self._sub(self.t1, self.r1)
        self.r1 = r
        return f

    def _clock_lfsr(self, f=None):
        s = self.s
        v = (((s[0] << 8) & 0xFFFFFF00) ^ int(self.mula[(s[0] >> 24) & 0xFF])
             ^ s[2] ^ ((s[11] >> 8) & 0x00FFFFFF) ^ int(self.diva[s[11] & 0xFF]))
        if f is not None:
            v ^= f
        self.s = s[1:] + [v & M32]

    def keystream(self, n: int) -> list:
        self._clock_fsm()  # first clock discarded (spec §4.2)
        self._clock_lfsr()
        out = []
        for _ in range(n):
            f = self._clock_fsm()
            out.append((f ^ self.s[0]) & M32)
            self._clock_lfsr()
        return out


def _key_words(key: bytes) -> list:
    # K[3] = first 4 bytes (MSB first) ... K[0] = last (spec §3.4/4.4 loading)
    w = [int.from_bytes(key[4 * i : 4 * i + 4], "big") for i in range(4)]
    return [w[3], w[2], w[1], w[0]]


def eea1(key: bytes, count: int, bearer: int, direction: int, data: bytes) -> bytes:
    """UEA2/128-EEA1 encryption (f8)."""
    k = _key_words(key)
    iv3 = count & M32
    iv2 = ((bearer & 0x1F) << 27) | ((direction & 1) << 26)
    iv = [iv2, iv3, iv2, iv3]
    n_words = (len(data) + 3) // 4
    ks = Snow3G(k, iv).keystream(n_words)
    ks_bytes = b"".join(w.to_bytes(4, "big") for w in ks)[: len(data)]
    return bytes(a ^ b for a, b in zip(data, ks_bytes))


def _mul64(v: int, p: int, c: int = 0x1B) -> int:
    """Carryless multiply in GF(2^64) mod (x^64 + c-poly) (spec §4.3.2)."""
    result = 0
    m = (1 << 64) - 1
    for i in range(64):
        if (p >> i) & 1:
            result ^= v
        v = ((v << 1) ^ c) & m if v & (1 << 63) else (v << 1) & m
    return result


def eia1(key: bytes, count: int, fresh: int, direction: int, data: bytes,
         length_bits: int = None) -> bytes:
    """UIA2/128-EIA1 integrity (f9).  Returns 4-byte MAC-I."""
    k = _key_words(key)
    iv = [
        (fresh ^ ((direction & 1) << 15)) & M32,
        (count ^ ((direction & 1) << 31)) & M32,
        fresh & M32,
        count & M32,
    ]
    z = Snow3G(k, iv).keystream(5)
    p = (z[0] << 32) | z[1]
    q = (z[2] << 32) | z[3]
    length = length_bits if length_bits is not None else 8 * len(data)
    d = length // 64 + (1 if length % 64 == 0 else 2)
    ev = 0
    for i in range(d - 2):
        block = int.from_bytes(data[8 * i : 8 * i + 8], "big")
        ev = _mul64(ev ^ block, p)
    # last (possibly partial) block, zero padded
    rem = data[8 * (d - 2) :].ljust(8, b"\x00")
    rem_bits = length - 64 * (d - 2)
    block = int.from_bytes(rem[:8], "big")
    if rem_bits < 64:
        block &= ((1 << rem_bits) - 1) << (64 - rem_bits) if rem_bits else 0
    ev = _mul64(ev ^ block, p)
    ev ^= length
    ev = _mul64(ev, q)
    mac32 = ((ev >> 32) ^ z[4]) & M32
    return mac32.to_bytes(4, "big")
