"""AES-128 in plain Python (FIPS-197): one-block encryption, the CTR
keystream (NIST SP 800-38A, a 128-bit big-endian counter) and CMAC
(RFC 4493).  Bytes in, bytes out.

The LTE security algorithms (`security.py`: Milenage, 128-EEA2, 128-EIA2)
need only the forward cipher.  Encryption runs on 32-bit words through the
four round tables of the FIPS-197 §5.2 "T-table" formulation; expanded keys
are cached per key.
"""

from __future__ import annotations

import functools


def _xtime(a: int) -> int:
    a <<= 1
    return (a ^ 0x11B) if a & 0x100 else a


def _gmul(a: int, b: int) -> int:
    p = 0
    while b:
        if b & 1:
            p ^= a
        a = _xtime(a)
        b >>= 1
    return p


def _sbox() -> list:
    """FIPS-197 §5.1.1: multiplicative inverse in GF(2^8), then the affine map."""
    # inverses through log / antilog tables of the generator 3
    exp, log, p = [0] * 255, [0] * 256, 1
    for i in range(255):
        exp[i], log[p] = p, i
        p ^= _xtime(p)
    inv = [0] + [exp[(255 - log[a]) % 255] for a in range(1, 256)]
    out = []
    for a in range(256):
        x = inv[a]
        s = x
        for r in range(1, 5):
            s ^= ((x << r) | (x >> (8 - r))) & 0xFF
        out.append(s ^ 0x63)
    return out


SBOX = _sbox()
# round tables: column (2s, s, s, 3s) rotated per byte position (MixColumns
# of one S-box output, as a 32-bit big-endian word)
_T0 = [(_gmul(s, 2) << 24) | (s << 16) | (s << 8) | _gmul(s, 3) for s in SBOX]
_T1 = [((t >> 8) | (t << 24)) & 0xFFFFFFFF for t in _T0]
_T2 = [((t >> 16) | (t << 16)) & 0xFFFFFFFF for t in _T0]
_T3 = [((t >> 24) | (t << 8)) & 0xFFFFFFFF for t in _T0]
_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36]


@functools.lru_cache(maxsize=64)
def _expand(key: bytes) -> tuple:
    """FIPS-197 §5.2 key expansion for a 16-byte key: 44 words."""
    if len(key) != 16:
        raise ValueError(f"AES-128 key must be 16 bytes, got {len(key)}")
    w = [int.from_bytes(key[4 * i : 4 * i + 4], "big") for i in range(4)]
    for i in range(4, 44):
        t = w[i - 1]
        if i % 4 == 0:
            t = ((t << 8) | (t >> 24)) & 0xFFFFFFFF  # RotWord
            t = ((SBOX[t >> 24] << 24) | (SBOX[(t >> 16) & 0xFF] << 16)
                 | (SBOX[(t >> 8) & 0xFF] << 8) | SBOX[t & 0xFF])
            t ^= _RCON[i // 4 - 1] << 24
        w.append(w[i - 4] ^ t)
    return tuple(w)


def _encrypt_words(w: tuple, s0: int, s1: int, s2: int, s3: int) -> tuple:
    s0 ^= w[0]
    s1 ^= w[1]
    s2 ^= w[2]
    s3 ^= w[3]
    for r in range(1, 10):
        k = 4 * r
        t0 = (_T0[s0 >> 24] ^ _T1[(s1 >> 16) & 0xFF] ^ _T2[(s2 >> 8) & 0xFF]
              ^ _T3[s3 & 0xFF] ^ w[k])
        t1 = (_T0[s1 >> 24] ^ _T1[(s2 >> 16) & 0xFF] ^ _T2[(s3 >> 8) & 0xFF]
              ^ _T3[s0 & 0xFF] ^ w[k + 1])
        t2 = (_T0[s2 >> 24] ^ _T1[(s3 >> 16) & 0xFF] ^ _T2[(s0 >> 8) & 0xFF]
              ^ _T3[s1 & 0xFF] ^ w[k + 2])
        t3 = (_T0[s3 >> 24] ^ _T1[(s0 >> 16) & 0xFF] ^ _T2[(s1 >> 8) & 0xFF]
              ^ _T3[s2 & 0xFF] ^ w[k + 3])
        s0, s1, s2, s3 = t0, t1, t2, t3
    # last round: SubBytes, ShiftRows, AddRoundKey (no MixColumns)
    S = SBOX

    def last(a, b, c, d, kw):
        return ((S[a >> 24] << 24) | (S[(b >> 16) & 0xFF] << 16)
                | (S[(c >> 8) & 0xFF] << 8) | S[d & 0xFF]) ^ kw

    return (last(s0, s1, s2, s3, w[40]), last(s1, s2, s3, s0, w[41]),
            last(s2, s3, s0, s1, w[42]), last(s3, s0, s1, s2, w[43]))


def encrypt_block(key: bytes, block: bytes) -> bytes:
    """AES-128 encryption of one 16-byte block (ECB of a single block)."""
    if len(block) != 16:
        raise ValueError(f"AES block must be 16 bytes, got {len(block)}")
    x = int.from_bytes(block, "big")
    out = _encrypt_words(_expand(bytes(key)), x >> 96, (x >> 64) & 0xFFFFFFFF,
                         (x >> 32) & 0xFFFFFFFF, x & 0xFFFFFFFF)
    return ((out[0] << 96) | (out[1] << 64) | (out[2] << 32) | out[3]).to_bytes(16, "big")


def ctr(key: bytes, iv: bytes, data: bytes) -> bytes:
    """AES-128-CTR: data XOR the keystream E(iv), E(iv + 1), ... with the
    whole 16-byte counter block incremented as one big-endian integer."""
    n = len(data)
    if not n:
        return b""
    ctr0 = int.from_bytes(iv, "big")
    ks = b"".join(encrypt_block(key, ((ctr0 + i) % (1 << 128)).to_bytes(16, "big"))
                  for i in range(-(-n // 16)))
    return (int.from_bytes(data, "big") ^ int.from_bytes(ks[:n], "big")).to_bytes(n, "big")


def _dbl(b: bytes) -> bytes:
    """Doubling in GF(2^128) with R_b = 0x87 (RFC 4493 §2.3)."""
    x = int.from_bytes(b, "big") << 1
    if x >> 128:
        x = (x ^ 0x87) & ((1 << 128) - 1)
    return x.to_bytes(16, "big")


def cmac(key: bytes, msg: bytes) -> bytes:
    """AES-CMAC (RFC 4493): the full 16-byte tag."""
    k1 = _dbl(encrypt_block(key, bytes(16)))
    k2 = _dbl(k1)
    msg = bytes(msg)
    n = max(1, -(-len(msg) // 16))
    last = msg[16 * (n - 1):]
    if len(last) == 16:
        last = bytes(a ^ b for a, b in zip(last, k1))
    else:
        padded = last + b"\x80" + bytes(15 - len(last))
        last = bytes(a ^ b for a, b in zip(padded, k2))
    x = bytes(16)
    for i in range(n - 1):
        x = encrypt_block(key, bytes(a ^ b for a, b in zip(x, msg[16 * i : 16 * i + 16])))
    return encrypt_block(key, bytes(a ^ b for a, b in zip(x, last)))
