"""LTE CRC attach/check as batched GF(2) products.

Twin of the reference's `ops/fec/crc.py`.  With zero initial state the CRC
is linear over GF(2): crc(m) = XOR_{i : m_i = 1} (x^(L-1-i+order) mod g), so
a batch of length-L messages is one float32 product (B, L) @ (L, order)
followed by mod 2.  The popcount sums are at most L <= 49,496 < 2^24, so the
float32 accumulation is exact in any order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...utils.devices import table_cache

# polynomial bitmasks include the leading x^order term
LTE_CRC24A = (0x1864CFB, 24)
LTE_CRC24B = (0x1800063, 24)
LTE_CRC16 = (0x11021, 16)
LTE_CRC8 = (0x19B, 8)


@functools.lru_cache(maxsize=None)
def _remainder_matrix(poly: int, order: int, length: int) -> np.ndarray:
    """R[i, :] = bits (MSB-first) of x^(length-1-i+order) mod g."""
    rem = np.zeros((length, order), dtype=np.int8)
    # state = x^order mod g  (polynomial bits, index j == coeff of x^j)
    state = poly & ((1 << order) - 1)
    for d in range(length):
        rem[length - 1 - d, :] = [(state >> (order - 1 - b)) & 1 for b in range(order)]
        # multiply by x: shift, reduce
        state <<= 1
        if state >> order & 1:
            state ^= poly
        state &= (1 << order) - 1
    return rem


@table_cache(128)
def _device_matrix(poly: int, order: int, length: int, device: torch.device):
    return torch.from_numpy(
        _remainder_matrix(poly, order, length).astype(np.float32)).to(device)


@table_cache(128)
def remainder_masks(poly: int, order: int, length: int, device: torch.device) -> torch.Tensor:
    """The rows of `_remainder_matrix` packed MSB-first into int32 words,
    (length,) on `device` (copied there once): the CRC of a length-bit
    message is the XOR of the words of its set bits (`crc_remainder`), as
    the turbo decoder's epilogue kernel computes it."""
    rows = _remainder_matrix(poly, order, length).astype(np.int64)
    words = rows @ (1 << np.arange(order - 1, -1, -1, dtype=np.int64))
    return torch.from_numpy(words.astype(np.int32)).to(device)


def crc_remainder(bits: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """(..., L) 0/1 bits -> (...,) int32: the XOR of `masks` (L,) over the
    set bits, i.e. the packed CRC remainder; 0 iff the CRC passes."""
    x = torch.where(bits != 0, masks, 0)
    n = x.shape[-1]
    while n > 1:  # a tree of halvings; an odd length keeps its last word
        half = n // 2
        folded = x[..., :half] ^ x[..., half:2 * half]
        x = torch.cat([folded, x[..., 2 * half:]], dim=-1) if n % 2 else folded
        n = x.shape[-1]
    return x[..., 0] if n else torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)


def crc_bits(bits: torch.Tensor, crc=LTE_CRC24A) -> torch.Tensor:
    """CRC of batched bit messages: (..., L) 0/1 -> (..., order) int8 bits,
    MSB-first (`srslte_crc_attach` bit order)."""
    poly, order = crc
    r = _device_matrix(poly, order, bits.shape[-1], bits.device)
    acc = bits.to(torch.float32) @ r
    return torch.remainder(acc, 2.0).to(torch.int8)


def crc_attach(bits: torch.Tensor, crc=LTE_CRC24A) -> torch.Tensor:
    """Append CRC bits: (..., L) -> (..., L + order)."""
    return torch.cat([bits, crc_bits(bits, crc).to(bits.dtype)], dim=-1)


def crc_ok(bits_with_crc: torch.Tensor, crc=LTE_CRC24A) -> torch.Tensor:
    """True where crc(m || crc(m)) == 0, over (..., L+order)."""
    return (crc_bits(bits_with_crc, crc) == 0).all(dim=-1)


def crc_host(bits: np.ndarray, crc=LTE_CRC24A) -> np.ndarray:
    """NumPy oracle: bit-serial LFSR CRC (the reference algorithm)."""
    poly, order = crc
    reg = 0
    for b in np.asarray(bits).astype(np.int64):
        reg = (reg << 1) | int(b)
        if (reg >> order) & 1:
            reg ^= poly
    # flush `order` zero bits
    for _ in range(order):
        reg <<= 1
        if (reg >> order) & 1:
            reg ^= poly
    reg &= (1 << order) - 1
    return np.array([(reg >> (order - 1 - i)) & 1 for i in range(order)], dtype=np.int8)
