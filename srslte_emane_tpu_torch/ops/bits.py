"""Bit pack/unpack ops (the `lib/src/phy/utils/bit.c` role).

Twin of the reference's `ops/bits.py`: conversions between byte payloads
and 0/1 bit tensors, MSB first (srslte_bit_unpack_vector), on the tensor's
device, plus the numpy host helpers.
"""

from __future__ import annotations

import numpy as np
import torch


def unpack_bits(bytes_arr: torch.Tensor) -> torch.Tensor:
    """(..., N) uint8 -> (..., N*8) int8 bits, MSB first."""
    b = bytes_arr.to(torch.uint8)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=b.device)
    bits = (b[..., None] >> shifts) & 1
    return bits.reshape(b.shape[:-1] + (-1,)).to(torch.int8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., N*8) bits -> (..., N) uint8, MSB first."""
    x = bits.to(torch.int32)
    x = x.reshape(x.shape[:-1] + (-1, 8))
    weights = 2 ** torch.arange(7, -1, -1, dtype=torch.int32, device=x.device)
    return (x * weights).sum(dim=-1).to(torch.uint8)


def bytes_to_bits(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, dtype=np.uint8)).astype(np.int8)


def bits_to_bytes(bits) -> bytes:
    return np.packbits(np.asarray(bits, dtype=np.uint8)).tobytes()
