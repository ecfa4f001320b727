"""36.211 scrambling (bits and LLRs) on top of the Gold-sequence op.

Twin of the reference's `ops/scrambling.py`.  A scrambling sequence depends
only on (c_init, length), so for an integer c_init it is built once per
device and cached.
"""

from __future__ import annotations

import functools

import torch

from . import sequence


def pdsch_cinit(rnti, q, sf_idx, cell_id):
    return (rnti << 14) + (q << 13) + (sf_idx << 9) + cell_id


@functools.lru_cache(maxsize=64)
def _cached_sequence(c_init: int, n: int, device: torch.device) -> torch.Tensor:
    return sequence.gold_sequence(c_init, n, device)


def _sequence(c_init, n: int, device) -> torch.Tensor:
    if isinstance(c_init, int):
        return _cached_sequence(c_init, n, device)
    return sequence.gold_sequence(c_init, n, device)


def scramble_bits(bits: torch.Tensor, c_init) -> torch.Tensor:
    """bits (..., E) ^ c(n).  c_init may be batched (leading dims must agree)."""
    return bits ^ _sequence(c_init, bits.shape[-1], bits.device).to(bits.dtype)


def scramble_llrs(llrs: torch.Tensor, c_init) -> torch.Tensor:
    """Descramble soft values: flip sign where c(n)==1 (scrambling.c float path)."""
    c = _sequence(c_init, llrs.shape[-1], llrs.device)
    return llrs * (1.0 - 2.0 * c.to(llrs.dtype))
