"""36.211 scrambling (bits and LLRs) on top of the Gold-sequence op.

Twin of the reference's `ops/scrambling.py`.  A scrambling sequence depends
only on (c_init, length), so for an integer c_init it is built once per
device and cached.  The c_init helpers take ints or integer tensors (a 0-d
rnti or sf on the device, as a CUDA graph's inputs are): a tensor c_init
is expanded on the device by `sequence.gold_sequence`, to the same bits.
"""

from __future__ import annotations

import torch

from ..utils.devices import table_cache
from . import sequence


def pdsch_cinit(rnti, q, sf_idx, cell_id):
    return (rnti << 14) + (q << 13) + (sf_idx << 9) + cell_id


def pusch_cinit(rnti, sf_idx, cell_id):
    return (rnti << 14) + (sf_idx << 9) + cell_id


def pbch_cinit(cell_id):
    return cell_id


def pcfich_cinit(sf_idx, cell_id):
    return ((sf_idx + 1) * (2 * cell_id + 1) << 9) + cell_id


def pdcch_cinit(sf_idx, cell_id):
    return (sf_idx << 9) + cell_id


@table_cache(64)
def _cached_sequence(c_init: int, n: int, device: torch.device) -> torch.Tensor:
    return sequence.gold_sequence(c_init, n, device)


def _sequence(c_init, n: int, device) -> torch.Tensor:
    if isinstance(c_init, int):
        return _cached_sequence(c_init, n, device)
    return sequence.gold_sequence(c_init, n, device)


def scramble_bits(bits: torch.Tensor, c_init, n: int = None) -> torch.Tensor:
    """bits (..., E) ^ c(n).  c_init may be batched (leading dims must agree)."""
    n = bits.shape[-1] if n is None else n
    return bits ^ _sequence(c_init, n, bits.device).to(bits.dtype)


def scramble_llrs(llrs: torch.Tensor, c_init, n: int = None) -> torch.Tensor:
    """Descramble soft values: flip sign where c(n)==1 (scrambling.c float path)."""
    n = llrs.shape[-1] if n is None else n
    c = _sequence(c_init, n, llrs.device)
    return llrs * (1.0 - 2.0 * c.to(llrs.dtype))
