"""3GPP 36.211 §7.2 Gold / pseudo-random sequence c(n).

Twin of the reference's `ops/sequence.py`: x1 is the same sequence for every
user (a constant vector), and x2's output is GF(2)-linear in the 31 c_init
bits, so a batch of sequences is one float32 product with a host-built
(31, N) response matrix, then mod 2 (the 31-term sums are exact).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import gf2
from ..utils.devices import table_cache

NC = 1600
_X1_TAPS = np.array([1, 0, 0, 1] + [0] * 27, dtype=np.int64)  # x1(n+31)=x1(n+3)+x1(n)
_X2_TAPS = np.array([1, 1, 1, 1] + [0] * 27, dtype=np.int64)  # +x2(n+2)+x2(n+1)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@functools.lru_cache(maxsize=8)
def _tables(n: int):
    """(x1 constant sequence, x2 response matrix) for n output bits."""
    x1_resp = gf2.lfsr_output_response(_X1_TAPS, n, skip=NC)  # (31, n)
    x1_seq = x1_resp[0, :].astype(np.int8)  # init state = e_0 -> row 0
    x2_resp = gf2.lfsr_output_response(_X2_TAPS, n, skip=NC).astype(np.int8)
    return x1_seq, x2_resp


@table_cache(128)
def _device_tables(n: int, device: torch.device):
    x1_seq, x2_resp = _tables(n)
    return (torch.from_numpy(x1_seq).to(device),
            torch.from_numpy(x2_resp.astype(np.float32)).to(device))


def cinit_bits(c_init: torch.Tensor) -> torch.Tensor:
    """Integer c_init(s) (shape (...,)) -> 31 LSB-first state bits (..., 31)."""
    shifts = torch.arange(31, device=c_init.device)
    return ((c_init.to(torch.int64)[..., None] >> shifts) & 1).to(torch.int8)


def gold_sequence(c_init, n: int, device=None) -> torch.Tensor:
    """Batched c(n) bits.

    c_init: int, or int tensor/array of shape (B,).
    Returns int8 tensor (B, n) (or (n,) for scalar input) of 0/1 bits.
    """
    c = torch.as_tensor(c_init, dtype=torch.int64, device=device)
    scalar = c.ndim == 0
    bits = cinit_bits(c.reshape(-1))  # (B, 31)
    x1_seq, x2_resp = _device_tables(_round_up(max(n, 1), 128), bits.device)
    x2 = bits.to(torch.float32) @ x2_resp
    out = (torch.remainder(x2, 2.0).to(torch.int8) ^ x1_seq)[:, :n]
    return out[0] if scalar else out


def gold_sequence_host(c_init: int, n: int) -> np.ndarray:
    """NumPy oracle: direct LFSR simulation (`sequence.c:44-73`).  Builds the
    host tables of phch/grid.py."""
    x1 = np.zeros(NC + n + 31, dtype=np.int64)
    x2 = np.zeros(NC + n + 31, dtype=np.int64)
    x1[0] = 1
    for i in range(31):
        x2[i] = (c_init >> i) & 1
    for i in range(NC + n):
        x1[i + 31] = (x1[i + 3] + x1[i]) & 1
        x2[i + 31] = (x2[i + 3] + x2[i + 2] + x2[i + 1] + x2[i]) & 1
    return ((x1[NC : NC + n] + x2[NC : NC + n]) & 1).astype(np.int8)
