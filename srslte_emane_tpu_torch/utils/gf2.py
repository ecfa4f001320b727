"""GF(2) linear-algebra helpers (host-side, NumPy), copied from the reference
package's `utils/gf2.py` so that the port loads nothing of that package.

Bit-serial machines (the Gold-sequence LFSRs here) are linear over GF(2):
their output for a block of steps is a host-precomputed 0/1 matrix, and the
device replaces the bit loop by a float32 product followed by mod 2.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "gf2_matmul",
    "gf2_matpow",
    "lfsr_transition_matrix",
    "lfsr_output_response",
    "poly_to_taps",
]


def gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(2). Inputs are 0/1 integer arrays."""
    return (a.astype(np.int64) @ b.astype(np.int64)) & 1


def gf2_matpow(a: np.ndarray, n: int) -> np.ndarray:
    """A**n over GF(2) by square-and-multiply."""
    assert a.shape[0] == a.shape[1]
    result = np.eye(a.shape[0], dtype=np.int64)
    base = a.astype(np.int64) & 1
    while n > 0:
        if n & 1:
            result = gf2_matmul(result, base)
        base = gf2_matmul(base, base)
        n >>= 1
    return result


def poly_to_taps(poly: int, degree: int) -> np.ndarray:
    """Binary coefficient vector [c_0 .. c_degree] of a polynomial given as an
    integer bitmask (bit i == coefficient of x^i)."""
    return np.array([(poly >> i) & 1 for i in range(degree + 1)], dtype=np.int64)


def lfsr_transition_matrix(taps: np.ndarray) -> np.ndarray:
    """One-step transition matrix of a Fibonacci LFSR over state
    (s_0 .. s_{n-1}): new_bit = sum_i taps[i] * s_i (mod 2), state shifts
    left by one (36.211 §7.2 x1/x2 updates)."""
    n = len(taps)
    m = np.zeros((n, n), dtype=np.int64)
    for i in range(n - 1):
        m[i, i + 1] = 1
    m[n - 1, :] = np.asarray(taps, dtype=np.int64) & 1
    return m


def lfsr_output_response(taps: np.ndarray, nsteps: int, skip: int = 0) -> np.ndarray:
    """Response matrix R (n, nsteps): output bit o_t = s_0 at step skip + t,
    as a linear function of the initial state."""
    n = len(taps)
    a = lfsr_transition_matrix(taps)
    a_skip = gf2_matpow(a, skip)
    # rows v_t = e_0^T A^(skip+t): a seed block by iteration, then extended
    # by log-doubling v_{t+L} = v_t A^L
    seed = min(nsteps, 256)
    v = np.zeros((seed, n), dtype=np.int64)
    row = a_skip[0, :].copy()
    a64 = a.astype(np.int64)
    for t in range(seed):
        v[t] = row
        row = (row @ a64) & 1
    a_l = gf2_matpow(a, seed)
    while v.shape[0] < nsteps:
        v = np.concatenate([v, gf2_matmul(v, a_l)], axis=0)
        a_l = gf2_matmul(a_l, a_l)
    return v[:nsteps].T.copy()
