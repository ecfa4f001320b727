"""The chip's published peaks and the least time each kernel's work could take.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor
cores.  The turbo kernels add and take maxima and make no fused
multiply-add, so their operation peak is half of that, 33.5 T/s.

The bounds are copied from the program's on-card smoke test (`bound`,
`map_bound`, `iter_bound`, `viterbi_bound`): each counts
the bytes the kernel must read and write once and the operations its
algorithm needs, and takes the larger of bytes over bandwidth and
operations over peak.  Every bound is in seconds.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12  # add / max, no FMA: half of the 67 TFLOP/s float32 peak
HALO = 40
ITER_OPS_PER_BIT = 6  # the epilogue's subtract, multiply, add, compare, and two XORs


def bound(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def map_bound(k: int, rows: float, w: int, narrow: bool) -> float:
    """turbo_map, one half-iteration of `rows` code blocks of size k in w
    windows: read ls, lp (rows, k) f32 and beta_K (rows, 8), write the LLRs;
    per (block, window) column 26 add/max per halo or backward step, 57 per
    forward step, 15 per normalisation after each halo and, in narrow mode,
    after each backward pair."""
    L = k // w
    H = min(HALO, L)
    per_col = 2 * H * 26 + L * (26 + 57) + 2 * 15 + (L // 2) * 15 * narrow
    return bound(4 * rows * (3 * k + 8), rows * w * per_col)


def iter_bound(rows: float, k: int) -> float:
    """turbo_iter, one pass: read post, ls_in and one of ls / ls2 (f32),
    write ls_in (f32) and the bits (int8), 17 B per position, and read the
    three (k,) int32 tables; ITER_OPS_PER_BIT operations per position."""
    return bound(rows * k * 17 + 12 * k, rows * k * ITER_OPS_PER_BIT)


def viterbi_bound(rows: int, k: int, tb_iter: int) -> float:
    """The Viterbi kernel: read bm (rows, k, 8) f32, write the bits (rows, k)
    int8; per row and trellis step 64 x (2 adds, 1 compare, 1 subtract) and
    63 max over the states."""
    return bound(rows * k * (8 * 4 + 1), rows * tb_iter * k * (64 * 4 + 63))
