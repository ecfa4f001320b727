"""36.211 §7.1 modulation mapper + zone-based soft demodulator.

Twin of the reference's `ops/modem.py`: closed-form nested Gray mapping and
the zone approximations of srsLTE's demod_soft.c:76-160, with this
framework's sign convention (positive LLR <=> bit 0).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

BPSK, QPSK, QAM16, QAM64, QAM256 = "bpsk", "qpsk", "16qam", "64qam", "256qam"
BITS_PER_SYMBOL = {BPSK: 1, QPSK: 2, QAM16: 4, QAM64: 6, QAM256: 8}
MOD_FROM_QM = {1: BPSK, 2: QPSK, 4: QAM16, 6: QAM64, 8: QAM256}


@functools.lru_cache(maxsize=None)
def constellation(mod: str) -> np.ndarray:
    """Complex LUT indexed by the bit-group value (b0 = MSB of the index,
    matching transmission order b(i), b(i+1), ...)."""
    qm = BITS_PER_SYMBOL[mod]
    n = 1 << qm
    pts = np.zeros(n, dtype=np.complex64)
    for v in range(n):
        b = [(v >> (qm - 1 - i)) & 1 for i in range(qm)]
        if mod == BPSK:
            # 36.211 Table 7.1.1-1: b=0 -> (1+j)/sqrt(2), b=1 -> -(1+j)/sqrt(2)
            s = (1 - 2 * b[0]) / np.sqrt(2)
            pts[v] = s + 1j * s
        elif mod == QPSK:
            pts[v] = ((1 - 2 * b[0]) + 1j * (1 - 2 * b[1])) / np.sqrt(2)
        elif mod == QAM16:
            i = (1 - 2 * b[0]) * (1 + 2 * b[2])
            q = (1 - 2 * b[1]) * (1 + 2 * b[3])
            pts[v] = (i + 1j * q) / np.sqrt(10)
        elif mod == QAM64:
            i = (1 - 2 * b[0]) * (4 - (1 - 2 * b[2]) * (2 - (1 - 2 * b[4])))
            q = (1 - 2 * b[1]) * (4 - (1 - 2 * b[3]) * (2 - (1 - 2 * b[5])))
            pts[v] = (i + 1j * q) / np.sqrt(42)
        elif mod == QAM256:
            i = (1 - 2 * b[0]) * (8 - (1 - 2 * b[2]) * (4 - (1 - 2 * b[4]) * (2 - (1 - 2 * b[6]))))
            q = (1 - 2 * b[1]) * (8 - (1 - 2 * b[3]) * (4 - (1 - 2 * b[5]) * (2 - (1 - 2 * b[7]))))
            pts[v] = (i + 1j * q) / np.sqrt(170)
    return pts


def modulate(bits: torch.Tensor, mod: str) -> torch.Tensor:
    """(..., E) bits -> (..., E/Qm, 2) split-complex symbols."""
    qm = BITS_PER_SYMBOL[mod]
    shape = bits.shape[:-1] + (bits.shape[-1] // qm, qm)
    s = 1.0 - 2.0 * bits.reshape(shape).to(torch.float32)  # (..., n, qm)
    if mod == BPSK:
        v = s[..., 0] * float(np.float32(1.0 / np.sqrt(2)))
        return torch.stack([v, v], dim=-1)
    if mod == QPSK:
        return s * float(np.float32(1.0 / np.sqrt(2)))
    if mod == QAM16:
        return s[..., 0:2] * (2.0 - s[..., 2:4]) * float(np.float32(1.0 / np.sqrt(10)))
    if mod == QAM64:
        return (s[..., 0:2] * (4.0 - s[..., 2:4] * (2.0 - s[..., 4:6]))
                * float(np.float32(1.0 / np.sqrt(42))))
    if mod == QAM256:
        return (s[..., 0:2] * (8.0 - s[..., 2:4]
                               * (4.0 - s[..., 4:6] * (2.0 - s[..., 6:8])))
                * float(np.float32(1.0 / np.sqrt(170))))
    raise ValueError(mod)


def demod_soft(symbols: torch.Tensor, mod: str) -> torch.Tensor:
    """Zone-approximate max-log LLRs: (..., N, 2) cf symbols -> (..., N*Qm).
    Unnormalized (no 1/sigma^2): the max-log decoder is scale-invariant and
    CSI weights multiply in later (pdsch.c:574-686)."""
    re, im = symbols[..., 0], symbols[..., 1]
    f = lambda x: float(np.float32(x))
    if mod == BPSK:
        out = [(re + im) * f(1 / np.sqrt(2))]
    elif mod == QPSK:
        out = [re * f(np.sqrt(2)), im * f(np.sqrt(2))]
    elif mod == QAM16:
        c = f(2 / np.sqrt(10))
        out = [re, im, c - re.abs(), c - im.abs()]
    elif mod == QAM64:
        c4, c2 = f(4 / np.sqrt(42)), f(2 / np.sqrt(42))
        t_re, t_im = re.abs() - c4, im.abs() - c4
        out = [re, im, -t_re, -t_im, c2 - t_re.abs(), c2 - t_im.abs()]
    elif mod == QAM256:
        c8, c4, c2 = f(8 / np.sqrt(170)), f(4 / np.sqrt(170)), f(2 / np.sqrt(170))
        t1_re, t1_im = re.abs() - c8, im.abs() - c8
        t2_re, t2_im = t1_re.abs() - c4, t1_im.abs() - c4
        out = [re, im, -t1_re, -t1_im, -t2_re, -t2_im,
               c2 - t2_re.abs(), c2 - t2_im.abs()]
    else:
        raise ValueError(mod)
    # interleave per symbol: (..., N, Qm) -> (..., N*Qm)
    return torch.stack(out, dim=-1).reshape(symbols.shape[:-2] + (-1,))


def demod_hard(symbols: torch.Tensor, mod: str) -> torch.Tensor:
    """Hard decisions via the soft path (reference: demod_hard.c)."""
    return (demod_soft(symbols, mod) < 0).to(torch.int8)
