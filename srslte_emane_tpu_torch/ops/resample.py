"""Resampling: polyphase arbitrary-ratio resampler, linear interpolator,
decimator and software AGC.

Twin of the reference's `ops/resample.py` (`lib/src/phy/resampling/
{resample_arb.c,interp.c,decim.c}`, 32-filter polyphase bank; `agc/agc.c`).
Each output sample's phase filter and input window come from host tables;
the filter is one gather and one contraction, batched.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import cplx

N_PHASES = 32
N_TAPS = 8


@functools.lru_cache(maxsize=None)
def _polyphase_bank(n_phases: int = N_PHASES, taps: int = N_TAPS) -> np.ndarray:
    """Windowed-sinc low-pass split into polyphase branches: (phases, taps)."""
    n = n_phases * taps
    t = (np.arange(n) - n / 2 + 0.5) / n_phases
    h = np.sinc(t) * np.hamming(n)
    h = h / np.sum(h) * n_phases
    return h.reshape(taps, n_phases).T.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _resample_tables(T: int, ratio: float, n_out: int, device: torch.device):
    """(input index (n_out, taps), coefficients (n_out, taps)) on `device`."""
    pos = np.arange(n_out) / ratio
    base = np.floor(pos).astype(np.int64)
    phase = np.minimum(((pos - base) * N_PHASES).astype(np.int64), N_PHASES - 1)
    # input windows: x[base - taps/2 + 1 + j], j in [0, taps)
    off = np.arange(N_TAPS) - N_TAPS // 2 + 1
    idx = np.clip(base[:, None] + off[None, :], 0, T - 1)
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(_polyphase_bank()[phase]).to(device))


def resample_arb(x: torch.Tensor, ratio: float, n_out: int = None) -> torch.Tensor:
    """Arbitrary-ratio polyphase resample of cf tensor (..., T, 2).
    ratio = f_out / f_in; n_out defaults to floor(T * ratio)."""
    T = x.shape[-2]
    if n_out is None:
        n_out = int(T * ratio)
    idx, coef = _resample_tables(T, ratio, n_out, x.device)
    win = x[..., idx, :]  # (..., n_out, taps, 2)
    return torch.einsum("...otc,ot->...oc", win, coef)


def interp_linear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Integer-factor linear interpolation of cf tensor (interp.c)."""
    T = x.shape[-2]
    t = np.arange(T * factor) / factor
    j0 = np.clip(np.floor(t).astype(np.int64), 0, T - 2)
    w = torch.from_numpy((t - j0).astype(np.float32)).to(x.device)[..., None]
    j0 = torch.from_numpy(j0).to(x.device)
    return x[..., j0, :] * (1 - w) + x[..., j0 + 1, :] * w


def decimate(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Averaging decimator (decim.c)."""
    T = (x.shape[-2] // factor) * factor
    return x[..., :T, :].reshape(x.shape[:-2] + (T // factor, factor, 2)).mean(dim=-2)


class Agc:
    """Software AGC (agc.c): per-frame gain toward a power target."""

    def __init__(self, target: float = 1.0, bw: float = 0.7):
        self.gain = 1.0
        self.target = target
        self.bw = bw

    def process(self, x: torch.Tensor) -> torch.Tensor:
        p = float(cplx.abs2(x).mean())
        y = x * np.float32(self.gain)
        if p > 0:
            desired = np.sqrt(self.target / (p * self.gain**2 + 1e-12))
            self.gain = (1 - self.bw) * self.gain + self.bw * self.gain * desired
        return y
