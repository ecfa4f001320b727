"""Split-complex representation: complex tensors as float32 with a trailing
re/im axis of size 2 (the convention of every module boundary in the port,
as in the reference package).  Inside a function the port may use torch's
complex dtypes (cuFFT in ops/dft.py); at the boundaries tensors are "cf
tensors".  Only the helpers the ported slice uses are here; the
reference module's others come with the slices that need them."""

from __future__ import annotations

import numpy as np
import torch


def from_numpy(x: np.ndarray, device=None) -> torch.Tensor:
    """complex numpy -> (..., 2) float32 tensor."""
    return torch.from_numpy(
        np.stack([x.real, x.imag], axis=-1).astype(np.float32)).to(device)


def to_numpy(x) -> np.ndarray:
    """(..., 2) float tensor -> complex64 numpy."""
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)


def make(re, im) -> torch.Tensor:
    return torch.stack([re, im], dim=-1)


def mul_conj(a, b):
    """a * conj(b)."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return make(ar * br + ai * bi, ai * br - ar * bi)


def abs2(x):
    return x[..., 0] ** 2 + x[..., 1] ** 2
