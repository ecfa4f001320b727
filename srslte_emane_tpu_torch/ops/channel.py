"""AWGN and flat MIMO channels on the device (twin of the reference's
`ops/channel.py`).

The noise comes from a `torch.Generator` on the tensor's device: it is not
the reference's jax.random stream, so tests that compare the two packages
feed both the same numpy noise instead.
"""

from __future__ import annotations

import torch

from . import cplx


def awgn(gen: torch.Generator, x: torch.Tensor, snr_db, signal_power=None):
    """Add complex white Gaussian noise to cf tensor x at the given SNR.

    snr_db may be scalar or batched over leading dims.  signal_power: if None,
    measured from x (mean |x|^2 over all but the leading batch dim)."""
    if signal_power is None:
        p = cplx.abs2(x)
        signal_power = p.reshape(p.shape[0], -1).mean(dim=-1)
        signal_power = signal_power.reshape((-1,) + (1,) * (x.ndim - 2))
    snr = 10.0 ** (torch.as_tensor(snr_db, dtype=torch.float32, device=x.device) / 10.0)
    snr = snr.reshape(snr.shape + (1,) * (x.ndim - 1 - snr.ndim))
    sigma2 = signal_power / snr  # total complex noise variance
    noise = torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)
    return x + noise * torch.sqrt(sigma2 / 2.0)[..., None]


def mimo_flat(gen: torch.Generator, tx: torch.Tensor, h: torch.Tensor, snr_db):
    """Flat-fading MIMO channel + AWGN.

    tx: (B, n_tx, T, 2) per-port time samples; h: (B, n_rx, n_tx, 2) cf flat
    channel.  Returns (B, n_rx, T, 2); the signal power of the AWGN is
    measured per row over all receive antennas."""
    # y[b,r,t,:] = sum_p h[b,r,p] * tx[b,p,t,:]
    y = cplx.mul(h[:, :, :, None, :], tx[:, None, :, :, :]).sum(dim=2)
    return awgn(gen, y, snr_db)
