"""Batched per-RB SINR on tensors (the device part of the reference's
`runtime/sinr.py`, the EMANE propagation + SINRTester equivalent):

  rx_power[t, r, prb] = tx_power[t] * prb_used[t, prb] / pathloss[t, r]
  sinr[t, r, prb]     = rx / (noise + sum_{t' != t} rx_power[t', r, prb])

The reference's host-side adjudication (thresholds, the SinrTester handle,
the native bus) stays in the JAX package for now.
"""

from __future__ import annotations

import torch


def per_rb_sinr_device(tx_power_dbm, prb_used, pathloss_db, noise_floor_dbm: float):
    """Per-RB SINR (dB) batched over (..., T, R, P): tx_power_dbm (..., T),
    prb_used (..., T, P) 0/1, pathloss_db (..., T, R).  Tensors stay on
    their device; the result is float32."""
    tx_mw = 10.0 ** (torch.as_tensor(tx_power_dbm, dtype=torch.float32) / 10.0)
    pl = 10.0 ** (-torch.as_tensor(pathloss_db, dtype=torch.float32) / 10.0)
    used = torch.as_tensor(prb_used, dtype=torch.float32)
    rx_mw = tx_mw[..., :, None, None] * pl[..., :, :, None] * used[..., :, None, :]
    total = rx_mw.sum(dim=-3, keepdim=True)
    noise_mw = 10.0 ** (noise_floor_dbm / 10.0)
    sinr = rx_mw / (total - rx_mw + noise_mw)
    return 10.0 * torch.log10(sinr.clamp(min=1e-12))
