"""MIMO: layer mapping and SFBC (transmit diversity) precoding/combining.

Twin of the SFBC part of the reference's `ops/mimo.py` (`lib/src/phy/mimo/
layermap.c`, the Alamouti branch of `precoding.c`), which PBCH and PCFICH
need for their 2- and 4-port hypotheses.  Tensors: symbols (..., n_re, 2);
multi-antenna grids carry a port axis: (..., n_port, n_re, 2).
"""

from __future__ import annotations

import numpy as np
import torch

from . import cplx

SQRT2 = float(np.float32(np.sqrt(2.0)))


# ---------------- layer mapping (36.211 §6.3.3) ----------------

def layer_map(cw_syms: list, n_layers: int) -> torch.Tensor:
    """codeword symbol lists [(..., M, 2), ...] -> (..., n_layers, M_layer, 2)."""
    n_cw = len(cw_syms)
    if n_cw == 1 and n_layers == 1:
        return cw_syms[0][..., None, :, :]
    if n_cw == 1 and n_layers in (2, 4):
        # tx diversity mapping: x(l)(i) = d(n_layers i + l)
        d = cw_syms[0]
        m = d.shape[-2] // n_layers
        x = d.reshape(d.shape[:-2] + (m, n_layers, 2))
        return torch.movedim(x, -2, -3)
    if n_cw == 2 and n_layers == 2:
        return torch.stack([cw_syms[0], cw_syms[1]], dim=-3)
    if n_cw == 2 and n_layers in (3, 4):
        n0 = n_layers // 2 if n_layers == 4 else 1
        a = cw_syms[0].reshape(cw_syms[0].shape[:-2] + (-1, n0, 2))
        b = cw_syms[1].reshape(cw_syms[1].shape[:-2] + (-1, n_layers - n0, 2))
        return torch.cat([torch.movedim(a, -2, -3), torch.movedim(b, -2, -3)], dim=-3)
    raise ValueError((n_cw, n_layers))


def layer_demap(layers: torch.Tensor, n_cw: int) -> list:
    """(..., n_layers, M, 2) -> list of codeword streams (inverse of map)."""
    n_layers = layers.shape[-3]
    if n_cw == 1 and n_layers == 1:
        return [layers[..., 0, :, :]]
    if n_cw == 1 and n_layers in (2, 4):
        x = torch.movedim(layers, -3, -2)  # (..., M, L, 2)
        return [x.reshape(x.shape[:-3] + (-1, 2))]
    if n_cw == 2 and n_layers == 2:
        return [layers[..., 0, :, :], layers[..., 1, :, :]]
    raise ValueError((n_cw, n_layers))


# ---------------- SFBC precoding (36.211 §6.3.4.3) ----------------

def precode_sfbc(layers: torch.Tensor) -> torch.Tensor:
    """TM2 tx diversity, 2 ports (SFBC/Alamouti, precoding.c).

    layers (..., 2, M, 2) -> ports (..., 2, 2M, 2):
      port0: [x0, x1, ...];  port1: [-x1*, x0*, ...] (per RE pair)."""
    x0 = layers[..., 0, :, :]
    x1 = layers[..., 1, :, :]
    p0 = torch.stack([x0, x1], dim=-2).reshape(x0.shape[:-2] + (-1, 2))
    p1 = torch.stack([-cplx.conj(x1), cplx.conj(x0)], dim=-2).reshape(p0.shape)
    return torch.stack([p0, p1], dim=-3) / SQRT2


def decode_sfbc(y: torch.Tensor, h: torch.Tensor, eps: float = 1e-9):
    """SFBC combining for 1 rx antenna.

    y (..., 2M, 2) received; h (..., 2, 2M, 2) per-port channel.
    Returns (x_hat (..., 2, M, 2) as layers, csi (..., 2, M))."""
    shape = y.shape[:-2] + (-1, 2, 2)
    yp = y.reshape(shape)  # (..., M, pair, 2)
    y0, y1 = yp[..., 0, :], yp[..., 1, :]
    h0 = h[..., 0, :, :].reshape(shape)[..., 0, :]  # port0 at even REs
    h1 = h[..., 1, :, :].reshape(shape)[..., 0, :]  # port1 (flat in pair)
    # Alamouti combining:  y0 = h0 x0 - h1 x1*,  y1 = h0 x1 + h1 x0*
    #   x0 = (h0* y0 + h1 y1*) / den;  x1 = conj(h0 y1* - h1* y0) / den
    den = cplx.abs2(h0) + cplx.abs2(h1) + eps
    y1c = cplx.conj(y1)
    x0 = (cplx.mul_conj(y0, h0) + cplx.mul(h1, y1c)) / den[..., None]
    x1 = cplx.conj(cplx.mul(h0, y1c) - cplx.mul_conj(y0, h1)) / den[..., None]
    x = torch.stack([x0, x1], dim=-3) * SQRT2
    csi = torch.stack([den, den], dim=-2) / 2.0
    return x, csi
