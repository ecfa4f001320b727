"""MIMO: layer mapping, precoding, predecoding (ZF/MRC), TM1-TM6.

Twin of the reference's `ops/mimo.py` (`lib/src/phy/mimo/layermap.c` and
`precoding.c`: single port, SFBC and SFBC-FSTD transmit diversity, CDD,
codebook spatial multiplexing, ZF receivers, PMI selection).  Everything is
elementwise or 2x2 closed-form math over the RE axis.  Tensors: symbols
(..., n_re, 2); multi-antenna grids carry a port axis: (..., n_port, n_re, 2).
"""

from __future__ import annotations

import functools

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


def _alamouti(y0, y1, ha, hb, eps):
    """Alamouti combining of the RE pair (y0, y1) over ports (ha, hb),
    y0 = ha x0 - hb x1*, y1 = ha x1 + hb x0*:
    x0 = (ha* y0 + hb y1*) / den, x1 = conj(ha y1* - hb* y0) / den.
    Returns (x0, x1, den)."""
    den = cplx.abs2(ha) + cplx.abs2(hb) + eps
    y1c = cplx.conj(y1)
    a = (cplx.mul_conj(y0, ha) + cplx.mul(hb, y1c)) / den[..., None]
    b = cplx.conj(cplx.mul(ha, y1c) - cplx.mul_conj(y0, hb)) / den[..., None]
    return a, b, den


def decode_sfbc(y: torch.Tensor, h: torch.Tensor, eps: float = 1e-9):
    """SFBC combining for 1 rx antenna.

    y (..., 2M, 2) received; h (..., 2, 2M, 2) per-port channel.
    Returns (x_hat (..., 2, M, 2) as layers, csi (..., 2, M))."""
    shape = y.shape[:-2] + (-1, 2, 2)
    yp = y.reshape(shape)  # (..., M, pair, 2)
    h0 = h[..., 0, :, :].reshape(shape)[..., 0, :]  # port0 at even REs
    h1 = h[..., 1, :, :].reshape(shape)[..., 0, :]  # port1 (flat in pair)
    x0, x1, den = _alamouti(yp[..., 0, :], yp[..., 1, :], h0, h1, eps)
    x = torch.stack([x0, x1], dim=-3) * SQRT2
    csi = torch.stack([den, den], dim=-2) / 2.0
    return x, csi


# ---------------- codebook precoding (36.211 §6.3.4.2) ----------------

# 2-port spatial multiplexing codebook (Table 6.3.4.2.3-1), 1 layer
PMI_2TX_1L = [
    np.array([1, 1]) / np.float32(np.sqrt(2.0)),
    np.array([1, -1]) / np.float32(np.sqrt(2.0)),
    np.array([1, 1j]) / np.float32(np.sqrt(2.0)),
    np.array([1, -1j]) / np.float32(np.sqrt(2.0)),
]
# 2 layers (PMI 1, 2 valid; PMI 0 = identity/2 used for CDD)
PMI_2TX_2L = [
    np.array([[1, 0], [0, 1]]) / np.float32(np.sqrt(2.0)),
    np.array([[1, 1], [1, -1]]) / 2.0,
    np.array([[1, 1], [1j, -1j]]) / 2.0,
]


@functools.lru_cache(maxsize=None)
def _codebook_2l(pmi: int, device: torch.device):
    """(re, im) float32 (2, 2) of PMI_2TX_2L[pmi] on `device`."""
    w = PMI_2TX_2L[pmi]
    return (torch.from_numpy(w.real.astype(np.float32)).to(device),
            torch.from_numpy(w.imag.astype(np.float32)).to(device))


def _times_weight(x: torch.Tensor, w: complex) -> torch.Tensor:
    """cf tensor x times the complex scalar w (two real products each)."""
    wr, wi = float(w.real), float(w.imag)
    return torch.stack([x[..., 0] * wr - x[..., 1] * wi,
                        x[..., 0] * wi + x[..., 1] * wr], dim=-1)


def precode_single(layers: torch.Tensor) -> torch.Tensor:
    """TM1: 1 layer -> 1 port."""
    return layers


def precode_sm2(layers: torch.Tensor, pmi: int) -> torch.Tensor:
    """TM4 spatial multiplexing, 2 layers -> 2 ports with codebook PMI."""
    wr, wi = _codebook_2l(pmi, layers.device)
    xr, xi = layers[..., 0], layers[..., 1]  # (..., L, M)
    yr = torch.einsum("pl,...lm->...pm", wr, xr) - torch.einsum("pl,...lm->...pm", wi, xi)
    yi = torch.einsum("pl,...lm->...pm", wr, xi) + torch.einsum("pl,...lm->...pm", wi, xr)
    return torch.stack([yr, yi], dim=-1)


def precode_cdd2(layers: torch.Tensor) -> torch.Tensor:
    """TM3 large-delay CDD, 2 layers -> 2 ports: W=I/sqrt2 fixed, D(i) phase
    ramp, U DFT2 (36.211 §6.3.4.2.2)."""
    m = layers.shape[-2]
    x0, x1 = layers[..., 0, :, :], layers[..., 1, :, :]
    # U = [[1,1],[1,-1]]/sqrt2 ; D(i) = diag(1, e^{-j pi i})  (alternates +-1)
    sign = 1.0 - 2.0 * (torch.arange(m, device=layers.device) % 2).to(layers.dtype)
    u0 = (x0 + x1) / SQRT2
    u1 = (x0 - x1) / SQRT2 * sign[..., None]
    return torch.stack([u0, u1], dim=-3) / SQRT2


def decode_zf2(y: torch.Tensor, h: torch.Tensor, noise=None, eps: float = 1e-9):
    """2x2 ZF/MMSE per RE (closed form, mat.c equivalent).

    y (..., n_rx=2, M, 2); h (..., n_rx, n_tx=2, M, 2) effective channel
    (precoder folded in).  Returns (x (..., 2, M, 2), csi (..., 2, M))."""
    h00, h01 = h[..., 0, 0, :, :], h[..., 0, 1, :, :]
    h10, h11 = h[..., 1, 0, :, :], h[..., 1, 1, :, :]
    y0, y1 = y[..., 0, :, :], y[..., 1, :, :]
    # Gram matrix G = H^H H (+ noise I) ; x = G^-1 H^H y
    g00 = cplx.abs2(h00) + cplx.abs2(h10)
    g11 = cplx.abs2(h01) + cplx.abs2(h11)
    g01 = cplx.mul_conj(h01, h00) + cplx.mul_conj(h11, h10)  # conj(h00)h01+...
    if noise is not None:
        g00 = g00 + noise[..., None]
        g11 = g11 + noise[..., None]
    det = g00 * g11 - cplx.abs2(g01) + eps
    # H^H y
    z0 = cplx.mul_conj(y0, h00) + cplx.mul_conj(y1, h10)
    z1 = cplx.mul_conj(y0, h01) + cplx.mul_conj(y1, h11)
    x0 = (g11[..., None] * z0 - cplx.mul(g01, z1)) / det[..., None]
    x1 = (g00[..., None] * z1 - cplx.mul(cplx.conj(g01), z0)) / det[..., None]
    x = torch.stack([x0, x1], dim=-3)
    # post-equalization SINR-ish CSI per layer: det / g_other
    csi = torch.stack([det / (g11 + eps), det / (g00 + eps)], dim=-2)
    return x, csi


def precode_sfbc_fstd(layers: torch.Tensor) -> torch.Tensor:
    """TM2 tx diversity with 4 ports: SFBC + frequency-switched diversity
    (36.211 §6.3.4.3 / precoding.c tx_diversity 4-port).

    layers (..., 4, M, 2) -> ports (..., 4, 4M, 2).  Per RE quadruple
    (k0..k3): ports (0,2) Alamouti-code (x0,x1) on (k0,k1); ports (1,3)
    code (x2,x3) on (k2,k3)."""
    x0, x1 = layers[..., 0, :, :], layers[..., 1, :, :]
    x2, x3 = layers[..., 2, :, :], layers[..., 3, :, :]
    z = torch.zeros_like(x0)

    def quad(a, b, c, d):
        return torch.stack([a, b, c, d], dim=-2).reshape(a.shape[:-2] + (-1, 2))

    p0 = quad(x0, x1, z, z)
    p2 = quad(-cplx.conj(x1), cplx.conj(x0), z, z)
    p1 = quad(z, z, x2, x3)
    p3 = quad(z, z, -cplx.conj(x3), cplx.conj(x2))
    return torch.stack([p0, p1, p2, p3], dim=-3) / SQRT2


def decode_sfbc_fstd(y: torch.Tensor, h: torch.Tensor, eps: float = 1e-9):
    """4-port SFBC-FSTD combining for 1 rx antenna.

    y (..., 4M, 2); h (..., 4, 4M, 2).  Returns (x (..., 4, M, 2), csi)."""
    shape = y.shape[:-2] + (-1, 4, 2)
    yq = y.reshape(shape)  # (..., M, quad, 2)
    hq = [h[..., p, :, :].reshape(shape) for p in range(4)]
    # (x0,x1) from REs 0,1 via ports 0/2;  (x2,x3) from REs 2,3 via ports 1/3
    x0, x1, d01 = _alamouti(yq[..., 0, :], yq[..., 1, :], hq[0][..., 0, :], hq[2][..., 0, :], eps)
    x2, x3, d23 = _alamouti(yq[..., 2, :], yq[..., 3, :], hq[1][..., 2, :], hq[3][..., 2, :], eps)
    x = torch.stack([x0, x1, x2, x3], dim=-3) * SQRT2
    csi = torch.stack([d01, d01, d23, d23], dim=-2) / 2.0
    return x, csi


def precode_sm1(layers: torch.Tensor, pmi: int) -> torch.Tensor:
    """Rank-1 closed-loop precoding, 2 ports (TM5/TM6): 1 layer through the
    codebook vector PMI_2TX_1L[pmi] (36.211 Table 6.3.4.2.3-1)."""
    w = PMI_2TX_1L[pmi]  # (2,) complex
    x = layers[..., 0, :, :]  # (..., M, 2)
    return torch.stack([_times_weight(x, w[p]) for p in range(2)], dim=-3)


def decode_mrc_eff(y: torch.Tensor, h_eff: torch.Tensor, eps: float = 1e-9):
    """Single-stream MRC over rx antennas with an effective channel.

    y (..., n_rx, M, 2); h_eff (..., n_rx, M, 2).
    Returns (x (..., M, 2), csi (..., M))."""
    num = cplx.mul_conj(y, h_eff).sum(dim=-3)
    den = cplx.abs2(h_eff).sum(dim=-2) + eps
    return num / den[..., None], den


def rank1_channel(h: torch.Tensor, w) -> torch.Tensor:
    """h (..., 2 tx, M, 2) folded with the codebook vector w (2,): the
    effective channel sum_p h[..., p] w[p] (..., M, 2)."""
    return _times_weight(h[..., 0, :, :], w[0]) + _times_weight(h[..., 1, :, :], w[1])


def pmi_select_1l(h: torch.Tensor, noise=None, eps: float = 1e-12):
    """Rank-1 PMI selection (precoding.c srslte_precoding_pmi_select_1l):
    argmax over the 2-tx codebook of ||H w||^2.

    h (..., n_rx, 2, M, 2) per-RE channel.  Returns (pmi (...,) int32,
    metric (..., n_pmi) mean power per codebook entry).  As in the
    reference, for h of 5 or more dimensions the metric is averaged over
    the axis before n_rx as well."""
    metrics = []
    for w in PMI_2TX_1L:
        # ||H w||^2 summed over rx, averaged over REs
        pwr = cplx.abs2(rank1_channel(h, w)).sum(dim=-2)
        metrics.append(pwr.sum(dim=-1).mean(dim=-1) if pwr.ndim > 1 else pwr)
    m = torch.stack(metrics, dim=-1)
    return torch.argmax(m, dim=-1).to(torch.int32), m


def cond_number_db(h: torch.Tensor, eps: float = 1e-12):
    """2x2 per-RE condition number in dB (mat.c srslte_mat_2x2_cn):
    10 log10(lmax/lmin) of H^H H.

    h (..., 2, 2, M, 2) -> (..., M)."""
    h00, h01 = h[..., 0, 0, :, :], h[..., 0, 1, :, :]
    h10, h11 = h[..., 1, 0, :, :], h[..., 1, 1, :, :]
    a = cplx.abs2(h00) + cplx.abs2(h10)
    d = cplx.abs2(h01) + cplx.abs2(h11)
    b = cplx.mul_conj(h01, h00) + cplx.mul_conj(h11, h10)
    tr = a + d
    det = a * d - cplx.abs2(b)
    disc = torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=0.0))
    lmax = (tr + disc) / 2.0
    lmin = torch.clamp((tr - disc) / 2.0, min=eps)
    return 10.0 * torch.log10(lmax / lmin)
