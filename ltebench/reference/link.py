"""The plain PDSCH link: transport block to time samples and back to the
decoder's soft buffer, written from 3GPP TS 36.211 and 36.212.

`encode` is the eNB side: CRC24A, segmentation with CRC24B, the rate-1/3
turbo code bit by bit, rate matching, scrambling, the 64QAM (or any square
QAM) map, the grid with port 0's CRS, and OFDM with the normal cyclic
prefix.  `front_end` is the UE side up to the turbo decoder: OFDM
demodulation, the CRS least-squares estimate with linear interpolation
(and extrapolation at the edges) in frequency and then in time, zero
forcing, the zone soft demodulator of srsLTE (demod_soft.c) weighted by
|h|^2, descrambling and de-rate-matching into each code block's soft
buffer, held in bfloat16 where the configuration's llr_bits is 16 or less.

The arithmetic runs in `Precision`: float64 for the reference, and one
step below float32 (each stage's output rounded to bfloat16) for the
control that `correct` has to refuse.  Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import tables


@dataclasses.dataclass(frozen=True)
class Precision:
    """complex: the dtype the complex arithmetic runs in; bf16: round every
    stage's output to bfloat16 (the control)."""
    complex: torch.dtype = torch.complex128
    bf16: bool = False

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if not self.bf16:
            return x
        if x.is_complex():
            r = torch.view_as_real(x).to(torch.bfloat16).to(torch.float32)
            return torch.view_as_complex(r.contiguous()).to(self.complex)
        return x.to(torch.bfloat16).to(x.dtype)

    @property
    def real(self) -> torch.dtype:
        return torch.float64 if self.complex == torch.complex128 else torch.float32


REFERENCE = Precision()
CONTROL = Precision(torch.complex64, bf16=True)


def crc(bits: torch.Tensor, poly_order) -> torch.Tensor:
    """(n, L) 0/1 -> (n, order) CRC bits (float64 products, exact)."""
    m = torch.from_numpy(tables.crc_matrix(*poly_order, bits.shape[1])).to(bits.device)
    return torch.remainder(bits.to(torch.float64) @ m, 2).to(torch.int8)


def crc_ok(bits: torch.Tensor, poly_order) -> torch.Tensor:
    return (crc(bits, poly_order) == 0).all(dim=1)


def code_blocks(payload: torch.Tensor, link: tables.Link) -> list:
    """36.212 5.1.1-5.1.2: (B, tbs) -> [(B, K_r) int8], the first block led by F zero fillers."""
    s = link.segm
    tb = torch.cat([payload.to(torch.int8), crc(payload, tables.CRC24A)], dim=1)
    if s.C == 1:
        return [torch.cat([tb.new_zeros((tb.shape[0], s.F)), tb], dim=1)]
    out, off = [], 0
    for r, k in enumerate(s.sizes):
        n = k - tables.CB_CRC - (s.F if r == 0 else 0)
        chunk = tb[:, off:off + n]
        off += n
        if r == 0:
            chunk = torch.cat([chunk.new_zeros((chunk.shape[0], s.F)), chunk], dim=1)
        out.append(torch.cat([chunk, crc(chunk, tables.CRC24B)], dim=1))
    return out


def _rsc(u: np.ndarray):
    """One constituent encoder, bit by bit over (n, K) uint8: the parity
    and the six tail bits x_K, z_K, x_K+1, z_K+1, x_K+2, z_K+2."""
    n, K = u.shape
    s0, s1, s2 = (np.zeros(n, np.uint8) for _ in range(3))
    z = np.empty_like(u)
    for t in range(K):
        a = u[:, t] ^ s1 ^ s2
        z[:, t] = a ^ s0 ^ s2
        s0, s1, s2 = a, s0, s1
    tail = []
    for _ in range(3):
        x = s1 ^ s2
        tail += [x, s0 ^ s2]
        s0, s1, s2 = np.zeros_like(s0), s0, s1
    return z, np.stack(tail, axis=1)


def turbo_encode(c: np.ndarray):
    """36.212 5.1.3.2: (n, K) -> d0, d1, d2 (n, K + 4)."""
    K = c.shape[1]
    z1, t1 = _rsc(c)
    z2, t2 = _rsc(c[:, tables.qpp(K)])
    d0 = np.concatenate([c, t1[:, [0]], t1[:, [3]], t2[:, [0]], t2[:, [3]]], axis=1)
    d1 = np.concatenate([z1, t1[:, [1]], t1[:, [4]], t2[:, [1]], t2[:, [4]]], axis=1)
    d2 = np.concatenate([z2, t1[:, [2]], t1[:, [5]], t2[:, [2]], t2[:, [5]]], axis=1)
    return d0, d1, d2


def codeword(payload: torch.Tensor, link: tables.Link) -> torch.Tensor:
    """(B, tbs) -> (B, G) rate-matched bits, code block after code block;
    the blocks of one size are encoded together."""
    s = link.segm
    cbs = [cb.cpu().numpy().astype(np.uint8) for cb in code_blocks(payload, link)]
    B = cbs[0].shape[0]
    parts = [None] * s.C
    for k in sorted(set(s.sizes)):
        rs = [r for r in range(s.C) if s.sizes[r] == k]
        d = np.concatenate(turbo_encode(np.concatenate([cbs[r] for r in rs])), axis=1)
        for i, r in enumerate(rs):
            f = s.F if r == 0 else 0
            w = tables.circular_buffer(k, f)
            parts[r] = d[i * B:(i + 1) * B][:, w[tables.selection(k, f, link.e_sizes[r])]]
    return torch.from_numpy(np.concatenate(parts, axis=1).astype(np.int8)).to(payload.device)


def scrambling(link: tables.Link, q: int = 0) -> np.ndarray:
    c_init = (link.rnti << 14) + (q << 13) + (link.sf_idx << 9) + link.cell_id
    return tables.gold(c_init, link.G)


def qam_axis(b: torch.Tensor) -> torch.Tensor:
    """36.211 7.1: one axis of square QAM from its bits b0, b2, b4, ...
    (..., m) 0/1 -> (...,): (1-2b0)(2^(m-1) - (1-2b1)(2^(m-2) - ...))."""
    s = 1.0 - 2.0 * b.to(torch.float64)
    m = b.shape[-1]
    v = s[..., m - 1]
    for j in range(m - 2, -1, -1):
        v = s[..., j] * (2.0 ** (m - 1 - j) - v)
    return v


def modulate(bits: torch.Tensor, qm: int, prec: Precision) -> torch.Tensor:
    """(B, G) -> (B, G / qm) complex symbols of unit mean power."""
    b = bits.reshape(bits.shape[0], -1, qm)
    norm = {2: 2.0, 4: 10.0, 6: 42.0, 8: 170.0}[qm] ** 0.5
    sym = torch.complex(qam_axis(b[..., 0::2]), qam_axis(b[..., 1::2])) / norm
    return prec.q(sym.to(prec.complex))


def grid(syms: torch.Tensor, link: tables.Link, prec: Precision) -> torch.Tensor:
    """(B, n_re) -> (B, 14, NRE): PDSCH symbols and port 0's CRS, zero elsewhere."""
    B = syms.shape[0]
    g = torch.zeros((B, tables.N_SYM * link.nre), dtype=prec.complex, device=syms.device)
    g[:, torch.from_numpy(link.re_idx).to(syms.device)] = syms
    g = g.reshape(B, tables.N_SYM, link.nre)
    for l, (k, r) in zip(tables.CRS_SYMS, tables.crs(link.n_prb, link.cell_id, link.sf_idx)):
        g[:, l, torch.from_numpy(k).to(g.device)] = prec.q(
            torch.from_numpy(r).to(device=g.device, dtype=prec.complex))
    return g


def ofdm(g: torch.Tensor, link: tables.Link, prec: Precision) -> torch.Tensor:
    """(B, 14, NRE) -> (B, SF_LEN) time samples (unitary IFFT, normal CP)."""
    n, bins, cps = tables.ofdm_layout(link.n_prb)
    x = torch.zeros(g.shape[:2] + (n,), dtype=prec.complex, device=g.device)
    x[:, :, torch.from_numpy(bins).to(g.device)] = g
    t = prec.q(torch.fft.ifft(x, dim=-1, norm="ortho"))
    return torch.cat([torch.cat([t[:, l, n - cp:], t[:, l]], dim=1)
                      for l, cp in enumerate(cps)], dim=1)


def encode(payload: torch.Tensor, link: tables.Link, prec: Precision = REFERENCE) -> torch.Tensor:
    """(B, tbs) bits -> (B, SF_LEN, 2) real time samples."""
    bits = codeword(payload, link)
    c = torch.from_numpy(scrambling(link).astype(np.int8)).to(bits.device)
    x = ofdm(grid(modulate(bits ^ c, link.qm, prec), link, prec), link, prec)
    return torch.view_as_real(x)


def add_noise(tx: torch.Tensor, unit_noise: torch.Tensor, snr_db: float) -> torch.Tensor:
    """AWGN at snr_db against each row's measured power, mean |x|^2 over its
    samples: rx = tx + unit_noise * sqrt(power / snr / 2), with unit_noise of
    variance 1 in each of the real and imaginary parts."""
    m = tx.square().mean(dim=(1, 2))  # power / 2
    std = (m / 10.0 ** (snr_db / 10.0)).sqrt()  # snr_db: a number or one per row
    return tx + unit_noise.to(tx.dtype) * std[:, None, None]


def demodulate(rx: torch.Tensor, link: tables.Link, prec: Precision) -> torch.Tensor:
    """(B, SF_LEN, 2) -> (B, 14, NRE) received grid."""
    n, bins, cps = tables.ofdm_layout(link.n_prb)
    x = prec.q(torch.view_as_complex(rx.to(prec.real).contiguous()).to(prec.complex))
    starts = np.cumsum([0] + [cp + n for cp in cps])[:-1] + np.asarray(cps)
    sym = torch.stack([x[:, s:s + n] for s in starts], dim=1)
    return prec.q(torch.fft.fft(sym, dim=-1, norm="ortho")[..., torch.from_numpy(bins).to(rx.device)])


@functools.lru_cache(maxsize=None)
def _interp(n_out: int, at: tuple) -> np.ndarray:
    """(n_out, len(at)) weights of linear interpolation between the two
    nearest samples at positions `at`, extrapolated from the end segments."""
    at = np.asarray(at, np.float64)
    w = np.zeros((n_out, len(at)))
    for x in range(n_out):
        j = int(np.clip(np.searchsorted(at, x, side="right") - 1, 0, len(at) - 2))
        t = (x - at[j]) / (at[j + 1] - at[j])
        w[x, j], w[x, j + 1] = 1 - t, t
    return w


def estimate(g: torch.Tensor, link: tables.Link, prec: Precision) -> torch.Tensor:
    """Port 0's CRS: least squares at the pilots, linear in frequency per
    pilot symbol, then linear in time over the pilot symbols -> (B, 14, NRE)."""
    dev = g.device
    per_sym = []
    for l, (k, r) in zip(tables.CRS_SYMS, tables.crs(link.n_prb, link.cell_id, link.sf_idx)):
        ls = prec.q(g[:, l, torch.from_numpy(k).to(dev)]
                    * torch.from_numpy(np.conj(r)).to(device=dev, dtype=prec.complex))
        wf = torch.from_numpy(_interp(link.nre, tuple(k.tolist()))).to(device=dev,
                                                                        dtype=prec.complex)
        per_sym.append(prec.q(ls @ wf.T))
    h = torch.stack(per_sym, dim=1)  # (B, 4, NRE)
    wt = torch.from_numpy(_interp(tables.N_SYM, tables.CRS_SYMS))
    return prec.q(torch.einsum("ls,bsk->blk", wt.to(device=dev, dtype=prec.complex), h))


def demod_soft(x: torch.Tensor, qm: int) -> torch.Tensor:
    """srsLTE's zone soft demodulator (demod_soft.c), positive for bit 0:
    (B, n) complex -> (B, n * qm)."""
    a = [x.real, x.imag]
    if qm == 2:
        out = [v * 2 ** 0.5 for v in a]
    else:
        norm = {4: 10.0, 6: 42.0, 8: 170.0}[qm] ** 0.5
        out, t = list(a), a
        for level in range(qm // 2 - 1, 0, -1):
            c = 2.0 ** level / norm
            if level == 1:
                out += [c - v.abs() for v in t]
            else:
                t = [v.abs() - c for v in t]
                out += [-v for v in t]
    return torch.stack(out, dim=-1).reshape(x.shape[0], -1)


def front_end(rx: torch.Tensor, link: tables.Link, prec: Precision = REFERENCE):
    """(B, SF_LEN, 2) -> (soft buffers [(B, 3 Kp_r)], channel estimate
    (B, 14, NRE, 2) real).  The soft buffers are in bfloat16 where llr_bits
    is 16 or less, else in the precision's real type."""
    g = demodulate(rx, link, prec)
    ce = estimate(g, link, prec)
    idx = torch.from_numpy(link.re_idx).to(rx.device)
    y = g.reshape(g.shape[0], -1)[:, idx]
    h = ce.reshape(ce.shape[0], -1)[:, idx]
    csi = prec.q(h.real.square() + h.imag.square())
    xe = prec.q(y * h.conj() / torch.clamp(csi, min=1e-9))
    llr = prec.q(demod_soft(xe, link.qm) * torch.repeat_interleave(csi, link.qm, dim=1))
    c = torch.from_numpy(scrambling(link).astype(np.float64)).to(device=rx.device,
                                                                 dtype=llr.dtype)
    llr = llr * (1 - 2 * c)
    sb_type = torch.bfloat16 if link.llr_bits <= 16 else llr.dtype
    llr = llr.to(sb_type)
    s = link.segm
    bufs, off = [], 0
    for r, k in enumerate(s.sizes):
        e = link.e_sizes[r]
        f = s.F if r == 0 else 0
        pos = torch.from_numpy(tables.selection(k, f, e)).to(rx.device)
        w = torch.zeros((llr.shape[0], len(tables.circular_buffer(k, f))),
                        dtype=sb_type, device=rx.device)
        w.index_add_(1, pos, llr[:, off:off + e])
        bufs.append(w)
        off += e
    return bufs, torch.view_as_real(ce.contiguous()).to(torch.float32 if prec.bf16 else prec.real)
