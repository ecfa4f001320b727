"""PRACH: Zadoff-Chu preamble generation + eNB correlation detection, and
the time-domain waveform of formats 0-4.

Twin of the reference's `phch/prach.py` (`lib/src/phy/phch/prach.c`):
839-length ZC roots in the logical order of 36.211 Table 5.7.2-4
(`prach_tables.npz`, a byte-for-byte copy of the reference's), N_cs
zero-correlation-zone shifts (Table 5.7.2-2, unrestricted and restricted
set type A), frequency-domain root correlation with a per-shift window
peak search (prach.c:235-266).  Detection correlates every distinct root
of the cell in one (B, roots, N_ZC) x (N_ZC, N_ZC) product with the IDFT
matrices, built once per (N_ZC, device); the window peaks of all 64
preambles are one gather.  The waveform synthesis and analysis over the
sparse PRACH bins are two-stage (a per-bin twiddle, then one product),
as in the reference.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

from ..ops import cplx
from ..utils.devices import resolve

_DATA = np.load(pathlib.Path(__file__).parent / "prach_tables.npz")
ZC_ROOTS = _DATA["zc_roots"]  # logical order, formats 0-3
ZC_ROOTS_F4 = _DATA["zc_roots_f4"]  # logical order, format 4 (N_ZC=139)
N_ZC = 839
N_ZC_F4 = 139
# 36.211 Table 5.7.2-2 (unrestricted and restricted set type A)
NCS_UNRESTRICTED = [0, 13, 15, 18, 22, 26, 32, 38, 46, 59, 76, 93, 119, 167, 279, 419]
NCS_RESTRICTED = [15, 18, 22, 26, 32, 38, 46, 55, 68, 82, 100, 128, 158, 202, 237]
NCS_F4 = [2, 4, 6, 8, 10, 12, 15]  # 36.211 Table 5.7.2-3 (preamble format 4)

# 36.211 Table 5.7.1-1, in 30.72 Msps samples: format -> (T_CP, n_repeats)
# of the base sequence (24576 samples at 1.25 kHz for 0-3; 4096 at 7.5 kHz
# for format 4).  prach.c:235-266 prach_Tcp / prach_Tseq.
FORMAT_CP = {0: 3168, 1: 21024, 2: 6240, 3: 21024, 4: 448}
FORMAT_REPS = {0: 1, 1: 1, 2: 2, 3: 2, 4: 1}


def nzc_for(fmt: int) -> int:
    return N_ZC_F4 if fmt == 4 else N_ZC


def _d_u(u: int, nzc: int = N_ZC) -> int:
    """Cyclic-shift distance due to Doppler: d_u = p or N_ZC - p where
    (p u) mod N_ZC = 1 (36.211 §5.7.2)."""
    p = pow(u, -1, nzc)
    return p if p < nzc // 2 else nzc - p


def _restricted_shifts(u: int, n_cs: int):
    """Valid cyclic shifts Cv of root u in restricted set type A."""
    du = _d_u(u)
    if n_cs <= du < N_ZC // 3:
        n_shift = du // n_cs
        d_start = 2 * du + n_shift * n_cs
        n_group = N_ZC // d_start
        n_shift_bar = max(0, (N_ZC - 2 * du - n_group * d_start) // n_cs)
    elif N_ZC // 3 <= du <= (N_ZC - n_cs) // 2:
        n_shift = (N_ZC - 2 * du) // n_cs
        d_start = N_ZC - 2 * du + n_shift * n_cs
        n_group = du // d_start
        n_shift_bar = min(max(0, (du - n_group * d_start) // n_cs), n_shift)
    else:
        return []
    total = n_shift * n_group + n_shift_bar
    return [d_start * (v // n_shift) + (v % n_shift) * n_cs for v in range(total)]


@functools.lru_cache(maxsize=None)
def _zc_freq(u: int, nzc: int = N_ZC) -> np.ndarray:
    n = np.arange(nzc)
    x = np.exp(-1j * np.pi * u * n * (n + 1) / nzc)
    return np.fft.fft(x).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def preamble_params(root_seq_idx: int, zczc: int, fmt: int = 0):
    """(roots list, n_cs, shifts per root) for 64 preambles."""
    nzc = nzc_for(fmt)
    n_cs = (NCS_F4 if fmt == 4 else NCS_UNRESTRICTED)[zczc]
    n_shifts = nzc // n_cs if n_cs > 0 else 1
    n_roots = -(-64 // n_shifts)
    tbl = ZC_ROOTS_F4 if fmt == 4 else ZC_ROOTS
    roots = [int(tbl[(root_seq_idx + i) % len(tbl)]) for i in range(n_roots)]
    return roots, n_cs, n_shifts


@functools.lru_cache(maxsize=None)
def shift_list(root_seq_idx: int, zczc: int, hs: bool = False, fmt: int = 0):
    """The 64 (root u, cyclic shift Cv) preamble assignments + n_cs.
    hs=True uses restricted set type A (variable shifts per root; formats
    0-3 only: 36.211 defines no restricted set for format 4)."""
    if not hs or fmt == 4:
        roots, n_cs, n_shifts = preamble_params(root_seq_idx, zczc, fmt)
        out = [(roots[i // n_shifts], (i % n_shifts) * n_cs) for i in range(64)]
        return out, n_cs
    n_cs = NCS_RESTRICTED[zczc]
    out = []
    i = 0
    while len(out) < 64:
        u = int(ZC_ROOTS[(root_seq_idx + i) % 838])
        for cv in _restricted_shifts(u, n_cs):
            out.append((u, cv))
            if len(out) == 64:
                break
        i += 1
    return out, n_cs


@functools.lru_cache(maxsize=None)
def preamble_freq_table(root_seq_idx: int, zczc: int, hs: bool = False,
                        fmt: int = 0) -> np.ndarray:
    """(64, N_ZC) complex64 frequency-domain preambles."""
    pairs, n_cs = shift_list(root_seq_idx, zczc, hs, fmt)
    nzc = nzc_for(fmt)
    out = np.zeros((64, nzc), dtype=np.complex64)
    k = np.arange(nzc)
    for i, (u, cv) in enumerate(pairs):
        # time shift x((n + Cv) mod Nzc) <-> freq X[k] * e^{+j 2 pi k Cv / Nzc}
        out[i] = _zc_freq(u, nzc) * np.exp(1j * 2 * np.pi * k * cv / nzc)
    return out


@functools.lru_cache(maxsize=16)
def _preamble_table(root_seq_idx: int, zczc: int, hs: bool, fmt: int, device: torch.device):
    return cplx.from_numpy(preamble_freq_table(root_seq_idx, zczc, hs, fmt), device)


def gen(preamble_idx, root_seq_idx: int = 0, zczc: int = 1, hs: bool = False,
        fmt: int = 0, device="cuda") -> torch.Tensor:
    """(B,) preamble indices (array or tensor) -> (B, N_ZC, 2)
    frequency-domain preambles on `device` ("cuda" by default: it raises
    where there is no card)."""
    dev = resolve(device, "prach.gen")
    idx = torch.as_tensor(preamble_idx, dtype=torch.int64).to(dev)
    return _preamble_table(root_seq_idx, zczc, hs, fmt, dev)[idx]


@functools.lru_cache(maxsize=8)
def _idft_matrices(nzc: int, device: torch.device):
    """The (N_ZC, N_ZC) inverse DFT (1/N_ZC) as float32 (re, im)."""
    ph = 2 * np.pi * np.outer(np.arange(nzc), np.arange(nzc)) / nzc
    f = lambda a: torch.from_numpy(a.astype(np.float32) / nzc).to(device)
    return f(np.cos(ph)), f(np.sin(ph))


@functools.lru_cache(maxsize=32)
def _detect_tables(root_seq_idx: int, zczc: int, hs: bool, fmt: int, device: torch.device):
    """(distinct roots' ZC spectra (R, N_ZC, 2), each preamble's root
    (64,), each preamble's window lags (64, W)): a preamble with cyclic
    shift Cv peaks at lag (N_ZC - Cv + delay) mod N_ZC, in the window
    [N - Cv, N - Cv + N_cs); with N_cs = 0 the window is every lag."""
    pairs, n_cs = shift_list(root_seq_idx, zczc, hs, fmt)
    nzc = nzc_for(fmt)
    roots = list(dict.fromkeys(u for u, _ in pairs))
    xu = np.stack([_zc_freq(u, nzc) for u in roots])
    root_of = np.array([roots.index(u) for u, _ in pairs])
    width = n_cs if n_cs > 0 else nzc
    lags = np.stack([(nzc - cv + np.arange(width)) % nzc if n_cs > 0 else np.arange(nzc)
                     for _, cv in pairs])
    t = lambda a: torch.from_numpy(a.astype(np.int64)).to(device)
    return cplx.from_numpy(xu, device), t(root_of), t(lags)


def detect(rx_freq: torch.Tensor, root_seq_idx: int = 0, zczc: int = 1,
           threshold: float = 8.0, hs: bool = False, fmt: int = 0):
    """eNB detection: rx_freq (B, N_ZC, 2) -> per-preamble metrics.

    Returns (detected (B, 64) bool, metric (B, 64), t_offset (B, 64) int32
    in ZC samples)."""
    xu, root_of, lags = _detect_tables(root_seq_idx, zczc, hs, fmt, rx_freq.device)
    idft_re, idft_im = _idft_matrices(nzc_for(fmt), rx_freq.device)
    # |IDFT(X_rx * conj(X_u))|^2 for every distinct root u: (B, R, N_ZC)
    prod = cplx.mul_conj(rx_freq[:, None], xu[None])
    corr = cplx.abs2(cplx.matmul(prod, idft_re, idft_im))
    mean_c = corr.mean(dim=-1) + 1e-20  # (B, R)
    win = corr[:, root_of[:, None], lags]  # (B, 64, W)
    peak, pos = win.max(dim=-1).values, win.argmax(dim=-1)  # the first maximum
    m = peak / mean_c[:, root_of]
    return m > threshold, m, pos.to(torch.int32)


# ---------------- waveform embedding (formats 0-4) ----------------
# Formats 0-3 (1.25 kHz numerology): base sequence T_SEQ = 800 us -> 24576
# samples at 30.72 Msps, repeated once (formats 0/1) or twice (2/3), with
# per-format CP lengths (36.211 Table 5.7.1-1; prach.c:235-266).  Format 4
# (7.5 kHz, TDD UpPTS): 139-length ZC over 4096 samples, 448-sample CP.
# The synthesis IDFT over the sparse bins factors as n = B a + b: a per-bin
# twiddle stage, then one (nzc -> A) product.

N_SEQ = 24576
N_SEQ_F4 = 4096
N_CP_F0 = 3168
_CT_B = 24
_CT_A = N_SEQ // _CT_B  # 1024


def _ct_split(fmt: int, srate_div: int = 1):
    """(n_seq, ct_b, ct_a) of one base-sequence repetition.  srate_div
    scales the synthesis to the cell sample rate (prach.c sizes its IFFT as
    24576 * srate / 30.72 Msps): 16 for a 1.92 Msps 6-PRB cell, 2 for
    10 MHz, 1 for 20 MHz."""
    if fmt == 4:
        return N_SEQ_F4 // srate_div, 16, N_SEQ_F4 // srate_div // 16
    return N_SEQ // srate_div, _CT_B, _CT_A // srate_div


@functools.lru_cache(maxsize=None)
def _ct_tables(k0: int, fmt: int = 0, srate_div: int = 1):
    """The two stages' constants at bin offset k0: twiddles (nzc, ct_b) and
    the (nzc, ct_a) transform."""
    n_seq, ct_b, ct_a = _ct_split(fmt, srate_div)
    k = np.arange(nzc_for(fmt)) + k0
    tw = np.exp(2j * np.pi * np.outer(k, np.arange(ct_b)) / n_seq)
    e = np.exp(2j * np.pi * np.outer(k, np.arange(ct_a) * ct_b) / n_seq)
    return tw.astype(np.complex64), e.astype(np.complex64)


@functools.lru_cache(maxsize=16)
def _ct_device_tables(k0: int, fmt: int, srate_div: int, device: torch.device):
    tw, e = _ct_tables(k0, fmt, srate_div)
    return cplx.from_numpy(tw, device), cplx.from_numpy(e, device)


def waveform_len(fmt: int = 0, srate_div: int = 1) -> int:
    """CP + repeated sequence, in (30.72 / srate_div) Msps samples."""
    n_seq, _, _ = _ct_split(fmt, srate_div)
    return FORMAT_CP[fmt] // srate_div + FORMAT_REPS[fmt] * n_seq


def gen_waveform(preamble_idx, root_seq_idx: int = 0, zczc: int = 1, hs: bool = False,
                 k0: int = 12 * 12 + 7, fmt: int = 0, srate_div: int = 1,
                 device="cuda") -> torch.Tensor:
    """(B,) preamble indices -> (B, waveform_len(fmt), 2) time samples at
    30.72 / srate_div Msps (prach.c srslte_prach_gen waveform path).

    k0: first occupied PRACH bin (1.25 kHz spacing for formats 0-3, 7.5 kHz
    for format 4; the default centers the 6-PRB region near
    prach_freq_offset=12 PRB).  Runs on `device`, as `gen`."""
    x = gen(preamble_idx, root_seq_idx, zczc, hs, fmt, device)  # (B, nzc, 2)
    n_seq, _, _ = _ct_split(fmt, srate_div)
    tw, e = _ct_device_tables(k0, fmt, srate_div, x.device)
    y = cplx.mul(x[:, :, None, :], tw[None])  # stage 1: (B, nzc, ct_b, 2)
    yr, yi, er, ei = y[..., 0], y[..., 1], e[..., 0], e[..., 1]
    # stage 2: x[a, b] = sum_k Y[k, b] E[k, a]
    xr = torch.einsum("bkc,ka->bac", yr, er) - torch.einsum("bkc,ka->bac", yi, ei)
    xi = torch.einsum("bkc,ka->bac", yr, ei) + torch.einsum("bkc,ka->bac", yi, er)
    t = cplx.make(xr, xi).reshape(x.shape[0], n_seq, 2) / np.sqrt(nzc_for(fmt))
    t = torch.cat([t] * FORMAT_REPS[fmt], dim=-2)
    n_cp = FORMAT_CP[fmt] // srate_div
    return torch.cat([t[:, t.shape[-2] - n_cp :, :], t], dim=-2)


def rx_waveform_to_freq(samples: torch.Tensor, k0: int = 12 * 12 + 7, fmt: int = 0,
                        srate_div: int = 1) -> torch.Tensor:
    """eNB side: (B, >= waveform_len(fmt), 2) -> (B, nzc, 2) PRACH bins.
    The analysis DFT over the same sparse bins, two-stage transposed;
    formats 2/3 average their two repetitions coherently (prach.c)."""
    n_seq, ct_b, ct_a = _ct_split(fmt, srate_div)
    n_cp, reps = FORMAT_CP[fmt] // srate_div, FORMAT_REPS[fmt]
    t = samples[:, n_cp : n_cp + reps * n_seq, :]
    y = t.reshape(t.shape[0], reps, ct_a, ct_b, 2).mean(dim=1)
    tw, e = _ct_device_tables(k0, fmt, srate_div, samples.device)
    yr, yi, er, ei = y[..., 0], y[..., 1], e[..., 0], -e[..., 1]  # E* for the analysis
    # stage 1 (transpose of synthesis stage 2): Z[k, b] = sum_a y[a, b] E*[k, a]
    zr = torch.einsum("bac,ka->bkc", yr, er) - torch.einsum("bac,ka->bkc", yi, ei)
    zi = torch.einsum("bac,ka->bkc", yr, ei) + torch.einsum("bac,ka->bkc", yi, er)
    # stage 2: X[k] = sum_b Z[k, b] tw*[k, b]
    out = cplx.mul_conj(cplx.make(zr, zi), tw[None]).sum(dim=-2)
    return out / np.sqrt(nzc_for(fmt)) / ct_b
