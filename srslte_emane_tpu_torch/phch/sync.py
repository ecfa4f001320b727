"""PSS/SSS synchronization and cell search.

Twin of the reference's `phch/sync.py` (`lib/src/phy/sync/pss.c`: ZC roots
u in {25, 29, 34}, cross-correlation at 1.92 Msps, peak-to-mean quality;
`sync/sss.c` + `find_sss.c`: m-sequence SSS, N_id_1 and subframe detection;
`ue/ue_cell_search.c`: composite search over N_id_2).  The sequences are
host numpy; `put_pss_sss` writes them into a subframe grid on the device
(enb_dl.c put_base).  On the UE side the PSS correlation for all 3 roots
and every lag is one conv1d of the samples against the replicas, and the
SSS detection one (B, 62) x (62, 336) product per N_id_2 over
every (N_id_1, subframe) hypothesis.  Ties go to the first maximum over
the reference's flattened layouts.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import cplx, dft, ofdm

PSS_ROOTS = {0: 25, 1: 29, 2: 34}


@functools.lru_cache(maxsize=None)
def pss_freq(n_id_2: int) -> np.ndarray:
    """62-length ZC PSS (36.211 §6.11.1)."""
    u = PSS_ROOTS[n_id_2]
    n = np.arange(31)
    a = np.exp(-1j * np.pi * u * n * (n + 1) / 63)
    b = np.exp(-1j * np.pi * u * (n + 31 + 1) * (n + 31 + 2) / 63)
    return np.concatenate([a, b]).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def pss_time(n_id_2: int, fft_size: int = 128) -> np.ndarray:
    """Time-domain PSS replica (one OFDM symbol, no CP), unit energy."""
    x = np.zeros(fft_size, dtype=np.complex64)
    d = pss_freq(n_id_2)
    # subcarriers -31..-1, +1..+31
    x[fft_size - 31 :] = d[:31]
    x[1:32] = d[31:]
    t = np.fft.ifft(x)
    return (t / np.linalg.norm(t)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _mseq(poly_taps: tuple) -> np.ndarray:
    """31-length m-sequence in bipolar form, x(0..4) init = (0,0,0,0,1)."""
    x = np.zeros(31, dtype=np.int64)
    x[4] = 1
    for i in range(26):
        x[i + 5] = sum(x[i + t] for t in poly_taps) % 2
    return (1 - 2 * x).astype(np.float32)


def _s_tilde():
    return _mseq((0, 2))  # x^5 + x^2 + 1


def _c_tilde():
    return _mseq((0, 3))  # x^5 + x^3 + 1


def _z_tilde():
    return _mseq((0, 1, 2, 4))  # x^5 + x^4 + x^2 + x + 1


def _m0m1(n_id_1: int):
    qp = n_id_1 // 30
    q = (n_id_1 + qp * (qp + 1) // 2) // 30
    mp = n_id_1 + q * (q + 1) // 2
    m0 = mp % 31
    m1 = (m0 + mp // 31 + 1) % 31
    return m0, m1


@functools.lru_cache(maxsize=None)
def sss_sequence(n_id_1: int, n_id_2: int, sf_idx: int) -> np.ndarray:
    """62-length bipolar SSS (36.211 §6.11.2); sf_idx in {0, 5}."""
    m0, m1 = _m0m1(n_id_1)
    s, c, z = _s_tilde(), _c_tilde(), _z_tilde()
    n = np.arange(31)
    s0 = s[(n + m0) % 31]
    s1 = s[(n + m1) % 31]
    c0 = c[(n + n_id_2) % 31]
    c1 = c[(n + n_id_2 + 3) % 31]
    z0 = z[(n + (m0 % 8)) % 31]
    z1 = z[(n + (m1 % 8)) % 31]
    d = np.zeros(62, dtype=np.float32)
    if sf_idx == 0:
        d[0::2] = s0 * c0
        d[1::2] = s1 * c1 * z0
    else:
        d[0::2] = s1 * c0
        d[1::2] = s0 * c1 * z1
    return d


@functools.lru_cache(maxsize=32)
def _device_tables(cell, sf_idx: int, device: torch.device):
    """(flat PSS REs, flat SSS REs, PSS values, SSS values) on `device`."""
    nre = cell.nre
    l_pss = 6 if cell.cp == "normal" else 5
    ks = np.arange(nre // 2 - 31, nre // 2 + 31, dtype=np.int64)
    sss = sss_sequence(cell.cell_id // 3, cell.cell_id % 3, sf_idx).astype(np.complex64)
    return (torch.from_numpy(l_pss * nre + ks).to(device),
            torch.from_numpy((l_pss - 1) * nre + ks).to(device),
            cplx.from_numpy(pss_freq(cell.cell_id % 3), device),
            cplx.from_numpy(sss, device))


def put_pss_sss(grid: torch.Tensor, cell, sf_idx: int) -> torch.Tensor:
    """eNB-side: place PSS (last symbol of slot 0) and SSS (one earlier) on
    sf 0/5 (enb_dl.c put_base equivalent), into a copy of grid.  Normal CP:
    symbols 6/5; extended CP: symbols 5/4 (6-symbol slots, 36.211 6.11)."""
    if sf_idx not in (0, 5):
        return grid
    pss_re, sss_re, pss, sss = _device_tables(cell, sf_idx, grid.device)
    flat = grid.reshape(grid.shape[0], -1, 2).clone()
    flat[:, pss_re, :] = pss
    flat[:, sss_re, :] = sss
    return flat.reshape(grid.shape)


def pss_symbol_start(n_prb: int, cp: str = "normal") -> int:
    """Sample index of the PSS symbol (no CP) within the subframe."""
    p = ofdm.params(n_prb, cp=cp)
    n_before = 6 if cp == "normal" else 5  # symbols preceding the PSS
    return (p["cp0"] + p["n"]) + (n_before - 1) * (p["cp"] + p["n"]) + p["cp"]


# ---------------- UE side: PSS correlation, SSS detection, cell search ----------------

@functools.lru_cache(maxsize=None)
def _sss_bank(n_id_2: int) -> np.ndarray:
    """(62, 336) matrix: all (N_id_1 x {sf0, sf5}) SSS hypotheses."""
    cols = []
    for n1 in range(168):
        for sf in (0, 5):
            cols.append(sss_sequence(n1, n_id_2, sf))
    return np.stack(cols, axis=1)


def _to(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


@functools.lru_cache(maxsize=16)
def _pss_replicas(fft_size: int, device: torch.device) -> torch.Tensor:
    """(6, 2, fft) conv1d weight: channels (re, im) of a window against it
    give [re (3) | im (3)] of its correlation with the 3 conjugated PSS
    replicas."""
    reps = np.stack([pss_time(i, fft_size) for i in range(3)])  # (3, fft)
    w_re, w_im = reps.real, -reps.imag
    return _to(np.stack([np.stack([w_re, -w_im], 1), np.stack([w_im, w_re], 1)]).reshape(
        6, 2, fft_size), device)


@functools.lru_cache(maxsize=16)
def _sss_banks(device: torch.device) -> torch.Tensor:
    """(3, 62, 336): `_sss_bank` of each N_id_2 on `device`."""
    return _to(np.stack([_sss_bank(h) for h in range(3)]), device)


def pss_correlate(samples: torch.Tensor, fft_size: int = 128):
    """samples (B, T, 2) -> correlation energy (B, 3, T-fft_size+1) and
    complex corr (B, lags, 3, 2) for CFO use.  One conv1d over the (B, 2, T)
    samples slides the replicas; no window is copied."""
    B = samples.shape[0]
    out = F.conv1d(samples.transpose(1, 2), _pss_replicas(fft_size, samples.device))
    corr = out.reshape(B, 2, 3, -1).permute(0, 3, 2, 1)  # (B, lags, 3, 2)
    return out[:, :3] ** 2 + out[:, 3:] ** 2, corr


def pss_find(samples: torch.Tensor, fft_size: int = 128):
    """Peak search: returns (n_id_2 (B,), peak_pos (B,), quality (B,))."""
    e, _ = pss_correlate(samples, fft_size)  # (B, 3, lags)
    B, lags = e.shape[0], e.shape[-1]
    flat = e.reshape(B, -1)
    peak = flat.max(dim=-1).values
    best = flat.argmax(dim=-1)  # the first maximum
    mean = e.mean(dim=(-1, -2))
    return ((best // lags).to(torch.int32), (best % lags).to(torch.int32),
            peak / (mean + 1e-12))


def sss_find(sss_freq_62: torch.Tensor, n_id_2: int):
    """sss_freq_62: (B, 62, 2) equalized/raw SSS subcarriers.  Non-coherent
    correlation against all hypotheses.  Returns (n_id_1 (B,), sf_idx (B,),
    metric (B,))."""
    return _sss_pick(sss_freq_62, _sss_banks(sss_freq_62.device)[n_id_2])


def _sss_pick(sss_freq_62, bank):
    re = sss_freq_62[..., 0] @ bank
    im = sss_freq_62[..., 1] @ bank
    m = re * re + im * im  # phase-agnostic
    best = m.argmax(dim=-1)  # the first maximum
    return ((best // 2).to(torch.int32), torch.where(best % 2 == 0, 0, 5).to(torch.int32),
            m.max(dim=-1).values)


def _sss_hypothesis(samples, pos, n_id_2, fft_size: int, cp: int):
    """SSS decode under one CP-length hypothesis: the SSS symbol starts
    (fft_size + cp) samples before the PSS peak.  Returns per-batch
    (n_id_1, sf_idx, metric) for the detected n_id_2."""
    start = torch.clamp(pos.to(torch.int64) - fft_size - cp, min=0)
    idx = start[:, None] + torch.arange(fft_size, device=samples.device)[None, :]
    sss_td = torch.gather(samples, 1, idx[..., None].expand(-1, -1, 2))  # (B, fft, 2)
    f = dft.dft(sss_td)
    # center 62 bins: negative freqs at [-31..-1] -> bins N-31..N-1, +1..+31
    bins = np.concatenate([np.arange(fft_size - 31, fft_size), np.arange(1, 32)])
    sss62 = f[:, torch.from_numpy(bins).to(samples.device)]
    banks = _sss_banks(samples.device)
    # every row against the bank of each n_id_2, then the detected one's pick
    n1, sf, m = (torch.stack(v, 1) for v in zip(*(_sss_pick(sss62, banks[h]) for h in range(3))))
    sel = n_id_2[:, None].to(torch.int64)
    return (n1.gather(1, sel)[:, 0], sf.gather(1, sel)[:, 0], m.gather(1, sel)[:, 0])


def cell_search(samples: torch.Tensor, fft_size: int = 128, detect_cp: bool = False):
    """Composite search on (B, T, 2) 1.92 Msps-equivalent samples (6-PRB
    wide).  Returns dict(n_id_2, pss_pos, quality, n_id_1, sf_idx, cell_id
    [, cp_ext]), the ue_cell_search.c equivalent, batched.  The SSS is read
    one symbol (+CP) before the PSS peak; detect_cp=True decodes it under
    both CP hypotheses (normal 9, extended 32 samples at 128) and picks per
    row by metric (sync.c:68-78)."""
    n_id_2, pos, quality = pss_find(samples, fft_size)
    n_id_1, sf_idx, metric = _sss_hypothesis(samples, pos, n_id_2, fft_size,
                                             9 * fft_size // 128)
    out = dict(n_id_2=n_id_2, pss_pos=pos, quality=quality)
    if detect_cp:
        n1_e, sf_e, m_e = _sss_hypothesis(samples, pos, n_id_2, fft_size, 32 * fft_size // 128)
        is_ext = m_e > metric
        n_id_1 = torch.where(is_ext, n1_e, n_id_1)
        sf_idx = torch.where(is_ext, sf_e, sf_idx)
        out["cp_ext"] = is_ext
    out.update(n_id_1=n_id_1, sf_idx=sf_idx, cell_id=3 * n_id_1 + n_id_2)
    return out
