"""36.212 §5.1.4.1 turbo rate matching.

Twin of the reference's `ops/fec/rm_turbo.py`: flat index tables are
computed on the host once per (K, F, E, rv, Ncb) configuration (and uploaded
once per device); the device op is one batched gather (TX), or a gather +
sum soft-combine into the HARQ w-buffer (RX).  NULL fillers and interleaver
dummies never touch the device.  The `_dyn` variants take one redundancy
version per row as a tensor (the in-block HARQ path's RV cycling).

LLR convention: positive LLR <=> bit 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

NCOLS = 32
# 36.212 Table 5.1.4-1 inter-column permutation pattern (== RM_PERM_TC).
PERM_TC = np.array(
    [0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
     1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31],
    dtype=np.int64,
)

DUMMY = -1  # sub-block interleaver padding
FILLER = -2  # NULL filler bits (first CB only)

FILLER_LLR = 127.0  # clamp value for known-zero filler bits at RX


@functools.lru_cache(maxsize=None)
def wbuf_map(k: int, f: int) -> np.ndarray:
    """Circular-buffer source map for CB size k with f leading fillers.

    Returns int32 array (3*Kp,) where entry is  stream*D + d_index  into the
    flattened (d0|d1|d2) array (D = k+4), or DUMMY / FILLER.
    """
    D = k + 4
    R = -(-D // NCOLS)
    Kp = NCOLS * R
    nd = Kp - D

    def stream_y(stream):
        y = np.full(Kp, DUMMY, dtype=np.int64)
        idx = np.arange(D)
        src = stream * D + idx
        if stream in (0, 1) and f > 0:
            # d0/d1 positions < f are NULL fillers (turbocoder.c:106-128)
            src = np.where(idx < f, FILLER, src)
        y[nd:] = src
        return y

    # streams 0/1: row-major fill, column permutation, column-major read
    rows = np.arange(R)
    v01 = []
    for s in (0, 1):
        y = stream_y(s)
        # v[col*R + row] = y[row*NCOLS + PERM_TC[col]]
        v01.append(y[(rows[None, :] * NCOLS + PERM_TC[:, None]).reshape(-1)])
    # stream 2: pi(n) = (PERM_TC[n // R] + NCOLS*(n % R) + 1) mod Kp
    n = np.arange(Kp)
    pi = (PERM_TC[n // R] + NCOLS * (n % R) + 1) % Kp
    v2 = stream_y(2)[pi]

    w = np.empty(3 * Kp, dtype=np.int64)
    w[:Kp] = v01[0]
    w[Kp::2] = v01[1]
    w[Kp + 1 :: 2] = v2
    return w.astype(np.int32)


def k0_index(k: int, rv: int, ncb: int) -> int:
    """Bit-selection start k0 = R*(2*ceil(Ncb/(8R))*rv + 2) (36.212 §5.1.4.1.2)."""
    R = -(-(k + 4) // NCOLS)
    return R * (2 * (-(-ncb // (8 * R))) * rv + 2)


@functools.lru_cache(maxsize=None)
def rx_table(k: int, f: int, e: int, rv: int, ncb: int = 0) -> np.ndarray:
    """Scatter targets (e,) : w-buffer position receiving each incoming LLR."""
    w = wbuf_map(k, f)
    if ncb <= 0 or ncb > len(w):
        ncb = len(w)
    k0 = k0_index(k, rv, ncb)
    valid_pos = np.flatnonzero(w[:ncb] >= 0)
    # rotate so selection starts at first valid index >= k0 (circular)
    start = np.searchsorted(valid_pos, k0)
    rot = np.roll(valid_pos, -start)
    return rot[np.arange(e) % len(rot)].astype(np.int32)


@functools.lru_cache(maxsize=None)
def tx_table(k: int, f: int, e: int, rv: int, ncb: int = 0) -> np.ndarray:
    """Gather indices (e,) into the flattened d array (3*(k+4),) producing the
    rate-matched output bits for this configuration."""
    return wbuf_map(k, f)[rx_table(k, f, e, rv, ncb)].astype(np.int32)


def wbuf_size(k: int) -> int:
    return 3 * NCOLS * (-(-(k + 4) // NCOLS))


@functools.lru_cache(maxsize=None)
def rx_gather_table(k: int, f: int, e: int, rv: int, ncb: int = 0) -> np.ndarray:
    """Inverse of rx_table as a dense gather: (wbuf_size, n_max) indices into
    the incoming LLR vector padded with one trailing zero (index e = "none"),
    so soft combining is wbuf += padded_llrs[..., table].sum(-1)."""
    tgt = rx_table(k, f, e, rv, ncb)
    size = wbuf_size(k)
    counts = np.bincount(tgt, minlength=size)
    n_max = max(1, int(counts.max()))
    out = np.full((size, n_max), e, dtype=np.int32)
    slot = np.zeros(size, dtype=np.int64)
    for j, t in enumerate(tgt):
        out[t, slot[t]] = j
        slot[t] += 1
    return out


@functools.lru_cache(maxsize=None)
def _wbuf_inverse(k: int, f: int):
    """(gather_idx (3D,), present (3D,), filler (3D,)) mapping w-buffer ->
    d-LLRs.  gather_idx[j] = w position holding d_flat[j], or 0."""
    w = wbuf_map(k, f)
    D = k + 4
    inv = np.zeros(3 * D, dtype=np.int32)
    present = np.zeros(3 * D, dtype=bool)
    pos = np.flatnonzero(w >= 0)
    inv[w[pos]] = pos
    present[w[pos]] = True
    filler = np.zeros(3 * D, dtype=bool)
    if f > 0:
        filler[0:f] = True  # d0 fillers
        filler[D : D + f] = True  # d1 fillers (state stays 0 -> parity known 0)
    return inv, present, filler


@functools.lru_cache(maxsize=64)
def _on_device(table_fn, args: tuple, device: torch.device):
    """A host table, uploaded once per (configuration, device)."""
    out = table_fn(*args)
    if isinstance(out, tuple):
        return tuple(torch.from_numpy(a).to(device).long() if a.dtype != bool
                     else torch.from_numpy(a).to(device) for a in out)
    return torch.from_numpy(out).to(device).long()


def rate_match_tx(d_flat: torch.Tensor, k: int, f: int, e: int, rv: int, ncb: int = 0):
    """TX bit selection: d_flat (B, 3*(k+4)) bits -> (B, e) bits."""
    return d_flat[..., _on_device(tx_table, (k, f, e, rv, ncb), d_flat.device)]


def rate_unmatch_rx(llrs: torch.Tensor, wbuf: torch.Tensor, k: int, f: int,
                    e: int, rv: int, ncb: int = 0):
    """RX soft-combine: accumulate incoming LLRs (B, e) into the HARQ w-buffer
    (B, 3*Kp) (`fec/softbuffer.c`).  Returns the updated w-buffer."""
    tbl = _on_device(rx_gather_table, (k, f, e, rv, ncb), llrs.device)
    padded = torch.cat([llrs, llrs.new_zeros(llrs.shape[:-1] + (1,))], dim=-1)
    return wbuf + padded[..., tbl].sum(-1)


@functools.lru_cache(maxsize=None)
def _cyclic_tables(k: int, f: int, ncb: int = 0):
    """Tables for the per-row RV paths.  The redundancy version changes only
    the circular-buffer start k0 (§5.1.4.1.2), so the bit-selection stream
    z[j] = d[region[valid[j]]] is RV-invariant and each RV reads it from its
    own start:

      tx_rv[i] = z[(start_rv + i) mod V]
      rx: w[valid[j]] += sum of llr[i] over i == j - start_rv (mod V)

    Returns (z_src (V,) gather into d_flat, starts (4,), inv (size,) index
    into the z domain per w-buffer position (V = "none"))."""
    w = wbuf_map(k, f)
    if ncb <= 0 or ncb > len(w):
        ncb = len(w)
    region = w[:ncb]
    valid = np.flatnonzero(region >= 0)
    starts = np.array([np.searchsorted(valid, k0_index(k, rv, ncb))
                       for rv in range(4)], np.int32)
    size = wbuf_size(k)
    inv = np.full(size, len(valid), np.int32)
    inv[valid] = np.arange(len(valid))
    return region[valid].astype(np.int32), starts, inv


def rate_match_tx_dyn(d_flat: torch.Tensor, k: int, f: int, e: int, rv_b: torch.Tensor,
                      ncb: int = 0):
    """rate_match_tx with one redundancy version per row, rv_b (B,) int:
    one gather of d_flat at z_src[(starts[rv_b] + i) mod V].  (The reference
    blends four static rolls, `_blend_rolled`, because per-row gathers were
    slow on its device; the bits are the same.)"""
    z_src, starts, _ = _on_device(_cyclic_tables, (k, f, ncb), d_flat.device)
    V = z_src.shape[0]
    pos = (starts[rv_b.long()][:, None] + torch.arange(e, device=d_flat.device)) % V
    return d_flat.gather(1, z_src[pos])


def rate_unmatch_rx_dyn(llrs: torch.Tensor, wbuf: torch.Tensor, k: int, f: int, e: int,
                        rv_b: torch.Tensor, ncb: int = 0):
    """rate_unmatch_rx with one redundancy version per row (HARQ IR
    soft-combining where each row may be another retransmission).  The
    wrap-combine of e > V LLRs sums in the LLRs' dtype; the combined stream
    is cast to the w-buffer's dtype before it is added, as in the
    reference.  One gather per row: w position p reads the combined stream
    at (inv[p] - starts[rv]) mod V, or a zero where inv[p] = V."""
    z_src, starts, inv = _on_device(_cyclic_tables, (k, f, ncb), llrs.device)
    V = z_src.shape[0]
    B = llrs.shape[0]
    reps = -(-e // V)
    pad = torch.cat([llrs, llrs.new_zeros((B, reps * V - e))], dim=-1)
    s = pad.reshape(B, reps, V).sum(-2) if reps > 1 else pad  # wrap-combine
    s = torch.cat([s, s.new_zeros((B, 1))], dim=-1)
    src = torch.where(inv < V, (inv - starts[rv_b.long()][:, None]) % V, V)
    return wbuf + s.gather(1, src).to(wbuf.dtype)


def wbuf_to_d_llrs(wbuf: torch.Tensor, k: int, f: int):
    """De-permute the w-buffer into (sys, par1, par2) LLRs, each (B, k+4).
    Filler positions are clamped to known-zero (+FILLER_LLR); never-transmitted
    positions (punctured) read 0."""
    D = k + 4
    inv, present, filler = _on_device(_wbuf_inverse, (k, f), wbuf.device)
    d = torch.where(present, wbuf[..., inv], 0.0)
    d = torch.where(filler, FILLER_LLR, d)
    return d[..., :D], d[..., D : 2 * D], d[..., 2 * D :]
