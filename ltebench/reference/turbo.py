"""The plain turbo decoder: soft buffers to transport block and CRC flag.

A frozen copy, in plain PyTorch, of the decoding rules that the program
states for its configuration (a max-log-MAP of 36.212's constituent code
over windows with a 40-step halo, decoded in turn with extrinsic scaling
0.75, the hard bits checked by CRC after every half-iteration, a block's
bits frozen at its first pass, at most 2 * max_iter half-iterations),
with the rounding points of the configuration's 16-bit mode: the inputs
quantised to 1/256 and saturated, the half-scaled branch metrics and the
stored betas in bfloat16, the recursions in float32.  Rows are decoded
independently: a row's result does not depend on the others, so the
batch-compaction cascade that the program runs to save work has no place
here.  Nothing here imports the program.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import link as link_mod
from . import tables

HALO = 40
EXT_SCALE = 0.75
NEG = -1e30


def n_windows(k: int) -> int:
    """Windows of length at least 128 (32, 16, ... or 1 at k <= 256)."""
    if k <= 256:
        return 1
    for w in (32, 16, 8, 4, 2):
        if k % w == 0 and k // w >= 128:
            return w
    return 1


@functools.lru_cache(maxsize=None)
def _inverse(k: int, f: int):
    """(source position in the soft buffer of each of d0|d1|d2, present?,
    filler?) for code block size k with f fillers."""
    w = tables.circular_buffer(k, f)
    D = k + 4
    src = np.zeros(3 * D, np.int64)
    present = np.zeros(3 * D, bool)
    pos = np.flatnonzero(w != tables.NULL)
    src[w[pos]] = pos
    present[w[pos]] = True
    filler = np.zeros(3 * D, bool)
    filler[:f] = True
    filler[D:D + f] = True
    return src, present, filler


def d_llrs(wbuf: torch.Tensor, k: int, f: int):
    """Soft buffer (B, 3 Kp) -> d0, d1, d2 (B, k + 4), in its dtype: a
    punctured bit reads 0, a filler FILLER_LLR."""
    src, present, filler = (torch.from_numpy(a).to(wbuf.device) for a in _inverse(k, f))
    d = torch.where(present, wbuf[:, src], 0.0)
    d = torch.where(filler, tables.FILLER_LLR, d)
    D = k + 4
    return d[:, :D], d[:, D:2 * D], d[:, 2 * D:]


def quantise(x: torch.Tensor, llr_bits: int) -> torch.Tensor:
    """The decoder's input range: 1/256 steps within +-32767 steps (16 bits)
    or 1/8 within +-127 (8 bits); float32 out."""
    x = x.to(torch.float32)
    if llr_bits == 16:
        return torch.clamp(torch.round(x * 256.0), -32767, 32767) / 256.0
    if llr_bits == 8:
        return torch.clamp(torch.round(x * 8.0), -127, 127) / 8.0
    return x


def beta_tail(tail_x: torch.Tensor, tail_z: torch.Tensor) -> torch.Tensor:
    """Exact termination metric of each state, (B, 8): its six signed tail
    LLRs added one at a time, halved."""
    signs = torch.from_numpy(tables.trellis()[2]).to(tail_x.device)
    tails = torch.stack([tail_x[:, 0], tail_z[:, 0], tail_x[:, 1], tail_z[:, 1],
                         tail_x[:, 2], tail_z[:, 2]], dim=-1)
    terms = tails.to(torch.float32)[:, None, :] * signs
    acc = terms[..., 0]
    for j in range(1, 6):
        acc = acc + terms[..., j]
    return 0.5 * acc


def map_pass(ls: torch.Tensor, lp: torch.Tensor, tail_x: torch.Tensor, tail_z: torch.Tensor,
             narrow: bool) -> torch.Tensor:
    """One max-log-MAP half-iteration over (B, K): windows of L steps with
    an H-step halo each side (zero outside the block), the betas from
    uniform at the halo and from the tail at the block's end, the alphas
    from uniform at the halo and from state 0 at its start, a
    normalisation (subtract the maximum) at each window's start and, in
    narrow mode, after every second backward step.  Returns the posterior
    LLRs (B, K) float32."""
    B, K = ls.shape
    W = n_windows(K)
    L = K // W
    H = min(HALO, L)
    C = B * W
    dev = ls.device
    ns, pz, _ = tables.trellis()
    # predecessors of each state and the inputs that lead there
    ps = np.zeros((8, 2), np.int64)
    pu = np.zeros((8, 2), np.int64)
    fill = np.zeros(8, np.int64)
    for s in range(8):
        for u in (0, 1):
            t = ns[s, u]
            ps[t, fill[t]], pu[t, fill[t]] = s, u
            fill[t] += 1
    ix = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    ns0, ns1 = ix(ns[:, 0]), ix(ns[:, 1])
    cb0, cb1 = ix(pz[:, 0]), ix(2 + pz[:, 1])  # branch index u * 2 + z
    ps0, ps1, pu0, pu1 = ix(ps[:, 0]), ix(ps[:, 1]), ix(pu[:, 0]), ix(pu[:, 1])
    cf0 = ix(pu[:, 0] * 2 + pz[ps[:, 0], pu[:, 0]])
    cf1 = ix(pu[:, 1] * 2 + pz[ps[:, 1], pu[:, 1]])

    kk = torch.arange(W)[None, :] * L - H + torch.arange(L + 2 * H)[:, None]
    idx = torch.where((kk >= 0) & (kk < K), kk, -1).to(dev)
    zero = ls.new_zeros((B, 1), dtype=torch.float32)

    def windows(x):  # (L + 2H, C) halved, rounded to the storage type
        x = (x.to(torch.float32) * 0.5).to(torch.bfloat16 if narrow else torch.float32)
        x = torch.cat([x.to(torch.float32), zero], dim=1)[:, idx]
        return x.permute(1, 0, 2).reshape(L + 2 * H, C)

    ls_t, lp_t = windows(ls), windows(lp)

    def g4(t):
        a, b = ls_t[t] + lp_t[t], ls_t[t] - lp_t[t]
        return torch.stack([a, b, -b, -a])

    bwd = lambda beta, g: torch.maximum(beta[ns0] + g[cb0], beta[ns1] + g[cb1])
    fwd = lambda alpha, g: torch.maximum(alpha[ps0] + g[cf0], alpha[ps1] + g[cf1])
    normalise = lambda x: x - x.max(dim=0).values
    w = torch.arange(C, device=dev) % W

    beta = ls_t.new_zeros((8, C))
    for i in range(H):
        beta = bwd(beta, g4(2 * H + L - 1 - i))
    bt = beta_tail(tail_x, tail_z).repeat_interleave(W, dim=0).T
    beta = normalise(torch.where(w == W - 1, bt, beta))
    sdt = torch.bfloat16 if narrow else torch.float32
    stored = ls_t.new_empty((L, 8, C), dtype=sdt)
    for i in range(L // 2):
        t = L - 1 - 2 * i
        stored[t] = beta.to(sdt)
        beta = bwd(beta, g4(H + t))
        stored[t - 1] = beta.to(sdt)
        beta = bwd(beta, g4(H + t - 1))
        if narrow:
            beta = normalise(beta)

    alpha = ls_t.new_zeros((8, C))
    for i in range(H):
        alpha = fwd(alpha, g4(i))
    start = torch.full((8, 1), NEG, dtype=torch.float32, device=dev)
    start[0] = 0.0
    alpha = normalise(torch.where(w == 0, start, alpha))
    llr = ls_t.new_empty((L, C))
    for t in range(L):
        g = g4(H + t)
        t0, t1 = alpha + g[cb0], alpha + g[cb1]
        bn = stored[t].to(torch.float32)
        llr[t] = (t0 + bn[ns0]).max(dim=0).values - (t1 + bn[ns1]).max(dim=0).values
        tsu = torch.stack([t0, t1], dim=1)
        alpha = torch.maximum(tsu[ps0, pu0], tsu[ps1, pu1])
    return llr.view(L, B, W).permute(1, 2, 0).reshape(B, K)


def decode_blocks(d0, d1, d2, k: int, check, max_iter: int, llr_bits: int):
    """Code blocks (B, k + 4) of each stream -> (hard bits (B, k) int8, CRC passed (B,))."""
    narrow = llr_bits <= 16
    d0, d1, d2 = (quantise(d, llr_bits) for d in (d0, d1, d2))
    ls, lp1, lp2 = d0[:, :k].contiguous(), d1[:, :k].contiguous(), d2[:, :k].contiguous()
    tails = ((torch.stack([d0[:, k], d2[:, k], d1[:, k + 1]], -1),
              torch.stack([d1[:, k], d0[:, k + 1], d2[:, k + 1]], -1)),
             (torch.stack([d0[:, k + 2], d2[:, k + 2], d1[:, k + 3]], -1),
              torch.stack([d1[:, k + 2], d0[:, k + 3], d2[:, k + 3]], -1)))
    perm = torch.from_numpy(tables.qpp(k)).to(ls.device)
    inv = torch.argsort(perm)
    ls2 = ls[:, perm]
    B = ls.shape[0]
    done = torch.zeros(B, dtype=torch.bool, device=ls.device)
    passed = torch.zeros_like(done)
    bits_out = torch.zeros((B, k), dtype=torch.int8, device=ls.device)
    ls_in = ls + torch.zeros_like(ls)
    for h in range(2 * max_iter):
        if bool(done.all()):
            break
        par = h % 2
        post = map_pass(ls_in, (lp1, lp2)[par], *tails[par], narrow)
        ext = (post - ls_in) * EXT_SCALE
        if par == 0:
            bits = (post < 0).to(torch.int8)
            ls_in = ls2 + ext[:, perm]
        else:
            bits = (post[:, inv] < 0).to(torch.int8)
            ls_in = ls + ext[:, inv]
        ok = link_mod.crc_ok(bits, check)
        bits_out = torch.where(done[:, None], bits_out, bits)
        passed = passed | (ok & ~done)
        done = done | ok
    return bits_out, passed


def decode(softbuf: list, lnk: tables.Link, llr_bits: int | None = None):
    """Per-code-block soft buffers [(B, 3 Kp_r)] -> (payload (B, tbs) int8,
    ok (B,)): ok needs every code block's CRC24B and the TB's CRC24A."""
    s = lnk.segm
    llr_bits = lnk.llr_bits if llr_bits is None else llr_bits
    check = tables.CRC24B if s.C > 1 else tables.CRC24A
    B = softbuf[0].shape[0]
    by_k = {}
    for r, k in enumerate(s.sizes):
        by_k.setdefault(k, []).append(r)
    cb_bits, cb_ok = [None] * s.C, [None] * s.C
    for k, rs in by_k.items():
        ds = [d_llrs(softbuf[r], k, s.F if r == 0 else 0) for r in rs]
        bits, ok = decode_blocks(*(torch.cat([d[j] for d in ds]) for j in range(3)), k, check,
                                 lnk.max_iter, llr_bits)
        for i, r in enumerate(rs):
            cb_bits[r], cb_ok[r] = bits[i * B:(i + 1) * B], ok[i * B:(i + 1) * B]
    if s.C == 1:
        tb = cb_bits[0][:, s.F:]
    else:
        tb = torch.cat([cb_bits[r][:, (s.F if r == 0 else 0):k - tables.CB_CRC]
                        for r, k in enumerate(s.sizes)], dim=1)
    ok = link_mod.crc_ok(tb, tables.CRC24A)
    for o in cb_ok:
        ok = ok & o
    return tb[:, :lnk.tbs], ok
