"""36.212 turbo decoder: batched, windowed max-log-MAP with CRC early stop.

Twin of the reference's `ops/fec/turbodecoder.py` (turbodecoder_win.h:36-87:
sub-block windows with a 40-step halo; sch.c:350-383: CRC early stop).
Code blocks x windows form one batch axis; `_map_decode` is the plain
PyTorch twin of the reference's XLA MAP, and `use_kernel=True` runs every
half-iteration through the hand-written CUDA kernel of
`turbodecoder_cuda.py` (its plain version on CPU tensors).  Left at its
default (None), `use_kernel` follows the LLRs' device: the kernel for CUDA
tensors, `_map_decode` for CPU tensors.

`turbo_decode` keeps the reference's semantics: a CRC check after every
half-iteration (one MAP pass), a block's bits freeze when its CRC first
passes, n_iter = (h + 1) // 2.  The reference keeps its stop test on the
device (lax.while_loop); here the test is a host sync after each
half-iteration.  It also keeps the reference's batch-compaction cascade
(`SRSLTE_TPU_CASCADE`, on unless "0"): once at most B/2 code blocks are
unfinished, the stragglers are gathered into a B/2 batch and then a B/4
one, so finished blocks stop costing MAP work.  Each row's MAP is
independent of the others and the half-iteration counter carries across
the stages, so the cascade changes the cost and never the results.  On an
H100 it halves the MAP rows of a straggler batch yet costs time (0.5-2.2
ms more per decode of 128 x K=5504, `PERF.md`): each stage adds a gather,
a scatter and a host sync, which cost more than the narrower MAP passes
save.

LLR convention: positive LLR <=> bit 0 (bipolar sign s_b = 1 - 2b).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from . import crc as crc_mod
from . import turbo

NEG = -1e30
HALO = 40  # window overlap, matches turbodecoder_win.h:36-87

# log-MAP mode (SRSLTE_TPU_LOGMAP=1): the exact max* correction in the
# alpha/beta recursions, read as the reference reads it; max-log is default.
LOGMAP = os.environ.get("SRSLTE_TPU_LOGMAP", "0") != "0"
EXT_SCALE = 0.75  # extrinsic damping (kept in both modes)

# Code-block rows that MAP passes have processed (a plain count of the
# batch rows of every pass; callers reset it): what the cascade saves.
map_rows = 0


def max_star(a, b):
    """Pairwise max* (log-MAP) or plain max (max-log-MAP), per LOGMAP.  The
    branch metrics are half-scaled, so the correction is
    0.5*ln(1 + e^(-2|a-b|))."""
    m = torch.maximum(a, b)
    if not LOGMAP:
        return m
    return m + 0.5 * torch.log1p(torch.exp(-2.0 * (a - b).abs()))


@functools.lru_cache(maxsize=None)
def _trellis():
    """8-state RSC trellis tables (state s = r0*4 + r1*2 + r2).

    Returns dict of int numpy arrays:
      next_state (8,2), parity (8,2): indexed [s][u]
      prev_state (8,2), prev_u (8,2): predecessors of s' (two each)
      tail_signs (8,6): bipolar (x,z) pairs of the 3 forced tail steps per state
    """
    next_state = np.zeros((8, 2), dtype=np.int64)
    parity = np.zeros((8, 2), dtype=np.int64)
    for s in range(8):
        r0, r1, r2 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        for u in (0, 1):
            a = u ^ r1 ^ r2
            z = u ^ r0 ^ r1
            next_state[s, u] = a * 4 + r0 * 2 + r1
            parity[s, u] = z
    prev_state = np.zeros((8, 2), dtype=np.int64)
    prev_u = np.zeros((8, 2), dtype=np.int64)
    fill = np.zeros(8, dtype=np.int64)
    for s in range(8):
        for u in (0, 1):
            ns = next_state[s, u]
            prev_state[ns, fill[ns]] = s
            prev_u[ns, fill[ns]] = u
            fill[ns] += 1
    assert (fill == 2).all()
    tail_signs = np.zeros((8, 6), dtype=np.float32)
    for s0 in range(8):
        s = s0
        for step in range(3):
            r0, r1, r2 = (s >> 2) & 1, (s >> 1) & 1, s & 1
            x = r1 ^ r2  # forced input (feedback bit)
            z = r0 ^ r2
            tail_signs[s0, 2 * step] = 1 - 2 * x
            tail_signs[s0, 2 * step + 1] = 1 - 2 * z
            s = (r0 * 2 + r1)  # a=0: s' = (0, r0, r1)
    return dict(
        next_state=next_state,
        parity=parity,
        prev_state=prev_state,
        prev_u=prev_u,
        tail_signs=tail_signs,
    )


def _pick_windows(k: int) -> int:
    """Number of windows W (dividing k) targeting window length ~128-256."""
    if k <= 256:
        return 1
    for w in (32, 16, 8, 4, 2):
        if k % w == 0 and k // w >= 128:
            return w
    return 1


def _gammas(ls: torch.Tensor, lp: torch.Tensor) -> torch.Tensor:
    """4-combo branch metrics, combo index = u*2 + z.  (..., T) -> (..., T, 4)."""
    su = torch.stack([ls, ls, -ls, -ls], dim=-1)
    sz = torch.stack([lp, -lp, lp, -lp], dim=-1)
    return 0.5 * (su + sz)


@functools.lru_cache(maxsize=16)
def _tail_signs(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_trellis()["tail_signs"]).to(device)


def beta_tail(tail_x: torch.Tensor, tail_z: torch.Tensor) -> torch.Tensor:
    """Exact termination beta_K (B, 8) from the tail-bit path metrics (the
    sign table is copied to each device once: a copy per call would hold
    the host until the card caught up)."""
    signs = _tail_signs(tail_x.device)
    tails = torch.stack([tail_x[:, 0], tail_z[:, 0], tail_x[:, 1], tail_z[:, 1],
                         tail_x[:, 2], tail_z[:, 2]], dim=-1)
    return 0.5 * (tails.to(torch.float32) @ signs.T)


def _map_decode(ls_eff: torch.Tensor, lp: torch.Tensor, tail_x: torch.Tensor,
                tail_z: torch.Tensor) -> torch.Tensor:
    """One max-log-MAP pass (plain twin of the reference's `_map_decode`).

    ls_eff: (B, K) systematic + apriori LLRs; lp: (B, K) parity LLRs;
    tail_x/tail_z: (B, 3) tail systematic/parity LLRs for this encoder.
    Returns posterior LLRs (B, K).
    """
    T = _trellis()
    B, K = ls_eff.shape
    W = _pick_windows(K)
    L = K // W
    H = min(HALO, L)
    dev = ls_eff.device
    idx = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    ns, pz = T["next_state"], T["parity"]
    ps, pu = T["prev_state"], T["prev_u"]
    combo_fwd = idx(pu * 2 + pz[ps, pu])  # (8,2) for the alpha gather
    combo_bwd = idx(np.arange(2)[None, :] * 2 + pz)  # (8,2) for beta
    combo_all = idx(np.arange(2)[:, None] * 2 + pz.T)  # (2,8)
    ns_i, ps_i, ns_t = idx(ns), idx(ps), idx(ns.T)

    g = _gammas(ls_eff, lp)  # (B, K, 4)
    g_pad = torch.nn.functional.pad(g, (0, 0, H, H))  # zero gammas outside
    pos = np.arange(W)[:, None] * L
    a_halo = idx((pos + np.arange(-H, 0)[None, :] + H).reshape(-1))
    b_halo = idx((pos + np.arange(L, L + H)[None, :] + H).reshape(-1))
    ga_halo = g_pad[:, a_halo].reshape(B, W, H, 4)
    gb_halo = g_pad[:, b_halo].reshape(B, W, H, 4)
    g_win = g.reshape(B, W, L, 4)

    # normalization every 2 trellis steps when the reference unrolls by 4,
    # never otherwise (its unroll rule, turbodecoder.py:191)
    U = 4 if L % 4 == 0 and H % 4 == 0 else 1
    norm_at = lambda i: U > 1 and i % 2 == 1

    def alpha_step(alpha, g_t, norm):
        cand = alpha[..., ps_i] + g_t[..., combo_fwd]  # (B, W, 8, 2)
        out = max_star(cand[..., 0], cand[..., 1])
        return out - out.max(dim=-1, keepdim=True).values if norm else out

    def beta_step(beta, g_t, norm):
        cand = beta[..., ns_i] + g_t[..., combo_bwd]
        out = max_star(cand[..., 0], cand[..., 1])
        return out - out.max(dim=-1, keepdim=True).values if norm else out

    # ---- beta: halo warm-up from uniform, exact beta_K, backward pass ----
    b_init = ls_eff.new_zeros((B, W, 8))
    for i in range(H):
        b_init = beta_step(b_init, gb_halo[:, :, H - 1 - i], norm_at(i))
    bt = beta_tail(tail_x, tail_z)
    b_init[:, W - 1] = bt - bt.max(dim=-1, keepdim=True).values
    betas = [None] * L  # betas[t] = beta at node t
    beta = b_init
    for i in range(L):
        beta = beta_step(beta, g_win[:, :, L - 1 - i], norm_at(i))
        betas[L - 1 - i] = beta
    beta_next = betas[1:] + [b_init]

    # ---- alpha: halo warm-up, exact alpha_0, forward pass + posterior ----
    alpha = ls_eff.new_zeros((B, W, 8))
    for i in range(H):
        alpha = alpha_step(alpha, ga_halo[:, :, i], norm_at(i))
    exact0 = torch.full((8,), NEG, dtype=ls_eff.dtype, device=dev)
    exact0[0] = 0.0
    alpha[:, 0] = exact0
    llr = []
    for t in range(L):
        g_t = g_win[:, :, t]
        # cand[u', s] = alpha[s] + g[combo(u', pz[s,u'])] + beta'[ns[s,u']]
        cand = alpha[..., None, :] + g_t[..., combo_all] + beta_next[t][..., ns_t]
        m = cand.max(dim=-1).values  # (B, W, 2)
        llr.append(m[..., 0] - m[..., 1])
        alpha = alpha_step(alpha, g_t, norm_at(t))
    return torch.stack(llr, dim=-1).reshape(B, K)


def quantize_llr_int8(llr, scale: float = 8.0):
    """The reference decoder's 8-bit input range (turbodecoder.h:50-66):
    round(llr * scale) saturated to [-127, 127], then dequantized."""
    q = torch.clamp(torch.round(llr.to(torch.float32) * scale), -127, 127)
    return q / scale


def quantize_llr_int16(llr, scale: float = 256.0):
    """16-bit mode (SRSLTE_TDEC_16BIT): same contract, +/-32767 range, f32
    out (a bf16 LLR stream re-enters the f32 recursion math)."""
    q = torch.clamp(torch.round(llr.to(torch.float32) * scale), -32767, 32767)
    return q / scale


@functools.lru_cache(maxsize=16)
def _device_perms(k: int, device: torch.device):
    perm = turbo.qpp_interleaver(k)
    return (torch.from_numpy(perm).to(device),
            torch.from_numpy(np.argsort(perm)).to(device))


def turbo_decode(d0: torch.Tensor, d1: torch.Tensor, d2: torch.Tensor,
                 valid: torch.Tensor, k: int, max_iter: int = 8,
                 crc: tuple = crc_mod.LTE_CRC24B, use_kernel: bool | None = None,
                 llr_bits: int = 32):
    """Decode a batch of code blocks with CRC-gated early stop.

    d0/d1/d2: (B, K+4) LLRs (systematic/parity1/parity2 + tails), positive=bit 0.
    valid: (B,) bool — rows actually present (padding rows decode but are
           ignored and treated as done from the start).
    crc: polynomial for the per-CB early stop, or None to run all iterations.
    use_kernel: run each MAP pass through turbodecoder_cuda.map_decode
           (llr_bits <= 16 selects its bf16-storage mode); False runs the
           plain `_map_decode`; None (default) means "the LLRs lie on a
           CUDA device".
    Returns (bits (B, K) int8 hard decisions, crc_pass (B,) bool, n_iter int).
    """
    if llr_bits == 8:
        d0, d1, d2 = (quantize_llr_int8(d) for d in (d0, d1, d2))
    elif llr_bits == 16:
        d0, d1, d2 = (quantize_llr_int16(d) for d in (d0, d1, d2))
    B = d0.shape[0]
    perm, inv_perm = _device_perms(k, d0.device)
    ls = d0[:, :k]
    lp1 = d1[:, :k].contiguous()
    lp2 = d2[:, :k].contiguous()
    ls2 = ls[:, perm]
    # tail arrangement (36.212 5.1.3.2.2, see turbo.turbo_encode):
    tail_x1 = torch.stack([d0[:, k], d2[:, k], d1[:, k + 1]], dim=-1)
    tail_z1 = torch.stack([d1[:, k], d0[:, k + 1], d2[:, k + 1]], dim=-1)
    tail_x2 = torch.stack([d0[:, k + 2], d2[:, k + 2], d1[:, k + 3]], dim=-1)
    tail_z2 = torch.stack([d1[:, k + 2], d0[:, k + 3], d2[:, k + 3]], dim=-1)

    if use_kernel is None:
        use_kernel = d0.device.type == "cuda"
    if use_kernel:
        from . import turbodecoder_cuda

        map_fn = functools.partial(turbodecoder_cuda.map_decode,
                                   narrow=llr_bits <= 16)
    else:
        map_fn = _map_decode
    arrs = (ls, lp1, lp2, tail_x1, tail_z1, tail_x2, tail_z2)

    def run(arrs, state, stop_count):
        """Half-iterations over one (possibly compacted) batch until at most
        stop_count of its rows are unfinished or the budget is spent."""
        global map_rows
        ls, lp1, lp2, tx1, tz1, tx2, tz2 = arrs
        h, ext, done, bits_out, pass_out = state
        ls2 = ls[:, perm]
        # the loop counter is HALF-iterations: CRC after every MAP pass
        while h < 2 * max_iter and int((~done).sum()) > stop_count:
            if h % 2 == 0:
                ls_in = ls + ext
                post = map_fn(ls_in, lp1, tx1, tz1)
                ext = (post - ls_in) * EXT_SCALE
                bits = (post < 0).to(torch.int8)
            else:
                ls_in = ls2 + ext[:, perm]
                post = map_fn(ls_in, lp2, tx2, tz2)
                ext = ((post - ls_in) * EXT_SCALE)[:, inv_perm]
                bits = (post[:, inv_perm] < 0).to(torch.int8)
            map_rows += ls.shape[0]
            ok = torch.zeros_like(done) if crc is None else crc_mod.crc_ok(bits, crc)
            # latest hard decisions for unfinished CBs; freeze once passed
            bits_out = torch.where(done[:, None], bits_out, bits)
            pass_out = pass_out | (ok & ~done)
            done = done | ok
            h += 1
        return h, ext, done, bits_out, pass_out

    def stage(state, size, stop_count):
        """Gather the unfinished rows first (stable) into a `size` batch, run
        it until at most stop_count remain, scatter the results back."""
        h, ext, done, bits_out, pass_out = state
        idx = torch.argsort(done.to(torch.uint8), stable=True)[:size]
        h, *sub = run(tuple(a[idx] for a in arrs),
                      (h, ext[idx], done[idx], bits_out[idx], pass_out[idx]), stop_count)
        return (h, *(full.index_copy(0, idx, part)
                     for full, part in zip((ext, done, bits_out, pass_out), sub)))

    state = (0, torch.zeros_like(ls), ~valid,
             torch.zeros((B, k), dtype=torch.int8, device=d0.device),
             torch.zeros((B,), dtype=torch.bool, device=d0.device))
    cascade_on = os.environ.get("SRSLTE_TPU_CASCADE", "1") != "0"
    if crc is None or B < 8 or not cascade_on:
        state = run(arrs, state, 0)
    else:
        # the reference's two stages (turbodecoder.py:453-455); enter at the
        # narrowest one that fits the stragglers, then fall through
        sizes = (B // 2, B // 4)
        state = run(arrs, state, sizes[0])
        n_left = int((~state[2]).sum())
        i = 0 if n_left > sizes[1] else 1
        while n_left and i < len(sizes):
            state = stage(state, sizes[i], sizes[i + 1] if i + 1 < len(sizes) else 0)
            n_left = int((~state[2]).sum())
            i += 1
    h, _, _, bits_out, pass_out = state
    return bits_out, pass_out & valid, (h + 1) // 2
