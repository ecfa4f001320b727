"""Batched Viterbi decoder for the K=7 rate-1/3 tail-biting code.

Twin of the reference's `ops/fec/viterbi.py` (`lib/src/phy/fec/viterbi.c`:
tail-biting handled by repeating the frame TB_ITER=3 times and keeping the
middle copy, viterbi.c:66-72).  The 64-state add-compare-select is a loop
over trellis steps with the batch and the states as tensor axes; branch
metrics for the 8 output combos come from one product; the traceback is a
second loop over the stored decisions.  A decision prefers the first
predecessor on a tie, as the reference's argmax does.

`viterbi_decode` is the one name every caller reaches.  On a CUDA tensor it
runs the kernel of `csrc/viterbi.cu` (`viterbi_cuda.viterbi_decode_cuda`:
the branch metrics here, then one launch for the ACS and the traceback,
as the reference's two scans are one compiled program) or raises; on a CPU
tensor it runs `viterbi_decode_ref`, the plain PyTorch loop of the same
function.  Nothing here loads the kernel library until a CUDA tensor asks
for it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .convcoder import GENERATORS
from ...utils.devices import table_cache

TB_ITER = 3


@functools.lru_cache(maxsize=None)
def _tables():
    # combo[s][u] = output bit triple index (d0 + 2 d1 + 4 d2)
    combo = np.zeros((64, 2), dtype=np.int64)
    for s in range(64):
        for u in (0, 1):
            idx = 0
            for i in range(3):
                d = GENERATORS[i, 0] * u
                for j in range(1, 7):
                    d ^= GENERATORS[i, j] * ((s >> (j - 1)) & 1)
                idx |= (int(d) & 1) << i
            combo[s, u] = idx
    # predecessors of state s': u = s'&1; preds = (s'>>1) | top<<5
    sp = np.arange(64)
    preds = np.stack([sp >> 1, (sp >> 1) | 32], axis=-1)  # (64, 2)
    u_of = sp & 1
    pred_combo = combo[preds, u_of[:, None]]  # (64, 2)
    # bipolar signs of the 8 combos for the 3 streams (positive LLR = bit 0)
    signs = np.zeros((3, 8), dtype=np.float32)
    for c in range(8):
        for i in range(3):
            signs[i, c] = 1.0 - 2.0 * ((c >> i) & 1)
    return preds, pred_combo, signs


@table_cache(8)
def _signs(dev: torch.device) -> torch.Tensor:
    """The combos' bipolar signs (3, 8) on `dev`, copied there once."""
    return torch.from_numpy(_tables()[2]).to(dev)


def branch_metrics(llrs: torch.Tensor) -> torch.Tensor:
    """(B, 3, K) stream LLRs -> (B, K, 8) branch metrics of the 8 output
    combos, as both the plain loop and the kernel read them."""
    return 0.5 * torch.einsum("bik,ic->bkc", llrs, _signs(llrs.device))


def viterbi_decode_ref(llrs: torch.Tensor, tb_iter: int = TB_ITER) -> torch.Tensor:
    """Plain PyTorch version: llrs (B, 3, K) stream LLRs (positive = bit 0).
    Returns (B, K) int8 bits."""
    preds, pred_combo, _ = _tables()
    dev = llrs.device
    p0, p1 = (torch.from_numpy(preds[:, j].copy()).to(dev) for j in (0, 1))
    c0, c1 = (torch.from_numpy(pred_combo[:, j].copy()).to(dev) for j in (0, 1))
    B, _, K = llrs.shape
    bm = branch_metrics(llrs)  # (B, K, 8)
    metrics = llrs.new_zeros((B, 64))
    decisions = []
    for t in range(tb_iter * K):  # tail-biting frame repetition
        bm_t = bm[:, t % K]
        cand0 = metrics[:, p0] + bm_t[:, c0]
        cand1 = metrics[:, p1] + bm_t[:, c1]
        decisions.append(cand1 > cand0)  # ties keep predecessor 0
        new = torch.maximum(cand0, cand1)
        metrics = new - new.max(dim=-1, keepdim=True).values
    state = metrics.argmax(dim=-1)  # first maximum, as jnp.argmax
    mid = (tb_iter // 2) * K
    bits = []
    for t in range(tb_iter * K - 1, mid - 1, -1):
        if t < mid + K:
            bits.append((state & 1).to(torch.int8))
        top = decisions[t].gather(1, state[:, None])[:, 0].to(torch.int64)
        state = (state >> 1) | (top << 5)
    return torch.stack(bits[::-1], dim=-1)


def viterbi_decode(llrs: torch.Tensor, tb_iter: int = TB_ITER) -> torch.Tensor:
    """llrs: (B, 3, K) stream LLRs (positive = bit 0). Returns (B, K) int8 bits:
    the kernel for CUDA tensors (it raises where it cannot run), the plain
    loop for CPU ones."""
    if llrs.device.type != "cuda":
        return viterbi_decode_ref(llrs, tb_iter)
    from . import viterbi_cuda

    return viterbi_cuda.viterbi_decode_cuda(llrs, tb_iter)
