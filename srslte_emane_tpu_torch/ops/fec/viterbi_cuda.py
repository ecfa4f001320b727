"""The Hopper Viterbi kernel: wrapper and launch count.

`viterbi_decode_cuda` is the CUDA side of `viterbi.viterbi_decode`, the
port's twin of the reference's `ops/fec/viterbi.viterbi_decode` (one
compiled program of two `lax.scan`s): the branch metrics in torch, by the
plain version's own call (`viterbi.branch_metrics`), so that the kernel
reads the same bits on the card; then one launch of `csrc/viterbi.cu`,
which runs the add-compare-select over every trellis step and the
traceback for every row.

What bounds the kernel is each row's chain of 3K dependent steps, each of
which needs the maximum over the 64 states of the step before: at few rows
one warp's step (its chain of shuffles and maxima, and the issue of its
instructions), at thousands the SMs' issue rate.  So a row has 8 lanes of
8 states each and a warp 4 rows: a step fetches its predecessors in 8
independent shuffles (slot t of lane j holds state 8j + (t ^ j), so every
lane sends its slot r in round r), takes the row's maximum from a tree in
the lane and 7 more independent shuffles (2 shuffle latencies deep,
against 6 when a row had a warp), and, on the steps the traceback visits,
each lane adds its 8 decisions onto 2^23 in floating point and stores the
low byte: one byte of the step's 64-bit word (bit s: state s), which one
lane per row reads back in the traceback.  The launch takes one of two
variants by shape: the rows' branch metrics and decisions in shared memory
where a block (one warp, `rows_per_block()` rows) holds them
(`viterbi_fits`: K up to 1,210 at tb_iter 3), else in device memory, the
decisions in a scratch tensor allocated here.

The kernel library is built by `turbodecoder_cuda.build` with nvcc at first
use, into build/viterbi-<hash of sources and flags>/, and reused after.
"""

from __future__ import annotations

import torch

from . import turbodecoder_cuda
from .viterbi import TB_ITER, branch_metrics

SOURCE = turbodecoder_cuda.CSRC / "viterbi.cu"

# Kernel launches made by `launch` (a plain count; callers reset it).
launches = 0


def _lib():
    return turbodecoder_cuda.build(SOURCE).lib


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def launch(bm: torch.Tensor, tb_iter: int = TB_ITER) -> torch.Tensor:
    """The kernel alone, on PyTorch's current stream.  bm: (R, K, 8)
    float32 branch metrics, contiguous on a CUDA device.  Returns the (R, K)
    int8 bits; for R = 0 an empty tensor, with no launch.  A K whose row
    does not fit a block's shared memory takes the variant that keeps its
    decisions in a scratch tensor of R * (tb_iter - tb_iter // 2) * K * 8
    bytes.  ValueError for what neither variant takes: another device,
    shape or layout, tb_iter < 1 or above 1,024, or K above 65,536;
    TypeError for another type (`turbodecoder_cuda._require`'s checks)."""
    global launches
    turbodecoder_cuda._require("bm", bm, bm.device, (torch.float32,), (*bm.shape[:2], 8))
    R, K = bm.shape[:2]
    if tb_iter < 1:
        raise ValueError(f"tb_iter must be at least 1, not {tb_iter}")
    lib = _lib()
    if not lib.viterbi_global_fits(K, tb_iter):
        raise ValueError(f"K={K} with tb_iter={tb_iter} is beyond both variants of the kernel")
    bits = torch.empty((R, K), dtype=torch.int8, device=bm.device)
    if R == 0:
        return bits
    scratch = None if lib.viterbi_fits(K, tb_iter) else torch.empty(
        (R, (tb_iter - tb_iter // 2) * K, 2), dtype=torch.int32, device=bm.device)
    err = lib.viterbi_launch(bm.data_ptr(), bits.data_ptr(),
                             None if scratch is None else scratch.data_ptr(), R, K, tb_iter,
                             _stream(bm.device))
    if err != 0:
        raise RuntimeError(f"viterbi kernel launch failed: cudaError_t {err}")
    launches += 1
    return bits


def viterbi_decode_cuda(llrs: torch.Tensor, tb_iter: int = TB_ITER) -> torch.Tensor:
    """llrs: (B, 3, K) float32 stream LLRs (positive = bit 0) on a CUDA
    device.  Returns (B, K) int8 bits: the branch metrics, then one launch."""
    if llrs.dim() != 3 or llrs.shape[1] != 3:
        raise ValueError(f"llrs has shape {tuple(llrs.shape)}, expected (B, 3, K)")
    return launch(branch_metrics(llrs).contiguous(), tb_iter)


def rows_per_block() -> int:
    """Rows one block of the kernel decodes (a warp: 8 lanes to a row)."""
    return _lib().viterbi_rows_per_block()


def occupancy(K: int, tb_iter: int = TB_ITER) -> int:
    """Blocks (of `rows_per_block()` rows each) per SM of the kernel, in the
    variant this shape takes, on the current card."""
    n = _lib().viterbi_blocks_per_sm(K, tb_iter)
    if n < 0:
        raise RuntimeError(f"occupancy query failed for K={K}, tb_iter={tb_iter}")
    return n
