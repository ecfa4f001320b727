"""The turbo decoder's loop on the card: the epilogue kernel's wrapper,
launch counts and plain PyTorch versions.

A decode is one loop of 2 * max_iter slots, each a MAP launch
(`turbodecoder_cuda`) and this epilogue (`csrc/turbo_iter.cu`), both
predicated on a flag that lives on the card, so
`turbodecoder.turbo_decode_device` enqueues the whole loop and never
reads.  The epilogue is the body of the JAX decoder's `lax.while_loop`
after its MAP call (`srslte_emane_tpu/ops/fec/turbodecoder.py:373-400`)
and the loop's condition (`:402-406`), with the cascade's `lax.cond`s
(`:463-481`) as a state on the card:
  * new_ext = (post - ls_in) * EXT_SCALE, in the pass's order;
  * the hard bits post < 0 in natural order (through inv_perm after an odd
    pass), and their CRC, which passes iff the XOR of the CRC remainder
    masks of the set bits is 0 (`crc.remainder_masks`);
  * bits_out and pass_out frozen on a row's first pass, done |= ok;
  * ls_in, in place, becomes the next pass's input: ls2 + ext[perm] after
    an even pass, ls + ext[inv_perm] after an odd one;
  * h += 1, map_rows += the listed rows, and `advance`: ctl[RUN] = (h <
    2 * max_iter) & (undone > the stage's stop), entering the next stage
    (B/2 rows, then B/4, the unfinished first: the reference's
    argsort(done)[:size]) while the condition fails and one is left.
A pass computes only the rows of `rows` ([n, r_0, ..., r_{B-1}]); the arm
kernel starts a decode with every row listed and tests the condition.  The
epilogue and the MAP launch of a pass run iff ctl[RUN] is set; otherwise
nothing changes.

On the card `decode_cuda` enqueues a decode's whole loop with one call
into the library (the arm kernel, then the slots); `turbo_iter_cuda` is
one launch of the epilogue, for comparing it with its plain version.  The
plain versions `arm_ref` and `turbo_iter_ref` run the same loop on the CPU
(and for use_kernel=False).  The kernel library is built by
`turbodecoder_cuda.build` with nvcc at first use, into
build/turbo_iter-<hash of sources and flags>/, and reused after.
"""

from __future__ import annotations

import torch

from . import crc as crc_mod
from . import turbodecoder_cuda

SOURCE = turbodecoder_cuda.CSRC / "turbo_iter.cu"
EXT_SCALE = 0.75  # turbodecoder.EXT_SCALE (this module is imported by it)

# ctl, (CTL_LEN,) int32 on the decode's device: the half-iteration counter,
# the flag of the next pass, the kernel's ticket, the MAP rows of the passes
# that ran, the unfinished rows at the last test, the cascade's stage.
H, RUN, TICKET, ROWS, UNDONE, STAGE = 0, 1, 2, 3, 4, 5
CTL_LEN = 8

# Kernel launches of the epilogue and of the arm kernel, made by
# `turbo_iter_cuda` and `decode_cuda` (plain counts; callers reset them).
launches = 0
arm_launches = 0


def new_state(rows: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """A decode's control words, all 0, and its row list, (rows + 1,)
    int32 (`arm` fills it)."""
    return (torch.zeros(CTL_LEN, dtype=torch.int32, device=device),
            torch.zeros(rows + 1, dtype=torch.int32, device=device))


def _lib():
    return turbodecoder_cuda.build(SOURCE).lib


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _advance_ref(done, ctl, rows, max_iter: int, n_stages: int) -> None:
    """Plain version of the kernels' `advance`: the flag for the pass after
    ctl[H] half-iterations, entering narrower stages while the condition
    fails.  Reads ctl on the host (free on the CPU)."""
    B = done.shape[0]
    undone = int((~done).sum())
    h, stage = int(ctl[H]), int(ctl[STAGE])
    stop = lambda s: B >> (s + 1) if s + 1 < n_stages else 0
    go = h < 2 * max_iter and undone > stop(stage)
    while not go and stage + 1 < n_stages:
        stage += 1
        width = B >> stage
        rows[0] = width
        rows[1:1 + width] = torch.argsort(done.to(torch.uint8), stable=True)[:width]
        go = h < 2 * max_iter and undone > stop(stage)
    ctl[STAGE], ctl[RUN], ctl[UNDONE] = stage, int(go), undone


def arm_ref(done, ctl, rows, max_iter: int, n_stages: int) -> None:
    """Plain version of `arm`: every row listed, stage 0, then the flag."""
    B = done.shape[0]
    rows[0] = B
    rows[1:] = torch.arange(B, dtype=torch.int32, device=rows.device)
    ctl[TICKET], ctl[STAGE] = 0, 0
    _advance_ref(done, ctl, rows, max_iter, n_stages)


def turbo_iter_ref(post, ls_in, ls, ls2, perm, inv_perm, masks, bits_out, done, pass_out, ctl,
                   rows, parity: int, max_iter: int, n_stages: int) -> None:
    """Plain version of the epilogue, in place on ls_in, bits_out, done,
    pass_out, ctl and rows; the same function as the kernel (module
    docstring), on the listed rows only.  Reads ctl and rows on the host
    (free on the CPU)."""
    if not int(ctl[RUN]):
        return
    idx = rows[1:1 + int(rows[0])].long()
    p, x = post[idx], ls_in[idx]
    ext = (p - x) * EXT_SCALE  # the pass's order
    if parity == 0:
        bits = (p < 0).to(torch.int8)
        nxt = ls2[idx] + ext[:, perm.long()]
    else:
        inv = inv_perm.long()
        bits = (p[:, inv] < 0).to(torch.int8)
        nxt = ls[idx] + ext[:, inv]
    d = done[idx]
    ok = (torch.zeros_like(d) if masks is None
          else crc_mod.crc_remainder(bits, masks) == 0)
    bits_out[idx] = torch.where(d[:, None], bits_out[idx], bits)
    pass_out[idx] = pass_out[idx] | (ok & ~d)
    done[idx] = d | ok
    ls_in[idx] = nxt
    ctl[ROWS] += idx.numel()
    ctl[H] += 1
    _advance_ref(done, ctl, rows, max_iter, n_stages)


def _check(post, ls_in, ls, ls2, perm, inv_perm, masks, bits_out, done, pass_out, ctl, rows):
    """The checks the kernel's wrapper makes before it launches."""
    B, K = post.shape
    dev = post.device
    req = turbodecoder_cuda._require
    for name, t in (("post", post), ("ls_in", ls_in), ("ls", ls), ("ls2", ls2)):
        req(name, t, dev, (torch.float32,), (B, K))
    for name, t in (("perm", perm), ("inv_perm", inv_perm)) + (
            (("masks", masks),) if masks is not None else ()):
        req(name, t, dev, (torch.int32,), (K,))
    req("bits_out", bits_out, dev, (torch.int8,), (B, K))
    req("done", done, dev, (torch.bool,), (B,))
    req("pass_out", pass_out, dev, (torch.bool,), (B,))
    req("ctl", ctl, dev, (torch.int32,), (CTL_LEN,))
    req("rows", rows, dev, (torch.int32,), (B + 1,))
    if not 0 < K <= 8192 or B == 0:
        raise ValueError(f"turbo_iter takes 0 < K <= 8192 and rows; got K={K}, {B} rows")


def _stages(n_stages: int) -> int:
    if n_stages not in (1, 3):
        raise ValueError(f"a decode has 1 stage (no cascade) or 3, not {n_stages}")
    return n_stages


def turbo_iter_cuda(post, ls_in, ls, ls2, perm, inv_perm, masks, bits_out, done, pass_out, ctl,
                    rows, parity: int, max_iter: int, n_stages: int) -> None:
    """One launch of the epilogue kernel on PyTorch's current stream,
    predicated on ctl[RUN], over the rows that `rows` lists.  post, ls_in,
    ls, ls2: (B, K) float32; perm, inv_perm, masks (or None: no CRC): (K,)
    int32; bits_out: (B, K) int8; done, pass_out: (B,) bool; ctl:
    (CTL_LEN,) int32; rows: (B + 1,) int32; all contiguous on one CUDA
    device.  ValueError / TypeError for what the kernel does not take (K
    above 8,192, no rows, parity not 0 or 1, n_stages not 1 or 3)."""
    global launches
    _check(post, ls_in, ls, ls2, perm, inv_perm, masks, bits_out, done, pass_out, ctl, rows)
    if parity not in (0, 1):
        raise ValueError(f"parity must be 0 or 1, not {parity}")
    B, K = post.shape
    err = _lib().turbo_iter_launch(
        post.data_ptr(), ls_in.data_ptr(), ls.data_ptr(), ls2.data_ptr(), perm.data_ptr(),
        inv_perm.data_ptr(), None if masks is None else masks.data_ptr(), bits_out.data_ptr(),
        done.data_ptr(), pass_out.data_ptr(), ctl.data_ptr(), rows.data_ptr(), B, K, parity,
        max_iter, _stages(n_stages), _stream(post.device))
    if err != 0:
        raise RuntimeError(f"turbo_iter kernel launch failed: cudaError_t {err}")
    launches += 1


def decode_cuda(lp1, lp2, beta_k1, beta_k2, post, ls_in, ls, ls2, perm, inv_perm, masks,
                bits_out, done, pass_out, ctl, rows, max_iter: int, n_stages: int,
                narrow: bool) -> None:
    """A decode's whole loop on the card, enqueued by one call into the
    library: the arm kernel, then 2 * max_iter slots of a predicated MAP
    launch (`turbodecoder_cuda.map_entry`'s kernel on ls_in with lp1 /
    beta_k1 on even slots, lp2 / beta_k2 on odd ones, into post, over the
    listed rows) and an epilogue launch of the same parity; the launch
    counts of all three kernels grow by what it launched.  lp1, lp2, post:
    (B, K) float32; beta_k1, beta_k2: (B, 8) float32; the rest as for
    `turbo_iter_cuda`."""
    global launches, arm_launches
    _check(post, ls_in, ls, ls2, perm, inv_perm, masks, bits_out, done, pass_out, ctl, rows)
    B, K = post.shape
    req = turbodecoder_cuda._require
    for name, t in (("lp1", lp1), ("lp2", lp2)):
        req(name, t, post.device, (torch.float32,), (B, K))
    for name, t in (("beta_k1", beta_k1), ("beta_k2", beta_k2)):
        req(name, t, post.device, (torch.float32,), (B, 8))
    if max_iter < 0:
        raise ValueError(f"max_iter must be at least 0, not {max_iter}")
    entry, v1, W, L, H_, narrow = turbodecoder_cuda.map_entry(K, narrow)
    err = _lib().turbo_iter_decode(
        entry, int(v1), lp1.data_ptr(), lp2.data_ptr(), beta_k1.data_ptr(), beta_k2.data_ptr(),
        post.data_ptr(), W, L, H_, int(narrow), int(turbodecoder_cuda.LOGMAP), ls_in.data_ptr(),
        ls.data_ptr(), ls2.data_ptr(), perm.data_ptr(), inv_perm.data_ptr(),
        None if masks is None else masks.data_ptr(), bits_out.data_ptr(), done.data_ptr(),
        pass_out.data_ptr(), ctl.data_ptr(), rows.data_ptr(), B, K, max_iter,
        _stages(n_stages), _stream(post.device))
    if err != 0:
        raise RuntimeError(f"turbo decoder loop launch failed: cudaError_t {err}")
    arm_launches += 1
    launches += 2 * max_iter
    if v1:
        turbodecoder_cuda.launches_v1 += 2 * max_iter
    else:
        turbodecoder_cuda.launches += 2 * max_iter

