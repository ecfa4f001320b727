"""Hopper max-log-MAP kernels: wrappers, build, and plain PyTorch versions.

`map_decode` is the port's twin of the reference's
`turbodecoder_pallas2.map_decode_pallas2`: one MAP half-iteration of one
constituent decoder over a batch of code blocks, windowed into
(code block x window) columns.  On a CUDA tensor it launches the kernel of
`csrc/turbo_map.cu` (`map_decode_cuda`: beta_K, then one launch on the
(B, K) tensors; the kernel windows the inputs itself, as `window_index`
states) or raises; on a CPU tensor it runs `map_decode_ref`, the plain
PyTorch version of the same function.

That kernel steps two trellis stages at a time, so it needs an even window
length L.  For an odd L, `map_decode` takes the second kernel, as the
reference falls back to its v1 TPU kernel (`turbodecoder_pallas2.py:241-245`,
`turbodecoder_pallas.map_decode_pallas`): `csrc/turbo_map_v1.cu`
(`map_decode_v1_cuda`, float32 only, any L): beta_K, then one launch on the
(B, K) tensors too, with the branch metrics, the halo warm-ups and the
window-edge rules in the kernel; its plain version is `map_decode_v1_ref`.
No LTE code-block size gives an odd L with `_pick_windows`, so the decoder
reaches v1 only when a caller picks the window count.

The window count is the reference decoder's `_pick_windows(K)` (W=32 at
both 20 MHz bench sizes: L=172 at K=5504, L=174 at K=5568), not the TPU
kernel's VMEM-driven refinement; halo windowing changes the LLRs, so
comparisons with the TPU kernel pass it the same `n_windows`.

Rounding points follow the TPU kernel: the inputs are halved in float32,
then (narrow mode) cast to bf16; beta is rounded to the storage type when
stored; alpha and m0 - m1 are float32.

Each kernel library is compiled from the repository's source with nvcc at
first use, into build/<kernel>-<hash of sources and flags>/, and reused after.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
import typing

import numpy as np
import torch

from .turbodecoder import (HALO, LOGMAP, NEG, _gammas, _pick_windows, _trellis, beta_tail,
                           max_star)

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
SOURCE = CSRC / "turbo_map.cu"
SOURCE_V1 = CSRC / "turbo_map_v1.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches made by `launch` and by `launch_v1` (plain counts;
# callers reset them).
launches = 0
launches_v1 = 0


# argument types of each library's C entry points (all return an int)
_ENTRY_POINTS = {
    "turbo_map": {
        "turbo_map_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3,
        "turbo_map_blocks_per_sm": [ctypes.c_int] * 4,
        "turbo_map_cols": [ctypes.c_int] * 3,
    },
    "turbo_map_v1": {
        "turbo_map_v1_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3,
        "turbo_map_v1_blocks_per_sm": [ctypes.c_int] * 3,
        "turbo_map_v1_cols": [ctypes.c_int] * 2,
    },
    "viterbi": {  # ops/fec/viterbi_cuda.py's kernel
        "viterbi_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
        "viterbi_fits": [ctypes.c_int] * 2,
        "viterbi_global_fits": [ctypes.c_int] * 2,
        "viterbi_blocks_per_sm": [ctypes.c_int] * 2,
        "viterbi_rows_per_block": [],
    },
    "turbo_iter": {  # ops/fec/turbo_iter_cuda.py's kernels
        "turbo_iter_launch": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        "turbo_iter_decode": ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                              + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                              + [ctypes.c_void_p]),
    },
    "sch_encode": {  # ops/fec/sch_encode_cuda.py's kernels
        "sch_encode_launch": ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
                              + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                              + [ctypes.c_void_p] * 2),
    },
}


class Build(typing.NamedTuple):
    lib: ctypes.CDLL
    path: pathlib.Path
    seconds: float  # nvcc wall time; 0.0 when an earlier build was reused
    log: str  # nvcc/ptxas output (registers, spills) of this build


@functools.lru_cache(maxsize=None)
def build(source: pathlib.Path) -> Build:
    """Compile one kernel source of csrc/ (with the csrc headers it may
    include) unless these sources were built before, then load the library."""
    name = source.stem
    tag = hashlib.sha256(b"".join(p.read_bytes() for p in [source, *sorted(CSRC.glob("*.cuh"))])
                         + " ".join(NVCC_FLAGS).encode())
    path = BUILD_DIR / f"{name}-{tag.hexdigest()[:16]}" / f"lib{name}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        nvcc = shutil.which("nvcc") or os.path.join(
            os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
                             capture_output=True, text=True, check=False)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} with code {res.returncode}:\n{log}")
        os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    lib = ctypes.CDLL(str(path))
    for entry, argtypes in _ENTRY_POINTS[name].items():
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
    return Build(lib, path, seconds, log)


def occupancy(K: int, n_windows: int, narrow: bool) -> tuple[int, int]:
    """(columns per block, blocks per SM) of turbo_map.cu on the current
    card for this code-block size (blocks per SM from CUDA's occupancy
    calculator)."""
    L, H = _windows(K, n_windows)
    lib = build(SOURCE).lib
    n = lib.turbo_map_blocks_per_sm(L, H, int(narrow), int(LOGMAP))
    if n < 0:
        raise RuntimeError(f"occupancy query failed for K={K}")
    return lib.turbo_map_cols(L, H, int(narrow)), n


def occupancy_v1(K: int, n_windows: int) -> tuple[int, int]:
    """(columns per block, blocks per SM) of turbo_map_v1.cu on the current
    card for this shape (one column per block when the window is too long
    for four blocks to share an SM)."""
    L, H = _windows_v1(K, n_windows)
    lib = build(SOURCE_V1).lib
    n = lib.turbo_map_v1_blocks_per_sm(L, H, int(LOGMAP))
    if n < 0:
        raise RuntimeError(f"occupancy query failed for K={K} in {n_windows} windows")
    return lib.turbo_map_v1_cols(L, H), n


def _windows_v1(K: int, n_windows: int):
    """(L, H) of K split into n_windows windows of any length L >= 1."""
    if n_windows <= 0 or K <= 0 or K % n_windows:
        raise ValueError(f"K={K} does not split into {n_windows} windows")
    L = K // n_windows
    return L, min(HALO, L)


def _windows(K: int, n_windows: int):
    """(L, H) for the radix-2 kernel, which needs an even L."""
    L, H = _windows_v1(K, n_windows)
    if L % 2:
        raise ValueError(f"K={K} with {n_windows} windows: window length must be even")
    return L, H


@functools.lru_cache(maxsize=64)
def window_index(K: int, n_windows: int) -> torch.Tensor:
    """Both kernels' addressing: (L + 2H, W) int64, the K-index that step i
    of window w reads (i in [0, L + 2H), the window's halos included), or
    -1 where the step lies outside [0, K) and reads zero.  A kernel reads
    flat index b*K + k of the (B, K) inputs for column b*W + w.  Any window
    length L >= 1: up to L = 40 the halo is the whole neighbouring window."""
    L, H = _windows_v1(K, n_windows)
    k = (torch.arange(n_windows)[None, :] * L - H + torch.arange(L + 2 * H)[:, None])
    return torch.where((k >= 0) & (k < K), k, -1)


def time_major(x: torch.Tensor, n_windows: int, narrow: bool) -> torch.Tensor:
    """(B, K) LLRs -> (L + 2H, B*W) pre-halved windows with halos, zero
    outside [0, K), column b*W + w, in the kernel's storage type: the TPU
    kernel's layout, built with pad and strides (`window_index` states the
    same windows as indices)."""
    B, K = x.shape
    L, H = _windows(K, n_windows)
    x = (x.to(torch.float32) * 0.5).to(torch.bfloat16 if narrow else torch.float32)
    x = torch.nn.functional.pad(x, (H, H))  # (B, K + 2H), contiguous
    spans = x.as_strided((B, n_windows, L + 2 * H), (K + 2 * H, L, 1))
    return spans.permute(2, 0, 1).contiguous().view(L + 2 * H, B * n_windows)


def _on_card(t: torch.Tensor, device: torch.device) -> bool:
    return t.device.type == "cuda" and t.device == device


def _require(name: str, t: torch.Tensor, device: torch.device, dtypes: tuple, shape: tuple):
    """The checks every kernel wrapper makes of an input before it launches."""
    if not _on_card(t, device):
        raise ValueError(f"{name} must lie on CUDA device {device}, not {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, not {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_select(run: torch.Tensor | None, rows: torch.Tensor | None, B: int,
                  dev: torch.device) -> tuple[int | None, int | None]:
    """The device addresses of a pass's flag and row list (None: every row
    runs), checked."""
    if run is not None:
        _require("run", run, dev, (torch.int32,), tuple(run.shape))
        if run.numel() != 1:
            raise ValueError(f"run must hold one flag, not {run.numel()}")
    if rows is not None:
        _require("rows", rows, dev, (torch.int32,), (B + 1,))
    return (None if run is None else run.data_ptr(), None if rows is None else rows.data_ptr())


def _output(out: torch.Tensor | None, like: torch.Tensor) -> torch.Tensor:
    """The posterior's tensor: `out` when given (checked), else a new one."""
    if out is None:
        return torch.empty_like(like)
    _require("out", out, like.device, (torch.float32,), tuple(like.shape))
    return out


def launch(ls: torch.Tensor, lp: torch.Tensor, beta_k: torch.Tensor, n_windows: int,
           narrow: bool, run: torch.Tensor | None = None, rows: torch.Tensor | None = None,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel alone, on PyTorch's current stream.  ls/lp: (B, K)
    float32 LLRs as the decoder holds them; beta_k: (B, 8) float32 exact
    beta_K (`beta_tail`); all contiguous on one CUDA device.  For the turbo
    decoder's loop on the device: run, None or a one-element int32 flag on
    the card, when it holds 0 the launch returns at once and writes
    nothing; rows, None or (B + 1,) int32 [n, r_0, ...] on the card, only
    the n listed rows are computed (the others of the output are not
    written).  out: the (B, K) float32 tensor to write, else a new one.
    Returns the posterior LLRs (B, K) float32."""
    global launches
    B, K = ls.shape
    L, H = _windows(K, n_windows)
    dev = ls.device
    _require("ls", ls, dev, (torch.float32,), (B, K))
    _require("lp", lp, dev, (torch.float32,), (B, K))
    _require("beta_k", beta_k, dev, (torch.float32,), (B, 8))
    run_ptr, rows_ptr = _check_select(run, rows, B, dev)
    llr = _output(out, ls)
    err = build(SOURCE).lib.turbo_map_launch(
        ls.data_ptr(), lp.data_ptr(), beta_k.data_ptr(), llr.data_ptr(), B * n_windows,
        n_windows, L, H, int(narrow), int(LOGMAP), run_ptr, rows_ptr,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"turbo_map kernel launch failed: cudaError_t {err}")
    launches += 1
    return llr


def map_decode_cuda(ls: torch.Tensor, lp: torch.Tensor, tail_x: torch.Tensor,
                    tail_z: torch.Tensor, n_windows: int,
                    narrow: bool = False) -> torch.Tensor:
    """One MAP half-iteration through the kernel: beta_K, then one launch
    on the (B, K) tensors.  ls/lp: (B, K) float32, tail_x/tail_z: (B, 3)
    float32, all contiguous on one CUDA device.  Returns the posterior LLRs
    (B, K) float32."""
    B, K = ls.shape
    for name, t, shape in (("ls", ls, (B, K)), ("lp", lp, (B, K)),
                           ("tail_x", tail_x, (B, 3)), ("tail_z", tail_z, (B, 3))):
        _require(name, t, ls.device, (torch.float32,), shape)
    return launch(ls, lp, beta_tail(tail_x, tail_z).contiguous(), n_windows, narrow)


@functools.lru_cache(maxsize=8)
def _index_tables(dev: torch.device):
    """The trellis as index tensors on `dev`: next states ns0/ns1 and the
    combos cb0/cb1 (u*2 + z) of the transitions (s, u=0/1); predecessors
    ps0/ps1 of each state, their inputs pu0/pu1 and combos cf0/cf1."""
    T = _trellis()
    idx = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    ns, pz, ps, pu = T["next_state"], T["parity"], T["prev_state"], T["prev_u"]
    combo = np.arange(2)[None, :] * 2 + pz  # (8, 2): u*2 + z of (s, u)
    return (idx(ns[:, 0]), idx(ns[:, 1]), idx(combo[:, 0]), idx(combo[:, 1]),
            idx(ps[:, 0]), idx(ps[:, 1]), idx(pu[:, 0]), idx(pu[:, 1]),
            idx(combo[ps[:, 0], pu[:, 0]]), idx(combo[ps[:, 1], pu[:, 1]]))


def map_decode_ref(ls: torch.Tensor, lp: torch.Tensor, tail_x: torch.Tensor,
                   tail_z: torch.Tensor, n_windows: int,
                   narrow: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel's function (same windows, same
    rounding points), states as (8, n_cols) tensors."""
    B, K = ls.shape
    L, H = _windows(K, n_windows)
    n_cols = B * n_windows
    dev = ls.device
    ns0, ns1, cb0, cb1, ps0, ps1, pu0, pu1, cf0, cf1 = _index_tables(dev)

    idx = window_index(K, n_windows).to(dev)
    zero = ls.new_zeros((B, 1))

    def windows(x):  # (L + 2H, B*W), halved and rounded as the kernel stages it
        x = (x.to(torch.float32) * 0.5).to(torch.bfloat16 if narrow else torch.float32)
        x = torch.cat([x.to(torch.float32), zero], dim=1)[:, idx]  # index -1: the zero
        return x.permute(1, 0, 2).reshape(L + 2 * H, n_cols)

    ls_t, lp_t = windows(ls), windows(lp)

    def g4(t):
        a, b = ls_t[t] + lp_t[t], ls_t[t] - lp_t[t]
        return torch.stack([a, b, -b, -a])  # (4, n_cols), combo = u*2 + z

    def bwd_step(beta, g):
        return max_star(beta[ns0] + g[cb0], beta[ns1] + g[cb1])

    def fwd_step(alpha, g):
        return max_star(alpha[ps0] + g[cf0], alpha[ps1] + g[cf1])

    normalise = lambda x: x - x.max(dim=0).values
    w = torch.arange(n_cols, device=dev) % n_windows

    beta = ls_t.new_zeros((8, n_cols))
    for i in range(H):
        beta = bwd_step(beta, g4(2 * H + L - 1 - i))
    bt = beta_tail(tail_x, tail_z).repeat_interleave(n_windows, dim=0).T
    beta = normalise(torch.where(w == n_windows - 1, bt, beta))
    sdt = torch.bfloat16 if narrow else torch.float32
    scratch = ls_t.new_empty((L, 8, n_cols), dtype=sdt)
    for i in range(L // 2):
        tt = L - 1 - 2 * i
        scratch[tt] = beta.to(sdt)
        beta = bwd_step(beta, g4(H + tt))
        scratch[tt - 1] = beta.to(sdt)
        beta = bwd_step(beta, g4(H + tt - 1))
        if narrow:
            beta = normalise(beta)

    alpha = ls_t.new_zeros((8, n_cols))
    for i in range(H):
        alpha = fwd_step(alpha, g4(i))
    exact0 = torch.full((8, 1), NEG, dtype=torch.float32, device=dev)
    exact0[0] = 0.0
    alpha = normalise(torch.where(w == 0, exact0, alpha))
    llr = ls_t.new_empty((L, n_cols))
    for tt in range(L):
        g = g4(H + tt)
        t0, t1 = alpha + g[cb0], alpha + g[cb1]  # tsu[s][u]
        bn = scratch[tt].to(torch.float32)
        llr[tt] = (t0 + bn[ns0]).max(dim=0).values - (t1 + bn[ns1]).max(dim=0).values
        tsu = torch.stack([t0, t1], dim=1)  # (8, 2, n_cols)
        alpha = max_star(tsu[ps0, pu0], tsu[ps1, pu1])
    return llr.view(L, B, n_windows).permute(1, 2, 0).reshape(B, K)


def _v1_steps(dev: torch.device):
    """v1's trellis steps on (8, n_cols) states with (4, n_cols) branch
    metrics, each followed by subtracting the max over the states, and its
    posterior m0 - m1 from alpha, the metrics and beta at the next node."""
    ns0, ns1, cb0, cb1, ps0, ps1, _, _, cf0, cf1 = _index_tables(dev)
    normalise = lambda x: x - x.max(dim=0).values

    def beta_step(beta, g):
        return normalise(max_star(beta[ns0] + g[cb0], beta[ns1] + g[cb1]))

    def alpha_step(alpha, g):
        return normalise(max_star(alpha[ps0] + g[cf0], alpha[ps1] + g[cf1]))

    def posterior(alpha, g, bn):
        return ((alpha + g[cb0] + bn[ns0]).max(dim=0).values
                - (alpha + g[cb1] + bn[ns1]).max(dim=0).values)

    return beta_step, alpha_step, posterior


def _v1_windows(ls: torch.Tensor, lp: torch.Tensor, n_windows: int) -> torch.Tensor:
    """The branch metrics of every window with its halos, time-major:
    (L + 2H, 4, n_cols), zero outside [0, K), column b*W + w, built with pad
    and strides (`window_index` states the same windows as indices)."""
    B, K = ls.shape
    L, H = _windows_v1(K, n_windows)
    g = torch.nn.functional.pad(_gammas(ls.to(torch.float32), lp.to(torch.float32)),
                                (0, 0, H, H))  # (B, K + 2H, 4), zero outside [0, K)
    spans = g.as_strided((B, n_windows, L + 2 * H, 4), ((K + 2 * H) * 4, L * 4, 4, 1))
    return spans.permute(2, 3, 0, 1).reshape(L + 2 * H, 4, B * n_windows)


def _v1_inputs(ls: torch.Tensor, lp: torch.Tensor, tail_x: torch.Tensor,
               tail_z: torch.Tensor, n_windows: int):
    """What the TPU's v1 kernel is given, as `map_decode_pallas` computes it
    outside its kernel (the CUDA kernel computes all of it itself): branch
    metrics (L, 4, n_cols) time-major, alpha at node 0 and beta at node L of
    every window (8, n_cols); column b*W + w.  The halo pre-scans start from
    the all-zero state and subtract the max at every step; window 0 takes
    the exact alpha_0, window W-1 the tail-derived beta_K less its max."""
    B, K = ls.shape
    L, H = _windows_v1(K, n_windows)
    n_cols = B * n_windows
    dev = ls.device
    beta_step, alpha_step, _ = _v1_steps(dev)
    gw = _v1_windows(ls, lp, n_windows)
    a0 = gw.new_zeros((8, n_cols))
    b0 = gw.new_zeros((8, n_cols))
    for i in range(H):
        a0 = alpha_step(a0, gw[i])
        b0 = beta_step(b0, gw[2 * H + L - 1 - i])
    w = torch.arange(n_cols, device=dev) % n_windows
    exact0 = torch.full((8, 1), NEG, dtype=torch.float32, device=dev)
    exact0[0] = 0.0
    a0 = torch.where(w == 0, exact0, a0)
    bt = beta_tail(tail_x, tail_z)
    bt = (bt - bt.max(dim=-1, keepdim=True).values).repeat_interleave(n_windows, dim=0).T
    b0 = torch.where(w == n_windows - 1, bt, b0)
    return gw[H:H + L].contiguous(), a0.contiguous(), b0.contiguous()


def launch_v1(ls: torch.Tensor, lp: torch.Tensor, beta_k: torch.Tensor,
              n_windows: int, run: torch.Tensor | None = None,
              rows: torch.Tensor | None = None, out: torch.Tensor | None = None) -> torch.Tensor:
    """The v1 kernel alone, on PyTorch's current stream.  ls/lp: (B, K)
    float32 LLRs as the decoder holds them; beta_k: (B, 8) float32 exact
    beta_K (`beta_tail`); all contiguous on one CUDA device; run, rows and
    out as for `launch`.  Returns the posterior LLRs (B, K) float32 and allocates
    nothing else.

    One kernel takes every window length that fits a block's shared memory
    (L up to about 19,000, three times the largest code block): as many
    columns per block as let four blocks share an SM, or, for L above about
    4,700, one column per block.  A longer window raises ValueError."""
    global launches_v1
    B, K = ls.shape
    L, H = _windows_v1(K, n_windows)
    dev = ls.device
    _require("ls", ls, dev, (torch.float32,), (B, K))
    _require("lp", lp, dev, (torch.float32,), (B, K))
    _require("beta_k", beta_k, dev, (torch.float32,), (B, 8))
    run_ptr, rows_ptr = _check_select(run, rows, B, dev)
    lib = build(SOURCE_V1).lib
    if lib.turbo_map_v1_cols(L, H) == 0:
        raise ValueError(f"window length {L} does not fit the kernel's shared memory")
    llr = _output(out, ls)
    err = lib.turbo_map_v1_launch(
        ls.data_ptr(), lp.data_ptr(), beta_k.data_ptr(), llr.data_ptr(), B * n_windows,
        n_windows, L, H, int(LOGMAP), run_ptr, rows_ptr,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"turbo_map_v1 kernel launch failed: cudaError_t {err}")
    launches_v1 += 1
    return llr


def map_decode_v1_cuda(ls: torch.Tensor, lp: torch.Tensor, tail_x: torch.Tensor,
                       tail_z: torch.Tensor, n_windows: int) -> torch.Tensor:
    """One MAP half-iteration through the v1 kernel, any window length:
    beta_K, then one launch on the (B, K) tensors.  ls/lp: (B, K) float32, tail_x/tail_z: (B, 3)
    float32, all contiguous on one CUDA device.  Returns the posterior LLRs
    (B, K) float32."""
    B, K = ls.shape
    for name, t, shape in (("ls", ls, (B, K)), ("lp", lp, (B, K)),
                           ("tail_x", tail_x, (B, 3)), ("tail_z", tail_z, (B, 3))):
        _require(name, t, ls.device, (torch.float32,), shape)
    return launch_v1(ls, lp, beta_tail(tail_x, tail_z).contiguous(), n_windows)


def map_decode_v1_ref(ls: torch.Tensor, lp: torch.Tensor, tail_x: torch.Tensor,
                      tail_z: torch.Tensor, n_windows: int) -> torch.Tensor:
    """Plain PyTorch version of the v1 kernel's function (same windows, same
    normalisation points), states as (8, n_cols) tensors."""
    B, K = ls.shape
    g, alpha, beta = _v1_inputs(ls, lp, tail_x, tail_z, n_windows)
    L, _, n_cols = g.shape
    beta_step, alpha_step, posterior = _v1_steps(ls.device)
    scratch = g.new_empty((L, 8, n_cols))
    for t in range(L - 1, -1, -1):
        scratch[t] = beta
        beta = beta_step(beta, g[t])
    llr = g.new_empty((L, n_cols))
    for t in range(L):
        llr[t] = posterior(alpha, g[t], scratch[t])
        alpha = alpha_step(alpha, g[t])
    return llr.view(L, B, n_windows).permute(1, 2, 0).reshape(B, K)


def map_decode(ls: torch.Tensor, lp: torch.Tensor, tail_x: torch.Tensor,
               tail_z: torch.Tensor, narrow: bool = False) -> torch.Tensor:
    """One MAP half-iteration with W = _pick_windows(K): the kernel for CUDA
    tensors, the plain version for CPU tensors.  An odd window length goes
    to v1 in float32 (`narrow` does not apply), as in the reference."""
    n_windows = _pick_windows(ls.shape[1])
    cpu = ls.device.type == "cpu"
    if (ls.shape[1] // n_windows) % 2:
        v1 = map_decode_v1_ref if cpu else map_decode_v1_cuda
        return v1(ls, lp, tail_x, tail_z, n_windows)
    if cpu:
        return map_decode_ref(ls, lp, tail_x, tail_z, n_windows, narrow)
    return map_decode_cuda(ls, lp, tail_x, tail_z, n_windows, narrow)



def map_entry(K: int, narrow: bool):
    """What the decoder's loop on the card hands `turbo_iter_cuda.decode_cuda`
    for its MAP launches, with W = _pick_windows(K) as `map_decode` routes:
    (address of the library's C entry point, v1, W, L, H, narrow), the v1
    kernel (float32) for an odd window length, else turbo_map.  Raises as
    `launch` / `launch_v1` do for a shape the kernel does not take."""
    n_windows = _pick_windows(K)
    if (K // n_windows) % 2:
        L, H = _windows_v1(K, n_windows)
        lib = build(SOURCE_V1).lib
        if lib.turbo_map_v1_cols(L, H) == 0:
            raise ValueError(f"window length {L} does not fit the kernel's shared memory")
        return ctypes.cast(lib.turbo_map_v1_launch, ctypes.c_void_p).value, True, n_windows, L, H, False
    L, H = _windows(K, n_windows)
    entry = build(SOURCE).lib.turbo_map_launch
    return ctypes.cast(entry, ctypes.c_void_p).value, False, n_windows, L, H, narrow
