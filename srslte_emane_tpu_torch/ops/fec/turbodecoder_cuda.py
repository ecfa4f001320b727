"""Hopper max-log-MAP kernel: wrapper, build, and plain PyTorch version.

`map_decode` is the port's twin of the reference's
`turbodecoder_pallas2.map_decode_pallas2`: one MAP half-iteration of one
constituent decoder over a batch of code blocks, windowed into
(code block x window) columns.  On a CUDA tensor it launches the kernel of
`csrc/turbo_map.cu` (`map_decode_cuda`: the time-major windowing in torch,
then `launch`) or raises; on a CPU tensor it runs `map_decode_ref`, the
plain PyTorch version of the same function.

The window count is the reference decoder's `_pick_windows(K)` (W=32 at
both 20 MHz bench sizes: L=172 at K=5504, L=174 at K=5568), not the TPU
kernel's VMEM-driven refinement; halo windowing changes the LLRs, so
comparisons with the TPU kernel pass it the same `n_windows`.

Rounding points follow the TPU kernel: the inputs are halved in float32,
then (narrow mode) cast to bf16; beta is rounded to the scratch type when
stored; m0 - m1 is float32.

The library is compiled from the repository's source with nvcc at first
use, into build/turbo_map-<hash of source and flags>/, and reused after.
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

from .turbodecoder import HALO, LOGMAP, NEG, _pick_windows, _trellis, beta_tail, max_star

SOURCE = pathlib.Path(__file__).resolve().parents[2] / "csrc" / "turbo_map.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches made by `launch` (a plain count; callers reset it).
launches = 0


class Build(typing.NamedTuple):
    lib: ctypes.CDLL
    path: pathlib.Path
    seconds: float  # nvcc wall time; 0.0 when an earlier build was reused
    log: str  # nvcc/ptxas output (registers, spills) of this build


@functools.lru_cache(maxsize=None)
def build() -> Build:
    """Compile csrc/turbo_map.cu unless this source was built before, then
    load the library."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    path = BUILD_DIR / f"turbo_map-{tag.hexdigest()[:16]}" / "libturbo_map.so"
    seconds, log = 0.0, ""
    if not path.exists():
        nvcc = shutil.which("nvcc") or os.path.join(
            os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True, check=False)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {res.returncode}:\n{log}")
        os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    lib = ctypes.CDLL(str(path))
    lib.turbo_map_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.turbo_map_launch.restype = ctypes.c_int
    return Build(lib, path, seconds, log)


def _windows(K: int, n_windows: int):
    L = K // n_windows
    if K % n_windows or L % 2:
        raise ValueError(f"K={K} with {n_windows} windows: window length must be even")
    return L, min(HALO, L)


def time_major(x: torch.Tensor, n_windows: int, narrow: bool) -> torch.Tensor:
    """(B, K) LLRs -> (L + 2H, B*W) pre-halved windows with halos, zero
    outside [0, K), column b*W + w, in the kernel's storage type."""
    B, K = x.shape
    L, H = _windows(K, n_windows)
    x = (x.to(torch.float32) * 0.5).to(torch.bfloat16 if narrow else torch.float32)
    x = torch.nn.functional.pad(x, (H, H))  # (B, K + 2H), contiguous
    spans = x.as_strided((B, n_windows, L + 2 * H), (K + 2 * H, L, 1))
    return spans.permute(2, 0, 1).contiguous().view(L + 2 * H, B * n_windows)


def _require(name: str, t: torch.Tensor, device: torch.device, dtypes: tuple, shape: tuple):
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must lie on CUDA device {device}, not {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, not {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(ls_t: torch.Tensor, lp_t: torch.Tensor, beta_k: torch.Tensor,
           n_windows: int, L: int) -> torch.Tensor:
    """The kernel alone, on PyTorch's current stream.  ls_t/lp_t: (L + 2H,
    n_cols) time-major pre-halved LLRs (`time_major`), bf16 (narrow mode)
    or float32; beta_k: (n_cols / n_windows, 8) float32 exact beta_K; all
    contiguous on one CUDA device.  Returns the posterior LLRs (L, n_cols)."""
    global launches
    H = min(HALO, L)
    n_cols = ls_t.shape[-1]
    if L <= 0 or L % 2 or n_windows <= 0 or n_cols % n_windows:
        raise ValueError(f"{n_cols} columns, {n_windows} windows of length {L}: "
                         "need an even L and whole code blocks")
    dev = ls_t.device
    _require("ls_t", ls_t, dev, (torch.float32, torch.bfloat16), (L + 2 * H, n_cols))
    _require("lp_t", lp_t, dev, (ls_t.dtype,), (L + 2 * H, n_cols))
    _require("beta_k", beta_k, dev, (torch.float32,), (n_cols // n_windows, 8))
    llr = torch.empty((L, n_cols), dtype=torch.float32, device=dev)
    scratch = torch.empty((L, 8, n_cols), dtype=ls_t.dtype, device=dev)
    err = build().lib.turbo_map_launch(
        ls_t.data_ptr(), lp_t.data_ptr(), beta_k.data_ptr(), llr.data_ptr(),
        scratch.data_ptr(), n_cols, n_windows, L, H, int(ls_t.dtype == torch.bfloat16),
        int(LOGMAP), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"turbo_map kernel launch failed: cudaError_t {err}")
    launches += 1
    return llr


def map_decode_cuda(ls: torch.Tensor, lp: torch.Tensor, tail_x: torch.Tensor,
                    tail_z: torch.Tensor, n_windows: int,
                    narrow: bool = False) -> torch.Tensor:
    """One MAP half-iteration through the kernel.  ls/lp: (B, K) float32,
    tail_x/tail_z: (B, 3) float32, all contiguous on one CUDA device.
    Returns the posterior LLRs (B, K) float32."""
    B, K = ls.shape
    for name, t, shape in (("ls", ls, (B, K)), ("lp", lp, (B, K)),
                           ("tail_x", tail_x, (B, 3)), ("tail_z", tail_z, (B, 3))):
        _require(name, t, ls.device, (torch.float32,), shape)
    L, _ = _windows(K, n_windows)
    llr = launch(time_major(ls, n_windows, narrow), time_major(lp, n_windows, narrow),
                 beta_tail(tail_x, tail_z).contiguous(), n_windows, L)
    return llr.view(L, B, n_windows).permute(1, 2, 0).reshape(B, K)


def map_decode_ref(ls: torch.Tensor, lp: torch.Tensor, tail_x: torch.Tensor,
                   tail_z: torch.Tensor, n_windows: int,
                   narrow: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel's function (same windows, same
    rounding points), states as (8, n_cols) tensors."""
    B, K = ls.shape
    L, H = _windows(K, n_windows)
    n_cols = B * n_windows
    dev = ls.device
    T = _trellis()
    idx = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    ns, pz, ps, pu = T["next_state"], T["parity"], T["prev_state"], T["prev_u"]
    combo = np.arange(2)[None, :] * 2 + pz  # (8, 2): u*2 + z of (s, u)
    ns0, ns1 = idx(ns[:, 0]), idx(ns[:, 1])
    cb0, cb1 = idx(combo[:, 0]), idx(combo[:, 1])
    ps0, ps1, pu0, pu1 = idx(ps[:, 0]), idx(ps[:, 1]), idx(pu[:, 0]), idx(pu[:, 1])
    cf0, cf1 = idx(combo[ps[:, 0], pu[:, 0]]), idx(combo[ps[:, 1], pu[:, 1]])

    ls_t = time_major(ls, n_windows, narrow).to(torch.float32)
    lp_t = time_major(lp, n_windows, narrow).to(torch.float32)

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


def map_decode(ls: torch.Tensor, lp: torch.Tensor, tail_x: torch.Tensor,
               tail_z: torch.Tensor, narrow: bool = False) -> torch.Tensor:
    """One MAP half-iteration with W = _pick_windows(K): the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    n_windows = _pick_windows(ls.shape[1])
    if ls.device.type == "cpu":
        return map_decode_ref(ls, lp, tail_x, tail_z, n_windows, narrow)
    return map_decode_cuda(ls, lp, tail_x, tail_z, n_windows, narrow)
