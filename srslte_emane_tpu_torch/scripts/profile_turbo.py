"""Micro-profile of the turbo-decode path: both MAP kernels, the plain MAP
and the decoder at fixed and early-stop iteration counts.

Twin of the JAX repository's `scripts/profile_turbo.py`, on its inputs: one
default_rng(0) stream of f32 normal LLRs, three (n_cb, k + 4) streams then
two (n_cb, 3) tail pairs, in the source's order (random LLRs are fine for
fixed-iteration timing).  Each MAP half-iteration runs with W =
`_pick_windows(k)` windows (W=32, L=174 at the default k=5568):

  - `map_decode_v1_cuda`, one `turbo_map_v1` launch (the twin of the TPU's
    v1 `map_decode_pallas`);
  - `map_decode_cuda` in f32, one `turbo_map` launch (the twin of
    `map_decode_pallas2`);
  - the plain `_map_decode`, for max(4, iters // 4) calls;
  - `turbo_decode` at a fixed 1 and 2 iterations (no CRC), and with the
    CRC24B early stop at up to 8.

Each stage is the source's `jax.jit` of it (`_timing.jit`), called on
the draws as the source calls it: on the card one CUDA graph each (6 in
all: 5 jit sites, the fixed-iteration one jitted at 1 and 2), captured
at its first call and replayed at every call after it (the plain MAP's
holds thousands of small kernels; each stage's "first_s" is its first
call's seconds, the capture included); with --eager (and on the CPU) op
by op.  The decodes leave n_iter on the device (`turbo_decode(read=False)`),
as a graph must.  On the CPU (`--cpu`) each kernel wrapper's plain
version runs in its place, as the wrappers do for CPU tensors; on the card
a kernel that fails to build or launch fails the run.

Usage: python -m srslte_emane_tpu_torch.scripts.profile_turbo [n_cb] [k] [iters] [--cpu] [--eager]

Each stage is timed over `iters` back-to-back calls after one untimed call
(CUDA events on the card, the host clock on the CPU).  Prints the source's
lines, then one JSON line: {"stages": {label: {"ms", "host_ms",
"turbo_map_launches", "turbo_map_v1_launches", "first_s"}}, "glue_ms",
"kernels_ms",
"n_cb", "k", "n_windows", "iters", "launches": {"turbo_map",
"turbo_map_v1"}, "captured_graphs"} plus "backend" and "device" ("ms" is
null on the CPU; the launch counts are per call, a replay counting its
graph's, "launches" their sum over the stages, and all are 0 on the CPU).
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..ops.fec import crc, turbodecoder, turbodecoder_cuda as tdc
from . import _timing

MAP_V1 = "map_decode_v1_cuda (half-iter)"
MAP = "map_decode_cuda (half-iter)"
PLAIN = "plain _map_decode (half-iter)"
EARLY = "turbo_decode early-stop max8 (random llr)"


def fixed(n_it: int) -> str:
    return f"turbo_decode fixed {n_it} iter"


def inputs(n_cb: int, k: int, dev: torch.device) -> dict:
    """The source's draws on `dev`: d (three (n_cb, k + 4) streams), ls/lp
    (the first k columns of d[0] and d[1]), the two (n_cb, 3) tails and an
    all-valid row mask."""
    rng = np.random.default_rng(0)
    d = [torch.from_numpy(rng.normal(size=(n_cb, k + 4)).astype(np.float32)).to(dev)
         for _ in range(3)]
    tails = [torch.from_numpy(rng.normal(size=(n_cb, 3)).astype(np.float32)).to(dev)
             for _ in range(2)]
    return dict(d=d, ls=d[0][:, :k].contiguous(), lp=d[1][:, :k].contiguous(),
                tails=tails, valid=torch.ones((n_cb,), dtype=torch.bool, device=dev), k=k)


def stages(inp: dict, eager: bool = False) -> dict:
    """label -> zero-argument callable, in the source's order: each calls
    the stage's jit (`_timing.jit`, kept in inp["steps"]) on the draws."""
    ls, lp, (tx, tz), d, valid, k = (inp[n] for n in ("ls", "lp", "tails", "d", "valid", "k"))
    w = turbodecoder._pick_windows(k)
    cuda = ls.device.type == "cuda"
    v1 = tdc.map_decode_v1_cuda if cuda else tdc.map_decode_v1_ref
    map2 = tdc.map_decode_cuda if cuda else tdc.map_decode_ref
    steps = inp.setdefault("steps", [])

    def stage(fn, *args):
        step = _timing.jit(fn, eager)
        steps.append(step)
        return lambda: step(*args)

    out = {MAP_V1: stage(lambda a, b, c, e: v1(a, b, c, e, w), ls, lp, tx, tz),
           MAP: stage(lambda a, b, c, e: map2(a, b, c, e, w), ls, lp, tx, tz),
           PLAIN: stage(turbodecoder._map_decode, ls, lp, tx, tz)}
    for n_it in (1, 2):
        out[fixed(n_it)] = stage(lambda a, b, c, v, n=n_it: turbodecoder.turbo_decode(
            a, b, c, v, k, n, None, read=False), *d, valid)
    out[EARLY] = stage(lambda a, b, c, v: turbodecoder.turbo_decode(
        a, b, c, v, k, 8, crc.LTE_CRC24B, read=False), *d, valid)
    return out


def main(argv=None) -> int:
    ap = _timing.parser(__doc__, eager=True)
    ap.add_argument("n_cb", type=int, nargs="?", default=1024)
    ap.add_argument("k", type=int, nargs="?", default=5568)
    ap.add_argument("iters", type=int, nargs="?", default=20)
    args = ap.parse_args(argv)
    dev = _timing.device(args.cpu, "profile_turbo")
    n_cb, k, iters = args.n_cb, args.k, args.iters
    inp = inputs(n_cb, k, dev)
    w = turbodecoder._pick_windows(k)
    print(f"# n_cb={n_cb} k={k} W={w} kernel={dev.type == 'cuda'}", flush=True)

    res = {}
    for label, fn in stages(inp, args.eager).items():
        _, res[label] = _timing.profile_stage(fn, max(4, iters // 4) if label == PLAIN else iters,
                                              dev)
        ms = _timing.stage_ms(res[label])
        print(f"{label:44s} {ms:8.2f} ms/iter", flush=True)
        if label == fixed(2):
            t_map = _timing.stage_ms(res[MAP_V1])
            glue = ms - 2 * 2 * t_map  # 2 iters = 4 half-iters
            print(f"# glue per fixed-2-iter call ~ {glue:.2f} ms "
                  f"(kernels {4 * t_map:.2f})", flush=True)
    launches = {name: sum(r[f"{name}_launches"] for r in res.values())
                for name in ("turbo_map", "turbo_map_v1")}
    print(json.dumps({"stages": res, "glue_ms": glue, "kernels_ms": 4 * t_map,
                      "n_cb": n_cb, "k": k, "n_windows": w, "iters": iters,
                      "launches": launches, "captured_graphs": _timing.captured(inp["steps"]),
                      **_timing.stamp(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
