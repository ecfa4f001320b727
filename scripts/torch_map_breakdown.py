#!/usr/bin/env python3
"""Where the MAP kernels' time goes, on one CUDA card.

Run from the repository root:  python3 scripts/torch_map_breakdown.py

Builds cut-down copies of srslte_emane_tpu_torch/csrc/turbo_map.cu and
turbo_map_v1.cu into build/breakdown/ (all nvcc runs started together) and
times each, back-to-back launches between CUDA events: turbo_map at 768 x
K=5504 (the downlink cell's MAP shape) in both storage modes, turbo_map_v1
at 768 x K=5504 (L=172) and 768 x K=1040 (L=65).  The copies:
  full          the kernel as it is;
  stage_only    staging and write-back, no trellis work;
  no_forward    staging, the backward pass with its checkpoints and the
                halo warm-ups, no segment recompute or forward pass;
  no_recompute  everything but the recompute of each segment's beta rows;
  no_warmup     (v1) everything but the two halo warm-ups.
The copies compute wrong LLRs; only their times are read.  For v1 the time
by phase follows: staging = stage_only, warm-up = full - no_warmup,
recompute = full - no_recompute, forward = no_recompute - no_forward,
backward = no_forward - stage_only - warm-up.

Then v1 with other constants (`tuned_v1`: steps per segment, loop unrolling,
threads per block and the blocks per SM that the shared memory is sized
for), each copy held bit for bit against the unchanged kernel and timed at
the two shapes above, at 128 x K=1056 (L=33) and at 128 x K=5504 (one block
or two per SM: one warp's chain alone), with its columns per block and
blocks per SM.  Prints one JSON line, then the card's name, power limit and
clocks.
"""

import concurrent.futures
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from srslte_emane_tpu_torch.ops.fec import turbodecoder, turbodecoder_cuda as tdc  # noqa: E402

K, B, N = 5504, 768, 20
V1_SHAPES = ((5504, 768, 32), (1040, 768, 16))  # (K, rows, W)
V1_TUNE_SHAPES = V1_SHAPES + ((1056, 128, 32), (5504, 128, 32))


def replace_in(src, name, swaps):
    for old, new in swaps:
        assert old in src, f"{name} changed: {old!r} not found"
        src = src.replace(old, new)
    return src


def variants(src):
    seg = "    for (int j = (n_pairs - 1) / kPairs; j >= 0; --j) {"
    rec = "        if (i0 + u < i1) bwd_pair(bt, L - 1 - 2 * (i0 + u), L - 1 - 2 * (i0 + u) - lo);"
    work = "  if (cl < cols && c < n_cols) {"
    cut = lambda *swaps: replace_in(src, "turbo_map.cu", swaps)
    return {
        "full": src,
        "stage_only": cut((work, "  if (cl < cols && c < 0) {")),
        "no_forward": cut((seg, seg.replace("j >= 0", "j >= n_cols"))),
        "no_recompute": cut((rec, rec.replace("i0 + u < i1)", "i0 + u < i1 && n_cols < 0)"))),
    }


def variants_v1(src):
    seg = "    for (int j = lay.n_seg - 1; j >= 0; --j) {"
    rec = "        if (tt >= lo) {"
    work = "  if (cl < cols && c < n_cols) {"
    warm_b = "    for (int i = 2 * H + L - 1; i >= H + L; --i) {"
    warm_a = "    for (int i = 0; i < H; ++i) {"
    cut = lambda *swaps: replace_in(src, "turbo_map_v1.cu", swaps)
    return {
        "full": src,
        "stage_only": cut((work, "  if (cl < cols && c < 0) {")),
        "no_forward": cut((seg, seg.replace("j >= 0", "j >= n_cols"))),
        "no_recompute": cut((rec, "        if (tt >= lo && n_cols < 0) {")),
        "no_warmup": cut((warm_b, warm_b.replace("i >= H + L;", "i >= H + L && n_cols < 0;")),
                         (warm_a, warm_a.replace("i < H;", "i < H && n_cols < 0;"))),
    }


def tuned_v1(src):
    seg, unroll = "constexpr int kSeg = 8;", "#pragma unroll 4\n"
    threads, blocks = "constexpr int kThreads = 128;", "constexpr int kBlocksPerSm = 4;"
    cut = lambda *swaps: replace_in(src, "turbo_map_v1.cu", swaps)
    return {
        "seg16": cut((seg, seg.replace("8", "16"))),
        "unroll1": cut((unroll, "#pragma unroll 1\n")),
        "unroll2": cut((unroll, "#pragma unroll 2\n")),
        "blocks3": cut((blocks, blocks.replace("4", "3"))),
        "blocks2": cut((blocks, blocks.replace("4", "2"))),
        "threads64_blocks8": cut((threads, threads.replace("128", "64")),
                                 (blocks, blocks.replace("4", "8"))),
        "threads256_blocks2": cut((threads, threads.replace("128", "256")),
                                  (blocks, blocks.replace("4", "2"))),
    }


def build_copies(kind, texts):
    """Build the copies {name: text} of csrc/<kind>.cu under build/breakdown/,
    one nvcc each, started together; returns {name: library}."""
    paths = {}
    for name, text in texts.items():
        d = ROOT / "build" / "breakdown" / f"{kind}-{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{kind}.cu").write_text(text)
        (d / "trellis.cuh").write_text((tdc.CSRC / "trellis.cuh").read_text())
        paths[name] = d / f"{kind}.cu"
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return dict(zip(paths, (b.lib for b in pool.map(tdc.build, paths.values()))))


def per_launch_ms(launch):
    assert launch() == 0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(N):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / N


def main():
    if not torch.cuda.is_available():
        print("torch_map_breakdown: torch.cuda is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev).contiguous()
    normal = lambda *shape: f(rng.normal(0, 4, shape))
    stream = torch.cuda.current_stream().cuda_stream
    out = {}

    ls, lp, beta_k = normal(B, K), normal(B, K), normal(B, 8)
    w = turbodecoder._pick_windows(K)
    L, H = tdc._windows(K, w)
    for name, lib in build_copies("turbo_map", variants(tdc.SOURCE.read_text())).items():
        for narrow in (True, False):
            llr = torch.empty_like(ls)
            out[f"{name}_{'bf16' if narrow else 'f32'}_ms"] = per_launch_ms(
                lambda: lib.turbo_map_launch(ls.data_ptr(), lp.data_ptr(), beta_k.data_ptr(),
                                             llr.data_ptr(), B * w, w, L, H, int(narrow), 0, stream))

    src_v1 = tdc.SOURCE_V1.read_text()
    libs = build_copies("turbo_map_v1", {**variants_v1(src_v1), **tuned_v1(src_v1)})
    for k, rows, w in V1_TUNE_SHAPES:
        ls, lp, beta_k = normal(rows, k), normal(rows, k), normal(rows, 8)
        L, H = tdc._windows_v1(k, w)
        ms, llrs = {}, {}
        for name, lib in libs.items():
            llr = llrs[name] = torch.empty_like(ls)
            ms[name] = per_launch_ms(
                lambda: lib.turbo_map_v1_launch(ls.data_ptr(), lp.data_ptr(), beta_k.data_ptr(),
                                                llr.data_ptr(), rows * w, w, L, H, 0, stream))
        for name in tuned_v1(src_v1):
            assert torch.equal(llrs[name], llrs["full"]), f"{name}: LLRs differ at L={L}"
        out[f"v1_tuned_{rows}x{k}_L{L}"] = {
            name: dict(ms=ms[name], cols=libs[name].turbo_map_v1_cols(L, H),
                       blocks_per_sm=libs[name].turbo_map_v1_blocks_per_sm(L, H, 0))
            for name in ("full", *tuned_v1(src_v1))}
        if (k, rows, w) not in V1_SHAPES:
            continue
        warmup = ms["full"] - ms["no_warmup"]
        out[f"v1_{rows}x{k}_L{L}"] = dict(
            {name: ms[name] for name in variants_v1(src_v1)}, staging_ms=ms["stage_only"], warmup_ms=warmup,
            backward_ms=ms["no_forward"] - ms["stage_only"] - warmup,
            recompute_ms=ms["full"] - ms["no_recompute"],
            forward_ms=ms["no_recompute"] - ms["no_forward"])
    print(json.dumps(out))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
