#!/usr/bin/env python3
"""Where the turbo_map kernel's time goes, on one CUDA card.

Run from the repository root:  python3 scripts/torch_map_breakdown.py

Builds cut-down copies of srslte_emane_tpu_torch/csrc/turbo_map.cu into
build/breakdown/ and times each at 768 x K=5504 (the downlink cell's MAP
shape) in both storage modes, back-to-back launches between CUDA events:
  full          the kernel as it is;
  stage_only    staging and write-back, no trellis work;
  no_forward    staging, the backward pass with its checkpoints and the
                halo warm-ups, no segment recompute or forward pass;
  no_recompute  everything but the recompute of each segment's beta rows.
The copies compute wrong LLRs; only their times are read.  Prints one JSON
line, then the card's name, power limit and clocks.
"""

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


def variants(src):
    seg = "    for (int j = (n_pairs - 1) / kPairs; j >= 0; --j) {"
    rec = "        if (i0 + u < i1) bwd_pair(bt, L - 1 - 2 * (i0 + u), L - 1 - 2 * (i0 + u) - lo);"
    work = "  if (cl < cols && c < n_cols) {"
    for needle in (seg, rec, work):
        assert needle in src, f"turbo_map.cu changed: {needle!r} not found"
    return {
        "full": src,
        "stage_only": src.replace(work, "  if (cl < cols && c < 0) {"),
        "no_forward": src.replace(seg, seg.replace("j >= 0", "j >= n_cols")),
        "no_recompute": src.replace(rec, rec.replace("i0 + u < i1)", "i0 + u < i1 && n_cols < 0)")),
    }


def main():
    if not torch.cuda.is_available():
        print("torch_map_breakdown: torch.cuda is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev).contiguous()
    ls, lp, beta_k = f(rng.normal(0, 4, (B, K))), f(rng.normal(0, 4, (B, K))), f(rng.normal(0, 4, (B, 8)))
    w = turbodecoder._pick_windows(K)
    L, H = tdc._windows(K, w)
    header = (tdc.CSRC / "trellis.cuh").read_text()
    out = {}
    for name, text in variants(tdc.SOURCE.read_text()).items():
        d = ROOT / "build" / "breakdown" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "turbo_map.cu").write_text(text)
        (d / "trellis.cuh").write_text(header)
        lib = tdc.build(d / "turbo_map.cu").lib
        for narrow in (True, False):
            llr = torch.empty_like(ls)
            launch = lambda: lib.turbo_map_launch(
                ls.data_ptr(), lp.data_ptr(), beta_k.data_ptr(), llr.data_ptr(), B * w, w, L, H,
                int(narrow), 0, torch.cuda.current_stream().cuda_stream)
            assert launch() == 0
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(N):
                launch()
            end.record()
            torch.cuda.synchronize()
            out[f"{name}_{'bf16' if narrow else 'f32'}_ms"] = start.elapsed_time(end) / N
    print(json.dumps(out))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
