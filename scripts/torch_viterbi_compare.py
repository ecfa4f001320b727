#!/usr/bin/env python3
"""The Viterbi kernel against other builds of it, in turns on one CUDA card.

Run from the repository root:
    python3 scripts/torch_viterbi_compare.py [OTHER_VITERBI_CU ...]

Builds srslte_emane_tpu_torch/csrc/viterbi.cu and copies of it into
build/viterbi_compare/<name>/ (one nvcc each, all started together):
  kernel        the kernel as it is;
  lanes4        4 lanes to a row (16 states a lane, 8 rows a warp);
  xor_rounds    the row's maximum in 3 dependent xor-shuffle rounds, in
                place of 7 independent shuffles and a tree;
  redux         the row's maximum as one __reduce_max_sync on the maxima's
                order-preserving integer keys (a mask per row);
  batch1        the traceback reading one decision word at a time, in place
                of 8 together;
  unroll1       the trellis loop not unrolled (the kernel unrolls it by 2);
  int_decisions each decision bit set from a compare by integer selects, in
                place of float adds and multiplies on 2^23;
and copies with one part of the step cut, whose bits are wrong and whose
times say what that part costs (kernel - cut):
  no_traceback  the traceback (the rows of a full warp skip it);
  cut_fetch     the 8 shuffles that fetch the predecessors' metrics;
  cut_max       the row's maximum over its lanes (shuffles and tree);
  cut_decisions the decision bits (the byte is still stored);
  cut_loads     the branch metrics' shared-memory reads;
and each file named on the command line as other0, other1, ... (an earlier
commit's csrc/viterbi.cu, e.g. `git show HEAD~1:srslte_emane_tpu_torch/
csrc/viterbi.cu > build/parent/viterbi.cu`; the C entry points
viterbi_launch, viterbi_fits and viterbi_blocks_per_sm are all it needs).
Every build but the cut ones is held bit for bit to the kernel at every
shape, and the kernel to viterbi_decode_ref at the smaller ones.  Then each
shape is timed in turns (others, copies, kernel, kernel, copies, others;
back-to-back launches between CUDA events, warm; the kernel and the others
L2-flushed too at 2,816 x K=44): the blind search's K=44 at 1 to 8,448
rows, one row at each caller's K, NPDSCH's 128 x K=224 and 4 x K=1,211 (the
first K whose rows leave shared memory).  Prints one JSON line (us and ns
per trellis step by shape and build), then the card's name and power
limit.
"""

import concurrent.futures
import ctypes
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from srslte_emane_tpu_torch.ops.fec import (convcoder, turbodecoder_cuda as tdc,  # noqa: E402
                                            viterbi, viterbi_cuda)

TB_ITER, N, FLUSH_BYTES = 3, 20, 64 << 20
SWEEP_K, SWEEP_ROWS = 44, (1, 64, 512, 2816, 8448)
CALLER_KS = (28, 38, 40, 44, 50, 55, 64)  # UCI, PBCH, DCI 1A / 1 / 2A at 100 PRB, NPBCH
OTHER_SHAPES = ((128, 224), (4, 1211))  # NPDSCH; beyond shared memory
PLAIN_ROWS = 512  # the plain loop checks the kernel up to this many rows
FLUSHED = (2816, 44)
CUT = ("no_traceback", "cut_fetch", "cut_max", "cut_decisions", "cut_loads")  # wrong bits


def replace_in(src, swaps):
    for old, new in swaps:
        assert old in src, f"csrc/viterbi.cu changed: {old!r} not found"
        src = src.replace(old, new)
    return src


def copies(src):
    lanes = "constexpr int kLanes = 8;"
    max7 = ("  float part[kLanes];  // the row's lanes' maxima: 7 independent shuffles\n"
            "  part[0] = tree[0];\n"
            "#pragma unroll\n"
            "  for (int i = 1; i < kLanes; ++i) part[i] = __shfl_xor_sync(kFull, tree[0], i, kLanes);\n"
            "#pragma unroll\n"
            "  for (int w = 1; w < kLanes; w <<= 1)\n"
            "#pragma unroll\n"
            "    for (int i = 0; i < kLanes; i += 2 * w) part[i] = fmaxf(part[i], part[i + w]);\n"
            "  const float mx = part[0];\n")
    rounds = ("  float mx = tree[0];\n"
              "#pragma unroll\n"
              "  for (int off = kLanes / 2; off > 0; off >>= 1)\n"
              "    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off, kLanes));\n")
    redux = ("  const unsigned mask = ((1u << kLanes) - 1) << (threadIdx.x / kLanes * kLanes);\n"
             "  int key = __float_as_int(tree[0]);  // its order-preserving integer key\n"
             "  key = __reduce_max_sync(mask, key ^ ((key >> 31) & 0x7fffffff));\n"
             "  const float mx = __int_as_float(key ^ ((key >> 31) & 0x7fffffff));\n")
    fetch = "    rcv[r] = __shfl_sync(kFull, m[r], r < kHalf ? src_lo : src_hi, kLanes);"
    decide = "      word = __fmaf_rn(positive(__fmul_rn(__fsub_rn(v, u), sg)), wt[t], word);"
    loads = "  for (int x = 0; x < 8; ++x) q[x] = b[base ^ x];"
    unroll = "#pragma unroll 2\n  for (int t = "
    trace = "  if (!live || j != 0) return;"
    return {
        "kernel": src,
        "lanes4": replace_in(src, [(lanes, lanes.replace("8", "4"))]),
        "xor_rounds": replace_in(src, [(max7, rounds)]),
        "redux": replace_in(src, [(max7, redux)]),
        "batch1": replace_in(src, [("constexpr int kBatch = 8;", "constexpr int kBatch = 1;")]),
        "unroll1": replace_in(src, [(unroll, unroll.replace("unroll 2", "unroll 1"))]),
        "no_traceback": replace_in(src, [(trace, "  if (live || j != 0) return;")]),
        "cut_fetch": replace_in(src, [(fetch, "    rcv[r] = m[r];")]),
        "cut_max": replace_in(src, [(max7, "  const float mx = tree[0];\n")]),
        "int_decisions": replace_in(src, [
            ("  float word = 8388608.0f;  // 2^23", "  unsigned word = 0;"),
            ("    if constexpr (kDecide)\n" + decide,
             "    if constexpr (kDecide)\n"
             "      word |= (sg > 0 ? v > u : u > v) ? static_cast<unsigned>(wt[t]) : 0u;"),
            ("  return __float_as_uint(word);", "  return word;")]),
        "cut_decisions": replace_in(src, [(decide, "      word = word + t;")]),
        "cut_loads": replace_in(src, [(loads, "  for (int x = 0; x < 8; ++x) q[x] = 0.25f * (base ^ x);")]),
    }


def build_lib(path):
    """nvcc with the port's flags into a library beside `path`; loads it
    with the argument types of the entry points this script calls."""
    nvcc = shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                                "bin", "nvcc")
    so = path.with_suffix(".so")
    res = subprocess.run([nvcc, *tdc.NVCC_FLAGS, "-o", str(so), str(path)], capture_output=True,
                         text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {path}:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(so))
    for name, types in (("viterbi_launch", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                         + [ctypes.c_void_p]),
                        ("viterbi_fits", [ctypes.c_int] * 2),
                        ("viterbi_blocks_per_sm", [ctypes.c_int] * 2)):
        getattr(lib, name).argtypes, getattr(lib, name).restype = types, ctypes.c_int
    regs = [line.strip() for line in (res.stdout + res.stderr).splitlines()
            if "registers" in line or "spill" in line]
    return lib, regs


def inputs(rows, k, dev, seed):
    """(rows, K, 8) branch metrics of threshold LLRs (BPSK of coded random
    bits at noise sigma 1.4, rounded to quarters), row 0 all zero."""
    rng = np.random.default_rng(seed)
    bits = torch.from_numpy(rng.integers(0, 2, (rows, k), dtype=np.int8)).to(dev)
    x = 1.0 - 2.0 * convcoder.conv_encode(bits).float()
    x = torch.round(4 * (x + torch.from_numpy(rng.normal(0, 1.4, x.shape).astype(np.float32))
                         .to(dev))) / 4
    x[0] = 0.0
    return x.contiguous(), viterbi.branch_metrics(x).contiguous()


def launcher(lib, bm):
    rows, k = bm.shape[:2]
    bits = torch.empty((rows, k), dtype=torch.int8, device=bm.device)
    scratch = None if lib.viterbi_fits(k, TB_ITER) else torch.empty(
        (rows, (TB_ITER - TB_ITER // 2) * k, 2), dtype=torch.int32, device=bm.device)
    stream = torch.cuda.current_stream(bm.device).cuda_stream

    def launch():
        err = lib.viterbi_launch(bm.data_ptr(), bits.data_ptr(),
                                 None if scratch is None else scratch.data_ptr(), rows, k,
                                 TB_ITER, stream)
        assert err == 0, f"cudaError_t {err}"
        return bits
    return launch


def per_launch_ms(launch, flush=None):
    launch()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if flush is None:
        start.record()
        for _ in range(N):
            launch()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / N
    total = 0.0
    for _ in range(N):
        flush.zero_()
        start.record()
        launch()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / N


def main():
    if not torch.cuda.is_available():
        print("torch_viterbi_compare: torch.cuda is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    texts = copies(viterbi_cuda.SOURCE.read_text())
    for i, other in enumerate(sys.argv[1:]):
        texts[f"other{i}"] = pathlib.Path(other).read_text()
    paths = {}
    for name, text in texts.items():
        d = ROOT / "build" / "viterbi_compare" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "viterbi.cu").write_text(text)
        paths[name] = d / "viterbi.cu"
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        built = dict(zip(paths, pool.map(build_lib, paths.values())))
    libs = {name: lib for name, (lib, _) in built.items()}
    others = [n for n in libs if n.startswith("other")]
    copies_ = [n for n in libs if n not in others and n != "kernel"]
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    shapes = ([(r, SWEEP_K) for r in SWEEP_ROWS] + [(1, k) for k in CALLER_KS if k != SWEEP_K]
              + list(OTHER_SHAPES))
    out = {"registers": {n: regs for n, (_, regs) in built.items()}, "shapes": []}
    for rows, k in shapes:
        x, bm = inputs(rows, k, dev, rows * 1000 + k)
        launches = {n: launcher(lib, bm) for n, lib in libs.items()}
        want = launches["kernel"]().clone()
        if rows <= PLAIN_ROWS:
            assert torch.equal(want, viterbi.viterbi_decode_ref(x, TB_ITER)), (rows, k)
        for n, launch in launches.items():
            if n not in CUT:
                assert torch.equal(launch(), want), f"{n} differs at {rows} x K={k}"
        order = others + copies_ + ["kernel", "kernel"] + copies_[::-1] + others[::-1]
        times = {n: [] for n in libs}
        for n in order:
            times[n].append(per_launch_ms(launches[n]))
        row = {"rows": rows, "K": k, "us": {n: [round(1e3 * t, 2) for t in ts]
                                            for n, ts in times.items()},
               "ns_per_step": {n: round(1e6 * min(ts) / (TB_ITER * k), 1)
                               for n, ts in times.items()},
               "blocks_per_sm": {n: lib.viterbi_blocks_per_sm(k, TB_ITER)
                                 for n, lib in libs.items()}}
        if (rows, k) == FLUSHED:
            flushed = {n: [] for n in others + ["kernel"]}
            for n in others + ["kernel", "kernel"] + others[::-1]:
                flushed[n].append(round(1e3 * per_launch_ms(launches[n], flush), 2))
            row["flushed_us"] = flushed
        out["shapes"].append(row)
        print(f"# {rows} x K={k}: {json.dumps(row['ns_per_step'])} ns per step", flush=True)
    print(json.dumps(out))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
