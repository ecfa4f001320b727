#!/usr/bin/env python3
"""Start-up check of the PyTorch port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises; the exit code is then non-zero):
  1. device: needs torch.cuda; prints the card's name and power limit;
  2. build: compiles the MAP kernel (srslte_emane_tpu_torch/csrc/turbo_map.cu)
     into build/ unless this source was built before;
  3. kernel vs plain: the CUDA MAP kernel against map_decode_ref on the card,
     at the two 20 MHz bench shapes (768 x K=5504, 384 x K=5568), f32 and
     bf16-storage modes;
  4. main path: the 20 MHz SISO 64QAM PDSCH link at batch 128 (tx_subframe,
     AWGN, rx_subframe with the kernel) must decode the payload bit-exactly
     with every CRC passing, through the kernel; then decode and encode
     throughput, median of 3 runs.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

ATOL, RTOL = 1e-3, 1e-4  # kernel vs plain, both modes (same rounding points)
BATCH = 128
N_RUNS = 3
ITERS = 10


def log(msg):
    print(f"# {msg}", flush=True)


def cuda_ms(fn, n):
    """Median milliseconds of n calls of fn, each bracketed by CUDA events."""
    import torch

    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def map_inputs(k, batch, dev):
    """Noisy LLRs of turbo-encoded random bits (the reference's
    tests/test_turbodecoder_pallas.py recipe), on the card."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import turbo

    rng = np.random.default_rng(k)
    bits = torch.from_numpy(rng.integers(0, 2, (batch, k), dtype=np.int8)).to(dev)
    d0, d1, d2 = (d.float() for d in turbo.turbo_encode(bits))
    noise = lambda shape: torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dev)
    ls = (1 - 2 * d0[:, :k]) * 4.0 + noise((batch, k))
    lp = (1 - 2 * d1[:, :k]) * 4.0 + noise((batch, k))
    tail_x = (1 - 2 * torch.stack([d0[:, k], d2[:, k], d1[:, k + 1]], -1)) * 4.0
    tail_z = (1 - 2 * torch.stack([d1[:, k], d0[:, k + 1], d2[:, k + 1]], -1)) * 4.0
    return ls.contiguous(), lp.contiguous(), tail_x.contiguous(), tail_z.contiguous()


def phase_kernel(dev):
    from srslte_emane_tpu_torch.ops.fec import turbodecoder, turbodecoder_cuda as tdc

    cases = []
    for k, batch in ((5504, 768), (5568, 384)):
        args = map_inputs(k, batch, dev)
        w = turbodecoder._pick_windows(k)
        for narrow in (False, True):
            got = tdc.map_decode_cuda(*args, w, narrow)
            ref = tdc.map_decode_ref(*args, w, narrow)
            err = (got - ref).abs()
            bound = ATOL + RTOL * ref.abs()
            strong = ref.abs() > 0.5
            assert bool(got.isfinite().all()), "kernel output not finite"
            assert bool((err <= bound).all()), \
                f"K={k} narrow={narrow}: max err {err.max().item()} exceeds atol/rtol"
            assert bool((got[strong].sign() == ref[strong].sign()).all()), \
                f"K={k} narrow={narrow}: sign differs where |LLR| > 0.5"
            # the kernel alone on prepared inputs, the whole wrapper, the plain version
            ls_t, lp_t = (tdc.time_major(a, w, narrow) for a in args[:2])
            beta_k = turbodecoder.beta_tail(*args[2:]).contiguous()
            ms = cuda_ms(lambda: tdc.launch(ls_t, lp_t, beta_k, w, k // w), 10)
            wrapper_ms = cuda_ms(lambda: tdc.map_decode_cuda(*args, w, narrow), 10)
            plain_ms = cuda_ms(lambda: tdc.map_decode_ref(*args, w, narrow), 3)
            case = dict(K=k, B=batch, W=w, narrow=narrow, max_abs_err=err.max().item(),
                        ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms)
            log(f"kernel vs plain {json.dumps(case)}")
            cases.append(case)
    return cases


def phase_main_path(dev):
    import torch

    from srslte_emane_tpu_torch.models import pdsch_link
    from srslte_emane_tpu_torch.ops import channel
    from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc
    from srslte_emane_tpu_torch.phch import grid

    cfg = pdsch_link.LinkConfig(cell=grid.CellConfig(n_prb=100, cell_id=1, cfi=1), qm=6,
                                code_rate=0.55, snr_db=20.0, sf_idx=1, llr_bits=16)
    segm = cfg.sch_cfg.segm
    assert (cfg.tbs, cfg.G, segm.C, segm.F) == (49472, 90000, 9, 16), (cfg.tbs, cfg.G, segm)
    payload = torch.from_numpy(
        np.random.default_rng(0).integers(0, 2, (BATCH, cfg.tbs), dtype=np.int8)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    tdc.launches = 0
    t0 = time.perf_counter()
    tx = pdsch_link.tx_subframe(payload, cfg)
    rx = channel.awgn(gen, tx, cfg.snr_db)
    out, ok, _, ch = pdsch_link.rx_subframe(rx, cfg, use_kernel=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    main_launches = tdc.launches
    assert tuple(tx.shape) == (BATCH, 30720, 2) and bool(tx.isfinite().all())
    assert bool(ok.all()), f"CRC failed on {int((~ok).sum())} of {BATCH} subframes"
    assert torch.equal(out, payload), "decoded payload differs"
    assert main_launches > 0, "the main path did not launch the MAP kernel"
    log(f"main path: {BATCH} subframes decoded bit-exact, all CRCs pass, "
        f"{main_launches} MAP kernel launches, first call {first_s:.2f} s "
        f"(host tables included), estimated SNR {ch.snr_db.mean().item():.2f} dB")

    # the card's TX waveform against the port on the CPU, small input
    tx_cpu = pdsch_link.tx_subframe(payload[:2].cpu(), cfg)
    rel = ((tx[:2].cpu() - tx_cpu).square().mean() / tx_cpu.square().mean()).sqrt().item()
    assert rel < 1e-5, f"card vs CPU TX waveform: relative RMS {rel}"
    log(f"card vs CPU tx_subframe relative RMS {rel:.3e}")

    def rate(fn, check=lambda out: True):
        fn()
        torch.cuda.synchronize()
        rates = []
        for _ in range(N_RUNS):
            t0 = time.perf_counter()
            for _ in range(ITERS):
                out = fn()
            torch.cuda.synchronize()
            rates.append(BATCH * ITERS / (time.perf_counter() - t0))
            assert check(out), "a timed run produced a wrong result"
        med = statistics.median(rates)
        return med, 100.0 * (max(rates) - min(rates)) / med, rates

    tdc.launches = 0
    dec, dec_spread, dec_rates = rate(
        lambda: pdsch_link.rx_subframe(rx, cfg, use_kernel=True)[1],
        check=lambda ok_: bool(ok_.all()))
    passes = tdc.launches / ((N_RUNS * ITERS + 1) * len({k for k in segm.cb_sizes}))
    enc, enc_spread, enc_rates = rate(lambda: pdsch_link.tx_subframe(payload, cfg))
    log(f"decode {dec:.1f} sf/s median of {N_RUNS} (spread {dec_spread:.2f}%: "
        f"{[round(r, 1) for r in dec_rates]}), {dec * cfg.tbs / 1e6:.1f} Mb/s payload, "
        f"MAP half-iterations per code-block size h = {passes:.2f} "
        f"(n_iter = (h+1)//2 = {(passes + 1) // 2:.0f} when all sizes take the same h); "
        f"encode {enc:.1f} sf/s (spread {enc_spread:.2f}%: "
        f"{[round(r, 1) for r in enc_rates]}); batch {BATCH}, tbs {cfg.tbs}")
    return main_launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc

    b = tdc.build()
    log(f"build: {b.seconds:.1f} s -> {b.path}")
    for line in b.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")

    cases = phase_kernel(dev)
    main_launches = phase_main_path(dev)
    bench = next(c for c in cases if c["K"] == 5504 and c["narrow"])
    print(json.dumps({"kernels": [{
        "name": "turbo_map",
        "route": "cuda",
        "source": "srslte_emane_tpu_torch/csrc/turbo_map.cu",
        "replaces": "srslte_emane_tpu/ops/fec/turbodecoder_pallas2.py:70",
        "launches": main_launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": bench["ms"],
        "plain_ms": bench["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
