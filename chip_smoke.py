#!/usr/bin/env python3
"""Start-up check of the PyTorch port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises; the exit code is then non-zero):
  1. device: needs torch.cuda; prints the card's name and power limit;
  2. build: compiles both MAP kernels (srslte_emane_tpu_torch/csrc/
     turbo_map.cu and turbo_map_v1.cu), one nvcc each, started together,
     into build/ unless these sources were built before;
  3. kernel vs plain: the CUDA MAP kernel against map_decode_ref on the card,
     bit for bit, at the downlink cell's shapes (768 x K=5504, 384 x
     K=5568), f32 and bf16-storage modes, and the uplink cell's (128 x
     K=5504, 512 x K=5568), bf16-storage mode; at each, the kernel's time
     warm and with L2 flushed between launches, its bound and share of it,
     the wrapper's time, its block and occupancy; and the downlink
     subframe's (phase 8) 128 x K=4480, f32;
  4. downlink path: the 20 MHz SISO 64QAM PDSCH link at batch 128
     (tx_subframe, AWGN, rx_subframe with the kernel) must decode the payload
     bit-exactly with every CRC passing, through the kernel; then decode and
     encode throughput, median of 3 runs;
  5. v1 kernel vs plain (map_decode_v1_ref), bit for bit unless
     SRSLTE_TPU_LOGMAP is set, at 768 x K=5504 (W=32, L=172), 768 x K=1040
     (W=16, L=65, an odd window) and the odd-window path's 128 x K=1056
     (W=32, L=33), each with the kernel's time warm and L2-flushed, its
     bound and share, the wrapper's time, its block and occupancy; then at
     a window shorter than the halo (64 x K=1056, W=96, L=11), long windows
     (64 x K=6144, W=4, L=1536, staged in several passes; 16 x K=6144, W=1,
     one column per block) and a batch that leaves the last block partly
     empty (5 x K=1040); then the odd-window path: turbo_decode with the
     window count patched to give L=33 must launch v1 once per MAP pass
     (and not the radix-2 kernel) and decode every code block; its time;
  6. uplink path: the 20 MHz PUSCH cell of scripts/bench_extra.py (100 PRB,
     16QAM rate 0.5, 14 dB, llr_bits=16) at batch 128 through
     models/ue_ul (build_subframe, AWGN, enb_receive with the kernel) must
     decode bit-exactly with every CRC passing; decode and encode
     throughput; then a full-width PUSCH + PUCCH 1a composite and the
     reference test's 25 PRB composites (PUSCH + PUCCH 1a + SRS; PUCCH 2);
  7. cascade: turbo_decode on 128 code blocks of K=5504, a quarter of them
     at low SNR, gives the same bits, CRC flags and n_iter with the
     compaction cascade on and off, on fewer MAP rows with it on;
  8. downlink subframe: netsim --waveform's plan at 100 PRB (cell_id 1,
     cfi 2, sf 1; four UEs, RNTIs 0x46-0x49, 24 PRBs each at 16QAM, TBS
     4,416 = one code block of K=4480; CCEs from pdcch.allocate_cces) at
     batch 128 and 20 dB through models/enb_dl.build_subframe and
     models/ue_dl.decode_subframe: CFI 2, every DCI and CRC, payloads
     bit-exact, through turbo_map in f32 mode and never v1; the first two
     rows against the same calls on the CPU; the time by stage of one
     decode (the Viterbi calls apart); decode and encode sf/s; an sf 0
     subframe at batch 16 with PSS/SSS, PBCH (SFN 8) and all 13 PHICH
     groups (MIB, port count, SFN offset, PHICH signs); and
     runtime/wavesim.WaveformDataPlane.send_tti for the four UEs with 128
     PDUs each (every PDU delivered), in PDUs/s;
  9. MIMO, MBSFN, CA and the UL planes: turbo_map against its plain version
     at the 2x2 TM3 cell's code blocks (768 x K=5440, 256 x K=5376, bf16)
     and MimoDataPlane's (256 x K=4864, 256 x K=4800, f32), with each
     shape's launches per decode; the TM3 cell of scripts/bench_extra.py
     (100 PRB, cell_id 7, 2 ports, cfi 1, sf 1, RNTI 0x46, 64QAM rate 0.5
     per codeword: TBS 43,176, 6 x K=5440 + 2 x K=5376; flat 2x2 channel
     N(0, 1) + 3.5 I at 30 dB, as drawn; llr_bits=16, batch 128) through
     pdsch.encode_tm / decode_tm, through turbo_map in bf16 mode: every
     codeword whose CRC passes is bit-exact, the decode equals the one with
     turbo_map's plain version in its place, bit for bit in every row (so a
     row that fails, fails there too), and the rows that fail are the
     worst-conditioned ones; the first two rows against the CPU, the decode
     by stage, decode and encode sf/s; TM2 (2 and 4 ports), TM4 (PMI 1),
     TM6 (PMI 0-3), TM7 and TM8 at 100 PRB, batch 8; CA with 2
     CCs of the 20 MHz PDSCH link at batch 128 (carrier-sf/s);
     MimoDataPlane.send (128 PDUs) and MbsfnPlane.send (128 PDUs to 4
     receivers) at 100 PRB, every PDU delivered, PDUs/s; UlControlPlane.step
     and UlSchPlane.step on netsim --waveform's UL plan at 100 PRB with four
     UEs (n_pucch 0-3; 24 PRB each), every ACK and wideband CQI right;
 10. sync, channel models, TDD, PRACH, NB-IoT and the scan, batch 128: the
     cell search sweep of scripts/bench_extra.py (cell 301, 6 PRB, sf 0 with
     PBCH, 5 dB, +1 kHz offset) under 5 CFO hypotheses in one
     cell_search(detect_cp=True), the -1 kHz rows right, captures/s; the MIB
     (decodes/s, the Viterbi's share); a stream through UeSync to CAMPING;
     CP detection on extended-CP captures; extended-CP PDSCH at 100 PRB
     (tests/test_extended_cp.py's chain, 16QAM, 20 dB) bit-exact, sf/s; an
     MBSFN subframe at n_fft 1536; the fading link of
     tests/test_fading_link.py at 100 PRB (EPA, EVA, 18 dB, MMSE): passing
     rows bit-exact and the decode equal to the plain MAP's, sf/s; a TDD
     frame (config 1, special subframe 7, 16QAM, UL 96 PRB, 20 dB) with
     every CRC, bit and ACK right, frames/s; two 100 PRB cells (PCI 3 and 6
     on their halves of the band) and two UEs at 25 dB, UE-subframes/s, and
     the co-channel collision and capture at batch 8; PRACH format 0 at
     30.72 Msps with random preambles and delays, preambles/s; NB-IoT
     NPSS/NSSS, NPBCH and NPDSCH (decodes/s, the Viterbi's share); the
     beacons of all 504 PCIs and a 64-cell network scan (cells/s); neighbour
     measurement over 32 PCIs at 100 PRB; the first two rows of the search,
     the TDD frame and PRACH against the CPU; then turbo_map against its
     plain version at every new shape of these paths, with its launches;
 11. the device-resident block engines: the SPS block of
     scripts/bench_waveform_tpu.py (100 PRB, cell_id 1, cfi 1, 8 UEs, DL 11
     PRB and UL 12 PRB at MCS 20, 30 dB, T=160, llr_bits=16) through
     runtime/waveblock.make_block_step on the card: every DL and UL CRC and
     ACK, payloads bit-exact; the first two TTIs against the CPU (the card's
     noise replayed); TTIs/s, CUDA-event time, a profile of one block
     (device time, kernel launches, busy share), DL/UL Mb/s, peak memory
     and a depth sweep at T = 20, 40, 80, 160; the same block in TM3 with 2
     ports (every codeword); the dynamic block of
     scripts/bench_waveblock_dyn.py (100 PRB, cfi 2, 8 feasible RNTIs, DL 11
     PRB MCS 25, UL 10 PRB MCS 20, 30 dB, R=20) through
     runtime/waveblock_dyn.make_dyn_block_step: every CRC and ACK, no DCI
     miss, the decoded RIVs followed, the TBs delivered in queue order; the
     first two rounds against the CPU; TTIs/s, its profile and the time by
     stage of a round (the Viterbi's share); then turbo_map against its
     plain version at the blocks' shapes, with its launches per block;
 12. the waveform-native network: apps/netsim.py:run_waveform_full's
     network (runtime/wavenet.WaveformNetwork at 100 PRB, cfi 3, 8 UEs,
     80 dB, seed 0, on the card by default) attaches in 10-TTI slabs (all
     8 REGISTERED, RRC CONNECTED, with an IP address; >= 8 PRACH
     detections), then carries netsim's 4 DL + 1 UL IP packets per UE over
     60 host-paced TTIs (every DL packet delivered, UL bytes grown):
     sf/s, CUDA-event time and turbo_map launches per TTI, the time by
     stage of a TTI with traffic and its profile (device time, launches,
     busy share); then SpsBlockRunner(T=160) and DynBlockRunner(R=20) on
     the attached network, one untimed and two timed blocks each (every
     CRC passes, every SPS ACK detected): TTIs/s and turbo_map launches
     per block; then turbo_map against its plain version at every shape
     the phase launched;
 13. slice 13c on phase 12's network: (a) with netsim's --fading epa (5 Hz)
     --dyn-delay 0.2,1.5,1.0 --hst 40, (b) in TDD (configuration 1, special
     subframe 4), (c) in 2x2 TM3 at 70 dB with singular-value ratio 1.0 for
     UEs 0-5 and 0.05 for UEs 6-7; each attaches (in TM3 the UEs whose
     antenna 0 decodes a noise-free MIB, since the PBCH rides port 0
     alone) and carries phase 12's packets (TM3: then 3 x 1,000 B more per
     UE, more than one TB) over 60 host-paced TTIs, every DL packet
     delivered, with sf/s, CUDA-event time, turbo_map launches per TTI, the
     time by stage and a profile; TDD: no UE transmission off a U
     subframe, a TB decoded in an S subframe; TM3: every camped UE probes
     its own rank (2, or 1 at ratio 0.05), the eNB gets RI reports, rank-2
     grants go out and both codewords decode; (d) the dynamic block of
     phase 11 (R=20) across 2 cells (make_bench_step(n_cells=2)) against 1:
     every CRC and ACK in every cell, cell-TTIs/s, kernel and turbo_map
     launches per block; then turbo_map against its plain version at every
     shape of the phase not checked before.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import collections
import concurrent.futures
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ATOL, RTOL = 1e-3, 1e-4  # kernel vs plain, both modes (same rounding points)
BATCH = 128
N_RUNS = 3
ITERS = 10
# H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM3 bytes/s, and f32
# add/max operations/s outside the tensor cores (67 TFLOP/s counts an FMA
# as two; the MAP kernels do no FMA)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12
FLUSH_BYTES = 64 << 20  # a write this large evicts the 50 MB L2


def log(msg):
    print(f"# {msg}", flush=True)


def cuda_ms(fn, n, flush=None):
    """Median milliseconds of n calls of fn, each bracketed by CUDA events.
    The stream first spins for about 10 ms on the card, so that the calls
    are all queued before the first one runs and the host's time between
    calls is not counted; with `flush`, each call follows a write of that
    tensor (L2 cold)."""
    import torch

    torch.cuda._sleep(20_000_000)  # cycles: ~10 ms at the H100's 1.98 GHz
    events = []
    for _ in range(n):
        if flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(n_bytes, n_ops):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def map_bound(k, batch, w, narrow):
    """turbo_map's bound for one half-iteration of `batch` code blocks: read
    ls, lp (B, K) f32 and beta_K (B, 8), write the LLRs (B, K) f32; per
    (code block, window) column 26 f32 add/max per halo or backward step
    (2 for the branch metrics, 8 x (2 adds + 1 max)), 57 per forward step
    (2 + 16 adds into alpha, 16 adds of beta, 2 x 7 max, 1 subtraction, 8
    max for alpha), 15 per normalisation (7 max + 8 subtractions) after
    each halo and, in narrow mode, after each backward pair."""
    L = k // w
    H = min(40, L)
    per_col = 2 * H * 26 + L * (26 + 57) + 2 * 15 + (L // 2) * 15 * narrow
    return bound(4 * batch * (3 * k + 8), batch * w * per_col)


def v1_bound(k, batch, w):
    """turbo_map_v1's bound, on what any implementation must do: read ls,
    lp (B, K) f32 and beta_K (B, 8), write the LLRs (B, K) f32 (turbo_map's
    bytes in f32); per (code block, window) column 2H halo steps of 41 f32
    add/max (2 for the branch metrics, a 24-operation step, its 15-operation
    normalisation) and L steps of 111: 2 for the branch metrics, beta and
    alpha steps 24 each, their normalisations 15 each, the posterior 31 (16
    adds of beta to the alpha step's own alpha + g sums, 14 max, 1
    subtraction; `map_bound` counts its forward step the same way)."""
    L = k // w
    H = min(40, L)
    return bound(4 * batch * (3 * k + 8), batch * w * (2 * H * 41 + L * 111))


def rate(fn, check=lambda out: True, per_call=BATCH, iters=ITERS):
    """Calls per second times per_call: one warm-up call, then the median of
    N_RUNS runs of `iters` calls (host clock, synchronised), with the spread
    (max - min) / median in percent and the rates themselves."""
    import torch

    fn()
    torch.cuda.synchronize()
    rates = []
    for _ in range(N_RUNS):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        torch.cuda.synchronize()
        rates.append(per_call * iters / (time.perf_counter() - t0))
        assert check(out), "a timed run produced a wrong result"
    med = statistics.median(rates)
    return med, 100.0 * (max(rates) - min(rates)) / med, rates


def fmt_rate(name, med, spread, rates, unit="sf/s"):
    return (f"{name} {med:.1f} {unit} median of {N_RUNS} (spread {spread:.2f}%: "
            f"{[round(r, 1) for r in rates]})")


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


def check_close(got, ref, what):
    """Kernel output against its plain version: finite, within atol/rtol,
    equal signs where |LLR| > 0.5.  Returns the max abs error."""
    err = (got - ref).abs()
    strong = ref.abs() > 0.5
    assert bool(got.isfinite().all()), f"{what}: kernel output not finite"
    assert bool((err <= ATOL + RTOL * ref.abs()).all()), \
        f"{what}: max err {err.max().item()} exceeds atol/rtol"
    assert bool((got[strong].sign() == ref[strong].sign()).all()), \
        f"{what}: sign differs where |LLR| > 0.5"
    return err.max().item()


# (K, rows, modes): the downlink cell's MAP shapes (6 and 3 code blocks of
# batch 128) in both modes, then the uplink cell's (1 and 4 code blocks of
# batch 128) in the narrow mode that llr_bits=16 selects, then the downlink
# subframe's (one code block of batch 128 per grant) in the f32 mode of
# ue_dl's llr_bits=32
MAP_SHAPES = ((5504, 768, (False, True)), (5568, 384, (False, True)),
              (5504, 128, (True,)), (5568, 512, (True,)), (4480, BATCH, (False,)))


def map_cases(shapes, dev):
    """turbo_map against map_decode_ref, bit for bit, at each (K, rows,
    modes) of `shapes`, with the kernel's time warm and L2-flushed, the
    wrapper's and the plain version's, its bound, share and occupancy."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import turbodecoder, turbodecoder_cuda as tdc

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    cases = []
    for k, batch, modes in shapes:
        args = map_inputs(k, batch, dev)
        w = turbodecoder._pick_windows(k)
        beta_k = turbodecoder.beta_tail(*args[2:]).contiguous()
        for narrow in modes:
            got = tdc.map_decode_cuda(*args, w, narrow)
            ref = tdc.map_decode_ref(*args, w, narrow)
            assert torch.equal(got, ref), f"K={k} B={batch} narrow={narrow}: not bit-exact"
            err = (got - ref).abs().max().item()
            # the kernel alone (warm, and L2 flushed), the whole wrapper, the plain version
            kernel = lambda: tdc.launch(args[0], args[1], beta_k, w, narrow)
            ms = cuda_ms(kernel, 20)
            flushed_ms = cuda_ms(kernel, 20, flush)
            wrapper_ms = cuda_ms(lambda: tdc.map_decode_cuda(*args, w, narrow), 20)
            plain_ms = cuda_ms(lambda: tdc.map_decode_ref(*args, w, narrow), 3)
            bound_ms, bound_by = map_bound(k, batch, w, narrow)
            cols, blocks = tdc.occupancy(k, w, narrow)
            case = dict(K=k, B=batch, W=w, narrow=narrow, max_abs_err=err, ms=ms,
                        flushed_ms=flushed_ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by, share=bound_ms / ms,
                        cols_per_block=cols, blocks_per_sm=blocks)
            log(f"kernel vs plain {json.dumps(case)}")
            cases.append(case)
    return cases


def phase_kernel(dev):
    return map_cases(MAP_SHAPES, dev)


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

    tdc.launches = 0
    dec, dec_spread, dec_rates = rate(
        lambda: pdsch_link.rx_subframe(rx, cfg, use_kernel=True)[1],
        check=lambda ok_: bool(ok_.all()))
    passes = tdc.launches / ((N_RUNS * ITERS + 1) * len({k for k in segm.cb_sizes}))
    enc, enc_spread, enc_rates = rate(lambda: pdsch_link.tx_subframe(payload, cfg))
    log(f"{fmt_rate('decode', dec, dec_spread, dec_rates)}, {dec * cfg.tbs / 1e6:.1f} Mb/s "
        f"payload, MAP half-iterations per code-block size h = {passes:.2f} "
        f"(n_iter = (h+1)//2 = {(passes + 1) // 2:.0f} when all sizes take the same h); "
        f"{fmt_rate('encode', enc, enc_spread, enc_rates)}; batch {BATCH}, tbs {cfg.tbs}")
    return main_launches


def random_llrs(k, batch, dev, seed):
    """LLRs of random code bits, any K (the MAP does not interleave, so K
    need not be a turbo code-block size), on the card."""
    import torch

    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (2, batch, k))
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev).contiguous()
    return (f((1 - 2.0 * bits[0]) * 4 + rng.normal(0, 1, (batch, k))),
            f((1 - 2.0 * bits[1]) * 4 + rng.normal(0, 1, (batch, k))),
            f(rng.normal(0, 4, (batch, 3))), f(rng.normal(0, 4, (batch, 3))))


def code_block_llrs(k, batch, dev, seed, scale):
    """(bits (B, K), d0, d1, d2): CRC24B-terminated code blocks through the
    turbo encoder, as LLRs (1 - 2d) * scale + unit noise; scale may be (B, 1)."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import crc, turbo

    rng = np.random.default_rng(seed)
    payload = torch.from_numpy(rng.integers(0, 2, (batch, k - 24), dtype=np.int8)).to(dev)
    bits = crc.crc_attach(payload, crc.LTE_CRC24B)
    noise = lambda d: torch.from_numpy(rng.normal(0, 1, tuple(d.shape)).astype(np.float32)).to(dev)
    return (bits, *((1 - 2.0 * d.float()) * scale + noise(d) for d in turbo.turbo_encode(bits)))


# (K, rows, W) of phase 5.  Timed with bound and share: the downlink bench
# shape (L=172), an odd window (L=65), the odd-window path's own shape (L=33,
# halo H=33).  Then a window shorter than the halo, of odd length (L=11: the
# halo is the whole neighbouring window), a long window staged in several
# passes (L=1536), one so long that a block takes one column (L=6144), and a
# batch whose 80 columns leave the last block partly empty.
V1_SHAPES = ((5504, 768, 32), (1040, 768, 16), (1056, BATCH, 32))
V1_EDGE_SHAPES = ((1056, 64, 96), (6144, 64, 4), (6144, 16, 1), (1040, 5, 16))
ODD_K, ODD_W = 1056, 32  # the odd-window path: L = 1056 / 32 = 33


@contextlib.contextmanager
def window_count(n):
    """The decoder's window count set to n for every code-block size (no
    size gives an odd window length by itself)."""
    from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc

    pick = tdc._pick_windows
    tdc._pick_windows = lambda _: n
    try:
        yield
    finally:
        tdc._pick_windows = pick


def odd_window_decode(dev):
    """(decode, bits): turbo_decode of BATCH code blocks of K=ODD_K through
    the kernels, to be called under window_count(ODD_W)."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import crc, turbodecoder

    bits, d0, d1, d2 = code_block_llrs(ODD_K, BATCH, dev, 1, 1.5)
    valid = torch.ones(BATCH, dtype=torch.bool, device=dev)
    return (lambda: turbodecoder.turbo_decode(d0, d1, d2, valid, ODD_K, 8, crc.LTE_CRC24B,
                                              use_kernel=True, llr_bits=16)), bits


def host_ms(fn, n):
    """Median milliseconds of n synchronised calls of fn on the host clock."""
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def phase_v1(dev):
    """The v1 kernel against its plain version, then the odd-window path
    through the decoder.  Returns (cases, launches of the path)."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import turbodecoder, turbodecoder_cuda as tdc

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    cases = []
    for k, batch, w in V1_SHAPES + V1_EDGE_SHAPES:
        edge = (k, batch, w) in V1_EDGE_SHAPES
        args = random_llrs(k, batch, dev, k + w)
        what = f"v1 K={k} B={batch} W={w}"
        got = tdc.map_decode_v1_cuda(*args, w)
        ref = tdc.map_decode_v1_ref(*args, w)
        if tdc.LOGMAP:  # the card's log and exp round differently from torch's
            err = check_close(got, ref, what)
        else:
            assert torch.equal(got, ref), f"{what}: not bit-exact"
            err = (got - ref).abs().max().item()
        cols, blocks = tdc.occupancy_v1(k, w)
        if (k, batch) == (1040, 5):
            assert (batch * w) % cols, f"{what}: the last block is full"
        assert (cols == 1) == ((k, w) == (6144, 1)), f"{what}: {cols} columns per block"
        # the kernel alone (warm, and L2 flushed), the whole wrapper, the plain version
        beta_k = turbodecoder.beta_tail(*args[2:]).contiguous()
        kernel = lambda: tdc.launch_v1(args[0], args[1], beta_k, w)
        ms = cuda_ms(kernel, 20)
        flushed_ms = cuda_ms(kernel, 20, flush)
        wrapper_ms = cuda_ms(lambda: tdc.map_decode_v1_cuda(*args, w), 20)
        plain_ms = cuda_ms(lambda: tdc.map_decode_v1_ref(*args, w), 1 if edge else 3)
        bound_ms, bound_by = v1_bound(k, batch, w)
        case = dict(K=k, B=batch, W=w, L=k // w, max_abs_err=err, ms=ms, flushed_ms=flushed_ms,
                    wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, share=bound_ms / ms, cols_per_block=cols,
                    blocks_per_sm=blocks)
        log(f"v1 kernel vs plain {json.dumps(case)}")
        cases.append(case)

    # the odd-window path: the decoder's entry point with a window count
    # that gives L = 1056 / 32 = 33
    decode, bits = odd_window_decode(dev)
    with window_count(ODD_W):
        turbodecoder.map_rows = tdc.launches = tdc.launches_v1 = 0
        out, ok, n_iter = decode()
        torch.cuda.synchronize()
        launches, passes = tdc.launches_v1, turbodecoder.map_rows / BATCH
        assert launches > 0 and tdc.launches == 0, \
            f"odd window: {launches} v1 and {tdc.launches} radix-2 launches"
        decode_ms = host_ms(decode, 5)
    assert bool(ok.all()) and torch.equal(out, bits), "odd-window decode failed"
    log(f"odd-window path: {BATCH} code blocks of K={ODD_K} at L={ODD_K // ODD_W} decoded "
        f"through v1, {launches} v1 launches in {passes:.2f} batch-wide MAP passes, n_iter "
        f"{n_iter}, {decode_ms:.3f} ms per decode (median of 5 calls, host clock)")
    return cases, launches


def ul_bench_config():
    """The 20 MHz PUSCH cell of scripts/bench_extra.py:84-101."""
    from srslte_emane_tpu_torch.models import ue_ul
    from srslte_emane_tpu_torch.phch import grid

    l_prb, qm = 96, 4
    G = 12 * l_prb * 12 * qm
    tbs = (int(G * 0.5) - 24) // 8 * 8
    return ue_ul.UlSubframeConfig(cell=grid.CellConfig(n_prb=100, cell_id=1), sf_idx=2,
                                  rnti=0x5A, rb_start=0, l_prb=l_prb, qm=qm, tbs=tbs)


def phase_uplink(dev):
    """The uplink path and its composites.  Returns the MAP kernel launches
    of the PUSCH cell's first decode."""
    import dataclasses

    import torch

    from srslte_emane_tpu_torch.models import ue_ul
    from srslte_emane_tpu_torch.ops import channel
    from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc
    from srslte_emane_tpu_torch.phch import grid

    cfg = ul_bench_config()
    segm = cfg.sch_cfg.segm
    assert (cfg.tbs, cfg.sch_cfg.G, segm.C, segm.F) == (27624, 55296, 5, 8), (cfg.tbs, segm)
    payload = torch.from_numpy(
        np.random.default_rng(2).integers(0, 2, (BATCH, cfg.tbs), dtype=np.int8)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    snr_db, llr_bits = 14.0, 16

    tdc.launches = 0
    t0 = time.perf_counter()
    tx = ue_ul.build_subframe(cfg, tb_bits=payload)
    rx = channel.awgn(gen, tx, snr_db)
    out = ue_ul.enb_receive(rx, cfg, use_kernel=True, llr_bits=llr_bits)
    got, ok = out["pusch"]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = tdc.launches
    assert tuple(tx.shape) == (BATCH, 30720, 2) and bool(tx.isfinite().all())
    assert bool(ok.all()), f"UL CRC failed on {int((~ok).sum())} of {BATCH} subframes"
    assert torch.equal(got, payload), "decoded UL payload differs"
    assert launches > 0, "the uplink path did not launch the MAP kernel"
    log(f"uplink path: {BATCH} subframes of {cfg.tbs} bits ({segm.C} code blocks: "
        f"{segm.cb_sizes}) decoded bit-exact at {snr_db} dB, all CRCs pass, {launches} MAP "
        f"kernel launches, first call {first_s:.2f} s (host tables included)")

    tdc.launches = 0
    dec = rate(lambda: ue_ul.enb_receive(rx, cfg, use_kernel=True, llr_bits=llr_bits)["pusch"][1],
               check=lambda ok_: bool(ok_.all()))
    sizes = sorted(set(segm.cb_sizes))
    passes = tdc.launches / ((N_RUNS * ITERS + 1) * len(sizes))
    enc = rate(lambda: ue_ul.build_subframe(cfg, tb_bits=payload))
    log(f"UL {fmt_rate('decode', *dec)}, {dec[0] * cfg.tbs / 1e6:.1f} Mb/s payload, "
        f"MAP passes per code-block size {passes:.2f} (sizes {sizes}); "
        f"UL {fmt_rate('encode', *enc)}; batch {BATCH}, tbs {cfg.tbs}")

    # full width: PUSCH beside PUCCH 1a on the edge PRBs 0 / 99
    full = dataclasses.replace(cfg, rb_start=2, n_pucch_1=0)
    ack = torch.tensor([[1.0, 0.0], [-1.0, 0.0]], device=dev).repeat(BATCH // 2, 1)
    rx = channel.awgn(gen, ue_ul.build_subframe(full, tb_bits=payload, ack_bits=ack), snr_db)
    out = ue_ul.enb_receive(rx, full, use_kernel=True, llr_bits=llr_bits)
    got, ok = out["pusch"]
    corr = out["pucch_ack"]
    assert bool(ok.all()) and torch.equal(got, payload), "full-width composite: PUSCH failed"
    assert bool((corr[:, 0].sign() == ack[:, 0]).all()), "full-width composite: ACK/NACK sign"
    log(f"full-width composite (PUSCH PRB 2-97 + PUCCH 1a on PRB 0/99): payload exact, "
        f"ACK/NACK signs right, |corr| min {corr[:, 0].abs().min().item():.3f}")

    # tests/test_ue_ul_model.py's composites at batch BATCH
    cell = grid.CellConfig(n_prb=25, cell_id=3)
    l_prb, qm = 8, 4
    tbs = (12 * l_prb * 12 * qm // 2 - 24) // 8 * 8
    c1 = ue_ul.UlSubframeConfig(cell=cell, sf_idx=2, rnti=0x5A, rb_start=10, l_prb=l_prb,
                                qm=qm, tbs=tbs, n_pucch_1=3, srs_rb_start=4, srs_l_prb=4)
    tb = torch.from_numpy(
        np.random.default_rng(0).integers(0, 2, (BATCH, tbs), dtype=np.int8)).to(dev)
    rx = channel.awgn(gen, ue_ul.build_subframe(c1, tb_bits=tb, ack_bits=ack), 18.0)
    out = ue_ul.enb_receive(rx, c1, use_kernel=True)
    got, ok = out["pusch"]
    h, snr = out["srs_ce"]
    assert bool(ok.all()) and torch.equal(got, tb), "25 PRB composite: PUSCH failed"
    assert bool((out["pucch_ack"][:, 0] * ack[:, 0] > 0.3).all()), "25 PRB composite: ACK"
    assert bool(h.isfinite().all()) and bool(snr.isfinite().all()), "SRS estimate not finite"
    c2 = ue_ul.UlSubframeConfig(cell=cell, sf_idx=4, n_pucch_2=1)
    cqi = torch.from_numpy(
        np.random.default_rng(1).integers(0, 2, (BATCH, 6), dtype=np.int8)).to(dev)
    rx = channel.awgn(gen, ue_ul.build_subframe(c2, cqi_bits=cqi), 12.0)
    assert torch.equal(ue_ul.enb_receive(rx, c2, n_cqi_bits=6)["pucch_cqi"], cqi), \
        "25 PRB composite: PUCCH 2 CQI bits differ"
    log(f"25 PRB composites: PUSCH + PUCCH 1a + SRS (payload exact, ACK signs right, SRS "
        f"SNR {snr.mean().item():.1f} dB) and PUCCH 2 (CQI bits exact)")
    return launches


def phase_cascade(dev):
    """The compaction cascade changes the MAP work, not the results."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import crc, turbodecoder

    k = 5504
    scale = torch.where(torch.arange(BATCH, device=dev) % 4 == 0, 0.45, 1.0)[:, None]
    bits, d0, d1, d2 = code_block_llrs(k, BATCH, dev, 3, scale)
    valid = torch.ones(BATCH, dtype=torch.bool, device=dev)
    runs, rows, secs = {}, {}, {"1": [], "0": []}
    decode = lambda: turbodecoder.turbo_decode(d0, d1, d2, valid, k, 8, crc.LTE_CRC24B,
                                               use_kernel=True, llr_bits=16)
    saved = os.environ.get("SRSLTE_TPU_CASCADE")
    try:
        for cascade in ("1", "0", "0", "1", "1", "0", "0", "1"):  # first pair: check + warm-up
            os.environ["SRSLTE_TPU_CASCADE"] = cascade
            turbodecoder.map_rows = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = decode()
            torch.cuda.synchronize()
            if cascade not in runs:
                runs[cascade], rows[cascade] = out, turbodecoder.map_rows
            else:
                secs[cascade].append(time.perf_counter() - t0)
    finally:
        if saved is None:
            os.environ.pop("SRSLTE_TPU_CASCADE", None)
        else:
            os.environ["SRSLTE_TPU_CASCADE"] = saved
    (b1, ok1, it1), (b0, ok0, it0) = runs["1"], runs["0"]
    assert torch.equal(b1, b0) and torch.equal(ok1, ok0) and it1 == it0, \
        "cascade on and off disagree"
    assert rows["1"] < rows["0"], f"cascade processed {rows['1']} MAP rows, off {rows['0']}"
    n_ok = int(ok1.sum())
    assert n_ok >= 3 * BATCH // 4 and torch.equal(b1[ok1], bits[ok1]), "cascade batch decode"
    log(f"cascade: {BATCH} code blocks of K={k} (a quarter at low SNR): {n_ok} pass, n_iter "
        f"{it1}; MAP rows {rows['1']} with the cascade, {rows['0']} without; "
        f"{statistics.median(secs['1']) * 1e3:.2f} ms vs {statistics.median(secs['0']) * 1e3:.2f} "
        f"ms per decode (median of 3 calls each, alternating, host clock)")

DL_SF_RNTIS = (0x46, 0x47, 0x48, 0x49)
DL_SF_SNR_DB = 20.0


def dl_subframe_config(sf_idx, **kw):
    """netsim --waveform's plan (apps/netsim.py:399-416) at 100 PRB: four
    UEs of 100 // 4 - 1 = 24 PRBs each at 16QAM with WaveformDataPlane's
    TBS, CCEs from each UE's search space by pdcch.allocate_cces."""
    from srslte_emane_tpu_torch.models import enb_dl
    from srslte_emane_tpu_torch.phch import grid, pdcch
    from srslte_emane_tpu_torch.runtime import wavesim

    cell = grid.CellConfig(n_prb=100, cell_id=1, cfi=2)
    alloc = pdcch.allocate_cces(cell, DL_SF_RNTIS, sf_idx)
    assert set(alloc) == set(DL_SF_RNTIS), alloc
    per_ue = 100 // len(DL_SF_RNTIS) - 1
    grants = []
    for i, r in enumerate(DL_SF_RNTIS):
        mask = tuple(int(i * per_ue <= p < (i + 1) * per_ue) for p in range(100))
        grants.append((r, mask, 4, wavesim.UeSlot(r, mask).tbs(cell, sf_idx), *alloc[r]))
    return enb_dl.DlSubframeConfig(cell=cell, sf_idx=sf_idx, grants=tuple(grants), **kw)


@contextlib.contextmanager
def timed_calls(targets):
    """Each (module, function name) of `targets` wrapped so that its calls
    are bracketed by torch.cuda.synchronize() and their host time summed.
    Yields {"module.name": [calls, seconds]}; nested calls count in both."""
    import torch

    totals, saved = {}, []

    def wrap(fn, label):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            totals[label][0] += 1
            totals[label][1] += time.perf_counter() - t0
            return out
        return timed

    for mod, name in targets:
        label = f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"
        totals[label] = [0, 0.0]
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, wrap(getattr(mod, name), label))
    try:
        yield totals
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def launch_log():
    """Yields a list that gets (K, rows, narrow) of every turbo_map launch
    made inside the block."""
    from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc

    seen, launch = [], tdc.launch
    tdc.launch = lambda *a, **kw: seen.append((a[0].shape[1], a[0].shape[0], a[4])) or launch(*a, **kw)
    try:
        yield seen
    finally:
        tdc.launch = launch


def phase_dl_subframe(dev, card):
    """The full downlink subframe (phase 8).  Returns the turbo_map
    launches of its first decode."""
    import torch

    from srslte_emane_tpu_torch.models import enb_dl, ue_dl
    from srslte_emane_tpu_torch.ops import channel, ofdm
    from srslte_emane_tpu_torch.ops.fec import turbodecoder, turbodecoder_cuda as tdc, viterbi
    from srslte_emane_tpu_torch.phch import chest, pbch, pcfich, pdcch, pdsch, phich
    from srslte_emane_tpu_torch.runtime import wavesim

    cfg = dl_subframe_config(1)
    cell = cfg.cell
    for gi, g in enumerate(cfg.grants):
        assert g[3] == 4416 and cfg.sch_cfg(gi).segm.cb_sizes == [4480], (g, cfg.sch_cfg(gi).segm)
    rng = np.random.default_rng(8)
    payloads = [torch.from_numpy(rng.integers(0, 2, (BATCH, g[3]), dtype=np.int8)).to(dev)
                for g in cfg.grants]
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)

    def decoded_right(res, sent):
        return (bool((res.cfi == cell.cfi).all()) and bool(res.dci_found.all())
                and all(bool(ok.all()) for ok in res.crc_ok)
                and all(torch.equal(a, b) for a, b in zip(res.payloads, sent)))

    # the main path, counted: which kernel, how often, in which mode
    with launch_log() as sf_log:
        tdc.launches = tdc.launches_v1 = 0
        t0 = time.perf_counter()
        tx = enb_dl.build_subframe(cfg, payloads)
        rx = channel.awgn(gen, tx, DL_SF_SNR_DB)
        res, _ = ue_dl.decode_subframe(rx, cfg)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches, launches_v1 = tdc.launches, tdc.launches_v1
    assert tuple(tx.shape) == (BATCH, 30720, 2) and bool(tx.isfinite().all())
    assert decoded_right(res, payloads), "DL subframe: CFI, a DCI, a CRC or a payload wrong"
    assert launches > 0 and launches_v1 == 0, f"turbo_map {launches}, v1 {launches_v1} launches"
    assert not any(narrow for _, _, narrow in sf_log), "turbo_map ran in the narrow (bf16) mode"
    log(f"DL subframe: {BATCH} subframes x {len(cfg.grants)} grants (CCEs "
        f"{[g[4:] for g in cfg.grants]}) decoded: CFI 2, every DCI and CRC, payloads "
        f"bit-exact; {launches} turbo_map launches, all f32 mode, 0 v1; first call "
        f"{first_s:.2f} s (host tables included), estimated SNR {res.snr_db.mean().item():.2f} dB")

    # the card against the port on the CPU, first two rows
    tx_cpu = enb_dl.build_subframe(cfg, [p[:2].cpu() for p in payloads])
    rel = ((tx[:2].cpu() - tx_cpu).square().mean() / tx_cpu.square().mean()).sqrt().item()
    assert rel < 1e-5, f"DL subframe: card vs CPU TX relative RMS {rel}"
    res_cpu, _ = ue_dl.decode_subframe(rx[:2].cpu(), cfg)
    for got, ref in ((res.cfi, res_cpu.cfi), (res.dci_found, res_cpu.dci_found),
                     *zip(res.payloads, res_cpu.payloads), *zip(res.crc_ok, res_cpu.crc_ok)):
        assert torch.equal(got[:2].cpu(), ref), "DL subframe: card and CPU decode differ"
    log(f"DL subframe: card vs CPU on 2 rows: TX relative RMS {rel:.3e}, decode equal")

    # time by stage of one decode (synchronised at every stage: a breakdown,
    # not a rate)
    stages = ((ofdm, "demodulate"), (chest, "estimate"), (pcfich, "decode"),
              (pdcch, "blind_search"), (viterbi, "viterbi_decode"), (pdsch, "decode"),
              (turbodecoder, "turbo_decode"), (ue_dl, "decode_subframe"))
    with timed_calls(stages) as totals:
        ue_dl.decode_subframe(rx, cfg)
    whole = totals["ue_dl.decode_subframe"][1]
    log("DL subframe decode by stage (host clock, synchronised; nested stages count in "
        "their callers too): " + json.dumps({k: {"calls": n, "ms": 1e3 * t, "share": t / whole}
                                              for k, (n, t) in totals.items()}))

    dec = rate(lambda: ue_dl.decode_subframe(rx, cfg)[0],
               check=lambda r: decoded_right(r, payloads))
    enc = rate(lambda: enb_dl.build_subframe(cfg, payloads))
    log(f"DL subframe {fmt_rate('decode', *dec)}; {fmt_rate('encode', *enc)}; batch {BATCH}, "
        f"4 grants of TBS 4416; {card}")

    # sf 0: PSS/SSS, PBCH and every PHICH group beside the four grants
    n_groups = phich.n_groups(cell.n_prb)
    cfg0 = dl_subframe_config(0, with_pbch_sfn=8, phich_groups=n_groups)
    b0 = 16
    payloads0 = [torch.from_numpy(rng.integers(0, 2, (b0, g[3]), dtype=np.int8)).to(dev)
                 for g in cfg0.grants]
    mib = torch.from_numpy(np.tile(pbch.pack_mib(cell.n_prb, 8), (b0, 1))).to(dev)
    acks = torch.from_numpy(rng.choice([-1.0, 1.0], (b0, n_groups, 8)).astype(np.float32)).to(dev)
    rx0 = channel.awgn(gen, enb_dl.build_subframe(cfg0, payloads0, mib_bits=mib, acks=acks),
                       DL_SF_SNR_DB)
    res0, _ = ue_dl.decode_subframe(rx0, cfg0, with_phich=True)
    assert decoded_right(res0, payloads0), "sf 0: CFI, a DCI, a CRC or a payload wrong"
    assert torch.equal(res0.phich.sign(), acks), "sf 0: PHICH signs wrong"
    grid0 = ofdm.demodulate(rx0, cell.n_prb)
    ce0 = chest.estimate(grid0, cell, 0).ce
    with timed_calls(((pbch, "decode"), (viterbi, "viterbi_decode"))) as pbch_t:
        mib_out, ports, off, ok = pbch.decode(grid0, ce0, cell)
    assert bool(ok.all()) and torch.equal(mib_out, mib), "sf 0: MIB"
    assert bool((ports == 1).all()) and bool((off == 0).all()), "sf 0: port count or SFN offset"
    log(f"DL sf 0: {b0} subframes with PSS/SSS, PBCH (SFN 8), {n_groups} PHICH groups and 4 "
        f"grants: payloads, CRCs, PHICH signs right; MIB, 1 port, SFN offset 0 decoded; "
        f"pbch.decode {1e3 * pbch_t['pbch.decode'][1]:.2f} ms, of which Viterbi "
        f"{1e3 * pbch_t['viterbi.viterbi_decode'][1]:.2f} ms")

    # the waveform data plane: four UEs' bursts of 128 PDUs in shared subframes
    dp = wavesim.WaveformDataPlane(cell)
    assert dp.device.type == dev.type, dp.device  # the plane's default: the card
    for r, mask, qm, _, l_aggr, start in cfg.grants:
        dp.add_ue(r, mask, qm=qm, l_aggr=l_aggr, cce_start=start)
    nb = 4416 // 8 - 2
    pdus = {r: [bytes(rng.integers(0, 256, int(rng.integers(1, nb + 1)), dtype=np.uint8))
                for _ in range(BATCH)] for r in DL_SF_RNTIS}
    pathloss = {r: 112.0 + i for i, r in enumerate(DL_SF_RNTIS)}  # 22 to 19 dB
    n_pdus = BATCH * len(DL_SF_RNTIS)
    out = dp.send_tti(pdus, pathloss)
    assert all([got for got, _ in out[r]] == pdus[r] for r in DL_SF_RNTIS), "send_tti lost a PDU"
    runs = []
    for _ in range(N_RUNS):
        t0 = time.perf_counter()
        for _ in range(3):
            out = dp.send_tti(pdus, pathloss)
        runs.append(3 * n_pdus / (time.perf_counter() - t0))
        assert all([got for got, _ in out[r]] == pdus[r] for r in DL_SF_RNTIS), "send_tti"
    med = statistics.median(runs)
    log(f"WaveformDataPlane.send_tti: {len(DL_SF_RNTIS)} UEs x {BATCH} PDUs, every PDU "
        f"delivered; {med:.1f} PDUs/s median of {N_RUNS} runs of 3 calls (spread "
        f"{100 * (max(runs) - min(runs)) / med:.2f}%: {[round(r, 1) for r in runs]}); "
        f"metrics {dp.metrics}; {card}")
    return launches


# phase 9: the 2x2 TM3 cell's code blocks (6 x K=5440 and 2 x K=5376 per
# codeword, batch 128, llr_bits=16: bf16 mode, one decode per codeword) and
# MimoDataPlane's (2 x K=4864 and 2 x K=4800 per codeword, f32 mode; 128 PDUs
# are 64 subframes, whose two codewords share one decode)
MIMO_MAP_SHAPES = ((5440, 6 * BATCH, (True,)), (5376, 2 * BATCH, (True,)),
                   (4864, 4 * BATCH // 2, (False,)), (4800, 4 * BATCH // 2, (False,)))
TM3_RNTI, TM3_SNR_DB = 0x46, 30.0


def tm3_cell():
    """scripts/bench_extra.py:60-82: the 20 MHz 2x2 TM3 cell (100 PRB,
    cell_id 7, 2 ports, cfi 1, sf 1), full PRB mask, 64QAM at code rate 0.5
    per codeword.  Returns (cell, prb_mask, [SchConfig] * 2)."""
    from srslte_emane_tpu_torch.phch import grid, sch

    cell = grid.CellConfig(n_prb=100, cell_id=7, n_ports=2, cfi=1)
    mask = (1,) * 100
    n_re = grid.nof_re(cell, 1, mask)
    cfg = sch.SchConfig(tbs=(int(n_re * 6 * 0.5) - 24) // 8 * 8, G=n_re * 6, Qm=6, Nl=1)
    return cell, mask, [cfg, cfg]


def flat_channel(rng, batch, n_rx, n_tx, boost, dev):
    """(batch, n_rx, n_tx, 2) flat channel: complex N(0, 1) entries (real
    and imaginary parts each N(0, 1), as scripts/bench_extra.py draws them)
    plus boost on the diagonal."""
    from srslte_emane_tpu_torch.ops import cplx

    h = rng.normal(size=(batch, n_rx, n_tx)) + 1j * rng.normal(size=(batch, n_rx, n_tx))
    return cplx.from_numpy((h + boost * np.eye(n_rx, n_tx)[None]).astype(np.complex64), dev)


def phase_mimo(dev, card):
    """Phase 9: MIMO, MBSFN, CA and the UL planes.  Returns (the turbo_map
    cases at the new shapes, the launches of the TM3 cell's first decode)."""
    import torch

    from srslte_emane_tpu_torch.models import pdsch_link
    from srslte_emane_tpu_torch.ops import channel, cplx, mimo, modem, ofdm
    from srslte_emane_tpu_torch.ops.fec import turbodecoder, turbodecoder_cuda as tdc
    from srslte_emane_tpu_torch.phch import grid, pdsch, sch
    from srslte_emane_tpu_torch.runtime import wavesim

    cases = map_cases(MIMO_MAP_SHAPES, dev)

    # the TM3 cell, not cut
    cell, mask, cfgs = tm3_cell()
    segm = cfgs[0].segm
    assert (cfgs[0].tbs, segm.C, sorted(set(segm.cb_sizes))) == (43176, 8, [5376, 5440]), segm
    rng = np.random.default_rng(9)
    tbs = [torch.from_numpy(rng.integers(0, 2, (BATCH, c.tbs), dtype=np.int8)).to(dev)
           for c in cfgs]
    h = flat_channel(rng, BATCH, 2, 2, 3.5, dev)
    h_np = h.cpu().numpy()
    cond_db = 20 * np.log10(np.linalg.cond(h_np[..., 0] + 1j * h_np[..., 1]))
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    encode = lambda p: ofdm.modulate(pdsch.encode_tm(p, cfgs, cell, 1, TM3_RNTI, mask, "tm3"), 100)
    decode = lambda x: pdsch.decode_tm(ofdm.demodulate(x, 100), cfgs, cell, 1, TM3_RNTI, mask,
                                       "tm3", llr_bits=16)

    def passed_right(res):
        """Every codeword whose CRC passes is bit-exact."""
        outs, oks, _ = res
        return all(torch.equal(a[ok], b[ok]) for a, ok, b in zip(outs, oks, tbs))

    with launch_log() as tm3_log:
        tdc.launches = tdc.launches_v1 = 0
        t0 = time.perf_counter()
        tx = encode(tbs)
        rx = channel.mimo_flat(gen, tx, h, TM3_SNR_DB)
        res = decode(rx)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches, launches_v1 = tdc.launches, tdc.launches_v1
    assert tuple(tx.shape) == (BATCH, 2, 30720, 2) and bool(tx.isfinite().all())
    assert passed_right(res), "TM3 cell: a codeword passed its CRC with wrong bits"
    assert launches > 0 and launches_v1 == 0, f"turbo_map {launches}, v1 {launches_v1} launches"
    assert all(narrow for _, _, narrow in tm3_log), "TM3 cell: turbo_map ran in f32 mode"
    # a row that fails must fail alike with turbo_map's plain version in its
    # place (the whole decode is the same bits and flags), and be one of the
    # worst-conditioned channels of the batch
    t0 = time.perf_counter()
    map_cuda, tdc.map_decode_cuda = tdc.map_decode_cuda, tdc.map_decode_ref
    try:
        plain = decode(rx)
    finally:
        tdc.map_decode_cuda = map_cuda
    plain_s = time.perf_counter() - t0
    for got, ref in zip(res[0] + res[1], plain[0] + plain[1]):
        assert torch.equal(got, ref), "TM3 cell: the kernel and the plain MAP decode differ"
    row_ok = torch.stack(res[1]).all(0).cpu().numpy()
    failed = np.flatnonzero(~row_ok)
    worst = np.argsort(-cond_db)[:len(failed)]
    assert set(failed) == set(worst), f"TM3 cell: rows {failed} fail, worst conditioned {worst}"
    log(f"TM3 cell: {BATCH} subframes x 2 codewords of TBS {cfgs[0].tbs} ({segm.C} code "
        f"blocks: {segm.cb_sizes}) at {TM3_SNR_DB} dB: {int(row_ok.sum())} rows bit-exact with "
        f"both CRCs passing; rows failing {failed.tolist()} (channel condition "
        f"{[round(float(cond_db[i]), 1) for i in failed]} dB, the worst of the batch; next "
        f"{round(float(np.sort(cond_db)[-len(failed) - 1]), 1)} dB); every row's bits and CRC "
        f"flags equal the plain MAP's ({plain_s:.1f} s); {launches} turbo_map launches per "
        f"decode (all bf16, 0 v1), first call {first_s:.2f} s (host tables included)")

    # the card against the port on the CPU, first two rows
    tx_cpu = encode([t[:2].cpu() for t in tbs])
    rel = ((tx[:2].cpu() - tx_cpu).square().mean() / tx_cpu.square().mean()).sqrt().item()
    assert rel < 1e-5, f"TM3 cell: card vs CPU TX relative RMS {rel}"
    outs_cpu, oks_cpu, _ = decode(rx[:2].cpu())
    for got, ref in zip(res[0] + res[1], outs_cpu + oks_cpu):
        assert torch.equal(got[:2].cpu(), ref), "TM3 cell: card and CPU decode differ"
    log(f"TM3 cell: card vs CPU on 2 rows: TX relative RMS {rel:.3e}, bits equal")

    stages = ((ofdm, "demodulate"), (pdsch, "estimate_mimo"), (mimo, "decode_zf2"),
              (modem, "demod_soft"), (turbodecoder, "turbo_decode"), (pdsch, "decode_tm"))
    for _ in range(2):  # the second call is the one printed
        with timed_calls(stages) as totals:
            decode(rx)
    whole = totals["ofdm.demodulate"][1] + totals["pdsch.decode_tm"][1]
    log("TM3 cell decode by stage (second of two calls; host clock, synchronised; whole = "
        "ofdm.demodulate + pdsch.decode_tm; nested stages count in their callers too): "
        + json.dumps({k: {"calls": n, "ms": 1e3 * t, "share": t / whole}
                      for k, (n, t) in totals.items()}))
    dec = rate(lambda: decode(rx), check=lambda r: passed_right(r) and all(
        torch.equal(ok, ok0) for ok, ok0 in zip(r[1], res[1])))
    enc = rate(lambda: encode(tbs))
    log(f"TM3 cell {fmt_rate('decode', *dec)}, {dec[0] * 2 * cfgs[0].tbs / 1e6:.1f} Mb/s "
        f"payload; {fmt_rate('encode', *enc)}; batch {BATCH}, 2 x TBS {cfgs[0].tbs}; {card}")

    # the other transmission modes at 100 PRB, batch 8: 16QAM at code rate 0.4
    b8, rnti = 8, 0x47

    def qam16(n_re):
        return sch.SchConfig(tbs=(int(n_re * 4 * 0.4) - 24) // 8 * 8, G=n_re * 4, Qm=4, Nl=1)

    def payloads(cfgs_):
        return [torch.from_numpy(rng.integers(0, 2, (b8, c.tbs), dtype=np.int8)).to(dev)
                for c in cfgs_]

    def through(grids, n_tx, snr_db=TM3_SNR_DB):
        rx_ = channel.mimo_flat(gen, ofdm.modulate(grids, 100), flat_channel(rng, b8, 2, n_tx, 2.5,
                                                                              dev), snr_db)
        return ofdm.demodulate(rx_, 100)

    done = []
    for tm, n_ports, pmi in (("tm2", 2, 0), ("tm2", 4, 0), ("tm4", 2, 1),
                             *(("tm6", 2, p) for p in range(4))):
        c = grid.CellConfig(n_prb=100, cell_id=7, n_ports=n_ports, cfi=1)
        cw = [qam16(grid.nof_re(c, 1, mask))] * (2 if tm == "tm4" else 1)
        sent = payloads(cw)
        outs, oks, _ = pdsch.decode_tm(through(pdsch.encode_tm(sent, cw, c, 1, rnti, mask, tm, pmi),
                                               n_ports), cw, c, 1, rnti, mask, tm, pmi)
        assert all(bool(ok.all()) for ok in oks) and all(
            torch.equal(a, b) for a, b in zip(outs, sent)), f"{tm} ({n_ports} ports, PMI {pmi})"
        done.append(f"{tm.upper()} {n_ports}p PMI {pmi}")
    c = grid.CellConfig(n_prb=100, cell_id=9, n_ports=2, cfi=1)
    cw = qam16(len(grid.pdsch_re_indices_tm7(c, 3, mask)))
    sent = payloads([cw])[0]
    beam = cplx.from_numpy(np.array([0.8 + 0.3j, -0.4 + 0.6j], np.complex64), dev)
    g = pdsch.encode_tm7(sent, cw, c, 3, 0x52, mask, beam)
    out, ok, _, _ = pdsch.decode_tm7(through(g, 2), cw, c, 3, 0x52, mask)
    assert bool(ok.all()) and torch.equal(out, sent), "TM7"
    c = grid.CellConfig(n_prb=100, cell_id=4, n_ports=2, cfi=1)
    cw = [qam16(len(grid.pdsch_re_indices_tm8(c, 2, mask)))] * 2
    sent = payloads(cw)
    beams = cplx.from_numpy(np.array([[1.0, 0.5 + 0.5j], [0.5 - 0.5j, -1.0]], np.complex64)
                            / np.sqrt(1.5), dev)
    outs, oks, _ = pdsch.decode_tm8(through(pdsch.encode_tm8(sent, cw, c, 2, rnti, mask, beams), 2),
                                    cw, c, 2, rnti, mask)
    assert all(bool(ok.all()) for ok in oks) and all(
        torch.equal(a, b) for a, b in zip(outs, sent)), "TM8"
    log(f"other modes at 100 PRB, batch {b8}, 16QAM rate 0.4, {TM3_SNR_DB} dB: "
        f"{', '.join(done)}, TM7, TM8: payloads bit-exact, every CRC passes")

    # carrier aggregation: 2 CCs of the PDSCH link's 20 MHz cell
    # (scripts/bench_extra.py:103-116), end to end, batch 128 per carrier
    ca_cfg = pdsch_link.LinkConfig(cell=grid.CellConfig(n_prb=100, cell_id=1, cfi=1), qm=6,
                                   code_rate=0.55, snr_db=20.0, sf_idx=1)
    step = pdsch_link.make_ca_link_step(ca_cfg, n_cc=2)
    ca_payloads = torch.from_numpy(
        rng.integers(0, 2, (2, BATCH, ca_cfg.tbs), dtype=np.int8)).to(dev)
    out, ok = step(ca_payloads, gen)
    assert bool(ok.all()) and torch.equal(out, ca_payloads), "CA: a CRC or a payload wrong"
    ca = rate(lambda: step(ca_payloads, gen)[1], check=lambda ok_: bool(ok_.all()),
              per_call=2 * BATCH)
    log(f"CA 2 CCs (cell_id 1 and 4, 100 PRB, 64QAM rate 0.55, 20 dB, encode + channel + "
        f"decode): every CRC passes; {fmt_rate('CA', *ca, unit='carrier-sf/s')}, "
        f"{ca[0] * ca_cfg.tbs / 1e6:.1f} Mb/s aggregate; {card}")

    # MimoDataPlane: 128 PDUs = 64 TM3 subframes
    mp = wavesim.MimoDataPlane(grid.CellConfig(n_prb=100, cell_id=7, n_ports=2, cfi=1))
    assert mp.device.type == dev.type, mp.device
    mp.add_ue(TM3_RNTI, mask, qm=4)
    nb = mp._sch_cfgs(1, TM3_RNTI)[0].tbs // 8 - 2
    pdus = [bytes(rng.integers(0, 256, int(rng.integers(1, nb + 1)), dtype=np.uint8))
            for _ in range(BATCH)]
    with launch_log() as mp_log:
        assert mp.send(TM3_RNTI, pdus, pathloss_db=100.0) == pdus, "MimoDataPlane lost a PDU"
    mp_launches = len(mp_log)
    assert not any(narrow for _, _, narrow in mp_log), "MimoDataPlane: turbo_map in bf16 mode"
    r = rate(lambda: mp.send(TM3_RNTI, pdus, pathloss_db=100.0), lambda o: o == pdus, iters=1)
    log(f"MimoDataPlane.send: {BATCH} PDUs ({BATCH // 2} subframes, TBS {nb * 8 + 16} per codeword, "
        f"{mp_launches} turbo_map launches, f32) all delivered; {fmt_rate('send', *r, unit='PDUs/s')}; "
        f"metrics {mp.metrics}; {card}")

    # MbsfnPlane: 128 PDUs to 4 receivers
    bp = wavesim.MbsfnPlane(grid.CellConfig(n_prb=100, cell_id=1))
    nb = bp.cfg.tbs // 8 - 2
    pdus = [bytes(rng.integers(0, 256, int(rng.integers(1, nb + 1)), dtype=np.uint8))
            for _ in range(BATCH)]
    pathloss = {rx_id: 100.0 + 5 * rx_id for rx_id in range(4)}  # 34 to 19 dB
    want = {rx_id: pdus for rx_id in pathloss}
    assert bp.send(pdus, pathloss) == want, "MbsfnPlane lost a PDU"
    r = rate(lambda: bp.send(pdus, pathloss), lambda o: o == want, iters=1)
    log(f"MbsfnPlane.send: {BATCH} PDUs (TBS {bp.cfg.tbs}) to 4 receivers, all delivered; "
        f"{fmt_rate('send', *r, unit='PDUs/s')} ({4 * r[0]:.1f} deliveries/s); {card}")

    # netsim --waveform's UL plan at 100 PRB with four UEs
    ul_cell = grid.CellConfig(n_prb=100, cell_id=1, cfi=2)
    rntis = DL_SF_RNTIS
    pl = {r_: 100.0 + 2 * i for i, r_ in enumerate(rntis)}
    cp = wavesim.UlControlPlane(ul_cell)
    for i, r_ in enumerate(rntis):
        cp.add_ue(r_, i)
    acks = {r_: i % 2 for i, r_ in enumerate(rntis)}
    ok_acks = lambda o: all(o[r_][:2] == (True, acks[r_]) for r_ in rntis)
    assert ok_acks(cp.step(acks, pl)), "UlControlPlane: an ACK missed"
    r = rate(lambda: cp.step(acks, pl), ok_acks, per_call=len(rntis), iters=1)
    log(f"UlControlPlane.step: 4 UEs' PUCCH 1a (n_pucch 0-3) superposed, every ACK/NACK "
        f"detected; {fmt_rate('step', *r, unit='ACKs/s')}; {card}")
    up = wavesim.UlSchPlane(ul_cell)
    ul_prb = 100 // len(rntis) - 1
    for i, r_ in enumerate(rntis):
        up.add_ue(r_, min(i * ul_prb, 100 - ul_prb), ul_prb)
    wb = {r_: min(15, max(1, int(round((up.tx_power_dbm - pl[r_] - up.noise_floor_dbm) / 2 + 2))))
          for r_ in rntis}
    sent = {r_: (b"ul" * 6, wb[r_]) for r_ in rntis}
    ok_ul = lambda o: all(o[r_] == (b"ul" * 6, True, wb[r_]) for r_ in rntis)
    assert ok_ul(up.step(sent, pl)), "UlSchPlane: a PUSCH or a CQI wrong"
    r = rate(lambda: up.step(sent, pl), ok_ul, per_call=len(rntis), iters=1)
    log(f"UlSchPlane.step: 4 UEs' PUSCH ({ul_prb} PRB each) with aperiodic CQI, payloads and "
        f"wideband CQIs {sorted(wb.values())} exact; {fmt_rate('step', *r, unit='TBs/s')}; {card}")

    # the new shapes' kernel times beside the launches one decode makes at them
    for c in cases:
        per = [(rows, n) for (k, rows, _), n in
               collections.Counter(tm3_log + mp_log).items() if k == c["K"]]
        where = "TM3 cell decode" if c["narrow"] else "MimoDataPlane.send decode"
        log(f"turbo_map at {c['B']} x K={c['K']} {'bf16' if c['narrow'] else 'f32'}: "
            f"{1e3 * c['ms']:.1f} us (L2-flushed {1e3 * c['flushed_ms']:.1f} us), bound "
            f"{1e3 * c['bound_ms']:.2f} us ({c['bound_by']}), share {c['share']:.3f}; launches "
            f"per {where} at K={c['K']} by rows: {sorted(per, reverse=True)}; {card}")
    return cases, launches


# phase 10: sync and cell search, extended CP, fading, TDD, multi-cell,
# PRACH, NB-IoT, the beacon scan and neighbour measurement
SEARCH_CELL, SEARCH_SNR_DB, SEARCH_CFO_HZ = 301, 5.0, 1000.0
CFO_HYPOTHESES_HZ = (-2000.0, -1000.0, 0.0, 1000.0, 2000.0)


def noise_like(gen, x, snr_db):
    """Complex white noise for x at snr_db against each row's mean power."""
    import torch

    p = x.square().sum(-1).reshape(x.shape[0], -1).mean(-1)
    s = torch.sqrt(p / 10 ** (snr_db / 10) / 2).reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.randn(x.shape, generator=gen, device=x.device) * s


@contextlib.contextmanager
def replaying_awgn(record=None, replay=None):
    """channel.awgn recording the first two rows of each call's input and
    output into `record`, or answering each call with the next recorded
    output of `replay` (and checking its input against the recorded one),
    so that a run on the CPU sees the card's noise."""
    from srslte_emane_tpu_torch.ops import channel

    awgn, it = channel.awgn, iter(replay or ())

    def recording(gen, x, snr_db, signal_power=None):
        y = awgn(gen, x, snr_db, signal_power)
        record.append((x[:2].cpu(), y[:2].cpu()))
        return y

    def replaying(gen, x, snr_db, signal_power=None):
        x_card, y_card = next(it)
        rel = ((x - x_card).square().mean() / x_card.square().mean()).sqrt().item()
        assert rel < 1e-5, f"card vs CPU transmit samples: relative RMS {rel}"
        return y_card

    channel.awgn = recording if record is not None else replaying
    try:
        yield
    finally:
        channel.awgn = awgn


def by_stage(totals, whole):
    """timed_calls' totals as {stage: {calls, ms, share of `whole`}}."""
    w = totals[whole][1]
    return json.dumps({k: {"calls": n, "ms": round(1e3 * t, 3), "share": round(t / w, 3)}
                       for k, (n, t) in totals.items()})


def new_map_shapes(logs, known):
    """The (K, rows, modes) of every turbo_map launch in `logs` not already
    in `known` (the most rows per (K, mode))."""
    rows = {}
    for k, r, narrow in logs:
        rows[(k, narrow)] = max(rows.get((k, narrow), 0), r)
    seen = {(k, b, n) for k, b, modes in known for n in modes}
    return tuple((k, r, (n,)) for (k, n), r in sorted(rows.items()) if (k, r, n) not in seen)


def step_cell_search(dev, card):
    """Phase 10.1: the cell search sweep, the MIB, UeSync, CP detection."""
    import torch

    from srslte_emane_tpu_torch.models import ue_sync
    from srslte_emane_tpu_torch.ops import cplx, fading, ofdm
    from srslte_emane_tpu_torch.ops.fec import viterbi
    from srslte_emane_tpu_torch.phch import chest, grid, pbch, pdsch, sync

    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    cell = grid.CellConfig(n_prb=6, cell_id=SEARCH_CELL)
    sfn = 8
    g = sync.put_pss_sss(cplx.zeros((BATCH, 14, 72), device=dev), cell, 0)
    g = pdsch.put_crs(g, cell, 0)
    mib = torch.from_numpy(np.tile(pbch.pack_mib(6, sfn), (BATCH, 1))).to(dev)
    g = pbch.encode(mib, cell, sfn, g)
    srate = ofdm.params(6)["sf_len"] * 1e3
    tx = ofdm.modulate(g, 6)
    caps = fading.apply_cfo(tx + noise_like(gen, tx, SEARCH_SNR_DB), SEARCH_CFO_HZ, srate)
    hyp = torch.tensor(CFO_HYPOTHESES_HZ, device=dev)[:, None]

    def sweep(x):
        rows = fading.apply_cfo_dyn(x[:, None], hyp, srate)  # (B, 5, T, 2)
        return sync.cell_search(rows.reshape(-1, *x.shape[1:]), detect_cp=True)

    res = sweep(caps)
    h0 = CFO_HYPOTHESES_HZ.index(-SEARCH_CFO_HZ)
    ids = res["cell_id"].reshape(BATCH, -1)
    q = res["quality"].reshape(BATCH, -1)
    cancel_ok = lambda r: bool((r["cell_id"].reshape(BATCH, -1)[:, h0] == SEARCH_CELL).all()) \
        and not bool(r["cp_ext"].reshape(BATCH, -1)[:, h0].any())
    assert cancel_ok(res), "cell search: the -1 kHz hypothesis missed the cell or its CP"
    per_hyp = {f"{h:+.0f} Hz": dict(found=int((ids[:, i] == SEARCH_CELL).sum()),
                                     quality_median=float(q[:, i].median()))
               for i, h in enumerate(CFO_HYPOTHESES_HZ)}
    # the card against the CPU: the first two captures' five hypotheses
    res_cpu = sweep(caps[:2].cpu())
    for k, v in res_cpu.items():
        if k != "quality":
            assert torch.equal(res[k][:10].cpu(), v), f"cell search: card and CPU differ in {k}"
    rate_cs = rate(lambda: sweep(caps), check=cancel_ok)
    with timed_calls(((fading, "apply_cfo_dyn"), (sync, "pss_correlate"),
                      (sync, "_sss_hypothesis"), (sync, "cell_search"))) as t_cs:
        sweep(caps)
    log(f"cell search sweep: {BATCH} captures (6 PRB, cell {SEARCH_CELL}, sf 0, {SEARCH_SNR_DB} dB, "
        f"{SEARCH_CFO_HZ:+.0f} Hz offset) x {len(CFO_HYPOTHESES_HZ)} CFO hypotheses = "
        f"{BATCH * len(CFO_HYPOTHESES_HZ)} rows in one cell_search(detect_cp=True); the -1 kHz rows "
        f"all find cell {SEARCH_CELL}, normal CP; by hypothesis {json.dumps(per_hyp)}; card vs CPU "
        f"on 2 captures equal; {fmt_rate('sweep', *rate_cs, unit='captures/s')}; {card}")
    log("cell search sweep by stage (host clock, synchronised; whole = cell_search; "
        f"apply_cfo_dyn runs before it): {by_stage(t_cs, 'sync.cell_search')}")

    # the MIB of the found cell, from the corrected sf 0 captures
    found = grid.CellConfig(n_prb=6, cell_id=int(res["cell_id"][h0]))
    rx0 = ofdm.demodulate(fading.apply_cfo(caps, -SEARCH_CFO_HZ, srate), 6)
    ce0 = chest.estimate(rx0, found, 0).ce

    def mib_right(out):
        mib_out, ports, off, ok = out
        return bool(ok.all()) and torch.equal(mib_out, mib) and bool((ports == 1).all()) \
            and bool((off == 0).all())

    with timed_calls(((pbch, "decode"), (viterbi, "viterbi_decode"))) as t_mib:
        assert mib_right(pbch.decode(rx0, ce0, found)), "MIB: wrong bits, ports or SFN offset"
    share = t_mib["viterbi.viterbi_decode"][1] / t_mib["pbch.decode"][1]
    rate_mib = rate(lambda: pbch.decode(rx0, ce0, found), check=mib_right)
    log(f"MIB: {BATCH} PBCH decodes of cell {found.cell_id} (SFN {sfn}): bits, 1 port, offset 0 "
        f"right; {fmt_rate('pbch.decode', *rate_mib, unit='decodes/s')}; Viterbi share of a "
        f"decode {share:.3f} ({1e3 * t_mib['viterbi.viterbi_decode'][1]:.2f} of "
        f"{1e3 * t_mib['pbch.decode'][1]:.2f} ms); {card}")

    # one stream through UeSync on the card: CELL_SEARCH -> SFN_SYNC -> CAMPING
    rng = np.random.default_rng(10)
    sfn0, sfs = 32, []
    for i in range(25):
        sf_idx, f = i % 10, sfn0 + i // 10
        gs = sync.put_pss_sss(cplx.zeros((1, 14, 72), device=dev), cell, sf_idx)
        gs = pdsch.put_crs(gs, cell, sf_idx)
        if sf_idx == 0:
            gs = pbch.encode(torch.from_numpy(pbch.pack_mib(6, f)[None]).to(dev), cell, f, gs)
        sfs.append(ofdm.modulate(gs, 6)[0])
    t = torch.cat(sfs)
    t = cplx.to_numpy(t + noise_like(gen, t[None], 10.0)[0])
    x = np.concatenate([np.zeros(77, np.complex64),
                        t * np.exp(2j * np.pi * 150.0 * np.arange(len(t)) / srate)]).astype(np.complex64)
    us = ue_sync.UeSync(n_prb=6, device=dev)
    states = []
    for i in range(20):
        chunk = x[i * 1920 : (i + 2) * 1920]
        s = us.step(chunk if us.s.state == "CELL_SEARCH" else chunk[:1920 + 200])
        states.append(s.state)
        if s.state == "CAMPING":
            break
    assert (s.state, s.cell_id, s.sfn, s.n_ports) == ("CAMPING", SEARCH_CELL, sfn0 + i // 10, 1), vars(s)
    log(f"UeSync on the card: {' -> '.join(dict.fromkeys(['CELL_SEARCH'] + states))} in {len(states)} subframes, "
        f"cell {s.cell_id}, SFN {s.sfn}, {s.n_ports} port, CFO {s.cfo_hz:.1f} Hz (150 sent)")

    # CP detection on extended-CP captures of random cells
    ids_ext = rng.choice(504, BATCH, replace=False)
    rows = []
    for cid in ids_ext:
        c = grid.CellConfig(n_prb=6, cell_id=int(cid), cp="ext")
        rows.append(sync.put_pss_sss(cplx.zeros((1, 12, 72), device=dev), c, 0))
    tx_e = ofdm.modulate(torch.cat(rows), 6, cp="ext")
    res_e = sync.cell_search(tx_e + noise_like(gen, tx_e, 10.0), detect_cp=True)
    assert bool(res_e["cp_ext"].all()), "CP detection: an extended-CP capture read as normal"
    assert torch.equal(res_e["cell_id"].cpu(), torch.from_numpy(ids_ext).to(torch.int32))
    log(f"CP detection: {BATCH} extended-CP captures of random cells at 10 dB: every row "
        f"cp_ext and its cell id")


def step_ext_cp(dev, card):
    """Phase 10.2: extended-CP PDSCH at 100 PRB, and the reduced-rate OFDM.
    Returns the turbo_map launches of the first decode and their log."""
    import torch

    from srslte_emane_tpu_torch.ops import channel, cplx, dft, ofdm
    from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc
    from srslte_emane_tpu_torch.phch import grid, pdsch, sch

    cell = grid.CellConfig(n_prb=100, cell_id=2, cp="ext")
    mask, sf = (1,) * 100, 3
    n_re = grid.nof_re(cell, sf, mask)
    cfg = sch.SchConfig(tbs=(n_re * 4 // 2 - 24) // 8 * 8, G=n_re * 4, Qm=4, Nl=1)
    tb = torch.from_numpy(np.random.default_rng(11).integers(0, 2, (BATCH, cfg.tbs),
                                                             dtype=np.int8)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    decode = lambda r: pdsch.decode(ofdm.demodulate(r, 100, cp="ext"), cfg, cell, sf, 0x46, mask)
    right = lambda out: bool(out[1].all()) and torch.equal(out[0], tb)
    with launch_log() as seen:
        tdc.launches = 0
        tx = ofdm.modulate(pdsch.encode(tb, cfg, cell, sf, 0x46, mask), 100, cp="ext")
        rx = channel.awgn(gen, tx, 20.0)
        out = decode(rx)
        launches = tdc.launches
    assert right(out), "extended CP: a CRC failed or the bits differ"
    dec = rate(lambda: decode(rx), check=right)
    log(f"extended CP: {BATCH} subframes of 100 PRB (12 symbols), sf 3, 16QAM, TBS {cfg.tbs} "
        f"({cfg.segm.C} code blocks {sorted(set(cfg.segm.cb_sizes))}), 20 dB: every CRC passes, "
        f"bits exact; {launches} turbo_map launches; {fmt_rate('decode', *dec)}; {card}")

    # the 100 PRB MBSFN subframe at srsLTE's reduced rate (n_fft 1536)
    n = 1536
    ctrl_syms, guard, mb_syms = ofdm.mbsfn_layout(100, n)
    grid_in = torch.randn((BATCH, 12, 1200, 2), generator=gen, device=dev)
    bins = torch.from_numpy(ofdm._bin_map(100, n)).to(dev)
    x = grid_in.new_zeros((BATCH, 12, n, 2))
    x[..., bins, :] = grid_in
    sym = dft.idft(x)
    pieces = []
    for l, (_, cp) in enumerate(ctrl_syms + mb_syms):
        if l == len(ctrl_syms):
            pieces.append(sym.new_zeros((BATCH, guard, 2)))
        pieces += [sym[:, l, n - cp:], sym[:, l]]
    samples = torch.cat(pieces, dim=1)
    assert samples.shape[1] == ofdm.params(100, n)["sf_len"] == 23040
    ctrl, mb = ofdm.demodulate_mbsfn(samples, 100, n)
    err = (torch.cat([ctrl, mb], 1) - grid_in).abs().max().item()
    assert err < 1e-4, f"reduced-rate OFDM round trip: max error {err}"
    log(f"reduced-rate OFDM: {BATCH} MBSFN subframes at 100 PRB, n_fft {n} (23,040 samples): "
        f"demodulate_mbsfn returns the grid, max error {err:.2e}")
    return launches, seen


def step_fading(dev, card):
    """Phase 10.3: the fading link at 100 PRB.  Returns the launches of the
    first decode and the launch log."""
    import torch

    from srslte_emane_tpu_torch.models import pdsch_link
    from srslte_emane_tpu_torch.ops import channel, fading, ofdm
    from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc
    from srslte_emane_tpu_torch.phch import grid, pdsch

    cfg = pdsch_link.LinkConfig(cell=grid.CellConfig(n_prb=100, cell_id=2, cfi=1), qm=2,
                                code_rate=0.35, sf_idx=1)
    tb = torch.from_numpy(np.random.default_rng(12).integers(0, 2, (BATCH, cfg.tbs),
                                                             dtype=np.int8)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    srate = ofdm.params(100)["sf_len"] * 1e3
    decode = lambda r: pdsch.decode(ofdm.demodulate(r, 100), cfg.sch_cfg, cfg.cell, 1, cfg.rnti,
                                    cfg.prb_mask, equalizer="mmse")
    passed_right = lambda out: torch.equal(out[0][out[1]], tb[out[1]])
    total_launches, seen = 0, []
    for profile in ("epa", "eva"):
        with launch_log() as seen_p:
            tdc.launches = 0
            faded, _ = fading.apply_fading(pdsch_link.tx_subframe(tb, cfg), gen, profile, srate,
                                           doppler_hz=5.0)
            rx = channel.awgn(gen, faded, 18.0)
            out = decode(rx)
            total_launches += tdc.launches
        seen += seen_p
        assert passed_right(out), f"{profile}: a row passed its CRC with wrong bits"
        map_cuda, tdc.map_decode_cuda = tdc.map_decode_cuda, tdc.map_decode_ref
        try:
            plain = decode(rx)
        finally:
            tdc.map_decode_cuda = map_cuda
        assert torch.equal(out[0], plain[0]) and torch.equal(out[1], plain[1]), \
            f"{profile}: the kernel and the plain MAP decode differ"
        failing = torch.nonzero(~out[1]).flatten().tolist()
        dec = rate(lambda: decode(rx), check=lambda o: passed_right(o) and torch.equal(o[1], out[1]))
        log(f"fading link {profile.upper()} (100 PRB, QPSK rate 0.35, TBS {cfg.tbs}, "
            f"{cfg.sch_cfg.segm.C} code blocks {sorted(set(cfg.sch_cfg.segm.cb_sizes))}, 5 Hz, "
            f"18 dB, MMSE): {BATCH - len(failing)} rows bit-exact, failing rows {failing}; the "
            f"decode equals the plain MAP's bit for bit; {fmt_rate('decode', *dec)}; {card}")
    return total_launches, seen


def step_tdd(dev, card):
    """Phase 10.4: one TDD frame at 100 PRB.  Returns the launches of the
    first frame and the launch log."""
    import torch

    from srslte_emane_tpu_torch.models import tdd_frame
    from srslte_emane_tpu_torch.ops import channel, ofdm
    from srslte_emane_tpu_torch.ops.fec import turbodecoder, turbodecoder_cuda as tdc
    from srslte_emane_tpu_torch.phch import grid, pdsch, pusch, tdd

    cfg = tdd_frame.TddFrameConfig(cell=grid.CellConfig(n_prb=100, cell_id=4, cfi=1),
                                   sf_config=1, ss_config=7, qm=4, ul_l_prb=96)
    rng = np.random.default_rng(13)
    bits = lambda n: torch.from_numpy(rng.integers(0, 2, (BATCH, n), dtype=np.int8)).to(dev)
    dl = {sf: bits(cfg.dl_cfg(sf).tbs) for sf in tdd.dl_subframes(1)}
    ul = {sf: bits(cfg.ul_cfg().tbs) for sf in tdd.ul_subframes(1)}
    want_acks = {}
    for sf in dl:
        want_acks.setdefault(tdd.ack_subframe_for_dl(1, sf) % 10, []).append(sf)
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)

    def right(out):
        return all(bool(out[k][sf][1].all()) and torch.equal(out[k][sf][0], tbs[sf])
                   for k, tbs in (("dl", dl), ("ul", ul)) for sf in tbs) \
            and {a: [s for s, _ in v] for a, v in out["acks"].items()} == want_acks \
            and all(bool(ok.all()) for v in out["acks"].values() for _, ok in v)

    record = []
    with launch_log() as seen, replaying_awgn(record=record):
        tdc.launches = 0
        out = tdd_frame.run_frame(cfg, dl, ul, gen)
        launches = tdc.launches
    assert right(out), "TDD frame: a CRC, a payload or the ACK map is wrong"
    # the card against the CPU: the same frame's first two rows, with the
    # card's received samples replayed into the CPU run
    with replaying_awgn(replay=record):
        out_cpu = tdd_frame.run_frame(cfg, {k: v[:2].cpu() for k, v in dl.items()},
                                      {k: v[:2].cpu() for k, v in ul.items()}, torch.Generator())
    for k in ("dl", "ul"):
        for sf, (b, ok) in out[k].items():
            assert torch.equal(b[:2].cpu(), out_cpu[k][sf][0]) and torch.equal(
                ok[:2].cpu(), out_cpu[k][sf][1]), f"TDD frame: card and CPU differ at {k} sf {sf}"
    fr = rate(lambda: tdd_frame.run_frame(cfg, dl, ul, gen), check=right, iters=2)
    with timed_calls(((pdsch, "encode"), (pusch, "encode"), (ofdm, "modulate"), (channel, "awgn"),
                      (ofdm, "demodulate"), (pdsch, "decode"), (pusch, "decode"),
                      (turbodecoder, "turbo_decode"), (tdd_frame, "run_frame"))) as t_tdd:
        tdd_frame.run_frame(cfg, dl, ul, gen)
    sizes = {f"sf {sf} ({tdd.sf_type(1, sf)})": (cfg.dl_cfg(sf) if sf in dl else cfg.ul_cfg()).tbs
             for sf in sorted({**dl, **ul})}
    log(f"TDD frame (100 PRB, config 1 DSUUDDSUUD, special subframe 7 (DwPTS 10 symbols), "
        f"16QAM, UL 96 PRB, 20 dB, batch {BATCH}): TBS {json.dumps(sizes)}; every CRC passes, "
        f"bits exact, ACKs {want_acks}; card vs CPU on 2 rows equal; {launches} turbo_map "
        f"launches per frame; {fmt_rate('run_frame', *fr, unit='frames/s')}; {card}")
    log(f"TDD frame by stage (host clock, synchronised): {by_stage(t_tdd, 'tdd_frame.run_frame')}")
    return launches, seen


def multicell_cfg(pci, prb_lo, prb_hi, n_prb=100, rnti=0x50):
    """tests/test_multicell.py's _cell_cfg: cfi 2, sf 1, one QPSK grant at
    about rate 2/3 on PRBs [prb_lo, prb_hi), DCI at aggregation level 4."""
    from srslte_emane_tpu_torch.models import enb_dl
    from srslte_emane_tpu_torch.phch import grid, pdcch

    cell = grid.CellConfig(n_prb=n_prb, cell_id=pci, cfi=2)
    cand = next(c for c in pdcch.candidates(cell, rnti, 1) if c[0] == 4)
    mask = tuple(1 if prb_lo <= i < prb_hi else 0 for i in range(n_prb))
    tbs = (grid.nof_re(cell, 1, mask) * 2 // 3) // 8 * 8
    return enb_dl.DlSubframeConfig(cell=cell, sf_idx=1, grants=((rnti, mask, 2, tbs, *cand),))


def step_multicell(dev, card):
    """Phase 10.5: two 100 PRB cells, two UEs.  Returns the launches of the
    first step and the launch log."""
    import torch

    from srslte_emane_tpu_torch.models import enb_dl, multicell, ue_dl
    from srslte_emane_tpu_torch.ops.fec import turbodecoder, turbodecoder_cuda as tdc, viterbi
    from srslte_emane_tpu_torch.phch import pdcch, pdsch

    gains = lambda db: np.stack([10 ** (-np.asarray(db, np.float64) / 20.0),
                                 np.zeros(np.shape(db))], -1).astype(np.float32)
    rng = np.random.default_rng(14)
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    cells = (multicell_cfg(3, 0, 50), multicell_cfg(6, 50, 100))
    cfg = multicell.MulticellConfig(cells=cells, serving=(0, 1), grant_of=(0, 0), snr_db=25.0)
    pays = [[torch.from_numpy(rng.integers(0, 2, (BATCH, c.grants[0][3]), dtype=np.int8)).to(dev)]
            for c in cells]
    g = gains([[0.0, 6.0], [6.0, 0.0]])
    right = lambda res: all(bool(ok.all()) and torch.equal(b, p[0]) for (ok, b, _), p in zip(res, pays))
    with launch_log() as seen:
        tdc.launches = 0
        res = multicell.step(cfg, pays, g, gen)
        launches = tdc.launches
    assert right(res), "multi-cell: a UE failed to decode its serving cell"
    r = rate(lambda: multicell.step(cfg, pays, g, gen), check=right, per_call=2 * BATCH, iters=1)
    with timed_calls(((enb_dl, "build_subframe"), (ue_dl, "decode_subframe"),
                      (pdcch, "blind_search"), (viterbi, "viterbi_decode"), (pdsch, "decode"),
                      (turbodecoder, "turbo_decode"), (multicell, "step"))) as t_mc:
        multicell.step(cfg, pays, g, gen)
    log(f"multi-cell: PCI 3 (PRB 0-49) and PCI 6 (PRB 50-99) at 100 PRB, TBS "
        f"{cells[0].grants[0][3]} each, two UEs 6 dB nearer their own cell, 25 dB, batch "
        f"{BATCH}: both UEs bit-exact; {launches} turbo_map launches per step; "
        f"{fmt_rate('step', *r, unit='UE-subframes/s')}; {card}")
    log(f"multi-cell step by stage (host clock, synchronised): {by_stage(t_mc, 'multicell.step')}")

    # co-channel: the same PRBs in both cells, batch 8
    b8 = 8
    cells = (multicell_cfg(3, 0, 50), multicell_cfg(6, 0, 50))
    cfg = multicell.MulticellConfig(cells=cells, serving=(0,), grant_of=(0,), snr_db=30.0)
    pays = [[torch.from_numpy(rng.integers(0, 2, (b8, c.grants[0][3]), dtype=np.int8)).to(dev)]
            for c in cells]
    equal = multicell.step(cfg, pays, gains([[0.0, 0.0]]), gen)
    capture = multicell.step(cfg, pays, gains([[0.0, 20.0]]), gen)
    assert not bool(equal[0][0].any()), "co-channel at 0 dB C/I decoded"
    assert bool(capture[0][0].all()) and torch.equal(capture[0][1], pays[0][0]), "capture at 20 dB"
    log(f"multi-cell co-channel (PRB 0-49 in both cells, batch {b8}, 30 dB): 0 dB C/I fails in "
        f"every row, 20 dB C/I captures in every row")
    return launches, seen


def step_prach(dev, card):
    """Phase 10.6: PRACH format 0 at 20 MHz, batch 128."""
    import torch

    from srslte_emane_tpu_torch.phch import prach

    root, zczc, fmt, div = 6, 2, 0, 1
    n_seq, nzc = prach.N_SEQ // div, prach.nzc_for(fmt)
    rng = np.random.default_rng(15)
    idx = torch.from_numpy(rng.integers(0, 64, BATCH)).to(dev)
    # delays inside the zero-correlation zone (N_cs 15 ZC samples)
    delay = torch.from_numpy(rng.integers(0, 14 * n_seq // nzc, BATCH)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)

    def channel(t):
        """Per-row integer delay, then white noise at the per-bin SNR of
        test_prach.py::test_detect_noisy_with_delay (0.7 per component on
        bins of power 839): 0.7 sqrt(n_seq / N_ZC) per time sample."""
        n = torch.arange(t.shape[1], device=t.device)[None] - delay[:, None]
        x = torch.where((n >= 0)[..., None], t.gather(1, n.clamp(min=0)[..., None].expand(-1, -1, 2)), 0.0)
        return x + 0.7 * np.sqrt(n_seq / nzc) * torch.randn(x.shape, generator=gen, device=x.device)

    def chain(t_rx):
        det, metric, toff = prach.detect(prach.rx_waveform_to_freq(t_rx, fmt=fmt, srate_div=div),
                                         root, zczc, fmt=fmt)
        return det, toff

    def right(out):
        det, toff = out
        b = torch.arange(BATCH, device=dev)
        want = delay.double() * nzc / n_seq
        return bool(det[b, idx].all()) and bool(((toff[b, idx].double() - want).abs() < 1).all())

    tx = prach.gen_waveform(idx, root, zczc, fmt=fmt, srate_div=div)
    rx = channel(tx)
    out = chain(rx)
    assert right(out), "PRACH: a sent preamble missed, or its timing offset wrong"
    tx_cpu = prach.gen_waveform(idx[:2].cpu(), root, zczc, fmt=fmt, srate_div=div, device="cpu")
    rel = ((tx[:2].cpu() - tx_cpu).square().mean() / tx_cpu.square().mean()).sqrt().item()
    assert rel < 1e-5, f"PRACH: card vs CPU waveform relative RMS {rel}"
    out_cpu = chain(rx[:2].cpu())
    assert all(torch.equal(a[:2].cpu(), b) for a, b in zip(out, out_cpu)), "PRACH: card vs CPU"
    r = rate(lambda: chain(channel(prach.gen_waveform(idx, root, zczc, fmt=fmt, srate_div=div))),
             check=right)
    n_false = int(out[0].sum()) - BATCH
    log(f"PRACH format 0 (root {root}, zczc {zczc}, 30.72 Msps, {prach.waveform_len(fmt, div)} "
        f"samples), {BATCH} random preambles and delays 0-{14 * n_seq // nzc} samples: every sent "
        f"preamble detected within 1 ZC sample of its delay, {n_false} other detections; card vs "
        f"CPU on 2 rows equal (waveform relative RMS {rel:.1e}); gen_waveform + channel + "
        f"rx_waveform_to_freq + detect {fmt_rate('', *r, unit='preambles/s')}; {card}")


def step_nbiot(dev, card):
    """Phase 10.7: NB-IoT sync and channels at batch 128."""
    import torch

    from srslte_emane_tpu_torch.ops import channel, cplx
    from srslte_emane_tpu_torch.ops.fec import viterbi
    from srslte_emane_tpu_torch.phch import nbiot, sync_nbiot

    rng = np.random.default_rng(16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    # NPSS in the even rows only, 0.05 noise per component (test_nbiot.py)
    g = np.zeros((BATCH, 14, 12), np.complex64)
    g[::2, 3:, :11] = sync_nbiot.npss_grid()
    g += 0.05 * (rng.normal(size=g.shape) + 1j * rng.normal(size=g.shape))
    m = sync_nbiot.npss_detect(cplx.from_numpy(g, dev)).cpu().numpy()
    assert (m[::2] > 0.9).all() and (m[1::2] < 0.3).all(), "NPSS detection"
    nid, fp = rng.integers(0, 504, BATCH), rng.integers(0, 4, BATCH)
    s = np.stack([sync_nbiot.nsss_sequence(int(a), 2 * int(b)) for a, b in zip(nid, fp)])
    s = s + 0.2 * (rng.normal(size=s.shape) + 1j * rng.normal(size=s.shape))
    got_id, got_fp, _ = sync_nbiot.nsss_detect(cplx.from_numpy(s.astype(np.complex64), dev))
    assert (got_id.cpu().numpy() == nid).all() and (got_fp.cpu().numpy() == fp).all(), "NSSS"
    log(f"NB-IoT sync: NPSS metric > 0.9 in the {BATCH // 2} rows that carry it, < 0.3 in the "
        f"rest; NSSS: {BATCH} random (cell id, frame phase) pairs all found")

    mib = torch.from_numpy(rng.integers(0, 2, (BATCH, nbiot.MIB_NB_BITS), dtype=np.int8)).to(dev)
    rx_b = channel.awgn(gen, nbiot.npbch_encode(mib, 17), 6.0)
    tb = torch.from_numpy(rng.integers(0, 2, (BATCH, 208), dtype=np.int8)).to(dev)
    rx_d = channel.awgn(gen, nbiot.npdsch_encode(tb, 4, 5, 0x51), 12.0)
    cases = (("NPBCH", lambda: nbiot.npbch_decode(rx_b, 17), mib, (nbiot, "npbch_decode")),
             ("NPDSCH", lambda: nbiot.npdsch_decode(rx_d, 208, 5, 0x51), tb, (nbiot, "npdsch_decode")))
    for name, fn, sent, target in cases:
        right = lambda out, sent=sent: bool(out[1].all()) and torch.equal(out[0], sent)
        with timed_calls((target, (viterbi, "viterbi_decode"))) as tc:
            assert right(fn()), f"{name}: a CRC failed or the bits differ"
        share = tc["viterbi.viterbi_decode"][1] / tc[f"nbiot.{target[1]}"][1]
        r = rate(fn, check=right)
        log(f"{name} round trip ({'MIB-NB, 8 blocks, 6 dB' if name == 'NPBCH' else 'TBS 208 over 4 subframes, 12 dB'}"
            f", batch {BATCH}): every CRC passes, bits exact; {fmt_rate('decode', *r, unit='decodes/s')}"
            f"; Viterbi share of a decode {share:.3f}; {card}")


def step_scan(dev, card):
    """Phase 10.8-9: the beacon scan and neighbour measurement."""
    import torch

    from srslte_emane_tpu_torch.models import measure, netscan
    from srslte_emane_tpu_torch.ops import channel, cplx, ofdm
    from srslte_emane_tpu_torch.phch import grid, pdsch, sync

    ids = torch.arange(504, device=dev)
    beacons = netscan.build_beacons(ids)
    for cid in range(504):
        c = grid.CellConfig(n_prb=6, cell_id=cid)
        ref = pdsch.put_crs(sync.put_pss_sss(cplx.zeros((1, 14, 72), device=dev), c, 0), c, 0)
        assert torch.equal(beacons[cid], ref[0]), f"beacon of cell {cid}"
    rng = np.random.default_rng(17)
    n = 64
    scan_ids = torch.from_numpy(rng.choice(504, n, replace=False)).to(dev)
    gm = 0.05 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    gm[np.arange(n), (np.arange(n) + 1) % n] = 1.0  # one dominant neighbour per observer
    gm = gm.astype(np.complex64)
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    want = scan_ids[(torch.arange(n, device=dev) + 1) % n].to(torch.int32)
    scan = lambda: netscan.network_scan(None, scan_ids, gm, gen=gen, noise_std=0.02)
    right = lambda res: torch.equal(res["cell_id"], want)
    assert right(scan()), "network scan: an observer missed its dominant neighbour"
    r = rate(scan, check=right, per_call=n)
    log(f"beacon scan: build_beacons of all 504 PCIs equals the per-cell grids; network_scan "
        f"over {n} cells (one dominant neighbour each, others at 0.05, noise 0.02): every row "
        f"finds its neighbour; {fmt_rate('scan', *r, unit='cells/s')}; {card}")

    # neighbour measurement: a serving cell and two weaker neighbours
    serving, n1, n2 = 11, 303, 42
    g = cplx.zeros((BATCH, 14, 1200), device=dev)
    for pci, amp in ((serving, 1.0), (n1, 0.5), (n2, 0.3)):
        g = g + amp * pdsch.put_crs(cplx.zeros((BATCH, 14, 1200), device=dev),
                                    grid.CellConfig(n_prb=100, cell_id=pci), 1)
    tx = ofdm.modulate(g, 100)
    rg = ofdm.demodulate(channel.awgn(gen, tx, 10.0), 100)
    others = [int(p) for p in rng.choice([p for p in range(504) if p not in (serving, n1, n2)], 29,
                                         replace=False)]
    pcis = [n1, n2] + others[:14] + [serving] + others[14:]
    best, meas = measure.strongest_cell(rg, 100, 1, pcis)
    assert best == [serving] * BATCH, "measurement: the strongest cell is not the serving cell"
    r = rate(lambda: measure.strongest_cell(rg, 100, 1, pcis)[0], check=lambda b: b == [serving] * BATCH)
    rsrp = {p: float(meas[p][0].mean()) for p in (serving, n1, n2, others[0])}
    log(f"measurement: 100 PRB, {len(pcis)} candidate PCIs, batch {BATCH}, 10 dB: the serving "
        f"cell is strongest in every row; mean RSRP {json.dumps(rsrp)}; "
        f"{fmt_rate('strongest_cell', *r, unit='grids/s')}; {card}")


def phase_sync(dev, card):
    """Phase 10.  Returns (the turbo_map cases at its new shapes, the
    launches of its paths' first runs)."""
    t0 = time.perf_counter()
    step_cell_search(dev, card)
    paths = [step(dev, card) for step in (step_ext_cp, step_fading, step_tdd, step_multicell)]
    step_prach(dev, card)
    step_nbiot(dev, card)
    step_scan(dev, card)
    logs = [entry for _, seen in paths for entry in seen]
    cases = map_cases(new_map_shapes(logs, MAP_SHAPES + MIMO_MAP_SHAPES), dev)
    names = ("extended-CP decode", "fading decodes (EPA + EVA)", "TDD frame", "multi-cell step")
    for c in cases:
        per = {name: sum(1 for k, _, narrow in seen if k == c["K"] and narrow == c["narrow"])
               for name, (_, seen) in zip(names, paths)}
        log(f"turbo_map at {c['B']} x K={c['K']} {'bf16' if c['narrow'] else 'f32'}: "
            f"{1e3 * c['ms']:.1f} us (L2-flushed {1e3 * c['flushed_ms']:.1f} us), bound "
            f"{1e3 * c['bound_ms']:.2f} us ({c['bound_by']}), share {c['share']:.3f}, bit for bit; "
            f"launches at K={c['K']}: {json.dumps({k: v for k, v in per.items() if v})}; {card}")
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")
    return cases, sum(n for n, _ in paths)

# phase 11: the device-resident block engines.  The SPS block as
# scripts/bench_waveform_tpu.py configures it (100 PRB, 8 UEs, T=160) in
# SISO and TM3, the dynamic block as scripts/bench_waveblock_dyn.py does
# (100 PRB, 8 UEs, R=20)
SPS_T, SPS_DEPTHS, DYN_R = 160, (20, 40, 80, 160), 20


def sps_config(T, tm3=False):
    """scripts/bench_waveform_tpu.py:50-69: 100 PRB, cell_id 1, cfi 1, 8 UEs
    (RNTIs 70-77), DL segments packed around the centre PRBs at MCS 20, UL
    width (n_prb - 2) // 8 made a valid DFT size at MCS 20 from PRB 1,
    ack_res = nCCE + i, 30 dB, llr_bits=16; tm3 with 2 ports."""
    from srslte_emane_tpu_torch.phch import grid, pdcch, pusch
    from srslte_emane_tpu_torch.runtime import waveblock

    n_prb, n = 100, 8
    cell = grid.CellConfig(n_prb=n_prb, cell_id=1, cfi=1, n_ports=2 if tm3 else 1)
    n_cce = pdcch.n_cce(cell)
    c0, c1 = waveblock.centre_prbs(n_prb)
    dl_starts, dl_w = waveblock._pack_segments(n_prb, n, [(0, c0), (c1, n_prb)])
    ul_w = max(1, (n_prb - 2) // n)
    while ul_w > 1 and not pusch.valid_n_prb(ul_w):
        ul_w -= 1
    return waveblock.BlockConfig(
        cell=cell, rntis=tuple(70 + i for i in range(n)), dl_rb_start=dl_starts,
        dl_l_crbs=dl_w, dl_mcs=20, ul_rb_start=tuple(1 + ul_w * i for i in range(n)),
        ul_l_prb=ul_w, ul_mcs=20, ack_res=tuple(n_cce + i for i in range(n)),
        snr_db=(30.0,) * n, T=T, llr_bits=16, tm3=tm3)


def dyn_config(R):
    """scripts/bench_waveblock_dyn.py:48-60: 100 PRB, cell_id 1, cfi 2, 8
    UEs from feasible_rntis, DL 11 PRB at MCS 25, UL 10 PRB at MCS 20, 30 dB,
    llr_bits=16."""
    from srslte_emane_tpu_torch.phch import grid
    from srslte_emane_tpu_torch.runtime import waveblock_dyn

    cell = grid.CellConfig(n_prb=100, cell_id=1, cfi=2)
    return waveblock_dyn.DynBlockConfig(
        cell=cell, rntis=waveblock_dyn.feasible_rntis(cell, 8), dl_l_crbs=11, dl_mcs=25,
        ul_l_prb=10, ul_mcs=20, snr_db=(30.0,) * 8, R=R, llr_bits=16)


@contextlib.contextmanager
def recorded_noise(record=None, replay=None, rows=slice(None)):
    """waveblock._randn recording each draw into `record`, or answering each
    call with the next recorded draw of `replay` cut to `rows` along its
    first axis and moved to the caller's device."""
    from srslte_emane_tpu_torch.runtime import waveblock

    randn, it = waveblock._randn, iter(replay or ())

    def recording(gen, shape, device):
        x = randn(gen, shape, device)
        record.append(x)
        return x

    def replaying(gen, shape, device):
        x = next(it)[rows]
        assert tuple(x.shape) == tuple(shape), (tuple(x.shape), tuple(shape))
        return x.to(device)

    waveblock._randn = recording if record is not None else replaying
    try:
        yield
    finally:
        waveblock._randn = randn


def profile_block(fn):
    """One call of fn under torch.profiler (after a synchronise): the
    device time (the CUDA kernels' own time), the kernel launches, the busy
    share (device time over the profiled wall time, which includes the
    profiler's overhead: a lower bound) and turbo_map's device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    map_ms = sum(e.self_device_time_total for e in kernels if "map_kernel" in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return dict(profiled_wall_ms=round(wall_ms, 3), device_ms=round(device_ms, 3),
                busy_share=round(device_ms / wall_ms, 4),
                kernel_launches=sum(e.count for e in kernels), turbo_map_ms=round(map_ms, 3),
                top=[(e.key[:50], round(e.self_device_time_total / 1e3, 3), e.count)
                     for e in top])


def block_timing(fn, ttis):
    """The block's rate (TTIs/s, median of N_RUNS runs of one call each,
    after one warm-up call) and its CUDA-event time (median of 3 calls; the
    events bracket the whole call on the stream, host waits included)."""
    import torch

    r = rate(fn, per_call=ttis, iters=1)

    def one():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    return r, statistics.median(one() for _ in range(3))


def step_sps(dev, card, tm3):
    """Phase 11.1/11.2: the SPS block at T=160 (SISO, or TM3 with 2 ports).
    Returns (turbo_map launches of one block, launch log)."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc
    from srslte_emane_tpu_torch.runtime import waveblock

    name = "SPS block TM3" if tm3 else "SPS block"
    cfg = sps_config(SPS_T, tm3)
    n, T = cfg.n_ues, cfg.T
    n_cw = 2 if tm3 else 1
    rng = np.random.default_rng(0)
    dl_shape = (T, n) + ((2,) if tm3 else ()) + (cfg.dl_tbs,)
    dl = torch.from_numpy(rng.integers(0, 2, dl_shape, dtype=np.int8)).to(dev)
    ul = torch.from_numpy(rng.integers(0, 2, (T, n, cfg.ul_tbs), dtype=np.int8)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    step = waveblock.make_block_step(cfg, sfn0=4)  # the card: the entry point's default
    bench = waveblock.make_bench_step(cfg, sfn0=4)
    build_s = time.perf_counter() - t0

    def right(out):
        return (bool(out["dl_ok"].all()) and bool(out["ul_ok"].all())
                and (not tm3 or bool(out["dl_ok_cw"].all()))
                and int((out["ack_energy"] > 1e-2).sum()) == T * n
                and torch.equal(out["dl_out"], dl.reshape(T, n, -1))
                and torch.equal(out["ul_out"], ul))

    record = []
    torch.cuda.reset_peak_memory_stats()
    with launch_log() as seen, recorded_noise(record=record):
        tdc.launches = 0
        t0 = time.perf_counter()
        out = step(dl, ul, gen, 0)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = tdc.launches
    peak = torch.cuda.max_memory_allocated()
    assert all(v.device.type == "cuda" for v in out.values()), "a block output left the card"
    assert launches > 0, f"{name}: no turbo_map launch"
    assert right(out), (f"{name}: DL {int(out['dl_ok'].sum())}, UL {int(out['ul_ok'].sum())}, "
                        f"ACK {int((out['ack_energy'] > 1e-2).sum())} of {T * n}, or a payload")
    log(f"{name}: 100 PRB, 8 UEs, T={T}, DL {cfg.dl_l_crbs} PRB MCS 20 (TBS {cfg.dl_tbs} x "
        f"{n_cw}), UL {cfg.ul_l_prb} PRB MCS 20 (TBS {cfg.ul_tbs}), 30 dB: every DL and UL "
        f"CRC passes, {T * n} ACKs, payloads bit-exact; {launches} turbo_map launches "
        f"{sorted(set(seen))} (K, rows, bf16); first call {first_s:.2f} s, tables {build_s:.2f} s; "
        f"peak memory {peak / 2**20:.1f} MiB")

    # the card against the CPU (the plain MAP): the first two TTIs, with the
    # card's noise replayed into the CPU run
    cpu_step = waveblock.make_block_step(cfg._replace(T=2), sfn0=4, device="cpu")
    with recorded_noise(replay=record, rows=slice(0, 2)):
        out_cpu = cpu_step(dl[:2].cpu(), ul[:2].cpu(), torch.Generator(), 0)
    for k, v in out_cpu.items():
        if v.dtype.is_floating_point:
            torch.testing.assert_close(out[k][:2].cpu(), v, rtol=1e-4, atol=1e-5)
        else:
            assert torch.equal(out[k][:2].cpu(), v), f"{name}: card and CPU differ at {k}"
    log(f"{name}: card vs CPU on the first 2 TTIs: bits, CRCs equal, ACK values within 1e-4")

    counts = lambda: bench(dl, ul, gen, 0)
    (med, spread, rates), event_ms = block_timing(counts, T)
    assert [int(x) for x in counts()] == [T * n * n_cw, T * n, T * n]
    prof = profile_block(lambda: step(dl, ul, gen, 0))
    log(f"{name}: {fmt_rate('block', med, spread, rates, unit='TTIs/s')}; DL "
        f"{med * n * n_cw * cfg.dl_tbs / 1e6:.1f} Mb/s + UL {med * n * cfg.ul_tbs / 1e6:.1f} Mb/s; "
        f"CUDA-event time per block {event_ms:.2f} ms; profile of one block {json.dumps(prof)}; {card}")
    if not tm3:
        sweep = {}
        for depth in SPS_DEPTHS:
            c = sps_config(depth)
            b = waveblock.make_bench_step(c, sfn0=4)
            d, u = dl[:depth], ul[:depth]
            sweep[depth] = rate(lambda: b(d, u, gen, 0), per_call=depth, iters=1,
                                check=lambda o: int(o[0]) == depth * n)[0]
        log(f"{name} depth sweep (TTIs/s by T, median of {N_RUNS}): "
            f"{json.dumps({k: round(v, 1) for k, v in sweep.items()})}; {card}")
    return launches, seen


def step_dyn(dev, card):
    """Phase 11.3: the dynamic block at R=20.  Returns (turbo_map launches
    of one block, launch log)."""
    import torch

    from srslte_emane_tpu_torch.ops import ofdm
    from srslte_emane_tpu_torch.ops.fec import convcoder, turbodecoder, turbodecoder_cuda as tdc
    from srslte_emane_tpu_torch.ops.fec import viterbi
    from srslte_emane_tpu_torch.phch import sch
    from srslte_emane_tpu_torch.runtime import waveblock_dyn as wbd

    cfg = dyn_config(DYN_R)
    n, T = cfg.n_ues, cfg.T
    rng = np.random.default_rng(0)
    dl_q = torch.from_numpy(rng.integers(0, 2, (T, n, cfg.dl_tbs), dtype=np.int8)).to(dev)
    ul_q = torch.from_numpy(rng.integers(0, 2, (T, n, cfg.ul_tbs), dtype=np.int8)).to(dev)
    rb_dl, rb_ul = (torch.from_numpy(a).to(dev) for a in wbd.make_schedule(cfg, seed=3))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    step = wbd.make_dyn_block_step(cfg)  # the card: the entry point's default
    bench = wbd.make_bench_step(cfg)
    build_s = time.perf_counter() - t0
    args = (dl_q, ul_q, rb_dl, rb_ul)

    def right(o):
        if not (int(o["dl_ok"].sum()) == int(o["ul_ok"].sum()) == int(o["ack_det"].sum()) == T * n
                and int(o["dci_dl_miss"]) == int(o["dci_ul_miss"]) == 0
                and torch.equal(o["rb_ue"], rb_dl.long())):
            return False
        for new, outs, q in (("dl_new", "dl_out", dl_q), ("ul_new", "ul_out", ul_q)):
            for u in range(n):  # delivered TBs equal the queue, in order
                sent = o[outs][:, :, u][o[new][:, :, u]]
                if not torch.equal(sent, q[: sent.shape[0], u]) or sent.shape[0] != T:
                    return False
        return True

    record = []
    torch.cuda.reset_peak_memory_stats()
    with launch_log() as seen, recorded_noise(record=record):
        tdc.launches = 0
        t0 = time.perf_counter()
        out = step(*args, gen, 0)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = tdc.launches
    peak = torch.cuda.max_memory_allocated()
    assert all(v.device.type == "cuda" for v in out.values()), "a block output left the card"
    assert launches > 0, "dynamic block: no turbo_map launch"
    assert right(out), (
        f"dynamic block: DL {int(out['dl_ok'].sum())}, UL {int(out['ul_ok'].sum())}, ACK "
        f"{int(out['ack_det'].sum())} of {T * n}, DCI misses {int(out['dci_dl_miss'])} + "
        f"{int(out['dci_ul_miss'])}, RBs followed {bool(torch.equal(out['rb_ue'], rb_dl.long()))}")
    log(f"dynamic block: 100 PRB, 8 UEs (RNTIs {list(cfg.rntis)}), R={DYN_R} ({T} TTIs), DL 11 PRB "
        f"MCS 25 (TBS {cfg.dl_tbs}, 2 code blocks), UL 10 PRB MCS 20 (TBS {cfg.ul_tbs}), 30 dB: "
        f"every DL and UL CRC and ACK, no DCI miss, the UE followed every decoded RIV, the "
        f"delivered TBs equal the queues in order; {launches} turbo_map launches "
        f"{sorted(set(seen))} (K, rows, bf16); first call {first_s:.2f} s, tables {build_s:.2f} s; "
        f"peak memory {peak / 2**20:.1f} MiB")

    # the card against the CPU (the plain MAP): the first two rounds, with
    # the card's noise replayed into the CPU run
    with recorded_noise(replay=record):
        cpu_out = wbd.make_dyn_block_step(cfg._replace(R=2), device="cpu")(
            *(a.cpu() for a in (dl_q, ul_q, rb_dl[:2], rb_ul[:2])), torch.Generator(), 0)
    for k, v in cpu_out.items():
        if k in ("dl_consumed", "ul_consumed") or v.ndim == 0:
            continue  # block totals: the CPU ran 2 of the card's rounds
        assert torch.equal(out[k][:2].cpu(), v), f"dynamic block: card and CPU differ at {k}"
    log("dynamic block: card vs CPU on the first 2 rounds: every per-round output equal")

    counts = lambda: bench(*args, gen, 0)
    (med, spread, rates), event_ms = block_timing(counts, T)
    assert [int(x) for x in counts()] == [T * n, T * n, T * n, 0, 0, 0]
    stages = ((ofdm, "modulate"), (ofdm, "demodulate"), (convcoder, "rate_unmatch_cc"),
              (viterbi, "viterbi_decode"), (sch, "encode_tb"), (sch, "decode_tb"),
              (turbodecoder, "turbo_decode"), (wbd, "_scatter_rows"))
    whole = "waveblock_dyn.step"
    with timed_calls(stages) as totals:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*args, gen, 0)
        torch.cuda.synchronize()
        totals[whole] = [1, time.perf_counter() - t0]
    per_round = {k: {"calls_per_round": n_ / DYN_R, "ms_per_round": round(1e3 * t / DYN_R, 3),
                     "share": round(t / totals[whole][1], 3)} for k, (n_, t) in totals.items()}
    prof = profile_block(lambda: step(*args, gen, 0))
    log(f"dynamic block: {fmt_rate('block', med, spread, rates, unit='TTIs/s')}; DL "
        f"{med * n * cfg.dl_tbs / 1e6:.1f} Mb/s + UL {med * n * cfg.ul_tbs / 1e6:.1f} Mb/s; "
        f"CUDA-event time per block {event_ms:.2f} ms; profile of one block {json.dumps(prof)}; {card}")
    log(f"dynamic block by stage, per round (host clock, synchronised at every stage: a "
        f"breakdown, not a rate; the Viterbi's share is viterbi.viterbi_decode's): "
        f"{json.dumps(per_round)}")
    return launches, seen


def phase_blocks(dev, card):
    """Phase 11.  Returns (the turbo_map cases at its new shapes, the
    launches of one block of each engine)."""
    t0 = time.perf_counter()
    paths = [step_sps(dev, card, False), step_sps(dev, card, True), step_dyn(dev, card)]
    logs = [entry for _, seen in paths for entry in seen]
    cases = map_cases(new_map_shapes(logs, ()), dev)
    names = ("SPS block", "SPS block TM3", "dynamic block")
    for c in cases:
        per = {name: sum(1 for k, _, narrow in seen if k == c["K"] and narrow == c["narrow"])
               for name, (_, seen) in zip(names, paths)}
        log(f"turbo_map at {c['B']} x K={c['K']} {'bf16' if c['narrow'] else 'f32'}: "
            f"{1e3 * c['ms']:.1f} us (L2-flushed {1e3 * c['flushed_ms']:.1f} us), bound "
            f"{1e3 * c['bound_ms']:.2f} us ({c['bound_by']}), share {c['share']:.3f}, bit for bit; "
            f"launches at K={c['K']} per block: {json.dumps({k: v for k, v in per.items() if v})}; "
            f"{card}")
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")
    return cases, sum(n for n, _ in paths)


# phase 12: the waveform-native network (runtime/wavenet.py) as
# apps/netsim.py:run_waveform_full builds it, at 100 PRB with 8 UEs, then
# the SPS and dynamic block runners on it at phase 11's depths
# cfi 3, not netsim's 2: at cfi 2, DynBlockRunner's CCE allocation
# (waveblock_dyn._alloc_cces, the reference's) cannot place the 8 netsim
# C-RNTIs 0x146-0x14d in every subframe
NET_PRB, NET_UES, NET_CFI, NET_PATHLOSS, STEADY_TTIS = 100, 8, 3, 80.0, 60


def waveform_network(pathloss=NET_PATHLOSS, **kw):
    """apps/netsim.py:run_waveform_full's network: 8 UEs with IMSIs
    0010100000000xx and preambles (7 + i) % 64, pathloss 80 dB, seed 0, at
    cfi NET_CFI, on the card (the entry point's default); `kw` are netsim's
    other WaveformNetwork options."""
    from srslte_emane_tpu_torch.epc import hss as hss_mod, mme as mme_mod, spgw as spgw_mod
    from srslte_emane_tpu_torch.runtime import wavenet
    from srslte_emane_tpu_torch.stack import enb_stack, security, ue_stack

    hss = hss_mod.Hss()
    spgw = spgw_mod.Spgw()
    mme = mme_mod.Mme(hss, spgw)
    enb = enb_stack.EnbStack(mme, enb_id=1, n_prb=NET_PRB)
    ues = []
    for i in range(NET_UES):
        imsi = f"0010100000000{i:02d}"
        key = bytes(range(16))
        hss.add(hss_mod.Subscriber(imsi=imsi, key=key))
        opc = security.milenage_opc(key, b"\x00" * 16)
        ues.append(ue_stack.UeStack(ue_stack.Usim(imsi, key, opc), preamble=(7 + i) % 64))
    net = wavenet.WaveformNetwork(enb, ues, pathloss_db=np.full(NET_UES, pathloss),
                                  n_prb=NET_PRB, seed=0, cfi=NET_CFI, **kw)
    assert net.device.type == "cuda" and net.medium._gen.device.type == "cuda"
    return net, ues, spgw, spgw_mod


def network_stages():
    """(module or class, function) pairs of one host-paced TTI for timed_calls."""
    from srslte_emane_tpu_torch.ops.fec import turbodecoder, viterbi
    from srslte_emane_tpu_torch.runtime import wavenet as wn

    return ((wn.WaveformNetwork, "run"), (wn.WaveEnbPhy, "_rx"), (wn.WaveEnbPhy, "_tx"),
            (wn.WaveMedium, "dl_take_all"), (wn._CellKernels, "rx_front"),
            (wn._CellKernels, "blind_all"), (viterbi, "viterbi_decode"),
            (wn.WaveUePhy, "_camp_rx_row"), (wn._CellKernels, "pdsch_rx"),
            (wn._CellKernels, "pusch_rx"), (wn.WaveUePhy, "_tx"),
            (turbodecoder, "turbo_decode"))


class NetworkRun:
    """Drives one waveform network through the steps that phases 12 and 13
    share, keeping every turbo_map launch's (K, rows, narrow) in `logs`."""

    def __init__(self, name, card, logs):
        self.name, self.card, self.logs = name, card, logs

    @contextlib.contextmanager
    def launch_seen(self):
        with launch_log() as seen:
            yield
        self.logs.extend(seen)

    def attach(self, net, ues, expect=None):
        """Attach in 10-TTI slabs (netsim's loop): every UE of `expect` (by
        default all) REGISTERED, RRC CONNECTED, with an IP address, each
        after a PRACH detection.  Returns each UE's attach TTI."""
        import torch

        from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc

        expect = range(len(ues)) if expect is None else expect
        attach_tti = {}
        limit = 200 + 100 * NET_UES
        tdc.launches = 0
        t0 = time.perf_counter()
        with self.launch_seen():
            while net.tti < limit:
                net.run(10)
                for i, u in enumerate(ues):
                    if i not in attach_tti and u.emm_state == "REGISTERED":
                        attach_tti[i] = net.tti
                if set(expect) <= set(attach_tti):
                    break
        torch.cuda.synchronize()
        attach_s = time.perf_counter() - t0
        bad = [(i, u.emm_state, u.rrc_state, u.ip_addr) for i, u in enumerate(ues)
               if i in expect and not (u.emm_state == "REGISTERED"
                                       and u.rrc_state == "CONNECTED" and u.ip_addr)]
        assert not bad, f"{self.name}: UEs not attached after {net.tti} TTIs: {bad}"
        assert net.enb.metrics["prach_det"] >= len(expect), net.enb.metrics
        log(f"{self.name}: {NET_PRB} PRB, cfi {NET_CFI}, {NET_UES} UEs at "
            f"{float(net.medium.pathloss_db[0]):.0f} dB: all REGISTERED, RRC CONNECTED, with an "
            f"IP address; attach TTI per UE {json.dumps(attach_tti)}; {net.tti} TTIs in "
            f"{attach_s:.1f} s ({net.tti / attach_s:.1f} sf/s during the attach, compiles none: "
            f"first calls' host tables included); {tdc.launches} turbo_map launches; eNB "
            f"{json.dumps(net.enb.metrics)}; UE 0 {json.dumps(net.ues[0].metrics)}; {self.card}")
        return attach_tti

    @staticmethod
    def traffic(ues, spgw, spgw_mod, size=120, n_dl=4):
        """netsim's IP traffic: n_dl DL packets of `size` bytes + 1 UL packet
        of 120 per UE.  Returns each UE's DL packet."""
        pkts = []
        for u in ues:
            pkt = spgw_mod.make_ipv4("8.8.8.8", u.ip_addr, b"d" * size)
            for _ in range(n_dl):
                spgw.handle_sgi_pdu(pkt)
            u.gw_send(spgw_mod.make_ipv4(u.ip_addr, "8.8.8.8", b"u" * 120))
            pkts.append(pkt)
        return pkts

    def paced(self, net, ues, spgw, offers, ttis=STEADY_TTIS):
        """`ttis` host-paced TTIs after the offers ((packet per UE, count)
        pairs): every DL packet delivered, UL bytes grown; sf/s, CUDA-event
        time and turbo_map launches per TTI.  Returns the launches."""
        import torch

        from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc

        before = [[u.gw_rx.count(pkt) for u, pkt in zip(ues, pkts)] for pkts, _ in offers]
        ul_before = spgw.metrics["ul_bytes"]
        tdc.launches = tdc.launches_v1 = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with self.launch_seen():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            net.run(ttis)
            end.record()
            torch.cuda.synchronize()
            steady_s = time.perf_counter() - t0
        launches = tdc.launches
        assert launches > 0 and tdc.launches_v1 == 0, (self.name, launches, tdc.launches_v1)
        missing = [(i, k) for k, ((pkts, n), b) in enumerate(zip(offers, before))
                   for i, (u, pkt) in enumerate(zip(ues, pkts)) if u.gw_rx.count(pkt) - b[i] != n]
        assert not missing, f"{self.name}: DL packets missing at (UE, offer) {missing}"
        assert spgw.metrics["ul_bytes"] > ul_before, spgw.metrics
        log(f"{self.name} steady state: {ttis} host-paced TTIs with "
            f"{' + '.join(f'{n} x {len(pkts[0])} B' for pkts, n in offers)} DL + 1 UL packets "
            f"per UE, every DL packet delivered, UL bytes {ul_before} -> "
            f"{spgw.metrics['ul_bytes']}; steady_sf_per_sec {ttis / steady_s:.1f}; CUDA-event "
            f"time per TTI {start.elapsed_time(end) / ttis:.2f} ms; turbo_map launches per TTI "
            f"{launches / ttis:.2f}; {self.card}")
        return launches

    def stages_and_profile(self, net, offer, extra_stages=()):
        """Where a host-paced TTI with traffic goes (synchronised at every
        stage: a breakdown, not a rate; nested calls count in both), then
        the device profile of 5 such TTIs; `offer` queues the traffic."""
        offer()
        with timed_calls(network_stages() + tuple(extra_stages)) as totals:
            net.run(10)
        per_tti = {k: {"calls_per_tti": n_ / 10, "ms_per_tti": round(1e2 * t, 3),
                       "share": round(t / totals["WaveformNetwork.run"][1], 3)}
                   for k, (n_, t) in totals.items()}
        log(f"{self.name} by stage, per host-paced TTI (traffic offered just before): "
            f"{json.dumps(per_tti)}")
        offer()
        prof = profile_block(lambda: net.run(5))  # the profiler's summary costs seconds per TTI
        log(f"{self.name} profile of 5 host-paced TTIs with traffic: {json.dumps(prof)}; per "
            f"TTI: device {prof['device_ms'] / 5:.3f} ms, {prof['kernel_launches'] / 5:.0f} "
            f"kernel launches, busy share {prof['busy_share']:.4f}; {self.card}")


def run_runner(runner, launch_seen):
    """One untimed block, then 2 timed ones.  Returns (TTIs/s, turbo_map
    launches per block)."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc

    with launch_seen():
        tdc.launches = 0
        runner.run_block()
        torch.cuda.synchronize()
        per_block = tdc.launches
    t0 = time.perf_counter()
    for _ in range(2):
        runner.run_block()
    torch.cuda.synchronize()
    rate_ = 2 * runner.cfg.T / (time.perf_counter() - t0)
    return rate_, per_block


def map_cases_logged(logs, known, dev, phase, card):
    """turbo_map against its plain version at every shape of `logs` not in
    `known`, each with its launches in the phase."""
    cases = map_cases(new_map_shapes(logs, known), dev)
    for c in cases:
        n_launch = sum(1 for k, r, nw in logs if (k, r, nw) == (c["K"], c["B"], c["narrow"]))
        log(f"turbo_map at {c['B']} x K={c['K']} {'bf16' if c['narrow'] else 'f32'}: "
            f"{1e3 * c['ms']:.1f} us (L2-flushed {1e3 * c['flushed_ms']:.1f} us, wrapper "
            f"{1e3 * c['wrapper_ms']:.1f} us, plain {1e3 * c['plain_ms']:.1f} us), bound "
            f"{1e3 * c['bound_ms']:.3f} us ({c['bound_by']}), share {c['share']:.4f}, bit for "
            f"bit; launches at this shape in phase {phase}: {n_launch}; {card}")
    return cases


def phase_network(dev, card):
    """Phase 12.  Returns (the turbo_map cases at its new shapes, its
    launches: the host-paced steady state plus one block of each runner)."""
    from srslte_emane_tpu_torch.runtime import waveblock, waveblock_dyn

    t_phase = time.perf_counter()
    net, ues, spgw, spgw_mod = waveform_network()
    logs = []
    run = NetworkRun("network", card, logs)
    run.attach(net, ues)
    pkts = run.traffic(ues, spgw, spgw_mod)
    steady_launches = run.paced(net, ues, spgw, [(pkts, 4)])
    run.stages_and_profile(net, lambda: run.traffic(ues, spgw, spgw_mod))

    # the block runners on the attached network
    sps = waveblock.SpsBlockRunner(net, T=SPS_T)
    sps_rate, sps_launches = run_runner(sps, run.launch_seen)
    m = sps.metrics
    assert m["blocks"] == 3 and m["dl_ok"] == m["dl_tb"] and m["ul_ok"] == m["ul_tb"] \
        and m["ack_det"] == m["dl_tb"], m
    log(f"SpsBlockRunner T={SPS_T}: {sps_rate:.1f} TTIs/s over 2 blocks (host mux and "
        f"stack feedback included), {sps_launches} turbo_map launches per block; metrics "
        f"{json.dumps(m)}; DL {sps.cfg.dl_l_crbs} PRB MCS {sps.cfg.dl_mcs} (TBS "
        f"{sps.cfg.dl_tbs}), UL {sps.cfg.ul_l_prb} PRB (TBS {sps.cfg.ul_tbs}); {card}")
    dyn = waveblock_dyn.DynBlockRunner(net, R=DYN_R)
    dyn_rate, dyn_launches = run_runner(dyn, run.launch_seen)
    m = dyn.metrics
    assert m["blocks"] == 3 and m["dl_ok"] == m["dl_tb"] and m["ul_ok"] == m["ul_tb"], m
    log(f"DynBlockRunner R={DYN_R}: {dyn_rate:.1f} TTIs/s over 2 blocks (host mux and "
        f"stack feedback included), {dyn_launches} turbo_map launches per block; metrics "
        f"{json.dumps(m)}; DL {dyn.cfg.dl_l_crbs} PRB (TBS {dyn.cfg.dl_tbs}), UL "
        f"{dyn.cfg.ul_l_prb} PRB (TBS {dyn.cfg.ul_tbs}); {card}")
    assert all(u.emm_state == "REGISTERED" for u in ues)

    cases = map_cases_logged(logs, (), dev, 12, card)
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s")
    return cases, steady_launches + sps_launches + dyn_launches


# phase 13: the waveform network's slice-13c options on phase 12's network
# (netsim --waveform-full at 100 PRB, 8 UEs, cfi 3): the impaired FDD network
# (netsim's --fading epa --dyn-delay 0.2,1.5,1.0 --hst 40), TDD (configuration
# 1, special subframe 4), the 2x2 TM3 downlink (UEs 0-5 well conditioned,
# 6-7 at singular-value ratio 0.05, 70 dB), then the dynamic block across 2
# cells at phase 11's configuration
TDD_CFG, TM3_COND, TM3_PATHLOSS, N_CELLS = 1, (1.0,) * 6 + (0.05,) * 2, 70.0, 2
IMPAIRMENTS = dict(fading_profile="epa", doppler_hz=5.0, dyn_delay=(0.2, 1.5, 1.0),
                   hst_fd_hz=40.0)


@contextlib.contextmanager
def wrapped(obj, name, before=None, after=None):
    """obj.name called with before(*args) first and after(out, *args) on its
    result; restored on exit."""
    fn = getattr(obj, name)

    def call(*a, **kw):
        if before is not None:
            before(*a, **kw)
        out = fn(*a, **kw)
        if after is not None:
            after(out, *a, **kw)
        return out

    setattr(obj, name, call)
    try:
        yield
    finally:
        setattr(obj, name, fn)


def step_net_impaired(card, logs):
    """Phase 13a.  Returns its turbo_map launches."""
    from srslte_emane_tpu_torch.ops import fading
    from srslte_emane_tpu_torch.runtime import wavenet as wn

    net, ues, spgw, spgw_mod = waveform_network(**IMPAIRMENTS)
    run = NetworkRun("impaired network (EPA 5 Hz, dynamic delay 0.2-1.5 us, HST 40 Hz)", card,
                     logs)
    run.attach(net, ues)
    pkts = run.traffic(ues, spgw, spgw_mod)
    launches = run.paced(net, ues, spgw, [(pkts, 4)])
    run.stages_and_profile(net, lambda: run.traffic(ues, spgw, spgw_mod),
                           ((wn.WaveMedium, "_impair"), (fading, "apply_fading")))
    return launches


def step_net_tdd(card, logs):
    """Phase 13b.  Returns its turbo_map launches."""
    from srslte_emane_tpu_torch.phch import tdd

    net, ues, spgw, spgw_mod = waveform_network(tdd_config=TDD_CFG, ss_config=4)
    run = NetworkRun(f"TDD network (configuration {TDD_CFG}, special subframe 4)", card, logs)
    off_u, s_ok = [], [0]

    def ul_put(tti, ue_idx, samples, is_prach=False):
        if tdd.sf_type(TDD_CFG, tti % 10) != "U":
            off_u.append((tti, ue_idx))

    def tb_decoded(tti, payload, *a, **kw):
        s_ok[0] += payload is not None and tdd.sf_type(TDD_CFG, tti % 10) == "S"

    with contextlib.ExitStack() as stack:
        stack.enter_context(wrapped(net.medium, "ul_put", before=ul_put))
        for u in ues:
            stack.enter_context(wrapped(u, "tb_decoded", before=tb_decoded))
        run.attach(net, ues)
        pkts = run.traffic(ues, spgw, spgw_mod)
        launches = run.paced(net, ues, spgw, [(pkts, 4)])
    assert not off_u, f"TDD: UE transmissions off U subframes (tti, UE): {off_u[:8]}"
    assert s_ok[0] >= 1, "TDD: no TB decoded in a special subframe"
    log(f"TDD network: no UE transmission off a U subframe; {s_ok[0]} TBs decoded in S "
        f"subframes (DwPTS 12 symbols) over the attach and the steady state; eNB "
        f"{json.dumps(net.enb.metrics)}; {card}")
    run.stages_and_profile(net, lambda: run.traffic(ues, spgw, spgw_mod))
    return launches


def mib_decodable(net):
    """Per UE of a MIMO network: does its antenna 0 decode the MIB of a
    noise-free subframe 0 through its 2x2 matrix?  The eNB sends the PBCH
    from port 0 alone with the 2-port CRC mask, which the UE checks on its
    SFBC (ports 0 and 1) hypothesis only (the reference's pbch.encode and
    decode): where the antenna hears port 1 well above port 0 that
    combination fails and the UE never leaves SFN_SYNC."""
    import torch

    from srslte_emane_tpu_torch.ops import cplx, ofdm
    from srslte_emane_tpu_torch.phch import pbch

    k = net.kern
    mib = np.asarray(pbch.pack_mib(NET_PRB, 0))[None].astype(np.int8)
    tx = k.modulate(torch.cat([k.base_grid(0, 0, mib), k.base_grid_p1(0)]))  # (2 ports, T, 2)
    y = cplx.mul(net.medium.mimo_h[:, 0, :, None, :], tx[None]).sum(1)  # each UE's antenna 0
    return [bool(x) for x in k.pbch_rx(ofdm.demodulate(y, NET_PRB))[3].cpu()]


def step_net_tm3(card, logs):
    """Phase 13c.  Returns its turbo_map launches."""
    from srslte_emane_tpu_torch.runtime import wavenet as wn

    net, ues, spgw, spgw_mod = waveform_network(pathloss=TM3_PATHLOSS, mimo=True,
                                                mimo_cond=list(TM3_COND))
    run = NetworkRun(f"TM3 network (2x2, ratio {TM3_COND[0]} for UEs 0-5, {TM3_COND[-1]} for "
                     f"6-7)", card, logs)
    can = [i for i, ok in enumerate(mib_decodable(net)) if ok]
    h = net.medium.mimo_h.cpu().numpy()
    gain = lambda p: [round(float(10 * np.log10((h[u, 0, p] ** 2).sum())), 1) for u in range(NET_UES)]
    log(f"TM3 network: antenna 0's gain from port 0 by UE {gain(0)} dB, from port 1 {gain(1)} "
        f"dB; UEs that decode a noise-free MIB (the PBCH rides port 0 alone): {can}; {card}")
    assert len(can) >= NET_UES - 2, can
    cws = collections.Counter()

    def tm3_rx(out, *a, **kw):
        cws["grants"] += 1
        cws["both"] += bool(out[2][0]) and bool(out[3][0])

    camped = [ues[i] for i in can]
    enb = net.enb.mac
    ri_of = lambda: {r: getattr(u, "ri", None) for r, u in sorted(enb.ues.items())}
    with wrapped(wn._CellKernels, "pdsch_rx_tm3", after=tm3_rx):
        run.attach(net, ues, expect=can)
        assert [i for i, u in enumerate(net.ues) if u.state == "CAMP"] == can
        net.run(wn.WaveUePhy.RI_PERIOD)  # every camped UE probes its rank once
        ri_ue = {net.ues[i].stack.crnti: net.ues[i]._ri for i in can}
        want = {net.ues[i].stack.crnti: 2 if TM3_COND[i] > 0.3 else 1 for i in can}
        assert ri_ue == want, f"TM3: RI probes {ri_ue}, want {want}"
        assert enb.metrics.get("ri_reports", 0) > 0, enb.metrics
        ri_shared = ri_of()
        # the eNB reads each format-2 report on every UE's resource of the
        # PRB pair, so the last report of an RI window sets every UE's rank
        # (the reference's adjudication); for the traffic each RI report
        # reaches the MAC with its own UE's rank, as a per-UE read would
        cqi_info = enb.cqi_info
        enb.cqi_info = lambda tti, rnti, cqi, ri=None, **kw: cqi_info(
            tti, rnti, cqi, ri=None if ri is None else ri_ue.get(rnti, ri), **kw)
        try:
            for rnti, ri in ri_ue.items():
                enb.cqi_info(net.tti, rnti, None, ri=ri)
            # phase 12's packets, then a burst that one TB (1,500 bytes at
            # most) cannot carry, so that the scheduler opens a second codeword
            pkts = run.traffic(camped, spgw, spgw_mod)
            burst = run.traffic(camped, spgw, spgw_mod, size=1000, n_dl=3)
            launches = run.paced(net, camped, spgw, [(pkts, 4), (burst, 3)])
        finally:
            del enb.cqi_info
    n_tm3 = net.enb.metrics.get("tm3_tx", 0)
    assert ri_of() == ri_ue, (ri_of(), ri_ue)
    assert n_tm3 > 0 and cws["grants"] > 0 and cws["both"] > 0, (n_tm3, dict(cws))
    log(f"TM3 network: RI probed by each camped UE (by RNTI) {json.dumps(ri_ue)}; eNB RI reports "
        f"{enb.metrics['ri_reports']}; the eNB's RI per RNTI after the shared format-2 reads "
        f"{json.dumps(ri_shared)}, with per-UE RI reports {json.dumps(ri_of())}; rank-2 grants "
        f"sent {n_tm3}, decoded {cws['grants']}, both codewords right {cws['both']}; eNB "
        f"{json.dumps(net.enb.metrics)}; {card}")
    run.stages_and_profile(net, lambda: run.traffic(camped, spgw, spgw_mod, size=1000, n_dl=3),
                           ((wn._CellKernels, "blind_all2"), (wn._CellKernels, "pdsch_rx_tm3"),
                            (wn._CellKernels, "ri_probe")))
    return launches


def step_cells(dev, card, logs):
    """Phase 13d: make_bench_step(n_cells=2) at phase 11's dynamic
    configuration against n_cells=1.  Returns its turbo_map launches."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc
    from srslte_emane_tpu_torch.runtime import waveblock_dyn as wbd

    cfg = dyn_config(DYN_R)
    n, T = cfg.n_ues, cfg.T
    rng = np.random.default_rng(1)
    dl_q = torch.from_numpy(rng.integers(0, 2, (N_CELLS, T, n, cfg.dl_tbs), dtype=np.int8)).to(dev)
    ul_q = torch.from_numpy(rng.integers(0, 2, (N_CELLS, T, n, cfg.ul_tbs), dtype=np.int8)).to(dev)
    rb = [wbd.make_schedule(cfg, seed=3 + c) for c in range(N_CELLS)]
    rb_dl, rb_ul = (torch.from_numpy(np.stack([r[k] for r in rb])).to(dev) for k in (0, 1))
    gens = []
    for c in range(N_CELLS):
        gens.append(torch.Generator(device=dev))
        gens[-1].manual_seed(c)
    results = {}
    for cells in (1, N_CELLS):
        bench = wbd.make_bench_step(cfg, n_cells=cells)  # the card: the entry point's default
        args = ((dl_q, ul_q, rb_dl, rb_ul, gens, 0) if cells > 1
                else (dl_q[0], ul_q[0], rb_dl[0], rb_ul[0], gens[0], 0))
        want = [cells * T * n] * 3 + [0, 0, 0]
        with launch_log() as seen:
            tdc.launches = 0
            counts = [int(x) for x in bench(*args)]
            launches = tdc.launches
        assert counts == want, f"dynamic block x {cells} cells: counts {counts}, want {want}"
        med, spread, rates = rate(lambda: bench(*args), per_call=cells * T, iters=1)
        prof = profile_block(lambda: bench(*args))
        results[cells] = dict(launches=launches, seen=seen, med=med, prof=prof)
        log(f"dynamic block x {cells} cell(s) (R={DYN_R}, {n} UEs per cell): every CRC and ACK in "
            f"every cell, no DCI miss; {fmt_rate('block', med, spread, rates, unit='cell-TTIs/s')}; "
            f"{launches} turbo_map launches per block {sorted(set(seen))}; profile of one block "
            f"{json.dumps(prof)}; {card}")
    one, two = results[1], results[N_CELLS]
    logs.extend(two["seen"])
    log(f"dynamic block across cells: {N_CELLS} cells vs 1: cell-TTIs/s x "
        f"{two['med'] / one['med']:.2f}, kernel launches per block x "
        f"{two['prof']['kernel_launches'] / one['prof']['kernel_launches']:.3f}, turbo_map "
        f"launches per block x {two['launches'] / one['launches']:.3f}, device time per block x "
        f"{two['prof']['device_ms'] / one['prof']['device_ms']:.2f}; {card}")
    return two["launches"]


def phase_slice13c(dev, card, known):
    """Phase 13.  Returns (the turbo_map cases at its shapes not in `known`,
    its launches: the three networks' host-paced steady states and one
    two-cell block)."""
    t_phase = time.perf_counter()
    logs, launches, seconds = [], [], []
    for step in (lambda: step_net_impaired(card, logs), lambda: step_net_tdd(card, logs),
                 lambda: step_net_tm3(card, logs), lambda: step_cells(dev, card, logs),
                 lambda: map_cases_logged(logs, known, dev, 13, card)):
        t0 = time.perf_counter()
        launches.append(step())
        seconds.append(round(time.perf_counter() - t0, 1))
    cases = launches.pop()
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s (13a, 13b, 13c, 13d, the kernel "
        f"checks: {seconds} s); turbo_map launches by sub-phase {launches}")
    return cases, sum(launches)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
        builds = list(pool.map(tdc.build, (tdc.SOURCE, tdc.SOURCE_V1)))
    log(f"build: {time.perf_counter() - t0:.1f} s wall for both")
    for b in builds:
        log(f"build: {b.seconds:.1f} s -> {b.path}")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas: {line.strip()}")

    cases = phase_kernel(dev)
    dl_launches = phase_main_path(dev)
    v1_cases, v1_launches = phase_v1(dev)
    ul_launches = phase_uplink(dev)
    phase_cascade(dev)
    sf_launches = phase_dl_subframe(dev, card)
    mimo_cases, tm3_launches = phase_mimo(dev, card)
    sync_cases, sync_launches = phase_sync(dev, card)
    block_cases, block_launches = phase_blocks(dev, card)
    net_cases, net_launches = phase_network(dev, card)
    known = tuple((c["K"], c["B"], (c["narrow"],)) for c in (
        cases + mimo_cases + sync_cases + block_cases + net_cases))
    c13_cases, c13_launches = phase_slice13c(dev, card, known)
    bench = next(c for c in cases if (c["K"], c["B"], c["narrow"]) == (5504, 768, True))
    odd = next(c for c in v1_cases if (c["K"], c["B"]) == (1040, 768))
    print(json.dumps({"kernels": [{
        "name": "turbo_map",
        "route": "cuda",
        "source": "srslte_emane_tpu_torch/csrc/turbo_map.cu",
        "replaces": "srslte_emane_tpu/ops/fec/turbodecoder_pallas2.py:70",
        # PDSCH link, uplink, DL subframe, TM3 cell, phase 10's, 11's, 12's and 13's paths
        "launches": (dl_launches + ul_launches + sf_launches + tm3_launches + sync_launches
                     + block_launches + net_launches + c13_launches),
        "max_abs_err": max(c["max_abs_err"] for c in cases + mimo_cases + sync_cases
                           + block_cases + net_cases + c13_cases),
        "ms": bench["ms"],
        "wrapper_ms": bench["wrapper_ms"],
        "plain_ms": bench["plain_ms"],
        "bound_ms": bench["bound_ms"],
        "bound_by": bench["bound_by"],
        "share": bench["share"],
        "library_ms": None,  # no single PyTorch call computes a MAP half-iteration
    }, {
        "name": "turbo_map_v1",
        "route": "cuda",
        "source": "srslte_emane_tpu_torch/csrc/turbo_map_v1.cu",
        "replaces": "srslte_emane_tpu/ops/fec/turbodecoder_pallas.py:53",
        "launches": v1_launches,  # the odd-window path
        "max_abs_err": max(c["max_abs_err"] for c in v1_cases),
        "ms": odd["ms"],
        "wrapper_ms": odd["wrapper_ms"],
        "plain_ms": odd["plain_ms"],
        "bound_ms": odd["bound_ms"],
        "bound_by": odd["bound_by"],
        "share": odd["share"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
