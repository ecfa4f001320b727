#!/usr/bin/env python3
"""Start-up check of the PyTorch port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises; the exit code is then non-zero):
  1. device: needs torch.cuda; prints the card's name and power limit;
  2. build: compiles both MAP kernels (srslte_emane_tpu_torch/csrc/
     turbo_map.cu and turbo_map_v1.cu), the Viterbi (csrc/viterbi.cu), the
     turbo decoder's epilogue (csrc/turbo_iter.cu) and the DL-SCH encode
     (csrc/sch_encode.cu), one nvcc each, started together, into build/
     unless these sources were built before;
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
     encode throughput, median of 3 runs, and the MAP passes per code block;
     (b) make_link_step, the reference's jitted step (on the card a CUDA
     graph captured once and replayed per call, runtime/graphs.jit),
     against link_step, the eager step, on the bench payload and a new one, on
     generators seeded alike: bits, CRC flags, snr_db, the generators'
     states, launches and MAP rows equal, each payload decoded; then both in
     turns (graph, eager, eager, graph): sf/s, CUDA-event ms per call, and
     one profiled call each (host launches, at most 16 for the graph; busy
     share; each port kernel's runs on the card equal to its launch count;
     an empty trace fails);
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
     PDUs each, then send for one UE's 128 PDUs (every PDU delivered), each
     step graphed (the card's default: one CUDA graph per key of the
     reference's jit) beside the same plane with jit=False, in lockstep
     over two bursts (results, SNR estimates, metrics, generator states and
     launch counts equal; graphs built, their build seconds and pool MiB),
     then in turns (graphed, eager, eager, graphed): PDUs/s, CUDA-event ms,
     and one profiled call each (host launches, device ms, busy share, each
     port kernel's runs on the card equal to its launch count);
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
     UEs (n_pucch 0-3; 24 PRB each), every ACK and wideband CQI right, in
     ACKs/s and TBs/s; each plane graphed beside jit=False as in phase 8;
     then both planes past the per-UE table caches' bound of 64 at 100
     PRB, cfi 3 (send_tti with 80 one-PRB grants, UlControlPlane.step with
     65 UEs), graphed beside jit=False (graphs built, host launches per
     call), and turbo_map at their shapes;
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
     runtime/waveblock.make_block_step on the card: the eager block
     (jit=False): every DL and UL CRC and ACK, payloads bit-exact; the
     first two TTIs against the CPU (the card's noise replayed); the
     graphed block (the default: one CUDA graph, tti0 and the payloads its
     inputs) against the eager one at tti0 0 and 37 on other payloads, as
     phase 4b, then both in turns as phase 4b (TTIs/s); the graphed bench
     step's TTIs/s, CUDA-event time, a profile of one graphed block (device
     time, kernel launches, busy share), DL/UL Mb/s, peak memory and a depth
     sweep at T = 20, 40, 80, 160; the same in TM3 with 2 ports (every
     codeword); the dynamic block of
     scripts/bench_waveblock_dyn.py (100 PRB, cfi 2, 8 feasible RNTIs, DL 11
     PRB MCS 25, UL 10 PRB MCS 20, 30 dB, R=20) through
     runtime/waveblock_dyn.make_dyn_block_step, by default one round
     captured as a CUDA graph and replayed R times: every CRC and ACK, no
     DCI miss, the decoded RIVs followed, the TBs delivered in queue order,
     equal bit for bit to the eager block (jit=False), whose noise is
     recorded for the first two rounds against the CPU; the graph's
     turbo_map launches and their log from its second call, equal to the
     eager block's; TTIs/s and the profile of the graph (its kernels' runs
     equal to their launch counts), the time by stage of a round of the
     eager block (the Viterbi's share); then turbo_map against its plain
     version at the blocks' shapes, with its launches per block;
 12. the waveform-native network: apps/netsim.py:run_waveform_full's
     network (runtime/wavenet.WaveformNetwork at 100 PRB, cfi 3, 8 UEs,
     80 dB, seed 0, on the card by default, every _CellKernels stage a
     CUDA graph captured once per key and replayed) beside the same
     network with jit=False (its stages eager), TTI by TTI in lockstep
     (NetworkPair: the HSS's RAND one seeded stream per network): every
     TTI's DL samples and the UL samples the eNB receives equal bit for
     bit, the UEs' states and all metrics equal.  It attaches in 10-TTI
     slabs (all 8 REGISTERED, RRC CONNECTED, with an IP address; >= 8
     PRACH detections), then carries netsim's 4 DL + 1 UL IP packets per
     UE over 60 host-paced TTIs (every DL packet delivered, UL bytes grown;
     the pair's delivered packets equal); then both networks in turns
     (graphed, eager, graphed, eager), each with traffic: sf/s, CUDA-event
     ms, host launches, device ms and busy share per TTI (a profile whose
     launch counts equal the card's runs), graphs built, their build
     seconds, peak allocated MiB and the graph pools' MiB; the graphs per
     stage key (add_dl_grant, pdsch_rx and the PUSCH stages: one each,
     never per sf or rb_start); the time by stage of a graphed TTI with
     traffic, the eager network's beside the plain Viterbi, and a profile;
     then SpsBlockRunner(T=160) and DynBlockRunner(R=20) on the attached
     graphed network, one untimed and two timed blocks each (every CRC
     passes, every SPS ACK detected): TTIs/s and turbo_map launches per
     block; then turbo_map against its plain version at every shape the
     phase launched;
 13. phase 12's network with the network's options, each graphed beside
     eager in lockstep as in phase 12: (a) with netsim's --fading epa (5 Hz)
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
     shape of the phase not checked before;
 14. the multi-device layer on one card (a 1-device mesh, no scaling claim):
     (a) pdsch_link.make_link_step_sharded at the bench cell (100 PRB, 64QAM,
     rate 0.55, llr_bits=16, batch 128) through turbo_map: the eager step
     (jit=False) with every CRC, the payload bit-exact, equal bit for bit
     to link_step on the same noise; the graphed step (the default: one
     CUDA graph for the mesh's position) against the eager one on two
     payloads as phase 4b, then both in turns (sf/s, CUDA-event ms, host
     launches per step, at most 24 for the graph; device ms), 0
     cross-device transfers; then parallel/dryrun.py on 1 device (its
     JSON lines); (b) ota_mix_sharded and total_rx_power_psum
     of 8 nodes on the card against the dense mix (atol 1e-4), also with
     noise against one dense draw from an equally seeded generator, and
     network_scan over 64 cells with the mesh and without: the same PCIs,
     cells/s; (c) waveblock.make_block_step_sharded for 1 cell at phase 11's
     SPS block: the eager step (jit=False) against make_block_step on the
     same draws (every CRC, ACK and output equal), the graphed step (one
     graph for the cell) against the eager one at tti0 0 and 37 as phase
     4b, then both in turns (TTIs/s, CUDA-event ms, host launches per
     block, device ms); (d) the module
     srslte_emane_tpu_torch.apps.netsim run as `-m` runs it, in four
     subprocesses started together, each with a time limit: the
     message-level run (--ues 20 --ttis 800 --prb 50), --waveform-full with
     8 UEs at 100 PRB, --waveform-block with 8 UEs (T=20) and --waveform-dyn
     with 6 UEs (R=2), each JSON line checked as phase 12 checks its network
     (attach, every DL and UL packet, every block CRC), each process
     reporting its turbo_map launches and their shapes (every waveform run
     must launch it); (e) turbo_map against its plain version at every
     shape of the phase not checked before, the netsim processes' included;
 15. the measuring entry points at their JAX twins' defaults, each run as
     `python -m` runs it in a subprocess through MODULE_LOGGED (its
     turbo_map launches and their shapes): srslte_emane_tpu_torch.bench (the
     number of record, alone: every CRC and bit, decode sf/s, CUDA-event ms
     per call, a warm kernel library, its encode and decode two captured
     graphs), then together the scripts' snr_sweep
     (BLER, sf/s and CUDA-event ms at 8-20 dB, no failure at 20 dB, its
     encode and decode one captured graph each per SNR: 14), bench_extra
     (cell search, TM3, PUSCH, 2-carrier CA, each a captured graph),
     bench_waveform_tpu (T=20), bench_waveblock_dyn (R=20), wavenet_smoke
     (both UEs registered) and snr_sweep --eager (no graph; the same BLER
     and launches per decode as the graphed sweep, its rates logged beside
     them), then bench_waveform_paced alone (T=40, 100 blocks: the
     deadline misses); each process's own gates must pass and its JSON line
     name the card; then in this process the sweep's decode at 8 and 20 dB
     graphed against --eager's as phase 4b (bit for bit on two batches,
     then in turns: sf/s, CUDA-event ms, host launches per decode, at most
     16 for the graph, device ms); then turbo_map against its plain version
     at every shape of the phase not checked before, at every row count
     (the sweep's straggler stages).  Any cut of the scripts' defaults is
     logged as the phase's `reduced` list;
 16. slice 17: (a) the profiling twins at their JAX scripts' defaults, each
     as `python -m` through MODULE_LOGGED (now logging turbo_map_v1 too),
     each alone: profile_turbo (1024 x K=5568 f32, W=32, L=174:
     turbo_map_v1 and turbo_map one launch per half-iteration call, the
     plain MAP none, turbo_decode 2 / 4 / 16 launches at 1 / 2 /
     early-stop iterations), profile_stages (the bench cell at batch 128,
     every CRC) and profile_mimo (the TM3 cell at batch 32, every CRC),
     each with its stage jits as replayed graphs (one per jit of its JAX
     twin: 6, 12 and 8) and then with --eager (none), each stage's
     CUDA-event and host ms logged graphed beside eager with the same MAP
     launches per call; then profile_dynblock (R=2, full and the four
     ablations); each JSON line naming the card; meanwhile feasible_rntis for the dynamic
     cell at PDCCH aggregation 2, 4 and 8; (b) phase 11's SPS TM3 block
     (T=20) at mimo_cond_db 0 (every codeword and ACK) and 60 (every
     codeword fails, each PUCCH carries a NACK with energy above 0.25); (c)
     phase 11's dynamic block (R=2) at l_aggr 2, 4 and 8 with those RNTIs
     (every CRC and ACK, no DCI miss), then with UE 7 at -6 dB under
     max_tx 4 (no drop) and 2 (its processes drop); (d) a 15 PRB, 2-UE
     network attached on the card, then 10 TTIs of WaveUePhy.run_tti with
     no samples and no batch (dl_take, _camp_rx), each UE's front end and
     blind search held against the batched ones on the same samples, TBs
     decoded and every offered packet delivered; (e) turbo_map against its
     plain version at every shape of the phase not checked before, at
     every row count, and turbo_map_v1 at profile_turbo's 1024 x K=5568
     on its draws, each with its launches;
 17. the Viterbi kernel: every call of phases 4-16 went through it (the
     callers reach it through viterbi.viterbi_decode; its launches are
     counted and each call's (rows, K, tb_iter) logged with its first LLRs,
     in this process by ViterbiLog and in the subprocesses of 14d, 15 and
     16a by MODULE_LOGGED; phases 8 and 10-16 each with at least one, and
     each subprocess that decodes control channels, VIT_PROCESSES); phases
     8, 11, 12 and 13 print their stage tables a second time with
     viterbi_decode_ref forced, beside the Viterbi's time and share with
     the kernel, and each device profile of a path that decodes control
     must hold a Viterbi kernel; then the
     kernel against viterbi_decode_ref, bit for bit, at every (rows, K,
     tb_iter) logged, on the path's own LLRs and on threshold LLRs with an
     all-zero row (every decision a tie), with the kernel's time warm and
     L2-flushed, the wrapper's, the plain loop's, the bound and share;
     then one row at each caller's K (28, 38, 40, 44, 50, 55, 64: the
     dependent-step latency) and tb_iter 1 and 5; then the row sweep at
     K=44 (1, 3, 5, 64, 512, 2,816, 2,817 and 8,448 rows: partial last
     warps, ns per step, blocks per SM, share); then K on both sides of a
     block's shared memory (4 x 1,210 in it; 4 x 1,211, NPDSCH's 128 x
     2,552, 2 x 4,000 beyond it), which the kernel's variant with its
     decisions in device memory decodes, bit for bit against the plain
     loop;
 18. the turbo decoder's loop on the card: every turbo_decode call of
     phases 4 (the bench cell), 8 (the DL subframe), 9 (the TM3 cell and
     the MIMO paths) and 12-13 (the graphed networks' decodes, from the
     graphs' warm-ups), the first of each (K, rows, llr_bits), kept, and the
     sweep's cell at 8-12 dB; each decoded by turbo_decode_device under
     torch.cuda.set_sync_debug_mode("error") and by turbo_decode_host (the
     host-driven loop of before, the plain version of the control flow):
     bits, CRC flags, n_iter and MAP rows equal (the networks' calls
     apart), turbo_decode one
     synchronising read; per decode each loop's host syncs, kernel launches
     and device ms (torch.profiler) and host-clock ms; the bench cell's
     widest call captured as a CUDA graph and replayed bit-equal; the bench
     cell's and the sweep's decode sf/s and CUDA-event ms per decode with
     each loop, in turns; then turbo_iter against turbo_iter_ref, bit for
     bit, at every (rows, K) of those calls, with its time per working
     pass warm and L2-flushed, an idle pass, the plain version's, the bound
     and share;
 19. the dynamic block as a replayed CUDA graph (make_dyn_block_step's
     jit=True, the card's default): phase 11's block (R=20), the HARQ block
     (its cell with UE 7 at -6 dB: retransmissions, drops and DCI misses)
     and the block across 2 cells, each against the eager block (jit=False)
     on equal generators: every output, counter and consumed pointer bit
     for bit, the generators left equal, the kernels' launch counts
     (replays included) equal and non-zero; two successive blocks on one
     generator against two eager blocks; a whole call under
     torch.cuda.set_sync_debug_mode("error"); then, graph and eager in
     turns at phase 11's block: the first call's time and memory, TTIs/s,
     CUDA-event and host ms per block, host launches (at most R + 64 for
     the graph), busy share and device ms from a profile, in which each of
     turbo_map, turbo_iter, its arm and the Viterbi ran on the card as many
     times as its launch count says (replays included), peak memory; and
     the other two blocks' cell-TTIs/s both ways;
 20. the DL-SCH encode kernel (csrc/sch_encode.cu, every sch.encode_tb on
     the card since phase 4): against sch.encode_tb_ref on the card, bit for
     bit, at the benchmark cell's 128 x TBS 51,024 (1,152 code blocks of
     K=5,696, two launches), phase 4's TBS 49,472 (16 fillers), 8 rows at
     each redundancy version with a soft-buffer limit, per-row rv_b, and one
     row of phase 8's TBS 4,416 (one K=4,480 block, 40 fillers: one
     launch); at the cell's shape and the one row the kernel's time warm and
     L2-flushed, its bound (payload and codeword bytes) and share, the
     plain version's time; then the benchmark cell's graphed
     encode step (code rate 0.56724): 1,152 code blocks encoded a call by
     the card's count (sch.read_encode_blocks), replays included.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import collections
import concurrent.futures
import contextlib
import functools
import json
import os
import re
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
            bad = int((got != ref).sum())
            assert bad == 0, f"K={k} B={batch} narrow={narrow}: {bad} LLRs not bit-exact"
            err = (got - ref).abs().max().item()
            # the kernel alone (warm, and L2 flushed), the whole wrapper, the plain version
            kernel = lambda: tdc.launch(args[0], args[1], beta_k, w, narrow)
            ms = cuda_ms(kernel, 20)
            flushed_ms = cuda_ms(kernel, 20, flush)
            wrapper_ms = cuda_ms(lambda: tdc.map_decode_cuda(*args, w, narrow), 20)
            plain_ms = cuda_ms(lambda: tdc.map_decode_ref(*args, w, narrow), 3)
            bound_ms, bound_by = map_bound(k, batch, w, narrow)
            cols, blocks = tdc.occupancy(k, w, narrow)
            case = dict(K=k, B=batch, W=w, narrow=narrow, mismatched=bad, max_abs_err=err, ms=ms,
                        flushed_ms=flushed_ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by, share=bound_ms / ms,
                        cols_per_block=cols, blocks_per_sm=blocks)
            log(f"kernel vs plain {json.dumps(case)}")
            cases.append(case)
    return cases


def phase_kernel(dev):
    return map_cases(MAP_SHAPES, dev)


def event_ms(fn, n=5):
    """Median CUDA-event milliseconds of n calls of fn, each bracketed by
    its own events and synchronised (the host's waits inside a call
    included, not the time between calls)."""
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


def graph_against_eager(label, steps, inputs, call, right):
    """Phases 4b and 11: the graphed step (steps["graph"], captured by
    its first call here) and the eager one (steps["eager"]) on each input
    tuple of `inputs`, on generators seeded alike (`call(step, args, gen)`):
    every output bit for bit, the generators left in equal states, each
    call's launch counts and MAP rows equal and each port kernel launched,
    `right(out, args)` holding (a second input tuple: the graph read its new
    inputs).  Returns (the first call's s, the launches of the graph's
    calls after it, by kernel)."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import turbodecoder

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call(steps["graph"], inputs[0], seeded(0))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = collections.Counter()
    for i, args in enumerate(inputs):
        runs = {}
        for name in ("graph", "eager"):
            g = seeded(100 + i)
            before, rows = kernel_counts(), turbodecoder.read_map_rows()
            out = call(steps[name], args, g)
            torch.cuda.synchronize()
            after = kernel_counts()
            counts = {k: after[k] - before[k] for k in after}
            runs[name] = out, g.get_state(), counts, turbodecoder.read_map_rows() - rows
        (out, state, counts, rows), (ref, ref_state, ref_counts, ref_rows) = (runs["graph"],
                                                                             runs["eager"])
        out_d, ref_d = (x if isinstance(x, dict) else dict(enumerate(x)) for x in (out, ref))
        assert set(out_d) == set(ref_d), label
        for k in ref_d:
            assert torch.equal(out_d[k], ref_d[k]), f"{label}: graph and eager differ at {k}"
        assert torch.equal(state, ref_state), f"{label}: generator states differ"
        assert counts == ref_counts and rows == ref_rows > 0, (label, counts, ref_counts, rows,
                                                               ref_rows)
        assert counts["turbo_map"] > 0 and counts["turbo_iter"] > 0, (label, counts)
        assert right(out, args), f"{label}: the graph's call {i} is wrong"
        launches.update(counts)
    return first_s, launches


def seeded(seed):
    """A generator on the card seeded `seed`."""
    import torch

    g = torch.Generator(device=torch.device("cuda", 0))
    g.manual_seed(seed)
    return g


def graph_turns(label, steps, call, per_call, unit, card, iters=ITERS, control=False):
    """The graphed and the eager step in turns (graph, eager, eager, graph):
    per_call units per second (median of N_RUNS runs of `iters` calls),
    CUDA-event ms per call (event_ms), then one profiled call of each
    (profile_counted: each port kernel's runs on the card equal its counted
    launches; an empty trace fails, and so does one without a Viterbi kernel
    where the step decodes control, `control`) with its host launches, busy
    share and device ms.  Logs and returns the summary."""
    res = {name: collections.defaultdict(list) for name in steps}
    for name in ("graph", "eager", "eager", "graph"):
        fn = lambda: call(steps[name])
        r = res[name]
        r["rates"].append(round(rate(fn, per_call=per_call, iters=iters)[0], 1))
        r["event_ms"].append(round(event_ms(fn), 3))
    for name in steps:
        prof = profile_counted(lambda: call(steps[name]), f"{label}: the {name} step",
                               control=control)
        res[name].update(host_launches=prof["host_launches"], busy_share=prof["busy_share"],
                         device_ms=prof["device_ms"], kernel_launches=prof["kernel_launches"],
                         port_kernels=prof["port_kernels"])
    summary = {name: {"rate": statistics.median(r["rates"]), "unit": unit, **r}
               for name, r in res.items()}
    log(f"{label}, graph vs eager in turns: {json.dumps(summary)}; {card}")
    return summary


PLANE_ITERS = 2  # calls per timed run of a plane (graph_turns)


def plane_pair(label, make, calls, per_call, unit, card, control=False, turns=True):
    """Phases 8 and 9: a waveform plane graphed (the card's default:
    runtime/wavesim's steps as graphs.jit steps, one CUDA graph per key)
    beside its jit=False twin, both made by make(jit) and so seeded alike.
    In lockstep, each of `calls` (a function of a plane) on both: results
    (bytes, SNR estimates, ACKs, CQIs), metrics and generator states equal,
    and the kernels' launch counts equal (a call that captures counts its
    warm-up too: twice the eager call's); then the graphs built (one per
    key), their build seconds and the pools' MiB; then the last call in
    turns (graph_turns: units/s, CUDA-event ms, one profiled call each), or
    with turns=False one profiled call each alone (host launches, device
    ms, busy share).  Returns the turbo_map launches of the graphed plane's
    calls."""
    import torch

    from srslte_emane_tpu_torch.runtime import graphs

    planes = dict(graph=make(True), eager=make(False))
    assert planes["graph"].jit and graphs.on_card(planes["graph"].device), label
    built, build_s = graphs.STATS["graphs"], graphs.STATS["build_s"]
    launches = collections.Counter()
    first_s = None
    for i, call in enumerate(calls):
        runs, n = {}, graphs.STATS["graphs"]
        for name, plane in planes.items():
            before = kernel_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call(plane)
            torch.cuda.synchronize()
            if name == "graph" and first_s is None:
                first_s = time.perf_counter() - t0
            runs[name] = out, {k: v - before[k] for k, v in kernel_counts().items()}
        (out, counts), (ref, ref_counts) = runs["graph"], runs["eager"]
        assert out == ref, f"{label}: call {i}: the graphed and the eager plane differ"
        captured = graphs.STATS["graphs"] > n
        assert counts == {k: v * (2 if captured else 1) for k, v in ref_counts.items()}, (
            label, i, counts, ref_counts)
        assert planes["graph"].metrics == planes["eager"].metrics, label
        assert torch.equal(planes["graph"].gen.get_state(), planes["eager"].gen.get_state()), label
        launches.update(counts)
    per_key = planes["graph"].graph_counts()
    n_graphs = graphs.STATS["graphs"] - built
    pools = {tuple(g.graph.pool()) for by_sig in planes["graph"].step_graphs().values()
             for g in by_sig.values()}
    pool_mib = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", (0, 0))) in pools) / 2**20
    assert n_graphs == len(per_key) > 0 and set(per_key.values()) == {1}, (label, per_key)
    log(f"{label}: graphed equals eager (jit=False) over {len(calls)} calls in lockstep: results, "
        f"metrics {planes['graph'].metrics}, generator states, launches "
        f"{json.dumps(dict(launches))}; {n_graphs} graphs "
        f"({json.dumps(collections.Counter(k[0] for k in per_key))} by factory), built in "
        f"{graphs.STATS['build_s'] - build_s:.2f} s, their pools {pool_mib:.1f} MiB; "
        f"first graphed call {first_s:.2f} s")
    if not turns:
        s = {name: profile_counted(lambda: calls[-1](plane), f"{label}: the {name} plane",
                                   control=control) for name, plane in planes.items()}
        log(f"{label}: one profiled call each, host launches {s['graph']['host_launches']} vs "
            f"{s['eager']['host_launches']}, device ms {s['graph']['device_ms']} vs "
            f"{s['eager']['device_ms']}, busy share {s['graph']['busy_share']} vs "
            f"{s['eager']['busy_share']}; {card}")
        return launches["turbo_map"]
    s = graph_turns(label, planes, calls[-1], per_call, unit, card, iters=PLANE_ITERS,
                    control=control)
    log(f"{label}: {unit} x {s['graph']['rate'] / s['eager']['rate']:.2f}, host launches "
        f"{s['graph']['host_launches']} vs {s['eager']['host_launches']}, device ms "
        f"{s['graph']['device_ms']} vs {s['eager']['device_ms']}, busy share "
        f"{s['graph']['busy_share']} vs {s['eager']['busy_share']}; {card}")
    return launches["turbo_map"]


# netsim --waveform's planes past the per-UE table caches' bound of 64:
# WaveformDataPlane.send_tti's one-PRB grants and UlControlPlane's UEs, at
# 100 PRB with cfi 3 (netsim's cfi for more than four UEs)
CROWDED_GRANTS, CROWDED_PUCCH_UES = 80, 65
CROWDED_RNTIS = tuple(range(0x46, 0x46 + 120))
CROWDED_PATHLOSS = {r: 96.0 + r % 7 for r in CROWDED_RNTIS}  # 25 to 31 dB


def crowded_cell():
    from srslte_emane_tpu_torch.phch import grid

    return grid.CellConfig(n_prb=100, cell_id=1, cfi=3)


def crowded_data_plane(jit, device="cuda", n=CROWDED_GRANTS):
    """WaveformDataPlane with n one-PRB 16QAM grants (PRB i for UE i, CCEs
    from allocate_cces as netsim places them), and its call: send_tti of 2
    PDUs per UE, each delivered.  Returns (plane, call)."""
    from srslte_emane_tpu_torch.phch import pdcch
    from srslte_emane_tpu_torch.runtime import wavesim

    cell = crowded_cell()
    alloc = pdcch.allocate_cces(cell, list(CROWDED_RNTIS), 1)
    placed = [r for r in CROWDED_RNTIS if r in alloc][:n]
    assert len(placed) == n, len(placed)
    dp = wavesim.WaveformDataPlane(cell, device=device, jit=jit)
    for i, r in enumerate(placed):
        dp.add_ue(r, tuple(int(p == i) for p in range(cell.n_prb)), qm=4, l_aggr=alloc[r][0],
                  cce_start=alloc[r][1])
    nb = min(s.tbs(cell, 1) for s in dp.slots.values()) // 8 - 2
    rng = np.random.default_rng(24)
    pdus = {r: [bytes(rng.integers(0, 256, nb, dtype=np.uint8)) for _ in range(2)]
            for r in placed}

    def send_tti(plane):
        out = plane.send_tti(pdus, CROWDED_PATHLOSS)
        assert all([got for got, _ in out[r]] == pdus[r] for r in placed), "send_tti lost a PDU"
        return out

    return dp, send_tti


def crowded_control_plane(jit, device="cuda", n=CROWDED_PUCCH_UES):
    """UlControlPlane with n UEs (resource i for UE i), and its call: a
    step with an ACK or a NACK from each, every one detected.  Returns
    (plane, call)."""
    from srslte_emane_tpu_torch.runtime import wavesim

    ues = CROWDED_RNTIS[:n]
    acks = {r: i % 2 for i, r in enumerate(ues)}
    cp = wavesim.UlControlPlane(crowded_cell(), device=device, jit=jit)
    for i, r in enumerate(ues):
        cp.add_ue(r, i)

    def step(plane):
        out = plane.step(acks, CROWDED_PATHLOSS)
        assert all(out[r][:2] == (True, acks[r]) for r in ues), "an ACK missed"
        return out

    return cp, step


def crowded_pairs(dev, card):
    """Phase 9: netsim --waveform's two planes with more UEs than a per-UE
    table cache holds (bound 64): send_tti with 80 one-PRB grants and
    UlControlPlane with 65 UEs, each graphed beside its jit=False twin
    (plane_pair without turns: graphs built, one profiled call each for
    the host launches per call).  Each capture reads
    the tables its warm-up made past the bound (utils/devices.table_cache).
    Then turbo_map against its plain version at every shape the pair
    launched.  Returns those cases and the turbo_map launches of the
    graphed calls."""
    t0 = time.perf_counter()
    with launch_log() as seen:
        _, send_tti = crowded_data_plane(False)
        launches = plane_pair(
            f"WaveformDataPlane.send_tti ({CROWDED_GRANTS} UEs x 2 PDUs, one PRB each, cfi 3: "
            f"past the per-UE caches' bound of 64; every PDU delivered)",
            lambda jit: crowded_data_plane(jit)[0], [send_tti], 2 * CROWDED_GRANTS, "PDUs/s",
            card, turns=False)
    _, step = crowded_control_plane(False)
    plane_pair(f"UlControlPlane.step ({CROWDED_PUCCH_UES} UEs' PUCCH 1a, n_pucch 0-"
               f"{CROWDED_PUCCH_UES - 1}: past the bound of 64; every ACK/NACK detected)",
               lambda jit: crowded_control_plane(jit)[0], [step], CROWDED_PUCCH_UES, "ACKs/s",
               card, turns=False)
    cases = map_cases_logged(seen, (), dev, 9, card, select=every_map_shape)
    log(f"past the table caches' bound: {time.perf_counter() - t0:.1f} s")
    return cases, launches


def link_graph(dev, cfg, payload, card):
    """Phase 4b: make_link_step (the reference's jitted step: on the card a
    CUDA graph captured once and replayed) against link_step, the eager
    step, on the bench payload and on a new one, then both in turns.  Returns the
    turbo_map launches of the graph's calls after its first."""
    import torch

    from srslte_emane_tpu_torch.models import pdsch_link

    steps = dict(graph=pdsch_link.make_link_step(cfg),
                 eager=functools.partial(pdsch_link.link_step, cfg=cfg))
    other = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2, tuple(payload.shape), dtype=np.int8)).to(dev)
    first_s, launches = graph_against_eager(
        "link graph", steps, [(payload,), (other,)], lambda step, a, g: step(a[0], g),
        lambda out, a: bool(out[1].all()) and torch.equal(out[0], a[0]))
    (graph,) = steps["graph"].graphs.values()
    log(f"link graph: make_link_step's graph equals link_step bit for bit (bits, CRC flags, "
        f"snr_db, generator states, launches {json.dumps(dict(launches))} over two calls, MAP "
        f"rows) on the bench payload and a new one, each decoded; first call (warm-up, capture, "
        f"one replay) {first_s:.2f} s; {len(graph.tables)} cached tables held")
    s = graph_turns("link graph (phase 4b)", steps, lambda step: step(payload, seeded(7)),
                    BATCH, "sf/s", card)
    assert s["graph"]["host_launches"] <= 16, s["graph"]
    log(f"link graph: sf/s x {s['graph']['rate'] / s['eager']['rate']:.2f}, host launches "
        f"{s['graph']['host_launches']} vs {s['eager']['host_launches']}, busy share "
        f"{s['graph']['busy_share']} vs {s['eager']['busy_share']}; {card}")
    return launches["turbo_map"]


def phase_main_path(dev, card):
    import torch

    from srslte_emane_tpu_torch.models import pdsch_link
    from srslte_emane_tpu_torch.ops import channel
    from srslte_emane_tpu_torch.ops.fec import turbodecoder, turbodecoder_cuda as tdc
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

    turbodecoder.reset_map_rows()
    dec, dec_spread, dec_rates = rate(
        lambda: pdsch_link.rx_subframe(rx, cfg, use_kernel=True)[1],
        check=lambda ok_: bool(ok_.all()))
    passes = turbodecoder.read_map_rows() / ((N_RUNS * ITERS + 1) * BATCH * segm.C)
    enc, enc_spread, enc_rates = rate(lambda: pdsch_link.tx_subframe(payload, cfg))
    log(f"{fmt_rate('decode', dec, dec_spread, dec_rates)}, {dec * cfg.tbs / 1e6:.1f} Mb/s "
        f"payload, MAP half-iterations per code block h = {passes:.2f} (the rows of the "
        f"passes that ran over the code blocks; n_iter = (h+1)//2 = {(passes + 1) // 2:.0f} "
        f"when all sizes take the same h); "
        f"{fmt_rate('encode', enc, enc_spread, enc_rates)}; batch {BATCH}, tbs {cfg.tbs}")
    return main_launches + link_graph(dev, cfg, payload, card)


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


def v1_case(args, w, flush, plain_n=3):
    """turbo_map_v1 against map_decode_v1_ref on `args` (ls, lp, tail_x,
    tail_z on the card) in w windows, bit for bit unless SRSLTE_TPU_LOGMAP
    is set, with the kernel's time warm and L2-flushed, the wrapper's and
    the plain version's (plain_n calls), its bound, share and occupancy."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import turbodecoder, turbodecoder_cuda as tdc

    batch, k = args[0].shape
    what = f"v1 K={k} B={batch} W={w}"
    got = tdc.map_decode_v1_cuda(*args, w)
    ref = tdc.map_decode_v1_ref(*args, w)
    bad = int((got != ref).sum())
    if tdc.LOGMAP:  # the card's log and exp round differently from torch's
        err = check_close(got, ref, what)
    else:
        assert bad == 0, f"{what}: {bad} LLRs not bit-exact"
        err = (got - ref).abs().max().item()
    cols, blocks = tdc.occupancy_v1(k, w)
    # the kernel alone (warm, and L2 flushed), the whole wrapper, the plain version
    beta_k = turbodecoder.beta_tail(*args[2:]).contiguous()
    kernel = lambda: tdc.launch_v1(args[0], args[1], beta_k, w)
    ms = cuda_ms(kernel, 20)
    flushed_ms = cuda_ms(kernel, 20, flush)
    wrapper_ms = cuda_ms(lambda: tdc.map_decode_v1_cuda(*args, w), 20)
    plain_ms = cuda_ms(lambda: tdc.map_decode_v1_ref(*args, w), plain_n)
    bound_ms, bound_by = v1_bound(k, batch, w)
    case = dict(K=k, B=batch, W=w, L=k // w, mismatched=bad, max_abs_err=err, ms=ms,
                flushed_ms=flushed_ms,
                wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, share=bound_ms / ms, cols_per_block=cols,
                blocks_per_sm=blocks)
    log(f"v1 kernel vs plain {json.dumps(case)}")
    return case


def phase_v1(dev):
    """The v1 kernel against its plain version, then the odd-window path
    through the decoder.  Returns (cases, launches of the path)."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import turbodecoder, turbodecoder_cuda as tdc

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    cases = []
    for k, batch, w in V1_SHAPES + V1_EDGE_SHAPES:
        args = random_llrs(k, batch, dev, k + w)
        case = v1_case(args, w, flush, 1 if (k, batch, w) in V1_EDGE_SHAPES else 3)
        if (k, batch) == (1040, 5):
            assert (batch * w) % case["cols_per_block"], f"v1 K={k} B={batch}: the last block is full"
        assert (case["cols_per_block"] == 1) == ((k, w) == (6144, 1)), case
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
    from srslte_emane_tpu_torch.ops.fec import turbodecoder, turbodecoder_cuda as tdc
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

    turbodecoder.reset_map_rows()
    dec = rate(lambda: ue_ul.enb_receive(rx, cfg, use_kernel=True, llr_bits=llr_bits)["pusch"][1],
               check=lambda ok_: bool(ok_.all()))
    sizes = sorted(set(segm.cb_sizes))
    passes = turbodecoder.read_map_rows() / ((N_RUNS * ITERS + 1) * BATCH * segm.C)
    enc = rate(lambda: ue_ul.build_subframe(cfg, tb_bits=payload))
    log(f"UL {fmt_rate('decode', *dec)}, {dec[0] * cfg.tbs / 1e6:.1f} Mb/s payload, "
        f"MAP passes per code block {passes:.2f} (sizes {sizes}; the rows of the passes that "
        f"ran over the code blocks); "
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
    A target (class, factory name, "stage") times the calls of the stage
    function that the factory returns (alone or first of a tuple), such as
    a replayed graph of wavenet._CellKernels.  Calls made while a graph
    captures are not timed.  Yields {"module.name": [calls, seconds]};
    nested calls count in both."""
    import torch

    totals, saved = {}, []

    def wrap(fn, label):
        def timed(*args, **kw):
            if torch.cuda.is_current_stream_capturing():
                return fn(*args, **kw)  # a graph's capture: nothing runs, nothing to time
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            totals[label][0] += 1
            totals[label][1] += time.perf_counter() - t0
            return out
        return timed

    def stage(factory, label):
        def timed_factory(*args, **kw):
            out = factory(*args, **kw)
            if isinstance(out, tuple):
                return (wrap(out[0], label),) + out[1:]
            return wrap(out, label)
        return timed_factory

    for mod, name, *kind in targets:
        label = f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"
        totals[label] = [0, 0.0]
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, (stage if kind else wrap)(getattr(mod, name), label))
    try:
        yield totals
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def loop_map_launches(a):
    """(K, rows, narrow, v1, W, launches) of the MAP launches that one
    turbo_iter_cuda.decode_cuda call (positional arguments `a`) enqueues:
    one per slot, of the kernel that the window length picks, over the
    batch's grid."""
    from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc

    rows, k = a[4].shape
    w = tdc._pick_windows(k)
    return k, rows, bool(a[18]), bool((k // w) % 2), w, 2 * a[16]


# What the logs' wrappers logged while a stream was capturing a CUDA graph,
# not yet handed to the graph (count_replays_in_logs)
CAPTURED = []


def log_update(update):
    """Makes `update` (a function that adds one call to a log of this
    script) now, or, while a stream is capturing a CUDA graph (which
    launches nothing), keeps it for the graph's replays."""
    import torch

    if torch.cuda.is_current_stream_capturing():
        CAPTURED.append(update)
    else:
        update()


def count_replays_in_logs():
    """Makes runtime/graphs.RoundGraph and StepGraph count a captured round's
    or step's replays in this script's logs, as they count them in the
    kernels' own counts: the updates kept during a capture go with its
    graph, and each RoundGraph.run(n) makes them n times, each
    StepGraph.run once.  For the rest of the process."""
    from srslte_emane_tpu_torch.runtime import graphs

    def captured(init):
        def init_logged(self, *a, **kw):
            CAPTURED.clear()
            init(self, *a, **kw)
            self.log_updates = CAPTURED[:]
            CAPTURED.clear()
        return init_logged

    run, step_run = graphs.RoundGraph.run, graphs.StepGraph.run

    def replayed(self, n, gens):
        run(self, n, gens)
        for _ in range(n):
            for update in self.log_updates:
                update()

    def step_replayed(self, args):
        out = step_run(self, args)
        for update in self.log_updates:
            update()
        return out

    graphs.RoundGraph.__init__ = captured(graphs.RoundGraph.__init__)
    graphs.StepGraph.__init__ = captured(graphs.StepGraph.__init__)
    graphs.RoundGraph.run, graphs.StepGraph.run = replayed, step_replayed


@contextlib.contextmanager
def launch_log():
    """Yields a list that gets (K, rows, narrow) of every turbo_map launch
    made inside the block, those that the decoder's loop enqueues from C
    (turbo_iter_cuda.decode_cuda) included, and those of a captured round's
    replays (count_replays_in_logs)."""
    from srslte_emane_tpu_torch.ops.fec import turbo_iter_cuda as ti, turbodecoder_cuda as tdc

    seen, live, launch, decode = [], [True], tdc.launch, ti.decode_cuda

    def add(entries):
        log_update(lambda: live[0] and seen.extend(entries))

    def logged_launch(*a, **kw):
        add([(a[0].shape[1], a[0].shape[0], a[4])])
        return launch(*a, **kw)

    def logged_decode(*a):
        k, rows, narrow, v1, _, n = loop_map_launches(a)
        if not v1:
            add([(k, rows, narrow)] * n)
        return decode(*a)

    tdc.launch, ti.decode_cuda = logged_launch, logged_decode
    try:
        yield seen
    finally:
        tdc.launch, ti.decode_cuda = launch, decode
        live[0] = False


@contextlib.contextmanager
def plain_map():
    """The turbo decoder with turbo_map's plain version in the kernel's
    place inside the block: the host-driven loop (turbo_decode_host, as
    scripts/bench_extra.host_loop_decode, in turbo_decode_device's place),
    whose MAP passes go through map_decode_cuda, with map_decode_cuda
    replaced by map_decode_ref (the same function, bit for bit, on the same
    device)."""
    from srslte_emane_tpu_torch.ops.fec import turbodecoder, turbodecoder_cuda as tdc
    from srslte_emane_tpu_torch.scripts.bench_extra import host_loop_decode

    saved = turbodecoder.turbo_decode_device, tdc.map_decode_cuda
    turbodecoder.turbo_decode_device, tdc.map_decode_cuda = host_loop_decode, tdc.map_decode_ref
    try:
        yield
    finally:
        turbodecoder.turbo_decode_device, tdc.map_decode_cuda = saved


@contextlib.contextmanager
def plain_viterbi():
    """viterbi.viterbi_decode forced to its plain loop (viterbi_decode_ref)
    on the card inside the block, for a stage table beside the kernel's."""
    from srslte_emane_tpu_torch.ops.fec import viterbi

    decode = viterbi.viterbi_decode
    viterbi.viterbi_decode = viterbi.viterbi_decode_ref
    try:
        yield
    finally:
        viterbi.viterbi_decode = decode


def viterbi_beside(label, kernel, plain, whole, per, unit, card):
    """Logs the stage table of timed_calls' `plain` totals (viterbi_decode_ref
    forced) per `unit` (`per` units in the run), then the whole and the
    Viterbi's time and share with the kernel (`kernel` totals) and with the
    plain loop."""
    table = {k: {f"calls_per_{unit}": n / per, f"ms_per_{unit}": round(1e3 * t / per, 3),
                 "share": round(t / plain[whole][1], 3)} for k, (n, t) in plain.items()}
    log(f"{label} by stage with viterbi_decode_ref forced, per {unit} (host clock, "
        f"synchronised at every stage): {json.dumps(table)}")
    vit = "viterbi.viterbi_decode"
    row = lambda tot: dict(whole_ms=round(1e3 * tot[whole][1] / per, 3),
                           viterbi_ms=round(1e3 * tot[vit][1] / per, 3),
                           viterbi_calls=tot[vit][0] / per,
                           viterbi_share=round(tot[vit][1] / tot[whole][1], 4))
    log(f"{label}: Viterbi kernel vs plain loop, per {unit}: {json.dumps(row(kernel))} vs "
        f"{json.dumps(row(plain))} ({whole}); {card}")


class ViterbiLog:
    """Wraps viterbi_cuda.viterbi_decode_cuda inside `with`: counts each
    call's (rows, K, tb_iter) under the phase in `phase`, and keeps a copy of
    the first LLRs of each shape for phase 17.  The subprocesses' calls
    come in through `add_process` (run_logged reaches the log as
    `ViterbiLog.active`); their launches are counted apart, in
    `process_launches`.  A captured round's replays count
    (count_replays_in_logs; the LLRs kept are those of the round's
    warm-up, the first call of each shape)."""

    active = None

    def __init__(self, dev):
        self.dev, self.phase, self.seen, self.inputs = dev, 0, collections.Counter(), {}
        self.process_launches = collections.Counter()

    def add_process(self, label, logged, llr_dir):
        """One MODULE_LOGGED process's Viterbi calls: its summary line
        `logged` and the LLRs it saved in `llr_dir`."""
        import torch

        calls = 0
        for rows, k, tb, n in logged["vit_shapes"]:
            self.seen[(self.phase, rows, k, tb)] += n
            calls += n
            if (rows, k, tb) not in self.inputs:
                self.inputs[(rows, k, tb)] = torch.load(
                    os.path.join(llr_dir, f"{rows}_{k}_{tb}.pt"), weights_only=True).to(self.dev)
        assert logged["vit_launches"] == calls - sum(
            n for rows, _, _, n in logged["vit_shapes"] if rows == 0), (label, logged)
        self.process_launches[label] += logged["vit_launches"]

    def __enter__(self):
        from srslte_emane_tpu_torch.ops.fec import viterbi_cuda

        self._decode = decode = viterbi_cuda.viterbi_decode_cuda

        def logged(llrs, tb_iter=viterbi_cuda.TB_ITER):
            key = (llrs.shape[0], llrs.shape[2], tb_iter)
            phase = self.phase
            log_update(lambda: ViterbiLog.active is self and self.seen.update([(phase, *key)]))
            if key not in self.inputs:
                self.inputs[key] = llrs.detach().clone()
            return decode(llrs, tb_iter)

        viterbi_cuda.viterbi_decode_cuda = logged
        ViterbiLog.active = self
        return self

    def __exit__(self, *exc):
        from srslte_emane_tpu_torch.ops.fec import viterbi_cuda

        viterbi_cuda.viterbi_decode_cuda = self._decode
        ViterbiLog.active = None


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
              (turbodecoder, "turbo_decode_device"), (ue_dl, "decode_subframe"))
    with timed_calls(stages) as totals:
        ue_dl.decode_subframe(rx, cfg)
    whole = totals["ue_dl.decode_subframe"][1]
    log("DL subframe decode by stage (host clock, synchronised; nested stages count in "
        "their callers too): " + json.dumps({k: {"calls": n, "ms": 1e3 * t, "share": t / whole}
                                              for k, (n, t) in totals.items()}))
    with plain_viterbi(), timed_calls(stages) as plain:
        ue_dl.decode_subframe(rx, cfg)
    viterbi_beside("DL subframe decode", totals, plain, "ue_dl.decode_subframe", 1, "decode", card)

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

    # the waveform data plane: four UEs' bursts of 128 PDUs in shared
    # subframes (send_tti), then one UE's alone (send), graphed beside eager
    def data_plane(jit):
        dp = wavesim.WaveformDataPlane(cell, jit=jit)
        assert dp.device.type == dev.type, dp.device  # the plane's default: the card
        for r, mask, qm, _, l_aggr, start in cfg.grants:
            dp.add_ue(r, mask, qm=qm, l_aggr=l_aggr, cce_start=start)
        return dp

    nb = 4416 // 8 - 2
    bursts = [{r: [bytes(rng.integers(0, 256, int(rng.integers(1, nb + 1)), dtype=np.uint8))
                   for _ in range(BATCH)] for r in DL_SF_RNTIS} for _ in range(2)]
    pathloss = {r: 112.0 + i for i, r in enumerate(DL_SF_RNTIS)}  # 22 to 19 dB

    def send_tti(pdus):
        def call(dp):
            out = dp.send_tti(pdus, pathloss)
            assert all([got for got, _ in out[r]] == pdus[r] for r in DL_SF_RNTIS), "send_tti"
            return out
        return call

    def send(pdus):
        def call(dp):
            out = dp.send(DL_SF_RNTIS[0], pdus[DL_SF_RNTIS[0]], pathloss[DL_SF_RNTIS[0]])
            assert [got for got, _ in out] == pdus[DL_SF_RNTIS[0]], "send lost a PDU"
            return out
        return call

    launches += plane_pair(f"WaveformDataPlane.send_tti ({len(DL_SF_RNTIS)} UEs x {BATCH} PDUs, "
                           f"every PDU delivered)", data_plane, [send_tti(p) for p in bursts],
                           BATCH * len(DL_SF_RNTIS), "PDUs/s", card, control=True)
    launches += plane_pair(f"WaveformDataPlane.send (1 UE, {BATCH} PDUs, every PDU delivered)",
                           data_plane, [send(p) for p in bursts], BATCH, "PDUs/s", card,
                           control=True)
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
    with plain_map():
        plain = decode(rx)
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
              (modem, "demod_soft"), (turbodecoder, "turbo_decode_device"), (pdsch, "decode_tm"))
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

    # the four planes, each graphed beside its eager twin (plane_pair); the
    # MAP launches per decode logged from one eager call
    # MimoDataPlane: 128 PDUs = 64 TM3 subframes
    def mimo_plane(jit):
        mp = wavesim.MimoDataPlane(grid.CellConfig(n_prb=100, cell_id=7, n_ports=2, cfi=1),
                                   jit=jit)
        mp.add_ue(TM3_RNTI, mask, qm=4)
        return mp

    nb = mimo_plane(False)._sch_cfgs(1, TM3_RNTI)[0].tbs // 8 - 2
    mp_bursts = [[bytes(rng.integers(0, 256, int(rng.integers(1, nb + 1)), dtype=np.uint8))
                  for _ in range(BATCH)] for _ in range(2)]
    with launch_log() as mp_log:
        mp = mimo_plane(False)
        assert mp.send(TM3_RNTI, mp_bursts[0], pathloss_db=100.0) == mp_bursts[0], \
            "MimoDataPlane lost a PDU"
    assert not any(narrow for _, _, narrow in mp_log), "MimoDataPlane: turbo_map in bf16 mode"

    def mimo_send(pdus):
        def call(p):
            out = p.send(TM3_RNTI, pdus, pathloss_db=100.0)
            assert out == pdus, "MimoDataPlane lost a PDU"
            return out
        return call

    launches += plane_pair(f"MimoDataPlane.send ({BATCH} PDUs, {BATCH // 2} subframes, TBS "
                           f"{nb * 8 + 16} per codeword, {len(mp_log)} turbo_map launches per "
                           f"eager call, f32; every PDU delivered)", mimo_plane,
                           [mimo_send(p) for p in mp_bursts], BATCH, "PDUs/s", card)

    # MbsfnPlane: 128 PDUs to 4 receivers
    mbsfn_cell = grid.CellConfig(n_prb=100, cell_id=1)
    mbsfn_plane = lambda jit: wavesim.MbsfnPlane(mbsfn_cell, jit=jit)
    tbs_mb = mbsfn_plane(False).cfg.tbs
    nb = tbs_mb // 8 - 2
    pathloss = {rx_id: 100.0 + 5 * rx_id for rx_id in range(4)}  # 34 to 19 dB

    def mbsfn_send(pdus):
        def call(p):
            out = p.send(pdus, pathloss)
            assert out == {rx_id: pdus for rx_id in pathloss}, "MbsfnPlane lost a PDU"
            return out
        return call

    launches += plane_pair(
        f"MbsfnPlane.send ({BATCH} PDUs of TBS {tbs_mb} to 4 receivers, every PDU delivered)",
        mbsfn_plane, [mbsfn_send([bytes(rng.integers(0, 256, int(rng.integers(1, nb + 1)),
                                                   dtype=np.uint8)) for _ in range(BATCH)])
                      for _ in range(2)], BATCH, "PDUs/s", card)

    # netsim --waveform's UL plan at 100 PRB with four UEs
    ul_cell = grid.CellConfig(n_prb=100, cell_id=1, cfi=2)
    rntis = DL_SF_RNTIS
    pl = {r_: 100.0 + 2 * i for i, r_ in enumerate(rntis)}

    def control_plane(jit):
        cp = wavesim.UlControlPlane(ul_cell, jit=jit)
        for i, r_ in enumerate(rntis):
            cp.add_ue(r_, i)
        return cp

    def acks_step(acks):
        def call(p):
            out = p.step(acks, pl)
            assert all(out[r_][:2] == (True, acks[r_]) for r_ in rntis), "an ACK missed"
            return out
        return call

    plane_pair("UlControlPlane.step (4 UEs' PUCCH 1a, n_pucch 0-3, superposed; every ACK/NACK "
               "detected)", control_plane,
               [acks_step({r_: (i + j) % 2 for i, r_ in enumerate(rntis)}) for j in range(2)],
               len(rntis), "ACKs/s", card)
    ul_prb = 100 // len(rntis) - 1

    def sch_plane(jit):
        up = wavesim.UlSchPlane(ul_cell, jit=jit)
        for i, r_ in enumerate(rntis):
            up.add_ue(r_, min(i * ul_prb, 100 - ul_prb), ul_prb)
        return up

    up = sch_plane(False)
    wb = {r_: min(15, max(1, int(round((up.tx_power_dbm - pl[r_] - up.noise_floor_dbm) / 2 + 2))))
          for r_ in rntis}

    def ul_step(payload):
        sent = {r_: (payload, wb[r_]) for r_ in rntis}

        def call(p):
            out = p.step(sent, pl)
            assert all(out[r_] == (payload, True, wb[r_]) for r_ in rntis), \
                "UlSchPlane: a PUSCH or a CQI wrong"
            return out
        return call

    launches += plane_pair(f"UlSchPlane.step (4 UEs' PUSCH, {ul_prb} PRB each, with aperiodic "
                           f"CQI; payloads and wideband CQIs {sorted(wb.values())} exact)",
                           sch_plane, [ul_step(b"ul" * 6), ul_step(b"UL" * 6)], len(rntis),
                           "TBs/s", card)

    # the new shapes' kernel times beside the launches one decode makes at them
    for c in cases:
        per = [(rows, n) for (k, rows, _), n in
               collections.Counter(tm3_log + mp_log).items() if k == c["K"]]
        where = "TM3 cell decode" if c["narrow"] else "MimoDataPlane.send decode"
        log(f"turbo_map at {c['B']} x K={c['K']} {'bf16' if c['narrow'] else 'f32'}: "
            f"{1e3 * c['ms']:.1f} us (L2-flushed {1e3 * c['flushed_ms']:.1f} us), bound "
            f"{1e3 * c['bound_ms']:.2f} us ({c['bound_by']}), share {c['share']:.3f}; launches "
            f"per {where} at K={c['K']} by rows: {sorted(per, reverse=True)}; {card}")
    crowded_cases, crowded_launches = crowded_pairs(dev, card)
    return cases + crowded_cases, launches + crowded_launches


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
def replaying_awgn(record=None, replay=None, rows=slice(0, 2)):
    """channel.awgn recording `rows` (the first two by default) of each
    call's input and output into `record`, or answering each call with the
    next recorded output of `replay` on the caller's device (and checking
    its input against the recorded one), so that a run on the CPU sees the
    card's noise."""
    from srslte_emane_tpu_torch.ops import channel

    awgn, it = channel.awgn, iter(replay or ())

    def recording(gen, x, snr_db, signal_power=None):
        y = awgn(gen, x, snr_db, signal_power)
        record.append((x[rows].cpu(), y[rows].cpu()))
        return y

    def replaying(gen, x, snr_db, signal_power=None):
        x_card, y_card = next(it)
        rel = ((x.cpu() - x_card).square().mean() / x_card.square().mean()).sqrt().item()
        assert rel < 1e-5, f"card vs CPU transmit samples: relative RMS {rel}"
        return y_card.to(x.device)

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
        with plain_map():
            plain = decode(rx)
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
                      (turbodecoder, "turbo_decode_device"), (tdd_frame, "run_frame"))) as t_tdd:
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
                      (turbodecoder, "turbo_decode_device"), (multicell, "step"))) as t_mc:
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


def scan_case(dev):
    """The 64-cell scan: (its rng, n, cell ids, the (n, n) link matrix with
    one dominant neighbour per observer and the others at 0.05, the PCIs
    each observer must find)."""
    import torch

    rng = np.random.default_rng(17)
    n = 64
    scan_ids = torch.from_numpy(rng.choice(504, n, replace=False)).to(dev)
    gm = 0.05 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    gm[np.arange(n), (np.arange(n) + 1) % n] = 1.0  # one dominant neighbour per observer
    want = scan_ids[(torch.arange(n, device=dev) + 1) % n].to(torch.int32)
    return rng, n, scan_ids, gm.astype(np.complex64), want


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
    rng, n, scan_ids, gm, want = scan_case(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
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


# the CUDA API calls (cuda* and cu*) with which the host enqueues work on the card
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


# the port's kernels on the dynamic block's path, as kernel_counts names
# them, and their names on the card (csrc/*.cu)
PORT_KERNELS = dict(turbo_map="map_kernel", turbo_iter="iter_kernel", arm="arm_kernel",
                    viterbi="viterbi_kernel")


def profile_block(fn, control=False):
    """One call of fn under torch.profiler (after a synchronise): the
    device time (the CUDA kernels' own time), the kernel launches, the busy
    share (device time over the profiled wall time, which includes the
    profiler's overhead: a lower bound), turbo_map's and the Viterbi
    kernel's device time, the host's launches (its calls of
    HOST_LAUNCH_CALLS: a CUDA graph's replay is one, however many kernels
    it runs) and the runs on the card of each of PORT_KERNELS.  Fails if the profiler recorded no device kernel, or, where
    fn decodes control channels (`control`), no Viterbi kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()  # aggregated once, for every count below
    kernels = [e for e in averages
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    assert kernels, "torch.profiler recorded no device kernel"
    vit = [e for e in kernels if "viterbi_kernel" in e.key]
    assert vit or not control, "torch.profiler recorded no Viterbi kernel"
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    map_ms = sum(e.self_device_time_total for e in kernels if "map_kernel" in e.key) / 1e3
    vit_ms = sum(e.self_device_time_total for e in vit) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    host = sum(e.count for e in averages if e.key in HOST_LAUNCH_CALLS)
    ran = collections.Counter()
    for e in averages:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for name, kernel in PORT_KERNELS.items():
                ran[name] += e.count if re.search(rf"\b{kernel}\b", e.key) else 0
    return dict(profiled_wall_ms=round(wall_ms, 3), device_ms=round(device_ms, 3),
                busy_share=round(device_ms / wall_ms, 4), host_launches=host,
                port_kernels=dict(ran),
                kernel_launches=sum(e.count for e in kernels), turbo_map_ms=round(map_ms, 3),
                viterbi_ms=round(vit_ms, 3),
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
    """Phase 11.1/11.2: the SPS block at T=160 (SISO, or TM3 with 2 ports):
    the eager block's first call (its noise recorded) against the CPU, then
    the graphed block (make_block_step's default on the card) against the
    eager one at tti0 0 and 37 on other payloads, both in turns, and the
    graphed bench step.  Returns (turbo_map launches of the eager block and
    the graph's calls, launch log of the first block)."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc
    from srslte_emane_tpu_torch.runtime import waveblock

    name = "SPS block TM3" if tm3 else "SPS block"
    cfg = sps_config(SPS_T, tm3)
    n, T = cfg.n_ues, cfg.T
    n_cw = 2 if tm3 else 1

    def payloads(seed):
        rng = np.random.default_rng(seed)
        dl_shape = (T, n) + ((2,) if tm3 else ()) + (cfg.dl_tbs,)
        return (torch.from_numpy(rng.integers(0, 2, dl_shape, dtype=np.int8)).to(dev),
                torch.from_numpy(rng.integers(0, 2, (T, n, cfg.ul_tbs), dtype=np.int8)).to(dev))

    dl, ul = payloads(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    steps = dict(graph=waveblock.make_block_step(cfg, sfn0=4),  # the card: the entry point's default
                 eager=waveblock.make_block_step(cfg, sfn0=4, jit=False))
    bench = waveblock.make_bench_step(cfg, sfn0=4)
    build_s = time.perf_counter() - t0

    def right(out, args=(dl, ul)):
        return (bool(out["dl_ok"].all()) and bool(out["ul_ok"].all())
                and (not tm3 or bool(out["dl_ok_cw"].all()))
                and int((out["ack_energy"] > 1e-2).sum()) == T * n
                and torch.equal(out["dl_out"], args[0].reshape(T, n, -1))
                and torch.equal(out["ul_out"], args[1]))

    record = []
    torch.cuda.reset_peak_memory_stats()
    with launch_log() as seen, recorded_noise(record=record):
        tdc.launches = 0
        t0 = time.perf_counter()
        out = steps["eager"](dl, ul, gen, 0)
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

    # the graph (one capture, tti0 and the payloads its inputs) against the
    # eager block at two TTIs, then both in turns
    graph_first_s, graph_launches = graph_against_eager(
        f"{name} graph", steps, [(dl, ul, 0), (*payloads(1), 37)],
        lambda step, a, g: step(a[0], a[1], g, a[2]), lambda out, a: right(out, a))
    (graph,) = steps["graph"].graphs.values()
    log(f"{name} graph: equals the eager block bit for bit at tti0 0 and 37 on other payloads "
        f"(bits, CRC flags, ack_energy, ack_val, generator states, MAP rows, launches "
        f"{json.dumps(dict(graph_launches))} over the two calls); first call (warm-up, capture, "
        f"one replay) {graph_first_s:.2f} s; {len(graph.tables)} cached tables held")
    s = graph_turns(f"{name} graph (phase 11)", steps, lambda step: step(dl, ul, seeded(7), 0),
                    T, "TTIs/s", card)
    assert s["graph"]["host_launches"] <= 16, s["graph"]
    log(f"{name} graph: TTIs/s x {s['graph']['rate'] / s['eager']['rate']:.2f}, host launches "
        f"{s['graph']['host_launches']} vs {s['eager']['host_launches']}, busy share "
        f"{s['graph']['busy_share']} vs {s['eager']['busy_share']}, device ms "
        f"{s['graph']['device_ms']} vs {s['eager']['device_ms']}; {card}")

    counts = lambda: bench(dl, ul, gen, 0)
    (med, spread, rates), ev_ms = block_timing(counts, T)
    assert [int(x) for x in counts()] == [T * n * n_cw, T * n, T * n]
    prof = profile_block(lambda: steps["graph"](dl, ul, gen, 0))
    log(f"{name}: {fmt_rate('block', med, spread, rates, unit='TTIs/s')} (the graphed bench "
        f"step); DL {med * n * n_cw * cfg.dl_tbs / 1e6:.1f} Mb/s + UL "
        f"{med * n * cfg.ul_tbs / 1e6:.1f} Mb/s; CUDA-event time per block {ev_ms:.2f} ms; "
        f"profile of one graphed block {json.dumps(prof)}; {card}")
    if not tm3:
        sweep = {}
        for depth in SPS_DEPTHS:
            c = sps_config(depth)
            b = waveblock.make_bench_step(c, sfn0=4)
            d, u = dl[:depth], ul[:depth]
            sweep[depth] = rate(lambda: b(d, u, gen, 0), per_call=depth, iters=1,
                                check=lambda o: int(o[0]) == depth * n)[0]
        log(f"{name} depth sweep (TTIs/s by T, graphed bench step, median of {N_RUNS}): "
            f"{json.dumps({k: round(v, 1) for k, v in sweep.items()})}; {card}")
    return launches + graph_launches["turbo_map"], seen


def dyn_block_right(o, dl_q, ul_q, rb_dl):
    """A clean-channel dynamic block's gate: every DL and UL CRC and ACK, no
    DCI miss, the UE followed every RIV, the delivered TBs equal the queues
    in order."""
    import torch

    T, n = dl_q.shape[:2]
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


def step_dyn(dev, card):
    """Phase 11.3: the dynamic block at R=20, on the card's default path
    (one round captured as a CUDA graph, R replays), its noise recorded
    from the eager block (jit=False: a capture draws no noise on the
    host), which the graph equals bit for bit.  Returns (turbo_map launches
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
    t0 = time.perf_counter()
    step = wbd.make_dyn_block_step(cfg)  # the card and the graph: the entry point's defaults
    eager = wbd.make_dyn_block_step(cfg, jit=False)  # the plain version
    bench = wbd.make_bench_step(cfg)
    build_s = time.perf_counter() - t0
    args = (dl_q, ul_q, rb_dl, rb_ul)

    def gen(seed=0):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    right = lambda o: dyn_block_right(o, dl_q, ul_q, rb_dl)

    record = []
    torch.cuda.reset_peak_memory_stats()
    with recorded_noise(record=record):
        tdc.launches = 0
        t0 = time.perf_counter()
        out_eager = eager(*args, gen(), 0)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        eager_launches = tdc.launches
    peak = torch.cuda.max_memory_allocated()
    with launch_log() as seen:
        t0 = time.perf_counter()
        step(*args, gen(), 0)  # warm-up round, capture, R replays
        torch.cuda.synchronize()
        graph_s = time.perf_counter() - t0
        del seen[:]
        tdc.launches = 0
        out = step(*args, gen(), 0)  # the graph: R replays
        torch.cuda.synchronize()
        launches = tdc.launches
    assert all(v.device.type == "cuda" for v in out.values()), "a block output left the card"
    assert launches > 0, "dynamic block: no turbo_map launch"
    assert launches == eager_launches == len(seen), (
        f"dynamic block: turbo_map launches, graph {launches}, eager {eager_launches}, "
        f"logged {len(seen)}")
    for k, v in out_eager.items():
        assert torch.equal(out[k], v), f"dynamic block: the graph and the eager block differ at {k}"
    assert right(out), (
        f"dynamic block: DL {int(out['dl_ok'].sum())}, UL {int(out['ul_ok'].sum())}, ACK "
        f"{int(out['ack_det'].sum())} of {T * n}, DCI misses {int(out['dci_dl_miss'])} + "
        f"{int(out['dci_ul_miss'])}, RBs followed {bool(torch.equal(out['rb_ue'], rb_dl.long()))}")
    log(f"dynamic block: 100 PRB, 8 UEs (RNTIs {list(cfg.rntis)}), R={DYN_R} ({T} TTIs), DL 11 PRB "
        f"MCS 25 (TBS {cfg.dl_tbs}, 2 code blocks), UL 10 PRB MCS 20 (TBS {cfg.ul_tbs}), 30 dB: "
        f"every DL and UL CRC and ACK, no DCI miss, the UE followed every decoded RIV, the "
        f"delivered TBs equal the queues in order; the graph (first call: warm-up, capture, "
        f"{DYN_R} replays, {graph_s:.2f} s) equals the eager block bit for bit; {launches} "
        f"turbo_map launches in the graph's second call, as many as the eager block's "
        f"{sorted(set(seen))} (K, rows, bf16); eager first call "
        f"{first_s:.2f} s, tables {build_s:.2f} s; eager peak memory {peak / 2**20:.1f} MiB")

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

    counts = lambda: bench(*args, gen(), 0)
    (med, spread, rates), event_ms = block_timing(counts, T)
    assert [int(x) for x in counts()] == [T * n, T * n, T * n, 0, 0, 0]
    stages = ((ofdm, "modulate"), (ofdm, "demodulate"), (convcoder, "rate_unmatch_cc"),
              (viterbi, "viterbi_decode"), (sch, "encode_tb"), (sch, "decode_tb"),
              (turbodecoder, "turbo_decode_device"), (wbd, "_scatter_rows"))
    whole = "waveblock_dyn.step"
    with timed_calls(stages) as totals:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager(*args, gen(), 0)
        torch.cuda.synchronize()
        totals[whole] = [1, time.perf_counter() - t0]
    per_round = {k: {"calls_per_round": n_ / DYN_R, "ms_per_round": round(1e3 * t / DYN_R, 3),
                     "share": round(t / totals[whole][1], 3)} for k, (n_, t) in totals.items()}
    with plain_viterbi(), timed_calls(stages) as plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager(*args, gen(), 0)
        torch.cuda.synchronize()
        plain[whole] = [1, time.perf_counter() - t0]
    prof = profile_counted(lambda: step(*args, gen(), 0), "dynamic block (the graph)")
    log(f"dynamic block (the graph): {fmt_rate('block', med, spread, rates, unit='TTIs/s')}; DL "
        f"{med * n * cfg.dl_tbs / 1e6:.1f} Mb/s + UL {med * n * cfg.ul_tbs / 1e6:.1f} Mb/s; "
        f"CUDA-event time per block {event_ms:.2f} ms; profile of one block {json.dumps(prof)}; {card}")
    log(f"dynamic block by stage, per round, of the eager block (jit=False; host clock, "
        f"synchronised at every stage: a breakdown, not a rate; the Viterbi's share is "
        f"viterbi.viterbi_decode's): {json.dumps(per_round)}")
    viterbi_beside("dynamic block (eager)", totals, plain, whole, DYN_R, "round", card)
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


def waveform_network(pathloss=NET_PATHLOSS, n_prb=NET_PRB, n_ues=NET_UES, cfi=NET_CFI, **kw):
    """apps/netsim.py:run_waveform_full's network: 8 UEs with IMSIs
    0010100000000xx and preambles (7 + i) % 64, pathloss 80 dB, seed 0, at
    cfi NET_CFI, on the card (the entry point's default); `kw` are netsim's
    other WaveformNetwork options, and jit=False (the eager stages)."""
    from srslte_emane_tpu_torch.epc import hss as hss_mod, mme as mme_mod, spgw as spgw_mod
    from srslte_emane_tpu_torch.runtime import wavenet
    from srslte_emane_tpu_torch.stack import enb_stack, security, ue_stack

    hss = hss_mod.Hss()
    spgw = spgw_mod.Spgw()
    mme = mme_mod.Mme(hss, spgw)
    enb = enb_stack.EnbStack(mme, enb_id=1, n_prb=n_prb)
    ues = []
    for i in range(n_ues):
        imsi = f"0010100000000{i:02d}"
        key = bytes(range(16))
        hss.add(hss_mod.Subscriber(imsi=imsi, key=key))
        opc = security.milenage_opc(key, b"\x00" * 16)
        ues.append(ue_stack.UeStack(ue_stack.Usim(imsi, key, opc), preamble=(7 + i) % 64))
    net = wavenet.WaveformNetwork(enb, ues, pathloss_db=np.full(n_ues, pathloss),
                                  n_prb=n_prb, seed=0, cfi=cfi, **kw)
    assert net.device.type == "cuda" and net.medium._gen.device.type == "cuda"
    return net, ues, spgw, spgw_mod


def network_stages():
    """(module or class, function) pairs of one host-paced TTI for timed_calls."""
    from srslte_emane_tpu_torch.ops.fec import turbodecoder, viterbi
    from srslte_emane_tpu_torch.runtime import wavenet as wn

    return ((wn.WaveformNetwork, "run"), (wn.WaveEnbPhy, "_rx"), (wn.WaveEnbPhy, "_tx"),
            (wn.WaveMedium, "dl_take_all"), (wn._CellKernels, "rx_front", "stage"),
            (wn._CellKernels, "blind_all", "stage"), (viterbi, "viterbi_decode"),
            (wn.WaveUePhy, "_camp_rx_row"), (wn._CellKernels, "pdsch_rx", "stage"),
            (wn._CellKernels, "pusch_rx", "stage"), (wn.WaveUePhy, "_tx"),
            (turbodecoder, "turbo_decode_device"))


def stage_table(totals, ttis):
    """timed_calls' totals of a network run of `ttis` TTIs, per TTI, with
    each stage's share of WaveformNetwork.run."""
    return {k: {"calls_per_tti": n / ttis, "ms_per_tti": round(1e3 * t / ttis, 3),
                "share": round(t / totals["WaveformNetwork.run"][1], 3)}
            for k, (n, t) in totals.items()}


TURN_TTIS, TURN_PROFILED = 20, 5  # per turn of phase 12: timed TTIs, then profiled ones


class SeededUrandom:
    """The HSS's `os` for a NetworkPair: os.urandom (its RAND) as one seeded
    stream per network (`use` picks the one drawing), so that both networks
    of the pair draw the same bytes."""

    def __init__(self, seed=0):
        self.seed, self.rngs, self.cur = seed, {}, None

    def use(self, key):
        self.rngs.setdefault(key, np.random.default_rng(self.seed))
        self.cur = key

    def urandom(self, n):
        return self.rngs[self.cur].bytes(n)


def graph_pool_mib():
    """MiB of the card's memory held in CUDA graphs' private pools."""
    import torch

    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)) / 2**20


class NetworkPair:
    """waveform_network(**kw) twice on the card: graphed (every _CellKernels
    stage a CUDA graph, the entry point's default) and eager (jit=False),
    driven TTI by TTI in lockstep by `run`: every TTI the DL samples that
    the eNB sends (WaveMedium.dl_put) and the UL samples it receives
    (ul_take) of the two must be equal bit for bit, and so must the UEs'
    EMM/RRC states and IP addresses and every PHY metrics dict.  The HSS's
    RAND comes from one seeded stream per network.  Stands in for the
    graphed network where NetworkRun drives one; `sides` holds both
    (net, ues, spgw, spgw_mod), `True` the graphed."""

    def __init__(self, **kw):
        from srslte_emane_tpu_torch.epc import hss

        self._hss, self._os = hss, hss.os
        self.fake = hss.os = SeededUrandom()
        self.sides, self.rec, self.recording = {}, {}, True
        self.compared = collections.Counter()
        for jit in (True, False):
            self.fake.use(jit)
            self.sides[jit] = waveform_network(jit=jit, **kw)
            self.rec[jit] = self._hook(self.sides[jit][0].medium, [])

    def _hook(self, medium, rec):
        dl_put, ul_take = medium.dl_put, medium.ul_take

        def put(tti, samples):
            if self.recording:
                rec.append(("DL", tti, samples.clone()))
            return dl_put(tti, samples)

        def take():
            out = ul_take()
            if out is not None and self.recording:
                rec.append(("UL", out[2], out[0].clone()))
            return out

        medium.dl_put, medium.ul_take = put, take
        return rec

    def close(self):
        self._hss.os = self._os

    def __getattr__(self, name):  # the graphed network's tti, enb, ues, medium, kern
        return getattr(self.sides[True][0], name)

    def state(self, jit):
        net, ues, spgw, _ = self.sides[jit]
        return ([(u.emm_state, u.rrc_state, u.ip_addr) for u in ues], net.enb.metrics,
                [u.metrics for u in net.ues], [u.state for u in net.ues],
                [list(u.gw_rx) for u in ues], spgw.metrics)

    def use(self, jit):
        """The network `jit` runs next (its HSS stream)."""
        self.fake.use(jit)
        return self.sides[jit][0]

    def run(self, n):
        import torch

        for _ in range(n):
            for jit in (True, False):
                self.rec[jit].clear()
                self.use(jit).run(1)
            a, b = self.rec[True], self.rec[False]
            tti = self.sides[True][0].tti - 1
            assert [x[:2] for x in a] == [x[:2] for x in b], (tti, [x[:2] for x in a],
                                                              [x[:2] for x in b])
            for (kind, t, x), (_, _, y) in zip(a, b):
                assert torch.equal(x, y), f"TTI {tti}: the {kind} samples of TTI {t} differ"
                self.compared[kind] += 1
            assert self.state(True) == self.state(False), f"TTI {tti}: the states differ"

    def check_equal(self, label):
        """The pair's states, delivered packets and metrics equal (after
        runs outside the lockstep)."""
        assert self.state(True) == self.state(False), f"{label}: the pair's states differ"

    def log_lockstep(self, label, card):
        log(f"{label}: graphed == eager (jit=False) bit for bit at every TTI of "
            f"{self.sides[True][0].tti} in lockstep: {self.compared['DL']} DL and "
            f"{self.compared['UL']} UL sample tensors, the UEs' states, every metrics dict, "
            f"the delivered packets; {card}")

    def turns(self, offer, card, ttis=TURN_TTIS):
        """Both networks in turns (graphed, eager, graphed, eager) after two
        unreported turns each (which capture most of the traffic's keys),
        each turn after `offer(net, ues, spgw, spgw_mod)`: sf/s and
        CUDA-event ms per TTI over `ttis` TTIs, then, after a second offer,
        a profile of TURN_PROFILED more (profile_counted: host launches,
        device ms, busy share, the launch counts against the card's runs),
        the graphs built in the turn and their build seconds, the turn's
        peak allocated MiB and the graph pools' MiB.  Returns {jit: [each
        turn's numbers]}."""
        import torch

        from srslte_emane_tpu_torch.runtime import graphs

        self.recording, out = False, {True: [], False: []}
        for jit in (True, False, True, False):
            offer(*self.sides[jit])
            self.use(jit).run(ttis + TURN_PROFILED)
        for jit in (True, False, True, False):
            net, ues, spgw, spgw_mod = self.sides[jit]
            self.use(jit)
            offer(net, ues, spgw, spgw_mod)
            built = dict(graphs.STATS)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            net.run(ttis)
            end.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            offer(net, ues, spgw, spgw_mod)
            prof = profile_counted(lambda: net.run(TURN_PROFILED),
                                   f"{'graphed' if jit else 'eager'} network turn")
            n = TURN_PROFILED
            row = dict(sf_per_s=round(ttis / wall, 2),
                       event_ms_per_tti=round(start.elapsed_time(end) / ttis, 3),
                       host_launches_per_tti=prof["host_launches"] / n,
                       kernel_launches_per_tti=prof["kernel_launches"] / n,
                       device_ms_per_tti=round(prof["device_ms"] / n, 3),
                       busy_share=prof["busy_share"],
                       graphs_built=graphs.STATS["graphs"] - built["graphs"],
                       build_s=round(graphs.STATS["build_s"] - built["build_s"], 3),
                       peak_allocated_mib=round(torch.cuda.max_memory_allocated() / 2**20, 1),
                       graph_pools_mib=round(graph_pool_mib(), 1))
            out[jit].append(row)
            log(f"network turn, {'graphed' if jit else 'eager (jit=False)'}: {json.dumps(row)}; "
                f"{card}")
        self.recording = True
        self.check_equal("after the turns")
        return out


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
            f"{attach_s:.1f} s ({net.tti / attach_s:.1f} sf/s during the attach, its graph "
            f"captures and first calls' host tables included); {tdc.launches} turbo_map launches; eNB "
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

    def stages_and_profile(self, pair, offer, extra_stages=()):
        """Where a host-paced TTI with traffic goes (synchronised at every
        stage: a breakdown, not a rate; nested calls count in both): in the
        graphed network of `pair` (its _CellKernels stages are their graphs'
        replays), then in the eager one with the Viterbi kernel and with
        viterbi_decode_ref forced (the stages' Python runs there); then the
        device profile of 5 graphed TTIs, its launch counts held to the
        card's runs.  `offer(jit)` queues the traffic on that network before
        each.  Ends the lockstep: the two networks part here."""
        from srslte_emane_tpu_torch.runtime import graphs

        stages = network_stages() + tuple(extra_stages)
        pair.recording, tables = False, []
        for jit, plain in ((True, False), (False, False), (False, True)):
            offer(jit)
            with plain_viterbi() if plain else contextlib.nullcontext(), \
                    timed_calls(stages) as totals:
                pair.use(jit).run(10)
            tables.append(totals)
        log(f"{self.name} by stage, graphed, per host-paced TTI (traffic offered just before; "
            f"the stages are their graphs' replays): {json.dumps(stage_table(tables[0], 10))}")
        log(f"{self.name} by stage, eager (jit=False), per host-paced TTI: "
            f"{json.dumps(stage_table(tables[1], 10))}")
        viterbi_beside(f"{self.name}, eager", tables[1], tables[2], "WaveformNetwork.run", 10,
                       "TTI", self.card)
        offer(True)
        # the profiler's summary costs seconds per TTI
        built = graphs.STATS["graphs"]
        prof = profile_counted(lambda: pair.use(True).run(5), f"{self.name}, graphed")
        log(f"{self.name}, graphed, profile of 5 host-paced TTIs with traffic: "
            f"{json.dumps(prof)}; per TTI: device {prof['device_ms'] / 5:.3f} ms, "
            f"{prof['kernel_launches'] / 5:.0f} kernel launches, {prof['host_launches'] / 5:.0f} "
            f"host launches, busy share {prof['busy_share']:.4f}; "
            f"{graphs.STATS['graphs'] - built} graphs built in them (a build's warm-up runs "
            f"the stage eagerly); {self.card}")


def run_runner(runner, launch_seen):
    """One untimed block (its launches logged; the dynamic block's first
    call also warms and captures its round), then 2 timed ones.  Returns
    (TTIs/s, turbo_map launches per timed block)."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc

    with launch_seen():
        runner.run_block()
        torch.cuda.synchronize()
    tdc.launches = 0
    t0 = time.perf_counter()
    for _ in range(2):
        runner.run_block()
    torch.cuda.synchronize()
    rate_ = 2 * runner.cfg.T / (time.perf_counter() - t0)
    return rate_, tdc.launches // 2


def every_map_shape(logs, known):
    """The (K, rows, modes) of every turbo_map launch in `logs` not already
    in `known`, at every row count (the decoder's straggler stages too)."""
    seen = {(k, b, n) for k, b, modes in known for n in modes}
    return tuple((k, r, (n,)) for k, r, n in sorted(set(logs)) if (k, r, n) not in seen)


def map_cases_logged(logs, known, dev, phase, card, select=new_map_shapes):
    """turbo_map against its plain version at every shape that `select`
    picks from `logs` and `known`, each with its launches in the phase."""
    cases = map_cases(select(logs, known), dev)
    for c in cases:
        n_launch = sum(1 for k, r, nw in logs if (k, r, nw) == (c["K"], c["B"], c["narrow"]))
        log(f"turbo_map at {c['B']} x K={c['K']} {'bf16' if c['narrow'] else 'f32'}: "
            f"{1e3 * c['ms']:.1f} us (L2-flushed {1e3 * c['flushed_ms']:.1f} us, wrapper "
            f"{1e3 * c['wrapper_ms']:.1f} us, plain {1e3 * c['plain_ms']:.1f} us), bound "
            f"{1e3 * c['bound_ms']:.3f} us ({c['bound_by']}), share {c['share']:.4f}, bit for "
            f"bit; launches at this shape in phase {phase}: {n_launch}; {card}")
    return cases


def pair_traffic(pair, ues_of=lambda side: side[1], **kw):
    """NetworkRun.traffic offered alike to both networks of `pair` (to the
    UEs that `ues_of` picks of each side).  Returns the graphed side's
    packets."""
    for jit in (False, True):
        side = pair.sides[jit]
        pkts = NetworkRun.traffic(ues_of(side), side[2], side[3], **kw)
    return pkts


def graphs_by_stage(kern, card, label):
    """Logs how many graphs each stage key of `kern` captured, by stage,
    and holds the position-free stages to one graph per key: add_dl_grant,
    pdsch_rx, pusch_tx(_cqi), pusch_rx(_cqi) are keyed by widths, MCS and
    RE counts alone, so a graph per sf or rb_start would show as a key with
    several.  Returns the total."""
    counts = kern.graph_counts()
    by = collections.defaultdict(lambda: [0, 0])
    for key, n in counts.items():
        by[key[0]][0] += 1
        by[key[0]][1] += n
    free = ("add_dl_grant", "pdsch_rx", "pusch_tx", "pusch_tx_cqi", "pusch_rx", "pusch_rx_cqi")
    several = {k: n for k, n in counts.items() if k[0] in free and n != 1}
    assert not several, f"{label}: position-free stage keys with other than one graph {several}"
    log(f"{label}: graphs by stage [keys, graphs] {json.dumps(dict(sorted(by.items())))}, "
        f"{sum(counts.values())} in all; each key of {', '.join(free)} one graph (keyed by "
        f"width, MCS and RE count: sf, rb_start, rnti and cce_start are inputs); {card}")
    return sum(counts.values())


def phase_network(dev, card):
    """Phase 12.  Returns (the turbo_map cases at its new shapes, its
    launches: the lockstep (both networks) and the turns, plus one block of
    each runner)."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc
    from srslte_emane_tpu_torch.runtime import graphs, waveblock, waveblock_dyn

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    before = dict(graphs.STATS)
    pair = NetworkPair()
    net, ues, spgw, spgw_mod = pair.sides[True]
    logs = []
    run = NetworkRun("network (graphed beside eager, in lockstep)", card, logs)
    try:
        run.attach(pair, ues)
        log(f"network attach, both networks: {graphs.STATS['graphs'] - before['graphs']} graphs "
            f"built in {graphs.STATS['build_s'] - before['build_s']:.1f} s (warm-up and capture) "
            f"by the graphed network; peak allocated "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, graph pools "
            f"{graph_pool_mib():.0f} MiB; {card}")
        pkts = pair_traffic(pair)
        steady_launches = run.paced(pair, ues, spgw, [(pkts, 4)])
        pair.check_equal("network steady state")
        pair.log_lockstep("network", card)
        turns = pair.turns(lambda n, u, sp, sm: NetworkRun.traffic(u, sp, sm), card)
        med = lambda jit, k: statistics.median(r[k] for r in turns[jit])
        log(f"network turns, graphed vs eager (median of 2 turns each): sf/s "
            f"{med(True, 'sf_per_s')} vs {med(False, 'sf_per_s')}, CUDA-event ms per TTI "
            f"{med(True, 'event_ms_per_tti')} vs {med(False, 'event_ms_per_tti')}, host launches "
            f"per TTI {med(True, 'host_launches_per_tti')} vs "
            f"{med(False, 'host_launches_per_tti')}, device ms per TTI "
            f"{med(True, 'device_ms_per_tti')} vs {med(False, 'device_ms_per_tti')}, busy share "
            f"{med(True, 'busy_share')} vs {med(False, 'busy_share')}; {card}")
        graphs_by_stage(pair.kern, card, "network")
        run.stages_and_profile(pair, lambda jit: NetworkRun.traffic(*pair.sides[jit][1:]))
        turn_launches = tdc.launches - steady_launches
    finally:
        pair.close()
    del pair

    # the block runners on the attached graphed network
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
    return cases, steady_launches + turn_launches + sps_launches + dyn_launches


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


PAIR_TTIS = STEADY_TTIS  # phase 13's host-paced TTIs in lockstep


def step_net_impaired(card, logs):
    """Phase 13a.  Returns its turbo_map launches."""
    from srslte_emane_tpu_torch.ops import fading
    from srslte_emane_tpu_torch.runtime import wavenet as wn

    pair = NetworkPair(**IMPAIRMENTS)
    net, ues, spgw, _ = pair.sides[True]
    name = "impaired network (EPA 5 Hz, dynamic delay 0.2-1.5 us, HST 40 Hz)"
    run = NetworkRun(name, card, logs)
    try:
        run.attach(pair, ues)
        pkts = pair_traffic(pair)
        launches = run.paced(pair, ues, spgw, [(pkts, 4)], ttis=PAIR_TTIS)
        pair.log_lockstep(name, card)
        graphs_by_stage(pair.kern, card, name)
        run.stages_and_profile(pair, lambda jit: NetworkRun.traffic(*pair.sides[jit][1:]),
                               ((wn.WaveMedium, "_impair"), (fading, "apply_fading")))
    finally:
        pair.close()
    return launches


def step_net_tdd(card, logs):
    """Phase 13b.  Returns its turbo_map launches."""
    from srslte_emane_tpu_torch.phch import tdd

    pair = NetworkPair(tdd_config=TDD_CFG, ss_config=4)
    net, ues, spgw, _ = pair.sides[True]
    name = f"TDD network (configuration {TDD_CFG}, special subframe 4)"
    run = NetworkRun(name, card, logs)
    off_u, s_ok = [], [0]

    def ul_put(tti, ue_idx, samples, is_prach=False):
        if tdd.sf_type(TDD_CFG, tti % 10) != "U":
            off_u.append((tti, ue_idx))

    def tb_decoded(tti, payload, *a, **kw):
        s_ok[0] += payload is not None and tdd.sf_type(TDD_CFG, tti % 10) == "S"

    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(wrapped(net.medium, "ul_put", before=ul_put))
            for u in ues:
                stack.enter_context(wrapped(u, "tb_decoded", before=tb_decoded))
            run.attach(pair, ues)
            pkts = pair_traffic(pair)
            launches = run.paced(pair, ues, spgw, [(pkts, 4)], ttis=PAIR_TTIS)
        assert not off_u, f"TDD: UE transmissions off U subframes (tti, UE): {off_u[:8]}"
        assert s_ok[0] >= 1, "TDD: no TB decoded in a special subframe"
        log(f"TDD network: no UE transmission off a U subframe; {s_ok[0]} TBs decoded in S "
            f"subframes (DwPTS 12 symbols) over the attach and the steady state; eNB "
            f"{json.dumps(net.enb.metrics)}; {card}")
        pair.log_lockstep(name, card)
        graphs_by_stage(pair.kern, card, name)
        run.stages_and_profile(pair, lambda jit: NetworkRun.traffic(*pair.sides[jit][1:]))
    finally:
        pair.close()
    return launches


def mib_decodable(net):
    """Per UE of a MIMO network: does its antenna 0 decode the MIB of a
    noise-free subframe 0 through its 2x2 matrix?  The eNB sends the PBCH
    from port 0 alone with the 2-port CRC mask, which the UE checks on its
    SFBC (ports 0 and 1) hypothesis only (the reference's pbch.encode and
    decode): where the antenna hears port 1 well above port 0 that
    combination fails and the UE never leaves SFN_SYNC."""
    import torch

    from srslte_emane_tpu_torch.ops import cplx
    from srslte_emane_tpu_torch.phch import pbch

    k = net.kern
    mib = np.asarray(pbch.pack_mib(NET_PRB, 0))[None].astype(np.int8)
    tx = k.modulate()(torch.cat([k.base_grid(0, 0)(mib), k.base_grid_p1(0)]))  # (2 ports, T, 2)
    y = cplx.mul(net.medium.mimo_h[:, 0, :, None, :], tx[None]).sum(1)  # each UE's antenna 0
    return [bool(x) for x in k.pbch_rx()(k.demodulate()(y))[3].cpu()]


def step_net_tm3(card, logs):
    """Phase 13c.  Returns its turbo_map launches."""
    from srslte_emane_tpu_torch.runtime import wavenet as wn

    pair = NetworkPair(pathloss=TM3_PATHLOSS, mimo=True, mimo_cond=list(TM3_COND))
    net, ues, spgw, _ = pair.sides[True]
    name = f"TM3 network (2x2, ratio {TM3_COND[0]} for UEs 0-5, {TM3_COND[-1]} for 6-7)"
    run = NetworkRun(name, card, logs)
    can = [i for i, ok in enumerate(mib_decodable(net)) if ok]
    h = net.medium.mimo_h.cpu().numpy()
    gain = lambda p: [round(float(10 * np.log10((h[u, 0, p] ** 2).sum())), 1) for u in range(NET_UES)]
    log(f"TM3 network: antenna 0's gain from port 0 by UE {gain(0)} dB, from port 1 {gain(1)} "
        f"dB; UEs that decode a noise-free MIB (the PBCH rides port 0 alone): {can}; {card}")
    assert len(can) >= NET_UES - 2, can
    cws = collections.Counter()

    def tm3_rx(fn):
        def rx(*a):
            out = fn(*a)
            cws["grants"] += 1
            cws["both"] += bool(out[2][0]) and bool(out[3][0])
            return out
        return rx

    camped = [ues[i] for i in can]
    camped_of = lambda side: [side[1][i] for i in can]
    macs = [pair.sides[jit][0].enb.mac for jit in (True, False)]
    enb = macs[0]
    ri_of = lambda: {r: getattr(u, "ri", None) for r, u in sorted(enb.ues.items())}
    factory = net.kern.pdsch_rx_tm3
    net.kern.pdsch_rx_tm3 = lambda *key: tm3_rx(factory(*key))  # the graphed network's
    try:
        run.attach(pair, ues, expect=can)
        assert [i for i, u in enumerate(net.ues) if u.state == "CAMP"] == can
        pair.run(wn.WaveUePhy.RI_PERIOD)  # every camped UE probes its rank once
        ri_ue = {net.ues[i].stack.crnti: net.ues[i]._ri for i in can}
        want = {net.ues[i].stack.crnti: 2 if TM3_COND[i] > 0.3 else 1 for i in can}
        assert ri_ue == want, f"TM3: RI probes {ri_ue}, want {want}"
        assert enb.metrics.get("ri_reports", 0) > 0, enb.metrics
        ri_shared = ri_of()
        # the eNB reads each format-2 report on every UE's resource of the
        # PRB pair, so the last report of an RI window sets every UE's rank
        # (the reference's adjudication); for the traffic each RI report
        # reaches the MAC with its own UE's rank, as a per-UE read would
        for mac in macs:
            cqi_info = mac.cqi_info
            mac.cqi_info = lambda tti, rnti, cqi, ri=None, _c=cqi_info, **kw: _c(
                tti, rnti, cqi, ri=None if ri is None else ri_ue.get(rnti, ri), **kw)
            for rnti, ri in ri_ue.items():
                mac.cqi_info(net.tti, rnti, None, ri=ri)
        # phase 12's packets, then a burst that one TB (1,500 bytes at
        # most) cannot carry, so that the scheduler opens a second codeword
        pkts = pair_traffic(pair, camped_of)
        burst = pair_traffic(pair, camped_of, size=1000, n_dl=3)
        launches = run.paced(pair, camped, spgw, [(pkts, 4), (burst, 3)], ttis=PAIR_TTIS)
        n_tm3 = net.enb.metrics.get("tm3_tx", 0)
        assert ri_of() == ri_ue, (ri_of(), ri_ue)
        assert n_tm3 > 0 and cws["grants"] > 0 and cws["both"] > 0, (n_tm3, dict(cws))
        log(f"TM3 network: RI probed by each camped UE (by RNTI) {json.dumps(ri_ue)}; eNB RI "
            f"reports {enb.metrics['ri_reports']}; the eNB's RI per RNTI after the shared "
            f"format-2 reads {json.dumps(ri_shared)}, with per-UE RI reports "
            f"{json.dumps(ri_of())}; rank-2 grants sent {n_tm3}, decoded {cws['grants']}, both "
            f"codewords right {cws['both']}; eNB {json.dumps(net.enb.metrics)}; {card}")
        pair.log_lockstep(name, card)
        graphs_by_stage(pair.kern, card, name)
        run.stages_and_profile(
            pair, lambda jit: NetworkRun.traffic(camped_of(pair.sides[jit]),
                                                 *pair.sides[jit][2:], size=1000, n_dl=3),
            ((wn._CellKernels, "blind_all2", "stage"), (wn._CellKernels, "pdsch_rx_tm3", "stage"),
             (wn._CellKernels, "ri_probe", "stage")))
    finally:
        pair.close()
        net.kern.__dict__.pop("pdsch_rx_tm3", None)
        for mac in macs:
            mac.__dict__.pop("cqi_info", None)
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
            bench(*args)  # the first call warms and captures the round
            tdc.launches = 0
            counts = [int(x) for x in bench(*args)]
            launches = tdc.launches
        assert counts == want, f"dynamic block x {cells} cells: counts {counts}, want {want}"
        med, spread, rates = rate(lambda: bench(*args), per_call=cells * T, iters=1)
        prof = profile_counted(lambda: bench(*args), f"dynamic block x {cells} cell(s)")
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


# phase 14: the multi-device layer on one card (a 1-device mesh: one card
# makes no scaling claim): the sharded link at the bench cell, the OTA
# collective and the scan over the mesh, the sharded block at phase 11's
# SPS configuration, then netsim through its entry point in subprocesses
NETSIM_TIMEOUT_S = 900
# (label, netsim arguments): the message-level run of the verify recipe,
# then phase 12's network through the three waveform modes at netsim's own
# cfi (2).  --waveform-dyn runs 6 UEs: at cfi 2 and 100 PRB the reference's
# CCE allocator (waveblock_dyn._alloc_cces) places netsim's C-RNTIs
# 0x146-0x14b and not 0x14c-0x14d
NETSIM_RUNS = (
    ("message level", ("--ues", "20", "--ttis", "800", "--prb", "50")),
    ("waveform-full", ("--waveform-full", "--ues", "8", "--prb", "100")),
    ("waveform-block", ("--waveform-block", "--ues", "8", "--prb", "100", "--ttis", "40",
                        "--block-ttis", "20")),
    ("waveform-dyn", ("--waveform-dyn", "--ues", "6", "--prb", "100", "--ttis", "32",
                      "--block-ttis", "16")),
)
NETSIM_IP_BYTES = 140  # netsim's IP packets: 120 bytes of payload in IPv4/UDP
# `python -c` body that runs the module named by its first argument as `-m`
# would (with the arguments after it), with every turbo_map and turbo_map_v1
# launch logged as launch_log does and every Viterbi call as ViterbiLog
# does (the first LLRs of each (rows, K, tb_iter) saved to the directory in
# $VITERBI_LLR_DIR); its last line, after the module's own output, is
# {"launches": the wrapper's count, "shapes": [[K, rows, narrow], ...],
# "v1_launches": v1's wrapper's count, "v1_shapes": [[K, rows, W], ...],
# "vit_launches": viterbi_cuda's count, "vit_shapes": [[rows, K, tb_iter,
# calls], ...]} (a module that resets the counts itself leaves the shapes
# whole); a captured round's replays count in the three logs as in the
# wrappers' counts (count_replays_in_logs, imported from this script)
MODULE_LOGGED = """
import collections, json, os, runpy, sys
import torch
from srslte_emane_tpu_torch.ops.fec import turbo_iter_cuda as ti, turbodecoder_cuda as tdc, viterbi_cuda
from chip_smoke import count_replays_in_logs, log_update
count_replays_in_logs()
seen, seen_v1, seen_vit = [], [], collections.Counter()
launch, launch_v1, decode_vit = tdc.launch, tdc.launch_v1, viterbi_cuda.viterbi_decode_cuda
loop = ti.decode_cuda
def logged(*a, **kw):
    log_update(lambda e=(a[0].shape[1], a[0].shape[0], bool(a[4])): seen.append(e))
    return launch(*a, **kw)
def logged_v1(*a, **kw):
    log_update(lambda e=(a[0].shape[1], a[0].shape[0], int(a[3])): seen_v1.append(e))
    return launch_v1(*a, **kw)
def logged_loop(*a):
    rows, k = a[4].shape
    w = tdc._pick_windows(k)
    if (k // w) % 2:
        log_update(lambda e=[(k, rows, w)] * (2 * a[16]): seen_v1.extend(e))
    else:
        log_update(lambda e=[(k, rows, bool(a[18]))] * (2 * a[16]): seen.extend(e))
    return loop(*a)
def logged_vit(llrs, tb_iter=viterbi_cuda.TB_ITER):
    key = (llrs.shape[0], llrs.shape[2], tb_iter)
    if key not in seen_vit:
        torch.save(llrs.cpu(), os.path.join(os.environ["VITERBI_LLR_DIR"], "%d_%d_%d.pt" % key))
    log_update(lambda: seen_vit.update([key]))
    return decode_vit(llrs, tb_iter)
tdc.launch, tdc.launch_v1, viterbi_cuda.viterbi_decode_cuda = logged, logged_v1, logged_vit
ti.decode_cuda = logged_loop
module = sys.argv.pop(1)
try:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
finally:
    print(json.dumps({"launches": tdc.launches, "shapes": seen,
                      "v1_launches": tdc.launches_v1, "v1_shapes": seen_v1,
                      "vit_launches": viterbi_cuda.launches,
                      "vit_shapes": [[*k, n] for k, n in seen_vit.items()]}), flush=True)
"""
NETSIM_MODULE = "srslte_emane_tpu_torch.apps.netsim"


def step_link_sharded(dev, card, logs):
    """Phase 14a: make_link_step_sharded on a 1-device mesh at the bench
    cell, batch 128: the eager step (jit=False) against link_step on the
    same noise; then the graphed step (the default: one CUDA graph for the
    mesh's position) against the eager one (graph_against_eager), both in
    turns (graph_turns: host launches per step); then the dry run.  Returns
    its turbo_map launches."""
    import torch

    from srslte_emane_tpu_torch.models import pdsch_link
    from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc
    from srslte_emane_tpu_torch.parallel import dryrun, mesh as mesh_mod

    mesh = mesh_mod.make_mesh(1)  # the card: the entry point's default
    assert mesh.devices == [dev] and mesh.shape == {"node": 1, "sf": 1}, mesh
    cfg = dryrun.bench_config()
    rng = np.random.default_rng(14)
    payload = torch.from_numpy(rng.integers(0, 2, (BATCH, cfg.tbs), dtype=np.int8)).to(dev)
    other = torch.from_numpy(rng.integers(0, 2, (BATCH, cfg.tbs), dtype=np.int8)).to(dev)
    steps = dict(graph=pdsch_link.make_link_step_sharded(cfg, mesh),
                 eager=pdsch_link.make_link_step_sharded(cfg, mesh, jit=False))
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    record = []
    with launch_log() as seen, replaying_awgn(record=record, rows=slice(None)):
        tdc.launches = 0
        out, ok, snr = steps["eager"](payload, gen)
        torch.cuda.synchronize()
        launches = tdc.launches
    logs.extend(seen)
    assert launches > 0 and all(narrow for _, _, narrow in seen), seen
    assert bool(ok.all()) and torch.equal(out, payload), \
        f"sharded link: {int(ok.sum())} of {BATCH} CRCs, or a payload bit"
    with replaying_awgn(replay=record, rows=slice(None)):  # eager: one awgn call to answer
        ref = pdsch_link.link_step(payload, gen, cfg)
    assert torch.equal(ref[0], out) and torch.equal(ref[1], ok) and torch.equal(ref[2], snr), \
        "sharded link differs from link_step on the same noise"
    right = lambda o, a: bool(o[1].all()) and torch.equal(o[0], a[0])
    with launch_log() as seen:
        first_s, graph_launches = graph_against_eager(
            "sharded link", steps, [(payload,), (other,)], lambda step, a, g: step(a[0], g),
            right)
    logs.extend(seen)
    (run,) = steps["graph"].positions
    assert len(run.graphs) == 1, run.graphs
    s = graph_turns("sharded link (phase 14a)", steps, lambda step: step(payload, seeded(7)),
                    BATCH, "sf/s", card)
    assert s["graph"]["host_launches"] <= 24, s["graph"]
    assert mesh.transfers == 0, f"sharded link moved {mesh.transfers} tensors between devices"
    log(f"sharded link: make_link_step_sharded on a 1-device mesh {mesh.shape}, bench cell "
        f"(100 PRB, 64QAM, rate 0.55, llr_bits=16, TBS {cfg.tbs}), batch {BATCH}: every CRC "
        f"passes, payload bit-exact, the eager step (jit=False) equal to link_step on the same "
        f"noise bit for bit (bits, CRCs, SNR estimates); {launches} turbo_map launches "
        f"{sorted(set(seen))}; the graphed step (one graph for the position) equal to the "
        f"eager one bit for bit on two payloads (generators, launches "
        f"{json.dumps(dict(graph_launches))}, MAP rows), first call {first_s:.2f} s; sf/s x "
        f"{s['graph']['rate'] / s['eager']['rate']:.2f}, host launches per step "
        f"{s['graph']['host_launches']} vs {s['eager']['host_launches']}, device ms "
        f"{s['graph']['device_ms']} vs {s['eager']['device_ms']}, CUDA-event ms "
        f"{s['graph']['event_ms']} vs {s['eager']['event_ms']}; cross-device transfers "
        f"{mesh.transfers}; {card}")
    launches += graph_launches["turbo_map"]
    with launch_log() as seen:
        tdc.launches = 0
        dryrun.dryrun(1)  # prints its JSON lines
        launches += tdc.launches
    logs.extend(seen)
    return launches


def step_ota_scan(dev, card):
    """Phase 14b: ota_mix_sharded and total_rx_power_psum on the card against
    the dense mix, then network_scan over 64 cells with the mesh and
    without."""
    import torch

    from srslte_emane_tpu_torch.models import netscan
    from srslte_emane_tpu_torch.parallel import mesh as mesh_mod, ota_collective

    mesh = mesh_mod.make_mesh(1)
    n, B, S = 8, 2, 30720  # 8 nodes, 2 subframes of 20 MHz samples each
    rng = np.random.default_rng(15)
    tx = rng.normal(size=(n, B, S, 2)).astype(np.float32)
    g = (0.1 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))).astype(np.complex64)
    shards = mesh_mod.node_sharding(mesh, tx)
    rx = mesh_mod.gather(ota_collective.ota_mix_sharded(mesh, shards, g))
    p = ota_collective.total_rx_power_psum(mesh, shards)
    assert rx.device == dev and p.device == dev
    gd = g * (1.0 - np.eye(n, dtype=np.float32))
    want = np.einsum("mn,nbs->mbs", gd.astype(np.complex128), tx[..., 0] + 1j * tx[..., 1])
    err = np.abs(rx.cpu().numpy() - np.stack([want.real, want.imag], -1)).max()
    assert err <= 1e-4, f"OTA mix on the card: max abs error {err}"
    p_want = sum(float(np.mean(np.sum(tx[i].astype(np.float64) ** 2, -1))) for i in range(n))
    assert abs(float(p) - p_want) <= 1e-5 * p_want, (float(p), p_want)
    # with noise: each device draws from a copy of gen's state, so the sharded
    # medium adds what one dense draw from an equally seeded generator adds
    gen, dense = (torch.Generator(device=dev).manual_seed(18) for _ in range(2))
    noisy = mesh_mod.gather(ota_collective.ota_mix_sharded(mesh, shards, g, gen=gen,
                                                           noise_std=0.1))
    noise = 0.1 * torch.randn((n, B, S, 2), generator=dense, device=dev) / np.sqrt(2.0)
    n_err = (noisy - rx - noise).abs().max().item()
    assert n_err <= 1e-4, f"OTA mix noise on the card: max abs error {n_err}"
    assert torch.equal(torch.randn(4, generator=gen, device=dev),
                       torch.randn(4, generator=dense, device=dev)), "gen did not advance as one draw"
    mix_ms = cuda_ms(lambda: ota_collective.ota_mix_sharded(mesh, shards, g), 20)
    log(f"OTA collective: ota_mix_sharded of {n} nodes x {B} x {S} samples on the card equals the "
        f"dense mix (max abs error {err:.2e}, bound 1e-4), with noise_std 0.1 the dense mix plus "
        f"one draw from an equally seeded generator (max abs error {n_err:.2e}, bound 1e-4), "
        f"total_rx_power_psum {float(p):.6f} against {p_want:.6f}; mix {mix_ms:.4f} ms (CUDA "
        f"events, median of 20); cross-device transfers {mesh.transfers}; {card}")

    _, n_cells, ids, gm, want_ids = scan_case(dev)  # phase 10's scan

    def scan(m):
        gen = torch.Generator(device=dev)
        gen.manual_seed(17)
        return netscan.network_scan(m, ids, gm, gen=gen, noise_std=0.02)

    sharded, plain = scan(mesh), scan(None)
    assert torch.equal(sharded["cell_id"], plain["cell_id"]), "scan: mesh and no mesh differ"
    assert torch.equal(sharded["cell_id"], want_ids), "scan: an observer missed its neighbour"
    right = lambda res: torch.equal(res["cell_id"], want_ids)
    r_mesh = rate(lambda: scan(mesh), check=right, per_call=n_cells)
    r_plain = rate(lambda: scan(None), check=right, per_call=n_cells)
    log(f"network scan over {n_cells} cells (phase 10's) with the mesh: the PCIs equal those without it "
        f"and every row finds its neighbour; {fmt_rate('mesh', *r_mesh, unit='cells/s')}; "
        f"{fmt_rate('no mesh', *r_plain, unit='cells/s')}; {card}")


def step_block_sharded(dev, card, logs):
    """Phase 14c: make_block_step_sharded for 1 cell at phase 11's SPS
    configuration: the eager step (jit=False) against make_block_step on
    the same draws; then the graphed step (the default: one CUDA graph for
    the cell's position) against the eager one at tti0 0 and 37
    (graph_against_eager), both in turns (graph_turns: host launches per
    block).  Returns its turbo_map launches."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc
    from srslte_emane_tpu_torch.parallel import mesh as mesh_mod
    from srslte_emane_tpu_torch.runtime import waveblock

    cfg = sps_config(SPS_T)
    n, T = cfg.n_ues, cfg.T
    mesh = mesh_mod.make_mesh(1)
    make = lambda jit: waveblock.make_block_step_sharded(cfg, mesh, (cfg.cell.cell_id,), sfn0=4,
                                                         jit=jit)
    (step, consts), (eager, _) = make(True), make(False)
    steps = dict(graph=step, eager=eager)
    assert all(v.device == dev for v in consts[0].values())
    rng = np.random.default_rng(16)
    payloads = [tuple(torch.from_numpy(rng.integers(0, 2, (1, T, n, tbs), dtype=np.int8)).to(dev)
                      for tbs in (cfg.dl_tbs, cfg.ul_tbs)) for _ in range(2)]
    dl, ul = payloads[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)

    def right(out, args=(dl, ul)):
        return (bool(out["dl_ok"].all()) and bool(out["ul_ok"].all())
                and int((out["ack_energy"] > 1e-2).sum()) == T * n
                and torch.equal(out["dl_out"], args[0]) and torch.equal(out["ul_out"], args[1]))

    record = []
    with launch_log() as seen, recorded_noise(record=record):
        tdc.launches = 0
        out = eager(dl, ul, [gen], 0)
        torch.cuda.synchronize()
        launches = tdc.launches
    logs.extend(seen)
    assert launches > 0 and right(out), (
        f"sharded block: DL {int(out['dl_ok'].sum())}, UL {int(out['ul_ok'].sum())}, ACK "
        f"{int((out['ack_energy'] > 1e-2).sum())} of {T * n}, or a payload")
    with recorded_noise(replay=record):
        ref = waveblock.make_block_step(cfg, sfn0=4, jit=False)(dl[0], ul[0], gen, 0)
    for k, v in ref.items():
        assert torch.equal(out[k][0], v), f"sharded block differs from make_block_step at {k}"
    with launch_log() as seen:
        first_s, graph_launches = graph_against_eager(
            "sharded block", steps, [(*payloads[0], 0), (*payloads[1], 37)],
            lambda s, a, g: s(a[0], a[1], [g], a[2]), right)
    logs.extend(seen)
    (run,) = step.positions
    assert len(run.graphs) == 1, run.graphs
    s = graph_turns("sharded block (phase 14c)", steps, lambda s: s(dl, ul, [seeded(7)], 0), T,
                    "TTIs/s", card, iters=2)
    assert s["graph"]["host_launches"] <= 64, s["graph"]
    assert mesh.transfers == 0
    log(f"sharded block: make_block_step_sharded, 1 cell on a 1-device mesh, phase 11's SPS "
        f"block (100 PRB, 8 UEs, T={T}): every DL and UL CRC passes, {T * n} ACKs, payloads "
        f"bit-exact, the eager step (jit=False) equal to make_block_step on the same draws in "
        f"every output; {launches} turbo_map launches {sorted(set(seen))}; the graphed step (one "
        f"graph for the cell) equal to the eager one bit for bit at tti0 0 and 37 (generators, "
        f"launches {json.dumps(dict(graph_launches))}, MAP rows), first call {first_s:.2f} s; "
        f"TTIs/s x {s['graph']['rate'] / s['eager']['rate']:.2f}, host launches per block "
        f"{s['graph']['host_launches']} vs {s['eager']['host_launches']}, device ms "
        f"{s['graph']['device_ms']} vs {s['eager']['device_ms']}, CUDA-event ms "
        f"{s['graph']['event_ms']} vs {s['eager']['event_ms']}; cross-device transfers "
        f"{mesh.transfers}; {card}")
    return launches + graph_launches["turbo_map"]


def netsim_checks(label, ues, out):
    """What phase 12 checks of a network, on netsim's JSON line."""
    assert out["attached"] == ues, f"netsim {label}: {out['attached']} of {ues} attached"
    if label == "message level":
        assert out["dl_ip_bytes"] > 0, out
        return
    # netsim's 4 DL packets and 1 UL packet per UE, every one delivered
    assert out["dl_ip_bytes"] == 4 * NETSIM_IP_BYTES * ues, out
    assert out["ul_ip_bytes"] == NETSIM_IP_BYTES * ues, out
    if label == "waveform-full":
        assert out["enb_phy"]["prach_det"] >= ues, out
    else:
        m = out["block_metrics"]
        assert m["dl_ok"] == m["dl_tb"] > 0 and m["ul_ok"] == m["ul_tb"] > 0, m
        assert m.get("ack_det", m["dl_tb"]) == m["dl_tb"] and m.get("dci_miss", 0) == 0, m


def run_logged(group, timeout_s):
    """Each (label, module, arguments) of `group` in its own subprocess
    through MODULE_LOGGED, all started together (the host's cores and the
    card are shared), each within what is left of `timeout_s`.  Returns
    {label: (its JSON lines, then MODULE_LOGGED's; its stderr lines that
    start with "#"; wall seconds)}; a process that exits non-zero fails the
    phase.  Its Viterbi calls, with their first LLRs, go to the active
    ViterbiLog, under the phase being run."""
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    procs, results = [], {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_llrs_") as tmp:
        try:
            for label, module, args in group:
                llr_dir = os.path.join(tmp, str(len(procs)))
                os.mkdir(llr_dir)
                env = dict(os.environ, OMP_NUM_THREADS="2", VITERBI_LLR_DIR=llr_dir)
                procs.append((label, llr_dir, subprocess.Popen(
                    [sys.executable, "-c", MODULE_LOGGED, module, *args], cwd=root, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            for label, llr_dir, proc in procs:
                left = max(1.0, timeout_s - (time.perf_counter() - t0))
                out, err = proc.communicate(timeout=left)
                assert proc.returncode == 0, f"{label} exited {proc.returncode}: {err[-3000:]}"
                lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
                ViterbiLog.active.add_process(label, lines[-1], llr_dir)
                results[label] = (lines, [x for x in err.splitlines() if x.startswith("#")],
                                  time.perf_counter() - t0)
        finally:
            for _, _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    return results


def step_netsim(card, logs):
    """Phase 14d: the port's netsim module, one process per run of
    NETSIM_RUNS, all started together (so their rates are lower bounds),
    each within NETSIM_TIMEOUT_S, run as `-m` runs it through MODULE_LOGGED
    so that each reports its turbo_map launches.  Returns the launches of
    the waveform runs, each of which must have launched the kernel; their
    shapes go to `logs`."""
    results = run_logged([(label, NETSIM_MODULE, args) for label, args in NETSIM_RUNS],
                         NETSIM_TIMEOUT_S)
    launches = 0
    for label, args in NETSIM_RUNS:
        lines, _, wall = results[label]
        *_, line, seen = lines
        netsim_checks(label, int(args[args.index("--ues") + 1]), line)
        shapes = [(k, r, bool(nw)) for k, r, nw in seen["shapes"]]
        assert seen["launches"] == len(shapes), seen["launches"]
        if label != "message level":  # the message level has no PHY
            assert shapes, f"netsim {label}: no turbo_map launch"
            launches += len(shapes)
            logs.extend(shapes)
        log(f"netsim {label} ({' '.join(args)}): done after {wall:.1f} s wall: "
            f"{json.dumps(line)}; turbo_map launches {len(shapes)} at {len(set(shapes))} "
            f"shapes {sorted(set(shapes))[:12]}; {card}")
    return launches


def phase_slice14(dev, card, known):
    """Phase 14.  Returns (the turbo_map cases at its shapes not in `known`,
    its launches: the sharded link and the dry run, the sharded block, the
    netsim waveform runs)."""
    t_phase = time.perf_counter()
    logs, launches, seconds = [], [], []
    for step in (lambda: step_link_sharded(dev, card, logs), lambda: step_ota_scan(dev, card),
                 lambda: step_block_sharded(dev, card, logs), lambda: step_netsim(card, logs),
                 lambda: map_cases_logged(logs, known, dev, 14, card)):
        t0 = time.perf_counter()
        launches.append(step())
        seconds.append(round(time.perf_counter() - t0, 1))
    cases = launches.pop()
    launches = [launches[0], launches[2], launches[3]]
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s (14a, 14b, 14c, 14d, the kernel "
        f"checks: {seconds} s); turbo_map launches of 14a, 14c and 14d {launches}")
    return cases, sum(launches)


# phase 15: the port's measuring entry points, srslte_emane_tpu_torch.bench
# and srslte_emane_tpu_torch.scripts.*, each run as `python -m` runs it in a
# subprocess on the card through MODULE_LOGGED, at its JAX twin's defaults.
# The number of record runs alone, then six processes at once (the host's
# cores and the card are shared, so their rates are lower bounds), then the
# paced run alone (its deadlines need the host to itself)
ENTRY_TIMEOUT_S = 600
ENTRY_GROUPS = (
    (("bench", "srslte_emane_tpu_torch.bench", ()),),
    tuple((name, f"srslte_emane_tpu_torch.scripts.{name}", ()) for name in (
        "snr_sweep", "bench_extra", "bench_waveform_tpu", "bench_waveblock_dyn",
        "wavenet_smoke")) + (("snr_sweep_eager", "srslte_emane_tpu_torch.scripts.snr_sweep",
                              ("--eager",)),),
    (("bench_waveform_paced", "srslte_emane_tpu_torch.scripts.bench_waveform_paced", ()),),
)
# what phase 15 cuts from the JAX scripts' defaults (nothing yet)
ENTRY_REDUCED = ()
SWEEP_SNRS_DB = (8.0, 9.0, 10.0, 11.0, 12.0, 14.0, 20.0)  # scripts/snr_sweep.py:29-30


def entry_checks(label, lines, card_name):
    """What phase 15 checks of an entry point's JSON lines, beyond its own
    gates (a failed gate exits non-zero)."""
    out = lines[-1]
    assert out["backend"] == "cuda" and out["device"] == card_name, out
    if label == "bench":
        assert out["metric"] == "pdsch_20mhz_decode_subframes_per_sec_per_chip", out
        assert out["value"] > 0 and out["device_ms"] > 0 and out["cache_state"] == "warm", out
        assert out["captured_graphs"] == 2, out  # the encode and the decode ran as graphs
    elif label.startswith("snr_sweep"):
        rows = out["snr_sweep"]
        assert rows == lines[:-1] and [r["snr_db"] for r in rows] == list(SWEEP_SNRS_DB), rows
        assert all(0.0 <= r["bler"] <= 1.0 and r["sf_per_s"] > 0 and r["device_ms"] > 0
                   for r in rows), rows
        assert rows[-1]["bler"] == 0.0, f"the sweep lost CRCs at 20 dB: {rows[-1]}"
        # the encode and the decode of each SNR one graph each; none with --eager
        assert out["captured_graphs"] == (0 if label.endswith("eager") else
                                          2 * len(SWEEP_SNRS_DB)), out
    elif label == "bench_extra":
        assert all(out[k] > 0 for k in ("cell_search", "mimo_tm3_decode", "pusch_decode",
                                        "ca_2cc_link")), out
    elif label == "wavenet_smoke":
        assert out["registered"] == out["n_ues"], out
    else:  # the block benches
        assert out["value"] > 0 and out["compile_s"] >= 0, out


SWEEP_GRAPH_SNRS_DB = (8.0, 20.0)  # the waterfall's bottom (every row fails) and the bench cell


def step_sweep_graphs(dev, card, logs):
    """Phase 15, in this process: the sweep's decode (scripts/snr_sweep.
    snr_case, batch 128) at SWEEP_GRAPH_SNRS_DB, graphed against --eager's
    (graph_against_eager, on two received batches), then both in turns
    (graph_turns: sf/s, CUDA-event ms, host launches and device ms per
    decode).  Returns its turbo_map launches."""
    import torch

    from srslte_emane_tpu_torch.scripts import snr_sweep

    tbs = snr_sweep.bench.bench_config(16).tbs
    rng = np.random.default_rng(15)
    launches = 0
    for snr in SWEEP_GRAPH_SNRS_DB:
        payloads = [torch.from_numpy(rng.integers(0, 2, (BATCH, tbs), dtype=np.int8)).to(dev)
                    for _ in range(2)]
        tx_fn, rx_fn, rx = snr_sweep.snr_case(snr, payloads[0])
        _, rx_eager, rx_ref = snr_sweep.snr_case(snr, payloads[0], eager=True)
        assert torch.equal(rx, rx_ref), f"sweep at {snr} dB: the encode's graph differs"
        other = snr_sweep.snr_case(snr, payloads[1], eager=True)[2]
        right = ((lambda o, a: bool(o[1].all())) if snr >= 20.0 else
                 (lambda o, a: not bool(o[1].any())))
        steps = dict(graph=rx_fn, eager=rx_eager)
        with launch_log() as seen:
            first_s, n = graph_against_eager(f"sweep decode at {snr} dB", steps,
                                             [(rx,), (other,)], lambda f, a, g: f(*a), right)
        logs.extend(seen)
        assert len(rx_fn.graphs) == len(tx_fn.graphs) == 1
        launches += n["turbo_map"]
        t = graph_turns(f"sweep decode at {snr} dB (phase 15)", steps, lambda f: f(rx), BATCH,
                        "sf/s", card)
        assert t["graph"]["host_launches"] <= 16, t["graph"]
        log(f"sweep decode at {snr} dB (bench cell, batch {BATCH}; BLER "
            f"{1.0 if snr < 20.0 else 0.0}): graph equal to --eager bit for bit on two batches "
            f"(launches {json.dumps(dict(n))}, MAP rows), first call {first_s:.2f} s; sf/s "
            f"{t['graph']['rate']} vs {t['eager']['rate']} (x "
            f"{t['graph']['rate'] / t['eager']['rate']:.2f}), CUDA-event ms per decode "
            f"{t['graph']['event_ms']} vs {t['eager']['event_ms']}, host launches "
            f"{t['graph']['host_launches']} vs {t['eager']['host_launches']}, device ms "
            f"{t['graph']['device_ms']} vs {t['eager']['device_ms']}; {card}")
    return launches


def phase_entry_points(dev, card, known):
    """Phase 15.  Returns (the turbo_map cases at its shapes not in `known`,
    at every row count, its launches)."""
    import torch

    t_phase = time.perf_counter()
    log(f"phase 15: reduced {list(ENTRY_REDUCED)}")
    logs, launches, results = [], {}, {}
    for group in ENTRY_GROUPS:
        results.update(run_logged(group, ENTRY_TIMEOUT_S))
    for label, (lines, notes, wall) in results.items():
        *lines, seen = lines
        log(f"{label}: done after {wall:.1f} s wall: {json.dumps(lines[-1])}; "
            f"{' '.join(notes)[-1500:]}; {card}")
        results[label] = lines
        entry_checks(label, lines, torch.cuda.get_device_name(0))
        if label == "bench_extra":  # its four timed steps ran as captured graphs
            n = [int(m.group(1)) for x in notes if (m := re.match(r"# graphs captured: (\d+)", x))]
            assert n == [4], notes
        shapes = [(k, r, bool(nw)) for k, r, nw in seen["shapes"]]
        assert seen["launches"] == len(shapes) > 0, f"{label}: {seen['launches']} launches"
        launches[label] = len(shapes)
        logs.extend(shapes)
    rec = results["bench"][-1]
    log(f"number of record: {rec['value']} sf/s decode (median of {rec['median_of']}, spread "
        f"{rec['spread_pct']} %), device {rec['device_ms']} ms per call (CUDA events), "
        f"compile {rec['compile_s']} s ({rec['cache_state']}); {card}")
    rows, eager_rows = (results[k][-1]["snr_sweep"] for k in ("snr_sweep", "snr_sweep_eager"))
    assert [(r["bler"], r["turbo_map_launches"]) for r in rows] == [
        (r["bler"], r["turbo_map_launches"]) for r in eager_rows], (rows, eager_rows)
    log("SNR sweep (batch 128, 10 calls each; beside five other processes), graphed (14 graphs) "
        "then --eager, the same BLER and launches per decode at every SNR: " + json.dumps(
            [{"snr_db": r["snr_db"], "bler": r["bler"], "sf_per_s": [r["sf_per_s"],
                                                                     e["sf_per_s"]],
              "device_ms": [r["device_ms"], e["device_ms"]],
              "turbo_map_launches": r["turbo_map_launches"]} for r, e in zip(rows, eager_rows)]))
    paced = results["bench_waveform_paced"][-1]
    log(f"paced: headroom {paced['value']}x, {paced['deadline_misses']} deadline misses in "
        f"{paced['blocks']} blocks of T={paced['block_ttis']}, compute {paced['compute_ms']} ms "
        f"per block; {card}")
    t0 = time.perf_counter()
    launches["sweep graphs"] = step_sweep_graphs(dev, card, logs)
    log(f"phase 15: the sweep's decode graphed against eager in {time.perf_counter() - t0:.1f} s")
    log(f"phase 15 turbo_map launches by entry point {json.dumps(launches)}")
    t0 = time.perf_counter()
    cases = map_cases_logged(logs, known, dev, 15, card, select=every_map_shape)
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s (the kernel checks "
        f"{time.perf_counter() - t0:.1f} s, {len(cases)} new shapes)")
    return cases, sum(launches.values())


# phase 16 (slice 17): the three profiling entry points at their JAX twins'
# defaults, each as `python -m` through MODULE_LOGGED, each alone (the
# profilers time the card): profile_turbo (it times both kernels),
# profile_stages and profile_mimo, each with its stages as replayed graphs
# (the default) and then with --eager, then profile_dynblock; the options
# the port had folded into constants, and WaveUePhy's per-UE fallback
PROFILE_TIMEOUT_S = 300
PROFILERS = ("profile_turbo", "profile_stages", "profile_mimo")
PROFILE_GROUPS = tuple(
    ((f"{name}{tag}", f"srslte_emane_tpu_torch.scripts.{name}", args),)
    for name in PROFILERS for tag, args in (("", ()), ("_eager", ("--eager",)))) + (
    (("profile_dynblock", "srslte_emane_tpu_torch.scripts.profile_dynblock", ()),),)
# the graphs each profiler captures: one per jit of its JAX twin (the
# fixed-iteration jits once per count; profile_mimo's two set-up jits too)
PROFILE_GRAPHS = dict(profile_turbo=6, profile_stages=12, profile_mimo=8)
# the UEs of phase 11's dynamic cell (100 PRB, cfi 2: 50 CCEs) that
# feasible_rntis places at each PDCCH aggregation level: the most of 8, 6,
# 4, 2 for which the greedy search found a set (8 at L=2 takes ~36 s of
# host time, so it runs beside the profiling processes)
DYN_L_UES = {2: 8, 4: 4, 8: 2}
SPS_TM3_T, DYN_OPT_R = 20, 2
PER_UE_PRB, PER_UE_UES, PER_UE_TTIS = 15, 2, 10


def profile_checks(label, out, card_name):
    """What phase 16 checks of a profiling twin's JSON line, beyond its own
    gates (profile_mimo's CRCs, for one)."""
    from srslte_emane_tpu_torch.scripts import profile_turbo

    assert out["backend"] == "cuda" and out["device"] == card_name, out
    name = label.removesuffix("_eager")
    if name in PROFILE_GRAPHS:  # one graph per jit, none with --eager
        assert out["captured_graphs"] == (0 if label.endswith("_eager") else
                                          PROFILE_GRAPHS[name]), out
        assert all(v["ms"] > 0 for v in out["stages"].values()), out
    if name == "profile_turbo":
        st = out["stages"]
        assert (out["n_cb"], out["k"], out["n_windows"]) == (1024, 5568, 32), out
        per_call = {k: (v["turbo_map_launches"], v["turbo_map_v1_launches"]) for k, v in st.items()}
        assert per_call[profile_turbo.MAP_V1] == (0, 1) and per_call[profile_turbo.MAP] == (1, 0)
        assert per_call[profile_turbo.PLAIN] == (0, 0), per_call
        assert per_call[profile_turbo.fixed(1)] == (2, 0), per_call
        assert per_call[profile_turbo.fixed(2)] == (4, 0), per_call
        # random LLRs, no CRC passes: the loop's 16 slots, all run
        assert per_call[profile_turbo.EARLY] == (16, 0), per_call
    elif name == "profile_mimo":
        assert len(out["stages"]) == 6, out
        assert out["sf_per_s"] > 0 and out["batch"] == 32, out
    elif name == "profile_stages":
        assert len(out["stages"]) == 12 and out["batch"] == 128, out
    else:
        var = out["variants"]
        assert list(out["ms_per_round"]) == ["full", "-viterbi", "-turbodec", "-turboenc",
                                             "-all-fec"], out
        assert all(v > 0 for v in out["ms_per_round"].values()), out
        assert var["full"]["turbo_map_launches"] > 0, var
        assert var["-turbodec"]["turbo_map_launches"] == var["-all-fec"]["turbo_map_launches"] == 0


def graphed_beside_eager(name, outs, card):
    """Logs each stage of profiler `name` replayed beside its --eager run
    (CUDA-event ms per call, the host's ms per call, the first call's s:
    the capture's, or the eager call's), and holds their MAP launches per
    call equal."""
    graphed, eager = outs[name]["stages"], outs[f"{name}_eager"]["stages"]
    assert list(graphed) == list(eager), (list(graphed), list(eager))
    rows = {}
    for label, g in graphed.items():
        e = eager[label]
        for key in ("turbo_map_launches", "turbo_map_v1_launches"):
            assert g.get(key) == e.get(key), (name, label, key, g, e)
        rows[label] = dict(ms=[g["ms"], e["ms"]], host_ms=[g["host_ms"], e["host_ms"]],
                           ms_ratio=round(e["ms"] / g["ms"], 2),
                           first_s=[round(g["first_s"], 2), round(e["first_s"], 2)])
    log(f"{name}: each stage replayed ({PROFILE_GRAPHS[name]} graphs) beside --eager, "
        f"[graphed, eager] (ms_ratio = eager / graphed CUDA-event ms): {json.dumps(rows)}; {card}")


def step_profiles(card, logs, v1_logs):
    """16a: the profiling twins.  Returns their turbo_map launches; the
    shapes go to `logs` and `v1_logs`."""
    import torch

    results = {}
    for group in PROFILE_GROUPS:
        results.update(run_logged(group, PROFILE_TIMEOUT_S))
    launches, outs = {}, {}
    for label, (lines, notes, wall) in results.items():
        *lines, seen = lines
        out = outs[label] = lines[-1]
        profile_checks(label, out, torch.cuda.get_device_name(0))
        shapes = [(k, r, bool(nw)) for k, r, nw in seen["shapes"]]
        v1_shapes = [tuple(x) for x in seen["v1_shapes"]]
        assert shapes, f"{label}: no turbo_map launch"
        assert bool(v1_shapes) == label.startswith("profile_turbo"), (label, len(v1_shapes))
        launches[label] = (len(shapes), len(v1_shapes))
        logs.extend(shapes)
        v1_logs.extend(v1_shapes)
        if label.startswith("profile_turbo"):
            assert set(v1_shapes) == {(5568, 1024, 32)}, set(v1_shapes)
            assert {(k, r) for k, r, _ in shapes} == {(5568, 1024)}, set(shapes)
        log(f"{label} (python -m, its defaults): done after {wall:.1f} s wall: "
            f"{json.dumps(out)}; {' '.join(notes)[-800:]}; turbo_map launches {len(shapes)} at "
            f"{len(set(shapes))} shapes, turbo_map_v1 launches {len(v1_shapes)}; {card}")
    for name in PROFILERS:
        graphed_beside_eager(name, outs, card)
    return launches


def step_tm3_condition(dev, card, logs):
    """16b: the SPS TM3 block (phase 11's, T=SPS_TM3_T) through a unitary
    channel and through the reference's rank-1 one (mimo_cond_db 60).
    Returns the turbo_map launches of both blocks."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc
    from srslte_emane_tpu_torch.runtime import waveblock

    launches = 0
    for cond in (0.0, 60.0):
        cfg = sps_config(SPS_TM3_T, tm3=True)._replace(mimo_cond_db=cond)
        n, T = cfg.n_ues, cfg.T
        rng = np.random.default_rng(0)
        dl = torch.from_numpy(rng.integers(0, 2, (T, n, 2, cfg.dl_tbs), dtype=np.int8)).to(dev)
        ul = torch.from_numpy(rng.integers(0, 2, (T, n, cfg.ul_tbs), dtype=np.int8)).to(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        step = waveblock.make_block_step(cfg, sfn0=4)
        with launch_log() as seen:
            tdc.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(dl, ul, gen, 0)
            torch.cuda.synchronize()
            block_s = time.perf_counter() - t0
        launches += tdc.launches
        logs.extend(seen)
        energy, val = out["ack_energy"], out["ack_val"]
        assert bool(out["ul_ok"].all()) and bool((energy > 0.25).all()), (cond, out["ul_ok"], energy)
        if cond == 0.0:
            assert bool(out["dl_ok_cw"].all()) and bool((val > 0).all()), cond
            assert torch.equal(out["dl_out"], dl.reshape(T, n, -1)), cond
        else:  # every codeword fails; the bundled NACK rides the PUCCH
            assert not bool(out["dl_ok_cw"].any()) and bool((val < 0).all()), cond
        log(f"SPS block TM3 at mimo_cond_db {cond:g} (100 PRB, 8 UEs, T={T}): codewords "
            f"passing {int(out['dl_ok_cw'].sum())} of {2 * T * n}, UL {int(out['ul_ok'].sum())} "
            f"of {T * n}, ACK energy min {energy.min().item():.3f}, ACK value range "
            f"[{val.min().item():.3f}, {val.max().item():.3f}]; {tdc.launches} turbo_map launches "
            f"{sorted(set(seen))}; {block_s:.2f} s for the block (host tables included); {card}")
    return launches


def step_dyn_options(dev, card, logs, rntis):
    """16c: the dynamic block (phase 11's, R=DYN_OPT_R) at PDCCH
    aggregation 2, 4 and 8 with the RNTIs feasible_rntis gave, then at L=1
    with UE 7 at -6 dB (it misses every DCI) under max_tx 4 and 2.  Returns
    the turbo_map launches."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc
    from srslte_emane_tpu_torch.runtime import waveblock_dyn as wbd

    base = dyn_config(DYN_OPT_R)
    cases = [(f"l_aggr {l}", base._replace(l_aggr=l, rntis=rntis[l],
                                         snr_db=(30.0,) * len(rntis[l]))) for l in DYN_L_UES]
    weak = base.snr_db[:7] + (-6.0,)
    cases += [(f"max_tx {m}", base._replace(max_tx=m, snr_db=weak)) for m in (4, 2)]
    launches, drops = 0, {}
    for name, cfg in cases:
        n, T = cfg.n_ues, cfg.T
        rng = np.random.default_rng(0)
        dl_q = torch.from_numpy(rng.integers(0, 2, (T, n, cfg.dl_tbs), dtype=np.int8)).to(dev)
        ul_q = torch.from_numpy(rng.integers(0, 2, (T, n, cfg.ul_tbs), dtype=np.int8)).to(dev)
        rb_dl, rb_ul = (torch.from_numpy(a).to(dev) for a in wbd.make_schedule(cfg, seed=3))
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        step = wbd.make_dyn_block_step(cfg)
        with launch_log() as seen:
            tdc.launches = 0
            out = step(dl_q, ul_q, rb_dl, rb_ul, gen, 0)
            torch.cuda.synchronize()
        launches += tdc.launches
        logs.extend(seen)
        if name.startswith("l_aggr"):
            assert dyn_block_right(out, dl_q, ul_q, rb_dl), (
                f"dynamic block at {name}: DL {int(out['dl_ok'].sum())}, UL "
                f"{int(out['ul_ok'].sum())}, ACK {int(out['ack_det'].sum())} of {T * n}, DCI misses "
                f"{int(out['dci_dl_miss'])} + {int(out['dci_ul_miss'])}")
        else:
            dl_ok = out["dl_ok"]
            assert bool(dl_ok[:, :, :7].all()) and not bool(out["dl_found"][:, :, 7].any()), name
            drops[name] = int(out["dl_drop"])
        log(f"dynamic block at {name} (100 PRB, cfi 2, {n} UEs, RNTIs {list(cfg.rntis)}, R="
            f"{cfg.R}): DL {int(out['dl_ok'].sum())}, UL {int(out['ul_ok'].sum())}, ACK "
            f"{int(out['ack_det'].sum())} of {T * n}; DCI misses {int(out['dci_dl_miss'])} + "
            f"{int(out['dci_ul_miss'])}; DL retransmissions {int(out['dl_retx_tx'])}, drops "
            f"{int(out['dl_drop'])}; {tdc.launches} turbo_map launches; {card}")
    # UE 7's processes: no drop within 2 rounds at max_tx 4, dropped after 2
    # transmissions at max_tx 2
    assert drops["max_tx 4"] == 0 < drops["max_tx 2"], drops
    return launches


def step_per_ue(dev, card, logs):
    """16d: a 15 PRB, 2-UE network attached on the card, then PER_UE_TTIS
    TTIs with traffic in which every UE runs run_tti alone (its own
    dl_take and _camp_rx); each TTI the batched front end (one rx_front and
    one blind_all over both UEs' samples, as WaveformNetwork.run calls them)
    runs on the same samples and is held against each UE's own.  Returns
    the turbo_map launches of those TTIs."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc

    net, ues, spgw, spgw_mod = waveform_network(n_prb=PER_UE_PRB, n_ues=PER_UE_UES, cfi=2)
    while net.tti < 400 and not all(u.emm_state == "REGISTERED" for u in ues):
        net.run(10)
    assert all(u.emm_state == "REGISTERED" and u.ip_addr for u in ues), net.tti
    pkts = NetworkRun.traffic(ues, spgw, spgw_mod)
    rx_before = [u.gw_rx.count(pkt) for u, pkt in zip(ues, pkts)]
    tb_before = [u.metrics["tb_ok"] for u in net.ues]
    taken, fronts, blinds = [], [], []
    take, front, blind = net.medium.dl_take, net.kern.rx_front, net.kern.blind_all

    def record(fn, into):
        def rec(*a):
            out = fn(*a)
            into.append((a, out))
            return out
        return rec

    def record_stage(factory, into):  # each call of the factory's stages, with its key
        def stage(sf):
            out = factory(sf)
            fn = out[0] if isinstance(out, tuple) else out
            rec = record(fn, into)
            return (rec,) + out[1:] if isinstance(out, tuple) else rec
        return stage

    net.medium.dl_take = record(take, taken)
    net.kern.rx_front = record_stage(front, fronts)
    net.kern.blind_all = record_stage(blind, blinds)
    checked, max_err = 0, 0.0
    try:
        with launch_log() as seen:
            tdc.launches = 0
            for _ in range(PER_UE_TTIS):
                taken.clear(), fronts.clear(), blinds.clear()
                net.enb.run_tti(net.tti)
                for ue in net.ues:
                    ue.run_tti(net.tti)
                net.tti += 1
                assert len(taken) == PER_UE_UES == len(fronts) == len(blinds), len(fronts)
                # the batched front end on the same samples, the UEs' subframe
                sf = net.ues[0].tti % 10
                assert all(u.tti % 10 == sf for u in net.ues), [u.tti for u in net.ues]
                rg, ce, snr, sb = front(sf)(torch.cat([s for _, s in taken]))
                bits, resid = blind(sf)[0](rg, ce)
                for i, ((_, own), (_, own_blind)) in enumerate(zip(fronts, blinds)):
                    for a, b in zip(own, (rg, ce, snr, sb)):
                        torch.testing.assert_close(a, b[i:i + 1], rtol=1e-5, atol=1e-5)
                        max_err = max(max_err, (a - b[i:i + 1]).abs().max().item())
                    assert torch.equal(own_blind[1], resid[i:i + 1])
                    assert torch.equal(own_blind[0], bits[i:i + 1])
                    checked += 1
            torch.cuda.synchronize()
            launches = tdc.launches
    finally:
        del net.medium.dl_take, net.kern.rx_front, net.kern.blind_all
    logs.extend(seen)
    tb = [u.metrics["tb_ok"] - b for u, b in zip(net.ues, tb_before)]
    assert min(tb) > 0 and launches > 0, (tb, launches)
    net.run(40)  # the rest of the offered packets, on the batched path
    got = [u.gw_rx.count(pkt) - b for u, pkt, b in zip(ues, pkts, rx_before)]
    assert got == [4] * PER_UE_UES, got
    log(f"per-UE fallback ({PER_UE_PRB} PRB, {PER_UE_UES} UEs): {PER_UE_TTIS} TTIs of "
        f"WaveUePhy.run_tti with no samples and no batch, {checked} UE-TTIs whose own front end "
        f"and blind search equal the batched one on the same samples (max abs err {max_err:.3e}, "
        f"DCI bits and RNTI residues equal); TBs decoded per UE {tb}, {launches} turbo_map "
        f"launches; every offered DL packet delivered; {card}")
    return launches


def phase_slice17(dev, card, known):
    """Phase 16.  Returns (the turbo_map cases at its shapes not in `known`,
    at every row count; the turbo_map_v1 cases at its shapes; its turbo_map
    launches; its turbo_map_v1 launches)."""
    import torch

    from srslte_emane_tpu_torch.phch import grid
    from srslte_emane_tpu_torch.runtime import waveblock_dyn as wbd
    from srslte_emane_tpu_torch.scripts import profile_turbo

    t_phase = time.perf_counter()
    logs, v1_logs, launches, seconds = [], [], {}, {}
    cell = grid.CellConfig(n_prb=100, cell_id=1, cfi=2)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        searches = {l: pool.submit(wbd.feasible_rntis, cell, n, l_aggr=l)
                    for l, n in DYN_L_UES.items()}
        t0 = time.perf_counter()
        profiles = step_profiles(card, logs, v1_logs)
        seconds["16a"] = time.perf_counter() - t0
        rntis = {l: f.result() for l, f in searches.items()}
    log(f"feasible_rntis at 100 PRB, cfi 2 by aggregation level: {json.dumps(rntis)} "
        f"({time.perf_counter() - t0:.1f} s with 16a)")
    steps = (("16b", lambda: step_tm3_condition(dev, card, logs)),
             ("16c", lambda: step_dyn_options(dev, card, logs, rntis)),
             ("16d", lambda: step_per_ue(dev, card, logs)))
    for name, step in steps:
        t0 = time.perf_counter()
        launches[name] = step()
        seconds[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cases = map_cases_logged(logs, known, dev, 16, card, select=every_map_shape)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    v1_cases = []
    for k, rows, w in sorted(set(v1_logs)):
        inp = profile_turbo.inputs(rows, k, dev)
        case = v1_case((inp["ls"], inp["lp"], *inp["tails"]), w, flush)
        n_launch = v1_logs.count((k, rows, w))
        log(f"turbo_map_v1 at {rows} x K={k} (W={w}, L={k // w}): {1e3 * case['ms']:.1f} us "
            f"(L2-flushed {1e3 * case['flushed_ms']:.1f} us, wrapper {1e3 * case['wrapper_ms']:.1f} "
            f"us, plain {1e3 * case['plain_ms']:.1f} us), bound {1e3 * case['bound_ms']:.3f} us "
            f"({case['bound_by']}), share {case['share']:.4f}, bit for bit, {case['cols_per_block']} "
            f"columns per block; launches at this shape in phase 16: {n_launch} (1 per call); {card}")
        v1_cases.append(case)
    seconds["kernel checks"] = time.perf_counter() - t0
    c16 = sum(n for n, _ in profiles.values()) + sum(launches.values())
    v1 = sum(n for _, n in profiles.values())
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s "
        f"({json.dumps({k: round(v, 1) for k, v in seconds.items()})}); turbo_map launches "
        f"{json.dumps({**{k: n for k, (n, _) in profiles.items()}, **launches})}, turbo_map_v1 "
        f"launches {v1}; {len(cases)} new turbo_map shapes, {len(v1_cases)} turbo_map_v1")
    return cases, v1_cases, c16, v1


# phase 17: the Viterbi kernel (csrc/viterbi.cu) against its plain loop at
# every shape the run's in-process phases gave it; the callers' K (UCI's 28
# and 38, PBCH 40, DCI 1A / 1 / 2A at 100 PRB 44 / 55 / 64, NPBCH 50) one
# row at a time for the dependent-step latency; tb_iter 1 and 5 beside the
# callers' 3
VIT_KS = (28, 38, 40, 44, 50, 55, 64)
# the subprocesses of phases 14-16 that decode control channels on the card
VIT_PROCESSES = ("waveform-full", "waveform-block", "waveform-dyn", "wavenet_smoke",
                 "bench_waveblock_dyn", "profile_dynblock")
VIT_TB_ITERS = (1, 5)
# (rows, K) on both sides of a block's shared memory: K = 1,210 (the last
# whose 4 rows fit at tb_iter 3) in shared memory; K = 1,211, NPDSCH's
# largest (TBS 2,536 + CRC16) and 4,000 with their decisions in device memory
VIT_GLOBAL_SHAPES = ((4, 1210), (4, 1211), (128, 2552), (2, 4000))
# the row sweep at the blind search's K = 44: one row (the chain's
# latency), partial last warps (3, 5, 2,817 rows), the DL subframe's 2,816
# rows and three times that
VIT_SWEEP_K, VIT_SWEEP_ROWS = 44, (1, 3, 5, 64, 512, 2816, 2817, 8448)


def viterbi_bound(rows, k, tb_iter):
    """The Viterbi's bound: read bm (R, K, 8) f32 and write the bits (R, K)
    int8; per row and trellis step 64 x (2 adds, 1 compare, 1 subtract) and
    63 max for the maximum over the states."""
    return bound(rows * k * (8 * 4 + 1), rows * tb_iter * k * (64 * 4 + 63))


def viterbi_inputs(rows, k, dev, seed):
    """(rows, 3, K) f32 stream LLRs at the decision threshold: BPSK of
    convolutionally encoded random bits at noise sigma 1.4, rounded to
    quarters (equal metrics), row 0 all zero (every decision a tie)."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import convcoder

    rng = np.random.default_rng(seed)
    bits = torch.from_numpy(rng.integers(0, 2, (rows, k), dtype=np.int8)).to(dev)
    x = 1.0 - 2.0 * convcoder.conv_encode(bits).float()
    noise = torch.from_numpy(rng.normal(0, 1.4, x.shape).astype(np.float32)).to(dev)
    x = torch.round(4 * (x + noise)) / 4
    x[0] = 0.0
    return x.contiguous()


def viterbi_case(inputs, tb_iter, flush, plain_n=3):
    """The kernel (through viterbi_decode) against viterbi_decode_ref on
    each LLR tensor of `inputs` (one shape), bit for bit, then on the first:
    the kernel's time warm and L2-flushed, the wrapper's and the plain
    loop's, the bound and share, blocks per SM."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import viterbi, viterbi_cuda

    bad = err = 0
    for x in inputs:
        n0 = viterbi_cuda.launches
        got = viterbi.viterbi_decode(x, tb_iter)
        ref = viterbi.viterbi_decode_ref(x, tb_iter)
        assert viterbi_cuda.launches == n0 + 1, "viterbi_decode did not launch the kernel once"
        assert got.dtype == torch.int8 and got.shape == ref.shape == (x.shape[0], x.shape[2])
        bad += int((got != ref).sum())
        err = max(err, int((got.int() - ref.int()).abs().max()))
    rows, _, k = inputs[0].shape
    assert bad == 0, f"viterbi at {rows} x K={k}, tb_iter {tb_iter}: {bad} bits differ"
    x = inputs[0]
    bm = viterbi.branch_metrics(x).contiguous()
    kernel = lambda: viterbi_cuda.launch(bm, tb_iter)
    bound_ms, bound_by = viterbi_bound(rows, k, tb_iter)
    ms = cuda_ms(kernel, 20)
    return dict(rows=rows, K=k, tb_iter=tb_iter, mismatched_bits=bad, max_abs_err=float(err),
                ms=ms, flushed_ms=cuda_ms(kernel, 20, flush),
                wrapper_ms=cuda_ms(lambda: viterbi.viterbi_decode(x, tb_iter), 20),
                plain_ms=cuda_ms(lambda: viterbi.viterbi_decode_ref(x, tb_iter), plain_n),
                bound_ms=bound_ms, bound_by=bound_by, share=bound_ms / ms,
                ns_per_step=1e6 * ms / (tb_iter * k),
                blocks_per_sm=viterbi_cuda.occupancy(k, tb_iter),
                rows_per_block=viterbi_cuda.rows_per_block())


def phase_viterbi(dev, card, vlog):
    """Phase 17.  Returns the Viterbi cases at every (rows, K, tb_iter) the
    in-process phases met (`vlog`), each bit for bit on the path's own LLRs
    and on tie and threshold LLRs."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import viterbi, viterbi_cuda

    t0 = time.perf_counter()
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    by_shape = collections.defaultdict(dict)
    for (phase, *key), n in vlog.seen.items():
        by_shape[tuple(key)][phase] = by_shape[tuple(key)].get(phase, 0) + n
    assert any(p in range(8, 14) for d in by_shape.values() for p in d), \
        "phases 8-13 made no Viterbi call on the card"
    cases = []
    for (rows, k, tb), per_phase in sorted(by_shape.items()):
        if rows == 0:  # no candidate: an empty result and no launch
            n0 = viterbi_cuda.launches
            out = viterbi.viterbi_decode(vlog.inputs[(rows, k, tb)], tb)
            assert tuple(out.shape) == (0, k) and viterbi_cuda.launches == n0
            log(f"viterbi at 0 x K={k}: empty result, no launch; calls by phase "
                f"{json.dumps(per_phase)}")
            continue
        synth = viterbi_inputs(rows, k, dev, rows * 1000 + k)
        case = viterbi_case([vlog.inputs[(rows, k, tb)], synth], tb, flush)
        case["calls_by_phase"] = per_phase
        log(f"viterbi kernel vs plain {json.dumps(case)}; {card}")
        cases.append(case)
    extra = []
    for k in VIT_KS:  # one row: the latency of the dependent chain
        extra.append(viterbi_case([viterbi_inputs(1, k, dev, k)], viterbi.TB_ITER, flush))
    for tb in VIT_TB_ITERS:
        extra.append(viterbi_case([viterbi_inputs(128, 44, dev, tb)], tb, flush))
    for c in extra:
        log(f"viterbi kernel vs plain {json.dumps(c)}; {card}")
    for rows in VIT_SWEEP_ROWS:
        c = viterbi_case([viterbi_inputs(rows, VIT_SWEEP_K, dev, rows)], viterbi.TB_ITER, flush,
                         plain_n=1)
        log(f"viterbi row sweep: {rows} x K={VIT_SWEEP_K}: {c['ns_per_step']:.1f} ns per step, "
            f"{1e3 * c['ms']:.2f} us (L2-flushed {1e3 * c['flushed_ms']:.2f}), "
            f"{c['blocks_per_sm']} blocks of {c['rows_per_block']} rows per SM, bound "
            f"{1e3 * c['bound_ms']:.3f} us, share {c['share']:.3f}, bit for bit; {card}")
        extra.append(c)
    # a K whose rows do not fit a block's shared memory takes the variant
    # with its decisions in device memory: bit for bit all the same
    for rows, k in VIT_GLOBAL_SHAPES:
        c = viterbi_case([viterbi_inputs(rows, k, dev, k)], viterbi.TB_ITER, flush, plain_n=1)
        where = "shared" if viterbi_cuda._lib().viterbi_fits(k, viterbi.TB_ITER) else "device"
        log(f"viterbi kernel vs plain, decisions in {where} memory {json.dumps(c)}; {card}")
        extra.append(c)
    log(f"phase 17: {time.perf_counter() - t0:.1f} s; {len(cases)} shapes of the run, "
        f"{len(extra)} more, every bit equal")
    return cases + extra


# ---------------- phase 18: the turbo decoder's loop on the card ----------------

LOOP_SWEEP_SNRS_DB = (8.0, 9.0, 10.0, 11.0, 12.0)  # the sweep's waterfall rows
# the phases whose turbo_decode calls phase 18 replays, by label
LOOP_PATHS = {4: "bench cell (phase 4)", 8: "DL subframe (phase 8)",
              9: "TM3 cell and the MIMO paths (phase 9)",
              12: "the graphed networks (phases 12-13)"}
ITER_OPS_PER_BIT = 6  # the epilogue's subtract, multiply, add, compare, and two XORs


def iter_bound(rows, k):
    """turbo_iter's bound for one pass: read post, ls_in and one of ls / ls2
    (f32), write ls_in (f32) and the bits (int8), read the three (K,) int32
    tables; ITER_OPS_PER_BIT operations per position."""
    return bound(rows * k * 17 + 12 * k, rows * k * ITER_OPS_PER_BIT)


def iter_inputs(k, rows, parity, dev, seed):
    """An epilogue's inputs: random LLRs, a posterior whose signs give CRC24B
    codewords in the first half of the rows (in the pass's order), some rows
    done and some passed before."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import crc, turbodecoder

    rng = np.random.default_rng(seed)
    perm, _, perm32, inv32 = turbodecoder._device_perms(k, dev)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    ls = f(rng.normal(0, 2, (rows, k)))
    payload = torch.from_numpy(rng.integers(0, 2, (rows, k - 24), dtype=np.int8)).to(dev)
    words = crc.crc_attach(payload, crc.LTE_CRC24B)
    words[rows // 2:] = torch.from_numpy(
        rng.integers(0, 2, (rows - rows // 2, k), dtype=np.int8)).to(dev)
    if parity:
        words = words[:, perm]
    return dict(post=((1 - 2.0 * words.float()) * f(rng.uniform(0.01, 9, (rows, k)))).contiguous(),
                ls_in=f(rng.normal(0, 3, (rows, k))), ls=ls, ls2=ls[:, perm].contiguous(),
                perm=perm32, inv=inv32, masks=crc.remainder_masks(*crc.LTE_CRC24B, k, dev),
                bits_out=torch.from_numpy(rng.integers(0, 2, (rows, k), dtype=np.int8)).to(dev),
                done=torch.from_numpy(rng.random(rows) < 0.3).to(dev),
                pass_out=torch.from_numpy(rng.random(rows) < 0.3).to(dev))


def iter_control(rows, dev, h=0, run=1, listed=None):
    """ctl and a row list for an epilogue call: h, the flag, map_rows 11,
    and the listed rows (every row by default)."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import turbo_iter_cuda as ti

    ctl, lst = ti.new_state(rows, dev)
    ctl[ti.H], ctl[ti.RUN], ctl[ti.ROWS] = h, run, 11
    listed = torch.arange(rows) if listed is None else torch.as_tensor(listed)
    lst[0] = len(listed)
    lst[1:1 + len(listed)] = listed.to(dev)
    return ctl, lst


def epilogue(fn, st, ctl, rows, parity, max_iter=8, n_stages=3):
    """One call of turbo_iter_cuda / turbo_iter_ref on iter_inputs' state."""
    fn(st["post"], st["ls_in"], st["ls"], st["ls2"], st["perm"], st["inv"], st["masks"],
       st["bits_out"], st["done"], st["pass_out"], ctl, rows, parity, max_iter, n_stages)


def iter_case(k, rows, dev, flush):
    """turbo_iter against turbo_iter_ref at (rows, K), both parities, flag
    set and clear, every row listed and a quarter of them (the cascade's
    last stage, which the pass may leave for none), every output, the
    control words and the row list bit for bit; then its time per working
    pass (every row, the flag kept set), warm and L2-flushed, a pass whose
    flag is clear, the plain version's, the bound and share."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import turbo_iter_cuda as ti

    bad = 0
    listed = list(range(rows - 1, -1, -4))  # a quarter, out of order
    for parity in (0, 1):
        for flag in (1, 0):
            for part in (None, listed):
                a = iter_inputs(k, rows, parity, dev, k + rows + parity)
                b = {n: v.clone() for n, v in a.items()}
                (ca, ra), (cb, rb) = (iter_control(rows, dev, 6 + parity, flag, part)
                                      for _ in range(2))
                epilogue(ti.turbo_iter_cuda, a, ca, ra, parity)
                epilogue(ti.turbo_iter_ref, b, cb, rb, parity)
                bad += (sum(int((a[n] != b[n]).sum()) for n in a) + int((ca != cb).sum())
                        + int((ra != rb).sum()))
    assert bad == 0, f"turbo_iter at {rows} x K={k}: {bad} values differ from the plain version"
    st = iter_inputs(k, rows, 0, dev, k)
    st["done"].zero_()  # no row done before (at one row, a done row stops every pass)
    ctl, lst = iter_control(rows, dev)
    # max_iter too large to end and one stage: every timed pass runs (the
    # second half of the rows carries no codeword, so never all pass)
    timed = lambda fn, parity: epilogue(fn, st, ctl, lst, parity, 10 ** 6, 1)
    ms = cuda_ms(lambda: timed(ti.turbo_iter_cuda, 0), 20)
    flushed = cuda_ms(lambda: timed(ti.turbo_iter_cuda, 1), 10, flush)
    plain = cuda_ms(lambda: timed(ti.turbo_iter_ref, 0), 3)
    assert int(ctl[ti.RUN]) == 1 and int(lst[0]) == rows, "the timed passes did not all run"
    ctl[ti.RUN] = 0
    idle = cuda_ms(lambda: timed(ti.turbo_iter_cuda, 0), 20)
    bound_ms, bound_by = iter_bound(rows, k)
    return dict(K=k, B=rows, mismatched_bits=bad, max_abs_err=0.0, ms=ms, flushed_ms=flushed,
                idle_ms=idle, plain_ms=plain, bound_ms=bound_ms, bound_by=bound_by,
                share=bound_ms / ms)


@contextlib.contextmanager
def decode_log(store, label):
    """Keeps the arguments of the first turbo decode on the card of each
    (K, rows, llr_bits) made inside the block (turbo_decode_device, which
    sch.decode_tb and turbo_decode call), cloned, in store[(label, K, rows,
    llr_bits)] as a dict of the decoder's parameters (turbo_decode's)."""
    import inspect

    from srslte_emane_tpu_torch.ops.fec import turbodecoder

    decode = turbodecoder.turbo_decode_device
    sig = inspect.signature(decode)

    def logged(*a, **kw):
        bound_args = sig.bind(*a, **kw)
        bound_args.apply_defaults()
        args = bound_args.arguments
        key = (label, args["k"], args["d0"].shape[0], args["llr_bits"])
        # on the card only (not the phases' comparisons on the CPU), with rows
        if key not in store and args["d0"].is_cuda and args["d0"].shape[0]:
            store[key] = {n: (v.clone() if hasattr(v, "clone") else v) for n, v in args.items()}
        return decode(*a, **kw)

    turbodecoder.turbo_decode_device = logged
    try:
        yield store
    finally:
        turbodecoder.turbo_decode_device = decode


def sweep_decodes(dev, store):
    """The sweep's cell (scripts/snr_sweep.py: the bench cell at each SNR,
    one default_rng(0) stream for the payloads, noise from a generator
    seeded 1) at 8-12 dB: each SNR's turbo_decode calls into `store`, and
    its (rx, cfg) for the rates."""
    import dataclasses

    import torch

    from srslte_emane_tpu_torch import bench
    from srslte_emane_tpu_torch.models import pdsch_link
    from srslte_emane_tpu_torch.ops import channel

    rng = np.random.default_rng(0)
    cells = {}
    for snr in LOOP_SWEEP_SNRS_DB:
        cfg = dataclasses.replace(bench.bench_config(16), snr_db=snr)
        payload = torch.from_numpy(rng.integers(0, 2, (BATCH, cfg.tbs), dtype=np.int8)).to(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        rx = channel.awgn(gen, pdsch_link.tx_subframe(payload, cfg), snr)
        with decode_log(store, f"sweep {snr:g} dB"):
            pdsch_link.rx_subframe(rx, cfg)
        cells[snr] = (rx, cfg)
    return cells


def count_syncs(fn):
    """Calls fn under torch.cuda.set_sync_debug_mode("warn") and returns
    (its result, the synchronising operations it made)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in seen)


def device_profile(fn, what):
    """(device kernels launched, their device ms, {kernel name: launches})
    of one call of fn, from torch.profiler; fails if two sessions in turn
    record no device kernel (the profiler has been seen to record none in a
    long process)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
        if ev:
            names = collections.Counter()
            for e in ev:
                names[e.key[:40]] += e.count
            return (sum(e.count for e in ev), sum(e.self_device_time_total for e in ev) / 1e3,
                    dict(names))
        log(f"{what}: the profiler recorded no device kernel; once more")
    raise AssertionError(f"{what}: the profiler recorded no device kernel twice")


def loop_case(label, args, flush):
    """One path's turbo_decode call, by both loops: the device loop under
    set_sync_debug_mode("error") and the host loop (turbo_decode_host, the
    pre-device-loop driver) give the same bits, CRC flags, n_iter, MAP
    passes and MAP rows; per decode each loop's host syncs, kernel
    launches and device ms (torch.profiler) and host-clock ms
    (synchronised, in turns)."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import turbodecoder

    kw = dict(args)
    host = lambda: turbodecoder.turbo_decode_host(**kw)
    new = lambda: turbodecoder.turbo_decode(**kw)
    turbodecoder.turbo_decode_device(**kw)  # the tables onto the card
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        bits, ok, n_iter, (passes, rows) = turbodecoder.turbo_decode_device(**kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    turbodecoder.map_rows = turbodecoder.map_passes = 0
    (h_bits, h_ok, h_iter), h_syncs = count_syncs(host)
    h_rows, h_passes = turbodecoder.map_rows, turbodecoder.map_passes
    (_, _, d_iter), d_syncs = count_syncs(new)
    assert torch.equal(bits, h_bits) and torch.equal(ok, h_ok), f"{label}: the loops disagree"
    assert int(n_iter) == h_iter == d_iter and int(rows) == h_rows and int(passes) == h_passes, \
        (f"{label}: n_iter {int(n_iter)} / {h_iter}, MAP rows {int(rows)} / {h_rows}, "
         f"MAP passes {int(passes)} / {h_passes}")
    assert d_syncs == 1, f"{label}: turbo_decode made {d_syncs} synchronising reads"
    what = f"{label} {kw['d0'].shape[0]} x K={kw['k']}"
    h_kernels, h_dev, h_names = device_profile(host, what + ", host loop")
    d_kernels, d_dev, d_names = device_profile(new, what + ", device loop")
    h_ms, d_ms = [], []
    for which in (host, new, new, host) * 3:
        (h_ms if which is host else d_ms).append(host_ms(which, 1))
    B = kw["d0"].shape[0]
    return dict(path=label, K=kw["k"], B=B, llr_bits=kw["llr_bits"], n_iter=h_iter,
                passes=h_rows / B, crc_pass=int(ok.sum()), equal=True,
                host_loop=dict(syncs=h_syncs, kernels=h_kernels, device_ms=h_dev,
                               ms=statistics.median(h_ms), by_kernel=h_names),
                device_loop=dict(syncs=d_syncs, kernels=d_kernels, device_ms=d_dev,
                                 ms=statistics.median(d_ms), by_kernel=d_names))


@contextlib.contextmanager
def host_loop():
    """turbodecoder.turbo_decode_device replaced by turbo_decode_host (as
    scripts/bench_extra.host_loop_decode) inside the block, for the paths'
    rates with the host-driven loop."""
    from srslte_emane_tpu_torch.ops.fec import turbodecoder
    from srslte_emane_tpu_torch.scripts.bench_extra import host_loop_decode

    decode = turbodecoder.turbo_decode_device
    turbodecoder.turbo_decode_device = host_loop_decode
    try:
        yield
    finally:
        turbodecoder.turbo_decode_device = decode


def phase_device_loop(dev, card, store):
    """Phase 18.  Returns the turbo_iter cases at the paths' shapes."""
    import torch

    from srslte_emane_tpu_torch import bench
    from srslte_emane_tpu_torch.models import pdsch_link
    from srslte_emane_tpu_torch.ops.fec import turbo_iter_cuda as ti, turbodecoder

    t0 = time.perf_counter()
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    cells = sweep_decodes(dev, store)
    labels = {key[0] for key in store}
    assert set(LOOP_PATHS.values()) <= labels, labels
    cases = []
    # both loops on each path's calls; the networks' many 1-6-row decodes
    # (phases 12-13) only at the epilogue's check below
    for key in sorted((k for k in store if k[0] != LOOP_PATHS[12]),
                      key=lambda key: (key[0], -key[2], key[1])):
        c = loop_case(key[0], store[key], flush)
        log(f"decode loop {json.dumps(c)}; {card}")
        cases.append(c)
    n = len(cases)
    for loop in ("host_loop", "device_loop"):
        log(f"decode loop, {loop}: per decode of the {n} path calls above, host syncs "
            f"{sum(c[loop]['syncs'] for c in cases) / n:.2f}, kernel launches "
            f"{sum(c[loop]['kernels'] for c in cases) / n:.1f}, device ms "
            f"{sum(c[loop]['device_ms'] for c in cases) / n:.3f}, host-clock ms "
            f"{sum(c[loop]['ms'] for c in cases) / n:.3f}; {card}")

    # the graph: one capture of the device loop on the bench cell's widest
    # call, replayed, bit-equal to the host loop
    kw = dict(store[max((k for k in store if k[0] == LOOP_PATHS[4]), key=lambda k: k[2])])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        turbodecoder.turbo_decode_device(**kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out = turbodecoder.turbo_decode_device(**kw)
    ref = turbodecoder.turbo_decode_host(**kw)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(g_out[0], ref[0]) and torch.equal(g_out[1], ref[1]), "graph replay"
        assert int(g_out[2]) == ref[2], "graph replay: n_iter"
    log(f"decode loop as a CUDA graph: {kw['d0'].shape[0]} x K={kw['k']} captured once, "
        f"replayed twice, bits, flags and n_iter equal to the host loop; replay "
        f"{cuda_ms(graph.replay, 10):.3f} ms against {cuda_ms(lambda: turbodecoder.turbo_decode_device(**kw), 10):.3f} ms "
        f"enqueued by the host (CUDA events)")

    # the number of record's cell and the sweep's waterfall: rates with each
    # loop, in turns
    from srslte_emane_tpu_torch.ops import channel

    cfg = bench.bench_config(16)
    payload = torch.from_numpy(
        np.random.default_rng(0).integers(0, 2, (BATCH, cfg.tbs), dtype=np.int8)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rx = channel.awgn(gen, pdsch_link.tx_subframe(payload, cfg), cfg.snr_db)
    for label, (rx_, cfg_), right in (
            ("bench cell 20 dB", (rx, cfg), lambda ok: bool(ok.all())),
            *((f"sweep {snr:g} dB", cells[snr], lambda ok: True) for snr in LOOP_SWEEP_SNRS_DB)):
        decode = lambda: pdsch_link.rx_subframe(rx_, cfg_)[1]
        res = {}
        for loop in ("host_loop", "device_loop", "device_loop", "host_loop"):
            with (host_loop() if loop == "host_loop" else contextlib.nullcontext()):
                r = rate(decode, check=right, iters=ITERS if label.startswith("bench") else 3)
                dms = cuda_ms(decode, 5)
            res.setdefault(loop, []).append((r[0], dms))
        with host_loop():
            bler = 1.0 - float(decode().float().mean())
        log(f"{label}: decode sf/s host loop {[round(x[0], 1) for x in res['host_loop']]}, "
            f"device loop {[round(x[0], 1) for x in res['device_loop']]}; device_ms (CUDA "
            f"events per decode) {[round(x[1], 3) for x in res['host_loop']]} / "
            f"{[round(x[1], 3) for x in res['device_loop']]}; BLER {bler:.4f}; {card}")

    # the epilogue kernel at the paths' shapes
    shapes = sorted({(key[1], key[2]) for key in store}, key=lambda s: -s[1])
    iter_cases = []
    for k, rows in shapes:
        c = iter_case(k, rows, dev, flush)
        log(f"turbo_iter kernel vs plain {json.dumps(c)}; {card}")
        iter_cases.append(c)
    log(f"phase 18: {time.perf_counter() - t0:.1f} s; {len(cases)} decodes equal under both "
        f"loops, turbo_iter bit for bit at {len(iter_cases)} shapes")
    return iter_cases


# ---------------- phase 19: the dynamic block as a replayed CUDA graph ----------------

# the HARQ block: phase 11's cell with UE 7 at -6 dB (it misses its DCIs, so
# its DL processes retransmit and drop after max_tx), as the harq case of
# tests/test_torch_waveblock.py lowers a UE's SNR at 15 PRB
GRAPH_HARQ_SNR_DB = (30.0,) * 7 + (-6.0,)


def kernel_counts():
    """The kernels' launch counts (the wrappers', replays included):
    turbo_map, turbo_iter's epilogue, its arm, the Viterbi, the DL-SCH
    encode's two kernels."""
    from srslte_emane_tpu_torch.ops.fec import sch_encode_cuda, turbo_iter_cuda as ti
    from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc, viterbi_cuda

    return dict(turbo_map=tdc.launches, turbo_iter=ti.launches, arm=ti.arm_launches,
                viterbi=viterbi_cuda.launches, sch_encode=sch_encode_cuda.launches)


def profile_counted(fn, label, control=True):
    """profile_block(fn, control), and the kernels' launch counts over
    that call (kernel_counts: for a replayed graph, what the capture counted
    times the replays) held equal to the runs of each kernel that the
    profiler recorded on the card.  The profiler has dropped a few events
    in a long process (PERF.md section 7), so a call whose counts differ is
    profiled once more; a second difference fails.  The DL-SCH encode's
    kernels are held to the card's own count instead: the code blocks that
    the card counted over the call equal those that the wrapper launched
    (late in this process the profiler loses every run of them in phase
    14a, and of sch_tb_crc_kernel in 14c)."""
    from srslte_emane_tpu_torch.ops.fec import sch_encode_cuda as sec

    for attempt in range(2):
        before = kernel_counts()
        blocks = sec.launched_blocks, sec.read_encode_blocks()
        prof = profile_block(fn, control=control)
        counted = {k: v - before[k] for k, v in kernel_counts().items()}
        launched, ran = sec.launched_blocks - blocks[0], sec.read_encode_blocks() - blocks[1]
        assert ran == launched and (launched > 0) == (counted["sch_encode"] > 0), \
            f"{label}: {counted['sch_encode']} encode launches of {launched} code blocks, " \
            f"{ran} run on the card"
        if dict(counted, sch_encode=None) == dict(prof["port_kernels"], sch_encode=None):
            return prof
        log(f"{label}: launch counts {counted}, runs on the card {prof['port_kernels']}"
            f"{'; once more' if attempt == 0 else ''}")
    raise AssertionError(f"{label}: the launch counts differ from the card's runs twice")


def graph_block(dev, label, cfg, n_cells, seed):
    """One block of phase 19 on the card: (its steps {"graph": jit=True,
    "eager": jit=False}, its inputs, a maker of its generators, (the graph's
    first call in s, the memory it reserved in MiB), the launches of one
    graph block by kernel, the graph's outputs).  The graph
    equals the eager block bit for bit on every output, counter and
    consumed pointer, leaves the generators in the eager block's states,
    and its launch counts (replays included) equal the eager block's, each
    kernel launched."""
    import torch

    from srslte_emane_tpu_torch.runtime import waveblock_dyn as wbd

    T, n, C = cfg.T, cfg.n_ues, n_cells
    rng = np.random.default_rng(seed)
    q = lambda tbs: torch.from_numpy(rng.integers(0, 2, (C, T, n, tbs), dtype=np.int8)).to(dev)
    dl_q, ul_q = q(cfg.dl_tbs), q(cfg.ul_tbs)
    rb = [wbd.make_schedule(cfg, seed=3 + c) for c in range(C)]
    rb_dl, rb_ul = (torch.from_numpy(np.stack([r[k] for r in rb])).to(dev) for k in (0, 1))
    args = (dl_q, ul_q, rb_dl, rb_ul) if C > 1 else (dl_q[0], ul_q[0], rb_dl[0], rb_ul[0])

    def gens(base):
        out = []
        for c in range(C):
            out.append(torch.Generator(device=dev))
            out[-1].manual_seed(base + c)
        return out if C > 1 else out[0]

    steps = dict(graph=wbd.make_dyn_block_step(cfg, n_cells=C),
                 eager=wbd.make_dyn_block_step(cfg, n_cells=C, jit=False))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    steps["graph"](*args, gens(100), 0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    reserved = (torch.cuda.memory_reserved() - reserved) / 2**20
    runs = {}
    for name, step in steps.items():
        g = gens(1)
        before = kernel_counts()
        out = step(*args, g, 0)
        torch.cuda.synchronize()
        after = kernel_counts()
        state = [x.get_state() for x in (g if C > 1 else [g])]
        runs[name] = out, state, {k: after[k] - before[k] for k in after}
    (out, state, counts), (ref, ref_state, ref_counts) = runs["graph"], runs["eager"]
    assert set(out) == set(ref), label
    for k in ref:
        assert torch.equal(out[k], ref[k]), f"{label}: the graph and the eager block differ at {k}"
    assert all(torch.equal(a, b) for a, b in zip(state, ref_state)), f"{label}: generator states"
    assert counts == ref_counts and min(counts.values()) > 0, (label, counts, ref_counts)
    log(f"{label}: the graph equals the eager block bit for bit on all {len(out)} outputs "
        f"(counters and consumed pointers included), generators left equal; launches per block "
        f"{json.dumps(counts)} both ways; graph first call (warm-up, capture, {cfg.R} replays) "
        f"{first_s:.2f} s; dl_ok {int(out['dl_ok'].sum())}, ul_ok {int(out['ul_ok'].sum())}, "
        f"ack {int(out['ack_det'].sum())} of {C * T * n}, dl_retx_tx "
        f"{out['dl_retx_tx'].tolist()}, dl_drop {out['dl_drop'].tolist()}, dci misses "
        f"{(out['dci_dl_miss'] + out['dci_ul_miss']).tolist()}; the first call reserved "
        f"{reserved:.1f} MiB more (the warm-up's blocks, the graph's pool)")
    return steps, args, gens, (first_s, reserved), counts, out


def graph_timing(steps, args, gens, ttis, card):
    """Graph against eager, in turns (graph, eager, eager, graph): TTIs/s
    (median of N_RUNS, spread), CUDA-event ms per block, host ms per block
    (to the call's return, and to the card's end), a profile of one block
    (busy share, device ms, kernel and host launches) and peak memory."""
    import torch

    res = {name: collections.defaultdict(list) for name in steps}
    for name in ("graph", "eager", "eager", "graph"):
        fn = lambda: steps[name](*args, gens(7), 0)
        (med, spread, rates), event_ms = block_timing(fn, ttis)
        enq, whole = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            enq.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            whole.append(1e3 * (time.perf_counter() - t0))
        r = res[name]
        r["tti_per_s"].append(med)
        r["spread_pct"].append(round(spread, 2))
        r["event_ms"].append(round(event_ms, 3))
        r["host_return_ms"].append(round(statistics.median(enq), 3))
        r["host_ms"].append(round(statistics.median(whole), 3))
    for name, step in steps.items():
        fn = lambda: step(*args, gens(7), 0)
        res[name]["profile"] = profile_counted(fn, f"graph vs eager: the {name} block")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        res[name]["peak_allocated_mib"] = round(torch.cuda.max_memory_allocated() / 2**20, 1)
        res[name]["peak_reserved_mib"] = round(torch.cuda.max_memory_reserved() / 2**20, 1)
    return {k: dict(v) for k, v in res.items()}


def phase_graph(dev, card):
    """Phase 19.  Returns the kernels' launches of its graph blocks (the
    equality runs), by kernel."""
    import torch

    t_phase = time.perf_counter()
    cfg = dyn_config(DYN_R)
    launches = collections.Counter()
    steps, args, gens, (first_s, pool_mib), counts, _ = graph_block(
        dev, "graph: phase 11's block", cfg, 1, 0)
    launches.update(counts)

    # two successive blocks on one generator against two eager blocks
    outs = {}
    for name, step in steps.items():
        g = gens(2)
        outs[name] = [step(*args, g, 0), step(*args, g, 8 * DYN_R)], g.get_state()
    for a, b in zip(outs["graph"][0], outs["eager"][0]):
        assert all(torch.equal(a[k], b[k]) for k in b), "graph: two successive blocks differ"
    assert torch.equal(outs["graph"][1], outs["eager"][1]), "graph: generator after two blocks"
    log("graph: two successive blocks on one generator equal two eager blocks on one generator, "
        "every output, and the generator's state after them")

    # no host sync from the first replay to the return (the inputs on the
    # card: the whole call enqueues only)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = steps["graph"](*args, gens(3), 0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert dyn_block_right(out, args[0], args[1], args[2]), "graph: the sync-free block is wrong"
    log("graph: one whole call (copies in, reset, R replays, copies out) under "
        "torch.cuda.set_sync_debug_mode(\"error\"): no synchronising operation")

    res = graph_timing(steps, args, gens, cfg.T, card)
    host = res["graph"]["profile"]["host_launches"]
    assert host <= DYN_R + 64, f"graph: {host} host launches per block, above R + 64"
    summary = {name: dict(
        tti_per_s=round(statistics.median(r["tti_per_s"]), 1), runs=[round(x, 1) for x in
                                                                     r["tti_per_s"]],
        spread_pct=r["spread_pct"], event_ms=r["event_ms"], host_ms=r["host_ms"],
        host_return_ms=r["host_return_ms"], host_launches=r["profile"]["host_launches"],
        busy_share=r["profile"]["busy_share"], device_ms=r["profile"]["device_ms"],
        kernel_launches=r["profile"]["kernel_launches"],
        peak_allocated_mib=r["peak_allocated_mib"], peak_reserved_mib=r["peak_reserved_mib"])
        for name, r in res.items()}
    summary["graph"].update(first_call_s=round(first_s, 3),
                            first_call_reserved_mib=round(pool_mib, 1))
    log(f"graph vs eager, phase 11's block (R={DYN_R}, {cfg.T} TTIs), in turns: "
        f"{json.dumps(summary)}; {card}")
    log(f"graph vs eager: TTIs/s x {summary['graph']['tti_per_s'] / summary['eager']['tti_per_s']:.2f}, "
        f"host launches {summary['graph']['host_launches']} vs {summary['eager']['host_launches']}, "
        f"busy share {summary['graph']['busy_share']} vs {summary['eager']['busy_share']}, "
        f"device ms {summary['graph']['device_ms']} vs {summary['eager']['device_ms']}; {card}")
    log(f"graph profile {json.dumps(res['graph']['profile'])}; eager profile "
        f"{json.dumps(res['eager']['profile'])}")
    del steps

    for label, c, cells, seed in (("graph: the HARQ block", cfg._replace(snr_db=GRAPH_HARQ_SNR_DB),
                                   1, 0),
                                  ("graph: 2 cells", cfg, 2, 1)):
        steps, args, gens, _, counts, out = graph_block(dev, label, c, cells, seed)
        launches.update(counts)
        if cells == 1:
            assert int(out["dl_retx_tx"]) > 0 and int(out["dl_drop"]) > 0 and \
                int(out["dci_dl_miss"]) > 0, f"{label}: no retransmission, drop or DCI miss"
        rates = {}
        for name in ("graph", "eager", "eager", "graph"):
            rates.setdefault(name, []).append(rate(lambda: steps[name](*args, gens(9), 0),
                                                   per_call=cells * c.T, iters=1)[0])
        log(f"{label}: cell-TTIs/s graph {[round(x, 1) for x in rates['graph']]} vs eager "
            f"{[round(x, 1) for x in rates['eager']]} (in turns; each a median of {N_RUNS}); "
            f"{card}")
        del steps
    log(f"phase 19: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches)


SCH_CELL = dict(tbs=51024, G=90000, Qm=6, Nl=1)  # the benchmark cell: 9 x K=5,696
SCH_CASES = (  # (name, SchConfig arguments, rows, timed)
    ("cell", SCH_CELL, BATCH, True),
    ("phase 4", dict(tbs=49472, G=90000, Qm=6, Nl=1), BATCH, False),  # 16 fillers
    ("one row", dict(tbs=4416, G=11520, Qm=4, Nl=1), 1, True),  # 1 x K=4,480, 40 fillers
) + tuple((f"rv {rv}, ncb 3000", dict(tbs=6968, G=15000, Qm=6, Nl=1, rv=rv, ncb=3000), 8,
           False) for rv in range(4))


def sch_case(name, kw, rows, timed, dev, flush, rv_b=None):
    """The encode kernel (through sch.encode_tb) against sch.encode_tb_ref
    on the card, bit for bit, with its launches and the code blocks the card
    counted; if timed, the kernel's time (sch_encode_cuda.launch) warm and
    L2-flushed, the plain version's, the bound (the payload read and the
    codeword written, one byte a bit) and the share."""
    import torch

    from srslte_emane_tpu_torch.ops.fec import sch_encode_cuda as sec
    from srslte_emane_tpu_torch.phch import sch

    cfg = sch.SchConfig(**kw)
    C = cfg.segm.C
    bits = torch.from_numpy(np.random.default_rng(rows + cfg.tbs).integers(
        0, 2, (rows, cfg.tbs), dtype=np.int8)).to(dev)
    sch.read_encode_blocks()
    sch.reset_encode_blocks()
    n0 = sec.launches
    got = sch.encode_tb(bits, cfg, rv_b=rv_b)
    ref = sch.encode_tb_ref(bits, cfg, rv_b=rv_b)
    launches = sec.launches - n0
    assert launches == (2 if C > 1 else 1), f"sch_encode {name}: {launches} launches"
    assert sch.read_encode_blocks() == rows * C, f"sch_encode {name}: code blocks miscounted"
    bad = int((got != ref).sum())
    assert bad == 0, f"sch_encode {name}: {bad} bits differ from the plain version"
    out = dict(case=name, rows=rows, tbs=cfg.tbs, G=cfg.G, code_blocks=rows * C,
               K=sorted(set(cfg.segm.cb_sizes)), F=cfg.segm.F, launches=launches,
               mismatched_bits=bad, max_abs_err=0.0 if bad == 0 else 1.0)
    if timed:
        e = tuple(cfg.e_sizes)
        kernel = lambda: sec.launch(bits, e, cfg.rv, cfg.ncb)
        bound_ms, bound_by = bound(rows * (cfg.tbs + cfg.G), 0)
        ms = cuda_ms(kernel, 50)
        out.update(ms=ms, flushed_ms=cuda_ms(kernel, 50, flush),
                   plain_ms=cuda_ms(lambda: sch.encode_tb_ref(bits, cfg), 5),
                   bound_ms=bound_ms, bound_by=bound_by, share=bound_ms / ms)
    return out


def phase_sch_encode(dev, card):
    """Phase 20.  Returns the encode kernel's cases, the benchmark cell's
    first."""
    import torch

    from srslte_emane_tpu_torch.models import pdsch_link
    from srslte_emane_tpu_torch.phch import grid, sch
    from srslte_emane_tpu_torch.runtime import graphs

    t_phase = time.perf_counter()
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    cases = [sch_case(*c, dev, flush) for c in SCH_CASES]
    rv_b = torch.tensor([0, 1, 2, 3, 3, 2, 1, 0], device=dev)
    cases.append(sch_case("per-row rv_b", dict(tbs=6968, G=15000, Qm=6, Nl=1, ncb=3000), 8,
                          False, dev, flush, rv_b))
    for c in cases:
        log(f"sch_encode vs plain {json.dumps(c)}")

    # the benchmark cell's encode step, graphed: the card counts every code block
    cfg = pdsch_link.LinkConfig(cell=grid.CellConfig(n_prb=100, cell_id=1, cfi=1), sf_idx=1,
                                rnti=0x46, qm=6, code_rate=0.56724, llr_bits=16)
    assert (cfg.tbs, cfg.sch_cfg.segm.C) == (51024, 9), (cfg.tbs, cfg.sch_cfg.segm)
    step = graphs.jit(lambda p: pdsch_link.tx_subframe(p, cfg))
    payload = torch.from_numpy(np.random.default_rng(20).integers(
        0, 2, (BATCH, cfg.tbs), dtype=np.int8)).to(dev)
    step(payload)  # warm-up, capture, one replay
    torch.cuda.synchronize()
    sch.read_encode_blocks()
    sch.reset_encode_blocks()
    for _ in range(3):
        step(payload)
    torch.cuda.synchronize()
    per_call = sch.read_encode_blocks() / 3
    assert per_call == BATCH * 9, f"the cell's encode step encoded {per_call} code blocks a call"
    log(f"sch_encode: the cell's graphed encode step encodes {per_call:.0f} code blocks a call "
        f"({card})")
    log(f"phase 20: {time.perf_counter() - t_phase:.1f} s")
    return cases


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

    from srslte_emane_tpu_torch.ops.fec import (sch_encode_cuda as sec, turbo_iter_cuda as ti,
                                                turbodecoder_cuda as tdc, viterbi_cuda)

    count_replays_in_logs()
    t0 = time.perf_counter()
    sources = (tdc.SOURCE, tdc.SOURCE_V1, viterbi_cuda.SOURCE, ti.SOURCE, sec.SOURCE)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        builds = list(pool.map(tdc.build, sources))
    log(f"build: {time.perf_counter() - t0:.1f} s wall for all five")
    for b in builds:
        log(f"build: {b.seconds:.1f} s -> {b.path}")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas: {line.strip()}")

    t_run = time.perf_counter()
    cases = phase_kernel(dev)
    # the main paths, every call of the Viterbi counted and its shape kept,
    # every launch of the decoder's epilogue counted, the first turbo_decode
    # call of each shape on phases 4, 8, 9, 12 and 13 kept for phase 18
    viterbi_cuda.launches = ti.launches = ti.arm_launches = sec.launches = 0
    sec.reset_encode_blocks()
    decodes = {}
    with ViterbiLog(dev) as vlog:
        vlog.phase = 4
        with decode_log(decodes, LOOP_PATHS[4]):
            dl_launches = phase_main_path(dev, card)
        vlog.phase = 5
        v1_cases, v1_launches = phase_v1(dev)
        vlog.phase = 6
        ul_launches = phase_uplink(dev)
        vlog.phase = 7
        phase_cascade(dev)
        vlog.phase = 8
        with decode_log(decodes, LOOP_PATHS[8]):
            sf_launches = phase_dl_subframe(dev, card)
        vlog.phase = 9
        with decode_log(decodes, LOOP_PATHS[9]):
            mimo_cases, tm3_launches = phase_mimo(dev, card)
        vlog.phase = 10
        sync_cases, sync_launches = phase_sync(dev, card)
        vlog.phase = 11
        block_cases, block_launches = phase_blocks(dev, card)
        vlog.phase = 12
        with decode_log(decodes, LOOP_PATHS[12]):
            net_cases, net_launches = phase_network(dev, card)
        known = tuple((c["K"], c["B"], (c["narrow"],)) for c in (
            cases + mimo_cases + sync_cases + block_cases + net_cases))
        vlog.phase = 13
        with decode_log(decodes, LOOP_PATHS[12]):
            c13_cases, c13_launches = phase_slice13c(dev, card, known)
        known += tuple((c["K"], c["B"], (c["narrow"],)) for c in c13_cases)
        vlog.phase = 14
        c14_cases, c14_launches = phase_slice14(dev, card, known)
        known += tuple((c["K"], c["B"], (c["narrow"],)) for c in c14_cases)
        vlog.phase = 15
        c15_cases, c15_launches = phase_entry_points(dev, card, known)
        known += tuple((c["K"], c["B"], (c["narrow"],)) for c in c15_cases)
        vlog.phase = 16
        c16_cases, c16_v1_cases, c16_launches, c16_v1_launches = phase_slice17(dev, card, known)
    vit_launches = viterbi_cuda.launches
    iter_launches, arm_launches = ti.launches, ti.arm_launches
    log(f"turbo_iter: {iter_launches} epilogue and {arm_launches} arm launches in phases 4-16 "
        f"in this process")
    assert iter_launches > 0 and arm_launches > 0, "the main paths did not launch turbo_iter"
    by_phase = collections.Counter()
    for (phase, *_), n in vlog.seen.items():
        by_phase[phase] += n
    sub = vlog.process_launches
    log(f"viterbi: {vit_launches} kernel launches in phases 4-16 in this process, "
        f"{sum(sub.values())} in the subprocesses of phases 14-16 {json.dumps(dict(sub))}; "
        f"calls by phase {json.dumps(dict(sorted(by_phase.items())))}")
    assert all(by_phase[p] > 0 for p in (8, 10, 11, 12, 13, 14, 15, 16)), by_phase
    assert all(sub[label] > 0 for label in VIT_PROCESSES), sub
    vit_cases = phase_viterbi(dev, card, vlog)
    iter_cases = phase_device_loop(dev, card, decodes)
    graph_launches = phase_graph(dev, card)
    sch_launches = sec.launches  # every encode of phases 4-19 in this process, replays included
    sch_cases = phase_sch_encode(dev, card)
    sf_vit = max((c for c in vit_cases if 8 in c.get("calls_by_phase", {})),
                 key=lambda c: c["rows"])  # phase 8's blind search
    log(f"chip_smoke: {time.perf_counter() - t_run:.1f} s after the build")
    bench = next(c for c in cases if (c["K"], c["B"], c["narrow"]) == (5504, 768, True))
    bench_iter = next(c for c in iter_cases if (c["K"], c["B"]) == (5504, 768))
    odd = next(c for c in v1_cases if (c["K"], c["B"]) == (1040, 768))
    print(json.dumps({"kernels": [{
        "name": "turbo_map",
        "route": "cuda",
        "source": "srslte_emane_tpu_torch/csrc/turbo_map.cu",
        "replaces": "srslte_emane_tpu/ops/fec/turbodecoder_pallas2.py:70",
        # PDSCH link, uplink, DL subframe, TM3 cell, phase 10's to 16's paths
        "launches": (dl_launches + ul_launches + sf_launches + tm3_launches + sync_launches
                     + block_launches + net_launches + c13_launches + c14_launches
                     + c15_launches + c16_launches + graph_launches["turbo_map"]),
        "max_abs_err": max(c["max_abs_err"] for c in cases + mimo_cases + sync_cases
                           + block_cases + net_cases + c13_cases + c14_cases + c15_cases
                           + c16_cases),
        # LLRs that differ from the plain version's: 0 is bit for bit
        "mismatched_bits": sum(c.get("mismatched", 0) for c in cases + mimo_cases + sync_cases
                               + block_cases + net_cases + c13_cases + c14_cases + c15_cases
                               + c16_cases),
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
        "launches": v1_launches + c16_v1_launches,  # the odd-window path, profile_turbo
        "max_abs_err": max(c["max_abs_err"] for c in v1_cases + c16_v1_cases),
        "mismatched_bits": sum(c["mismatched"] for c in v1_cases + c16_v1_cases),
        "ms": odd["ms"],
        "wrapper_ms": odd["wrapper_ms"],
        "plain_ms": odd["plain_ms"],
        "bound_ms": odd["bound_ms"],
        "bound_by": odd["bound_by"],
        "share": odd["share"],
        "library_ms": None,
    }, {
        "name": "viterbi",
        "route": "cuda",
        "source": "srslte_emane_tpu_torch/csrc/viterbi.cu",
        "replaces": "srslte_emane_tpu/ops/fec/viterbi.py:53",
        # phases 4-16, subprocesses too, and phase 19's graph blocks
        "launches": vit_launches + sum(sub.values()) + graph_launches["viterbi"],
        "max_abs_err": max(c["max_abs_err"] for c in vit_cases),  # bits: 0 is bit for bit
        "mismatched_bits": sum(c["mismatched_bits"] for c in vit_cases),
        "ms": sf_vit["ms"],
        "wrapper_ms": sf_vit["wrapper_ms"],
        "plain_ms": sf_vit["plain_ms"],
        "bound_ms": sf_vit["bound_ms"],
        "bound_by": sf_vit["bound_by"],
        "share": sf_vit["share"],
        "rows": sf_vit["rows"],
        "K": sf_vit["K"],
        "library_ms": None,  # no PyTorch call computes a Viterbi decode
    }, {
        "name": "turbo_iter",
        "route": "cuda",
        "source": "srslte_emane_tpu_torch/csrc/turbo_iter.cu",
        "replaces": "srslte_emane_tpu/ops/fec/turbodecoder.py:421",
        # phases 4-16 and 19, this process; arm launches apart
        "launches": iter_launches + graph_launches["turbo_iter"],
        "arm_launches": arm_launches + graph_launches["arm"],
        "max_abs_err": max(c["max_abs_err"] for c in iter_cases),
        "mismatched_bits": sum(c["mismatched_bits"] for c in iter_cases),
        "ms": bench_iter["ms"],
        "idle_ms": bench_iter["idle_ms"],
        "plain_ms": bench_iter["plain_ms"],
        "bound_ms": bench_iter["bound_ms"],
        "bound_by": bench_iter["bound_by"],
        "share": bench_iter["share"],
        "rows": bench_iter["B"],
        "K": bench_iter["K"],
        "library_ms": None,  # no single PyTorch call computes this epilogue
    }, {
        "name": "sch_encode",
        "route": "cuda",
        "source": "srslte_emane_tpu_torch/csrc/sch_encode.cu",
        "replaces": None,  # the JAX package leaves this encode to XLA (phch/sch.py encode_tb)
        "launches": sch_launches,  # phases 4-19, this process, replays included
        "max_abs_err": max(c["max_abs_err"] for c in sch_cases),  # bits: 0 is bit for bit
        "mismatched_bits": sum(c["mismatched_bits"] for c in sch_cases),
        "ms": sch_cases[0]["ms"],
        "flushed_ms": sch_cases[0]["flushed_ms"],
        "plain_ms": sch_cases[0]["plain_ms"],
        "bound_ms": sch_cases[0]["bound_ms"],
        "bound_by": sch_cases[0]["bound_by"],
        "share": sch_cases[0]["share"],
        "rows": sch_cases[0]["rows"],
        "code_blocks": sch_cases[0]["code_blocks"],
        "library_ms": None,  # no PyTorch call computes a DL-SCH encode
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
