#!/usr/bin/env python3
"""Device time of the port's downlink, uplink, downlink-subframe and 2x2
TM3 decodes, by kernel, on one CUDA card.

Run from the repository root:  python3 scripts/torch_profile_link.py [cell ...]
(cells: dl_decode ul_decode dl_subframe_decode tm3_decode; default all)

For each of chip_smoke.py's four cells (the 20 MHz PDSCH and PUSCH
decodes, the four-grant downlink subframe's `ue_dl.decode_subframe`, and
the 2x2 TM3 cell's `ofdm.demodulate` + `pdsch.decode_tm`, batch 128),
after two warm-up calls: the host-clock time per call over 10
synchronised calls, then torch.profiler over 5 calls: the device time per
call (the sum of the CUDA kernels' device time), the busy share (device
time over the profiled wall time, which includes the profiler's own
overhead, so the share is a lower bound), the kernel launches per call,
the MAP kernel's device time and launches per call, and the six kernels
with the most device time.  Prints one JSON line per cell, after the
card's name and power limit.
"""

import importlib.util
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CALLS = 5


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profile(name, fn):
    from torch.profiler import ProfilerActivity, profile as tprofile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 10
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the kernels themselves (an aten op's row repeats its kernels' device time)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    map_k = [e for e in kernels if "map_kernel" in e.key]
    return dict(cell=name, host_ms_per_call=host_ms, profiled_wall_ms_per_call=wall_ms / CALLS,
                device_ms_per_call=device_ms / CALLS, busy_share=device_ms / wall_ms,
                launches_per_call=sum(e.count for e in kernels) / CALLS,
                map_ms_per_call=sum(e.self_device_time_total for e in map_k) / 1e3 / CALLS,
                map_launches_per_call=sum(e.count for e in map_k) / CALLS,
                top=[(e.key[:60], e.self_device_time_total / 1e3 / CALLS, e.count / CALLS)
                     for e in top])


def main():
    if not torch.cuda.is_available():
        print("torch_profile_link: torch.cuda is not available", file=sys.stderr)
        return 1
    from srslte_emane_tpu_torch.models import enb_dl, pdsch_link, ue_dl, ue_ul
    from srslte_emane_tpu_torch.ops import channel, ofdm
    from srslte_emane_tpu_torch.phch import grid, pdsch

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    cs = smoke()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    cells = sys.argv[1:] or ["dl_decode", "ul_decode", "dl_subframe_decode", "tm3_decode"]
    if "dl_decode" in cells:
        cfg = pdsch_link.LinkConfig(cell=grid.CellConfig(n_prb=100, cell_id=1, cfi=1), qm=6,
                                    code_rate=0.55, snr_db=20.0, sf_idx=1, llr_bits=16)
        pay = torch.from_numpy(
            np.random.default_rng(0).integers(0, 2, (cs.BATCH, cfg.tbs), dtype=np.int8)).to(dev)
        gen.manual_seed(0)
        rx = channel.awgn(gen, pdsch_link.tx_subframe(pay, cfg), cfg.snr_db)
        print(json.dumps(profile("dl_decode", lambda: pdsch_link.rx_subframe(rx, cfg))), flush=True)
    if "ul_decode" in cells:
        ucfg = cs.ul_bench_config()
        upay = torch.from_numpy(
            np.random.default_rng(2).integers(0, 2, (cs.BATCH, ucfg.tbs), dtype=np.int8)).to(dev)
        gen.manual_seed(2)
        urx = channel.awgn(gen, ue_ul.build_subframe(ucfg, tb_bits=upay), 14.0)
        print(json.dumps(profile("ul_decode", lambda: ue_ul.enb_receive(urx, ucfg, llr_bits=16))),
              flush=True)
    if "dl_subframe_decode" in cells:
        scfg = cs.dl_subframe_config(1)
        rng = np.random.default_rng(8)
        spay = [torch.from_numpy(rng.integers(0, 2, (cs.BATCH, g[3]), dtype=np.int8)).to(dev)
                for g in scfg.grants]
        gen.manual_seed(8)
        srx = channel.awgn(gen, enb_dl.build_subframe(scfg, spay), cs.DL_SF_SNR_DB)
        print(json.dumps(profile("dl_subframe_decode",
                                 lambda: ue_dl.decode_subframe(srx, scfg))), flush=True)
    if "tm3_decode" in cells:
        cell, mask, cfgs = cs.tm3_cell()
        rng = np.random.default_rng(9)
        tpay = [torch.from_numpy(rng.integers(0, 2, (cs.BATCH, c.tbs), dtype=np.int8)).to(dev)
                for c in cfgs]
        h = cs.flat_channel(rng, cs.BATCH, 2, 2, 3.5, dev)
        gen.manual_seed(9)
        tx = ofdm.modulate(pdsch.encode_tm(tpay, cfgs, cell, 1, cs.TM3_RNTI, mask, "tm3"), 100)
        trx = channel.mimo_flat(gen, tx, h, cs.TM3_SNR_DB)
        print(json.dumps(profile("tm3_decode", lambda: pdsch.decode_tm(
            ofdm.demodulate(trx, 100), cfgs, cell, 1, cs.TM3_RNTI, mask, "tm3", llr_bits=16))),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
