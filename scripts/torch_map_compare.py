#!/usr/bin/env python3
"""The PyTorch port's MAP kernels and link decode rates, tree against tree,
on one CUDA card.

Run from the repository root, with other checkouts of the port unpacked
beside it (for example `git archive <commit> | tar -x -C build/parent`):

    python3 scripts/torch_map_compare.py build/parent . . build/parent

Each tree named runs in a process of its own, in the order given (so
parent, change, change, parent takes turns on the same card), and prints
one JSON line: at each of chip_smoke.py's MAP_SHAPES the turbo_map kernel
alone warm and with L2 flushed between launches, the wrapper
`map_decode_cuda`, and the bound; the same for the turbo_map_v1 kernel and
`map_decode_v1_cuda` at chip_smoke.py's V1_SHAPES, and the decode time of
its odd-window path (turbo_decode at L=33); then the downlink and uplink
cells' decode and encode rates in subframes/s (chip_smoke.py's cells, batch
128, median of 5 runs of 10 calls); last, `pbch.decode` on phase 8's sf 0
subframe (100 PRB, batch 16): its median ms of 9 synchronised calls, and
the mean ms of its Viterbi call.  A tree whose kernels take inputs
prepared in torch (the port's first designs: time-major windows for
turbo_map, branch metrics and window-edge states for v1) has them prepared
outside the timed launch; its wrappers are timed whole.
"""

import importlib.util
import inspect
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_RUNS = 5


def smoke():
    """This checkout's chip_smoke.py, loaded by path (each tree has one)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rate(fn, check=lambda out: True):
    import torch

    cs = smoke()
    fn()
    torch.cuda.synchronize()
    rates = []
    for _ in range(N_RUNS):
        t0 = time.perf_counter()
        for _ in range(cs.ITERS):
            out = fn()
        torch.cuda.synchronize()
        rates.append(cs.BATCH * cs.ITERS / (time.perf_counter() - t0))
        assert check(out), "a timed run produced a wrong result"
    return statistics.median(rates), rates


def child(tree):
    import numpy as np
    import torch

    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    from srslte_emane_tpu_torch.models import enb_dl, pdsch_link, ue_ul
    from srslte_emane_tpu_torch.ops import channel, ofdm
    from srslte_emane_tpu_torch.ops.fec import turbodecoder, turbodecoder_cuda as tdc, viterbi
    from srslte_emane_tpu_torch.phch import chest, grid, pbch

    cs = smoke()
    dev = torch.device("cuda", 0)
    time_major = "ls_t" in inspect.signature(tdc.launch).parameters
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    out = {"tree": tree, "package": str(pathlib.Path(tdc.__file__).resolve()), "map": []}
    for k, batch, modes in cs.MAP_SHAPES:
        args = cs.map_inputs(k, batch, dev)
        w = turbodecoder._pick_windows(k)
        beta_k = turbodecoder.beta_tail(*args[2:]).contiguous()
        for narrow in modes:
            if time_major:
                ls_t, lp_t = (tdc.time_major(a, w, narrow) for a in args[:2])
                kernel = lambda: tdc.launch(ls_t, lp_t, beta_k, w, k // w)
            else:
                kernel = lambda: tdc.launch(args[0], args[1], beta_k, w, narrow)
            wrapper = lambda: tdc.map_decode_cuda(*args, w, narrow)
            wrapper()
            torch.cuda.synchronize()
            bound_ms, bound_by = cs.map_bound(k, batch, w, narrow)
            ms = cs.cuda_ms(kernel, 20)
            out["map"].append(dict(K=k, B=batch, narrow=narrow, ms=ms,
                                   flushed_ms=cs.cuda_ms(kernel, 20, flush),
                                   wrapper_ms=cs.cuda_ms(wrapper, 20), bound_ms=bound_ms,
                                   bound_by=bound_by, share=bound_ms / ms))

    v1_prepared = "g" in inspect.signature(tdc.launch_v1).parameters
    out["v1"] = []
    for k, batch, w in cs.V1_SHAPES:
        args = cs.random_llrs(k, batch, dev, k + w)
        if v1_prepared:
            prepared = tdc._v1_inputs(*args, w)
            kernel = lambda: tdc.launch_v1(*prepared)
        else:
            beta_k = turbodecoder.beta_tail(*args[2:]).contiguous()
            kernel = lambda: tdc.launch_v1(args[0], args[1], beta_k, w)
        wrapper = lambda: tdc.map_decode_v1_cuda(*args, w)
        wrapper()
        torch.cuda.synchronize()
        bound_ms, bound_by = cs.v1_bound(k, batch, w)
        ms = cs.cuda_ms(kernel, 20)
        out["v1"].append(dict(K=k, B=batch, W=w, L=k // w, ms=ms,
                              flushed_ms=cs.cuda_ms(kernel, 20, flush),
                              wrapper_ms=cs.cuda_ms(wrapper, 20), bound_ms=bound_ms,
                              bound_by=bound_by, share=bound_ms / ms))
    decode, bits = cs.odd_window_decode(dev)
    with cs.window_count(cs.ODD_W):
        got, ok, _ = decode()
        assert bool(ok.all()) and torch.equal(got, bits), "odd-window decode failed"
        out["odd_window_decode_ms"] = cs.host_ms(decode, 9)

    cfg = pdsch_link.LinkConfig(cell=grid.CellConfig(n_prb=100, cell_id=1, cfi=1), qm=6,
                                code_rate=0.55, snr_db=20.0, sf_idx=1, llr_bits=16)
    payload = torch.from_numpy(
        np.random.default_rng(0).integers(0, 2, (cs.BATCH, cfg.tbs), dtype=np.int8)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rx = channel.awgn(gen, pdsch_link.tx_subframe(payload, cfg), cfg.snr_db)
    out["dl_decode_sf_s"], out["dl_runs"] = rate(
        lambda: pdsch_link.rx_subframe(rx, cfg, use_kernel=True)[:2],
        lambda r: bool(r[1].all()) and torch.equal(r[0], payload))
    out["dl_encode_sf_s"], out["dl_encode_runs"] = rate(
        lambda: pdsch_link.tx_subframe(payload, cfg))

    ucfg = cs.ul_bench_config()
    upay = torch.from_numpy(
        np.random.default_rng(2).integers(0, 2, (cs.BATCH, ucfg.tbs), dtype=np.int8)).to(dev)
    gen.manual_seed(2)
    urx = channel.awgn(gen, ue_ul.build_subframe(ucfg, tb_bits=upay), 14.0)
    out["ul_decode_sf_s"], out["ul_runs"] = rate(
        lambda: ue_ul.enb_receive(urx, ucfg, use_kernel=True, llr_bits=16)["pusch"],
        lambda r: bool(r[1].all()) and torch.equal(r[0], upay))
    out["ul_encode_sf_s"], out["ul_encode_runs"] = rate(
        lambda: ue_ul.build_subframe(ucfg, tb_bits=upay))

    # pbch.decode on chip_smoke.py's phase-8 sf 0 subframe (100 PRB, batch 16)
    cfg0 = cs.dl_subframe_config(0, with_pbch_sfn=8)
    cell = cfg0.cell
    rng = np.random.default_rng(8)
    pay0 = [torch.from_numpy(rng.integers(0, 2, (16, g[3]), dtype=np.int8)).to(dev)
            for g in cfg0.grants]
    mib = torch.from_numpy(np.tile(pbch.pack_mib(cell.n_prb, 8), (16, 1))).to(dev)
    gen.manual_seed(8)
    grid0 = ofdm.demodulate(channel.awgn(gen, enb_dl.build_subframe(cfg0, pay0, mib_bits=mib),
                                         cs.DL_SF_SNR_DB), cell.n_prb)
    ce0 = chest.estimate(grid0, cell, 0).ce
    decode = lambda: pbch.decode(grid0, ce0, cell)
    got, _, _, ok = decode()
    assert bool(ok.all()) and torch.equal(got, mib), "pbch.decode failed"
    out["pbch_decode_ms"] = cs.host_ms(decode, 9)
    with cs.timed_calls(((viterbi, "viterbi_decode"),)) as vit:
        for _ in range(9):
            decode()
    out["pbch_viterbi_ms"] = 1e3 * vit["viterbi.viterbi_decode"][1] / 9
    print(json.dumps(out), flush=True)


def main():
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_map_compare: torch.cuda is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    rc = 0
    for tree in sys.argv[1:]:
        rc |= subprocess.run([sys.executable, __file__, "--child", tree], cwd=ROOT,
                             timeout=900, check=False).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
