"""Multi-device dry run: the twin of the reference's
`__graft_entry__.dryrun_multichip` and of `scripts/scaling_curve.py`'s table.

It builds an n-device ('node', 'sf') mesh and runs the FULL 20 MHz link step
(encode + channel + decode) of the bench of record (`bench.py`: 100 PRB,
64QAM, code rate 0.55, llr_bits=16) with one subframe per device, sharded
over both axes; then the 1/2/4/..n table of sf/s with each row's
cross-device transfers; then one cell's waveform block per device
(runtime/waveblock.make_block_step_sharded); then the node-sharded OTA
superposition and its power psum (parallel/ota_collective.py).  The
structural evidence is the transfer count of the link step and the block:
0, since subframes and cells are independent.  The mesh's devices are the
cards (or, with --device cpu, virtual CPU devices that share the host, as
the reference's virtual XLA devices do), so sf/s makes no scaling claim.

Usage: python -m srslte_emane_tpu_torch.parallel.dryrun --devices N [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..models import pdsch_link
from ..phch import grid as grid_mod, pdcch as pdcch_mod
from ..runtime import waveblock
from . import mesh as mesh_mod, ota_collective


def bench_config() -> pdsch_link.LinkConfig:
    """The bench-of-record link (bench.py:46-56)."""
    return pdsch_link.LinkConfig(
        cell=grid_mod.CellConfig(n_prb=100, cell_id=1, cfi=1),
        qm=6, code_rate=0.55, snr_db=20.0,
        llr_bits=16)  # the shipping bench decoder width


def _sync(mesh):
    for d in set(mesh.devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _counted(mesh, fn):
    """(fn(), the transfers it made on `mesh`)."""
    before = mesh.transfers
    out = fn()
    return out, mesh.transfers - before


def link_table(cfg, n_devices: int, device, iters: int = 3) -> list:
    """sf/s of the sharded link step at 1, 2, 4, .. n_devices devices, one
    subframe per device: one untimed call, then `iters` timed ones
    (synchronised), with the transfers of every call."""
    rng = np.random.default_rng(3)
    table, n_sub = [], 1
    while n_sub <= n_devices:
        m = mesh_mod.make_mesh(n_sub, device=device)
        step = pdsch_link.make_link_step_sharded(cfg, m)
        gen = torch.Generator(device=m.devices[0]).manual_seed(0)
        pl = rng.integers(0, 2, (n_sub, cfg.tbs), dtype=np.int8)
        step(pl, gen)
        _sync(m)
        t0 = time.perf_counter()
        for _ in range(iters):
            step(pl, gen)
        _sync(m)
        table.append({"devices": n_sub, "batch": n_sub,
                      "sf_per_s": iters * n_sub / (time.perf_counter() - t0),
                      "cross_device_transfers": m.transfers})
        n_sub *= 2
    return table


def block_config() -> waveblock.BlockConfig:
    """The reference dryrun's multi-cell block: 15 PRB, 2 UEs, T=4."""
    cell = grid_mod.CellConfig(n_prb=15, cell_id=1, cfi=2)
    n_cce = pdcch_mod.n_cce(cell)
    c0, c1 = waveblock.centre_prbs(15)
    dl_starts, dl_w = waveblock._pack_segments(15, 2, [(0, c0), (c1, 15)])
    return waveblock.BlockConfig(
        cell=cell, rntis=(70, 71), dl_rb_start=dl_starts, dl_l_crbs=dl_w,
        dl_mcs=8, ul_rb_start=(1, 5), ul_l_prb=4, ul_mcs=8,
        ack_res=(n_cce, n_cce + 1), snr_db=(30.0, 28.0), T=4)


def dryrun(n_devices: int, device="cuda", cfg: pdsch_link.LinkConfig = None) -> dict:
    """Runs the dry run, prints its JSON lines and returns the first one's
    dict; raises if a decode fails or a link step or block moves anything
    between devices.  cfg defaults to the bench of record."""
    cfg = cfg or bench_config()
    mesh = mesh_mod.make_mesh(n_devices, device=device)
    assert mesh.size == n_devices, (
        f"only {mesh.size} device(s) of type {device!r}: the dry run would test a smaller mesh")
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 2, (n_devices, cfg.tbs), dtype=np.int8)
    gen = torch.Generator(device=mesh.devices[0]).manual_seed(0)
    step = pdsch_link.make_link_step_sharded(cfg, mesh)
    (out, ok, _), n_x = _counted(mesh, lambda: step(payload, gen))
    head = {"dryrun_devices": n_devices, "mesh": dict(mesh.shape),
            "link_step_cross_device_transfers": n_x, "collective_free": n_x == 0}
    print(json.dumps(head), flush=True)

    table = link_table(cfg, n_devices, device)
    print(json.dumps({
        "scaling_table": table,
        "device": (torch.cuda.get_device_name(mesh.devices[0])
                   if mesh.devices[0].type == "cuda" else "cpu"),
        "note": ("sf_per_s of one process driving the mesh's devices; virtual CPU devices "
                 "share one host's cores: NOT a scaling result; the structural evidence is "
                 "cross_device_transfers == 0 at every point")}), flush=True)
    assert all(r["cross_device_transfers"] == 0 for r in table), table
    assert ok.shape == (n_devices,) and bool(ok.all()), f"dry run decode failed: {ok}"
    assert np.array_equal(out.cpu().numpy(), payload), "dry run payload not bit-exact"
    assert n_x == 0, f"link step moved {n_x} tensors between devices"

    # multi-cell WAVEFORM block: one cell's full bidirectional PHY block per
    # device, every cell-dependent table on its device (cells don't talk)
    wcfg = block_config()
    wstep, _ = waveblock.make_block_step_sharded(wcfg, mesh, tuple(range(1, n_devices + 1)))
    rngw = np.random.default_rng(2)
    wdl = rngw.integers(0, 2, (n_devices, wcfg.T, 2, wcfg.dl_tbs), dtype=np.int8)
    wul = rngw.integers(0, 2, (n_devices, wcfg.T, 2, wcfg.ul_tbs), dtype=np.int8)
    gens = [torch.Generator(device=d).manual_seed(c) for c, d in enumerate(mesh.devices)]
    wout, w_x = _counted(mesh, lambda: wstep(wdl, wul, gens, 20))
    assert bool(wout["dl_ok"].all()) and bool(wout["ul_ok"].all())
    assert np.array_equal(wout["dl_out"].cpu().numpy(), wdl)
    assert w_x == 0, f"multi-cell waveform block moved {w_x} tensors between devices"
    print(json.dumps({"waveform_multicell": dict(
        cells=n_devices, ues_per_cell=2, block_ttis=wcfg.T, cross_device_transfers=w_x,
        all_crc_ok=True)}), flush=True)

    # the collective phase: node-sharded OTA superposition (one all-gather
    # over the 'node' axis) + the medium-occupancy psum
    n_nodes = mesh.shape["node"] * 2  # 2 nodes per node shard
    rng2 = np.random.default_rng(1)
    tx = rng2.normal(size=(n_nodes, 2, 96, 2)).astype(np.float32)
    g = (rng2.normal(size=(n_nodes, n_nodes)) + 1j * rng2.normal(size=(n_nodes, n_nodes)))
    shards = mesh_mod.node_sharding(mesh, tx)
    rx, ota_x = _counted(mesh, lambda: ota_collective.ota_mix_sharded(
        mesh, shards, g.astype(np.complex64), gen=gen, noise_std=0.01))
    p, psum_x = _counted(mesh, lambda: ota_collective.total_rx_power_psum(mesh, shards))
    assert bool(mesh_mod.gather(rx).isfinite().all()) and float(p) > 0.0
    print(json.dumps({"ota_collective": dict(
        nodes=n_nodes, mix_cross_device_transfers=ota_x,
        psum_cross_device_transfers=psum_x)}), flush=True)
    return head


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, required=True)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the cards, the default) or 'cpu' (virtual CPU devices)")
    args = ap.parse_args(argv)
    dryrun(args.devices, args.device)


if __name__ == "__main__":
    main()
