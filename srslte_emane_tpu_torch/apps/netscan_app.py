"""Deployment-scale cell scan CLI.

Synthesizes an N-cell beacon deployment with the cell id as data
(`models/netscan.py`), superposes the waveforms over the (optionally
sharded) OTA medium, and runs batched cell search at every observation
point — the `srsue/src/phy/scell/intra_measure.cc` neighbor-scan role at
network scale.  It runs on the card, or on the CPU with --cpu (--mesh N then
lays N virtual CPU devices).

Usage: python -m srslte_emane_tpu_torch.apps.netscan_app --cells 32 [--cpu] [--mesh N]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=16)
    ap.add_argument("--noise-std", type=float, default=0.02)
    ap.add_argument("--interferer-gain", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (device='cpu') instead of the card")
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard cells over an n-device ('node','sf') mesh"
                         " (0 = single device)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    from ..models import netscan
    from ..parallel import mesh as mesh_mod
    from ..utils.devices import resolve

    rng = np.random.default_rng(args.seed)
    n = args.cells
    ids = rng.choice(504, n, replace=False).astype(np.int32)
    g = args.interferer_gain * (
        rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    for i in range(n):
        g[i, (i + 1) % n] = 1.0  # each observer's dominant neighbor
    mesh = mesh_mod.make_mesh(args.mesh, device=device) if args.mesh else None
    gen_device = mesh.devices[0] if mesh is not None else resolve(device, "netscan_app")
    gen = torch.Generator(device=gen_device).manual_seed(args.seed)

    t0 = time.time()
    res = netscan.network_scan(mesh, ids, g.astype(np.complex64), gen=gen,
                               noise_std=args.noise_std, device=device)
    found = res["cell_id"].cpu().numpy()
    quality = res["quality"].cpu().numpy()
    wall = time.time() - t0
    want = ids[(np.arange(n) + 1) % n]
    print(json.dumps(dict(
        cells=n,
        correct=int((found == want).sum()),
        wall_s=round(wall, 3),
        cells_per_sec=round(n / wall, 1),
        mean_quality=round(float(quality.mean()), 2),
        backend=gen_device.type,
    )))
    return found


if __name__ == "__main__":
    main()
