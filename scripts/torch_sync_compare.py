#!/usr/bin/env python3
"""The PyTorch port's PSS correlation and cell search, tree against tree,
on one CUDA card.

Run from the repository root, with other checkouts of the port unpacked
beside it (for example `git archive <commit> | tar -x -C build/parent`):

    python3 scripts/torch_sync_compare.py build/parent . . build/parent

Each tree named runs in a process of its own, in the order given (so
parent, change, change, parent takes turns on the same card), and prints
one JSON line at chip_smoke.py's cell search sweep size: 640 rows of one
6-PRB subframe (1,920 samples; cell 301, sf 0, PSS/SSS and CRS, 5 dB of
numpy noise from a fixed seed, the same in every tree).  For
`sync.pss_correlate` and `sync.cell_search(detect_cp=True)` it gives the
median of 20 calls timed with CUDA events after a warm-up, the peak device
memory a call allocates above what was allocated before it, and a digest
of the ids found, which must be equal across trees.  The card's name and
power limit come first.
"""

import hashlib
import json
import pathlib
import statistics
import subprocess
import sys

ROWS = 640
CELL = 301
SNR_DB = 5.0
N_CALLS = 20


def one_tree(tree: pathlib.Path) -> dict:
    sys.path.insert(0, str(tree.resolve()))
    import numpy as np
    import torch

    from srslte_emane_tpu_torch.ops import cplx, ofdm
    from srslte_emane_tpu_torch.phch import grid, pdsch, sync

    dev = torch.device("cuda", 0)
    cell = grid.CellConfig(n_prb=6, cell_id=CELL)
    g = pdsch.put_crs(sync.put_pss_sss(cplx.zeros((1, 14, 72), device=dev), cell, 0), cell, 0)
    tx = ofdm.modulate(g, 6).cpu().numpy()
    power = float(np.mean(np.sum(tx.astype(np.float64) ** 2, -1)))
    rng = np.random.default_rng(0)
    noise = rng.normal(0.0, np.sqrt(power / 10 ** (SNR_DB / 10) / 2), (ROWS,) + tx.shape[1:])
    x = torch.from_numpy((tx + noise).astype(np.float32)).to(dev)

    def event_ms(fn):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(N_CALLS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    def peak_mib(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2**20

    res = sync.cell_search(x, detect_cp=True)
    ids = torch.stack([res[k].to(torch.int64) for k in ("cell_id", "pss_pos", "sf_idx")])
    out = {"tree": str(tree), "rows": ROWS, "found": int((res["cell_id"] == CELL).sum())}
    for name, fn in (("pss_correlate", lambda: sync.pss_correlate(x)),
                     ("cell_search", lambda: sync.cell_search(x, detect_cp=True))):
        out[name] = {"ms": event_ms(fn), "peak_mib": peak_mib(fn)}
    out["ids_sha1"] = hashlib.sha1(ids.cpu().numpy().tobytes()).hexdigest()[:12]
    return out


def main(argv):
    if argv[:1] == ["--one"]:
        print(json.dumps(one_tree(pathlib.Path(argv[1]))))
        return 0
    q = "--query-gpu=name,power.limit"
    print(subprocess.run(["nvidia-smi", q, "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for tree in argv or ["."]:
        r = subprocess.run([sys.executable, __file__, "--one", tree], capture_output=True, text=True)
        if r.returncode:
            sys.stderr.write(r.stderr)
            return r.returncode
        print(r.stdout.strip().splitlines()[-1])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
