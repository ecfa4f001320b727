"""OTA hub app: the EMANE-emulator process (propagation + TTI barrier).

Usage:
    python -m srslte_emane_tpu_torch.apps.hub_app --nodes 3 --prb 25 \
        --pathloss 80 --port 5599 --run-seconds 30
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..runtime import distrib, sinr


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, required=True)
    ap.add_argument("--prb", type=int, default=25)
    ap.add_argument("--pathloss", type=float, default=80.0)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--run-seconds", type=float, default=30.0)
    ap.add_argument("--native", action="store_true",
                    help="serve through the C++ ota_hub daemon"
                         " (native/ota_hub.cpp) instead of the python hub")
    args = ap.parse_args(argv)
    n = args.nodes
    pl = np.full((n, n), args.pathloss, np.float32)
    np.fill_diagonal(pl, 0)
    prop = sinr.Propagation(pathloss_db=pl)
    if args.native:
        if not distrib.native_hub_available():
            raise SystemExit("native ota_hub not built (scripts/build_native.sh)")
        hub = distrib.NativeHub(prop, n_nodes=n, n_prb=args.prb)
        print(json.dumps(dict(listening=hub.port, native=True)), flush=True)
        t0 = time.time()
        while time.time() - t0 < args.run_seconds and hub.proc.poll() is None:
            time.sleep(0.2)
        hub.stop()
        print(json.dumps(dict(stopped=True)))
        return
    hub = distrib.OtaHub(prop, node_ids=list(range(n)), n_prb=args.prb,
                         port=args.port).start()
    print(json.dumps(dict(listening=hub.port)), flush=True)
    t0 = time.time()
    while time.time() - t0 < args.run_seconds and not hub._stop:
        time.sleep(0.2)
    print(json.dumps(dict(final_tti=hub.tti)))
    hub.stop()


if __name__ == "__main__":
    main()
