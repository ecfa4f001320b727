"""srsepc-equivalent app shell: MME + SPGW + HSS in one process.

Reference behavior: `srsepc/src/main.cc` — singletons mme/spgw/hss, user DB
csv, S1AP SCTP server (here: the RPC endpoint), SGi edge.

Usage:
    python -m srslte_emane_tpu_torch.apps.epc_app --port 36412 \
        [--user-db user_db.csv] [--ttis-idle 30]
"""

from __future__ import annotations

import argparse
import json
import time

from ..epc import hss as hss_mod, mme as mme_mod, spgw as spgw_mod
from ..utils import metrics as metrics_mod
from . import rpc


def build(user_db: str = None, default_subs: int = 4):
    hss = hss_mod.Hss(user_db)
    if not hss.subs:
        for i in range(default_subs):
            hss.add(hss_mod.Subscriber(imsi=f"0010100000000{i:02d}",
                                       key=bytes(range(16))))
    spgw = spgw_mod.Spgw()
    mme = mme_mod.Mme(hss, spgw)
    return rpc.EpcFrontend(mme)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=36412)
    ap.add_argument("--user-db", default=None)
    ap.add_argument("--run-seconds", type=float, default=30.0)
    ap.add_argument("--ostat-port", type=int, default=0,
                    help="serve MME/SPGW tables on an ostatistic-style "
                         "endpoint (EPCSTATS::initialize, srsepc main.cc:494)")
    args = ap.parse_args(argv)
    frontend = build(args.user_db)
    srv = rpc.RpcServer(frontend, port=args.port)
    ostat = None
    if args.ostat_port or args.ostat_port == 0:
        hub = metrics_mod.MetricsHub()
        hub.add_source("mme", lambda: dict(frontend.mme.metrics))
        hub.add_source("spgw", lambda: dict(frontend.spgw.metrics))
        ostat = metrics_mod.OStatServer(hub, port=args.ostat_port)
    print(json.dumps(dict(listening=srv.port,
                          ostat=ostat.port if ostat else None)), flush=True)
    t0 = time.time()
    while time.time() - t0 < args.run_seconds:
        if ostat:
            ostat.hub.poll()  # refresh the queryable snapshot
        time.sleep(0.2)
    print(json.dumps(dict(mme=frontend.mme.metrics, spgw=frontend.spgw.metrics)))
    if ostat:
        ostat.stop()
    srv.stop()


if __name__ == "__main__":
    main()
