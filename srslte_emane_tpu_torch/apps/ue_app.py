"""srsue-equivalent app shell: one UE node process.

Reference behavior: `srsue/src/main.cc` — config/CLI, USIM from [usim]
section, radio->phy->stack->gw wiring; -emane build uses the MHAL (here:
the distributed OTA hub).

Usage:
    python -m srslte_emane_tpu_torch.apps.ue_app --conf ue.conf \
        --hub HOST:PORT --node-id 1 --cell 1 --ttis 1000
"""

from __future__ import annotations

import argparse
import json

from ..runtime import distrib, phy_adapter
from ..stack import security, ue_stack
from ..utils import config as config_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--conf", default=None)
    ap.add_argument("--hub", required=True)
    ap.add_argument("--node-id", type=int, default=1)
    ap.add_argument("--cell", type=int, default=1)
    ap.add_argument("--prb", type=int, default=25)
    ap.add_argument("--ttis", type=int, default=1000)
    ap.add_argument("--native-hub", action="store_true",
                    help="the hub is the C++ ota_hub daemon (binary OTA"
                         " protocol) instead of the python OtaHub")
    args, rest = ap.parse_known_args(argv)
    cfg = config_mod.load(config_mod.UeConfig, args.conf, rest)

    host, port = args.hub.rsplit(":", 1)
    if args.native_hub:
        bus = distrib.NativeRemoteBus(host, int(port), args.node_id,
                                      n_prb=args.prb)
    else:
        bus = distrib.RemoteBus(host, int(port), args.node_id)
    key = bytes.fromhex(cfg.key_hex)
    op = bytes.fromhex(cfg.op_hex)
    usim = ue_stack.Usim(cfg.imsi, key, security.milenage_opc(key, op))
    ue = ue_stack.UeStack(usim, preamble=cfg.preamble, hplmn=cfg.hplmn)
    if cfg.mbms_service_id >= 0:
        # autostart MBMS reception (ue.conf mbms_service_id/port role)
        ue.mbms_service_start(cfg.mbms_service_id, cfg.mbms_service_port)
    node = phy_adapter.UePhyAdapter(bus, args.node_id, cell_id=args.cell,
                                    n_prb=args.prb, stack=ue,
                                    tx_power_mw=cfg.tx_power_mw)
    for _ in range(args.ttis):
        node.run_tti(bus.curr_tti)
        bus.step_tti()
    print(json.dumps(dict(emm=ue.emm_state, ip=ue.ip_addr,
                          metrics=dict(ue.metrics))))
    bus.close()


if __name__ == "__main__":
    main()
