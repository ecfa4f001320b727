"""Smoke drive of the port's waveform-native network: N UEs power on and attach.

Twin of the JAX repository's `scripts/wavenet_smoke.py`: the port's
`runtime/wavenet.WaveformNetwork` (6 PRB, 2 UEs, 80 dB path loss, no
message bus below L2: cell search, MIB, PRACH, RA, RRC and NAS all ride
OFDM) runs in 50-TTI slabs until every UE is REGISTERED or `n_ttis` have
passed, printing each slab's states and PHY metrics.  The source pins the
CPU; the twin runs on the card unless it is given --cpu.

Usage: python -m srslte_emane_tpu_torch.scripts.wavenet_smoke [n_ttis] [--cpu]

Ends with one JSON line, {"registered", "n_ues", "tti", "seconds"} plus
"backend" and "device"; the run fails unless every UE registered.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from ..epc import hss as hss_mod, mme as mme_mod, spgw as spgw_mod
from ..runtime import wavenet
from ..stack import enb_stack, security, ue_stack
from . import _timing


def build(n_ues=2, n_prb=6, pathloss=80.0, device="cuda"):
    hss = hss_mod.Hss()
    spgw = spgw_mod.Spgw()
    mme = mme_mod.Mme(hss, spgw)
    enb = enb_stack.EnbStack(mme, enb_id=1, n_prb=n_prb)
    ues = []
    for i in range(n_ues):
        imsi = f"00101000000000{i:02d}"
        key = bytes(range(16))
        hss.add(hss_mod.Subscriber(imsi=imsi, key=key))
        opc = security.milenage_opc(key, b"\x00" * 16)
        ues.append(ue_stack.UeStack(ue_stack.Usim(imsi, key, opc), preamble=7 + i))
    net = wavenet.WaveformNetwork(enb, ues, pathloss_db=np.full(n_ues, pathloss), n_prb=n_prb,
                                  device=device)
    return net, enb, ues, mme, spgw


def main(argv=None) -> int:
    ap = _timing.parser(__doc__)
    ap.add_argument("n_ttis", type=int, nargs="?", default=400)
    args = ap.parse_args(argv)
    dev = _timing.device(args.cpu, "wavenet_smoke")
    net, enb, ues, mme, spgw = build(device=dev)
    t0 = time.time()
    step = 50
    for _ in range(0, args.n_ttis, step):
        net.run(step)
        states = [(u.emm_state, u.rrc_state, u.mac_state) for u in ues]
        print(f"tti={net.tti} t={time.time() - t0:.1f}s states={states}")
        print(f"  enb_phy={net.enb.metrics} ue0_phy={net.ues[0].metrics}")
        print(f"  ue0_sync={net.ues[0].state} enb_mac: rach={enb.metrics['rach']}"
              f" si_tx={enb.metrics['si_tx']} attach_ok={mme.metrics['attach_ok']}")
        if all(u.emm_state == "REGISTERED" for u in ues):
            print(f"ALL REGISTERED at tti={net.tti}")
            break
    for i, u in enumerate(ues):
        print(f"ue{i}: emm={u.emm_state} rrc={u.rrc_state} ip={u.ip_addr}")
    registered = sum(u.emm_state == "REGISTERED" for u in ues)
    print(json.dumps({"registered": registered, "n_ues": len(ues), "tti": net.tti,
                      "seconds": round(time.time() - t0, 1), **_timing.stamp(dev)}), flush=True)
    _timing.require(registered == len(ues), f"{registered} of {len(ues)} UEs registered")
    return 0


if __name__ == "__main__":
    sys.exit(main())
