"""Distinct keys of the port's device-table caches over a run of the
waveform network with traffic.

Every `utils.devices.table_cache` is made unbounded for the run (before the
modules that hold one are imported), so each cache's size is the number of
distinct tables the run asked for.  The network (`wavenet_smoke.build`)
attaches its UEs; then every 10 TTIs each attached UE gets a downlink packet
and sends an uplink one, their sizes drawn from --seed so that the grants
vary.  Prints one JSON line per 100 TTIs of traffic, {"tti", cache: size}:
a size that keeps rising with the TTIs is a cache that would grow without a
bound.

Usage: python -m srslte_emane_tpu_torch.scripts.table_cache_keys [--ues 4]
       [--ttis 800] [--prb 25] [--seed 0] [--cpu]
"""

from __future__ import annotations

import importlib
import json
import sys

import numpy as np

from ..utils import devices
from . import _timing

# (module, attribute) of each table_cache, in the package
CACHES = (("phch.pdsch", "_re_table"), ("phch.pdsch", "_tx_gather"), ("phch.pdsch", "_crs_table"),
          ("ops.scrambling", "_cached_sequence"), ("phch.chest", "_device_tables"),
          ("ops.ofdm", "_device_tables"), ("ops.sequence", "_device_tables"),
          ("ops.fec.crc", "_device_matrix"), ("ops.fec.crc", "remainder_masks"),
          ("ops.fec.viterbi", "_signs"), ("ops.fec.turbo", "_device_tables"),
          ("ops.fec.turbo", "_device_perm"), ("ops.fec.rm_turbo", "_on_device"),
          ("ops.fec.turbodecoder", "_tail_signs"), ("ops.fec.turbodecoder", "_device_perms"),
          ("ops.fec.convcoder", "_on_device"), ("runtime.waveblock", "_time_weights"),
          # the waveform network's stages (runtime/wavenet._CellKernels)
          ("phch.chest", "_crs10"), ("phch.pdsch", "_crs_table10"),
          ("phch.pdsch", "_layer_weights"), ("phch.pdcch", "_device_tables"),
          ("phch.pdcch", "_sequence10"), ("phch.pdcch", "_level_tables"),
          ("phch.pdcch", "_crc_weights"), ("phch.pusch", "_dmrs10_device"),
          ("phch.pusch", "_sym_offsets"), ("phch.pusch", "_device_tables"),
          ("phch.pusch", "_time_weights"), ("phch.uci", "_generator"),
          ("phch.uci", "_device_codebook"), ("phch.pusch_uci", "_device_tables"),
          ("phch.pucch", "_device_tables"), ("phch.pucch", "_sym_index"),
          ("phch.phich", "_device_tables"), ("phch.pbch", "_device_tables"),
          ("phch.pbch", "_port_mask"), ("phch.sync", "_pss_replicas"),
          ("phch.sync", "_sss_banks"), ("phch.sync", "_sss_bins"),
          ("runtime.wavenet", "_base_table"), ("runtime.wavenet", "_base_p1_table"),
          ("runtime.wavenet", "_sb_layout"), ("runtime.wavenet", "_pucch_wf"),
          ("runtime.wavenet", "_f2_tables"), ("runtime.wavenet", "_pucch_rx_tables"),
          # the waveform planes' steps (runtime/wavesim)
          ("models.enb_dl", "_dci_1a_bits"), ("phch.pcfich", "_device_tables"),
          ("phch.sync", "_device_tables"), ("phch.pdcch", "_rnti_mask"),
          ("phch.pmch", "_device_tables"), ("ops.ofdm", "_mbsfn_device_tables"),
          ("ops.mimo", "_codebook_2l"), ("phch.pucch", "_f1_data_mask"))
PKG = __package__.rsplit(".", 1)[0]


def main(argv=None) -> int:
    ap = _timing.parser(__doc__)
    ap.add_argument("--ues", type=int, default=4)
    ap.add_argument("--ttis", type=int, default=800)
    ap.add_argument("--prb", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    loaded = [m for m, _ in CACHES if f"{PKG}.{m}" in sys.modules]
    _timing.require(not loaded, f"run in a fresh process ({loaded} already imported)")
    bounded = devices.table_cache
    devices.table_cache = lambda maxsize: bounded(None)
    caches = {f"{m}.{a}": getattr(importlib.import_module(f"{PKG}.{m}"), a) for m, a in CACHES}
    from ..epc import spgw as spgw_mod
    from . import wavenet_smoke

    dev = _timing.device(args.cpu, "table_cache_keys")
    net, _, ues, _, spgw = wavenet_smoke.build(n_ues=args.ues, n_prb=args.prb, device=dev)
    while net.tti < 200 + 100 * args.ues and not all(u.emm_state == "REGISTERED" for u in ues):
        net.run(10)
    rng = np.random.default_rng(args.seed)
    for i in range(args.ttis // 10):
        for u in ues:
            if u.emm_state == "REGISTERED":
                spgw.handle_sgi_pdu(spgw_mod.make_ipv4("8.8.8.8", u.ip_addr,
                                                       b"d" * int(rng.integers(40, 1400))))
                u.gw_send(spgw_mod.make_ipv4(u.ip_addr, "8.8.8.8", b"u" * int(rng.integers(40, 600))))
        net.run(10)
        if i % 10 == 9:
            sizes = {k: c.cache_info().currsize for k, c in caches.items()}
            print(json.dumps({"tti": net.tti, **sizes, **_timing.stamp(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
