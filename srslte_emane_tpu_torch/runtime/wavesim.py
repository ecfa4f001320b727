"""Waveform-mode data plane: DL user data through the real PHY pipeline.

Twin of `WaveformDataPlane` in the reference's `runtime/wavesim.py` (the
ZMQ-mode equivalent of stock srsLTE's IQ transport, rf_zmq_imp.c): the
control plane (RA, RRC, NAS) stays on the message bus, and once a UE is
attached its downlink PDCP PDUs ride the device pipeline — PDCCH DCI +
PDSCH encode -> OFDM -> per-link pathloss + AWGN -> OFDM demod -> chest ->
blind DCI search -> PDSCH decode — batched over the PDUs of a burst.

Each attached UE holds a static grant slot (rnti, prb_mask, Qm, tbs); the
plane runs on `device` ("cuda" by default: it raises where there is no
card rather than run on the CPU) and draws its channel noise from its own
seeded `torch.Generator` on that device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import enb_dl, ue_dl
from ..ops import bits as bits_mod, channel
from ..phch import grid as grid_mod


@dataclasses.dataclass
class UeSlot:
    rnti: int
    prb_mask: tuple
    qm: int = 4
    l_aggr: int = 4
    cce_start: int = 0

    def tbs(self, cell, sf_idx) -> int:
        n_re = grid_mod.nof_re(cell, sf_idx, self.prb_mask)
        return max(16, (n_re * self.qm // 3) // 8 * 8)


class WaveformDataPlane:
    """Carries DL PDCP PDUs of attached UEs over the waveform pipeline."""

    def __init__(self, cell: grid_mod.CellConfig, noise_floor_dbm: float = -104.0,
                 tx_power_dbm: float = 30.0, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("WaveformDataPlane: no CUDA device (pass device='cpu' "
                               "to run on the CPU)")
        self.cell = cell
        self.noise_floor_dbm = noise_floor_dbm
        self.tx_power_dbm = tx_power_dbm
        self.slots: dict = {}  # rnti -> UeSlot
        self.gen = torch.Generator(self.device)
        self.gen.manual_seed(0)
        self.metrics = {"sf_tx": 0, "crc_ok": 0, "crc_fail": 0}

    def add_ue(self, rnti: int, prb_mask: tuple, qm: int = 4,
               cce_start: int = 0, l_aggr: int = 1):
        self.slots[rnti] = UeSlot(rnti, prb_mask, qm, l_aggr=l_aggr, cce_start=cce_start)

    def _grant(self, rnti: int, sf_idx: int) -> tuple:
        s = self.slots[rnti]
        return (rnti, s.prb_mask, s.qm, s.tbs(self.cell, sf_idx), s.l_aggr, s.cce_start)

    def _payload_bits(self, pdus, batch: int, tbs: int) -> torch.Tensor:
        """(batch, tbs) bits on the device: each PDU behind its 2-byte
        length, zero-padded; rows past len(pdus) are empty PDUs."""
        nbytes = tbs // 8
        buf = np.zeros((batch, nbytes), dtype=np.uint8)
        for i, p in enumerate(pdus):
            assert len(p) + 2 <= nbytes, (len(p), nbytes)
            buf[i, 0] = len(p) >> 8
            buf[i, 1] = len(p) & 0xFF
            buf[i, 2 : 2 + len(p)] = np.frombuffer(p, np.uint8)
        return bits_mod.unpack_bits(torch.from_numpy(buf).to(self.device))[:, :tbs]

    def _snr_db(self, pathloss_db: float) -> float:
        return self.tx_power_dbm - pathloss_db - self.noise_floor_dbm

    def _deliver(self, n: int, res: ue_dl.UeDlResult) -> list:
        """[(bytes | None, snr_db), ...] of the first n rows of a one-grant
        decode; counts them in the metrics."""
        found = res.dci_found[:, 0].cpu().numpy()
        ok = res.crc_ok[0].cpu().numpy()
        out_bytes = bits_mod.pack_bits(res.payloads[0]).cpu().numpy()
        snrs = res.snr_db.cpu().numpy()
        results = []
        for i in range(n):
            self.metrics["sf_tx"] += 1
            if found[i] and ok[i]:
                m = (int(out_bytes[i, 0]) << 8) | int(out_bytes[i, 1])
                results.append((bytes(out_bytes[i, 2 : 2 + m]), float(snrs[i])))
                self.metrics["crc_ok"] += 1
            else:
                results.append((None, float(snrs[i])))
                self.metrics["crc_fail"] += 1
        return results

    def send_tti(self, pdus: dict, pathloss_db: dict, sf_idx: int = 1) -> dict:
        """Carry one DL burst for EVERY attached UE in shared subframes.

        The eNB builds one multi-grant subframe per row (all UEs' PDCCH
        DCIs + PDSCH); each UE's receiver decodes its own grant through its
        own channel (sf_worker.cc serving N grants per TTI).  pdus:
        {rnti: [pdu bytes, ...]}; UEs with shorter (or no) bursts ride
        zero-length padding PDUs.  Returns {rnti: [(bytes|None, snr_db),
        ...]} aligned with each UE's input list."""
        plan = tuple(self._grant(r, sf_idx) for r in sorted(self.slots))
        B = max((len(v) for v in pdus.values()), default=0)
        if B == 0:
            return {}
        payloads = [self._payload_bits(pdus.get(g[0], ()), B, g[3]) for g in plan]
        tx = enb_dl.build_subframe(
            enb_dl.DlSubframeConfig(cell=self.cell, sf_idx=sf_idx, grants=plan), payloads)
        results = {}
        for g in plan:
            rnti = g[0]
            rx = channel.awgn(self.gen, tx, self._snr_db(pathloss_db[rnti]))
            res, _ = ue_dl.decode_subframe(
                rx, enb_dl.DlSubframeConfig(cell=self.cell, sf_idx=sf_idx, grants=(g,)))
            results[rnti] = self._deliver(len(pdus.get(rnti, ())), res)
        return results

    def send(self, rnti: int, pdus: list, pathloss_db: float, sf_idx: int = 1) -> list:
        """Transmit a burst of DL byte-PDUs to one UE through the PHY, in
        subframes that carry its grant alone.

        Returns list of (delivered_bytes | None, snr_db) per PDU — None when
        the PDSCH CRC failed at this pathloss."""
        grant = self._grant(rnti, sf_idx)
        cfg = enb_dl.DlSubframeConfig(cell=self.cell, sf_idx=sf_idx, grants=(grant,))
        tx = enb_dl.build_subframe(cfg, [self._payload_bits(pdus, len(pdus), grant[3])])
        rx = channel.awgn(self.gen, tx, self._snr_db(pathloss_db))
        res, _ = ue_dl.decode_subframe(rx, cfg)
        return self._deliver(len(pdus), res)
