"""Waveform-mode planes: user data and control through the real PHY pipeline.

Twin of the reference's `runtime/wavesim.py` (the ZMQ-mode equivalent of
stock srsLTE's IQ transport, rf_zmq_imp.c): the control plane (RA, RRC,
NAS) stays on the message bus, and once a UE is attached its traffic rides
the device pipeline, batched over the PDUs of a burst:
- `WaveformDataPlane`: DL PDUs through PDCCH DCI + PDSCH encode -> OFDM ->
  per-link pathloss + AWGN -> OFDM demod -> chest -> blind DCI search ->
  PDSCH decode;
- `MbsfnPlane`: MTCH PDUs through PMCH in the hybrid-CP MBSFN subframe,
  one broadcast heard by every receiver through its own channel;
- `UlControlPlane`: superposed PUCCH format-1a ACKs of many UEs;
- `UlSchPlane`: PUSCH data with an aperiodic CQI report multiplexed in;
- `MimoDataPlane`: TM3 2x2 DL, two transport blocks per subframe.

Each plane runs on `device` ("cuda" by default: it raises where there is no
card rather than run on the CPU) and draws its channel from its own
`torch.Generator` on that device, seeded with its JAX twin's PRNG seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import enb_dl, ue_dl
from ..ops import bits as bits_mod, channel, cplx, ofdm
from ..phch import grid as grid_mod, pdsch, pmch, pucch, pusch, sch, uci as uci_codes
from ..utils.devices import resolve as _device


def _generator(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device)
    gen.manual_seed(seed)
    return gen


def _pdu_bits(pdus, batch: int, tbs: int, device) -> torch.Tensor:
    """(batch, tbs) bits on `device`: each PDU behind its 2-byte length,
    zero-padded; rows past len(pdus) are empty PDUs."""
    nbytes = tbs // 8
    buf = np.zeros((batch, nbytes), dtype=np.uint8)
    for i, p in enumerate(pdus):
        assert len(p) + 2 <= nbytes, (len(p), nbytes)
        buf[i, 0] = len(p) >> 8
        buf[i, 1] = len(p) & 0xFF
        buf[i, 2 : 2 + len(p)] = np.frombuffer(p, np.uint8)
    return bits_mod.unpack_bits(torch.from_numpy(buf).to(device))[:, :tbs]


def _pdu(row: np.ndarray) -> bytes:
    """The PDU behind its 2-byte length in one decoded byte row."""
    return bytes(row[2 : 2 + ((int(row[0]) << 8) | int(row[1]))])


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
        self.device = _device(device, "WaveformDataPlane")
        self.cell = cell
        self.noise_floor_dbm = noise_floor_dbm
        self.tx_power_dbm = tx_power_dbm
        self.slots: dict = {}  # rnti -> UeSlot
        self.gen = _generator(self.device, 0)
        self.metrics = {"sf_tx": 0, "crc_ok": 0, "crc_fail": 0}

    def add_ue(self, rnti: int, prb_mask: tuple, qm: int = 4,
               cce_start: int = 0, l_aggr: int = 1):
        self.slots[rnti] = UeSlot(rnti, prb_mask, qm, l_aggr=l_aggr, cce_start=cce_start)

    def _grant(self, rnti: int, sf_idx: int) -> tuple:
        s = self.slots[rnti]
        return (rnti, s.prb_mask, s.qm, s.tbs(self.cell, sf_idx), s.l_aggr, s.cce_start)

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
                results.append((_pdu(out_bytes[i]), float(snrs[i])))
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
        payloads = [_pdu_bits(pdus.get(g[0], ()), B, g[3], self.device) for g in plan]
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
        tx = enb_dl.build_subframe(cfg, [_pdu_bits(pdus, len(pdus), grant[3], self.device)])
        rx = channel.awgn(self.gen, tx, self._snr_db(pathloss_db))
        res, _ = ue_dl.decode_subframe(rx, cfg)
        return self._deliver(len(pdus), res)


class MbsfnPlane:
    """Waveform-mode eMBMS: MTCH payloads through the real PMCH pipeline.

    One broadcast waveform per burst (pmch.encode: area scrambling +
    MBSFN-RS in the hybrid-CP subframe, `lib/src/phy/phch/pmch.c` role)
    is heard by every receiver through its own pathloss + AWGN channel —
    one encode, N independent decodes, batched over the burst."""

    def __init__(self, cell: grid_mod.CellConfig, area_id: int = 1, qm: int = 2,
                 code_rate: float = 0.4, tx_power_dbm: float = 30.0,
                 noise_floor_dbm: float = -104.0, seed: int = 5, device="cuda"):
        self.device = _device(device, "MbsfnPlane")
        self.cell = cell
        self.area_id = area_id
        g = pmch.nof_re(cell.n_prb) * qm
        self.cfg = sch.SchConfig(tbs=max(8, (int(g * code_rate) - 24) // 8 * 8), G=g, Qm=qm, Nl=1)
        self.tx_power_dbm = tx_power_dbm
        self.noise_floor_dbm = noise_floor_dbm
        self.gen = _generator(self.device, seed)
        self.metrics = {"sf_tx": 0, "crc_ok": 0, "crc_fail": 0}

    def send(self, pdus: list, pathloss_db: dict, sf_idx: int = 3) -> dict:
        """Broadcast a burst of MTCH byte-PDUs to every listed receiver.

        pathloss_db: {receiver_id: pathloss}.  Returns {receiver_id:
        [delivered bytes | None per PDU]} — None where that receiver's
        channel failed the PMCH CRC."""
        n_prb, b = self.cell.n_prb, len(pdus)
        bits = _pdu_bits(pdus, b, self.cfg.tbs, self.device)
        mb = pmch.encode(bits, self.cfg, n_prb, self.area_id, sf_idx)
        t = ofdm.modulate_mbsfn(cplx.zeros((b, 2, self.cell.nre), device=self.device), mb, n_prb)
        self.metrics["sf_tx"] += b
        results = {}
        for rid in sorted(pathloss_db):
            snr_db = self.tx_power_dbm - pathloss_db[rid] - self.noise_floor_dbm
            _, mb_rx = ofdm.demodulate_mbsfn(channel.awgn(self.gen, t, snr_db), n_prb)
            out, ok = pmch.decode(mb_rx, self.cfg, n_prb, self.area_id, sf_idx)
            out_bytes = bits_mod.pack_bits(out).cpu().numpy()
            ok = ok.cpu().numpy()
            results[rid] = [_pdu(out_bytes[i]) if ok[i] else None for i in range(b)]
            self.metrics["crc_ok"] += int(ok.sum())
            self.metrics["crc_fail"] += b - int(ok.sum())
        return results


class UlControlPlane:
    """Waveform-mode PUCCH: each attached UE transmits HARQ-ACK/SR on its
    own format-1/1a resource; the eNB receives the SUPERPOSITION of every
    UE's uplink waveform plus noise and matched-filters each resource
    (`lib/src/phy/phch/pucch.c` + `srsenb/src/phy/sf_worker.cc` UL control
    decoding): simultaneous PUCCHs on different cyclic shifts of the same
    PRB separate, which the message-level per-RB SINR model treats as
    interference."""

    # detection threshold on matched-filter energy, relative to the
    # noise-only expectation (enb_ul.c pucch threshold role)
    DETECT_SNR = 4.0

    def __init__(self, cell: grid_mod.CellConfig, noise_floor_dbm: float = -104.0,
                 tx_power_dbm: float = 23.0, device="cuda"):
        self.device = _device(device, "UlControlPlane")
        self.cell = cell
        self.noise_floor_dbm = noise_floor_dbm
        self.tx_power_dbm = tx_power_dbm
        self.resources: dict = {}  # rnti -> n_pucch
        self.gen = _generator(self.device, 1)
        self.metrics = {"pucch_tx": 0, "pucch_det": 0, "pucch_dtx": 0}

    def add_ue(self, rnti: int, n_pucch: int):
        self.resources[rnti] = n_pucch

    def step(self, tx: dict, pathloss_db: dict, sf_idx: int = 2) -> dict:
        """tx: {rnti: ack_bit | None}  (None = SR-only presence; absent
        rnti = DTX).  Returns {rnti: (detected, ack_bit, metric_db)}."""
        cell, dev = self.cell, self.device
        rntis = sorted(self.resources)
        U = len(rntis)
        # the BPSK ack symbol per UE (0 amplitude = DTX) and its received
        # amplitude: unit noise at the demodulated grid
        d0 = np.zeros((U, 2), np.float32)
        amp = np.zeros(U, np.float32)
        for u, r in enumerate(rntis):
            if r in tx:
                d0[u, 0] = 1.0 if tx[r] in (None, 1) else -1.0
                amp[u] = 10.0 ** ((self.tx_power_dbm - pathloss_db[r]
                                   - self.noise_floor_dbm) / 20.0)
        d0 = torch.from_numpy(d0).to(dev)
        grids = torch.cat([
            pucch.encode_f1(d0[u : u + 1], cell, sf_idx, self.resources[r],
                            cplx.zeros((1, 14, cell.nre), device=dev))
            for u, r in enumerate(rntis)])
        s = ofdm.modulate(grids, cell.n_prb) * torch.from_numpy(amp).to(dev)[:, None, None]
        rx = s.sum(dim=0, keepdim=True)
        rx = rx + torch.randn(rx.shape, generator=self.gen, device=dev) / np.sqrt(2.0)
        rg = ofdm.demodulate(rx, cell.n_prb)
        det = [pucch.detect_f1(rg, cell, sf_idx, self.resources[r]) for r in rntis]
        corr = torch.stack([c[0] for c, _ in det]).cpu().numpy()
        energy = torch.stack([e[0] for _, e in det]).cpu().numpy()
        out = {}
        for u, r in enumerate(rntis):
            found = bool(energy[u] > self.DETECT_SNR)
            out[r] = (found, int(corr[u, 0] > 0) if found else None,
                      float(10.0 * np.log10(energy[u] + 1e-12)))
            self.metrics["pucch_tx" if r in tx else "pucch_dtx"] += 1
            self.metrics["pucch_det"] += int(found)
        return out


class UlSchPlane:
    """Waveform-mode PUSCH with an aperiodic CQI report multiplexed on
    UL-SCH: the DCI-0 csi_request path carried through the real PHY
    (`lib/src/phy/phch/pusch.c` UCI multiplexing + `cqi.c` aperiodic
    HL-subband reporting).  Each UE's transmission runs SC-FDMA encode
    with the packed 36.212 §5.2.2.6 report punctured in, AWGN at the link
    SNR, then the eNB's MMSE equalise + decode of payload and report."""

    def __init__(self, cell: grid_mod.CellConfig, noise_floor_dbm: float = -104.0,
                 tx_power_dbm: float = 23.0, device="cuda"):
        self.device = _device(device, "UlSchPlane")
        self.cell = cell
        self.noise_floor_dbm = noise_floor_dbm
        self.tx_power_dbm = tx_power_dbm
        self.slots: dict = {}  # rnti -> (rb_start, l_prb, qm)
        self.gen = _generator(self.device, 5)
        self.metrics = {"pusch_tx": 0, "pusch_crc_ok": 0, "cqi_rx": 0}

    def add_ue(self, rnti: int, rb_start: int, l_prb: int, qm: int = 2):
        self.slots[rnti] = (rb_start, l_prb, qm)

    def _dims(self, rnti: int):
        """(SchConfig, CQI report bits, pusch.decode's uci_dims_in)."""
        _, l_prb, qm = self.slots[rnti]
        n_cqi = 4 + 2 * uci_codes.cqi_hl_subband_size(self.cell.n_prb)
        q_ack, q_ri, q_cqi, g_data = pusch.uci_dims(l_prb, qm, 0, 0, n_cqi)
        tbs = max(8, (int(g_data * 0.4) - 24) // 8 * 8)
        cfg = sch.SchConfig(tbs=tbs, G=g_data, Qm=qm, Nl=1)
        return cfg, n_cqi, (q_ack, q_ri, q_cqi, 0, 0, n_cqi)

    def step(self, tx: dict, pathloss_db: dict, sf_idx: int = 4) -> dict:
        """tx: {rnti: (payload_bytes, wb_cqi_int)}.  Returns
        {rnti: (payload_bytes|None, crc_ok, decoded_wb_cqi|None)}."""
        cell = self.cell
        n_sb = uci_codes.cqi_hl_subband_size(cell.n_prb)
        out = {}
        for rnti, (pkt, wb_cqi) in tx.items():
            rb_start, l_prb, _ = self.slots[rnti]
            cfg, n_cqi, dims = self._dims(rnti)
            payload = np.zeros((1, cfg.tbs), np.int8)
            raw = bits_mod.bytes_to_bits(pkt[: cfg.tbs // 8])
            payload[0, : raw.size] = raw
            cqi = uci_codes.pack_cqi_hl_subband(wb_cqi, [0] * n_sb, cell.n_prb)[None, :n_cqi]
            g = pusch.encode(torch.from_numpy(payload).to(self.device), cfg, cell, sf_idx, rnti,
                             rb_start, l_prb, uci=dict(cqi=torch.from_numpy(cqi).to(self.device)))
            snr_db = self.tx_power_dbm - pathloss_db[rnti] - self.noise_floor_dbm
            rx = channel.awgn(self.gen, ofdm.modulate(g, cell.n_prb), snr_db)
            res = pusch.decode(ofdm.demodulate(rx, cell.n_prb), cfg, cell, sf_idx, rnti,
                               rb_start, l_prb, uci_dims_in=dims)
            self.metrics["pusch_tx"] += 1
            if not bool(res["ok"][0]):
                out[rnti] = (None, False, None)
                continue
            self.metrics["pusch_crc_ok"] += 1
            got = bits_mod.bits_to_bytes(res["payload"][0].cpu().numpy())[: len(pkt)]
            rep = uci_codes.unpack_cqi_hl_subband(res["cqi"][0].cpu().numpy(), cell.n_prb)
            self.metrics["cqi_rx"] += 1
            out[rnti] = (bytes(got), True, rep["wideband_cqi"])
        return out


class MimoDataPlane:
    """TM3 2x2 open-loop spatial-multiplexing DL data plane: two transport
    blocks per subframe per UE through the full device pipeline —
    encode_tm -> per-port OFDM -> 2x2 flat channel -> ZF predecode ->
    per-codeword turbo decode (the reference's 150 Mb/s headline config,
    `debian/man/srsenb.txt:17`).  The channel is drawn per burst with a
    conditioning boost on the diagonal (EPA-class rank-2 behaviour)."""

    def __init__(self, cell: grid_mod.CellConfig, noise_floor_dbm: float = -104.0,
                 tx_power_dbm: float = 30.0, cond_boost: float = 3.5, device="cuda"):
        assert cell.n_ports == 2, "TM3 plane needs a 2-port cell"
        self.device = _device(device, "MimoDataPlane")
        self.cell = cell
        self.noise_floor_dbm = noise_floor_dbm
        self.tx_power_dbm = tx_power_dbm
        self.cond_boost = cond_boost
        self.slots = {}
        self.gen = _generator(self.device, 2)
        self.metrics = {"sf_tx": 0, "crc_ok": 0, "crc_fail": 0}

    def add_ue(self, rnti: int, prb_mask: tuple, qm: int = 4):
        self.slots[rnti] = UeSlot(rnti, prb_mask, qm)

    def _sch_cfgs(self, sf_idx: int, rnti: int) -> list:
        s = self.slots[rnti]
        n_re = grid_mod.nof_re(self.cell, sf_idx, s.prb_mask)
        cfg = sch.SchConfig(tbs=s.tbs(self.cell, sf_idx), G=n_re * s.qm, Qm=s.qm, Nl=1)
        return [cfg, cfg]

    def send(self, rnti: int, pdus: list, pathloss_db: float, sf_idx: int = 1) -> list:
        """Burst of DL PDUs, two per subframe (cw0, cw1).  Returns a list of
        (delivered_bytes | None) aligned with `pdus`."""
        cell, dev = self.cell, self.device
        prb_mask = self.slots[rnti].prb_mask
        cfgs = self._sch_cfgs(sf_idx, rnti)
        B = (len(pdus) + 1) // 2  # an odd burst's last cw1 carries an empty PDU
        tbs = [_pdu_bits(pdus[q::2], B, cfgs[q].tbs, dev) for q in range(2)]
        snr_db = self.tx_power_dbm - pathloss_db - self.noise_floor_dbm
        h = torch.randn((B, 2, 2, 2), generator=self.gen, device=dev) / np.sqrt(2.0)
        h = h + self.cond_boost * torch.eye(2, device=dev)[None, :, :, None]
        grids = pdsch.encode_tm(tbs, cfgs, cell, sf_idx, rnti, prb_mask, "tm3")
        rx = channel.mimo_flat(self.gen, ofdm.modulate(grids, cell.n_prb), h, snr_db)
        outs, oks, _ = pdsch.decode_tm(ofdm.demodulate(rx, cell.n_prb), cfgs, cell, sf_idx,
                                       rnti, prb_mask, "tm3")
        outs = [bits_mod.pack_bits(o).cpu().numpy() for o in outs]
        oks = [o.cpu().numpy() for o in oks]
        self.metrics["sf_tx"] += B
        results = []
        for i in range(2 * B):  # the padding PDU counts in the metrics, as in the reference
            q, b = i % 2, i // 2
            results.append(_pdu(outs[q][b]) if oks[q][b] else None)
            self.metrics["crc_ok" if oks[q][b] else "crc_fail"] += 1
        return results[: len(pdus)]
