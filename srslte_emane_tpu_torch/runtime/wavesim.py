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

The reference jits each plane's device chain in a factory cached per key
(`functools.lru_cache`): the port keeps the same factories, keyed alike
and cached per instance.  With `jit` on the card each returns a
`runtime/graphs.jit` step (one CUDA graph per key and argument signature,
replayed at every call, the generator's state going in and coming back);
otherwise the same function runs eagerly on the same tensor arguments.
Packing the PDUs and reading the results stay on the host, outside the
step.  Reconfiguring a UE drops the factories the reference's `add_ue`
drops, and their graphs with them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import enb_dl, ue_dl
from ..ops import bits as bits_mod, channel, cplx, ofdm
from ..phch import grid as grid_mod, pdsch, pmch, pucch, pusch, sch, uci as uci_codes
from ..utils.devices import resolve as _device
from . import graphs


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


def _ue_rx(gen, tx, snr_db, cfg) -> tuple:
    """One UE's channel and receiver: (DCI found, payload bits, CRC ok, SNR
    estimate) of its grant, per row."""
    res, _ = ue_dl.decode_subframe(channel.awgn(gen, tx, snr_db), cfg)
    return res.dci_found[:, 0], res.payloads[0], res.crc_ok[0], res.snr_db


class _Plane:
    """What the planes share: the device, the generator and the steps (whose
    functions hold no reference to their plane: a plane let go frees its
    graphs at once, not at a later garbage collection)."""

    def __init__(self, device, who: str, seed: int, jit: bool):
        self.device = _device(device, who)
        self.gen = _generator(self.device, seed)
        self.jit = jit
        self._memo = {}  # (factory, key...) -> what the factory returned

    def _drop(self, name: str) -> None:
        """Forget every step of factory `name` (the reference's
        cache_clear), and with them their graphs and memory pools."""
        for key in [k for k in self._memo if k[0] == name]:
            del self._memo[key]

    def step_graphs(self) -> dict:
        """{(factory, key...): the step's graphs by argument signature} over
        the graphed steps."""
        steps = {k: v[0] if isinstance(v, tuple) else v for k, v in self._memo.items()}
        return {k: s.graphs for k, s in steps.items() if hasattr(s, "graphs")}

    def graph_counts(self) -> dict:
        """{(factory, key...): graphs captured} over the graphed steps."""
        return {k: len(g) for k, g in self.step_graphs().items()}


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


class WaveformDataPlane(_Plane):
    """Carries DL PDCP PDUs of attached UEs over the waveform pipeline."""

    def __init__(self, cell: grid_mod.CellConfig, noise_floor_dbm: float = -104.0,
                 tx_power_dbm: float = 30.0, device="cuda", jit: bool = True):
        super().__init__(device, "WaveformDataPlane", 0, jit)
        self.cell = cell
        self.noise_floor_dbm = noise_floor_dbm
        self.tx_power_dbm = tx_power_dbm
        self.slots: dict = {}  # rnti -> UeSlot
        self.metrics = {"sf_tx": 0, "crc_ok": 0, "crc_fail": 0}

    def add_ue(self, rnti: int, prb_mask: tuple, qm: int = 4,
               cce_start: int = 0, l_aggr: int = 1):
        slot = UeSlot(rnti, prb_mask, qm, l_aggr=l_aggr, cce_start=cce_start)
        # reconfiguring an rnti drops the (sf_idx, rnti)-keyed steps, as the
        # reference drops its compiled ones: a stale graph would serve the
        # old allocation
        if self.slots.get(rnti) not in (None, slot):
            self._drop("_link_fn")
        self.slots[rnti] = slot

    def _grant(self, rnti: int, sf_idx: int) -> tuple:
        s = self.slots[rnti]
        return (rnti, s.prb_mask, s.qm, s.tbs(self.cell, sf_idx), s.l_aggr, s.cce_start)

    def _snr_db(self, pathloss_db: float) -> float:
        return self.tx_power_dbm - pathloss_db - self.noise_floor_dbm

    def _cfg(self, sf_idx: int, grants: tuple) -> enb_dl.DlSubframeConfig:
        return enb_dl.DlSubframeConfig(cell=self.cell, sf_idx=sf_idx, grants=grants)

    @graphs.per_instance
    def _link_fn(self, sf_idx: int, rnti: int):
        """fn(payload bits, gen, gain, snr_db) -> `_ue_rx` of the UE's grant
        alone in its subframes."""
        cfg = self._cfg(sf_idx, (self._grant(rnti, sf_idx),))

        def run(payload_bits, gen, gain, snr_db):
            return _ue_rx(gen, enb_dl.build_subframe(cfg, [payload_bits]) * gain, snr_db, cfg)

        return graphs.step(run, self.device, self.jit)

    @graphs.per_instance
    def _tti_fn(self, sf_idx: int, plan: tuple):
        """One step per (sf_idx, attached set): the eNB builds a single
        multi-grant subframe (all UEs' PDCCH DCIs + PDSCH), then each UE's
        receiver decodes its grant through its own channel (sf_worker.cc
        serving N grants per TTI).  fn(gen, snrs_db (U,), payload of each
        grant...) -> [`_ue_rx` of each UE]."""
        cfg_all = self._cfg(sf_idx, plan)
        cfg_one = [self._cfg(sf_idx, (g,)) for g in plan]

        def run(gen, snrs_db, *payloads):
            tx = enb_dl.build_subframe(cfg_all, list(payloads))
            return [_ue_rx(gen, tx, snrs_db[u], cu) for u, cu in enumerate(cfg_one)]

        return graphs.step(run, self.device, self.jit)

    def _deliver(self, n: int, out) -> list:
        """[(bytes | None, snr_db), ...] of the first n rows of one UE's
        `_ue_rx`; counts them in the metrics."""
        found, payload, ok, snr = out
        found, ok = found.cpu().numpy(), ok.cpu().numpy()
        out_bytes = bits_mod.pack_bits(payload).cpu().numpy()
        snrs = snr.cpu().numpy()
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

        pdus: {rnti: [pdu bytes, ...]}; UEs with shorter (or no) bursts ride
        zero-length padding PDUs.  Returns {rnti: [(bytes|None, snr_db),
        ...]} aligned with each UE's input list."""
        plan = tuple(self._grant(r, sf_idx) for r in sorted(self.slots))
        B = max((len(v) for v in pdus.values()), default=0)
        if B == 0:
            return {}
        payloads = [_pdu_bits(pdus.get(g[0], ()), B, g[3], self.device) for g in plan]
        snrs = np.asarray([self._snr_db(pathloss_db[g[0]]) for g in plan], np.float32)
        outs = self._tti_fn(sf_idx, plan)(self.gen, snrs, *payloads)
        return {g[0]: self._deliver(len(pdus.get(g[0], ())), o) for g, o in zip(plan, outs)}

    def send(self, rnti: int, pdus: list, pathloss_db: float, sf_idx: int = 1) -> list:
        """Transmit a burst of DL byte-PDUs to one UE through the PHY, in
        subframes that carry its grant alone.

        Returns list of (delivered_bytes | None, snr_db) per PDU — None when
        the PDSCH CRC failed at this pathloss."""
        bits = _pdu_bits(pdus, len(pdus), self._grant(rnti, sf_idx)[3], self.device)
        out = self._link_fn(sf_idx, rnti)(bits, self.gen, 1.0, self._snr_db(pathloss_db))
        return self._deliver(len(pdus), out)


class MbsfnPlane(_Plane):
    """Waveform-mode eMBMS: MTCH payloads through the real PMCH pipeline.

    One broadcast waveform per burst (pmch.encode: area scrambling +
    MBSFN-RS in the hybrid-CP subframe, `lib/src/phy/phch/pmch.c` role)
    is heard by every receiver through its own pathloss + AWGN channel —
    one encode, N independent decodes, batched over the burst."""

    def __init__(self, cell: grid_mod.CellConfig, area_id: int = 1, qm: int = 2,
                 code_rate: float = 0.4, tx_power_dbm: float = 30.0,
                 noise_floor_dbm: float = -104.0, seed: int = 5, device="cuda",
                 jit: bool = True):
        super().__init__(device, "MbsfnPlane", seed, jit)
        self.cell = cell
        self.area_id = area_id
        g = pmch.nof_re(cell.n_prb) * qm
        self.cfg = sch.SchConfig(tbs=max(8, (int(g * code_rate) - 24) // 8 * 8), G=g, Qm=qm, Nl=1)
        self.tx_power_dbm = tx_power_dbm
        self.noise_floor_dbm = noise_floor_dbm
        self.metrics = {"sf_tx": 0, "crc_ok": 0, "crc_fail": 0}

    @graphs.per_instance
    def _fn(self, sf_idx: int, n_rx: int):
        """fn(payload bits, gen, snrs_db (n_rx,)) -> (bits (n_rx, B, tbs),
        CRC ok (n_rx, B)) of every receiver."""
        cfg, area, n_prb, nre = self.cfg, self.area_id, self.cell.n_prb, self.cell.nre

        def run(payload_bits, gen, snrs_db):
            mb = pmch.encode(payload_bits, cfg, n_prb, area, sf_idx)
            ctrl = cplx.zeros((payload_bits.shape[0], 2, nre), device=mb.device)
            t = ofdm.modulate_mbsfn(ctrl, mb, n_prb)
            outs, oks = [], []
            for r in range(n_rx):
                _, mb_rx = ofdm.demodulate_mbsfn(channel.awgn(gen, t, snrs_db[r]), n_prb)
                out, ok = pmch.decode(mb_rx, cfg, n_prb, area, sf_idx)
                outs.append(out)
                oks.append(ok)
            return torch.stack(outs), torch.stack(oks)

        return graphs.step(run, self.device, self.jit)

    def send(self, pdus: list, pathloss_db: dict, sf_idx: int = 3) -> dict:
        """Broadcast a burst of MTCH byte-PDUs to every listed receiver.

        pathloss_db: {receiver_id: pathloss}.  Returns {receiver_id:
        [delivered bytes | None per PDU]} — None where that receiver's
        channel failed the PMCH CRC."""
        rx_ids, b = sorted(pathloss_db), len(pdus)
        bits = _pdu_bits(pdus, b, self.cfg.tbs, self.device)
        snrs = np.asarray([self.tx_power_dbm - pathloss_db[r] - self.noise_floor_dbm
                           for r in rx_ids], np.float32)
        outs, oks = self._fn(sf_idx, len(rx_ids))(bits, self.gen, snrs)
        out_bytes = bits_mod.pack_bits(outs).cpu().numpy()
        oks = oks.cpu().numpy()
        self.metrics["sf_tx"] += b
        results = {}
        for u, rid in enumerate(rx_ids):
            results[rid] = [_pdu(out_bytes[u, i]) if oks[u, i] else None for i in range(b)]
            self.metrics["crc_ok"] += int(oks[u].sum())
            self.metrics["crc_fail"] += b - int(oks[u].sum())
        return results


class UlControlPlane(_Plane):
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
                 tx_power_dbm: float = 23.0, device="cuda", jit: bool = True):
        super().__init__(device, "UlControlPlane", 1, jit)
        self.cell = cell
        self.noise_floor_dbm = noise_floor_dbm
        self.tx_power_dbm = tx_power_dbm
        self.resources: dict = {}  # rnti -> n_pucch
        self.metrics = {"pucch_tx": 0, "pucch_det": 0, "pucch_dtx": 0}

    def add_ue(self, rnti: int, n_pucch: int):
        self.resources[rnti] = n_pucch

    @graphs.per_instance
    def _fn(self, sf_idx: int, resources: tuple):
        """One step per (sf_idx, resource tuple), UEs along the leading
        axis: fn(d0 (U, 2) BPSK ack symbol per UE (0 = DTX), amp (U,)
        received amplitude, gen, noise_amp) -> (corr (U, 2), energy (U,))."""
        cell = self.cell

        def run(d0, amp, gen, noise_amp):
            grids = torch.cat([
                pucch.encode_f1(d0[u : u + 1], cell, sf_idx, n,
                                cplx.zeros((1, 14, cell.nre), device=d0.device))
                for u, n in enumerate(resources)])
            rx = (ofdm.modulate(grids, cell.n_prb) * amp[:, None, None]).sum(dim=0, keepdim=True)
            noise = torch.randn(rx.shape, generator=gen, device=rx.device) * noise_amp
            rg = ofdm.demodulate(rx + noise / np.sqrt(2.0), cell.n_prb)
            det = [pucch.detect_f1(rg, cell, sf_idx, n) for n in resources]
            return torch.stack([c[0] for c, _ in det]), torch.stack([e[0] for _, e in det])

        return graphs.step(run, self.device, self.jit)

    def step(self, tx: dict, pathloss_db: dict, sf_idx: int = 2) -> dict:
        """tx: {rnti: ack_bit | None}  (None = SR-only presence; absent
        rnti = DTX).  Returns {rnti: (detected, ack_bit, metric_db)}."""
        rntis = sorted(self.resources)
        U = len(rntis)
        # unit noise at the demodulated grid <-> per-UE amplitude from SNR
        d0 = np.zeros((U, 2), np.float32)
        amp = np.zeros(U, np.float32)
        for u, r in enumerate(rntis):
            if r in tx:
                d0[u, 0] = 1.0 if tx[r] in (None, 1) else -1.0
                amp[u] = 10.0 ** ((self.tx_power_dbm - pathloss_db[r]
                                   - self.noise_floor_dbm) / 20.0)
        resources = tuple(self.resources[r] for r in rntis)
        corr, energy = self._fn(sf_idx, resources)(d0, amp, self.gen, 1.0)
        corr, energy = corr.cpu().numpy(), energy.cpu().numpy()
        out = {}
        for u, r in enumerate(rntis):
            found = bool(energy[u] > self.DETECT_SNR)
            out[r] = (found, int(corr[u, 0] > 0) if found else None,
                      float(10.0 * np.log10(energy[u] + 1e-12)))
            self.metrics["pucch_tx" if r in tx else "pucch_dtx"] += 1
            self.metrics["pucch_det"] += int(found)
        return out


class UlSchPlane(_Plane):
    """Waveform-mode PUSCH with an aperiodic CQI report multiplexed on
    UL-SCH: the DCI-0 csi_request path carried through the real PHY
    (`lib/src/phy/phch/pusch.c` UCI multiplexing + `cqi.c` aperiodic
    HL-subband reporting).  Each UE's transmission runs SC-FDMA encode
    with the packed 36.212 §5.2.2.6 report punctured in, AWGN at the link
    SNR, then the eNB's MMSE equalise + decode of payload and report."""

    def __init__(self, cell: grid_mod.CellConfig, noise_floor_dbm: float = -104.0,
                 tx_power_dbm: float = 23.0, device="cuda", jit: bool = True):
        super().__init__(device, "UlSchPlane", 5, jit)
        self.cell = cell
        self.noise_floor_dbm = noise_floor_dbm
        self.tx_power_dbm = tx_power_dbm
        self.slots: dict = {}  # rnti -> (rb_start, l_prb, qm)
        self.metrics = {"pusch_tx": 0, "pusch_crc_ok": 0, "cqi_rx": 0}

    def add_ue(self, rnti: int, rb_start: int, l_prb: int, qm: int = 2):
        if self.slots.get(rnti) not in (None, (rb_start, l_prb, qm)):
            self._drop("_fn")  # reconfigured: drop the steps and their graphs
        self.slots[rnti] = (rb_start, l_prb, qm)

    def _dims(self, rnti: int):
        """(SchConfig, CQI report bits, pusch.decode's uci_dims_in)."""
        _, l_prb, qm = self.slots[rnti]
        n_cqi = 4 + 2 * uci_codes.cqi_hl_subband_size(self.cell.n_prb)
        q_ack, q_ri, q_cqi, g_data = pusch.uci_dims(l_prb, qm, 0, 0, n_cqi)
        tbs = max(8, (int(g_data * 0.4) - 24) // 8 * 8)
        cfg = sch.SchConfig(tbs=tbs, G=g_data, Qm=qm, Nl=1)
        return cfg, n_cqi, (q_ack, q_ri, q_cqi, 0, 0, n_cqi)

    @graphs.per_instance
    def _fn(self, rnti: int, sf_idx: int):
        """(fn, SchConfig, CQI report bits): fn(payload (1, tbs), CQI bits
        (1, n_cqi), gen, snr_db) -> pusch.decode's dict."""
        cell = self.cell
        rb_start, l_prb, _ = self.slots[rnti]
        cfg, n_cqi, dims = self._dims(rnti)

        def run(payload, cqi_bits, gen, snr_db):
            g = pusch.encode(payload, cfg, cell, sf_idx, rnti, rb_start, l_prb,
                             uci=dict(cqi=cqi_bits))
            rx = channel.awgn(gen, ofdm.modulate(g, cell.n_prb), snr_db)
            return pusch.decode(ofdm.demodulate(rx, cell.n_prb), cfg, cell, sf_idx, rnti,
                                rb_start, l_prb, uci_dims_in=dims)

        return graphs.step(run, self.device, self.jit), cfg, n_cqi

    def step(self, tx: dict, pathloss_db: dict, sf_idx: int = 4) -> dict:
        """tx: {rnti: (payload_bytes, wb_cqi_int)}.  Returns
        {rnti: (payload_bytes|None, crc_ok, decoded_wb_cqi|None)}."""
        cell = self.cell
        n_sb = uci_codes.cqi_hl_subband_size(cell.n_prb)
        out = {}
        for rnti, (pkt, wb_cqi) in tx.items():
            fn, cfg, n_cqi = self._fn(rnti, sf_idx)
            payload = np.zeros((1, cfg.tbs), np.int8)
            raw = bits_mod.bytes_to_bits(pkt[: cfg.tbs // 8])
            payload[0, : raw.size] = raw
            cqi = np.asarray(uci_codes.pack_cqi_hl_subband(wb_cqi, [0] * n_sb, cell.n_prb),
                             np.int8)[None, :n_cqi]
            snr_db = self.tx_power_dbm - pathloss_db[rnti] - self.noise_floor_dbm
            res = fn(payload, cqi, self.gen, float(snr_db))
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


class MimoDataPlane(_Plane):
    """TM3 2x2 open-loop spatial-multiplexing DL data plane: two transport
    blocks per subframe per UE through the full device pipeline —
    encode_tm -> per-port OFDM -> 2x2 flat channel -> ZF predecode ->
    per-codeword turbo decode (the reference's 150 Mb/s headline config,
    `debian/man/srsenb.txt:17`).  The channel is drawn per burst with a
    conditioning boost on the diagonal (EPA-class rank-2 behaviour),
    outside the step, as the reference draws it outside its jit."""

    def __init__(self, cell: grid_mod.CellConfig, noise_floor_dbm: float = -104.0,
                 tx_power_dbm: float = 30.0, cond_boost: float = 3.5, device="cuda",
                 jit: bool = True):
        assert cell.n_ports == 2, "TM3 plane needs a 2-port cell"
        super().__init__(device, "MimoDataPlane", 2, jit)
        self.cell = cell
        self.noise_floor_dbm = noise_floor_dbm
        self.tx_power_dbm = tx_power_dbm
        self.cond_boost = cond_boost
        self.slots = {}
        self.metrics = {"sf_tx": 0, "crc_ok": 0, "crc_fail": 0}

    def add_ue(self, rnti: int, prb_mask: tuple, qm: int = 4):
        slot = UeSlot(rnti, prb_mask, qm)
        if self.slots.get(rnti) not in (None, slot):
            self._drop("_link_fn")  # reconfigured: drop the steps and their graphs
        self.slots[rnti] = slot

    def _sch_cfgs(self, sf_idx: int, rnti: int) -> list:
        s = self.slots[rnti]
        n_re = grid_mod.nof_re(self.cell, sf_idx, s.prb_mask)
        cfg = sch.SchConfig(tbs=s.tbs(self.cell, sf_idx), G=n_re * s.qm, Qm=s.qm, Nl=1)
        return [cfg, cfg]

    @graphs.per_instance
    def _link_fn(self, sf_idx: int, rnti: int):
        """fn(tb0, tb1, gen, h (B, 2, 2, 2), snr_db) -> (bits 0, bits 1,
        CRC ok 0, CRC ok 1)."""
        cell, mask = self.cell, self.slots[rnti].prb_mask
        cfgs = self._sch_cfgs(sf_idx, rnti)

        def run(tb0, tb1, gen, h, snr_db):
            grids = pdsch.encode_tm([tb0, tb1], cfgs, cell, sf_idx, rnti, mask, "tm3")
            rx = channel.mimo_flat(gen, ofdm.modulate(grids, cell.n_prb), h, snr_db)
            outs, oks, _ = pdsch.decode_tm(ofdm.demodulate(rx, cell.n_prb), cfgs, cell, sf_idx,
                                           rnti, mask, "tm3")
            return outs[0], outs[1], oks[0], oks[1]

        return graphs.step(run, self.device, self.jit)

    def send(self, rnti: int, pdus: list, pathloss_db: float, sf_idx: int = 1) -> list:
        """Burst of DL PDUs, two per subframe (cw0, cw1).  Returns a list of
        (delivered_bytes | None) aligned with `pdus`."""
        dev = self.device
        cfgs = self._sch_cfgs(sf_idx, rnti)
        B = (len(pdus) + 1) // 2  # an odd burst's last cw1 carries an empty PDU
        tbs = [_pdu_bits(pdus[q::2], B, cfgs[q].tbs, dev) for q in range(2)]
        snr_db = self.tx_power_dbm - pathloss_db - self.noise_floor_dbm
        h = torch.randn((B, 2, 2, 2), generator=self.gen, device=dev) / np.sqrt(2.0)
        h = h + self.cond_boost * torch.eye(2, device=dev)[None, :, :, None]
        o0, o1, ok0, ok1 = self._link_fn(sf_idx, rnti)(*tbs, self.gen, h, snr_db)
        outs = [bits_mod.pack_bits(o).cpu().numpy() for o in (o0, o1)]
        oks = [o.cpu().numpy() for o in (ok0, ok1)]
        self.metrics["sf_tx"] += B
        results = []
        for i in range(2 * B):  # the padding PDU counts in the metrics, as in the reference
            q, b = i % 2, i // 2
            results.append(_pdu(outs[q][b]) if oks[q][b] else None)
            self.metrics["crc_ok" if oks[q][b] else "crc_fail"] += 1
        return results[: len(pdus)]
