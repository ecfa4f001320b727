"""MAC layer: eNB scheduler + UE MAC (message-level round-1 versions).

Reference behavior: eNB `srsenb/src/stack/mac/{mac.cc,scheduler*.cc}` —
FAPI-like get_dl_sched/get_ul_sched grant arrays, round-robin metric
(scheduler_metric.h:29-54), RAR after rach_detected, 8-process HARQ; UE
`srsue/src/stack/mac/` — RA procedure (proc_ra.cc:137-154), HARQ, mux/demux.

This module implements the interface surface and the round-robin scheduling
behavior at message level (payload bytes); the bit-level grant/PHY coupling
rides the phch/ layer in waveform mode.
"""

from __future__ import annotations

import collections

from ..phch import ra
from ..runtime.phy_adapter import DlGrant, UlGrant

RAR_RNTI_START = 0x46
MAX_DL_BYTES_PER_TTI = 4096


class EnbMac:
    """eNB MAC + round-robin scheduler (scheduler.cc / scheduler_metric.cc)."""

    def __init__(self, n_prb: int = 25, mcs: int = 9):
        self.n_prb = n_prb
        self.mcs = mcs
        self.next_rnti = RAR_RNTI_START
        self.ues = {}  # rnti -> dict(dl_queue, ul_pending, sr)
        self.rar_pending = []  # (tti, preamble)
        self.rx_pdus = collections.defaultdict(list)  # rnti -> [bytes]
        self.phich_queue = []
        self._rr_next = 0
        self.metrics = collections.Counter()

    # ---- stack_interface_phy_lte (enb_interfaces.h:40-99) ----
    def rach_detected(self, tti: int, preamble: int):
        rnti = self.next_rnti
        self.next_rnti += 1
        self.ues[rnti] = dict(dl_queue=collections.deque(), sr=False,
                              ul_grant_pending=0, preamble=preamble)
        self.rar_pending.append((tti, preamble, rnti))
        self.metrics["rach"] += 1

    def sr_detected(self, tti: int, rnti: int):
        if rnti in self.ues:
            self.ues[rnti]["sr"] = True

    def ul_crc_info(self, tti: int, rnti: int, ok: bool):
        self.metrics["ul_crc_ok" if ok else "ul_crc_err"] += 1
        self.phich_queue.append(dict(rnti=rnti, ack=ok))

    def ul_pdu(self, tti: int, rnti: int, payload: bytes, sinr: float):
        self.rx_pdus[rnti].append(payload)
        self.metrics["ul_bytes"] += len(payload)

    def ack_info(self, tti: int, rnti: int, ack: bool):
        self.metrics["dl_ack" if ack else "dl_nack"] += 1

    # ---- downstream API (RLC enqueues DL SDUs) ----
    def dl_push(self, rnti: int, sdu: bytes):
        self.ues[rnti]["dl_queue"].append(sdu)

    # ---- scheduler (get_dl_sched / get_ul_sched) ----
    def get_dl_sched(self, tti: int):
        grants = []
        # RAR: addressed to RA-RNTI (1 + tti%10), carries the new C-RNTI —
        # the UE validates by preamble echo (proc_ra.cc contention resolution)
        while self.rar_pending:
            _, preamble, rnti = self.rar_pending.pop(0)
            from . import pdu as pdu_mod

            rar = pdu_mod.pack_rar(rapid=preamble, ta=0, ul_grant=0, t_crnti=rnti)
            grants.append(DlGrant(rnti=1 + tti % 10, prb_mask=self._alloc(2),
                                  mcs=0, payload=rar))
            self.metrics["rar"] += 1
        # round robin over UEs with data
        active = [r for r, u in self.ues.items() if u["dl_queue"]]
        if active:
            r = active[self._rr_next % len(active)]
            self._rr_next += 1
            u = self.ues[r]
            payload = u["dl_queue"].popleft()[:MAX_DL_BYTES_PER_TTI]
            # size the allocation from the per-PRB TBS at this MCS so the
            # effective code rate stays at the modulation's operating point
            from ..phch import ra

            bytes_per_prb = max(2, ra.dl_tbs(self.mcs, 1) // 8)
            n_prb_needed = min(self.n_prb, max(2, -(-len(payload) // bytes_per_prb)))
            grants.append(DlGrant(rnti=r, prb_mask=self._alloc(n_prb_needed),
                                  mcs=self.mcs, payload=payload))
            self.metrics["dl_bytes"] += len(payload)
        return grants

    def get_ul_sched(self, tti: int):
        grants = []
        for r, u in self.ues.items():
            if u["sr"]:
                u["sr"] = False
                grants.append(UlGrant(rnti=r, rb_start=0, l_prb=4, mcs=self.mcs))
        return grants

    def get_phich(self, tti: int):
        out = self.phich_queue
        self.phich_queue = []
        return out

    def _alloc(self, n: int) -> tuple:
        return tuple(1 if i < n else 0 for i in range(self.n_prb))


class UeMac:
    """UE MAC: RA procedure + grant handling (proc_ra.cc / mac.cc)."""

    def __init__(self, preamble: int = 7):
        self.preamble = preamble
        self.crnti = None
        self.state = "IDLE"  # IDLE -> PRACH_SENT -> CONNECTED
        self.rx_tbs = []
        self.tx_queue = collections.deque()
        self._ul_grants = collections.deque()
        self._sr_pending = False
        self._acks = collections.deque()
        self.mib = None
        self.metrics = collections.Counter()

    # ---- upward-facing (phy adapter callbacks) ----
    def mib_received(self, tti: int, pbch: dict):
        self.mib = pbch

    def tb_decoded(self, tti: int, payload, snr_db: float):
        if payload is None:
            self.metrics["dl_crc_err"] += 1
            self._acks.append(dict(rnti=self.crnti, ack=[0]))
            return
        self.metrics["dl_crc_ok"] += 1
        from . import pdu as pdu_mod

        if self.state == "PRACH_SENT" and pdu_mod.is_rar(payload):
            rar = pdu_mod.unpack_rar(payload)
            if rar["rapid"] == self.preamble:
                self.crnti = rar["t_crnti"]
                self.state = "CONNECTED"
                self.metrics["connected"] += 1
            return
        self.rx_tbs.append(bytes(payload))
        if self.crnti:
            self._acks.append(dict(rnti=self.crnti, ack=[1]))

    def ul_grant(self, tti: int, grant):
        self._ul_grants.append(grant)

    def harq_ack(self, tti: int, ack: bool):
        self.metrics["phich_ack" if ack else "phich_nack"] += 1

    def listen_rntis(self, tti: int):
        """RNTIs the UE's PDCCH search is armed for this TTI (ue_dl blind
        search RNTI set): RA-RNTI window during RA, else the C-RNTI."""
        if self.state == "PRACH_SENT":
            return set(range(1, 11))
        return {self.crnti} if self.crnti else set()

    # ---- PHY pulls (phy_interface_stack equivalents) ----
    def get_prach(self, tti: int):
        if self.state == "IDLE":
            self.state = "PRACH_SENT"
            return self.preamble
        return None

    def get_pusch(self, tti: int):
        out = []
        while self._ul_grants and self.tx_queue:
            g = self._ul_grants.popleft()
            g = UlGrant(self.crnti, g.rb_start, g.l_prb, g.mcs, g.ndi, g.rv)
            out.append((g, self.tx_queue.popleft()))
        self._ul_grants.clear()
        return out

    def get_pucch(self, tti: int):
        if self._acks:
            a = self._acks.popleft()
            a["sr"] = bool(self.tx_queue)
            return a
        if self.tx_queue and self.state == "CONNECTED":
            return dict(rnti=self.crnti, sr=True, ack=[])
        return None

    # ---- app-facing ----
    def send(self, sdu: bytes):
        self.tx_queue.append(sdu)
