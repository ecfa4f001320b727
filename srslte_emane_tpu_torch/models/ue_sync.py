"""UE synchronization state machine: CELL_SEARCH -> SFN_SYNC -> CAMPING.

Twin of the reference's `models/ue_sync.py` (`srsue/src/phy/sync.cc`, state
machine at sync.cc:364-470, over `lib/src/phy/ue/ue_sync.c` and
`ue/ue_mib.c`).  The host drives the state machine on numpy sample chunks;
each state's work is a batched call on `device` (cell search with CP
detection, the PBCH hypothesis decode, the tracking PSS correlation).
Tracking refines timing by a windowed PSS correlation around the expected
position and blends CFO estimates from the cyclic prefix (sync.c:343).
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

from ..ops import cplx, ofdm
from ..phch import chest, grid as grid_mod, pbch, sync
from ..utils.devices import resolve


@dataclasses.dataclass
class UeSyncState:
    state: str = "CELL_SEARCH"
    cell_id: int = -1
    n_prb: int = 6
    sample_offset: int = 0
    cfo_hz: float = 0.0
    sfn: int = -1
    n_ports: int = 1
    quality: float = 0.0
    sfo_ppm: float = 0.0  # sample-clock error estimate (sfo.c)
    cp: str = "normal"  # auto-detected during cell search (sync.c:68-78)


def sfo_estimate(peak_drifts, period_samples: int) -> float:
    """Sample-frequency offset from successive PSS timing drifts
    (`lib/src/phy/sync/sfo.c` srslte_sfo_estimate): the mean drift per
    tracking period, as a fraction of the sample clock (x1e6 = ppm)."""
    d = np.asarray(peak_drifts, dtype=np.float64)
    if d.size == 0:
        return 0.0
    return float(np.mean(d)) / period_samples


def cfo_est_cp(samples, n_prb: int) -> float:
    """CP-based CFO estimate (averaged over symbols): the angle between each
    CP and its copy N samples later (ue_sync.c cfo_cp)."""
    p = ofdm.params(n_prb)
    n = p["n"]
    x = np.asarray(samples)
    acc = 0j
    for start, cp in ofdm._symbol_starts(n_prb):
        acc += np.sum(np.conj(x[start : start + cp]) * x[start + n : start + n + cp])
    srate = p["sf_len"] * 1000.0
    return np.angle(acc) / (2 * np.pi) * srate / n


class UeSync:
    """Host-side driver; consumes one subframe of samples per step.  Runs on
    `device` ("cuda" by default: it raises where there is no card)."""

    def __init__(self, n_prb: int = 6, device="cuda"):
        self.s = UeSyncState(n_prb=n_prb)
        self.device = resolve(device, "UeSync")
        self._sf_count = 0
        self._drifts = collections.deque(maxlen=16)

    def step(self, samples: np.ndarray) -> UeSyncState:
        """samples: (SF_LEN_max,) complex64 stream chunk (>= 1 subframe)."""
        if self.s.state == "CELL_SEARCH":
            self._cell_search(samples)
        elif self.s.state == "SFN_SYNC":
            self._sfn_sync(samples)
        else:
            self._track(samples)
        return self.s

    def _on_device(self, x: np.ndarray):
        return cplx.from_numpy(x[None], self.device)

    def _cell_search(self, samples):
        res = sync.cell_search(self._on_device(samples), detect_cp=True)
        res = {k: v[0].item() for k, v in res.items()}
        if res["quality"] < 10.0:
            return
        self.s.cell_id = int(res["cell_id"])
        self.s.cp = "ext" if res["cp_ext"] else "normal"
        # align so the NEXT chunk starts at a subframe boundary of sf 0/5
        self.s.sample_offset = int(res["pss_pos"]) - sync.pss_symbol_start(self.s.n_prb, self.s.cp)
        self.s.quality = res["quality"]
        self.s.cfo_hz = cfo_est_cp(
            samples[self.s.sample_offset : self.s.sample_offset + 1920], self.s.n_prb)
        self._search_sf = int(res["sf_idx"])
        self.s.state = "SFN_SYNC"

    def _corrected(self, samples):
        off = self.s.sample_offset
        sf_len = ofdm.params(self.s.n_prb)["sf_len"]
        x = samples[off : off + sf_len]
        if self.s.cfo_hz:
            n = np.arange(len(x))
            x = x * np.exp(-2j * np.pi * self.s.cfo_hz * n / (sf_len * 1000.0))
        return x

    def _sfn_sync(self, samples):
        """Decode the MIB from the sf 0 capture to learn SFN + ports."""
        if self._search_sf != 0:
            # the found PSS was sf 5; the next PSS occurrence 5 sf later is
            # sf 0: callers feed a continuous stream, so flip the expectation
            self._search_sf = 0
            return
        cell = grid_mod.CellConfig(n_prb=self.s.n_prb, cell_id=self.s.cell_id)
        g = ofdm.demodulate(self._on_device(self._corrected(samples)), self.s.n_prb)
        ch0 = chest.estimate(g, cell, 0, port=0)
        ch1 = chest.estimate(g, cell, 0, port=1)
        mib, ports, off, ok = pbch.decode(g, ch0.ce, cell, ce_port1=ch1.ce)
        if bool(ok[0]):
            info = pbch.unpack_mib(mib[0].cpu().numpy())
            self.s.sfn = info["sfn_msb"] * 4 + int(off[0])
            self.s.n_ports = int(ports[0])
            self.s.state = "CAMPING"

    def _track(self, samples):
        """CAMPING: refine timing via PSS around the expected position and
        update the CFO blend (only on sf 0/5, where the PSS is)."""
        self._sf_count += 1
        sf_idx = (self.s.sfn * 10 + self._sf_count) % 10
        if sf_idx not in (0, 5):
            return
        exp = self.s.sample_offset + sync.pss_symbol_start(self.s.n_prb)
        lo = max(0, exp - 16)
        e, _ = sync.pss_correlate(self._on_device(samples[lo : exp + 16 + 128]))
        pos = int(e[0, self.s.cell_id % 3].argmax())
        drift = (lo + pos) - exp
        if abs(drift) <= 16:
            self.s.sample_offset += drift
            # SFO: mean timing drift per 5 ms tracking period (sfo.c)
            self._drifts.append(drift)
            period = 5 * ofdm.params(self.s.n_prb)["sf_len"]
            self.s.sfo_ppm = 1e6 * sfo_estimate(self._drifts, period)
        cfo_new = cfo_est_cp(self._corrected(samples), self.s.n_prb)
        self.s.cfo_hz += 0.3 * cfo_new  # blended tracking loop (sync.c:343)
