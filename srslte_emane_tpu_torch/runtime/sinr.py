"""Batched SINR adjudication, the EMANE propagation + SINRTester
equivalent (twin of the reference's `runtime/sinr.py`).

Reference behavior: EMANE computes per-RB SINR from TxControl PRB center
frequencies, pathloss, and interference; receivers call
`SINRTester.sinrCheck/sinrCheck2(channel[, rnti])` which returns
{bPassed, sinr_dB, noiseFloor_dBm} per channel (SURVEY.md §8;
phy_adapter.cc:1366-1497).

The whole network's TTI is adjudicated at once:

  rx_power[t, r, prb] = tx_power[t] * prb_used[t, prb] / pathloss[t, r]
  sinr[t, r, prb]     = rx / (noise + sum_{t' != t} rx_power[t', r, prb])

then per-channel pass/fail by comparing mean SINR over the channel's PRBs
against a per-modulation threshold curve (the BLER-knee table EMANE's model
uses).  The host side (`per_rb_sinr`, `SinrTester`, `adjudicate`) is NumPy
and serves the message bus (`otabus.py`) TTI by TTI; `per_rb_sinr_device`
batches many TTIs on tensors.  The reference's C++ bus (`native_bus.py`)
has no twin here yet, so `per_rb_sinr` always takes the NumPy path.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import otamsg

# SINR decode thresholds (dB) at the BLER knee per modulation — the shape of
# EMANE's pre-computed BLER curves collapsed to their operating points.
THRESHOLD_DB = {
    otamsg.Mod.BPSK: -2.0,
    otamsg.Mod.QPSK: 1.0,
    otamsg.Mod.QAM16: 8.0,
    otamsg.Mod.QAM64: 15.0,
    otamsg.Mod.QAM256: 22.0,
}
# control channels are more protected (PDCCH at aggregation 8 decodes well
# below the QPSK data knee; PRACH's ZC correlation gain is larger still)
CONTROL_MARGIN_DB = {
    otamsg.Chan.PBCH: -4.0,
    otamsg.Chan.PCFICH: -4.0,
    otamsg.Chan.PDCCH: -6.0,
    otamsg.Chan.PHICH: -4.0,
    otamsg.Chan.PRACH: -8.0,
    otamsg.Chan.PUCCH: -4.0,
}


class _TrackedArray(np.ndarray):
    """ndarray view that bumps its owner's version on every __setitem__ —
    lets the adjudication cache detect pathloss edits (test mobility
    scripts write `prop.pathloss_db[i, j] = v` directly) in O(1) instead
    of snapshot-comparing the full N x N matrix every TTI."""

    def __array_finalize__(self, obj):
        self._owner = getattr(obj, "_owner", None)

    def __setitem__(self, key, value):
        owner = self._owner
        if owner is not None:
            owner._version += 1
        np.ndarray.__setitem__(self, key, value)


@dataclasses.dataclass
class Propagation:
    """Static-per-TTI propagation state for N nodes.

    pathloss_db: (N, N) tx->rx pathloss (dB); noise_floor_dbm: scalar.
    The matrix is COPIED at construction; edit it in place through
    `prop.pathloss_db[i, j] = v` (mobility scripts, RLF tests) — those
    writes are version-tracked so the per-TTI adjudication cache
    invalidates in O(1).  Writes to the array originally passed in have
    no effect."""
    pathloss_db: np.ndarray
    noise_floor_dbm: float = -110.0

    def __post_init__(self):
        self._version = 0
        arr = np.array(self.pathloss_db, np.float32).view(_TrackedArray)
        arr._owner = self
        self.pathloss_db = arr


def per_rb_sinr(tx_power_dbm, prb_used, pathloss_db, noise_floor_dbm,
                cells=None):
    """Per-RB SINR for all links of one TTI (host NumPy — the per-TTI control
    path; use per_rb_sinr_device for bulk many-TTI sweeps on the card).

    tx_power_dbm: (T,) transmit powers; prb_used: (T, n_prb) 0/1 masks;
    pathloss_db: (T, R).  Returns sinr_db (T, R, n_prb).

    With `cells` (per-transmitter cell id) given, same-cell emissions do NOT
    interfere with each other — they are code/resource-multiplexed in LTE
    (PRACH Zadoff-Chu preambles, PUCCH cyclic shifts/OCC, scheduler-disjoint
    PUSCH); only other-cell energy plus noise degrades them."""
    tx_mw = 10.0 ** (np.asarray(tx_power_dbm, np.float64) / 10.0)
    pl = 10.0 ** (-np.asarray(pathloss_db, np.float64) / 10.0)  # (T, R)
    used = np.asarray(prb_used, np.float64)  # (T, P)
    rx_mw = tx_mw[:, None, None] * pl[:, :, None] * used[:, None, :]  # (T,R,P)
    total = np.sum(rx_mw, axis=0, keepdims=True)  # (1,R,P)
    noise_mw = 10.0 ** (noise_floor_dbm / 10.0)
    if cells is None:
        own = rx_mw
    else:
        c = np.asarray(cells)
        onehot = (c[:, None] == np.unique(c)[None, :]).astype(np.float64)
        by_cell = np.einsum("tc,trp->crp", onehot, rx_mw)
        own = np.einsum("tc,crp->trp", onehot, by_cell)
    interf = total - own + noise_mw
    sinr = rx_mw / interf
    return 10.0 * np.log10(np.maximum(sinr, 1e-12))


def per_rb_sinr_device(tx_power_dbm, prb_used, pathloss_db, noise_floor_dbm: float):
    """Per-RB SINR (dB) batched over (..., T, R, P): tx_power_dbm (..., T),
    prb_used (..., T, P) 0/1, pathloss_db (..., T, R).  Tensors stay on
    their device; the result is float32."""
    tx_mw = 10.0 ** (torch.as_tensor(tx_power_dbm, dtype=torch.float32) / 10.0)
    pl = 10.0 ** (-torch.as_tensor(pathloss_db, dtype=torch.float32) / 10.0)
    used = torch.as_tensor(prb_used, dtype=torch.float32)
    rx_mw = tx_mw[..., :, None, None] * pl[..., :, :, None] * used[..., :, None, :]
    total = rx_mw.sum(dim=-3, keepdim=True)
    noise_mw = 10.0 ** (noise_floor_dbm / 10.0)
    sinr = rx_mw / (total - rx_mw + noise_mw)
    return 10.0 * torch.log10(sinr.clamp(min=1e-12))


class SinrTester:
    """Per-(tx, rx) SINR check results for one TTI — the SINRTester_ handle
    attached to each received message (phy_adapter.cc sinrCheck/sinrCheck2)."""

    def __init__(self, sinr_db_rb: np.ndarray, noise_floor_dbm: float,
                 full_mean: float = None):
        self._rb = np.asarray(sinr_db_rb)  # (n_prb,) for this (tx, rx) pair
        # scalar fast path: checks run per (channel, rx) per TTI in the
        # host loop; python-float math over the tiny per-RB list is ~10x
        # cheaper than numpy fancy-index + mean at this size.  Converted
        # lazily: testers exist for every (tx, rx) pair but only the pairs
        # a receiver actually listens to ever call check().
        self._rb_list = None
        self._full_mean = full_mean
        self.noise_floor_dbm = noise_floor_dbm

    def _rb_scalars(self):
        if self._rb_list is None:
            self._rb_list = self._rb.tolist()
        return self._rb_list

    def check(self, chmsg: otamsg.ChannelMessage):
        """Returns (passed, sinr_db).  The threshold is the modulation's
        BLER-knee adjusted by the effective code rate (EMANE's BLER curves
        are per-MCS; the rate term reproduces the low-MCS robustness that
        lets e.g. a handover command survive cell-edge SINR)."""
        s0, s1 = chmsg.prb_slot0, chmsg.prb_slot1
        if not s0 and not s1:
            # wideband probe fast path (sync/neighbor measurement): one
            # numpy mean, no per-RB python list
            if self._full_mean is None:
                self._full_mean = float(self._rb.mean())
            n_prbs = len(self._rb)
            sinr = self._full_mean
        else:
            rb = self._rb_scalars()
            prbs = set(s0)
            prbs.update(s1)
            n_prbs = len(prbs)
            sinr = sum(map(rb.__getitem__, prbs)) / n_prbs
        thr = THRESHOLD_DB[chmsg.modulation] + CONTROL_MARGIN_DB.get(
            chmsg.channel_type, 0.0
        )
        if chmsg.number_of_bits and chmsg.channel_type in (
                otamsg.Chan.PDSCH, otamsg.Chan.PUSCH):
            qm = int(chmsg.modulation)
            n_re = max(1, n_prbs) * 12 * 12
            rate = chmsg.number_of_bits / (n_re * max(qm, 1))
            # ~6 dB per doubling of rate around the 0.5 operating point
            thr += min(6.0, max(-8.0, 6.0 * math.log2(max(rate, 1e-3) / 0.5)))
        return sinr >= thr, sinr


def _frame_occ(fr):
    """Occupied-PRB index vector for a frame, cached on the frame."""
    occ = getattr(fr, "_occ_prbs", None)
    if occ is None:
        prbs = set()
        for ch in fr.txc.channels:
            prbs.update(ch.prb_slot0)
            prbs.update(ch.prb_slot1)
        occ = np.fromiter(prbs, np.int64, len(prbs))
        fr._occ_prbs = occ
    return occ


def adjudicate(frames, prop: Propagation, n_prb: int, node_ids, roles=None,
               recv=None):
    """Compute SinrTesters for every (tx frame, rx node) pair of a TTI.

    FDD: downlink and uplink frames live on separate carriers, so they are
    adjudicated as independent interference domains (which also removes
    eNB/UE self-interference); carrier-aggregation component carriers
    (txc.freq_idx) are further independent domains.  Returns
    {(id(frame), rx_id): SinrTester} — keyed by frame identity because one
    node may emit on several carriers in the same TTI.

    Propagation is static between explicit pathloss edits, so a TTI whose
    (transmitter-set, occupancy, receiver-set) signature repeats reuses the
    cached tester objects outright — at deployment scale the steady-state
    DL subframe and the per-stride-phase awake sets recur every few TTIs,
    and the per-RB SINR math drops out of the per-TTI loop entirely.
    Testers are read-only after construction, so sharing them is safe; a
    pathloss edit (mobility, RLF tests) is caught by snapshot compare and
    flushes the cache."""
    cache = getattr(prop, "_adj_cache", None)
    sig = (id(prop.pathloss_db), getattr(prop, "_version", 0),
           prop.noise_floor_dbm)
    if cache is None or prop._adj_sig != sig:
        cache = {}
        prop._adj_cache = cache
        prop._adj_sig = sig
    out = {}
    domains = sorted({(f.txc.is_downlink, f.txc.freq_idx) for f in frames})
    for dom in domains:
        group = [f for f in frames
                 if (f.txc.is_downlink, f.txc.freq_idx) == dom]
        if recv is not None:
            # receiver pruning from the bus's sleep registry: tester
            # objects only for pairs that will actually be delivered.
            # recv was built role-aware by the bus, so the receiver list
            # IS the delivered union — no O(nodes) role scan per TTI.
            want_rx = set()
            for f in group:
                want_rx.update(recv.get(id(f), ()))
            rx_ids = sorted(want_rx)
        elif roles is not None:
            # the EMANE hub's role filter: downlink frames are only ever
            # decoded by UEs, uplink frames only by eNBs — skip the
            # (T x R) SINR work and tester objects for the rest.  The
            # role partition is static: memoize it instead of calling
            # roles.get for every node every TTI.
            part = getattr(prop, "_role_rx", None)
            if part is None or part[0] is not roles or part[1] is not node_ids:
                part = (roles, node_ids,
                        {True: [n for n in node_ids
                                if roles.get(n) == "ue"],
                         False: [n for n in node_ids
                                 if roles.get(n) == "enb"]})
                prop._role_rx = part
            rx_ids = part[2][bool(dom[0])]
        else:
            rx_ids = node_ids
        # interned rx tuple (tuples cache their hash): the receiver set
        # recurs TTI after TTI, so key hashing must not re-walk it
        memo = getattr(prop, "_rxids_memo", None)
        if memo is None:
            memo = prop._rxids_memo = {}
        m = memo.get(dom)
        if m is not None and m[0] == rx_ids:
            rx_t = m[1]
        else:
            rx_t = tuple(rx_ids)
            memo[dom] = (rx_ids, rx_t)
        if recv is not None:
            # the bus interns receiver tuples per (src, domain): reuse
            # them as key components instead of re-tupling per TTI
            rcv_of = [recv[id(f)] for f in group]
            rcv_of = [r if isinstance(r, tuple) else tuple(r)
                      for r in rcv_of]
        else:
            rcv_of = [None] * len(group)
        key = (dom, n_prb, rx_t, tuple(
            (f.src, f.txc.reference_signal_power_mw, f.txc.phy_cell_id,
             not f.txc.channels, _frame_occ(f).tobytes(), rcv)
            for f, rcv in zip(group, rcv_of)))
        by_t = cache.get(key)
        if by_t is None:
            # per-receiver assembly: one receiver's SINR is independent
            # of the rest of the set, so the rotating awake-set of the
            # DRX wake schedule (a different handful of UEs every TTI)
            # reuses each receiver's testers computed on an earlier TTI
            # with the same transmitter/occupancy signature — only
            # receivers never seen under this signature compute anything
            fkey = (dom, n_prb, tuple(
                (f.src, f.txc.reference_signal_power_mw,
                 f.txc.phy_cell_id, not f.txc.channels,
                 _frame_occ(f).tobytes()) for f in group))
            per_rx = cache.get(fkey)
            if per_rx is None:
                if len(cache) >= 4096:
                    cache.clear()
                per_rx = cache[fkey] = {}
            missing = [rid for rid in rx_ids if rid not in per_rx]
            if missing:
                new_by_t = _adjudicate_group(group, prop, n_prb,
                                             missing, node_ids)
                for rid in missing:
                    per_rx[rid] = [new_by_t[t].get(rid)
                                   for t in range(len(group))]
            by_t = []
            for t in range(len(group)):
                rids = rcv_of[t] if rcv_of[t] is not None else rx_ids
                by_t.append({rid: per_rx[rid][t] for rid in rids
                             if per_rx[rid][t] is not None})
            if len(cache) >= 4096:
                cache.clear()
            cache[key] = by_t
        for t, fr in enumerate(group):
            fid = id(fr)
            for rid, tester in by_t[t].items():
                out[(fid, rid)] = tester
    return out


def _adjudicate_group(frames, prop: Propagation, n_prb: int, rx_ids,
                      node_ids=None, recv=None):
    """Returns [ {rx_id: SinrTester} per frame ] — cache-friendly shape
    (no frame identities), mapped to (id(frame), rx) keys by the caller."""
    if not frames or not rx_ids:
        return [{} for _ in frames]
    node_ids = rx_ids if node_ids is None else node_ids
    T = len(frames)
    gidx = {n: i for i, n in enumerate(node_ids)}
    cols = np.asarray([gidx[r] for r in rx_ids])
    tx_power = np.zeros(T, np.float32)
    used = np.zeros((T, n_prb), np.float32)
    pl = np.zeros((T, len(rx_ids)), np.float32)
    for t, fr in enumerate(frames):
        tx_power[t] = 10.0 * np.log10(fr.txc.reference_signal_power_mw + 1e-12)
        # one fancy-index per frame instead of a python loop per PRB (the
        # 100-PRB DL frame made this the per-TTI hot spot at 200 UEs)
        occ = _frame_occ(fr)
        if not fr.txc.channels:
            used[t, :] = 1.0
        elif occ.size:
            used[t, occ] = 1.0
        pl[t, :] = prop.pathloss_db[gidx[fr.src], cols]
    cells = np.asarray([fr.txc.phy_cell_id for fr in frames], np.int32)
    sinr = per_rb_sinr(tx_power, used, pl, prop.noise_floor_dbm, cells)
    # wideband means for ALL (tx, rx) pairs in one vector op: the per-UE
    # sync/neighbor probes hit this every TTI, and per-check numpy mean
    # dispatch dominated the 200-UE receive loop
    wb = sinr.mean(axis=2).tolist()
    out = []
    for t, fr in enumerate(frames):
        wb_t = wb[t]
        sinr_t = sinr[t]
        want = recv.get(id(fr)) if recv is not None else None
        row = {}
        for r, rid in enumerate(rx_ids):
            if rid == fr.src or (want is not None and rid not in want):
                continue
            row[rid] = SinrTester(sinr_t[r], prop.noise_floor_dbm,
                                  full_mean=wb_t[r])
        out.append(row)
    return out
