"""PyTorch port vs the JAX package: the host side of `runtime/sinr.py`
(Propagation, per_rb_sinr, SinrTester, adjudicate), on the inputs of the
reference's own tests (tests/test_native_bus.py, tests/test_runtime_emulation.py).

Both packages' `per_rb_sinr` take their C++ path (`runtime/native_bus.py`,
built with g++ at first use) when it loads.  With both C++ paths switched
off, the port is held to the reference's NumPy path exactly; as they run,
to tests/test_native_bus.py's tolerance (rtol 2e-3, atol 1e-2).  The
message-level network of tests/test_runtime_emulation.py runs on the port's
copies of the bus, PHY adapters, MAC and TTI loop beside the reference's
own.
"""

import numpy as np
import pytest

from srslte_emane_tpu.runtime import native_bus as j_native
from srslte_emane_tpu.runtime import otabus as j_otabus, otamsg as j_msg
from srslte_emane_tpu.runtime import phy_adapter as j_phy, sinr as j_sinr, ttiloop
from srslte_emane_tpu.stack import mac as j_mac
from srslte_emane_tpu_torch.runtime import native_bus as p_native, otabus as p_otabus
from srslte_emane_tpu_torch.runtime import otamsg as p_msg, phy_adapter as p_phy
from srslte_emane_tpu_torch.runtime import sinr as p_sinr, ttiloop as p_ttiloop
from srslte_emane_tpu_torch.stack import mac as p_mac

NATIVE = dict(rtol=2e-3, atol=1e-2)  # tests/test_native_bus.py:20


@pytest.fixture
def numpy_ref(monkeypatch):
    """Both packages with their C++ paths switched off."""
    monkeypatch.setattr(j_native, "available", lambda: False)
    monkeypatch.setattr(p_native, "available", lambda: False)


def _sinr_cases():
    rng = np.random.default_rng(0)  # tests/test_native_bus.py's draws
    T, R, P = 5, 4, 50
    yield "native_bus", (rng.uniform(-10, 20, T), (rng.random((T, P)) < 0.5).astype(np.float32),
                         rng.uniform(60, 120, (T, R)).astype(np.float32), -110.0), None
    rng = np.random.default_rng(1)
    yield "large", (rng.uniform(0, 10, 200), np.ones((200, 100), np.float32),
                    rng.uniform(60, 140, (200, 200)).astype(np.float32), -110.0), None
    # tests/test_runtime_emulation.py's closed-form case
    yield "closed_form", (np.array([0.0, 0.0]), np.ones((2, 4), np.float32),
                          np.array([[50.0, 70.0], [70.0, 50.0]], np.float32), -110.0), None
    rng = np.random.default_rng(2)
    yield "cells", (rng.uniform(-10, 20, 6), (rng.random((6, 25)) < 0.6).astype(np.float32),
                    rng.uniform(60, 120, (6, 3)).astype(np.float32), -104.0), [1, 1, 2, 2, 2, 3]


SINR_CASES = list(_sinr_cases())


@pytest.mark.parametrize("case", SINR_CASES, ids=[c[0] for c in SINR_CASES])
def test_per_rb_sinr_equals_numpy_reference(case, numpy_ref):
    _, args, cells = case
    got = p_sinr.per_rb_sinr(*args, cells)
    ref = j_sinr.per_rb_sinr(*args, cells)
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", SINR_CASES, ids=[c[0] for c in SINR_CASES])
def test_per_rb_sinr_near_native_reference(case):
    _, args, cells = case
    np.testing.assert_allclose(p_sinr.per_rb_sinr(*args, cells),
                               j_sinr.per_rb_sinr(*args, cells), **NATIVE)


def test_closed_form_values():
    out = p_sinr.per_rb_sinr(*SINR_CASES[2][1])
    assert abs(out[0, 0, 0] - 20.0) < 0.1
    assert abs(out[1, 0, 0] + 20.0) < 0.1


def _frames(msg):
    """One TTI's emissions: two co-channel eNBs (one sending only control,
    which occupies the whole band), an SCell carrier, three UEs' uplinks."""
    C, M = msg.Chan, msg.Mod
    ch = msg.ChannelMessage
    dl = [msg.OtaFrame(0, msg.EnbDlMessage(7, 2, 1), msg.TxControl(
              7, 1, True, reference_signal_power_mw=2.0, channels=[
                  ch(C.PDCCH, M.QPSK, 0, prb_slot0=tuple(range(25))),
                  ch(C.PDSCH, M.QAM16, 4000, rnti=70, prb_slot0=tuple(range(3, 10)),
                     prb_slot1=tuple(range(3, 10))),
                  ch(C.PDSCH, M.QAM64, 9000, rnti=71, prb_slot0=tuple(range(12, 20)))])),
          msg.OtaFrame(1, msg.EnbDlMessage(7, 2, 2), msg.TxControl(7, 2, True)),
          msg.OtaFrame(0, msg.EnbDlMessage(7, 2, 1, carrier_idx=1), msg.TxControl(
              7, 1, True, freq_idx=1, channels=[
                  ch(C.PDSCH, M.QPSK, 800, rnti=70, prb_slot0=(0, 1, 2))]))]
    ul = [msg.OtaFrame(2 + u, msg.UeUlMessage(7, 70 + u, 1), msg.TxControl(
              7, 1, False, reference_signal_power_mw=0.2 + 0.1 * u, channels=[
                  ch(C.PUSCH, M.QPSK if u else M.QAM16, 600 * (u + 1), rnti=70 + u,
                     prb_slot0=tuple(range(4 * u, 4 * u + 4))),
                  ch(C.PUCCH, M.QPSK, 2, rnti=70 + u, prb_slot0=(0,), prb_slot1=(24,))]))
          for u in range(3)]
    return dl + ul


PL = np.array([[0, 95, 80, 90, 100],
               [95, 0, 110, 85, 99],
               [80, 110, 0, 70, 75],
               [90, 85, 70, 0, 72],
               [100, 99, 75, 72, 0]], np.float32)
ADJ = ["all", "roles", "recv"]  # adjudicate's receiver sets


def _adj_kw(how, frames):
    if how == "roles":
        return dict(roles={0: "enb", 1: "enb", 2: "ue", 3: "ue", 4: "ue"})
    if how == "recv":
        return dict(recv={id(f): (2, 3, 4) if f.txc.is_downlink else (0,) for f in frames})
    return {}


def _adjudicate(sinr_mod, msg, how):
    """(check results, per-RB SINR per (frame index, rx)) of the first call,
    a cached repeat, and a call after a pathloss edit."""
    frames = _frames(msg)
    idx = {id(f): i for i, f in enumerate(frames)}
    prop = sinr_mod.Propagation(pathloss_db=PL, noise_floor_dbm=-104.0)
    kw = _adj_kw(how, frames)
    first = sinr_mod.adjudicate(frames, prop, 25, list(range(5)), **kw)
    again = sinr_mod.adjudicate(frames, prop, 25, list(range(5)), **kw)  # the cache
    prop.pathloss_db[3, 0] = 60.0  # a mobility edit flushes it
    edited = sinr_mod.adjudicate(frames, prop, 25, list(range(5)), **kw)
    checks = []
    for testers in (first, again, edited):
        out = {}
        for (fid, rx), t in testers.items():
            chans = frames[idx[fid]].txc.channels or [
                msg.ChannelMessage(msg.Chan.PBCH, msg.Mod.QPSK, 0)]
            for c, chm in enumerate(chans):
                out[(idx[fid], rx, c)] = t.check(chm)
        checks.append(out)
    rbs = [{(idx[fid], rx): t._rb for (fid, rx), t in testers.items()}
           for testers in (first, edited)]
    return checks, rbs


@pytest.mark.parametrize("how", ADJ)
def test_adjudicate_equals_numpy_reference(how, numpy_ref):
    got, got_rb = _adjudicate(p_sinr, p_msg, how)
    ref, ref_rb = _adjudicate(j_sinr, j_msg, how)
    assert got == ref
    assert got[0] == got[1] and got[0] != got[2]
    for g, r in zip(got_rb, ref_rb):
        assert g.keys() == r.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], r[k])


@pytest.mark.parametrize("how", ADJ)
def test_adjudicate_near_native_reference(how):
    got, got_rb = _adjudicate(p_sinr, p_msg, how)
    ref, ref_rb = _adjudicate(j_sinr, j_msg, how)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in g:
            np.testing.assert_allclose(g[k][1], r[k][1], **NATIVE)
    for g, r in zip(got_rb, ref_rb):
        for k in g:
            np.testing.assert_allclose(g[k], r[k], **NATIVE)


def _emulation(pkg, pathloss, cells, traffic):
    """tests/test_runtime_emulation.py's network: eNB adapters at the first
    len(cells) nodes, one UE adapter last; returns what its asserts read."""
    sinr_mod, otabus, phy, mac, ttiloop = pkg
    n = len(pathloss)
    prop = sinr_mod.Propagation(pathloss_db=np.asarray(pathloss, np.float32))
    bus = otabus.OtaBus(prop, node_ids=list(range(n)), n_prb=25)
    net = ttiloop.Network(bus)
    enbs = [mac.EnbMac(n_prb=25, mcs=9) for _ in cells]
    for i, (m, cid) in enumerate(zip(enbs, cells)):
        net.add(phy.EnbPhyAdapter(bus, i, cell_id=cid, n_prb=25, mac=m))
    ue_mac = mac.UeMac(preamble=11)
    ue = net.add(phy.UePhyAdapter(bus, n - 1, cell_id=1, n_prb=25, stack=ue_mac))
    net.run(6)
    state = [ue_mac.state, enbs[0].metrics["rach"]]
    if traffic and ue_mac.state == "CONNECTED":
        for i in range(3):
            enbs[0].dl_push(ue_mac.crnti, bytes([i]) * 200)
        ue_mac.send(b"hello-ul" * 10)
        net.run(15)
    else:
        net.run(4)
    return dict(state=state, rx_tbs=list(ue_mac.rx_tbs),
                rx_pdus={k: list(v) for k, v in enbs[0].rx_pdus.items()},
                metrics=dict(enbs[0].metrics), snr=ue.last_snr_db)


EMULATIONS = {"attach_and_data_flow": ([[0, 80], [80, 0]], [1], True),
              "far_ue_fails_sinr": ([[0, 135], [135, 0]], [1], False),
              "interference_between_cells": ([[0, 60, 70], [60, 0, 75], [70, 75, 0]], [1, 2],
                                             True)}


@pytest.mark.parametrize("name", list(EMULATIONS))
def test_message_level_network_equals_reference(name, numpy_ref):
    pl, cells, traffic = EMULATIONS[name]
    got = _emulation((p_sinr, p_otabus, p_phy, p_mac, p_ttiloop), pl, cells, traffic)
    ref = _emulation((j_sinr, j_otabus, j_phy, j_mac, ttiloop), pl, cells, traffic)
    assert got == ref
    assert (got["state"][0] == "CONNECTED") == (name != "far_ue_fails_sinr")
