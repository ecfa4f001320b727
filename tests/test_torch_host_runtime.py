"""PyTorch port vs the JAX package: the host runtime and the utilities.

`runtime/{ttiloop,checkpoint,syssim,distrib,native_bus}.py`,
`utils/{config,crash_handler,iq_io,logging_util,metrics,tun}.py` and the
C++ sources `native/{emanelte_bus,ota_hub}.cpp` are byte copies (held by
tests/test_torch_stack_copy.py); here they run on the port's own stack,
EPC and bus copies, beside the reference's, and every observable of the
reference tests' scenarios (states, addresses, counters, delivered packets)
is held exactly equal: the message-level network is deterministic.  The
port's C++ SINR is held to its NumPy path at tests/test_native_bus.py's
tolerance (rtol 2e-3, atol 1e-2), with no wall-clock assert.
`utils/wire.py` differs from its twin on its module check alone: it admits
the port's classes and refuses the JAX package's.  `utils/radio.py` runs
its CFO shift, AGC and resampling on tensors (here on the CPU) and is held
to the JAX Radio within atol 1e-5; `utils/trace.py` keeps its span records
in a ring buffer with a binary dump (tests/test_torch_trace_spans.py holds
the rest of the tracing).
"""

import pickle
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import srslte_emane_tpu.apps.netsim as j_netsim
import srslte_emane_tpu_torch.apps.netsim as p_netsim
from srslte_emane_tpu.epc import hss as j_hss, mme as j_mme, spgw as j_spgw
from srslte_emane_tpu.runtime import checkpoint as j_ckpt, otabus as j_otabus
from srslte_emane_tpu.runtime import otamsg as j_msg, phy_adapter as j_phy
from srslte_emane_tpu.runtime import sinr as j_sinr, syssim as j_syssim, ttiloop as j_tti
from srslte_emane_tpu.stack import enb_stack as j_enb, nas_msgs as j_nas, nas_wire as j_nas_wire
from srslte_emane_tpu.stack import rrc_msgs as j_rrc, security as j_sec, ue_stack as j_ue
from srslte_emane_tpu.utils import radio as j_radio, wire as j_wire
from srslte_emane_tpu_torch.epc import hss as p_hss, mme as p_mme, spgw as p_spgw
from srslte_emane_tpu_torch.runtime import checkpoint as p_ckpt, distrib as p_distrib
from srslte_emane_tpu_torch.runtime import native_bus as p_native, otabus as p_otabus
from srslte_emane_tpu_torch.runtime import otamsg as p_msg, phy_adapter as p_phy
from srslte_emane_tpu_torch.runtime import sinr as p_sinr, syssim as p_syssim
from srslte_emane_tpu_torch.runtime import ttiloop as p_tti
from srslte_emane_tpu_torch.stack import enb_stack as p_enb, nas_msgs as p_nas
from srslte_emane_tpu_torch.stack import nas_wire as p_nas_wire, rrc_msgs as p_rrc
from srslte_emane_tpu_torch.stack import security as p_sec, ue_stack as p_ue
from srslte_emane_tpu_torch.utils import radio as p_radio, trace as p_trace, wire as p_wire

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

NATIVE = dict(rtol=2e-3, atol=1e-2)  # tests/test_native_bus.py:20
ATOL = 1e-5  # the Radio's DSP against the JAX Radio

PKG = {
    "port": dict(hss=p_hss, mme=p_mme, spgw=p_spgw, sinr=p_sinr, otabus=p_otabus, phy=p_phy,
                 tti=p_tti, enb=p_enb, ue=p_ue, sec=p_sec),
    "ref": dict(hss=j_hss, mme=j_mme, spgw=j_spgw, sinr=j_sinr, otabus=j_otabus, phy=j_phy,
                tti=j_tti, enb=j_enb, ue=j_ue, sec=j_sec),
}


# ---------------- the TTI loop: tests/test_e2e_attach.py ----------------

def _build(m, n_ues=1, pathloss=80.0):
    """tests/test_e2e_attach.py's _build on one package's modules `m`."""
    n = 1 + n_ues
    pl = np.full((n, n), pathloss, np.float32)
    np.fill_diagonal(pl, 0)
    prop = m["sinr"].Propagation(pathloss_db=pl)
    bus = m["otabus"].OtaBus(prop, node_ids=list(range(n)), n_prb=25)
    net = m["tti"].Network(bus)
    hss = m["hss"].Hss()
    spgw = m["spgw"].Spgw()
    mme = m["mme"].Mme(hss, spgw)
    enb = m["enb"].EnbStack(mme, enb_id=1, n_prb=25)
    net.add(m["phy"].EnbPhyAdapter(bus, 0, cell_id=1, n_prb=25, mac=enb))
    ues = []
    for i in range(n_ues):
        imsi = f"00101000000000{i:02d}"
        key = bytes(range(16))
        hss.add(m["hss"].Subscriber(imsi=imsi, key=key))
        opc = m["sec"].milenage_opc(key, b"\x00" * 16)
        ue = m["ue"].UeStack(m["ue"].Usim(imsi, key, opc), preamble=7 + i)
        net.add(m["phy"].UePhyAdapter(bus, 1 + i, cell_id=1, n_prb=25, stack=ue))
        ues.append(ue)
    return net, mme, spgw, enb, ues


def _attach_and_traffic(which, n_ues):
    """Attach, then a DL packet to every UE and a UL packet from each: what
    tests/test_e2e_attach.py's attach and user-plane tests read."""
    m = PKG[which]
    net, mme, spgw, enb, ues = _build(m, n_ues)
    net.run(60 * n_ues)
    out = dict(emm=[u.emm_state for u in ues], rrc=[u.rrc_state for u in ues],
               ip=[u.ip_addr for u in ues], eia=[u.pdcp[1].int_algo for u in ues],
               mme=dict(mme.metrics), reconfig=enb.metrics["reconfig_ok"])
    for i, u in enumerate(ues):
        assert spgw.handle_sgi_pdu(
            m["spgw"].make_ipv4("8.8.8.8", u.ip_addr, b"dns-response" * (20 + i)))
    net.run(30)
    for i, u in enumerate(ues):
        u.gw_send(m["spgw"].make_ipv4(u.ip_addr, "8.8.8.8", b"dns-query" * (10 + i)))
    net.run(30)
    out.update(gw_rx=[list(u.gw_rx) for u in ues], sgi_out=list(spgw.sgi_out),
               spgw=dict(spgw.metrics))
    return out


@pytest.mark.parametrize("n_ues", [1, 3])
def test_e2e_attach_and_user_plane_equal_reference(n_ues):
    got = _attach_and_traffic("port", n_ues)
    assert got == _attach_and_traffic("ref", n_ues)
    assert got["emm"] == ["REGISTERED"] * n_ues and len(set(got["ip"])) == n_ues
    assert min(got["ip"]) == "172.16.0.2" and got["mme"]["attach_ok"] == n_ues
    assert got["eia"] == [p_sec.EIA2] * n_ues
    assert all(len(r) == 1 for r in got["gw_rx"]) and len(got["sgi_out"]) == n_ues


def test_unknown_imsi_rejected():
    net, mme, _, _, (ue,) = _build(PKG["port"])
    mme.hss.subs.clear()  # no subscribers
    net.run(60)
    assert ue.emm_state != "REGISTERED"
    assert mme.metrics["auth_fail"] == 1


# ---------------- checkpoint / resume: tests/test_checkpoint.py ----------------

def _resume(netsim, checkpoint, spgw_mod):
    sysd = netsim.build_network(2, 80.0)
    sysd["net"].run(80)
    assert all(u.emm_state == "REGISTERED" for u in sysd["ues"])
    blob = checkpoint.snapshot(sysd)
    runs = []
    for s in (sysd, checkpoint.restore(blob)):  # continue, then restore and replay
        for u in s["ues"]:
            s["spgw"].handle_sgi_pdu(spgw_mod.make_ipv4("9.9.9.9", u.ip_addr, b"z" * 123))
        s["net"].run(40)
        runs.append(([(u.crnti, u.emm_state, len(u.gw_rx)) for u in s["ues"]],
                     s["bus"].curr_tti, s["ues"][0].gw_rx[-1]))
    assert runs[0] == runs[1]
    return runs[0]


def test_snapshot_resume_determinism_equals_reference():
    assert _resume(p_netsim, p_ckpt, p_spgw) == _resume(j_netsim, j_ckpt, j_spgw)


# ---------------- the system simulator: tests/test_syssim.py ----------------

def _syssim_run(syssim, ue_stack, security, rrc_msgs, nas_msgs, nas_wire):
    key = bytes(range(16))
    ue = ue_stack.UeStack(ue_stack.Usim("001019876543210", key,
                                        security.milenage_opc(key, b"\x00" * 16)))
    ss = syssim.SysSim(ue)
    ss.step(3)
    req = ss.expect_rrc(rrc_msgs.RrcConnectionRequest)
    ss.dl_ccch(rrc_msgs.RrcConnectionSetup())
    ss.step(2)
    done = ss.expect_rrc(rrc_msgs.RrcConnectionSetupComplete)
    attach = nas_wire.decode(done.nas_pdu)
    assert isinstance(attach, nas_msgs.AttachRequest)
    state = [req.cause, done.nas_pdu, attach.imsi, ue.rrc_state]
    ss.dl_rrc(rrc_msgs.UECapabilityEnquiry())
    cap = ss.expect_rrc(rrc_msgs.UECapabilityInformation)
    ss.dl_rrc(rrc_msgs.RrcConnectionRelease())
    ss.step(2)
    return state + [cap.category, ue.rrc_state]


def test_syssim_procedures_equal_reference():
    got = _syssim_run(p_syssim, p_ue, p_sec, p_rrc, p_nas, p_nas_wire)
    assert got == _syssim_run(j_syssim, j_ue, j_sec, j_rrc, j_nas, j_nas_wire)
    cause, nas_pdu, imsi, rrc, category, rrc_after = got
    assert cause == "mo-Data" and nas_pdu[:2] == b"\x07\x41" and imsi == "001019876543210"
    assert rrc == "CONNECTED" and category >= 1 and rrc_after == "IDLE"


# ---------------- the distributed bus: tests/test_distrib.py ----------------

def _two_node_attach(enb_bus, ue_bus, n_ttis):
    m = PKG["port"]
    hss, spgw = p_hss.Hss(), p_spgw.Spgw()
    mme = p_mme.Mme(hss, spgw)
    imsi, key = "001010000000001", bytes(range(16))
    hss.add(p_hss.Subscriber(imsi=imsi, key=key))
    enb = p_enb.EnbStack(mme, enb_id=1, n_prb=25)
    enb_node = m["phy"].EnbPhyAdapter(enb_bus, 0, cell_id=1, n_prb=25, mac=enb)
    ue = p_ue.UeStack(p_ue.Usim(imsi, key, p_sec.milenage_opc(key, b"\x00" * 16)))
    ue_node = m["phy"].UePhyAdapter(ue_bus, 1, cell_id=1, n_prb=25, stack=ue)

    def run_node(node, bus):
        for _ in range(n_ttis):
            node.run_tti(bus.curr_tti)
            bus.step_tti()

    threads = [threading.Thread(target=run_node, args=a)
               for a in ((enb_node, enb_bus), (ue_node, ue_bus))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "a node thread hung on the hub"
    return ue, mme


def test_distributed_attach():
    prop = p_sinr.Propagation(pathloss_db=np.array([[0, 80], [80, 0]], np.float32))
    hub = p_distrib.OtaHub(prop, node_ids=[0, 1], n_prb=25).start()
    buses = [p_distrib.RemoteBus("127.0.0.1", hub.port, i) for i in (0, 1)]
    try:
        ue, mme = _two_node_attach(*buses, 80)
        assert ue.emm_state == "REGISTERED", (ue.emm_state, ue.rrc_state)
        assert mme.metrics["attach_ok"] == 1
    finally:
        for b in buses:
            b.close()
        hub.stop()


def test_native_hub_built_from_the_ports_source():
    assert p_distrib.native_hub_available(), "g++ could not build native/ota_hub"
    assert "srslte_emane_tpu_torch" in p_distrib._HUB_SRC


def test_native_hub_attach():
    prop = p_sinr.Propagation(pathloss_db=np.array([[0, 80], [80, 0]], np.float32))
    hub = p_distrib.NativeHub(prop, n_nodes=2, n_prb=25)
    buses = [p_distrib.NativeRemoteBus("127.0.0.1", hub.port, i, n_prb=25) for i in (0, 1)]
    try:
        ue, mme = _two_node_attach(*buses, 120)
        assert ue.emm_state == "REGISTERED", (ue.emm_state, ue.rrc_state)
        assert mme.metrics["attach_ok"] == 1
    finally:
        for b in buses:
            b.close()
        hub.stop()


def test_native_hub_node_crash_fails_fast():
    prop = p_sinr.Propagation(pathloss_db=np.array([[0, 80], [80, 0]], np.float32))
    hub = p_distrib.NativeHub(prop, n_nodes=2, n_prb=25)
    a = p_distrib.NativeRemoteBus("127.0.0.1", hub.port, 0, n_prb=25)
    b = p_distrib.NativeRemoteBus("127.0.0.1", hub.port, 1, n_prb=25)
    t = threading.Thread(target=b.step_tti)
    t.start()
    a.step_tti()
    t.join(timeout=30)
    assert not t.is_alive()
    b.sock.close()  # crash, no BYE
    try:
        with pytest.raises(ConnectionError):
            for _ in range(3):
                a.step_tti()
    finally:
        hub.stop()


# ---------------- the native bus: tests/test_native_bus.py ----------------

def test_native_library_built_from_the_ports_source():
    assert p_native.available(), "g++ could not build native/libemanelte_tpu.so"
    assert "srslte_emane_tpu_torch" in str(p_native._SO)


@pytest.mark.parametrize("cells", [None, [1, 1, 2, 2, 3]])
def test_native_sinr_matches_numpy(cells, monkeypatch):
    rng = np.random.default_rng(0)
    T, R, P = 5, 4, 50
    args = (rng.uniform(-10, 20, T), (rng.random((T, P)) < 0.5).astype(np.float32),
            rng.uniform(60, 120, (T, R)).astype(np.float32), -110.0)
    nat = p_native.sinr_per_rb_native(*args, cells=cells)
    assert np.array_equal(p_sinr.per_rb_sinr(*args, cells), nat)  # the native path is taken
    monkeypatch.setattr(p_native, "available", lambda: False)
    np.testing.assert_allclose(nat, p_sinr.per_rb_sinr(*args, cells), **NATIVE)


def test_native_bus_queues():
    bus = p_native.NativeBus()
    bus.send(0, [1, 2], b"hello")
    bus.send(1, [2], b"world!")
    assert bus.recv(1) == [(0, b"hello")]
    assert bus.recv(2) == [(0, b"hello"), (1, b"world!")]
    assert bus.recv(2) == []
    assert bus.step_tti() == 1


# ---------------- the radio: tests/test_radio.py ----------------

def _radios(**kw):
    return p_radio.Radio(dsp_device="cpu", **kw), j_radio.Radio(**kw)


def test_radio_loopback_gain_and_padding():
    burst = np.ones((100, 2), np.float32) * 0.5
    outs = []
    for r in _radios(srate_hz=1.92e6):
        r.set_tx_gain(6.0)
        r.tx(burst)  # at sample 0..99
        r.tx(burst, t_start_samples=300)  # gap 100..299 must be zero-padded
        outs.append(r.rx(400))
    got, ref = outs
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got[:100], burst * 10 ** (6 / 20), atol=ATOL)
    assert np.abs(got[100:300]).max() == 0.0


def test_radio_cfo_and_agc_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 2)).astype(np.float32)
    outs = []
    for r in _radios(srate_hz=1.92e6):
        r.set_tx_freq_offset(5000.0)
        r.tx(x)
        shifted = r.rx(256)  # the TX shift alone
        r.set_rx_freq_offset(5000.0)  # receiver corrects the same offset
        r.tx(x)
        back = r.rx(256)
        r.set_rx_freq_offset(0.0)
        r.set_rx_gain(-9.0)
        agc = []
        for _ in range(3):  # the AGC's gain converges over frames
            r.tx(x)
            agc.append(r.rx(256, agc=True))
        outs.append((shifted, back, np.stack(agc), r.channels[0].agc.gain))
    (s_p, b_p, a_p, g_p), (s_j, b_j, a_j, g_j) = outs
    np.testing.assert_allclose(s_p, s_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(b_p, b_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(b_p, x, atol=2e-3)
    np.testing.assert_allclose(a_p, a_j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(g_p, g_j, rtol=1e-5)


def test_radio_resample_matches_jax():
    t = np.arange(1920) / 1.92e6
    x = np.stack([np.cos(2 * np.pi * 1e5 * t), np.sin(2 * np.pi * 1e5 * t)], -1).astype(np.float32)
    got, ref = (r.resample_to(x, 3.84e6) for r in _radios(srate_hz=1.92e6))
    assert got.shape == np.asarray(ref).shape and abs(len(got) - 3840) <= 32
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_radio_multichannel():
    r = p_radio.Radio(nof_channels=2, dsp_device="cpu")
    assert r.nof_channels == 2
    r.set_tx_gain(6.0, channel=1)  # only channel 1 amplified
    a = np.ones((100, 2), np.float32) * 0.5
    b = np.ones((100, 2), np.float32) * 0.25
    r.tx([a, b])
    y = r.rx(100)
    assert y.shape == (2, 100, 2)
    np.testing.assert_allclose(y[0], 0.5, atol=1e-6)
    np.testing.assert_allclose(y[1], 0.25 * 10 ** (6 / 20), rtol=1e-5)
    r.tx(a * 0.1, channel=0)
    np.testing.assert_allclose(r.rx(100, channel=0), 0.05, atol=1e-6)
    assert r.channel_of_carrier(1) == 1
    r.carrier_map[1] = 0  # SCell mapped onto channel 0
    assert r.channel_of_carrier(1) == 0


def test_radio_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_radio.Radio()


# ---------------- trace and crash handler: tests/test_misc_aux.py ----------------

def test_trace_ring_buffer(tmp_path):
    """The span store keeps its newest `capacity` records after it wraps,
    and its dump reads back record for record."""
    tr = p_trace.Trace(capacity=8)
    for tti in range(12):  # wraps
        rid = tr.open(f"tti.{tti % 3}", parent=tti - 1, request=tti, start_ns=10 * tti)
        tr.close(rid, 10 * tti + 5)
    p = tmp_path / "trace.bin"
    tr.dump(str(p))
    recs = p_trace.Trace.load(str(p))
    assert recs == tr.records() and len(recs) == 8
    assert [r.id for r in recs] == list(range(4, 12))  # newest retained after wrap
    assert recs[-1] == p_trace.Span(11, "tti.2", 10, 11, "host", 110, 115)


def test_crash_handler_writes_backtrace(tmp_path):
    p = tmp_path / "bt.txt"
    code = ("from srslte_emane_tpu_torch.utils import crash_handler\n"
            f"crash_handler.install({str(p)!r})\n"
            "raise RuntimeError('boom')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, timeout=120)
    assert r.returncode != 0
    assert b"boom" in p.read_bytes()


# ---------------- the wire ----------------

def test_wire_admits_the_ports_classes_only():
    frame = p_msg.OtaFrame(3, p_msg.UeUlMessage(7, 70, 1), p_msg.TxControl(7, 1, False))
    assert p_wire.safe_loads(p_wire.dumps(frame)) == frame
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(p_wire.safe_loads(p_wire.dumps(arr)), arr)
    ref_frame = j_msg.OtaFrame(3, j_msg.UeUlMessage(7, 70, 1), j_msg.TxControl(7, 1, False))
    with pytest.raises(pickle.UnpicklingError, match="srslte_emane_tpu.runtime.otamsg"):
        p_wire.safe_loads(j_wire.dumps(ref_frame))
    with pytest.raises(pickle.UnpicklingError, match="srslte_emane_tpu_torch"):
        j_wire.safe_loads(p_wire.dumps(frame))  # and the reference refuses the port's

    class Gadget:
        def __reduce__(self):
            return (subprocess.call, (["true"],))

    with pytest.raises(pickle.UnpicklingError, match="subprocess"):
        p_wire.safe_loads(pickle.dumps(Gadget()))
