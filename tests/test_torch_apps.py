"""PyTorch port vs the JAX package: the apps (`python -m
srslte_emane_tpu_torch.apps.<name>`).

`apps/{enb_app,epc_app,hub_app,rpc,ue_app}.py` are copies that name the
port in their usage strings (held by tests/test_torch_stack_copy.py);
`apps/netsim.py` passes `device="cpu"` for --cpu where the reference pins
JAX's platform, and `apps/netscan_app.py` runs the scan on a torch mesh.
Here: the four-process deployment through the port's apps (Python and C++
hub), netsim's message-level runs against the reference's netsim on the same
arguments (every JSON field but the wall-clock ones exactly equal: the
message-level network is deterministic), the reference's observability and
RPC (S1AP over TCP) cases on the port's modules, and a spawned port netsim
that loads neither jax nor the JAX package.  Every spawned process has a
time limit.
"""

import json
import os
import pickletools
import socket
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import srslte_emane_tpu.apps.netsim as j_netsim
from srslte_emane_tpu_torch.apps import netscan_app, netsim, rpc
from srslte_emane_tpu_torch.epc import hss as hss_mod, mme as mme_mod
from srslte_emane_tpu_torch.epc import s1ap_wire, spgw as spgw_mod
from srslte_emane_tpu_torch.runtime import distrib, otabus, phy_adapter, sinr, ttiloop
from srslte_emane_tpu_torch.stack import enb_stack, security, ue_stack
from srslte_emane_tpu_torch.utils import config as config_mod, metrics as metrics_mod
from srslte_emane_tpu_torch.utils import pcap as pcap_mod

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
WALL = {"wall_s", "ttis_per_sec", "realtime_factor"}  # host-clock fields


def _spawn(mod, *args):
    return subprocess.Popen([sys.executable, "-m", mod, *args], cwd=ROOT, env=ENV,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _first_json(proc):
    line = proc.stdout.readline()
    assert line, proc.stderr.read()[:500]
    return json.loads(line)


# ---------------- tests/test_apps_multiprocess.py ----------------

@pytest.mark.parametrize("native", [False, True], ids=["python_hub", "native_hub"])
def test_four_process_attach(native):
    """epc_app + hub_app + enb_app + ue_app as OS processes of the port:
    every message between them goes through the port's restricted
    unpickler (utils/wire.py) or the C++ hub."""
    app = "srslte_emane_tpu_torch.apps."
    procs = []
    try:
        epc = _spawn(app + "epc_app", "--port", "0", "--run-seconds", "90")
        procs.append(epc)
        epc_port = _first_json(epc)["listening"]
        hub = _spawn(app + "hub_app", "--nodes", "2", "--prb", "25", "--pathloss", "80",
                     "--run-seconds", "90", *(["--native"] if native else []))
        procs.append(hub)
        hub_port = _first_json(hub)["listening"]
        nat = ["--native-hub"] if native else []
        enb = _spawn(app + "enb_app", "--hub", f"127.0.0.1:{hub_port}", "--node-id", "0",
                     "--epc", f"127.0.0.1:{epc_port}", "--ttis", "150", *nat)
        procs.append(enb)
        ue = _spawn(app + "ue_app", "--hub", f"127.0.0.1:{hub_port}", "--node-id", "1",
                    "--cell", "1", "--ttis", "150", "--imsi", "001010000000000", *nat)
        procs.append(ue)
        out_ue, err_ue = ue.communicate(timeout=120)
        out_enb, err_enb = enb.communicate(timeout=60)
        ue_result = json.loads(out_ue.strip().splitlines()[-1])
        assert ue_result["emm"] == "REGISTERED", (ue_result, err_ue[-500:])
        assert ue_result["ip"] is not None
        enb_result = json.loads(out_enb.strip().splitlines()[-1])
        assert enb_result.get("rach", 0) >= 1, err_enb[-500:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate(timeout=30)


# ---------------- netsim against the reference's netsim ----------------

NETSIM_RUNS = {
    "attach_traffic": ["--ues", "4", "--ttis", "400", "--prb", "25"],
    "carriers": ["--ues", "2", "--ttis", "300", "--carriers", "2"],
    "tdd": ["--ues", "2", "--ttis", "400", "--tdd", "1"],
    "mbms": ["--ues", "2", "--mbms"],
}


@pytest.mark.parametrize("name", list(NETSIM_RUNS))
def test_netsim_message_level_equals_reference(name, capsys):
    args = ["--cpu"] + NETSIM_RUNS[name]
    got = netsim.main(args)
    ref = j_netsim.main(args)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines == [got, ref]  # each prints its summary as one JSON line
    assert set(got) == set(ref)
    assert {k: v for k, v in got.items() if k not in WALL} == \
        {k: v for k, v in ref.items() if k not in WALL}
    assert got["attached"] == got["ues"] and got["dl_ip_bytes"] > 0
    if name == "mbms":
        assert got["mbms"]["ues_all5"] == 2


def test_spawned_netsim_loads_no_jax():
    """The port's netsim --cpu (with its waveform data plane) as its own
    process: neither jax nor the JAX package is in its sys.modules."""
    code = ("import runpy, sys\n"
            "sys.argv = ['netsim', '--cpu', '--waveform', '--ues', '2', '--ttis', '250']\n"
            "runpy.run_module('srslte_emane_tpu_torch.apps.netsim', run_name='__main__')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'srslte_emane_tpu')]\n"
            "print(json.dumps(bad))\n")
    r = subprocess.run([sys.executable, "-c", "import json\n" + code], cwd=ROOT, env=ENV,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    summary, bad = (json.loads(x) for x in r.stdout.strip().splitlines()[-2:])
    assert bad == []
    assert summary["attached"] == 2
    assert [w["delivered"] for w in summary["waveform"]] == [4, 4]
    assert all(w["pucch_ack"] and w["pusch_ok"] for w in summary["waveform"])


def test_netsim_waveform_modes_need_a_card_without_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        netsim.main(["--waveform-full", "--ues", "1", "--prb", "6"])


def test_netscan_app_mesh_on_the_cpu(capsys):
    found = netscan_app.main(["--cpu", "--mesh", "4", "--cells", "16"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["cells"] == out["correct"] == 16 and out["backend"] == "cpu"
    assert found.shape == (16,)


# ---------------- tests/test_apps_observability.py on the port ----------------

def test_netsim_runs_and_attaches(tmp_path):
    summary = netsim.main(["--ues", "2", "--ttis", "250", "--csv", str(tmp_path / "m.csv")])
    assert summary["attached"] == 2
    assert summary["dl_ip_bytes"] > 0 and summary["ul_ip_bytes"] > 0
    assert (tmp_path / "m.csv").exists()


def test_ostat_endpoint_query():
    hub = metrics_mod.MetricsHub()
    hub.add_source("mac", lambda: {"dl_bytes": 123})
    srv = metrics_mod.OStatServer(hub)
    hub.poll()
    try:
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=2)
        s.sendall(b'{"q":"mac"}')
        s.shutdown(socket.SHUT_WR)
        assert json.loads(s.recv(4096)) == {"dl_bytes": 123}
        s.close()
    finally:
        srv.stop()


def test_mac_pcap_format(tmp_path):
    p = tmp_path / "mac.pcap"
    w = pcap_mod.MacPcap(str(p))
    w.write_pdu(b"\x3f\x00\x01\x02", rnti=0x46, tti=3, is_dl=True)
    w.close()
    raw = p.read_bytes()
    magic, _, _, _, _, _, dlt = struct.unpack("!IHHiIII", raw[:24])
    assert magic == 0xA1B2C3D4 and dlt == 147
    assert raw[24 + 16] == pcap_mod.FDD_RADIO  # first context byte


def test_config_layering(tmp_path):
    conf = tmp_path / "enb.conf"
    conf.write_text("[enb]\nn_prb = 50\ncell_id = 7\n[log]\nlog_level = debug\n")
    cfg = config_mod.load(config_mod.EnbConfig, str(conf), ["--n_prb=100"])
    assert cfg.n_prb == 100  # CLI wins
    assert cfg.cell_id == 7  # file wins over default
    assert cfg.log_level == "debug"
    assert cfg.mcs == 9  # default preserved


# ---------------- the RPC cases of tests/test_s1ap_{live,mobility}_wire.py ----------------

def test_rpc_transport_carries_aper_not_pickled_dataclass():
    captured = {}

    class Sink:
        def initial_ue_message(self, enb_id, msg):
            captured["msg"] = msg
            return "ok"

    srv = rpc.RpcServer(Sink())
    try:
        cli = rpc.RpcClient(srv.host, srv.port)
        msg = mme_mod.InitialUEMessage(enb_ue_id=5, nas_pdu=b"\xca\xfe" * 8)
        assert cli.call("initial_ue_message", 1, msg) == "ok"
        assert captured["msg"] == msg  # the server dispatched the decoded message
        frame = rpc.wire.dumps(dict(path="initial_ue_message",
                                    args=s1ap_wire.encode_args("initial_ue_message", (1, msg)),
                                    kwargs={}))
        ops = [op[0].name for op in pickletools.genops(frame)]
        assert "STACK_GLOBAL" not in ops and "GLOBAL" not in ops
        cli.close()
    finally:
        srv.stop()


def test_rpc_unbridged_path_carries_a_port_dataclass():
    """A path outside the S1AP table crosses as a pickled dataclass of the
    port, which the port's wire admits."""
    srv = rpc.RpcServer(type("Echo", (), {"x2_forward": lambda self, a, b: (a, b)})())
    try:
        cli = rpc.RpcClient(srv.host, srv.port)
        msg = mme_mod.HandoverRequired(mme_ue_id=7, enb_ue_id=70, target_pci=2)
        assert cli.call("x2_forward", 1, msg) == (1, msg)
        cli.close()
    finally:
        srv.stop()


def test_attach_through_live_s1ap_wire():
    hss = hss_mod.Hss()
    spgw = spgw_mod.Spgw()
    mme = mme_mod.Mme(hss, spgw)
    srv = rpc.RpcServer(rpc.EpcFrontend(mme))
    try:
        remote = rpc.RemoteMme(srv.host, srv.port)
        prop = sinr.Propagation(np.full((2, 2), 80.0, np.float32))
        bus = otabus.OtaBus(prop, [0, 1], n_prb=25, roles={0: "enb", 1: "ue"})
        net = ttiloop.Network(bus)
        enb = enb_stack.EnbStack(remote, enb_id=1, n_prb=25)
        net.add(phy_adapter.EnbPhyAdapter(bus, 0, cell_id=1, n_prb=25, mac=enb))
        imsi, key = "001010000000077", bytes(range(16))
        hss.add(hss_mod.Subscriber(imsi=imsi, key=key))
        ue = ue_stack.UeStack(ue_stack.Usim(imsi, key, security.milenage_opc(key, b"\x00" * 16)))
        net.add(phy_adapter.UePhyAdapter(bus, 1, cell_id=1, n_prb=25, stack=ue))
        net.run(120)
        assert ue.emm_state == "REGISTERED", (ue.emm_state, ue.rrc_state)
        assert mme.metrics["attach_ok"] == 1
    finally:
        srv.stop()


def test_s1_handover_signalling_over_tcp_wire():
    class FakeTargetEnb:
        cell_pci = 2
        gtpu_dl = staticmethod(lambda pkt: None)

        def __init__(self):
            self.requests = []

        def ho_request(self, req):
            self.requests.append(req)
            return dict(new_rnti=0x150, preamble=61)

    class FakeSourceEnb:
        cell_pci = 1

        def __init__(self):
            self.commands = []

        def ho_command(self, cmd):
            self.commands.append(cmd)

    class FakeSpgw:
        by_ip = {"10.45.0.2": dict(teid_in=7, teid_out=8)}

        def path_switch(self, ip, sink):
            self.switched = (ip, sink)

    spgw = FakeSpgw()
    mme = mme_mod.Mme.__new__(mme_mod.Mme)
    mme.hss = object()
    mme.spgw = spgw
    mme.ues = {7: dict(enb_id=1, enb_ue_id=70, ue_ip="10.45.0.2", state="ATTACHED",
                       vec=dict(kasme=b"\x55" * 32))}
    mme.metrics = {}
    src, tgt = FakeSourceEnb(), FakeTargetEnb()
    tgt_srv = rpc.RpcServer(tgt, port=0)
    tgt_cli = rpc.RpcClient("127.0.0.1", tgt_srv.port)

    class TargetProxy:
        cell_pci = 2
        gtpu_dl = staticmethod(lambda pkt: None)

        def ho_request(self, req):
            return tgt_cli.call("ho_request", req)

    mme.enbs = {1: src, 2: TargetProxy()}
    mme_srv = rpc.RpcServer(mme, port=0)
    mme_cli = rpc.RpcClient("127.0.0.1", mme_srv.port)
    try:
        mme_cli.call("handover_required", 1, mme_mod.HandoverRequired(
            mme_ue_id=7, enb_ue_id=70, target_pci=2))
        (req,), (cmd,) = tgt.requests, src.commands
        assert req.mme_ue_id == 7 and req.teid_spgw == 7 and len(req.kenb_star) == 32
        assert (cmd.target_pci, cmd.new_rnti, cmd.dedicated_preamble) == (2, 0x150, 61)
        assert cmd.kenb_star == req.kenb_star  # KeNB* consistent both legs
        mme_cli.call("path_switch", 2, mme_mod.PathSwitchRequest(mme_ue_id=7,
                                                                 target_enb_ue_id=0x150))
        assert spgw.switched[0] == "10.45.0.2"
        assert mme.ues[7]["enb_id"] == 2
        assert mme.metrics.get("handover_ok") == 1
    finally:
        tgt_cli.close()
        mme_cli.close()
        tgt_srv.stop()
        mme_srv.stop()


def test_native_hub_app_refuses_without_the_binary(monkeypatch):
    """hub_app --native exits with the reference's message where the C++
    hub cannot be built."""
    from srslte_emane_tpu_torch.apps import hub_app

    monkeypatch.setattr(distrib, "native_hub_available", lambda: False)
    with pytest.raises(SystemExit, match="native ota_hub not built"):
        hub_app.main(["--nodes", "2", "--native", "--run-seconds", "0"])
