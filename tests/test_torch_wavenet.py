"""PyTorch port vs the JAX package: the waveform-native network
(runtime/wavenet.py, SISO FDD over AWGN) and the two block runners on it
(waveblock.SpsBlockRunner, waveblock_dyn.DynBlockRunner), in lockstep.

Both packages build tests/test_waveblock.py's reference network (15 PRB,
2 UEs, pathloss 80 dB, seed 3, preambles 11 + 5i) from one parameter set,
each with its own copy of the stacks and EPC and a MAC pcap.  The port runs
on the CPU with the plain MAP.  The noise: `jax.random.normal` is patched
while the JAX network runs to hand out numpy draws, which the port's
`wavenet._randn` replays in the same order; the HSS's RAND (os.urandom) is
one seeded stream per package.  The reference's DFT rounds its inputs to
bf16 (`ops/dft.py:87-88`), a noise floor near -54 dB that at this 54 dB
link reads as a second AWGN source in its SNR estimates; the lockstep runs
it with that DFT swapped for an f32 FFT (`_dft_f32`), and
`test_snr_gap_is_the_references_bf16_dft` holds the gap the swap removes.
Per TTI, each UE's sync state and EMM/RRC/MAC states and every PHY metrics
dict must be equal, each UE's SNR estimate within SNR_TOL_DB, and the eNB's
DL samples within a relative RMS of REL.  The decoded TBs of both directions
are held byte for byte through the two pcaps (timestamps dropped).  After the
attach, IP packets ride 30 TTIs of the host-paced network, then two SPS
blocks (T=10) and one dynamic block (R=2), whose draws are replayed as in
tests/test_torch_waveblock.py: the JAX blocks are jitted, so the draws
made while they trace serve every later call.  Between the paced TTIs and
the blocks, more IP packets ride PER_UE_TTIS TTIs through
`WaveUePhy.run_tti`'s per-UE fallback (no shared front end: each UE takes
its own DL from the medium, `dl_take`, and runs its own receive chain,
`_camp_rx`), held TTI by TTI as before.  The whole run is one
module-scoped fixture; the tests read its record.
"""

import struct
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srslte_emane_tpu.epc import hss as j_hss, mme as j_mme, spgw as j_spgw
from srslte_emane_tpu.ops import dft as j_dft, ofdm as j_ofdm
from srslte_emane_tpu.phch import grid as j_grid
from srslte_emane_tpu.runtime import waveblock as j_wb, waveblock_dyn as j_wbd
from srslte_emane_tpu.runtime import wavenet as j_wn
from srslte_emane_tpu.stack import enb_stack as j_enb, security as j_sec
from srslte_emane_tpu.stack import ue_stack as j_ue
from srslte_emane_tpu.utils import pcap as j_pcap
from srslte_emane_tpu_torch.epc import hss as p_hss, mme as p_mme, spgw as p_spgw
from srslte_emane_tpu_torch.ops import ofdm as p_ofdm
from srslte_emane_tpu_torch.phch import dci as p_dci, grid as p_grid
from srslte_emane_tpu_torch.runtime import waveblock as p_wb, waveblock_dyn as p_wbd
from srslte_emane_tpu_torch.runtime import wavenet as p_wn
from srslte_emane_tpu_torch.stack import enb_stack as p_enb, security as p_sec
from srslte_emane_tpu_torch.stack import ue_stack as p_ue
from srslte_emane_tpu_torch.utils import pcap as p_pcap

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

# the network: UE i has IMSI imsi + f"{i:02d}" and preamble preamble + step * i
NET = dict(n_ues=2, n_prb=15, pathloss=80.0, seed=3, imsi="00101000000002", preamble=11,
           step=5)
MAX_ATTACH = 400  # TTIs
PER_UE_TTIS = 6  # TTIs through the per-UE fallback (each JAX subframe compiles anew)
# the two packages' f32 FFTs: 1.20e-7 and 1.8e-4 dB the most over the run
REL = 1e-5  # relative RMS of the DL samples
SNR_TOL_DB = 0.01  # the UEs' chest SNR estimates (dB)
JAX = (j_hss, j_mme, j_spgw, j_enb, j_sec, j_ue, j_pcap, j_wn)
PORT = (p_hss, p_mme, p_spgw, p_enb, p_sec, p_ue, p_pcap, p_wn)


def _dft_f32(x, n=None, inverse=False, ortho=True):
    """The reference's `ops/dft.py` dft without its bf16 input rounding: an
    f32 FFT, the port's transform."""
    assert n is None or n == x.shape[-2]
    z = jax.lax.complex(x[..., 0].astype(jnp.float32), x[..., 1].astype(jnp.float32))
    y = (jnp.fft.ifft if inverse else jnp.fft.fft)(
        z, axis=-1, norm="ortho" if ortho else "backward")
    return jnp.stack([jnp.real(y), jnp.imag(y)], axis=-1)


def _build(pkg, pcap_path, net=NET, **kw):
    """One package's network from the parameter set `net` (by default
    tests/test_waveblock.py's)."""
    hss_mod, mme_mod, spgw_mod, enb_stack, security, ue_stack, pcap_mod, wavenet = pkg
    n_ues = net["n_ues"]
    hss = hss_mod.Hss()
    spgw = spgw_mod.Spgw()
    mme = mme_mod.Mme(hss, spgw)
    enb = enb_stack.EnbStack(mme, enb_id=1, n_prb=net["n_prb"])
    ues = []
    for i in range(n_ues):
        imsi = f"{net['imsi']}{i:02d}"
        key = bytes(range(16))
        hss.add(hss_mod.Subscriber(imsi=imsi, key=key))
        opc = security.milenage_opc(key, b"\x00" * 16)
        ues.append(ue_stack.UeStack(ue_stack.Usim(imsi, key, opc),
                                    preamble=net["preamble"] + net["step"] * i))
    net_ = wavenet.WaveformNetwork(
        enb, ues, pathloss_db=np.full(n_ues, net["pathloss"]), n_prb=net["n_prb"],
        seed=net["seed"], pcap=pcap_mod.MacPcap(str(pcap_path)), **kw)
    return types.SimpleNamespace(net=net_, ues=ues, spgw=spgw, spgw_mod=spgw_mod, enb=enb)


def _fake_os(seed):
    """An `os` stand-in whose urandom is a seeded stream (the HSS's RAND)."""
    rng = np.random.default_rng(seed)
    return types.SimpleNamespace(urandom=lambda n: rng.bytes(n))


class Noise:
    """The JAX medium's draws (its patched jax.random.normal), replayed in
    order by the port's patched wavenet._randn."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.queue = []

    def jax_normal(self, key, shape=(), dtype=jnp.float32):
        x = self.rng.standard_normal(tuple(shape)).astype(np.float32)
        self.queue.append(x)
        return jnp.asarray(x)

    def port_randn(self, gen, shape, device):
        x = self.queue.pop(0)
        assert x.shape == tuple(shape), (x.shape, tuple(shape))
        return torch.from_numpy(x).to(device)


class BlockDraws(Noise):
    """A jitted JAX block's draws, made while its first call traces and
    baked into it: the port hands them out again every len(queue) calls."""

    def __init__(self, seed):
        super().__init__(seed)
        self.calls = 0

    def port_randn(self, gen, shape, device):
        x = self.queue[self.calls % len(self.queue)]
        self.calls += 1
        assert x.shape == tuple(shape), (x.shape, tuple(shape))
        return torch.from_numpy(x).to(device)


def _state(side):
    """What must be equal every TTI: the UEs' sync states, their stacks'
    EMM/RRC/MAC states and out-of-sync counters, the eNB MAC's RI per UE,
    and every PHY metrics dict."""
    return dict(
        sync=[u.state for u in side.net.ues],
        stack=[(u.emm_state, u.rrc_state, u.mac_state, u._consec_err, u.metrics["rlf"])
               for u in side.ues],
        ri={r: getattr(u, "ri", None) for r, u in side.enb.ues.items()},
        enb_metrics=dict(side.net.enb.metrics),
        ue_metrics=[dict(u.metrics) for u in side.net.ues])


def _run_per_ue(net):
    """One TTI of WaveformNetwork.run without the shared front end: every UE
    runs `run_tti` with no samples, batch or search (its fallback)."""
    net.enb.run_tti(net.tti)
    for ue in net.ues:
        ue.run_tti(net.tti)
    net.tti += 1


def _rel_rms(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if not ref.any():  # a silent subframe (TDD U): the port's must be silent too
        return 0.0 if not got.any() else float("inf")
    return float(np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2)))


def _pcap_records(path):
    """Every record's bytes (the MAC context + TB image), timestamps dropped."""
    data = open(path, "rb").read()
    out, off = [], 24
    while off < len(data):
        _, _, n, _ = struct.unpack("!IIII", data[off : off + 16])
        out.append(data[off + 16 : off + 16 + n])
        off += 16 + n
    return out


class Lockstep:
    """Both packages' networks from one parameter set, run TTI by TTI.

    Inside `patch` (a pytest.MonkeyPatch, undone by its owner) the reference
    runs with `_dft_f32`, each HSS draws its RAND from a seeded stream and
    the port's `wavenet._randn` replays the numpy draws that the patched
    `jax.random.normal` hands the reference.  Each step records the TTIs
    whose `_state` differs, the relative RMS of the eNB's DL samples and of
    whatever `probes` return ((jax, port) sample pairs), and the UEs' SNR
    estimates."""

    def __init__(self, tmp, patch, net=NET, **kw):
        self.noise = Noise(5)
        self.tmp = tmp
        patch.setattr(j_dft, "dft", _dft_f32)
        jax.clear_caches()  # nothing traced with the bf16 dft may be reused
        patch.setattr(j_hss, "os", _fake_os(9))
        patch.setattr(p_hss, "os", _fake_os(9))
        patch.setattr(p_wn, "_randn", self.noise.port_randn)
        self.j = _build(JAX, tmp / "jax.pcap", net, **kw)
        self.p = _build(PORT, tmp / "port.pcap", net, device="cpu", **kw)
        self.probes = []
        self.rec = dict(mismatch=[], rel_rms=[], probe_rms=[], snr=[], paced=0)

    def step(self, n=1, per_ue=False):
        """n TTIs of both networks; per_ue: through `_run_per_ue`."""
        j, p, rec = self.j, self.p, self.rec
        for _ in range(n):
            rec["paced"] += 1
            with pytest.MonkeyPatch.context() as mj:
                mj.setattr(jax.random, "normal", self.noise.jax_normal)
                _run_per_ue(j.net) if per_ue else j.net.run(1)
            _run_per_ue(p.net) if per_ue else p.net.run(1)
            assert not self.noise.queue, "the port drew less noise than the reference"
            sj, sp = _state(j), _state(p)
            for key in sj:
                if sj[key] != sp[key]:
                    rec["mismatch"].append((j.net.tti, key, sj[key], sp[key]))
            rec["rel_rms"].append(_rel_rms(p.net.medium._dl[1].numpy(),
                                           np.asarray(j.net.medium._dl[1])))
            rec["probe_rms"].append([_rel_rms(b, a) for probe in self.probes
                                     for a, b in probe()])
            rec["snr"].append([[getattr(u, "last_rsrp_snr", None) for u in s.ues]
                               for s in (j, p)])

    def attach(self, max_tti=MAX_ATTACH):
        """Step until every UE of both networks is REGISTERED."""
        j, p = self.j, self.p
        while j.net.tti < max_tti and not all(
                u.emm_state == "REGISTERED" for u in j.ues + p.ues):
            self.step(1)
        self.rec["attach_tti"] = j.net.tti
        self.rec["registered"] = [[u.emm_state == "REGISTERED" and u.rrc_state == "CONNECTED"
                                   and bool(u.ip_addr) for u in s.ues] for s in (j, p)]

    def offer(self, dl=b"blk" * 40, n_dl=1, ul=b"ul" * 30):
        """Offer each UE n_dl DL packets and one UL packet in both networks;
        records ((the port's DL packets), the port's UL bytes before)."""
        out = []
        for s in (self.j, self.p):
            ul_before = s.spgw.metrics["ul_bytes"]
            pkts = []
            for u in s.ues:
                pkt = s.spgw_mod.make_ipv4("8.8.8.8", u.ip_addr, dl)
                for _ in range(n_dl):
                    assert s.spgw.handle_sgi_pdu(pkt)
                pkts.append(pkt)
                u.gw_send(s.spgw_mod.make_ipv4(u.ip_addr, "8.8.8.8", ul))
            out.append((pkts, ul_before))
        return out

    def pcaps(self):
        return [_pcap_records(self.tmp / f"{s}.pcap") for s in ("jax", "port")]


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    """Run both networks TTI by TTI; returns the record the tests read."""
    with pytest.MonkeyPatch.context() as m:
        ls = Lockstep(tmp_path_factory.mktemp("wavenet"), m)
        j, p, rec = ls.j, ls.p, ls.rec
        ls.attach()
        # tests/test_waveblock.py's IP packets, then 30 host-paced TTIs
        rec["pkts"] = ls.offer()
        ls.step(30)
        rec["gw_rx_paced"] = [[list(u.gw_rx) for u in s.ues] for s in (j, p)]
        rec["spgw_paced"] = [dict(s.spgw.metrics) for s in (j, p)]

        # the per-UE fallback, its calls counted on both sides
        calls = {"take": [0, 0], "camp": [0, 0]}
        with pytest.MonkeyPatch.context() as mc:
            for i, wn in enumerate((j_wn, p_wn)):
                for key, cls, name in (("take", wn.WaveMedium, "dl_take"),
                                       ("camp", wn.WaveUePhy, "_camp_rx")):
                    def counted(*a, _f=getattr(cls, name), _k=key, _i=i):
                        calls[_k][_i] += 1
                        return _f(*a)
                    mc.setattr(cls, name, counted)
            tb_before = [[u.metrics["tb_ok"] for u in s.net.ues] for s in (j, p)]
            rec["pkts_per_ue"] = ls.offer(n_dl=2)
            ls.step(PER_UE_TTIS, per_ue=True)
        rec["per_ue"] = dict(calls=calls, tb_ok=[[u.metrics["tb_ok"] - b for u, b in
                                                  zip(s.net.ues, before)]
                                                 for s, before in zip((j, p), tb_before)],
                             gw_rx=[[list(u.gw_rx) for u in s.ues] for s in (j, p)])

        # the runners, block by block
        rec["runners"] = []

        def blocks(name, jr, pr, n_blocks, draws):
            with pytest.MonkeyPatch.context() as mb:
                mb.setattr(p_wb, "_randn", draws.port_randn)
                for _ in range(n_blocks):
                    with pytest.MonkeyPatch.context() as mj:
                        mj.setattr(jax.random, "normal", draws.jax_normal)
                        jr.run_block()
                    pr.run_block()
                    rec["runners"].append((name, dict(jr.metrics), dict(pr.metrics),
                                           [[list(u.gw_rx) for u in s.ues] for s in (j, p)],
                                           [dict(s.spgw.metrics) for s in (j, p)]))

        blocks("sps", j_wb.SpsBlockRunner(j.net, T=10), p_wb.SpsBlockRunner(p.net, T=10), 2,
               BlockDraws(21))
        blocks("dyn", j_wbd.DynBlockRunner(j.net, R=2), p_wbd.DynBlockRunner(p.net, R=2), 1,
               BlockDraws(23))

        rec["pcaps"] = ls.pcaps()
    yield rec
    jax.clear_caches()


def test_attach_registers_both_networks(lockstep):
    assert lockstep["attach_tti"] < MAX_ATTACH
    assert lockstep["registered"] == [[True, True], [True, True]]


def test_states_and_metrics_equal_every_tti(lockstep):
    assert not lockstep["mismatch"], lockstep["mismatch"][:3]


def test_dl_samples_close_every_tti(lockstep):
    rr = lockstep["rel_rms"]
    assert len(rr) == lockstep["paced"] and max(rr) < REL, max(rr)


def test_decoded_tbs_equal_in_pcaps(lockstep):
    """Byte for byte, the Power Headroom CE too: its level is round(SNR
    estimate + 6) (ue_stack.py:560, pdu.phr_ce), where the chest SNR reaches
    a TB."""
    jp, pp = lockstep["pcaps"]
    assert len(jp) > 40 and len(jp) == len(pp), (len(jp), len(pp))
    assert [k for k, (a, b) in enumerate(zip(jp, pp)) if a != b] == []


def test_snr_estimates_within_tolerance(lockstep):
    """The UEs' chest SNR estimates (54 dB links), every TTI they camp."""
    d = [p - j for js, ps in lockstep["snr"] for j, p in zip(js, ps) if j is not None]
    assert len(d) > 100 and max(abs(x) for x in d) <= SNR_TOL_DB, (min(d), max(d))


def test_ip_packets_delivered_host_paced(lockstep):
    gj, gp = lockstep["gw_rx_paced"]
    assert gj == gp
    pkts, _ = lockstep["pkts"][1]
    assert all(pkt in rx for pkt, rx in zip(pkts, gp))
    sj, sp = lockstep["spgw_paced"]
    assert sj == sp and sp["ul_bytes"] > lockstep["pkts"][1][1]


@pytest.mark.parametrize("block", [0, 1, 2], ids=["sps-1", "sps-2", "dyn-1"])
def test_runner_blocks_equal(lockstep, block):
    name, mj, mp, gw, spgw = lockstep["runners"][block]
    assert mj == mp
    assert gw[0] == gw[1] and spgw[0] == spgw[1]
    # tests/test_waveblock.py:200-203's gates, on the port
    assert mp["dl_ok"] == mp["dl_tb"] > 0 and mp["ul_ok"] == mp["ul_tb"] > 0
    if name == "sps":
        assert mp["ack_det"] == mp["dl_tb"]


def test_per_ue_fallback_equal(lockstep):
    """WaveUePhy.run_tti with no samples and no batch: every UE took its own
    DL and ran its own front end every TTI on both sides, decoded TBs, and
    stayed in lockstep (states, samples and pcaps are held by the tests
    above, which cover these TTIs too)."""
    rec = lockstep["per_ue"]
    n = NET["n_ues"] * PER_UE_TTIS
    assert rec["calls"] == {"take": [n, n], "camp": [n, n]}
    assert rec["tb_ok"][0] == rec["tb_ok"][1] and min(rec["tb_ok"][1]) > 0, rec["tb_ok"]
    assert rec["gw_rx"][0] == rec["gw_rx"][1]


def test_network_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _build(PORT, tmp_path / "x.pcap")


def _snr_reading(links_db, n_draws=16, sf=1):
    """(port, reference with its bf16 DFT, reference with `_dft_f32`) chest
    SNR estimates (len(links_db), n_draws) of the eNB's subframe `sf` under
    AWGN at each link SNR, the medium's DL (WaveMedium.dl_take_all)."""
    cfg = dict(n_prb=NET["n_prb"], cell_id=1, cfi=2)  # WaveformNetwork's cell
    pk = p_wn._CellKernels(p_grid.CellConfig(**cfg), device="cpu")
    g = pk.base_grid(sf, -1)(np.zeros((1, 24), np.int8)).numpy()
    rng = np.random.default_rng(11)
    amp = np.repeat(10.0 ** (-np.asarray(links_db) / 20.0), n_draws)[:, None, None]
    sf_len = p_ofdm.params(NET["n_prb"])["sf_len"]
    noise = (rng.standard_normal((len(amp), sf_len, 2)) / np.sqrt(2.0) * amp).astype(np.float32)
    tx_p = p_ofdm.modulate(torch.from_numpy(g), NET["n_prb"]).numpy()
    snr = [pk.rx_front(sf)(torch.from_numpy(tx_p + noise))[2].numpy()]
    for f32 in (False, True):
        with pytest.MonkeyPatch.context() as m:
            if f32:
                m.setattr(j_dft, "dft", _dft_f32)
            jax.clear_caches()
            tx_j = np.asarray(j_ofdm.modulate(jnp.asarray(g), NET["n_prb"]))
            jk = j_wn._CellKernels(j_grid.CellConfig(**cfg))
            snr.append(np.asarray(jk.rx_front(sf)(jnp.asarray(tx_j + noise))[2]))
    jax.clear_caches()
    return [x.reshape(len(links_db), n_draws) for x in snr]


def test_snr_gap_is_the_references_bf16_dft():
    """Why the lockstep swaps the reference's DFT: with its own bf16 DFT the
    reference reads the lockstep's 54 dB link several dB low, since its
    rounding (relative 2^-9 per input) is a noise floor near -54 dB; at a
    24 dB link, whose AWGN buries that floor, the two agree.  With the f32
    FFT the gap closes to the lockstep's SNR_TOL_DB at both links."""
    port, ref_bf16, ref_f32 = _snr_reading((54.0, 24.0))
    assert np.abs(port - ref_f32).max() <= SNR_TOL_DB, port - ref_f32
    d = port - ref_bf16
    print("port - bf16 reference (dB), by link (min, mean, max):",
          [(float(r.min()), float(r.mean()), float(r.max())) for r in d],
          "| port - f32 reference, largest:", float(np.abs(port - ref_f32).max()))
    assert d[0].min() > 0.5 and d[0].mean() > 1.0, d[0]
    assert np.abs(d[1]).max() < 0.1, d[1]


def _aliased_dci(kind):
    """DCI bits no scheduler sends at 100 PRB, as a CRC alias decodes."""
    n_prb = 100
    if kind == "dci1a-mcs29":
        return p_dci.pack_dl(p_dci.DciDl("1A", mcs=29, rb_start=0, l_crbs=10), n_prb)
    bits = (p_dci.pack_ul(p_dci.DciUl(mcs=10, rb_start=0, l_crbs=46), n_prb)
            if kind.startswith("dci0") else
            p_dci.pack_dl(p_dci.DciDl("1A", mcs=10, rb_start=0, l_crbs=10), n_prb))
    if kind.endswith("past-band"):
        # RIV 5100 decodes to rb_start 99, 50 PRBs (ra.riv_decode's mirror)
        n = p_dci.riv_len(n_prb)
        bits[2 : 2 + n] = [int(c) for c in format(5100, f"0{n}b")]
    return bits


def _ue_phy_at_100_prb():
    """A camped WaveUePhy on a 100 PRB cell with C-RNTI 0x46, its PDSCH
    decode replaced by a recorder that fails every TB."""
    cell = p_grid.CellConfig(n_prb=100, cell_id=1, cfi=3)
    kern = p_wn._CellKernels(cell, device="cpu")
    decodes = []

    def pdsch_rx(l_crbs, mcs, n_re):
        def decode(rg, rnti, re_idx, sf):
            rb_start = int(re_idx[0]) % cell.nre // 12  # the allocation's first RE
            decodes.append((rb_start, l_crbs, mcs))
            return torch.zeros(1, 8, dtype=torch.uint8), torch.zeros(1, dtype=torch.bool)
        return decode

    kern.pdsch_rx = pdsch_rx
    key = bytes(range(16))
    stack = p_ue.UeStack(p_ue.Usim("001010000000200", key,
                                   p_sec.milenage_opc(key, b"\x00" * 16)), preamble=7)
    stack.crnti = 0x46
    phy = p_wn.WaveUePhy(None, cell, stack, kern, 0)
    phy.tti = 123
    return phy, decodes


def _ue_state(phy):
    st = phy.stack
    return (list(st._ul_grants), list(st._acks), dict(st.metrics), st._ul_harq_buf,
            st._ul_retx, st.mac_state, dict(phy.metrics), phy._ack_cce)


@pytest.mark.parametrize("kind", ["dci0-46prb", "dci0-past-band", "dci1a-past-band",
                                  "dci1a-mcs29"])
def test_aliased_dci_stops_at_the_phy(kind):
    """A CRC-aliased DCI with an allocation no scheduler makes (a DCI-0
    width not 2^a 3^b 5^c or past the band, a DCI-1A past the band or with
    MCS 29-31) reaches neither the PDSCH decoder nor the stack, and leaves
    the UE's grants, HARQ and metrics as they were.  The reference has no
    such check and fails in pusch.encode / ra.dl_tbs."""
    phy, decodes = _ue_phy_at_100_prb()
    before = _ue_state(phy)
    phy._handle_dci(None, 0x46, _aliased_dci(kind), 20.0, 4)
    assert decodes == [] and _ue_state(phy) == before


def test_valid_dci_reaches_the_stack():
    """The same path with the allocations a scheduler makes: a 48 PRB DCI-0
    queues a UL grant, a DCI-1A at MCS 28 is decoded and NACKed."""
    phy, decodes = _ue_phy_at_100_prb()
    phy._handle_dci(None, 0x46, p_dci.pack_ul(p_dci.DciUl(mcs=10, rb_start=52, l_crbs=48),
                                              100), 20.0, 4)
    (g,) = phy.stack._ul_grants
    assert (g.rb_start, g.l_prb, g.mcs) == (52, 48, 10)
    phy._handle_dci(None, 0x46, p_dci.pack_dl(p_dci.DciDl("1A", mcs=28, rb_start=0,
                                                          l_crbs=10), 100), 20.0, 4)
    assert decodes == [(0, 10, 28)] and phy.metrics["tb_err"] == 1
    assert phy.stack._acks[-1]["ack"] == [0] and phy._ack_cce == 4
