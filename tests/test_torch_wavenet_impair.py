"""PyTorch port vs the JAX package: the waveform network's medium
impairments (runtime/wavenet.py WaveMedium: TDL fading, dynamic delay, HST
Doppler, radio-link failure) and the 2x2 MIMO channel, in lockstep.

The network is tests/test_wavenet.py's EPA attach (6 PRB, 1 UE, 70 dB,
seed 5, EPA at 5 Hz).  After the attach both media get a sweeping path
delay (0.2-1.5 us, 1 s period), the 40 Hz HST Doppler trajectory and a
periodic outage (RLF_OUTAGE), set as attributes as tests/test_wavenet.py
sets them, and the network carries IP traffic through two outage windows.
The lockstep is tests/test_torch_wavenet.py's (`Lockstep`: the reference's
DFT at f32, the AWGN draws replayed, states, metrics and pcaps equal); the
fading's sinusoids, which the reference draws from
fold_in(PRNGKey(77), tti) every TTI, reach the port's `gains_from_phases`
through a patched `fading.draw_phases`.  Besides the eNB's DL samples, the
UE's received DL samples and the eNB's received UL samples are held to
REL every TTI.  The outages are shorter than N310 (10 TTIs), so the UE
counts out-of-sync indications without declaring RLF; RLF with RRC
reestablishment runs on the card (tests/test_torch_cuda.py).

`test_medium_option` holds each option alone on fixed samples.
"""

import jax
import numpy as np
import pytest
import torch

from srslte_emane_tpu.ops import fading as j_fading
from srslte_emane_tpu.runtime import wavenet as j_wn
from srslte_emane_tpu_torch.ops import fading as p_fading
from srslte_emane_tpu_torch.runtime import wavenet as p_wn

from test_torch_wavenet import JAX, PORT, REL, SNR_TOL_DB, Lockstep, Noise, _build, _rel_rms

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

EPA_NET = dict(n_ues=1, n_prb=6, pathloss=70.0, seed=5, imsi="00101000000000", preamble=9,
               step=0)
DYN_DELAY = (0.2, 1.5, 1.0)  # tests/test_wavenet.py:217-220
HST_FD_HZ = 40.0
RLF_OUTAGE = (0.1, 0.006)  # 6 TTIs dead every 100
END_TTI = 245  # past the outages at TTIs 100-105 and 200-205


def _jax_phases(tti, batch, n_taps):
    """The sinusoids' angles and phases the reference draws at `tti`."""
    key = jax.random.fold_in(jax.random.PRNGKey(77), tti)
    shape = (batch, n_taps, j_fading.N_SINUSOIDS)
    return tuple(torch.from_numpy(np.array(jax.random.uniform(k, shape, minval=0.0,
                                                              maxval=2 * np.pi)))
                 for k in jax.random.split(key))


def _replayed_phases(medium):
    """fading.draw_phases for the port's `medium`: the reference's draws of
    the TTI on the air, after checking the port seeded its generator from
    (77, that TTI)."""

    def draw(gen, batch, n_taps, device=None):
        tti = medium._dl[0]
        assert gen.initial_seed() == (p_wn.FADING_SEED << 32) + tti
        return _jax_phases(tti, batch, n_taps)

    return draw


def _keep(patch, obj, name, store, key):
    """Patch obj.name to keep its last result in store[key]."""
    fn = getattr(obj, name)

    def kept(*a):
        store[key] = out = fn(*a)
        return out

    patch.setattr(obj, name, kept)


@pytest.fixture(scope="module")
def impaired(tmp_path_factory):
    with pytest.MonkeyPatch.context() as m:
        ls = Lockstep(tmp_path_factory.mktemp("impair"), m, EPA_NET, fading_profile="epa",
                      doppler_hz=5.0)
        j, p, rec = ls.j, ls.p, ls.rec
        m.setattr(p_fading, "draw_phases", _replayed_phases(p.net.medium))
        last = {}
        for s, side in (("j", j), ("p", p)):
            _keep(m, side.net.medium, "dl_take_all", last, s + "dl")
            _keep(m, side.net.medium, "ul_take", last, s + "ul")

        def received():
            """(jax, port) pairs: the UE's DL samples, the eNB's UL samples."""
            pairs = [(np.asarray(last["jdl"]), last["pdl"].numpy())]
            if last.get("jul") is not None:
                pairs.append((np.asarray(last["jul"][0]), last["pul"][0].numpy()))
            last["jul"] = last["pul"] = None
            return pairs

        ls.probes.append(received)
        ls.attach()
        for side in (j, p):
            side.net.medium.dyn_delay = DYN_DELAY
            side.net.medium.hst_fd_hz = HST_FD_HZ
            side.net.medium.rlf = RLF_OUTAGE
        rec["pkts"] = ls.offer(b"epa" * 40, n_dl=3)
        rec["outage"] = []
        while j.net.tti < END_TTI:
            tti = j.net.tti
            ls.step(1)
            if p.net.medium.in_outage(tti):
                rx_dl = last["pdl"]
                rec["outage"].append((tti, float((rx_dl ** 2).sum(-1).mean()),
                                      p.ues[0]._consec_err, j.ues[0]._consec_err))
            if tti % 50 == 0:
                ls.offer(b"epa" * 40, n_dl=1)
        rec["gw_rx"] = [[list(u.gw_rx) for u in s.ues] for s in (j, p)]
        rec["spgw"] = [dict(s.spgw.metrics) for s in (j, p)]
        rec["pcaps"] = ls.pcaps()
    yield rec
    jax.clear_caches()


def test_attach_through_epa_fading(impaired):
    assert impaired["registered"] == [[True], [True]]


def test_states_and_metrics_equal_every_tti(impaired):
    assert impaired["paced"] >= END_TTI - 200
    assert not impaired["mismatch"], impaired["mismatch"][:3]


def test_samples_close_every_tti(impaired):
    """The eNB's DL, the faded and impaired DL each UE receives, and the
    eNB's UL (zeroed in the outages) within REL."""
    assert max(impaired["rel_rms"]) < REL
    rr = [x for row in impaired["probe_rms"] for x in row]
    assert len(rr) > impaired["paced"] and max(rr) < REL, max(rr)


def test_snr_estimates_within_tolerance(impaired):
    d = [p - j for js, ps in impaired["snr"] for j, p in zip(js, ps) if j is not None]
    assert len(d) > 100 and max(abs(x) for x in d) <= SNR_TOL_DB, (min(d), max(d))


def test_outage_zeroes_the_downlink_and_counts_out_of_sync(impaired):
    """Both windows: the UE hears the noise floor only (70 dB link: signal
    power ~1, noise ~4e-7), and both packages' UEs count the same growing
    run of out-of-sync indications, short of N310."""
    out = impaired["outage"]
    ttis = [t for t, *_ in out]
    for start in (100, 200):  # t mod 0.1 s < 6 ms: 6 or 7 TTIs as the float rounds
        assert 6 <= sum(start <= t < start + 10 for t in ttis) <= 7, ttis
    assert len(ttis) <= 14, ttis
    assert all(pw < 1e-5 for _, pw, _, _ in out), out
    assert all(cp == cj for *_, cp, cj in out) and max(cp for *_, cp, _ in out) >= 5, out


def test_ip_packets_delivered_and_pcaps_equal(impaired):
    gj, gp = impaired["gw_rx"]
    assert gj == gp
    pkts, _ = impaired["pkts"][1]
    assert all(pkt in rx for pkt, rx in zip(pkts, gp))
    assert impaired["spgw"][0] == impaired["spgw"][1]
    jp, pp = impaired["pcaps"]
    assert len(jp) > 20 and jp == pp


# ---------------- one option at a time, on fixed samples ----------------

N_UES, N_PRB = 3, 6
SF_LEN = 1920  # 6 PRB


def _media(opt):
    """Both packages' WaveMedium with one option (mimo and mimo_cond: the
    medium of both WaveformNetworks, whose channel matrices they draw)."""
    if opt in ("mimo", "mimo_cond"):
        net = dict(n_ues=N_UES, n_prb=N_PRB, pathloss=70.0, seed=4, imsi="00101000000003",
                   preamble=3, step=4)
        kw = dict(mimo=True) if opt == "mimo" else dict(mimo=True, mimo_cond=[1.0, 0.3, 0.05])
        return (_build(JAX, "/dev/null", net, **kw).net.medium,
                _build(PORT, "/dev/null", net, device="cpu", **kw).net.medium)
    kw = dict(fading_profile=dict(fading_profile="etu"),
              doppler_hz=dict(fading_profile="eva", doppler_hz=70.0),
              dyn_delay=dict(dyn_delay=(0.5, 4.0, 0.4)),
              hst_fd_hz=dict(hst_fd_hz=750.0),
              rlf=dict(rlf=(0.5, 0.2)))[opt]
    pl = np.array([60.0, 70.0, 80.0])
    return (j_wn.WaveMedium(N_UES, pl, seed=1, srate_hz=SF_LEN * 1e3, **kw),
            p_wn.WaveMedium(N_UES, pl, seed=1, srate_hz=SF_LEN * 1e3, device="cpu", **kw))


@pytest.mark.parametrize("opt", ["fading_profile", "doppler_hz", "dyn_delay", "hst_fd_hz",
                                 "rlf", "mimo", "mimo_cond"])
def test_medium_option(opt, monkeypatch):
    """Each option alone on fixed samples: the DL every UE receives (and,
    for rlf, the UL the eNB receives) within REL of the reference's, at
    TTIs along the option's trajectory; mimo: the channel matrices that
    WaveformNetwork draws are the reference's, element for element."""
    jm, pm = _media(opt)
    noise = Noise(7)
    monkeypatch.setattr(p_wn, "_randn", noise.port_randn)
    monkeypatch.setattr(p_fading, "draw_phases", _replayed_phases(pm))
    rng = np.random.default_rng(3)
    n_tx = 2 if opt.startswith("mimo") else 1
    if n_tx == 2:
        h = np.asarray(jm.mimo_h)
        np.testing.assert_array_equal(pm.mimo_h.numpy(), h)
        s = np.linalg.svd(h[..., 0] + 1j * h[..., 1], compute_uv=False)
        want = [1.0, 1.0, 1.0] if opt == "mimo" else [1.0, 0.3, 0.05]
        np.testing.assert_allclose(s[:, 1] / s[:, 0], want, rtol=1e-5)
    seen = []
    for tti in (0, 137, 250, 480, 901):  # t < 1 s, the span of the f32 Jakes phases' REL
        x = rng.standard_normal((n_tx, SF_LEN, 2)).astype(np.float32) / np.sqrt(2)
        ul = rng.standard_normal((1, SF_LEN, 2)).astype(np.float32)
        got = []
        for med, arr in ((jm, jax.numpy.asarray), (pm, torch.from_numpy)):
            with monkeypatch.context() as mj:
                mj.setattr(jax.random, "normal", noise.jax_normal)
                med.ul_put(tti, 1, arr(ul))
                med.dl_put(tti, arr(x))  # the UL of tti rotates to the eNB
                got.append((np.asarray(med.dl_take_all()), np.asarray(med.ul_take()[0])))
        assert not noise.queue
        (jd, ju), (pd, pu) = got
        assert pd.shape == jd.shape == ((N_UES, 2) if n_tx == 2 else (N_UES,)) + (SF_LEN, 2)
        assert _rel_rms(pd, jd) < REL and _rel_rms(pu, ju) < REL, (tti, _rel_rms(pd, jd))
        seen.append((float((jd ** 2).mean()), float((ju ** 2).mean())))
    if opt == "rlf":
        # tti 0 and 137 sit in the outage (t mod 0.5 < 0.2), the rest not:
        # there the UEs hear their noise floors, the eNB its unit noise
        assert [d < 1e-4 and u < 2.0 for d, u in seen] == [True, True, False, False, False], seen
    else:
        assert min(d for d, _ in seen) > 1e-4, seen
