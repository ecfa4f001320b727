"""PyTorch port vs the JAX package: the channel simulator (ops/fading.py),
resampling and AGC (ops/resample.py), and PDSCH over EPA/EVA fading.

The cases are the JAX package's tests/test_fading.py, test_fading_link.py
and test_srs_resample.py (the resampler and AGC; SRS is held in
tests/test_torch_uplink.py).  The reference draws its Jakes sinusoids from
jax.random; the port from a torch.Generator.  So the gains are held with
the JAX package's own draw of the angles and phases fed to the port's
`gains_from_phases`, at sf_time_s <= 1 s: float32 cosines of 2 pi f_d
cos(alpha) t + phi, whose rounding grows with the argument, so to 1e-5
absolute at 5 Hz (arguments < 38 rad) and 1e-4 at 100 Hz (< 640 rad).
Taps, delays, CFO ramps, resampled samples and the AGC gain are held to
float32 rounding (relative 1e-5, or 1e-4 where sums of products differ in
order); LLRs after the OFDM demodulator to a relative RMS of 1e-2 (the
reference's DFT rounds its inputs to bf16); decoded bits and CRC flags
exactly.  Both decoders see the same numpy samples.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srslte_emane_tpu.models import pdsch_link as j_link
from srslte_emane_tpu.ops import fading as j_fading
from srslte_emane_tpu.ops import resample as j_resample
from srslte_emane_tpu.phch import chest as j_chest
from srslte_emane_tpu.phch import grid as j_grid
from srslte_emane_tpu.phch import pdsch as j_pdsch
from srslte_emane_tpu.phch import sch as j_sch
from srslte_emane_tpu_torch.models import pdsch_link as p_link
from srslte_emane_tpu_torch.ops import cplx as p_cplx
from srslte_emane_tpu_torch.ops import fading as p_fading
from srslte_emane_tpu_torch.ops import modem as p_modem
from srslte_emane_tpu_torch.ops import ofdm as p_ofdm
from srslte_emane_tpu_torch.ops import resample as p_resample
from srslte_emane_tpu_torch.ops import scrambling as p_scr
from srslte_emane_tpu_torch.phch import chest as p_chest
from srslte_emane_tpu_torch.phch import grid as p_grid
from srslte_emane_tpu_torch.phch import pdsch as p_pdsch
from srslte_emane_tpu_torch.phch import sch as p_sch

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

GAIN_ATOL = {5.0: 1e-5, 100.0: 1e-4}  # Jakes gains at sf_time_s <= 1 s, by Doppler
F32_REL = 1e-5  # same arithmetic, float32 rounding
SUM_REL = 1e-4  # sums of products in another order
DFT_REL = 1e-2  # after the OFDM demodulator (the reference's bf16 DFT)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _rel_rms(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def _jax_phases(key, batch, n_taps):
    """The angles and phases the JAX package's tap_gains draws from `key`."""
    k1, k2 = jax.random.split(key)
    shape = (batch, n_taps, j_fading.N_SINUSOIDS)
    draw = lambda k: _t(jax.random.uniform(k, shape, minval=0.0, maxval=2 * np.pi))
    return draw(k1), draw(k2)


def _noise(rng, x, snr_db):
    """x (numpy) plus complex white noise at snr_db against its mean power."""
    p = np.mean(np.sum(x ** 2, -1), axis=tuple(range(1, x.ndim - 1)), keepdims=True)
    return (x + rng.normal(size=x.shape) * np.sqrt(p / 10 ** (snr_db / 10) / 2)[..., None]
            ).astype(np.float32)


# ---------------- fading ----------------

def test_profile_taps_equal_and_normalized():
    for p in ("epa", "eva", "etu", "none"):
        for srate in (1.92e6, 7.68e6, 30.72e6):
            d, a = p_fading.profile_taps(p, srate)
            jd, ja = j_fading.profile_taps(p, srate)
            np.testing.assert_array_equal(d, jd)
            np.testing.assert_array_equal(a, ja)
            assert abs(np.sum(a ** 2) - 1.0) < 1e-6 and (np.diff(d) >= 0).all()


@pytest.mark.parametrize("doppler_hz,t_s", [(5.0, (0.0, 0.001, 0.5, 1.0)), (100.0, (0.0, 0.05, 1.0))])
def test_gains_from_phases_match_tap_gains(doppler_hz, t_s):
    key = jax.random.PRNGKey(7)
    ref = np.asarray(j_fading.tap_gains(key, 9, np.array(t_s), doppler_hz, batch=6))
    got = p_fading.gains_from_phases(*_jax_phases(key, 6, 9), t_s, doppler_hz)
    assert got.shape == ref.shape == (6, len(t_s), 9, 2)
    np.testing.assert_allclose(got.numpy(), ref, atol=GAIN_ATOL[doppler_hz])


def test_rayleigh_statistics():
    """Tap gains are ~unit-power complex Gaussian over realizations."""
    gen = torch.Generator().manual_seed(0)
    p = p_cplx.abs2(p_fading.tap_gains(gen, 1, np.zeros(1), 5.0, batch=4000)).numpy()
    assert abs(p.mean() - 1.0) < 0.1


def test_fading_evolves_with_doppler():
    alpha, phi = p_fading.draw_phases(torch.Generator().manual_seed(1), 8, 1)
    t = np.array([0.0, 0.05])
    g = p_fading.gains_from_phases(alpha, phi, t, 100.0).numpy()
    assert not np.allclose(g[:, 0], g[:, 1], atol=1e-3)
    g0 = p_fading.gains_from_phases(alpha, phi, t, 0.0).numpy()
    np.testing.assert_allclose(g0[:, 0], g0[:, 1], atol=1e-6)


@pytest.mark.parametrize("profile", ["epa", "eva"])
def test_apply_fading_matches(profile):
    """The JAX draw's taps through the port's delay line: the same faded
    subframe as the JAX package's apply_fading."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7680, 2)).astype(np.float32)
    key, srate = jax.random.PRNGKey(2), 7.68e6
    jy, jg = j_fading.apply_fading(jnp.asarray(x), key, profile, srate, doppler_hz=5.0,
                                   sf_time_s=0.3)
    d, a = p_fading.profile_taps(profile, srate)
    g = p_fading.gains_from_phases(*_jax_phases(key, 3, len(d)), [0.3], 5.0)[:, 0]
    g = g * _t(a)[None, :, None]
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=GAIN_ATOL[5.0])
    y = p_fading.tdl(_t(x), _t(np.asarray(jg)), d)
    assert _rel_rms(y, jy) < F32_REL
    # and the port's own draw: same shapes, unit average power
    py, pg = p_fading.apply_fading(_t(x), torch.Generator().manual_seed(0), profile, srate)
    assert py.shape == x.shape and pg.shape == (3, len(d), 2)


def test_rlf_cfo_delay_helpers():
    x = np.random.default_rng(3).normal(size=(2, 300, 2)).astype(np.float32)
    for t_s in (0.1, 1.0, 2.15):
        np.testing.assert_array_equal(p_fading.apply_rlf(_t(x), t_s).numpy(),
                                      np.asarray(j_fading.apply_rlf(jnp.asarray(x), t_s)))
    assert p_fading.apply_rlf(_t(x), 0.1).abs().sum() == 0
    np.testing.assert_allclose(p_fading.apply_cfo(_t(x), 1000.0, 1.92e6).numpy(),
                               np.asarray(j_fading.apply_cfo(jnp.asarray(x), 1000.0, 1.92e6)),
                               rtol=F32_REL, atol=1e-6)
    y = p_fading.apply_cfo_dyn(_t(x), torch.tensor(-750.0), 1.92e6)
    np.testing.assert_allclose(y.numpy(), np.asarray(j_fading.apply_cfo_dyn(
        jnp.asarray(x), jnp.float32(-750.0), 1.92e6)), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(p_cplx.abs2(y).numpy(), p_cplx.abs2(_t(x)).numpy(), rtol=1e-4)
    for dl in (0, 7, 299):
        np.testing.assert_array_equal(p_fading.apply_delay(_t(x), dl).numpy(),
                                      np.asarray(j_fading.apply_delay(jnp.asarray(x), dl)))
        np.testing.assert_array_equal(p_fading.apply_delay_dyn(_t(x), torch.tensor(dl)).numpy(),
                                      np.asarray(j_fading.apply_delay_dyn(jnp.asarray(x), dl)))
    t = np.linspace(0, 10, 41)
    np.testing.assert_array_equal(p_fading.hst_doppler_hz(t), j_fading.hst_doppler_hz(t))
    np.testing.assert_array_equal(p_fading.dynamic_delay_samples(t, 3.0, 40.0, 2.5),
                                  j_fading.dynamic_delay_samples(t, 3.0, 40.0, 2.5))


# ---------------- resampling and AGC ----------------

def test_resample_arb_tone():
    """Resampling a complex tone preserves its frequency."""
    fs_in, fs_out, f0 = 1.92e6, 3.84e6, 100e3
    x = np.exp(2j * np.pi * f0 * np.arange(1920) / fs_in).astype(np.complex64)
    xc = p_cplx.from_numpy(x[None])
    y = p_resample.resample_arb(xc, fs_out / fs_in)
    ref = j_resample.resample_arb(jnp.asarray(xc.numpy()), fs_out / fs_in)
    assert y.shape == ref.shape and _rel_rms(y, ref) < SUM_REL
    yc = p_cplx.to_numpy(y)[0]
    n = len(yc)
    spec = np.abs(np.fft.fft(yc[100:-100] * np.hanning(n - 200)))
    assert abs(np.argmax(spec) / (n - 200) * fs_out - f0) < 3e3
    # a ratio below 1 and an explicit n_out
    y2 = p_resample.resample_arb(xc, 0.75, n_out=1400)
    assert _rel_rms(y2, j_resample.resample_arb(jnp.asarray(xc.numpy()), 0.75, n_out=1400)) < SUM_REL


def test_interp_and_decim():
    x = p_cplx.from_numpy(np.arange(10, dtype=np.complex64)[None])
    up = p_resample.interp_linear(x, 2)
    np.testing.assert_allclose(up.numpy(), np.asarray(j_resample.interp_linear(
        jnp.asarray(x.numpy()), 2)), rtol=F32_REL)
    assert abs(float(up[0, 1, 0]) - 0.5) < 1e-6
    down = p_resample.decimate(up, 2)
    np.testing.assert_allclose(down.numpy(), np.asarray(j_resample.decimate(
        jnp.asarray(up.numpy()), 2)), rtol=F32_REL)
    np.testing.assert_allclose(down[0, :-1, 0].numpy(), np.arange(9) + 0.25, atol=1e-5)


def test_agc_converges():
    rng = np.random.default_rng(0)
    x = (0.01 * (rng.normal(size=512) + 1j * rng.normal(size=512))).astype(np.complex64)
    xc = p_cplx.from_numpy(x[None])
    agc, jagc = p_resample.Agc(target=1.0), j_resample.Agc(target=1.0)
    for _ in range(20):
        y, jy = agc.process(xc), jagc.process(jnp.asarray(xc.numpy()))
        assert abs(agc.gain - jagc.gain) <= SUM_REL * jagc.gain
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=SUM_REL)
    assert 0.5 < float(p_cplx.abs2(y).mean()) < 2.0


# ---------------- PDSCH over fading ----------------

@pytest.fixture
def port_llrs(monkeypatch):
    """The LLRs of every port `sch.decode_tb` call in the test."""
    seen, decode_tb = [], p_sch.decode_tb

    def spy(llrs, *args, **kw):
        seen.append(llrs.numpy())
        return decode_tb(llrs, *args, **kw)

    monkeypatch.setattr(p_sch, "decode_tb", spy)
    return seen


def _jax_decode_llrs(fn, *args):
    """The LLRs of each `sch.decode_tb` call of fn(*args), under jax.jit,
    stopping before the JAX turbo decoder (no JAX decoder compiles here)."""
    def run(*a):
        taps = []

        def tap(llrs, cfg, *_, **__):
            taps.append(llrs)
            return jnp.zeros((llrs.shape[0], cfg.tbs), jnp.int8), jnp.ones(llrs.shape[0], bool), [], 0

        with pytest.MonkeyPatch.context() as m:
            m.setattr(j_sch, "decode_tb", tap)
            fn(*a)
        return taps

    return [np.asarray(x) for x in jax.jit(run)(*args)]


def _link_cfgs(qm, code_rate, **cell):
    kw = dict(qm=qm, code_rate=code_rate, sf_idx=1)
    return (p_link.LinkConfig(cell=p_grid.CellConfig(**cell), **kw),
            j_link.LinkConfig(cell=j_grid.CellConfig(**cell), **kw))


def _faded(cfg, tb, profile, snr_db, seed):
    """The port's TX through the port's fading (its own draw) and numpy
    noise: numpy samples for both receivers."""
    tx = p_link.tx_subframe(_t(tb), cfg)
    srate = p_ofdm.params(cfg.cell.n_prb)["sf_len"] * 1000.0
    faded, _ = p_fading.apply_fading(tx, torch.Generator().manual_seed(seed), profile, srate,
                                     doppler_hz=5.0)
    return _noise(np.random.default_rng(seed + 1), faded.numpy(), snr_db)


def test_pdsch_over_epa_fading(port_llrs):
    """test_fading.py: QPSK rate 0.3 over EPA at 20 dB through
    pdsch_link.rx_subframe (ZF): at least 3 of 4 rows pass, and the passing
    rows are bit-exact; the LLRs equal the JAX package's."""
    pcfg, jcfg = _link_cfgs(2, 0.3, n_prb=25, cell_id=9, cfi=1)
    tb = np.random.default_rng(0).integers(0, 2, (4, pcfg.tbs), dtype=np.int8)
    rx = _faded(pcfg, tb, "epa", 20.0, seed=2)
    out, ok, _, _ = p_link.rx_subframe(_t(rx), pcfg)
    ok = ok.numpy()
    assert ok.mean() >= 0.75 and (out.numpy()[ok] == tb[ok]).all()
    ref = _jax_decode_llrs(lambda r: j_link.rx_subframe(r, jcfg), jnp.asarray(rx))
    assert len(ref) == len(port_llrs) == 1 and _rel_rms(port_llrs[0], ref[0]) < DFT_REL


@pytest.mark.parametrize("profile", ["epa", "eva"])
def test_pdsch_over_epa_and_eva(profile, port_llrs):
    """test_fading_link.py's _link: QPSK rate 0.35, 5 Hz Doppler, 18 dB,
    the MMSE equalizer: every row decodes bit-exact; the LLRs equal the
    JAX package's MMSE LLRs on the same grid."""
    pcfg, jcfg = _link_cfgs(2, 0.35, n_prb=25, cell_id=2, cfi=1)
    tb = np.random.default_rng(3).integers(0, 2, (4, pcfg.tbs), dtype=np.int8)
    g = p_ofdm.demodulate(_t(_faded(pcfg, tb, profile, 18.0, seed=3)), 25)
    out, ok, _, _ = p_pdsch.decode(g, pcfg.sch_cfg, pcfg.cell, 1, pcfg.rnti, pcfg.prb_mask,
                                   equalizer="mmse")
    assert ok.all() and (out.numpy() == tb).all(), profile
    ref = _jax_decode_llrs(lambda r: j_pdsch.decode(r, jcfg.sch_cfg, jcfg.cell, 1, jcfg.rnti,
                                                    jcfg.prb_mask, equalizer="mmse"),
                           jnp.asarray(g.numpy()))
    assert len(ref) == len(port_llrs) == 1 and _rel_rms(port_llrs[0], ref[0]) < SUM_REL


def test_tx_evm_bound():
    """Clean channel: the equalized 64QAM constellation's EVM stays under
    -30 dB; the channel estimate equals the JAX package's on the same grid."""
    pcfg, jcfg = _link_cfgs(6, 0.5, n_prb=25, cell_id=2, cfi=1)
    tb = np.random.default_rng(0).integers(0, 2, (2, pcfg.tbs), dtype=np.int8)
    g = p_ofdm.demodulate(p_link.tx_subframe(_t(tb), pcfg), 25)
    ch = p_chest.estimate(g, pcfg.cell, 1)
    jce = jax.jit(lambda x: j_chest.estimate(x, jcfg.cell, 1).ce)(jnp.asarray(g.numpy()))
    assert _rel_rms(ch.ce, jce) < F32_REL
    re_idx = p_grid.pdsch_re_indices(pcfg.cell, 1, pcfg.prb_mask)
    y = p_cplx.to_numpy(g.reshape(2, -1, 2)[:, re_idx])
    h = p_cplx.to_numpy(ch.ce.reshape(2, -1, 2)[:, re_idx])
    cw = p_sch.encode_tb(_t(tb), pcfg.sch_cfg)
    scr = p_scr.scramble_bits(cw, p_scr.pdsch_cinit(pcfg.rnti, 0, 1, 2))
    ref = p_cplx.to_numpy(p_modem.modulate(scr, p_modem.MOD_FROM_QM[6]))
    evm = np.sqrt(np.mean(np.abs(y / (h + 1e-12) - ref) ** 2) / np.mean(np.abs(ref) ** 2))
    assert 20 * np.log10(evm) < -30.0
