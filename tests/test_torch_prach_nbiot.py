"""PyTorch port vs the JAX package: PRACH (preamble tables, restricted set
type A, detection, the waveform of formats 0-4), the NB-IoT sync signals
(NPSS/NSSS) and the NB-IoT channels (NRS, NPBCH, NPDSCH).

The cases are the JAX package's tests/test_prach.py and test_nbiot.py.  The
port's `prach_tables.npz` and `nsss_tables.npz` are held byte-equal to the
reference's.  Tables, shift lists, detections, the timing offsets of
detected preambles, ids, frame phases, bits and CRC flags are held
exactly; preamble spectra, waveforms (float32 products in another order)
and detection metrics to a relative 1e-4; NB-IoT grids built from the same bits to float32 rounding (rtol
1e-5).  Both packages get the same numpy inputs (numpy noise).  The JAX
NB-IoT decoders run under jax.jit up to their Viterbi call, which hands
back its input, so no JAX Viterbi compiles here: their Viterbi inputs are
held to the port's (relative RMS 1e-5), and the port decodes the bits.
"""

import filecmp
import inspect
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srslte_emane_tpu.ops.fec import viterbi as j_viterbi
from srslte_emane_tpu.phch import nbiot as j_nbiot
from srslte_emane_tpu.phch import prach as j_prach
from srslte_emane_tpu.phch import sync_nbiot as j_sync_nbiot
from srslte_emane_tpu_torch.ops import cplx as p_cplx
from srslte_emane_tpu_torch.ops.fec import viterbi as p_viterbi
from srslte_emane_tpu_torch.phch import nbiot as p_nbiot
from srslte_emane_tpu_torch.phch import prach as p_prach
from srslte_emane_tpu_torch.phch import sync_nbiot as p_sync_nbiot

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

REL = 1e-4  # float32 products and sums in another order
RTOL, ATOL = 1e-5, 1e-6  # grids from the same bits

j_detect = jax.jit(j_prach.detect, static_argnames=("root_seq_idx", "zczc", "threshold", "hs", "fmt"))


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _rel_rms(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def _cf(x):
    return np.stack([x.real, x.imag], -1).astype(np.float32)


def _detect_both(rx, **kw):
    """(det, metric, t_offset) of the port, held to the JAX package's: the
    timing offsets where a preamble is detected (elsewhere they are the
    argmax of noise)."""
    got = [v.numpy() for v in p_prach.detect(_t(rx), **kw)]
    ref = [np.asarray(v) for v in j_detect(jnp.asarray(rx), **kw)]
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=REL, atol=REL)
    np.testing.assert_array_equal(got[2][got[0]], ref[2][ref[0]])
    return got


# ---------------- PRACH tables ----------------

def test_prach_tables_byte_equal():
    for name in ("prach_tables.npz",):
        assert filecmp.cmp(pathlib.Path(inspect.getfile(p_prach)).parent / name,
                           pathlib.Path(inspect.getfile(j_prach)).parent / name, shallow=False)
    np.testing.assert_array_equal(p_prach.ZC_ROOTS, j_prach.ZC_ROOTS)
    np.testing.assert_array_equal(p_prach.ZC_ROOTS_F4, j_prach.ZC_ROOTS_F4)
    for name in ("NCS_UNRESTRICTED", "NCS_RESTRICTED", "NCS_F4", "FORMAT_CP", "FORMAT_REPS"):
        assert getattr(p_prach, name) == getattr(j_prach, name)


@pytest.mark.parametrize("hs,fmt", [(False, 0), (True, 0), (False, 4)])
def test_shift_lists_and_preambles_equal(hs, fmt):
    for root in (0, 6, 22, 137, 837) if fmt != 4 else (0, 1, 137):
        for zczc in range(len(p_prach.NCS_F4) if fmt == 4 else 15):
            if not hs and fmt != 4 and zczc == 0:
                continue  # N_cs 0: one shift per root, 64 roots
            assert p_prach.shift_list(root, zczc, hs, fmt) == j_prach.shift_list(root, zczc, hs, fmt)
        tbl = p_prach.preamble_freq_table(root, 2, hs, fmt)
        np.testing.assert_allclose(tbl, j_prach.preamble_freq_table(root, 2, hs, fmt), rtol=1e-6)
    tbl = p_prach.preamble_freq_table(0, 1)
    np.testing.assert_allclose(np.abs(tbl[0]) ** 2, p_prach.N_ZC, rtol=1e-3)
    assert not np.allclose(tbl[0], tbl[1])


def test_restricted_set_avoids_doppler_images():
    """Restricted set type A: for each (u, cv) the windows at cv, cv+du and
    cv-du never collide across the preambles of one root."""
    pairs, n_cs = p_prach.shift_list(22, 3, hs=True)
    assert len(pairs) == 64 and n_cs == p_prach.NCS_RESTRICTED[3]
    by_root = {}
    for u, cv in pairs:
        by_root.setdefault(u, []).append(cv)
    for u, cvs in by_root.items():
        du = p_prach._d_u(u)
        assert du == j_prach._d_u(u)
        occupied = set()
        for cv in cvs:
            for img in (cv, (cv + du) % p_prach.N_ZC, (cv - du) % p_prach.N_ZC):
                assert not ({(img + k) % p_prach.N_ZC for k in range(n_cs)} & occupied)
            occupied |= {(cv + k) % p_prach.N_ZC for k in range(n_cs)}


# ---------------- PRACH detection ----------------

def test_detect_clean():
    idx = np.array([0, 5, 17, 63])
    p = p_prach.gen(idx, 0, 1, device="cpu")
    np.testing.assert_allclose(p.numpy(), np.asarray(j_prach.gen(idx, 0, 1)), rtol=1e-6, atol=1e-3)
    det, _, toff = _detect_both(p.numpy(), root_seq_idx=0, zczc=1)
    assert det[np.arange(4), idx].all() and (toff[np.arange(4), idx] == 0).all()
    det[np.arange(4), idx] = False
    assert not det.any()


def test_detect_noisy_with_delay():
    rng = np.random.default_rng(1)
    idx = np.array([3, 40])
    d = 5
    pc = p_cplx.to_numpy(p_prach.gen(idx, 6, 2, device="cpu"))
    pc = pc * np.exp(-1j * 2 * np.pi * np.arange(p_prach.N_ZC) * d / p_prach.N_ZC)
    pc = pc + rng.normal(0, 0.7, pc.shape) + 1j * rng.normal(0, 0.7, pc.shape)
    det, _, toff = _detect_both(_cf(pc), root_seq_idx=6, zczc=2, threshold=8.0)
    assert det[np.arange(2), idx].all() and (toff[np.arange(2), idx] == d).all()
    det[np.arange(2), idx] = False
    assert not det.any()


def test_prach_restricted_set_high_speed():
    idx = np.array([0, 17, 40, 63])
    tx = p_cplx.to_numpy(p_prach.gen(idx, root_seq_idx=22, zczc=3, hs=True, device="cpu"))
    rng = np.random.default_rng(0)
    p = np.mean(np.abs(tx) ** 2)
    rx = tx + np.sqrt(p / 10 / 2) * (rng.normal(size=tx.shape) + 1j * rng.normal(size=tx.shape))
    det, _, _ = _detect_both(_cf(rx), root_seq_idx=22, zczc=3, hs=True)
    assert det[np.arange(4), idx].all()


def test_prach_format4_sequence_level():
    pairs, n_cs = p_prach.shift_list(1, 2, fmt=4)
    assert len(pairs) == 64 and n_cs == p_prach.NCS_F4[2]
    x = p_prach.gen(np.arange(64), root_seq_idx=1, zczc=2, fmt=4, device="cpu")
    assert x.shape == (64, 139, 2)
    det, _, _ = _detect_both(x.numpy(), root_seq_idx=1, zczc=2, fmt=4)
    assert det[np.arange(64), np.arange(64)].all()


# ---------------- PRACH waveform ----------------

def test_prach_waveform_two_stage_dft_roundtrip():
    idx = np.array([3, 21, 40])
    t = p_prach.gen_waveform(idx, root_seq_idx=0, zczc=1, device="cpu")
    assert t.shape == (3, p_prach.N_CP_F0 + p_prach.N_SEQ, 2)
    assert _rel_rms(t, j_prach.gen_waveform(idx, root_seq_idx=0, zczc=1)) < REL
    tt = t.numpy()
    np.testing.assert_allclose(tt[:, :p_prach.N_CP_F0], tt[:, p_prach.N_SEQ:], atol=1e-4)
    rx = tt + np.random.default_rng(0).normal(0, 0.002, tt.shape).astype(np.float32)
    freq = p_prach.rx_waveform_to_freq(_t(rx))
    assert _rel_rms(freq, j_prach.rx_waveform_to_freq(jnp.asarray(rx))) < REL
    ref = p_prach.gen(idx, 0, 1, device="cpu").numpy()
    got = freq.numpy()
    np.testing.assert_allclose(got / (np.abs(got).mean() / np.abs(ref).mean()), ref, atol=0.05)
    det, _, _ = _detect_both(got, root_seq_idx=0, zczc=1)
    assert det[np.arange(3), idx].all()


@pytest.mark.parametrize("fmt,srate_div", [(0, 1), (1, 1), (2, 1), (3, 1), (4, 1), (0, 16), (4, 2)])
def test_prach_waveform_all_formats(fmt, srate_div):
    """Each format's CP and repetitions; a true cyclic prefix; detection of
    a delayed, noisy arrival with its timing offset; at 30.72 Msps and at
    a reduced cell rate (srate_div)."""
    rng = np.random.default_rng(1)
    idx = np.array([5, 17])
    t = p_prach.gen_waveform(idx, root_seq_idx=2, zczc=1, fmt=fmt, srate_div=srate_div,
                             device="cpu").numpy()
    jt = np.asarray(j_prach.gen_waveform(idx, root_seq_idx=2, zczc=1, fmt=fmt, srate_div=srate_div))
    assert t.shape == jt.shape == (2, p_prach.waveform_len(fmt, srate_div), 2)
    assert _rel_rms(t, jt) < REL
    n_seq = (p_prach.N_SEQ_F4 if fmt == 4 else p_prach.N_SEQ) // srate_div
    n_cp, reps = p_prach.FORMAT_CP[fmt] // srate_div, p_prach.FORMAT_REPS[fmt]
    np.testing.assert_allclose(t[:, :n_cp], t[:, n_cp + reps * n_seq - n_cp:], atol=1e-4)
    if reps == 2:
        np.testing.assert_allclose(t[:, n_cp:n_cp + n_seq], t[:, n_cp + n_seq:], atol=1e-4)
    delay = 64 // srate_div
    rx = np.zeros_like(t)
    rx[:, delay:] = t[:, :t.shape[1] - delay]
    rx = rx + rng.normal(0, 0.02, rx.shape).astype(np.float32)
    freq = p_prach.rx_waveform_to_freq(_t(rx), fmt=fmt, srate_div=srate_div)
    jfreq = j_prach.rx_waveform_to_freq(jnp.asarray(rx), fmt=fmt, srate_div=srate_div)
    assert _rel_rms(freq, jfreq) < REL
    det, _, toff = _detect_both(freq.numpy(), root_seq_idx=2, zczc=1, fmt=fmt)
    assert det[np.arange(2), idx].all()
    samp_per_zc = n_seq / p_prach.nzc_for(fmt)
    assert np.all(np.abs(toff[np.arange(2), idx] * samp_per_zc - delay) < 2.5 * samp_per_zc)



@pytest.mark.parametrize("fn", ["gen", "gen_waveform"])
def test_prach_default_device_is_the_card(fn):
    """Numpy preamble indices go to the card by default; where there is none
    the call raises instead of running on the CPU."""
    if torch.cuda.is_available():
        assert getattr(p_prach, fn)(np.array([3, 9])).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(p_prach, fn)(np.array([3, 9]))

# ---------------- NB-IoT sync ----------------

def test_nsss_tables_byte_equal_and_sequences_equal():
    name = "nsss_tables.npz"
    assert filecmp.cmp(pathlib.Path(inspect.getfile(p_sync_nbiot)).parent / name,
                       pathlib.Path(inspect.getfile(j_sync_nbiot)).parent / name, shallow=False)
    np.testing.assert_array_equal(p_sync_nbiot.npss_grid(), j_sync_nbiot.npss_grid())
    np.testing.assert_array_equal(p_sync_nbiot._nsss_bank(), j_sync_nbiot._nsss_bank())


def test_npss_detect():
    rng = np.random.default_rng(0)
    g = np.zeros((2, 14, 12), dtype=np.complex64)
    for i, l in enumerate(p_sync_nbiot.NPSS_SYMS):
        g[0, l, :11] = p_sync_nbiot.npss_grid()[i]
    g += (0.05 * (rng.normal(size=g.shape) + 1j * rng.normal(size=g.shape))).astype(np.complex64)
    m = p_sync_nbiot.npss_detect(p_cplx.from_numpy(g)).numpy()
    np.testing.assert_allclose(m, np.asarray(j_sync_nbiot.npss_detect(jnp.asarray(_cf(g)))),
                               rtol=REL)
    assert m[0] > 0.9 and m[1] < 0.3


def test_nsss_detect_all_ids_sampled():
    rng = np.random.default_rng(1)
    cases = [(nid, fp) for nid in (0, 17, 257, 503) for fp in (0, 3)]
    noisy = np.stack([p_sync_nbiot.nsss_sequence(nid, 2 * fp)
                      + 0.2 * (rng.normal(size=132) + 1j * rng.normal(size=132))
                      for nid, fp in cases])
    got = [v.numpy() for v in p_sync_nbiot.nsss_detect(_t(_cf(noisy)))]
    ref = [np.asarray(v) for v in jax.jit(j_sync_nbiot.nsss_detect)(_cf(noisy))]
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=REL)
    assert list(zip(got[0], got[1])) == cases


# ---------------- NB-IoT channels ----------------

@pytest.fixture
def port_viterbi_in(monkeypatch):
    """The input of every port Viterbi call in the test."""
    seen, decode = [], p_viterbi.viterbi_decode

    def spy(llrs, *args, **kw):
        seen.append(llrs.numpy())
        return decode(llrs, *args, **kw)

    monkeypatch.setattr(p_viterbi, "viterbi_decode", spy)
    return seen


def _jax_viterbi_in(fn, *args):
    """The Viterbi input of fn(*args) (one call), under jax.jit, stopping
    before the JAX Viterbi."""
    def run(*a):
        taps = []

        def tap(llrs, *_, **__):
            taps.append(llrs)
            return jnp.zeros(llrs.shape[:1] + llrs.shape[2:], jnp.int8)

        with pytest.MonkeyPatch.context() as m:
            m.setattr(j_viterbi, "viterbi_decode", tap)
            fn(*a)
        return taps

    (x,) = jax.jit(run)(*args)
    return np.asarray(x)


def _awgn_np(x, snr_db, seed):
    """x (numpy) plus complex white noise at snr_db against its mean power
    (per row)."""
    rng = np.random.default_rng(seed)
    p = np.mean(np.sum(x ** 2, -1).reshape(x.shape[0], -1), axis=-1)
    s = np.sqrt(p / 10 ** (snr_db / 10) / 2).reshape((-1,) + (1,) * (x.ndim - 1))
    return (x + rng.normal(size=x.shape) * s).astype(np.float32)


def test_nrs_tables_equal():
    for nid in (0, 5, 17, 503):
        np.testing.assert_array_equal(p_nbiot.nrs_k(nid), j_nbiot.nrs_k(nid))
        for sf in (0, 4, 9):
            np.testing.assert_array_equal(p_nbiot.nrs_values(nid, sf), j_nbiot.nrs_values(nid, sf))
            for l_start in (0, 3):
                np.testing.assert_array_equal(p_nbiot._re_indices(nid, sf, l_start),
                                              j_nbiot._re_indices(nid, sf, l_start))


def test_npbch_mib_nb_roundtrip(port_viterbi_in):
    mib = np.random.default_rng(0).integers(0, 2, (2, p_nbiot.MIB_NB_BITS), dtype=np.int8)
    blocks = p_nbiot.npbch_encode(_t(mib), n_id_ncell=17)
    assert blocks.shape[1:] == (8, 14, 12, 2)
    ref = jax.jit(j_nbiot.npbch_encode, static_argnums=(1,))(mib, 17)
    np.testing.assert_allclose(blocks.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    rx = _awgn_np(blocks.numpy(), 6.0, seed=1)
    out, ok = p_nbiot.npbch_decode(_t(rx), 17)
    assert ok.all() and (out.numpy() == mib).all()
    jin = _jax_viterbi_in(lambda x: j_nbiot.npbch_decode(x, 17), jnp.asarray(rx))
    assert len(port_viterbi_in) == 1 and _rel_rms(port_viterbi_in[0], jin) < RTOL


def test_npdsch_roundtrip(port_viterbi_in):
    tbs = 208
    tb = np.random.default_rng(1).integers(0, 2, (3, tbs), dtype=np.int8)
    sfs = p_nbiot.npdsch_encode(_t(tb), n_sf=4, n_id_ncell=5, rnti=0x51)
    assert sfs.shape[1:] == (4, 14, 12, 2)
    ref = jax.jit(j_nbiot.npdsch_encode, static_argnums=(1, 2, 3))(tb, 4, 5, 0x51)
    np.testing.assert_allclose(sfs.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    rx = _awgn_np(sfs.numpy(), 12.0, seed=2)
    out, ok = p_nbiot.npdsch_decode(_t(rx), tbs, 5, 0x51)
    assert ok.all() and (out.numpy() == tb).all()
    jin = _jax_viterbi_in(lambda x: j_nbiot.npdsch_decode(x, tbs, 5, 0x51), jnp.asarray(rx))
    assert len(port_viterbi_in) == 1 and _rel_rms(port_viterbi_in[0], jin) < RTOL


def test_npdsch_fails_with_wrong_cell():
    tb = np.random.default_rng(2).integers(0, 2, (1, 104), dtype=np.int8)
    rx = _awgn_np(p_nbiot.npdsch_encode(_t(tb), n_sf=2, n_id_ncell=5, rnti=0x51).numpy(), 8.0, 3)
    _, ok = p_nbiot.npdsch_decode(_t(rx), 104, 6, 0x51)  # wrong n_id_ncell
    assert not ok.any()
