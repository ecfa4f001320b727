"""PyTorch port vs the JAX package: sync and cell search (PSS/SSS, CP
detection), the UE sync state machine, neighbour measurement, extended CP
and the reduced-rate FFT sizes of the OFDM layer, and the beacon scan
without a mesh.

The cases are the JAX package's tests/test_sync.py, test_extended_cp.py,
test_ue_sync.py, test_measure.py and test_netscan.py (the unsharded ones).
Both packages get the same numpy inputs: captures built by the port's
transmitter plus numpy noise.  Ids, positions, subframe indices, CP flags,
states, bits and CRC flags must be equal.  Values after a DFT (SSS metrics,
OFDM samples and grids, LLRs) are held to a relative RMS of 1e-2: the
reference rounds DFT inputs to bf16, the port transforms in float32.
Values with no DFT in between (PSS energies, RSRP/RSRQ, beacon grids) are
held to float32 rounding (relative 1e-4), the beacon grids exactly.  The
JAX side runs under jax.jit, each function compiled once per shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srslte_emane_tpu.models import measure as j_measure
from srslte_emane_tpu.models import netscan as j_netscan
from srslte_emane_tpu.models import ue_sync as j_ue_sync
from srslte_emane_tpu.ops import ofdm as j_ofdm
from srslte_emane_tpu.phch import chest as j_chest
from srslte_emane_tpu.phch import grid as j_grid
from srslte_emane_tpu.phch import pbch as j_pbch
from srslte_emane_tpu.phch import pdsch as j_pdsch
from srslte_emane_tpu.phch import sch as j_sch
from srslte_emane_tpu.phch import sync as j_sync
from srslte_emane_tpu_torch.models import measure as p_measure
from srslte_emane_tpu_torch.models import netscan as p_netscan
from srslte_emane_tpu_torch.models import ue_sync as p_ue_sync
from srslte_emane_tpu_torch.ops import cplx as p_cplx
from srslte_emane_tpu_torch.ops import ofdm as p_ofdm
from srslte_emane_tpu_torch.phch import grid as p_grid
from srslte_emane_tpu_torch.phch import pbch as p_pbch
from srslte_emane_tpu_torch.phch import pdsch as p_pdsch
from srslte_emane_tpu_torch.phch import sch as p_sch
from srslte_emane_tpu_torch.phch import sync as p_sync

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

DFT_REL = 1e-2  # relative RMS after a DFT (the reference's bf16 inputs)
F32_REL = 1e-4  # no DFT in between: float32 rounding only
SEARCH_T = 2100  # every cell-search capture: 3 rows of this length

j_cell_search = jax.jit(j_sync.cell_search, static_argnames=("fft_size", "detect_cp"))
j_pss_correlate = jax.jit(j_sync.pss_correlate, static_argnames=("fft_size",))
j_pbch_decode = jax.jit(j_pbch.decode, static_argnums=(2,))
j_estimate = jax.jit(j_chest.estimate, static_argnums=(1, 2), static_argnames=("port",))
j_demodulate = jax.jit(j_ofdm.demodulate, static_argnums=(1,), static_argnames=("cp",))


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _rel_rms(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def _noise(rng, shape, snr_db, power):
    """Complex white noise as float32 (..., 2) at snr_db against `power`."""
    sigma = np.sqrt(power / 10 ** (snr_db / 10) / 2)
    return rng.normal(0, sigma, shape + (2,)).astype(np.float32)


def _beacon(cell, sf_idx, with_crs=True):
    """(T, 2) numpy: one subframe of PSS/SSS (+ CRS), the port's TX."""
    g = p_sync.put_pss_sss(p_cplx.zeros((1, cell.n_sym, cell.nre)), cell, sf_idx)
    if with_crs:
        g = p_pdsch.put_crs(g, cell, sf_idx)
    return p_ofdm.modulate(g, cell.n_prb, cp=cell.cp)[0].numpy()


def _capture(cell, sf_idx, snr_db, delay, seed, T=SEARCH_T):
    """test_sync.py's _make_sf: the beacon + noise, delayed, cut/padded to T."""
    x = _beacon(cell, sf_idx)
    x = x + _noise(np.random.default_rng(seed), x.shape[:1], snr_db, np.mean(x ** 2) * 2)
    x = np.concatenate([np.zeros((delay, 2), np.float32), x])[:T]
    return np.pad(x, ((0, T - len(x)), (0, 0)))


def _search_both(batch):
    """(port result, JAX result) of cell_search(detect_cp=True) on the same
    numpy batch; ids, positions, subframes and CP flags equal, qualities to
    float32 rounding."""
    pr = {k: v.numpy() for k, v in p_sync.cell_search(_t(batch), detect_cp=True).items()}
    jr = {k: np.asarray(v) for k, v in j_cell_search(jnp.asarray(batch), detect_cp=True).items()}
    assert set(pr) == set(jr)
    for k in ("n_id_2", "pss_pos", "n_id_1", "sf_idx", "cell_id", "cp_ext"):
        np.testing.assert_array_equal(pr[k], jr[k], err_msg=k)
    np.testing.assert_allclose(pr["quality"], jr["quality"], rtol=F32_REL)
    return pr


# ---------------- sync: sequences, correlation, cell search ----------------

def test_sss_bank_and_replicas_equal():
    for h in range(3):
        np.testing.assert_array_equal(p_sync._sss_bank(h), j_sync._sss_bank(h))
        np.testing.assert_array_equal(p_sync.pss_time(h), j_sync.pss_time(h))
    assert len({tuple(p_sync.sss_sequence(n1, 0, 0)) for n1 in range(168)}) == 168
    for cp in ("normal", "ext"):
        for n_prb in (6, 25, 100):
            assert p_sync.pss_symbol_start(n_prb, cp) == j_sync.pss_symbol_start(n_prb, cp)


def test_pss_correlate_matches():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 400, 2)).astype(np.float32)
    pe, pc = p_sync.pss_correlate(_t(x))
    je, jc = j_pss_correlate(jnp.asarray(x))
    assert pe.shape == je.shape == (2, 3, 400 - 127) and pc.shape == jc.shape
    np.testing.assert_allclose(pe.numpy(), np.asarray(je), rtol=F32_REL, atol=1e-6)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=F32_REL, atol=1e-5)


@pytest.mark.parametrize("cell_id,sf_idx,delay", [(0, 0, 0), (301, 0, 37), (17, 5, 100)])
def test_cell_search(cell_id, sf_idx, delay):
    cell = p_grid.CellConfig(n_prb=6, cell_id=cell_id)
    batch = np.stack([_capture(cell, sf_idx, 10.0, delay, cell_id + s) for s in range(3)])
    res = _search_both(batch)
    assert (res["cell_id"] == cell_id).all() and (res["sf_idx"] == sf_idx).all()
    assert (np.abs(res["pss_pos"] - (p_sync.pss_symbol_start(6) + delay)) <= 1).all()
    assert not res["cp_ext"].any()


def test_cell_search_batched_cells():
    """Different delays of one cell in one batch, at 5 dB."""
    cell = p_grid.CellConfig(n_prb=6, cell_id=42)
    batch = np.stack([_capture(cell, 0, 5.0, d, i) for i, d in enumerate((0, 50, 150))])
    assert (_search_both(batch)["cell_id"] == 42).all()


def test_cp_blind_cell_search():
    """detect_cp=True: a normal-CP and an extended-CP cell (and a third,
    normal-CP cell) identified blind, each with its CP and PSS position."""
    rng = np.random.default_rng(3)
    rows, want = [], []
    for cp, cid in (("normal", 53), ("ext", 53), ("normal", 200)):
        x = _beacon(p_grid.CellConfig(n_prb=6, cell_id=cid, cp=cp), 0, with_crs=False)
        x = x + rng.normal(0, 0.01, x.shape).astype(np.float32)
        rows.append(np.pad(x, ((0, SEARCH_T - len(x)), (0, 0))))
        want.append((cid, cp == "ext", p_sync.pss_symbol_start(6, cp)))
    res = _search_both(np.stack(rows))
    assert list(zip(res["cell_id"], res["cp_ext"], res["pss_pos"])) == want
    assert (res["sf_idx"] == 0).all()


def test_sss_find_matches():
    rng = np.random.default_rng(4)
    s = j_sync.sss_sequence(77, 1, 5).astype(np.complex64) * np.exp(1j * 0.7)
    y = s[None] + 0.3 * (rng.normal(size=(3, 62)) + 1j * rng.normal(size=(3, 62)))
    yc = np.stack([y.real, y.imag], -1).astype(np.float32)
    got = [v.numpy() for v in p_sync.sss_find(_t(yc), 1)]
    ref = [np.asarray(v) for v in jax.jit(j_sync.sss_find, static_argnums=(1,))(yc, 1)]
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=F32_REL)
    assert (got[0] == 77).all() and (got[1] == 5).all()


# ---------------- OFDM: extended CP and reduced-rate FFT sizes ----------------

def test_ext_cp_layout_and_tables_equal():
    for n_prb in (6, 15, 25, 50, 75, 100):
        for cp in ("normal", "ext"):
            assert p_ofdm.params(n_prb, cp=cp) == j_ofdm.params(n_prb, cp=cp)
            assert p_ofdm._symbol_starts(n_prb, cp) == j_ofdm._symbol_starts(n_prb, cp)
    p = p_ofdm.params(25, cp="ext")
    assert p["n_sym"] == 12 and p["cp0"] == p["cp"] == 512 * p["n"] // 2048
    assert p["sf_len"] == p_ofdm.params(25)["sf_len"]
    assert p_grid.pilot_syms(0, "ext") == j_grid.pilot_syms(0, "ext") == (0, 3, 6, 9)
    v_ext = p_grid.crs_values(1, 0, 6, 0, "ext")
    np.testing.assert_array_equal(v_ext, j_grid.crs_values(1, 0, 6, 0, "ext"))
    assert not np.allclose(v_ext, p_grid.crs_values(1, 0, 6, 0, "normal"))


def test_n_fft_tables_equal():
    for n_prb, n_fft in ((25, 384), (50, 768), (75, 1152), (100, 1536), (100, None)):
        assert p_ofdm.params(n_prb, n_fft) == j_ofdm.params(n_prb, n_fft)
        np.testing.assert_array_equal(p_ofdm._bin_map(n_prb, n_fft), j_ofdm._bin_map(n_prb, n_fft))
        assert p_ofdm.mbsfn_layout(n_prb, n_fft) == j_ofdm.mbsfn_layout(n_prb, n_fft)


def test_ext_cp_ofdm_roundtrip():
    rng = np.random.default_rng(0)
    g = rng.normal(size=(2, 12, 300, 2)).astype(np.float32)
    t = p_ofdm.modulate(_t(g), 25, cp="ext")
    jt = jax.jit(j_ofdm.modulate, static_argnums=(1,), static_argnames=("cp",))(
        jnp.asarray(g), 25, cp="ext")
    assert t.shape == jt.shape == (2, 7680, 2)
    assert _rel_rms(t, jt) < DFT_REL
    g2 = p_ofdm.demodulate(t, 25, cp="ext")
    np.testing.assert_allclose(g2.numpy(), g, atol=3e-2)
    assert _rel_rms(g2, j_demodulate(jnp.asarray(t.numpy()), 25, cp="ext")) < DFT_REL


def test_demodulate_mbsfn_reduced_rate():
    """A 100 PRB MBSFN subframe at srsLTE's reduced rate (n_fft 1536)."""
    sf_len = p_ofdm.params(100, 1536)["sf_len"]
    x = np.random.default_rng(5).normal(size=(2, sf_len, 2)).astype(np.float32)
    got = p_ofdm.demodulate_mbsfn(_t(x), 100, 1536)
    ref = jax.jit(j_ofdm.demodulate_mbsfn, static_argnums=(1, 2))(jnp.asarray(x), 100, 1536)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and _rel_rms(a, b) < DFT_REL


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


def test_ext_cp_pdsch_roundtrip_with_channel(port_llrs):
    """test_extended_cp.py's chain: CellConfig(cp="ext"), sf 3, 16QAM,
    encode -> OFDM (ext) -> 20 dB -> OFDM demod (ext) -> decode.  The port
    decodes bit-exact; its LLRs equal the JAX package's on the same grid."""
    kw = dict(n_prb=15, cell_id=2, cp="ext")
    pcell, jcell = p_grid.CellConfig(**kw), j_grid.CellConfig(**kw)
    mask, sf = (1,) * 15, 3
    n_re = p_grid.nof_re(pcell, sf, mask)
    assert n_re == j_grid.nof_re(jcell, sf, mask)
    cfg = p_sch.SchConfig(tbs=(n_re * 4 // 2 - 24) // 8 * 8, G=n_re * 4, Qm=4, Nl=1)
    jcfg = j_sch.SchConfig(tbs=cfg.tbs, G=cfg.G, Qm=4, Nl=1)
    tb = np.random.default_rng(1).integers(0, 2, (2, cfg.tbs), dtype=np.int8)
    g = p_pdsch.encode(_t(tb), cfg, pcell, sf, 0x46, mask)
    assert g.shape[1] == 12
    with pytest.MonkeyPatch.context() as m:  # the JAX grid from the port's codeword
        cw = jnp.asarray(p_sch.encode_tb(_t(tb), cfg).numpy())
        m.setattr(j_sch, "encode_tb", lambda *_: cw)
        jg = jax.jit(lambda: j_pdsch.encode(None, jcfg, jcell, sf, 0x46, mask))()
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
    t = p_ofdm.modulate(g, 15, cp="ext").numpy()
    rx = t + _noise(np.random.default_rng(2), t.shape[:2], 20.0, np.mean(t ** 2) * 2)
    rg = p_ofdm.demodulate(_t(rx), 15, cp="ext")
    out, ok, _, ch = p_pdsch.decode(rg, cfg, pcell, sf, 0x46, mask)
    assert ok.all() and (out.numpy() == tb).all()
    assert float(ch.snr_db.mean()) > 12.0
    ref = _jax_decode_llrs(lambda r: j_pdsch.decode(r, jcfg, jcell, sf, 0x46, mask),
                           jnp.asarray(rg.numpy()))
    assert len(ref) == len(port_llrs) == 1 and _rel_rms(port_llrs[0], ref[0]) < F32_REL


# ---------------- the UE sync state machine ----------------

@pytest.fixture
def jax_ue_sync(monkeypatch):
    """The JAX UeSync with its device calls jitted (same functions)."""
    monkeypatch.setattr(j_sync, "cell_search", j_cell_search)
    monkeypatch.setattr(j_sync, "pss_correlate", j_pss_correlate)
    monkeypatch.setattr(j_pbch, "decode", j_pbch_decode)
    monkeypatch.setattr(j_chest, "estimate", j_estimate)
    monkeypatch.setattr(j_ofdm, "demodulate", j_demodulate)
    return j_ue_sync.UeSync


def _stream(cell, sfn0, n_sf, snr_db, cfo_hz, delay, seed):
    """test_ue_sync.py's _make_stream (port TX, numpy noise): complex64."""
    sfs = []
    for i in range(n_sf):
        sf_idx, sfn = i % 10, sfn0 + i // 10
        g = p_sync.put_pss_sss(p_cplx.zeros((1, 14, cell.nre)), cell, sf_idx)
        g = p_pdsch.put_crs(g, cell, sf_idx)
        if sf_idx == 0:
            g = p_pbch.encode(_t(p_pbch.pack_mib(cell.n_prb, sfn)[None]), cell, sfn, g)
        sfs.append(p_ofdm.modulate(g, cell.n_prb)[0].numpy())
    t = np.concatenate(sfs)
    t = t + _noise(np.random.default_rng(seed), t.shape[:1], snr_db, np.mean(t ** 2) * 2)
    x = t[:, 0] + 1j * t[:, 1]
    if cfo_hz:
        x = x * np.exp(2j * np.pi * cfo_hz * np.arange(len(x)) / (p_ofdm.params(cell.n_prb)["sf_len"] * 1e3))
    return np.concatenate([np.zeros(delay), x]).astype(np.complex64)


def _step_both(port, ref, chunk):
    """One step of each machine on the same chunk; the states must agree."""
    s, r = port.step(chunk), ref.step(chunk)
    for f in ("state", "cell_id", "n_prb", "sample_offset", "sfn", "n_ports", "cp", "sfo_ppm"):
        assert getattr(s, f) == getattr(r, f), (f, vars(s), vars(r))
    assert abs(s.quality - r.quality) <= F32_REL * abs(r.quality)
    assert abs(s.cfo_hz - r.cfo_hz) <= 1e-3 * max(1.0, abs(r.cfo_hz)), (s.cfo_hz, r.cfo_hz)
    return s


def test_ue_sync_acquires_and_camps(jax_ue_sync):
    x = _stream(p_grid.CellConfig(n_prb=6, cell_id=93), 32, 25, 10.0, 150.0, 77, seed=0)
    port, ref = p_ue_sync.UeSync(n_prb=6, device="cpu"), jax_ue_sync(n_prb=6)
    sf_len, state = 1920, None
    for i in range(20):
        chunk = x[i * sf_len : (i + 2) * sf_len]
        if len(chunk) < sf_len:
            break
        state = _step_both(port, ref, chunk if port.s.state == "CELL_SEARCH" else chunk[:sf_len + 200])
        if state.state == "CAMPING":
            break
    assert state is not None and state.state == "CAMPING", vars(port.s)
    assert state.cell_id == 93 and abs(state.cfo_hz - 150.0) < 80.0


def test_sfo_estimate():
    period = 5 * 1920
    for drifts in ([2, 2, 2, 2], [], [1, 2, 0, 1, 1, 2, 0, 1]):
        assert p_ue_sync.sfo_estimate(drifts, period) == j_ue_sync.sfo_estimate(drifts, period)
    assert abs(p_ue_sync.sfo_estimate([2, 2, 2, 2], period) - 2 / period) < 1e-12


def test_sfo_tracked_from_skewed_stream(jax_ue_sync):
    """A receiver clock 104 ppm fast: the PSS lands ~1 sample early each
    5 ms tracking period; both machines report the same signed error."""
    x = _stream(p_grid.CellConfig(n_prb=6, cell_id=93), 32, 40, 20.0, 0.0, 0, seed=1)
    port, ref = p_ue_sync.UeSync(n_prb=6, device="cpu"), jax_ue_sync(n_prb=6)
    sf_len, skew, state = 1920, 0, None
    for i in range(36):
        if port.s.state == "CAMPING" and i % 5 == 0:
            skew += 1
        chunk = x[i * sf_len + skew : (i + 2) * sf_len + skew]
        if len(chunk) < sf_len:
            break
        state = _step_both(port, ref, chunk)
    want_ppm = -1e6 / (5 * sf_len)
    assert state.state == "CAMPING" and 2.0 * want_ppm < state.sfo_ppm < 0.3 * want_ppm


def test_cp_blind_ue_sync_state_machine(jax_ue_sync):
    """UeSync camps on an extended-CP cell without being told the CP."""
    t = _beacon(p_grid.CellConfig(n_prb=6, cell_id=11, cp="ext"), 0, with_crs=False)
    samples = (t[:, 0] + 1j * t[:, 1]).astype(np.complex64)
    s = _step_both(p_ue_sync.UeSync(n_prb=6, device="cpu"), jax_ue_sync(n_prb=6), samples)
    assert (s.cell_id, s.cp, s.state) == (11, "ext", "SFN_SYNC")


def test_ue_sync_default_device_is_the_card():
    if torch.cuda.is_available():
        assert p_ue_sync.UeSync().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            p_ue_sync.UeSync()


# ---------------- neighbour measurement ----------------

def test_measure_two_cells():
    n_prb, sf = 6, 1
    crs = lambda cid: p_pdsch.put_crs(p_cplx.zeros((1, 14, 72)),
                                      p_grid.CellConfig(n_prb=n_prb, cell_id=cid), sf)
    t = p_ofdm.modulate(crs(11) + crs(303) * np.sqrt(0.1), n_prb).numpy()  # B 10 dB weaker
    t = t + _noise(np.random.default_rng(0), t.shape[:2], 20.0, np.mean(t ** 2) * 2)
    rg = p_ofdm.demodulate(_t(t), n_prb).numpy()
    pcis = [11, 303, 42]
    best, meas = p_measure.strongest_cell(_t(rg), n_prb, sf, pcis)
    jbest, jmeas = j_measure.strongest_cell(jnp.asarray(rg), n_prb, sf, pcis)
    assert best == jbest == [11]
    rssi = np.mean(np.sum(rg.astype(np.float64) ** 2, -1))
    for pci in pcis:
        np.testing.assert_allclose(meas[pci][0].numpy(), np.asarray(jmeas[pci][0]), rtol=F32_REL)
        # RSRQ over each row's RSSI (the reference's is per subcarrier)
        np.testing.assert_allclose(meas[pci][1].numpy(),
                                   n_prb * np.asarray(jmeas[pci][0]) / (rssi * n_prb), rtol=F32_REL)
    ratio_db = 10 * np.log10(float(meas[11][0][0]) / float(meas[303][0][0]))
    assert 6 < ratio_db < 14 and float(meas[42][0][0]) < float(meas[303][0][0])


def test_measure_rsrq_per_row():
    """RSRQ is N_PRB * RSRP / RSSI with each row's own RSSI, at any batch.
    The reference averages RSSI over the batch and symbols per subcarrier:
    its RSRQ has shape (NRE,) at B = 1 and fails to broadcast at B = 2."""
    rng = np.random.default_rng(1)
    rg = rng.normal(size=(2, 14, 72, 2)).astype(np.float32)
    rg[1] *= 3.0  # the second row 9.5 dB stronger, noise only
    meas = p_measure.measure_cells(_t(rg), 6, 1, [11])
    rsrp, rsrq = (v.numpy() for v in meas[11])
    assert rsrp.shape == rsrq.shape == (2,)
    rssi = np.mean(np.sum(rg.astype(np.float64) ** 2, -1).reshape(2, -1), axis=-1)
    np.testing.assert_allclose(rsrq, 6 * rsrp / (rssi * 6), rtol=F32_REL)
    assert np.asarray(j_measure.measure_cells(jnp.asarray(rg[:1]), 6, 1, [11])[11][1]).shape == (72,)
    with pytest.raises((TypeError, ValueError)):
        j_measure.measure_cells(jnp.asarray(rg), 6, 1, [11])


# ---------------- the beacon scan, unsharded ----------------

def test_traced_beacons_bitexact_vs_host_specialized():
    ids = np.array([0, 5, 6, 151, 503], np.int32)
    got = p_netscan.build_beacons(ids, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.jit(j_netscan.build_beacons)(ids)))
    for i, cid in enumerate(ids):
        cell = p_grid.CellConfig(n_prb=6, cell_id=int(cid))
        ref = p_pdsch.put_crs(p_sync.put_pss_sss(p_cplx.zeros((1, 14, 72)), cell, 0), cell, 0)
        assert torch.equal(got[i], ref[0]), cid


def test_network_scan_unsharded_path():
    N = 6
    ids = np.arange(10, 10 + N, dtype=np.int32)
    g = np.zeros((N, N), np.complex64)
    for i in range(N):
        g[i, (i + 3) % N] = 1.0
    res = p_netscan.network_scan(None, ids, g, device="cpu")
    ref = jax.jit(lambda i, gg: j_netscan.network_scan(None, i, gg))(ids, g)
    for k in ("n_id_2", "pss_pos", "n_id_1", "sf_idx", "cell_id"):
        np.testing.assert_array_equal(res[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert (res["cell_id"].numpy() == ids[(np.arange(N) + 3) % N]).all()
    # the mesh branch gives the same rows
    from srslte_emane_tpu_torch.parallel import mesh as p_mesh

    sharded = p_netscan.network_scan(p_mesh.make_mesh(2, device="cpu"), ids, g)
    for k in res:
        assert torch.equal(sharded[k], res[k]), k


@pytest.mark.parametrize("call", [
    lambda ids: p_netscan.build_beacons(ids),
    lambda ids: p_netscan.beacon_waveforms(ids),
    lambda ids: p_netscan.network_scan(None, ids, np.eye(len(ids), dtype=np.complex64)),
], ids=["build_beacons", "beacon_waveforms", "network_scan"])
def test_scan_default_device_is_the_card(call):
    """Numpy ids, as the reference's callers pass them, go to the card by
    default; where there is none the call raises instead of running on the CPU."""
    ids = np.arange(3)
    if torch.cuda.is_available():
        out = call(ids)
        assert (out["cell_id"] if isinstance(out, dict) else out).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(ids)
