"""PyTorch port vs the JAX package: the MBSFN subframe (ops/ofdm's hybrid-CP
modulator, phch/pmch), carrier aggregation (models/pdsch_link.
make_ca_link_step) and the four waveform planes of runtime/wavesim
(MbsfnPlane, UlControlPlane, UlSchPlane, MimoDataPlane), in the reference
tests' configurations.

Time samples are held to a relative RMS of 1e-2 (the reference's bf16
DFT); the PMCH receivers get one numpy grid, so their bits and CRC flags
are held exactly.  The planes draw their own noise (jax.random against a
torch.Generator), so each is held to its JAX twin's delivered bytes, ACKs,
CQIs and metrics.  The JAX side runs under jax.jit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from srslte_emane_tpu.models import pdsch_link as j_link
from srslte_emane_tpu.ops import ofdm as j_ofdm
from srslte_emane_tpu.phch import grid as j_grid
from srslte_emane_tpu.phch import pmch as j_pmch
from srslte_emane_tpu.phch import sch as j_sch
from srslte_emane_tpu.runtime import wavesim as j_wavesim
from srslte_emane_tpu_torch.models import pdsch_link as p_link
from srslte_emane_tpu_torch.ops import ofdm as p_ofdm
from srslte_emane_tpu_torch.phch import grid as p_grid
from srslte_emane_tpu_torch.phch import pmch as p_pmch
from srslte_emane_tpu_torch.phch import sch as p_sch
from srslte_emane_tpu_torch.runtime import wavesim as p_wavesim

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

REL = 1e-2  # relative RMS across the reference's bf16 DFT


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _rel_rms(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


# ---------------- MBSFN subframe and PMCH ----------------

def test_mbsfn_layout_and_tables():
    for n_prb in (6, 15, 25, 50, 75, 100):
        assert p_ofdm.mbsfn_layout(n_prb) == j_ofdm.mbsfn_layout(n_prb)
    assert p_ofdm.N_SYM_MBSFN == j_ofdm.N_SYM_MBSFN
    assert (p_pmch.PILOT_SYMS, p_pmch.PILOT_FIDX) == (j_pmch.PILOT_SYMS, j_pmch.PILOT_FIDX)
    for n_prb in (6, 25):
        np.testing.assert_array_equal(p_pmch.data_indices(n_prb), j_pmch.data_indices(n_prb))
        np.testing.assert_array_equal(p_pmch.mbsfn_rs(2, 3, n_prb), j_pmch.mbsfn_rs(2, 3, n_prb))
        for a, b in zip(p_pmch.pilot_k(n_prb), j_pmch.pilot_k(n_prb)):
            np.testing.assert_array_equal(a, b)


def test_mbsfn_ofdm_round_trip():
    """tests/test_pmch.py's round trip at 25 PRB: both modulators agree,
    and each demodulator gets back the grids of the other's samples."""
    n_prb = 25
    rng = np.random.default_rng(0)
    ctrl = rng.normal(size=(2, 2, 12 * n_prb, 2)).astype(np.float32)
    mb = rng.normal(size=(2, 10, 12 * n_prb, 2)).astype(np.float32)
    t_j = np.asarray(jax.jit(lambda c, m: j_ofdm.modulate_mbsfn(c, m, n_prb))(ctrl, mb))
    t_p = p_ofdm.modulate_mbsfn(_t(ctrl), _t(mb), n_prb)
    assert t_p.shape == t_j.shape == (2, p_ofdm.params(n_prb)["sf_len"], 2)
    assert _rel_rms(t_p, t_j) < REL
    c_j, m_j = jax.jit(lambda s: j_ofdm.demodulate_mbsfn(s, n_prb))(t_j)
    c_p, m_p = p_ofdm.demodulate_mbsfn(_t(t_j), n_prb)
    assert _rel_rms(c_p, c_j) < REL and _rel_rms(m_p, m_j) < REL
    # the port's own round trip is float32-exact up to the FFT's rounding
    c2, m2 = p_ofdm.demodulate_mbsfn(t_p, n_prb)
    np.testing.assert_allclose(c2.numpy(), ctrl, atol=1e-4)
    np.testing.assert_allclose(m2.numpy(), mb, atol=1e-4)


def test_pmch_encode_decode_matches(monkeypatch):
    """tests/test_pmch.py's grant at 25 PRB: the same region grid from both
    encoders; the same noisy grid gives the JAX decoder's LLRs (its
    `sch.decode_tb` patched to hand them back: the turbo decoder is held
    to the JAX package's elsewhere), and the port decodes the payload."""
    n_prb, area_id, sf_idx = 25, 1, 3
    n_re = j_pmch.nof_re(n_prb)
    assert p_pmch.nof_re(n_prb) == n_re
    kw = dict(tbs=(n_re * 2 // 3) // 8 * 8, G=n_re * 2, Qm=2, Nl=1)
    pcfg, jcfg = p_sch.SchConfig(**kw), j_sch.SchConfig(**kw)
    rng = np.random.default_rng(1)
    payload = rng.integers(0, 2, (2, kw["tbs"]), dtype=np.int8)
    g_j = np.asarray(jax.jit(lambda p: j_pmch.encode(p, jcfg, n_prb, area_id, sf_idx))(payload))
    g_p = p_pmch.encode(_t(payload), pcfg, n_prb, area_id, sf_idx)
    np.testing.assert_array_equal(g_p.numpy(), g_j)
    rx = (g_j + rng.normal(size=g_j.shape) * 0.3).astype(np.float32)

    def jax_llrs(g):
        taps = []

        def tap(llrs, cfg, softbuf=None, max_iter=8, **kw_):
            taps.append(llrs)
            return jax.numpy.zeros((llrs.shape[0], cfg.tbs), jax.numpy.int8), llrs[:, 0] > 0, [], 0

        with monkeypatch.context() as m:
            m.setattr(j_sch, "decode_tb", tap)
            j_pmch.decode(g, jcfg, n_prb, area_id, sf_idx)
        return taps

    llr_j = jax.jit(jax_llrs)(rx)
    port_llrs, decode_tb = [], p_sch.decode_tb
    monkeypatch.setattr(p_sch, "decode_tb", lambda llrs, *a, **k: (
        port_llrs.append(llrs), decode_tb(llrs, *a, **k))[1])
    out_p, ok_p = p_pmch.decode(_t(rx), pcfg, n_prb, area_id, sf_idx)
    assert len(llr_j) == len(port_llrs) == 1
    assert _rel_rms(port_llrs[0], llr_j[0]) < 1e-5
    assert ok_p.all()
    np.testing.assert_array_equal(out_p.numpy(), payload)


# ---------------- carrier aggregation ----------------

def test_ca_link_step():
    """tests/test_carrier_aggregation.py::test_waveform_ca_link_step: each
    carrier's TX samples against the JAX package's for that carrier's cell,
    then the step decodes both carriers and, with the payloads swapped,
    still decodes both (the carriers are distinct cells)."""
    cell_kw = dict(n_prb=6, cell_id=1, cfi=2)
    kw = dict(qm=2, code_rate=0.5, snr_db=20.0)
    pcfg = p_link.LinkConfig(cell=p_grid.CellConfig(**cell_kw), **kw)
    jcfg = j_link.LinkConfig(cell=j_grid.CellConfig(**cell_kw), **kw)
    rng = np.random.default_rng(0)
    payloads = rng.integers(0, 2, size=(2, 4, pcfg.tbs), dtype=np.int8)
    carrier = lambda cfg, i: dataclasses.replace(
        cfg, cell=dataclasses.replace(cfg.cell, cell_id=1 + 3 * i))
    t_j = jax.jit(lambda p: [j_link.tx_subframe(p[i], carrier(jcfg, i)) for i in range(2)])(payloads)
    for i in range(2):
        assert _rel_rms(p_link.tx_subframe(_t(payloads[i]), carrier(pcfg, i)), t_j[i]) < REL
    step = p_link.make_ca_link_step(pcfg, n_cc=2)
    gen = torch.Generator()
    gen.manual_seed(0)
    out, ok = step(_t(payloads), gen)
    assert ok.shape == (2, 4) and ok.all()
    np.testing.assert_array_equal(out.numpy(), payloads)
    swapped, ok2 = step(_t(payloads[::-1]), gen)
    assert ok2.all()
    np.testing.assert_array_equal(swapped.numpy(), payloads[::-1])


# ---------------- the four waveform planes ----------------

def _planes(name, cell_kw, **kw):
    return (getattr(j_wavesim, name)(j_grid.CellConfig(**cell_kw), **kw),
            getattr(p_wavesim, name)(p_grid.CellConfig(**cell_kw), device="cpu", **kw))


def test_mbsfn_plane_matches():
    """tests/test_mbms_e2e.py::test_mbsfn_waveform_plane: the near receiver
    decodes every packet, one 60 dB deeper none."""
    jp, pp = _planes("MbsfnPlane", dict(n_prb=6, cell_id=1), area_id=2)
    assert pp.cfg.tbs == jp.cfg.tbs
    pkts = [b"mbms-%d" % i * 3 for i in range(3)]
    out_j = jp.send(pkts, {10: 80.0, 11: 140.0}, sf_idx=3)
    out_p = pp.send(pkts, {10: 80.0, 11: 140.0}, sf_idx=3)
    assert out_p == out_j == {10: pkts, 11: [None, None, None]}
    assert pp.metrics == jp.metrics == {"sf_tx": 3, "crc_ok": 3, "crc_fail": 3}


def _pucch_planes(n_ues):
    jp, pp = _planes("UlControlPlane", dict(n_prb=25, cell_id=17))
    for u in range(n_ues):
        jp.add_ue(100 + u, u)
        pp.add_ue(100 + u, u)
    return jp, pp


def test_ul_control_plane_matches():
    """tests/test_wavesim_pucch.py: ten simultaneous ACK/NACKs separate,
    two silent UEs read as DTX; and a UE 30 dB weaker than its PRB
    neighbour is still detected."""
    jp, pp = _pucch_planes(12)
    assert pp.DETECT_SNR == jp.DETECT_SNR == 4.0
    tx = {100 + u: (u % 2) for u in range(10)}
    pl = {100 + u: 90.0 for u in range(12)}
    out_j, out_p = jp.step(tx, pl), pp.step(tx, pl)
    assert {r: v[:2] for r, v in out_p.items()} == {r: v[:2] for r, v in out_j.items()}
    for u in range(10):
        det, ack, metric = out_p[100 + u]
        assert det and ack == u % 2 and metric > 20.0
        assert abs(metric - out_j[100 + u][2]) < 0.5
    assert all(out_p[r][2] < 10.0 for r in (110, 111))
    assert pp.metrics == jp.metrics
    jp, pp = _pucch_planes(2)
    tx, pl = {100: 1, 101: 0}, {100: 70.0, 101: 100.0}
    out_j, out_p = jp.step(tx, pl), pp.step(tx, pl)
    assert {r: v[:2] for r, v in out_p.items()} == {r: v[:2] for r, v in out_j.items()} == {
        100: (True, 1), 101: (True, 0)}


def test_ul_sch_plane_matches():
    """tests/test_wavesim.py::test_ulsch_plane_pusch_with_aperiodic_cqi:
    payloads and wideband CQIs of two UEs back exact; at the cell edge the
    CRC fails and no CQI is claimed."""
    jp, pp = _planes("UlSchPlane", dict(n_prb=25, cell_id=1))
    for p in (jp, pp):
        p.add_ue(0x46, 0, 8, qm=2)
        p.add_ue(0x47, 8, 8, qm=2)
    tx = {0x46: (b"hello-ul-world!!", 9), 0x47: (b"second-ue-pusch!", 12)}
    pl = {0x46: 100.0, 0x47: 105.0}
    out_p = pp.step(tx, pl)
    assert out_p == jp.step(tx, pl) == {0x46: (b"hello-ul-world!!", True, 9),
                                        0x47: (b"second-ue-pusch!", True, 12)}
    far = {0x46: (b"hello-ul-world!!", 9)}
    assert pp.step(far, {0x46: 145.0}) == jp.step(far, {0x46: 145.0}) == {0x46: (None, False, None)}
    assert pp.metrics == jp.metrics == {"pusch_tx": 3, "pusch_crc_ok": 2, "cqi_rx": 2}


def test_mimo_data_plane_matches():
    """tests/test_wavesim.py::test_mimo_tm3_data_plane: both codewords of
    every subframe deliver at 95 dB; an odd burst at 135 dB delivers none
    (its padding PDU counts in the metrics, as in the reference)."""
    jp, pp = _planes("MimoDataPlane", dict(n_prb=25, cell_id=5, n_ports=2, cfi=1))
    for p in (jp, pp):
        p.add_ue(0x50, (1,) * 25, qm=4)
    pdus = [bytes([i]) * 150 for i in range(6)]
    assert pp.send(0x50, pdus, pathloss_db=95.0) == jp.send(0x50, pdus, pathloss_db=95.0) == pdus
    far = pdus[:5]  # three subframes again: the JAX plane reuses its compiled graph
    assert pp.send(0x50, far, pathloss_db=135.0) == jp.send(0x50, far, pathloss_db=135.0) == [
        None] * 5
    assert pp.metrics == jp.metrics == {"sf_tx": 6, "crc_ok": 6, "crc_fail": 6}


@pytest.mark.parametrize("name,args", [
    ("MbsfnPlane", ()), ("UlControlPlane", ()), ("UlSchPlane", ()), ("MimoDataPlane", ())])
def test_planes_need_a_card_by_default(name, args, monkeypatch):
    """The default device is the card: with none, each plane raises rather
    than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(p_wavesim, name)(p_grid.CellConfig(n_prb=6, n_ports=2), *args)
