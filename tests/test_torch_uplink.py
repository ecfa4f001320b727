"""PyTorch port vs the JAX package: the uplink slice (refsignal_ul, convcoder,
viterbi, uci, pusch_uci, pusch, srs, pucch, models/ue_ul, convert).

Bits, tables and decisions must be equal.  Where the reference's bf16
transform (ops/dft.py) sits between input and output, samples and LLRs are
held to a relative RMS of 1e-2.  Where both packages see the same grid,
estimates and correlations agree to float32 rounding (rtol 1e-4, atol
1e-5).  The two packages draw different noise, so receivers get the same
numpy noise on the JAX transmit samples.
"""

import dataclasses
import filecmp
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srslte_emane_tpu.models import ue_ul as j_ue_ul
from srslte_emane_tpu.ops import cplx as j_cplx
from srslte_emane_tpu.ops import ofdm as j_ofdm
from srslte_emane_tpu.ops.fec import convcoder as j_cc
from srslte_emane_tpu.ops.fec import viterbi as j_vit
from srslte_emane_tpu.phch import grid as j_grid
from srslte_emane_tpu.phch import pucch as j_pucch
from srslte_emane_tpu.phch import pusch as j_pusch
from srslte_emane_tpu.phch import pusch_uci as j_mux
from srslte_emane_tpu.phch import refsignal_ul as j_rs
from srslte_emane_tpu.phch import sch as j_sch
from srslte_emane_tpu.phch import srs as j_srs
from srslte_emane_tpu.phch import uci as j_uci
from srslte_emane_tpu_torch import convert
from srslte_emane_tpu_torch.models import ue_ul as p_ue_ul
from srslte_emane_tpu_torch.ops import ofdm as p_ofdm
from srslte_emane_tpu_torch.ops.fec import convcoder as p_cc
from srslte_emane_tpu_torch.ops.fec import viterbi as p_vit
from srslte_emane_tpu_torch.phch import grid as p_grid
from srslte_emane_tpu_torch.phch import pucch as p_pucch
from srslte_emane_tpu_torch.phch import pusch as p_pusch
from srslte_emane_tpu_torch.phch import pusch_uci as p_mux
from srslte_emane_tpu_torch.phch import refsignal_ul as p_rs
from srslte_emane_tpu_torch.phch import sch as p_sch
from srslte_emane_tpu_torch.phch import srs as p_srs
from srslte_emane_tpu_torch.phch import uci as p_uci

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

REL = 1e-2  # relative RMS across the reference's bf16 DFT
RTOL, ATOL = 1e-4, 1e-5  # same grid in, float32 rounding only


def _rel_rms(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _noisy(x, snr_db, rng):
    """x (B, ..., 2) plus complex white noise at snr_db per row, as float32."""
    x = np.asarray(x)
    power = np.mean(np.sum(x ** 2, -1).reshape(x.shape[0], -1), -1)
    power = power.reshape((-1,) + (1,) * (x.ndim - 1))
    return (x + rng.normal(size=x.shape) * np.sqrt(power / 10 ** (snr_db / 10) / 2)
            ).astype(np.float32)


def _cells(**kw):
    return p_grid.CellConfig(**kw), j_grid.CellConfig(**kw)


def test_tables_copied_and_equal():
    port = pathlib.Path(p_rs.__file__).parent
    ref = pathlib.Path(j_rs.__file__).parent
    for name in ("ul_rs_tables.npz", "uci_tables.npz"):
        assert filecmp.cmp(port / name, ref / name, shallow=False), name
    for m_sc in (12, 24, 36, 96, 300, 1152):
        for u in (0, 7, 29):
            np.testing.assert_array_equal(p_rs.base_sequence(u, 0, m_sc),
                                          j_rs.base_sequence(u, 0, m_sc))
    for cell_id in (1, 3, 42, 150):
        np.testing.assert_array_equal(p_rs.n_prs_table(cell_id), j_rs.n_prs_table(cell_id))
        np.testing.assert_array_equal(p_rs.f_gh_table(cell_id, True), j_rs.f_gh_table(cell_id, True))
        np.testing.assert_array_equal(p_pucch.n_cs_cell(cell_id), j_pucch.n_cs_cell(cell_id))
        for sf, n_prb in ((2, 8), (7, 25), (2, 96)):
            np.testing.assert_array_equal(p_rs.pusch_dmrs(cell_id, sf, n_prb),
                                          j_rs.pusch_dmrs(cell_id, sf, n_prb))
        np.testing.assert_array_equal(p_srs.srs_sequence(cell_id, 2, 16, 2, 0),
                                      j_srs.srs_sequence(cell_id, 2, 16, 2, 0))
        np.testing.assert_array_equal(p_pucch._f1_waveform(cell_id, 2, 40),
                                      j_pucch._f1_waveform(cell_id, 2, 40))
    np.testing.assert_array_equal(p_uci.RM32, j_uci.RM32)
    np.testing.assert_array_equal(p_uci.RM20, j_uci.RM20)
    for n in (0, 5, 40, 77):
        for ns in range(20):
            assert p_pucch.pucch_prb(n, ns, 100) == j_pucch.pucch_prb(n, ns, 100)


def test_interleaver_and_mux_tables():
    rng = np.random.default_rng(0)
    for qm, r in ((2, 30), (4, 96)):
        bits = rng.integers(0, 2, (2, 12 * qm * r), dtype=np.int8)
        np.testing.assert_array_equal(p_pusch.interleave(_t(bits), qm).numpy(),
                                      np.asarray(j_pusch.interleave(bits, qm)))
        llr = rng.normal(size=bits.shape).astype(np.float32)
        np.testing.assert_array_equal(p_pusch.deinterleave(_t(llr), qm).numpy(),
                                      np.asarray(j_pusch.deinterleave(llr, qm)))
    for n_prb, rb, l_prb in ((25, 10, 8), (100, 0, 96)):
        for a, b in zip(p_pusch.re_indices(n_prb, rb, l_prb), j_pusch.re_indices(n_prb, rb, l_prb)):
            np.testing.assert_array_equal(a, b)
    for l_prb, qm, dims in ((8, 2, (1, 1, 6)), (4, 4, (2, 1, 20)), (96, 4, (2, 2, 0))):
        assert p_pusch.uci_dims(l_prb, qm, *dims) == j_pusch.uci_dims(l_prb, qm, *dims)
        q_ack, q_ri, q_cqi, g_data = j_pusch.uci_dims(l_prb, qm, *dims)
        g = g_data + q_ri + q_cqi  # data = CQI prefix + SCH codeword
        pt, jt = p_mux.mux_tables(g, qm, q_ri, q_ack), j_mux.mux_tables(g, qm, q_ri, q_ack)
        assert pt.keys() == jt.keys()
        for name in jt:
            np.testing.assert_array_equal(pt[name], jt[name], err_msg=name)
        data = rng.integers(0, 2, (2, g - q_ri), dtype=np.int8)
        ack = rng.integers(0, 2, (2, dims[0]), dtype=np.int8)
        ri = rng.integers(0, 2, (2, dims[1]), dtype=np.int8)
        ack_j, ri_j = (np.asarray(j_mux.encode_ack_ri(x, q // qm, qm))
                       for x, q in ((ack, q_ack), (ri, q_ri)))
        ack_p, ri_p = (p_mux.encode_ack_ri(_t(x), q // qm, qm).numpy()
                       for x, q in ((ack, q_ack), (ri, q_ri)))
        np.testing.assert_array_equal(ack_p, ack_j)
        np.testing.assert_array_equal(ri_p, ri_j)
        mux = p_mux.multiplex(_t(data), _t(ri_j), _t(ack_j), qm).numpy()
        np.testing.assert_array_equal(mux, np.asarray(j_mux.multiplex(data, ri_j, ack_j, qm)))
        llr = rng.normal(size=mux.shape).astype(np.float32)
        for got, ref in zip(p_mux.demultiplex(_t(llr), qm, q_ri, q_ack),
                            j_mux.demultiplex(llr, qm, q_ri, q_ack)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        for n, q in ((dims[0], q_ack), (dims[1], q_ri)):
            x = llr[:, :q]
            np.testing.assert_array_equal(p_mux.decode_ack_ri(_t(x), n, qm).numpy(),
                                          np.asarray(j_mux.decode_ack_ri(x, n, qm)))


@pytest.mark.parametrize("k", [40, 72])
def test_convcoder_and_viterbi(k):
    rng = np.random.default_rng(k)
    bits = rng.integers(0, 2, (4, k), dtype=np.int8)
    enc = p_cc.conv_encode(_t(bits))
    np.testing.assert_array_equal(enc.numpy(), np.asarray(j_cc.conv_encode(bits)))
    for e in (int(3 * k * 0.6), 3 * k, int(3 * k * 2.5)):
        tx = p_cc.rate_match_cc(enc, e)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(j_cc.rate_match_cc(enc.numpy(), e)))
        llr = ((1 - 2.0 * tx.numpy()) + rng.normal(0, 0.8, tx.shape)).astype(np.float32)
        streams = p_cc.rate_unmatch_cc(_t(llr), k)
        np.testing.assert_array_equal(streams.numpy(), np.asarray(j_cc.rate_unmatch_cc(llr, k)))
        np.testing.assert_array_equal(p_vit.viterbi_decode(streams).numpy(),
                                      np.asarray(j_vit.viterbi_decode(streams.numpy())))


@pytest.mark.parametrize("n_bits,q_bits", [(6, 32), (11, 48), (20, 96), (30, 120)])
def test_uci_codes(n_bits, q_bits):
    """RM32 (short reports) and CRC8 + convolutional code (long ones)."""
    rng = np.random.default_rng(n_bits)
    bits = rng.integers(0, 2, (4, n_bits), dtype=np.int8)
    cw = p_uci.encode_cqi_pusch(_t(bits), q_bits)
    np.testing.assert_array_equal(cw.numpy(), np.asarray(j_uci.encode_cqi_pusch(bits, q_bits)))
    llr = ((1 - 2.0 * cw.numpy()) + rng.normal(0, 0.7, cw.shape)).astype(np.float32)
    got_bits, got_ok = p_uci.decode_cqi_pusch(_t(llr), n_bits)
    ref_bits, ref_ok = j_uci.decode_cqi_pusch(llr, n_bits)
    np.testing.assert_array_equal(got_bits.numpy(), np.asarray(ref_bits))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ref_ok))
    np.testing.assert_array_equal(got_bits.numpy(), bits)
    if n_bits <= 13:  # the PUCCH (20, A) code
        cw20 = p_uci.encode_rm20(_t(bits))
        np.testing.assert_array_equal(cw20.numpy(), np.asarray(j_uci.encode_rm20(bits)))
        llr = ((1 - 2.0 * cw20.numpy()) + rng.normal(0, 0.5, cw20.shape)).astype(np.float32)
        got, got_m = p_uci.decode_rm(_t(llr), n_bits, "rm20")
        ref, ref_m = j_uci.decode_rm(llr, n_bits, "rm20")
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_allclose(got_m.numpy(), np.asarray(ref_m), rtol=RTOL, atol=ATOL)
    # all-zero LLRs tie every codeword: both keep the first (bits 0)
    got, _ = p_uci.decode_rm(torch.zeros((1, 32)), min(n_bits, 11), "rm32")
    ref, _ = j_uci.decode_rm(np.zeros((1, 32), np.float32), min(n_bits, 11), "rm32")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_cqi_report_packing():
    n_prb = 50
    diffs = [(i * 7) % 4 for i in range(p_uci.cqi_hl_subband_size(n_prb))]
    for pk in (lambda m: m.pack_cqi_wideband(11, pmi=2),
               lambda m: m.pack_cqi_wideband(9, pmi=1, rank2=True, spatial_diff=5),
               lambda m: m.pack_cqi_format2_subband(7, 2, True),
               lambda m: m.pack_cqi_ue_subband(12, 3, 5, n_prb),
               lambda m: m.pack_cqi_hl_subband(11, diffs, n_prb, cw1=(6, diffs), pmi=1)):
        np.testing.assert_array_equal(pk(p_uci), pk(j_uci))
    bits = j_uci.pack_cqi_hl_subband(11, diffs, n_prb, cw1=(6, diffs), pmi=1)
    assert (p_uci.unpack_cqi_hl_subband(bits, n_prb, rank2=True, has_pmi=True)
            == j_uci.unpack_cqi_hl_subband(bits, n_prb, rank2=True, has_pmi=True))
    assert p_uci.unpack_cqi_ue_subband(j_uci.pack_cqi_ue_subband(12, 3, 5, n_prb), n_prb) \
        == j_uci.unpack_cqi_ue_subband(j_uci.pack_cqi_ue_subband(12, 3, 5, n_prb), n_prb)


PUCCH_CELL = dict(n_prb=25, cell_id=150)


def _pucch_case(fmt, B, rng):
    """(port encode, JAX encode, port decode, JAX decode) closures of one
    format, with the JAX test's resources and sizes."""
    pc, jc = _cells(**PUCCH_CELL)
    if fmt == "f1":
        d0 = np.tile(np.array([[1.0, 0.0], [-1.0, 0.0]], np.float32), (B // 2, 1))
        return ((lambda g: p_pucch.encode_f1(_t(d0), pc, 2, 5, g)),
                (lambda g: j_pucch.encode_f1(d0, jc, 2, 5, g)),
                (lambda r: p_pucch.detect_f1(r, pc, 2, 5)),
                (lambda r: j_pucch.detect_f1(r, jc, 2, 5)), d0)
    if fmt == "f2":
        bits = rng.integers(0, 2, (B, 6), dtype=np.int8)
        return ((lambda g: p_pucch.encode_f2(_t(bits), pc, 4, 3, g)),
                (lambda g: j_pucch.encode_f2(bits, jc, 4, 3, g)),
                (lambda r: p_pucch.decode_f2(r, pc, 4, 3, 6)),
                (lambda r: j_pucch.decode_f2(r, jc, 4, 3, 6)), bits)
    if fmt in ("f2a", "f2b"):
        cqi = rng.integers(0, 2, (B, 6), dtype=np.int8)
        n_ack = 1 if fmt == "f2a" else 2
        ack = rng.integers(0, 2, (B, n_ack), dtype=np.int8)
        return ((lambda g: p_pucch.encode_f2ab(_t(cqi), _t(ack), pc, 2, 5, g)),
                (lambda g: j_pucch.encode_f2ab(cqi, ack, jc, 2, 5, g)),
                (lambda r: p_pucch.decode_f2ab(r, pc, 2, 5, 6, n_ack)),
                (lambda r: j_pucch.decode_f2ab(r, jc, 2, 5, 6, n_ack)), (cqi, ack))
    ack = rng.integers(0, 2, (B, 10), dtype=np.int8)
    return ((lambda g: p_pucch.encode_f3(_t(ack), pc, 1, 7, g)),
            (lambda g: j_pucch.encode_f3(ack, jc, 1, 7, g)),
            (lambda r: p_pucch.decode_f3(r, pc, 1, 7, 10)),
            (lambda r: j_pucch.decode_f3(r, jc, 1, 7, 10)), ack)


@pytest.mark.parametrize("fmt", ["f1", "f2", "f2a", "f2b", "f3"])
def test_pucch_formats(fmt):
    """Grids equal on TX; on the same noisy grid, decisions equal and
    correlations/metrics within float32 rounding; through OFDM, the JAX
    test's own checks."""
    B = 4
    rng = np.random.default_rng(len(fmt) + ord(fmt[-1]))
    p_enc, j_enc, p_dec, j_dec, sent = _pucch_case(fmt, B, rng)
    nre = PUCCH_CELL["n_prb"] * 12
    base = rng.normal(size=(B, 14, nre, 2)).astype(np.float32)  # writes land on data
    g_p = p_enc(_t(base)).numpy()
    g_j = np.asarray(j_enc(jnp.asarray(base)))
    np.testing.assert_allclose(g_p, g_j, rtol=RTOL, atol=1e-6)
    rx = _noisy(g_j, 8.0, rng)
    got, ref = p_dec(_t(rx)), j_dec(rx)
    for a, b in zip(got, ref):
        if a.dtype == torch.int8:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)
    # over the air (JAX OFDM, numpy noise), as tests/test_pucch.py checks it
    t = np.asarray(j_ofdm.modulate(j_enc(jnp.zeros((B, 14, nre, 2))), PUCCH_CELL["n_prb"]))
    rg = p_ofdm.demodulate(_t(_noisy(t, 10.0, rng)), PUCCH_CELL["n_prb"])
    out = p_dec(rg)
    if fmt == "f1":
        corr = out[0].numpy()
        assert (corr[0::2, 0] > 0.1).all() and (corr[1::2, 0] < -0.1).all()
    elif fmt in ("f2a", "f2b"):
        np.testing.assert_array_equal(out[0].numpy(), sent[0])
        np.testing.assert_array_equal(out[1].numpy(), sent[1])
    else:
        np.testing.assert_array_equal(out[0].numpy(), sent)


def test_srs():
    pc, jc = _cells(n_prb=25, cell_id=88)
    rng = np.random.default_rng(88)
    base = rng.normal(size=(2, 14, pc.nre, 2)).astype(np.float32)
    g_p = p_srs.put_srs(_t(base), pc, 2, rb_start=4, m_srs_prb=16, cyclic_shift=2)
    g_j = np.asarray(j_srs.put_srs(jnp.asarray(base), jc, 2, rb_start=4, m_srs_prb=16,
                                   cyclic_shift=2))
    np.testing.assert_array_equal(g_p.numpy(), g_j)
    t = np.asarray(j_ofdm.modulate(j_srs.put_srs(jnp.zeros(base.shape), jc, 2, 4, 16, 2), 25))
    rg = np.asarray(j_ofdm.demodulate(_noisy(t, 20.0, rng), 25))
    h_p, snr_p = p_srs.estimate_srs(_t(rg), pc, 2, 4, 16, cyclic_shift=2)
    h_j, snr_j = j_srs.estimate_srs(rg, jc, 2, 4, 16, cyclic_shift=2)
    np.testing.assert_allclose(h_p.numpy(), np.asarray(h_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(snr_p.numpy(), np.asarray(snr_j), rtol=RTOL, atol=ATOL)
    # tests/test_srs_resample.py's checks: flat channel, good SNR
    assert abs(h_p.numpy()[..., 0].mean() - 1.0) < 0.1 and snr_p.min() > 10


def _capture_decode_tb(monkeypatch, module):
    """Record the LLRs each sch.decode_tb call of `module` receives."""
    seen, orig = [], module.sch.decode_tb
    monkeypatch.setattr(module.sch, "decode_tb",
                        lambda llrs, *a, **kw: seen.append(np.asarray(llrs, np.float32)) or orig(llrs, *a, **kw))
    return seen


@pytest.mark.parametrize("l_prb,qm,snr", [(4, 2, 6.0), (25, 4, 12.0)])
def test_pusch_matches_jax(monkeypatch, l_prb, qm, snr):
    """tests/test_pusch.py's links: grid samples within the bf16 bound, the
    DMRS estimate equal on one grid, the LLRs handed to decode_tb within
    the bf16 bound, payload and CRC flags equal."""
    pc, jc = _cells(n_prb=25, cell_id=42)
    sf_idx, rnti, rb_start = 2, 0x5A, 0
    G = 12 * l_prb * 12 * qm
    tbs = max(8, (int(G * 0.4) - 24) // 8 * 8)
    pcfg, jcfg = p_sch.SchConfig(tbs=tbs, G=G, Qm=qm, Nl=1), j_sch.SchConfig(tbs=tbs, G=G, Qm=qm, Nl=1)
    rng = np.random.default_rng(l_prb)
    payload = rng.integers(0, 2, (2, tbs), dtype=np.int8)
    g_j = np.asarray(j_pusch.encode(payload, jcfg, jc, sf_idx, rnti, rb_start, l_prb))
    g_p = p_pusch.encode(_t(payload), pcfg, pc, sf_idx, rnti, rb_start, l_prb).numpy()
    assert _rel_rms(g_p, g_j) <= REL
    t = np.asarray(j_ofdm.modulate(g_j, 25))
    rx = _noisy(t, snr, rng)
    rg = np.asarray(j_ofdm.demodulate(rx, 25))
    ce_p, n_p = p_pusch.estimate_ul(_t(rg), pc, sf_idx, rb_start, l_prb)
    ce_j, n_j = j_pusch.estimate_ul(rg, jc, sf_idx, rb_start, l_prb)
    np.testing.assert_allclose(ce_p.numpy(), np.asarray(ce_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(n_p.numpy(), np.asarray(n_j), rtol=RTOL, atol=ATOL)
    seen_p = _capture_decode_tb(monkeypatch, p_pusch)
    seen_j = _capture_decode_tb(monkeypatch, j_pusch)
    out_p, ok_p, _, _ = p_pusch.decode(p_ofdm.demodulate(_t(rx), 25), pcfg, pc, sf_idx, rnti,
                                       rb_start, l_prb)
    out_j, ok_j, _, _ = j_pusch.decode(rg, jcfg, jc, sf_idx, rnti, rb_start, l_prb)
    assert _rel_rms(seen_p[0], seen_j[0]) <= REL
    np.testing.assert_array_equal(out_p.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_j))
    assert ok_p.all() and (out_p.numpy() == payload).all()
    # the kernel path (its plain version on CPU), and a wrong RNTI fails
    out_k, ok_k, _, _ = p_pusch.decode(_t(rg), pcfg, pc, sf_idx, rnti, rb_start, l_prb,
                                       use_kernel=True, llr_bits=16)
    assert ok_k.all() and (out_k.numpy() == payload).all()
    if l_prb == 4:
        _, bad, _, _ = p_pusch.decode(_t(rg), pcfg, pc, sf_idx, rnti + 1, rb_start, l_prb)
        assert not bad.any()


@pytest.mark.parametrize("n_cqi", [6, 20])
def test_pusch_with_uci_matches_jax(n_cqi):
    """tests/test_pusch_uci.py's case; n_cqi=20 takes the long CQI code."""
    pc, jc = _cells(n_prb=25, cell_id=42)
    sf_idx, rnti, rb_start, l_prb, qm = 2, 0x5A, 0, 8, 2
    rng = np.random.default_rng(n_cqi)
    B, n_ack, n_ri = 2, 1, 1
    dims = j_pusch.uci_dims(l_prb, qm, n_ack, n_ri, n_cqi)
    q_ack, q_ri, q_cqi, g_data = dims
    tbs = max(8, (int(g_data * 0.4) - 24) // 8 * 8)
    pcfg = p_sch.SchConfig(tbs=tbs, G=g_data, Qm=qm, Nl=1)
    jcfg = j_sch.SchConfig(tbs=tbs, G=g_data, Qm=qm, Nl=1)
    payload = rng.integers(0, 2, (B, tbs), dtype=np.int8)
    uci = dict(ack=rng.integers(0, 2, (B, n_ack), dtype=np.int8),
               ri=rng.integers(0, 2, (B, n_ri), dtype=np.int8),
               cqi=rng.integers(0, 2, (B, n_cqi), dtype=np.int8))
    g_j = np.asarray(j_pusch.encode(payload, jcfg, jc, sf_idx, rnti, rb_start, l_prb, uci=uci))
    g_p = p_pusch.encode(_t(payload), pcfg, pc, sf_idx, rnti, rb_start, l_prb,
                         uci={k: _t(v) for k, v in uci.items()}).numpy()
    assert _rel_rms(g_p, g_j) <= REL
    rg = np.asarray(j_ofdm.demodulate(_noisy(np.asarray(j_ofdm.modulate(g_j, 25)), 10.0, rng), 25))
    dims_in = (q_ack, q_ri, q_cqi, n_ack, n_ri, n_cqi)
    out_p = p_pusch.decode(_t(rg), pcfg, pc, sf_idx, rnti, rb_start, l_prb, uci_dims_in=dims_in)
    out_j = j_pusch.decode(rg, jcfg, jc, sf_idx, rnti, rb_start, l_prb, uci_dims_in=dims_in)
    for name in ("payload", "ok", "ack", "ri", "cqi"):
        np.testing.assert_array_equal(out_p[name].numpy(), np.asarray(out_j[name]), err_msg=name)
    assert out_p["ok"].all() and (out_p["payload"].numpy() == payload).all()
    for name in ("ack", "ri", "cqi"):
        np.testing.assert_array_equal(out_p[name].numpy(), uci[name], err_msg=name)


def _ue_ul_cases():
    """tests/test_ue_ul_model.py's two composites."""
    l_prb, qm = 8, 4
    tbs = (12 * l_prb * 12 * qm // 2 - 24) // 8 * 8
    full = dict(cell=dict(n_prb=25, cell_id=3), sf_idx=2, rnti=0x5A, rb_start=10,
                l_prb=l_prb, qm=qm, tbs=tbs, n_pucch_1=3, srs_rb_start=4, srs_l_prb=4)
    return [(full, 2, 18.0, 0), (dict(cell=dict(n_prb=25, cell_id=3), sf_idx=4, n_pucch_2=1), 3, 12.0, 6)]


@pytest.mark.parametrize("case", _ue_ul_cases(), ids=["pusch_pucch1a_srs", "pucch2"])
def test_ue_ul_composites_match_jax(case):
    fields, B, snr, n_cqi = case
    jcfg = j_ue_ul.UlSubframeConfig(**dict(fields, cell=j_grid.CellConfig(**fields["cell"])))
    pcfg = convert.ul_config_from_fields(**dataclasses.asdict(jcfg))
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    rng = np.random.default_rng(B)
    kw_j, kw_p = {}, {}
    if pcfg.l_prb:
        tb = rng.integers(0, 2, (B, pcfg.tbs), dtype=np.int8)
        ack = j_cplx.from_numpy(np.array([1 + 0j, -1 + 0j], dtype=np.complex64))
        kw_j, kw_p = dict(tb_bits=tb, ack_bits=ack), dict(tb_bits=_t(tb), ack_bits=_t(np.asarray(ack)))
    else:
        cqi = rng.integers(0, 2, (B, n_cqi), dtype=np.int8)
        kw_j, kw_p = dict(cqi_bits=cqi), dict(cqi_bits=_t(cqi))
    tx_j = np.asarray(j_ue_ul.build_subframe(jcfg, **kw_j))
    tx_p = p_ue_ul.build_subframe(pcfg, **kw_p).numpy()
    assert _rel_rms(tx_p, tx_j) <= REL
    rx = _noisy(tx_j, snr, rng)
    out_j = j_ue_ul.enb_receive(rx, jcfg, n_cqi_bits=n_cqi)
    out_p = p_ue_ul.enb_receive(_t(rx), pcfg, n_cqi_bits=n_cqi)
    assert out_p.keys() == out_j.keys()
    if pcfg.l_prb:
        for got, ref in zip(out_p["pusch"], out_j["pusch"]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert out_p["pusch"][1].all() and (out_p["pusch"][0].numpy() == tb).all()
        corr = out_p["pucch_ack"].numpy()
        assert _rel_rms(corr, out_j["pucch_ack"]) <= REL
        assert corr[0, 0] > 0.3 and corr[1, 0] < -0.3  # ACK vs NACK signs
        for got, ref in zip(out_p["srs_ce"], out_j["srs_ce"]):
            assert _rel_rms(got.numpy(), ref) <= REL
    else:
        np.testing.assert_array_equal(out_p["pucch_cqi"].numpy(), np.asarray(out_j["pucch_cqi"]))
        np.testing.assert_array_equal(out_p["pucch_cqi"].numpy(), cqi)


def test_pusch_harq_softbuffer_carried_across():
    """A failed first PUSCH transmission decoded by the JAX package; its soft
    buffers, carried into the port, combine with a retransmission of the
    same codeword as the JAX package combines them."""
    pc, jc = _cells(n_prb=25, cell_id=42)
    sf_idx, rnti, l_prb, qm = 2, 0x5A, 20, 4
    G = 12 * l_prb * 12 * qm
    tbs = (int(G * 0.6) - 24) // 8 * 8  # two code blocks
    pcfg, jcfg = p_sch.SchConfig(tbs=tbs, G=G, Qm=qm, Nl=1), j_sch.SchConfig(tbs=tbs, G=G, Qm=qm, Nl=1)
    assert pcfg.segm.C == 2
    rng = np.random.default_rng(5)
    payload = rng.integers(0, 2, (2, tbs), dtype=np.int8)
    t = np.asarray(j_ofdm.modulate(j_pusch.encode(payload, jcfg, jc, sf_idx, rnti, 0, l_prb), 25))
    rg1, rg2 = (np.asarray(j_ofdm.demodulate(_noisy(t, snr, rng), 25)) for snr in (3.0, 5.0))
    _, ok1, sb1, _ = j_pusch.decode(rg1, jcfg, jc, sf_idx, rnti, 0, l_prb, max_iter=4)
    assert not np.asarray(ok1).any()
    _, ok1_p, _, _ = p_pusch.decode(_t(rg1), pcfg, pc, sf_idx, rnti, 0, l_prb, max_iter=4)
    assert not ok1_p.any()
    sb1_p = convert.softbuffer_from_numpy([np.asarray(a) for a in sb1])
    out_j, ok_j, sb_j, _ = j_pusch.decode(rg2, jcfg, jc, sf_idx, rnti, 0, l_prb, softbuf=sb1)
    out_p, ok_p, sb_p, _ = p_pusch.decode(_t(rg2), pcfg, pc, sf_idx, rnti, 0, l_prb,
                                          softbuf=sb1_p)
    _, ok_alone, _, _ = p_pusch.decode(_t(rg2), pcfg, pc, sf_idx, rnti, 0, l_prb)
    assert np.asarray(ok_j).all() and not ok_alone.all()  # the combining is what decodes
    np.testing.assert_array_equal(out_p.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_j))
    for a, b in zip(sb_p, sb_j):
        assert _rel_rms(a.numpy(), b) <= REL
