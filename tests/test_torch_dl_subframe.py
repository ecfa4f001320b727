"""PyTorch port vs the JAX package: the full downlink subframe
(models/enb_dl, models/ue_dl, runtime/wavesim.WaveformDataPlane,
convert.dl_config_from_fields), in tests/test_node_models.py's and
tests/test_wavesim.py's configurations.

Transmit samples are held to a relative RMS of 1e-2 (the reference's bf16
DFT).  The receivers get the same numpy noise on the JAX transmit samples;
CFI, DCI hits, payload bits, CRC flags and the MIB must then be equal,
PHICH soft metrics within atol 1e-3, rtol 1e-2.  The two planes draw their
own noise, so they are held to the bytes they deliver.  The JAX side runs
under jax.jit: op by op it compiles each op on first use, three times
slower here.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from srslte_emane_tpu.models import enb_dl as j_enb
from srslte_emane_tpu.models import ue_dl as j_ue
from srslte_emane_tpu.ops import ofdm as j_ofdm
from srslte_emane_tpu.phch import chest as j_chest
from srslte_emane_tpu.phch import grid as j_grid
from srslte_emane_tpu.phch import pbch as j_pbch
from srslte_emane_tpu.phch import pdcch as j_pdcch
from srslte_emane_tpu.runtime import wavesim as j_wavesim
from srslte_emane_tpu_torch import convert
from srslte_emane_tpu_torch.models import enb_dl as p_enb
from srslte_emane_tpu_torch.models import ue_dl as p_ue
from srslte_emane_tpu_torch.ops import ofdm as p_ofdm
from srslte_emane_tpu_torch.phch import chest as p_chest
from srslte_emane_tpu_torch.phch import grid as p_grid
from srslte_emane_tpu_torch.phch import pbch as p_pbch
from srslte_emane_tpu_torch.runtime import wavesim as p_wavesim

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

REL = 1e-2  # relative RMS across the reference's bf16 DFT
SOFT_RTOL, SOFT_ATOL = 1e-2, 1e-3  # PHICH soft metrics


def _rel_rms(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _noisy(x, snr_db, rng):
    """x (B, T, 2) plus complex white noise at snr_db per row, as float32."""
    x = np.asarray(x)
    power = np.mean(np.sum(x ** 2, -1), -1)[:, None, None]
    return (x + rng.normal(size=x.shape) * np.sqrt(power / 10 ** (snr_db / 10) / 2)
            ).astype(np.float32)


def _port_config(jcfg):
    """The port's config from the JAX config's fields (convert's path)."""
    pcfg = convert.dl_config_from_fields(**dataclasses.asdict(jcfg))
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    # the cell may also come as an object with CellConfig's fields
    assert convert.dl_config_from_fields(
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}) == pcfg
    for gi in range(len(jcfg.grants)):
        assert dataclasses.asdict(pcfg.sch_cfg(gi)) == dataclasses.asdict(jcfg.sch_cfg(gi))
    return pcfg


def _assert_same_decode(res_p, res_j, n_grants):
    np.testing.assert_array_equal(res_p.cfi.numpy(), np.asarray(res_j.cfi))
    np.testing.assert_array_equal(res_p.dci_found.numpy(), np.asarray(res_j.dci_found))
    assert len(res_p.payloads) == len(res_p.crc_ok) == n_grants
    for gi in range(n_grants):
        np.testing.assert_array_equal(res_p.payloads[gi].numpy(), np.asarray(res_j.payloads[gi]))
        np.testing.assert_array_equal(res_p.crc_ok[gi].numpy(), np.asarray(res_j.crc_ok[gi]))
    np.testing.assert_allclose(res_p.snr_db.numpy(), np.asarray(res_j.snr_db), atol=0.1)


def test_full_dl_subframe_sf0():
    """tests/test_node_models.py's sf 0 subframe: PSS/SSS, PCFICH, PBCH
    (SFN 8), PHICH, DCI 1A and PDSCH, built and decoded by both packages."""
    jcell = j_grid.CellConfig(n_prb=25, cell_id=123, cfi=2)
    rnti = 0x46
    l_aggr, cce = next(c for c in j_pdcch.candidates(jcell, rnti, 0) if c[0] == 4)
    prb_mask = tuple(1 if 4 <= i < 12 else 0 for i in range(25))
    tbs = (j_grid.nof_re(jcell, 0, prb_mask) * 2 // 3) // 8 * 8
    jcfg = j_enb.DlSubframeConfig(cell=jcell, sf_idx=0,
                                  grants=((rnti, prb_mask, 2, tbs, l_aggr, cce),),
                                  with_pbch_sfn=8, phich_groups=1)
    pcfg = _port_config(jcfg)
    B = 2
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 2, (B, tbs), dtype=np.int8)
    mib = np.tile(j_pbch.pack_mib(25, 8), (B, 1))
    acks = np.ones((B, 1, 8), np.float32)
    tx_j = np.asarray(jax.jit(lambda p, m, a: j_enb.build_subframe(jcfg, [p], mib_bits=m, acks=a))(
        payload, mib, acks))
    tx_p = p_enb.build_subframe(pcfg, [_t(payload)], mib_bits=_t(mib), acks=_t(acks))
    assert tx_p.shape == tx_j.shape and _rel_rms(tx_p, tx_j) < REL

    rx = _noisy(tx_j, 14.0, rng)

    def decode_j(x):  # the subframe, then the MIB from the same capture
        g = j_ofdm.demodulate(x, 25)
        return (j_ue.decode_subframe(x, jcfg, with_phich=True)[0],
                j_pbch.decode(g, j_chest.estimate(g, jcell, 0).ce, jcell))

    res_j, mib_j = jax.jit(decode_j)(rx)
    res_p, bufs = p_ue.decode_subframe(_t(rx), pcfg, with_phich=True)
    _assert_same_decode(res_p, res_j, 1)
    assert (res_p.cfi == 2).all() and res_p.dci_found.all() and res_p.crc_ok[0].all()
    np.testing.assert_array_equal(res_p.payloads[0].numpy(), payload)
    np.testing.assert_allclose(res_p.phich.numpy(), np.asarray(res_j.phich),
                               rtol=SOFT_RTOL, atol=SOFT_ATOL)
    assert (res_p.phich[:, 0, :] > 0).all()
    assert len(bufs) == 1 and bufs[0][0].shape[0] == B

    g_p = p_ofdm.demodulate(_t(rx), 25)
    out_p = p_pbch.decode(g_p, p_chest.estimate(g_p, pcfg.cell, 0).ce, pcfg.cell)
    for got, ref in zip(out_p, mib_j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert out_p[3].all() and (out_p[2] == 0).all()
    np.testing.assert_array_equal(out_p[0].numpy(), mib)


def test_two_ue_grants_same_subframe():
    """tests/test_node_models.py's sf 4 subframe with two grants (QPSK and
    16QAM), decoded through the plain MAP and through the kernel path's
    plain version (use_kernel=True on CPU tensors): the same results."""
    jcell = j_grid.CellConfig(n_prb=25, cell_id=5, cfi=2)
    sf = 4
    g1 = tuple(1 if i < 8 else 0 for i in range(25))
    g2 = tuple(1 if 12 <= i < 25 else 0 for i in range(25))
    r1, r2 = 0x50, 0x51
    c1 = next(c for c in j_pdcch.candidates(jcell, r1, sf) if c[0] == 2)
    c2 = next(c for c in j_pdcch.candidates(jcell, r2, sf) if c[0] == 2 and c[1] != c1[1])
    tbs1 = (j_grid.nof_re(jcell, sf, g1) * 2 // 3) // 8 * 8
    tbs2 = (j_grid.nof_re(jcell, sf, g2) * 4 // 3) // 8 * 8
    jcfg = j_enb.DlSubframeConfig(cell=jcell, sf_idx=sf,
                                  grants=((r1, g1, 2, tbs1, *c1), (r2, g2, 4, tbs2, *c2)))
    pcfg = _port_config(jcfg)
    rng = np.random.default_rng(1)
    p1 = rng.integers(0, 2, (2, tbs1), dtype=np.int8)
    p2 = rng.integers(0, 2, (2, tbs2), dtype=np.int8)
    tx_j = np.asarray(jax.jit(lambda a, b: j_enb.build_subframe(jcfg, [a, b]))(p1, p2))
    tx_p = p_enb.build_subframe(pcfg, [_t(p1), _t(p2)])
    assert _rel_rms(tx_p, tx_j) < REL
    rx = _noisy(tx_j, 16.0, rng)
    res_j, _ = jax.jit(lambda x: j_ue.decode_subframe(x, jcfg))(rx)
    res_p, _ = p_ue.decode_subframe(_t(rx), pcfg)
    _assert_same_decode(res_p, res_j, 2)
    assert res_p.phich is None
    for gi, p in enumerate((p1, p2)):
        assert res_p.dci_found[:, gi].all() and res_p.crc_ok[gi].all()
        np.testing.assert_array_equal(res_p.payloads[gi].numpy(), p)
    res_k, _ = p_ue.decode_subframe(_t(rx), pcfg, use_kernel=True)
    _assert_same_decode(res_k, res_j, 2)


def test_build_subframe_takes_an_explicit_device():
    """With no payload and no MIB there is no tensor to take the device
    from: the caller names it, else build_subframe raises."""
    jcfg = j_enb.DlSubframeConfig(cell=j_grid.CellConfig(n_prb=6, cell_id=7, cfi=3), sf_idx=5)
    pcfg = _port_config(jcfg)
    with pytest.raises(ValueError, match="device"):
        p_enb.build_subframe(pcfg, [])
    tx_p = p_enb.build_subframe(pcfg, [], device="cpu")
    tx_j = np.asarray(jax.jit(lambda: j_enb.build_subframe(jcfg, []))())
    assert tx_p.shape == tx_j.shape == (1, p_ofdm.params(6)["sf_len"], 2)
    assert _rel_rms(tx_p, tx_j) < REL


def _planes(cell_kw):
    jdp = j_wavesim.WaveformDataPlane(j_grid.CellConfig(**cell_kw))
    pdp = p_wavesim.WaveformDataPlane(p_grid.CellConfig(**cell_kw), device="cpu")
    return jdp, pdp


def test_waveform_plane_send():
    """Bursts through `send` to each of two UEs, at 25 PRB: a strong link
    delivers every PDU (the JAX plane's bytes), a hopeless one none."""
    jdp, pdp = _planes(dict(n_prb=25, cell_id=1, cfi=1))
    for dp in (jdp, pdp):
        dp.add_ue(0x46, prb_mask=(1,) * 8 + (0,) * 17, qm=4)
        dp.add_ue(0x47, prb_mask=(0,) * 8 + (1,) * 8 + (0,) * 9, qm=2, cce_start=2)
    pdus = [bytes([i]) * (20 + 3 * i) for i in range(3)]
    out_j = jdp.send(0x46, pdus, pathloss_db=100.0)
    out_p = pdp.send(0x46, pdus, pathloss_db=100.0)
    assert [g for g, _ in out_p] == [g for g, _ in out_j] == pdus
    assert all(snr > 20.0 for _, snr in out_p)
    out_p = pdp.send(0x46, pdus[:2], pathloss_db=150.0)
    assert all(g is None for g, _ in out_p)
    out_p = pdp.send(0x47, [b"ue-b-packet" * 3], pathloss_db=105.0)  # the second slot
    assert [g for g, _ in out_p] == [b"ue-b-packet" * 3]
    assert pdp.metrics == {"sf_tx": 6, "crc_ok": 4, "crc_fail": 2}


def test_waveform_plane_send_tti():
    """Two UEs in shared subframes through `send_tti`, at 6 PRB, CCEs from
    each UE's search space; the shorter burst rides padding PDUs."""
    jdp, pdp = _planes(dict(n_prb=6, cell_id=3, cfi=2))
    rntis = [0x46, 0x47]
    alloc = j_pdcch.allocate_cces(jdp.cell, rntis, sf_idx=1)
    assert set(alloc) == set(rntis)
    for dp in (jdp, pdp):
        for u, r in enumerate(rntis):
            l, start = alloc[r]
            dp.add_ue(r, prb_mask=tuple(int(i // 3 == u) for i in range(6)), qm=4,
                      l_aggr=l, cce_start=start)
    pdus = {0x46: [b"\x46" * 10, b"\x01" * 6, b"\x02" * 3], 0x47: [b"\x47" * 8]}
    pl = {0x46: 95.0, 0x47: 100.0}
    out_j = jdp.send_tti(pdus, pl)
    out_p = pdp.send_tti(pdus, pl)
    for r in rntis:
        assert [g for g, _ in out_p[r]] == [g for g, _ in out_j[r]] == pdus[r]
    assert pdp.metrics == {"sf_tx": 4, "crc_ok": 4, "crc_fail": 0}
    pl[0x47] = 150.0  # deep fade on one UE only
    out_p = pdp.send_tti(pdus, pl)
    assert all(g is None for g, _ in out_p[0x47])
    assert [g for g, _ in out_p[0x46]] == pdus[0x46]


def test_waveform_plane_needs_a_card_by_default(monkeypatch):
    """The default device is the card: with none, the plane raises rather
    than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        p_wavesim.WaveformDataPlane(p_grid.CellConfig(n_prb=6))
