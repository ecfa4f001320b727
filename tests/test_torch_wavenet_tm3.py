"""PyTorch port vs the JAX package: the waveform network's 2x2 TM3
downlink (runtime/wavenet.py with mimo=True), in lockstep.

The network is tests/test_wavenet_mimo.py's `_net` (15 PRB, 70 dB) with
two UEs: UE 0's link matrix has singular-value ratio 1.0, UE 1's 0.05
(`mimo_cond`), so UE 0's RI probe reads rank 2 and UE 1's rank 1.  The eNB
transmits two port waveforms, each UE receives through its own 2x2 matrix
(drawn from numpy's default_rng(seed + 13) in both packages), reports RI on
PUCCH format 2 in the RI windows, and rank-2 grants carry two codewords on
DCI format 2A, decoded after a second blind search and ACKed with one
bundled bit.  The eNB reads each UE's format-2 report by DMRS energy, and
every format-2 resource sits in the same PRB pair, so a report sets the
rank of every UE whose resource it lights (the reference's adjudication,
copied): the preambles put UE 0's report last in each window, so both UEs
get rank-2 grants, and UE 1 decodes them too at this SNR.
The lockstep is tests/test_torch_wavenet.py's (`Lockstep`): every TTI the
states (the eNB MAC's RI per UE among them), metrics, SNR estimates and the
eNB's two port waveforms, and both pcaps byte for byte.  Then one subframe
alone: a rank-2 grant (the first shape the lockstep sent) through
`add_dl_grant_tm3`, the medium's 2x2 channel, `rx_front`, `blind_all2`,
`pdsch_rx_tm3` and `ri_probe`, on the lockstep's own cell kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srslte_emane_tpu.ops import ofdm as j_ofdm
from srslte_emane_tpu.phch import dci as j_dci, pbch as j_pbch, ra as j_ra
from srslte_emane_tpu_torch.phch import pdcch as p_pdcch
from srslte_emane_tpu_torch.runtime import wavenet as p_wn

from test_torch_wavenet import REL, SNR_TOL_DB, Lockstep, Noise, _rel_rms

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

TM3_NET = dict(n_ues=2, n_prb=15, pathloss=70.0, seed=0, imsi="00101000000001", preamble=12,
               step=-5)
COND = [1.0, 0.05]
TRAFFIC_SLABS = 3  # 20 TTIs each, 5 DL packets of 400 bytes per UE


@pytest.fixture(scope="module")
def tm3(tmp_path_factory):
    with pytest.MonkeyPatch.context() as m:
        ls = Lockstep(tmp_path_factory.mktemp("tm3"), m, TM3_NET, mimo=True, mimo_cond=COND)
        j, p, rec = ls.j, ls.p, ls.rec
        rec["grants"] = []  # the port's rank-2 grants: (sf, rb, l, mcs1, mcs2, l_aggr)
        add = p.net.kern.add_dl_grant_tm3

        def add_dl_grant_tm3(grid, grid_p1, sf, rb, l, mcs1, mcs2, l_aggr, *a):
            rec["grants"].append((sf, rb, l, mcs1, mcs2, l_aggr))
            return add(grid, grid_p1, sf, rb, l, mcs1, mcs2, l_aggr, *a)

        m.setattr(p.net.kern, "add_dl_grant_tm3", add_dl_grant_tm3)
        ls.attach()
        rec["dl_before"] = [[len(u.gw_rx) for u in s.ues] for s in (j, p)]
        for _ in range(TRAFFIC_SLABS):
            ls.offer(b"m" * 400, n_dl=5)
            ls.step(20)
        rec["ue_ri"] = [[u._ri for u in s.net.ues] for s in (j, p)]
        rec["gw_rx"] = [[list(u.gw_rx) for u in s.ues] for s in (j, p)]
        rec["spgw"] = [dict(s.spgw.metrics) for s in (j, p)]
        rec["pcaps"] = ls.pcaps()
        rec["sides"] = (j, p)
        yield rec
    jax.clear_caches()


def test_tm3_attach_registers(tm3):
    assert tm3["registered"] == [[True, True], [True, True]]


def test_states_and_metrics_equal_every_tti(tm3):
    assert not tm3["mismatch"], tm3["mismatch"][:3]


def test_port_waveforms_close_every_tti(tm3):
    rr = tm3["rel_rms"]
    assert len(rr) == tm3["paced"] and max(rr) < REL, max(rr)


def test_snr_estimates_within_tolerance(tm3):
    d = [p - j for js, ps in tm3["snr"] for j, p in zip(js, ps) if j is not None]
    assert len(d) > 100 and max(abs(x) for x in d) <= SNR_TOL_DB, (min(d), max(d))


def test_ri_rank2_grants_and_both_codewords(tm3):
    """UE 0 probes rank 2, UE 1 (ratio 0.05) rank 1; RI reports reach the
    MAC; rank-2 grants go out on DCI 2A and both codewords decode."""
    j, p = tm3["sides"]
    assert tm3["ue_ri"] == [[2, 1], [2, 1]]
    assert p.enb.metrics.get("ri_reports", 0) >= 2
    n_tm3 = p.net.enb.metrics.get("tm3_tx", 0)
    assert n_tm3 >= 2 and len(tm3["grants"]) == n_tm3
    assert sum(u.metrics["tb_err"] for u in p.net.ues) == 0
    assert p.net.enb.metrics == j.net.enb.metrics


def test_ip_packets_and_pcaps_equal(tm3):
    gj, gp = tm3["gw_rx"]
    assert gj == gp and tm3["spgw"][0] == tm3["spgw"][1]
    assert all(len(rx) - n0 >= 15 for rx, n0 in zip(gp, tm3["dl_before"][1]))
    jp, pp = tm3["pcaps"]
    assert len(jp) > 40 and jp == pp


def test_one_rank2_subframe(tm3):
    """One rank-2 grant through both packages' calls on the same numpy
    inputs (the lockstep's cell kernels, so the reference's are compiled
    already): the port grids within REL, the medium's 2x2 channel, the UE's
    front end on both antennas, the format-2A blind search (bits and
    residues equal, the DCI found at its CCE), both codewords decoded
    bit-exact, and the RI probe's singular-value ratio of each link."""
    j, p = tm3["sides"]
    jk, pk = j.net.kern, p.net.kern
    sf, rb, l, mcs1, mcs2, l_aggr = tm3["grants"][0]
    n_prb, rnti, cce = 15, 0x4a, 0
    rng = np.random.default_rng(8)
    tbs = [j_ra.dl_tbs(mcs, l) for mcs in (mcs1, mcs2)]
    tb1, tb2 = (rng.integers(0, 2, (1, t), dtype=np.int8) for t in tbs)
    mask, p_ = j_ra.type2_to_prb_mask(rb, l, n_prb), j_ra.rbg_size(n_prb)
    n_rbg = -(-n_prb // p_)
    bitmap = sum(1 << (n_rbg - 1 - gi) for gi in range(n_rbg)
                 if all(mask[i] for i in range(gi * p_, min((gi + 1) * p_, n_prb))))
    assert j_ra.type0_to_prb_mask(bitmap, n_prb) == tuple(mask)
    d = j_dci.DciDl2("2A", rbg_bitmap=bitmap, harq_pid=3, mcs1=mcs1, ndi1=1, rv1=0, mcs2=mcs2)
    bits = j_dci.pack_dl_2(d, n_prb)[None]
    g0 = pk.base_grid(sf, -1, None).numpy()  # PSS/SSS, port-0 CRS, PCFICH
    g1 = pk.base_grid_p1(sf).numpy()  # port-1 CRS
    fn, _ = jk.add_dl_grant_tm3(sf, rb, l, mcs1, mcs2, l_aggr)
    jg = fn(jnp.asarray(g0), jnp.asarray(g1), jnp.asarray(bits), jnp.asarray(tb1),
            jnp.asarray(tb2), jnp.asarray(rnti, jnp.int32), jnp.asarray(cce, jnp.int32))
    pg = pk.add_dl_grant_tm3(torch.from_numpy(g0), torch.from_numpy(g1), sf, rb, l, mcs1, mcs2,
                             l_aggr, bits, tb1, tb2, rnti, cce)
    for a, b in zip(jg, pg):
        assert _rel_rms(b.numpy(), np.asarray(a)) < REL
    # both port waveforms through the medium's channel (the lockstep's
    # matrices) with one numpy noise draw
    tx = np.array(jk.modulate()(jnp.concatenate(jg, axis=0)))
    noise = Noise(4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", noise.jax_normal)
        mp.setattr(p_wn, "_randn", noise.port_randn)
        for s, arr in ((j, jnp.asarray), (p, torch.from_numpy)):
            s.net.medium.dl_put(sf, arr(tx))
        ys = [np.array(s.net.medium.dl_take_all()) for s in (j, p)]
    assert _rel_rms(ys[1], ys[0]) < REL
    y = ys[0]  # (2 UEs, 2 rx, T, 2): the same samples into both receivers
    flat = y.reshape((4,) + y.shape[2:])
    jrg, jce, jsnr, _, _ = jk.rx_front(sf)(jnp.asarray(flat))
    prg, pce, psnr, _ = pk.rx_front(torch.from_numpy(flat), sf)
    assert _rel_rms(prg.numpy(), np.asarray(jrg)) < REL
    np.testing.assert_allclose(psnr.numpy(), np.asarray(jsnr), atol=SNR_TOL_DB)
    jfn, jpos = jk.blind_all2(sf)
    jb, jr = (np.asarray(v) for v in jfn(jrg[0::2], jce[0::2]))
    pb, pr, ppos = pk.blind_all2(prg[0::2], pce[0::2], sf)
    assert list(ppos) == list(jpos)
    np.testing.assert_array_equal(pb.numpy(), jb)
    np.testing.assert_array_equal(pr.numpy(), jr)
    hits = [i for i, c in enumerate(ppos) if c == (l_aggr, cce) and pr[0, i] == rnti]
    assert hits and (pb[0, hits[0]].numpy() == bits[0]).all()
    for u in range(2):
        jout = jk.pdsch_rx_tm3(sf, rb, l, mcs1, mcs2)(jrg[2 * u : 2 * u + 2][None],
                                                      jnp.asarray(rnti, jnp.int32))
        pout = pk.pdsch_rx_tm3(prg[2 * u : 2 * u + 2][None], sf, rb, l, mcs1, mcs2, rnti)
        for a, b in zip(jout, pout):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert bool(pout[2][0]) and bool(pout[3][0]), u  # 64 dB: both decode
        np.testing.assert_array_equal(pout[0].numpy(), tb1)
        np.testing.assert_array_equal(pout[1].numpy(), tb2)
        jratio, js1 = jk.ri_probe(sf)(jrg[2 * u : 2 * u + 2][None])
        pratio, ps1 = pk.ri_probe(prg[2 * u : 2 * u + 2][None], sf)
        # near equal singular values the ratio rests on sqrt(tr^2 - 4 det),
        # whose f32 rounding is of order sqrt(2^-23) ~ 3.5e-4 of tr
        np.testing.assert_allclose([float(pratio), float(ps1)], [float(jratio), float(js1)],
                                   atol=1e-3)
        assert (float(pratio) > 0.3) == (COND[u] > 0.3), (u, float(pratio))
    assert p_pdcch.n_cce(pk.cell) > cce


def test_pbch_of_the_2_port_cell_rides_port_0_alone(tm3):
    """A fault of the reference, which the port keeps: in MIMO mode the eNB
    sends the PBCH from port 0 alone but with the 2-port CRC mask, which the
    UE checks on its SFBC hypothesis (ports 0 and 1 combined) only.  So an
    antenna that hears port 1 well above port 0 never decodes the MIB: in
    both packages a noise-free subframe 0 decodes through the row
    [0.70, 0.71] and fails through [0.26, 0.97] (two of the eight UEs of
    chip_smoke.py phase 13c draw such a row)."""
    j, p = tm3["sides"]
    jk, pk = j.net.kern, p.net.kern
    mib = j_pbch.pack_mib(15, 8)[None].astype(np.int8)
    g = [pk.base_grid(0, 0, mib), pk.base_grid_p1(0)]
    tx = p_wn.ofdm.modulate(torch.cat(g), 15).numpy()
    got = []
    for row in ([0.70, 0.71], [0.26, 0.97]):
        y = np.einsum("p,ptc->tc", np.asarray(row, np.float32), tx)[None]
        jok = np.asarray(jk.pbch_rx()(j_ofdm.demodulate(jnp.asarray(y), 15))[3])
        pok = pk.pbch_rx(p_wn.ofdm.demodulate(torch.from_numpy(y), 15))[3].numpy()
        got.append((bool(jok[0]), bool(pok[0])))
    assert got == [(True, True), (False, False)], got
