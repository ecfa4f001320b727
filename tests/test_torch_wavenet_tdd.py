"""PyTorch port vs the JAX package: the waveform network in TDD
(runtime/wavenet.py with tdd_config=1, ss_config=4), in lockstep.

The network is tests/test_wavenet_tdd.py's (15 PRB, 1 UE at 70 dB,
configuration 1 = DSUUDDSUUD, special subframe 4: DwPTS 12 symbols).  The
eNB radiates nothing on U subframes and silences the S subframe past DwPTS,
PDSCH in S is DwPTS-truncated, the UE transmits on U subframes only (PRACH
in subframe 2), DCI-0 rides the subframes with a PUSCH k-association and
HARQ-ACKs arrive, AND-bundled, on the next U subframe.  The lockstep is
tests/test_torch_wavenet.py's (`Lockstep`): every TTI the states, metrics,
SNR estimates and the eNB's DL samples (zero on U subframes in both), and
both pcaps byte for byte.  After the attach, IP traffic rides TRAFFIC_SLABS
slabs of 20 TTIs, each with 6 DL packets of 300 bytes and one UL packet,
as the reference test offers them (it offers 12 per slab, over 10 slabs).
"""

import jax
import numpy as np
import pytest
import torch

from srslte_emane_tpu_torch.phch import tdd as p_tdd

from test_torch_wavenet import REL, SNR_TOL_DB, Lockstep

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

CFG = 1
TDD_NET = dict(n_ues=1, n_prb=15, pathloss=70.0, seed=0, imsi="00101000000000", preamble=7,
               step=0)
TRAFFIC_SLABS = 3


@pytest.fixture(scope="module")
def tdd(tmp_path_factory):
    with pytest.MonkeyPatch.context() as m:
        ls = Lockstep(tmp_path_factory.mktemp("tdd"), m, TDD_NET, tdd_config=CFG, ss_config=4)
        j, p, rec = ls.j, ls.p, ls.rec
        # tests/test_wavenet_tdd.py's instruments, on both networks: UE
        # transmissions on non-U subframes, TBs decoded in S subframes
        rec["bad_sf_tx"] = [0, 0]
        rec["s_sf_tb_ok"] = [0, 0]
        for k, side in enumerate((j, p)):
            put, tb = side.net.medium.ul_put, side.ues[0].tb_decoded

            def ul_put(tti, ue_idx, samples, is_prach=False, put=put, k=k):
                rec["bad_sf_tx"][k] += p_tdd.sf_type(CFG, tti % 10) != "U"
                return put(tti, ue_idx, samples, is_prach)

            def tb_decoded(tti, payload, snr, tb=tb, k=k, **kw):
                if payload is not None and p_tdd.sf_type(CFG, tti % 10) == "S":
                    rec["s_sf_tb_ok"][k] += 1
                return tb(tti, payload, snr, **kw)

            m.setattr(side.net.medium, "ul_put", ul_put)
            m.setattr(side.ues[0], "tb_decoded", tb_decoded)
        ls.attach()
        rec["dl_before"] = [sum(len(x) for x in s.ues[0].gw_rx) for s in (j, p)]
        for _ in range(TRAFFIC_SLABS):
            ls.offer(b"d" * 300, n_dl=6, ul=b"u" * 120)
            ls.step(20)
        rec["gw_rx"] = [[list(u.gw_rx) for u in s.ues] for s in (j, p)]
        rec["spgw"] = [dict(s.spgw.metrics) for s in (j, p)]
        rec["enb_mac"] = [dict(s.enb.metrics) for s in (j, p)]
        rec["pcaps"] = ls.pcaps()
    yield rec
    jax.clear_caches()


def test_tdd_attach_registers(tdd):
    assert tdd["registered"] == [[True], [True]]


def test_states_and_metrics_equal_every_tti(tdd):
    assert not tdd["mismatch"], tdd["mismatch"][:3]


def test_dl_samples_close_every_tti(tdd):
    """U subframes are silent in both (_rel_rms is 0 only if the port's is
    silent too); D and S within REL."""
    rr = tdd["rel_rms"]
    assert len(rr) == tdd["paced"] and max(rr) < REL, max(rr)
    assert rr.count(0.0) >= 0.3 * len(rr)  # 4 U subframes in 10 (and no TB is exact)


def test_snr_estimates_within_tolerance(tdd):
    d = [p - j for js, ps in tdd["snr"] for j, p in zip(js, ps) if j is not None]
    assert len(d) > 50 and max(abs(x) for x in d) <= SNR_TOL_DB, (min(d), max(d))


def test_tdd_gates_of_the_reference_test(tdd):
    """tests/test_wavenet_tdd.py's gates, on the port, equal on both sides:
    no UE transmission off a U subframe, DwPTS-truncated TBs decoded in S
    subframes, UL delivered and DL ACKed."""
    assert tdd["bad_sf_tx"] == [0, 0]
    assert tdd["s_sf_tb_ok"][0] == tdd["s_sf_tb_ok"][1] >= 1
    sj, sp = tdd["spgw"]
    assert sj == sp and sp["ul_bytes"] > 200
    mj, mp = tdd["enb_mac"]
    assert mj == mp and mp.get("dl_ack", 0) >= 3


def test_ip_packets_and_pcaps_equal(tdd):
    gj, gp = tdd["gw_rx"]
    assert gj == gp
    assert sum(len(x) for x in gp[0]) - tdd["dl_before"][1] > 2000
    jp, pp = tdd["pcaps"]
    assert len(jp) > 20 and jp == pp
