"""The waveform network's stages as the reference jits them
(runtime/wavenet.py `_CellKernels`): one graph per static key, with rnti,
cce_start, rb_start, sf and the RE index table as device inputs.

On the CPU (the stages run eagerly there, on the tensor path a CUDA graph
captures): the four stages that the reference traces by position,
add_dl_grant, pdsch_rx, pusch_tx and pusch_rx (and the PUSCH stages with an
aperiodic CQI report), against the JAX `_CellKernels` stages on the same
numpy inputs, at 2 subframes and 2 rb_starts per key, so that JAX compiles
each key once; grids and samples to the lockstep's relative RMS (REL of
tests/test_torch_wavenet.py, the reference's DFT swapped for an f32 FFT as
there), bits and CRC flags exactly.  Then every PHY call and stage with 0-d
tensor arguments against the same call with ints, bit for bit: chest at all
10 subframes, the scrambling sequences, pdcch.encode_dyn, pdsch and pusch
encode and decode (UCI too), and each stage with position inputs.

On the card (`cuda`): a 4-UE network at 25 PRB graphed against the same
network with jit=False, in lockstep over the attach and 20 TTIs of traffic
(DL and UL samples of every TTI, the stacks' metrics, the pcap bytes), and
the graphs per key family.  The JAX package is imported only by the CPU
tests' fixtures, so the card (which has no jax) runs this file with
`--noconftest -m cuda`.
"""

import types

import numpy as np
import pytest
import torch

from srslte_emane_tpu_torch.ops import ofdm as p_ofdm, scrambling as p_scr
from srslte_emane_tpu_torch.phch import chest as p_chest, grid as p_grid, pdcch as p_pdcch
from srslte_emane_tpu_torch.phch import pdsch as p_pdsch, pusch as p_pusch, ra as p_ra
from srslte_emane_tpu_torch.phch import sch as p_sch
from srslte_emane_tpu_torch.runtime import wavenet as p_wn

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

CELL = dict(n_prb=6, cell_id=1, cfi=2)
DL_KEY = dict(l_crbs=3, mcs=4, l_aggr=2)  # add_dl_grant / pdsch_rx
UL_KEY = dict(l_prb=2, mcs=6)  # pusch_tx / pusch_rx
N_CQI = 4  # the aperiodic report's bits at 6 PRB (a wideband CQI)
# (sf, rb_start): 2 subframes x 2 positions of one key each (sf 1 and 6
# carry no PSS/SSS/PBCH, so the DL positions share their RE count)
DL_AT = [(1, 0), (1, 3), (6, 0), (6, 3)]
UL_AT = [(2, 1), (2, 3), (7, 1), (7, 3)]
RNTI, CCE = 0x4A, 2
SNR_DB = 30.0


def _cell():
    return p_grid.CellConfig(**CELL)


def _t0(v):
    """A 0-d int64 tensor: the graph's input for a number."""
    return torch.tensor(v)


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if a is None:
        return b is None
    return torch.equal(a, b)


def _dl_inputs(sf, rb, seed):
    """(grid (1, 14, NRE, 2), DCI bits, TB bits) for a grant at (sf, rb)."""
    cell = _cell()
    rng = np.random.default_rng(seed)
    kern = p_wn._CellKernels(cell, device="cpu")
    grid = kern.base_grid(sf, -1)(np.zeros((1, 24), np.int8)).numpy()
    dci = rng.integers(0, 2, (1, kern.dci_len), dtype=np.int8)
    tbs = p_ra.dl_tbs(DL_KEY["mcs"], DL_KEY["l_crbs"])
    return grid, dci, rng.integers(0, 2, (1, tbs), dtype=np.int8)


def _noisy(x, seed, snr_db=SNR_DB):
    rng = np.random.default_rng(seed)
    x = np.asarray(x, np.float32)
    p = float(np.mean(x.astype(np.float64) ** 2)) or 1.0
    return (x + rng.standard_normal(x.shape) * np.sqrt(p / 10 ** (snr_db / 10))).astype(np.float32)


# ---------------- against the JAX stages ----------------

@pytest.fixture(scope="module")
def jax_stages():
    """The JAX `_CellKernels` of the 6 PRB cell and the lockstep's helpers,
    its DFT an f32 FFT (tests/test_torch_wavenet.py `_dft_f32`) while the
    module's stages compile; each stage key compiles once."""
    import jax

    from srslte_emane_tpu.ops import dft as j_dft
    from srslte_emane_tpu.phch import grid as j_grid
    from srslte_emane_tpu.runtime import wavenet as j_wn
    from test_torch_wavenet import REL, _dft_f32, _rel_rms

    with pytest.MonkeyPatch.context() as m:
        m.setattr(j_dft, "dft", _dft_f32)
        jax.clear_caches()
        yield types.SimpleNamespace(k=j_wn._CellKernels(j_grid.CellConfig(**CELL)), REL=REL,
                                    rel=_rel_rms)
    jax.clear_caches()


def _j(*a):
    import jax.numpy as jnp

    return [jnp.asarray(x, jnp.int32) if isinstance(x, int) else jnp.asarray(x) for x in a]


@pytest.mark.parametrize("sf,rb", DL_AT)
def test_add_dl_grant_matches_jax(jax_stages, sf, rb):
    jk, pk = jax_stages.k, p_wn._CellKernels(_cell(), device="cpu")
    j_idx = jk.dl_re_idx(sf, rb, DL_KEY["l_crbs"])
    p_idx = pk.dl_re_idx(sf, rb, DL_KEY["l_crbs"])
    np.testing.assert_array_equal(p_idx.numpy(), j_idx)
    grid, dci, tb = _dl_inputs(sf, rb, seed=sf + 10 * rb)
    key = (DL_KEY["l_crbs"], DL_KEY["mcs"], DL_KEY["l_aggr"], len(j_idx))
    jfn, jtbs = jk.add_dl_grant(*key)
    pfn, ptbs = pk.add_dl_grant(*key)
    assert jtbs == ptbs == tb.shape[1]
    want = np.asarray(jfn(*_j(grid, dci, tb, RNTI, CCE, j_idx, sf)))
    got = pfn(grid, dci, tb, RNTI, CCE, p_idx, sf).numpy()
    assert jax_stages.rel(got, want) < jax_stages.REL


@pytest.mark.parametrize("sf,rb", DL_AT)
def test_pdsch_rx_matches_jax(jax_stages, sf, rb):
    jk, pk = jax_stages.k, p_wn._CellKernels(_cell(), device="cpu")
    j_idx = jk.dl_re_idx(sf, rb, DL_KEY["l_crbs"])
    grid, dci, tb = _dl_inputs(sf, rb, seed=sf + 10 * rb)
    key = (DL_KEY["l_crbs"], DL_KEY["mcs"], DL_KEY["l_aggr"], len(j_idx))
    tx = pk.add_dl_grant(*key)[0](grid, dci, tb, RNTI, CCE, pk.dl_re_idx(sf, rb, 3), sf)
    rg = _noisy(tx.numpy(), seed=sf * rb + 1)
    jb, jok = (np.asarray(v) for v in jk.pdsch_rx(*key[:2], key[3])(*_j(rg, RNTI, j_idx, sf)))
    pb, pok = pk.pdsch_rx(*key[:2], key[3])(torch.from_numpy(rg), RNTI,
                                            pk.dl_re_idx(sf, rb, 3), sf)
    np.testing.assert_array_equal(pb.numpy(), jb)
    np.testing.assert_array_equal(pok.numpy(), jok)
    assert bool(pok[0]) and (pb.numpy() == tb).all()


def _ul_bits(sf, rb, cqi):
    rng = np.random.default_rng(100 + sf + 10 * rb)
    tbs = p_ra.ul_tbs(UL_KEY["mcs"], UL_KEY["l_prb"])
    bits = rng.integers(0, 2, (1, tbs), dtype=np.int8)
    return bits, rng.integers(0, 2, (1, N_CQI), dtype=np.int8) if cqi else None


@pytest.mark.parametrize("cqi", [False, True], ids=["pusch", "pusch_cqi"])
@pytest.mark.parametrize("sf,rb", UL_AT)
def test_pusch_tx_and_rx_match_jax(jax_stages, sf, rb, cqi):
    jk, pk = jax_stages.k, p_wn._CellKernels(_cell(), device="cpu")
    l_prb, mcs = UL_KEY["l_prb"], UL_KEY["mcs"]
    bits, cqi_bits = _ul_bits(sf, rb, cqi)
    if cqi:
        (jfn, jtbs), (pfn, ptbs) = (k.pusch_tx_cqi(l_prb, mcs, N_CQI) for k in (jk, pk))
        want = np.asarray(jfn(*_j(bits, cqi_bits, RNTI, rb, sf)))
        got = pfn(bits, cqi_bits, RNTI, rb, sf).numpy()
    else:
        (jfn, jtbs), (pfn, ptbs) = (k.pusch_tx(l_prb, mcs) for k in (jk, pk))
        want = np.asarray(jfn(*_j(bits, RNTI, rb, sf)))
        got = pfn(bits, RNTI, rb, sf).numpy()
    assert jtbs == ptbs == bits.shape[1]
    assert jax_stages.rel(got, want) < jax_stages.REL
    rx = _noisy(want, seed=sf + rb)
    rg = pk.demodulate()(rx)
    if cqi:
        jout = jk.pusch_rx_cqi(l_prb, mcs, N_CQI)(*_j(rx, RNTI, rb, sf))
        pout = pk.pusch_rx_cqi(l_prb, mcs, N_CQI)(rg, RNTI, rb, sf)
        np.testing.assert_array_equal(pout[2].numpy(), np.asarray(jout[2]))
        np.testing.assert_array_equal(pout[2].numpy(), cqi_bits)
    else:
        jout = jk.pusch_rx(l_prb, mcs)(*_j(rx, RNTI, rb, sf))
        pout = pk.pusch_rx(l_prb, mcs)(rg, RNTI, rb, sf)
    for a, b in zip(pout[:2], jout[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool(pout[1][0]) and (pout[0].numpy() == bits).all()


# ---------------- tensor arguments against ints ----------------

@pytest.mark.parametrize("port", [0, 1])
@pytest.mark.parametrize("sf", range(10))
def test_chest_tensor_sf_equals_int(sf, port):
    cell = p_grid.CellConfig(n_prb=6, cell_id=1, cfi=2, n_ports=2)
    rg = torch.from_numpy(np.random.default_rng(sf).standard_normal(
        (2, 14, cell.nre, 2)).astype(np.float32))
    assert _equal(tuple(p_chest.estimate(rg, cell, _t0(sf), port)),
                  tuple(p_chest.estimate(rg, cell, sf, port)))


@pytest.mark.parametrize("q", [0, 1])
@pytest.mark.parametrize("rnti,sf", [(0x46, 0), (0xFFFF, 9), (0x14D, 4)])
def test_scrambling_tensor_cinit_equals_the_cached_int(rnti, sf, q):
    bits = torch.from_numpy(np.random.default_rng(rnti).integers(0, 2, (1, 1000), dtype=np.int8))
    for c_int, c_t in ((p_scr.pdsch_cinit(rnti, q, sf, 1), p_scr.pdsch_cinit(_t0(rnti), q, _t0(sf), 1)),
                       (p_scr.pusch_cinit(rnti, sf, 1), p_scr.pusch_cinit(_t0(rnti), _t0(sf), 1))):
        assert isinstance(c_int, int) and isinstance(c_t, torch.Tensor) and int(c_t) == c_int
        assert torch.equal(p_scr.scramble_bits(bits, c_t), p_scr.scramble_bits(bits, c_int))
        llr = bits.float() - 0.5
        assert torch.equal(p_scr.scramble_llrs(llr, c_t), p_scr.scramble_llrs(llr, c_int))


@pytest.mark.parametrize("sf,l_aggr,cce", [(0, 1, 3), (3, 2, 2), (7, 4, 0), (9, 8, 0)])
def test_pdcch_encode_dyn_tensors_equal_encode(sf, l_aggr, cce):
    cell = p_grid.CellConfig(n_prb=15, cell_id=1, cfi=3)
    rng = np.random.default_rng(sf)
    grid = torch.from_numpy(rng.standard_normal((1, 14, cell.nre, 2)).astype(np.float32))
    dci = torch.from_numpy(rng.integers(0, 2, (1, 25), dtype=np.int8))
    want = p_pdcch.encode(dci, RNTI, l_aggr, cce, cell, sf, grid)
    for args in ((_t0(RNTI), _t0(cce), _t0(sf)), (RNTI, cce, sf)):
        got = p_pdcch.encode_dyn(dci, args[0], l_aggr, args[1], cell, args[2], grid)
        assert torch.equal(got, want)


def _dl_cfg(cell, sf, rb, l_crbs, mcs, max_sym=0):
    mask = p_ra.type2_to_prb_mask(rb, l_crbs, cell.n_prb)
    qm = p_ra.dl_mcs_to_qm(mcs)
    n_re = p_grid.nof_re(cell, sf, mask, max_sym)
    return mask, p_sch.SchConfig(tbs=p_ra.dl_tbs(mcs, l_crbs), G=n_re * qm, Qm=qm, Nl=1)


@pytest.mark.parametrize("sf,rb,l_crbs,max_sym", [(0, 0, 6, 0), (5, 1, 3, 0), (1, 2, 4, 0),
                                                  (1, 0, 6, 12)])
def test_pdsch_tensor_inputs_equal_ints(sf, rb, l_crbs, max_sym):
    cell = _cell()
    mask, cfg = _dl_cfg(cell, sf, rb, l_crbs, 6, max_sym)
    rng = np.random.default_rng(sf + rb)
    tb = torch.from_numpy(rng.integers(0, 2, (1, cfg.tbs), dtype=np.int8))
    grid = torch.from_numpy(rng.standard_normal((1, 14, cell.nre, 2)).astype(np.float32))
    re_idx = p_pdsch._re_table(cell, sf, mask, torch.device("cpu"), max_sym)
    want = p_pdsch.encode(tb, cfg, cell, sf, RNTI, mask, grid=grid, max_sym=max_sym)
    got = p_pdsch.encode(tb, cfg, cell, _t0(sf), _t0(RNTI), None, grid=grid, re_idx=re_idx)
    assert torch.equal(got, want)
    rx = torch.from_numpy(_noisy(want.numpy(), seed=sf))
    want = p_pdsch.decode(rx, cfg, cell, sf, RNTI, mask, max_sym=max_sym)
    got = p_pdsch.decode(rx, cfg, cell, _t0(sf), _t0(RNTI), None, re_idx=re_idx)
    assert _equal(tuple(got[:2]) + tuple(got[3]), tuple(want[:2]) + tuple(want[3]))
    assert bool(got[1][0])


@pytest.mark.parametrize("n_cqi", [0, 4, 11, 20])
@pytest.mark.parametrize("sf,rb,l_prb", [(0, 0, 4), (3, 1, 3), (9, 9, 6)])
def test_pusch_tensor_inputs_equal_ints(sf, rb, l_prb, n_cqi):
    cell = p_grid.CellConfig(n_prb=15, cell_id=7, cfi=2)
    qm = 4
    _, _, q_cqi, g_data = p_pusch.uci_dims(l_prb, qm, 0, 0, n_cqi)
    cfg = p_sch.SchConfig(tbs=p_ra.ul_tbs(12, l_prb), G=g_data, Qm=qm, Nl=1)
    rng = np.random.default_rng(sf + rb + n_cqi)
    tb = torch.from_numpy(rng.integers(0, 2, (1, cfg.tbs), dtype=np.int8))
    uci = dims = None
    if n_cqi:
        uci = dict(cqi=torch.from_numpy(rng.integers(0, 2, (1, n_cqi), dtype=np.int8)))
        dims = (0, 0, q_cqi, 0, 0, n_cqi)
    t = (_t0(sf), _t0(RNTI), _t0(rb))
    want = p_pusch.encode(tb, cfg, cell, sf, RNTI, rb, l_prb, uci=uci)
    assert torch.equal(p_pusch.encode(tb, cfg, cell, t[0], t[1], t[2], l_prb, uci=uci), want)
    rx = torch.from_numpy(_noisy(want.numpy(), seed=rb))
    assert _equal(p_pusch.estimate_ul(rx, cell, t[0], t[2], l_prb),
                  p_pusch.estimate_ul(rx, cell, sf, rb, l_prb))
    want = p_pusch.decode(rx, cfg, cell, sf, RNTI, rb, l_prb, uci_dims_in=dims)
    got = p_pusch.decode(rx, cfg, cell, t[0], t[1], t[2], l_prb, uci_dims_in=dims)
    assert _equal(got, want)
    ok = got["ok"] if n_cqi else got[1]
    assert bool(ok[0])


def _kern(**kw):
    cell = p_grid.CellConfig(**{**CELL, "n_prb": 15, **kw})
    return p_wn._CellKernels(cell, n_pucch_res=40, n_f2_res=4, f2_base=36, n_cce=10,
                             device="cpu")


@pytest.mark.parametrize("sf,rb,l_crbs,l_aggr,cce", [(1, 0, 4, 1, 5), (5, 7, 8, 2, 4),
                                                     (0, 11, 4, 2, 0)])
def test_dl_stages_with_tensor_inputs_equal_the_int_path(sf, rb, l_crbs, l_aggr, cce):
    """add_dl_grant and pdsch_rx as the graph captures them (0-d tensor
    inputs) against pdcch.encode + pdsch.encode / pdsch.decode on ints."""
    k = _kern()
    cell, mcs = k.cell, 10
    re_idx = k.dl_re_idx(sf, rb, l_crbs)
    mask, cfg = _dl_cfg(cell, sf, rb, l_crbs, mcs)
    fn, tbs = k.add_dl_grant(l_crbs, mcs, l_aggr, len(re_idx))
    rng = np.random.default_rng(sf)
    grid = k.base_grid(sf, -1)(np.zeros((1, 24), np.int8))
    dci = rng.integers(0, 2, (1, k.dci_len), dtype=np.int8)
    tb = rng.integers(0, 2, (1, tbs), dtype=np.int8)
    got = fn(grid, dci, tb, _t0(RNTI), _t0(cce), re_idx, _t0(sf))
    g = p_pdcch.encode(torch.from_numpy(dci), RNTI, l_aggr, cce, cell, sf, grid)
    want = p_pdsch.encode(torch.from_numpy(tb), cfg, cell, sf, RNTI, mask, grid=g)
    assert torch.equal(got, want)
    rx = torch.from_numpy(_noisy(want.numpy(), seed=rb))
    got = k.pdsch_rx(l_crbs, mcs, len(re_idx))(rx, _t0(RNTI), re_idx, _t0(sf))
    want = p_pdsch.decode(rx, cfg, cell, sf, RNTI, mask)[:2]
    assert _equal(got, want) and bool(got[1][0])


@pytest.mark.parametrize("sf,rb,l_prb,n_cqi", [(2, 2, 3, 0), (8, 5, 5, 0), (4, 3, 4, 20)])
def test_ul_stages_with_tensor_inputs_equal_the_int_path(sf, rb, l_prb, n_cqi):
    """pusch_tx(_cqi) and pusch_rx(_cqi) with 0-d tensor inputs against
    pusch.encode / decode on ints; pucch_tx's resource as a tensor against
    its int row."""
    k, mcs = _kern(), 12
    cfg, q_cqi = k._ul_cfg(l_prb, mcs, n_cqi)
    rng = np.random.default_rng(sf)
    bits = rng.integers(0, 2, (1, cfg.tbs), dtype=np.int8)
    t = (_t0(RNTI), _t0(rb), _t0(sf))
    if n_cqi:
        cqi = rng.integers(0, 2, (1, n_cqi), dtype=np.int8)
        got = k.pusch_tx_cqi(l_prb, mcs, n_cqi)[0](bits, cqi, *t)
        uci = dict(cqi=torch.from_numpy(cqi))
    else:
        got, uci = k.pusch_tx(l_prb, mcs)[0](bits, *t), None
    g = p_pusch.encode(torch.from_numpy(bits), cfg, k.cell, sf, RNTI, rb, l_prb, uci=uci)
    assert torch.equal(got, p_ofdm.modulate(g, k.cell.n_prb))
    rg = p_ofdm.demodulate(torch.from_numpy(_noisy(got.numpy(), seed=sf)), k.cell.n_prb)
    if n_cqi:
        got = k.pusch_rx_cqi(l_prb, mcs, n_cqi)(rg, *t)
        out = p_pusch.decode(rg, cfg, k.cell, sf, RNTI, rb, l_prb,
                             uci_dims_in=(0, 0, q_cqi, 0, 0, n_cqi))
        want = (out["payload"], out["ok"], out["cqi"])
    else:
        got = k.pusch_rx(l_prb, mcs)(rg, *t)
        want = p_pusch.decode(rg, cfg, k.cell, sf, RNTI, rb, l_prb)[:2]
    assert _equal(got, want) and bool(got[1][0])
    d0 = np.array([[-1.0, 0.0]], np.float32)
    wd, wx = p_wn._pucch_wf(k.cell, k.n_pucch_res, sf, torch.device("cpu"))
    want = wd[rb][None] + p_wn.cplx.mul(torch.from_numpy(d0)[:, None, :], wx[rb][None])
    assert torch.equal(k.pucch_tx(sf)(_t0(rb), d0), want)


@pytest.mark.parametrize("sf,rb,l_aggr,cce", [(1, 0, 2, 2), (6, 4, 1, 4)])
def test_tm3_and_ul_dci_stages_with_tensor_inputs_equal_the_int_path(sf, rb, l_aggr, cce):
    """add_dl_grant_tm3 and add_ul_dci with 0-d tensor rnti / cce_start
    against pdcch.encode + pdsch.encode_tm on ints; pdsch_rx_tm3 with a
    tensor rnti against pdsch.decode_tm."""
    k = _kern(n_ports=2)
    cell, l_crbs, mcs = k.cell, 4, (10, 8)
    rng = np.random.default_rng(rb)
    g0 = k.base_grid(sf, -1)(np.zeros((1, 24), np.int8))
    g1 = k.base_grid_p1(sf)
    dci = rng.integers(0, 2, (1, 30), dtype=np.int8)
    fn, tbss = k.add_dl_grant_tm3(sf, rb, l_crbs, *mcs, l_aggr)
    tbs = [rng.integers(0, 2, (1, n), dtype=np.int8) for n in tbss]
    got = fn(g0, g1, dci, *tbs, _t0(RNTI), _t0(cce))
    mask, cfgs = k._tm3_cfgs(sf, rb, l_crbs, *mcs)
    w0 = p_pdcch.encode(torch.from_numpy(dci), RNTI, l_aggr, cce, cell, sf, g0)
    want = p_pdsch.encode_tm([torch.from_numpy(b) for b in tbs], cfgs, cell, sf, RNTI, mask,
                             "tm3", grids=torch.stack([w0, g1], dim=1))
    assert _equal(got, (want[:, 0], want[:, 1]))
    rx = torch.from_numpy(_noisy(want.numpy(), seed=sf))  # (1, 2 ports as 2 rx, ...)
    got = k.pdsch_rx_tm3(sf, rb, l_crbs, *mcs)(rx, _t0(RNTI))
    pls, oks, _ = p_pdsch.decode_tm(rx, cfgs, cell, sf, RNTI, mask, "tm3")
    assert _equal(got, (pls[0], pls[1], oks[0], oks[1]))
    ul = k.add_ul_dci(sf, l_aggr)(g0, dci[:, :21], _t0(RNTI), _t0(cce))
    assert torch.equal(ul, p_pdcch.encode(torch.from_numpy(dci[:, :21]), RNTI, l_aggr, cce,
                                          cell, sf, g0))


def test_stages_are_cached_per_key_and_eager_off_the_card():
    """One stage per static key and instance; off the card no graph is
    kept, and each number reaches the stage as a 0-d tensor."""
    k = _kern()
    assert k.add_dl_grant(4, 10, 1, 432) is k.add_dl_grant(4, 10, 1, 432)
    assert k.add_dl_grant(4, 10, 1, 432) is not k.add_dl_grant(4, 12, 1, 432)
    assert k.rx_front(3) is k.rx_front(3) and k.graph_counts() == {}
    seen = []
    run = k._stage(lambda *a: seen.extend(a) or torch.zeros(1), "probe")
    run(3, np.int64(4), np.zeros(2, np.int8), torch.ones(1))
    assert [tuple(x.shape) for x in seen] == [(), (), (2,), (1,)]
    assert seen[0].dtype == seen[1].dtype == torch.int64


# ---------------- the stages' tables and captures, on a stand-in card ----------------

CPU = torch.device("cpu")
_C15 = p_grid.CellConfig(n_prb=15, cell_id=1, cfi=2)


def _mod(name):
    import importlib

    return importlib.import_module(f"srslte_emane_tpu_torch.{name}")


# the bounded caches of device tables that the network's stages read (new
# with them): (module, cache, one set of arguments)
TABLE_CACHES = {
    "chest._crs10": ("phch.chest", (_C15, 0, CPU)),
    "pdsch._crs_table10": ("phch.pdsch", (_C15, 0, CPU)),
    "pdsch._layer_weights": ("phch.pdsch", ("tm3", 0, 48, CPU)),
    "pdcch._device_tables": ("phch.pdcch", (_C15, 1, CPU)),
    "pdcch._sequence10": ("phch.pdcch", (_C15, CPU)),
    "pdcch._level_tables": ("phch.pdcch", (_C15, 1, ((1, 0), (2, 2)), CPU)),
    "pdcch._crc_weights": ("phch.pdcch", (CPU,)),
    "pusch._dmrs10_device": ("phch.pusch", (1, 2, CPU)),
    "pusch._sym_offsets": ("phch.pusch", (15, CPU)),
    "pusch._device_tables": ("phch.pusch", (15, 1, 3, 2, 2, CPU)),
    "pusch._time_weights": ("phch.pusch", (CPU,)),
    "uci._generator": ("phch.uci", (4, 20, "rm20", CPU)),
    "uci._device_codebook": ("phch.uci", (4, 20, "rm20", CPU)),
    "pusch_uci._device_tables": ("phch.pusch_uci", (288, 2, 0, 0, CPU)),
    "pucch._device_tables": ("phch.pucch", ("f2", _C15, 1, 40, CPU)),
    "pucch._sym_index": ("phch.pucch", ((0, 2), CPU)),
    "phich._device_tables": ("phch.phich", (_C15, 1, "1", CPU)),
    "pbch._device_tables": ("phch.pbch", (_C15, CPU)),
    "pbch._port_mask": ("phch.pbch", (2, CPU)),
    "sync._pss_replicas": ("phch.sync", (128, CPU)),
    "sync._sss_banks": ("phch.sync", (CPU,)),
    "sync._sss_bins": ("phch.sync", (128, CPU)),
    "wavenet._base_table": ("runtime.wavenet", (_C15, 1, CPU)),
    "wavenet._base_p1_table": ("runtime.wavenet", (_C15, 1, CPU)),
    "wavenet._sb_layout": ("runtime.wavenet", (_C15, CPU)),
    "wavenet._pucch_wf": ("runtime.wavenet", (_C15, 4, 1, CPU)),
    "wavenet._f2_tables": ("runtime.wavenet", (_C15, 2, 36, 1, CPU)),
    "wavenet._pucch_rx_tables": ("runtime.wavenet", (_C15, 4, 1, CPU)),
}


@pytest.mark.parametrize("name", list(TABLE_CACHES))
def test_a_stage_graph_holds_the_tables_it_read(name, monkeypatch):
    """Each new cache of the stages' device tables is a bounded table_cache
    that hands a graph every table it read while it captured (on
    tests/test_torch_step_graph.py's stand-in card), so an eviction frees
    none under the graph."""
    from test_torch_step_graph import _fake_card, _flat

    _fake_card(monkeypatch)
    module, args = TABLE_CACHES[name]
    cache = getattr(_mod(module), name.split(".")[1])
    assert cache.cache_parameters()["maxsize"] is not None
    cache.cache_clear()
    step = p_wn.graphs.jit(lambda x: _flat(cache(*args))[0].float().sum() + x, CPU)
    step(torch.zeros(()))
    (g,) = step.graphs.values()
    read = cache(*args)
    assert g.tables.get(id(read)) is read
    cache.cache_clear()  # an eviction: the cache lets go of every table
    assert cache(*args) is not read and g.tables[id(read)] is read


def test_every_stage_captures_its_first_call_on_a_stand_in_card(monkeypatch):
    """Every stage of a 15 PRB TM3 cell built with jit on a stand-in card
    (its capture runs the stage's Python once, no table may be made in it):
    one graph per stage key, each first call equal to the eager stage's."""
    from test_torch_step_graph import _fake_card

    _fake_card(monkeypatch)
    kw = dict(n_pucch_res=40, n_f2_res=4, f2_base=36, n_cce=6)
    cell = p_grid.CellConfig(n_prb=15, cell_id=1, cfi=3, n_ports=2)
    k = p_wn._CellKernels(cell, device=CPU, **kw)
    e = p_wn._CellKernels(cell, device=CPU, jit=False, **kw)
    rng = np.random.default_rng(0)
    bits = lambda n: rng.integers(0, 2, (1, n), dtype=np.int8)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    sf, rb, nre, T = 1, 2, cell.nre, p_ofdm.params(15)["sf_len"]
    re_idx = k.dl_re_idx(sf, rb, 4)
    tbs = p_ra.dl_tbs(10, 4)
    ul_tbs = k._ul_cfg(3, 12)[0].tbs
    calls = [
        (("cell_search",), (f(2, T, 2),)),
        (("base_grid", 0, 0), (bits(24),)),
        (("add_dl_grant", 4, 10, 2, len(re_idx)), (f(1, 14, nre, 2), bits(k.dci_len), bits(tbs),
                                                   RNTI, CCE, re_idx, sf)),
        (("add_ul_dci", sf, 2), (f(1, 14, nre, 2), bits(k.dci_len), RNTI, CCE)),
        (("add_phich", sf), (f(1, 14, nre, 2), np.sign(f(1, 1, 8)))),
        (("modulate",), (f(2, 14, nre, 2),)),
        (("demodulate",), (f(1, T, 2),)),
        (("mask_dwpts", 12), (f(1, 14, nre, 2),)),
        (("rx_front", sf), (f(2, T, 2),)),
        (("blind_all", sf), (f(2, 14, nre, 2), f(2, 14, nre, 2))),
        (("blind_all2", sf), (f(1, 14, nre, 2), f(1, 14, nre, 2))),
        (("pdsch_rx", 4, 10, len(re_idx)), (f(1, 14, nre, 2), RNTI, re_idx, sf)),
        (("phich_rx", sf), (f(1, 14, nre, 2), f(1, 14, nre, 2))),
        (("pbch_rx",), (f(1, 14, nre, 2),)),
        (("ri_probe", sf), (f(1, 2, 14, nre, 2),)),
        (("add_dl_grant_tm3", sf, rb, 4, 10, 8, 2), (f(1, 14, nre, 2), f(1, 14, nre, 2), bits(30),
                                                     bits(tbs), bits(p_ra.dl_tbs(8, 4)), RNTI,
                                                     CCE)),
        (("pdsch_rx_tm3", sf, rb, 4, 10, 8), (f(1, 2, 14, nre, 2), RNTI)),
        (("pusch_tx", 3, 12), (bits(ul_tbs), RNTI, rb, sf)),
        (("pusch_tx_cqi", 3, 12, 8), (bits(k._ul_cfg(3, 12, 8)[0].tbs), bits(8), RNTI, rb, sf)),
        (("pusch_rx", 3, 12), (f(1, 14, nre, 2), RNTI, rb, sf)),
        (("pusch_rx_cqi", 3, 12, 8), (f(1, 14, nre, 2), RNTI, rb, sf)),
        (("pucch_tx", sf), (5, f(1, 2))),
        (("pucch2_tx", sf, 1, 0), (bits(4),)),
        (("pucch2_tx", sf, 1, 1), (bits(4), bits(1))),
        (("pucch2_rx_all", sf), (f(1, 14, nre, 2),)),
        (("pucch_rx_all", sf), (f(1, 14, nre, 2),)),
    ]
    for key, args in calls:
        stage, extra = getattr(k, key[0])(*key[1:]), ()
        ref = getattr(e, key[0])(*key[1:])
        if isinstance(stage, tuple):
            (stage, *extra), ref = stage, ref[0]
        assert _equal(stage(*args), ref(*args)), key
    counts = k.graph_counts()
    assert counts == {key: 1 for key, _ in calls}, counts
    assert len(counts) == 26  # the 24 graphed stages of the reference's 25 (and demodulate)


# ---------------- on the card ----------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _network(tmp, jit, n_ues=4, n_prb=25):
    """A 4-UE network at 25 PRB on the card (graphed, or jit=False), its
    MAC pcap in tmp."""
    from srslte_emane_tpu_torch.epc import hss as hss_mod, mme as mme_mod, spgw as spgw_mod
    from srslte_emane_tpu_torch.stack import enb_stack, security, ue_stack
    from srslte_emane_tpu_torch.utils import pcap

    hss = hss_mod.Hss()
    spgw = spgw_mod.Spgw()
    enb = enb_stack.EnbStack(mme_mod.Mme(hss, spgw), enb_id=1, n_prb=n_prb)
    ues = []
    for i in range(n_ues):
        imsi, key = f"00101000000003{i:02d}", bytes(range(16))
        hss.add(hss_mod.Subscriber(imsi=imsi, key=key))
        opc = security.milenage_opc(key, b"\x00" * 16)
        ues.append(ue_stack.UeStack(ue_stack.Usim(imsi, key, opc), preamble=9 + 7 * i))
    net = p_wn.WaveformNetwork(enb, ues, pathloss_db=np.full(n_ues, 80.0), n_prb=n_prb,
                               seed=2, cfi=3, pcap=pcap.MacPcap(str(tmp / f"{jit}.pcap")),
                               jit=jit)
    return net, ues, spgw, spgw_mod


def _record_samples(medium):
    """A list that gets a copy of every DL waveform the eNB sends
    (dl_put) and of every UL signal it receives (ul_take)."""
    rec, put, take = [], medium.dl_put, medium.ul_take

    def dl_put(tti, samples):
        rec.append(samples.clone())
        return put(tti, samples)

    def ul_take():
        out = take()
        if out is not None:
            rec.append(out[0].clone())
        return out

    medium.dl_put, medium.ul_take = dl_put, ul_take
    return rec


def _pcap_records(data):
    """Every pcap record's bytes, its header (wall-clock timestamps) left out."""
    import struct

    off, out = 24, []
    while off < len(data):
        n = struct.unpack("!IIII", data[off : off + 16])[2]
        out.append(data[off + 16 : off + 16 + n])
        off += 16 + n
    return out


@pytest.mark.cuda
def test_graphed_network_equals_the_eager_network(dev, tmp_path, monkeypatch):
    """The graphed network (every stage a replayed CUDA graph) in lockstep
    with jit=False over the attach and 20 TTIs of traffic: every TTI's DL
    samples and the UL samples the eNB receives equal bit for bit, the
    stacks' states and metrics, the delivered packets and the pcap bytes
    too; one graph per key of the position-free stages."""
    from srslte_emane_tpu_torch.epc import hss as hss_mod

    streams = {}
    fake = types.SimpleNamespace(cur=None)
    fake.urandom = lambda n: streams[fake.cur].bytes(n)
    monkeypatch.setattr(hss_mod, "os", fake)
    sides, recs = {}, {}
    for jit in (True, False):
        streams[jit], fake.cur = np.random.default_rng(0), jit
        sides[jit] = _network(tmp_path, jit)
        recs[jit] = _record_samples(sides[jit][0].medium)
    assert sides[True][0].device.type == "cuda" and sides[True][0].kern.jit

    def state(side):
        net, ues, spgw, _ = side
        return ([u.state for u in net.ues], [(u.emm_state, u.rrc_state, u.mac_state) for u in ues],
                net.enb.metrics, [u.metrics for u in net.ues], [list(u.gw_rx) for u in ues],
                spgw.metrics)

    def run(n):
        for _ in range(n):
            for jit in (True, False):
                recs[jit].clear()
                fake.cur = jit
                sides[jit][0].run(1)
            assert len(recs[True]) == len(recs[False])
            assert all(torch.equal(a, b) for a, b in zip(recs[True], recs[False]))
            assert state(sides[True]) == state(sides[False]), sides[True][0].tti

    while sides[True][0].tti < 400 and not all(u.emm_state == "REGISTERED"
                                                for u in sides[True][1]):
        run(1)
    assert all(u.emm_state == "REGISTERED" for u in sides[True][1])
    for _, ues, spgw, spgw_mod in sides.values():
        for u in ues:
            spgw.handle_sgi_pdu(spgw_mod.make_ipv4("8.8.8.8", u.ip_addr, b"g" * 300))
            u.gw_send(spgw_mod.make_ipv4(u.ip_addr, "8.8.8.8", b"u" * 100))
    run(20)
    assert all(u.gw_rx for u in sides[True][1]) and sides[True][2].metrics["ul_bytes"] > 0
    pcaps = [_pcap_records((tmp_path / f"{jit}.pcap").read_bytes()) for jit in (True, False)]
    assert len(pcaps[0]) > 40 and pcaps[0] == pcaps[1]
    counts = sides[True][0].kern.graph_counts()
    assert counts and all(n == 1 for n in counts.values()), counts
    free = [k for k in counts if k[0] in ("add_dl_grant", "pdsch_rx", "pusch_tx", "pusch_rx")]
    assert {k[0] for k in free} >= {"add_dl_grant", "pdsch_rx", "pusch_tx", "pusch_rx"}
    assert sides[False][0].kern.graph_counts() == {}


@pytest.mark.cuda
def test_add_dl_grant_takes_one_graph_per_key(dev):
    """add_dl_grant at 4 subframes x 3 positions x 2 RNTIs and CCEs: one
    graph for the key, every call equal to the eager stage's."""
    cell = p_grid.CellConfig(n_prb=25, cell_id=1, cfi=3)
    k = p_wn._CellKernels(cell, device=dev)
    e = p_wn._CellKernels(cell, device=dev, jit=False)
    rng = np.random.default_rng(1)
    for sf in (1, 2, 3, 4):
        for rb in (0, 8, 17):
            for rnti, cce in ((0x46, 0), (0x14D, 6)):
                re_idx = k.dl_re_idx(sf, rb, 8)
                fn, tbs = k.add_dl_grant(8, 10, 2, len(re_idx))
                args = (k.base_grid(sf, -1)(np.zeros((1, 24), np.int8)),
                        rng.integers(0, 2, (1, k.dci_len), dtype=np.int8),
                        rng.integers(0, 2, (1, tbs), dtype=np.int8), rnti, cce, re_idx, sf)
                assert torch.equal(fn(*args), e.add_dl_grant(8, 10, 2, len(re_idx))[0](*args))
    assert k.graph_counts() == {("add_dl_grant", 8, 10, 2, len(re_idx)): 1} | {
        ("base_grid", sf, -1): 1 for sf in (1, 2, 3, 4)}
