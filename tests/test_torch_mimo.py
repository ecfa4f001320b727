"""PyTorch port vs the JAX package: the multi-antenna downlink (ops/mimo,
ops/channel.mimo_flat, the UE-RS tables of phch/grid, chest.interp_matrix,
phch/pdsch's TM2-TM8 and convert.softbuffers_from_numpy).

Both receivers get one numpy grid: the JAX TX grid through a flat random
channel plus numpy noise, formed in the frequency domain, so no DFT (and
none of the reference's bf16 DFT rounding) sits between the packages.  TX
grids are then equal, the LLRs within a relative RMS of 1e-5 (float32
products in another order), and bits, CRC flags, PMI indices and index
tables exact.  In the per-mode tests the JAX side runs under jax.jit from
after `sch.encode_tb` to before `sch.decode_tb` (`jax_encode`,
`jax_llrs`), so the JAX turbo codec compiles once, in the TM3 HARQ case,
rather than once per mode; the TM2-TM6 cases share one jit per side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srslte_emane_tpu.ops import channel as j_channel
from srslte_emane_tpu.ops import cplx as j_cplx
from srslte_emane_tpu.ops import mimo as j_mimo
from srslte_emane_tpu.phch import chest as j_chest
from srslte_emane_tpu.phch import grid as j_grid
from srslte_emane_tpu.phch import pdsch as j_pdsch
from srslte_emane_tpu.phch import sch as j_sch
from srslte_emane_tpu_torch import convert
from srslte_emane_tpu_torch.ops import channel as p_channel
from srslte_emane_tpu_torch.ops import cplx as p_cplx
from srslte_emane_tpu_torch.ops import mimo as p_mimo
from srslte_emane_tpu_torch.phch import chest as p_chest
from srslte_emane_tpu_torch.phch import grid as p_grid
from srslte_emane_tpu_torch.phch import pdsch as p_pdsch
from srslte_emane_tpu_torch.phch import sch as p_sch

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

SAMPLE_TOL = 1e-5  # elementwise float32 math in another order: max abs error
LLR_REL = 1e-5  # relative RMS of the LLRs handed to decode_tb


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _rel_rms(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def _cf(rng, shape):
    """Random split-complex float32 of `shape` + (2,)."""
    return rng.normal(size=tuple(shape) + (2,)).astype(np.float32)


def _close(got, ref, tol=SAMPLE_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, atol=tol, rtol=tol)


# ---------------- ops/mimo.py ----------------

def test_codebooks_equal_the_reference():
    for p_tab, j_tab in ((p_mimo.PMI_2TX_1L, j_mimo.PMI_2TX_1L),
                         (p_mimo.PMI_2TX_2L, j_mimo.PMI_2TX_2L)):
        assert len(p_tab) == len(j_tab)
        for a, b in zip(p_tab, j_tab):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


PRECODERS = [("precode_single", ()), ("precode_cdd2", ()), ("precode_sfbc_fstd", ()),
             *(("precode_sm2", (pmi,)) for pmi in range(3)),
             *(("precode_sm1", (pmi,)) for pmi in range(4))]


@pytest.mark.parametrize("name,args", PRECODERS)
def test_precoders_match(name, args):
    n_layers = {"precode_sfbc_fstd": 4, "precode_sm1": 1, "precode_single": 1}.get(name, 2)
    x = _cf(np.random.default_rng(len(name) + sum(args)), (3, n_layers, 24))
    got = getattr(p_mimo, name)(_t(x), *args)
    ref = jax.jit(lambda a: getattr(j_mimo, name)(a, *args))(x)
    _close(got, ref)


@pytest.mark.parametrize("with_noise", [False, True])
def test_decode_zf2_matches(with_noise):
    rng = np.random.default_rng(5)
    y, h = _cf(rng, (3, 2, 40)), _cf(rng, (3, 2, 2, 40))
    noise = rng.uniform(0.1, 1.0, 3).astype(np.float32) if with_noise else None
    got = p_mimo.decode_zf2(_t(y), _t(h), None if noise is None else _t(noise))
    ref = jax.jit(j_mimo.decode_zf2)(y, h, noise)
    for g, r in zip(got, ref):
        _close(g, r, 1e-4)


def test_sfbc_fstd_and_mrc_match():
    rng = np.random.default_rng(6)
    y, h = _cf(rng, (3, 32)), _cf(rng, (3, 4, 32))
    for g, r in zip(p_mimo.decode_sfbc_fstd(_t(y), _t(h)), jax.jit(j_mimo.decode_sfbc_fstd)(y, h)):
        _close(g, r, 1e-4)
    y, h = _cf(rng, (3, 2, 32)), _cf(rng, (3, 2, 32))
    for g, r in zip(p_mimo.decode_mrc_eff(_t(y), _t(h)), jax.jit(j_mimo.decode_mrc_eff)(y, h)):
        _close(g, r, 1e-4)


def test_pmi_select_and_cond_number_match():
    rng = np.random.default_rng(7)
    for shape in ((2, 2, 16), (3, 2, 2, 16)):  # (rx, tx, M) and a leading axis
        h = _cf(rng, shape)
        pmi, metric = p_mimo.pmi_select_1l(_t(h))
        pmi_j, metric_j = jax.jit(j_mimo.pmi_select_1l)(h)
        assert pmi.dtype == torch.int32
        np.testing.assert_array_equal(pmi.numpy(), np.asarray(pmi_j))
        _close(metric, metric_j, 1e-4)
    h = _cf(rng, (3, 2, 2, 16))
    _close(p_mimo.cond_number_db(_t(h)), jax.jit(j_mimo.cond_number_db)(h), 1e-3)


def test_pmi_select_exact_tie_takes_the_first():
    """h0 = 1 and h1 = e^{-3 i pi/4} on every RE: ||h w||^2 of PMI 1 (w1 = -1)
    and PMI 2 (w1 = +j) are the same float32 number and the largest; both
    packages return the first of the two."""
    s = np.float32(np.sqrt(0.5))
    h = np.zeros((1, 1, 2, 8, 2), np.float32)  # (batch, rx, tx, M, 2)
    h[0, 0, 0, :, 0] = 1.0
    h[0, 0, 1] = (-s, -s)
    pmi, metric = p_mimo.pmi_select_1l(_t(h))
    pmi_j, metric_j = jax.jit(j_mimo.pmi_select_1l)(h)
    assert metric[1] == metric[2] == metric.max() and float(metric_j[1]) == float(metric_j[2])
    assert int(pmi) == int(pmi_j) == 1


def test_mimo_flat_with_the_same_noise(monkeypatch):
    """The reference's flat channel with the same numpy noise in both
    packages: the signal power is measured per row over all rx antennas."""
    rng = np.random.default_rng(8)
    tx, h = _cf(rng, (2, 2, 64)), _cf(rng, (2, 2, 2))
    noise = rng.normal(size=(2, 2, 64, 2)).astype(np.float32)
    monkeypatch.setattr(j_channel.jax.random, "normal", lambda key, shape, dtype: jnp.asarray(noise))
    monkeypatch.setattr(p_channel.torch, "randn", lambda shape, **kw: _t(noise))
    got = p_channel.mimo_flat(None, _t(tx), _t(h), 12.0)
    ref = jax.jit(lambda a, b: j_channel.mimo_flat(jax.random.PRNGKey(0), a, b, 12.0))(tx, h)
    _close(got, ref)


# ---------------- host tables ----------------

@pytest.mark.parametrize("cell_kw,sf_idx,rnti,mask", [
    (dict(n_prb=6, cell_id=9, n_ports=2, cfi=1), 3, 0x52, (1,) * 6),
    (dict(n_prb=15, cell_id=4, n_ports=2, cfi=2), 2, 0x47, (0, 1) * 7 + (1,)),
    (dict(n_prb=25, cell_id=301, n_ports=4, cfi=1), 0, 0x46, (1,) * 10 + (0,) * 15),
])
def test_uers_tables_equal_the_reference(cell_kw, sf_idx, rnti, mask):
    pcell, jcell = p_grid.CellConfig(**cell_kw), j_grid.CellConfig(**cell_kw)
    assert p_grid.UERS5_SYMS == j_grid.UERS5_SYMS
    assert (p_grid.UERS78_SYMS, p_grid.UERS78_OCC) == (j_grid.UERS78_SYMS, j_grid.UERS78_OCC)
    n, c = pcell.n_prb, pcell.cell_id
    for got, ref in ((p_grid.uers5_k(c, n), j_grid.uers5_k(c, n)),
                     (p_grid.uers5_values(c, sf_idx, rnti, n), j_grid.uers5_values(c, sf_idx, rnti, n)),
                     (p_grid.uers78_k(c, n), j_grid.uers78_k(c, n)),
                     (p_grid.uers78_values(c, sf_idx, 0, n), j_grid.uers78_values(c, sf_idx, 0, n)),
                     (p_grid.pdsch_re_indices_tm7(pcell, sf_idx, mask),
                      j_grid.pdsch_re_indices_tm7(jcell, sf_idx, mask)),
                     (p_grid.pdsch_re_indices_tm8(pcell, sf_idx, mask),
                      j_grid.pdsch_re_indices_tm8(jcell, sf_idx, mask)),
                     (p_grid.pdsch_re_indices(pcell, sf_idx, mask),
                      j_grid.pdsch_re_indices(jcell, sf_idx, mask))):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    ks = p_grid.uers5_k(c, n)
    for pk in (tuple(ks[0].tolist()), tuple(ks[1][::3].tolist()), (0, 5, 6, 40)):
        np.testing.assert_array_equal(p_chest.interp_matrix(pk, pcell.nre),
                                      j_chest.interp_matrix(pk, jcell.nre))


# ---------------- phch/pdsch.py TM2-TM8 ----------------

def _rx_grids(grids, rng, boost, noise=0.05):
    """(B, n_tx, 14, NRE, 2) TX grids through a flat random (2, n_tx)
    channel (+ boost I) plus noise, formed per RE: (B, 2, 14, NRE, 2)."""
    g = np.asarray(grids)
    B, n_tx = g.shape[:2]
    h = rng.normal(size=(B, 2, n_tx)) + 1j * rng.normal(size=(B, 2, n_tx))
    h = h + boost * np.eye(2, n_tx)[None]
    y = np.einsum("brp,bpsk->brsk", h, g[..., 0] + 1j * g[..., 1])
    y = y + noise * (rng.normal(size=y.shape) + 1j * rng.normal(size=y.shape))
    return np.stack([y.real, y.imag], -1).astype(np.float32)


def jax_encode(calls):
    """The grids of [(fn, tbs, pcfgs, args)]: every fn(*args) under one
    jax.jit, from after `sch.encode_tb` (its calls answered in order with the
    port's codewords of that call's `tbs`; the two codecs are held equal in
    tests/test_torch_phy.py), so no JAX turbo codec compiles here."""
    cws = [[jnp.asarray(p_sch.encode_tb(_t(t), c).numpy()) for t, c in zip(tbs, pcfgs)]
           for _, tbs, pcfgs, _ in calls]

    def run(args):
        grids = []
        with pytest.MonkeyPatch.context() as m:
            for (fn, *_), cw, a in zip(calls, cws, args):
                m.setattr(j_sch, "encode_tb", lambda tb, cfg, pending=iter(cw): next(pending))
                grids.append(fn(*a))
        return grids

    return [np.asarray(g) for g in jax.jit(run)([c[3] for c in calls])]


def jax_llrs(calls):
    """For [(fn, args)], the LLRs of each `sch.decode_tb` call of every
    fn(*args), all under one jax.jit, up to before `decode_tb`."""
    def run(args):
        taps = []
        with pytest.MonkeyPatch.context() as m:
            for (fn, _), a in zip(calls, args):
                taps.append([])

                def tap(llrs, cfg, softbuf=None, max_iter=8, out=taps[-1], **kw):
                    out.append(llrs)
                    B = llrs.shape[0]
                    return jnp.zeros((B, cfg.tbs), jnp.int8), jnp.ones(B, bool), [], 0

                m.setattr(j_sch, "decode_tb", tap)
                fn(*a)
        return taps

    return [[np.asarray(x) for x in t] for t in jax.jit(run)([a for _, a in calls])]


@pytest.fixture
def port_llrs(monkeypatch):
    """The LLRs of every port `sch.decode_tb` call in the test."""
    seen, decode_tb = [], p_sch.decode_tb

    def spy(llrs, *args, **kw):
        seen.append(llrs.numpy())
        return decode_tb(llrs, *args, **kw)

    monkeypatch.setattr(p_sch, "decode_tb", spy)
    return seen


def assert_same_llrs(jax_llrs_, port_llrs_):
    """The same decode_tb calls (merged or not) with the same LLRs."""
    assert len(jax_llrs_) == len(port_llrs_) > 0
    for ref, got in zip(jax_llrs_, port_llrs_):
        assert got.shape == ref.shape and _rel_rms(got, ref) < LLR_REL


def _cells(**kw):
    return p_grid.CellConfig(**kw), j_grid.CellConfig(**kw)


def _tm_case(tm, n_ports, n_prb=6, sf_idx=1, qm=2, seed=0):
    """(port cell, jax cell, port cfgs, jax cfgs, payloads) of a
    full-band grant, one codeword per layer group, code rate 0.4."""
    pcell, jcell = _cells(n_prb=n_prb, cell_id=7, n_ports=n_ports, cfi=1)
    n_re = j_grid.nof_re(jcell, sf_idx, (1,) * n_prb)
    n_cw = 2 if tm in ("tm3", "tm4") else 1
    kw = dict(tbs=max(8, (int(n_re * qm * 0.4) - 24) // 8 * 8), G=n_re * qm, Qm=qm, Nl=1)
    rng = np.random.default_rng(seed)
    tbs = [rng.integers(0, 2, (2, kw["tbs"]), dtype=np.int8) for _ in range(n_cw)]
    return (pcell, jcell, [p_sch.SchConfig(**kw)] * n_cw, [j_sch.SchConfig(**kw)] * n_cw, tbs)


TMS = [("tm2", 2, 0), ("tm2", 4, 0), ("tm3", 2, 0), ("tm4", 2, 1), ("tm4", 2, 2),
       ("tm5", 2, 2), *(("tm6", 2, pmi) for pmi in range(4))]


@pytest.fixture(scope="module")
def jax_tms():
    """{TMS case: (its _tm_case, JAX TX grid, received grid, JAX decode_tb
    LLRs)}: the JAX encoders of every case under one jax.jit and their
    decoders under another, two compiles in all rather than two per case."""
    cases = [_tm_case(tm, n_ports, seed=pmi) for tm, n_ports, pmi in TMS]
    encs, decs = [], []
    for (tm, _, pmi), (pcell, jcell, _, jcfgs, _) in zip(TMS, cases):
        mask = (1,) * pcell.n_prb
        encs.append(lambda *t, c=jcfgs, e=jcell, m=mask, tm=tm, pmi=pmi:
                    j_pdsch.encode_tm(list(t), c, e, 1, 0x46, m, tm, pmi))
        decs.append(lambda r, c=jcfgs, e=jcell, m=mask, tm=tm, pmi=pmi:
                    j_pdsch.decode_tm(r, c, e, 1, 0x46, m, tm, pmi))
    grids = jax_encode([(enc, c[4], c[2], tuple(c[4])) for enc, c in zip(encs, cases)])
    rxs = [_rx_grids(g, np.random.default_rng(10 + pmi), 2.5 if tm in ("tm3", "tm4") else 0.0)
           for g, (tm, _, pmi) in zip(grids, TMS)]
    llrs = jax_llrs([(dec, (rx,)) for dec, rx in zip(decs, rxs)])
    return dict(zip(TMS, zip(cases, grids, rxs, llrs)))


@pytest.mark.parametrize("tm,n_ports,pmi", TMS)
def test_encode_decode_tm_matches(tm, n_ports, pmi, jax_tms, port_llrs):
    """Fresh-grid encode equal to the reference; the same received grid
    gives the reference's LLRs, and the port decodes every payload."""
    (pcell, _, pcfgs, _, tbs), g_j, rx, llrs_j = jax_tms[tm, n_ports, pmi]
    mask = (1,) * pcell.n_prb
    g_p = p_pdsch.encode_tm([_t(t) for t in tbs], pcfgs, pcell, 1, 0x46, mask, tm, pmi)
    assert g_p.shape == (2, n_ports, 14, 12 * pcell.n_prb, 2)
    _close(g_p, g_j)
    outs, oks, sbs = p_pdsch.decode_tm(_t(rx), pcfgs, pcell, 1, 0x46, mask, tm, pmi)
    assert_same_llrs(llrs_j, port_llrs)
    assert len(outs) == len(oks) == len(sbs) == len(tbs)
    for out, ok, tb in zip(outs, oks, tbs):
        assert ok.all()
        np.testing.assert_array_equal(out.numpy(), tb)


@pytest.mark.parametrize("tm,n_ports", [("tm3", 2), ("tm2", 4)])
def test_encode_tm_into_given_grids(tm, n_ports):
    """The `grids=` scatter path: PDSCH and every port's CRS written over
    a copy of the given grids, as the reference writes them."""
    pcell, jcell, pcfgs, jcfgs, tbs = _tm_case(tm, n_ports, seed=3)
    mask = (1,) * pcell.n_prb
    base = _cf(np.random.default_rng(4), (2, n_ports, 14, pcell.nre))
    base_t = _t(base)
    g_p = p_pdsch.encode_tm([_t(t) for t in tbs], pcfgs, pcell, 1, 0x46, mask, tm, grids=base_t)
    [g_j] = jax_encode([(lambda g, *t: j_pdsch.encode_tm(list(t), jcfgs, jcell, 1, 0x46, mask,
                                                         tm, grids=g), tbs, pcfgs, (base, *tbs))])
    _close(g_p, g_j)
    np.testing.assert_array_equal(base_t.numpy(), base)  # the input is not written


def test_tm7_matches(port_llrs):
    pcell, jcell = _cells(n_prb=6, cell_id=9, n_ports=2, cfi=1)
    sf_idx, rnti, mask = 3, 0x52, (1, 1, 1, 0, 1, 1)
    n_re = len(j_grid.pdsch_re_indices_tm7(jcell, sf_idx, mask))
    kw = dict(tbs=(n_re * 2 * 2 // 5 - 24) // 8 * 8, G=n_re * 2, Qm=2, Nl=1)
    pcfg, jcfg = p_sch.SchConfig(**kw), j_sch.SchConfig(**kw)
    tb = np.random.default_rng(7).integers(0, 2, (2, kw["tbs"]), dtype=np.int8)
    beam = np.array([0.8 + 0.3j, -0.4 + 0.6j], dtype=np.complex64)
    [g_j] = jax_encode([(lambda t, b: j_pdsch.encode_tm7(t, jcfg, jcell, sf_idx, rnti, mask, b),
                         [tb], [pcfg], (tb, j_cplx.from_numpy(beam)))])
    g_p = p_pdsch.encode_tm7(_t(tb), pcfg, pcell, sf_idx, rnti, mask, p_cplx.from_numpy(beam))
    _close(g_p, g_j)
    rx = _rx_grids(g_j, np.random.default_rng(17), 0.0)
    [llrs_j] = jax_llrs([(lambda r: j_pdsch.decode_tm7(r, jcfg, jcell, sf_idx, rnti, mask), (rx,))])
    out, ok, sb, _ = p_pdsch.decode_tm7(_t(rx), pcfg, pcell, sf_idx, rnti, mask)
    assert_same_llrs(llrs_j, port_llrs)
    assert ok.all() and len(sb) == pcfg.segm.C
    np.testing.assert_array_equal(out.numpy(), tb)


def test_tm8_matches(port_llrs):
    """Two beamformed layers whose DMRS add on the same REs (ports 7/8)."""
    pcell, jcell = _cells(n_prb=6, cell_id=4, n_ports=2, cfi=1)
    sf_idx, rnti, mask = 2, 0x47, (1,) * 6
    n_re = len(j_grid.pdsch_re_indices_tm8(jcell, sf_idx, mask))
    kw = dict(tbs=(n_re * 2 * 2 // 5 - 24) // 8 * 8, G=n_re * 2, Qm=2, Nl=1)
    pcfgs, jcfgs = [p_sch.SchConfig(**kw)] * 2, [j_sch.SchConfig(**kw)] * 2
    rng = np.random.default_rng(8)
    tbs = [rng.integers(0, 2, (2, kw["tbs"]), dtype=np.int8) for _ in range(2)]
    beams = np.array([[1.0 + 0j, 0.5 + 0.5j], [0.5 - 0.5j, -1.0 + 0j]],
                     dtype=np.complex64) / np.sqrt(1.5)
    [g_j] = jax_encode([(lambda b, *t: j_pdsch.encode_tm8(list(t), jcfgs, jcell, sf_idx, rnti,
                                                          mask, b),
                         tbs, pcfgs, (j_cplx.from_numpy(beams), *tbs))])
    g_p = p_pdsch.encode_tm8([_t(t) for t in tbs], pcfgs, pcell, sf_idx, rnti, mask,
                             p_cplx.from_numpy(beams))
    _close(g_p, g_j)
    rx = _rx_grids(g_j, rng, 2.5)
    [llrs_j] = jax_llrs([(lambda r: j_pdsch.decode_tm8(r, jcfgs, jcell, sf_idx, rnti, mask),
                          (rx,))])
    outs, oks, _ = p_pdsch.decode_tm8(_t(rx), pcfgs, pcell, sf_idx, rnti, mask)
    assert_same_llrs(llrs_j, port_llrs)
    for out, ok, tb in zip(outs, oks, tbs):
        assert ok.all()
        np.testing.assert_array_equal(out.numpy(), tb)


@pytest.fixture(scope="module")
def tm3_harq():
    """A TM3 grant sent twice at low SNR, decoded by the JAX package: the
    first transmission from empty soft buffers, the second combined into
    the first's (each jitted once per llr_bits)."""
    pcell, jcell, pcfgs, jcfgs, tbs = _tm_case("tm3", 2, seed=11)
    mask = (1,) * pcell.n_prb
    grids = p_pdsch.encode_tm([_t(t) for t in tbs], pcfgs, pcell, 1, 0x46, mask, "tm3")
    rng = np.random.default_rng(12)
    rx = [_rx_grids(grids, rng, 2.5, noise=0.9) for _ in range(2)]
    out = {}
    for llr_bits in (16,):
        first = jax.jit(lambda r: j_pdsch.decode_tm(r, jcfgs, jcell, 1, 0x46, mask, "tm3",
                                                    llr_bits=llr_bits))(rx[0])
        again = jax.jit(lambda r, sb: j_pdsch.decode_tm(r, jcfgs, jcell, 1, 0x46, mask, "tm3",
                                                        softbufs=sb, llr_bits=llr_bits))(
            rx[1], first[2])
        out[llr_bits] = jax.tree_util.tree_map(np.asarray, (first, again))
    return pcell, pcfgs, tbs, rx, out


@pytest.mark.parametrize("llr_bits", [16])
def test_tm3_decode_and_harq_match_jax(tm3_harq, llr_bits):
    """Bits and CRC flags of both codewords equal the JAX decode's, the
    JAX soft buffers carried over (convert.softbuffers_from_numpy) combine
    with a retransmission exactly as in the JAX package, and the kernel
    path's plain version (use_kernel=True on CPU tensors) decodes the same."""
    pcell, pcfgs, tbs, rx, out = tm3_harq
    (outs_j, oks_j, sbs_j), (outs2_j, oks2_j, sbs2_j) = out[llr_bits]
    mask = (1,) * pcell.n_prb
    outs, oks, sbs = p_pdsch.decode_tm(_t(rx[0]), pcfgs, pcell, 1, 0x46, mask, "tm3",
                                       llr_bits=llr_bits)
    for got, ref in zip(outs + oks, list(outs_j) + list(oks_j)):
        np.testing.assert_array_equal(got.numpy(), ref)
    sb_in = convert.softbuffers_from_numpy(
        sbs_j, dtype=torch.bfloat16 if llr_bits == 16 else torch.float32)
    assert [len(cw) for cw in sb_in] == [len(cw) for cw in sbs]
    assert convert.softbuffers_from_numpy([None, sbs_j[1]])[0] is None
    outs2, oks2, sbs2 = p_pdsch.decode_tm(_t(rx[1]), pcfgs, pcell, 1, 0x46, mask, "tm3",
                                          softbufs=sb_in, llr_bits=llr_bits, use_kernel=True)
    for got, ref in zip(outs2 + oks2, list(outs2_j) + list(oks2_j)):
        np.testing.assert_array_equal(got.numpy(), ref)
    assert all(oks2[q].all() for q in range(2))
    for q in range(2):
        np.testing.assert_array_equal(outs2[q].numpy(), tbs[q])
        for got, ref in zip(sbs2[q], sbs2_j[q]):
            got = got.float().numpy()
            assert got.shape == ref.shape and _rel_rms(got, np.asarray(ref, np.float32)) < 1e-2
