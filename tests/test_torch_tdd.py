"""PyTorch port vs the JAX package: the TDD frame structure (the port's
copy of phch/tdd.py), the grid's `max_sym` (DwPTS) and reserved-RE
options, the DwPTS-truncated PDSCH, the TDD frame loop and the waveform
multi-cell step.

The cases are the JAX package's tests/test_tdd.py (all but the netsim
attach test, which runs the message-level network) and test_multicell.py
(all but the sharded one).  The copy of tdd.py is held byte-equal and every
table and function equal.  Index tables, bits, CRC flags and ACK maps are
held exactly; grids built from the same bits to float32 rounding (rtol
1e-5); LLRs and SNR estimates after the OFDM demodulator to a relative RMS
of 1e-2 (the reference rounds DFT inputs to bf16).  The JAX side runs under
jax.jit from after `sch.encode_tb` (answered with the port's codewords) to
before `sch.decode_tb` (which hands back its LLRs), so no JAX turbo codec
compiles here; its AWGN is patched, in the test only, to add the same numpy
noise as the port's.
"""

import filecmp
import inspect
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srslte_emane_tpu.models import multicell as j_multicell
from srslte_emane_tpu.models import enb_dl as j_enb_dl
from srslte_emane_tpu.models import tdd_frame as j_tdd_frame
from srslte_emane_tpu.ops import channel as j_channel
from srslte_emane_tpu.ops import cplx as j_cplx
from srslte_emane_tpu.phch import grid as j_grid
from srslte_emane_tpu.phch import pdcch as j_pdcch
from srslte_emane_tpu.phch import pdsch as j_pdsch
from srslte_emane_tpu.phch import sch as j_sch
from srslte_emane_tpu.phch import tdd as j_tdd
from srslte_emane_tpu_torch.models import enb_dl as p_enb_dl
from srslte_emane_tpu_torch.models import multicell as p_multicell
from srslte_emane_tpu_torch.models import tdd_frame as p_tdd_frame
from srslte_emane_tpu_torch.ops import channel as p_channel
from srslte_emane_tpu_torch.ops import cplx as p_cplx
from srslte_emane_tpu_torch.phch import grid as p_grid
from srslte_emane_tpu_torch.phch import pdcch as p_pdcch
from srslte_emane_tpu_torch.phch import pdsch as p_pdsch
from srslte_emane_tpu_torch.phch import sch as p_sch
from srslte_emane_tpu_torch.phch import tdd as p_tdd

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

RTOL, ATOL = 1e-5, 1e-6  # grids from the same bits: float32 rounding
DFT_REL = 1e-2  # relative RMS after the OFDM demodulator


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _rel_rms(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def _cells(**kw):
    return p_grid.CellConfig(**kw), j_grid.CellConfig(**kw)


@pytest.fixture
def port_llrs(monkeypatch):
    """The LLRs of every port `sch.decode_tb` call in the test."""
    seen, decode_tb = [], p_sch.decode_tb

    def spy(llrs, *args, **kw):
        seen.append(llrs.numpy())
        return decode_tb(llrs, *args, **kw)

    monkeypatch.setattr(p_sch, "decode_tb", spy)
    return seen


def _jax_stubbed(fn, codewords, *args):
    """fn(*args) under jax.jit with `sch.encode_tb` answered in order by
    `codewords` and `sch.decode_tb` handing back its LLRs.  Returns (fn's
    output, [LLRs of each decode_tb call])."""
    def run(*a):
        taps, cws = [], iter(codewords)

        def tap(llrs, cfg, *_, **__):
            taps.append(llrs)
            return jnp.zeros((llrs.shape[0], cfg.tbs), jnp.int8), jnp.ones(llrs.shape[0], bool), [], 0

        with pytest.MonkeyPatch.context() as m:
            m.setattr(j_sch, "encode_tb", lambda *_: jnp.asarray(next(cws)))
            m.setattr(j_sch, "decode_tb", tap)
            out = fn(*a)
        return out, taps

    out, taps = jax.jit(run)(*args)
    return out, [np.asarray(x) for x in taps]


def _awgn_patch(monkeypatch, noises):
    """Both packages' channel.awgn add the next numpy standard-normal draw of
    `noises` (per real component), scaled by sqrt(sigma^2 / 2) from each
    package's own measurement of the signal power, as awgn does."""
    jit_noise, port_noise = iter(noises), iter(noises)

    def j_awgn(key, x, snr_db, signal_power=None):
        p = jnp.mean(j_cplx.abs2(x).reshape(x.shape[0], -1), axis=-1)
        s = jnp.sqrt(p / 10 ** (snr_db / 10) / 2).reshape((-1,) + (1,) * (x.ndim - 1))
        return x + jnp.asarray(next(jit_noise)) * s

    def p_awgn(gen, x, snr_db, signal_power=None):
        p = p_cplx.abs2(x).reshape(x.shape[0], -1).mean(dim=-1)
        s = torch.sqrt(p / 10 ** (snr_db / 10) / 2).reshape((-1,) + (1,) * (x.ndim - 1))
        return x + _t(next(port_noise)) * s

    monkeypatch.setattr(j_channel, "awgn", j_awgn)
    monkeypatch.setattr(p_channel, "awgn", p_awgn)


# ---------------- the copy of phch/tdd.py ----------------

def test_tdd_copy_byte_equal_and_tables_equal():
    assert filecmp.cmp(inspect.getfile(p_tdd), inspect.getfile(j_tdd), shallow=False)
    for name in ("UL_DL", "SS_SYMBOLS", "NOF_HARQ", "N_SYM", "DL_ASSOC_K", "UL_GRANT_K"):
        assert getattr(p_tdd, name) == getattr(j_tdd, name), name
    for cfg in range(7):
        assert p_tdd.dl_subframes(cfg) == j_tdd.dl_subframes(cfg)
        assert p_tdd.ul_subframes(cfg) == j_tdd.ul_subframes(cfg)
        assert p_tdd.nof_harq(cfg) == j_tdd.nof_harq(cfg)
        for sf in range(10):
            assert p_tdd.sf_type(cfg, sf) == j_tdd.sf_type(cfg, sf)
            if p_tdd.sf_type(cfg, sf) != "U":
                assert p_tdd.ack_subframe_for_dl(cfg, sf) == j_tdd.ack_subframe_for_dl(cfg, sf)
        for n in p_tdd.UL_GRANT_K[cfg]:
            assert p_tdd.pusch_subframe_for_grant(cfg, n) == j_tdd.pusch_subframe_for_grant(cfg, n)
        for ss in range(10):
            for sf in p_tdd.dl_subframes(cfg):
                assert p_tdd.pdsch_max_sym(cfg, ss, sf) == j_tdd.pdsch_max_sym(cfg, ss, sf)
            np.testing.assert_array_equal(p_tdd.dl_symbol_mask(cfg, ss), j_tdd.dl_symbol_mask(cfg, ss))
            np.testing.assert_array_equal(p_tdd.ul_symbol_mask(cfg, ss), j_tdd.ul_symbol_mask(cfg, ss))
    for ss in range(10):
        for f in ("nof_dw", "nof_gp", "nof_up"):
            assert getattr(p_tdd, f)(ss) == getattr(j_tdd, f)(ss)
        for slot in (0, 1):
            assert p_tdd.nof_dw_slot(ss, slot) == j_tdd.nof_dw_slot(ss, slot)
    # the reference tests' invariants, on the copy
    assert p_tdd.dl_subframes(1) == (0, 1, 4, 5, 6, 9) and p_tdd.ul_subframes(1) == (2, 3, 7, 8)
    assert p_tdd.nof_dw(4) == 12 and p_tdd.nof_up(7) == 2 and p_tdd.nof_harq(0) == 7
    assert p_tdd.ack_subframe_for_dl(1, 9) == 13 and p_tdd.pusch_subframe_for_grant(6, 9) == 14


# ---------------- grid: max_sym ----------------

@pytest.mark.parametrize("n_prb,cfi,n_ports,cp", [(6, 2, 1, "normal"), (15, 1, 2, "normal"),
                                                  (25, 3, 4, "normal"), (15, 2, 1, "ext")])
def test_grid_max_sym_tables_equal(n_prb, cfi, n_ports, cp):
    pcell, jcell = _cells(n_prb=n_prb, cell_id=7, cfi=cfi, n_ports=n_ports, cp=cp)
    rng = np.random.default_rng(n_prb)
    for sf in (0, 1, 5, 6):
        np.testing.assert_array_equal(p_grid.reserved_mask(pcell, sf),
                                      j_grid.reserved_mask(jcell, sf))
        for max_sym in (0, 6, 9, 10, 12):
            mask = tuple(int(v) for v in rng.integers(0, 2, n_prb))
            np.testing.assert_array_equal(p_grid.pdsch_re_indices(pcell, sf, mask, max_sym),
                                          j_grid.pdsch_re_indices(jcell, sf, mask, max_sym))
            assert p_grid.nof_re(pcell, sf, mask, max_sym) == j_grid.nof_re(jcell, sf, mask, max_sym)
            np.testing.assert_array_equal(p_grid.tx_gather_table(pcell, sf, mask, 0, max_sym),
                                          j_grid.tx_gather_table(jcell, sf, mask, 0, max_sym))
            assert (p_grid.worst_nof_re(pcell, sf, 4, max_sym)
                    == j_grid.worst_nof_re(jcell, sf, 4, max_sym))


def test_dwpts_pdsch_roundtrip(port_llrs):
    """PDSCH in a special subframe, symbols truncated to DwPTS (10)."""
    pcell, jcell = _cells(n_prb=15, cell_id=3)
    mask, sf = (1,) * 15, 1
    max_sym = p_tdd.pdsch_max_sym(1, 7, sf)
    n_re = p_grid.nof_re(pcell, sf, mask, max_sym)
    assert n_re < p_grid.nof_re(pcell, sf, mask)
    kw = dict(tbs=(n_re * 4 // 2 - 24) // 8 * 8, G=n_re * 4, Qm=4, Nl=1)
    pcfg, jcfg = p_sch.SchConfig(**kw), j_sch.SchConfig(**kw)
    tb = np.random.default_rng(0).integers(0, 2, (2, pcfg.tbs), dtype=np.int8)
    g = p_pdsch.encode(_t(tb), pcfg, pcell, sf, 0x46, mask, max_sym=max_sym)
    assert g[:, 10].abs().max() == 0  # symbol 10 in the guard period (no CRS symbol)
    jg, _ = _jax_stubbed(lambda: j_pdsch.encode(None, jcfg, jcell, sf, 0x46, mask,
                                                max_sym=max_sym),
                         [p_sch.encode_tb(_t(tb), pcfg).numpy()])
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=RTOL, atol=ATOL)
    out, ok, _, _ = p_pdsch.decode(g, pcfg, pcell, sf, 0x46, mask, max_sym=max_sym)
    assert ok.all() and (out.numpy() == tb).all()
    _, ref = _jax_stubbed(lambda x: j_pdsch.decode(x, jcfg, jcell, sf, 0x46, mask,
                                                   max_sym=max_sym), [], jnp.asarray(g.numpy()))
    assert len(ref) == len(port_llrs) == 1 and _rel_rms(port_llrs[0], ref[0]) < 1e-4


# ---------------- the TDD frame ----------------

def test_tdd_frame_end_to_end(monkeypatch, port_llrs):
    """Config 1 (DSUUDDSUUD), special subframe 7: PDSCH on D (sf 0, 4),
    DwPTS PDSCH on S (sf 1), PUSCH on U (sf 2, 7), ACKs at the k-set
    subframes.  The port decodes every payload bit-exact; its LLRs equal
    the JAX package's with the same noise."""
    pcell, jcell = _cells(n_prb=15, cell_id=4, cfi=1)
    pcfg = p_tdd_frame.TddFrameConfig(cell=pcell, sf_config=1, ss_config=7)
    jcfg = j_tdd_frame.TddFrameConfig(cell=jcell, sf_config=1, ss_config=7)
    rng = np.random.default_rng(0)
    B = 2
    dl_tbs = {sf: rng.integers(0, 2, (B, pcfg.dl_cfg(sf).tbs), dtype=np.int8) for sf in (0, 1, 4)}
    ul_tbs = {sf: rng.integers(0, 2, (B, pcfg.ul_cfg().tbs), dtype=np.int8) for sf in (2, 7)}
    for sf in dl_tbs:
        p, j = pcfg.dl_cfg(sf), jcfg.dl_cfg(sf)
        assert (p.tbs, p.G, p.Qm) == (j.tbs, j.G, j.Qm)
    order = sorted({**dl_tbs, **ul_tbs})  # the frame's order of encodes, noises, decodes
    sent = {**dl_tbs, **ul_tbs}
    cws = [p_sch.encode_tb(_t(sent[sf]), pcfg.dl_cfg(sf) if sf in dl_tbs else pcfg.ul_cfg()).numpy()
           for sf in order]
    noises = [rng.normal(size=(B, 3840, 2)).astype(np.float32) for _ in order]
    _awgn_patch(monkeypatch, noises)
    out = p_tdd_frame.run_frame(pcfg, {k: _t(v) for k, v in dl_tbs.items()},
                                {k: _t(v) for k, v in ul_tbs.items()}, torch.Generator())
    for kind, tbs in (("dl", dl_tbs), ("ul", ul_tbs)):
        for sf, tb in tbs.items():
            bits, ok = out[kind][sf]
            assert ok.all() and (bits.numpy() == tb).all(), (kind, sf)
    acked = {ack: [dl for dl, _ in items] for ack, items in out["acks"].items()}
    assert acked == {7: [0, 1], 8: [4]}
    assert all(p_tdd.sf_type(1, s) == "U" for s in out["acks"])
    _, ref = _jax_stubbed(lambda k: j_tdd_frame.run_frame(jcfg, dl_tbs, ul_tbs, k), cws,
                          jax.random.PRNGKey(1))
    assert len(ref) == len(port_llrs) == len(order)
    for got, want in zip(port_llrs, ref):
        assert got.shape == want.shape and _rel_rms(got, want) < DFT_REL


# ---------------- multi-cell ----------------

def _cell_cfgs(pci, prb_lo, prb_hi, n_prb=25, rnti=0x50):
    """test_multicell.py's _cell_cfg, for each package."""
    out = []
    for grid_mod, pdcch_mod, enb_mod in ((p_grid, p_pdcch, p_enb_dl), (j_grid, j_pdcch, j_enb_dl)):
        cell = grid_mod.CellConfig(n_prb=n_prb, cell_id=pci, cfi=2)
        cand = next(c for c in pdcch_mod.candidates(cell, rnti, 1) if c[0] == 4)
        mask = tuple(1 if prb_lo <= i < prb_hi else 0 for i in range(n_prb))
        tbs = (grid_mod.nof_re(cell, 1, mask) * 2 // 3) // 8 * 8
        out.append(enb_mod.DlSubframeConfig(cell=cell, sf_idx=1,
                                            grants=((rnti, mask, 2, tbs, *cand),)))
    assert out[0].grants == out[1].grants
    return out


def _gains(matrix_db):
    lin = 10 ** (-np.asarray(matrix_db, np.float64) / 20.0)
    g = np.zeros(lin.shape + (2,), np.float32)
    g[..., 0] = lin
    return g


def _multicell_both(monkeypatch, port_llrs, cells, serving, grant_of, snr_db, gains, payloads):
    """The port's step and the JAX package's (stubbed) on the same noise;
    the JAX LLRs and SNR estimates equal the port's."""
    pcfg = p_multicell.MulticellConfig(cells=tuple(c[0] for c in cells), serving=serving,
                                       grant_of=grant_of, snr_db=snr_db)
    jcfg = j_multicell.MulticellConfig(cells=tuple(c[1] for c in cells), serving=serving,
                                       grant_of=grant_of, snr_db=snr_db)
    T = 7680
    noise = np.random.default_rng(5).normal(size=(1, T, 2)).astype(np.float32)
    _awgn_patch(monkeypatch, [noise] * len(serving))  # one draw serves every UE
    n_llrs = len(port_llrs)
    res = p_multicell.step(pcfg, [[_t(p)] for p in payloads], gains, torch.Generator())
    cws = [p_sch.encode_tb(_t(p), c[0].sch_cfg(0)).numpy() for p, c in zip(payloads, cells)]
    jres, ref = _jax_stubbed(lambda g, k: j_multicell.step(jcfg, [[p] for p in payloads], g, k),
                             cws, gains, jax.random.PRNGKey(1))
    assert len(ref) == len(port_llrs) - n_llrs == len(serving)
    for got, want in zip(port_llrs[n_llrs:], ref):
        assert _rel_rms(got, want) < DFT_REL
    for (_, _, snr), (_, _, jsnr) in zip(res, jres):
        np.testing.assert_allclose(snr.numpy(), np.asarray(jsnr), rtol=DFT_REL)
    return res


def test_two_cells_orthogonal_prbs_both_decode(monkeypatch, port_llrs):
    ca, cb = _cell_cfgs(3, 0, 10), _cell_cfgs(6, 14, 24)
    rng = np.random.default_rng(0)
    pa = rng.integers(0, 2, (1, ca[0].grants[0][3]), dtype=np.int8)
    pb = rng.integers(0, 2, (1, cb[0].grants[0][3]), dtype=np.int8)
    gains = _gains([[0.0, 6.0], [6.0, 0.0]])  # each UE 6 dB nearer its own cell
    res = _multicell_both(monkeypatch, port_llrs, (ca, cb), (0, 1), (0, 0), 25.0, gains, (pa, pb))
    assert res[0][0].all() and res[1][0].all()
    np.testing.assert_array_equal(res[0][1].numpy(), pa)
    np.testing.assert_array_equal(res[1][1].numpy(), pb)


def test_multicell_one_noise_draw_per_step(monkeypatch):
    """Every UE of a step gets the same standard-normal draw (the reference
    uses one key for all), scaled by its own signal power; the generator
    advances once per step."""
    ca, cb = _cell_cfgs(3, 0, 10), _cell_cfgs(6, 14, 24)
    cfg = p_multicell.MulticellConfig(cells=(ca[0], cb[0]), serving=(0, 1), grant_of=(0, 0))
    rng = np.random.default_rng(1)
    payloads = [[_t(rng.integers(0, 2, (1, c[0].grants[0][3]), dtype=np.int8))] for c in (ca, cb)]
    draws, awgn = [], p_channel.awgn

    def spy(gen, x, snr_db, signal_power=None):
        y = awgn(gen, x, snr_db)
        p = p_cplx.abs2(x).reshape(x.shape[0], -1).mean(dim=-1)
        draws.append((y - x) / torch.sqrt(p / 10 ** (snr_db / 10) / 2)[:, None, None])
        return y

    monkeypatch.setattr(p_channel, "awgn", spy)
    gen = torch.Generator().manual_seed(3)
    p_multicell.step(cfg, payloads, _gains([[0.0, 6.0], [6.0, 0.0]]), gen)
    assert len(draws) == 2 and torch.allclose(draws[0], draws[1], rtol=1e-4, atol=1e-4)
    once = torch.Generator().manual_seed(3)
    torch.randn(draws[0].shape, generator=once)
    assert torch.equal(gen.get_state(), once.get_state())


def test_cochannel_collision_fails_then_capture(monkeypatch, port_llrs):
    """Same PRBs in both cells: at 0 dB C/I the victim fails; at 20 dB C/I
    it captures."""
    ca, cb = _cell_cfgs(3, 0, 12), _cell_cfgs(6, 0, 12)
    rng = np.random.default_rng(2)
    pa = rng.integers(0, 2, (1, ca[0].grants[0][3]), dtype=np.int8)
    pb = rng.integers(0, 2, (1, cb[0].grants[0][3]), dtype=np.int8)
    equal = _multicell_both(monkeypatch, port_llrs, (ca, cb), (0,), (0,), 30.0,
                            _gains([[0.0, 0.0]]), (pa, pb))
    assert not equal[0][0].any(), "equal-power collision decoded"
    capture = _multicell_both(monkeypatch, port_llrs, (ca, cb), (0,), (0,), 30.0,
                              _gains([[0.0, 20.0]]), (pa, pb))
    assert capture[0][0].all() and (capture[0][1].numpy() == pa).all()
