"""PyTorch port vs the JAX package: the control channels and their host
tables (bits, scrambling, mimo SFBC, regs, ra, dci, pcfich, phich, pdcch,
pbch, sync's eNB side).

Tables, bits, CRC flags and decisions must be equal.  Grids built from the
same bits agree to float32 rounding (rtol 1e-5, atol 1e-6); PCFICH
correlations and PHICH soft metrics to atol 1e-3, rtol 1e-2.  Receivers see
the same numpy grid: the transmit grid times a random per-RE channel, plus
numpy noise, with that channel as the estimate.  The JAX receivers run
under jax.jit (op by op they compile each op on first use, several times
slower here); the Viterbi-bearing ones once per module for their static
arguments.
"""

import dataclasses
import filecmp
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srslte_emane_tpu.ops import bits as j_bits
from srslte_emane_tpu.ops import cplx as j_cplx
from srslte_emane_tpu.ops import mimo as j_mimo
from srslte_emane_tpu.ops import scrambling as j_scr
from srslte_emane_tpu.phch import dci as j_dci
from srslte_emane_tpu.phch import grid as j_grid
from srslte_emane_tpu.phch import pbch as j_pbch
from srslte_emane_tpu.phch import pcfich as j_pcfich
from srslte_emane_tpu.phch import pdcch as j_pdcch
from srslte_emane_tpu.phch import phich as j_phich
from srslte_emane_tpu.phch import ra as j_ra
from srslte_emane_tpu.phch import regs as j_regs
from srslte_emane_tpu.phch import sync as j_sync
from srslte_emane_tpu_torch.ops import bits as p_bits
from srslte_emane_tpu_torch.ops import cplx as p_cplx
from srslte_emane_tpu_torch.ops import mimo as p_mimo
from srslte_emane_tpu_torch.ops import scrambling as p_scr
from srslte_emane_tpu_torch.ops.fec import viterbi as p_vit
from srslte_emane_tpu_torch.phch import dci as p_dci
from srslte_emane_tpu_torch.phch import grid as p_grid
from srslte_emane_tpu_torch.phch import pbch as p_pbch
from srslte_emane_tpu_torch.phch import pcfich as p_pcfich
from srslte_emane_tpu_torch.phch import pdcch as p_pdcch
from srslte_emane_tpu_torch.phch import phich as p_phich
from srslte_emane_tpu_torch.phch import ra as p_ra
from srslte_emane_tpu_torch.phch import regs as p_regs
from srslte_emane_tpu_torch.phch import sync as p_sync

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

RTOL, ATOL = 1e-5, 1e-6  # same bits in, float32 rounding only
SOFT_RTOL, SOFT_ATOL = 1e-2, 1e-3  # PCFICH correlations, PHICH soft metrics
N_PRBS = (6, 15, 25, 50, 75, 100)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _cells(**kw):
    return p_grid.CellConfig(**kw), j_grid.CellConfig(**kw)


def _zero_grid(cell, B):
    return np.zeros((B, p_grid.N_SYM, cell.nre, 2), np.float32)


def _channel(grid, snr_db, seed, flat=False):
    """(rx, ce): grid times a random per-RE channel (one gain per row when
    `flat`, as SFBC combining assumes) plus complex noise at snr_db against
    unit power, both float32 numpy."""
    rng = np.random.default_rng(seed)
    shape = (grid.shape[0],) + (1,) * (grid.ndim - 2) if flat else grid.shape[:-1]
    h = (0.5 + rng.random(shape)) * np.exp(2j * np.pi * rng.random(shape))
    x = j_cplx.to_numpy(grid) * h
    h = np.broadcast_to(h, x.shape)
    sigma = np.sqrt(10 ** (-snr_db / 10) / 2)
    rx = x + sigma * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
    f = lambda z: np.stack([z.real, z.imag], -1).astype(np.float32)
    return f(rx), f(h)


@functools.lru_cache(maxsize=None)
def _jax_blind_search(cell_j, sf, rnti, n):
    """(jitted JAX blind_search on (rx, ce) -> (bits, ok), its candidate
    list, filled while tracing)."""
    cands = []

    def search(rx, ce):
        out, ok, c = j_pdcch.blind_search(rx, ce, cell_j, sf, rnti, n)
        cands[:] = c
        return out, ok

    return jax.jit(search), cands


@functools.lru_cache(maxsize=None)
def _jax_pbch_decode(cell_j):
    """Jitted JAX pbch.decode on (rx, ce, ce_port1); a ce_port1 equal to ce
    is what ce_port1=None means."""
    return jax.jit(lambda rx, ce, ce1: j_pbch.decode(rx, ce, cell_j, ce_port1=ce1))


def _count_viterbi(monkeypatch):
    calls = []
    decode = p_vit.viterbi_decode

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return decode(*args, **kw)

    monkeypatch.setattr(p_vit, "viterbi_decode", counted)
    return calls


# ---------------- bits, scrambling, SFBC ----------------

def test_bits_pack_unpack():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (3, 17), dtype=np.uint8)
    bits = p_bits.unpack_bits(_t(data))
    assert bits.dtype == torch.int8
    np.testing.assert_array_equal(bits.numpy(), np.asarray(j_bits.unpack_bits(data)))
    packed = p_bits.pack_bits(bits)
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(), np.asarray(j_bits.pack_bits(np.asarray(bits))))
    np.testing.assert_array_equal(packed.numpy(), data)
    raw = bytes(data[0])
    np.testing.assert_array_equal(p_bits.bytes_to_bits(raw), j_bits.bytes_to_bits(raw))
    assert p_bits.bits_to_bytes(p_bits.bytes_to_bits(raw)) == j_bits.bits_to_bytes(
        j_bits.bytes_to_bits(raw)) == raw


def test_control_cinits():
    for sf in range(10):
        for cell_id in (0, 1, 77, 123, 301, 503):
            assert p_scr.pcfich_cinit(sf, cell_id) == j_scr.pcfich_cinit(sf, cell_id)
            assert p_scr.pdcch_cinit(sf, cell_id) == j_scr.pdcch_cinit(sf, cell_id)
            assert p_scr.pbch_cinit(cell_id) == j_scr.pbch_cinit(cell_id)


@pytest.mark.parametrize("n_layers", [1, 2, 4])
def test_layer_map_and_sfbc(n_layers):
    rng = np.random.default_rng(n_layers)
    d = rng.normal(size=(2, 24, 2)).astype(np.float32)
    layers_j = np.asarray(j_mimo.layer_map([d], n_layers))
    layers_p = p_mimo.layer_map([_t(d)], n_layers)
    np.testing.assert_array_equal(layers_p.numpy(), layers_j)
    np.testing.assert_array_equal(p_mimo.layer_demap(layers_p, 1)[0].numpy(), d)
    if n_layers != 2:
        return
    d2 = rng.normal(size=(2, 12, 2)).astype(np.float32)
    for cw0, cw1, n in ((d2, d[:, :12], 2), (d2, d, 3), (d, d, 4)):  # two codewords
        two_j = np.asarray(j_mimo.layer_map([cw0, cw1], n))
        two_p = p_mimo.layer_map([_t(cw0), _t(cw1)], n)
        np.testing.assert_array_equal(two_p.numpy(), two_j)
        if n == 2:
            for got, ref in zip(p_mimo.layer_demap(two_p, 2), (cw0, cw1)):
                np.testing.assert_array_equal(got.numpy(), ref)
    ports_j = np.asarray(j_mimo.precode_sfbc(layers_j))
    ports_p = p_mimo.precode_sfbc(layers_p)
    np.testing.assert_allclose(ports_p.numpy(), ports_j, rtol=RTOL, atol=ATOL)
    h = rng.normal(size=(2, 2, 24, 2)).astype(np.float32)
    y = rng.normal(size=(2, 24, 2)).astype(np.float32)
    for got, ref in zip(p_mimo.decode_sfbc(_t(y), _t(h)), j_mimo.decode_sfbc(y, h)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(p_cplx.conj(_t(y)).numpy(), np.asarray(j_cplx.conj(y)))


# ---------------- host tables: regs, ra, dci, search spaces, RE maps, sync ----------------

@pytest.mark.parametrize("n_prb,cell_id,n_ports", [(6, 0, 1), (15, 301, 2), (25, 123, 1),
                                                   (50, 17, 4), (100, 1, 1)])
def test_regs_tables_equal(n_prb, cell_id, n_ports):
    regs_p = p_regs.reg_table(n_prb, cell_id, n_ports)
    regs_j = j_regs.reg_table(n_prb, cell_id, n_ports)
    assert len(regs_p) == len(regs_j)
    for a, b in zip(regs_p, regs_j):
        assert (a["l"], a["k0"]) == (b["l"], b["k0"])
        np.testing.assert_array_equal(a["k"], b["k"])
    for ng in ("1/6", "1/2", "1", "2"):
        ch_p = p_regs.channel_regs(n_prb, cell_id, n_ports, ng)
        ch_j = j_regs.channel_regs(n_prb, cell_id, n_ports, ng)
        np.testing.assert_array_equal(ch_p["pcfich"], ch_j["pcfich"])
        np.testing.assert_array_equal(ch_p["phich"], ch_j["phich"])
        assert ch_p["pdcch"].keys() == ch_j["pdcch"].keys()
        for cfi in ch_j["pdcch"]:
            np.testing.assert_array_equal(ch_p["pdcch"][cfi], ch_j["pdcch"][cfi])
        ids = ch_j["phich"]
        np.testing.assert_array_equal(p_regs.reg_re_indices(n_prb, cell_id, n_ports, ids),
                                      j_regs.reg_re_indices(n_prb, cell_id, n_ports, ids))


def test_ra_copied_and_equal():
    port = pathlib.Path(p_ra.__file__).parent / "tbs_tables.npz"
    assert filecmp.cmp(port, pathlib.Path(j_ra.__file__).parent / "tbs_tables.npz", shallow=False)
    for n_prb in N_PRBS:
        assert p_ra.rbg_size(n_prb) == j_ra.rbg_size(n_prb)
        for riv in range(n_prb * (n_prb + 1) // 2):
            assert p_ra.riv_decode(riv, n_prb) == j_ra.riv_decode(riv, n_prb)
        for s, l in ((0, 1), (2, 3), (0, n_prb), (n_prb - 1, 1), (1, n_prb - 1)):
            assert p_ra.riv_encode(s, l, n_prb) == j_ra.riv_encode(s, l, n_prb)
            assert p_ra.type2_to_prb_mask(s, l, n_prb) == j_ra.type2_to_prb_mask(s, l, n_prb)
        for bitmap in (0, 1, 0b1011, (1 << 9) - 1):
            assert p_ra.type0_to_prb_mask(bitmap, n_prb) == j_ra.type0_to_prb_mask(bitmap, n_prb)
            if n_prb > 10:
                p = p_ra.rbg_size(n_prb)
                for subset in range(p):
                    for shift in (0, 1):
                        assert p_ra.type1_to_prb_mask(subset, shift, bitmap, n_prb) == \
                            j_ra.type1_to_prb_mask(subset, shift, bitmap, n_prb)
    for mcs in range(29):
        assert p_ra.dl_mcs_to_qm(mcs) == j_ra.dl_mcs_to_qm(mcs)
        assert p_ra.ul_mcs_to_qm(mcs) == j_ra.ul_mcs_to_qm(mcs)
        for n_prb in (1, 6, 50, 110):
            assert p_ra.dl_tbs(mcs, n_prb) == j_ra.dl_tbs(mcs, n_prb)
            assert p_ra.ul_tbs(mcs, n_prb) == j_ra.ul_tbs(mcs, n_prb)
    for mcs in range(28):
        assert p_ra.dl_mcs_to_qm(mcs, True) == j_ra.dl_mcs_to_qm(mcs, True)
        assert p_ra.dl_tbs(mcs, 25, True) == j_ra.dl_tbs(mcs, 25, True)
        assert p_ra.dl_tbs_ra_format1a_common(mcs, 1) == j_ra.dl_tbs_ra_format1a_common(mcs, 1)


@pytest.mark.parametrize("n_prb", N_PRBS)
def test_dci_every_format_equal(n_prb):
    """Every format's length, pack and unpack, on random field values."""
    rng = np.random.default_rng(n_prb)
    r = lambda n_bits: int(rng.integers(0, 1 << n_bits))
    asdict = dataclasses.asdict
    for fn in ("riv_len", "format0_1a_len", "format1_len", "format1c_len", "format1bd_len"):
        assert getattr(p_dci, fn)(n_prb) == getattr(j_dci, fn)(n_prb), fn
    for fmt in ("2", "2A", "2B"):
        assert p_dci.format2_len(n_prb, fmt) == j_dci.format2_len(n_prb, fmt)
    n_rbg = -(-n_prb // j_ra.rbg_size(n_prb))
    for _ in range(4):
        start = int(rng.integers(0, n_prb))
        length = int(rng.integers(1, n_prb - start + 1))
        fields = dict(mcs=r(5), harq_pid=r(3), ndi=r(1), rv=r(2), tpc=r(2), rb_start=start,
                      l_crbs=length, rbg_bitmap=r(n_rbg))
        for fmt in ("1A", "1"):
            bits_p = p_dci.pack_dl(p_dci.DciDl(fmt, **fields), n_prb)
            bits_j = j_dci.pack_dl(j_dci.DciDl(fmt, **fields), n_prb)
            np.testing.assert_array_equal(bits_p, bits_j)
            assert asdict(p_dci.unpack_dl(bits_j, n_prb, fmt)) == \
                asdict(j_dci.unpack_dl(bits_j, n_prb, fmt))
        ul = dict(mcs=r(5), ndi=r(1), tpc=r(2), rb_start=start, l_crbs=length, dmrs_cs=r(3),
                  cqi_req=r(1), hopping=r(1))
        bits_p = p_dci.pack_ul(p_dci.DciUl(**ul), n_prb)
        np.testing.assert_array_equal(bits_p, j_dci.pack_ul(j_dci.DciUl(**ul), n_prb))
        assert asdict(p_dci.unpack_ul(bits_p, n_prb)) == asdict(j_dci.unpack_ul(bits_p, n_prb))
        assert p_dci.is_format0(bits_p) == j_dci.is_format0(bits_p)
        tbs_idx = r(5)
        bits_p = p_dci.pack_dl_1c(start, length, tbs_idx, n_prb)
        np.testing.assert_array_equal(bits_p, j_dci.pack_dl_1c(start, length, tbs_idx, n_prb))
        assert p_dci.unpack_dl_1c(bits_p, n_prb) == j_dci.unpack_dl_1c(bits_p, n_prb)
        for fmt in ("1B", "1D"):
            tpmi, extra = r(2), r(1)
            bits_p = p_dci.pack_dl_1bd(p_dci.DciDl(fmt, **fields), n_prb, fmt, tpmi, extra)
            np.testing.assert_array_equal(
                bits_p, j_dci.pack_dl_1bd(j_dci.DciDl(fmt, **fields), n_prb, fmt, tpmi, extra))
            (d_p, *rest_p), (d_j, *rest_j) = (p_dci.unpack_dl_1bd(bits_p, n_prb, fmt),
                                              j_dci.unpack_dl_1bd(bits_p, n_prb, fmt))
            assert asdict(d_p) == asdict(d_j) and rest_p == rest_j
        two = dict(rbg_bitmap=r(n_rbg), tpc=r(2), harq_pid=r(3), cw_swap=r(1), mcs1=r(5),
                   ndi1=r(1), rv1=r(2), mcs2=r(5), ndi2=r(1), rv2=r(2), precoding_info=r(3),
                   n_scid=r(1))
        for fmt in ("2", "2A", "2B"):
            bits_p = p_dci.pack_dl_2(p_dci.DciDl2(fmt, **two), n_prb)
            np.testing.assert_array_equal(bits_p, j_dci.pack_dl_2(j_dci.DciDl2(fmt, **two), n_prb))
            assert asdict(p_dci.unpack_dl_2(bits_p, n_prb, fmt)) == \
                asdict(j_dci.unpack_dl_2(bits_p, n_prb, fmt))


@pytest.mark.parametrize("n_prb,cell_id,cfi", [(6, 301, 2), (15, 3, 2), (25, 77, 2),
                                               (100, 1, 2), (100, 1, 3)])
def test_search_spaces_and_re_tables_equal(n_prb, cell_id, cfi):
    cell_p, cell_j = _cells(n_prb=n_prb, cell_id=cell_id, cfi=cfi)
    assert p_pdcch.n_cce(cell_p) == j_pdcch.n_cce(cell_j)
    np.testing.assert_array_equal(p_pdcch.cce_re_indices(cell_p), j_pdcch.cce_re_indices(cell_j))
    assert p_pdcch.full_space(cell_p) == j_pdcch.full_space(cell_j)
    rntis = [0x46, 0x47, 0x48, 0x49, 0x50, 0x1234, 0xFFFF]
    for sf in range(10):
        for rnti in rntis:
            assert p_pdcch.ue_yk(rnti, sf) == j_pdcch.ue_yk(rnti, sf)
            assert p_pdcch.candidates(cell_p, rnti, sf) == j_pdcch.candidates(cell_j, rnti, sf)
        for l_pref in (1, 2, 4):
            assert p_pdcch.allocate_cces(cell_p, rntis, sf, l_pref) == \
                j_pdcch.allocate_cces(cell_j, rntis, sf, l_pref)
    np.testing.assert_array_equal(p_pcfich.re_indices(cell_p), j_pcfich.re_indices(cell_j))
    np.testing.assert_array_equal(p_pbch.re_indices(cell_p), j_pbch.re_indices(cell_j))
    for ng in ("1/6", "1"):
        assert p_phich.n_groups(n_prb, ng) == j_phich.n_groups(n_prb, ng)
        np.testing.assert_array_equal(p_phich.re_indices(cell_p, ng), j_phich.re_indices(cell_j, ng))
    for sf in (0, 4, 9):
        np.testing.assert_array_equal(p_phich._spread_matrix(cell_id, sf),
                                      j_phich._spread_matrix(cell_id, sf))
    for args in ((0, 0, 13), (24, 3, 13), (7, 5, 2)):
        assert p_phich.alloc(*args) == j_phich.alloc(*args)
    np.testing.assert_array_equal(p_pcfich.CFI_CODEWORDS, j_pcfich.CFI_CODEWORDS)
    for ports in (1, 2, 4):
        np.testing.assert_array_equal(p_pbch.PORT_MASKS[ports], j_pbch.PORT_MASKS[ports])


def test_sync_sequences_and_placement():
    for n_id_2 in range(3):
        np.testing.assert_array_equal(p_sync.pss_freq(n_id_2), j_sync.pss_freq(n_id_2))
        for fft in (128, 512):
            np.testing.assert_array_equal(p_sync.pss_time(n_id_2, fft), j_sync.pss_time(n_id_2, fft))
        for n_id_1 in (0, 29, 30, 111, 167):
            for sf in (0, 5):
                np.testing.assert_array_equal(p_sync.sss_sequence(n_id_1, n_id_2, sf),
                                              j_sync.sss_sequence(n_id_1, n_id_2, sf))
    for n_prb in N_PRBS:
        assert p_sync.pss_symbol_start(n_prb) == j_sync.pss_symbol_start(n_prb)
    for cp in ("normal", "ext"):
        cell_p, cell_j = _cells(n_prb=25, cell_id=123, cp=cp)
        for sf in (0, 1, 5):
            g = np.random.default_rng(sf).normal(size=(2, cell_p.n_sym, cell_p.nre, 2))
            g = g.astype(np.float32)
            np.testing.assert_array_equal(p_sync.put_pss_sss(_t(g), cell_p, sf).numpy(),
                                          np.asarray(j_sync.put_pss_sss(jnp.asarray(g), cell_j, sf)))


# ---------------- channels: encode and decode against the JAX package ----------------

CELL_KW = dict(n_prb=25, cell_id=77, cfi=2)


@pytest.mark.parametrize("n_ports", [1, 2])
def test_pcfich_encode_decode(n_ports):
    cell_p, cell_j = _cells(**CELL_KW, n_ports=n_ports)
    sf = 4
    cfis = np.array([1, 2, 3])
    g_j = np.asarray(jax.jit(lambda c, g: j_pcfich.encode(c, cell_j, sf, g))(
        cfis, _zero_grid(cell_p, 3)))
    g_p = p_pcfich.encode(_t(cfis), cell_p, sf, _t(_zero_grid(cell_p, 3)))
    np.testing.assert_allclose(g_p.numpy(), g_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(p_pcfich.encode(2, cell_p, sf, _t(_zero_grid(cell_p, 3)))[1],
                                  g_p[1])
    rx, ce = _channel(g_j, 0.0, seed=n_ports, flat=n_ports == 2)
    # 2 ports: a zero port-1 estimate makes the SFBC combiner a scaled ZF
    ce1 = np.zeros_like(ce) if n_ports == 2 else None
    cfi_j, corr_j = jax.jit(lambda rx, ce, ce1: j_pcfich.decode(rx, ce, cell_j, sf, ce_port1=ce1))(
        rx, ce, ce1)
    cfi_p, corr_p = p_pcfich.decode(_t(rx), _t(ce), cell_p, sf,
                                    ce_port1=None if ce1 is None else _t(ce1))
    np.testing.assert_array_equal(cfi_p.numpy(), np.asarray(cfi_j))
    np.testing.assert_array_equal(cfi_p.numpy(), cfis)
    np.testing.assert_allclose(corr_p.numpy(), np.asarray(corr_j), rtol=SOFT_RTOL, atol=SOFT_ATOL)


def test_pcfich_tie_picks_the_first_cfi():
    """All three correlations equal (nothing received): CFI 1 in both."""
    cell_p, cell_j = _cells(**CELL_KW)
    rx, ce = _zero_grid(cell_p, 2), np.ones_like(_zero_grid(cell_p, 2))
    cfi_j, corr_j = jax.jit(lambda rx, ce: j_pcfich.decode(rx, ce, cell_j, 1))(rx, ce)
    cfi_p, corr_p = p_pcfich.decode(_t(rx), _t(ce), cell_p, 1)
    assert (corr_p == 0).all() and (np.asarray(corr_j) == 0).all()
    np.testing.assert_array_equal(cfi_p.numpy(), np.asarray(cfi_j))
    assert (cfi_p == 1).all()


def test_phich_encode_decode():
    cell_p, cell_j = _cells(**CELL_KW)
    sf = 3
    ng = p_phich.n_groups(cell_p.n_prb)
    acks = np.random.default_rng(0).choice([-1, 0, 1], size=(2, ng, 8)).astype(np.float32)
    g_j = np.asarray(jax.jit(lambda a, g: j_phich.encode(a, cell_j, sf, g))(
        acks, _zero_grid(cell_p, 2)))
    g_p = p_phich.encode(_t(acks), cell_p, sf, _t(_zero_grid(cell_p, 2)))
    np.testing.assert_allclose(g_p.numpy(), g_j, rtol=RTOL, atol=ATOL)
    rx, ce = _channel(g_j, 15.0, seed=3)
    m_j = np.asarray(jax.jit(lambda rx, ce: j_phich.decode(rx, ce, cell_j, sf))(rx, ce))
    m_p = p_phich.decode(_t(rx), _t(ce), cell_p, sf).numpy()
    np.testing.assert_allclose(m_p, m_j, rtol=SOFT_RTOL, atol=SOFT_ATOL)
    on = acks != 0
    np.testing.assert_array_equal(np.sign(m_p[on]), acks[on])


def _dci_grid(cell_p, cell_j, rnti, l_aggr, start, sf, B=2):
    """(dci bits (B, n), the JAX grid, the port grid) of one DCI 1A."""
    d = j_dci.DciDl("1A", mcs=12, harq_pid=2, ndi=1, rv=0, rb_start=1, l_crbs=4)
    bits = np.tile(j_dci.pack_dl(d, cell_p.n_prb), (B, 1))
    g_j = np.asarray(jax.jit(lambda b, g: j_pdcch.encode(b, rnti, l_aggr, start, cell_j, sf, g))(
        bits, _zero_grid(cell_p, B)))
    g_p = p_pdcch.encode(_t(bits), rnti, l_aggr, start, cell_p, sf, _t(_zero_grid(cell_p, B)))
    return bits, g_j, g_p


@pytest.mark.parametrize("l_aggr,rnti", [(1, 0x50), (2, 0x46), (4, 0x46), (8, 0xFFFF)])
def test_pdcch_encode_and_blind_search(l_aggr, rnti, monkeypatch):
    """At each aggregation level: the encoded grid, then blind_search's
    bits, CRC flags and candidate order equal the JAX package's, with
    exactly one Viterbi call for all levels' candidates."""
    cell_p, cell_j = _cells(**CELL_KW)
    sf = 3
    start = next(s for l, s in p_pdcch.candidates(cell_p, rnti, sf) if l == l_aggr)
    bits, g_j, g_p = _dci_grid(cell_p, cell_j, rnti, l_aggr, start, sf)
    np.testing.assert_allclose(g_p.numpy(), g_j, rtol=RTOL, atol=ATOL)
    dyn_p = p_pdcch.encode_dyn(_t(bits), torch.tensor(rnti), l_aggr, torch.tensor(start),
                               cell_p, sf, _t(_zero_grid(cell_p, 2)))
    assert torch.equal(dyn_p, g_p)
    dyn_j = jax.jit(lambda b, r, s, g: j_pdcch.encode_dyn(b, r, l_aggr, s, cell_j, sf, g))(
        bits, rnti, start, _zero_grid(cell_p, 2))
    np.testing.assert_allclose(dyn_p.numpy(), np.asarray(dyn_j), rtol=RTOL, atol=ATOL)

    rx, ce = _channel(g_j, 8.0, seed=l_aggr)
    n = bits.shape[1]
    search_j, cands_j = _jax_blind_search(cell_j, sf, rnti, n)
    out_j, ok_j = search_j(rx, ce)
    calls = _count_viterbi(monkeypatch)
    out_p, ok_p, cands_p = p_pdcch.blind_search(_t(rx), _t(ce), cell_p, sf, rnti, n)
    assert len(calls) == 1 and calls[0][0] == 2 * len(cands_p), calls
    assert cands_p == cands_j
    np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(out_p.numpy(), np.asarray(out_j))
    ci = cands_p.index((l_aggr, start))
    assert ok_p[:, ci].all()
    np.testing.assert_array_equal(out_p[:, ci].numpy(), bits)


def test_blind_search_all_equal(monkeypatch):
    cell_p, cell_j = _cells(**CELL_KW)
    sf, rnti = 3, 0x46
    l_aggr, start = next(c for c in p_pdcch.candidates(cell_p, rnti, sf) if c[0] == 2)
    bits, g_j, _ = _dci_grid(cell_p, cell_j, rnti, l_aggr, start, sf)
    rx, ce = _channel(g_j, 8.0, seed=9)
    pos_j = []

    def search_j(rx, ce):
        out, resid, pos = j_pdcch.blind_search_all(rx, ce, cell_j, sf, bits.shape[1])
        pos_j.extend(pos)  # host list, filled while tracing
        return out, resid

    out_j, resid_j = jax.jit(search_j)(rx, ce)
    calls = _count_viterbi(monkeypatch)
    out_p, resid_p, pos_p = p_pdcch.blind_search_all(_t(rx), _t(ce), cell_p, sf, bits.shape[1])
    assert len(calls) == 1 and calls[0][0] == 2 * len(pos_p), calls
    assert pos_p == list(pos_j)
    assert resid_p.dtype == torch.int32
    np.testing.assert_array_equal(resid_p.numpy(), np.asarray(resid_j))
    np.testing.assert_array_equal(out_p.numpy(), np.asarray(out_j))
    assert (resid_p[:, pos_p.index((l_aggr, start))] == rnti).all()


@pytest.mark.parametrize("n_ports,sfn", [(1, 8), (2, 5), (4, 2)])
def test_pbch_encode_decode(n_ports, sfn, monkeypatch):
    """MIB, port count, SFN offset and CRC flags equal the JAX package's,
    with the 12 hypotheses' 8 distinct LLR rows in one Viterbi call.  The
    transmitter places one stream whatever the port count, so a zero port-1
    estimate makes the SFBC hypotheses a scaled ZF and the port count shows
    in the CRC mask."""
    cell_p, cell_j = _cells(n_prb=6, cell_id=301, n_ports=n_ports)
    mib = np.tile(p_pbch.pack_mib(6, sfn), (2, 1))
    g_j = np.asarray(jax.jit(lambda m, g: j_pbch.encode(m, cell_j, sfn, g))(
        mib, _zero_grid(cell_p, 2)))
    g_p = p_pbch.encode(_t(mib), cell_p, sfn, _t(_zero_grid(cell_p, 2)))
    np.testing.assert_allclose(g_p.numpy(), g_j, rtol=RTOL, atol=ATOL)
    rx, ce = _channel(g_j, 5.0, seed=n_ports, flat=True)
    ce1 = np.zeros_like(ce) if n_ports > 1 else None
    out_j = _jax_pbch_decode(cell_j)(rx, ce, ce if ce1 is None else ce1)
    calls = _count_viterbi(monkeypatch)
    out_p = p_pbch.decode(_t(rx), _t(ce), cell_p, ce_port1=None if ce1 is None else _t(ce1))
    assert len(calls) == 1 and tuple(calls[0]) == (2 * 8, 3, 40), calls
    for got, ref in zip(out_p, out_j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    mib_p, ports, off, ok = out_p
    assert ok.all() and (ports == n_ports).all() and (off == sfn % 4).all()
    np.testing.assert_array_equal(mib_p.numpy(), mib)
    assert p_pbch.unpack_mib(mib[0]) == j_pbch.unpack_mib(mib[0])
    assert p_pbch.unpack_mib(mib[0])["sfn_msb"] == sfn >> 2


def test_pbch_tie_picks_the_first_hypothesis():
    """All-zero LLRs decode to all-zero bits, which pass the 1-port CRC at
    every frame offset: both packages take offset 0."""
    cell_p, cell_j = _cells(n_prb=6, cell_id=301)
    rx, ce = _zero_grid(cell_p, 2), np.ones_like(_zero_grid(cell_p, 2))
    out_j = _jax_pbch_decode(cell_j)(rx, ce, ce)
    out_p = p_pbch.decode(_t(rx), _t(ce), cell_p)
    for got, ref in zip(out_p, out_j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    mib, ports, off, ok = out_p
    assert ok.all() and (off == 0).all() and (ports == 1).all() and (mib == 0).all()


def test_pack_mib_equal():
    for n_prb in N_PRBS:
        for sfn in (0, 8, 513, 1023):
            for res in ("1/6", "1/2", "1", "2"):
                np.testing.assert_array_equal(p_pbch.pack_mib(n_prb, sfn, res, sfn & 1),
                                              j_pbch.pack_mib(n_prb, sfn, res, sfn & 1))
                bits = p_pbch.pack_mib(n_prb, sfn, res)
                assert p_pbch.unpack_mib(bits) == j_pbch.unpack_mib(bits)
