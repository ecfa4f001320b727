"""The plain reference against the program (srslte_emane_tpu_torch) on the
CPU, at 15 PRB (two code-block sizes, fillers, as at 100 PRB)."""

import dataclasses

import numpy as np
import pytest
import torch

from ltebench.reference import link as ref_link
from ltebench.reference import tables
from ltebench.reference import turbo as ref_turbo
from srslte_emane_tpu_torch.models import pdsch_link
from srslte_emane_tpu_torch.ops import sequence
from srslte_emane_tpu_torch.ops.fec import cbsegm, crc, rm_turbo, turbo, turbodecoder
from srslte_emane_tpu_torch.phch import grid

LINK = tables.Link(n_prb=15, cell_id=1, cfi=1, sf_idx=1, rnti=70, qm=6, code_rate=0.55,
                   max_iter=8, llr_bits=16)
B = 2


def program_config(lnk: tables.Link) -> pdsch_link.LinkConfig:
    return pdsch_link.LinkConfig(
        cell=grid.CellConfig(n_prb=lnk.n_prb, cell_id=lnk.cell_id, cfi=lnk.cfi),
        sf_idx=lnk.sf_idx, rnti=lnk.rnti, qm=lnk.qm, code_rate=lnk.code_rate,
        max_iter=lnk.max_iter, llr_bits=lnk.llr_bits)


def rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def payload():
    g = torch.Generator().manual_seed(3)
    return torch.randint(0, 2, (B, LINK.tbs), generator=g, dtype=torch.int8)


@pytest.mark.parametrize("c_init,n", [(0, 100), (1, 5000), (2 ** 31 - 1, 777), (0x46 << 14 | 513, 4000)])
def test_gold_equals_the_lfsr(c_init, n):
    assert np.array_equal(tables.gold(c_init, n), sequence.gold_sequence_host(c_init, n))


@pytest.mark.parametrize("n_prb,cell_id,sf", [(6, 0, 1), (15, 1, 1), (100, 1, 1), (50, 301, 7)])
def test_crs_and_pdsch_res(n_prb, cell_id, sf):
    for i, (k, r) in enumerate(tables.crs(n_prb, cell_id, sf)):
        assert np.array_equal(k, grid.crs_k(cell_id, n_prb, 0)[i])
        np.testing.assert_allclose(r, grid.crs_values(cell_id, sf, n_prb, 0)[i], atol=1e-6)
    cell = grid.CellConfig(n_prb=n_prb, cell_id=cell_id, cfi=1)
    assert np.array_equal(tables.pdsch_re(n_prb, cell_id, 1, sf),
                          grid.pdsch_re_indices(cell, sf, (1,) * n_prb))


@pytest.mark.parametrize("tbs", [40, 2704, 7104, 49472, 51024, 75376])
def test_segmentation_and_interleaver(tbs):
    s, p = tables.segmentation(tbs), cbsegm.cbsegm(tbs)
    assert (s.C, s.F, list(s.sizes)) == (p.C, p.F, p.cb_sizes)
    for k in set(s.sizes):
        assert np.array_equal(tables.qpp(k), turbo.qpp_interleaver(k))


@pytest.mark.parametrize("k,f,e,rv", [(5504, 16, 9600, 0), (5568, 0, 9606, 0), (3584, 56, 6480, 2),
                                      (40, 0, 500, 1)])
def test_rate_matching(k, f, e, rv):
    w = tables.circular_buffer(k, f)
    assert np.array_equal(np.where(w < 0, -1, w), np.where(rm_turbo.wbuf_map(k, f) < 0, -1,
                                                           rm_turbo.wbuf_map(k, f)))
    assert np.array_equal(w[tables.selection(k, f, e, rv)], rm_turbo.tx_table(k, f, e, rv))


def test_crc_matrix_equals_the_lfsr():
    bits = torch.from_numpy(np.random.default_rng(1).integers(0, 2, (3, 1000), dtype=np.int8))
    for poly in (tables.CRC24A, tables.CRC24B):
        want = np.stack([crc.crc_host(b.numpy(), poly) for b in bits])
        assert np.array_equal(ref_link.crc(bits, poly).numpy(), want)


def test_turbo_code_equals_the_bit_serial_oracle():
    u = np.random.default_rng(2).integers(0, 2, (2, 3584)).astype(np.uint8)
    ref = ref_link.turbo_encode(u)
    for row in range(2):
        for a, b in zip(ref, turbo.turbo_encode_host(u[row])):
            assert np.array_equal(a[row], b)


def test_encode_matches_the_program(payload):
    tx = pdsch_link.tx_subframe(payload, program_config(LINK))
    assert rel(tx, ref_link.encode(payload, LINK)) < 1e-6


@pytest.mark.parametrize("snr", [8.0, 20.0])
def test_front_end_and_decoder_match_the_program(payload, snr):
    cfg = program_config(LINK)
    g = torch.Generator().manual_seed(int(snr))
    tx = pdsch_link.tx_subframe(payload, cfg)
    noise = torch.randn(tx.shape, generator=g)
    out, ok, softbuf, ch = pdsch_link.rx_subframe(ref_link.add_noise(tx, noise, snr), cfg,
                                                  use_kernel=True)
    sb_ref, ce_ref = ref_link.front_end(
        ref_link.add_noise(ref_link.encode(payload, LINK), noise, snr), LINK)
    assert rel(ch.ce, ce_ref) < 1e-6
    assert rel(torch.cat([s.flatten() for s in softbuf]),
               torch.cat([s.flatten() for s in sb_ref])) < 1e-3
    payload_ref, ok_ref = ref_turbo.decode(softbuf, LINK)
    assert torch.equal(ok, ok_ref) and torch.equal(out, payload_ref)
    assert bool(ok.all()) == (snr == 20.0)


def test_decoder_follows_the_kernels_rules_not_the_xla_twin(payload):
    """The reference decodes as the card's kernels do (bfloat16 staging);
    the program's other plain MAP (`_map_decode`) rounds otherwise, so on a
    block that fails the two part."""
    cfg = program_config(LINK)
    g = torch.Generator().manual_seed(9)
    tx = pdsch_link.tx_subframe(payload, cfg)
    rx = ref_link.add_noise(tx, torch.randn(tx.shape, generator=g), 8.0)
    _, _, softbuf, _ = pdsch_link.rx_subframe(rx, cfg, use_kernel=True)
    k, f = LINK.segm.sizes[0], LINK.segm.F
    d = ref_turbo.d_llrs(softbuf[0], k, f)
    bits_k, _, _, _ = turbodecoder.turbo_decode_device(
        *d, torch.ones(B, dtype=torch.bool), k, 8, crc.LTE_CRC24B, use_kernel=True, llr_bits=16)
    bits_x, _, _, _ = turbodecoder.turbo_decode_device(
        *d, torch.ones(B, dtype=torch.bool), k, 8, crc.LTE_CRC24B, use_kernel=False, llr_bits=16)
    bits_r, _ = ref_turbo.decode_blocks(*d, k, tables.CRC24B, 8, 16)
    assert torch.equal(bits_r, bits_k)
    assert not torch.equal(bits_r, bits_x)


def test_control_is_one_precision_down(payload):
    tx = ref_link.encode(payload, LINK)
    tx_c = ref_link.encode(payload, LINK, ref_link.CONTROL)
    assert 1e-3 < rel(tx_c, tx) < 1e-2
    assert ref_link.CONTROL.real == torch.float32
    assert dataclasses.replace(ref_link.CONTROL, bf16=False).q(tx_c) is tx_c
