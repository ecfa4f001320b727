"""PyTorch port vs the JAX package: bit-level ops and host tables, exact.

Inputs come from numpy seeds and go through both packages; every result
here is bits or integer tables, so the port must match exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from srslte_emane_tpu.ops import scrambling as j_scr
from srslte_emane_tpu.ops import sequence as j_seq
from srslte_emane_tpu.ops.fec import cbsegm as j_cbsegm
from srslte_emane_tpu.ops.fec import crc as j_crc
from srslte_emane_tpu.ops.fec import rm_turbo as j_rm
from srslte_emane_tpu.ops.fec import turbo as j_turbo
from srslte_emane_tpu.phch import grid as j_grid
from srslte_emane_tpu.utils import gf2 as j_gf2
from srslte_emane_tpu_torch.ops import scrambling as p_scr
from srslte_emane_tpu_torch.ops import sequence as p_seq
from srslte_emane_tpu_torch.ops.fec import cbsegm as p_cbsegm
from srslte_emane_tpu_torch.ops.fec import crc as p_crc
from srslte_emane_tpu_torch.ops.fec import rm_turbo as p_rm
from srslte_emane_tpu_torch.ops.fec import turbo as p_turbo
from srslte_emane_tpu_torch.phch import grid as p_grid
from srslte_emane_tpu_torch.utils import gf2 as p_gf2


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_cbsegm_copy_matches():
    np.testing.assert_array_equal(p_cbsegm.TC_CB_SIZES, j_cbsegm.TC_CB_SIZES)
    for tbs in list(range(8, 7000, 40)) + [49472, 75376, 97896]:
        assert (dataclasses.astuple(p_cbsegm.cbsegm(tbs))
                == dataclasses.astuple(j_cbsegm.cbsegm(tbs)))


@pytest.mark.parametrize("taps", [[1, 0, 0, 1] + [0] * 27, [1, 1, 1, 1] + [0] * 27])
def test_gf2_lfsr_response_copy_matches(taps):
    taps = np.array(taps, dtype=np.int64)
    np.testing.assert_array_equal(p_gf2.lfsr_output_response(taps, 700, skip=1600),
                                  j_gf2.lfsr_output_response(taps, 700, skip=1600))


@pytest.mark.parametrize("n", [1, 300, 1000])
def test_gold_sequence(n):
    c_init = np.array([0, 1, 12345, 0x46 << 14 | 1 << 9 | 17, 2**31 - 1], np.int64)
    got = p_seq.gold_sequence(torch.from_numpy(c_init), n)
    np.testing.assert_array_equal(_np(got), np.asarray(j_seq.gold_sequence(c_init, n)))
    np.testing.assert_array_equal(_np(p_seq.gold_sequence(int(c_init[3]), n)),
                                  p_seq.gold_sequence_host(int(c_init[3]), n))
    np.testing.assert_array_equal(p_seq.gold_sequence_host(int(c_init[2]), n),
                                  j_seq.gold_sequence_host(int(c_init[2]), n))


def test_scrambling_bits_and_llrs():
    rng = np.random.default_rng(3)
    c_init = p_scr.pdsch_cinit(0x46, 0, 1, 17)
    assert c_init == j_scr.pdsch_cinit(0x46, 0, 1, 17)
    bits = rng.integers(0, 2, (3, 1500), dtype=np.int8)
    np.testing.assert_array_equal(_np(p_scr.scramble_bits(torch.from_numpy(bits), c_init)),
                                  np.asarray(j_scr.scramble_bits(bits, c_init)))
    llrs = rng.normal(size=(3, 1500)).astype(np.float32)
    np.testing.assert_array_equal(_np(p_scr.scramble_llrs(torch.from_numpy(llrs), c_init)),
                                  np.asarray(j_scr.scramble_llrs(llrs, c_init)))


@pytest.mark.parametrize("poly", ["LTE_CRC24A", "LTE_CRC24B", "LTE_CRC16", "LTE_CRC8"])
def test_crc(poly):
    rng = np.random.default_rng(len(poly))
    p_poly, j_poly = getattr(p_crc, poly), getattr(j_crc, poly)
    assert p_poly == j_poly
    for length in (40, 5480, 49472):
        bits = rng.integers(0, 2, (3, length), dtype=np.int8)
        got = p_crc.crc_attach(torch.from_numpy(bits), p_poly)
        ref = np.asarray(j_crc.crc_attach(bits, j_poly))
        np.testing.assert_array_equal(_np(got), ref)
        bad = ref.copy()
        bad[1, 7] ^= 1
        np.testing.assert_array_equal(_np(p_crc.crc_ok(torch.from_numpy(bad), p_poly)),
                                      np.asarray(j_crc.crc_ok(bad, j_poly)))


@pytest.mark.parametrize("k", [40, 512, 1056, 5504, 5568, 6144])
def test_turbo_encode(k):
    np.testing.assert_array_equal(p_turbo.qpp_interleaver(k), j_turbo.qpp_interleaver(k))
    bits = np.random.default_rng(k).integers(0, 2, (3, k), dtype=np.int8)
    got = p_turbo.turbo_encode(torch.from_numpy(bits))
    ref = j_turbo.turbo_encode(bits)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(_np(g), np.asarray(r))


RM_CASES = [(40, 0, 132, 0, 0), (512, 0, 1200, 2, 0), (5504, 16, 10000, 0, 0),
            (5568, 0, 9996, 0, 0), (1056, 8, 4000, 1, 2000), (104, 0, 900, 3, 0)]


@pytest.mark.parametrize("k,f,e,rv,ncb", RM_CASES)
def test_rm_turbo_tables(k, f, e, rv, ncb):
    np.testing.assert_array_equal(p_rm.wbuf_map(k, f), j_rm.wbuf_map(k, f))
    assert p_rm.wbuf_size(k) == j_rm.wbuf_size(k)
    for name in ("tx_table", "rx_table", "rx_gather_table"):
        np.testing.assert_array_equal(getattr(p_rm, name)(k, f, e, rv, ncb),
                                      getattr(j_rm, name)(k, f, e, rv, ncb))
    for a, b in zip(p_rm._wbuf_inverse(k, f), j_rm._wbuf_inverse(k, f)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k,f,e,rv,ncb", RM_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rate_match_round_trip(k, f, e, rv, ncb, dtype):
    import jax.numpy as jnp

    rng = np.random.default_rng(k + e)
    d_flat = rng.integers(0, 2, (2, 3 * (k + 4)), dtype=np.int8)
    np.testing.assert_array_equal(
        _np(p_rm.rate_match_tx(torch.from_numpy(d_flat), k, f, e, rv, ncb)),
        np.asarray(j_rm.rate_match_tx(d_flat, k, f, e, rv, ncb)))
    # llrs/w-buffer values on a 1/8 grid: exact in bf16 and under its sums
    llrs = (rng.integers(-64, 64, (2, e)) / 8.0).astype(np.float32)
    wbuf = (rng.integers(-64, 64, (2, p_rm.wbuf_size(k))) / 8.0).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = p_rm.rate_unmatch_rx(torch.from_numpy(llrs).to(tdt),
                               torch.from_numpy(wbuf).to(tdt), k, f, e, rv, ncb)
    ref = j_rm.rate_unmatch_rx(jnp.asarray(llrs, jdt), jnp.asarray(wbuf, jdt),
                               k, f, e, rv, ncb)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
    for g, r in zip(p_rm.wbuf_to_d_llrs(got, k, f), j_rm.wbuf_to_d_llrs(ref, k, f)):
        assert g.dtype == tdt
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(r, np.float32))


CELLS = [dict(n_prb=6, cell_id=1, cfi=2), dict(n_prb=15, cell_id=3, cfi=2),
         dict(n_prb=50, cell_id=17, cfi=1, n_ports=2), dict(n_prb=100, cell_id=1, cfi=1),
         dict(n_prb=25, cell_id=5, cfi=3, n_ports=4)]


@pytest.mark.parametrize("cell_kw", CELLS)
@pytest.mark.parametrize("sf_idx", [0, 1, 5])
def test_grid_tables(cell_kw, sf_idx):
    pc, jc = p_grid.CellConfig(**cell_kw), j_grid.CellConfig(**cell_kw)
    assert (pc.nre, pc.n_sym) == (jc.nre, jc.n_sym)
    mask = tuple(1 if i % 3 else 0 for i in range(pc.n_prb))
    for port in range(pc.n_ports):
        np.testing.assert_array_equal(
            p_grid.crs_values(pc.cell_id, sf_idx, pc.n_prb, port),
            j_grid.crs_values(jc.cell_id, sf_idx, jc.n_prb, port))
        np.testing.assert_array_equal(p_grid.crs_k(pc.cell_id, pc.n_prb, port),
                                      j_grid.crs_k(jc.cell_id, jc.n_prb, port))
        np.testing.assert_array_equal(
            p_grid.tx_gather_table(pc, sf_idx, mask, port),
            j_grid.tx_gather_table(jc, sf_idx, mask, port))
    np.testing.assert_array_equal(p_grid.reserved_mask(pc, sf_idx),
                                  j_grid.reserved_mask(jc, sf_idx))
    for m in (mask, (1,) * pc.n_prb):
        np.testing.assert_array_equal(p_grid.pdsch_re_indices(pc, sf_idx, m),
                                      j_grid.pdsch_re_indices(jc, sf_idx, m))
        assert p_grid.nof_re(pc, sf_idx, m) == j_grid.nof_re(jc, sf_idx, m)
