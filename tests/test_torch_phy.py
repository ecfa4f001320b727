"""PyTorch port vs the JAX package: modem, OFDM, AWGN, channel estimation,
equalizers and PDSCH grid assembly, on inputs made from numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srslte_emane_tpu.ops import modem as j_modem
from srslte_emane_tpu.ops import ofdm as j_ofdm
from srslte_emane_tpu.phch import chest as j_chest
from srslte_emane_tpu.phch import grid as j_grid
from srslte_emane_tpu.phch import pdsch as j_pdsch
from srslte_emane_tpu.phch import sch as j_sch
from srslte_emane_tpu_torch.ops import channel as p_channel
from srslte_emane_tpu_torch.ops import cplx as p_cplx
from srslte_emane_tpu_torch.ops import dft as p_dft
from srslte_emane_tpu_torch.ops import modem as p_modem
from srslte_emane_tpu_torch.ops import ofdm as p_ofdm
from srslte_emane_tpu_torch.phch import chest as p_chest
from srslte_emane_tpu_torch.phch import grid as p_grid
from srslte_emane_tpu_torch.phch import pdsch as p_pdsch
from srslte_emane_tpu_torch.phch import sch as p_sch

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker


def _rel_rms(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


@pytest.mark.parametrize("mod", ["bpsk", "qpsk", "16qam", "64qam", "256qam"])
def test_modem(mod):
    qm = p_modem.BITS_PER_SYMBOL[mod]
    assert qm == j_modem.BITS_PER_SYMBOL[mod]
    rng = np.random.default_rng(qm)
    bits = rng.integers(0, 2, (3, 240 * qm), dtype=np.int8)
    syms = p_modem.modulate(torch.from_numpy(bits), mod)
    np.testing.assert_allclose(syms.numpy(), np.asarray(j_modem.modulate(bits, mod)),
                               atol=1e-6, rtol=0)
    noisy = (syms.numpy() + rng.normal(0, 0.2, syms.shape)).astype(np.float32)
    np.testing.assert_allclose(p_modem.demod_soft(torch.from_numpy(noisy), mod).numpy(),
                               np.asarray(j_modem.demod_soft(noisy, mod)), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(p_modem.demod_hard(syms, mod).numpy(), bits)


@pytest.mark.parametrize("n", [128, 1536, 2048])
@pytest.mark.parametrize("inverse", [False, True])
def test_dft_matches_numpy(n, inverse):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))).astype(np.complex64)
    got = p_cplx.to_numpy(p_dft.dft(p_cplx.from_numpy(x), inverse=inverse))
    ref = (np.fft.ifft if inverse else np.fft.fft)(x, axis=-1, norm="ortho")
    assert _rel_rms(np.stack([got.real, got.imag]), np.stack([ref.real, ref.imag])) < 1e-5


@pytest.mark.parametrize("n_prb", [6, 50, 100])
def test_ofdm(n_prb):
    assert p_ofdm.params(n_prb) == j_ofdm.params(n_prb)
    rng = np.random.default_rng(n_prb)
    nre = 12 * n_prb
    grid = rng.normal(size=(2, 14, nre, 2)).astype(np.float32)
    time_p = p_ofdm.modulate(torch.from_numpy(grid), n_prb)
    # against np.fft: place the bins, IFFT, prepend each symbol's CP
    p = p_ofdm.params(n_prb)
    x = np.zeros((2, 14, p["n"]), np.complex64)
    x[..., p_ofdm._bin_map(n_prb)] = grid[..., 0] + 1j * grid[..., 1]
    t = np.fft.ifft(x, axis=-1, norm="ortho")
    ref = np.concatenate([np.concatenate([t[:, l, p["n"] - cpl:], t[:, l]], axis=-1)
                          for l, (_, cpl) in enumerate(p_ofdm._symbol_starts(n_prb))], -1)
    assert _rel_rms(time_p.numpy(), np.stack([ref.real, ref.imag], -1)) < 1e-5
    # against the JAX package, whose DFT rounds its inputs to bf16
    time_j = np.asarray(j_ofdm.modulate(grid, n_prb))
    assert _rel_rms(time_p.numpy(), time_j) <= 1e-2
    back_p = p_ofdm.demodulate(time_p, n_prb).numpy()
    assert _rel_rms(back_p, grid) < 1e-5
    assert _rel_rms(back_p, np.asarray(j_ofdm.demodulate(time_j, n_prb))) <= 1e-2


def test_awgn_snr_and_generator():
    x = p_cplx.from_numpy(np.exp(1j * np.linspace(0, 50, 4 * 3000)).reshape(4, 3000)
                          .astype(np.complex64))
    gen = torch.Generator().manual_seed(7)
    y = p_channel.awgn(gen, x, torch.tensor([0.0, 10.0, 20.0, 30.0]))
    noise_p = p_cplx.abs2(y - x).mean(dim=-1)
    snr = 10 * torch.log10(1.0 / noise_p)
    np.testing.assert_allclose(snr.numpy(), [0.0, 10.0, 20.0, 30.0], atol=0.2)
    y2 = p_channel.awgn(torch.Generator().manual_seed(7), x, torch.tensor([0.0, 10.0, 20.0, 30.0]))
    assert torch.equal(y, y2)


def _rx_grid(cell, B, seed):
    """A grid with CRS on port 0 through a random smooth channel plus noise."""
    rng = np.random.default_rng(seed)
    syms = (rng.normal(size=(B, cell.n_sym, cell.nre)) + 1j * rng.normal(
        size=(B, cell.n_sym, cell.nre))) / np.sqrt(2)
    ks = p_grid.crs_k(cell.cell_id, cell.n_prb, 0)
    vals = p_grid.crs_values(cell.cell_id, 1, cell.n_prb, 0)
    for i, sym in enumerate(p_grid.pilot_syms(0)):
        syms[:, sym, ks[i]] = vals[i]
    f = np.arange(cell.nre) / cell.nre
    h = (1.0 + 0.3 * np.exp(2j * np.pi * (3 * f[None, :] + rng.uniform(size=(B, 1)))))
    y = syms * h[:, None, :] + 0.05 * (rng.normal(size=syms.shape) + 1j * rng.normal(size=syms.shape))
    return np.stack([y.real, y.imag], -1).astype(np.float32)


@pytest.mark.parametrize("cell_kw", [dict(n_prb=6, cell_id=1, cfi=2),
                                     dict(n_prb=50, cell_id=17, cfi=1)])
def test_chest_and_equalizers(cell_kw):
    pc, jc = p_grid.CellConfig(**cell_kw), j_grid.CellConfig(**cell_kw)
    np.testing.assert_array_equal(p_chest._freq_interp_matrix(pc.n_prb, 3),
                                  j_chest._freq_interp_matrix(jc.n_prb, 3))
    np.testing.assert_array_equal(p_chest._time_interp_matrix((0, 4, 7, 11)),
                                  j_chest._time_interp_matrix((0, 4, 7, 11)))
    rx = _rx_grid(pc, 2, pc.n_prb)
    got = p_chest.estimate(torch.from_numpy(rx), pc, 1)
    ref = j_chest.estimate(rx, jc, 1)
    for name in got._fields:
        g, r = getattr(got, name), np.asarray(getattr(ref, name))
        assert g.shape == r.shape, name
        atol = 1e-4 if name == "sync_err" else 1e-6
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=atol, err_msg=name)
    ce = np.array(ref.ce)
    for eq in ("zf", "mmse"):
        if eq == "zf":
            xp, cp = p_chest.equalize_zf(torch.from_numpy(rx), torch.from_numpy(ce))
            xj, cj = j_chest.equalize_zf(rx, ce)
        else:
            xp, cp = p_chest.equalize_mmse(torch.from_numpy(rx), torch.from_numpy(ce),
                                           torch.from_numpy(np.array(ref.noise_est)))
            xj, cj = j_chest.equalize_mmse(rx, ce, ref.noise_est)
        np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(cp.numpy(), np.asarray(cj), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("cell_kw,qm,sf_idx", [(dict(n_prb=6, cell_id=1, cfi=2), 2, 1),
                                               (dict(n_prb=15, cell_id=3, cfi=2), 4, 0),
                                               (dict(n_prb=50, cell_id=17, cfi=1), 6, 1)])
def test_pdsch_encode_grid(cell_kw, qm, sf_idx):
    """Codeword bits -> grid: integer work and a gather, so exact."""
    pc, jc = p_grid.CellConfig(**cell_kw), j_grid.CellConfig(**cell_kw)
    mask = (1,) * pc.n_prb
    G = p_grid.nof_re(pc, sf_idx, mask) * qm
    tbs = max(8, (int(G * 0.5) - 24) // 8 * 8)
    pcfg, jcfg = p_sch.SchConfig(tbs=tbs, G=G, Qm=qm, Nl=1), j_sch.SchConfig(tbs=tbs, G=G, Qm=qm, Nl=1)
    assert pcfg.e_sizes == jcfg.e_sizes
    payload = np.random.default_rng(qm).integers(0, 2, (2, tbs), dtype=np.int8)
    np.testing.assert_array_equal(p_sch.encode_tb(torch.from_numpy(payload), pcfg).numpy(),
                                  np.asarray(j_sch.encode_tb(payload, jcfg)))
    got = p_pdsch.encode(torch.from_numpy(payload), pcfg, pc, sf_idx, 0x46, mask)
    ref = np.asarray(j_pdsch.encode(payload, jcfg, jc, sf_idx, 0x46, mask))
    np.testing.assert_array_equal(got.numpy(), ref)
    # into an existing grid (scatter + put_crs path)
    base = np.random.default_rng(1).normal(size=ref.shape).astype(np.float32)
    got = p_pdsch.encode(torch.from_numpy(payload), pcfg, pc, sf_idx, 0x46, mask,
                         grid=torch.from_numpy(base))
    ref = np.asarray(j_pdsch.encode(payload, jcfg, jc, sf_idx, 0x46, mask,
                                    grid=jnp.asarray(base)))
    np.testing.assert_array_equal(got.numpy(), ref)
