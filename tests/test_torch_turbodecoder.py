"""PyTorch port vs the JAX package: turbo decoder.

* `_map_decode` (plain twin of the reference's XLA MAP) at atol 1e-3,
  rtol 1e-4, as the reference's own kernel tests hold its MAP variants;
* `map_decode_ref`, the plain version of the CUDA kernel, against the TPU
  kernel `map_decode_pallas2` in interpret mode, both storage modes, at the
  same window count, atol 1e-3, rtol 1e-4 and equal signs where |LLR| > 0.5;
* `map_decode_v1_ref`, the plain version of the v1 CUDA kernel (the
  odd-window fallback), against the TPU kernel `map_decode_pallas` in
  interpret mode (at K=512 and at odd windows down to the short-halo case
  H = L) and against both packages' `_map_decode` at odd and short window
  lengths, atol 1e-3, rtol 1e-4; `window_index`, the kernels' addressing, against
  the strided windows v1's plain version builds, at the same lengths;
* `turbo_decode` (with and without the compaction cascade) and
  `decode_tb`: bits, CRC flags and n_iter exactly equal.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from srslte_emane_tpu.ops.fec import crc as j_crc
from srslte_emane_tpu.ops.fec import turbo as j_turbo
from srslte_emane_tpu.ops.fec import turbodecoder as j_td
from srslte_emane_tpu.ops.fec import turbodecoder_pallas as j_pallas
from srslte_emane_tpu.ops.fec import turbodecoder_pallas2 as j_pallas2
from srslte_emane_tpu.phch import sch as j_sch
from srslte_emane_tpu_torch.ops.fec import cbsegm as p_cbsegm
from srslte_emane_tpu_torch.ops.fec import crc as p_crc
from srslte_emane_tpu_torch.ops.fec import turbodecoder as p_td
from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as p_tdc
from srslte_emane_tpu_torch.phch import sch as p_sch

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

ATOL, RTOL = 1e-3, 1e-4


def _map_inputs(k, B):
    """The reference's tests/test_turbodecoder_pallas.py recipe."""
    rng = np.random.default_rng(k)
    bits = rng.integers(0, 2, (B, k), dtype=np.int8)
    d0, d1, d2 = (np.asarray(x).astype(np.float32) for x in j_turbo.turbo_encode(bits))
    scale = 4.0
    ls = ((1 - 2.0 * d0[:, :k]) * scale + rng.normal(0, 1, (B, k))).astype(np.float32)
    lp = ((1 - 2.0 * d1[:, :k]) * scale + rng.normal(0, 1, (B, k))).astype(np.float32)
    tail_x = ((1 - 2.0 * np.stack([d0[:, k], d2[:, k], d1[:, k + 1]], -1)) * scale).astype(np.float32)
    tail_z = ((1 - 2.0 * np.stack([d1[:, k], d0[:, k + 1], d2[:, k + 1]], -1)) * scale).astype(np.float32)
    return ls, lp, tail_x, tail_z


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _pallas2_windows(B, K, narrow):
    """The window count map_decode_pallas2 picks (its VMEM-driven refinement
    of _pick_windows, turbodecoder_pallas2.py:226-239)."""
    W = j_td._pick_windows(K)
    for w_c in (2, 4, 8, 16, 32):
        if K % w_c:
            continue
        l_c = K // w_c
        if l_c % 2 == 0 and l_c >= 128 and j_pallas2._pick_subs(
                B * w_c, l_c, min(j_td.HALO, l_c), narrow) >= 8:
            return w_c
    return W


def test_trellis_and_windows():
    pt, jt = p_td._trellis(), j_td._trellis()
    for name in jt:
        np.testing.assert_array_equal(pt[name], jt[name])
    for k in p_cbsegm.TC_CB_SIZES:
        assert p_td._pick_windows(int(k)) == j_td._pick_windows(int(k))
        assert (int(k) // p_td._pick_windows(int(k))) % 2 == 0
    with pytest.raises(ValueError):
        p_tdc._windows(40, 8)  # odd window length


@pytest.mark.parametrize("narrow", [False, True])
def test_window_index_gathers_time_major(narrow):
    """The kernel's addressing (`window_index`: the K-index each halo-window
    step reads, -1 for a zero) gathers the TPU kernel's time-major windows,
    at every code-block size with the decoder's window count."""
    rng = np.random.default_rng(11)
    for k in map(int, p_cbsegm.TC_CB_SIZES):
        w = p_td._pick_windows(k)
        L, H = p_tdc._windows(k, w)
        idx = p_tdc.window_index(k, w)
        assert tuple(idx.shape) == (L + 2 * H, w)
        x = torch.from_numpy(rng.normal(0, 4, (2, k)).astype(np.float32))
        xs = (x * 0.5).to(torch.bfloat16 if narrow else torch.float32)
        got = torch.cat([xs, xs.new_zeros((2, 1))], dim=1)[:, idx]  # (2, L + 2H, W)
        want = p_tdc.time_major(x, w, narrow)
        assert torch.equal(got.permute(1, 0, 2).reshape(L + 2 * H, 2 * w), want), k


@pytest.mark.parametrize("k,B", [(40, 4), (512, 4), (5504, 2)])
def test_map_decode_matches_jax(k, B):
    ls, lp, tail_x, tail_z = _map_inputs(k, B)
    ref = np.asarray(j_td._map_decode(ls, lp, tail_x, tail_z))
    got = p_td._map_decode(*_t(ls, lp, tail_x, tail_z)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("k", [512, 5504])
@pytest.mark.parametrize("narrow", [False, True])
def test_map_decode_ref_matches_pallas2(k, narrow):
    B = 2
    ls, lp, tail_x, tail_z = _map_inputs(k, B)
    ref = np.asarray(j_pallas2.map_decode_pallas2(ls, lp, tail_x, tail_z,
                                                  interpret=True, narrow=narrow))
    w = _pallas2_windows(B, k, narrow)
    got = p_tdc.map_decode_ref(*_t(ls, lp, tail_x, tail_z), w, narrow).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    strong = np.abs(ref) > 0.5
    assert (np.sign(got[strong]) == np.sign(ref[strong])).all()


def _random_llrs(k, B, seed):
    """LLRs of random code bits: any K, also one that is not a turbo
    code-block size (the MAP does not interleave)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (2, B, k))
    return (((1 - 2.0 * bits[0]) * 4 + rng.normal(0, 1, (B, k))).astype(np.float32),
            ((1 - 2.0 * bits[1]) * 4 + rng.normal(0, 1, (B, k))).astype(np.float32),
            rng.normal(0, 4, (B, 3)).astype(np.float32), rng.normal(0, 4, (B, 3)).astype(np.float32))


def test_map_decode_v1_ref_matches_pallas_v1():
    """The shape tests/test_turbodecoder_pallas.py already compiles for v1."""
    ls, lp, tail_x, tail_z = _map_inputs(512, 4)
    ref = np.asarray(j_pallas.map_decode_pallas(ls, lp, tail_x, tail_z, interpret=True))
    got = p_tdc.map_decode_v1_ref(*_t(ls, lp, tail_x, tail_z), p_td._pick_windows(512)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("k,B,w", [(1040, 3, 16), (45, 2, 1)])
def test_map_decode_v1_odd_window_matches_map_decode(monkeypatch, k, B, w):
    """At an odd window length (L=65, L=45) v1 computes the same posterior
    as the plain twin of the reference's XLA MAP; the normalisation points
    differ, the LLRs do not."""
    args = _t(*_random_llrs(k, B, k))
    got = p_tdc.map_decode_v1_ref(*args, w)
    monkeypatch.setattr(p_td, "_pick_windows", lambda _: w)
    torch.testing.assert_close(got, p_td._map_decode(*args), atol=ATOL, rtol=RTOL)


# window lengths v1 exists for: odd ones, and ones at or below the 40-step
# halo (H = L there, so a halo is the whole neighbouring window)
V1_WINDOW_LENGTHS = (1, 3, 11, 33, 39, 41, 65, 255)


def _v1_shape(L):
    """(K, B, W) with window length L: several windows, few columns."""
    W = 2 if L > 64 else 6
    return L * W, 2, W


@pytest.mark.parametrize("L", V1_WINDOW_LENGTHS)
def test_window_index_gathers_v1_windows(L):
    """`window_index` at any window length (the v1 kernel's addressing)
    gathers the halo windows that v1's plain version cuts with pad and
    strides: the same branch metrics, zero outside [0, K)."""
    K, B, W = _v1_shape(L)
    H = min(p_td.HALO, L)
    ls, lp = _t(*_random_llrs(K, B, L)[:2])
    idx = p_tdc.window_index(K, W)
    assert tuple(idx.shape) == (L + 2 * H, W)
    assert int(idx.min()) == -1 and int(idx.max()) == K - 1
    assert torch.equal(idx[H:H + L].T.reshape(-1), torch.arange(K))  # the windows tile [0, K)
    g = p_td._gammas(ls, lp)  # (B, K, 4)
    got = torch.cat([g, g.new_zeros((B, 1, 4))], dim=1)[:, idx]  # (B, L + 2H, W, 4)
    want = p_tdc._v1_windows(ls, lp, W)
    assert torch.equal(got.permute(1, 3, 0, 2).reshape(L + 2 * H, 4, B * W), want)
    with pytest.raises(ValueError):
        p_tdc.window_index(K + 1, W)  # does not split into W windows


@pytest.mark.parametrize("L", V1_WINDOW_LENGTHS)
def test_map_decode_v1_ref_matches_map_decode_at_window_length(monkeypatch, L):
    """At odd and short window lengths v1's plain version computes the same
    posterior as the plain twin of the reference's XLA MAP with the same
    window count (the normalisation points differ, the LLRs do not)."""
    K, B, W = _v1_shape(L)
    args = _t(*_random_llrs(K, B, 100 + L))
    got = p_tdc.map_decode_v1_ref(*args, W)
    assert tuple(got.shape) == (B, K) and bool(got.isfinite().all())
    monkeypatch.setattr(p_td, "_pick_windows", lambda _: W)
    torch.testing.assert_close(got, p_td._map_decode(*args), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("L", V1_WINDOW_LENGTHS)
def test_map_decode_v1_ref_matches_jax_map_decode_at_window_length(monkeypatch, L):
    """The same lengths against the JAX package: its XLA MAP with its window
    count patched to the same W states the short-halo rule (H = L below 40,
    a halo spanning whole neighbouring windows) independently of the port."""
    K, B, W = _v1_shape(L)
    arrays = _random_llrs(K, B, 200 + L)
    monkeypatch.setattr(j_td, "_pick_windows", lambda _: W)
    ref = np.asarray(j_td._map_decode(*arrays))
    got = p_tdc.map_decode_v1_ref(*_t(*arrays), W).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("L", [1, 11, 33, 65])
def test_map_decode_v1_ref_matches_pallas_v1_at_short_halo(monkeypatch, L):
    """The TPU v1 kernel in interpret mode, with its wrapper's halo pre-scans,
    at odd windows, three of them no longer than the halo (H = L): per-step
    normalisation and the window-edge rules as the JAX package states them."""
    K, B, W = _v1_shape(L)
    arrays = _random_llrs(K, B, 300 + L)
    monkeypatch.setattr(j_td, "_pick_windows", lambda _: W)
    ref = np.asarray(j_pallas.map_decode_pallas(*arrays, interpret=True))
    got = p_tdc.map_decode_v1_ref(*_t(*arrays), W).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    strong = np.abs(ref) > 0.5
    assert (np.sign(got[strong]) == np.sign(ref[strong])).all()


def test_map_decode_odd_window_goes_to_v1_on_cpu(monkeypatch):
    """map_decode sends an odd window length to v1 (its plain version on
    CPU tensors, f32 whatever `narrow` says) instead of raising; the
    radix-2 kernel's own entry points keep refusing it."""
    args = _t(*_random_llrs(1040, 2, 7))
    monkeypatch.setattr(p_tdc, "_pick_windows", lambda _: 16)
    before = (p_tdc.launches, p_tdc.launches_v1)
    for narrow in (False, True):
        assert torch.equal(p_tdc.map_decode(*args, narrow=narrow),
                           p_tdc.map_decode_v1_ref(*args, 16))
    assert (p_tdc.launches, p_tdc.launches_v1) == before
    with pytest.raises(ValueError):
        p_tdc.map_decode_ref(*args, 16)
    with pytest.raises(ValueError):
        p_tdc.map_decode_v1_cuda(*args, 16)  # CPU tensors: no launch


def test_map_decode_dispatch_on_cpu():
    """On CPU tensors the kernel entry point runs its plain version with the
    decoder's window count, and launches nothing."""
    ls, lp, tail_x, tail_z = _t(*_map_inputs(512, 2))
    before = p_tdc.launches
    got = p_tdc.map_decode(ls, lp, tail_x, tail_z, narrow=True)
    ref = p_tdc.map_decode_ref(ls, lp, tail_x, tail_z, p_td._pick_windows(512), True)
    assert torch.equal(got, ref)
    assert p_tdc.launches == before
    with pytest.raises(ValueError):
        p_tdc.map_decode_cuda(ls, lp, tail_x, tail_z, 4)  # CPU tensors: no launch


@pytest.mark.parametrize("bits", [8, 16])
def test_quantize(bits):
    x = (np.random.default_rng(bits).normal(0, 40, (4, 300))).astype(np.float32)
    x[0, :5] = [0.5 / 256, 1.5 / 256, 2.5 / 8, 1e6, -1e6]  # ties and saturation
    j_fn = getattr(j_td, f"quantize_llr_int{bits}")
    p_fn = getattr(p_td, f"quantize_llr_int{bits}")
    np.testing.assert_array_equal(p_fn(torch.from_numpy(x)).numpy(), np.asarray(j_fn(x)))


def _code_block_llrs(k, B, snr_scale, seed):
    """CRC24B-terminated code blocks through the encoder, as noisy LLRs."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, (B, k - 24), dtype=np.int8)
    bits = np.asarray(j_crc.crc_attach(payload, j_crc.LTE_CRC24B))
    ds = [np.asarray(x).astype(np.float32) for x in j_turbo.turbo_encode(bits)]
    llr = [((1 - 2.0 * d) * snr_scale + rng.normal(0, 1, d.shape)).astype(np.float32)
           for d in ds]
    return bits, llr


def test_beta_tail_does_not_depend_on_the_batch():
    """beta_tail gives a row the same beta_K bits whatever rows are decoded
    beside it (each state's six signed tail LLRs are added one at a time in
    index order), and the reference's einsum within float rounding."""
    rng = np.random.default_rng(3)
    tx, tz = (rng.normal(0, 3, (64, 3)).astype(np.float32) for _ in range(2))
    whole = p_td.beta_tail(*_t(tx, tz))
    for n in (1, 2, 5, 8, 16, 32):
        assert torch.equal(p_td.beta_tail(*_t(tx[:n], tz[:n])), whole[:n]), n
    tails = np.stack([tx[:, 0], tz[:, 0], tx[:, 1], tz[:, 1], tx[:, 2], tz[:, 2]], -1)
    ref = 0.5 * np.einsum("sj,bj->bs", j_td._trellis()["tail_signs"], tails)
    np.testing.assert_allclose(whole.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("k,B,scale,llr_bits", [
    (40, 4, 1.0, 32), (40, 8, 1.0, 16), (512, 3, 1.0, 32), (512, 3, 1.0, 16),
    (1056, 2, 1.0, 8)])
def test_turbo_decode_matches_jax(k, B, scale, llr_bits):
    """The XLA-MAP paths of both packages.  B=8 runs both packages'
    compaction cascades (at high SNR, where it has no stragglers left)."""
    bits, (d0, d1, d2) = _code_block_llrs(k, B, scale, k + B)
    valid = np.ones(B, bool)
    valid[-1] = B < 4
    j_bits, j_ok, j_it = j_td.turbo_decode(d0, d1, d2, valid, k, 6, j_crc.LTE_CRC24B,
                                           False, llr_bits)
    p_bits, p_ok, p_it = p_td.turbo_decode(*_t(d0, d1, d2, valid), k, 6, p_crc.LTE_CRC24B,
                                           use_kernel=False, llr_bits=llr_bits)
    np.testing.assert_array_equal(p_bits.numpy(), np.asarray(j_bits))
    np.testing.assert_array_equal(p_ok.numpy(), np.asarray(j_ok))
    assert p_it == int(j_it)
    assert int(j_it) > 1 and np.asarray(j_ok).any()  # the case exercises several passes


def _straggler_batch(k, B, seed):
    """B code blocks, every fourth at low SNR: the rest converge within a
    few passes, the stragglers run out the budget or converge late."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, (B, k - 24), dtype=np.int8)
    bits = np.asarray(j_crc.crc_attach(payload, j_crc.LTE_CRC24B))
    scale = np.where(np.arange(B) % 4 == 0, 0.45, 1.2)[:, None]
    llr = [((1 - 2.0 * np.asarray(d, np.float32)) * scale + rng.normal(0, 1, d.shape))
           .astype(np.float32) for d in j_turbo.turbo_encode(bits)]
    return bits, llr


@pytest.mark.parametrize("use_kernel", [False, True])
def test_turbo_decode_cascade_matches_jax(monkeypatch, use_kernel):
    """B=16 with stragglers: with the cascade on, the port gives the same
    bits, CRC flags and n_iter as with it off, on fewer MAP rows; on the
    XLA-MAP path both equal the reference's (cascade on).  use_kernel=True
    is the kernel path (its plain version on CPU tensors), whose rounding
    differs from the XLA MAP's in the blocks that never converge."""
    k, B = 512, 16
    bits, (d0, d1, d2) = _straggler_batch(k, B, 7)
    valid = np.ones(B, bool)
    j_bits, j_ok, j_it = j_td.turbo_decode(d0, d1, d2, valid, k, 8, j_crc.LTE_CRC24B,
                                           False, 32)
    assert 0 < int(np.asarray(j_ok).sum()) < B and int(j_it) == 8
    rows, runs = {}, {}
    for cascade in ("1", "0"):
        monkeypatch.setenv("SRSLTE_TPU_CASCADE", cascade)
        monkeypatch.setattr(p_td, "map_rows", 0)
        runs[cascade] = p_td.turbo_decode(*_t(d0, d1, d2, valid), k, 8, p_crc.LTE_CRC24B,
                                          use_kernel=use_kernel)
        rows[cascade] = p_td.map_rows
    for a, b in zip(runs["1"][:2], runs["0"][:2]):
        assert torch.equal(a, b)
    assert runs["1"][2] == runs["0"][2] == int(j_it)
    assert rows["1"] < rows["0"] == B * 2 * 8
    if not use_kernel:
        np.testing.assert_array_equal(runs["1"][0].numpy(), np.asarray(j_bits))
        np.testing.assert_array_equal(runs["1"][1].numpy(), np.asarray(j_ok))


@pytest.mark.parametrize("llr_bits", [32, 16])
def test_turbo_decode_default_on_cpu_is_plain_map(monkeypatch, llr_bits):
    """use_kernel left at its default on CPU tensors decodes through
    `_map_decode`, as use_kernel=False does: same bits, CRC flags, n_iter."""
    k, B = 512, 3
    bits, (d0, d1, d2) = _code_block_llrs(k, B, 1.0, 5)
    args = (*_t(d0, d1, d2, np.ones(B, bool)), k, 6, p_crc.LTE_CRC24B)
    calls = []
    plain = p_td._map_decode
    monkeypatch.setattr(p_td, "_map_decode", lambda *a: calls.append(1) or plain(*a))
    before = p_tdc.launches
    got = p_td.turbo_decode(*args, llr_bits=llr_bits)
    n_default = len(calls)
    want = p_td.turbo_decode(*args, use_kernel=False, llr_bits=llr_bits)
    assert n_default > 0 and len(calls) == 2 * n_default and p_tdc.launches == before
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a, b)
    assert got[2] == want[2] > 1
    assert torch.equal(got[0], torch.from_numpy(np.array(bits)))


@pytest.mark.parametrize("llr_bits", [32, 16])
def test_turbo_decode_kernel_path_matches_pallas(llr_bits):
    """use_kernel=True (the kernel's plain version on CPU) against the
    reference's use_pallas=True (interpret mode); at K=40 both use 1 window."""
    k, B = 40, 4
    bits, (d0, d1, d2) = _code_block_llrs(k, B, 1.0, 3)
    j_bits, j_ok, j_it = j_td.turbo_decode(d0, d1, d2, np.ones(B, bool), k, 6,
                                           j_crc.LTE_CRC24B, True, llr_bits)
    p_bits, p_ok, p_it = p_td.turbo_decode(*_t(d0, d1, d2, np.ones(B, bool)), k, 6,
                                           p_crc.LTE_CRC24B, use_kernel=True,
                                           llr_bits=llr_bits)
    np.testing.assert_array_equal(p_bits.numpy(), np.asarray(j_bits))
    np.testing.assert_array_equal(p_ok.numpy(), np.asarray(j_ok))
    assert p_it == int(j_it)


@pytest.mark.parametrize("tbs,llr_bits", [(1000, 32), (1000, 16)])
def test_decode_tb_matches_jax(tbs, llr_bits):
    """Same codeword LLRs into both SCH decoders, one code block (CRC24A
    early stop).  Multi-CB decodes: test_torch_link.py's HARQ test."""
    G = 3 * (tbs + 24)  # rate ~1/3, even for QPSK
    pcfg, jcfg = p_sch.SchConfig(tbs=tbs, G=G, Qm=2, Nl=1), j_sch.SchConfig(tbs=tbs, G=G, Qm=2, Nl=1)
    rng = np.random.default_rng(tbs + llr_bits)
    payload = rng.integers(0, 2, (2, tbs), dtype=np.int8)
    cw = np.asarray(j_sch.encode_tb(payload, jcfg)).astype(np.float32)
    llrs = ((1 - 2 * cw) * 1.0 + rng.normal(0, 1, cw.shape)).astype(np.float32)
    j_out, j_ok, j_sb, j_it = j_sch.decode_tb(llrs, jcfg, None, 8, llr_bits=llr_bits)
    p_out, p_ok, p_sb, p_it = p_sch.decode_tb(torch.from_numpy(llrs), pcfg, None, 8,
                                              llr_bits=llr_bits)
    np.testing.assert_array_equal(p_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(p_ok.numpy(), np.asarray(j_ok))
    assert p_it == int(j_it)
    assert np.asarray(j_ok).all()
    for p, j in zip(p_sb, j_sb):
        assert p.dtype == (torch.bfloat16 if llr_bits <= 16 else torch.float32)
        np.testing.assert_array_equal(p.float().numpy(), np.asarray(j, np.float32))


def test_logmap_mode_matches_jax():
    """SRSLTE_TPU_LOGMAP=1 (read at import by both packages): the max*
    correction in the port's plain MAP and in the kernel's plain version
    against the reference's XLA MAP.  The TPU kernel is not the oracle
    here: in interpret mode its log-MAP build takes minutes.  f32 storage
    at atol 1e-3, rtol 1e-4; bf16 storage at the bound the reference holds
    its own narrow kernel to against f32 (tests/test_turbodecoder_pallas.py
    `test_pallas2_narrow_mode`: atol 0.3, rtol 0.02, equal strong signs)."""
    code = textwrap.dedent("""
        import jax
        jax.config.update("jax_platforms", "cpu")
        import numpy as np, torch
        from srslte_emane_tpu.ops.fec import turbo, turbodecoder as j_td
        from srslte_emane_tpu_torch.ops.fec import turbodecoder as p_td
        from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as p_tdc
        assert j_td.LOGMAP and p_td.LOGMAP
        k, B = 512, 2
        rng = np.random.default_rng(5)
        bits = rng.integers(0, 2, (B, k), dtype=np.int8)
        d0, d1, d2 = (np.asarray(x).astype(np.float32) for x in turbo.turbo_encode(bits))
        ls = ((1 - 2.0 * d0[:, :k]) * 2.0 + rng.normal(0, 1, (B, k))).astype(np.float32)
        lp = ((1 - 2.0 * d1[:, :k]) * 2.0 + rng.normal(0, 1, (B, k))).astype(np.float32)
        tx = ((1 - 2.0 * np.stack([d0[:, k], d2[:, k], d1[:, k + 1]], -1)) * 2.0).astype(np.float32)
        tz = ((1 - 2.0 * np.stack([d1[:, k], d0[:, k + 1], d2[:, k + 1]], -1)) * 2.0).astype(np.float32)
        t = [torch.from_numpy(a) for a in (ls, lp, tx, tz)]
        ref = np.asarray(j_td._map_decode(ls, lp, tx, tz))
        np.testing.assert_allclose(p_td._map_decode(*t).numpy(), ref, atol=1e-3, rtol=1e-4)
        w = p_td._pick_windows(k)
        np.testing.assert_allclose(p_tdc.map_decode_ref(*t, w, False).numpy(), ref,
                                   atol=1e-3, rtol=1e-4)
        got = p_tdc.map_decode_ref(*t, w, True).numpy()
        np.testing.assert_allclose(got, ref, atol=0.3, rtol=0.02)
        strong = np.abs(ref) > 0.5
        assert (np.sign(got[strong]) == np.sign(ref[strong])).all()
    """)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, SRSLTE_TPU_LOGMAP="1", JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=600, check=False)
    assert res.returncode == 0, res.stderr[-3000:]
