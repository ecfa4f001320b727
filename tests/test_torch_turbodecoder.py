"""PyTorch port vs the JAX package: turbo decoder.

* `_map_decode` (plain twin of the reference's XLA MAP) at atol 1e-3,
  rtol 1e-4, as the reference's own kernel tests hold its MAP variants;
* `map_decode_ref`, the plain version of the CUDA kernel, against the TPU
  kernel `map_decode_pallas2` in interpret mode, both storage modes, at the
  same window count, atol 1e-3, rtol 1e-4 and equal signs where |LLR| > 0.5;
* `turbo_decode` and `decode_tb`: bits, CRC flags and n_iter exactly equal.
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
from srslte_emane_tpu.ops.fec import turbodecoder_pallas2 as j_pallas2
from srslte_emane_tpu.phch import sch as j_sch
from srslte_emane_tpu_torch.ops.fec import cbsegm as p_cbsegm
from srslte_emane_tpu_torch.ops.fec import crc as p_crc
from srslte_emane_tpu_torch.ops.fec import turbodecoder as p_td
from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as p_tdc
from srslte_emane_tpu_torch.phch import sch as p_sch

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


@pytest.mark.parametrize("k,B,scale,llr_bits", [
    (40, 4, 1.0, 32), (40, 8, 1.0, 16), (512, 3, 1.0, 32), (512, 3, 1.0, 16),
    (1056, 2, 1.0, 8)])
def test_turbo_decode_matches_jax(k, B, scale, llr_bits):
    """The XLA-MAP paths of both packages.  B=8 runs the reference's
    compaction cascade, which the port does not have: results must agree."""
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
