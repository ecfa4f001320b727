"""The CUDA MAP kernels against their plain PyTorch versions, and a PUSCH
decode through them, on the card.

Marked `cuda`: skips without a CUDA device.  The card's machine has no jax,
so run this file there without the suite's conftest:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from srslte_emane_tpu_torch.ops import channel
from srslte_emane_tpu_torch.ops.fec import turbo, turbodecoder, turbodecoder_cuda

pytestmark = pytest.mark.cuda

ATOL, RTOL = 1e-3, 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(k, B, dev):
    rng = np.random.default_rng(k)
    bits = torch.from_numpy(rng.integers(0, 2, (B, k), dtype=np.int8)).to(dev)
    d0, d1, _ = (d.float() for d in turbo.turbo_encode(bits))
    noise = lambda: torch.from_numpy(rng.normal(0, 1, (B, k)).astype(np.float32)).to(dev)
    ls = ((1 - 2 * d0[:, :k]) * 4.0 + noise()).contiguous()
    lp = ((1 - 2 * d1[:, :k]) * 4.0 + noise()).contiguous()
    tails = torch.from_numpy(rng.normal(0, 4, (2, B, 3)).astype(np.float32)).to(dev)
    return ls, lp, tails[0].contiguous(), tails[1].contiguous()


@pytest.mark.parametrize("k,B", [(40, 3), (512, 5), (5504, 4)])
@pytest.mark.parametrize("narrow", [False, True])
def test_kernel_matches_plain(dev, k, B, narrow):
    args = _inputs(k, B, dev)
    w = turbodecoder._pick_windows(k)
    before = turbodecoder_cuda.launches
    got = turbodecoder_cuda.map_decode(*args, narrow=narrow)
    torch.cuda.synchronize()
    assert turbodecoder_cuda.launches == before + 1
    ref = turbodecoder_cuda.map_decode_ref(*args, w, narrow)
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)
    strong = ref.abs() > 0.5
    assert torch.equal(got[strong].sign(), ref[strong].sign())


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    ls, lp, tx, tz = _inputs(512, 2, dev)
    with pytest.raises(TypeError):
        turbodecoder_cuda.map_decode_cuda(ls.double(), lp, tx, tz, 4)
    with pytest.raises(ValueError):
        turbodecoder_cuda.map_decode_cuda(ls.t().contiguous().t(), lp, tx, tz, 4)
    with pytest.raises(ValueError):
        turbodecoder_cuda.map_decode_cuda(ls, lp.cpu(), tx, tz, 4)
    with pytest.raises(ValueError):
        turbodecoder_cuda.map_decode_cuda(ls, lp, tx, tz, 3)  # 3 does not divide K


def test_logmap_kernel_matches_plain(dev, monkeypatch):
    """The log-MAP kernel against its plain version.  SRSLTE_TPU_LOGMAP is
    read once at import (the CPU tests check that); here the flag is set on
    both modules, where the kernel launch and max_star read it."""
    monkeypatch.setattr(turbodecoder, "LOGMAP", True)
    monkeypatch.setattr(turbodecoder_cuda, "LOGMAP", True)
    args = _inputs(5504, 4, dev)
    for narrow in (False, True):
        got = turbodecoder_cuda.map_decode(*args, narrow=narrow)
        ref = turbodecoder_cuda.map_decode_ref(*args, turbodecoder._pick_windows(5504), narrow)
        torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)


def _random_inputs(k, B, dev):
    """LLRs of random code bits: any K (the MAP does not interleave)."""
    rng = np.random.default_rng(k + B)
    bits = rng.integers(0, 2, (2, B, k))
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev).contiguous()
    return (f((1 - 2.0 * bits[0]) * 4 + rng.normal(0, 1, (B, k))),
            f((1 - 2.0 * bits[1]) * 4 + rng.normal(0, 1, (B, k))),
            f(rng.normal(0, 4, (B, 3))), f(rng.normal(0, 4, (B, 3))))


@pytest.mark.parametrize("k,B,w", [(40, 3, 1), (512, 5, 2), (1040, 4, 16), (5504, 4, 32)])
def test_v1_kernel_matches_plain(dev, k, B, w):
    args = _random_inputs(k, B, dev)
    before = turbodecoder_cuda.launches_v1
    got = turbodecoder_cuda.map_decode_v1_cuda(*args, w)
    torch.cuda.synchronize()
    assert turbodecoder_cuda.launches_v1 == before + 1
    ref = turbodecoder_cuda.map_decode_v1_ref(*args, w)
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)
    strong = ref.abs() > 0.5
    assert torch.equal(got[strong].sign(), ref[strong].sign())


def test_odd_window_goes_to_v1_kernel(dev, monkeypatch):
    """An odd window length (L=65) launches v1 through map_decode, in both
    modes, and not the radix-2 kernel."""
    monkeypatch.setattr(turbodecoder_cuda, "_pick_windows", lambda _: 16)
    args = _random_inputs(1040, 4, dev)
    before = (turbodecoder_cuda.launches, turbodecoder_cuda.launches_v1)
    for narrow in (False, True):
        got = turbodecoder_cuda.map_decode(*args, narrow=narrow)
        torch.testing.assert_close(got, turbodecoder_cuda.map_decode_v1_ref(*args, 16),
                                   atol=ATOL, rtol=RTOL)
    assert (turbodecoder_cuda.launches, turbodecoder_cuda.launches_v1) == (before[0], before[1] + 2)
    with pytest.raises(ValueError):
        turbodecoder_cuda.map_decode_cuda(*args, 16)  # the radix-2 kernel needs an even L


def test_v1_wrapper_rejects_what_the_kernel_does_not_take(dev):
    ls, lp, tx, tz = _random_inputs(512, 2, dev)
    with pytest.raises(TypeError):
        turbodecoder_cuda.map_decode_v1_cuda(ls.double(), lp, tx, tz, 2)
    with pytest.raises(ValueError):
        turbodecoder_cuda.map_decode_v1_cuda(ls.t().contiguous().t(), lp, tx, tz, 2)
    with pytest.raises(ValueError):
        turbodecoder_cuda.map_decode_v1_cuda(ls, lp.cpu(), tx, tz, 2)
    with pytest.raises(ValueError):
        turbodecoder_cuda.map_decode_v1_cuda(ls, lp, tx, tz, 3)  # 3 does not divide K
    g, a0, b0 = turbodecoder_cuda._v1_inputs(ls, lp, tx, tz, 2)
    with pytest.raises(ValueError):
        turbodecoder_cuda.launch_v1(g, a0[:4].contiguous(), b0)


@pytest.mark.parametrize("llr_bits", [32, 16])
def test_pusch_decode_through_the_kernel(dev, llr_bits):
    """A 25 PRB PUSCH subframe batch decodes bit-exactly through the kernel."""
    from srslte_emane_tpu_torch.models import ue_ul
    from srslte_emane_tpu_torch.phch import grid

    l_prb, qm = 25, 4
    tbs = (12 * l_prb * 12 * qm // 2 - 24) // 8 * 8
    cfg = ue_ul.UlSubframeConfig(cell=grid.CellConfig(n_prb=25, cell_id=42), sf_idx=2,
                                 rnti=0x5A, l_prb=l_prb, qm=qm, tbs=tbs)
    payload = torch.from_numpy(
        np.random.default_rng(3).integers(0, 2, (8, tbs), dtype=np.int8)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    rx = channel.awgn(gen, ue_ul.build_subframe(cfg, tb_bits=payload), 14.0)
    before = turbodecoder_cuda.launches
    out = ue_ul.enb_receive(rx, cfg, use_kernel=True, llr_bits=llr_bits)
    torch.cuda.synchronize()
    assert turbodecoder_cuda.launches > before
    got, ok = out["pusch"]
    assert bool(ok.all()) and torch.equal(got, payload)
