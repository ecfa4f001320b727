"""The CUDA MAP kernel against its plain PyTorch version, on the card.

Marked `cuda`: skips without a CUDA device.  The card's machine has no jax,
so run this file there without the suite's conftest:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

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
