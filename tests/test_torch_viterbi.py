"""PyTorch port vs the JAX package: the tail-biting Viterbi decoder
(ops/fec/viterbi.py) and the routing to its CUDA kernel (ops/fec/
viterbi_cuda.py, csrc/viterbi.cu).

On the CPU `viterbi_decode` runs its plain loop, which must equal the JAX
decoder (jitted, one compile per shape and tb_iter) bit for bit at every K
a caller passes: UCI's 12-, 20- and 30-bit CQI reports on PUSCH (n + 8 =
20, 28, 38: tests/test_torch_uplink.py::test_uci_codes), PBCH's 40, DCI
formats 1A, 1 and 2A at 100 PRB (44, 55, 64), NPBCH's 50 and NPDSCH's 224
(its 208-bit TB and CRC16); at tb_iter 1, 3 and
5; on all-zero LLRs (every decision a tie), clean codewords and noisy,
coarsely quantised LLRs at the decision threshold (equal metrics and
decoding errors).  The wrapper's argument checks run against a stub
library object; the kernel itself runs only on the card
(tests/test_torch_cuda.py).
"""

import pathlib
import re
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from srslte_emane_tpu.ops.fec import viterbi as j_vit
from srslte_emane_tpu_torch.ops.fec import (convcoder, turbodecoder_cuda, viterbi as p_vit,
                                            viterbi_cuda)

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

REPO = pathlib.Path(__file__).resolve().parents[1]
# every K a caller passes: UCI 20, 28, 38; PBCH 40; DCI 1A / 1 / 2A at 100
# PRB 44, 55, 64; NPBCH 50; NPDSCH 224
KS = (20, 28, 38, 40, 44, 50, 55, 64, 224)
TB_ITERS = (1, 3, 5)


def _llrs(K, seed):
    """(8, 3, K) f32 stream LLRs, positive = bit 0, and the sent bits:
    row 0 all zero (every decision a tie), row 1 a clean codeword, rows 2-7
    BPSK at noise sigma 1.4, rounded to quarters (equal metrics), at the
    decision threshold: two to all six of them decode with errors."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (8, K), dtype=np.int8)
    cw = convcoder.conv_encode(torch.from_numpy(bits)).numpy().astype(np.float32)
    x = 1.0 - 2.0 * cw
    x[2:] = np.round(4 * (x[2:] + rng.normal(0, 1.4, x[2:].shape))) / 4
    x[0] = 0.0
    return x.astype(np.float32), bits


@pytest.mark.parametrize("tb_iter", TB_ITERS)
@pytest.mark.parametrize("K", KS)
def test_viterbi_equals_jax(K, tb_iter):
    x, sent = _llrs(K, 100 * K + tb_iter)
    got = p_vit.viterbi_decode(torch.from_numpy(x), tb_iter)
    ref = np.asarray(j_vit.viterbi_decode(x, tb_iter))
    assert got.dtype == torch.int8 and tuple(got.shape) == (8, K)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy()[0], 0)  # ties: state 0 throughout
    if tb_iter > 1:
        np.testing.assert_array_equal(got.numpy()[1], sent[1])
    assert (got.numpy()[2:] != sent[2:]).any(), "no decoding error: not at the threshold"


def test_a_k_beyond_shared_memory_equals_jax():
    """K = 1,211, the first K (at tb_iter 3) whose row does not fit the
    kernel's shared-memory variant: the plain loop, which the card's tests
    hold the global-memory variant to, equals the JAX decoder."""
    x, sent = _llrs(1211, 1211)
    x = x[:3]
    got = p_vit.viterbi_decode(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_vit.viterbi_decode(x)))
    np.testing.assert_array_equal(got.numpy()[1], sent[1])


@pytest.mark.parametrize("K", (40, 64))
def test_one_row_equals_jax(K):
    x, _ = _llrs(K, K)
    for row in (x[3:4], x[:1]):
        np.testing.assert_array_equal(p_vit.viterbi_decode(torch.from_numpy(row)).numpy(),
                                      np.asarray(j_vit.viterbi_decode(row)))


def test_no_rows():
    x = np.zeros((0, 3, 44), np.float32)
    got = p_vit.viterbi_decode(torch.from_numpy(x))
    ref = np.asarray(j_vit.viterbi_decode(x))
    assert got.dtype == torch.int8 and tuple(got.shape) == ref.shape == (0, 44)


def test_kernel_table_is_the_trellis():
    """csrc/viterbi.cu's kPredCombo is the table `_tables` computes from
    the generators, and the kernel's predecessor layout is the trellis's."""
    src = (REPO / "srslte_emane_tpu_torch" / "csrc" / "viterbi.cu").read_text()
    body = re.search(r"kPredCombo\[64\]\[2\] = \{(.*?)\n\};", src, re.S).group(1)
    table = np.array([[int(a), int(b)] for a, b in re.findall(r"\{(\d+), (\d+)\}", body)])
    preds, pred_combo, _ = p_vit._tables()
    np.testing.assert_array_equal(table, pred_combo)
    j_preds, j_combo, j_signs = j_vit._tables()
    np.testing.assert_array_equal(pred_combo, j_combo)
    np.testing.assert_array_equal(preds, j_preds)
    # lane l holds states 2l, 2l+1; both have predecessors l and l + 32,
    # held by lanes l >> 1 and 16 + (l >> 1) in slot l & 1
    lanes = np.arange(32)
    for slot in (0, 1):
        np.testing.assert_array_equal(preds[2 * lanes + slot], np.stack([lanes, lanes + 32], -1))
    np.testing.assert_array_equal(preds[2 * lanes, 0] >> 1, lanes >> 1)
    np.testing.assert_array_equal(preds[2 * lanes, 1] >> 1, 16 + (lanes >> 1))


def test_branch_metrics_equal_jax():
    x, _ = _llrs(44, 7)
    bm = p_vit.branch_metrics(torch.from_numpy(x))
    _, _, signs = j_vit._tables()
    ref = np.asarray(jax.jit(lambda v: 0.5 * jax.numpy.einsum("bik,ic->bkc", v, signs))(x))
    assert bm.is_contiguous() and tuple(bm.shape) == (8, 44, 8)
    np.testing.assert_array_equal(bm.numpy(), ref)


# ---------------- routing ----------------

def test_cpu_tensor_reaches_the_plain_version(monkeypatch):
    calls = []
    ref = p_vit.viterbi_decode_ref
    monkeypatch.setattr(p_vit, "viterbi_decode_ref",
                        lambda x, tb_iter=3: calls.append(tb_iter) or ref(x, tb_iter))
    monkeypatch.setattr(viterbi_cuda, "viterbi_decode_cuda",
                        lambda *a, **kw: pytest.fail("the kernel was asked for on the CPU"))
    x = torch.zeros((2, 3, 40))
    p_vit.viterbi_decode(x)
    p_vit.viterbi_decode(x, 5)
    assert calls == [3, 5]


def test_cuda_tensor_reaches_the_kernel(monkeypatch):
    """The route follows the LLRs' device alone: a tensor on a CUDA device
    (a stand-in with that device here) goes to the kernel's wrapper, never
    to the plain loop."""
    calls = []
    monkeypatch.setattr(p_vit, "viterbi_decode_ref",
                        lambda *a, **kw: pytest.fail("the plain loop was asked for on the card"))
    monkeypatch.setattr(viterbi_cuda, "viterbi_decode_cuda",
                        lambda x, tb_iter: calls.append(tb_iter) or "bits")
    x = types.SimpleNamespace(device=torch.device("cuda", 0))
    assert p_vit.viterbi_decode(x) == p_vit.viterbi_decode(x, 5) == "bits"
    assert calls == [3, 5]


def test_kernel_wrappers_refuse_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        viterbi_cuda.viterbi_decode_cuda(torch.zeros((2, 3, 40)))
    with pytest.raises(ValueError, match="CUDA"):
        viterbi_cuda.launch(torch.zeros((3, 44, 8)))


def test_import_loads_no_kernel_library():
    """Importing the decoder and its callers runs no nvcc and loads no
    kernel library (and no jax): the library comes with the first CUDA
    tensor."""
    code = ("import sys, pathlib\n"
            "import srslte_emane_tpu_torch.ops.fec.viterbi, srslte_emane_tpu_torch.phch.pdcch, "
            "srslte_emane_tpu_torch.phch.pbch, srslte_emane_tpu_torch.phch.uci, "
            "srslte_emane_tpu_torch.phch.nbiot, srslte_emane_tpu_torch.runtime.waveblock_dyn\n"
            "from srslte_emane_tpu_torch.ops.fec import viterbi_cuda, turbodecoder_cuda\n"
            "assert turbodecoder_cuda.build.cache_info().currsize == 0\n"
            "maps = pathlib.Path('/proc/self/maps').read_text()\n"
            "assert 'libviterbi' not in maps and 'libturbo_map' not in maps\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'srslte_emane_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


# ---------------- the wrapper's checks, on a stub library ----------------

class StubLib:
    """Stands in for the nvcc-built library: refuses K above `max_k` as
    viterbi_fits does above the shared-memory limit, and K above `max_global`
    as viterbi_global_fits does beyond both variants; records launches and
    whether each had a decisions scratch."""

    def __init__(self, max_k=100, max_global=1000, err=0):
        self.max_k, self.max_global, self.err, self.calls, self.scratch = (
            max_k, max_global, err, [], [])

    def viterbi_fits(self, K, tb_iter):
        return int(0 < K <= self.max_k and tb_iter > 0)

    def viterbi_global_fits(self, K, tb_iter):
        return int(0 < K <= self.max_global and tb_iter > 0)

    def viterbi_launch(self, bm, bits, scratch, R, K, tb_iter, stream):
        self.calls.append((R, K, tb_iter))
        self.scratch.append(scratch is not None)
        return self.err


@pytest.fixture
def stub(monkeypatch):
    """A stub library, with CPU tensors let through the device check."""
    lib = StubLib()
    monkeypatch.setattr(viterbi_cuda, "_lib", lambda: lib)
    monkeypatch.setattr(turbodecoder_cuda, "_on_card", lambda t, device: True)
    monkeypatch.setattr(viterbi_cuda, "_stream", lambda dev: 0)
    return lib


def test_launch_reaches_the_library_once(stub):
    before = viterbi_cuda.launches
    bits = viterbi_cuda.launch(torch.zeros((5, 44, 8)), 3)
    assert stub.calls == [(5, 44, 3)] and viterbi_cuda.launches == before + 1
    assert stub.scratch == [False]  # the shared-memory variant needs none
    assert bits.dtype == torch.int8 and tuple(bits.shape) == (5, 44)


@pytest.mark.parametrize("tb_iter", [1, 3, 5])
def test_a_k_beyond_shared_memory_takes_the_global_variant(stub, monkeypatch, tb_iter):
    """Above viterbi_fits' limit the wrapper allocates the decisions
    scratch, (R, (tb_iter - tb_iter // 2) * K) pairs of int32, and launches
    once: a route by shape, not a fallback to the plain loop."""
    shapes = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda shape, **kw: shapes.append(
        (tuple(shape), kw.get("dtype"))) or empty(shape, **kw))
    monkeypatch.setattr(p_vit, "viterbi_decode_ref",
                        lambda *a, **kw: pytest.fail("the plain loop was asked for"))
    before = viterbi_cuda.launches
    bits = viterbi_cuda.launch(torch.zeros((3, 101, 8)), tb_iter)
    assert stub.calls == [(3, 101, tb_iter)] and stub.scratch == [True]
    assert viterbi_cuda.launches == before + 1 and tuple(bits.shape) == (3, 101)
    assert ((3, (tb_iter - tb_iter // 2) * 101, 2), torch.int32) in shapes


def test_decode_passes_the_branch_metrics(stub, monkeypatch):
    seen = []
    launch = viterbi_cuda.launch
    monkeypatch.setattr(viterbi_cuda, "launch", lambda bm, tb: seen.append(bm) or launch(bm, tb))
    x, _ = _llrs(55, 3)
    x = torch.from_numpy(x)
    viterbi_cuda.viterbi_decode_cuda(x, 5)
    assert stub.calls == [(8, 55, 5)]
    assert seen[0].is_contiguous() and torch.equal(seen[0], p_vit.branch_metrics(x))


def test_no_launch_for_no_rows(stub):
    before = viterbi_cuda.launches
    bits = viterbi_cuda.launch(torch.zeros((0, 44, 8)))
    assert tuple(bits.shape) == (0, 44) and bits.dtype == torch.int8
    assert stub.calls == [] and viterbi_cuda.launches == before


def test_launch_rejects_what_the_kernel_does_not_take(stub):
    bm = torch.zeros((3, 44, 8))
    with pytest.raises(ValueError, match="beyond both variants"):
        viterbi_cuda.launch(torch.zeros((3, 1001, 8)))  # above the library's K limit
    with pytest.raises(TypeError, match="float32"):
        viterbi_cuda.launch(bm.double())
    with pytest.raises(ValueError, match="contiguous"):
        viterbi_cuda.launch(torch.zeros((3, 8, 44)).transpose(1, 2))
    with pytest.raises(ValueError, match="shape"):
        viterbi_cuda.launch(torch.zeros((3, 44, 4)))
    with pytest.raises(ValueError, match="tb_iter"):
        viterbi_cuda.launch(bm, 0)
    with pytest.raises(ValueError, match="shape"):
        viterbi_cuda.viterbi_decode_cuda(torch.zeros((3, 2, 44)))
    assert stub.calls == []


def test_launch_error_raises(stub):
    stub.err = 1  # cudaErrorInvalidValue
    before = viterbi_cuda.launches
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        viterbi_cuda.launch(torch.zeros((3, 44, 8)))
    assert viterbi_cuda.launches == before
