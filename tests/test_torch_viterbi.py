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
(tests/test_torch_cuda.py), but its lane map (which lane and slot hold
each state, which rounds bring each predecessor, which bit each decision
takes) is transcribed from csrc/viterbi.cu and run here in numpy.
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
    # lane j of a row holds states S j .. S j + S - 1 (S = 64 / kLanes); their
    # predecessors are the S / 2 states from S / 2 j in each half, held by
    # lanes j >> 1 and kLanes / 2 + (j >> 1) from offset S / 2 (j & 1)
    lanes, low, _, _ = _kernel_constants()
    S = 64 // lanes
    for j in range(lanes):
        for t in range(S):
            a, b = preds[S * j + t]
            assert (a // S, a % S) == (j >> 1, S // 2 * (j & 1) + (t >> 1))
            assert (b // S, b % S) == (lanes // 2 + (j >> 1), S // 2 * (j & 1) + (t >> 1))
    # the code is linear: kLowCombos and lane j's first combo give every
    # branch's combo, and combo 1 is combo 0 ^ 7
    assert [(low >> 4 * t) & 15 for t in range(16)] == pred_combo[:16, 0].tolist()
    s_ = np.arange(64)
    np.testing.assert_array_equal(pred_combo[:, 1], pred_combo[:, 0] ^ 7)
    np.testing.assert_array_equal(pred_combo[:, 0], pred_combo[s_ - s_ % S, 0] ^ pred_combo[s_ % S, 0])


def _kernel_constants():
    """csrc/viterbi.cu's kLanes (lanes per row), kLowCombos, and kSpread and
    kDelta (their values at kLanes = 8)."""
    src = (REPO / "srslte_emane_tpu_torch" / "csrc" / "viterbi.cu").read_text()
    lanes = int(re.search(r"constexpr int kLanes = (\d+);", src).group(1))
    low = int(re.search(r"kLowCombos = (0x[0-9a-f]+)ull;", src).group(1), 16)
    spread, delta = re.search(r"constexpr int kSpread = kLanes == 8 \? (\d+) : (\d+), "
                              r"kDelta = kLanes == 8 \? (\d+) : (\d+);", src).group(1, 3)
    assert lanes == 8
    return lanes, low, int(spread), int(delta)


def _kernel_lane_map():
    """The kernel's step, index by index, as numpy arrays over the 64
    (lane j, slot t) positions of a row (position S j + t): the state each
    holds (S j + (t ^ kSpread j)); the states whose metrics its candidates
    u and v add (those in the shuffle rounds t >> 1 and (t >> 1) ^ kDelta,
    in which lane src sends its slot r; the source lanes transcribed from
    csrc/viterbi.cu); the combos of their branch metrics (at the lane's
    base, xored with 7 on an odd lane); the sign sg (-1 on an odd lane,
    where u is predecessor 1) whose product with v - u is positive for a
    decision; and the bit of the step's decision word it writes."""
    lanes, low, spread, delta = _kernel_constants()
    S, H = 64 // lanes, 32 // lanes
    _, pred_combo, _ = p_vit._tables()
    pos = dict(state=[], u=[], v=[], cu=[], cv=[], sg=[], bit=[])
    for j in range(lanes):
        odd, a = j & 1, spread * j
        src_lo = (j >> 1) + (lanes // 2 if odd else 0)
        src_hi = (j >> 1) + (0 if odd else lanes // 2)
        rcv = []
        for r in range(S):  # round r: lane src sends slot r, state S src + (r ^ spread src)
            src = src_lo if r < H else src_hi
            rcv.append(S * src + (r ^ (spread * src)))
        base = int(pred_combo[S * j, 0]) ^ ((low >> 4 * a) & 15) ^ (7 if odd else 0)
        for t in range(S):
            c = (low >> 4 * t) & 15
            for k, v in (("state", S * j + (t ^ a)), ("u", rcv[t >> 1]),
                         ("v", rcv[(t >> 1) ^ delta]), ("cu", base ^ c), ("cv", base ^ c ^ 7),
                         ("sg", -1.0 if odd else 1.0), ("bit", 8 * (j * S // 8) + (t ^ a))):
                pos[k].append(v)
    return {k: np.array(v) for k, v in pos.items()}


def test_kernel_lane_map_is_the_trellis():
    """The lane map against `_tables()`: the positions hold every state
    once; u and v add the state's two
    predecessors' metrics (predecessor 0 in u on an even lane, in v on an
    odd one, where sg is -1) to the branch metrics of their combos; and the
    state's decision is bit s of the step's word (S / 8 bytes a lane, in
    lane order), the bit the traceback reads."""
    preds, pred_combo, _ = p_vit._tables()
    m = _kernel_lane_map()
    s = m["state"]
    np.testing.assert_array_equal(np.sort(s), np.arange(64))
    odd = m["sg"] < 0
    np.testing.assert_array_equal(np.where(odd, m["v"], m["u"]), preds[s, 0])
    np.testing.assert_array_equal(np.where(odd, m["u"], m["v"]), preds[s, 1])
    np.testing.assert_array_equal(np.where(odd, m["cv"], m["cu"]), pred_combo[s, 0])
    np.testing.assert_array_equal(np.where(odd, m["cu"], m["cv"]), pred_combo[s, 1])
    np.testing.assert_array_equal(m["bit"], s)


@pytest.mark.parametrize("tb_iter", (1, 3))
def test_kernel_lane_map_decodes_as_the_plain_loop(tb_iter):
    """The kernel's step run through its lane map in numpy (float32, each
    add and subtract rounded once; a decision where sg (v - u) > 0, its bit
    added to 2^23 in float32 and read back from the low mantissa bits; the
    maximum as fmaxf takes it; the final state the first maximum; the
    traceback on bit s of each step's word) decodes the tie, clean and
    threshold rows of `_llrs` as viterbi_decode_ref."""
    m = _kernel_lane_map()
    sg = m["sg"].astype(np.float32)
    lanes = _kernel_constants()[0]
    S = 64 // lanes
    for K in (20, 44):
        x, _ = _llrs(K, 7 * K + tb_iter)
        bm = p_vit.branch_metrics(torch.from_numpy(x)).numpy()  # (R, K, 8) f32
        R, T, mid = x.shape[0], tb_iter * K, (tb_iter // 2) * K
        metric = np.zeros((R, 64), np.float32)
        words = []
        for t in range(T):
            b = bm[:, t % K]
            u = metric[:, m["u"]] + b[:, m["cu"]]
            v = metric[:, m["v"]] + b[:, m["cv"]]
            n = np.maximum(u, v)
            metric = np.empty_like(metric)
            metric[:, m["state"]] = n - n.max(axis=1, keepdims=True)
            d = ((v - u) * sg > 0).astype(np.float32)
            lane_bits = np.full((R, lanes), 2.0 ** 23, np.float32)
            for p_ in range(64):  # each lane's bits summed onto 2^23, one add at a time
                lane_bits[:, p_ // S] += d[:, p_] * np.float32(2 ** (m["bit"][p_] % S))
            low = (lane_bits.view(np.uint32) & (2 ** S - 1)).astype(np.uint64)
            words.append((low << (S * np.arange(lanes, dtype=np.uint64))).sum(1))
        state = metric.argmax(1)
        out = np.zeros((R, K), np.int8)
        for t in range(T - 1, mid - 1, -1):
            if t < mid + K:
                out[:, t - mid] = state & 1
            state = (state >> 1) | (((words[t] >> state.astype(np.uint64)) & 1).astype(int) << 5)
        ref = p_vit.viterbi_decode_ref(torch.from_numpy(x), tb_iter).numpy()
        np.testing.assert_array_equal(out, ref)


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
