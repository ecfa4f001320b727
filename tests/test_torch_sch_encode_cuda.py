"""The DL-SCH encode kernel (csrc/sch_encode.cu, ops/fec/sch_encode_cuda.py)
against its plain version, `sch.encode_tb_ref`, on the card: bit for bit at
the benchmark cell's shape (128 x TBS 51,024: 9 code blocks of K = 5,696),
with fillers in one and in two code-block sizes, at K = 40 with and without
fillers, a one-row TB, each redundancy version with and without a soft-
buffer limit, one redundancy version per row (the dynamic block's path), a
UL-SCH codeword through `pusch.encode` and TM3's two codewords through
`pdsch.encode_tm`; a captured encode against the eager one; its launches
and encoded code blocks; and what the wrapper refuses.  At the cell's shape,
at K = 40 with fillers and with one redundancy version per row, the card's
bits are also held to the JAX package's `encode_tb` through the digests in
`JAX_DIGESTS`, which tests/test_torch_sch_encode.py recomputes from the JAX
package on the CPU (the card's machine has no JAX).

Marked `cuda`: skips without a CUDA device.  Run on the card with
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_sch_encode_cuda.py
"""

import hashlib
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from srslte_emane_tpu_torch.ops.fec import cbsegm, sch_encode_cuda as sec
from srslte_emane_tpu_torch.phch import sch

pytestmark = pytest.mark.cuda

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bits(B, tbs, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 2, (B, tbs), dtype=np.int8)).to(dev)


def _with_fillers(c_minus):
    for tbs in range(6128, 20000, 8):
        s = cbsegm.cbsegm(tbs)
        if s.C > 1 and s.F > 0 and (s.C_minus > 0) == c_minus:
            return tbs
    raise AssertionError("no such TBS")


def hashed_bits(B, tbs, salt):
    """(B, tbs) int8 0/1 payload bits that every numpy version makes alike:
    the top bit of a multiplicative hash of each bit's index."""
    h = (np.arange(B * tbs, dtype=np.uint64) + np.uint64(salt)) * np.uint64(0x9E3779B97F4A7C15)
    h = (h ^ (h >> np.uint64(29))) * np.uint64(0xBF58476D1CE4E5B9)
    return (h >> np.uint64(63)).astype(np.int8).reshape(B, tbs)


def digest(bits):
    """The first 16 hex digits of the SHA-256 of (B, G) 0/1 bits, packed."""
    packed = np.packbits(np.asarray(bits, dtype=np.uint8), axis=1)
    return hashlib.sha256(packed.tobytes()).hexdigest()[:16]


# name: (SchConfig arguments, rows, rv_b or None), on hashed_bits(rows, tbs, len(name))
JAX_CASES = {
    "cell": (dict(tbs=51024, G=90000, Qm=6, Nl=1), 2, None),
    "k40_fillers": (dict(tbs=8, G=132, Qm=2, Nl=1), 5, None),
    "rv_b_ncb": (dict(tbs=6968, G=15000, Qm=6, Nl=1, ncb=2000), 12,
                 (0, 1, 2, 3, 3, 2, 1, 0, 2, 2, 0, 1)),
}
# the digests of the JAX package's encode_tb on JAX_CASES
JAX_DIGESTS = {
    "cell": "654726b573774ed0",
    "k40_fillers": "41bb656765e60b51",
    "rv_b_ncb": "d4237e9e8765ab81",
}


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_kernel_equals_the_jax_reference(dev, name):
    """The card's bits against the JAX package's encode_tb, by digest."""
    kw, B, rv_b = JAX_CASES[name]
    cfg = sch.SchConfig(**kw)
    bits = torch.from_numpy(hashed_bits(B, cfg.tbs, len(name))).to(dev)
    if rv_b is not None:
        rv_b = torch.tensor(rv_b, device=dev)
    got = sch.encode_tb(bits, cfg, rv_b=rv_b)
    assert digest(got.cpu().numpy()) == JAX_DIGESTS[name]


# name: (SchConfig arguments, rows)
CASES = {
    "cell": (dict(tbs=51024, G=90000, Qm=6, Nl=1), 128),
    "cell_one_row": (dict(tbs=51024, G=90000, Qm=6, Nl=1), 1),
    "fillers_c2": (dict(tbs=_with_fillers(False), G=12000, Qm=4, Nl=1), 16),
    "fillers_two_sizes": (dict(tbs=_with_fillers(True), G=13200, Qm=6, Nl=1), 16),
    "k40": (dict(tbs=16, G=120, Qm=2, Nl=1), 64),
    "k40_fillers": (dict(tbs=8, G=132, Qm=2, Nl=1), 5),
    "one_row_c1_fillers": (dict(tbs=4416, G=13824, Qm=4, Nl=1), 1),
    "k6144": (dict(tbs=6120, G=18000, Qm=6, Nl=1), 7),
    "tbs_not_bytes": (dict(tbs=6203, G=12000, Qm=2, Nl=1), 3),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_plain(dev, name):
    """Bit for bit, in 1 launch for one code block and 2 for more, with B x C
    code blocks counted on the card."""
    kw, B = CASES[name]
    cfg = sch.SchConfig(**kw)
    bits = _bits(B, cfg.tbs, len(name), dev)
    C = cfg.segm.C
    sch.read_encode_blocks()
    sch.reset_encode_blocks()
    before, blocks = sec.launches, sec.launched_blocks
    got = sch.encode_tb(bits, cfg)
    torch.cuda.synchronize()
    assert sec.launches == before + (2 if C > 1 else 1)
    assert sch.read_encode_blocks() == sec.launched_blocks - blocks == B * C
    assert got.dtype == torch.int8 and tuple(got.shape) == (B, cfg.G)
    assert torch.equal(got, sch.encode_tb_ref(bits, cfg))


@pytest.mark.parametrize("rv", [0, 1, 2, 3])
@pytest.mark.parametrize("ncb", [0, 3000])
def test_each_redundancy_version(dev, rv, ncb):
    """cfg.rv 0-3, with and without a soft-buffer limit, at 2 code blocks
    (E below V) and at one K = 1,568 block repeated (E above V)."""
    for kw in (dict(tbs=6968, G=15000, Qm=6, Nl=1), dict(tbs=1544, G=9600, Qm=2, Nl=1)):
        cfg = sch.SchConfig(**kw, rv=rv, ncb=ncb)
        bits = _bits(8, cfg.tbs, rv + ncb, dev)
        assert torch.equal(sch.encode_tb(bits, cfg), sch.encode_tb_ref(bits, cfg)), kw


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32, torch.int64])
@pytest.mark.parametrize("ncb", [0, 2000])
def test_one_redundancy_version_per_row(dev, dtype, ncb):
    """rv_b, the dynamic block's path (`rate_match_tx_dyn`), of any integer type."""
    cfg = sch.SchConfig(tbs=6968, G=15000, Qm=6, Nl=1, ncb=ncb)
    bits = _bits(12, cfg.tbs, 4, dev)
    rv_b = torch.tensor([0, 1, 2, 3, 3, 2, 1, 0, 2, 2, 0, 1], dtype=dtype, device=dev)
    got = sch.encode_tb(bits, cfg, rv_b=rv_b)
    assert torch.equal(got, sch.encode_tb_ref(bits, cfg, rv_b=rv_b))


def _with_plain_encode(monkeypatch):
    monkeypatch.setattr(sch, "encode_tb", sch.encode_tb_ref)


def test_pusch_codeword(dev, monkeypatch):
    """The 20 MHz PUSCH cell (100 PRB, 96 PRB at 16QAM, rate 0.5: 5 code
    blocks) through pusch.encode, against the same call on the plain
    encode."""
    from srslte_emane_tpu_torch.phch import grid, pusch

    l_prb, qm = 96, 4
    G = 12 * l_prb * pusch.N_DATA_SYMS * qm
    cfg = sch.SchConfig(tbs=(int(G * 0.5) - 24) // 8 * 8, G=G, Qm=qm, Nl=1)
    cell = grid.CellConfig(n_prb=100, cell_id=1)
    bits = _bits(16, cfg.tbs, 6, dev)
    got = pusch.encode(bits, cfg, cell, 2, 0x5A, 0, l_prb)
    _with_plain_encode(monkeypatch)
    assert torch.equal(got, pusch.encode(bits, cfg, cell, 2, 0x5A, 0, l_prb))


def test_tm3_two_codewords(dev, monkeypatch):
    """The 2x2 TM3 cell of scripts/bench_extra.py (2 ports, 64QAM rate 0.5
    per codeword) through pdsch.encode_tm: both codewords' grids."""
    from srslte_emane_tpu_torch.phch import grid, pdsch

    cell = grid.CellConfig(n_prb=100, cell_id=7, n_ports=2, cfi=1)
    mask = (1,) * 100
    n_re = grid.nof_re(cell, 1, mask)
    cfg = sch.SchConfig(tbs=(int(n_re * 6 * 0.5) - 24) // 8 * 8, G=n_re * 6, Qm=6, Nl=1)
    tbs = [_bits(8, cfg.tbs, 7 + q, dev) for q in range(2)]
    before = sec.launches
    got = pdsch.encode_tm(tbs, [cfg, cfg], cell, 1, 0x46, mask, "tm3")
    assert sec.launches == before + 4
    _with_plain_encode(monkeypatch)
    assert torch.equal(got, pdsch.encode_tm(tbs, [cfg, cfg], cell, 1, 0x46, mask, "tm3"))


def test_captured_encode_equals_eager(dev):
    """The encode in a graphs.jit step: each replay equals the eager call,
    and adds its launches and its B x C code blocks."""
    from srslte_emane_tpu_torch.runtime import graphs

    cfg = sch.SchConfig(tbs=51024, G=90000, Qm=6, Nl=1)
    step = graphs.jit(lambda p: sch.encode_tb(p, cfg))
    first, second = _bits(32, cfg.tbs, 8, dev), _bits(32, cfg.tbs, 9, dev)
    step(first)  # warm-up and capture
    sch.read_encode_blocks()
    sch.reset_encode_blocks()
    before, blocks = sec.launches, sec.launched_blocks
    for bits in (second, first):
        assert torch.equal(step(bits), sch.encode_tb(bits, cfg))
    torch.cuda.synchronize()
    assert sec.launches == before + 4 * 2  # two replays and two eager calls
    assert sch.read_encode_blocks() == sec.launched_blocks - blocks == 4 * 32 * 9


# a `python -c` body: one encode at 9 code blocks and one at 1 under
# torch.profiler, after a warm-up; prints {name: {kernel: runs}}
PROFILE_ENCODES = """
import json, torch
from torch.profiler import ProfilerActivity, profile
from srslte_emane_tpu_torch.phch import sch
dev = torch.device("cuda", 0)
out = {}
for name, cfg in (("c9", sch.SchConfig(tbs=51024, G=90000, Qm=6, Nl=1)),
                  ("c1", sch.SchConfig(tbs=4416, G=13824, Qm=4, Nl=1))):
    bits = torch.randint(0, 2, (128, cfg.tbs), dtype=torch.int8, device=dev)
    sch.encode_tb(bits, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sch.encode_tb(bits, cfg)
        torch.cuda.synchronize()
    out[name] = {e.key: e.count for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.self_device_time_total > 0}
print(json.dumps(out))
"""


def test_an_encode_is_its_launches_on_the_card(dev):
    """In a fresh process (late in a long one the profiler may record no
    device events): an encode of 9 code blocks runs sch_tb_crc_kernel and
    sch_encode_kernel once each on the card, one of 1 code block
    sch_encode_kernel alone, and nothing else."""
    out = subprocess.run([sys.executable, "-c", PROFILE_ENCODES], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    runs = json.loads(out.stdout.splitlines()[-1])
    names = lambda kernels: sorted(k for k in kernels if "sch_" in k)
    assert len(runs["c9"]) == 2 and sum(runs["c9"].values()) == 2, runs
    assert any("sch_tb_crc_kernel" in k for k in names(runs["c9"])), runs
    assert any("sch_encode_kernel" in k for k in names(runs["c9"])), runs
    assert len(runs["c1"]) == 1 and sum(runs["c1"].values()) == 1, runs
    assert "sch_encode_kernel" in names(runs["c1"])[0], runs


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    bits = _bits(4, 1544, 1, dev)
    e = (2400,)
    before = sec.launches
    with pytest.raises(TypeError):
        sec.launch(bits.to(torch.int64), e)
    with pytest.raises(ValueError):
        sec.launch(_bits(4, 3088, 1, dev)[:, ::2], e)  # not contiguous
    with pytest.raises(ValueError):
        sec.launch(bits[0], e)  # not (B, tbs)
    with pytest.raises(ValueError):
        sec.launch(bits.cpu(), e)
    with pytest.raises(ValueError):
        sec.launch(bits, e, rv=4)
    with pytest.raises(ValueError):
        sec.launch(bits, (1200, 1200))  # one code block, not two
    with pytest.raises(ValueError):
        sec.launch(bits, e, rv_b=torch.zeros(3, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        sec.launch(bits, e, rv_b=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError):
        sec.launch(bits, e, rv_b=torch.zeros(4, dtype=torch.float32, device=dev))
    assert sec.launches == before
    empty = sec.launch(bits[:0], e)
    assert tuple(empty.shape) == (0, 2400) and sec.launches == before
