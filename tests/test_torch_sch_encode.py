"""The host tables of the DL-SCH encode kernel (csrc/sch_encode.cu,
ops/fec/sch_encode_cuda.py) and the arithmetic the kernel does with them,
on the CPU.

The kernel runs only on the card (tests/test_torch_sch_encode_cuda.py holds
it to the plain `sch.encode_tb` there).  Here `kernel_encode` transcribes
what its blocks do, step by step, in numpy: the word-wise CRCs through the
byte tables and word weights, with its carry-less `mulmod`; the two passes
of the RSC byte table around the scan of entry states (in-warp shuffles,
then warps, with the powers A^p); the tails; the bit selection through
`zmap` from the launch's rv or each row's rv_b.  It must give the plain
encode's bits at every shape the card tests use; the tables alone are held
to `crc.crc_host`, `turbo.turbo_encode_host`, `rm_turbo.tx_table` and
`rm_turbo.rate_match_tx_dyn`.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from srslte_emane_tpu_torch.ops.fec import cbsegm, crc, rm_turbo, sch_encode_cuda as sec, turbo
from srslte_emane_tpu_torch.phch import sch
from srslte_emane_tpu_torch.runtime import graphs
from test_torch_sch_encode_cuda import JAX_CASES, JAX_DIGESTS, digest, hashed_bits

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

REPO = pathlib.Path(__file__).resolve().parents[1]
THREADS = sec.THREADS


def crc_byte(s, byte, tab):
    return ((s << 8) & 0xFFFFFF) ^ int(tab[((s >> 16) ^ byte) & 0xFF])


def kernel_mulmod(a, b, tab):
    """csrc/sch_encode.cu `mulmod`: carry-less product, reduced by the table."""
    p = 0
    for i in range(24):
        if a >> i & 1:
            p ^= b << i
    hi = p >> 24
    r = crc_byte(0, hi >> 16, tab)
    r = crc_byte(r, hi >> 8 & 0xFF, tab)
    r = crc_byte(r, hi & 0xFF, tab)
    return r ^ (p & 0xFFFFFF)


def block_crc(bits, tab, pw):
    """`block_crc`: word t of the message padded in front to THREADS words,
    folded through the table, weighed by pw[t]; the words XORed."""
    n = len(bits)
    assert n % 8 == 0 and n <= 32 * THREADS
    padded = np.concatenate([np.zeros(32 * THREADS - n, np.uint8), bits & 1])
    words = np.packbits(padded.astype(np.uint8)).reshape(THREADS, 4)
    rem = 0
    for t in range(THREADS):
        if 32 * t - (32 * THREADS - n) <= -32:
            continue
        s = 0
        for u in range(4):
            s = crc_byte(s, int(words[t, u]), tab)
        rem ^= kernel_mulmod(s, int(pw[t]), tab)
    return rem


def tables():
    t = sec.small_tables().astype(np.int64)
    return dict(crc_a=t[sec.TAB_CRC_A:sec.TAB_CRC_A + 256],
                crc_b=t[sec.TAB_CRC_B:sec.TAB_CRC_B + 256],
                pow_a=t[sec.TAB_POW_A:sec.TAB_POW_A + THREADS],
                pow_b=t[sec.TAB_POW_B:sec.TAB_POW_B + THREADS],
                rsc=t[sec.TAB_RSC:sec.TAB_APOW], apow=t[sec.TAB_APOW:sec.TAB_TAIL],
                tail=t[sec.TAB_TAIL:sec.TAB_LEN])


def rsc_streams(d0_bits, k, f1, f2, tb):
    """The kernel's constituents on d0's K bits: (d1, d2, final states),
    word t of each input from thread t, entry states from its scan."""
    nw = -(-k // 32)
    bits = np.zeros(32 * nw, np.int64)
    bits[:k] = d0_bits[:k]
    perm = [(f1 * i + f2 * i * i) % k for i in range(32 * nw)]
    inter = np.array([d0_bits[q] for q in perm], np.int64)
    rsc, apow = tb["rsc"], tb["apow"]

    def word(x, t):
        return int(np.packbits(x[32 * t:32 * t + 32].astype(np.uint8)).view(">u4")[0])

    w1 = [word(bits, t) for t in range(nw)]
    w2 = [word(inter, t) for t in range(nw)]
    nb = [min(4, (k - 32 * t) >> 3) for t in range(nw)]

    def run(s, w, n):
        out = []
        for u in range(n):
            e = int(rsc[s << 8 | (w >> (24 - 8 * u) & 0xFF)])
            out.append(e & 0xFF)
            s = e >> 8
        return s, out

    apply = lambda q, v: int(apow[q * 8 + (v & 7)]) | int(apow[q * 8 + (v >> 3)]) << 3
    y = [0] * THREADS
    for t in range(nw):
        y[t] = run(0, w1[t], nb[t])[0] | run(0, w2[t], nb[t])[0] << 3
    o = 1
    while o < 32:  # Hillis-Steele in each warp (__shfl_up_sync)
        y = [y[t] ^ apply(4 * o % 7, y[t - o]) if t % 32 >= o else y[t] for t in range(THREADS)]
        o <<= 1
    totals = [y[32 * w + 31] for w in range(THREADS // 32)]
    d1 = np.zeros(k + 4, np.int64)
    d2 = np.zeros(k + 4, np.int64)
    finals = None
    for t in range(nw):
        e = 0 if t % 32 == 0 else y[t - 1]
        enter = 0
        for w in range(t // 32):
            enter = apply(2, enter) ^ totals[w]
        e ^= apply(4 * (t % 32) % 7, enter)
        s1, p1 = run(e & 7, w1[t], nb[t])
        s2, p2 = run(e >> 3, w2[t], nb[t])
        for u in range(nb[t]):
            d1[32 * t + 8 * u:32 * t + 8 * u + 8] = np.unpackbits(np.uint8(p1[u]))
            d2[32 * t + 8 * u:32 * t + 8 * u + 8] = np.unpackbits(np.uint8(p2[u]))
        finals = (s1, s2)
    return d1, d2, finals


def code_block_streams(d0, k, f1, f2, tb):
    """d0 (K + 4,) with its K bits set -> the three d-streams, tails in."""
    d0 = d0.copy()
    d1, d2, (s1, s2) = rsc_streams(d0, k, f1, f2, tb)
    t1, t2 = int(tb["tail"][s1]), int(tb["tail"][s2])
    for j, (a, sh) in enumerate(((t1, 0), (t1, 3), (t2, 0), (t2, 3))):
        d0[k + j] = a >> sh & 1
        d1[k + j] = a >> (sh + 1) & 1
        d2[k + j] = a >> (sh + 2) & 1
    return d0, d1, d2


def kernel_encode(bits, e_sizes, rv=0, ncb=0, rv_b=None):
    """What the kernel's blocks compute: (B, tbs) 0/1 -> (B, G) int8."""
    B, tbs = bits.shape
    rows, z = sec.plan(tbs, tuple(e_sizes), ncb)
    tb = tables()
    C = len(rows)
    G = sum(e_sizes)
    out = np.zeros((B, G), np.int8)
    for b in range(B):
        row = bits[b].astype(np.int64) & 1
        shares = []
        if C > 1:  # tb_crc_kernel
            for p in rows:
                ntb = p[sec.P_NTB]
                pad = (8 - ntb % 8) % 8
                chunk = row[p[sec.P_SRC]:p[sec.P_SRC] + ntb]
                msg = np.concatenate([np.zeros(pad, np.int64), chunk])
                shares.append(kernel_mulmod(block_crc(msg, tb["crc_a"], tb["pow_a"]),
                                            int(p[sec.P_TBPOW]), tb["crc_a"]))
        tbcrc = int(np.bitwise_xor.reduce(shares)) if shares else 0
        for p in rows:  # encode_kernel
            k, f, src, ndata = (int(p[i]) for i in (sec.P_K, sec.P_F, sec.P_SRC, sec.P_NDATA))
            d0 = np.zeros(k + 4, np.int64)
            q = src + np.arange(ndata)
            d0[f:f + ndata] = np.where(q < tbs, row[np.minimum(q, tbs - 1)],
                                       tbcrc >> np.clip(23 - (q - tbs), 0, 23) & 1)
            if C == 1:
                rem = block_crc(d0[:f + tbs], tb["crc_a"], tb["pow_a"])
                d0[f + tbs:f + tbs + 24] = [rem >> (23 - i) & 1 for i in range(24)]
            else:
                rem = block_crc(d0[:k - 24], tb["crc_b"], tb["pow_b"])
                d0[k - 24:k] = [rem >> (23 - i) & 1 for i in range(24)]
            streams = code_block_streams(d0, k, int(p[sec.P_F1]), int(p[sec.P_F2]), tb)
            smem = np.zeros(3 * sec.STRIDE, np.int64)
            for s, d in enumerate(streams):
                smem[s * sec.STRIDE:s * sec.STRIDE + k + 4] = d
            E, V = int(p[sec.P_E]), int(p[sec.P_V])
            rvq = rv if rv_b is None else int(rv_b[b]) & 3
            start = int(p[sec.P_START + rvq])
            idx = (start + np.arange(E)) % V
            zt = z[p[sec.P_ZOFF]:p[sec.P_ZOFF] + V].astype(np.int64)
            out[b, p[sec.P_OUT]:p[sec.P_OUT] + E] = smem[zt[idx]]
    return out


def _bits(B, tbs, seed):
    return np.random.default_rng(seed).integers(0, 2, (B, tbs), dtype=np.int8)


def _with_fillers(c_minus=False):
    """The smallest TBS of more than one code block with fillers (and
    blocks of two sizes, for c_minus)."""
    for tbs in range(6128, 20000, 8):
        s = cbsegm.cbsegm(tbs)
        if s.C > 1 and s.F > 0 and (s.C_minus > 0) == c_minus:
            return tbs
    raise AssertionError("no such TBS")


# (name, SchConfig arguments, rows): the card tests' shapes, cut in rows
CASES = {
    "cell": (dict(tbs=51024, G=90000, Qm=6, Nl=1), 1),
    "fillers_c2": (dict(tbs=_with_fillers(), G=12000, Qm=4, Nl=1), 2),
    "fillers_two_sizes": (dict(tbs=_with_fillers(True), G=13200, Qm=6, Nl=1), 2),
    "k40": (dict(tbs=16, G=120, Qm=2, Nl=1), 3),
    "k40_fillers": (dict(tbs=8, G=132, Qm=2, Nl=1), 2),
    "one_row_c1": (dict(tbs=4416, G=13824, Qm=4, Nl=1), 1),
    "rv1": (dict(tbs=1544, G=2400, Qm=2, Nl=1, rv=1), 2),
    "rv2_ncb": (dict(tbs=1544, G=2400, Qm=2, Nl=1, rv=2, ncb=2000), 2),
    "rv3_ncb_repeat": (dict(tbs=328, G=2880, Qm=2, Nl=1, rv=3, ncb=600), 2),
    "ul_16qam": (dict(tbs=25456, G=57600, Qm=4, Nl=1), 1),
    "tm3_two_layers": (dict(tbs=21384, G=43200, Qm=6, Nl=2), 1),
    "tbs_not_bytes": (dict(tbs=6203, G=12000, Qm=2, Nl=1), 1),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_arithmetic_equals_plain_encode(name):
    """kernel_encode, the kernel's steps on its tables, gives the plain
    `sch.encode_tb`'s bits (the CPU runs the plain version)."""
    kw, B = CASES[name]
    cfg = sch.SchConfig(**kw)
    bits = _bits(B, cfg.tbs, len(name))
    ref = sch.encode_tb(torch.from_numpy(bits), cfg).numpy()
    np.testing.assert_array_equal(kernel_encode(bits, cfg.e_sizes, cfg.rv, cfg.ncb), ref)


@pytest.mark.parametrize("ncb", [0, 1500])
def test_kernel_arithmetic_per_row_rv(ncb):
    """rv_b per row (the dynamic block's path), int32 and int64 alike."""
    cfg = sch.SchConfig(tbs=6968, G=15000, Qm=6, Nl=1, ncb=ncb)
    bits = _bits(6, cfg.tbs, 3)
    rv_b = torch.tensor([0, 1, 2, 3, 2, 1])
    ref = sch.encode_tb(torch.from_numpy(bits), cfg, rv_b=rv_b).numpy()
    np.testing.assert_array_equal(kernel_encode(bits, cfg.e_sizes, 0, ncb, rv_b.numpy()), ref)


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_card_digests_are_the_jax_encode(name):
    """The digests the card tests hold the kernel to are those of the JAX
    package's encode_tb, and the plain version gives the same bits."""
    import jax.numpy as jnp

    from srslte_emane_tpu.phch import sch as j_sch

    kw, B, rv_b = JAX_CASES[name]
    bits = hashed_bits(B, kw["tbs"], len(name))
    want = np.asarray(j_sch.encode_tb(jnp.asarray(bits), j_sch.SchConfig(**kw),
                                      None if rv_b is None else jnp.asarray(rv_b)))
    assert digest(want) == JAX_DIGESTS[name]
    got = sch.encode_tb(torch.from_numpy(bits), sch.SchConfig(**kw),
                        None if rv_b is None else torch.tensor(rv_b))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("poly", [crc.LTE_CRC24A, crc.LTE_CRC24B], ids=["24A", "24B"])
@pytest.mark.parametrize("n", [0, 8, 24, 32, 40, 1000, 6120, 6144, 8192])
def test_word_crc_tables_equal_the_bit_serial_crc(poly, n):
    """crc_byte_table and crc_word_powers, as block_crc uses them, give
    crc.crc_host's remainder."""
    tab, pw = sec.crc_byte_table(poly[0]), sec.crc_word_powers(poly[0])
    bits = np.random.default_rng(n).integers(0, 2, n).astype(np.int64)
    want = int(sum(int(b) << (23 - i) for i, b in enumerate(crc.crc_host(bits, poly))))
    assert block_crc(bits, tab, pw) == want


def test_kernel_mulmod_equals_the_polynomial_product():
    """The kernel's carry-less mulmod against Horner's (`sec.mulmod`), and
    x^n by squaring against n multiplications by x."""
    rng = np.random.default_rng(5)
    for poly in (crc.LTE_CRC24A[0], crc.LTE_CRC24B[0]):
        tab = sec.crc_byte_table(poly)
        for a, b in rng.integers(0, 1 << 24, (200, 2)):
            assert kernel_mulmod(int(a), int(b), tab) == sec.mulmod(int(a), int(b), poly)
        r = 1
        for n in range(100):
            assert sec.xpow(n, poly) == r
            r = sec._mulx(r, poly)


@pytest.mark.parametrize("k", [40, 48, 56, 64, 512, 1056, 4480, 5696, 6144])
def test_rsc_tables_encode_like_the_host_encoder(k):
    """The RSC byte table's two passes around the scan, the tail bits and
    the interleaver stepped by differences give turbo_encode_host's
    d-streams (words of 8, 16, 24 and 32 bits at the end)."""
    u = np.random.default_rng(k).integers(0, 2, k).astype(np.int64)
    idx = cbsegm.cb_size_index(k)
    d0 = np.zeros(k + 4, np.int64)
    d0[:k] = u
    got = code_block_streams(d0, k, int(turbo.F1_TABLE[idx]), int(turbo.F2_TABLE[idx]), tables())
    for g, w in zip(got, turbo.turbo_encode_host(u)):
        np.testing.assert_array_equal(g, w)


def test_state_powers_and_tails():
    """A^p from single zero-input steps, A^7 = I (g0 is primitive), and
    tail_bits as turbo_encode_host's tail (state s = r0 + 2 r1 + 4 r2)."""
    ap = sec.state_powers().reshape(7, 8)
    np.testing.assert_array_equal(ap[0], np.arange(8))
    step = lambda s: sec._rsc_step(s, 0)[1]
    for s in range(8):
        assert [step(int(ap[p, s])) for p in range(6)] == list(ap[1:, s])
        assert step(int(ap[6, s])) == s
    for s in range(8):
        word = int(sec.tail_bits()[s])
        st = [s & 1, s >> 1 & 1, s >> 2 & 1]
        bits = []
        for _ in range(3):
            bits += [(st[1] + st[2]) & 1, (st[0] + st[2]) & 1]
            st = [0, st[0], st[1]]
        assert [word >> i & 1 for i in range(6)] == bits


@pytest.mark.parametrize("k,f", [(40, 0), (40, 8), (1056, 0), (5696, 0), (6144, 0), (3136, 56)])
@pytest.mark.parametrize("ncb", [0, 700, 3000])
def test_zmap_reproduces_the_rate_matchers(k, f, ncb):
    """zmap and its starts, read in the kernel's shared-memory layout, give
    rate_match_tx for rv 0-3 (E below and above V) and rate_match_tx_dyn."""
    rng = np.random.default_rng(k + f + ncb)
    d_flat = rng.integers(0, 2, (4, 3 * (k + 4))).astype(np.int8)
    smem = np.zeros((4, 3 * sec.STRIDE), np.int8)
    for s in range(3):
        smem[:, s * sec.STRIDE:s * sec.STRIDE + k + 4] = d_flat[:, s * (k + 4):(s + 1) * (k + 4)]
    z, starts = sec.zmap(k, f, ncb)
    V = len(z)
    for e in (k // 3, 3 * k + 100):
        for rv in range(4):
            want = rm_turbo.rate_match_tx(torch.from_numpy(d_flat), k, f, e, rv, ncb).numpy()
            got = smem[:, z.astype(np.int64)[(starts[rv] + np.arange(e)) % V]]
            np.testing.assert_array_equal(got, want)
        rv_b = torch.tensor([3, 0, 2, 1])
        want = rm_turbo.rate_match_tx_dyn(torch.from_numpy(d_flat), k, f, e, rv_b, ncb).numpy()
        got = np.stack([smem[i, z.astype(np.int64)[(starts[r] + np.arange(e)) % V]]
                        for i, r in enumerate(rv_b.tolist())])
        np.testing.assert_array_equal(got, want)


def test_plan_of_the_benchmark_cell():
    """TBS 51,024 into G = 90,000: 9 code blocks of K = 5,696, no fillers,
    3 of 9,996 bits and 6 of 10,002; the shares of the TB CRC, weighed, XOR
    to crc_host."""
    cfg = sch.SchConfig(tbs=51024, G=90000, Qm=6, Nl=1)
    rows, z = sec.plan(cfg.tbs, tuple(cfg.e_sizes), 0)
    assert rows.shape == (9, sec.P_LEN)
    assert (rows[:, sec.P_K] == 5696).all() and (rows[:, sec.P_F] == 0).all()
    assert list(rows[:, sec.P_E]) == [9996] * 3 + [10002] * 6 == cfg.e_sizes
    assert list(rows[:, sec.P_OUT]) == list(np.cumsum([0] + cfg.e_sizes[:-1]))
    assert (rows[:, sec.P_ZOFF] == 0).all()
    assert list(rows[:, sec.P_SRC]) == [5672 * r for r in range(9)]
    assert rows[:, sec.P_NTB].sum() == cfg.tbs and len(z) == rows[0, sec.P_V]
    bits = _bits(1, cfg.tbs, 9)[0].astype(np.int64)
    tab = sec.crc_byte_table(crc.LTE_CRC24A[0])
    shares = 0
    for p in rows:
        chunk = bits[p[sec.P_SRC]:p[sec.P_SRC] + p[sec.P_NTB]]
        shares ^= sec.mulmod(block_crc(chunk, tab, sec.crc_word_powers(crc.LTE_CRC24A[0])),
                             int(p[sec.P_TBPOW]), crc.LTE_CRC24A[0])
    want = crc.crc_host(bits, crc.LTE_CRC24A)
    assert shares == int(sum(int(b) << (23 - i) for i, b in enumerate(want)))


def test_source_constants_match_the_wrapper():
    """csrc/sch_encode.cu's block size, stride, table offsets and plan
    fields are the wrapper's."""
    src = (REPO / "srslte_emane_tpu_torch" / "csrc" / "sch_encode.cu").read_text()
    const = {m.group(1): int(m.group(2)) for m in re.finditer(r"\b(k\w+) = (\d+)", src)}
    assert const["kThreads"] == sec.THREADS and 32 * sec.THREADS >= const["kMaxK"] == 6144
    assert const["kStride"] == sec.STRIDE
    assert sec.THREADS <= sec.TAB_POW_B - sec.TAB_POW_A == sec.TAB_RSC - sec.TAB_POW_B
    for name in ("CRC_A", "CRC_B", "POW_A", "POW_B", "RSC", "APOW", "TAIL"):
        cu = "kTab" + "".join(w.capitalize() for w in name.split("_"))
        assert const[cu] == getattr(sec, "TAB_" + name), name
    fields = dict(K="kK", F="kF", SRC="kSrc", NDATA="kNdata", NTB="kNtb", TBPOW="kTbPow",
                  OUT="kOut", E="kE", V="kV", ZOFF="kZoff", START="kStart", F1="kF1", F2="kF2",
                  LEN="kPlanLen")
    for py, cu in fields.items():
        assert const[cu] == getattr(sec, "P_" + py), py
    assert sec.STRIDE >= 6144 + 24 and 3 * sec.STRIDE < 2 ** 15


def test_encode_tb_on_the_cpu_is_the_plain_version(monkeypatch):
    """A CPU tensor never reaches the kernel's wrapper."""
    def refuse(*a, **kw):
        raise AssertionError("the kernel's wrapper was called for a CPU tensor")

    monkeypatch.setattr(sec, "launch", refuse)
    cfg = sch.SchConfig(tbs=1544, G=2400, Qm=2, Nl=1)
    out = sch.encode_tb(torch.from_numpy(_bits(2, cfg.tbs, 1)), cfg)
    assert out.shape == (2, cfg.G) and out.dtype == torch.int8


def test_launch_rejects_a_cpu_tensor_before_building():
    bits = torch.zeros((2, 1544), dtype=torch.int8)
    with pytest.raises(ValueError):
        sec.launch(bits, (1200, 1200))
    with pytest.raises(ValueError):
        sec.launch(bits[0], (1200, 1200))


def test_plan_rejects_a_wrong_code_block_count():
    with pytest.raises(ValueError):
        sec.plan(51024, (45000, 45000), 0)


def test_graphs_count_the_encode_launches():
    """A graph's replays add the launches its capture counted."""
    assert ("srslte_emane_tpu_torch.ops.fec.sch_encode_cuda", "launches") in graphs.COUNTERS
    assert ("srslte_emane_tpu_torch.ops.fec.sch_encode_cuda", "launched_blocks") in graphs.COUNTERS
