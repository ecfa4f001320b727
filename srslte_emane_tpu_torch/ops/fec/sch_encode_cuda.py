"""The DL-SCH / UL-SCH encode as one hand-written CUDA pass: wrapper, host
tables, launch count and the count of encoded code blocks.

`launch` is the CUDA side of `sch.encode_tb`: the TB CRC24A,
segmentation with fillers and CB CRC24Bs, the rate-1/3 turbo encode (both
constituents, QPP interleaver, tails) and rate matching into the (B, G)
int8 codeword, in `csrc/sch_encode.cu`.  Each code block stays in shared
memory from payload bits to codeword bits.  A TB of one code block is one
launch (`sch_encode_kernel`); one of C > 1 code blocks is two, a first one
(`sch_tb_crc_kernel`) that leaves each code block's share of the TB CRC24A in
a scratch tensor, since the last block needs the whole TB's CRC.  The
plain version is the PyTorch code of `sch.encode_tb` (crc.py, turbo.py,
rm_turbo.py), which the CPU runs.

The kernel reads host tables, built here and uploaded once per device
through bounded `table_cache`s (a CUDA graph reads them by address):
  * for both CRCs the byte-wise table T[v] = v(x) x^24 mod g and the
    powers x^(32 (THREADS - 1 - t)) mod g by which thread t weighs its word
    (`crc_byte_table`, `crc_word_powers`);
  * the RSC encoder on bytes, state x input byte -> parity byte and next
    state (`rsc_byte_table`), the zero-input transitions A^p, p < 7
    (`state_powers`), the six tail bits of each final state (`tail_bits`);
  * per configuration, a row of geometry per code block (`plan`) and the
    rate matcher's source table in the kernel's shared-memory layout
    (`zmap`): `rm_turbo._cyclic_tables`' z_src, whose output bit j of
    redundancy version rv is z[(starts[rv] + j) mod V].

`launches` counts the kernel launches and `launched_blocks` the code blocks
they encode (plain counts; callers reset them).  Every block also adds one
to a count on its device (an atomicAdd, so a graph's replays count too):
`read_encode_blocks` / `reset_encode_blocks`; it equals `launched_blocks`
when every launched block ran on the card.
The kernel library is built by `turbodecoder_cuda.build` with nvcc at
first use, into build/sch_encode-<hash of sources and flags>/.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import cbsegm, crc, rm_turbo, turbo, turbodecoder_cuda
from ...utils.devices import table_cache

SOURCE = turbodecoder_cuda.CSRC / "sch_encode.cu"

THREADS = 256  # a block's threads: one 32-bit word each of a code block (K <= 6,144)
STRIDE = 6176  # bytes between the d-streams in a block's shared memory: 32 * ceil(6,148 / 32)

# the layout of the small tables (`small_tables`), as csrc/sch_encode.cu reads it (256
# entries for each power table, of which THREADS are used)
TAB_CRC_A, TAB_CRC_B, TAB_POW_A, TAB_POW_B = 0, 256, 512, 768
TAB_RSC, TAB_APOW, TAB_TAIL, TAB_LEN = 1024, 3072, 3128, 3136

# the fields of a code block's row of `plan`
(P_K, P_F, P_SRC, P_NDATA, P_NTB, P_TBPOW, P_OUT, P_E, P_V, P_ZOFF,
 P_START, P_F1, P_F2) = 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 14, 15
P_LEN = 16

# Kernel launches made by `launch`, and the code blocks they encode, B x C a
# launch (plain counts; callers reset them).
launches = 0
launched_blocks = 0
# Code blocks encoded: folded in from each device's count by `read_encode_blocks`.
encode_blocks = 0
_device_counts = {}


def read_encode_blocks() -> int:
    """Code blocks the kernel encoded, with each device's count folded in
    (one read per device, which zeroes its count)."""
    global encode_blocks
    for acc in _device_counts.values():
        encode_blocks += int(acc.item())
        acc.zero_()
    return encode_blocks


def reset_encode_blocks() -> None:
    """The count of encoded code blocks, and every device's, to 0."""
    global encode_blocks
    encode_blocks = 0
    for acc in _device_counts.values():
        acc.zero_()


def _counter(dev: torch.device) -> torch.Tensor:
    acc = _device_counts.get(dev)
    if acc is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("sch_encode: the block count is made by an eager call, "
                               "not while a graph captures")
        acc = _device_counts[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
    return acc


# ---------------- host tables ----------------

def _mulx(a: int, poly: int) -> int:
    """a(x) * x mod g, a of degree < 24; poly = g with its x^24 term."""
    a <<= 1
    return a ^ poly if a >> 24 else a


@functools.lru_cache(maxsize=None)
def crc_byte_table(poly: int) -> np.ndarray:
    """(256,) int64: T[v] = v(x) x^24 mod g, the byte v MSB-first (its
    first bit in time the coefficient of x^7)."""
    out = np.zeros(256, np.int64)
    for v in range(256):
        r = v << 16  # v(x) x^16, then 8 more multiplications by x
        for _ in range(8):
            r = _mulx(r, poly)
        out[v] = r
    return out


def mulmod(a: int, b: int, poly: int) -> int:
    """a(x) b(x) mod g for 24-bit a, b (the kernel's `mulmod`)."""
    r = 0
    for i in range(23, -1, -1):  # Horner over b's bits
        r = _mulx(r, poly)
        if b >> i & 1:
            r ^= a
    return r


def xpow(n: int, poly: int) -> int:
    """x^n mod g, by squaring."""
    r, base = 1, _mulx(1, poly)
    while n:
        if n & 1:
            r = mulmod(r, base, poly)
        base = mulmod(base, base, poly)
        n >>= 1
    return r


@functools.lru_cache(maxsize=None)
def crc_word_powers(poly: int) -> np.ndarray:
    """(THREADS,) int64: x^(32 (THREADS - 1 - t)) mod g, the weight of
    thread t's word when a block's words end with the message."""
    return np.array([xpow(32 * (THREADS - 1 - t), poly) for t in range(THREADS)], np.int64)


def _rsc_step(s: int, u: int) -> tuple[int, int]:
    """One RSC step from state s = r0 + 2 r1 + 4 r2 on input u:
    (parity z, next state), as turbo.turbo_encode_host steps."""
    r0, r1, r2 = s & 1, s >> 1 & 1, s >> 2 & 1
    return u ^ r0 ^ r1, (u ^ r1 ^ r2) | r0 << 1 | r1 << 2


@functools.lru_cache(maxsize=None)
def rsc_byte_table() -> np.ndarray:
    """(8 * 256,) int64: entry s * 256 + v = parity byte | next state << 8
    after the 8 input bits of byte v (MSB first) from state s; the parity
    byte MSB first too."""
    out = np.zeros(8 * 256, np.int64)
    for s0 in range(8):
        for v in range(256):
            s, z = s0, 0
            for i in range(7, -1, -1):
                p, s = _rsc_step(s, v >> i & 1)
                z = z << 1 | p
            out[s0 * 256 + v] = z | s << 8
    return out


@functools.lru_cache(maxsize=None)
def state_powers() -> np.ndarray:
    """(7 * 8,) int64: entry p * 8 + s = A^p s, the state after p zero
    inputs from s (g0 = 1 + D^2 + D^3 is primitive: A^7 = I)."""
    out = np.zeros(7 * 8, np.int64)
    for s0 in range(8):
        s = s0
        for p in range(7):
            out[p * 8 + s0] = s
            s = _rsc_step(s, 0)[1]
    return out


@functools.lru_cache(maxsize=None)
def tail_bits() -> np.ndarray:
    """(8,) int64: bit k of entry s is tail output k (x_K, z_K, x_K+1,
    z_K+1, x_K+2, z_K+2) of an encoder whose final state is s."""
    out = np.zeros(8, np.int64)
    for s0 in range(8):
        s, word = s0, 0
        for k in range(3):
            r0, r1, r2 = s & 1, s >> 1 & 1, s >> 2 & 1
            word |= (r1 ^ r2) << 2 * k | (r0 ^ r2) << 2 * k + 1
            s = r0 << 1 | r1 << 2
        out[s0] = word
    return out


@functools.lru_cache(maxsize=None)
def small_tables() -> np.ndarray:
    """(TAB_LEN,) int32: every table the kernel reads that no configuration
    changes, at the TAB_* offsets."""
    out = np.zeros(TAB_LEN, np.int64)
    out[TAB_CRC_A:TAB_CRC_A + 256] = crc_byte_table(crc.LTE_CRC24A[0])
    out[TAB_CRC_B:TAB_CRC_B + 256] = crc_byte_table(crc.LTE_CRC24B[0])
    out[TAB_POW_A:TAB_POW_A + THREADS] = crc_word_powers(crc.LTE_CRC24A[0])
    out[TAB_POW_B:TAB_POW_B + THREADS] = crc_word_powers(crc.LTE_CRC24B[0])
    out[TAB_RSC:TAB_APOW] = rsc_byte_table()
    out[TAB_APOW:TAB_TAIL] = state_powers()
    out[TAB_TAIL:TAB_LEN] = tail_bits()
    return out.astype(np.int32)


@functools.lru_cache(maxsize=None)
def zmap(k: int, f: int, ncb: int) -> tuple[np.ndarray, np.ndarray]:
    """(z (V,) int16, starts (4,)): the bit-selection stream of
    `rm_turbo._cyclic_tables` as offsets into the kernel's shared memory
    (d-stream s at s * STRIDE), and each redundancy version's start."""
    z_src, starts, _ = rm_turbo._cyclic_tables(k, f, ncb)
    stream, pos = np.divmod(z_src.astype(np.int64), k + 4)
    return (stream * STRIDE + pos).astype(np.int16), starts


@functools.lru_cache(maxsize=None)
def plan(tbs: int, e_sizes: tuple, ncb: int) -> tuple[np.ndarray, np.ndarray]:
    """(rows (C, P_LEN) int32, z (sum of V,) int16): one row of geometry per
    code block r (its K and fillers F; the offset and count of its data
    bits in the TB + CRC24A stream, NDATA, and of its payload bits, NTB;
    x^(tbs - SRC - NTB) mod g_A, by which its share of the TB CRC is
    weighed; its offset and size E in the codeword; V, its table's offset
    in z, the four starts; the QPP's f1, f2), and the tables of its distinct
    (K, F), one after another."""
    s = cbsegm.cbsegm(tbs)
    if s.C != len(e_sizes):
        raise ValueError(f"TBS {tbs} has {s.C} code blocks, not {len(e_sizes)}")
    rows = np.zeros((s.C, P_LEN), np.int64)
    tables, offsets = [], {}
    src = out = 0
    for r, k in enumerate(s.cb_sizes):
        f = s.F if r == 0 else 0
        ndata = k - f - (cbsegm.CB_CRC_LEN if s.C > 1 else 0)
        ntb = max(0, min(tbs - src, ndata))
        z, starts = zmap(k, f, ncb)
        if (k, f) not in offsets:
            offsets[(k, f)] = sum(len(t) for t in tables)
            tables.append(z)
        idx = cbsegm.cb_size_index(k)
        tb_pow = xpow(tbs - src - ntb, crc.LTE_CRC24A[0])
        rows[r, [P_K, P_F, P_SRC, P_NDATA, P_NTB, P_TBPOW, P_OUT, P_E, P_V, P_ZOFF]] = (
            k, f, src, ndata, ntb, tb_pow, out, e_sizes[r], len(z), offsets[(k, f)])
        rows[r, P_START:P_START + 4] = starts
        rows[r, P_F1], rows[r, P_F2] = turbo.F1_TABLE[idx], turbo.F2_TABLE[idx]
        src += ndata
        out += e_sizes[r]
    assert src == tbs + cbsegm.TB_CRC_LEN
    return rows.astype(np.int32), np.concatenate(tables)


@table_cache(8)
def _device_small(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(small_tables()).to(device)


@table_cache(128)
def _device_plan(tbs: int, e_sizes: tuple, ncb: int, device: torch.device):
    rows, z = plan(tbs, e_sizes, ncb)
    return torch.from_numpy(rows).to(device), torch.from_numpy(z).to(device)


# ---------------- the kernel ----------------

def _lib():
    return turbodecoder_cuda.build(SOURCE).lib


def launch(bits: torch.Tensor, e_sizes: tuple, rv: int = 0, ncb: int = 0,
           rv_b: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel alone, on PyTorch's current stream.  bits: (B, tbs) int8
    0/1 payload bits, contiguous on a CUDA device; e_sizes: the code
    blocks' rate-matched sizes (`SchConfig.e_sizes`); rv: the redundancy
    version, 0-3, or rv_b: one per row, a (B,) int32 or int64 tensor on
    the same device; ncb: the soft-buffer limit (0: none).  Returns the
    (B, sum(e_sizes)) int8 codeword bits: one launch for one code block, two
    for more.  ValueError for what the kernel does not take: another
    device, shape or layout, a TBS of no code block, an rv outside 0-3;
    TypeError for another type."""
    global launches, launched_blocks
    if bits.dim() != 2:
        raise ValueError(f"bits has shape {tuple(bits.shape)}, expected (B, tbs)")
    B, tbs = bits.shape
    dev = bits.device
    turbodecoder_cuda._require("bits", bits, dev, (torch.int8,), (B, tbs))
    e_sizes = tuple(int(e) for e in e_sizes)
    if tbs < 1:
        raise ValueError("a TBS of 0 bits has no code block to encode")
    if rv_b is None:
        if rv not in (0, 1, 2, 3):
            raise ValueError(f"rv must be 0-3, not {rv}")
    else:
        turbodecoder_cuda._require("rv_b", rv_b, dev, (torch.int32, torch.int64), (B,))
    rows, z = _device_plan(tbs, e_sizes, ncb, dev)
    C = rows.shape[0]
    G = sum(e_sizes)
    out = torch.empty((B, G), dtype=torch.int8, device=dev)
    if B == 0:
        return out
    if B * C >= 2 ** 31:
        raise ValueError(f"{B} x {C} code blocks are more than one grid holds")
    partial = torch.empty((B * C if C > 1 else 1,), dtype=torch.int32, device=dev)
    rv_bytes = 0 if rv_b is None else rv_b.element_size()
    err = _lib().sch_encode_launch(
        bits.data_ptr(), out.data_ptr(), B, tbs, G, C, rows.data_ptr(), z.data_ptr(),
        _device_small(dev).data_ptr(), partial.data_ptr(), rv,
        None if rv_b is None else rv_b.data_ptr(), rv_bytes, _counter(dev).data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sch_encode kernel launch failed: cudaError_t {err}")
    launches += 2 if C > 1 else 1
    launched_blocks += B * C
    return out
