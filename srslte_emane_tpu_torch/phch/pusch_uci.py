"""UCI on PUSCH: CQI / RI / HARQ-ACK multiplexing with the channel interleaver.

Twin of the reference's `phch/pusch_uci.py` (`lib/src/phy/phch/sch.c` UL-SCH
portion: Qm-specific channel interleaver with RI/ACK positions,
sch.c:600-918; beta offsets, sch.c:43-53).  Per 36.212 §5.2.2.8 (normal
CP): the interleaver matrix has C_mux = 12 columns (one per SC-FDMA data
symbol); RI symbols fill columns {1, 4, 7, 10} from the bottom row up;
HARQ-ACK symbols *puncture* columns {2, 3, 8, 9} likewise; CQI bits are
prepended to the data stream.

All placement is static per (G, Qm, q_ri, q_ack): the tables (whose source
labels mix data indices with the sentinels 10**6 and 2*10**6) stay numpy on
the host, and only the final int64 index tensors reach the device, for one
gather (TX, plus one scatter of the ACK bits) or one gather (RX).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.devices import table_cache

RI_COLS = (1, 4, 7, 10)
ACK_COLS = (2, 3, 8, 9)
C_MUX = 12


def n_uci_symbols(o_bits: int, beta: float, q_m: int, g_data: int) -> int:
    """Approximate Q' (number of UCI modulation symbols): spec 5.2.2.6-ish
    Q' = ceil(O * beta * G / (Qm * payload_bits)) simplified against the
    data rate; bounded to 4 columns' worth."""
    if o_bits == 0:
        return 0
    n_sym_total = g_data // q_m
    qp = int(np.ceil(o_bits * beta))
    return max(o_bits, min(qp, n_sym_total // 3))


@functools.lru_cache(maxsize=None)
def mux_tables(g_total: int, qm: int, q_ri: int, q_ack: int):
    """Index tables for the (R x 12 x Qm) interleaver matrix.

    Returns dict with int32 arrays:
      out_src: (g_total,) read order -> source: data-bit index i, or
               10^6+j for RI bit j, or 2*10^6+j for ACK bit j
      data_pos: inverse for RX (positions in the read stream of each
                data bit; ACK-punctured data bits map to -1)
    """
    r = g_total // (qm * C_MUX)
    assert r * qm * C_MUX == g_total
    # matrix of source labels, filled row-wise with data (incl. CQI prefix)
    RI, ACK = 10**6, 2 * 10**6
    mat = np.full((r, C_MUX, qm), -1, dtype=np.int64)
    # 1) RI placement: columns RI_COLS, bottom row up
    n_ri_sym = q_ri // qm
    for j in range(n_ri_sym):
        row = r - 1 - (j // 4)
        col = RI_COLS[j % 4]
        mat[row, col, :] = RI + j * qm + np.arange(qm)
    # 2) data fill row-wise skipping RI cells
    flat_order = [(i, c) for i in range(r) for c in range(C_MUX)]
    di = 0
    n_data = g_total - q_ri  # ACK punctures later
    for (i, c) in flat_order:
        if mat[i, c, 0] >= 0:
            continue
        if di >= n_data:
            break
        mat[i, c, :] = di + np.arange(qm)
        di += qm
    # 3) ACK puncture: columns ACK_COLS, bottom row up (overwrites data)
    n_ack_sym = q_ack // qm
    for j in range(n_ack_sym):
        row = r - 1 - (j // 4)
        col = ACK_COLS[j % 4]
        mat[row, col, :] = ACK + j * qm + np.arange(qm)
    # read column-wise
    out_src = mat.transpose(1, 0, 2).reshape(-1)
    # RX inverse: position in out stream per data bit index
    data_pos = np.full(n_data, -1, dtype=np.int64)
    for pos, src in enumerate(out_src):
        if 0 <= src < RI:
            data_pos[src] = pos
    ri_pos = np.array([np.flatnonzero(out_src == RI + j)[0] for j in range(q_ri)],
                      dtype=np.int64) if q_ri else np.zeros(0, np.int64)
    ack_pos = np.array([np.flatnonzero(out_src == ACK + j)[0] for j in range(q_ack)],
                       dtype=np.int64) if q_ack else np.zeros(0, np.int64)
    return dict(out_src=out_src.astype(np.int32),
                data_pos=data_pos.astype(np.int32),
                ri_pos=ri_pos.astype(np.int32),
                ack_pos=ack_pos.astype(np.int32),
                n_data=n_data)


@table_cache(32)
def _device_tables(g_total: int, qm: int, q_ri: int, q_ack: int, device: torch.device):
    """(TX gather into [data | RI], ACK positions, RX gather into
    [llrs | 0], RI positions) as int64 tensors on `device`."""
    t = mux_tables(g_total, qm, q_ri, q_ack)
    lbl = t["out_src"].astype(np.int64)
    n_data = t["n_data"]
    tx = np.where(lbl < 10**6, lbl, np.where(lbl < 2 * 10**6, n_data + (lbl - 10**6), 0))
    rx = np.where(t["data_pos"] >= 0, t["data_pos"], g_total)
    f = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(device)
    return f(tx), f(t["ack_pos"]), f(rx), f(t["ri_pos"])


def multiplex(data_bits: torch.Tensor, ri_bits_coded, ack_bits_coded, qm: int) -> torch.Tensor:
    """TX: (B, n_data) data (+CQI prefix) + coded RI/ACK -> (B, G) stream."""
    q_ri = ri_bits_coded.shape[-1] if ri_bits_coded is not None else 0
    q_ack = ack_bits_coded.shape[-1] if ack_bits_coded is not None else 0
    g_total = data_bits.shape[-1] + q_ri
    tx, ack_pos, _, _ = _device_tables(g_total, qm, q_ri, q_ack, data_bits.device)
    src = torch.cat([data_bits, ri_bits_coded.to(data_bits.dtype)], dim=-1) if q_ri else data_bits
    out = src[..., tx]
    if q_ack:
        out[..., ack_pos] = ack_bits_coded.to(out.dtype)  # ACK punctures data
    return out


def demultiplex(llrs: torch.Tensor, qm: int, q_ri: int, q_ack: int):
    """RX: (B, G) LLRs -> (data_llrs (B, n_data), ri_llrs, ack_llrs).
    ACK-punctured data positions read 0 (erasure)."""
    _, ack_pos, rx, ri_pos = _device_tables(llrs.shape[-1], qm, q_ri, q_ack, llrs.device)
    padded = torch.cat([llrs, llrs.new_zeros(llrs.shape[:-1] + (1,))], dim=-1)
    return (padded[..., rx], llrs[..., ri_pos] if q_ri else None,
            llrs[..., ack_pos] if q_ack else None)


def encode_ack_ri(bits: torch.Tensor, q_sym: int, qm: int) -> torch.Tensor:
    """1-2 bit ACK/RI encoding: repetition to q_sym*qm coded bits
    (36.212 Table 5.2.2.6-A/-B simplified to the repetition forms)."""
    n = q_sym * qm
    reps = -(-n // bits.shape[-1])
    return bits.to(torch.int8).repeat(1, reps)[..., :n]


def decode_ack_ri(llrs: torch.Tensor, n_bits: int, qm: int) -> torch.Tensor:
    """Majority/soft combine of the repetition code."""
    B, n = llrs.shape
    usable = (n // n_bits) * n_bits
    comb = llrs[..., :usable].reshape(B, -1, n_bits).sum(dim=-2)
    return (comb < 0).to(torch.int8)
