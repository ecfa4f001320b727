"""DL-SCH / UL-SCH transport-block codec.

Twin of the reference's `phch/sch.py` (sch.c:291 encode_tb, sch.c:429
decode_tb): TB CRC24A -> segmentation -> per-CB CRC24B -> turbo encode ->
rate match; decode de-rate-matches into per-CB HARQ w-buffers and runs one
batched turbo decode per code-block size K.  Code blocks ride the batch axis.

Per-CB rate-match output sizes E_r (36.212 §5.1.4.1.2):
  E_r = Nl*Qm*floor(G'/C) for r <= C - (G' mod C) - 1 else Nl*Qm*ceil(G'/C),
  G' = G/(Nl*Qm).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops.fec import cbsegm, crc, rm_turbo, turbo, turbodecoder


@dataclasses.dataclass(frozen=True)
class SchConfig:
    """Static shape parameters of one TB configuration."""
    tbs: int  # transport block size (bits, no CRC)
    G: int  # total rate-matched bits for the codeword
    Qm: int  # modulation order (bits/symbol)
    Nl: int  # layers this codeword maps to
    rv: int = 0
    ncb: int = 0  # soft-buffer limit (0 = unlimited, 3*Kp)

    @functools.cached_property
    def segm(self) -> cbsegm.CbSegm:
        return cbsegm.cbsegm(self.tbs)

    @functools.cached_property
    def e_sizes(self) -> list:
        s = self.segm
        C = s.C
        gp = self.G // (self.Nl * self.Qm)
        gamma = gp % C
        e = []
        for r in range(C):
            if r <= C - gamma - 1:
                e.append(self.Nl * self.Qm * (gp // C))
            else:
                e.append(self.Nl * self.Qm * (-(-gp // C)))
        assert sum(e) == self.G
        return e


def _segment_bits(tb_bits: torch.Tensor, cfg: SchConfig):
    """Segmentation of (B, tbs) payload bits into per-CB bit tensors with
    CRCs and (zero) fillers.  Returns the list of (B, K_r) int8 tensors."""
    s = cfg.segm
    b = tb_bits.to(torch.int8)
    with_tb_crc = crc.crc_attach(b, crc.LTE_CRC24A)  # (B, tbs+24)
    filler = b.new_zeros((b.shape[0], s.F))
    if s.C == 1:
        return [torch.cat([filler, with_tb_crc], dim=1)]
    # split into C chunks: first chunk shorter by F
    sizes = [kr - cbsegm.CB_CRC_LEN for kr in s.cb_sizes]
    sizes[0] -= s.F
    out = []
    off = 0
    for r, sz in enumerate(sizes):
        chunk = with_tb_crc[:, off : off + sz]
        off += sz
        if r == 0 and s.F:
            chunk = torch.cat([filler, chunk], dim=1)
        out.append(crc.crc_attach(chunk, crc.LTE_CRC24B))
    assert off == with_tb_crc.shape[1]
    return out


def _groups(cfg: SchConfig):
    """Group code blocks by identical (K, F, E): one batched call each."""
    s = cfg.segm
    es = cfg.e_sizes
    groups = {}
    for r in range(s.C):
        key = (s.cb_sizes[r], s.F if r == 0 else 0, es[r])
        groups.setdefault(key, []).append(r)
    return groups


def encode_tb(tb_bits: torch.Tensor, cfg: SchConfig, rv_b=None) -> torch.Tensor:
    """(B, tbs) payload bits -> (B, G) rate-matched codeword bits (int8).

    rv_b: optional (B,) int tensor, one redundancy version per row in place
    of cfg.rv (the in-block HARQ retransmission path)."""
    cbs = _segment_bits(tb_bits, cfg)
    B = cbs[0].shape[0]
    pieces = [None] * cfg.segm.C
    for (k, f, e), rs in _groups(cfg).items():
        stacked = torch.cat([cbs[r] for r in rs], dim=0)  # (n*B, K)
        d_flat = torch.cat(turbo.turbo_encode(stacked), dim=1)
        if rv_b is None:
            tx = rm_turbo.rate_match_tx(d_flat, k, f, e, cfg.rv, cfg.ncb)
        else:
            tx = rm_turbo.rate_match_tx_dyn(d_flat, k, f, e, rv_b.repeat(len(rs)), cfg.ncb)
        for i, r in enumerate(rs):
            pieces[r] = tx[i * B : (i + 1) * B]
    return torch.cat(pieces, dim=1)


def init_softbuffer(batch: int, cfg: SchConfig, dtype=torch.float32, device=None):
    """Per-CB HARQ w-buffers (list over CBs): the softbuffer.c equivalent."""
    return [torch.zeros((batch, rm_turbo.wbuf_size(kr)), dtype=dtype, device=device)
            for kr in cfg.segm.cb_sizes]


def decode_tb(llrs: torch.Tensor, cfg: SchConfig, softbuf=None, max_iter: int = 8,
              use_kernel: bool | None = None, llr_bits: int = 32, rv_b=None):
    """(B, G) codeword LLRs (positive = bit 0) -> (tb_bits (B, tbs), ok (B,),
    softbuf', n_iter).

    Soft-combines into `softbuf` (HARQ IR) if given.  ok requires every CB CRC
    and the TB CRC24A to pass (sch.c decode_tb semantics).  llr_bits <= 16
    holds the LLRs and soft buffers in bf16, as the reference does; each
    position receives at most one LLR per transmission at the bench rate, so
    the bf16 sums are exact there; HARQ retransmission sums round to bf16
    in the soft buffers.  rv_b: optional (B,) int tensor, one redundancy
    version per row in place of cfg.rv.
    """
    s = cfg.segm
    B = llrs.shape[0]
    es = cfg.e_sizes
    narrow = llr_bits <= 16
    if narrow:
        llrs = llrs.to(torch.bfloat16)
    if softbuf is None:
        softbuf = init_softbuffer(B, cfg, torch.bfloat16 if narrow else torch.float32,
                                  llrs.device)
    offs = np.concatenate([[0], np.cumsum(es)])
    cb_bits = [None] * s.C
    cb_ok = [None] * s.C
    new_soft = [None] * s.C
    total_iters = 0
    check = crc.LTE_CRC24B if s.C > 1 else crc.LTE_CRC24A
    # de-rate-match per (K, F, E) group, but ONE turbo decode per K: fewer,
    # wider decoder calls (F/E only shape the tables, never the trellis)
    by_k = {}
    for (kr, f, e), rs in _groups(cfg).items():
        e_llr = torch.cat([llrs[:, offs[r] : offs[r + 1]] for r in rs], dim=0)
        wbuf = torch.cat([softbuf[r] for r in rs], dim=0)
        if rv_b is None:
            wbuf = rm_turbo.rate_unmatch_rx(e_llr, wbuf, kr, f, e, cfg.rv, cfg.ncb)
        else:
            wbuf = rm_turbo.rate_unmatch_rx_dyn(e_llr, wbuf, kr, f, e, rv_b.repeat(len(rs)),
                                                cfg.ncb)
        d3 = rm_turbo.wbuf_to_d_llrs(wbuf, kr, f)
        for i, r in enumerate(rs):
            new_soft[r] = wbuf[i * B : (i + 1) * B]
        by_k.setdefault(kr, []).append((rs, d3))
    for kr, parts in by_k.items():
        rs_all = [r for rs, _ in parts for r in rs]
        l0, l1, l2 = (torch.cat([d3[j] for _, d3 in parts], dim=0)
                      for j in range(3))
        nB = len(rs_all) * B
        bits, ok, it = turbodecoder.turbo_decode(
            l0, l1, l2, torch.ones((nB,), dtype=torch.bool, device=llrs.device),
            kr, max_iter, check, use_kernel=use_kernel, llr_bits=llr_bits)
        total_iters += it
        for i, r in enumerate(rs_all):
            cb_bits[r] = bits[i * B : (i + 1) * B]
            cb_ok[r] = ok[i * B : (i + 1) * B]
    # reassemble payload: strip fillers + CB CRCs, then strip/verify TB CRC
    if s.C == 1:
        tb_with_crc = cb_bits[0][:, s.F :]
    else:
        tb_with_crc = torch.cat(
            [cb_bits[r][:, (s.F if r == 0 else 0) : s.cb_sizes[r] - cbsegm.CB_CRC_LEN]
             for r in range(s.C)], dim=1)
    payload = tb_with_crc[:, : cfg.tbs]
    all_ok = crc.crc_ok(tb_with_crc, crc.LTE_CRC24A)
    for ok in cb_ok:
        all_ok = all_ok & ok
    return payload, all_ok, new_soft, total_iters
