"""Secondary benchmarks of the port: cell search, 2x2 TM3, 20 MHz PUSCH, 2-carrier CA.

Twin of the JAX repository's `scripts/bench_extra.py`, with its cells and
draws (one default_rng(0) stream for payloads and channels, in the
source's order; each jax.random key becomes a torch.Generator with the
same seed):
  - cell search over `batch` captures (6 PRB, cell 301, sf 0, 5 dB): every
    capture finds cell 301;
  - the 2x2 TM3 decode (100 PRB, cell_id 7, 2 ports, 64QAM at rate 0.5 per
    codeword, a flat channel N(0, 1) + 3.5 I per row at 30 dB, llr_bits=16).
    The channel is drawn as the source draws it, so a row may fail: every
    codeword whose CRC passes must be bit-exact, and when a row fails the
    whole decode must equal, bits and flags, the decode with the MAP
    kernel's plain version in its place (the failure is the channel's, not
    the kernel's);
  - the 20 MHz PUSCH decode (96 PRB, 16QAM at rate 0.5, 14 dB, llr_bits=16):
    every CRC passes;
  - two 20 MHz component carriers of the bench link, encode and decode in
    one step (f32 decoder): every CRC passes.

Usage: python -m srslte_emane_tpu_torch.scripts.bench_extra [batch] [iters] [--cpu]
(`iters`, 20 by default, is the source's fixed count of timed calls.)

Prints one JSON line: {cell_search, mimo_tm3_decode, pusch_decode,
ca_2cc_link} in rows (captures, subframes or carrier-subframes) per second,
plus "backend" and "device"; each rate is `iters` calls on the host clock,
bracketed by synchronises, after one untimed call.  The source jits each
timed function; here each is a `runtime/graphs.jit` step (on the card one
CUDA graph, captured at its first call and replayed at every call), the CA
step through make_ca_link_step's own.  The TM3 decode's first call and its
comparison with the plain MAP run eagerly, and every graphed call must equal
that first call.
"""

from __future__ import annotations

import contextlib
import json
import sys

import numpy as np
import torch

from ..models import pdsch_link
from ..ops import channel, cplx, ofdm
from ..phch import grid as grid_mod, pdsch, pusch, sch, sync
from ..runtime import graphs
from . import _timing

TM3_RNTI = 0x46


def host_loop_decode(*args, **kw):
    """`turbodecoder.turbo_decode_host`, the host-driven loop, with
    `turbo_decode_device`'s arguments and results (n_iter a 0-d tensor,
    the MAP passes and rows a (2,) one; they are 0, since the host loop adds
    its own to `turbodecoder.map_passes` and `map_rows`): it can stand in
    for the device loop."""
    from ..ops.fec import turbodecoder

    bits, ok, n_iter = turbodecoder.turbo_decode_host(*args, **kw)
    zero = torch.zeros(2, dtype=torch.int32, device=bits.device)
    return bits, ok, zero[0] + n_iter, zero


@contextlib.contextmanager
def plain_map():
    """The turbo decoder with the MAP kernel's plain version in its place
    (the same function, bit for bit, on the same device): the host-driven
    loop (`host_loop_decode` in `turbodecoder.turbo_decode_device`'s
    place), whose passes go through the kernel's wrapper, with that wrapper
    replaced by `map_decode_ref`."""
    from ..ops.fec import turbodecoder, turbodecoder_cuda as tdc

    saved = turbodecoder.turbo_decode_device, tdc.map_decode_cuda
    turbodecoder.turbo_decode_device, tdc.map_decode_cuda = host_loop_decode, tdc.map_decode_ref
    try:
        yield
    finally:
        turbodecoder.turbo_decode_device, tdc.map_decode_cuda = saved


def main(argv=None) -> int:
    ap = _timing.parser(__doc__)
    ap.add_argument("batch", type=int, nargs="?", default=32)
    ap.add_argument("iters", type=int, nargs="?", default=20)
    args = ap.parse_args(argv)
    dev = _timing.device(args.cpu, "bench_extra")
    batch, iters = args.batch, args.iters
    results = {}

    def timed(name, fn, check):
        out = fn()
        _timing.require(check(out), f"{name}: the first call's gate failed")
        r = _timing.median_rate(fn, 1, iters, 1, dev, check=check)
        results[name] = 1.0 / r.median
        return results[name]

    def gen(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    rng = np.random.default_rng(0)

    # --- cell search over batched captures ---
    c6 = grid_mod.CellConfig(n_prb=6, cell_id=301)
    gg = sync.put_pss_sss(cplx.zeros((batch, 14, 72), device=dev), c6, 0)
    gg = pdsch.put_crs(gg, c6, 0)
    tt = channel.awgn(gen(1), ofdm.modulate(gg, 6), 5.0)
    cs = graphs.jit(sync.cell_search, dev)
    dt = timed("cell_search", lambda: cs(tt), lambda o: bool((o["cell_id"] == 301).all()))
    print(f"# cell search: {batch / dt:.0f} captures/s", file=sys.stderr)

    # --- 2x2 MIMO TM3 20 MHz ---
    cell2 = grid_mod.CellConfig(n_prb=100, cell_id=7, n_ports=2, cfi=1)
    prb_mask = (1,) * 100
    n_re = grid_mod.nof_re(cell2, 1, prb_mask)
    qm = 6
    cfgs = [sch.SchConfig(tbs=(int(n_re * qm * 0.5) - 24) // 8 * 8, G=n_re * qm, Qm=qm, Nl=1)
            for _ in range(2)]
    tbs_list = [torch.from_numpy(rng.integers(0, 2, (batch, c.tbs), dtype=np.int8)).to(dev)
                for c in cfgs]
    tx2 = ofdm.modulate(pdsch.encode_tm(tbs_list, cfgs, cell2, 1, TM3_RNTI, prb_mask, "tm3"), 100)
    h = (rng.normal(size=(batch, 2, 2)) + 1j * rng.normal(size=(batch, 2, 2))).astype(np.complex64)
    h = h + 3.5 * np.eye(2)[None]
    rx2 = channel.mimo_flat(gen(2), tx2, cplx.from_numpy(h, dev), 30.0)
    rg2 = ofdm.demodulate(rx2, 100)
    tm3 = lambda r: pdsch.decode_tm(r, cfgs, cell2, 1, TM3_RNTI, prb_mask, "tm3",
                                    llr_bits=16)[:2]
    dec2 = lambda: tm3(rg2)
    first = dec2()
    outs, oks = first
    _timing.require(all(torch.equal(o[ok], t[ok]) for o, ok, t in zip(outs, oks, tbs_list)),
                    "TM3: a codeword passed its CRC with wrong bits")
    failed = (~torch.stack(oks).all(0)).nonzero().flatten().tolist()
    if failed and dev.type == "cuda":
        with plain_map():
            p_outs, p_oks = dec2()
        _timing.require(all(torch.equal(a, b) for a, b in zip(outs + oks, p_outs + p_oks)),
                        f"TM3: rows {failed} fail, and the decode differs from the plain MAP's")
    same = lambda o: all(torch.equal(a, b) for a, b in zip(o[0] + o[1], outs + oks))
    tm3_step = graphs.jit(tm3, dev)
    dt = timed("mimo_tm3_decode", lambda: tm3_step(rg2), same)
    cond = np.linalg.cond(h)
    print(f"# MIMO 2x2 TM3 64QAM: {batch / dt:.0f} sf/s "
          f"({batch / dt * sum(c.tbs for c in cfgs) / 1e6:.0f} Mb/s); rows failing {failed} "
          f"(channel condition {[round(float(cond[i]), 1) for i in failed]}, batch worst "
          f"{float(cond.max()):.1f}), each as with the plain MAP", file=sys.stderr)

    # --- 20 MHz PUSCH uplink ---
    cell = grid_mod.CellConfig(n_prb=100, cell_id=1)
    l_prb, qm = 96, 4  # 2^5*3 valid transform size
    G = 12 * l_prb * 12 * qm
    tbs = (int(G * 0.5) - 24) // 8 * 8
    cfg = sch.SchConfig(tbs=tbs, G=G, Qm=qm, Nl=1)
    payload = torch.from_numpy(rng.integers(0, 2, (batch, tbs), dtype=np.int8)).to(dev)
    t = ofdm.modulate(pusch.encode(payload, cfg, cell, 2, 0x5A, 0, l_prb), 100)
    rg = ofdm.demodulate(channel.awgn(gen(0), t, 14.0), 100)
    ul_step = graphs.jit(lambda r: pusch.decode(r, cfg, cell, 2, 0x5A, 0, l_prb, llr_bits=16)[:2],
                         dev)
    dt = timed("pusch_decode", lambda: ul_step(rg),
               lambda o: bool(o[1].all()) and torch.equal(o[0], payload))
    print(f"# UL 20MHz 16QAM: {batch / dt:.0f} sf/s ({batch / dt * tbs / 1e6:.0f} Mb/s)",
          file=sys.stderr)

    # --- carrier aggregation: 2 x 20 MHz CCs in one step ---
    ca_cfg = pdsch_link.LinkConfig(cell=grid_mod.CellConfig(n_prb=100, cell_id=1, cfi=1),
                                   qm=6, code_rate=0.55, snr_db=20.0, sf_idx=1)
    ca_step = pdsch_link.make_ca_link_step(ca_cfg, n_cc=2)
    ca_payloads = torch.from_numpy(
        rng.integers(0, 2, size=(2, batch, ca_cfg.tbs), dtype=np.int8)).to(dev)
    ca_gen = gen(3)
    dt = timed("ca_2cc_link", lambda: ca_step(ca_payloads, ca_gen),
               lambda o: bool(o[1].all()) and torch.equal(o[0], ca_payloads))
    agg = 2 * batch / dt
    print(f"# CA 2CC 20MHz e2e encode+decode: {agg:.0f} carrier-sf/s "
          f"({agg * ca_cfg.tbs / 1e6:.0f} Mb/s aggregate)", file=sys.stderr)
    n_graphs = sum(len(s.graphs) for s in (cs, tm3_step, ul_step, ca_step))
    print(f"# graphs captured: {n_graphs} ({graphs.STATS['build_s']:.2f} s to build)",
          file=sys.stderr)

    print(json.dumps({**{k: round(batch / v, 1) for k, v in results.items()},
                      **_timing.stamp(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
