"""Stage-ablation profile of the dynamic waveform block.

Twin of the JAX repository's `scripts/profile_dynblock.py`: its block
(`bench_cfg`: 100 PRB, cell_id 1, cfi 2, `feasible_rntis(cell, 8)`, DL 11
CRBs at MCS 25, UL 10 PRB at MCS 20, 30 dB, llr_bits=16, R rounds) timed in
full and with heavy stages replaced by the source's cheap stubs, which
attribute the per-round latency:

  - "-viterbi": `viterbi.viterbi_decode` returns zeros;
  - "-turbodec": `sch.decode_tb` returns zeros with every CRC passing;
  - "-turboenc": `sch.encode_tb` returns an all-zero codeword;
  - "-all-fec": the three together.

Each stub keeps its inputs' producer chain alive as the source's does (a
zero-weighted sum of its input is added to its output).  On the card the
block captures its round as a CUDA graph at its first call, and what the
graph replays is what the capture called: so each variant builds its own
step and makes its first call inside its stubs, as the source traces each
variant's program with its stubs in place; the original functions are
restored after each variant.  Payloads come from
default_rng(0) in the source's order, the schedule is make_schedule(seed=3)
and the noise a torch.Generator seeded 0 (the source's PRNGKey(0)).

Usage: python -m srslte_emane_tpu_torch.scripts.profile_dynblock [R] [iters] [--cpu]
(R, 2 by default, is the source's; `iters`, 3 by default, its fixed count
of timed calls.)

Each variant: one untimed call, then `iters` calls (CUDA events on the
card, the host clock on the CPU), reported per round.  Prints the source's
lines, then one JSON line: {"ms_per_round": {variant: ms}, "variants":
{variant: {"ms", "host_ms", "turbo_map_launches", "turbo_map_v1_launches"}
per block}, "R", "n_ues"} plus "backend" and "device".
"""

from __future__ import annotations

import contextlib
import json
import sys

import numpy as np
import torch

from ..ops.fec import viterbi
from ..phch import grid as grid_mod, sch
from ..runtime import waveblock_dyn as wbd
from . import _timing


def bench_cfg(R: int = 2) -> wbd.DynBlockConfig:
    cell = grid_mod.CellConfig(n_prb=100, cell_id=1, cfi=2)
    return wbd.DynBlockConfig(
        cell=cell, rntis=wbd.feasible_rntis(cell, 8), dl_l_crbs=11, dl_mcs=25, ul_l_prb=10,
        ul_mcs=20, snr_db=(30.0,) * 8, R=R, llr_bits=16)


def stub_vit(llrs, tb_iter=3):
    keep = (llrs.sum((-2, -1))[:, None] * 0).to(torch.int8)
    return torch.zeros((llrs.shape[0], llrs.shape[-1]), dtype=torch.int8,
                       device=llrs.device) + keep


def stub_dec(llrs, c, softbuf=None, max_iter=8, use_kernel=None, llr_bits=32, rv_b=None,
             read=True):
    B = llrs.shape[0]
    if softbuf is None:
        softbuf = sch.init_softbuffer(B, c, llrs.dtype, llrs.device)
    keep = (llrs.sum(-1, keepdim=True) * 0).to(torch.int8)
    return (torch.zeros((B, c.tbs), dtype=torch.int8, device=llrs.device) + keep,
            torch.ones((B,), dtype=torch.bool, device=llrs.device) & (llrs.sum(-1) > -1e30),
            softbuf, 0)


def stub_enc(b, c, rv_b=None):
    return torch.zeros((b.shape[0], c.G), dtype=torch.int8, device=b.device)


def stub_enc_kept(b, c, rv_b=None):
    return stub_enc(b, c) + (b.sum(-1, keepdim=True) * 0).to(torch.int8)


# variant -> the (module, name, stub) replacements it runs with
VARIANTS = {
    "full": (),
    "-viterbi": ((viterbi, "viterbi_decode", stub_vit),),
    "-turbodec": ((sch, "decode_tb", stub_dec),),
    "-turboenc": ((sch, "encode_tb", stub_enc),),
    "-all-fec": ((sch, "decode_tb", stub_dec), (viterbi, "viterbi_decode", stub_vit),
                 (sch, "encode_tb", stub_enc_kept)),
}


@contextlib.contextmanager
def stubbed(variant: str):
    """The variant's stubs in place of the port's functions; the originals
    come back on exit."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in VARIANTS[variant]]
    try:
        for mod, name, stub in VARIANTS[variant]:
            setattr(mod, name, stub)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def block_inputs(cfg: wbd.DynBlockConfig, dev: torch.device):
    """(dl_q, ul_q, rb_dl, rb_ul) as the source draws them."""
    rng = np.random.default_rng(0)
    T = cfg.T
    dl_q = torch.from_numpy(rng.integers(0, 2, (T, cfg.n_ues, cfg.dl_tbs), dtype=np.int8)).to(dev)
    ul_q = torch.from_numpy(rng.integers(0, 2, (T, cfg.n_ues, cfg.ul_tbs), dtype=np.int8)).to(dev)
    rb_dl, rb_ul = wbd.make_schedule(cfg, seed=3)
    return dl_q, ul_q, torch.from_numpy(rb_dl).to(dev), torch.from_numpy(rb_ul).to(dev)


def run(cfg: wbd.DynBlockConfig, variant: str, dev: torch.device, iters: int = 3):
    """The block under `variant`: (its first call's outputs, the
    `profile_stage` record per block)."""
    inputs = block_inputs(cfg, dev)
    with stubbed(variant):
        step = wbd.make_dyn_block_step(cfg, device=dev)

        def call():
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            return step(*inputs, gen, 0)

        return _timing.profile_stage(call, iters, dev)


def main(argv=None) -> int:
    ap = _timing.parser(__doc__)
    ap.add_argument("R", type=int, nargs="?", default=2)
    ap.add_argument("iters", type=int, nargs="?", default=3)
    args = ap.parse_args(argv)
    dev = _timing.device(args.cpu, "profile_dynblock")
    cfg = bench_cfg(args.R)
    per_round, recs = {}, {}
    for variant in VARIANTS:
        _, recs[variant] = run(cfg, variant, dev, args.iters)
        per_round[variant] = _timing.stage_ms(recs[variant]) / cfg.R
        print(f"{variant}: {per_round[variant]:.1f} ms/round", flush=True)
    print(json.dumps({"ms_per_round": per_round, "variants": recs, "R": cfg.R,
                      "n_ues": cfg.n_ues, **_timing.stamp(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
