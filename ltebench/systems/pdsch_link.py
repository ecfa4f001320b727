"""Driver of the PDSCH link cells: the traffic generator and one call.

A call is one batch of `batch` subframes at one SNR: the program's encode
(`models/pdsch_link.tx_subframe`, a replayed CUDA graph through
`runtime/graphs.jit`), then AWGN added here at the call's SNR, then the
program's decode (`rx_subframe`, a replayed graph) with its soft buffers
and channel estimate.  The harness times each call, waits for its outputs
and keeps the calls that the check samples.

The traffic file gives `snr_db` (a list the calls cycle through in
order: call c is at SNR c % len(snr_db), its stratum for the check's
sample), `pool` (how many payload batches and unit-noise batches are made
on the card from the seed at set-up; call c takes payload c % pool and
noise (c + c // pool) % pool), `check_per_snr` (calls of each SNR that
the check samples from the whole window) and `trace_calls` (calls in the
profiled window of a trace run).  Every seed gets the same sizes and
SNRs; only the bits and the noise differ.

`check` compares each sampled call with the plain reference (reference/):
the tx samples (`tx_err`), the channel estimate (`chest_err`) and the
soft buffers (`softbuf_err`) as relative RMS errors against the
reference's float64 link run on the same payload and unit noise, and the
decoded payloads and CRC flags (`rows_wrong`) against the reference
decoder run on the program's soft buffers.  The reference decoder also
runs on the reference's own soft buffers; the rows where that decode and
the program's differ are reported in `info`, not compared.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ltebench.reference import link as ref_link
from ltebench.reference import tables
from ltebench.reference import turbo as ref_turbo


def reference_link(config: dict) -> tables.Link:
    return tables.Link(**{k: config[k] for k in (
        "n_prb", "cell_id", "cfi", "sf_idx", "rnti", "qm", "code_rate", "max_iter", "llr_bits")})


def control_steps(config: dict):
    """The reference one precision down, in the program's place: its
    float32 arithmetic rounded to bfloat16 at every stage, and its decoder
    fed 8-bit LLRs where the configuration states 16."""
    lnk = reference_link(config)

    def rx(samples):
        softbuf, ce = ref_link.front_end(samples, lnk, ref_link.CONTROL)
        out, ok = ref_turbo.decode(softbuf, lnk, llr_bits=8)
        return out, ok, softbuf, ce

    return lambda p: ref_link.encode(p, lnk, ref_link.CONTROL).to(torch.float32), rx


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.to(torch.float64), b.to(torch.float64)
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


class Driver:
    rate_metric = "link_sf_per_s"

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        self.config, self.seed, self.dev = config, seed, device
        self.link = reference_link(config)
        if self.link.tbs != config["tbs"]:
            raise ValueError(f"code_rate {config['code_rate']} gives TBS {self.link.tbs}, "
                             f"not the configuration's {config['tbs']}")
        self.batch = self.units_per_call = config["batch"]
        self.snrs = [float(s) for s in traffic["snr_db"]]
        self.strata = len(self.snrs)
        self.per_stratum = traffic["check_per_snr"]
        self.pool = traffic["pool"]
        self.trace_calls = traffic["trace_calls"]
        self.info_ = {}
        self._stages = None
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        n_fft, _, cps = tables.ofdm_layout(self.link.n_prb)
        sf_len = sum(cps) + tables.N_SYM * n_fft
        self.payloads = torch.randint(0, 2, (self.pool, self.batch, self.link.tbs),
                                      generator=gen, device=device, dtype=torch.int8)
        self.noise = torch.randn((self.pool, self.batch, sf_len, 2), generator=gen, device=device)

    def inputs(self, c: int):
        """(payload, unit noise, SNR in dB) of call c."""
        return (self.payloads[c % self.pool], self.noise[(c + c // self.pool) % self.pool],
                self.snrs[c % self.strata])

    def program(self):
        """The program's graphed encode and decode for this configuration:
        encode(payload) -> tx; decode(rx) -> (payload, ok, soft buffers, ce).
        On the card its kernel libraries are built under its build/ on the
        first run of a checkout and loaded after; off the card (the tests)
        the decoder runs its kernels' plain versions, which compute what
        the kernels compute on the card."""
        from srslte_emane_tpu_torch.models import pdsch_link
        from srslte_emane_tpu_torch.phch import grid
        from srslte_emane_tpu_torch.runtime import graphs

        c = self.config
        cfg = pdsch_link.LinkConfig(
            cell=grid.CellConfig(n_prb=c["n_prb"], cell_id=c["cell_id"], cfi=c["cfi"]),
            sf_idx=c["sf_idx"], rnti=c["rnti"], qm=c["qm"], code_rate=c["code_rate"],
            max_iter=c["max_iter"], llr_bits=c["llr_bits"])
        if (cfg.tbs, cfg.G) != (self.link.tbs, self.link.G):
            raise ValueError(f"program and reference disagree on the configuration: TBS "
                             f"{cfg.tbs} / {self.link.tbs}, G {cfg.G} / {self.link.G}")
        on_card = self.dev.type == "cuda"
        if on_card:
            from srslte_emane_tpu_torch.ops.fec import turbo_iter_cuda
            from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc

            builds = [tdc.build(tdc.SOURCE), tdc.build(turbo_iter_cuda.SOURCE)]
            self.info_["kernel_build_s"] = sum(b.seconds for b in builds)

        def rx(samples):
            out, ok, softbuf, ch = pdsch_link.rx_subframe(
                samples, cfg, use_kernel=None if on_card else True)
            return out, ok, softbuf, ch.ce

        return graphs.jit(lambda p: pdsch_link.tx_subframe(p, cfg)), graphs.jit(rx)

    def use(self, steps) -> None:
        self.encode, self.decode = steps

    def warm(self, steps) -> None:
        """The program's graphs captured, then every SNR's call run once."""
        from srslte_emane_tpu_torch.runtime import graphs

        self.use(steps)
        for c in range(self.strata):
            self.call(c)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.info_.update(graphs=graphs.STATS["graphs"], graph_build_s=graphs.STATS["build_s"])

    def call(self, c: int):
        """Call c submitted; returns (tx, (payload, ok, soft buffers, ce)).
        With stage timing on, CUDA events mark the encode and the decode."""
        payload, noise, snr = self.inputs(c)
        ev = None
        if self._stages is not None:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
        tx = self.encode(payload)
        if ev:
            ev[1].record()
        rx = ref_link.add_noise(tx, noise, snr)
        if ev:
            ev[2].record()
        out = self.decode(rx)
        if ev:
            ev[3].record()
            self._stages.append(ev)
        return tx, out

    def counters_reset(self, stages: bool = False) -> None:
        """Zero the program's counters; with `stages` (on the card) time
        each later call's encode and decode."""
        from srslte_emane_tpu_torch.ops.fec import turbodecoder

        turbodecoder.reset_map_rows()
        self._stages = [] if stages and self.dev.type == "cuda" else None

    def counters(self) -> dict:
        """MAP rows since the reset, and the encode and decode times in ms
        of each call where stages were timed."""
        from srslte_emane_tpu_torch.ops.fec import turbodecoder

        out = {"map_rows": turbodecoder.read_map_rows()}
        if self._stages:
            out["encode_ms"] = [e[0].elapsed_time(e[1]) for e in self._stages]
            out["decode_ms"] = [e[2].elapsed_time(e[3]) for e in self._stages]
        self._stages = None
        return out

    def map_work(self, rows: float) -> list:
        """[(K, rows of K, windows, narrow)]: MAP rows split over the
        code-block sizes in proportion to their count (the rows of one
        call's decodes are counted together)."""
        sizes = self.link.segm.sizes
        return [(k, rows * sizes.count(k) / len(sizes), ref_turbo.n_windows(k),
                 self.link.llr_bits <= 16) for k in sorted(set(sizes))]

    def check(self, kept: dict) -> dict:
        """The numbers compared for the calls in `kept` ({c: what call c
        returned}); the program's steps are let go first, and the
        reference runs once over all the sampled calls."""
        self.encode = self.decode = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        lnk, B = self.link, self.batch
        calls = sorted(kept)
        outs = [kept[c][1] for c in calls]
        ins = [self.inputs(c) for c in calls]
        cat = lambda xs: torch.cat(list(xs))
        rows = lambda j: slice(j * B, (j + 1) * B)
        tx_ref = ref_link.encode(cat(i[0] for i in ins), lnk)
        tx_err = [rel_err(kept[c][0], tx_ref[rows(j)]) for j, c in enumerate(calls)]
        snr = torch.tensor([i[2] for i in ins], dtype=torch.float64,
                           device=self.dev).repeat_interleave(B)
        sb_ref, ce_ref = ref_link.front_end(
            ref_link.add_noise(tx_ref, cat(i[1] for i in ins), snr), lnk)
        del tx_ref
        chest_err = [rel_err(o[3], ce_ref[rows(j)]) for j, o in enumerate(outs)]
        sb_err = [rel_err(cat(s.flatten() for s in o[2]),
                          cat(s[rows(j)].flatten() for s in sb_ref)) for j, o in enumerate(outs)]
        del ce_ref
        payload, ok = cat(o[0] for o in outs), cat(o[1] for o in outs)
        t0 = time.perf_counter()
        payload_own, ok_own = ref_turbo.decode(sb_ref, lnk)
        del sb_ref
        softbuf = [cat(o[2][r] for o in outs) for r in range(lnk.segm.C)]
        payload_ref, ok_ref = ref_turbo.decode(softbuf, lnk)
        wrong = (ok != ok_ref) | (payload != payload_ref).any(dim=1)
        snr_of_row = np.repeat([i[2] for i in ins], B)
        flag_differs = (ok != ok_own).cpu().numpy()
        self.info_.update(
            checked_calls=calls, checked_bler=1.0 - float(ok.float().mean()),
            reference_decodes_s=time.perf_counter() - t0,
            own_softbuf_bler=1.0 - float(ok_own.float().mean()),
            own_softbuf_flags_differ=int(flag_differs.sum()),
            own_softbuf_flags_differ_at_db=sorted({float(s) for s in snr_of_row[flag_differs]}),
            own_softbuf_payloads_differ=int(((payload != payload_own).any(dim=1)
                                             & ok & ok_own).sum()))
        return {"tx_err": max(tx_err), "chest_err": max(chest_err),
                "softbuf_err": max(sb_err), "rows_wrong": int(wrong.sum())}

    def info(self) -> dict:
        return dict(self.info_)
