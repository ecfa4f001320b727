"""PyTorch port vs the JAX package: the measuring entry points.

The SNR sweep (slice 8): a small cell of the sweep's kind (6 PRB, 64QAM,
rate 0.55, llr_bits=16, batch 16) at two SNRs of its waterfall, 10.5 and
11.0 dB, chosen from a JAX run so that one has a BLER strictly between 0
and 1.  Both packages' `rx_subframe` get the same received samples: the
JAX TX waveform plus one numpy noise draw per SNR, in order, from the
payload's default_rng(0).  The reference runs with its `ops/dft.py` dft
patched to an f32 FFT (`_dft_f32` of test_torch_wavenet.py): its bf16
input rounding would otherwise flip marginal rows.  Every row's CRC flag
and decoded bits must be equal, the failing rows' included (no allowance).

The entry points: each one's `main(argv)` runs in process with --cpu at a
tiny size and must pass its gates, end with a JSON line holding its JAX
twin's keys plus "backend" (and "device"), and build no `turbo_map`
library (the CPU runs the kernel's plain version).  Without a card and
without --cpu, each raises.
"""

import dataclasses
import importlib
import json

import jax
import numpy as np
import pytest
import torch

from srslte_emane_tpu.models import pdsch_link as j_link
from srslte_emane_tpu.ops import dft as j_dft
from srslte_emane_tpu.phch import grid as j_grid
from srslte_emane_tpu_torch.models import pdsch_link as p_link
from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc
from srslte_emane_tpu_torch.phch import grid as p_grid
from test_torch_wavenet import _dft_f32

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

SWEEP_CELL = dict(n_prb=6, cell_id=1, cfi=1)
SWEEP_LINK = dict(qm=6, code_rate=0.55, sf_idx=1, llr_bits=16)
SWEEP_SNRS_DB = (10.5, 11.0)
SWEEP_BATCH = 16

# each JAX script's JSON keys (the last line; snr_sweep's rows too), which
# the twin keeps: bench.py:146-157, scripts/snr_sweep.py:56-61,
# scripts/bench_extra.py:118 (its `timed` names), and the JSON lines of
# scripts/bench_waveform_tpu.py:110, bench_waveblock_dyn.py:110 and
# bench_waveform_paced.py:149.
# profile_stages.py, wavenet_smoke.py and profile_{turbo,mimo,dynblock}.py
# print no JSON; their twins' keys are the port's own.
BLOCK_KEYS = {"metric", "value", "unit", "vs_baseline", "n_prb", "n_ues", "block_ttis",
              "dl_mbps", "ul_mbps", "median_of", "spread_pct", "compile_s", "device"}
JAX_KEYS = {
    "bench": {"metric", "value", "unit", "vs_baseline", "median_of", "spread_pct",
              "cache_state", "compile_s"},
    "snr_sweep": {"snr_sweep"},
    "bench_extra": {"cell_search", "mimo_tm3_decode", "pusch_decode", "ca_2cc_link"},
    "bench_waveform_tpu": BLOCK_KEYS,
    "bench_waveblock_dyn": BLOCK_KEYS | {"n_cells"},
    "bench_waveform_paced": {"metric", "value", "unit", "vs_baseline", "n_prb", "n_ues",
                             "block_ttis", "blocks", "deadline_misses", "compute_ms",
                             "serialized_rtt_ms", "per_tti_us", "compile_s", "device"},
    "profile_stages": {"stages", "decode_sf_per_s", "encode_sf_per_s", "batch", "tbs"},
    "wavenet_smoke": {"registered", "n_ues", "tti", "seconds"},
    "profile_turbo": {"stages", "glue_ms", "kernels_ms", "n_cb", "k", "n_windows", "iters",
                      "launches"},
    "profile_mimo": {"stages", "sf_per_s", "mb_per_s", "stage_sum_ms", "full_ms", "batch",
                     "tbs", "G", "C", "n_re"},
    "profile_dynblock": {"ms_per_round", "variants", "R", "n_ues"},
}
SWEEP_ROW_KEYS = {"snr_db", "bler", "sf_per_s", "goodput_mbps"}
# (module under srslte_emane_tpu_torch, --cpu arguments at a tiny size)
RUNS = [
    ("bench", ["1", "1", "1"]),
    ("scripts.snr_sweep", ["1", "1", "20"]),
    ("scripts.bench_extra", ["1", "1"]),
    ("scripts.bench_waveform_tpu", ["15", "2", "2", "1", "1"]),
    ("scripts.bench_waveform_tpu", ["15", "2", "2", "1", "1", "tm3"]),
    ("scripts.bench_waveblock_dyn", ["2", "1", "1", "1"]),
    ("scripts.bench_waveblock_dyn", ["2", "1", "1", "1", "2"]),
    ("scripts.bench_waveform_paced", ["15", "2", "2", "3"]),
    ("scripts.profile_stages", ["1", "1"]),
    ("scripts.wavenet_smoke", ["200"]),
    ("scripts.profile_turbo", ["4", "512", "1"]),
    ("scripts.profile_mimo", ["1", "1"]),
    ("scripts.profile_dynblock", ["1", "1"]),
]
MODULES = sorted({m for m, _ in RUNS})


@pytest.fixture(scope="module")
def sweep():
    """Per SNR: (payload, JAX bits, JAX flags, port bits, port flags)."""
    jcfg = j_link.LinkConfig(cell=j_grid.CellConfig(**SWEEP_CELL), **SWEEP_LINK)
    pcfg = p_link.LinkConfig(cell=p_grid.CellConfig(**SWEEP_CELL), **SWEEP_LINK)
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 2, (SWEEP_BATCH, jcfg.tbs), dtype=np.int8)
    rows = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_dft, "dft", _dft_f32)
        jax.clear_caches()  # nothing traced with the bf16 dft may be reused
        tx = np.asarray(jax.jit(lambda p: j_link.tx_subframe(p, jcfg))(payload))
        rx_j = jax.jit(lambda s: j_link.rx_subframe(s, jcfg)[:2])  # rx reads no snr_db
        power = np.mean(np.sum(tx ** 2, -1), -1)[:, None, None]
        for snr in SWEEP_SNRS_DB:
            rx = (tx + rng.normal(size=tx.shape) * np.sqrt(power / 10 ** (snr / 10) / 2)
                  ).astype(np.float32)
            out_j, ok_j = rx_j(rx)
            out_p, ok_p, _, _ = p_link.rx_subframe(torch.from_numpy(rx),
                                                   dataclasses.replace(pcfg, snr_db=snr))
            rows[snr] = (payload, np.asarray(out_j), np.asarray(ok_j), out_p.numpy(),
                         ok_p.numpy())
    jax.clear_caches()
    return rows


@pytest.mark.parametrize("snr", SWEEP_SNRS_DB)
def test_sweep_rows_equal_the_jax_link(sweep, snr):
    payload, out_j, ok_j, out_p, ok_p = sweep[snr]
    np.testing.assert_array_equal(ok_p, ok_j)
    np.testing.assert_array_equal(out_p, out_j)
    assert (out_p[ok_p] == payload[ok_p]).all()


def test_sweep_cell_is_in_its_waterfall(sweep):
    blers = [1.0 - ok_j.mean() for _, _, ok_j, _, _ in sweep.values()]
    assert any(0.0 < b < 1.0 for b in blers), blers
    assert blers == sorted(blers, reverse=True), blers


@pytest.mark.parametrize("module,args", RUNS, ids=[" ".join([m, *a]) for m, a in RUNS])
def test_entry_point_on_the_cpu(module, args, capsys, monkeypatch):
    def no_build(source):
        raise AssertionError(f"built {source} on the CPU")

    monkeypatch.setattr(tdc, "build", no_build)
    mod = importlib.import_module(f"srslte_emane_tpu_torch.{module}")
    assert mod.main([*args, "--cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    name = module.rsplit(".", 1)[-1]
    assert JAX_KEYS[name] | {"backend", "device"} <= set(last), set(last)
    assert (last["backend"], last["device"]) == ("cpu", "cpu")
    if name == "snr_sweep":
        rows = [json.loads(line) for line in lines[:-1]]
        assert rows == last["snr_sweep"] and all(SWEEP_ROW_KEYS <= set(r) for r in rows)
        assert [(r["bler"], r["turbo_map_launches"]) for r in rows] == [(0.0, 0.0)]  # 20 dB
    if name == "wavenet_smoke":
        assert last["registered"] == last["n_ues"] == 2
    if name in ("profile_turbo", "profile_mimo", "profile_dynblock"):  # no launch on the CPU
        stages = last["variants" if name == "profile_dynblock" else "stages"]
        assert all(r["ms"] is None and r["turbo_map_launches"] == r["turbo_map_v1_launches"] == 0
                   for r in stages.values())
        assert len(stages) == {"profile_turbo": 6, "profile_mimo": 6, "profile_dynblock": 5}[name]


@pytest.mark.parametrize("module", MODULES)
def test_entry_point_needs_a_card_or_cpu(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"srslte_emane_tpu_torch.{module}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
