"""The port's measuring entry points, twins of the JAX repository's root
`bench.py` (here `srslte_emane_tpu_torch.bench`) and of its
`scripts/{snr_sweep,bench_extra,bench_waveform_tpu,bench_waveblock_dyn,
bench_waveform_paced,profile_stages,wavenet_smoke,profile_turbo,profile_mimo,
profile_dynblock}.py`.

Each runs as `python -m srslte_emane_tpu_torch.scripts.<name> [args]`, with
its twin's positional arguments and defaults, on the card unless it is
given `--cpu` (without a card and without `--cpu` it raises).  Each ends
with one JSON line: its twin's keys plus "backend" ("cuda" or "cpu") and
"device" (the card's name).  No entry point falls back to another path
when the MAP kernel fails to build or launch: the run fails.
"""
