"""ltebench: the benchmark of the PyTorch and CUDA port, srslte_emane_tpu_torch.

`python3 -m ltebench.run` runs one cell of BENCHMARK.json (see harness.py).
The folder holds everything the benchmark measures with: the drivers and
their one traffic generator each (systems/), the traffic mixes
(traffic/), the configurations (configs/), the per-layer metric readers
(metrics/), the trace reduction (trace.py), the peaks and roofline bounds
(roofline.py), the plain reference that decides `correct` (reference/) and
the limits it is held to (checks/).  It imports neither JAX nor the JAX
package, and the reference imports nothing of the program.
"""
