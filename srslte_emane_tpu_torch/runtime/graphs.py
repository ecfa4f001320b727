"""One round of device work captured as a CUDA graph and replayed.

The reference compiles a loop of rounds (`lax.scan`) into one device
program.  The port captures the round's launches once as a
`torch.cuda.CUDAGraph` and replays the graph once per round: the host then
enqueues one graph launch per round instead of every kernel of it.

A replay runs the captured kernels, but the Python that enqueued them ran
once, at capture, and a capture launches nothing: the launch counts that the
kernels' wrappers keep (`COUNTERS`) would count the capture and no replay.
`RoundGraph` puts each count back to its value before the capture, and
`run(n)` adds n times what the capture counted.
"""

from __future__ import annotations

import importlib

import torch

# the launch counts kept by the kernels' wrappers: (module, attribute)
COUNTERS = (("srslte_emane_tpu_torch.ops.fec.turbodecoder_cuda", "launches"),
            ("srslte_emane_tpu_torch.ops.fec.turbodecoder_cuda", "launches_v1"),
            ("srslte_emane_tpu_torch.ops.fec.turbo_iter_cuda", "launches"),
            ("srslte_emane_tpu_torch.ops.fec.turbo_iter_cuda", "arm_launches"),
            ("srslte_emane_tpu_torch.ops.fec.viterbi_cuda", "launches"))


class RoundGraph:
    """`body(gens)`, one round, captured once on `dev`, and `reset()`, which
    puts the round's state back to its start, captured beside it.

    The build: `reset` and `body` run once eagerly on a side stream with
    scratch generators (the warm-up: it copies the tables to the card,
    plans the FFTs and builds the kernels, none of which a capture may do;
    it leaves the round's state dirty, which `run` resets); then one
    graph-safe generator per cell (`n_gens`) is registered with the graph
    and `body` is captured with them; then `reset`, in the same memory pool.
    The tables that the round reads come from caches that never evict, so
    none is freed under the graph.  A failure raises: nothing falls back to
    the eager round."""

    def __init__(self, body, reset, n_gens: int, dev: torch.device):
        self.gens = [torch.Generator(device=dev) for _ in range(n_gens)]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            reset()
            body([torch.Generator(device=dev) for _ in range(n_gens)])
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        for g in self.gens:
            self.graph.register_generator_state(g)
        counters = [(importlib.import_module(m), name) for m, name in COUNTERS]
        before = [getattr(m, name) for m, name in counters]
        with torch.cuda.graph(self.graph):
            body(self.gens)
        self.counted = []  # (module, attribute, launches of one round)
        for (m, name), b in zip(counters, before):
            self.counted.append((m, name, getattr(m, name) - b))
            setattr(m, name, b)
        self.reset = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.reset, pool=self.graph.pool()):
            reset()

    def run(self, n: int, gens) -> None:
        """Reset, then n replays drawing from the states of `gens` (one
        generator per cell, on the card), which are advanced as n eager
        rounds would advance them.  Enqueues only: no host sync."""
        for mine, g in zip(self.gens, gens):
            mine.set_state(g.get_state())
        self.reset.replay()
        for _ in range(n):
            self.graph.replay()
        for mine, g in zip(self.gens, gens):
            g.set_state(mine.get_state())
        for m, name, delta in self.counted:
            setattr(m, name, getattr(m, name) + n * delta)
