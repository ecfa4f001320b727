"""Device work captured as a CUDA graph and replayed: the port's `jax.jit`
and `lax.scan`.

The reference compiles a step (`jax.jit`) or a loop of rounds (`lax.scan`)
into one device program.  The port captures the step's or the round's
launches once as a `torch.cuda.CUDAGraph` and replays the graph: the host
then enqueues one graph launch per call (`StepGraph`, through `jit`) or per
round (`RoundGraph`) instead of every kernel of it.

A replay runs the captured kernels, but the Python that enqueued them ran
once, at capture, and a capture launches nothing: the launch counts that the
kernels' wrappers keep (`COUNTERS`) would count the capture and no replay.
A capture puts each count back to its value before it, and each replay adds
what the capture counted.  A failure raises: nothing falls back to the
eager step.

How long a table lives, the one rule: a graph reads its tables by address,
so every device table that a captured step reads comes from a bounded
`utils.devices.table_cache`, and the graph holds each table that one
handed out while it captured (`devices.holding`), so none is freed under it
while the graph lives.  A capture may read any table that the warm-up just
before it handed out: the warm-up records them (`devices.recording`), and a
capture whose lookup misses a cache's LRU (one step asked for more keys
than its bound) takes the table from that record; a key the warm-up never
asked for raises.  This holds for `StepGraph`, for both captures of
`RoundGraph` and so for every step of `jit` and `step`.  No other cache
keeps a table that a graph reads:
the waveform network's `_CellKernels` and the waveform planes keep their
factories (and so their graphs) per instance (`per_instance`), and their
device tables in module-level table_caches like every other step's.

`STATS` counts the graphs built (`StepGraph` and `RoundGraph`) and the
seconds their builds took, warm-up and capture together.

Spans (utils/trace.py): with tracing on, or under an active profiler, a
replay is a host span `graphs.replay` with the children `graphs.load`
(the input copies and fills), `graphs.launch` (the graph's replay) and
`graphs.clone` (the output clones); a `RoundGraph` run has a
`graphs.launch` per round.  With tracing on, a `StepGraph` also times its
load and clone on the device, each from an event recorded before the host
enqueues its copies: where no work is queued ahead of the load (a call's
first replay), the load's span runs at the host's pace, and its idle part
lies under the host span `graphs.load` too.  `jit` keeps a graph
captured with tracing on apart from one captured with it off: only the
first holds the device stage events of the step (`trace.stage`), and it
resolves them into spans of its replay before it replays again.  With
both off, each span, stage and group of a replay tests its flags and
does nothing.
"""

from __future__ import annotations

import functools
import gc
import importlib
import numbers
import time

import numpy as np
import torch

from ..utils import devices, trace

# the launch counts kept by the kernels' wrappers: (module, attribute)
COUNTERS = (("srslte_emane_tpu_torch.ops.fec.turbodecoder_cuda", "launches"),
            ("srslte_emane_tpu_torch.ops.fec.turbodecoder_cuda", "launches_v1"),
            ("srslte_emane_tpu_torch.ops.fec.turbo_iter_cuda", "launches"),
            ("srslte_emane_tpu_torch.ops.fec.turbo_iter_cuda", "arm_launches"),
            ("srslte_emane_tpu_torch.ops.fec.viterbi_cuda", "launches"),
            ("srslte_emane_tpu_torch.ops.fec.sch_encode_cuda", "launches"),
            ("srslte_emane_tpu_torch.ops.fec.sch_encode_cuda", "launched_blocks"),
            ("srslte_emane_tpu_torch.ops.fec.turbodecoder", "map_slots"))


# graphs built and the seconds their builds took (warm-up and capture)
STATS = dict(graphs=0, build_s=0.0)


def _built(t0: float) -> None:
    STATS["graphs"] += 1
    STATS["build_s"] += time.perf_counter() - t0


def _warm_up(fn, dev: torch.device) -> dict:
    """fn() once on a side stream: it copies the tables to the card, plans
    the FFTs and builds the kernels, none of which a capture may do.
    Returns the record of the tables it was handed (`devices.recording`),
    for the capture after it."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with devices.recording() as made, torch.cuda.stream(side), trace.muted():
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    return made


def _capture(graph, fn, made, gens=(), pool=None, stages=None):
    """fn() captured into `graph`, with `gens` registered as its graph-safe
    generators and `made` the warm-up's record of tables (`_warm_up`);
    the device stages of fn go into `stages` (a `trace.Capture`) as event
    nodes of the graph, or, with None, are left out.
    Returns (fn's result, [(module, attribute, launches the capture
    counted)], the tables it read); each count is put back to its value
    before the capture.  Python's cyclic garbage collector is off
    while the stream captures: it would otherwise free, at any allocation,
    an unreachable object that holds another graph, and the frees of that
    graph's memory invalidate the capture."""
    for g in gens:
        graph.register_generator_state(g)
    counters = [(importlib.import_module(m), name) for m, name in COUNTERS]
    before = [getattr(m, name) for m, name in counters]
    collecting = gc.isenabled()
    gc.disable()
    try:
        with devices.holding(made) as tables, torch.cuda.graph(graph, pool=pool), \
                trace.capturing(stages):
            out = fn()
    finally:
        if collecting:
            gc.enable()
    counted = []
    for (m, name), b in zip(counters, before):
        counted.append((m, name, getattr(m, name) - b))
        setattr(m, name, b)
    return out, counted, tables


def _add_counts(counted, n: int) -> None:
    """n replays' launches: n times what the capture counted."""
    for m, name, delta in counted:
        setattr(m, name, getattr(m, name) + n * delta)


def _copy_states(dst, src) -> None:
    for d, s in zip(dst, src):
        d.set_state(s.get_state())


class RoundGraph:
    """`body(gens)`, one round, captured once on `dev`, and `reset()`, which
    puts the round's state back to its start, captured beside it.

    The build: `reset` and `body` run once eagerly on a side stream with
    scratch generators (the warm-up; it leaves the round's state dirty,
    which `run` resets); then one graph-safe generator per cell (`n_gens`)
    is registered with the graph and `body` is captured with them; then
    `reset`, in the same memory pool."""

    def __init__(self, body, reset, n_gens: int, dev: torch.device):
        t0 = time.perf_counter()
        self.gens = [torch.Generator(device=dev) for _ in range(n_gens)]

        def warm_up():
            reset()
            body([torch.Generator(device=dev) for _ in range(n_gens)])

        made = _warm_up(warm_up, dev)
        self.graph = torch.cuda.CUDAGraph()
        _, self.counted, self.tables = _capture(self.graph, lambda: body(self.gens), made,
                                                self.gens)
        self.reset = torch.cuda.CUDAGraph()
        _, _, reset_tables = _capture(self.reset, reset, made, pool=self.graph.pool())
        self.tables.update(reset_tables)
        _built(t0)

    def run(self, n: int, gens) -> None:
        """Reset, then n replays drawing from the states of `gens` (one
        generator per cell, on the card), which are advanced as n eager
        rounds would advance them.  Enqueues only: no host sync."""
        with trace.span("graphs.replay"):
            _copy_states(self.gens, gens)
            self.reset.replay()
            for _ in range(n):
                with trace.span("graphs.launch"):
                    self.graph.replay()
            _copy_states(gens, self.gens)
            _add_counts(self.counted, n)


def _is_number(a) -> bool:
    return isinstance(a, numbers.Number)


def _as_tensor(a):
    """A tensor argument as a tensor (numpy arrays become CPU tensors), or
    None for an argument that is not one."""
    if isinstance(a, torch.Tensor):
        return a
    if isinstance(a, np.ndarray):
        return torch.as_tensor(a)
    return None


def _signature(args) -> tuple:
    """The key under which `jit` keeps a step's graph, as `jax.jit` keys its
    cache: each tensor's (or numpy array's) shape and dtype, each Python
    number's type, "generator" for each torch.Generator, and each other
    argument itself (static: it must be hashable)."""
    key = []
    for a in args:
        t = _as_tensor(a)
        if t is not None:
            key.append(("tensor", tuple(t.shape), t.dtype))
        elif isinstance(a, torch.Generator):
            key.append(("generator",))
        elif _is_number(a):
            key.append(("number", type(a)))
        else:
            key.append(("static", a))
    return tuple(key)


def _tree_map(fn, x):
    """fn on every tensor of a tensor, tuple, list or dict of them."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, v) for v in x)
    return x


class StepGraph:
    """`fn(*args)` captured once on `dev` for one signature of its arguments
    (`_signature`); `run(args)` replays it on new arguments of that
    signature.

    The build: the static inputs, one per argument (a tensor on `dev` for
    each tensor or numpy array, a 0-d tensor for each Python number, the
    argument itself for a static one), loaded with `args`; one warm-up of
    fn on them with scratch generators; one graph-safe generator per
    torch.Generator argument, registered with the graph; then fn captured
    on the static inputs, its results kept as the static outputs.  With
    tracing on, the capture keeps the step's device stages (`stages`)."""

    def __init__(self, fn, args, dev: torch.device):
        t0 = time.perf_counter()
        self.dev = dev
        self.inputs = []
        for a in args:
            t = _as_tensor(a)
            if t is not None:
                self.inputs.append(torch.empty(t.shape, dtype=t.dtype, device=dev))
            elif isinstance(a, torch.Generator):
                self.inputs.append(torch.Generator(device=dev))
            elif _is_number(a):
                self.inputs.append(torch.empty((), dtype=torch.as_tensor(a).dtype, device=dev))
            else:
                self.inputs.append(a)
        self.gens = [x for x in self.inputs if isinstance(x, torch.Generator)]
        self._load(args)
        scratch = lambda: [torch.Generator(device=dev) if isinstance(x, torch.Generator) else x
                           for x in self.inputs]
        made = _warm_up(lambda: fn(*scratch()), dev)
        self.graph = torch.cuda.CUDAGraph()
        self.stages = trace.Capture() if trace.enabled else None
        self.outputs, self.counted, self.tables = _capture(
            self.graph, lambda: fn(*self.inputs), made, self.gens, stages=self.stages)
        self.group = None  # the last replay's device spans, until resolved
        _built(t0)

    def _load(self, args) -> None:
        """The arguments into the static inputs: a copy per tensor, a fill
        per number (a kernel argument: nothing is copied from the host)."""
        for x, a in zip(self.inputs, args):
            if isinstance(x, torch.Tensor):
                if _is_number(a):
                    x.fill_(a)
                else:
                    x.copy_(_as_tensor(a))

    def run(self, args):
        """One replay on `args`: the generators' states go in and come back
        advanced as the eager step would advance them; returns new tensors
        (the next replay overwrites the static outputs).  With the tensor
        arguments on `dev`, enqueues only: no host sync.  With tracing on,
        the last replay's device spans are resolved first, the load and
        the clone are timed on the device as well, and the captured stages
        are handed over as spans of this replay."""
        with trace.span("graphs.replay"):
            if self.group is not None:  # the last replay's spans: its events are recorded again
                self.group.resolve()
            with trace.group(self.dev) as self.group:
                with trace.span("graphs.load"), trace.stage("graphs.load", self.dev):
                    self._load(args)
                    gens = [a for a in args if isinstance(a, torch.Generator)]
                    _copy_states(self.gens, gens)
                with trace.span("graphs.launch") as launch:
                    self.graph.replay()
                    trace.replayed(self.stages, launch)
                _copy_states(gens, self.gens)
                _add_counts(self.counted, 1)
                with trace.span("graphs.clone"), trace.stage("graphs.clone", self.dev):
                    return _tree_map(torch.Tensor.clone, self.outputs)


def on_card(dev: torch.device) -> bool:
    """Whether `jit` captures on `dev`: a CUDA device."""
    return dev.type == "cuda"


def _device_of(args) -> torch.device:
    """The device of a step's first tensor argument, else of its first
    generator, else the CPU."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    for a in args:
        if isinstance(a, torch.Generator):
            return a.device
    return torch.device("cpu")


TRACED = (("traced",),)


def jit(fn, device=None):
    """fn as the reference's `jax.jit(fn)` runs it: on the card (`device`,
    or the device of the first tensor argument), the first call of each
    `_signature` builds a `StepGraph` and every call replays it, returning
    new tensors, with no host sync from the replay to the return when the
    tensor arguments lie on the card.  Off the card fn runs eagerly.  The
    outputs equal the eager fn's bit for bit; a capture or replay that
    fails raises.  The returned step keeps its graphs in `.graphs`; one
    captured with tracing on is keyed apart (`TRACED` ends its key)."""
    graphs = {}
    fixed = None if device is None else torch.device(device)

    def step(*args):
        dev = fixed or _device_of(args)
        if not on_card(dev):
            return fn(*args)
        key = _signature(args)
        if trace.enabled:
            key += TRACED
        graph = graphs.get(key)
        if graph is None:
            graph = graphs[key] = StepGraph(fn, args, dev)
        return graph.run(args)

    step.graphs = graphs
    return step


def step(run, device: torch.device, enabled: bool = True):
    """`run` as a jitted step of the reference: `jit(run, device)` on the
    card when `enabled`, else run eagerly on the arguments a graph would
    get (a number as a 0-d tensor, a numpy array as a tensor, on `device`),
    so that the tensor path the graph captures is the one that runs."""
    if enabled and on_card(device):
        return jit(run, device)

    def eager(*args):
        return run(*(torch.as_tensor(a, device=device)
                     if isinstance(a, (np.ndarray, numbers.Number)) else a for a in args))

    return eager


def per_instance(factory):
    """A method that makes steps, cached in its instance's `_memo` by its
    arguments, as the reference caches its jitting factories per key: one
    step (and so one set of graphs) per key and instance."""

    @functools.wraps(factory)
    def cached(self, *args):
        key = (factory.__name__,) + args
        if key not in self._memo:
            self._memo[key] = factory(self, *args)
        return self._memo[key]

    return cached
