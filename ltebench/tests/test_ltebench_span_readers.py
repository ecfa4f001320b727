"""The readers of the program's spans and MAP slot counts: on a made-up
profiler trace, a made-up span list, and one traced pass of a small cell
on the CPU."""

import pathlib
import time
import typing

import pytest
import torch

from ltebench import harness, spans
from ltebench.tests import small_tree
from ltebench.trace import WINDOW, Event

ROOT = pathlib.Path(__file__).resolve().parents[2]
STAGES = {"tx_fec_ms.link": "tx.fec", "tx_map_ms.link": "tx.map", "tx_ofdm_ms.link": "tx.ofdm",
          "rx_ofdm_ms.link": "rx.ofdm", "rx_chest_ms.link": "rx.chest",
          "rx_llr_ms.link": "rx.llr", "rx_turbo_ms.link": "rx.turbo", "rx_tb_ms.link": "rx.tb"}


class Span(typing.NamedTuple):  # the fields of the program's trace.Span that the readers use
    name: str
    request: int
    start_ns: int
    end_ns: int


def read(name, ctx):
    return harness.reader(ROOT, name)(ctx)


def events(graph_spans=True):
    """A 1 ms window: the device busy 100-300 and 600-700 us; a graph
    launch inside `graphs.launch` over 0-90 us (the gap 0-100 us lies under
    it), a sync over 300-600 us, nothing over 700-1000 us."""
    us = 1000
    ev = [Event(WINDOW, False, 0, 1000 * us),
          Event("cudaGraphLaunch", False, 10 * us, 80 * us),
          Event("k", True, 100 * us, 300 * us),
          Event("cudaEventSynchronize", False, 300 * us, 600 * us),
          Event("k", True, 600 * us, 700 * us)]
    if graph_spans:
        ev += [Event("graphs.replay", False, 0, 95 * us),
               Event("graphs.launch", False, 5 * us, 90 * us)]
    return ev


def test_replay_idle_counts_only_gaps_under_graph_spans():
    assert read("replay_idle_ms.link", {"events": events(), "traced_calls": 2}) == \
        pytest.approx(0.05)  # 100 us over 2 calls
    assert read("replay_idle_ms.link", {"events": events(False), "traced_calls": 2}) is None


def test_stage_readers_take_the_mean_over_the_requests():
    recs = [Span(stage, r, 1000 * r, 1000 * r + 100_000 * (i + 1) * (r + 1))
            for i, stage in enumerate(STAGES.values()) for r in range(3)]
    recs += [Span("graphs.load", r, 0, 20_000) for r in range(3) for _ in range(2)]
    recs += [Span("graphs.clone", r, 0, 10_000) for r in range(3)]
    recs += [Span("tx.fec", 5, 0, 10**9)]  # a request outside the pass
    ctx = {"span_records": recs, "span_calls": 3}
    for i, name in enumerate(STAGES):
        assert read(name, ctx) == pytest.approx(0.1 * (i + 1) * 2)  # (1 + 2 + 3) / 3
    assert read("graph_io_ms.link", ctx) == pytest.approx(0.05)


def test_readers_without_spans_or_calls_return_none():
    ctx = {"span_records": None, "span_calls": 0}
    assert all(read(name, ctx) is None for name in [*STAGES, "graph_io_ms.link"])
    assert read("map_idle_slots_per_call.link", {"calls": 0}) is None


def test_a_traced_pass_of_a_small_cell(tmp_path):
    """On the CPU (the stages on the host's clock): every stage reader has a
    number, the pass leaves the driver's info and steps as it found them,
    and runs once; the idle slots are a count of the window's calls."""
    from srslte_emane_tpu_torch.ops.fec import turbodecoder

    root = small_tree.make(tmp_path)
    cell = harness.load_cell(root, "small_cell")
    drv = cell.system.Driver(cell.config, cell.traffic, 2 ** 31 + 3, torch.device("cpu"))
    drv.warm(drv.program())
    drv.counters_reset()
    for c in range(2):
        drv.call(c)
    ctx = dict(drv.counters(), calls=2, driver=drv)
    info = drv.info()
    idle = read("map_idle_slots_per_call.link", ctx)
    assert idle == (turbodecoder.read_map_slots() - turbodecoder.read_map_passes()) / 2
    assert 0 <= idle < 2 * 16  # two decodes of 16 slots a call (15 PRB: two code-block sizes)
    t0 = time.perf_counter()
    got = {name: read(name, ctx) for name in STAGES}
    assert all(v > 0 for v in got.values()), got
    assert read("graph_io_ms.link", ctx) is None  # no graph off the card
    assert drv.info() == info and drv.encode is None
    again = time.perf_counter()
    assert spans.traced(ctx)[1] == drv.trace_calls  # the pass ran once: cached in ctx
    assert time.perf_counter() - again < 0.1 * (again - t0)
