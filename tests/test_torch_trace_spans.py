"""The port's tracing (`utils/trace.py`) and the MAP slot counts on the CPU.

* the span store: nesting, parents, request ids, its wrap and its dump;
* `span` under an active `torch.profiler` is a range of its host
  timeline (not a user annotation), and nothing with tracing and the
  profiler off;
* the link's stages: a 6 PRB `tx_subframe` / `rx_subframe` with tracing on
  records `link.tx_subframe` / `link.rx_subframe` with their eight phases
  once each, in order, on the host clock; off, nothing; the outputs equal;
* the graphs layer on a stood-in card (tests/test_torch_waveblock_graph's
  `_fake_cuda`): a replay's host spans, and a graph captured with tracing
  on keyed apart from one captured with it off; eager stages there, whose
  groups wait unresolved in a bounded list;
* `map_passes` and `map_slots` on the plain decoder path against the host
  loop, the idle slots at high SNR and with every row failing, and their
  reset.
The card's half (stage events in a captured graph) is in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from srslte_emane_tpu_torch.models import pdsch_link
from srslte_emane_tpu_torch.ops.fec import crc as crc_mod, turbodecoder
from srslte_emane_tpu_torch.phch import grid
from srslte_emane_tpu_torch.runtime import graphs
from srslte_emane_tpu_torch.scripts import bench_extra
from srslte_emane_tpu_torch.utils import trace

from test_torch_waveblock_graph import _fake_cuda

STAGES = {"link.tx_subframe": ["tx.fec", "tx.map", "tx.ofdm"],
          "link.rx_subframe": ["rx.ofdm", "rx.chest", "rx.llr", "rx.turbo", "rx.tb"]}


@pytest.fixture(autouse=True)
def clean_trace():
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


def test_spans_nest_with_parents_and_requests():
    trace.enable(True)
    with trace.span("graphs.replay") as outer:
        with trace.request(7):
            with trace.span("graphs.load") as inner:
                pass
        with trace.span("graphs.launch"):
            pass
    with trace.request(8), trace.stage("link.tx_subframe", "cpu"):
        trace.phase("tx.fec")
        trace.phase("tx.map")
    got = trace.spans()
    assert [(s.name, s.parent, s.request) for s in got] == [
        ("graphs.replay", -1, -1), ("graphs.load", outer, 7), ("graphs.launch", outer, -1),
        ("link.tx_subframe", -1, 8), ("tx.fec", got[3].id, 8), ("tx.map", got[3].id, 8)]
    assert inner == got[1].id
    assert all(s.clock == "host" and 0 <= s.start_ns <= s.end_ns for s in got)
    assert got[4].end_ns <= got[5].start_ns <= got[5].end_ns <= got[3].end_ns


@pytest.mark.parametrize("capacity,n", [(4, 3), (4, 10), (16, 40)])
def test_store_wraps_and_dumps(tmp_path, capacity, n):
    """The newest `capacity` records are kept; a record that the wrap
    dropped is no longer written; dump and load round-trip."""
    tr = trace.Trace(capacity)
    ids = [tr.open(f"rx.{i % 5}", i - 1, i // 2, i % 2, 100 * i) for i in range(n)]
    for rid in ids:
        tr.close(rid, 100 * rid + 50)
    recs = tr.records()
    assert [r.id for r in recs] == ids[-capacity:]
    assert all(r.end_ns == 100 * r.id + 50 and r.clock == trace.CLOCKS[r.id % 2] for r in recs)
    tr.dump(str(tmp_path / "spans.bin"))
    assert trace.Trace.load(str(tmp_path / "spans.bin")) == recs
    tr.clear()
    assert tr.records() == [] and tr.open("tx.fec") == n


def test_module_dump_and_reset(tmp_path):
    trace.enable(True)
    with trace.span("graphs.replay"):
        pass
    trace.dump(str(tmp_path / "t.bin"))
    assert [s.name for s in trace.Trace.load(str(tmp_path / "t.bin"))] == ["graphs.replay"]
    trace.reset()
    assert trace.spans() == []


def test_span_is_a_profiler_range_only_under_the_profiler():
    """Under an active profiler a span is a host range of its timeline (no
    user annotation, which the profiler would copy onto the device's
    timeline); with tracing and the profiler off it is nothing."""
    from torch.profiler import ProfilerActivity, profile

    assert trace.span("graphs.replay") is trace._NULL
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("graphs.replay"):
            torch.ones(4).sum()
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "graphs.replay"]
    assert ev.device_type() == torch.autograd.DeviceType.CPU and not ev.is_user_annotation()
    assert ev.start_ns() < ev.end_ns()
    assert trace.spans() == []  # the store is off: the profiler alone saw it


def _link():
    cfg = pdsch_link.LinkConfig(cell=grid.CellConfig(n_prb=6), qm=6, code_rate=0.55,
                                llr_bits=16)
    payload = torch.from_numpy(np.random.default_rng(3).integers(
        0, 2, (2, cfg.tbs), dtype=np.int8))
    return cfg, payload


def _run_link(cfg, payload):
    tx = pdsch_link.tx_subframe(payload, cfg)
    out, ok, softbuf, ch = pdsch_link.rx_subframe(tx, cfg, use_kernel=True)
    return [tx, out, ok, *softbuf, ch.ce]


def test_link_stages_once_each_in_order():
    cfg, payload = _link()
    off = _run_link(cfg, payload)
    assert trace.spans() == []  # tracing off: nothing recorded
    trace.enable(True)
    with trace.request(5):
        on = _run_link(cfg, payload)
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    got = trace.spans()
    assert [s.name for s in got] == [n for parent, kids in STAGES.items() for n in [parent, *kids]]
    parents = {s.name: s for s in got if s.name in STAGES}
    for parent, kids in STAGES.items():
        spans = [s for s in got if s.name in kids]
        assert all(s.parent == parents[parent].id and s.request == 5 for s in spans)
        assert all(0 <= s.end_ns - s.start_ns for s in spans)
        assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))
        assert parents[parent].start_ns <= spans[0].start_ns
        assert spans[-1].end_ns <= parents[parent].end_ns


def test_phase_outside_a_stage_records_nothing():
    trace.enable(True)
    trace.phase("rx.turbo")
    assert trace.spans() == []


def test_graph_replays_are_spanned_and_traced_graphs_kept_apart(monkeypatch):
    _fake_cuda(monkeypatch)
    monkeypatch.setattr(graphs, "on_card", lambda dev: True)
    step = graphs.jit(lambda x: x * 2)
    x = torch.arange(4.0)
    step(x)
    assert trace.spans() == [] and len(step.graphs) == 1
    trace.enable(True)
    with trace.request(1):
        assert torch.equal(step(x), x * 2)  # captures a traced graph: no span kept
        assert torch.equal(step(x), x * 2)
    trace.enable(False)
    assert len(step.graphs) == 2 and sum(k[-1] == graphs.TRACED[0] for k in step.graphs) == 1
    step(x)  # off again: the first graph
    assert len(step.graphs) == 2
    host = [s for s in trace.spans() if s.clock == "host"]
    replay = host[0]
    assert replay.name == "graphs.replay" and replay.request == 1
    kids = [s.name for s in host if s.parent == replay.id]
    assert kids == ["graphs.load", "graphs.launch", "graphs.clone"]
    assert len([s for s in host if s.name == "graphs.replay"]) == 2  # the capture's call too


class _Event:
    """A stood-in timing event: its time is the order it was recorded in,
    a microsecond a step."""
    clock = 0

    def record(self):
        _Event.clock += 1
        self.t = _Event.clock

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e-3


def test_eager_stages_leave_a_bounded_list_of_groups(monkeypatch):
    """Eager stages on a stood-in card each time a group of their own; at
    most trace.PENDING of them wait unresolved (the oldest is resolved
    first), and `spans()` resolves the rest; off, `group` gives None."""
    _fake_cuda(monkeypatch)
    monkeypatch.setattr(trace, "_event", lambda external=False: _Event())
    with trace.group("cuda") as g:
        assert g is None
    trace.enable(True)
    n = 3 * trace.PENDING
    for i in range(n):
        with trace.request(i), trace.stage("tx.fec", "cuda"):
            pass
        assert len(trace._pending) <= trace.PENDING
    assert sum(s.start_ns >= 0 for s in trace._store.records()) == n - trace.PENDING
    got = trace.spans()
    assert [s.request for s in got] == list(range(n)) and trace._pending == []
    assert all(s.clock == "device" and (s.start_ns, s.end_ns) == (0, 1000) for s in got)


def test_round_graph_run_spans_each_round(monkeypatch):
    _fake_cuda(monkeypatch)
    g = graphs.RoundGraph(lambda gens: None, lambda: None, 1, torch.device("cpu"))
    trace.enable(True)
    g.run(3, [torch.Generator()])
    got = trace.spans()
    assert [s.name for s in got] == ["graphs.replay"] + ["graphs.launch"] * 3
    assert all(s.parent == got[0].id for s in got[1:])


def _blocks(k, B, snr_db, seed):
    """B code blocks of size k with a CRC24B each, BPSK over AWGN at snr_db:
    the decoder's three LLR streams."""
    from srslte_emane_tpu_torch.ops.fec import turbo

    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (B, k - 24), dtype=np.int8)
    bits = crc_mod.crc_attach(torch.from_numpy(bits), crc_mod.LTE_CRC24B)
    sigma = 10 ** (-snr_db / 20)
    return [(1 - 2 * d.float()) + sigma * torch.from_numpy(
        rng.normal(size=d.shape).astype(np.float32)) for d in turbo.turbo_encode(bits)]


@pytest.mark.parametrize("snr_db", [6.0, -6.0])
def test_map_passes_and_slots_match_the_host_loop(snr_db):
    """The device loop's plain path (turbo_decode, and decode_tb's
    read-free count) counts the passes that the host loop runs and 2 *
    max_iter slots a decode; at high SNR most slots are idle, with every
    row failing none is."""
    k, B, max_iter = 512, 8, 8
    d = _blocks(k, B, snr_db, 11)
    valid = torch.ones(B, dtype=torch.bool)
    counts = []
    for decode in (turbodecoder.turbo_decode, turbodecoder.turbo_decode_host,
                   lambda *a, **kw: turbodecoder.turbo_decode(*a, read=False, **kw)):
        turbodecoder.reset_map_rows()
        ok = decode(*d, valid, k, max_iter, crc_mod.LTE_CRC24B, use_kernel=False)[1]
        counts.append((turbodecoder.read_map_rows(), turbodecoder.read_map_passes(),
                       turbodecoder.read_map_slots()))
    assert counts[0] == counts[1] == counts[2]
    rows, passes, slots = counts[0]
    assert slots == 2 * max_iter and rows >= passes > 0
    idle = slots - passes
    if snr_db > 0:
        assert bool(ok.all()) and idle == 2 * max_iter - passes >= 2 * max_iter - 4
    else:
        assert not bool(ok.any()) and idle == 0


def test_read_free_decodes_count_in_a_stand_in_loop(monkeypatch):
    """The host loop in turbo_decode_device's place (bench_extra) counts its
    passes and slots on the host and hands back zero device counts:
    read_map_rows folds nothing more."""
    monkeypatch.setattr(turbodecoder, "turbo_decode_device", bench_extra.host_loop_decode)
    k, B = 512, 8
    d = _blocks(k, B, 6.0, 12)
    turbodecoder.reset_map_rows()
    turbodecoder.turbo_decode(*d, torch.ones(B, dtype=torch.bool), k, 4, crc_mod.LTE_CRC24B,
                              use_kernel=False, read=False)
    assert turbodecoder.read_map_slots() == 8 and 0 < turbodecoder.read_map_passes() < 8


def test_reset_zeroes_the_three_counts():
    k, B = 512, 8
    turbodecoder.turbo_decode(*_blocks(k, B, -6.0, 13), torch.ones(B, dtype=torch.bool), k, 2,
                              crc_mod.LTE_CRC24B, use_kernel=False, read=False)
    assert turbodecoder.read_map_slots() > 0 and turbodecoder.read_map_passes() > 0
    turbodecoder.reset_map_rows()
    assert (turbodecoder.read_map_rows(), turbodecoder.read_map_passes(),
            turbodecoder.read_map_slots()) == (0, 0, 0)
