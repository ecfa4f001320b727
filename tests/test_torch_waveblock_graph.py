"""The dynamic block's rounds as a replayed CUDA graph, on the CPU
(runtime/waveblock_dyn.make_dyn_block_step's jit=, runtime/graphs.py,
phch/sch.decode_tb's read=False, the tables the round now reads from
caches, and how chip_smoke.py's logs count a graph's replays).

Port alone: no JAX function is compiled here.  The configurations are
tests/test_torch_waveblock.py's 15 PRB dynamic-block cases (`clean`: R=2,
`harq`: R=5, UE 0 at 8 dB with MCS 16 retransmissions, UE 1 at -6 dB
missing every DCI), whose parity with the JAX block that file holds.  On
the CPU there is no graph: jit=True must change nothing, a stubbed card
must reach the capture and raise there without running any round, and the
capture's bookkeeping (launch counts times replays) is held with
torch.cuda's graph and stream objects replaced by stand-ins.  The
graph itself, bit for bit against the eager block, is in
tests/test_torch_cuda.py (marked `cuda`).
"""

import contextlib
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from srslte_emane_tpu_torch.ops import ofdm, sequence
from srslte_emane_tpu_torch.ops.fec import convcoder, crc, rm_turbo, turbo, turbodecoder
from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda, viterbi, viterbi_cuda
from srslte_emane_tpu_torch.phch import sch
from srslte_emane_tpu_torch.runtime import graphs, waveblock, waveblock_dyn as wbd
from srslte_emane_tpu_torch.scripts import bench_extra
from srslte_emane_tpu_torch.utils import devices

from test_torch_waveblock import DYN_CASES, _dyn_cfgs, _dyn_inputs

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker


def _sch_cfgs(cfg):
    """The block's DL and UL transport-block configurations."""
    qm_d, qm_u = wbd.ra.dl_mcs_to_qm(cfg.dl_mcs), wbd.ra.ul_mcs_to_qm(cfg.ul_mcs)
    n_re_d = len(wbd._dl_base_idx(cfg))
    return (sch.SchConfig(tbs=cfg.dl_tbs, G=n_re_d * qm_d, Qm=qm_d, Nl=1),
            sch.SchConfig(tbs=cfg.ul_tbs, G=12 * cfg.ul_l_prb * 12 * qm_u, Qm=qm_u, Nl=1))


@pytest.mark.parametrize("llr_bits", [32, 16])
@pytest.mark.parametrize("case", list(DYN_CASES))
def test_read_free_decode_tb_equals_decode_tb(case, llr_bits):
    """At the block's DL and UL shapes (8 processes x 2 UEs): a first
    transmission into empty soft buffers, then a retransmission at each
    row's next RV combined into them, at an SNR where some rows fail (the
    harq case's 8 dB UE); bits, CRC flags, soft buffers equal, and n_iter
    a 0-d tensor equal to decode_tb's int."""
    cfg, _ = _dyn_cfgs(**DYN_CASES[case])
    rng = np.random.default_rng(len(case) + llr_bits)
    B = wbd.N_PID * cfg.n_ues
    sigma = 1.0 if case == "harq" else 0.8
    sdt = torch.bfloat16 if llr_bits == 16 else torch.float32
    for c in _sch_cfgs(cfg):
        bits = torch.from_numpy(rng.integers(0, 2, (B, c.tbs), dtype=np.int8))
        soft = {k: sch.init_softbuffer(B, c, sdt) for k in ("host", "device")}
        oks = []
        for rv in (torch.zeros(B, dtype=torch.int64),
                   torch.from_numpy(wbd.RV_SEQ[1 + rng.integers(0, 3, B)]).long()):
            cw = sch.encode_tb(bits, c, rv_b=rv).float()
            llr = (1 - 2 * cw) + torch.from_numpy(
                rng.normal(0, sigma, cw.shape).astype(np.float32))
            kw = dict(rv_b=rv, llr_bits=llr_bits)
            out, ok, soft["host"], n_iter = sch.decode_tb(llr, c, softbuf=soft["host"], **kw)
            d_out, d_ok, soft["device"], d_iter = sch.decode_tb(
                llr, c, softbuf=soft["device"], read=False, **kw)
            assert isinstance(n_iter, int) and torch.is_tensor(d_iter) and d_iter.ndim == 0
            assert int(d_iter) == n_iter
            assert torch.equal(d_out, out) and torch.equal(d_ok, ok)
            for a, b in zip(soft["device"], soft["host"]):
                assert a.dtype == sdt and torch.equal(a, b)
            oks.append(ok)
        if case == "harq":  # the case does what it is for: failures, then recoveries
            assert not oks[0].all() and oks[1].sum() > oks[0].sum(), oks


def _run(cfg, jit, gen_seed=7, n_cells=1):
    dl_q, ul_q, rb_dl, rb_ul = _dyn_inputs(cfg)
    gen = torch.Generator()
    gen.manual_seed(gen_seed)
    step = wbd.make_dyn_block_step(cfg, device="cpu", jit=jit)
    return step(dl_q, ul_q, rb_dl, rb_ul, gen, 16), gen


@pytest.mark.parametrize("case", list(DYN_CASES))
def test_jit_changes_nothing_off_the_card(case):
    """jit=True and jit=False: every output equal, and each leaves its
    generator in the same state."""
    cfg, _ = _dyn_cfgs(**DYN_CASES[case])
    (a, gen_a), (b, gen_b) = _run(cfg, True), _run(cfg, False)
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
    assert torch.equal(gen_a.get_state(), gen_b.get_state())
    assert a["dl_new"].shape == (cfg.R, wbd.N_PID, cfg.n_ues)


def test_a_drop_needs_a_fourth_failed_transmission():
    """The harq case's UE 1 (-6 dB) misses every DCI, so its processes
    retransmit after each failure and drop only after the fourth
    transmission (max_tx): 3 rounds retransmit 24 times and drop nothing,
    4 rounds drop.  (A 2-cell harq block at R=3 shows no drop in either
    cell for this reason, not for a fault of the cells axis.)"""
    counts = {}
    for R in (3, 4):
        cfg, _ = _dyn_cfgs(**{**DYN_CASES["harq"], "R": R})
        out, _ = _run(cfg, False, gen_seed=11)
        counts[R] = int(out["dl_retx_tx"]), int(out["dl_drop"])
    assert counts[3] == (24, 0) and counts[4][1] > 0, counts


def _counting_randn(calls):
    randn = waveblock._randn

    def counted(gen, shape, device):
        calls.append(tuple(shape))
        return randn(gen, shape, device)
    return counted


@pytest.mark.parametrize("hook", ["raises", "cpu_torch"])
def test_a_failed_capture_raises_and_runs_no_round(hook, monkeypatch):
    """On a stubbed card (turbodecoder_cuda._on_card) the step goes to the
    capture: a capture hook that raises (or, unpatched, torch.cuda's own
    objects in a build without CUDA) makes the step raise, and no round
    runs eagerly in its place."""
    cfg, _ = _dyn_cfgs(R=2)
    calls = []
    monkeypatch.setattr(turbodecoder_cuda, "_on_card", lambda t, device: True)
    monkeypatch.setattr(waveblock, "_randn", _counting_randn(calls))
    if hook == "raises":
        def capture(*a, **kw):
            raise RuntimeError("capture failed")
        monkeypatch.setattr(graphs, "RoundGraph", capture)
    if hook == "cpu_torch" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    step = wbd.make_dyn_block_step(cfg, device="cpu")
    dl_q, ul_q, rb_dl, rb_ul = _dyn_inputs(cfg)
    with pytest.raises(Exception) as err:
        step(dl_q, ul_q, rb_dl, rb_ul, torch.Generator(), 0)
    if hook == "raises":
        assert "capture failed" in str(err.value)
    assert calls == []  # no round ran, not even a warm-up
    step_eager = wbd.make_dyn_block_step(cfg, device="cpu", jit=False)
    step_eager(dl_q, ul_q, rb_dl, rb_ul, torch.Generator(), 0)
    assert len(calls) == 5 * cfg.R  # five draws per round, eagerly


class _FakeCuda:
    """Stand-ins for torch.cuda's stream and graph objects: a capture runs
    its Python once and a replay runs nothing, as on the card (where the
    replay runs the kernels and no Python)."""

    capturing = False

    class Stream:
        def __init__(self, *a, **kw):
            pass

        def wait_stream(self, other):
            pass

    class CUDAGraph:
        def __init__(self):
            self.generators, self.replays = [], 0

        def register_generator_state(self, gen):
            self.generators.append(gen)

        def pool(self):
            return None

        def replay(self):
            self.replays += 1

    @staticmethod
    def current_stream(*a):
        return _FakeCuda.Stream()

    @staticmethod
    def stream(s):
        return contextlib.nullcontext()

    @staticmethod
    @contextlib.contextmanager
    def graph(g, pool=None):
        _FakeCuda.capturing = True
        try:
            yield
        finally:
            _FakeCuda.capturing = False

    @staticmethod
    def is_current_stream_capturing():
        return _FakeCuda.capturing


def _fake_cuda(monkeypatch):
    for name in ("Stream", "CUDAGraph", "current_stream", "stream", "graph",
                 "is_current_stream_capturing"):
        monkeypatch.setattr(torch.cuda, name, getattr(_FakeCuda, name))


def test_replays_add_what_the_capture_counted(monkeypatch):
    """RoundGraph's bookkeeping: the warm-up's launches count, the
    capture's are taken back, and each run of n replays adds n times what
    the capture counted to the wrappers' counts; the generators' states go
    in and come back."""
    _fake_cuda(monkeypatch)
    monkeypatch.setattr(turbodecoder_cuda, "launches", 0)
    monkeypatch.setattr(viterbi_cuda, "launches", 0)
    rounds = []

    def body(gens):  # what a round's kernel wrappers count, at each Python run
        rounds.append(len(gens))
        turbodecoder_cuda.launches += 16
        viterbi_cuda.launches += 1

    g = graphs.RoundGraph(body, lambda: None, 2, torch.device("cpu"))
    assert rounds == [2, 2]  # the warm-up and the capture
    assert (turbodecoder_cuda.launches, viterbi_cuda.launches) == (16, 1)  # the warm-up's
    assert len(g.graph.generators) == 2 and g.graph.replays == 0
    gens = [torch.Generator(), torch.Generator()]
    gens[1].manual_seed(3)
    states = [x.get_state() for x in gens]
    g.run(5, gens)
    assert g.graph.replays == 5 and g.reset.replays == 1 and rounds == [2, 2]
    assert (turbodecoder_cuda.launches, viterbi_cuda.launches) == (16 + 80, 1 + 5)
    assert all(torch.equal(x.get_state(), s) for x, s in zip(gens, states))
    assert torch.equal(g.gens[1].get_state(), states[1])
    g.run(2, gens)
    assert turbodecoder_cuda.launches == 96 + 32 and viterbi_cuda.launches == 6 + 2


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_logs_count_replays(monkeypatch):
    """chip_smoke.py's logs count a replayed round as the kernels' counts
    do: an update made while a stream captures is held back (log_update),
    and with count_replays_in_logs each RoundGraph.run(n) makes the
    capture's updates n times; outside a capture an update is made at
    once."""
    cs = _chip_smoke()
    _fake_cuda(monkeypatch)
    for name in ("__init__", "run"):  # put back after the test
        monkeypatch.setattr(graphs.RoundGraph, name, getattr(graphs.RoundGraph, name))
        monkeypatch.setattr(graphs.StepGraph, name, getattr(graphs.StepGraph, name))
    cs.count_replays_in_logs()
    log = []
    body = lambda gens: cs.log_update(lambda: log.append(len(gens)))
    g = graphs.RoundGraph(body, lambda: None, 3, torch.device("cpu"))
    assert log == [3] and len(g.log_updates) == 1 and cs.CAPTURED == []  # the warm-up's
    g.run(4, [torch.Generator()] * 3)
    assert log == [3] * 5
    cs.log_update(lambda: log.append(0))
    assert log == [3] * 5 + [0]


def test_device_table_caches_never_evict():
    """The caches of the tables that a round copies to the card never
    evict a table from under a graph that read it: a captured graph reads
    its tables by address at every replay.  Each is a bounded
    utils.devices.table_cache (unbounded, the keys of a network run grow
    with its grants), and a table it hands out inside `holding` (a
    capture) stays held after the cache lets it go."""
    caches = (ofdm._device_tables, sequence._device_tables, crc._device_matrix,
              crc.remainder_masks, viterbi._signs, turbo._device_tables, turbo._device_perm,
              rm_turbo._on_device, turbodecoder._tail_signs, turbodecoder._device_perms,
              convcoder._on_device, waveblock._time_weights)
    wrapper = devices.table_cache(1)(len).__code__  # the code of every table_cache's wrapper
    assert all(c.__code__ is wrapper for c in caches)
    assert all(c.cache_parameters()["maxsize"] is not None for c in caches)
    cpu = torch.device("cpu")
    turbodecoder._device_perms(40, cpu)  # made before the capture, as a warm-up makes it
    with devices.holding() as held:
        first = turbodecoder._device_perms(40, cpu)
    turbodecoder._device_perms.cache_clear()  # an eviction
    assert turbodecoder._device_perms(40, cpu) is not first and held[id(first)] is first


def test_host_loop_decode_stands_in_for_the_device_loop(monkeypatch):
    """scripts/bench_extra.host_loop_decode (the host-driven loop with
    turbo_decode_device's arguments and results) in turbo_decode_device's
    place, as bench_extra.plain_map and chip_smoke.py put it: decode_tb
    gives the same bits, CRC flags, soft buffers and iterations, and
    turbo_decode's MAP rows are the host loop's."""
    cfg, _ = _dyn_cfgs(**DYN_CASES["harq"])
    c = _sch_cfgs(cfg)[0]
    rng = np.random.default_rng(3)
    B = wbd.N_PID * cfg.n_ues
    bits = torch.from_numpy(rng.integers(0, 2, (B, c.tbs), dtype=np.int8))
    cw = sch.encode_tb(bits, c).float()
    sigma = np.where(np.arange(B) % 2, 1.2, 0.3)[:, None]  # every other row fails
    llr = (1 - 2 * cw) + torch.from_numpy((sigma * rng.normal(size=cw.shape)).astype(np.float32))
    want = sch.decode_tb(llr, c)
    monkeypatch.setattr(turbodecoder, "turbo_decode_device", bench_extra.host_loop_decode)
    got = sch.decode_tb(llr, c)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and got[3] == want[3]
    assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))
    assert not want[1].all() and want[1].any()  # some rows fail: the iterations differ by row
    k = c.segm.cb_sizes[0]
    d = [torch.from_numpy(rng.normal(0, 1.0, (4, k + 4)).astype(np.float32)) for _ in range(3)]
    valid = torch.ones(4, dtype=torch.bool)
    monkeypatch.setattr(turbodecoder, "map_rows", 0)
    n_iter = turbodecoder.turbo_decode(*d, valid, k)[2]
    rows = turbodecoder.map_rows
    turbodecoder.map_rows = 0
    assert turbodecoder.turbo_decode_host(*d, valid, k)[2] == n_iter
    assert turbodecoder.map_rows == rows > 0


def test_cached_tables_equal_the_uploads():
    """The convcoder and UL-estimate tables, now copied to a device once,
    equal the per-call uploads they replace, and come back as the same
    tensor; the rate matchers give what the per-call tables gave."""
    cpu = torch.device("cpu")
    rng = np.random.default_rng(5)
    for d, e in ((43, 72), (43, 144), (56, 576), (64, 36)):
        tx = convcoder._on_device(convcoder.cc_tx_table, d, e, cpu)
        rx = convcoder._on_device(convcoder.cc_rx_gather_table, d, e, cpu)
        assert torch.equal(tx, torch.from_numpy(convcoder.cc_tx_table(d, e).astype(np.int64)))
        assert torch.equal(rx, torch.from_numpy(
            convcoder.cc_rx_gather_table(d, e).astype(np.int64)))
        assert tx is convcoder._on_device(convcoder.cc_tx_table, d, e, cpu)
        streams = torch.from_numpy(rng.integers(0, 2, (3, 3, d), dtype=np.int8))
        assert torch.equal(convcoder.rate_match_cc(streams, e), streams.reshape(3, -1)[:, tx])
        llrs = torch.from_numpy(rng.normal(size=(3, e)).astype(np.float32))
        padded = torch.cat([llrs, llrs.new_zeros((3, 1))], dim=-1)
        assert torch.equal(convcoder.rate_unmatch_cc(llrs, d),
                           padded[:, rx].sum(-1).reshape(3, 3, d))
    t_w = waveblock._time_weights(cpu)
    want = (np.array(waveblock.pusch_mod.DATA_SYMS, np.float32) - 3.0) / 7.0
    assert torch.equal(t_w, torch.from_numpy(want)) and t_w is waveblock._time_weights(cpu)
