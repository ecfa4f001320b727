"""The port's `jax.jit` (runtime/graphs.jit and StepGraph) on the CPU: the
link step, the CA step and the SPS block and bench steps, the TTI as a
device input of the block, `sch.decode_tb(read=False)` at the decode call
sites and the MAP-row counts on the device, and the table caches that hand
a captured graph its tables: a capture reads every table its warm-up was
handed, past the cache's bound, and raises on a key the warm-up never
asked for.

On the CPU there is no graph: every graphed step must equal its eager
step (`link_step`, `waveblock._step_body`) exactly.  The block with tti0
given as a 0-d tensor is held against the JAX block at two TTIs in
tests/test_torch_waveblock.py (test_sps_block_equal and
test_sps_block_at_a_second_tti, on its compile of the block).  StepGraph's
bookkeeping is held with torch.cuda's graph and stream objects replaced by
the stand-ins of tests/test_torch_waveblock_graph.py.  The graphs
themselves, bit for bit against the eager steps, are in
tests/test_torch_cuda.py (marked `cuda`).
"""

import dataclasses

import numpy as np
import pytest
import torch

from srslte_emane_tpu_torch.models import enb_dl, pdsch_link as p_link
from srslte_emane_tpu_torch.ops import channel, mimo, ofdm, scrambling, sequence
from srslte_emane_tpu_torch.ops.fec import convcoder, crc, rm_turbo, turbo, turbodecoder
from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda, viterbi, viterbi_cuda
from srslte_emane_tpu_torch.phch import chest, grid as p_grid, pcfich, pdcch, pdsch, pmch, pucch
from srslte_emane_tpu_torch.phch import pusch, sch, sync
from srslte_emane_tpu_torch.runtime import graphs, waveblock as p_wb
from srslte_emane_tpu_torch.scripts import bench_extra
from srslte_emane_tpu_torch.utils import devices

from test_torch_waveblock import _sps_cfgs, _sps_payloads
from test_torch_waveblock_graph import _FakeCuda, _chip_smoke, _fake_cuda

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

CPU = torch.device("cpu")


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _link_cfg(snr_db=30.0):
    """tests/test_torch_link.py's 6 PRB QPSK link at llr_bits=16."""
    return p_link.LinkConfig(cell=p_grid.CellConfig(n_prb=6, cell_id=1, cfi=2), qm=2,
                             code_rate=0.5, snr_db=snr_db, sf_idx=1, llr_bits=16)


def _equal(a, b):
    a = a if isinstance(a, dict) else dict(enumerate(a))
    b = b if isinstance(b, dict) else dict(enumerate(b))
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------- off the card: every graphed step is its eager step ----------------

def _link_case(kind):
    """(graphed step, eager step, inputs without the generator)."""
    cfg = _link_cfg()
    rng = np.random.default_rng(4)
    if kind == "link":
        payload = torch.from_numpy(rng.integers(0, 2, (3, cfg.tbs), dtype=np.int8))
        return (p_link.make_link_step(cfg),
                lambda p, g: p_link.link_step(p, g, cfg), (payload,))
    payloads = torch.from_numpy(rng.integers(0, 2, (2, 3, cfg.tbs), dtype=np.int8))

    def ca(p, g):  # carrier i: a cell with cell_id + 3 i, noise in carrier order
        outs = [p_link.link_step(p[i], g, dataclasses.replace(cfg, cell=dataclasses.replace(
            cfg.cell, cell_id=cfg.cell.cell_id + 3 * i))) for i in range(2)]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    return p_link.make_ca_link_step(cfg, 2), ca, (payloads,)


@pytest.mark.parametrize("kind", ["link", "ca"])
def test_link_steps_equal_link_step_off_the_card(kind):
    """make_link_step and make_ca_link_step (jit on, their default) on CPU
    tensors are link_step: every output equal, the generator left in the
    same state, every CRC passing."""
    step, eager, ins = _link_case(kind)
    g_a, g_b = _gen(3), _gen(3)
    a, b = step(*ins, g_a), eager(*ins, g_b)
    _equal(a, b)
    assert torch.equal(g_a.get_state(), g_b.get_state())
    assert bool(a[1].all()) and torch.equal(a[0], ins[0])
    assert step.graphs == {}  # nothing captured off the card


@pytest.mark.parametrize("tm3", [False, True], ids=["siso", "tm3"])
def test_block_steps_equal_the_step_body_off_the_card(tm3):
    """make_block_step and make_bench_step (jit on) on the CPU are
    _step_body on the block's tables: every output equal, the counts those
    of its outputs, the generator left in the same state; tti0 as an int
    and as a 0-d tensor give the same block."""
    p_cfg, _ = _sps_cfgs(tm3)
    dl, ul = (torch.from_numpy(a) for a in _sps_payloads(p_cfg, 0))
    consts = p_wb._on(p_wb._cell_consts(p_cfg, 12), CPU)
    step = p_wb.make_block_step(p_cfg, sfn0=12, device="cpu")
    bench = p_wb.make_bench_step(p_cfg, sfn0=12, device="cpu")
    g = [_gen(5) for _ in range(4)]
    got = step(dl, ul, g[0], 120)
    want = p_wb._step_body(p_cfg, consts, dl, ul, g[1], 120)
    _equal(got, want)
    _equal(step(dl, ul, _gen(5), torch.tensor(120)), want)
    assert torch.equal(g[0].get_state(), g[1].get_state())
    counts = bench(dl, ul, g[2], 120)
    dl_ok = want["dl_ok_cw"] if tm3 else want["dl_ok"]
    assert [int(c) for c in counts] == [int(dl_ok.sum()), int(want["ul_ok"].sum()),
                                       int((want["ack_energy"] > 1e-2).sum())]
    assert int(counts[0]) == p_cfg.T * p_cfg.n_ues * (2 if tm3 else 1)
    assert step.graphs == bench.graphs == {}


def test_plain_decoder_and_jit_false_steps_are_eager():
    """make_block_step(jit=False), and use_kernel=False (the plain decoder,
    whose loop reads on the host), give the eager steps: no graphs.jit
    wrapper."""
    cfg = _link_cfg()
    assert not hasattr(p_link.make_link_step(cfg, use_kernel=False), "graphs")
    assert not hasattr(p_link.make_ca_link_step(cfg, 2, use_kernel=False), "graphs")
    assert hasattr(p_link.make_link_step(cfg), "graphs")
    p_cfg, _ = _sps_cfgs(False)
    assert not hasattr(p_wb.make_block_step(p_cfg, device="cpu", jit=False), "graphs")
    assert not hasattr(p_wb.make_bench_step(p_cfg._replace(use_kernel=False), device="cpu"),
                       "graphs")
    assert hasattr(p_wb.make_bench_step(p_cfg, device="cpu"), "graphs")


# ---------------- decode_tb(read=False) at the decode call sites ----------------

def _tm3_grids(B, seed):
    """A 6 PRB 2x2 TM3 subframe at 12 dB through a random flat channel:
    (cell, mask, cfgs, rx grids (B, 2, 14, NRE, 2))."""
    cell = p_grid.CellConfig(n_prb=6, cell_id=7, n_ports=2, cfi=2)
    mask = (1,) * 6
    n_re = p_grid.nof_re(cell, 1, mask)
    cfg = sch.SchConfig(tbs=(int(n_re * 2 * 0.5) - 24) // 8 * 8, G=n_re * 2, Qm=2, Nl=1)
    rng = np.random.default_rng(seed)
    tbs = [torch.from_numpy(rng.integers(0, 2, (B, cfg.tbs), dtype=np.int8)) for _ in range(2)]
    tx = ofdm.modulate(pdsch.encode_tm(tbs, [cfg, cfg], cell, 1, 0x46, mask, "tm3"), 6)
    h = torch.from_numpy(rng.normal(0, np.sqrt(0.5), (B, 2, 2, 2)).astype(np.float32))
    rx = channel.mimo_flat(_gen(seed), tx, h, 12.0)
    return cell, mask, [cfg, cfg], ofdm.demodulate(rx, 6)


def _pusch_case(uci):
    """tests/test_torch_uplink.py's UCI case (25 PRB, l_prb 8, QPSK), its
    two rows at 10 and -12 dB (over the whole band: the allocation is a
    third of it): the decode call of pusch.decode."""
    cell = p_grid.CellConfig(n_prb=25, cell_id=42)
    sf_idx, rnti, rb_start, l_prb, qm = 2, 0x5A, 0, 8, 2
    rng = np.random.default_rng(6)
    dims = pusch.uci_dims(l_prb, qm, 1, 1, 6)
    g_data = dims[3] if uci else 12 * 12 * l_prb * qm
    cfg = sch.SchConfig(tbs=max(8, (int(g_data * 0.4) - 24) // 8 * 8), G=g_data, Qm=qm, Nl=1)
    payload = torch.from_numpy(rng.integers(0, 2, (2, cfg.tbs), dtype=np.int8))
    bits = (dict(ack=torch.ones((2, 1), dtype=torch.int8), ri=torch.zeros((2, 1), dtype=torch.int8),
                 cqi=torch.from_numpy(rng.integers(0, 2, (2, 6), dtype=np.int8))) if uci else None)
    g = pusch.encode(payload, cfg, cell, sf_idx, rnti, rb_start, l_prb, uci=bits)
    rx = channel.awgn(_gen(6), ofdm.modulate(g, 25), torch.tensor([10.0, -12.0]))
    kw = dict(uci_dims_in=dims[:3] + (1, 1, 6)) if uci else {}
    return lambda: pusch.decode(ofdm.demodulate(rx, 25), cfg, cell, sf_idx, rnti, rb_start,
                                l_prb, llr_bits=16, **kw)


def _site(name):
    """A call that reaches one changed decode_tb call site."""
    if name == "pdsch.decode":  # pdsch.py, via the link's receiver; two of four rows fail
        cfg = _link_cfg()
        payload = torch.from_numpy(np.random.default_rng(2).integers(0, 2, (4, cfg.tbs),
                                                                     dtype=np.int8))
        rx = channel.awgn(_gen(2), p_link.tx_subframe(payload, cfg),
                          torch.tensor([30.0, -3.0, 30.0, -6.0]))
        return lambda: p_link.rx_subframe(rx, cfg)[:3]
    if name.startswith("pdsch.decode_tm"):  # both codewords in one call, or one each
        cell, mask, cfgs, grids = _tm3_grids(3, 8)
        soft = ([None, sch.init_softbuffer(3, cfgs[1], torch.bfloat16)]
                if name.endswith("per_codeword") else None)
        return lambda: pdsch.decode_tm(grids, cfgs, cell, 1, 0x46, mask, "tm3", softbufs=soft,
                                       llr_bits=16)
    if name.startswith("pusch.decode"):
        return _pusch_case(uci=name.endswith("uci"))
    tm3 = name.endswith("tm3")  # the SPS block's three decodes (DL, TM3's two codewords, UL)
    p_cfg = _sps_cfgs(tm3)[0]._replace(snr_db=(30.0, -2.0))  # UE 1's DL fails
    dl, ul = _sps_payloads(p_cfg, 3)
    step = p_wb.make_block_step(p_cfg, sfn0=12, device="cpu")
    return lambda: step(dl, ul, _gen(9), 30)


SITES = ["pdsch.decode", "pdsch.decode_tm", "pdsch.decode_tm_per_codeword", "pusch.decode",
         "pusch.decode_uci", "waveblock", "waveblock_tm3"]


def _flat(x):
    """The tensors of a nested result, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flat(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flat(v)]
    return []


@pytest.mark.parametrize("site", SITES)
def test_read_free_call_sites_equal_and_count_rows(site, monkeypatch):
    """Each call site now passes read=False: its bits, CRC flags, soft
    buffers and every other output equal those with decode_tb forced to
    read (the old call), and the MAP rows that decode_tb counts on the
    device (turbodecoder.read_map_rows) equal those the host loop counts on
    the host for the same decodes."""
    call = _site(site)
    decode_tb, reads = sch.decode_tb, []

    def spy(*a, read=True, **kw):
        reads.append(read)
        return decode_tb(*a, read=read, **kw)

    def reading(*a, read=True, **kw):
        return decode_tb(*a, read=True, **kw)

    monkeypatch.setattr(sch, "decode_tb", spy)
    turbodecoder.reset_map_rows()
    got = call()
    rows = turbodecoder.read_map_rows()
    assert reads and not any(reads), reads
    monkeypatch.setattr(sch, "decode_tb", reading)
    want = call()
    a, b = _flat(got), _flat(want)
    assert len(a) == len(b) > 0
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    monkeypatch.setattr(turbodecoder, "turbo_decode_device", bench_extra.host_loop_decode)
    turbodecoder.reset_map_rows()
    call()
    assert turbodecoder.map_rows == rows > 0
    assert turbodecoder.read_map_rows() == rows  # the host loop counted nothing on the device
    oks = torch.cat([t.reshape(-1) for t in a if t.dtype == torch.bool])
    assert bool(oks.any()) and not bool(oks.all())  # rows that pass and rows that fail


def test_map_rows_counts_fold_and_reset():
    """count_map adds passes and rows on their device; read_map_rows folds
    the counts into map_passes and map_rows once and zeroes them;
    reset_map_rows zeroes them all and map_slots."""
    turbodecoder.reset_map_rows()
    turbodecoder.map_rows = 5
    turbodecoder.map_slots = 32
    turbodecoder.count_map(torch.tensor([2, 7], dtype=torch.int32))
    turbodecoder.count_map(torch.tensor([1, 3], dtype=torch.int32))
    assert turbodecoder.read_map_rows() == 15 and turbodecoder.read_map_rows() == 15
    assert turbodecoder.read_map_passes() == 3 and turbodecoder.read_map_slots() == 32
    turbodecoder.count_map(torch.tensor([1, 2], dtype=torch.int32))
    turbodecoder.reset_map_rows()
    assert turbodecoder.read_map_rows() == 0
    assert turbodecoder.read_map_passes() == turbodecoder.read_map_slots() == 0


# ---------------- StepGraph's bookkeeping, torch.cuda stood in for ----------------

class _Graph(_FakeCuda.CUDAGraph):
    """A stand-in graph whose replay draws once from each registered
    generator, as a captured step's randn advances it on the card."""

    def replay(self):
        super().replay()
        for g in self.generators:
            torch.randn(1, generator=g)


def _fake_card(monkeypatch):
    _fake_cuda(monkeypatch)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(graphs, "on_card", lambda dev: True)
    monkeypatch.setattr(turbodecoder_cuda, "launches", 0)
    monkeypatch.setattr(viterbi_cuda, "launches", 0)


def _counting_step(runs):
    """A step that records each Python run and counts 16 turbo_map and 1
    Viterbi launches in it, as the kernels' wrappers would."""
    def fn(x, gen, scale, mode):
        runs.append((x.clone(), scale.clone() if torch.is_tensor(scale) else scale, mode))
        turbodecoder_cuda.launches += 16
        viterbi_cuda.launches += 1
        return {"y": x * scale + torch.randn(x.shape, generator=gen), "n": (x.sum(),)}
    return fn


def test_one_capture_per_signature(monkeypatch):
    """A capture (a warm-up and a captured run) for the first call of each
    signature, none after it: the tensors' shape and dtype, a number's type
    and a static argument make the key."""
    _fake_card(monkeypatch)
    runs = []
    step = graphs.jit(_counting_step(runs), CPU)
    x = torch.ones(3)
    step(x, _gen(1), 2.0, "a")
    assert len(runs) == 2 and len(step.graphs) == 1
    step(x + 1, _gen(2), 3.0, "a")
    step(np.ones(3, np.float32), _gen(3), 3.0, "a")  # numpy: the tensor it becomes
    assert len(runs) == 2 and len(step.graphs) == 1
    for args in ((torch.ones(4), _gen(1), 2.0, "a"), (torch.ones(3, dtype=torch.float64),
                                                     _gen(1), 2.0, "a"),
                 (x, _gen(1), 2, "a"), (x, _gen(1), 2.0, "b")):
        n = len(runs)
        step(*args)
        assert len(runs) == n + 2
    assert len(step.graphs) == 5
    (g,) = [g for k, g in step.graphs.items() if k[3] == ("static", "b")]
    assert g.inputs[3] == "b"  # a static argument reaches the step as it is


def test_arguments_are_copied_into_the_static_inputs(monkeypatch):
    """A replay reads the static inputs, which each call loads: tensors
    (numpy arrays too) copied, numbers filled into a 0-d tensor."""
    _fake_card(monkeypatch)
    runs = []
    step = graphs.jit(_counting_step(runs), CPU)
    step(torch.zeros(3), _gen(1), 2.0, "a")
    (g,) = step.graphs.values()
    assert runs[-1][0] is not None and torch.equal(runs[-1][0], torch.zeros(3))
    assert g.inputs[0].shape == (3,) and g.inputs[2].shape == () and g.inputs[2].dtype == \
        torch.float32
    step(torch.arange(3.0), _gen(1), 5.0, "a")
    assert torch.equal(g.inputs[0], torch.arange(3.0)) and float(g.inputs[2]) == 5.0
    step(np.full(3, 7.0, np.float32), _gen(1), 0.5, "a")
    assert torch.equal(g.inputs[0], torch.full((3,), 7.0)) and float(g.inputs[2]) == 0.5
    assert len(runs) == 2  # the replays ran no Python of the step


def test_generator_states_round_trip(monkeypatch):
    """The caller's generator state goes into the graph's generator before
    the replay and comes back advanced by the replay's draws; each call may
    bring a new generator object."""
    _fake_card(monkeypatch)
    step = graphs.jit(_counting_step([]), CPU)
    step(torch.ones(2), _gen(1), 1.0, "a")
    (g,) = step.graphs.values()
    assert len(g.graph.generators) == 1 and g.graph.generators[0] is g.gens[0]
    for seed in (5, 6):
        mine, ref = _gen(seed), _gen(seed)
        step(torch.ones(2), mine, 1.0, "a")
        torch.randn(1, generator=ref)
        assert torch.equal(mine.get_state(), ref.get_state())
        assert torch.equal(g.gens[0].get_state(), ref.get_state())


def test_outputs_are_clones(monkeypatch):
    """Each call returns new tensors equal to the static outputs, in the
    step's structure; a later call leaves an earlier call's outputs alone."""
    _fake_card(monkeypatch)
    step = graphs.jit(_counting_step([]), CPU)
    out = step(torch.ones(2), _gen(1), 1.0, "a")
    (g,) = step.graphs.values()
    assert set(out) == {"y", "n"} and isinstance(out["n"], tuple)
    assert torch.equal(out["y"], g.outputs["y"]) and out["y"] is not g.outputs["y"]
    assert out["y"].data_ptr() != g.outputs["y"].data_ptr()
    keep = out["y"].clone()
    g.outputs["y"].add_(1.0)  # what the next replay does to the static outputs
    assert torch.equal(out["y"], keep)


def test_launch_counts_are_the_capture_times_the_calls(monkeypatch):
    """The warm-up's launches count, the capture's are taken back, and each
    call adds what the capture counted."""
    _fake_card(monkeypatch)
    step = graphs.jit(_counting_step([]), CPU)
    step(torch.ones(2), _gen(1), 1.0, "a")
    assert (turbodecoder_cuda.launches, viterbi_cuda.launches) == (32, 2)  # warm-up + 1 call
    for _ in range(3):
        step(torch.ones(2), _gen(1), 1.0, "a")
    assert (turbodecoder_cuda.launches, viterbi_cuda.launches) == (32 + 48, 2 + 3)
    (g,) = step.graphs.values()
    assert g.graph.replays == 4


@pytest.mark.parametrize("hook", ["raises", "cpu_torch"])
def test_a_failed_capture_raises_and_runs_no_eager_step(hook, monkeypatch):
    """A capture that fails (a stand-in whose capture raises, or, with only
    on_card patched, torch.cuda's own objects in a build without CUDA)
    makes the call raise; the step's Python runs for the warm-up alone (or
    not at all), never in the capture's place, and no graph is kept."""
    runs = []
    if hook == "raises":
        _fake_card(monkeypatch)

        def graph(g, pool=None):
            raise RuntimeError("capture failed")
        monkeypatch.setattr(torch.cuda, "graph", graph)
    else:
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        monkeypatch.setattr(graphs, "on_card", lambda dev: True)
    step = graphs.jit(_counting_step(runs), CPU)
    with pytest.raises(Exception) as err:
        step(torch.ones(2), _gen(1), 1.0, "a")
    if hook == "raises":
        assert "capture failed" in str(err.value)
    assert len(runs) == (1 if hook == "raises" else 0) and step.graphs == {}


def test_a_graphed_block_fills_tti0_into_a_device_input(monkeypatch):
    """make_block_step on a stood-in card: the block's TTI is a 0-d int64
    static input, filled at each call, which the captured body read (its
    subframes come from it); the payloads are static inputs too."""
    _fake_card(monkeypatch)
    p_cfg, _ = _sps_cfgs(False)
    dl, ul = _sps_payloads(p_cfg, 0)
    seen = []
    body = p_wb._step_body

    def spy(cfg, c, dl_bits, ul_bits, gen, tti0):
        seen.append(tti0)
        return body(cfg, c, dl_bits, ul_bits, gen, tti0)

    monkeypatch.setattr(p_wb, "_step_body", spy)
    step = p_wb.make_block_step(p_cfg, sfn0=12, device="cpu")
    out = step(dl, ul, _gen(1), 120)
    (g,) = step.graphs.values()
    tti = g.inputs[3]
    assert tti.shape == () and tti.dtype == torch.int64 and all(t is tti for t in seen)
    assert int(tti) == 120 and len(seen) == 2
    step(dl, ul, _gen(1), 37)
    assert int(tti) == 37 and len(seen) == 2 and len(step.graphs) == 1
    assert np.array_equal(g.inputs[0].numpy(), dl) and bool(out["dl_ok"].all())


def _host_table(*args):
    return np.arange(8, dtype=np.int64)


# the bounded caches of device tables that a captured step reads (the link's
# receiver and transmitter, the blocks' rounds), each with one set of arguments
_CELL6 = p_grid.CellConfig(n_prb=6, cell_id=1)
TABLE_CACHES = {
    "pdsch._crs_table": (pdsch._crs_table, (_CELL6, 1, 0, CPU)),
    "pdsch._re_table": (pdsch._re_table, (_CELL6, 1, (1,) * 6, CPU)),
    "pdsch._tx_gather": (pdsch._tx_gather, (_CELL6, 1, (1,) * 6, 0, CPU)),
    "scrambling._cached_sequence": (scrambling._cached_sequence, (1001, 64, CPU)),
    "chest._device_tables": (chest._device_tables, (_CELL6, 1, 0, CPU)),
    "ofdm._device_tables": (ofdm._device_tables, (6, CPU)),
    "sequence._device_tables": (sequence._device_tables, (64, CPU)),
    "crc._device_matrix": (crc._device_matrix, (*crc.LTE_CRC24A, 64, CPU)),
    "crc.remainder_masks": (crc.remainder_masks, (*crc.LTE_CRC24A, 64, CPU)),
    "viterbi._signs": (viterbi._signs, (CPU,)),
    "turbo._device_perm": (turbo._device_perm, (40, CPU)),
    "rm_turbo._on_device": (rm_turbo._on_device, (_host_table, (), CPU)),
    "turbodecoder._tail_signs": (turbodecoder._tail_signs, (CPU,)),
    "turbodecoder._device_perms": (turbodecoder._device_perms, (40, CPU)),
    "convcoder._on_device": (convcoder._on_device, (_host_table, 1, 2, CPU)),
    "waveblock._time_weights": (p_wb._time_weights, (CPU,)),
    # the waveform planes' steps (runtime/wavesim)
    "enb_dl._dci_1a_bits": (enb_dl._dci_1a_bits, (6, 0, 3, CPU)),
    "pcfich._device_tables": (pcfich._device_tables, (_CELL6, CPU)),
    "sync._device_tables": (sync._device_tables, (_CELL6, 0, CPU)),
    "pdcch._rnti_mask": (pdcch._rnti_mask, (0x46, CPU)),
    "pmch._device_tables": (pmch._device_tables, (6, 1, 3, CPU)),
    "ofdm._mbsfn_device_tables": (ofdm._mbsfn_device_tables, (6, CPU)),
    "mimo._codebook_2l": (mimo._codebook_2l, (1, CPU)),
    "pucch._f1_data_mask": (pucch._f1_data_mask, (CPU,)),
}


@pytest.mark.parametrize("name", list(TABLE_CACHES))
def test_a_graph_holds_the_tables_it_read(name, monkeypatch):
    """A bounded table cache hands each table it returns during a capture
    to the graph: the cache may then evict it, and the graph still holds
    the very tensors it read."""
    _fake_card(monkeypatch)
    cache, args = TABLE_CACHES[name]
    maxsize = cache.cache_parameters()["maxsize"]
    assert maxsize is not None
    cache.cache_clear()
    step = graphs.jit(lambda x: _flat(cache(*args))[0].float().sum() + x, CPU)
    step(torch.zeros(()))
    (g,) = step.graphs.values()
    read = cache(*args)
    assert id(read) in g.tables and g.tables[id(read)] is read
    cache.cache_clear()  # an eviction: the cache lets go of every table
    assert cache(*args) is not read and g.tables[id(read)] is read
    assert cache.cache_info().currsize == 1
    step(torch.zeros(()))  # a replay reads no cache: nothing more is held
    assert len(g.tables) == 1


def _three_keys():
    """A table cache bounded at 2 keys."""
    @devices.table_cache(2)
    def _three(k, device):
        return torch.full((2,), float(k), device=device)
    return _three


@pytest.mark.parametrize("kind", ["step", "round"])
def test_a_capture_reads_every_table_its_warm_up_made(kind, monkeypatch):
    """A step that asks a table_cache(2) for 3 keys: its warm-up evicts its
    own first table, and the capture takes it from the warm-up's record.
    The graph captures, equals the eager call and holds all 3 tables; the
    cache keeps its bound.  The same for a RoundGraph, whose reset reads
    key 0 again after the round's capture."""
    _fake_card(monkeypatch)
    cache = _three_keys()
    fn = lambda x: sum(cache(k, CPU) for k in range(3)) + x
    x = torch.tensor([1.0, 2.0])
    if kind == "step":
        step = graphs.jit(fn, CPU)
        got = step(x)
        (g,) = step.graphs.values()
        assert torch.equal(got, fn(x)) and torch.equal(step(x), got)
    else:
        out = {}
        g = graphs.RoundGraph(lambda gens: out.update(y=fn(x)), lambda: out.update(z=cache(0, CPU)),
                              1, CPU)
        assert torch.equal(out["y"], fn(x)) and torch.equal(out["z"], cache(0, CPU))
    held = sorted(float(t[0]) for t in g.tables.values())
    assert held == [0.0, 1.0, 2.0], held
    assert cache.cache_info().currsize == 2


def test_a_table_made_while_a_graph_captures_raises(monkeypatch):
    """A key that the warm-up never asked for, and the cache does not
    hold, misses at capture: its table would be made while the graph
    captures, as a host copy cannot be.  The capture raises and names the
    cache, and the step keeps no graph."""
    _fake_card(monkeypatch)
    cache = _three_keys()
    runs = []

    def fn(x):  # the warm-up asks for key 1, the capture for key 2
        runs.append(x)
        return cache(len(runs), CPU) + x

    step = graphs.jit(fn, CPU)
    with pytest.raises(RuntimeError, match="_three.*a key its warm-up did not ask for"):
        step(torch.zeros(()))
    assert step.graphs == {} and len(runs) == 2


def test_round_graphs_hold_their_tables_too(monkeypatch):
    """RoundGraph captures through the same code: the tables its round read
    are held by it."""
    _fake_card(monkeypatch)
    cell = p_grid.CellConfig(n_prb=6, cell_id=3)
    g = graphs.RoundGraph(lambda gens: pdsch._re_table(cell, 1, (1,) * 6, CPU), lambda: None, 1,
                          CPU)
    read = pdsch._re_table(cell, 1, (1,) * 6, CPU)
    assert len(g.tables) == 1 and g.tables[id(read)] is read


def test_chip_smoke_logs_count_step_replays(monkeypatch):
    """chip_smoke.py's logs count a replayed step as the kernels' counts
    do: an update made while a step is captured is held back, and each
    StepGraph.run makes it once."""
    cs = _chip_smoke()
    _fake_card(monkeypatch)
    for cls in (graphs.RoundGraph, graphs.StepGraph):  # put back after the test
        for name in ("__init__", "run"):
            monkeypatch.setattr(cls, name, getattr(cls, name))
    cs.count_replays_in_logs()
    log = []
    step = graphs.jit(lambda x: cs.log_update(lambda: log.append(1)) or x + 1, CPU)
    step(torch.zeros(2))
    (g,) = step.graphs.values()
    assert log == [1, 1] and len(g.log_updates) == 1  # the warm-up's, then the first replay's
    step(torch.zeros(2))
    step(torch.zeros(2))
    assert log == [1] * 4
