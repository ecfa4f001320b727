"""The last `jax.jit`s of the JAX package as `runtime/graphs.jit` steps: the
SNR sweep's encode and decode (scripts/snr_sweep.py:42, :45), the three
profilers' stage jits (scripts/profile_stages.py, profile_mimo.py,
profile_turbo.py) and the two sharded steps
(pdsch_link.make_link_step_sharded, waveblock.make_block_step_sharded).

On a stood-in card (tests/test_torch_waveblock_graph.py's torch.cuda
stand-ins, `graphs.on_card` forced, as tests/test_torch_step_graph.py does
it) a capture runs the step's Python once after its warm-up and a replay
runs none, so each call after the first returns what the capture computed
and adds the launches the capture counted.  On it each entry point builds
one graph per jit of its JAX twin (per argument signature), and each
replay equals the eager step (`--eager`, `jit=False`, `eager=True`)
exactly: every output, and the MAP launches of a call, which these tests
count at the MAP's plain versions (the wrappers' counts on the card).
Steps that draw noise are held on injected noise (a stand-in capture
draws from its own generators).  A step that reads a tensor on the host
while it captures raises, as on the card.  The JAX parity of the same
paths is held elsewhere (tests/test_torch_bench.py::test_sweep_rows_equal_
the_jax_link, tests/test_torch_profile_and_options.py, tests/
test_torch_parallel.py); the graphs on the card, bit for bit against
eager, are in tests/test_torch_cuda.py (marked `cuda`).
"""

import contextlib

import numpy as np
import pytest
import torch

from srslte_emane_tpu_torch.models import pdsch_link as p_link
from srslte_emane_tpu_torch.ops import channel, cplx
from srslte_emane_tpu_torch.ops.fec import crc as crc_mod, turbodecoder, turbodecoder_cuda as tdc
from srslte_emane_tpu_torch.parallel import mesh as p_mesh
from srslte_emane_tpu_torch.phch import grid as p_grid
from srslte_emane_tpu_torch.runtime import graphs, waveblock as p_wb
from srslte_emane_tpu_torch.scripts import profile_mimo, profile_stages, profile_turbo, snr_sweep

from test_torch_step_graph import _flat
from test_torch_waveblock import _sps_cfgs, _sps_payloads
from test_torch_waveblock_graph import _FakeCuda, _fake_cuda

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

CPU = torch.device("cpu")


def _counting(fn, name):
    """fn that adds one to tdc.<name> per call, as the kernel's wrapper
    counts a launch."""
    def counted(*a, **kw):
        setattr(tdc, name, getattr(tdc, name) + 1)
        return fn(*a, **kw)
    return counted


def _stand_in_card(mp):
    """The stood-in card, with the plain MAPs counted as launches, and the
    decoder's passes routed as on the card (use_kernel=None takes the
    kernel's route: its plain version on CPU tensors)."""
    _fake_cuda(mp)
    mp.setattr(graphs, "on_card", lambda dev: True)
    device_decode = turbodecoder.turbo_decode_device

    def routed(d0, d1, d2, valid, k, max_iter=8, crc=crc_mod.LTE_CRC24B, use_kernel=None,
               llr_bits=32):
        return device_decode(d0, d1, d2, valid, k, max_iter, crc, use_kernel is not False,
                             llr_bits)
    mp.setattr(turbodecoder, "turbo_decode_device", routed)
    mp.setattr(tdc, "map_decode_ref", _counting(tdc.map_decode_ref, "launches"))
    mp.setattr(tdc, "map_decode_v1_ref", _counting(tdc.map_decode_v1_ref, "launches_v1"))
    mp.setattr(tdc, "launches", 0)
    mp.setattr(tdc, "launches_v1", 0)


def _counts():
    return tdc.launches, tdc.launches_v1


def _equal(a, b):
    a, b = _flat(a), _flat(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


# ---------------- the profilers: one graph per stage jit, each replay eager ----------------

def _run(make_stages, eager):
    """Every stage of a profiler in order, each called twice (on the card:
    the capture, then one replay) with the outputs of the earlier stages'
    first calls, as the scripts call them.  Returns {label: (the second
    call's output, its launches, the stage's step)}."""
    outs, res, steps = {}, {}, []
    for label, fn in make_stages(outs, steps, eager):
        outs[label] = fn()
        before = _counts()
        out = fn()
        res[label] = out, tuple(a - b for a, b in zip(_counts(), before)), steps[len(res)]
    assert len(steps) == len(res)
    return res


def _stages_stages(outs, steps, eager):
    ctx = profile_stages.setup(2, CPU)
    ctx["steps"] = steps
    return profile_stages.stages(ctx, outs, eager)


def _mimo_stages(outs, steps, eager):
    ctx = profile_mimo.setup(2, CPU, n_prb=6, eager=eager)
    ctx["steps"] = steps  # the stages' jits (not the two set-up jits, each called once)
    return profile_mimo.stages(ctx, outs, eager)


def _turbo_stages(outs, steps, eager):
    inp = profile_turbo.inputs(8, 1056, CPU)
    inp["steps"] = steps
    return profile_turbo.stages(inp, eager).items()


PROFILERS = {"profile_stages": _stages_stages, "profile_mimo": _mimo_stages,
             "profile_turbo": _turbo_stages}
# each profiler's stages, in order (profile_stages' fixed-iteration labels
# name the code blocks of its first group: the bench cell's one K=5504 block)
STAGES = {
    "profile_stages": (*profile_stages.TX_STAGES, profile_stages.DEMOD, profile_stages.FRONT,
                       profile_stages.DERM, *(profile_stages.fixed(n, 1)
                                              for n in profile_stages.FIXED_ITERS),
                       profile_stages.EARLY, profile_stages.FULL),
    "profile_mimo": (profile_mimo.EST, profile_mimo.FRONT, profile_mimo.DEM, profile_mimo.SEP,
                     profile_mimo.MERGED, profile_mimo.FULL),
    "profile_turbo": (profile_turbo.MAP_V1, profile_turbo.MAP, profile_turbo.PLAIN,
                      profile_turbo.fixed(1), profile_turbo.fixed(2), profile_turbo.EARLY),
}
CASES = [(p, label) for p, labels in STAGES.items() for label in labels]


@pytest.fixture(scope="module")
def profiled():
    """Each profiler's stages on the stood-in card and eagerly:
    {profiler: (graphed, eager)}, each as `_run` returns it.  The eager
    side's MAP calls are counted too."""
    runs = {}
    for name, make in PROFILERS.items():
        with pytest.MonkeyPatch.context() as mp:
            _stand_in_card(mp)
            graphed = _run(make, eager=False)
            runs[name] = graphed, _run(make, eager=True)
    return runs


@pytest.mark.parametrize("profiler,label", CASES, ids=[f"{p}:{s}" for p, s in CASES])
def test_profiler_stage_replays_equal_eager(profiled, profiler, label):
    """A stage's jit builds one graph for its one signature, and its replay
    (the second call) gives the eager stage's outputs exactly, with the
    same MAP launches per call."""
    graphed, eager = profiled[profiler]
    assert list(graphed) == list(eager) == list(STAGES[profiler])
    out, launches, step = graphed[label]
    ref, ref_launches, ref_step = eager[label]
    assert len(step.graphs) == 1 and not hasattr(ref_step, "graphs")
    (graph,) = step.graphs.values()
    assert graph.graph.replays == 2  # the first call replays once after its capture
    _equal(out, ref)
    assert launches == ref_launches


def test_profiler_launches_count_the_replays(profiled):
    """The decoding stages launch the MAP at every replay, as often as the
    eager stage does: profile_turbo's MAP stages once per call, its fixed
    decodes at every half-iteration, profile_mimo's decodes and the
    bench-cell profiler's turbo stages."""
    turbo = {label: r[1] for label, r in profiled["profile_turbo"][0].items()}
    assert turbo[profile_turbo.MAP_V1] == (0, 1) and turbo[profile_turbo.MAP] == (1, 0)
    assert turbo[profile_turbo.PLAIN] == (0, 0)
    assert turbo[profile_turbo.fixed(1)] == (2, 0) and turbo[profile_turbo.fixed(2)] == (4, 0)
    mimo = profiled["profile_mimo"][0]
    assert all(mimo[label][1][0] > 0 for label in STAGES["profile_mimo"][3:])
    stages = profiled["profile_stages"][0]
    assert all(stages[label][1][0] > 0 for label in STAGES["profile_stages"][7:])


PROFILER_MAINS = [
    ("profile_stages", ["2", "1"], 12),
    ("profile_mimo", ["1", "1"], 8),
    ("profile_turbo", ["4", "512", "1"], 6),
]


@pytest.mark.parametrize("name,args,n_graphs", PROFILER_MAINS,
                         ids=[m for m, _, _ in PROFILER_MAINS])
def test_profiler_main_captures_one_graph_per_jit(name, args, n_graphs, capsys, monkeypatch):
    """Each profiler's main on the stood-in card reports one captured graph
    per jit of its JAX twin (profile_stages: 10 jit sites, the
    fixed-iteration one jitted at 1, 2 and 8 iterations; profile_mimo 6
    stages and 2 set-up jits; profile_turbo 5 jit sites, the
    fixed-iteration one at 1 and 2 iterations), and none with --eager."""
    import json

    mod = {"profile_stages": profile_stages, "profile_mimo": profile_mimo,
           "profile_turbo": profile_turbo}[name]
    if name == "profile_mimo":  # its 6 PRB cell
        setup = mod.setup
        monkeypatch.setattr(mod, "setup", lambda b, d, eager=False: setup(b, d, 6, eager))
    _stand_in_card(monkeypatch)
    assert mod.main([*args, "--cpu"]) == 0
    graphed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert graphed["captured_graphs"] == n_graphs
    assert mod.main([*args, "--cpu", "--eager"]) == 0
    eager = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert eager["captured_graphs"] == 0
    if name != "profile_stages":
        for label, rec in graphed["stages"].items():
            assert rec["turbo_map_launches"] == eager["stages"][label]["turbo_map_launches"]
            assert rec["turbo_map_v1_launches"] == eager["stages"][label]["turbo_map_v1_launches"]
            assert rec["first_s"] >= 0.0


# ---------------- the SNR sweep ----------------

SWEEP_SNRS = ("8", "20")


def test_sweep_graphs_equal_eager(capsys, monkeypatch):
    """snr_sweep.main on the stood-in card at 8 and 20 dB, batch 2: the
    encode and the decode of each SNR one graph each (captured_graphs 4),
    and every row (BLER, the MAP launches per decode: a replay counts its
    graph's) equal to the --eager sweep's; at 8 dB every subframe fails
    and the decoder runs its whole budget, at 20 dB none fails."""
    import json

    _stand_in_card(monkeypatch)
    assert snr_sweep.main(["2", "1", *SWEEP_SNRS, "--cpu"]) == 0
    graphed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert graphed["captured_graphs"] == 2 * len(SWEEP_SNRS)
    assert snr_sweep.main(["2", "1", *SWEEP_SNRS, "--cpu", "--eager"]) == 0
    eager = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert eager["captured_graphs"] == 0
    keep = ("snr_db", "bler", "turbo_map_launches")
    assert [{k: r[k] for k in keep} for r in graphed["snr_sweep"]] == \
        [{k: r[k] for k in keep} for r in eager["snr_sweep"]]
    assert [r["bler"] for r in graphed["snr_sweep"]] == [1.0, 0.0]
    assert graphed["snr_sweep"][0]["turbo_map_launches"] > graphed["snr_sweep"][1][
        "turbo_map_launches"] > 0


def test_sweep_case_replays_equal_eager(monkeypatch):
    """snr_case's steps at 8 dB: the received samples and the decode's bits
    and CRC flags of a replay equal the eager steps' exactly (the noise is
    drawn outside the steps, from a generator seeded 1)."""
    _stand_in_card(monkeypatch)
    payload = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2, (2, snr_sweep.bench.bench_config(16).tbs), dtype=np.int8))
    tx_fn, rx_fn, rx = snr_sweep.snr_case(8.0, payload)
    first = rx_fn(rx)
    before = _counts()
    out = rx_fn(rx)
    launches = tuple(a - b for a, b in zip(_counts(), before))
    assert len(tx_fn.graphs) == len(rx_fn.graphs) == 1
    monkeypatch.setattr(graphs, "on_card", lambda dev: False)
    _, rx_eager, rx_ref = snr_sweep.snr_case(8.0, payload, eager=True)
    assert torch.equal(rx, rx_ref)
    before = _counts()
    ref = rx_eager(rx_ref)
    assert tuple(a - b for a, b in zip(_counts(), before)) == launches
    _equal(out, ref)
    _equal(first, ref)
    assert not bool(ref[1].any())


# ---------------- a host read while a stream captures ----------------

_READS = ("tolist", "item", "__int__", "__float__", "__bool__", "__index__")


@contextlib.contextmanager
def _reads_raise_while_capturing(mp):
    """As on the card: a tensor read on the host while a stream captures
    raises (a synchronising read is not allowed in a capture)."""
    for name in _READS:
        real = getattr(torch.Tensor, name)

        def read(self, *a, _real=real, **kw):
            if _FakeCuda.capturing:
                raise RuntimeError("operation not permitted when stream is capturing")
            return _real(self, *a, **kw)
        mp.setattr(torch.Tensor, name, read)
    yield


def _device_decode(d0, d1, d2, valid, k, max_iter=8, crc=None, use_kernel=None, llr_bits=32):
    """A stand-in for turbo_decode_device that reads nothing on the host
    (as the card's loop): hard decisions, the flags, n_iter and the passes
    and rows."""
    return ((d0[:, :k] < 0).to(torch.int8), valid.clone(),
            torch.full((), max_iter, dtype=torch.int32),
            torch.tensor([2 * max_iter, 2 * max_iter * d0.shape[0]], dtype=torch.int32))


@pytest.mark.parametrize("read", [True, False], ids=["read", "read_free"])
def test_a_host_read_in_a_capture_raises(read, monkeypatch):
    """turbo_decode's read of n_iter and the MAP rows cannot be captured:
    jitted, turbo_decode raises at its capture, keeps no graph and runs no
    eager step in its place; turbo_decode(read=False), as the profilers'
    stages call it, captures and leaves n_iter and the rows on the device."""
    _stand_in_card(monkeypatch)
    monkeypatch.setattr(turbodecoder, "turbo_decode_device", _device_decode)
    d = [torch.from_numpy(np.random.default_rng(1).normal(size=(4, 44)).astype(np.float32))
         for _ in range(3)]
    valid = torch.ones(4, dtype=torch.bool)
    runs = []

    def decode(a, b, c, v):
        runs.append(1)
        return turbodecoder.turbo_decode(a, b, c, v, 40, 2, None, read=read)

    step = graphs.jit(decode)
    turbodecoder.reset_map_rows()
    with _reads_raise_while_capturing(monkeypatch):
        if read:
            with pytest.raises(RuntimeError, match="stream is capturing"):
                step(*d, valid)
            assert step.graphs == {} and len(runs) == 2  # the warm-up, then the capture
            return
        bits, ok, n_iter = step(*d, valid)
    assert len(step.graphs) == 1 and len(runs) == 2
    assert isinstance(n_iter, torch.Tensor) and int(n_iter) == 2
    assert torch.equal(bits, (d[0][:, :40] < 0).to(torch.int8)) and bool(ok.all())
    assert turbodecoder.read_map_rows() == 2 * 16  # the warm-up's rows and the capture's


# ---------------- the sharded steps ----------------

LINK = dict(qm=6, code_rate=0.55, snr_db=20.0, llr_bits=16)  # the bench cell at 6 PRB


def _link_cfg():
    return p_link.LinkConfig(cell=p_grid.CellConfig(n_prb=6, cell_id=1, cfi=1), **LINK)


def _injected_awgn(seed):
    """channel.awgn adding fixed numpy noise to the rows it is given (the
    same noise at every call, so a warm-up, a capture and an eager call
    add alike), scaled as awgn scales its own draw."""
    noise = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (8, 1920, 2)).astype(np.float32))

    def awgn(gen, x, snr_db, signal_power=None):
        p = cplx.abs2(x).reshape(x.shape[0], -1).mean(dim=-1)
        s = torch.sqrt(p / 10 ** (snr_db / 10) / 2).reshape((-1,) + (1,) * (x.ndim - 1))
        return x + noise[:x.shape[0]] * s
    return awgn


@pytest.mark.parametrize("positions", [1, 2])
def test_sharded_link_graphs_equal_the_unsharded_graph(positions, monkeypatch):
    """make_link_step_sharded on the stood-in card, one graph per position
    (each of its slice, on its device), on injected noise: every output
    equal to make_link_step's graph on each slice, to jit=False and to
    link_step; the step's generator advanced alike (one host draw of the
    seed, outside the graphs); the launches of a call equal."""
    _stand_in_card(monkeypatch)
    monkeypatch.setattr(channel, "awgn", _injected_awgn(3))
    cfg = _link_cfg()
    payload = torch.from_numpy(np.random.default_rng(4).integers(
        0, 2, (2 * positions, cfg.tbs), dtype=np.int8))
    mesh = p_mesh.make_mesh(positions, device="cpu")
    step = p_link.make_link_step_sharded(cfg, mesh)
    eager = p_link.make_link_step_sharded(cfg, mesh, jit=False)
    g, g_eager = _gen(5), _gen(5)
    step(payload, g)
    before = _counts()
    out = step(payload, g)
    launches = tuple(a - b for a, b in zip(_counts(), before))
    assert [len(r.graphs) for r in step.positions] == [1] * positions
    assert all(not hasattr(r, "graphs") for r in eager.positions)
    before = _counts()
    ref = eager(payload, g_eager)
    assert tuple(a - b for a, b in zip(_counts(), before)) == launches and launches[0] > 0
    eager(payload, g_eager)
    assert torch.equal(g.get_state(), g_eager.get_state())
    _equal(out, ref)
    shards = [p_link.link_step(p, _gen(6), cfg) for p in payload.chunk(positions)]
    _equal(out, tuple(torch.cat([s[i] for s in shards]) for i in range(3)))
    if positions == 1:  # the unsharded graph of the whole batch
        one = p_link.make_link_step(cfg)
        _equal(out, one(payload, _gen(6)))
        assert len(one.graphs) == 1
    assert bool(out[1].all()) and torch.equal(out[0], payload) and mesh.transfers == 0


def test_sharded_link_plain_decoder_stays_eager():
    """use_kernel=False (the plain decoder, whose loop reads on the host)
    and jit=False give eager positions, as make_link_step's use_kernel=False."""
    mesh = p_mesh.make_mesh(2, device="cpu")
    assert all(hasattr(r, "graphs") for r in p_link.make_link_step_sharded(_link_cfg(),
                                                                            mesh).positions)
    for kw in (dict(use_kernel=False), dict(jit=False)):
        step = p_link.make_link_step_sharded(_link_cfg(), mesh, **kw)
        assert not any(hasattr(r, "graphs") for r in step.positions)


def _fixed_randn(seed):
    """waveblock._randn drawing the same numpy draws at every call of a
    shape (so a warm-up, a capture and an eager block draw alike)."""
    def randn(gen, shape, device):
        rng = np.random.default_rng([seed, *shape])
        return torch.from_numpy(rng.standard_normal(tuple(shape)).astype(np.float32)).to(device)
    return randn


def test_sharded_block_graph_equals_jit_false(monkeypatch):
    """make_block_step_sharded for 1 cell on a 1-position mesh on the
    stood-in card: one graph (tti0 a device input, filled at each call),
    every output equal to jit=False and to make_block_step's graph on the
    same draws, the launches of a call equal; a second call replays."""
    _stand_in_card(monkeypatch)
    monkeypatch.setattr(p_wb, "_randn", _fixed_randn(7))
    p_cfg, _ = _sps_cfgs(False)
    dl, ul = (a[None] for a in _sps_payloads(p_cfg, 2))
    mesh = p_mesh.make_mesh(1, device="cpu")
    step, consts = p_wb.make_block_step_sharded(p_cfg, mesh, (1,), sfn0=4)
    eager, _ = p_wb.make_block_step_sharded(p_cfg, mesh, (1,), sfn0=4, jit=False)
    step(dl, ul, [_gen(1)], 20)
    before = _counts()
    out = step(dl, ul, [_gen(1)], 20)
    launches = tuple(a - b for a, b in zip(_counts(), before))
    (run,) = step.positions
    (graph,) = run.graphs.values()
    assert graph.graph.replays == 2 and int(graph.inputs[3]) == 20
    before = _counts()
    ref = eager(dl, ul, [_gen(1)], 20)
    assert tuple(a - b for a, b in zip(_counts(), before)) == launches and launches[0] > 0
    _equal(out, ref)
    one = p_wb.make_block_step(p_cfg, sfn0=4, device="cpu")(dl[0], ul[0], _gen(1), 20)
    _equal(out, {k: v[None] for k, v in one.items()})
    assert bool(out["dl_ok"].all()) and bool(out["ul_ok"].all())
    step(dl, ul, [_gen(1)], 21)
    assert graph.graph.replays == 3 and int(graph.inputs[3]) == 21 and len(run.graphs) == 1
    assert not hasattr(eager.positions[0], "graphs")
    plain, _ = p_wb.make_block_step_sharded(p_cfg._replace(use_kernel=False), mesh, (1,))
    assert not hasattr(plain.positions[0], "graphs")


# ---------------- the strict stand-in: a capture that touches the host raises ----------------

def _strict_steps(name):
    """(the steps of an entry point, called once each in order on the
    earlier steps' outputs, as the scripts call them): a list of zero-argument
    callables, each returning its step's output."""
    if name == "sweep":
        payload = torch.from_numpy(np.random.default_rng(0).integers(
            0, 2, (1, snr_sweep.bench.bench_config(16).tbs), dtype=np.int8))
        tx_fn, rx_fn, rx = snr_sweep.snr_case(20.0, payload)
        return [lambda: tx_fn(payload), lambda: rx_fn(rx)]
    if name == "sharded_link":
        mesh = p_mesh.make_mesh(1, device="cpu")
        step = p_link.make_link_step_sharded(_link_cfg(), mesh)
        payload = torch.from_numpy(np.random.default_rng(4).integers(
            0, 2, (2, _link_cfg().tbs), dtype=np.int8))
        return [lambda: step(payload, _gen(5))]
    if name == "sharded_block":
        p_cfg, _ = _sps_cfgs(False)
        dl, ul = (a[None] for a in _sps_payloads(p_cfg, 2))
        step, _ = p_wb.make_block_step_sharded(p_cfg, p_mesh.make_mesh(1, device="cpu"), (1,),
                                               sfn0=4)
        return [lambda: step(dl, ul, [_gen(1)], 20)]
    outs, steps = {}, []
    make = PROFILERS[name]
    if name == "profile_stages":
        make = lambda o, s, e: profile_stages.stages(dict(profile_stages.setup(1, CPU), steps=s),
                                                      o, e)
    calls = []
    for label, fn in make(outs, steps, False):
        outs[label] = fn()
        calls.append(fn)
    return calls


STRICT = ["sweep", "profile_stages", "profile_mimo", "profile_turbo", "sharded_link",
          "sharded_block"]


@pytest.mark.parametrize("name", STRICT)
def test_entry_steps_capture_without_touching_the_host(name, monkeypatch):
    """Every new graphed step captures under tests/test_torch_wavesim_graph.py's
    strict stand-in, whose capture refuses what the card refuses (a host
    read, a tensor made from host data, a host index; the turbo decoder's
    loop and the MAP kernels' plain versions apart: on the card each is one
    C call or launch), and whose replay runs the captured Python again on
    the static inputs: each step's replay equals its first call (the
    capture's)."""
    from test_torch_wavesim_graph import _fake_card as _strict_card, _plain_kernel

    _strict_card(monkeypatch)
    for name_ in ("map_decode_ref", "map_decode_v1_ref"):
        monkeypatch.setattr(tdc, name_, _plain_kernel(getattr(tdc, name_)))
    calls = _strict_steps(name)
    for call in calls:
        first = call()
        _equal(call(), first)
