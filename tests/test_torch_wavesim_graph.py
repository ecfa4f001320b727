"""The waveform planes' steps as the reference jits them (runtime/wavesim.py):
one factory per key, cached per plane, each step a `graphs.jit` step on the
card (one CUDA graph per key and argument signature) and eager elsewhere.

On the CPU:
- keys: each plane's factories after the same calls (two subframes, one
  reconfigured rnti) number what the JAX plane's `lru_cache` holds, its
  jitted functions stopped at their first call (nothing compiles);
- captures: with torch.cuda's graph stood in for by one that runs the
  captured Python again at each replay (reading the static inputs, drawing
  from the graph's generators and writing the static outputs, as a replay
  does on the card), every plane's first call captures once per key and
  each call equals the same plane's with jit=False bit for bit: delivered
  bytes, SNR estimates, ACKs, CQIs, metrics and the generator's state.
  While a step captures, a read of a tensor on the host or a tensor made
  from host data raises (the card rejects both in a capture), and a
  `table_cache` lookup that misses both its LRU and the warm-up's record
  raises (graphs.py);
- more UEs than a table cache holds: UlControlPlane.step with 65 UEs and
  WaveformDataPlane.send_tti with 64 and 80 one-PRB grants at 100 PRB
  (chip_smoke.py's crowded planes) overflow per-UE caches of bound 64, and
  each capture reads the tables its warm-up made: equal to jit=False;
- reconfiguration: `add_ue` with a new slot drops the rnti's steps and
  graphs; the next send captures anew with the new allocation and delivers
  the JAX plane's bytes;
- the PHY tables and reads this slice changed: enb_dl's DCI rows, the
  PCFICH row of an int CFI, the RNTI mask of an int rnti, and pmch.decode
  with read=False, against the old calls.

On the card (`cuda`): each of the six steps graphed against its jit=False
twin on generators seeded alike, over two calls and one reconfiguration.
The JAX package is imported only by the CPU tests' fixture, so the card
(which has no jax) runs this file with `--noconftest -m cuda`.
"""

import contextlib
import dataclasses
import gc
import importlib.util
import pathlib
import weakref

import numpy as np
import pytest
import torch

from srslte_emane_tpu_torch.models import enb_dl
from srslte_emane_tpu_torch.ops import cplx, scrambling
from srslte_emane_tpu_torch.ops.fec import turbodecoder, viterbi
from srslte_emane_tpu_torch.phch import dci, grid as p_grid, pcfich, pdcch, pmch, pucch, sch
from srslte_emane_tpu_torch.runtime import graphs, wavesim
from srslte_emane_tpu_torch.utils import devices

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

CPU = torch.device("cpu")


# ---------------- the six steps' scenarios ----------------

def _dl_cell():
    return p_grid.CellConfig(n_prb=6, cell_id=3, cfi=2)


def _dl_slots(cell):
    """tests/test_torch_dl_subframe.py's two UEs at 6 PRB: PRBs 0-2 and 3-5,
    16QAM, CCEs from each UE's search space."""
    alloc = pdcch.allocate_cces(cell, [0x46, 0x47], 1)
    return {r: dict(prb_mask=tuple(int(i // 3 == u) for i in range(6)), qm=4, l_aggr=alloc[r][0],
                    cce_start=alloc[r][1]) for u, r in enumerate((0x46, 0x47))}


def _moved(slot):
    """The same grant on the other half of the band: the same TBS at sf 1,
    so a stale step would take the new payloads without a new capture."""
    return dict(slot, prb_mask=slot["prb_mask"][3:] + slot["prb_mask"][:3])


def _pdus(n, size, seed):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(0, 256, size, dtype=np.uint8)) for _ in range(n)]


class Scenario:
    """A plane's calls: the plane is `cls(cell, **kw)` (the JAX twin too),
    `calls` are (method name, args, kwargs) in order, `factory` names the
    factory they reach, `drops` whether an add_ue in them drops a step."""

    def __init__(self, cls, cell, factory, calls, kw=None, drops=False):
        self.cls, self.cell, self.factory = cls, cell, factory
        self.calls, self.kw, self.drops = calls, kw or {}, drops


def _scenarios():
    dl = _dl_cell()
    slots = _dl_slots(dl)
    a, b = 0x46, 0x47
    add = lambda r, s: ("add_ue", (r,), s)
    bursts = {a: _pdus(3, 24, 1), b: _pdus(2, 20, 2)}
    pl = {a: 100.0, b: 104.0}
    ul = p_grid.CellConfig(n_prb=25, cell_id=1)
    return {
        "send": Scenario("WaveformDataPlane", dl, "_link_fn", [
            add(a, slots[a]), add(b, slots[b]),
            ("send", (a, bursts[a], 100.0), {}), ("send", (b, bursts[b], 104.0), {}),
            ("send", (a, bursts[a], 100.0), dict(sf_idx=6)),
            add(b, slots[b]),  # the same slot again: nothing dropped
            add(a, _moved(slots[a])),
            ("send", (a, bursts[a], 100.0), {})], drops=True),
        "send_tti": Scenario("WaveformDataPlane", dl, "_tti_fn", [
            add(a, slots[a]), add(b, slots[b]),
            ("send_tti", (bursts, pl), {}), ("send_tti", (bursts, pl), dict(sf_idx=6)),
            add(a, dict(slots[a], qm=2)),
            ("send_tti", (bursts, pl), {})]),
        "mbsfn": Scenario("MbsfnPlane", p_grid.CellConfig(n_prb=6, cell_id=1), "_fn", [
            ("send", (_pdus(3, 20, 3), {10: 80.0, 11: 90.0}), {}),
            ("send", (_pdus(3, 20, 4), {10: 80.0, 11: 90.0}), dict(sf_idx=7)),
            ("send", (_pdus(3, 20, 5), {11: 85.0}), {})], dict(area_id=2)),
        "ul_control": Scenario("UlControlPlane", p_grid.CellConfig(n_prb=6, cell_id=17), "_fn", [
            *(("add_ue", (100 + u, u), {}) for u in range(3)),
            ("step", ({100: 1, 101: 0}, {100 + u: 90.0 for u in range(3)}), {}),
            ("step", ({100: 0, 102: None}, {100 + u: 95.0 for u in range(3)}), dict(sf_idx=7)),
            ("add_ue", (103, 3), {}),
            ("step", ({100: 1, 103: 1}, {100 + u: 90.0 for u in range(4)}), {})]),
        "ul_sch": Scenario("UlSchPlane", ul, "_fn", [
            ("add_ue", (a, 0, 8), dict(qm=2)), ("add_ue", (b, 8, 8), dict(qm=2)),
            ("step", ({a: (b"hello-ul-world!!", 9), b: (b"second-ue-pusch!", 12)},
                      {a: 100.0, b: 105.0}), {}),
            ("step", ({a: (b"again", 7)}, {a: 100.0}), dict(sf_idx=9)),
            ("add_ue", (b, 12, 8), dict(qm=2)),
            ("step", ({a: (b"hello-ul-world!!", 9), b: (b"moved-ue-pusch!!", 11)},
                      {a: 100.0, b: 105.0}), {})], drops=True),
        "mimo": Scenario("MimoDataPlane", p_grid.CellConfig(n_prb=6, cell_id=5, n_ports=2, cfi=1),
                         "_link_fn", [
            ("add_ue", (0x50, (1,) * 6), dict(qm=4)),
            ("send", (0x50, _pdus(4, 30, 6), 95.0), {}),
            ("send", (0x50, _pdus(3, 30, 7), 95.0), dict(sf_idx=6)),
            ("add_ue", (0x50, (1,) * 3 + (0,) * 3), dict(qm=4)),
            ("send", (0x50, _pdus(4, 20, 8), 95.0), {})], drops=True),
    }


SCENARIOS = _scenarios()


def _plane(sc, **kw):
    return getattr(wavesim, sc.cls)(sc.cell, device="cpu", **sc.kw, **kw)


# ---------------- a stand-in card whose graphs replay the captured Python ----------------

class _HostTouch(RuntimeError):
    pass


class _Graph:
    """A stand-in CUDA graph: the capture keeps the step's Python and its
    outputs (`_keep`); each replay runs it again, on the static inputs and
    the graph's generators, and writes the static outputs in place."""

    def __init__(self):
        self.generators, self.replays, self.fn, self.out = [], 0, None, None

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def pool(self):
        return None

    def replay(self):
        self.replays += 1
        _copy_into(self.out, self.fn())


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_into(d, s)


class _Stream:
    def __init__(self, *a, **kw):
        pass

    def wait_stream(self, other):
        pass


CAPTURING = [False]
# calls of the turbo decoder's loop and of the Viterbi in progress: on the
# CPU their plain versions read the host by design; on the card each is one
# C call or launch (turbo_iter_cuda.decode_cuda, viterbi_cuda), captured in
# graphs since tests/test_torch_step_graph.py and tests/test_torch_cuda.py
PLAIN_KERNELS = [0]
# what the card refuses while a stream captures, outside those: a read on
# the host, a tensor made from host data, an index of host data (a list or
# a numpy array, copied to the card at each call)
HOST_READS = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__", "__float__", "__index__",
              "__array__")
HOST_DATA = ("from_numpy", "tensor")


@contextlib.contextmanager
def _patched(pairs):
    saved = [(obj, name, obj.__dict__.get(name)) for obj, name, _ in pairs]
    for obj, name, new in pairs:
        setattr(obj, name, new)
    try:
        yield
    finally:
        for obj, name, old in saved:
            if old is None:
                delattr(obj, name)
            else:
                setattr(obj, name, old)


def _refuse(what, fn):
    def refused(*a, **kw):
        if PLAIN_KERNELS[0]:
            return fn(*a, **kw)
        raise _HostTouch(f"{what} while a graph captures")
    return refused


def _plain_kernel(fn):
    def run(*a, **kw):
        PLAIN_KERNELS[0] += 1
        try:
            return fn(*a, **kw)
        finally:
            PLAIN_KERNELS[0] -= 1
    return run


@contextlib.contextmanager
def _strict_capture(graph, pool=None):
    """torch.cuda.graph's stand-in: inside it, a host read or a tensor made
    from host data raises."""
    as_tensor = torch.as_tensor

    def strict_as_tensor(data, *a, **kw):
        if not isinstance(data, torch.Tensor) and not PLAIN_KERNELS[0]:
            raise _HostTouch("torch.as_tensor of host data while a graph captures")
        return as_tensor(data, *a, **kw)

    def strict_index(name):
        fn = getattr(torch.Tensor, name)

        def indexed(self, index, *a):
            parts = index if isinstance(index, tuple) else (index,)
            if not PLAIN_KERNELS[0] and any(isinstance(p, (list, np.ndarray)) for p in parts):
                raise _HostTouch(f"Tensor.{name} with a host index while a graph captures")
            return fn(self, index, *a)
        return indexed

    pairs = ([(torch.Tensor, n, _refuse(f"Tensor.{n}", getattr(torch.Tensor, n)))
              for n in HOST_READS]
             + [(torch.Tensor, n, strict_index(n)) for n in ("__getitem__", "__setitem__")]
             + [(torch, n, _refuse(f"torch.{n}", getattr(torch, n))) for n in HOST_DATA]
             + [(torch, "as_tensor", strict_as_tensor)])
    CAPTURING[0] = True
    try:
        with _patched(pairs):
            yield
    finally:
        CAPTURING[0] = False


def _fake_card(monkeypatch):
    """graphs.jit captures on the CPU with the stand-ins above."""
    capture = graphs._capture

    def keeping(graph, fn, *args, **kw):
        out, counted, tables = capture(graph, fn, *args, **kw)
        graph.fn, graph.out = fn, out
        return out, counted, tables

    for name, obj in (("Stream", _Stream), ("CUDAGraph", _Graph),
                      ("current_stream", lambda *a: _Stream()),
                      ("stream", lambda s: contextlib.nullcontext()),
                      ("graph", _strict_capture),
                      ("is_current_stream_capturing", lambda: CAPTURING[0])):
        monkeypatch.setattr(torch.cuda, name, obj)
    monkeypatch.setattr(graphs, "_capture", keeping)
    for mod, name in ((turbodecoder, "turbo_decode_device"), (viterbi, "viterbi_decode")):
        monkeypatch.setattr(mod, name, _plain_kernel(getattr(mod, name)))
    monkeypatch.setattr(graphs, "on_card", lambda dev: True)


def _run(plane, call):
    name, args, kw = call
    return getattr(plane, name)(*args, **kw)


# ---------------- keys: the port's factories against the JAX plane's caches ----------------

class _Stop(Exception):
    """Raised by a JAX plane's jitted function in place of its compile."""


@pytest.fixture(scope="module")
def jax_wavesim():
    import jax

    from srslte_emane_tpu.phch import grid as j_grid
    from srslte_emane_tpu.runtime import wavesim as j_wavesim

    jax.config.update("jax_platforms", "cpu")
    return j_wavesim, j_grid


def _jax_plane(jax_wavesim, cls, cell, **kw):
    j_wavesim, j_grid = jax_wavesim
    return getattr(j_wavesim, cls)(j_grid.CellConfig(**dataclasses.asdict(cell)), **kw)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_factories_are_keyed_as_the_reference(name, jax_wavesim, monkeypatch):
    """After every call of the scenario the plane holds as many steps of
    the factory as the JAX plane's lru_cache holds jitted functions (their
    calls stopped before the compile): the same keys, the same keys
    dropped when add_ue reconfigures an rnti (none when the slot is the
    same), none when it does not."""
    j_wavesim, _ = jax_wavesim
    sc = SCENARIOS[name]
    jp, pp = _jax_plane(jax_wavesim, sc.cls, sc.cell, **sc.kw), _plane(sc)
    cache = getattr(type(jp), sc.factory)
    cache.cache_clear()

    def stopped(fn, *a, **kw):
        def call(*args, **kwargs):
            if name == "ul_sch":  # a failed CRC: the step goes on to its next UE
                return {"ok": np.zeros(1, bool)}
            raise _Stop
        return call

    monkeypatch.setattr(j_wavesim.jax, "jit", stopped)
    sizes = []
    for call in sc.calls:
        if call[0] == "add_ue" or name == "ul_sch":
            _run(jp, call)
        else:
            with pytest.raises(_Stop):
                _run(jp, call)
        _run(pp, call)
        sizes.append((sum(k[0] == sc.factory for k in pp._memo), cache.cache_info().currsize))
    cache.cache_clear()
    assert all(p == j for p, j in sizes), sizes
    assert max(j for _, j in sizes) >= 2, sizes


# ---------------- captures: graphed against eager, on the stand-in card ----------------

def _state(plane):
    return plane.gen.get_state()


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_graphed_planes_equal_eager_planes(name, monkeypatch):
    """The scenario through the plane graphed on the stand-in card and
    through the same plane with jit=False: every call's results (bytes,
    SNR estimates, ACKs, CQIs) equal, the metrics and the generator's state
    equal after each call; each key's step captured once (no host read and
    no upload inside), and a reconfigured rnti's step and graphs gone."""
    _fake_card(monkeypatch)
    sc = SCENARIOS[name]
    graphed, eager = _plane(sc), _plane(sc, jit=False)
    assert eager.jit is False and graphed.jit is True
    built = graphs.STATS["graphs"]
    steps = {}
    for call in sc.calls:
        got, want = _run(graphed, call), _run(eager, call)
        assert got == want, call[0]
        assert graphed.metrics == eager.metrics
        assert torch.equal(_state(graphed), _state(eager))
        counts = graphed.graph_counts()
        assert all(n == 1 for n in counts.values()), counts
        for key in counts:
            steps.setdefault(key, []).append(graphed._memo[key])
        assert eager.graph_counts() == {}
    # a step once made is kept until add_ue drops it: one object per key and
    # life, and a dropped one is not brought back
    lives = sum(len({id(s) for s in v}) for v in steps.values())
    assert graphs.STATS["graphs"] - built == lives
    assert (lives > len(graphed.graph_counts())) == sc.drops


def test_a_reconfigured_rnti_is_served_its_new_allocation(jax_wavesim, monkeypatch):
    """WaveformDataPlane.send after add_ue moves a UE to the other half of
    the band (the same TBS, so the same argument signature): the old step
    and its graph are gone, the new step's capture builds the subframe with
    the new PRBs, and the plane delivers the JAX plane's bytes there."""
    _fake_card(monkeypatch)
    cell = _dl_cell()
    slots = _dl_slots(cell)
    pdus = _pdus(3, 30, 9)
    jp = _jax_plane(jax_wavesim, "WaveformDataPlane", cell)
    pp = wavesim.WaveformDataPlane(cell, device="cpu")
    for p in (jp, pp):
        p.add_ue(0x46, **slots[0x46])
    assert [g for g, _ in pp.send(0x46, pdus, 100.0)] == pdus
    (old_key, old), = pp._memo.items()
    (old_graph,) = old.graphs.values()
    masks, build = [], enb_dl.build_subframe

    def spy(cfg, payloads, *a, **kw):
        masks.append(cfg.grants[0][1])
        return build(cfg, payloads, *a, **kw)

    monkeypatch.setattr(enb_dl, "build_subframe", spy)
    for p in (jp, pp):
        p.add_ue(0x46, **_moved(slots[0x46]))
    assert pp._memo == {} and pp.graph_counts() == {}
    out_p = pp.send(0x46, pdus, 100.0)
    out_j = jp.send(0x46, pdus, 100.0)
    (new_key, new), = pp._memo.items()
    assert new_key == old_key and new is not old and len(new.graphs) == 1
    assert next(iter(new.graphs.values())) is not old_graph
    assert masks == [_moved(slots[0x46])["prb_mask"]] * 3  # warm-up, capture, replay
    assert [g for g, _ in out_p] == [g for g, _ in out_j] == pdus


def test_no_garbage_is_collected_while_a_graph_captures(monkeypatch):
    """The cyclic garbage collector is off while a step captures (it could
    free another graph there, which invalidates the capture on the card)
    and back on after, also when the capture fails; a plane let go frees
    itself and its steps (and with them their graphs) at once, with no
    collection: its steps hold no reference to it."""
    _fake_card(monkeypatch)
    seen = []
    step = graphs.jit(lambda x: seen.append(gc.isenabled()) or x + 1, CPU)
    step(torch.zeros(2))
    assert seen == [True, False, True] and gc.isenabled()  # warm-up, capture, replay
    bad = graphs.jit(lambda x: x + float(x.sum()), CPU)
    with pytest.raises(_HostTouch):
        bad(torch.zeros(2))
    assert gc.isenabled()
    sc = SCENARIOS["send"]
    plane = _plane(sc)
    for call in sc.calls[:3]:
        _run(plane, call)
    (step,) = plane._memo.values()
    assert len(step.graphs) == 1
    gone = [weakref.ref(plane), weakref.ref(step)]
    del step
    gc.disable()
    try:
        del plane
        assert [ref() for ref in gone] == [None, None]
    finally:
        gc.enable()


# ---------------- the PHY tables and reads of this slice ----------------

@pytest.mark.parametrize("n_prb", [6, 25, 100])
def test_dci_rows_come_from_a_table(n_prb):
    """enb_dl's DCI 1A row of a grant is dci.pack_dl's bits, from a bounded
    table_cache, expanded over the batch (build_subframe uploads nothing)."""
    assert enb_dl._dci_1a_bits.cache_parameters()["maxsize"] is not None
    for s, l in ((0, 1), (1, n_prb - 1), (n_prb // 2, n_prb // 3 or 1)):
        want = dci.pack_dl(dci.DciDl("1A", mcs=0, rb_start=s, l_crbs=l), n_prb)
        got = enb_dl._dci_1a_bits(n_prb, s, l, CPU)
        assert got.shape == (1, want.size) and got.dtype == torch.int8
        np.testing.assert_array_equal(got[0].numpy(), want)
        assert enb_dl._dci_1a_bits(n_prb, s, l, CPU) is got


@pytest.mark.parametrize("cfi", [1, 2, 3])
def test_pcfich_int_cfi_equals_tensor_cfi(cfi):
    """pcfich.encode with an int CFI (its row picked on the host) equals the
    same CFI as a tensor, and numpy ints take the int path."""
    cell = p_grid.CellConfig(n_prb=6, cell_id=5, cfi=cfi)
    g = torch.randn(2, 14, cell.nre, 2)
    want = pcfich.encode(torch.tensor(cfi), cell, 4, g)
    assert torch.equal(pcfich.encode(cfi, cell, 4, g), want)
    assert torch.equal(pcfich.encode(np.int64(cfi), cell, 4, g), want)


def test_pucch_format1_symbols_come_from_tables():
    """encode_f1 and detect_f1 take the data symbols from device tables:
    the same grid and the same correlation as with the list index."""
    cell = p_grid.CellConfig(n_prb=6, cell_id=17)
    d0 = torch.tensor([[1.0, 0.0], [-1.0, 0.0]])
    g = pucch.encode_f1(d0, cell, 2, 3, torch.zeros(2, 14, cell.nre, 2))
    idx, wf = pucch._device_tables("f1", cell, 2, 3, CPU)
    data = torch.zeros(7, dtype=torch.bool)
    data[list(pucch.F1_DATA_SYMS)] = True
    want = torch.where(data[None, None, :, None, None], cplx.mul(d0[:, None, None, None, :],
                                                                  wf[None]), wf[None])
    assert torch.equal(pucch._take(g, idx), want)
    syms = list(pucch.F1_DATA_SYMS)
    corr, energy = pucch.detect_f1(g, cell, 2, 3)
    y = pucch._take(g, idx[:, syms])
    ref = cplx.mul_conj(y, wf[:, syms]).sum(dim=-2).sum(dim=(1, 2)) / (12 * 2 * len(syms))
    assert torch.equal(corr, ref) and torch.equal(energy, cplx.abs2(ref))
    assert corr[0, 0] > 0.9 and corr[1, 0] < -0.9


@pytest.mark.parametrize("rnti", [0, 1, 0x46, 0xFFFE, 0xFFFF])
def test_rnti_mask_of_an_int_comes_from_a_table(rnti):
    """rnti_mask_bits of an int rnti is a table_cache's row, equal to the
    tensor path's bits."""
    got = pdcch.rnti_mask_bits(rnti, CPU)
    assert torch.equal(got, pdcch.rnti_mask_bits(torch.tensor(rnti), CPU))
    assert got is pdcch.rnti_mask_bits(rnti, CPU) and got.dtype == torch.int8
    assert int("".join(str(int(b)) for b in got), 2) == rnti


def test_pmch_decode_reads_nothing(monkeypatch):
    """pmch.decode calls decode_tb with read=False, and its bits and flags
    equal those of the old reading call."""
    n_prb, area, sf = 6, 2, 3
    n_re = pmch.nof_re(n_prb)
    cfg = sch.SchConfig(tbs=(n_re * 2 // 3) // 8 * 8, G=n_re * 2, Qm=2, Nl=1)
    rng = np.random.default_rng(3)
    payload = torch.from_numpy(rng.integers(0, 2, (3, cfg.tbs), dtype=np.int8))
    g = pmch.encode(payload, cfg, n_prb, area, sf)
    g = g + torch.from_numpy(rng.normal(0, 1.0, g.shape).astype(np.float32)) * torch.tensor(
        [0.1, 3.0, 0.1])[:, None, None, None]
    decode_tb, reads = sch.decode_tb, []

    def spy(*a, read=True, **kw):
        reads.append(read)
        return decode_tb(*a, read=read, **kw)

    monkeypatch.setattr(sch, "decode_tb", spy)
    out, ok = pmch.decode(g, cfg, n_prb, area, sf)
    monkeypatch.setattr(sch, "decode_tb", lambda *a, read=True, **kw: decode_tb(*a, **kw))
    out_r, ok_r = pmch.decode(g, cfg, n_prb, area, sf)
    assert reads == [False]
    assert torch.equal(out, out_r) and torch.equal(ok, ok_r)
    assert ok.tolist() == [True, False, True] and torch.equal(out[0], payload[0])


def test_a_host_read_inside_a_capture_raises(monkeypatch):
    """The stand-in capture refuses what the card refuses: a step that
    reads a tensor on the host, or copies host data in, raises at its
    capture and keeps no graph."""
    _fake_card(monkeypatch)
    for bad in (lambda x: x + float(x.sum()), lambda x: x + torch.from_numpy(np.ones(2)),
                lambda x: x + torch.as_tensor([1.0, 2.0]), lambda x: x[[1, 0]],
                lambda x: x[np.array([0])]):
        step = graphs.jit(bad, CPU)
        with pytest.raises(_HostTouch):
            step(torch.zeros(2))
        assert step.graphs == {}


# ---------------- on the card ----------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_graphed_planes_equal_eager_planes_on_the_card(name):
    """Each step graphed (the planes' default on the card) against its
    jit=False twin on generators seeded alike, over the scenario's calls
    (two subframes, a reconfiguration): results, metrics and generator
    states equal after every call, one graph per key, the kernels' launch
    counts equal and the MAP kernel launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from srslte_emane_tpu_torch.ops.fec import turbodecoder_cuda as tdc

    sc = SCENARIOS[name]
    make = lambda **kw: getattr(wavesim, sc.cls)(sc.cell, **sc.kw, **kw)
    graphed, eager = make(), make(jit=False)  # their generators seeded alike
    assert graphed.device.type == "cuda" and graphed.jit
    for call in sc.calls:
        launches, built = [], graphs.STATS["graphs"]
        for plane in (graphed, eager):
            before = tdc.launches
            out = _run(plane, call)
            torch.cuda.synchronize()
            launches.append((out, tdc.launches - before))
        (got, n_graph), (want, n_eager) = launches
        assert got == want, call[0]
        # a call that captures runs its step once more, eagerly (the warm-up)
        assert n_graph == n_eager * (2 if graphs.STATS["graphs"] > built else 1)
        assert call[0] == "add_ue" or name == "ul_control" or n_graph > 0
        assert graphed.metrics == eager.metrics
        assert torch.equal(graphed.gen.get_state(), eager.gen.get_state())
        assert all(n == 1 for n in graphed.graph_counts().values())
    assert graphed.graph_counts() and not eager.graph_counts()


# ---------------- more UEs than a table cache holds ----------------

# netsim --waveform's planes at 100 PRB once more than four UEs attach (cfi
# 3; chip_smoke.py's crowded_data_plane and crowded_control_plane), at UE
# counts that overflow the per-UE table caches (bound 64): every UE's PUCCH
# resource, every grant's scrambling sequence, DCI and PDCCH levels
CROWDED_UES = {"ul_control_65": ("control", 65), "send_tti_64": ("data", 64),
               "send_tti_80": ("data", 80)}
# the caches whose bound each case's step overflows
OVERFLOWED = {"ul_control_65": (pucch._device_tables,),
              "send_tti_64": (scrambling._cached_sequence,),
              "send_tti_80": (scrambling._cached_sequence, enb_dl._dci_1a_bits,
                              pdcch._level_tables)}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _crowded_plane(case, **kw):
    """The case's plane on the CPU and its call (a function of a plane)."""
    kind, n = CROWDED_UES[case]
    return getattr(_chip_smoke(), f"crowded_{kind}_plane")(device="cpu", n=n, **kw)


@pytest.mark.parametrize("case", list(CROWDED_UES))
def test_a_step_with_more_ues_than_a_cache_holds_captures(case, monkeypatch):
    """UlControlPlane.step with 65 UEs and WaveformDataPlane.send_tti with
    64 and 80 one-PRB grants at 100 PRB, cfi 3: each step asks a per-UE
    table cache (bound 64) for more keys than it holds, and its capture
    reads what its warm-up made.  Graphed on the stand-in card against
    jit=False (over two calls for the cheap UlControlPlane): the same bytes
    or ACKs, metrics and generator states, one graph holding more tables
    than the bound, and the caches still at their bounds."""
    _fake_card(monkeypatch)
    records, recording = [], devices.recording

    @contextlib.contextmanager
    def kept():
        with recording() as made:
            records.append(made)
            yield made

    monkeypatch.setattr(devices, "recording", kept)
    kind, n = CROWDED_UES[case]
    (graphed, call), (eager, _) = _crowded_plane(case, jit=True), _crowded_plane(case, jit=False)
    for _ in range(2 if kind == "control" else 1):
        got, want = call(graphed), call(eager)  # each delivers every PDU, detects every ACK
        assert got == want and len(got) == n
        assert graphed.metrics == eager.metrics
        assert torch.equal(_state(graphed), _state(eager))
    assert list(graphed.graph_counts().values()) == [1] and eager.graph_counts() == {}
    ((graph,),) = (g.values() for g in graphed.step_graphs().values())
    assert len(graph.tables) > 64
    (made,) = records  # the one warm-up's tables, by cache and key
    for cache in OVERFLOWED[case]:
        bound = cache.cache_parameters()["maxsize"]
        assert sum(key[0] is cache for key in made) > bound >= cache.cache_info().currsize
