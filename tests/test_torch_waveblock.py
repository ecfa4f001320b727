"""PyTorch port vs the JAX package: the device-resident block engines
(runtime/waveblock.py, the SPS block in SISO and TM3; runtime/waveblock_dyn.py,
the dynamic IR-HARQ block) and the per-row variants they need (rate matching
with one redundancy version per row, `sch` with rv_b=, the PUSCH DMRS and RE
tables and the CRS table for subframe indices given as tensors,
`sinr.per_rb_sinr_device`).

Bits, CRC flags, ACK decisions, counters and RBs are held exactly (the
decoded bits on the rows whose CRC passed: those a failed decode hands out
follow the LLRs' last rounding, which the reference's bf16 DFT sets); the
rate-matched bits and w-buffers exactly (f32, and bf16 on both sides);
ack_val to 1e-3 relative and ack_energy, its squared magnitude, to 2e-3;
the LLRs into `sch.decode_tb` to a relative RMS of 1e-2 (the reference
rounds DFT inputs to bf16, `ops/dft.py:87-88`).  The blocks' noise: `jax.random.normal` is patched
while the JAX step is traced (it is jitted, so the patch is live only
during that first call) to hand out numpy draws, which the port's
`waveblock._randn` replays in the same order.  Each JAX block compiles
once per module (module-scoped fixtures).  The behaviour tests (NACK on
PUCCH, IR beats chase combining, a missed DCI is DTX) run the port alone
with the reference tests' assertions.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srslte_emane_tpu.ops.fec import rm_turbo as j_rm
from srslte_emane_tpu.phch import chest as j_chest
from srslte_emane_tpu.phch import grid as j_grid
from srslte_emane_tpu.phch import pdcch as j_pdcch
from srslte_emane_tpu.phch import pusch as j_pusch
from srslte_emane_tpu.phch import sch as j_sch
from srslte_emane_tpu.runtime import sinr as j_sinr
from srslte_emane_tpu.runtime import waveblock as j_wb
from srslte_emane_tpu.runtime import waveblock_dyn as j_wbd
from srslte_emane_tpu_torch.ops.fec import rm_turbo as p_rm
from srslte_emane_tpu_torch.phch import chest as p_chest
from srslte_emane_tpu_torch.phch import grid as p_grid
from srslte_emane_tpu_torch.phch import pusch as p_pusch
from srslte_emane_tpu_torch.phch import sch as p_sch
from srslte_emane_tpu_torch.runtime import sinr as p_sinr
from srslte_emane_tpu_torch.runtime import waveblock as p_wb
from srslte_emane_tpu_torch.runtime import waveblock_dyn as p_wbd

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

REL = 1e-2  # relative RMS of the LLRs across the reference's bf16 DFT
# ack_val to 1e-3 relative; ack_energy = |corr|^2 doubles that (2e-3)
ACK_RTOL = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _rel_rms(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


# ---------------- rate matching with one RV per row, and sch rv_b ----------------

# (K, E): E < V and E > V (the wrap; V = 3 * (K + 4) minus the fillers)
RM_CASES = [(40, 100), (40, 300), (512, 1000), (512, 3500)]
RVS = ["0", "1", "2", "3", "mixed"]


def _rv_rows(rv, B, rng):
    if rv == "mixed":
        return rng.integers(0, 4, B).astype(np.int32)
    return np.full(B, int(rv), np.int32)


@pytest.mark.parametrize("rv", RVS)
@pytest.mark.parametrize("k,e", RM_CASES)
def test_rate_matching_dyn_equal(k, e, rv):
    rng = np.random.default_rng(k + e)
    B = 6
    f = 8 if k == 512 else 0
    rv_b = _rv_rows(rv, B, rng)
    V = len(p_rm._cyclic_tables(k, f)[0])
    assert (e > V) == (e in (300, 3500)), (k, e, V)
    for a, b in zip(p_rm._cyclic_tables(k, f), j_rm._cyclic_tables(k, f)):
        np.testing.assert_array_equal(a, b)
    d_flat = rng.integers(0, 2, (B, 3 * (k + 4)), dtype=np.int8)
    tx = p_rm.rate_match_tx_dyn(_t(d_flat), k, f, e, _t(rv_b))
    np.testing.assert_array_equal(
        tx.numpy(), np.asarray(j_rm.rate_match_tx_dyn(jnp.asarray(d_flat), k, f, e, rv_b)))
    # a row with a static RV reads what rate_match_tx reads
    for i in range(B):
        np.testing.assert_array_equal(
            tx[i].numpy(), p_rm.rate_match_tx(_t(d_flat[i : i + 1]), k, f, e, int(rv_b[i]))[0])
    size = p_rm.wbuf_size(k)
    llrs = rng.normal(0, 3, (B, e)).astype(np.float32)
    wbuf = rng.normal(0, 1, (B, size)).astype(np.float32)
    got = p_rm.rate_unmatch_rx_dyn(_t(llrs), _t(wbuf), k, f, e, _t(rv_b))
    ref = j_rm.rate_unmatch_rx_dyn(jnp.asarray(llrs), jnp.asarray(wbuf), k, f, e, rv_b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # narrow mode: bf16 LLRs into a bf16 w-buffer on both sides
    got16 = p_rm.rate_unmatch_rx_dyn(_t(llrs).bfloat16(), _t(wbuf).bfloat16(), k, f, e,
                                     _t(rv_b))
    ref16 = j_rm.rate_unmatch_rx_dyn(jnp.asarray(llrs, jnp.bfloat16),
                                     jnp.asarray(wbuf, jnp.bfloat16), k, f, e, rv_b)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(got16.float().numpy(), np.asarray(ref16, np.float32))


@pytest.fixture(scope="module")
def j_sch_rv():
    """A two-code-block TB (K=3136 and 3136 at tbs 6200, 16QAM) through the
    JAX encode_tb / decode_tb with rv_b, each jitted once."""
    cfg = j_sch.SchConfig(tbs=6200, G=4 * 3300, Qm=4, Nl=1)
    enc = jax.jit(lambda b, rv: j_sch.encode_tb(b, cfg, rv_b=rv))
    dec = jax.jit(lambda l, sb, rv: j_sch.decode_tb(l, cfg, softbuf=list(sb), rv_b=rv,
                                                   llr_bits=16))
    return cfg, enc, dec


@pytest.mark.parametrize("rv", RVS)
def test_sch_rv_b_equal(j_sch_rv, rv):
    jcfg, enc, dec = j_sch_rv
    cfg = p_sch.SchConfig(tbs=jcfg.tbs, G=jcfg.G, Qm=jcfg.Qm, Nl=1)
    assert cfg.segm.C == 2
    rng = np.random.default_rng(3)
    B = 4
    rv_b = _rv_rows(rv, B, rng)
    bits = rng.integers(0, 2, (B, cfg.tbs), dtype=np.int8)
    cw = p_sch.encode_tb(_t(bits), cfg, rv_b=_t(rv_b))
    np.testing.assert_array_equal(cw.numpy(), np.asarray(enc(bits, rv_b)))
    # two transmissions of one TB, soft-combined in bf16 w-buffers: RV 0
    # into empty buffers, then this RV
    soft = [np.zeros((B, p_rm.wbuf_size(k)), np.float32) for k in cfg.segm.cb_sizes]
    p_soft = [_t(s).bfloat16() for s in soft]
    j_soft = [jnp.asarray(s, jnp.bfloat16) for s in soft]
    for rvs in (np.zeros(B, np.int32), rv_b):
        cw_i = p_sch.encode_tb(_t(bits), cfg, rv_b=_t(rvs)).numpy().astype(np.float32)
        llr = (1 - 2 * cw_i) + rng.normal(0, 1.0, cw_i.shape).astype(np.float32)
        out, ok, p_soft, _ = p_sch.decode_tb(_t(llr), cfg, softbuf=p_soft, rv_b=_t(rvs),
                                             llr_bits=16)
        j_out, j_ok, j_soft, _ = dec(llr, j_soft, rvs)
        for a, b in zip(p_soft, j_soft):
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
        np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
    assert ok.all(), ok  # the combined transmissions decode


# ---------------- the traced-index tables ----------------

def test_pusch_tables_with_tensor_arguments():
    for cell_id, l_prb in ((1, 4), (7, 12), (301, 5)):
        np.testing.assert_array_equal(p_pusch._dmrs10(cell_id, l_prb),
                                      j_pusch._dmrs10(cell_id, l_prb))
        jit_dmrs = jax.jit(lambda s: j_pusch._dmrs_for(cell_id, s, l_prb))
        for sf in range(10):
            got = p_pusch._dmrs_for(cell_id, torch.tensor(sf), l_prb)
            np.testing.assert_array_equal(got.numpy(), np.asarray(jit_dmrs(jnp.int32(sf))))
            np.testing.assert_array_equal(p_pusch._dmrs_for(cell_id, sf, l_prb).numpy(),
                                          np.asarray(j_pusch._dmrs_for(cell_id, sf, l_prb)))
        sfs = torch.arange(10)
        np.testing.assert_array_equal(
            p_pusch._dmrs_for(cell_id, sfs, l_prb).numpy(),
            np.stack([np.asarray(jit_dmrs(jnp.int32(s))) for s in range(10)]))
    for n_prb, l_prb in ((15, 4), (100, 12)):
        jit_re = jax.jit(lambda rb: j_pusch._re_idx(n_prb, rb, l_prb))
        rbs = (0, 1, n_prb - l_prb)
        for rb in rbs:
            got = p_pusch._re_idx(n_prb, torch.tensor(rb), l_prb)
            for a, b, c in zip(got, jit_re(jnp.int32(rb)), p_pusch.re_indices(n_prb, rb, l_prb)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
                np.testing.assert_array_equal(a.numpy(), c)
        data, dmrs = p_pusch._re_idx(n_prb, torch.tensor(rbs), l_prb)
        assert data.shape == (3, 12, 12 * l_prb) and dmrs.shape == (3, 2, 12 * l_prb)
        for i, rb in enumerate(rbs):
            np.testing.assert_array_equal(data[i].numpy(), p_pusch.re_indices(n_prb, rb, l_prb)[0])


def test_crs_values10_equal():
    for cell_id, n_prb, port, cp in ((1, 15, 0, "normal"), (7, 100, 1, "normal"),
                                     (3, 25, 0, "ext"), (5, 6, 2, "normal")):
        np.testing.assert_array_equal(p_chest._crs_values10(cell_id, n_prb, port, cp),
                                      j_chest._crs_values10(cell_id, n_prb, port, cp))


def test_per_rb_sinr_device_equal():
    rng = np.random.default_rng(5)
    tx = rng.uniform(10, 30, (3, 4)).astype(np.float32)
    used = rng.integers(0, 2, (3, 4, 25)).astype(np.float32)
    pl = rng.uniform(80, 120, (3, 4, 6)).astype(np.float32)
    got = p_sinr.per_rb_sinr_device(_t(tx), _t(used), _t(pl), -104.0)
    ref = j_sinr.per_rb_sinr_device(tx, used, pl, -104.0)
    assert got.shape == (3, 4, 6, 25)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


# ---------------- the SPS block ----------------

class Draws:
    """Standard-normal numpy draws handed out by shape in call order: the
    JAX side draws them (its patched jax.random.normal), the port replays
    them (its patched waveblock._randn)."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.drawn = []

    def jax_normal(self, key, shape=(), dtype=jnp.float32):
        x = self.rng.standard_normal(tuple(shape)).astype(np.float32)
        self.drawn.append(x)
        return jnp.asarray(x)

    def port_randn(self, calls=None):
        """The port's _randn.  `calls` given: the draws are handed out again
        every `calls` calls (the JAX side traced a lax.scan body once, so
        every round reuses its draws)."""
        it = itertools.cycle(self.drawn) if calls else iter(self.drawn)
        assert calls is None or calls == len(self.drawn), (calls, len(self.drawn))

        def randn(gen, shape, device):
            x = next(it)
            assert x.shape == tuple(shape), (x.shape, tuple(shape))
            return torch.from_numpy(x).to(device)
        return randn


def _jax_run(fn, args, draws):
    """fn(*args) jitted, with jax.random.normal answered by `draws`; returns
    its output and the LLRs of every JAX sch.decode_tb call (handed out
    through an ordered host callback, which works inside lax.scan)."""
    taps, decode_tb = [], j_sch.decode_tb

    def spy(llrs, *rest, **kw):
        jax.debug.callback(lambda x: taps.append(np.asarray(x, np.float32)), llrs,
                           ordered=True)
        return decode_tb(llrs, *rest, **kw)

    def run(*a):
        with pytest.MonkeyPatch.context() as m:
            m.setattr(j_sch, "decode_tb", spy)
            m.setattr(jax.random, "normal", draws.jax_normal)
            return fn(*a)

    out = jax.tree_util.tree_map(np.asarray, jax.jit(run)(*args))
    jax.effects_barrier()
    return out, taps


def _port_run(fn, args, draws, monkeypatch, calls=None):
    taps, decode_tb = [], p_sch.decode_tb

    def spy(llrs, *rest, **kw):
        taps.append(llrs.float().numpy())
        return decode_tb(llrs, *rest, **kw)

    monkeypatch.setattr(p_sch, "decode_tb", spy)
    monkeypatch.setattr(p_wb, "_randn", draws.port_randn(calls))
    out = fn(*args)
    return {k: v.numpy() for k, v in out.items()}, taps


def _sps_cfgs(tm3, n_prb=15, n_ues=2, T=2, **kw):
    """tests/test_waveblock.py's _cfg (15 PRB, cell_id 1, cfi 2, MCS 10,
    ack_res nCCE + i) for both packages, T=2; tm3 with 2 ports."""
    out = []
    for grid_mod, wb in ((p_grid, p_wb), (j_grid, j_wb)):
        cell = grid_mod.CellConfig(n_prb=n_prb, cell_id=1, cfi=2, n_ports=2 if tm3 else 1)
        n_cce = j_pdcch.n_cce(j_grid.CellConfig(n_prb=n_prb, cell_id=1, cfi=2,
                                                n_ports=2 if tm3 else 1))
        c0, c1 = wb.centre_prbs(n_prb)
        dl_starts, dl_w = wb._pack_segments(n_prb, n_ues, [(0, c0), (c1, n_prb)])
        out.append(wb.BlockConfig(
            cell=cell, rntis=tuple(70 + i for i in range(n_ues)),
            dl_rb_start=dl_starts, dl_l_crbs=dl_w, dl_mcs=10,
            ul_rb_start=tuple(1 + 4 * i for i in range(n_ues)), ul_l_prb=4, ul_mcs=10,
            ack_res=tuple(n_cce + i for i in range(n_ues)),
            snr_db=tuple(30.0 - i for i in range(n_ues)), T=T, tm3=tm3, **kw))
    return out


def _sps_payloads(cfg, seed):
    rng = np.random.default_rng(seed)
    dl_shape = (cfg.T, cfg.n_ues) + ((2,) if cfg.tm3 else ()) + (cfg.dl_tbs,)
    return (rng.integers(0, 2, dl_shape, dtype=np.int8),
            rng.integers(0, 2, (cfg.T, cfg.n_ues, cfg.ul_tbs), dtype=np.int8))


@pytest.fixture(scope="module", params=[False, True], ids=["siso", "tm3"])
def sps_pair(request):
    """(port cfg, JAX cfg, payloads, draws, JAX consts, JAX outputs, JAX
    decode_tb LLRs) of one SPS block, the JAX side compiled once."""
    p_cfg, j_cfg = _sps_cfgs(request.param)
    dl, ul = _sps_payloads(p_cfg, 0)
    draws = Draws(1)
    consts = j_wb._cell_consts(j_cfg, 12)
    out, taps = _jax_run(lambda d, u, key, tti0: j_wb._step_body(j_cfg, consts, d, u, key, tti0),
                         (dl, ul, jax.random.PRNGKey(0), jnp.int32(120)), draws)
    return p_cfg, j_cfg, (dl, ul), draws, consts, out, taps


def test_sps_block_tables_equal(sps_pair):
    p_cfg, j_cfg, _, _, j_consts, _, _ = sps_pair
    got = p_wb._cell_consts(p_cfg, 12)
    assert set(got) == set(j_consts) - {"cell_id"}
    for k, v in got.items():
        ref = np.asarray(j_consts[k])
        if k == "base10":  # grids built from the same bits: float32 rounding
            np.testing.assert_allclose(v, ref, rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(v, ref, err_msg=k)


def test_sps_block_equal(sps_pair, monkeypatch):
    p_cfg, _, (dl, ul), draws, _, ref, j_taps = sps_pair
    step = p_wb.make_block_step(p_cfg, sfn0=12, device="cpu")
    got, taps = _port_run(step, (dl, ul, torch.Generator(), 120), draws, monkeypatch)
    assert set(got) == set(ref)
    for k in ("dl_ok", "ul_ok", "dl_out", "ul_out") + (("dl_ok_cw",) if p_cfg.tm3 else ()):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["dl_ok"].all() and got["ul_ok"].all()
    assert (got["dl_out"] == dl.reshape(got["dl_out"].shape)).all()
    assert (got["ul_out"] == ul).all()
    np.testing.assert_allclose(got["ack_val"], ref["ack_val"], rtol=ACK_RTOL)
    np.testing.assert_allclose(got["ack_energy"], ref["ack_energy"], rtol=2 * ACK_RTOL)
    assert (got["ack_energy"] > 0.25).all() and (got["ack_val"] > 0).all()
    assert len(taps) == len(j_taps) == (3 if p_cfg.tm3 else 2)
    for a, b in zip(taps, j_taps):
        assert a.shape == b.shape
        assert _rel_rms(a, b) < REL, _rel_rms(a, b)


def test_sps_bench_step_counts(sps_pair):
    p_cfg, _, (dl, ul), _, _, _, _ = sps_pair
    gen = torch.Generator()
    gen.manual_seed(3)
    d_ok, u_ok, a_ok = p_wb.make_bench_step(p_cfg, sfn0=12, device="cpu")(dl, ul, gen, 120)
    n = p_cfg.T * p_cfg.n_ues
    assert (int(d_ok), int(u_ok), int(a_ok)) == (n * (2 if p_cfg.tm3 else 1), n, n)


def test_sps_block_nack_rides_pucch():
    """tests/test_waveblock.py::test_block_nack_rides_pucch on the port: a
    UE crushed to -10 dB fails its DL CRC and signals NACK on its PUCCH."""
    cfg, _ = _sps_cfgs(False, T=4)
    cfg = cfg._replace(snr_db=(30.0, -10.0))
    dl, ul = _sps_payloads(cfg, 1)
    gen = torch.Generator()
    gen.manual_seed(2)
    out = p_wb.make_block_step(cfg, device="cpu")(dl, ul, gen, 40)
    dl_ok = out["dl_ok"].numpy()
    assert dl_ok[:, 0].all() and not dl_ok[:, 1].any()
    val = out["ack_val"].numpy()
    assert (val[:, 0] > 0).all()  # ACKs
    assert (val[:, 1] < 0).all()  # NACKs carried over the air


def test_block_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p_cfg, _ = _sps_cfgs(False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_wb.make_block_step(p_cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_wb.make_bench_step(p_cfg)
    d_cfg, _ = _dyn_cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_wbd.make_dyn_block_step(d_cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_wbd.make_bench_step(d_cfg)


# ---------------- the dynamic block ----------------

def _dyn_cfgs(R=1, **kw):
    """tests/test_waveblock_dyn.py's clean-channel config (15 PRB, RNTIs 70
    and 71, DL 3 PRB MCS 8, UL 2 PRB MCS 8, 30 / 28 dB), R rounds."""
    base = dict(rntis=(70, 71), dl_l_crbs=3, dl_mcs=8, ul_l_prb=2, ul_mcs=8,
                snr_db=(30.0, 28.0), R=R)
    base.update(kw)
    return (p_wbd.DynBlockConfig(cell=p_grid.CellConfig(n_prb=15, cell_id=1, cfi=2), **base),
            j_wbd.DynBlockConfig(cell=j_grid.CellConfig(n_prb=15, cell_id=1, cfi=2), **base))


def _dyn_inputs(cfg, seed=0, sched_seed=1):
    rb_dl, rb_ul = p_wbd.make_schedule(cfg, seed=sched_seed)
    rng = np.random.default_rng(seed)
    dl_q = rng.integers(0, 2, (cfg.T, cfg.n_ues, cfg.dl_tbs), dtype=np.int8)
    ul_q = rng.integers(0, 2, (cfg.T, cfg.n_ues, cfg.ul_tbs), dtype=np.int8)
    return dl_q, ul_q, rb_dl, rb_ul


def _run_dyn(cfg, seed=0, gen_seed=7):
    dl_q, ul_q, rb_dl, rb_ul = _dyn_inputs(cfg, seed)
    gen = torch.Generator()
    gen.manual_seed(gen_seed)
    out = p_wbd.make_dyn_block_step(cfg, device="cpu")(dl_q, ul_q, rb_dl, rb_ul, gen, 0)
    return {k: v.numpy() for k, v in out.items()}, dl_q, ul_q, rb_dl


# clean: every TB new and first-time right, the state carried across rounds
# is the NDI toggles and queue pointers.  harq: UE 0 at 8 dB fails its
# MCS-16 first transmissions and IR-combines retransmissions at rv 2, 3, 1;
# UE 1 at -6 dB misses every DCI (garbage RBs clamped, DTX on PUCCH, its UL
# soft buffers fed from missed grants), so its DL processes reach MAX_TX and
# drop in round 4, and round 5 sends new data.
DYN_CASES = {"clean": dict(R=2),
             "harq": dict(R=5, dl_mcs=16, snr_db=(8.0, -6.0))}


@pytest.fixture(scope="module", params=list(DYN_CASES))
def dyn_pair(request):
    p_cfg, j_cfg = _dyn_cfgs(**DYN_CASES[request.param])
    inputs = _dyn_inputs(p_cfg)
    draws = Draws(4)
    step = j_wbd.make_dyn_block_step(j_cfg, jit=False)
    out, taps = _jax_run(step, (*inputs, jax.random.PRNGKey(7), jnp.int32(0)), draws)
    return request.param, p_cfg, j_cfg, inputs, draws, out, taps


def test_dyn_block_tables_equal(dyn_pair):
    p_cfg, j_cfg = dyn_pair[1:3]
    for a, b in zip(p_wbd.make_schedule(p_cfg, 5), j_wbd.make_schedule(j_cfg, 5)):
        np.testing.assert_array_equal(a, b)
    # the chip's dynamic cell: 100 PRB, cfi 2, 8 UEs
    cells = (p_grid.CellConfig(n_prb=100, cell_id=1, cfi=2),
             j_grid.CellConfig(n_prb=100, cell_id=1, cfi=2))
    assert p_wbd.feasible_rntis(cells[0], 8) == j_wbd.feasible_rntis(cells[1], 8)
    got, ref = p_wbd._consts(p_cfg), j_wbd._consts(j_cfg)
    assert set(got) == set(ref) | {"cce_re"}
    for k, v in ref.items():
        if k == "base10":
            np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def test_dyn_block_equal(dyn_pair, monkeypatch):
    case, p_cfg, _, inputs, draws, ref, j_taps = dyn_pair
    assert len(draws.drawn) == 5  # one round's draws, traced once
    step = p_wbd.make_dyn_block_step(p_cfg, device="cpu")
    got, taps = _port_run(step, (*inputs, torch.Generator(), 0), draws, monkeypatch,
                          calls=5)
    assert set(got) == set(ref)
    for k in ref:
        if k in ("dl_out", "ul_out"):  # delivered bits: the rows whose CRC passed
            ok = ref[k[:2] + "_ok"]
            assert got[k].shape == ref[k].shape
            np.testing.assert_array_equal(got[k][ok], ref[k][ok], err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    Tn = p_cfg.T * p_cfg.n_ues
    if case == "clean":
        assert got["dl_ok"].sum() == got["ul_ok"].sum() == got["ack_det"].sum() == Tn
    else:  # the scenario the case is meant to drive did happen
        new, rv = got["dl_new"][:, :, 0], got["rv_dl"][:, :, 0]
        assert got["dl_ok"][:, :, 0][~new].sum() > 0 and (rv[~new] != 0).all()
        assert not got["dl_found"][:, :, 1].any() and not got["ack_det"][:, :, 1].any()
        assert got["dl_drop"] >= 8 and got["dl_new"][4, :, 1].all()
    assert len(taps) == len(j_taps) == 2 * p_cfg.R
    for a, b in zip(taps, j_taps):
        assert _rel_rms(a, b) < REL, _rel_rms(a, b)


def test_dyn_block_clean_channel_end_to_end():
    """tests/test_waveblock_dyn.py::test_dyn_block_clean_channel_end_to_end
    on the port (R=2): every TB rides a blind-decoded DCI, every CRC passes
    first time, the UE follows the decoded RIV and the payloads arrive in
    queue order; the bench step counts the same."""
    cfg, _ = _dyn_cfgs(R=2)
    out, dl_q, ul_q, rb_dl = _run_dyn(cfg)
    Tn = cfg.T * cfg.n_ues
    assert out["dl_found"].sum() == Tn
    assert out["dci_ul_miss"] == 0
    assert out["dl_ok"].sum() == out["ul_ok"].sum() == out["ack_det"].sum() == Tn
    assert out["dl_retx_tx"] == 0 and out["ul_retx_tx"] == 0
    assert (out["rb_ue"] == rb_dl).all()
    for u in range(cfg.n_ues):
        for new, outs, q, used in (("dl_new", "dl_out", dl_q, "dl_consumed"),
                                   ("ul_new", "ul_out", ul_q, "ul_consumed")):
            ptr = 0
            for r in range(cfg.R):
                for t in range(p_wbd.N_PID):
                    if out[new][r, t, u]:
                        assert (out[outs][r, t, u] == q[ptr, u]).all()
                        ptr += 1
            assert ptr == out[used][u] == cfg.T
    gen = torch.Generator()
    gen.manual_seed(7)
    counts = p_wbd.make_bench_step(cfg, device="cpu")(*_dyn_inputs(cfg), gen, 0)
    assert [int(x) for x in counts] == [Tn, Tn, Tn, 0, 0, 0]


def test_dyn_block_ir_soft_combining_gain():
    """tests/test_waveblock_dyn.py::test_dyn_block_ir_soft_combining_gain on
    the port: a UE at 8 dB fails its first transmissions at MCS 16 and the
    IR retransmissions recover them; with the soft buffer chased
    (combine=False) the same retransmissions do not, and HARQ drops."""
    cfg, _ = _dyn_cfgs(R=4, dl_mcs=16, snr_db=(30.0, 8.0))
    out, _, _, _ = _run_dyn(cfg)
    u = 1
    ok, new = out["dl_ok"][:, :, u], out["dl_new"][:, :, u]
    assert out["dci_dl_miss"] == 0
    assert ok[new].sum() <= 2, ok
    recovered = ok[~new].sum()
    assert recovered >= 10, (recovered, ok, new)
    assert out["dl_drop"] <= 1
    rv = out["rv_dl"][:, :, u]
    assert (rv[~new] != 0).all()
    assert (rv[1][~new[1]] == 2).all()

    ctrl, _, _, _ = _run_dyn(cfg._replace(combine=False))
    okc = ctrl["dl_ok"][:, :, u]
    assert okc.sum() <= 2, okc
    assert ctrl["dl_drop"] >= 6
    assert recovered - okc[~ctrl["dl_new"][:, :, u]].sum() >= 8


def test_dyn_block_dci_miss_is_dtx():
    """tests/test_waveblock_dyn.py::test_dyn_block_dci_miss_is_dtx on the
    port: at -6 dB the UE misses every PDCCH, decodes nothing and sends no
    PUCCH (DTX); the eNB retransmits; the good UE is untouched."""
    cfg, _ = _dyn_cfgs(R=2, snr_db=(30.0, -6.0))
    out, _, _, _ = _run_dyn(cfg)
    u = 1
    assert not out["dl_found"][:, :, u].any()
    assert not out["dl_ok"][:, :, u].any()
    assert not out["ack_det"][:, :, u].any()
    assert out["dl_retx_tx"] >= 8
    assert out["dl_ok"][:, :, 0].all()
    assert out["ul_ok"][:, :, 0].all()
