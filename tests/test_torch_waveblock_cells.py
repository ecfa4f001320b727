"""PyTorch port vs the JAX package: the dynamic block's cells axis
(runtime/waveblock_dyn.make_dyn_block_step / make_bench_step with
n_cells > 1, the reference's jax.vmap of the block over independent cells).

The configuration is tests/test_torch_waveblock.py's `clean` case (15 PRB,
2 UEs, R=2); the two cells carry their own queues and schedules.  The JAX
side runs jitted with jax.random.normal patched to hand out numpy draws: its
lax.scan traces the round once and its vmap traces the cell once, so one
round's 5 draws serve every round of both cells, and the port's
waveblock._randn hands each draw to each cell in turn.  Every per-cell
output must equal the reference's (the delivered bits where the CRC
passed), the six bench counts too.  With real generators, a two-cell block
must equal two one-cell blocks, and it must run about as many torch ops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srslte_emane_tpu.runtime import waveblock_dyn as j_wbd
from srslte_emane_tpu_torch.runtime import waveblock as p_wb, waveblock_dyn as p_wbd

from test_torch_waveblock import Draws, _dyn_cfgs, _dyn_inputs

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

N_CELLS = 2
N_DRAWS = 5  # one round's noise draws


def _cell_inputs(cfg):
    """(dl_q, ul_q, rb_dl, rb_ul), each with a leading cells axis."""
    per = [_dyn_inputs(cfg, seed=c, sched_seed=1 + c) for c in range(N_CELLS)]
    return tuple(np.stack(x) for x in zip(*per))


def _replay(draws):
    """The port's _randn: draw k of the reference's round, to each cell in
    turn (the vmap broadcast one trace's draws over the cells)."""
    calls = [0]

    def randn(gen, shape, device):
        x = draws.drawn[(calls[0] // N_CELLS) % N_DRAWS]
        calls[0] += 1
        assert x.shape == tuple(shape), (x.shape, tuple(shape))
        return torch.from_numpy(x).to(device)

    return randn


def _gens(seeds):
    out = []
    for s in seeds:
        g = torch.Generator()
        g.manual_seed(s)
        out.append(g)
    return out


@pytest.fixture(scope="module")
def ref():
    """The reference's vmapped block (every output, per cell) and its
    n_cells=2 bench step, each jitted once with its own draws."""
    p_cfg, j_cfg = _dyn_cfgs(R=2)
    inputs = _cell_inputs(p_cfg)
    keys = jax.random.split(jax.random.PRNGKey(7), N_CELLS)
    step = jax.vmap(j_wbd.make_dyn_block_step(j_cfg, jit=False), in_axes=(0, 0, 0, 0, 0, None))
    bench = j_wbd.make_bench_step(j_cfg, n_cells=N_CELLS)
    out = {}
    for name, fn, seed in (("step", step, 4), ("bench", bench, 5)):
        draws = Draws(seed)
        with pytest.MonkeyPatch.context() as m:
            m.setattr(jax.random, "normal", draws.jax_normal)
            res = jax.jit(fn)(*(jnp.asarray(a) for a in inputs), keys, jnp.int32(0))
        out[name] = (jax.tree_util.tree_map(np.asarray, res), draws)
    yield p_cfg, inputs, out
    jax.clear_caches()


def test_cells_block_equals_the_reference_vmap(ref, monkeypatch):
    p_cfg, inputs, out = ref
    want, draws = out["step"]
    assert len(draws.drawn) == N_DRAWS
    monkeypatch.setattr(p_wb, "_randn", _replay(draws))
    got = p_wbd.make_dyn_block_step(p_cfg, device="cpu", n_cells=N_CELLS)(
        *inputs, _gens((7, 8)), 0)
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, (k, got[k].shape, v.shape)
        if k in ("dl_out", "ul_out"):  # delivered bits: the rows whose CRC passed
            ok = want[k[:2] + "_ok"]
            np.testing.assert_array_equal(got[k][ok], v[ok], err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    Tn = p_cfg.T * p_cfg.n_ues
    assert (got["dl_ok"].sum((1, 2, 3)) == Tn).all() and (got["ack_det"].sum() == 2 * Tn)


def test_cells_bench_equals_the_reference(ref, monkeypatch):
    p_cfg, inputs, out = ref
    want, draws = out["bench"]
    monkeypatch.setattr(p_wb, "_randn", _replay(draws))
    got = p_wbd.make_bench_step(p_cfg, n_cells=N_CELLS, device="cpu")(
        *inputs, _gens((7, 8)), 0)
    assert [int(x) for x in got] == [int(x) for x in want]
    Tn = N_CELLS * p_cfg.T * p_cfg.n_ues
    assert [int(x) for x in got] == [Tn, Tn, Tn, 0, 0, 0]


def _one_cell(cfg, inputs, c, seed, **kw):
    return p_wbd.make_dyn_block_step(cfg, device="cpu", **kw)(
        *(a[c] for a in inputs), _gens((seed,))[0], 0)


def test_cells_block_equals_one_cell_blocks():
    """Real generators, one per cell: the two-cell block is the two
    one-cell blocks side by side, every output (the harq case, where
    retransmissions, drops and DCI misses happen, at R=3)."""
    cfg, _ = _dyn_cfgs(R=3, dl_mcs=16, snr_db=(8.0, -6.0))
    inputs = _cell_inputs(cfg)
    both = p_wbd.make_dyn_block_step(cfg, device="cpu", n_cells=N_CELLS)(
        *inputs, _gens((11, 12)), 0)
    for c, seed in enumerate((11, 12)):
        one = _one_cell(cfg, inputs, c, seed)
        assert set(one) == set(both)
        for k, v in one.items():
            torch.testing.assert_close(both[k][c], v, rtol=0, atol=0, msg=k)
    counts = p_wbd.make_bench_step(cfg, n_cells=N_CELLS, device="cpu")(
        *inputs, _gens((11, 12)), 0)
    singles = [p_wbd.make_bench_step(cfg, device="cpu")(*(a[c] for a in inputs),
                                                          _gens((s,))[0], 0)
               for c, s in enumerate((11, 12))]
    assert [int(x) for x in counts] == [int(a) + int(b) for a, b in zip(*singles)]
    assert int(counts[3]) > 0 and int(counts[5]) > 0  # retransmissions and DCI misses


def test_cells_axis_runs_the_ops_of_one_cell():
    """The cells ride the row axis: a block of 2 cells runs about as many
    torch ops as a block of 1 (the per-cell noise draws are the only ops
    that repeat), not twice as many as a loop over cells would."""
    cfg, _ = _dyn_cfgs(R=1)
    inputs = _cell_inputs(cfg)

    def n_ops(c, gens):
        step = p_wbd.make_dyn_block_step(cfg, device="cpu", n_cells=c)
        args = inputs if c > 1 else tuple(a[0] for a in inputs)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            step(*args, gens if c > 1 else gens[0], 0)
        return sum(e.count for e in prof.key_averages())

    one, two = n_ops(1, _gens((1,))), n_ops(2, _gens((1, 2)))
    assert two < 1.1 * one, (one, two)
