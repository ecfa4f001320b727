"""PyTorch port vs the JAX package: the multi-device layer (parallel/mesh.py,
parallel/ota_collective.py, parallel/dryrun.py) and what runs over it
(pdsch_link.make_link_step_sharded, waveblock.make_block_step_sharded,
netscan.network_scan with a mesh).

The port's mesh is driven by one process (single controller, as JAX is);
here it lays 4 virtual CPU devices (the JAX side runs on 4 of the 8 virtual
XLA CPU devices of tests/conftest.py).  Tolerances: the OTA mix and the
psum to atol 1e-5 (f32 products of the same inputs); bits, CRC flags, PCIs
and transfer counts exactly; the sharded block's ack_val to 1e-3 relative
and ack_energy to 2e-3 (tests/test_torch_waveblock.py's bounds: the
reference rounds its DFT inputs to bf16).  The two packages draw different
noise, so the JAX-vs-port cases compare what the noise cannot change at
these SNRs (bits, CRCs, PCIs) or feed both the same numpy draws; the sharded
port steps are held bit for bit against the unsharded port steps on the
same injected noise.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srslte_emane_tpu.models import netscan as j_netscan, pdsch_link as j_link
from srslte_emane_tpu.parallel import mesh as j_mesh, ota_collective as j_ota
from srslte_emane_tpu.phch import grid as j_grid
from srslte_emane_tpu.runtime import waveblock as j_wb
from srslte_emane_tpu_torch.models import enb_dl as p_enb_dl, netscan as p_netscan
from srslte_emane_tpu_torch.models import pdsch_link as p_link, ue_dl as p_ue_dl
from srslte_emane_tpu_torch.ops import channel as p_channel, cplx as p_cplx
from srslte_emane_tpu_torch.parallel import dryrun as p_dryrun, mesh as p_mesh
from srslte_emane_tpu_torch.parallel import ota_collective as p_ota
from srslte_emane_tpu_torch.phch import grid as p_grid, pdcch as p_pdcch
from srslte_emane_tpu_torch.runtime import waveblock as p_wb
from test_torch_waveblock import ACK_RTOL, Draws, _sps_cfgs

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

ATOL = 1e-5
N_DEV = 4


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _dense_mix(g, tx):
    """tests/test_ota_collective.py's dense reference."""
    n = g.shape[0]
    g = g * (1.0 - np.eye(n, dtype=np.float32))
    xc = tx[..., 0] + 1j * tx[..., 1]
    yc = np.einsum("mn,nbs->mbs", g, xc)
    return np.stack([yc.real, yc.imag], axis=-1).astype(np.float32)


def _jax_node_sharded(mesh, x):
    return jax.device_put(x, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("node", None, None, None)))


# ---------------- the mesh ----------------

@pytest.mark.parametrize("n,node_axis", [(1, None), (2, None), (4, None), (8, None), (6, None),
                                         (4, 4), (8, 2), (4, 1)])
def test_make_mesh_shape_matches_jax(n, node_axis):
    got = p_mesh.make_mesh(n, node_axis=node_axis, device="cpu")
    ref = j_mesh.make_mesh(n, node_axis=node_axis)
    assert got.shape == dict(ref.shape)
    assert got.axis_names == tuple(ref.axis_names)
    assert got.size == n and got.transfers == 0


def test_make_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_mesh.make_mesh(2)


def test_shardings_place_and_gather():
    mesh = p_mesh.make_mesh(N_DEV, device="cpu")
    x = torch.arange(8 * 3).reshape(8, 3)
    shards = p_mesh.batch_sharding(mesh, x)
    assert [s.shape[0] for s in shards] == [2] * N_DEV
    assert torch.equal(p_mesh.gather(shards), x)
    nodes = p_mesh.node_sharding(mesh, x)
    assert len(nodes) == mesh.shape["node"] and torch.equal(p_mesh.gather(nodes), x)
    assert all(torch.equal(r, x) for r in p_mesh.replicated(mesh, x))
    assert mesh.transfers == 0  # placement moves nothing between devices
    with pytest.raises(ValueError, match="equal shards"):
        p_mesh.batch_sharding(mesh, x[:6])


# ---------------- the OTA collective (tests/test_ota_collective.py) ----------------

def test_ota_mix_matches_jax_and_dense():
    n, B, S = 8, 3, 64
    rng = np.random.default_rng(0)
    tx = rng.normal(size=(n, B, S, 2)).astype(np.float32)
    g = (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))).astype(np.complex64)
    jm = j_mesh.make_mesh(N_DEV)
    ref = np.asarray(j_ota.ota_mix_sharded(jm, _jax_node_sharded(jm, tx), g))
    mesh = p_mesh.make_mesh(N_DEV, device="cpu")
    rx = p_ota.ota_mix_sharded(mesh, torch.from_numpy(tx), g)
    assert len(rx) == mesh.shape["node"]  # node-sharded like tx
    got = p_mesh.gather(rx).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, _dense_mix(g, tx), rtol=1e-4, atol=1e-4)
    # the all-gather: every node shard to every other node row, once
    k = mesh.shape["node"]
    assert mesh.transfers == k * (k - 1)


def test_ota_mix_noise_equals_the_dense_draw():
    """The noise is drawn from the generator over the whole shape, so the
    sharded medium adds what one dense draw adds."""
    n, B, S = 8, 2, 32
    rng = np.random.default_rng(4)
    tx = rng.normal(size=(n, B, S, 2)).astype(np.float32)
    g = (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))).astype(np.complex64)
    mesh = p_mesh.make_mesh(N_DEV, device="cpu")
    got = p_mesh.gather(p_ota.ota_mix_sharded(mesh, p_mesh.node_sharding(mesh, tx), g,
                                              gen=torch.Generator().manual_seed(5),
                                              noise_std=0.3)).numpy()
    noise = 0.3 * torch.randn((n, B, S, 2), generator=torch.Generator().manual_seed(5)) / np.sqrt(2)
    np.testing.assert_allclose(got, _dense_mix(g, tx) + noise.numpy(), rtol=1e-4, atol=1e-4)


def test_ota_mix_noise_moves_nothing_and_advances_gen_as_one_draw():
    """Each device draws its noise from a copy of gen's state (no noise
    tensor moves between devices: the transfers are the all-gather's
    alone), and gen ends where one dense draw leaves it."""
    n, B, S = 8, 2, 32
    tx = np.random.default_rng(6).normal(size=(n, B, S, 2)).astype(np.float32)
    g = np.ones((n, n), np.complex64)
    mesh = p_mesh.make_mesh(N_DEV, device="cpu")
    gen, dense = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    p_ota.ota_mix_sharded(mesh, p_mesh.node_sharding(mesh, tx), g, gen=gen, noise_std=0.1)
    k = mesh.shape["node"]
    assert mesh.transfers == k * (k - 1)
    torch.randn((n, B, S, 2), generator=dense)
    assert torch.equal(torch.randn(4, generator=gen), torch.randn(4, generator=dense))


def test_total_rx_power_psum_matches_jax():
    rng = np.random.default_rng(1)
    tx = rng.normal(size=(8, 2, 32, 2)).astype(np.float32)
    jm = j_mesh.make_mesh(N_DEV)
    ref = float(j_ota.total_rx_power_psum(jm, _jax_node_sharded(jm, tx)))
    mesh = p_mesh.make_mesh(N_DEV, device="cpu")
    got = p_ota.total_rx_power_psum(mesh, p_mesh.node_sharding(mesh, tx))
    assert got.ndim == 0
    np.testing.assert_allclose(float(got), ref, rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(float(got), sum(np.mean(np.sum(tx[i] ** 2, -1)) for i in range(8)),
                               rtol=1e-5)
    assert mesh.transfers == mesh.shape["node"] - 1  # one scalar per node row


# ---------------- multi-cell over the sharded medium (test_multicell.py) ----------------

def _cell_cfg(pci, prb_lo, prb_hi, n_prb=15, rnti=0x50):
    """tests/test_multicell.py's _cell_cfg on the port."""
    cell = p_grid.CellConfig(n_prb=n_prb, cell_id=pci, cfi=2)
    cand = next(c for c in p_pdcch.candidates(cell, rnti, 1) if c[0] == 4)
    mask = tuple(1 if prb_lo <= i < prb_hi else 0 for i in range(n_prb))
    tbs = (p_grid.nof_re(cell, 1, mask) * 2 // 3) // 8 * 8
    return p_enb_dl.DlSubframeConfig(cell=cell, sf_idx=1, grants=((rnti, mask, 2, tbs, *cand),))


def test_multicell_over_sharded_ota_medium():
    """test_multicell.py::test_multicell_over_sharded_ota_medium on the port:
    each of 4 mesh nodes hosts one (cell, UE) pair, the serving signal stays
    node-local, the interference rides the sharded medium (held against the
    JAX medium on the same waveforms), and every UE decodes its serving cell
    through it."""
    n = N_DEV
    mesh = p_mesh.make_mesh(n, node_axis=n, device="cpu")
    rng = np.random.default_rng(0)
    cfgs = [_cell_cfg(10 + ci, 3 * ci, 3 * ci + 3) for ci in range(n)]
    B = 2
    payloads = [rng.integers(0, 2, (B, c.grants[0][3]), dtype=np.int8) for c in cfgs]
    txs = torch.stack([p_enb_dl.build_subframe(c, [_t(p)]) for c, p in zip(cfgs, payloads)])
    # link gains: serving (diagonal) 0 dB; interference -20 dB
    g = np.full((n, n), 10 ** (-20 / 20), np.complex64)
    np.fill_diagonal(g, 0.0)  # diagonal handled locally below
    shards = p_mesh.node_sharding(mesh, txs)
    interference = p_ota.ota_mix_sharded(mesh, shards, g, noise_std=0.0)
    jm = j_mesh.make_mesh(n, node_axis=n)
    ref = np.asarray(j_ota.ota_mix_sharded(jm, _jax_node_sharded(jm, txs.numpy()), g))
    np.testing.assert_allclose(p_mesh.gather(interference).numpy(), ref, rtol=0, atol=ATOL)
    gen = torch.Generator().manual_seed(3)
    for ui, cfg in enumerate(cfgs):
        rx = p_channel.awgn(gen, interference[ui] + shards[ui], 25.0)[0]  # serving never moves
        res, _ = p_ue_dl.decode_subframe(rx, cfg)
        assert res.crc_ok[0].all(), ui
        assert (res.payloads[0].numpy() == payloads[ui]).all(), ui


# ---------------- the scan (test_netscan.py) ----------------

def _scan_case(N=16):
    rng = np.random.default_rng(0)
    ids = rng.choice(504, N, replace=False).astype(np.int32)
    g = 0.05 * (rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N)))
    for i in range(N):
        g[i, (i + 1) % N] = 1.0  # one dominant neighbor per observer
    return ids, g.astype(np.complex64), ids[(np.arange(N) + 1) % N]


def test_sharded_network_scan_identifies_neighbors():
    ids, g, want = _scan_case()
    ref = j_netscan.network_scan(j_mesh.make_mesh(N_DEV), ids, g, key=jax.random.PRNGKey(0),
                                 noise_std=0.02)
    mesh = p_mesh.make_mesh(N_DEV, device="cpu")
    got = p_netscan.network_scan(mesh, ids, g, gen=torch.Generator().manual_seed(0),
                                 noise_std=0.02)
    np.testing.assert_array_equal(got["cell_id"].numpy(), np.asarray(ref["cell_id"]))
    np.testing.assert_array_equal(got["cell_id"].numpy(), want)
    assert mesh.transfers == mesh.shape["node"] * (mesh.shape["node"] - 1)


def test_sharded_scan_equals_the_unsharded_scan():
    """With the mesh and without it, on one generator seed: every output
    of the search equal (the ids given as a tensor)."""
    ids, g, _ = _scan_case()
    got = p_netscan.network_scan(p_mesh.make_mesh(N_DEV, device="cpu"), torch.from_numpy(ids), g,
                                 gen=torch.Generator().manual_seed(7), noise_std=0.05)
    ref = p_netscan.network_scan(None, ids, g, gen=torch.Generator().manual_seed(7),
                                 noise_std=0.05, device="cpu")
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


# ---------------- the sharded link (pdsch_link.make_link_step_sharded) ----------------

LINK = dict(qm=6, code_rate=0.55, snr_db=20.0, llr_bits=16)  # the bench cell at 6 PRB


def _link_cfgs():
    return (p_link.LinkConfig(cell=p_grid.CellConfig(n_prb=6, cell_id=1, cfi=1), **LINK),
            j_link.LinkConfig(cell=j_grid.CellConfig(n_prb=6, cell_id=1, cfi=1), **LINK))


def test_link_step_sharded_matches_jax():
    pcfg, jcfg = _link_cfgs()
    payload = np.random.default_rng(0).integers(0, 2, (8, pcfg.tbs), dtype=np.int8)
    j_out, j_ok, _ = j_link.make_link_step_sharded(jcfg, j_mesh.make_mesh(N_DEV))(
        payload, jax.random.PRNGKey(0))
    mesh = p_mesh.make_mesh(N_DEV, device="cpu")
    out, ok, snr = p_link.make_link_step_sharded(pcfg, mesh)(payload, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
    assert ok.all() and (out.numpy() == payload).all()
    assert snr.shape == (8,) and bool((snr > 15).all())
    assert mesh.transfers == 0  # collective-free by construction


def test_link_step_sharded_equals_unsharded_on_injected_noise(monkeypatch):
    pcfg, _ = _link_cfgs()
    rng = np.random.default_rng(1)
    payload = rng.integers(0, 2, (8, pcfg.tbs), dtype=np.int8)
    B, T = 8, 1920  # 6 PRB: 1.92 Msps
    noise = rng.standard_normal((B, T, 2)).astype(np.float32)

    def replay():
        """channel.awgn adding the next rows of `noise` (per real
        component), scaled as awgn scales its own draw."""
        at = [0]

        def awgn(gen, x, snr_db, signal_power=None):
            p = p_cplx.abs2(x).reshape(x.shape[0], -1).mean(dim=-1)
            s = torch.sqrt(p / 10 ** (snr_db / 10) / 2).reshape((-1,) + (1,) * (x.ndim - 1))
            rows = noise[at[0]:at[0] + x.shape[0]]
            at[0] += x.shape[0]
            return x + _t(rows) * s
        return awgn

    monkeypatch.setattr(p_channel, "awgn", replay())
    mesh = p_mesh.make_mesh(N_DEV, device="cpu")
    got = p_link.make_link_step_sharded(pcfg, mesh)(payload, torch.Generator().manual_seed(0))
    monkeypatch.setattr(p_channel, "awgn", replay())
    ref = p_link.make_link_step(pcfg)(torch.from_numpy(payload), torch.Generator())
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    torch.testing.assert_close(got[2], ref[2], rtol=1e-5, atol=1e-4)
    assert got[1].all() and (got[0].numpy() == payload).all()


def test_link_step_sharded_noise_per_device():
    """Each position draws from its own generator, seeded from the step's
    generator and its (node, sf) coordinates: equal subframes come out of
    different positions with different SNR estimates, and the same
    generator seed repeats the step."""
    pcfg, _ = _link_cfgs()
    mesh = p_mesh.make_mesh(N_DEV, device="cpu")
    step = p_link.make_link_step_sharded(pcfg, mesh)
    payload = np.tile(np.random.default_rng(2).integers(0, 2, (1, pcfg.tbs), dtype=np.int8),
                      (N_DEV, 1))
    a = step(payload, torch.Generator().manual_seed(9))
    b = step(payload, torch.Generator().manual_seed(9))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert len(set(a[2].tolist())) == N_DEV
    seeds = {p_link._device_seed(123, *divmod(pos, mesh.shape["sf"])) for pos in range(N_DEV)}
    assert len(seeds) == N_DEV


# ---------------- the sharded block (waveblock.make_block_step_sharded) ----------------

CELLS = (1, 2, 3, 4)


@pytest.fixture(scope="module")
def block_case():
    """(port cfg, JAX cfg, payloads (C, ...), the draws, the JAX sharded
    block's outputs) on 4 devices, 15 PRB, 2 UEs, T=2, MCS 10; the JAX
    step's jax.random.normal answered by numpy draws (its shard_map body is
    traced once, so every cell reads the same draws)."""
    p_cfg, j_cfg = _sps_cfgs(False)
    rng = np.random.default_rng(0)
    C = len(CELLS)
    dl = rng.integers(0, 2, (C, p_cfg.T, p_cfg.n_ues, p_cfg.dl_tbs), dtype=np.int8)
    ul = rng.integers(0, 2, (C, p_cfg.T, p_cfg.n_ues, p_cfg.ul_tbs), dtype=np.int8)
    draws = Draws(11)
    j_step, _ = j_wb.make_block_step_sharded(j_cfg, j_mesh.make_mesh(C), CELLS, sfn0=4)
    keys = jax.vmap(jax.random.PRNGKey)(np.arange(C, dtype=np.uint32))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax.random, "normal", draws.jax_normal)
        out = j_step(dl, ul, keys, jnp.int32(20))
    return p_cfg, (dl, ul), draws, {k: np.asarray(v) for k, v in out.items()}


def test_block_step_sharded_matches_jax(block_case, monkeypatch):
    p_cfg, (dl, ul), draws, ref = block_case
    monkeypatch.setattr(p_wb, "_randn", draws.port_randn(calls=len(draws.drawn)))
    mesh = p_mesh.make_mesh(len(CELLS), device="cpu")
    step, consts = p_wb.make_block_step_sharded(p_cfg, mesh, CELLS, sfn0=4)
    assert len(consts) == len(CELLS)
    got = {k: v.numpy() for k, v in step(dl, ul, [torch.Generator()] * len(CELLS), 20).items()}
    assert set(got) == set(ref)
    for k in ("dl_ok", "ul_ok", "dl_out", "ul_out"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["dl_ok"].all() and got["ul_ok"].all()
    assert (got["dl_out"] == dl).all() and (got["ul_out"] == ul).all()
    np.testing.assert_allclose(got["ack_val"], ref["ack_val"], rtol=ACK_RTOL)
    np.testing.assert_allclose(got["ack_energy"], ref["ack_energy"], rtol=2 * ACK_RTOL)
    assert (got["ack_energy"] > 0.25).all()
    assert mesh.transfers == 0


def test_block_step_sharded_equals_unsharded_steps(block_case, monkeypatch):
    """Four cells on four devices against four one-cell steps, each of its
    own cell, on the same injected draws: every output equal."""
    p_cfg, (dl, ul), _, _ = block_case

    def draws():
        rng = np.random.default_rng(5)
        return lambda gen, shape, device: torch.from_numpy(
            rng.standard_normal(tuple(shape)).astype(np.float32)).to(device)

    monkeypatch.setattr(p_wb, "_randn", draws())
    mesh = p_mesh.make_mesh(len(CELLS), device="cpu")
    step, _ = p_wb.make_block_step_sharded(p_cfg, mesh, CELLS, sfn0=4)
    got = step(torch.from_numpy(dl), torch.from_numpy(ul), [torch.Generator()] * len(CELLS), 20)
    monkeypatch.setattr(p_wb, "_randn", draws())
    for c, cid in enumerate(CELLS):
        cell = p_grid.CellConfig(n_prb=p_cfg.cell.n_prb, cell_id=cid, cfi=p_cfg.cell.cfi)
        one = p_wb.make_block_step(p_cfg._replace(cell=cell), sfn0=4, device="cpu")(
            dl[c], ul[c], torch.Generator(), 20)
        for k, v in one.items():
            assert torch.equal(got[k][c], v), (cid, k)


# ---------------- the dry run (twin of __graft_entry__.dryrun_multichip) ----------------

def test_dryrun_is_collective_free(capsys):
    pcfg, _ = _link_cfgs()
    head = p_dryrun.dryrun(N_DEV, "cpu", pcfg)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0] == head
    assert head == {"dryrun_devices": N_DEV, "mesh": {"node": 2, "sf": 2},
                    "link_step_cross_device_transfers": 0, "collective_free": True}
    table = lines[1]["scaling_table"]
    assert [r["devices"] for r in table] == [1, 2, 4]
    assert all(r["cross_device_transfers"] == 0 and r["sf_per_s"] > 0 for r in table)
    assert lines[2]["waveform_multicell"]["cross_device_transfers"] == 0
    assert lines[3]["ota_collective"] == {"nodes": 4, "mix_cross_device_transfers": 2,
                                          "psum_cross_device_transfers": 1}


def test_dryrun_bench_config_is_the_bench_cell():
    cfg = p_dryrun.bench_config()
    assert (cfg.cell.n_prb, cfg.qm, cfg.code_rate, cfg.llr_bits, cfg.tbs) == (100, 6, 0.55, 16,
                                                                             49472)
