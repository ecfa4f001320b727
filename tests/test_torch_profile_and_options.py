"""PyTorch port vs the JAX package: the last of the reference's surface.

* The three profiling entry points (`scripts/profile_{turbo,mimo,dynblock}.py`
  and their twins `srslte_emane_tpu_torch.scripts.profile_*`), stage by
  stage on the same inputs.  The JAX side is the reference script's own
  stage code, jitted, with its TPU kernels in interpret mode.
  - profile_turbo at 8 x K=1056 (W=8, L=132): each half-iteration's
    posterior to atol 1e-3 / rtol 1e-4 (the port's MAPs against the TPU
    kernels and the XLA MAP; float32 sums in another order).  The decodes
    run on random LLRs, so no CRC passes; their hard decisions agree on at
    least 99.9 % of the bits (a bit whose posterior is within rounding of 0
    follows the last float difference, as in any failed decode).
  - profile_mimo at 6 PRB, batch 2, on the JAX received grids: the channel
    estimate, the streams and CSI to a relative RMS of 1e-5, the LLRs to
    1e-5, every CRC flag and the decoded bits exactly.
  - profile_dynblock at 15 PRB, 2 UEs, R=1: every variant's block outputs
    equal (flags, counters, RVs, RBs exactly; the delivered bits on the rows
    whose CRC passed), with the reference's stubs in the JAX step and the
    script's in the port's.
* The options and names the port had folded into constants or left out:
  `BlockConfig.mimo_cond_db` / `mimo_seed` (the reference's rank-1
  scenario: every codeword fails and a NACK rides the PUCCH),
  `DynBlockConfig.l_aggr` / `max_tx` / `ack_thresh` and
  `feasible_rntis(l_aggr=)`, `pdsch.encode/decode(codeword_q=, use_csi=,
  re_idx=)`, `grid.reserved_mask(has_pss_sss=, has_pbch=)`,
  `dft/idft(n=, ortho=)`, `scramble_*(n=)`, `cplx.re/im/scale/div`,
  `ofdm.N_SYM_SF` and the NumPy oracles: bits and tables exactly, floats
  within the stated tolerance.

Block noise: `jax.random.normal` is patched while a JAX step traces to hand
out numpy draws, which the port's `_randn` replays (`test_torch_waveblock`'s
`Draws`).  The per-UE fallback of `WaveUePhy.run_tti` is held in
`test_torch_wavenet.py`, on that file's lockstep network.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srslte_emane_tpu.ops import cplx as j_cplx
from srslte_emane_tpu.ops import dft as j_dft
from srslte_emane_tpu.ops import modem as j_modem
from srslte_emane_tpu.ops import ofdm as j_ofdm
from srslte_emane_tpu.ops import scrambling as j_scr
from srslte_emane_tpu.ops.fec import crc as j_crc
from srslte_emane_tpu.ops.fec import turbo as j_turbo
from srslte_emane_tpu.phch import grid as j_grid
from srslte_emane_tpu.phch import pdsch as j_pdsch
from srslte_emane_tpu.utils import gf2 as j_gf2
from srslte_emane_tpu_torch.ops import cplx as p_cplx
from srslte_emane_tpu_torch.ops import dft as p_dft
from srslte_emane_tpu_torch.ops import modem as p_modem
from srslte_emane_tpu_torch.ops import ofdm as p_ofdm
from srslte_emane_tpu_torch.ops import scrambling as p_scr
from srslte_emane_tpu_torch.ops.fec import crc as p_crc
from srslte_emane_tpu_torch.ops.fec import turbo as p_turbo
from srslte_emane_tpu_torch.phch import grid as p_grid
from srslte_emane_tpu_torch.phch import pdsch as p_pdsch
from srslte_emane_tpu_torch.phch import sch as p_sch
from srslte_emane_tpu_torch.utils import gf2 as p_gf2

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _rel_rms(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


# ---------------- ops: cplx, dft, scrambling, ofdm and the oracles ----------------

def test_cplx_helpers_equal():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 3, 5, 2)).astype(np.float32)
    s = rng.normal(size=(3, 5)).astype(np.float32)
    for name in ("re", "im"):
        np.testing.assert_array_equal(getattr(p_cplx, name)(_t(a)).numpy(),
                                      np.asarray(getattr(j_cplx, name)(jnp.asarray(a))))
    np.testing.assert_array_equal(p_cplx.scale(_t(a), _t(s)).numpy(),
                                  np.asarray(j_cplx.scale(jnp.asarray(a), s)))
    np.testing.assert_array_equal(p_cplx.scale(_t(a), 0.5).numpy(),
                                  np.asarray(j_cplx.scale(jnp.asarray(a), 0.5)))
    for eps in (0.0, 0.1):
        np.testing.assert_allclose(p_cplx.div(_t(a), _t(b), eps).numpy(),
                                   np.asarray(j_cplx.div(jnp.asarray(a), jnp.asarray(b), eps)),
                                   rtol=1e-6, atol=1e-6)
    want = p_cplx.to_numpy(_t(a)) / p_cplx.to_numpy(_t(b))
    np.testing.assert_allclose(p_cplx.to_numpy(p_cplx.div(_t(a), _t(b))), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [12, 256])
@pytest.mark.parametrize("ortho", [True, False])
def test_dft_n_and_ortho(n, ortho):
    """The reference rounds its DFT inputs to bf16 (relative RMS bound 1e-2);
    both equal np.fft's scaling, which dft_host states exactly."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(3, n, 2)).astype(np.float32)
    xc = x[..., 0] + 1j * x[..., 1]
    for inverse in (False, True):
        got = (p_dft.idft(_t(x), n, ortho=ortho) if inverse
               else p_dft.dft(_t(x), n, ortho=ortho)).numpy()
        ref = np.asarray(j_dft.idft(jnp.asarray(x), n, ortho=ortho) if inverse
                         else j_dft.dft(jnp.asarray(x), n, ortho=ortho))
        assert _rel_rms(got, ref) < 1e-2, _rel_rms(got, ref)
        host = p_dft.dft_host(xc, inverse, ortho)
        np.testing.assert_array_equal(host, j_dft.dft_host(xc, inverse, ortho))
        np.testing.assert_allclose(got[..., 0] + 1j * got[..., 1], host, rtol=1e-4, atol=1e-4)
    # the defaults are the reference's: ortho, n from the input
    np.testing.assert_array_equal(p_dft.dft(_t(x)).numpy(),
                                  p_dft.dft(_t(x), n, inverse=False, ortho=True).numpy())
    with pytest.raises(ValueError):
        p_dft.dft(_t(x), n + 1)


def test_scrambling_n_equal():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (2, 300), dtype=np.int8)
    llrs = rng.normal(size=(2, 300)).astype(np.float32)
    c_init = p_scr.pdsch_cinit(0x46, 1, 3, 7)
    for n in (None, 300):
        np.testing.assert_array_equal(p_scr.scramble_bits(_t(bits), c_init, n).numpy(),
                                      np.asarray(j_scr.scramble_bits(jnp.asarray(bits), c_init, n)))
        np.testing.assert_array_equal(p_scr.scramble_llrs(_t(llrs), c_init, n).numpy(),
                                      np.asarray(j_scr.scramble_llrs(jnp.asarray(llrs), c_init, n)))
    # a one-column input broadcasts against an n-long sequence, as in the reference
    np.testing.assert_array_equal(p_scr.scramble_bits(_t(bits[:, :1]), c_init, 40).numpy(),
                                  np.asarray(j_scr.scramble_bits(jnp.asarray(bits[:, :1]),
                                                                 c_init, 40)))


def test_oracles_and_constants_equal():
    rng = np.random.default_rng(2)
    assert p_ofdm.N_SYM_SF == j_ofdm.N_SYM_SF == 14
    for poly in (j_crc.LTE_CRC24A, j_crc.LTE_CRC24B, j_crc.LTE_CRC16, j_crc.LTE_CRC8):
        bits = rng.integers(0, 2, 97, dtype=np.int8)
        np.testing.assert_array_equal(p_crc.crc_host(bits, poly), j_crc.crc_host(bits, poly))
        # the oracle agrees with the port's batched CRC
        np.testing.assert_array_equal(p_crc.crc_host(bits, poly),
                                      p_crc.crc_bits(_t(bits[None]), poly)[0].numpy())
    for k in (40, 512):
        u = rng.integers(0, 2, k, dtype=np.int8)
        ref = j_turbo.turbo_encode_host(u)
        for got, want, dev in zip(p_turbo.turbo_encode_host(u), ref,
                                  p_turbo.turbo_encode(_t(u[None]))):
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, dev[0].numpy())
    for mod in p_modem.BITS_PER_SYMBOL:
        pts = p_modem.constellation(mod)
        np.testing.assert_array_equal(pts, j_modem.constellation(mod))
        qm = p_modem.BITS_PER_SYMBOL[mod]
        v = np.arange(1 << qm)
        bits = ((v[:, None] >> (qm - 1 - np.arange(qm))) & 1).astype(np.int8).reshape(1, -1)
        sym = p_cplx.to_numpy(p_modem.modulate(_t(bits), mod))[0]
        np.testing.assert_allclose(sym, pts, atol=1e-6)
    for poly, deg in ((0b10011, 4), (0x864CFB, 24), (1 << 31 | 9, 31)):
        np.testing.assert_array_equal(p_gf2.poly_to_taps(poly, deg), j_gf2.poly_to_taps(poly, deg))


@pytest.mark.parametrize("sf", [0, 1, 5])
def test_reserved_mask_flags_equal(sf):
    for n_ports in (1, 2):
        kw = dict(n_prb=15, cell_id=3, cfi=2, n_ports=n_ports)
        pc, jc = p_grid.CellConfig(**kw), j_grid.CellConfig(**kw)
        for pss in (True, False):
            for pbch in (True, False):
                got = p_grid.reserved_mask(pc, sf, pss, pbch)
                np.testing.assert_array_equal(got, j_grid.reserved_mask(jc, sf, pss, pbch))
                np.testing.assert_array_equal(
                    p_grid.reserved_mask(pc, sf, has_pss_sss=pss, has_pbch=pbch), got)
        np.testing.assert_array_equal(p_grid.reserved_mask(pc, sf),
                                      p_grid.reserved_mask(pc, sf, True, True))


# ---------------- pdsch: codeword_q, use_csi, re_idx ----------------

PDSCH_CELL = dict(n_prb=6, cell_id=5, cfi=2)


def _pdsch_case():
    """6 PRB, sf 1, PRBs 1-4, QPSK: (cells, cfg, mask, payload, re_idx)."""
    pc, jc = p_grid.CellConfig(**PDSCH_CELL), j_grid.CellConfig(**PDSCH_CELL)
    mask = (0, 1, 1, 1, 1, 0)
    re_idx = j_grid.pdsch_re_indices(jc, 1, mask)
    G = len(re_idx) * 2
    tbs = (G // 3 - 24) // 8 * 8
    payload = np.random.default_rng(3).integers(0, 2, (2, tbs), dtype=np.int8)
    return pc, jc, p_sch.SchConfig(tbs=tbs, G=G, Qm=2, Nl=1), mask, payload, re_idx


def test_pdsch_codeword_q_csi_and_re_idx_equal():
    from srslte_emane_tpu.phch import sch as j_sch

    pc, jc, pcfg, mask, payload, re_idx = _pdsch_case()
    jcfg = j_sch.SchConfig(tbs=pcfg.tbs, G=pcfg.G, Qm=2, Nl=1)
    rnti = 0x3C
    # encode: codeword 1's scrambling, the table given explicitly, onto a grid
    base = np.random.default_rng(4).normal(size=(2, 14, 72, 2)).astype(np.float32)
    g_j = np.asarray(jax.jit(lambda p, g: j_pdsch.encode(
        p, jcfg, jc, 1, rnti, mask, grid=g, codeword_q=1, re_idx=jnp.asarray(re_idx)))(
            payload, base))
    g_p = p_pdsch.encode(_t(payload), pcfg, pc, 1, rnti, mask, grid=_t(base), codeword_q=1,
                         re_idx=_t(re_idx))
    np.testing.assert_allclose(g_p.numpy(), g_j, atol=1e-6)
    # a fresh grid through re_idx equals the one-gather assembly of prb_mask
    fresh = p_pdsch.encode(_t(payload), pcfg, pc, 1, rnti, mask, codeword_q=1, re_idx=re_idx)
    np.testing.assert_array_equal(
        fresh.numpy(), p_pdsch.encode(_t(payload), pcfg, pc, 1, rnti, mask, codeword_q=1).numpy())
    # codeword 0 scrambles differently
    assert not torch.equal(fresh, p_pdsch.encode(_t(payload), pcfg, pc, 1, rnti, mask))
    # decode from one numpy grid: codeword 1, no CSI weights, the explicit table
    rng = np.random.default_rng(5)
    rx = (np.asarray(fresh) + 0.05 * rng.normal(size=fresh.shape)).astype(np.float32)
    out_j = jax.jit(lambda g: j_pdsch.decode(g, jcfg, jc, 1, rnti, mask, codeword_q=1,
                                             use_csi=False, re_idx=jnp.asarray(re_idx))[:2])(rx)
    bits, ok, _, _ = p_pdsch.decode(_t(rx), pcfg, pc, 1, rnti, mask, codeword_q=1,
                                    use_csi=False, re_idx=_t(re_idx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(out_j[1]))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(out_j[0]))
    assert ok.all() and (bits.numpy() == payload).all()
    # the wrong codeword's scrambling fails every CRC
    assert not p_pdsch.decode(_t(rx), pcfg, pc, 1, rnti, mask)[1].any()


# ---------------- the SPS TM3 block: mimo_cond_db and mimo_seed ----------------

# the reference's _roundtrip / _rank1 (tests/test_waveblock_tm3.py) and
# another channel draw
TM3_CASES = {"roundtrip": dict(mimo_cond_db=0.0), "rank1": dict(mimo_cond_db=60.0),
             "seed5": dict(mimo_seed=5)}


@pytest.fixture(scope="module")
def tm3_blocks():
    """Per case: (port cfg, JAX tables, JAX outputs) of the SPS TM3 block at
    15 PRB, 2 UEs, T=2.  The JAX body compiles once with its tables as
    arguments (the channel is a table), so all cases share its noise."""
    from srslte_emane_tpu.runtime import waveblock as j_wb

    from test_torch_waveblock import Draws, _sps_cfgs, _sps_payloads

    p_cfg0, j_cfg0 = _sps_cfgs(True)
    dl, ul = _sps_payloads(p_cfg0, 0)
    draws = Draws(11)
    body = jax.jit(lambda c, d, u, key, tti0: j_wb._step_body(j_cfg0, c, d, u, key, tti0))
    out = {}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax.random, "normal", draws.jax_normal)
        for case, kw in TM3_CASES.items():
            p_cfg, j_cfg = _sps_cfgs(True, **kw)
            consts = j_wb._cell_consts(j_cfg, 12)
            res = body(consts, dl, ul, jax.random.PRNGKey(0), jnp.int32(120))
            out[case] = (p_cfg, consts, jax.tree_util.tree_map(np.asarray, res))
    return out, (dl, ul), draws


@pytest.mark.parametrize("case", list(TM3_CASES))
def test_tm3_block_condition_and_seed_equal(tm3_blocks, case, monkeypatch):
    from test_torch_waveblock import ACK_RTOL

    from srslte_emane_tpu_torch.runtime import waveblock as p_wb

    blocks, (dl, ul), draws = tm3_blocks
    p_cfg, j_consts, ref = blocks[case]
    np.testing.assert_array_equal(p_wb._cell_consts(p_cfg, 12)["h2"], np.asarray(j_consts["h2"]))
    monkeypatch.setattr(p_wb, "_randn", draws.port_randn())
    got = {k: v.numpy() for k, v in
           p_wb.make_block_step(p_cfg, sfn0=12, device="cpu")(dl, ul, torch.Generator(),
                                                              120).items()}
    assert set(got) == set(ref)
    for k in ("dl_ok", "dl_ok_cw", "ul_ok", "ul_out"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # delivered DL bits on the codewords whose CRC passed
    ok_cw = ref["dl_ok_cw"].reshape(-1)
    shape = (ok_cw.size, -1)
    np.testing.assert_array_equal(got["dl_out"].reshape(shape)[ok_cw],
                                  ref["dl_out"].reshape(shape)[ok_cw])
    np.testing.assert_allclose(got["ack_val"], ref["ack_val"], rtol=ACK_RTOL)
    np.testing.assert_allclose(got["ack_energy"], ref["ack_energy"], rtol=2 * ACK_RTOL)
    assert got["ul_ok"].all()  # the SISO UL is unchanged alongside
    assert (got["ack_energy"] > 0.25).all()
    if case == "rank1":  # every codeword fails and the NACK rides the PUCCH
        assert not got["dl_ok_cw"].any() and (got["ack_val"] < 0).all()
    else:
        assert got["dl_ok_cw"].all() and (got["ack_val"] > 0).all()
        assert (got["dl_out"].reshape(dl.shape) == dl).all()


def test_tm3_channel_condition_and_seed():
    """The drawn channel has the asked condition number, mean |h|^2 = 1, and
    mimo_seed draws another one."""
    from test_torch_waveblock import _sps_cfgs

    from srslte_emane_tpu_torch.runtime import waveblock as p_wb

    hs = {}
    for case, kw in TM3_CASES.items():
        h2 = p_wb._cell_consts(_sps_cfgs(True, **kw)[0], 0)["h2"]
        hs[case] = h2[..., 0] + 1j * h2[..., 1]
        np.testing.assert_allclose((np.abs(hs[case]) ** 2).mean((-2, -1)), 1.0, rtol=1e-5)
    np.testing.assert_allclose(np.linalg.cond(hs["roundtrip"]), 1.0, rtol=1e-4)
    np.testing.assert_allclose(20 * np.log10(np.linalg.cond(hs["rank1"])), 60.0, atol=0.1)
    assert not np.allclose(hs["seed5"], hs["roundtrip"])


# ---------------- the dynamic block: l_aggr, max_tx, ack_thresh ----------------

def _dyn_option_cfgs(R, **kw):
    """test_torch_waveblock's `harq` case (15 PRB; UE 0 at 8 dB retransmits,
    UE 1 misses every DCI and its processes drop) at PDCCH aggregation 2,
    with cfi 3 (cfi 2's 7 CCEs cannot hold 2 UEs x 2 grants of 2 CCEs) and
    UE 1 at -12 dB (two CCEs carry a DCI 3 dB better than one: at -6 dB its
    DCIs sit at the detection margin, where the reference's bf16 DFT
    decides)."""
    from srslte_emane_tpu.runtime import waveblock_dyn as j_wbd
    from srslte_emane_tpu_torch.runtime import waveblock_dyn as p_wbd

    cells = (p_grid.CellConfig(n_prb=15, cell_id=1, cfi=3),
             j_grid.CellConfig(n_prb=15, cell_id=1, cfi=3))
    rntis = p_wbd.feasible_rntis(cells[0], 2, l_aggr=2)
    assert rntis == j_wbd.feasible_rntis(cells[1], 2, l_aggr=2)
    base = dict(rntis=rntis, dl_l_crbs=3, dl_mcs=16, ul_l_prb=2, ul_mcs=8, snr_db=(8.0, -12.0),
                R=R, l_aggr=2, **kw)
    return (p_wbd.DynBlockConfig(cell=cells[0], **base),
            j_wbd.DynBlockConfig(cell=cells[1], **base))


@pytest.fixture(scope="module")
def dyn_jax():
    """The options' block (`_dyn_option_cfgs(3, max_tx=2, ack_thresh=0.5)`)
    on profile_dynblock's payloads and schedule (`block_inputs`): (port cfg,
    JAX cfg, inputs, variant -> (JAX outputs, draws)), each JAX variant
    compiled on first use, with the reference script's stubs."""
    from test_torch_waveblock import Draws, _jax_run

    from srslte_emane_tpu.runtime import waveblock_dyn as j_wbd
    from srslte_emane_tpu_torch.scripts import profile_dynblock as prof

    p_cfg, j_cfg = _dyn_option_cfgs(3, max_tx=2, ack_thresh=0.5)
    inputs = prof.block_inputs(p_cfg, torch.device("cpu"))
    arrays = tuple(x.numpy() for x in inputs)
    cache = {}

    def ref(variant):
        if variant not in cache:
            draws = Draws(6)
            with pytest.MonkeyPatch.context() as m:
                for mod, name, stub in _jax_stubs()[variant]:
                    m.setattr(mod, name, stub)
                out, _ = _jax_run(j_wbd.make_dyn_block_step(j_cfg, jit=False),
                                  (*arrays, jax.random.PRNGKey(0), jnp.int32(0)), draws)
            cache[variant] = out, draws
        return cache[variant]

    return p_cfg, j_cfg, inputs, ref


def _port_dyn(p_cfg, inputs, draws, monkeypatch, variant="full"):
    from srslte_emane_tpu_torch.runtime import waveblock as p_wb
    from srslte_emane_tpu_torch.runtime import waveblock_dyn as p_wbd
    from srslte_emane_tpu_torch.scripts import profile_dynblock as prof

    monkeypatch.setattr(p_wb, "_randn", draws.port_randn(calls=len(draws.drawn)))
    with prof.stubbed(variant):
        out = p_wbd.make_dyn_block_step(p_cfg, device="cpu")(*inputs, torch.Generator(), 0)
    return {k: v.numpy() for k, v in out.items()}


def _dyn_equal(got, ref):
    """Every output equal; the delivered bits on the rows whose CRC passed."""
    assert set(got) == set(ref)
    for k in ref:
        if k in ("dl_out", "ul_out"):
            ok = ref[k[:2] + "_ok"]
            np.testing.assert_array_equal(got[k][ok], ref[k][ok], err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_dyn_block_options_equal(dyn_jax, monkeypatch):
    """l_aggr=2, max_tx=2, ack_thresh=0.5 on both packages, R=3."""
    from srslte_emane_tpu.runtime import waveblock_dyn as j_wbd
    from srslte_emane_tpu_torch.runtime import waveblock_dyn as p_wbd

    p_cfg, j_cfg, inputs, jax_ref = dyn_jax
    got_c, ref_c = p_wbd._consts(p_cfg), j_wbd._consts(j_cfg)
    for k in ("cce_dl", "cce_ul", "cand", "cand_re"):
        np.testing.assert_array_equal(got_c[k], np.asarray(ref_c[k]), err_msg=k)
    assert got_c["cand_re"].shape[-1] == 72  # 36 REs per CCE, 2 CCEs
    ref, draws = jax_ref("full")
    got = _port_dyn(p_cfg, inputs, draws, monkeypatch)
    _dyn_equal(got, ref)
    # UE 0 found every DCI at aggregation 2; UE 1's processes drop after 2
    # transmissions (round 2), so round 3 sends new data
    assert got["dl_found"][:, :, 0].all() and not got["dl_found"][:, :, 1].any()
    assert got["dl_drop"] >= 8 and got["dl_new"][2, :, 1].all()


def test_dyn_block_options_change_the_block():
    """Port alone: each knob moves what the reference says it moves."""
    from test_torch_waveblock import _run_dyn

    base, _ = _dyn_option_cfgs(3)
    default, *_ = _run_dyn(base)
    assert default["dl_drop"] == 0  # max_tx 4: nothing drops within 3 rounds
    short, *_ = _run_dyn(base._replace(max_tx=2))
    assert short["dl_drop"] > 0  # UE 1's processes give up after 2 transmissions
    deaf, *_ = _run_dyn(base._replace(ack_thresh=1e9))  # no ACK clears the threshold
    assert not deaf["ack_det"].any() and default["ack_det"][:, :, 0].any()


# ---------------- profile_dynblock: every variant against the JAX stubs ----------------

def _jax_stubs():
    """The reference script's stubs (scripts/profile_dynblock.py), by variant."""
    from srslte_emane_tpu.ops.fec import viterbi as j_vit
    from srslte_emane_tpu.phch import sch as j_sch

    def stub_vit(llrs, tb_iter=3):
        keep = (llrs.sum((-2, -1), keepdims=False)[:, None] * 0).astype(jnp.int8)
        return jnp.zeros((llrs.shape[0], llrs.shape[-1]), jnp.int8) + keep

    def stub_dec(llrs, c, softbuf=None, max_iter=8, use_pallas=False, llr_bits=32, rv_b=None):
        B = llrs.shape[0]
        if softbuf is None:
            softbuf = j_sch.init_softbuffer(B, c, llrs.dtype)
        keep = (llrs.sum(-1, keepdims=True) * 0).astype(jnp.int8)
        return (jnp.zeros((B, c.tbs), jnp.int8) + keep,
                jnp.ones((B,), bool) & (llrs.sum(-1) > -1e30), softbuf, 0)

    def stub_enc(b, c, rv_b=None):
        return jnp.zeros((b.shape[0], c.G), jnp.int8)

    def stub_enc_kept(b, c, rv_b=None):
        return jnp.zeros((b.shape[0], c.G), jnp.int8) + (b.sum(-1, keepdims=True) * 0
                                                          ).astype(jnp.int8)

    return {"full": (), "-viterbi": ((j_vit, "viterbi_decode", stub_vit),),
            "-turbodec": ((j_sch, "decode_tb", stub_dec),),
            "-turboenc": ((j_sch, "encode_tb", stub_enc),),
            "-all-fec": ((j_sch, "decode_tb", stub_dec), (j_vit, "viterbi_decode", stub_vit),
                         (j_sch, "encode_tb", stub_enc_kept))}


@pytest.mark.parametrize("variant", ["full", "-viterbi", "-turbodec", "-turboenc", "-all-fec"])
def test_profile_dynblock_variant_equal(dyn_jax, variant, monkeypatch):
    """The script's stubs in the port's block against the reference
    script's in the JAX one; the originals come back after each variant."""
    from srslte_emane_tpu.ops.fec import viterbi as j_vit
    from srslte_emane_tpu.phch import sch as j_sch
    from srslte_emane_tpu_torch.ops.fec import viterbi as p_vit

    originals = [p_vit.viterbi_decode, p_sch.decode_tb, p_sch.encode_tb,
                 j_vit.viterbi_decode, j_sch.decode_tb, j_sch.encode_tb]
    p_cfg, _, inputs, jax_ref = dyn_jax
    ref, draws = jax_ref(variant)
    got = _port_dyn(p_cfg, inputs, draws, monkeypatch, variant)
    assert [p_vit.viterbi_decode, p_sch.decode_tb, p_sch.encode_tb, j_vit.viterbi_decode,
            j_sch.decode_tb, j_sch.encode_tb] == originals
    _dyn_equal(got, ref)
    if variant in ("-viterbi", "-all-fec"):  # the zero DCI addresses nobody
        assert not got["dl_found"].any()
    if variant in ("-turbodec", "-all-fec"):  # every stubbed decode passes
        assert got["ul_ok"][got["ul_new"]].all()


# ---------------- profile_turbo: the stages on the script's draws ----------------

TURBO_NCB, TURBO_K = 8, 1056  # W=8, L=132


def test_profile_turbo_stages_equal():
    from test_torch_turbodecoder import _pallas2_windows

    from srslte_emane_tpu.ops.fec import turbodecoder as j_td
    from srslte_emane_tpu.ops.fec import turbodecoder_pallas as j_pallas
    from srslte_emane_tpu.ops.fec import turbodecoder_pallas2 as j_pallas2
    from srslte_emane_tpu_torch.ops.fec import turbodecoder as p_td
    from srslte_emane_tpu_torch.scripts import profile_turbo as prof

    inp = prof.inputs(TURBO_NCB, TURBO_K, torch.device("cpu"))
    got = {label: fn() for label, fn in prof.stages(inp).items()}
    # the source's draws, in its order
    rng = np.random.default_rng(0)
    d = [rng.normal(size=(TURBO_NCB, TURBO_K + 4)).astype(np.float32) for _ in range(3)]
    tails = [rng.normal(size=(TURBO_NCB, 3)).astype(np.float32) for _ in range(2)]
    for a, b in zip(d + tails, inp["d"] + inp["tails"]):
        np.testing.assert_array_equal(a, b.numpy())
    ls, lp = d[0][:, :TURBO_K], d[1][:, :TURBO_K]
    assert p_td._pick_windows(TURBO_K) == _pallas2_windows(TURBO_NCB, TURBO_K, False) == 8
    args = (ls, lp, *tails)
    ref = {prof.MAP_V1: j_pallas.map_decode_pallas(*args, interpret=True),
           prof.MAP: j_pallas2.map_decode_pallas2(*args, interpret=True),
           prof.PLAIN: jax.jit(j_td._map_decode)(*args)}
    for label, want in ref.items():
        np.testing.assert_allclose(got[label].numpy(), np.asarray(want), atol=1e-3, rtol=1e-4,
                                   err_msg=label)
    valid = np.ones(TURBO_NCB, bool)
    for label, n_it, poly in ((prof.fixed(1), 1, None), (prof.fixed(2), 2, None),
                              (prof.EARLY, 8, j_crc.LTE_CRC24B)):
        bits, ok, n_iter = jax.jit(lambda a, b, c, v, n=n_it, p=poly: j_td.turbo_decode(
            a, b, c, v, TURBO_K, n, p, False))(*d, valid)
        p_bits, p_ok, p_iter = got[label]
        np.testing.assert_array_equal(p_ok.numpy(), np.asarray(ok), err_msg=label)
        assert p_iter == int(n_iter) == n_it, label
        assert not p_ok.any()  # random LLRs: no code block passes
        agree = (p_bits.numpy() == np.asarray(bits)).mean()
        assert agree >= 0.999, (label, agree)


# ---------------- profile_mimo: the stages on the JAX received grids ----------------

MIMO_PRB, MIMO_BATCH = 6, 2
MIMO_REL = 1e-5  # float32 products and sums in another order: relative RMS


def _jax_mimo_stages(rg2, cell2, cfgs, prb_mask):
    """The reference script's stage code (scripts/profile_mimo.py), each
    stage jitted; returns every stage's output."""
    from srslte_emane_tpu.ops import mimo as j_mimo
    from srslte_emane_tpu.phch import sch as j_sch

    sf_idx, rnti, qm = 1, 0x46, 6
    re_idx = j_grid.pdsch_re_indices(cell2, sf_idx, prb_mask)
    ce, noise = jax.jit(lambda g: j_pdsch.estimate_mimo(g, cell2, sf_idx, 2))(rg2)

    def front(rx_grids, ce):
        take = lambda a: jnp.take(
            a.reshape(a.shape[:-3] + (cell2.n_sym * cell2.nre, 2)), jnp.asarray(re_idx), axis=-2)
        y = take(rx_grids)
        hh = take(ce)
        m = len(re_idx)
        u = np.array([[1, 1], [1, -1]], dtype=np.complex64) / np.sqrt(2)
        base = (np.eye(2) / np.sqrt(2)).astype(np.complex64)
        w0 = base @ np.diag([1.0, 1.0]).astype(np.complex64) @ u
        w1 = base @ np.diag([1.0, -1.0]).astype(np.complex64) @ u
        w_eff = np.where((np.arange(m) % 2 == 0)[:, None, None],
                         w0[None], w1[None]).astype(np.complex64)
        wr = jnp.asarray(w_eff.real.astype(np.float32))
        wi = jnp.asarray(w_eff.imag.astype(np.float32))
        hr, hi = hh[..., 0], hh[..., 1]
        heff_r = jnp.einsum("brtm,mtl->brlm", hr, wr) - jnp.einsum("brtm,mtl->brlm", hi, wi)
        heff_i = jnp.einsum("brtm,mtl->brlm", hr, wi) + jnp.einsum("brtm,mtl->brlm", hi, wr)
        heff = jnp.stack([heff_r, heff_i], axis=-1)
        x, csi = j_mimo.decode_zf2(y, heff, noise=None)
        return j_mimo.layer_demap(x, 2), [csi[..., 0, :], csi[..., 1, :]]

    streams, csis = jax.jit(front)(rg2, ce)

    def dem(streams, csis):
        out = []
        for q in range(2):
            llr = j_modem.demod_soft(streams[q], j_modem.MOD_FROM_QM[qm])
            llr = llr * jnp.repeat(csis[q], qm, axis=-1)
            c_init = j_scr.pdsch_cinit(rnti, q, sf_idx, cell2.cell_id)
            out.append(j_scr.scramble_llrs(llr, c_init))
        return out

    llrs2 = jax.jit(dem)(streams, csis)
    sep = jax.jit(lambda l: [j_sch.decode_tb(l[q], cfgs[q], None, 8)[:2] for q in range(2)])(llrs2)
    full = jax.jit(lambda g: j_pdsch.decode_tm(g, cfgs, cell2, sf_idx, rnti, prb_mask,
                                               "tm3")[:2])(rg2)
    return jax.tree_util.tree_map(np.asarray, dict(est=(ce, noise), front=(streams, csis),
                                                   dem=llrs2, sep=sep, full=full))


def test_profile_mimo_stages_equal():
    from srslte_emane_tpu.ops import channel as j_channel
    from srslte_emane_tpu.phch import sch as j_sch
    from srslte_emane_tpu_torch.scripts import profile_mimo as prof

    ctx = prof.setup(MIMO_BATCH, torch.device("cpu"), n_prb=MIMO_PRB)
    # the reference's cell and draws at 6 PRB
    rng = np.random.default_rng(0)
    cell2 = j_grid.CellConfig(n_prb=MIMO_PRB, cell_id=7, n_ports=2, cfi=1)
    prb_mask = (1,) * MIMO_PRB
    n_re = j_grid.nof_re(cell2, 1, prb_mask)
    assert n_re == ctx["n_re"]
    cfgs = [j_sch.SchConfig(tbs=(int(n_re * 6 * 0.5) - 24) // 8 * 8, G=n_re * 6, Qm=6, Nl=1)
            for _ in range(2)]
    tbs_list = [rng.integers(0, 2, (MIMO_BATCH, c.tbs), dtype=np.int8) for c in cfgs]
    for a, b in zip(tbs_list, ctx["tbs_list"]):
        np.testing.assert_array_equal(a, b.numpy())
    tx2 = jax.jit(lambda a, b: j_ofdm.modulate(j_pdsch.encode_tm(
        [a, b], cfgs, cell2, 1, 0x46, prb_mask, "tm3"), MIMO_PRB))(*tbs_list)
    assert _rel_rms(ctx["tx2"].numpy(), np.asarray(tx2)) < 1e-2  # the reference's bf16 DFT
    h = (rng.normal(size=(MIMO_BATCH, 2, 2))
         + 1j * rng.normal(size=(MIMO_BATCH, 2, 2))).astype(np.complex64)
    h = h + 3.5 * np.eye(2)[None]
    rx2 = j_channel.mimo_flat(jax.random.PRNGKey(2), tx2, j_cplx.from_numpy(h), 30.0)
    rg2 = np.asarray(jax.jit(lambda s: j_ofdm.demodulate(s, MIMO_PRB))(rx2))
    ref = _jax_mimo_stages(rg2, cell2, cfgs, prb_mask)

    ctx["rg2"] = _t(rg2)  # both packages read one received grid
    outs = {}
    for label, fn in prof.stages(ctx, outs):
        outs[label] = fn()
    for got, want in zip(outs[prof.EST], ref["est"]):
        assert _rel_rms(got.numpy(), want) < MIMO_REL
    (streams, csis), (j_streams, j_csis) = outs[prof.FRONT], ref["front"]
    for got, want in zip(streams + csis, list(j_streams) + list(j_csis)):
        assert _rel_rms(got.numpy(), want) < MIMO_REL
    for got, want in zip(outs[prof.DEM], ref["dem"]):
        assert _rel_rms(got.numpy(), want) < MIMO_REL
    for q in range(2):
        for got, want in zip(outs[prof.SEP][q], ref["sep"][q]):
            np.testing.assert_array_equal(got.numpy(), want)
    for got, want in zip(outs[prof.FULL][0] + outs[prof.FULL][1],
                         list(ref["full"][0]) + list(ref["full"][1])):
        np.testing.assert_array_equal(got.numpy(), want)
    merged_bits, merged_ok = outs[prof.MERGED]
    np.testing.assert_array_equal(merged_ok.numpy(),
                                  np.concatenate([ref["sep"][0][1], ref["sep"][1][1]]))
    np.testing.assert_array_equal(merged_bits.numpy(),
                                  np.concatenate([ref["sep"][0][0], ref["sep"][1][0]]))
    # the source's assertion: every CRC passes, and the bits are the payload
    assert all(ok.all() for ok in outs[prof.FULL][1])
    for got, want in zip(outs[prof.FULL][0], tbs_list):
        np.testing.assert_array_equal(got.numpy(), want)
