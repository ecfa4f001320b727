"""The CUDA MAP kernels and the Viterbi kernel against their plain PyTorch
versions, and the paths through them (PUSCH, the downlink subframe, the
2x2 TM3 cell, the waveform planes, the control decoders), on the card.

Marked `cuda`: skips without a CUDA device.  The card's machine has no jax,
so run this file there without the suite's conftest:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from srslte_emane_tpu_torch.ops import channel
from srslte_emane_tpu_torch.ops.fec import cbsegm, turbo, turbodecoder, turbodecoder_cuda

pytestmark = pytest.mark.cuda

ATOL, RTOL = 1e-3, 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(k, B, dev):
    rng = np.random.default_rng(k)
    bits = torch.from_numpy(rng.integers(0, 2, (B, k), dtype=np.int8)).to(dev)
    d0, d1, _ = (d.float() for d in turbo.turbo_encode(bits))
    noise = lambda: torch.from_numpy(rng.normal(0, 1, (B, k)).astype(np.float32)).to(dev)
    ls = ((1 - 2 * d0[:, :k]) * 4.0 + noise()).contiguous()
    lp = ((1 - 2 * d1[:, :k]) * 4.0 + noise()).contiguous()
    tails = torch.from_numpy(rng.normal(0, 4, (2, B, 3)).astype(np.float32)).to(dev)
    return ls, lp, tails[0].contiguous(), tails[1].contiguous()


@pytest.mark.parametrize("k,B", [(40, 3), (512, 5), (5504, 4)])
@pytest.mark.parametrize("narrow", [False, True])
def test_kernel_matches_plain(dev, k, B, narrow):
    args = _inputs(k, B, dev)
    w = turbodecoder._pick_windows(k)
    before = turbodecoder_cuda.launches
    got = turbodecoder_cuda.map_decode(*args, narrow=narrow)
    torch.cuda.synchronize()
    assert turbodecoder_cuda.launches == before + 1
    ref = turbodecoder_cuda.map_decode_ref(*args, w, narrow)
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)
    strong = ref.abs() > 0.5
    assert torch.equal(got[strong].sign(), ref[strong].sign())


def _sweep_sizes():
    """Every sixth code-block size, plus 40, 6144 and the first size of
    each window count W = 1, 2, 4, 8, 16, 32."""
    ks = [int(k) for k in cbsegm.TC_CB_SIZES]
    first = {}
    for k in ks:
        first.setdefault(turbodecoder._pick_windows(k), k)
    assert sorted(first) == [1, 2, 4, 8, 16, 32]
    return sorted(set(ks[::6]) | set(first.values()) | {40, 6144})


@pytest.mark.parametrize("narrow", [False, True])
def test_kernel_equals_plain_at_code_block_sizes(dev, narrow):
    """Bit for bit (max abs err 0.0) at B=2 over the sizes of _sweep_sizes,
    K=6144 in f32 (the most shared memory) included."""
    for k in _sweep_sizes():
        args = _random_inputs(k, 2, dev)
        w = turbodecoder._pick_windows(k)
        got = turbodecoder_cuda.map_decode_cuda(*args, w, narrow)
        torch.cuda.synchronize()
        assert torch.equal(got, turbodecoder_cuda.map_decode_ref(*args, w, narrow)), k


@pytest.mark.parametrize("B", [3, 13, 33])
def test_kernel_partial_last_block(dev, B):
    """B x W=4 columns (12, 52, 132) that do not fill the last thread block
    (32 columns in bf16, 23 in f32 at K=512): still bit for bit."""
    args = _random_inputs(512, B, dev)
    for narrow in (False, True):
        cols, _ = turbodecoder_cuda.occupancy(512, 4, narrow)
        assert (B * 4) % cols
        got = turbodecoder_cuda.map_decode_cuda(*args, 4, narrow)
        assert torch.equal(got, turbodecoder_cuda.map_decode_ref(*args, 4, narrow))


@pytest.mark.parametrize("narrow", [False, True])
def test_wrapper_is_one_launch_without_scratch(dev, narrow):
    """map_decode_cuda at 96 x K=5504: one turbo_map launch, and a peak
    device-memory growth below the (L, 8, columns) beta scratch of the
    earlier design."""
    B, k, w = 96, 5504, 32
    args = _random_inputs(k, B, dev)
    turbodecoder_cuda.map_decode_cuda(*args, w, narrow)  # build, warm up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = turbodecoder_cuda.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        turbodecoder_cuda.map_decode_cuda(*args, w, narrow)
        torch.cuda.synchronize()
    assert turbodecoder_cuda.launches == before + 1
    names = [e.name for e in prof.events() if "map_kernel" in e.name]
    assert len(names) == 1, names
    scratch = (k // w) * 8 * B * w * (2 if narrow else 4)
    assert torch.cuda.max_memory_allocated(dev) - base < scratch


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    ls, lp, tx, tz = _inputs(512, 2, dev)
    with pytest.raises(TypeError):
        turbodecoder_cuda.map_decode_cuda(ls.double(), lp, tx, tz, 4)
    with pytest.raises(ValueError):
        turbodecoder_cuda.map_decode_cuda(ls.t().contiguous().t(), lp, tx, tz, 4)
    with pytest.raises(ValueError):
        turbodecoder_cuda.map_decode_cuda(ls, lp.cpu(), tx, tz, 4)
    with pytest.raises(ValueError):
        turbodecoder_cuda.map_decode_cuda(ls, lp, tx, tz, 3)  # 3 does not divide K


def test_logmap_kernel_matches_plain(dev, monkeypatch):
    """The log-MAP kernel against its plain version.  SRSLTE_TPU_LOGMAP is
    read once at import (the CPU tests check that); here the flag is set on
    both modules, where the kernel launch and max_star read it."""
    monkeypatch.setattr(turbodecoder, "LOGMAP", True)
    monkeypatch.setattr(turbodecoder_cuda, "LOGMAP", True)
    args = _inputs(5504, 4, dev)
    for narrow in (False, True):
        got = turbodecoder_cuda.map_decode(*args, narrow=narrow)
        ref = turbodecoder_cuda.map_decode_ref(*args, turbodecoder._pick_windows(5504), narrow)
        torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)


def _random_inputs(k, B, dev):
    """LLRs of random code bits: any K (the MAP does not interleave)."""
    rng = np.random.default_rng(k + B)
    bits = rng.integers(0, 2, (2, B, k))
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev).contiguous()
    return (f((1 - 2.0 * bits[0]) * 4 + rng.normal(0, 1, (B, k))),
            f((1 - 2.0 * bits[1]) * 4 + rng.normal(0, 1, (B, k))),
            f(rng.normal(0, 4, (B, 3))), f(rng.normal(0, 4, (B, 3))))


@pytest.mark.parametrize("k,B,w", [(40, 3, 1), (512, 5, 2), (1040, 4, 16), (5504, 4, 32)])
def test_v1_kernel_matches_plain(dev, k, B, w):
    args = _random_inputs(k, B, dev)
    before = turbodecoder_cuda.launches_v1
    got = turbodecoder_cuda.map_decode_v1_cuda(*args, w)
    torch.cuda.synchronize()
    assert turbodecoder_cuda.launches_v1 == before + 1
    ref = turbodecoder_cuda.map_decode_v1_ref(*args, w)
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)
    strong = ref.abs() > 0.5
    assert torch.equal(got[strong].sign(), ref[strong].sign())


def test_odd_window_goes_to_v1_kernel(dev, monkeypatch):
    """An odd window length (L=65) launches v1 through map_decode, in both
    modes, and not the radix-2 kernel."""
    monkeypatch.setattr(turbodecoder_cuda, "_pick_windows", lambda _: 16)
    args = _random_inputs(1040, 4, dev)
    before = (turbodecoder_cuda.launches, turbodecoder_cuda.launches_v1)
    for narrow in (False, True):
        got = turbodecoder_cuda.map_decode(*args, narrow=narrow)
        torch.testing.assert_close(got, turbodecoder_cuda.map_decode_v1_ref(*args, 16),
                                   atol=ATOL, rtol=RTOL)
    assert (turbodecoder_cuda.launches, turbodecoder_cuda.launches_v1) == (before[0], before[1] + 2)
    with pytest.raises(ValueError):
        turbodecoder_cuda.map_decode_cuda(*args, 16)  # the radix-2 kernel needs an even L


def test_v1_wrapper_rejects_what_the_kernel_does_not_take(dev):
    ls, lp, tx, tz = _random_inputs(512, 2, dev)
    with pytest.raises(TypeError):
        turbodecoder_cuda.map_decode_v1_cuda(ls.double(), lp, tx, tz, 2)
    with pytest.raises(ValueError):
        turbodecoder_cuda.map_decode_v1_cuda(ls.t().contiguous().t(), lp, tx, tz, 2)
    with pytest.raises(ValueError):
        turbodecoder_cuda.map_decode_v1_cuda(ls, lp.cpu(), tx, tz, 2)
    with pytest.raises(ValueError):
        turbodecoder_cuda.map_decode_v1_cuda(ls, lp, tx, tz, 3)  # 3 does not divide K
    beta_k = turbodecoder.beta_tail(tx, tz).contiguous()
    before = turbodecoder_cuda.launches_v1
    with pytest.raises(ValueError):
        turbodecoder_cuda.launch_v1(ls, lp, beta_k[:, :4].contiguous(), 2)
    with pytest.raises(TypeError):
        turbodecoder_cuda.launch_v1(ls, lp, beta_k.double(), 2)
    with pytest.raises(ValueError):
        turbodecoder_cuda.launch_v1(ls, lp.t().contiguous().t(), beta_k, 2)
    # a window that does not fit a block's shared memory: the wrapper raises
    # and the library's entry point refuses it
    long = torch.zeros((1, 30000), device=dev)
    with pytest.raises(ValueError):
        turbodecoder_cuda.launch_v1(long, long, beta_k[:1].contiguous(), 1)
    lib = turbodecoder_cuda.build(turbodecoder_cuda.SOURCE_V1).lib
    assert lib.turbo_map_v1_cols(30000, 40) == 0
    assert lib.turbo_map_v1_launch(long.data_ptr(), long.data_ptr(), beta_k.data_ptr(),
                                   long.data_ptr(), 1, 1, 30000, 40, 0, None, None,
                                   torch.cuda.current_stream(dev).cuda_stream) != 0
    assert turbodecoder_cuda.launches_v1 == before  # a refused launch is not counted


# (K, B, W): window lengths 1, 3, 11 (halo = window), 33, 39, 41, 65, 255
# (odd, around the 40-step halo, a partial last segment), an even one (172,
# the downlink shape), one window alone, and long windows: L=1536 staged in
# several passes, L=6144 with one column per block
V1_SHAPES = [(6, 3, 6), (18, 3, 6), (1056, 4, 96), (1056, 5, 32), (234, 3, 6), (246, 3, 6),
             (1040, 4, 16), (510, 3, 2), (5504, 3, 32), (45, 2, 1), (6144, 2, 4), (6144, 2, 1)]


@pytest.mark.parametrize("k,B,w", V1_SHAPES)
def test_v1_kernel_equals_plain(dev, k, B, w):
    """Bit for bit (max abs err 0.0), in one launch, with the block the
    shape picks."""
    args = _random_inputs(k, B, dev)
    cols, blocks = turbodecoder_cuda.occupancy_v1(k, w)
    assert blocks > 0 and (cols == 1) == (k // w == 6144)
    before = turbodecoder_cuda.launches_v1
    got = turbodecoder_cuda.map_decode_v1_cuda(*args, w)
    torch.cuda.synchronize()
    assert turbodecoder_cuda.launches_v1 == before + 1
    assert torch.equal(got, turbodecoder_cuda.map_decode_v1_ref(*args, w))


@pytest.mark.parametrize("k,B,w", [(9402, 3, 2), (9602, 3, 2), (6144, 5, 1), (12289, 2, 1)])
def test_v1_long_window_equals_plain(dev, k, B, w):
    """Windows around the length from which a block takes one column (L =
    4701, 4801) and beyond (a whole code block as one window, and twice
    that, odd): bit for bit too, with fewer blocks per SM."""
    args = _random_inputs(k, B, dev)
    cols, blocks = turbodecoder_cuda.occupancy_v1(k, w)
    assert cols >= 1 and 1 <= blocks <= 4
    got = turbodecoder_cuda.map_decode_v1_cuda(*args, w)
    assert torch.equal(got, turbodecoder_cuda.map_decode_v1_ref(*args, w))


@pytest.mark.parametrize("B", [1, 13, 33])
def test_v1_kernel_partial_last_block(dev, B):
    """B x W=16 columns (16, 208, 528) against blocks of 32 columns at
    L=65: the last block is half empty, still bit for bit."""
    args = _random_inputs(1040, B, dev)
    cols, _ = turbodecoder_cuda.occupancy_v1(1040, 16)
    assert 0 < cols and (B * 16) % cols
    got = turbodecoder_cuda.map_decode_v1_cuda(*args, 16)
    assert torch.equal(got, turbodecoder_cuda.map_decode_v1_ref(*args, 16))


def test_v1_wrapper_is_one_launch_without_scratch(dev):
    """map_decode_v1_cuda at 96 x K=1040, W=16: one v1 launch, and a peak
    device-memory growth below the (L, 4, columns) branch metrics or the
    (L, 8, columns) beta scratch of the earlier design."""
    B, k, w = 96, 1040, 16
    args = _random_inputs(k, B, dev)
    turbodecoder_cuda.map_decode_v1_cuda(*args, w)  # build, warm up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = turbodecoder_cuda.launches_v1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        turbodecoder_cuda.map_decode_v1_cuda(*args, w)
        torch.cuda.synchronize()
    assert turbodecoder_cuda.launches_v1 == before + 1
    names = [e.name for e in prof.events() if "map_v1" in e.name]
    assert len(names) == 1, names
    metrics = (k // w) * 4 * B * w * 4
    assert torch.cuda.max_memory_allocated(dev) - base < metrics


def test_logmap_v1_kernel_matches_plain(dev, monkeypatch):
    """The log-MAP build of v1 against its plain version; the flag is set
    on both modules, as for the radix-2 kernel."""
    monkeypatch.setattr(turbodecoder, "LOGMAP", True)
    monkeypatch.setattr(turbodecoder_cuda, "LOGMAP", True)
    ls, lp, tx, tz = _random_inputs(1040, 4, dev)
    ref = turbodecoder_cuda.map_decode_v1_ref(ls, lp, tx, tz, 16)
    beta_k = turbodecoder.beta_tail(tx, tz).contiguous()
    torch.testing.assert_close(turbodecoder_cuda.launch_v1(ls, lp, beta_k, 16), ref,
                               atol=ATOL, rtol=RTOL)


def test_turbo_decode_at_an_odd_window_launches_v1_once_per_pass(dev, monkeypatch):
    """turbo_decode with the window count patched to give L=33 makes one v1
    launch for each slot of the loop's budget (2 * max_iter predicated
    passes; the passes that ran are map_rows / B) and none of the radix-2
    kernel, and decodes every code block."""
    from srslte_emane_tpu_torch.ops.fec import crc

    k, B = 1056, 16
    rng = np.random.default_rng(9)
    payload = torch.from_numpy(rng.integers(0, 2, (B, k - 24), dtype=np.int8)).to(dev)
    bits = crc.crc_attach(payload, crc.LTE_CRC24B)
    d0, d1, d2 = ((1 - 2.0 * d.float()) * 1.5
                  + torch.from_numpy(rng.normal(0, 1, tuple(d.shape)).astype(np.float32)).to(dev)
                  for d in turbo.turbo_encode(bits))
    valid = torch.ones(B, dtype=torch.bool, device=dev)
    monkeypatch.setattr(turbodecoder_cuda, "_pick_windows", lambda _: 32)
    monkeypatch.setenv("SRSLTE_TPU_CASCADE", "0")  # every pass runs the whole batch
    monkeypatch.setattr(turbodecoder, "map_rows", 0)
    before = (turbodecoder_cuda.launches, turbodecoder_cuda.launches_v1)
    out, ok, n_iter = turbodecoder.turbo_decode(d0, d1, d2, valid, k, 8, crc.LTE_CRC24B)
    torch.cuda.synchronize()
    passes = turbodecoder.map_rows // B
    assert 1 <= passes < 16 and n_iter == (passes + 1) // 2
    assert (turbodecoder_cuda.launches, turbodecoder_cuda.launches_v1) == (before[0],
                                                                          before[1] + 16)
    assert bool(ok.all()) and torch.equal(out, bits)


@pytest.mark.parametrize("llr_bits", [32, 16])
def test_pusch_decode_through_the_kernel(dev, llr_bits):
    """A 25 PRB PUSCH subframe batch decodes bit-exactly through the kernel."""
    from srslte_emane_tpu_torch.models import ue_ul
    from srslte_emane_tpu_torch.phch import grid

    l_prb, qm = 25, 4
    tbs = (12 * l_prb * 12 * qm // 2 - 24) // 8 * 8
    cfg = ue_ul.UlSubframeConfig(cell=grid.CellConfig(n_prb=25, cell_id=42), sf_idx=2,
                                 rnti=0x5A, l_prb=l_prb, qm=qm, tbs=tbs)
    payload = torch.from_numpy(
        np.random.default_rng(3).integers(0, 2, (8, tbs), dtype=np.int8)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    rx = channel.awgn(gen, ue_ul.build_subframe(cfg, tb_bits=payload), 14.0)
    before = turbodecoder_cuda.launches
    out = ue_ul.enb_receive(rx, cfg, use_kernel=True, llr_bits=llr_bits)
    torch.cuda.synchronize()
    assert turbodecoder_cuda.launches > before
    got, ok = out["pusch"]
    assert bool(ok.all()) and torch.equal(got, payload)


def test_link_defaults_to_the_kernel_on_the_card(dev):
    """pdsch_link.rx_subframe with use_kernel left at its default decodes
    CUDA samples through turbo_map."""
    from srslte_emane_tpu_torch.models import pdsch_link
    from srslte_emane_tpu_torch.phch import grid

    cfg = pdsch_link.LinkConfig(cell=grid.CellConfig(n_prb=6, cell_id=1), qm=4,
                                snr_db=20.0, llr_bits=16)
    payload = torch.from_numpy(
        np.random.default_rng(4).integers(0, 2, (4, cfg.tbs), dtype=np.int8)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    rx = channel.awgn(gen, pdsch_link.tx_subframe(payload, cfg), cfg.snr_db)
    before = turbodecoder_cuda.launches
    out, ok, _, _ = pdsch_link.rx_subframe(rx, cfg)
    torch.cuda.synchronize()
    assert turbodecoder_cuda.launches > before
    assert bool(ok.all()) and torch.equal(out, payload)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _four_grant_config(sf_idx):
    """chip_smoke.py's phase-8 plan: netsim --waveform's four UEs of 24
    PRBs each at 100 PRB, 16QAM (TBS 4,416 at sf 1: one code block of
    K=4480), CCEs from pdcch.allocate_cces."""
    return _chip_smoke().dl_subframe_config(sf_idx)


def test_four_grant_subframe_through_the_kernel(dev):
    """The 100 PRB four-grant subframe at batch 8: CFI, every DCI and CRC,
    payloads bit-exact, decoded through turbo_map (f32 mode) and not v1."""
    from srslte_emane_tpu_torch.models import enb_dl, ue_dl

    cfg = _four_grant_config(1)
    assert [g[3] for g in cfg.grants] == [4416] * 4
    rng = np.random.default_rng(5)
    payloads = [torch.from_numpy(rng.integers(0, 2, (8, g[3]), dtype=np.int8)).to(dev)
                for g in cfg.grants]
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    rx = channel.awgn(gen, enb_dl.build_subframe(cfg, payloads), 20.0)
    before = (turbodecoder_cuda.launches, turbodecoder_cuda.launches_v1)
    res, _ = ue_dl.decode_subframe(rx, cfg)
    torch.cuda.synchronize()
    assert turbodecoder_cuda.launches > before[0] and turbodecoder_cuda.launches_v1 == before[1]
    assert bool((res.cfi == 2).all()) and bool(res.dci_found.all())
    for gi, p in enumerate(payloads):
        assert bool(res.crc_ok[gi].all()) and torch.equal(res.payloads[gi], p)


def _control_grid(dev):
    """A noisy 25 PRB sf 0 grid with PDCCH (rnti 0x46, L=2) and PBCH, its
    channel estimate, on `dev` and on the CPU."""
    from srslte_emane_tpu_torch.models import enb_dl
    from srslte_emane_tpu_torch.ops import ofdm
    from srslte_emane_tpu_torch.phch import chest, grid, pbch, pdcch

    cell = grid.CellConfig(n_prb=25, cell_id=123, cfi=2)
    l_aggr, start = next(c for c in pdcch.candidates(cell, 0x46, 0) if c[0] == 2)
    mask = tuple(int(p < 8) for p in range(25))
    tbs = (grid.nof_re(cell, 0, mask) * 2 // 3) // 8 * 8
    cfg = enb_dl.DlSubframeConfig(cell=cell, sf_idx=0, with_pbch_sfn=8,
                                  grants=((0x46, mask, 2, tbs, l_aggr, start),))
    rng = np.random.default_rng(6)
    payload = torch.from_numpy(rng.integers(0, 2, (4, tbs), dtype=np.int8))
    mib = torch.from_numpy(np.tile(pbch.pack_mib(25, 8), (4, 1)))
    tx = enb_dl.build_subframe(cfg, [payload], mib_bits=mib).numpy()
    rx = torch.from_numpy((tx + rng.normal(0, 0.02, tx.shape)).astype(np.float32))
    g = ofdm.demodulate(rx, 25)
    ce = chest.estimate(g, cell, 0).ce
    return cell, (g.to(dev), ce.to(dev)), (g, ce)


def test_control_decoders_on_the_card_equal_the_cpu(dev):
    """blind_search, blind_search_all and pbch.decode give on the card what
    they give on the CPU, equal-metric ties included (first maximum)."""
    from srslte_emane_tpu_torch.phch import dci, pbch, pcfich, pdcch

    cell, on_card, on_cpu = _control_grid(dev)
    n = dci.format0_1a_len(25)
    results = []
    for g, ce in (on_card, on_cpu):
        bits, ok, cands = pdcch.blind_search(g, ce, cell, 0, 0x46, n)
        all_bits, resid, pos = pdcch.blind_search_all(g, ce, cell, 0, n)
        zero, ones = torch.zeros_like(g), torch.ones_like(ce)
        results.append([bits, ok, all_bits, resid, *pbch.decode(g, ce, cell),
                        *pbch.decode(zero, ones, cell), *pcfich.decode(zero, ones, cell, 0)])
        assert bool(ok.any(dim=1).all())
    for got, ref in zip(*results):
        assert torch.equal(got.cpu(), ref)
    mib_ok, tie_off, tie_cfi = results[0][7], results[0][10], results[0][12]
    assert bool(mib_ok.all()) and bool((tie_off == 0).all()) and bool((tie_cfi == 1).all())


def test_waveform_plane_defaults_to_the_card(dev):
    """WaveformDataPlane() with no device argument runs on the card and
    delivers every PDU of two UEs' bursts."""
    from srslte_emane_tpu_torch.phch import grid, pdcch
    from srslte_emane_tpu_torch.runtime import wavesim

    cell = grid.CellConfig(n_prb=25, cell_id=1, cfi=1)
    dp = wavesim.WaveformDataPlane(cell)
    assert dp.device.type == "cuda"
    alloc = pdcch.allocate_cces(cell, [0x46, 0x47], 1)
    for u, r in enumerate((0x46, 0x47)):
        l_aggr, start = alloc[r]
        dp.add_ue(r, tuple(int(u * 12 <= p < (u + 1) * 12) for p in range(25)), qm=4,
                  l_aggr=l_aggr, cce_start=start)
    pdus = {0x46: [bytes([i]) * (10 + i) for i in range(8)], 0x47: [b"b" * 30] * 5}
    out = dp.send_tti(pdus, {0x46: 100.0, 0x47: 105.0})
    for r, sent in pdus.items():
        assert [g for g, _ in out[r]] == sent
    assert dp.metrics == {"sf_tx": 13, "crc_ok": 13, "crc_fail": 0}


@pytest.mark.parametrize("k,B,narrow", [(5440, 768, True), (4864, 256, False)])
def test_kernel_equals_plain_at_the_mimo_shapes(dev, k, B, narrow):
    """turbo_map at the TM3 cell's 768 x K=5440 (bf16) and MimoDataPlane's
    256 x K=4864 (f32): bit for bit its plain version."""
    args = _inputs(k, B, dev)
    w = turbodecoder._pick_windows(k)
    got = turbodecoder_cuda.map_decode_cuda(*args, w, narrow)
    assert torch.equal(got, turbodecoder_cuda.map_decode_ref(*args, w, narrow))


def test_tm3_cell_decode_on_the_card_equals_the_cpu(dev):
    """The 20 MHz 2x2 TM3 cell (chip_smoke.tm3_cell) at batch 4, llr_bits=16:
    the card (through turbo_map, bf16 mode) decodes both codewords
    bit-exact, and the same samples give the same bits and flags on the
    CPU (plain MAP)."""
    from srslte_emane_tpu_torch.ops import ofdm
    from srslte_emane_tpu_torch.phch import pdsch

    smoke = _chip_smoke()
    cell, mask, cfgs = smoke.tm3_cell()
    rng = np.random.default_rng(9)
    tbs = [torch.from_numpy(rng.integers(0, 2, (4, c.tbs), dtype=np.int8)).to(dev) for c in cfgs]
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    tx = ofdm.modulate(pdsch.encode_tm(tbs, cfgs, cell, 1, 0x46, mask, "tm3"), 100)
    h = smoke.flat_channel(rng, 4, 2, 2, 3.5, dev)
    rx = channel.mimo_flat(gen, tx, h, 30.0)
    results = []
    for samples in (rx, rx.cpu()):
        before = turbodecoder_cuda.launches
        outs, oks, _ = pdsch.decode_tm(ofdm.demodulate(samples, 100), cfgs, cell, 1, 0x46, mask,
                                       "tm3", llr_bits=16)
        assert (turbodecoder_cuda.launches > before) == (samples.device.type == "cuda")
        results.append([t.cpu() for t in outs + oks])
    for got, ref in zip(*results):
        assert torch.equal(got, ref)
    for q in range(2):
        assert bool(results[0][2 + q].all()) and torch.equal(results[0][q], tbs[q].cpu())


@pytest.mark.parametrize("plane", ["MbsfnPlane", "UlControlPlane", "UlSchPlane", "MimoDataPlane"])
def test_new_planes_default_to_the_card(dev, plane):
    """Each plane with no device argument runs on the card and delivers its
    reference test's traffic."""
    from srslte_emane_tpu_torch.phch import grid
    from srslte_emane_tpu_torch.runtime import wavesim

    if plane == "MbsfnPlane":
        p = wavesim.MbsfnPlane(grid.CellConfig(n_prb=6, cell_id=1), area_id=2)
        pkts = [b"mbms-%d" % i * 3 for i in range(3)]
        assert p.send(pkts, {10: 80.0, 11: 140.0}) == {10: pkts, 11: [None] * 3}
    elif plane == "UlControlPlane":
        p = wavesim.UlControlPlane(grid.CellConfig(n_prb=25, cell_id=17))
        for u in range(4):
            p.add_ue(100 + u, u)
        out = p.step({100 + u: u % 2 for u in range(3)}, {100 + u: 90.0 for u in range(4)})
        assert [out[100 + u][:2] for u in range(3)] == [(True, u % 2) for u in range(3)]
        assert not out[103][0]
    elif plane == "UlSchPlane":
        p = wavesim.UlSchPlane(grid.CellConfig(n_prb=25, cell_id=1))
        p.add_ue(0x46, 0, 8, qm=2)
        assert p.step({0x46: (b"hello-ul-world!!", 9)}, {0x46: 100.0}) == {
            0x46: (b"hello-ul-world!!", True, 9)}
    else:
        p = wavesim.MimoDataPlane(grid.CellConfig(n_prb=25, cell_id=5, n_ports=2, cfi=1))
        p.add_ue(0x50, (1,) * 25, qm=4)
        pdus = [bytes([i]) * 150 for i in range(5)]
        assert p.send(0x50, pdus, pathloss_db=95.0) == pdus
    assert p.device.type == "cuda" and p.gen.device.type == "cuda"


@pytest.mark.parametrize("kind", ["data", "control"])
def test_a_step_past_the_table_caches_bound_is_graphed(dev, kind):
    """netsim --waveform's planes with more UEs than a per-UE table cache
    holds (bound 64; chip_smoke.py's crowded planes at 100 PRB, cfi 3:
    send_tti with 80 one-PRB grants, UlControlPlane with 65 UEs), graphed
    (the card's default) against jit=False on generators seeded alike over
    two calls: every PDU delivered or ACK detected, results, metrics and
    generator states equal, one graph, holding more tables than the bound."""
    from srslte_emane_tpu_torch.runtime import graphs

    make = getattr(_chip_smoke(), f"crowded_{kind}_plane")
    (graphed, call), (eager, _) = make(True), make(False)
    assert graphed.jit and graphed.device.type == "cuda"
    built = graphs.STATS["graphs"]
    for _ in range(2):
        got, want = call(graphed), call(eager)
        torch.cuda.synchronize()
        assert got == want
        assert graphed.metrics == eager.metrics
        assert torch.equal(graphed.gen.get_state(), eager.gen.get_state())
    assert graphs.STATS["graphs"] - built == 1 and not eager.graph_counts()
    ((graph,),) = (g.values() for g in graphed.step_graphs().values())
    assert len(graph.tables) > 64


# ---------------- sync, TDD, PRACH (chip_smoke.py phase 10) ----------------

def test_cell_search_sweep_on_the_card_equals_the_cpu(dev):
    """chip_smoke's cell search capture (cell 301, 6 PRB, sf 0, 5 dB, +1 kHz)
    at batch 8 under its 5 CFO hypotheses: the -1 kHz rows find the cell
    with normal CP, and every row's ids equal the CPU's."""
    from srslte_emane_tpu_torch.ops import cplx, fading, ofdm
    from srslte_emane_tpu_torch.phch import grid, pdsch, sync

    smoke = _chip_smoke()
    cell = grid.CellConfig(n_prb=6, cell_id=smoke.SEARCH_CELL)
    g = pdsch.put_crs(sync.put_pss_sss(cplx.zeros((8, 14, 72), device=dev), cell, 0), cell, 0)
    tx = ofdm.modulate(g, 6)
    gen = torch.Generator(device=dev).manual_seed(0)
    caps = fading.apply_cfo(tx + smoke.noise_like(gen, tx, smoke.SEARCH_SNR_DB),
                            smoke.SEARCH_CFO_HZ, 1.92e6)
    hyp = torch.tensor(smoke.CFO_HYPOTHESES_HZ, device=dev)[:, None]
    sweep = lambda x: sync.cell_search(
        fading.apply_cfo_dyn(x[:, None], hyp.to(x.device), 1.92e6).reshape(-1, 1920, 2),
        detect_cp=True)
    res, res_cpu = sweep(caps), sweep(caps.cpu())
    h0 = smoke.CFO_HYPOTHESES_HZ.index(-smoke.SEARCH_CFO_HZ)
    assert (res["cell_id"].reshape(8, -1)[:, h0] == smoke.SEARCH_CELL).all()
    assert not res["cp_ext"].reshape(8, -1)[:, h0].any()
    for k in ("n_id_2", "pss_pos", "n_id_1", "sf_idx", "cell_id", "cp_ext"):
        assert torch.equal(res[k].cpu(), res_cpu[k]), k


def test_tdd_frame_on_the_card(dev):
    """A TDD frame (config 1, special subframe 7) at 25 PRB, batch 4, 20 dB:
    every D, S and U CRC passes, bits exact, through turbo_map."""
    from srslte_emane_tpu_torch.models import tdd_frame
    from srslte_emane_tpu_torch.phch import grid, tdd

    cfg = tdd_frame.TddFrameConfig(cell=grid.CellConfig(n_prb=25, cell_id=4, cfi=1),
                                   sf_config=1, ss_config=7, qm=4, ul_l_prb=24)
    rng = np.random.default_rng(0)
    bits = lambda n: torch.from_numpy(rng.integers(0, 2, (4, n), dtype=np.int8)).to(dev)
    dl = {sf: bits(cfg.dl_cfg(sf).tbs) for sf in tdd.dl_subframes(1)}
    ul = {sf: bits(cfg.ul_cfg().tbs) for sf in tdd.ul_subframes(1)}
    before = turbodecoder_cuda.launches
    out = tdd_frame.run_frame(cfg, dl, ul, torch.Generator(device=dev).manual_seed(1))
    assert turbodecoder_cuda.launches > before
    for kind, sent in (("dl", dl), ("ul", ul)):
        for sf, tb in sent.items():
            b, ok = out[kind][sf]
            assert ok.all() and torch.equal(b, tb), (kind, sf)


def test_prach_detection_on_the_card(dev):
    """PRACH format 0 at 30.72 Msps, batch 8, random preambles: each sent
    preamble is detected at timing offset 0, and the detections and offsets
    equal the CPU's."""
    from srslte_emane_tpu_torch.phch import prach

    idx = torch.from_numpy(np.random.default_rng(2).integers(0, 64, 8)).to(dev)
    t = prach.gen_waveform(idx, 6, 2)
    t = t + 0.7 * torch.randn(t.shape, generator=torch.Generator(device=dev).manual_seed(3),
                              device=dev)
    chain = lambda x: prach.detect(prach.rx_waveform_to_freq(x), 6, 2)
    det, _, toff = chain(t)
    det_cpu, _, toff_cpu = chain(t.cpu())
    b = torch.arange(8, device=dev)
    assert det[b, idx].all() and (toff[b, idx] == 0).all()
    assert torch.equal(det.cpu(), det_cpu) and torch.equal(toff[det].cpu(), toff_cpu[det_cpu])


def test_scan_and_prach_run_on_the_card_from_numpy_ids(dev):
    """network_scan and prach.gen_waveform given numpy ids, as the reference's
    callers pass them, run on the card and equal the CPU's result."""
    from srslte_emane_tpu_torch.models import netscan
    from srslte_emane_tpu_torch.phch import prach

    n = 6
    ids = np.arange(10, 10 + n)
    g = np.zeros((n, n), np.complex64)
    g[np.arange(n), (np.arange(n) + 3) % n] = 1.0
    res = netscan.network_scan(None, ids, g)
    assert res["cell_id"].device.type == "cuda"
    assert (res["cell_id"].cpu().numpy() == ids[(np.arange(n) + 3) % n]).all()
    assert torch.equal(res["cell_id"].cpu(), netscan.network_scan(None, ids, g, device="cpu")["cell_id"])
    t = prach.gen_waveform(np.array([3, 9]))
    assert t.device.type == "cuda"
    t_cpu = prach.gen_waveform(np.array([3, 9]), device="cpu")
    assert ((t.cpu() - t_cpu).square().mean() / t_cpu.square().mean()).sqrt() < 1e-5


@pytest.mark.parametrize("k,B,narrow", [(5056, 512, False), (5120, 128, False),
                                         (5312, 128, False)])
def test_kernel_equals_plain_at_the_phase_10_shapes(dev, k, B, narrow):
    """turbo_map bit for bit, f32, at shapes the smoke's phase 10 launches:
    512 x K=5056 (the extended-CP decode and the TDD frame), 128 x K=5120
    (the extended-CP decode) and 128 x K=5312 (the fading link)."""
    args = _inputs(k, B, dev)
    w = turbodecoder._pick_windows(k)
    got = turbodecoder_cuda.map_decode_cuda(*args, w, narrow)
    assert torch.equal(got, turbodecoder_cuda.map_decode_ref(*args, w, narrow))


@pytest.mark.parametrize("k,B", [(4416, 1280), (5184, 1280), (3136, 128), (4288, 64)])
def test_kernel_equals_plain_at_the_block_shapes(dev, k, B):
    """turbo_map bit for bit, bf16 mode (llr_bits=16), at the block engines'
    shapes (chip_smoke.py phase 11): the SPS block's DL 1280 x K=4416 (also
    each TM3 codeword) and UL 1280 x K=5184 at T=160, 8 UEs; the dynamic
    block's DL 128 x K=3136 (2 code blocks x 8 TTIs x 8 UEs) and UL
    64 x K=4288 per round."""
    args = _inputs(k, B, dev)
    w = turbodecoder._pick_windows(k)
    got = turbodecoder_cuda.map_decode_cuda(*args, w, True)
    assert torch.equal(got, turbodecoder_cuda.map_decode_ref(*args, w, True))


def test_sps_block_kernel_equals_plain_on_the_card(dev):
    """The SPS block of chip_smoke.py at T=8 (100 PRB, 8 UEs, llr_bits=16)
    on the card through turbo_map equals the same call with the plain MAP
    (use_kernel=False), output for output, under the same noise."""
    from srslte_emane_tpu_torch.runtime import waveblock

    cfg = _chip_smoke().sps_config(8)
    rng = np.random.default_rng(0)
    dl = rng.integers(0, 2, (cfg.T, cfg.n_ues, cfg.dl_tbs), dtype=np.int8)
    ul = rng.integers(0, 2, (cfg.T, cfg.n_ues, cfg.ul_tbs), dtype=np.int8)
    outs = []
    for use_kernel in (None, False):
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        before = turbodecoder_cuda.launches
        outs.append(waveblock.make_block_step(cfg._replace(use_kernel=use_kernel), sfn0=4)(
            dl, ul, gen, 0))
        assert (turbodecoder_cuda.launches > before) == (use_kernel is None)
    for k, v in outs[0].items():
        assert torch.equal(v, outs[1][k]), k
    assert bool(outs[0]["dl_ok"].all()) and bool(outs[0]["ul_ok"].all())
    assert np.array_equal(outs[0]["dl_out"].cpu().numpy(), dl)


def test_block_entry_points_return_tensors_on_the_card(dev):
    """make_block_step (SISO and TM3), make_dyn_block_step and both
    make_bench_steps default to the card and, given numpy inputs, return
    tensors there (15 PRB, 2 UEs)."""
    from srslte_emane_tpu_torch.phch import grid, pdcch
    from srslte_emane_tpu_torch.runtime import waveblock, waveblock_dyn

    rng = np.random.default_rng(2)
    gen = torch.Generator(device=dev)
    for tm3 in (False, True):
        cell = grid.CellConfig(n_prb=15, cell_id=1, cfi=2, n_ports=2 if tm3 else 1)
        n_cce = pdcch.n_cce(cell)
        cfg = waveblock.BlockConfig(
            cell=cell, rntis=(70, 71), dl_rb_start=(0, 11), dl_l_crbs=4, dl_mcs=10,
            ul_rb_start=(1, 5), ul_l_prb=4, ul_mcs=10, ack_res=(n_cce, n_cce + 1),
            snr_db=(30.0, 29.0), T=2, tm3=tm3)
        dl = rng.integers(0, 2, (2, 2) + ((2,) if tm3 else ()) + (cfg.dl_tbs,), dtype=np.int8)
        ul = rng.integers(0, 2, (2, 2, cfg.ul_tbs), dtype=np.int8)
        out = waveblock.make_block_step(cfg)(dl, ul, gen, 0)
        assert all(v.device.type == "cuda" for v in out.values())
        assert bool(out["dl_ok"].all()) and bool(out["ul_ok"].all())
        counts = waveblock.make_bench_step(cfg)(dl, ul, gen, 0)
        assert all(c.device.type == "cuda" for c in counts)
    dcfg = waveblock_dyn.DynBlockConfig(
        cell=grid.CellConfig(n_prb=15, cell_id=1, cfi=2), rntis=(70, 71), dl_l_crbs=3,
        dl_mcs=8, ul_l_prb=2, ul_mcs=8, snr_db=(30.0, 28.0), R=1)
    rb_dl, rb_ul = waveblock_dyn.make_schedule(dcfg, seed=1)
    dl_q = rng.integers(0, 2, (dcfg.T, 2, dcfg.dl_tbs), dtype=np.int8)
    ul_q = rng.integers(0, 2, (dcfg.T, 2, dcfg.ul_tbs), dtype=np.int8)
    out = waveblock_dyn.make_dyn_block_step(dcfg)(dl_q, ul_q, rb_dl, rb_ul, gen, 0)
    assert all(v.device.type == "cuda" for v in out.values())
    assert int(out["dl_ok"].sum()) == int(out["ul_ok"].sum()) == dcfg.T * 2
    counts = waveblock_dyn.make_bench_step(dcfg)(dl_q, ul_q, rb_dl, rb_ul, gen, 0)
    assert all(c.device.type == "cuda" for c in counts)


def _port_network(tmp, device):
    """tests/test_waveblock.py's network (15 PRB, 2 UEs, 80 dB, seed 3,
    preambles 11 + 5i) on the port alone, with a MAC pcap."""
    from srslte_emane_tpu_torch.epc import hss as hss_mod, mme as mme_mod, spgw as spgw_mod
    from srslte_emane_tpu_torch.runtime import wavenet
    from srslte_emane_tpu_torch.stack import enb_stack, security, ue_stack
    from srslte_emane_tpu_torch.utils import pcap

    hss = hss_mod.Hss()
    spgw = spgw_mod.Spgw()
    enb = enb_stack.EnbStack(mme_mod.Mme(hss, spgw), enb_id=1, n_prb=15)
    ues = []
    for i in range(2):
        imsi, key = f"00101000000002{i:02d}", bytes(range(16))
        hss.add(hss_mod.Subscriber(imsi=imsi, key=key))
        opc = security.milenage_opc(key, b"\x00" * 16)
        ues.append(ue_stack.UeStack(ue_stack.Usim(imsi, key, opc), preamble=11 + 5 * i))
    net = wavenet.WaveformNetwork(enb, ues, pathloss_db=np.full(2, 80.0), n_prb=15, seed=3,
                                  pcap=pcap.MacPcap(str(tmp / f"{device}.pcap")),
                                  **({} if device == "cuda" else dict(device=device)))
    return net, ues, spgw, spgw_mod


def test_network_on_the_card_equals_the_cpu(dev, tmp_path, monkeypatch):
    """The waveform network on the card (its default device) in lockstep
    with the same network on the CPU, both fed one seeded numpy noise stream
    each and the same HSS RAND: per TTI the sync, EMM/RRC/MAC states and PHY
    metrics, then the MAC pcaps and the delivered IP packets, are equal."""
    import types

    from srslte_emane_tpu_torch.epc import hss as hss_mod
    from srslte_emane_tpu_torch.runtime import wavenet

    rngs = {"cuda": np.random.default_rng(5), "cpu": np.random.default_rng(5)}

    def randn(gen, shape, device):
        x = rngs[torch.device(device).type].standard_normal(tuple(shape)).astype(np.float32)
        return torch.from_numpy(x).to(device)

    monkeypatch.setattr(wavenet, "_randn", randn)
    monkeypatch.setattr(hss_mod, "os", types.SimpleNamespace(urandom=lambda n: bytes(range(n))))
    sides = [_port_network(tmp_path, d) for d in ("cuda", "cpu")]
    assert sides[0][0].device.type == "cuda" and sides[1][0].device.type == "cpu"

    def state(side):
        net, ues, _, _ = side
        return ([u.state for u in net.ues], [(u.emm_state, u.rrc_state, u.mac_state) for u in ues],
                net.enb.metrics, [u.metrics for u in net.ues])

    def run(n):
        for _ in range(n):
            for net, *_ in sides:
                net.run(1)
            assert state(sides[0]) == state(sides[1]), sides[0][0].tti

    while sides[0][0].tti < 300 and not all(u.emm_state == "REGISTERED" for u in sides[0][1]):
        run(1)
    assert all(u.emm_state == "REGISTERED" for _, ues, _, _ in sides for u in ues)
    for _, ues, spgw, spgw_mod in sides:
        for u in ues:
            assert spgw.handle_sgi_pdu(spgw_mod.make_ipv4("8.8.8.8", u.ip_addr, b"blk" * 40))
    run(20)
    gw = [[list(u.gw_rx) for u in ues] for _, ues, _, _ in sides]
    assert gw[0] == gw[1] and all(gw[0])
    recs = [(tmp_path / f"{d}.pcap").read_bytes() for d in ("cuda", "cpu")]
    strip = lambda b: [b[o + 16 : o + 16 + n] for o, n in _pcap_offsets(b)]
    assert len(strip(recs[0])) > 40 and strip(recs[0]) == strip(recs[1])


def _pcap_offsets(data):
    """(offset, length) of every pcap record."""
    import struct

    off, out = 24, []
    while off < len(data):
        n = struct.unpack("!IIII", data[off : off + 16])[2]
        out.append((off, n))
        off += 16 + n
    return out


# ---------------- slice 13c (chip_smoke.py phase 13) ----------------

@pytest.mark.parametrize("k,B,narrow", [(3136, 256, True), (4288, 128, True), (1248, 1, False),
                                         (4736, 3, False), (4928, 6, False), (6144, 2, False)])
def test_kernel_equals_plain_at_the_phase_13_shapes(dev, k, B, narrow):
    """turbo_map bit for bit at shapes chip_smoke.py phase 13 launches: the
    two-cell dynamic block's DL 256 x K=3136 (2 code blocks x 8 TTIs x 8
    UEs x 2 cells) and UL 128 x K=4288 per round in bf16 mode, and the
    networks' few-row f32 decodes (1 x K=1248, 3 x K=4736 and 6 x K=4928
    of rank-2 grants, 2 x K=6144)."""
    args = _inputs(k, B, dev)
    w = turbodecoder._pick_windows(k)
    got = turbodecoder_cuda.map_decode_cuda(*args, w, narrow)
    assert torch.equal(got, turbodecoder_cuda.map_decode_ref(*args, w, narrow))


def test_rlf_outage_reestablishment_on_the_card(dev):
    """tests/test_wavenet.py::test_waveform_rlf_outage_reestablishment on
    the port, on the card: 15 PRB, 1 UE, seed 23; after the attach a 1.6 s
    outage every 4 s (rlf=(4.0, 1.6), set on the medium) trips N310 and RLF,
    RRC reestablishment recovers the connection once the link is back, and
    the user plane carries packets again."""
    from srslte_emane_tpu_torch.epc import hss as hss_mod, mme as mme_mod, spgw as spgw_mod
    from srslte_emane_tpu_torch.runtime import wavenet
    from srslte_emane_tpu_torch.stack import enb_stack, security, ue_stack

    hss = hss_mod.Hss()
    spgw = spgw_mod.Spgw()
    enb = enb_stack.EnbStack(mme_mod.Mme(hss, spgw), enb_id=1, n_prb=15)
    imsi, key = "001010000000000", bytes(range(16))
    hss.add(hss_mod.Subscriber(imsi=imsi, key=key))
    ue = ue_stack.UeStack(ue_stack.Usim(imsi, key, security.milenage_opc(key, b"\x00" * 16)),
                          preamble=7)
    net = wavenet.WaveformNetwork(enb, [ue], pathloss_db=np.full(1, 80.0), n_prb=15, seed=23)
    assert net.device.type == "cuda"
    for _ in range(8):
        net.run(50)
        if ue.emm_state == "REGISTERED":
            break
    assert ue.emm_state == "REGISTERED"
    net.medium.rlf = (4.0, 1.6)
    pkt = spgw_mod.make_ipv4("8.8.8.8", ue.ip_addr, b"rlf" * 20)
    for _ in range(40):
        spgw.handle_sgi_pdu(pkt)
        net.run(100)
        if ue.metrics.get("rlf", 0) >= 1 and ue.rrc_state == "CONNECTED" \
                and not net.medium.in_outage(net.tti):
            break
    assert ue.metrics.get("rlf", 0) >= 1, dict(ue.metrics)
    assert ue.rrc_state == "CONNECTED", (ue.rrc_state, dict(ue.metrics))
    n_before = len(ue.gw_rx)
    spgw.handle_sgi_pdu(pkt)
    net.run(40)
    assert len(ue.gw_rx) > n_before


def test_dyn_bench_step_across_cells_on_the_card(dev):
    """make_bench_step(n_cells=2) on the card (its default) from numpy
    inputs with a leading cells axis and one generator per cell: the six
    counts come back on the card and equal the sums of the two one-cell
    blocks with the same generators' seeds (15 PRB, 2 UEs, R=2)."""
    from srslte_emane_tpu_torch.phch import grid
    from srslte_emane_tpu_torch.runtime import waveblock_dyn

    cfg = waveblock_dyn.DynBlockConfig(
        cell=grid.CellConfig(n_prb=15, cell_id=1, cfi=2), rntis=(70, 71), dl_l_crbs=3,
        dl_mcs=8, ul_l_prb=2, ul_mcs=8, snr_db=(30.0, 28.0), R=2)
    rng = np.random.default_rng(4)
    sched = [waveblock_dyn.make_schedule(cfg, seed=1 + c) for c in range(2)]
    ins = (rng.integers(0, 2, (2, cfg.T, 2, cfg.dl_tbs), dtype=np.int8),
           rng.integers(0, 2, (2, cfg.T, 2, cfg.ul_tbs), dtype=np.int8),
           np.stack([s[0] for s in sched]), np.stack([s[1] for s in sched]))

    def gens(*seeds):
        out = [torch.Generator(device=dev) for _ in seeds]
        for g, s in zip(out, seeds):
            g.manual_seed(s)
        return out

    counts = waveblock_dyn.make_bench_step(cfg, n_cells=2)(*ins, gens(5, 6), 0)
    assert all(c.device.type == "cuda" for c in counts)
    one = waveblock_dyn.make_bench_step(cfg)
    singles = [one(*(a[c] for a in ins), gens(s)[0], 0) for c, s in enumerate((5, 6))]
    assert [int(x) for x in counts] == [int(a) + int(b) for a, b in zip(*singles)]
    assert [int(x) for x in counts] == [2 * cfg.T * 2] * 3 + [0, 0, 0]


def test_mesh_defaults_to_the_cards(dev):
    """make_mesh takes the cards by default; a 1-device mesh is (1, 1)."""
    from srslte_emane_tpu_torch.parallel import mesh as mesh_mod

    m = mesh_mod.make_mesh()
    assert m.size == torch.cuda.device_count() and all(d.type == "cuda" for d in m.devices)
    one = mesh_mod.make_mesh(1)
    assert one.devices == [dev] and one.shape == {"node": 1, "sf": 1}


def test_sharded_link_on_the_card_equals_the_unsharded_step(dev):
    """make_link_step_sharded on a 1-device mesh (15 PRB, 64QAM, llr_bits=16,
    batch 8) through turbo_map: every CRC, the payload, 0 cross-device
    transfers, and the same outputs as make_link_step given the noise the
    sharded step drew (its generator's seed for position (0, 0))."""
    from srslte_emane_tpu_torch.models import pdsch_link
    from srslte_emane_tpu_torch.parallel import mesh as mesh_mod
    from srslte_emane_tpu_torch.phch import grid

    cfg = pdsch_link.LinkConfig(cell=grid.CellConfig(n_prb=15, cell_id=1, cfi=1), qm=6,
                                code_rate=0.55, snr_db=20.0, llr_bits=16)
    mesh = mesh_mod.make_mesh(1)
    payload = torch.from_numpy(
        np.random.default_rng(6).integers(0, 2, (8, cfg.tbs), dtype=np.int8)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    before = turbodecoder_cuda.launches
    out, ok, snr = pdsch_link.make_link_step_sharded(cfg, mesh)(payload, gen)
    assert turbodecoder_cuda.launches > before
    assert bool(ok.all()) and torch.equal(out, payload) and mesh.transfers == 0
    base = int(torch.randint(0, 2 ** 62, (1,), generator=torch.Generator(device=dev).manual_seed(6),
                             device=dev))
    g0 = torch.Generator(device=dev).manual_seed(pdsch_link._device_seed(base, 0, 0))
    ref = pdsch_link.make_link_step(cfg)(payload, g0)
    assert torch.equal(ref[0], out) and torch.equal(ref[1], ok) and torch.equal(ref[2], snr)


def test_ota_collective_on_the_card(dev):
    from srslte_emane_tpu_torch.parallel import mesh as mesh_mod, ota_collective

    mesh = mesh_mod.make_mesh(1)
    rng = np.random.default_rng(7)
    tx = rng.normal(size=(4, 2, 256, 2)).astype(np.float32)
    g = (rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))).astype(np.complex64)
    rx = mesh_mod.gather(ota_collective.ota_mix_sharded(mesh, tx, g))
    assert rx.device == dev
    gd = g * (1 - np.eye(4, dtype=np.float32))
    want = np.einsum("mn,nbs->mbs", gd, tx[..., 0] + 1j * tx[..., 1])
    np.testing.assert_allclose(rx.cpu().numpy(), np.stack([want.real, want.imag], -1), atol=1e-4)
    p = ota_collective.total_rx_power_psum(mesh, tx)
    assert p.device == dev
    np.testing.assert_allclose(float(p), sum(np.mean(np.sum(tx[i] ** 2, -1)) for i in range(4)),
                               rtol=1e-5)


def test_sharded_block_on_the_card(dev):
    """make_block_step_sharded, 1 cell on a 1-device mesh (15 PRB, 2 UEs,
    T=2): every CRC and payload, its tables on the card, 0 transfers."""
    from srslte_emane_tpu_torch.parallel import mesh as mesh_mod
    from srslte_emane_tpu_torch.phch import grid, pdcch
    from srslte_emane_tpu_torch.runtime import waveblock

    cell = grid.CellConfig(n_prb=15, cell_id=1, cfi=2)
    n_cce = pdcch.n_cce(cell)
    c0, c1 = waveblock.centre_prbs(15)
    starts, w = waveblock._pack_segments(15, 2, [(0, c0), (c1, 15)])
    cfg = waveblock.BlockConfig(cell=cell, rntis=(70, 71), dl_rb_start=starts, dl_l_crbs=w,
                                dl_mcs=8, ul_rb_start=(1, 5), ul_l_prb=4, ul_mcs=8,
                                ack_res=(n_cce, n_cce + 1), snr_db=(30.0, 28.0), T=2)
    mesh = mesh_mod.make_mesh(1)
    step, consts = waveblock.make_block_step_sharded(cfg, mesh, (5,))
    assert all(v.device == dev for v in consts[0].values())
    rng = np.random.default_rng(8)
    dl = rng.integers(0, 2, (1, 2, 2, cfg.dl_tbs), dtype=np.int8)
    ul = rng.integers(0, 2, (1, 2, 2, cfg.ul_tbs), dtype=np.int8)
    out = step(dl, ul, [torch.Generator(device=dev).manual_seed(8)], 20)
    assert all(v.device == dev for v in out.values())
    assert bool(out["dl_ok"].all()) and bool(out["ul_ok"].all())
    assert np.array_equal(out["dl_out"].cpu().numpy(), dl) and mesh.transfers == 0


def test_both_kernels_equal_plain_at_the_profile_turbo_shape(dev):
    """scripts/profile_turbo.py's defaults: 1024 x K=5568 in f32 on its
    draws (W=32, L=174): turbo_map and turbo_map_v1 each one launch, bit for
    bit with their plain versions; L=174 fits v1's shared memory."""
    from srslte_emane_tpu_torch.scripts import profile_turbo

    inp = profile_turbo.inputs(1024, 5568, dev)
    args = (inp["ls"], inp["lp"], *inp["tails"])
    w = turbodecoder._pick_windows(5568)
    assert w == 32
    cols, blocks = turbodecoder_cuda.occupancy_v1(5568, w)
    assert cols > 1 and blocks > 0
    before = (turbodecoder_cuda.launches, turbodecoder_cuda.launches_v1)
    got = turbodecoder_cuda.map_decode_cuda(*args, w)
    got_v1 = turbodecoder_cuda.map_decode_v1_cuda(*args, w)
    torch.cuda.synchronize()
    assert (turbodecoder_cuda.launches, turbodecoder_cuda.launches_v1) == (before[0] + 1,
                                                                           before[1] + 1)
    assert torch.equal(got, turbodecoder_cuda.map_decode_ref(*args, w))
    assert torch.equal(got_v1, turbodecoder_cuda.map_decode_v1_ref(*args, w))


def test_rank1_tm3_block_on_the_card_equals_the_cpu(dev):
    """The reference's rank-1 scenario (tests/test_waveblock_tm3.py:93-98,
    mimo_cond_db=60) at 15 PRB, 2 UEs, T=2 on the card, against the CPU on
    the card's noise: every codeword fails on both, so the decoders run
    every iteration; CRC flags and the UL bits equal, the bundled NACK
    (energy above 0.25, value negative) within 1e-4."""
    from srslte_emane_tpu_torch.phch import grid, pdcch
    from srslte_emane_tpu_torch.runtime import waveblock

    smoke = _chip_smoke()
    cell = grid.CellConfig(n_prb=15, cell_id=1, cfi=2, n_ports=2)
    n_cce = pdcch.n_cce(cell)
    c0, c1 = waveblock.centre_prbs(15)
    starts, w = waveblock._pack_segments(15, 2, [(0, c0), (c1, 15)])
    cfg = waveblock.BlockConfig(cell=cell, rntis=(70, 71), dl_rb_start=starts, dl_l_crbs=w,
                                dl_mcs=10, ul_rb_start=(1, 5), ul_l_prb=4, ul_mcs=10,
                                ack_res=(n_cce, n_cce + 1), snr_db=(30.0, 29.0), T=2, tm3=True,
                                mimo_cond_db=60.0)
    rng = np.random.default_rng(0)
    dl = rng.integers(0, 2, (2, 2, 2, cfg.dl_tbs), dtype=np.int8)
    ul = rng.integers(0, 2, (2, 2, cfg.ul_tbs), dtype=np.int8)
    record = []
    with smoke.recorded_noise(record=record):
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        before = turbodecoder_cuda.launches
        out = waveblock.make_block_step(cfg, sfn0=8, jit=False)(dl, ul, gen, 40)
        assert turbodecoder_cuda.launches > before
    with smoke.recorded_noise(replay=record):
        cpu = waveblock.make_block_step(cfg, sfn0=8, device="cpu")(dl, ul, torch.Generator(), 40)
    for o in (out, cpu):
        assert not bool(o["dl_ok_cw"].any()) and bool(o["ul_ok"].all())
        assert bool((o["ack_energy"] > 0.25).all()) and bool((o["ack_val"] < 0).all())
    for k in ("dl_ok", "dl_ok_cw", "ul_ok", "ul_out"):
        assert torch.equal(out[k].cpu(), cpu[k]), k
    for k in ("ack_val", "ack_energy"):
        torch.testing.assert_close(out[k].cpu(), cpu[k], rtol=1e-4, atol=1e-5)


# ---------------- the Viterbi kernel (csrc/viterbi.cu) ----------------

# every K a caller passes: UCI 20, 28, 38; PBCH 40; DCI 1A / 1 / 2A at 100
# PRB 44, 55, 64; NPBCH 50; NPDSCH 224
VIT_KS = (20, 28, 38, 40, 44, 50, 55, 64, 224)
# (rows, K) of the kernel's launches in chip_smoke.py's phases 8 (the DL
# subframe's blind searches at batch 128, its sf 0 at batch 16), 10 (MIB,
# NPBCH, NPDSCH, the multi-cell step, the TDD frame), 11 (the dynamic
# block), 12 (the network) and 13 (TM3's DCI 2A, the two-cell block)
VIT_PATH_SHAPES = ((2688, 44), (2816, 44), (304, 44), (320, 44), (336, 44), (352, 44),
                   (128, 40), (1024, 40), (128, 50), (128, 224), (168, 44), (8, 40), (384, 44),
                   (1256, 44), (1, 38), (1256, 64), (768, 44), (64, 40))


@pytest.mark.parametrize("tb_iter", (1, 3, 5))
@pytest.mark.parametrize("k", VIT_KS)
def test_viterbi_kernel_equals_plain(dev, k, tb_iter):
    """Bit for bit at 1, 3, 5 and 131 rows, and 2,817 at K=44 (each a
    partial last block: a warp of 4 rows): threshold LLRs (equal metrics)
    with an all-zero row (every decision a tie), and clean codewords
    decoded right."""
    from srslte_emane_tpu_torch.ops.fec import convcoder, viterbi, viterbi_cuda

    smoke = _chip_smoke()
    for rows in (1, 3, 5, 131) + ((2817,) if k == 44 else ()):
        x = smoke.viterbi_inputs(rows, k, dev, 10 * rows + k)
        before = viterbi_cuda.launches
        got = viterbi.viterbi_decode(x, tb_iter)
        torch.cuda.synchronize()
        assert viterbi_cuda.launches == before + 1
        assert torch.equal(got, viterbi.viterbi_decode_ref(x, tb_iter)), rows
        assert not bool(got[0].any())  # the all-zero row: state 0 throughout
    bits = torch.from_numpy(np.random.default_rng(k).integers(0, 2, (7, k), dtype=np.int8)).to(dev)
    clean = 1.0 - 2.0 * convcoder.conv_encode(bits).float()
    assert torch.equal(viterbi.viterbi_decode(clean, max(tb_iter, 2)), bits)


@pytest.mark.parametrize("rows,k", VIT_PATH_SHAPES)
def test_viterbi_kernel_equals_plain_at_the_path_shapes(dev, rows, k):
    from srslte_emane_tpu_torch.ops.fec import viterbi

    x = _chip_smoke().viterbi_inputs(rows, k, dev, rows + k)
    got = viterbi.viterbi_decode(x)
    assert torch.equal(got, viterbi.viterbi_decode_ref(x))


# a `python -c` body: one viterbi_decode call per K of its arguments under
# torch.profiler, after a warm-up; prints {K: [Viterbi kernels, other
# device kernels]}
PROFILE_ONE_CALL = """
import json, sys, torch
from torch.profiler import ProfilerActivity, profile
from srslte_emane_tpu_torch.ops.fec import viterbi
counts = {}
for k in map(int, sys.argv[1:]):
    x = torch.randn((300, 3, k), generator=torch.Generator().manual_seed(k)).cuda()
    viterbi.viterbi_decode(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        viterbi.viterbi_decode(x)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}
    vit = sum(n for name, n in kernels.items() if "viterbi_kernel" in name)
    counts[k] = [vit, sum(kernels.values()) - vit]
print(json.dumps(counts))
"""


def test_viterbi_decode_is_one_launch(dev):
    """One viterbi_decode call on the card: one Viterbi kernel and at most
    4 other device kernels (the branch metrics), whatever K is, counted with
    torch.profiler in a fresh process (in this one, earlier tests of the
    file leave the profiler without device events); no launch for no rows."""
    import json
    import subprocess
    import sys

    from srslte_emane_tpu_torch.ops.fec import viterbi, viterbi_cuda

    out = subprocess.run([sys.executable, "-c", PROFILE_ONE_CALL, "28", "64", "200"],
                         cwd=pathlib.Path(__file__).resolve().parents[1], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    counts = json.loads(out.stdout.splitlines()[-1])
    assert sorted(counts) == ["200", "28", "64"], counts
    for k, (vit, others) in counts.items():
        assert vit == 1 and others <= 4, (k, vit, others)
    before = viterbi_cuda.launches
    empty = viterbi.viterbi_decode(torch.zeros((0, 3, 44), device=dev))
    assert tuple(empty.shape) == (0, 44) and viterbi_cuda.launches == before


def test_viterbi_wrapper_rejects_what_the_kernel_does_not_take(dev):
    from srslte_emane_tpu_torch.ops.fec import viterbi_cuda

    bm = torch.zeros((3, 44, 8), device=dev)
    before = viterbi_cuda.launches
    with pytest.raises(TypeError, match="float32"):
        viterbi_cuda.launch(bm.double())
    with pytest.raises(ValueError, match="contiguous"):
        viterbi_cuda.launch(torch.zeros((3, 8, 44), device=dev).transpose(1, 2))
    with pytest.raises(ValueError, match="beyond both variants"):
        viterbi_cuda.launch(torch.zeros((3, 70000, 8), device=dev))
    with pytest.raises(ValueError, match="CUDA"):
        viterbi_cuda.launch(bm.cpu())
    with pytest.raises(ValueError, match="tb_iter"):
        viterbi_cuda.launch(bm, 0)
    assert viterbi_cuda.launches == before
    assert viterbi_cuda.occupancy(44) > 0


def test_control_decoders_reach_the_viterbi_kernel(dev):
    """blind_search and pbch.decode on the card: one Viterbi launch each,
    and no call of the plain loop."""
    from srslte_emane_tpu_torch.ops.fec import viterbi, viterbi_cuda
    from srslte_emane_tpu_torch.phch import dci, pbch, pdcch

    cell, (g, ce), _ = _control_grid(dev)
    ref = viterbi.viterbi_decode_ref
    try:
        viterbi.viterbi_decode_ref = lambda *a, **kw: pytest.fail("plain loop on the card")
        before = viterbi_cuda.launches
        pdcch.blind_search(g, ce, cell, 0, 0x46, dci.format0_1a_len(25))
        pbch.decode(g, ce, cell)
        torch.cuda.synchronize()
    finally:
        viterbi.viterbi_decode_ref = ref
    assert viterbi_cuda.launches == before + 2


@pytest.mark.parametrize("k", [1211, 4000])
def test_viterbi_beyond_shared_memory_equals_plain(dev, k):
    """A K whose decisions do not fit a block's shared memory takes the
    global-memory variant: one launch, bit for bit against the plain loop,
    on threshold LLRs with an all-zero row, at 1, 3, 5 and 9 rows (K = 1,210,
    the last K in shared memory, beside it)."""
    from srslte_emane_tpu_torch.ops.fec import viterbi, viterbi_cuda

    smoke = _chip_smoke()
    lib = viterbi_cuda._lib()
    assert not lib.viterbi_fits(k, 3) and lib.viterbi_fits(1210, 3)
    for rows, kk in [(r, k) for r in (1, 3, 5, 9)] + [(5, 1210)]:
        x = smoke.viterbi_inputs(rows, kk, dev, rows + kk)
        before = viterbi_cuda.launches
        got = viterbi.viterbi_decode(x)
        torch.cuda.synchronize()
        assert viterbi_cuda.launches == before + 1
        assert torch.equal(got, viterbi.viterbi_decode_ref(x)), (rows, kk)
    assert viterbi_cuda.occupancy(k) > 0 and viterbi_cuda.rows_per_block() == 4


def test_npdsch_at_the_largest_tbs_on_the_card(dev, monkeypatch):
    """NB-IoT's largest TBS, 2,536 bits (K = 2,552 with its CRC16) over 32
    subframes at 12 dB: decoded on the card through the kernel, bit for bit
    as with the plain loop on the same LLRs, and right."""
    from srslte_emane_tpu_torch.ops.fec import viterbi, viterbi_cuda
    from srslte_emane_tpu_torch.phch import nbiot

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tb = torch.from_numpy(np.random.default_rng(2).integers(0, 2, (4, 2536), dtype=np.int8)).to(dev)
    rx = channel.awgn(gen, nbiot.npdsch_encode(tb, 32, 5, 0x51), 12.0)
    before = viterbi_cuda.launches
    bits, ok = nbiot.npdsch_decode(rx, 2536, 5, 0x51)
    assert viterbi_cuda.launches == before + 1
    monkeypatch.setattr(viterbi, "viterbi_decode", viterbi.viterbi_decode_ref)
    bits_ref, ok_ref = nbiot.npdsch_decode(rx, 2536, 5, 0x51)
    assert torch.equal(bits, bits_ref) and torch.equal(ok, ok_ref)
    assert bool(ok.all()) and torch.equal(bits, tb)


# ---------------- the turbo decoder's loop on the card (csrc/turbo_iter.cu) ----------------

@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("k,B", [(40, 5), (5504, 768), (4480, 128), (6144, 3)])
def test_turbo_iter_equals_plain(dev, k, B, parity):
    """The epilogue kernel against turbo_iter_ref, every output, the control
    words and the row list bit for bit, with the flag set (one launch, h
    advanced) and clear (nothing changes), on every row and on a third of
    them."""
    from srslte_emane_tpu_torch.ops.fec import turbo_iter_cuda as ti

    smoke = _chip_smoke()
    for flag in (1, 0):
        for listed in (None, list(range(0, B, 3))):
            a = smoke.iter_inputs(k, B, parity, dev, k + B + parity)
            b = {n: v.clone() for n, v in a.items()}
            untouched = {n: v.clone() for n, v in a.items()}
            (ca, ra), (cb, rb) = (smoke.iter_control(B, dev, 6 + parity, flag, listed)
                                  for _ in range(2))
            before = ti.launches
            smoke.epilogue(ti.turbo_iter_cuda, a, ca, ra, parity)
            torch.cuda.synchronize()
            assert ti.launches == before + 1
            smoke.epilogue(ti.turbo_iter_ref, b, cb, rb, parity)
            for n in a:
                assert torch.equal(a[n], b[n]), (n, flag)
                if not flag:
                    assert torch.equal(a[n], untouched[n]), n
            assert torch.equal(ca, cb), (ca.tolist(), cb.tolist())
            assert torch.equal(ra, rb)
            assert ca[ti.H].item() == 6 + parity + flag


def test_predicated_map_kernels_equal_unpredicated(dev):
    """A set flag gives the unpredicated launch's LLRs bit for bit, a clear
    one writes nothing; a row list computes the listed rows bit for bit as
    the whole batch does and writes no other; both kernels, both storage
    modes."""
    run = torch.ones(1, dtype=torch.int32, device=dev)
    stop = torch.zeros(1, dtype=torch.int32, device=dev)
    for k, B, narrow in ((5504, 64, True), (4480, 32, False)):
        ls, lp, tx, tz = _random_inputs(k, B, dev)
        bk = turbodecoder.beta_tail(tx, tz).contiguous()
        w = turbodecoder._pick_windows(k)
        listed = torch.tensor([B - 1, 0, B // 2, 5], dtype=torch.int32)
        rows = torch.cat([torch.tensor([4], dtype=torch.int32), listed,
                          torch.zeros(B - 4, dtype=torch.int32)]).to(dev)
        others = torch.ones(B, dtype=torch.bool)
        others[listed.long()] = False
        for kernel, extra in ((turbodecoder_cuda.launch, (narrow,)), (turbodecoder_cuda.launch_v1, ())):
            ref = kernel(ls, lp, bk, w, *extra)
            assert torch.equal(kernel(ls, lp, bk, w, *extra, run=run), ref)
            out = torch.full_like(ls, 7.0)
            kernel(ls, lp, bk, w, *extra, run=stop, out=out)
            part = torch.full_like(ls, 7.0)
            kernel(ls, lp, bk, w, *extra, run=run, rows=rows, out=part)
            torch.cuda.synchronize()
            assert bool((out == 7.0).all())
            assert torch.equal(part[listed.long()], ref[listed.long()])
            assert bool((part[others.to(dev)] == 7.0).all())


def _decode_cases(dev):
    """(llr_bits, args) of turbo_decode: 768 x K=5504 bf16 at high SNR, the
    same with every fourth row at low SNR (the cascade), 128 x K=4480 f32,
    and 16 x K=40 (no cascade)."""
    from srslte_emane_tpu_torch.ops.fec import crc

    smoke = _chip_smoke()
    out = []
    for k, B, low, bits in ((5504, 768, False, 16), (5504, 768, True, 16), (4480, 128, False, 32),
                            (40, 6, True, 32)):
        scale = torch.where((torch.arange(B, device=dev) % 4 == 0) & low, 0.45, 1.2)[:, None]
        _, d0, d1, d2 = smoke.code_block_llrs(k, B, dev, k + B, scale)
        valid = torch.ones(B, dtype=torch.bool, device=dev)
        out.append((bits, (d0, d1, d2, valid, k, 8, crc.LTE_CRC24B)))
    return out


def test_device_loop_equals_the_host_loop(dev):
    """turbo_decode (the loop on the card, one read) against
    turbo_decode_host (a read before every pass): bits, CRC flags, n_iter
    and the MAP rows, with the cascade on and off."""
    import os

    for bits, args in _decode_cases(dev):
        for cascade in ("1", "0"):
            os.environ["SRSLTE_TPU_CASCADE"] = cascade
            try:
                turbodecoder.map_rows = 0
                new = turbodecoder.turbo_decode(*args, llr_bits=bits)
                rows = turbodecoder.map_rows
                old = turbodecoder.turbo_decode_host(*args, llr_bits=bits)
            finally:
                os.environ.pop("SRSLTE_TPU_CASCADE")
            assert torch.equal(new[0], old[0]) and torch.equal(new[1], old[1])
            assert new[2] == old[2] and turbodecoder.map_rows == 2 * rows


def test_device_loop_makes_no_host_sync(dev):
    """turbo_decode_device runs under torch.cuda.set_sync_debug_mode("error")
    (after a warm-up that copies the tables to the card); turbo_decode adds
    exactly one synchronising read."""
    import warnings

    for bits, args in _decode_cases(dev):
        turbodecoder.turbo_decode_device(*args, llr_bits=bits)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = turbodecoder.turbo_decode_device(*args, llr_bits=bits)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ref = turbodecoder.turbo_decode_host(*args, llr_bits=bits)
        assert torch.equal(out[0], ref[0]) and int(out[2]) == ref[2]
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                turbodecoder.turbo_decode(*args, llr_bits=bits)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        assert len([w for w in seen if "synchroniz" in str(w.message)]) == 1


def test_device_loop_replays_as_a_cuda_graph(dev):
    """turbo_decode_device captured once under torch.cuda.graph and
    replayed twice: bit-equal to the host loop each time (the launch
    sequence no longer depends on the data)."""
    bits, args = _decode_cases(dev)[1]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        turbodecoder.turbo_decode_device(*args, llr_bits=bits)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = turbodecoder.turbo_decode_device(*args, llr_bits=bits)
    ref = turbodecoder.turbo_decode_host(*args, llr_bits=bits)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
        assert int(out[2]) == ref[2] == 8



def test_turbo_decode_rows_do_not_depend_on_the_batch(dev):
    """The device loop decodes a row to the same bits alone in its batch or
    beside other rows: 16 noise-only code blocks of K=280 (every CRC fails,
    so the hard decisions rest on the last bits of every metric) decoded as
    a batch of 16 and as the first half of 32; beta_K (turbodecoder.beta_tail)
    equal on the card and on the CPU at each batch size."""
    from srslte_emane_tpu_torch.ops.fec import crc

    rng = np.random.default_rng(9)
    k, B = 280, 16
    d = [torch.from_numpy(rng.normal(0, 1.5, (2 * B, k + 4)).astype(np.float32)).to(dev)
         for _ in range(3)]
    valid = torch.ones(2 * B, dtype=torch.bool, device=dev)
    for n in (B, 2 * B, 1, 5):
        tx, tz = d[0][:n, :3], d[1][:n, :3]
        assert torch.equal(turbodecoder.beta_tail(tx, tz).cpu(),
                           turbodecoder.beta_tail(tx.cpu(), tz.cpu())), n
    outs = [turbodecoder.turbo_decode_device(*(x[:n] for x in d), valid[:n], k, 8,
                                             crc.LTE_CRC24B) for n in (B, 2 * B)]
    assert not bool(outs[1][1].any())
    assert torch.equal(outs[0][0], outs[1][0][:B]) and int(outs[0][2]) == int(outs[1][2]) == 8


# ---------------- the dynamic block's round as a replayed CUDA graph (chip_smoke.py phase 19) ----------------

def _dyn_case(dev, R=2, harq=False, n_cells=1, seed=0):
    """tests/test_torch_waveblock.py's 15 PRB dynamic-block cases on the
    card (clean, or harq: UE 0 at 8 dB with MCS 16, UE 1 at -6 dB): (cfg,
    the queues and schedules as tensors on the card, with a leading cells
    axis for n_cells > 1)."""
    from srslte_emane_tpu_torch.phch import grid
    from srslte_emane_tpu_torch.runtime import waveblock_dyn

    kw = dict(dl_mcs=16, snr_db=(8.0, -6.0)) if harq else dict(dl_mcs=8, snr_db=(30.0, 28.0))
    cfg = waveblock_dyn.DynBlockConfig(
        cell=grid.CellConfig(n_prb=15, cell_id=1, cfi=2), rntis=(70, 71), dl_l_crbs=3,
        ul_l_prb=2, ul_mcs=8, R=R, **kw)
    cells = []
    for c in range(n_cells):
        rng = np.random.default_rng(seed + c)
        rb_dl, rb_ul = waveblock_dyn.make_schedule(cfg, seed=1 + c)
        cells.append((rng.integers(0, 2, (cfg.T, 2, cfg.dl_tbs), dtype=np.int8),
                      rng.integers(0, 2, (cfg.T, 2, cfg.ul_tbs), dtype=np.int8), rb_dl, rb_ul))
    ins = [np.stack(x) if n_cells > 1 else x[0] for x in zip(*cells)]
    return cfg, [torch.from_numpy(a).to(dev) for a in ins]


def _gens(dev, *seeds):
    out = []
    for s in seeds:
        g = torch.Generator(device=dev)
        g.manual_seed(s)
        out.append(g)
    return out


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].device.type == "cuda" and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("case", [dict(R=2), dict(R=5, harq=True), dict(R=2, n_cells=2),
                                  dict(R=5, harq=True, n_cells=2)],
                         ids=["clean", "harq", "cells2", "harq-cells2"])
def test_dyn_graph_equals_the_eager_block(dev, case):
    """make_dyn_block_step on the card (jit=True: one round captured, R
    replays) against jit=False on equal generators: every output, counter
    and consumed pointer bit for bit, the generators left in equal states,
    and the kernels' launch counts (replays included) equal the eager
    block's; then the same graph on other queues and a new generator."""
    from srslte_emane_tpu_torch.ops.fec import turbo_iter_cuda, viterbi_cuda
    from srslte_emane_tpu_torch.runtime import waveblock_dyn

    C = case.get("n_cells", 1)
    cfg, ins = _dyn_case(dev, **case)
    graph = waveblock_dyn.make_dyn_block_step(cfg, n_cells=C)
    eager = waveblock_dyn.make_dyn_block_step(cfg, n_cells=C, jit=False)
    arg = lambda gens: gens if C > 1 else gens[0]
    graph(*ins, arg(_gens(dev, *range(C))), 8)  # the capture
    counters = lambda: (turbodecoder_cuda.launches, turbo_iter_cuda.launches,
                        turbo_iter_cuda.arm_launches, viterbi_cuda.launches)
    runs = {}
    for name, step in (("graph", graph), ("eager", eager)):
        gens = _gens(dev, *(11 + c for c in range(C)))
        before = counters()
        out = step(*ins, arg(gens), 16)
        torch.cuda.synchronize()
        runs[name] = out, [g.get_state() for g in gens], [a - b for a, b in zip(counters(), before)]
    _equal(runs["graph"][0], runs["eager"][0])
    assert all(torch.equal(a, b) for a, b in zip(runs["graph"][1], runs["eager"][1]))
    assert runs["graph"][2] == runs["eager"][2] and min(runs["graph"][2]) > 0, runs["graph"][2]
    out = runs["graph"][0]
    if case.get("harq"):  # retransmissions, drops and DCI misses happened
        assert out["dl_retx_tx"].sum() > 0 and out["dl_drop"].sum() > 0
        assert out["dci_dl_miss"].sum() > 0
    else:
        assert bool(out["dl_ok"].all()) and bool(out["ul_ok"].all())
    _, other = _dyn_case(dev, seed=7, **case)
    _equal(graph(*other, arg(_gens(dev, *(30 + c for c in range(C)))), 0),
           eager(*other, arg(_gens(dev, *(30 + c for c in range(C)))), 0))


@pytest.mark.parametrize("harq", [False, True], ids=["clean", "harq"])
def test_dyn_graph_cells_equal_one_cell_graphs(dev, harq):
    """The 2-cell graph block is two 1-cell graph blocks side by side:
    each cell, with its own queues, schedule and generator, equals the
    1-cell block on them bit for bit (on the card, as
    tests/test_torch_waveblock_cells.py's test_cells_block_equals_one_cell_blocks
    holds it on the CPU).  The harq case at R=5: each cell retransmits,
    drops (a drop needs a fourth failed transmission, so at least 4
    rounds) and misses DCIs."""
    from srslte_emane_tpu_torch.runtime import waveblock_dyn

    cfg, ins = _dyn_case(dev, R=5 if harq else 2, harq=harq, n_cells=2)
    both = waveblock_dyn.make_dyn_block_step(cfg, n_cells=2)(*ins, _gens(dev, 11, 12), 8)
    one = waveblock_dyn.make_dyn_block_step(cfg)
    for c in range(2):
        _equal({k: v[c] for k, v in both.items()},
               one(*(a[c] for a in ins), _gens(dev, 11 + c)[0], 8))
    if harq:
        for k in ("dl_retx_tx", "dl_drop", "dci_dl_miss"):
            assert bool((both[k] > 0).all()), (k, both[k])


def test_dyn_graph_two_blocks_on_one_generator(dev):
    """Two successive graph blocks on one generator equal two eager
    blocks on one generator (the state the first leaves is the second's)."""
    from srslte_emane_tpu_torch.runtime import waveblock_dyn

    cfg, ins = _dyn_case(dev, R=3, harq=True)
    outs = {}
    for jit in (True, False):
        step = waveblock_dyn.make_dyn_block_step(cfg, jit=jit)
        gen = _gens(dev, 5)[0]
        outs[jit] = [step(*ins, gen, 8 * r) for r in (0, 3)], gen.get_state()
    for a, b in zip(outs[True][0], outs[False][0]):
        _equal(a, b)
    assert torch.equal(outs[True][1], outs[False][1])


def test_dyn_graph_makes_no_host_sync(dev):
    """After the capture, a whole call (inputs on the card) runs under
    torch.cuda.set_sync_debug_mode("error"): the copies in, R replays and
    the copies out enqueue only."""
    from srslte_emane_tpu_torch.runtime import waveblock_dyn

    cfg, ins = _dyn_case(dev, R=4, harq=True)
    step = waveblock_dyn.make_dyn_block_step(cfg)
    step(*ins, _gens(dev, 1)[0], 0)
    torch.cuda.synchronize()
    gen = _gens(dev, 2)[0]
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step(*ins, gen, 0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ref = waveblock_dyn.make_dyn_block_step(cfg, jit=False)(*ins, _gens(dev, 2)[0], 0)
    _equal(out, ref)


def test_dyn_block_runner_graph_equals_jit_false(dev, tmp_path):
    """DynBlockRunner (R=2) on an attached 15 PRB, 2-UE network on the card
    over two blocks, its generator carried across them: each block's
    outputs equal the jit=False block's on the same queues, schedule and
    TTI, drawing from one generator started where the runner's was."""
    from srslte_emane_tpu_torch.runtime import waveblock_dyn

    net, ues, _, _ = _port_network(tmp_path, "cuda")
    while net.tti < 400 and not all(u.emm_state == "REGISTERED" for u in ues):
        net.run(10)
    assert all(u.emm_state == "REGISTERED" for u in ues)
    runner = waveblock_dyn.DynBlockRunner(net, R=2)
    calls, step = [], runner.step

    def recorded(*a):
        out = step(*a)
        calls.append((a, {k: v.clone() for k, v in out.items()}))
        return out

    runner.step = recorded
    gen = torch.Generator(device=net.device)
    gen.set_state(runner._gen.get_state())
    for _ in range(2):
        runner.run_block()
    eager = waveblock_dyn.make_dyn_block_step(runner.cfg, device=net.device, jit=False)
    for (dl, ul, rb_dl, rb_ul, _, tti0), out in calls:
        _equal(out, eager(dl, ul, rb_dl, rb_ul, gen, tti0))
    assert torch.equal(gen.get_state(), runner._gen.get_state())
    assert runner.metrics["blocks"] == 2 and runner.metrics["dl_ok"] > 0


# ---------------- the port's jax.jit: steps captured once, replayed per call (chip_smoke.py phases 4, 11, 15) ----------------

def _link_cfg(snr_db, llr_bits=16):
    """The bench cell (srslte_emane_tpu_torch/bench.py) at `snr_db`."""
    import dataclasses

    from srslte_emane_tpu_torch import bench

    return dataclasses.replace(bench.bench_config(llr_bits), snr_db=snr_db)


def _step_counts():
    """The kernels' launch counts and the MAP rows counted on the card."""
    from srslte_emane_tpu_torch.ops.fec import turbo_iter_cuda, viterbi_cuda

    return (turbodecoder_cuda.launches, turbo_iter_cuda.launches, turbo_iter_cuda.arm_launches,
            viterbi_cuda.launches, turbodecoder.read_map_rows())


def _link_call(step, args, gen):
    return step(*args, gen)


def _block_call(step, args, gen):  # args (dl, ul, tti0)
    return step(args[0], args[1], gen, args[2])


def _graph_against_eager(dev, graph, eager, inputs, call=_link_call,
                         graphs_of=lambda step: step.graphs):
    """Each input tuple through the graphed and the eager step (`call`) on
    generators seeded alike: every output bit for bit, the generators left
    in equal states, the launch counts and MAP rows of each call equal (the
    first call, which captures, first: its warm-up's launches count on top);
    the graphed step's graphs (`graphs_of`) one.  Returns the graphed
    step's outputs."""
    call(graph, inputs[0], _gens(dev, 0)[0])  # the capture
    outs = []
    for i, args in enumerate(inputs):
        runs = {}
        for name, step in (("graph", graph), ("eager", eager)):
            gens = _gens(dev, 100 + i)
            before = _step_counts()
            out = call(step, args, gens[0])
            torch.cuda.synchronize()
            counts = [a - b for a, b in zip(_step_counts(), before)]
            runs[name] = out, [g.get_state() for g in gens], counts
        (a, sa, ca), (b, sb, cb) = runs["graph"], runs["eager"]
        _equal(a if isinstance(a, dict) else dict(enumerate(a)),
               b if isinstance(b, dict) else dict(enumerate(b)))
        assert all(torch.equal(x, y) for x, y in zip(sa, sb))
        assert ca == cb and ca[0] > 0, (ca, cb)
        outs.append(a)
    assert len(graphs_of(graph)) == 1  # one capture for one signature
    return outs


def test_traced_link_graphs_equal_untraced_and_span_each_stage(dev):
    """The bench cell's encode and decode (batch 16, 20 dB of noise added
    eagerly) as `graphs.jit` steps: the graphs captured with tracing on
    replay bit for bit as those captured with it off, and every replay
    yields its stages on the device's clock: `link.tx_subframe` with
    tx.fec, tx.map, tx.ofdm and `link.rx_subframe` with rx.ofdm, rx.chest,
    rx.llr, rx.turbo, rx.tb, once each, in order, under their parent, and
    the replays' load and clone; the captures' spans are not kept."""
    from srslte_emane_tpu_torch.models import pdsch_link
    from srslte_emane_tpu_torch.runtime import graphs
    from srslte_emane_tpu_torch.utils import trace

    cfg = _link_cfg(20.0)
    rng = np.random.default_rng(4)
    payload = torch.from_numpy(rng.integers(0, 2, (16, cfg.tbs), dtype=np.int8)).to(dev)
    encode = graphs.jit(lambda p: pdsch_link.tx_subframe(p, cfg))

    def rx(samples):
        out, ok, softbuf, ch = pdsch_link.rx_subframe(samples, cfg)
        return out, ok, softbuf, ch.ce

    decode = graphs.jit(rx)

    def call():
        tx = encode(payload)
        noisy = tx + 0.01 * torch.randn(tx.shape, device=dev, generator=_gens(dev, 5)[0])
        return [tx, *decode(noisy)]

    off = call()
    trace.reset()
    try:
        trace.enable(True)
        runs = []
        for r in range(3):
            with trace.request(r):
                runs.append(call())
                torch.cuda.synchronize()
        with trace.request(9):  # eagerly: plain events, timed from the stage's own start
            eager = pdsch_link.tx_subframe(payload, cfg)
    finally:
        trace.enable(False)
    spans = trace.spans()
    trace.reset()
    assert torch.equal(eager, off[0])
    top, *kids = [s for s in spans if s.request == 9]
    assert (top.name, top.clock, top.start_ns) == ("link.tx_subframe", "device", 0)
    assert [s.name for s in kids] == ["tx.fec", "tx.map", "tx.ofdm"]
    assert all(s.parent == top.id and 0 <= s.start_ns <= s.end_ns <= top.end_ns for s in kids)
    assert len(encode.graphs) == len(decode.graphs) == 2
    for on in runs:
        assert all(torch.equal(a, b) for a, b in zip(_flat_tensors(off), _flat_tensors(on)))
    stages = {"link.tx_subframe": ["tx.fec", "tx.map", "tx.ofdm"],
              "link.rx_subframe": ["rx.ofdm", "rx.chest", "rx.llr", "rx.turbo", "rx.tb"]}
    for r in range(3):
        dev_spans = [s for s in spans if s.request == r and s.clock == "device"]
        assert [s.name for s in dev_spans if not s.name.startswith("graphs.")] == \
            [n for parent, kids in stages.items() for n in [parent, *kids]]
        assert [s.name for s in dev_spans if s.name.startswith("graphs.")] == \
            ["graphs.load", "graphs.clone"] * 2
        for parent, kids in stages.items():
            (top,) = [s for s in dev_spans if s.name == parent]
            got = [s for s in dev_spans if s.name in kids]
            assert all(s.parent == top.id and s.end_ns >= s.start_ns >= 0 for s in got)
            assert all(a.end_ns <= b.start_ns for a, b in zip(got, got[1:]))
            assert top.start_ns <= got[0].start_ns and got[-1].end_ns <= top.end_ns


def _flat_tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _flat_tensors(v)]


@pytest.mark.parametrize("snr_db", [20.0, 8.0], ids=["bench", "low-snr"])
def test_link_step_graph_equals_the_eager_step(dev, snr_db):
    """make_link_step on the card (a replayed graph) against link_step at
    the bench cell with batch 16: bits, CRC flags and snr_db bit for bit on
    two payloads (the second call reads its new payload), the launches and
    MAP rows equal; at 20 dB each payload decodes, at 8 dB every row fails
    (every iteration runs)."""
    from srslte_emane_tpu_torch.models import pdsch_link

    cfg = _link_cfg(snr_db)
    rng = np.random.default_rng(3)
    payloads = [torch.from_numpy(rng.integers(0, 2, (16, cfg.tbs), dtype=np.int8)).to(dev)
                for _ in range(2)]
    outs = _graph_against_eager(dev, pdsch_link.make_link_step(cfg),
                                functools.partial(pdsch_link.link_step, cfg=cfg),
                                [(p,) for p in payloads])
    for (out, ok, snr), p in zip(outs, payloads):
        if snr_db == 20.0:
            assert bool(ok.all()) and torch.equal(out, p)
        else:
            assert not bool(ok.any())
        assert snr.shape == (16,) and bool(snr.isfinite().all())


def test_ca_step_graph_equals_the_eager_step(dev):
    """make_ca_link_step (2 carriers of the bench cell, f32 LLRs, batch 8 as
    scripts/bench_extra.py's CA cell) graphed against link_step carrier by
    carrier (cell_id + 3 i, noise in carrier order), on two payloads: every
    output and the generators bit for bit."""
    import dataclasses

    from srslte_emane_tpu_torch.models import pdsch_link

    cfg = _link_cfg(20.0, llr_bits=32)
    rng = np.random.default_rng(4)
    payloads = [torch.from_numpy(rng.integers(0, 2, (2, 8, cfg.tbs), dtype=np.int8)).to(dev)
                for _ in range(2)]

    def eager(p, gen):
        outs = [pdsch_link.link_step(p[i], gen, dataclasses.replace(cfg, cell=dataclasses.replace(
            cfg.cell, cell_id=cfg.cell.cell_id + 3 * i))) for i in range(2)]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])

    outs = _graph_against_eager(dev, pdsch_link.make_ca_link_step(cfg, 2), eager,
                                [(p,) for p in payloads])
    for (out, ok), p in zip(outs, payloads):
        assert bool(ok.all()) and torch.equal(out, p)


def _block_inputs(cfg, dev, seed):
    rng = np.random.default_rng(seed)
    dl = rng.integers(0, 2, (cfg.T, cfg.n_ues) + ((2,) if cfg.tm3 else ()) + (cfg.dl_tbs,),
                      dtype=np.int8)
    ul = rng.integers(0, 2, (cfg.T, cfg.n_ues, cfg.ul_tbs), dtype=np.int8)
    return torch.from_numpy(dl).to(dev), torch.from_numpy(ul).to(dev)


@pytest.mark.parametrize("tm3", [False, True], ids=["siso", "tm3"])
def test_sps_block_graph_equals_the_eager_block(dev, tm3):
    """make_block_step and make_bench_step on the card (replayed graphs)
    against the eager block (jit=False, and its counts) at chip_smoke.py's
    SPS cell (100 PRB, 8 UEs) with T=8, at tti0 0 and 37 on other payloads
    (the TTI and the payloads are inputs of the graph): every output bit
    for bit (bits, CRC flags, ack_energy, ack_val), the generators,
    launches and MAP rows equal."""
    from srslte_emane_tpu_torch.runtime import waveblock

    cfg = _chip_smoke().sps_config(8, tm3)
    inputs = [(*_block_inputs(cfg, dev, seed), tti0) for seed, tti0 in ((0, 0), (1, 37))]
    outs = _graph_against_eager(dev, waveblock.make_block_step(cfg, sfn0=4),
                                waveblock.make_block_step(cfg, sfn0=4, jit=False), inputs,
                                _block_call)
    for out, (dl, ul, _) in zip(outs, inputs):
        assert bool(out["dl_ok"].all()) and bool(out["ul_ok"].all())
        assert torch.equal(out["dl_out"], dl.reshape(out["dl_out"].shape))
        assert torch.equal(out["ul_out"], ul)
    assert not torch.equal(outs[0]["ack_val"], outs[1]["ack_val"])
    eager = waveblock.make_block_step(cfg, sfn0=4, jit=False)

    def eager_counts(dl, ul, gen, tti0):  # make_bench_step's counts of the eager block
        out = eager(dl, ul, gen, tti0)
        dl_ok = out["dl_ok_cw"] if tm3 else out["dl_ok"]
        return dl_ok.sum(), out["ul_ok"].sum(), (out["ack_energy"] > 1e-2).sum()

    for counts in _graph_against_eager(dev, waveblock.make_bench_step(cfg, sfn0=4), eager_counts,
                                       inputs, _block_call):
        n = cfg.T * cfg.n_ues
        assert [int(c) for c in counts] == [n * (2 if tm3 else 1), n, n]


@pytest.mark.parametrize("snr_db", [8.0, 20.0], ids=["8dB", "20dB"])
def test_sweep_decode_graph_equals_eager(dev, snr_db):
    """scripts/snr_sweep's decode (snr_case: the bench cell, batch 16) as a
    replayed graph against the eager decode on two received batches: bits,
    CRC flags, launches and MAP rows bit for bit; the encode's graph gives
    the eager encode's samples; at 8 dB every row fails (the whole budget,
    the cascade), at 20 dB every row decodes."""
    from srslte_emane_tpu_torch.scripts import snr_sweep

    tbs = snr_sweep.bench.bench_config(16).tbs
    rng = np.random.default_rng(9)
    payloads = [torch.from_numpy(rng.integers(0, 2, (16, tbs), dtype=np.int8)).to(dev)
                for _ in range(2)]
    tx_fn, rx_fn, rx = snr_sweep.snr_case(snr_db, payloads[0])
    _, rx_eager, rx_ref = snr_sweep.snr_case(snr_db, payloads[0], eager=True)
    assert torch.equal(rx, rx_ref) and len(tx_fn.graphs) == 1
    other = snr_sweep.snr_case(snr_db, payloads[1], eager=True)[2]
    outs = _graph_against_eager(dev, rx_fn, rx_eager, [(rx,), (other,)],
                                lambda step, a, gen: step(*a))
    assert len(rx_fn.graphs) == 1
    for (out, ok), p in zip(outs, payloads):
        if snr_db == 20.0:
            assert bool(ok.all()) and torch.equal(out, p)
        else:
            assert not bool(ok.any())


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flat(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flat(v)]
    return []


def _profiler_runs(name, dev, eager):
    """Each stage of a profiling script (at a batch a test can afford) called
    twice on the outputs of the earlier stages' first calls: {label: (the
    second call's output, the launch counts of that call)}, and the steps."""
    from srslte_emane_tpu_torch.ops.fec import turbo_iter_cuda
    from srslte_emane_tpu_torch.scripts import profile_mimo, profile_stages, profile_turbo

    outs, res = {}, {}
    if name == "profile_stages":
        ctx = profile_stages.setup(4, dev)
        stages, steps = profile_stages.stages(ctx, outs, eager), ctx["steps"]
    elif name == "profile_mimo":
        ctx = profile_mimo.setup(4, dev, eager=eager)
        stages, steps = profile_mimo.stages(ctx, outs, eager), ctx["steps"]
    else:
        inp = profile_turbo.inputs(64, 5568, dev)
        stages, steps = profile_turbo.stages(inp, eager).items(), inp["steps"]
    counts = lambda: (turbodecoder_cuda.launches, turbodecoder_cuda.launches_v1,
                      turbo_iter_cuda.launches, turbo_iter_cuda.arm_launches)
    for label, fn in stages:
        outs[label] = fn()
        torch.cuda.synchronize()
        before = counts()
        out = fn()
        torch.cuda.synchronize()
        res[label] = out, [a - b for a, b in zip(counts(), before)]
    return res, steps


@pytest.mark.parametrize("name", ["profile_stages", "profile_mimo", "profile_turbo"])
def test_profiler_stage_graphs_equal_eager(dev, name):
    """Each profiler's stage jits on the card (one graph each: 12, 8 with
    the set-up jits, and 6) against the same stages run eagerly (--eager):
    each replay's outputs bit for bit, its launches of turbo_map, turbo_map_v1,
    the epilogue and the arm equal to the eager call's."""
    graphed, steps = _profiler_runs(name, dev, False)
    eager, eager_steps = _profiler_runs(name, dev, True)
    assert list(graphed) == list(eager)
    assert [len(s.graphs) for s in steps] == [1] * len(steps)
    assert len(steps) == {"profile_stages": 12, "profile_mimo": 8, "profile_turbo": 6}[name]
    assert not any(hasattr(s, "graphs") for s in eager_steps)
    for label, (out, launches) in graphed.items():
        ref, ref_launches = eager[label]
        a, b = _flat(out), _flat(ref)
        assert len(a) == len(b) > 0, label
        assert all(x.device.type == "cuda" and torch.equal(x, y) for x, y in zip(a, b)), label
        assert launches == ref_launches, (label, launches, ref_launches)
    if name == "profile_turbo":
        from srslte_emane_tpu_torch.scripts import profile_turbo

        assert graphed[profile_turbo.MAP_V1][1][:2] == [0, 1]
        assert graphed[profile_turbo.MAP][1][:2] == [1, 0]
        assert graphed[profile_turbo.EARLY][1][0] == 16


def test_sharded_link_graph_equals_the_eager_sharded_step(dev):
    """make_link_step_sharded on a 1-card mesh (one graph for its position)
    against jit=False, on generators seeded alike, on two payloads: bits,
    CRC flags, snr_db, the generators, launches and MAP rows bit for bit."""
    from srslte_emane_tpu_torch.models import pdsch_link
    from srslte_emane_tpu_torch.parallel import mesh as mesh_mod

    cfg = _link_cfg(20.0)
    mesh = mesh_mod.make_mesh(1)
    rng = np.random.default_rng(10)
    payloads = [torch.from_numpy(rng.integers(0, 2, (16, cfg.tbs), dtype=np.int8)).to(dev)
                for _ in range(2)]
    step = pdsch_link.make_link_step_sharded(cfg, mesh)
    outs = _graph_against_eager(dev, step, pdsch_link.make_link_step_sharded(cfg, mesh, jit=False),
                                [(p,) for p in payloads],
                                graphs_of=lambda s: s.positions[0].graphs)
    assert len(step.positions) == 1 and mesh.transfers == 0
    for (out, ok, _), p in zip(outs, payloads):
        assert bool(ok.all()) and torch.equal(out, p)


def test_sharded_block_graph_equals_the_eager_sharded_step(dev):
    """make_block_step_sharded, 1 cell on a 1-card mesh (chip_smoke.py's SPS
    cell, T=8), graphed against jit=False at tti0 0 and 37 on other
    payloads: every output bit for bit, the generators, launches and MAP
    rows equal."""
    from srslte_emane_tpu_torch.parallel import mesh as mesh_mod
    from srslte_emane_tpu_torch.runtime import waveblock

    cfg = _chip_smoke().sps_config(8)
    mesh = mesh_mod.make_mesh(1)
    inputs = [(*(x[None] for x in _block_inputs(cfg, dev, seed)), tti0)
              for seed, tti0 in ((0, 0), (1, 37))]
    step, _ = waveblock.make_block_step_sharded(cfg, mesh, (cfg.cell.cell_id,), sfn0=4)
    eager, _ = waveblock.make_block_step_sharded(cfg, mesh, (cfg.cell.cell_id,), sfn0=4,
                                                 jit=False)
    outs = _graph_against_eager(dev, step, eager, inputs,
                                lambda s, a, gen: s(a[0], a[1], [gen], a[2]),
                                graphs_of=lambda s: s.positions[0].graphs)
    assert len(step.positions) == 1 and mesh.transfers == 0
    for out, (dl, ul, _) in zip(outs, inputs):
        assert bool(out["dl_ok"].all()) and bool(out["ul_ok"].all())
        assert torch.equal(out["dl_out"], dl) and torch.equal(out["ul_out"], ul)


def test_graphed_steps_make_no_host_sync(dev):
    """After the capture, a whole call of the link step and of the SPS
    block (inputs on the card, tti0 a Python int) runs under
    torch.cuda.set_sync_debug_mode("error"): the copies and fills in, the
    generator states, one replay and the clones out enqueue only; and the
    MAP rows of the calls are read once after them."""
    from srslte_emane_tpu_torch.models import pdsch_link
    from srslte_emane_tpu_torch.runtime import waveblock

    cfg = _link_cfg(20.0)
    payload = torch.from_numpy(np.random.default_rng(5).integers(
        0, 2, (16, cfg.tbs), dtype=np.int8)).to(dev)
    link = pdsch_link.make_link_step(cfg)
    bcfg = _chip_smoke().sps_config(8)
    block = waveblock.make_block_step(bcfg, sfn0=4)
    dl, ul = _block_inputs(bcfg, dev, 2)
    link(payload, _gens(dev, 1)[0])
    block(dl, ul, _gens(dev, 1)[0], 0)
    torch.cuda.synchronize()
    turbodecoder.reset_map_rows()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = link(payload, _gens(dev, 2)[0])
        blk = block(dl, ul, _gens(dev, 2)[0], 17)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rows = turbodecoder.read_map_rows()
    turbodecoder.reset_map_rows()
    _equal(dict(enumerate(out)), dict(enumerate(
        pdsch_link.link_step(payload, _gens(dev, 2)[0], cfg))))
    _equal(blk, waveblock.make_block_step(bcfg, sfn0=4, jit=False)(dl, ul, _gens(dev, 2)[0], 17))
    assert rows == turbodecoder.read_map_rows() > 0  # the eager calls counted as many


# a `python -c` body: the graphed link step (the bench cell, batch 16) and
# SPS block (chip_smoke.py's, T=8), each captured, then one call profiled by
# chip_smoke.profile_counted (the launch counts against the kernels' runs on
# the card); prints {step: [host launches, device kernels]}
PROFILE_GRAPHS = """
import json, sys
sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke as cs
from srslte_emane_tpu_torch import bench
from srslte_emane_tpu_torch.models import pdsch_link
from srslte_emane_tpu_torch.runtime import waveblock
dev = torch.device("cuda", 0)
g = lambda s: torch.Generator(device=dev).manual_seed(s)
cfg = bench.bench_config(16)
payload = torch.from_numpy(np.random.default_rng(0).integers(0, 2, (16, cfg.tbs), dtype=np.int8)).to(dev)
link = pdsch_link.make_link_step(cfg)
bcfg = cs.sps_config(8)
rng = np.random.default_rng(1)
dl = torch.from_numpy(rng.integers(0, 2, (8, 8, bcfg.dl_tbs), dtype=np.int8)).to(dev)
ul = torch.from_numpy(rng.integers(0, 2, (8, 8, bcfg.ul_tbs), dtype=np.int8)).to(dev)
block = waveblock.make_block_step(bcfg, sfn0=4)
out = {}
for name, fn in (("link", lambda: link(payload, g(1))), ("block", lambda: block(dl, ul, g(1), 0))):
    fn()
    prof = cs.profile_counted(fn, name, control=False)
    out[name] = [prof["host_launches"], prof["kernel_launches"], prof["port_kernels"]]
print(json.dumps(out))
"""


def test_graphed_launch_counts_equal_the_profilers_runs(dev):
    """In a fresh process (the profiler records no device events late in
    this one): one replayed call of the link step and of the SPS block
    under torch.profiler: each port kernel ran on the card as many times as
    its launch count says (chip_smoke.profile_counted), with a handful of
    host launches (the copies in, the generator state, one graph launch,
    the clones out) against the graph's hundreds of kernels."""
    import json
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-c", PROFILE_GRAPHS],
                         cwd=pathlib.Path(__file__).resolve().parents[1], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.splitlines()[-1])
    for name, (host, kernels, ran) in res.items():
        assert host <= 16 and kernels > 100 and ran["turbo_map"] > 0, (name, host, kernels, ran)
