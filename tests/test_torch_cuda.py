"""The CUDA MAP kernels against their plain PyTorch versions, and the
paths through them (PUSCH, the downlink subframe, the 2x2 TM3 cell, the
waveform planes), on the card.

Marked `cuda`: skips without a CUDA device.  The card's machine has no jax,
so run this file there without the suite's conftest:
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

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
                                   long.data_ptr(), 1, 1, 30000, 40, 0,
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
    launch for each MAP pass (half-iteration) and none of the radix-2
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
    assert passes >= 1 and n_iter == (passes + 1) // 2
    assert (turbodecoder_cuda.launches, turbodecoder_cuda.launches_v1) == (before[0],
                                                                          before[1] + passes)
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
