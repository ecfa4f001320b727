"""PyTorch port vs the JAX package: the PDSCH link slice as a whole, the
jax-free import contract, and the state carried across (convert.py).

The two packages draw different noise (jax.random vs torch.Generator), so
both receivers get the same samples: the JAX TX waveform plus numpy noise.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from srslte_emane_tpu.models import pdsch_link as j_link
from srslte_emane_tpu.phch import grid as j_grid
from srslte_emane_tpu.phch import sch as j_sch
from srslte_emane_tpu_torch import convert
from srslte_emane_tpu_torch.models import pdsch_link as p_link
from srslte_emane_tpu_torch.phch import grid as p_grid
from srslte_emane_tpu_torch.phch import sch as p_sch

# Under pytest-xdist several workers share the cores: one intra-op thread
# each, or torch's spinning thread pools slow every worker many-fold.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICES = [  # (cell, qm, code_rate, snr_db)
    (dict(n_prb=6, cell_id=1, cfi=2), 2, 0.5, 10.0),
    (dict(n_prb=50, cell_id=17, cfi=1), 6, 0.5, 18.0),
]


def _configs(cell_kw, qm, rate, snr, llr_bits):
    kw = dict(qm=qm, code_rate=rate, snr_db=snr, sf_idx=1, llr_bits=llr_bits)
    return (p_link.LinkConfig(cell=p_grid.CellConfig(**cell_kw), **kw),
            j_link.LinkConfig(cell=j_grid.CellConfig(**cell_kw), **kw))


@pytest.mark.parametrize("cell_kw,qm,rate,snr", SLICES)
@pytest.mark.parametrize("llr_bits", [32, 16])
def test_link_slice_matches_jax(cell_kw, qm, rate, snr, llr_bits):
    pcfg, jcfg = _configs(cell_kw, qm, rate, snr, llr_bits)
    assert (pcfg.n_re, pcfg.G, pcfg.tbs) == (jcfg.n_re, jcfg.G, jcfg.tbs)
    B = 2
    rng = np.random.default_rng(qm + llr_bits)
    payload = rng.integers(0, 2, (B, jcfg.tbs), dtype=np.int8)
    tx_j = np.asarray(j_link.tx_subframe(payload, jcfg))
    tx_p = p_link.tx_subframe(torch.from_numpy(payload), pcfg).numpy()
    # the JAX DFT rounds its inputs to bf16: relative RMS, not equality
    rel = np.sqrt(np.mean((tx_p - tx_j) ** 2) / np.mean(tx_j ** 2))
    assert rel <= 1e-2
    power = np.mean(np.sum(tx_j ** 2, -1), -1)[:, None, None]
    rx = (tx_j + rng.normal(size=tx_j.shape) * np.sqrt(power / 10 ** (snr / 10) / 2)
          ).astype(np.float32)
    out_j, ok_j, _, _ = j_link.rx_subframe(rx, jcfg)
    out_p, ok_p, _, ch = p_link.rx_subframe(torch.from_numpy(rx), pcfg)
    np.testing.assert_array_equal(out_p.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_j))
    assert ok_p.all() and (out_p.numpy() == payload).all()
    # the kernel path (its plain version on CPU)
    out_k, ok_k, _, _ = p_link.rx_subframe(torch.from_numpy(rx), pcfg, use_kernel=True)
    assert ok_k.all() and (out_k.numpy() == payload).all()


def test_link_step_with_generator():
    pcfg, _ = _configs(dict(n_prb=6, cell_id=1, cfi=2), 2, 0.5, 30.0, 16)
    payload = torch.from_numpy(
        np.random.default_rng(0).integers(0, 2, (2, pcfg.tbs), dtype=np.int8))
    step = p_link.make_link_step(pcfg, use_kernel=True)
    out, ok, snr_est = step(payload, torch.Generator().manual_seed(0))
    assert ok.all() and torch.equal(out, payload)
    assert snr_est.mean() > 15


def test_port_never_imports_jax():
    """The port (and so chip_smoke.py) loads neither jax nor the JAX package."""
    code = ("import sys; assert 'jax' not in sys.modules, 'jax preloaded'; "
            "import srslte_emane_tpu_torch.models.pdsch_link, srslte_emane_tpu_torch.convert, "
            "srslte_emane_tpu_torch.ops.fec.turbodecoder_cuda, srslte_emane_tpu_torch.models.ue_ul, "
            "srslte_emane_tpu_torch.phch.pusch_uci, srslte_emane_tpu_torch.phch.uci, "
            "srslte_emane_tpu_torch.ops.fec.viterbi, srslte_emane_tpu_torch.ops.bits, "
            "srslte_emane_tpu_torch.ops.mimo, srslte_emane_tpu_torch.phch.regs, "
            "srslte_emane_tpu_torch.phch.dci, srslte_emane_tpu_torch.phch.ra, "
            "srslte_emane_tpu_torch.phch.pcfich, srslte_emane_tpu_torch.phch.phich, "
            "srslte_emane_tpu_torch.phch.pdcch, srslte_emane_tpu_torch.phch.pbch, "
            "srslte_emane_tpu_torch.phch.sync, srslte_emane_tpu_torch.models.enb_dl, "
            "srslte_emane_tpu_torch.models.ue_dl, srslte_emane_tpu_torch.runtime.wavesim, "
            "srslte_emane_tpu_torch.phch.pmch, srslte_emane_tpu_torch.phch.pdsch, "
            "srslte_emane_tpu_torch.ops.channel, srslte_emane_tpu_torch.phch.chest, "
            "srslte_emane_tpu_torch.bench, srslte_emane_tpu_torch.scripts.snr_sweep, "
            "srslte_emane_tpu_torch.scripts.bench_extra, "
            "srslte_emane_tpu_torch.scripts.bench_waveform_tpu, "
            "srslte_emane_tpu_torch.scripts.bench_waveblock_dyn, "
            "srslte_emane_tpu_torch.scripts.bench_waveform_paced, "
            "srslte_emane_tpu_torch.scripts.profile_stages, "
            "srslte_emane_tpu_torch.scripts.wavenet_smoke, "
            "srslte_emane_tpu_torch.scripts.profile_turbo, "
            "srslte_emane_tpu_torch.scripts.profile_mimo, "
            "srslte_emane_tpu_torch.scripts.profile_dynblock; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'srslte_emane_tpu')]; assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=False)
    assert res.returncode == 0, res.stderr


def test_port_sources_name_no_jax():
    """No source file of the port, and not chip_smoke.py, imports jax or the
    JAX package, not even in a function body the import test never runs."""
    import pathlib
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|srslte_emane_tpu)(\.|\s|$)", re.M)
    pkg = pathlib.Path(REPO) / "srslte_emane_tpu_torch"
    files = sorted(pkg.rglob("*.py")) + [pathlib.Path(REPO) / "chip_smoke.py"]
    assert len(files) > 40
    bad = [f"{f}: {m.group(0).strip()}" for f in files for m in pat.finditer(f.read_text())]
    assert not bad, bad


def test_link_config_from_fields():
    jcfg = j_link.LinkConfig(cell=j_grid.CellConfig(n_prb=25, cell_id=5, cfi=3), qm=4,
                             prb_mask=tuple(i % 2 for i in range(25)), snr_db=14.0,
                             llr_bits=16)
    pcfg = convert.link_config_from_fields(**dataclasses.asdict(jcfg))
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert (pcfg.n_re, pcfg.G, pcfg.tbs) == (jcfg.n_re, jcfg.G, jcfg.tbs)
    assert dataclasses.asdict(pcfg.sch_cfg) == dataclasses.asdict(jcfg.sch_cfg)
    # the cell may also come as an object with CellConfig's fields
    pcfg2 = convert.link_config_from_fields(
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    assert pcfg2 == pcfg


@pytest.mark.parametrize("llr_bits", [32, 16])
def test_harq_softbuffer_carried_across(llr_bits):
    """A failed first transmission (two code blocks) decoded by both
    packages from empty soft buffers; the JAX package's soft buffers,
    carried into the port, combine with a retransmission exactly as the JAX
    package combines them."""
    tbs, G = 8000, 3 * 8024
    jcfg = j_sch.SchConfig(tbs=tbs, G=G, Qm=2, Nl=1)
    pcfg = p_sch.SchConfig(tbs=tbs, G=G, Qm=2, Nl=1)
    rng = np.random.default_rng(llr_bits)
    payload = rng.integers(0, 2, (2, tbs), dtype=np.int8)
    bip = 1 - 2 * np.asarray(j_sch.encode_tb(payload, jcfg)).astype(np.float32)
    llr1 = (bip * 0.5 + rng.normal(0, 1, bip.shape)).astype(np.float32)
    llr2 = (bip * 0.9 + rng.normal(0, 1, bip.shape)).astype(np.float32)
    out1, ok1, sb1, it1 = j_sch.decode_tb(llr1, jcfg, None, 4, llr_bits=llr_bits)
    assert not np.asarray(ok1).any()
    out1_p, ok1_p, sb1_own, it1_p = p_sch.decode_tb(torch.from_numpy(llr1), pcfg, None, 4,
                                                     llr_bits=llr_bits)
    np.testing.assert_array_equal(out1_p.numpy(), np.asarray(out1))
    np.testing.assert_array_equal(ok1_p.numpy(), np.asarray(ok1))
    assert it1_p == int(it1)
    dtype = torch.bfloat16 if llr_bits <= 16 else torch.float32
    for a, b in zip(sb1_own, sb1):
        assert a.dtype == dtype
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
    sb1_p = convert.softbuffer_from_numpy([np.asarray(a) for a in sb1], dtype=dtype)
    for a, b in zip(sb1_p, sb1):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
    out_j, ok_j, sb_j, it_j = j_sch.decode_tb(llr2, jcfg, sb1, 8, llr_bits=llr_bits)
    out_p, ok_p, sb_p, it_p = p_sch.decode_tb(torch.from_numpy(llr2), pcfg, sb1_p, 8,
                                              llr_bits=llr_bits)
    assert np.asarray(ok_j).all()
    np.testing.assert_array_equal(out_p.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_j))
    assert it_p == int(it_j)
    for a, b in zip(sb_p, sb_j):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
