"""PyTorch port vs the JAX package: the turbo decoder's loop on the device.

* `turbo_iter_ref`, the plain version of csrc/turbo_iter.cu (the epilogue
  of one MAP pass), against the JAX loop body's arithmetic
  (srslte_emane_tpu/ops/fec/turbodecoder.py:373-400, jitted) at K=40 and
  512, on both parities, with rows that are done and rows whose CRC
  passes: the next pass's input, bits_out, pass_out and done exactly, and
  the loop condition (:402-406) in the flag; on a row list, the listed
  rows only;
* a pass whose flag is 0 changes nothing; `arm_ref` sets the flag as the
  condition reads before the first trip, entering the cascade's stages
  (:463-481) as the reference's `lax.cond`s do;
* the XOR-mask CRC (`crc.remainder_masks`, `crc.crc_remainder`) against
  the port's `crc_ok` and the JAX `crc_ok`;
* `turbo_decode_device` and one read against the JAX `turbo_decode`, with
  and without the cascade (the straggler batch of test_torch_turbodecoder.py),
  and against `turbo_decode_host`, the plain version of the control flow;
* the cascade's stages are entered on the card's state (the row list), at
  an odd half-iteration count too.
The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srslte_emane_tpu.ops.fec import crc as j_crc
from srslte_emane_tpu.ops.fec import turbo as j_turbo
from srslte_emane_tpu.ops.fec import turbodecoder as j_td
from srslte_emane_tpu_torch.ops.fec import crc as p_crc
from srslte_emane_tpu_torch.ops.fec import turbo_iter_cuda as ti
from srslte_emane_tpu_torch.ops.fec import turbodecoder as p_td

from test_torch_turbodecoder import _straggler_batch

torch.set_num_threads(1)  # one intra-op thread per pytest-xdist worker

CPU = torch.device("cpu")


def _pass_inputs(k, B, parity, seed):
    """A pass of parity `parity` on B rows: ext in natural order, the
    pass's input ls_in as the reference forms it, a posterior whose signs
    give CRC24B codewords in rows 0-2 (in the pass's order), rows 1 and 3
    done before the pass with other bits and rows 1 and 4 passed."""
    rng = np.random.default_rng(seed)
    perm = j_turbo.qpp_interleaver(k)
    ls = rng.normal(0, 2, (B, k)).astype(np.float32)
    ext = rng.normal(0, 3, (B, k)).astype(np.float32)
    ls_in = ls + ext if parity == 0 else ls[:, perm] + ext[:, perm]
    payload = rng.integers(0, 2, (B, k - 24), dtype=np.int8)
    words = np.array(j_crc.crc_attach(payload, j_crc.LTE_CRC24B))  # natural order
    words[3:] = rng.integers(0, 2, words[3:].shape)  # these fail (odds 2^-24)
    signs = 1.0 - 2.0 * (words if parity == 0 else words[:, perm])
    mag = rng.uniform(0.01, 9, (B, k)).astype(np.float32)
    post = (signs * mag).astype(np.float32)
    done = np.zeros(B, bool)
    done[[1, 3]] = True
    pass_out = np.zeros(B, bool)
    pass_out[[1, 4]] = True
    bits_out = rng.integers(0, 2, (B, k), dtype=np.int8)
    return dict(ls=ls, ls_in=ls_in, post=post, done=done, pass_out=pass_out,
                bits_out=bits_out), perm


def _freeze(bits, done, bits_out, pass_out):
    ok = j_crc.crc_ok(bits, j_crc.LTE_CRC24B)
    return jnp.where(done[:, None], bits_out, bits), pass_out | (ok & ~done), done | ok


@jax.jit
def _jax_even(post, ls_in, done, bits_out, pass_out):
    """The JAX body after half_enc1's MAP: the new extrinsic (the loop's
    carry), the frozen bits and flags."""
    new_ext = (post - ls_in) * j_td.EXT_SCALE
    return new_ext, *_freeze((post < 0).astype(jnp.int8), done, bits_out, pass_out)


@jax.jit
def _jax_odd(post, ls_in, done, bits_out, pass_out, inv_perm):
    """The same after half_enc2's MAP."""
    new_ext = jnp.take((post - ls_in) * j_td.EXT_SCALE, inv_perm, axis=1)
    bits = (jnp.take(post, inv_perm, axis=1) < 0).astype(jnp.int8)
    return new_ext, *_freeze(bits, done, bits_out, pass_out)


@jax.jit
def _jax_next_odd(ls, ext, perm):
    """The next trip's input to half_enc2 from the carried extrinsic."""
    return jnp.take(ls, perm, axis=1) + jnp.take(ext, perm, axis=1)


@jax.jit
def _jax_next_even(ls, ext):
    """The next trip's input to half_enc1."""
    return ls + ext


def _port_state(x, k):
    t = {n: torch.from_numpy(np.array(v)) for n, v in x.items()}
    _, _, perm32, inv32 = p_td._device_perms(k, CPU)
    t["ls2"] = t["ls"][:, perm32.long()]
    return t, perm32, inv32


def _epilogue(t, perm32, inv32, masks, ctl, rows, parity, max_iter=8, n_stages=1):
    ti.turbo_iter_ref(t["post"], t["ls_in"], t["ls"], t["ls2"], perm32, inv32, masks,
                      t["bits_out"], t["done"], t["pass_out"], ctl, rows, parity, max_iter,
                      n_stages)


def _all_rows(B):
    return torch.cat([torch.tensor([B]), torch.arange(B)]).to(torch.int32)


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("k", [40, 512])
def test_epilogue_equals_the_jax_body(k, parity):
    B = 6
    x, perm = _pass_inputs(k, B, parity, 10 * k + parity)
    args = (x["post"], x["ls_in"], x["done"], x["bits_out"], x["pass_out"])
    if parity == 0:
        ext, j_bits, j_pass, j_done = _jax_even(*args)
        j_next = _jax_next_odd(x["ls"], ext, perm)
    else:
        ext, j_bits, j_pass, j_done = _jax_odd(*args, np.argsort(perm))
        j_next = _jax_next_even(x["ls"], ext)
    t, perm32, inv32 = _port_state(x, k)
    masks = p_crc.remainder_masks(*p_crc.LTE_CRC24B, k, CPU)
    ctl, rows = ti.new_state(B, CPU)
    ctl[ti.H], ctl[ti.RUN] = 4 + parity, 1
    rows.copy_(_all_rows(B))
    _epilogue(t, perm32, inv32, masks, ctl, rows, parity)
    np.testing.assert_array_equal(t["ls_in"].numpy(), np.asarray(j_next))
    np.testing.assert_array_equal(t["bits_out"].numpy(), np.asarray(j_bits))
    np.testing.assert_array_equal(t["pass_out"].numpy(), np.asarray(j_pass))
    np.testing.assert_array_equal(t["done"].numpy(), np.asarray(j_done))
    assert t["done"].numpy().tolist() == [True, True, True, True, False, False]
    assert t["pass_out"].numpy().tolist() == [True, True, True, False, True, False]
    # h advanced, rows counted; the loop's condition for the next pass
    # (h = 5 + parity < 16 and 2 undone > 0), stage 0 of one
    assert ctl.tolist() == [5 + parity, 1, 0, B, 2, 0, 0, 0]
    assert torch.equal(rows, _all_rows(B))


@pytest.mark.parametrize("parity", [0, 1])
def test_epilogue_on_a_row_list_touches_the_listed_rows(parity):
    """Rows 4, 1 listed of 6: they change as on the whole batch, the rest
    not at all; map_rows counts 2."""
    k, B = 40, 6
    x, _ = _pass_inputs(k, B, parity, 5 + parity)
    whole, perm32, inv32 = _port_state(x, k)
    part = {n: v.clone() for n, v in whole.items()}
    masks = p_crc.remainder_masks(*p_crc.LTE_CRC24B, k, CPU)
    for t, listed in ((whole, list(range(B))), (part, [4, 1])):
        ctl, rows = ti.new_state(B, CPU)
        ctl[ti.RUN] = 1
        rows[0] = len(listed)
        rows[1:1 + len(listed)] = torch.tensor(listed)
        _epilogue(t, perm32, inv32, masks, ctl, rows, parity)
    assert int(ctl[ti.ROWS]) == 2
    for n in ("ls_in", "bits_out", "done", "pass_out"):
        for r in range(B):
            ref = whole if r in (1, 4) else _port_state(x, k)[0]
            assert torch.equal(part[n][r], ref[n][r]), (n, r)


@pytest.mark.parametrize("parity", [0, 1])
def test_a_pass_whose_flag_is_0_changes_nothing(parity):
    k, B = 40, 6
    x, _ = _pass_inputs(k, B, parity, 3)
    t, perm32, inv32 = _port_state(x, k)
    masks = p_crc.remainder_masks(*p_crc.LTE_CRC24B, k, CPU)
    ctl, rows = ti.new_state(B, CPU)
    ctl[ti.H] = 3
    rows.copy_(_all_rows(B))
    before = {n: v.clone() for n, v in t.items()}
    ctl0, rows0 = ctl.clone(), rows.clone()
    _epilogue(t, perm32, inv32, masks, ctl, rows, parity)
    for n, v in t.items():
        assert torch.equal(v, before[n]), n
    assert torch.equal(ctl, ctl0) and torch.equal(rows, rows0)


@pytest.mark.parametrize("h,undone,n_stages,run,stage", [
    (0, 5, 3, 1, 0), (0, 4, 3, 1, 1), (3, 2, 3, 1, 2), (5, 0, 3, 0, 2), (16, 5, 3, 0, 2),
    (15, 1, 1, 1, 0), (4, 0, 1, 0, 0), (16, 5, 1, 0, 0)])
def test_arm_is_the_loop_condition(h, undone, n_stages, run, stage):
    """(h < 2 * max_iter) & (sum(~done) > the stage's stop), 8 rows: stage 0
    stops at 4 unfinished rows with the cascade (0 without), stage 1 (4
    rows) at 2, stage 2 (2 rows) at 0; a stage whose condition fails gives
    way to the next, as the reference's lax.conds; the list holds every
    row in stage 0, then the stage's first rows of argsort(done)."""
    done = torch.ones(8, dtype=torch.bool)
    done[torch.tensor([6, 1, 3, 7, 0][:undone], dtype=torch.long)] = False
    ctl, rows = ti.new_state(8, CPU)
    ctl[ti.H], ctl[ti.TICKET] = h, 7
    ti.arm_ref(done, ctl, rows, 8, n_stages)
    assert ctl.tolist() == [h, run, 0, 0, undone, stage, 0, 0]
    width = 8 >> stage  # stage 0 lists every row in order
    order = torch.argsort(done.to(torch.uint8), stable=True) if stage else torch.arange(8)
    assert int(rows[0]) == width and torch.equal(rows[1:1 + width].long(), order[:width])


@pytest.mark.parametrize("crc", ["LTE_CRC24A", "LTE_CRC24B"])
@pytest.mark.parametrize("length", [40, 63, 512, 6144])
def test_xor_mask_crc_equals_crc_ok(crc, length):
    rng = np.random.default_rng(length)
    payload = rng.integers(0, 2, (6, length - 24), dtype=np.int8)
    words = np.array(j_crc.crc_attach(payload, getattr(j_crc, crc)))
    words[3, 7] ^= 1  # one bit error
    words[4, [1, length // 2, length - 1]] ^= 1  # three
    words[5, :] = 0  # the all-zero word passes
    poly = getattr(p_crc, crc)
    masks = p_crc.remainder_masks(*poly, length, CPU)
    assert masks.dtype == torch.int32 and tuple(masks.shape) == (length,)
    ok = (p_crc.crc_remainder(torch.from_numpy(words), masks) == 0).numpy()
    np.testing.assert_array_equal(ok, p_crc.crc_ok(torch.from_numpy(words), poly).numpy())
    np.testing.assert_array_equal(ok, np.asarray(j_crc.crc_ok(words, getattr(j_crc, crc))))
    assert ok[:3].all() and ok[5] and not ok[3:5].any()


def test_remainder_masks_pack_the_remainder_matrix():
    r = j_crc._remainder_matrix(*j_crc.LTE_CRC24B, 100).astype(np.int64)
    m = p_crc.remainder_masks(*p_crc.LTE_CRC24B, 100, CPU).numpy()
    np.testing.assert_array_equal((m[:, None] >> np.arange(23, -1, -1)) & 1, r)


@pytest.fixture(scope="module")
def stragglers():
    """test_torch_turbodecoder.py's straggler batch and the JAX decode of it
    (cascade on, which gives the same results as off)."""
    k, B = 512, 16
    bits, (d0, d1, d2) = _straggler_batch(k, B, 6)  # the B/4 stage enters at h = 3
    valid = np.ones(B, bool)
    valid[5] = False
    j = j_td.turbo_decode(d0, d1, d2, valid, k, 8, j_crc.LTE_CRC24B, False, 32)
    return k, (d0, d1, d2, valid), tuple(np.asarray(a) for a in j)


@pytest.mark.parametrize("cascade", ["1", "0"])
def test_device_loop_equals_jax(stragglers, monkeypatch, cascade):
    k, inputs, (j_bits, j_ok, j_it) = stragglers
    monkeypatch.setenv("SRSLTE_TPU_CASCADE", cascade)
    entered = {}  # stage -> h at its entry
    advance = ti._advance_ref

    def logged(done, ctl, rows, *a):
        advance(done, ctl, rows, *a)
        entered.setdefault(int(ctl[ti.STAGE]), int(ctl[ti.H]))

    monkeypatch.setattr(ti, "_advance_ref", logged)
    bits, ok, n_iter, counts = p_td.turbo_decode_device(*(torch.from_numpy(a) for a in inputs),
                                                        k, 8, p_crc.LTE_CRC24B,
                                                        use_kernel=False)
    assert n_iter.dim() == 0 and counts.shape == (2,)
    passes, rows = counts
    assert int(passes) == 16  # every slot ran: 8 iterations
    np.testing.assert_array_equal(bits.numpy(), j_bits)
    np.testing.assert_array_equal(ok.numpy(), j_ok)
    assert int(n_iter) == int(j_it) == 8
    assert 0 < j_ok.sum() < 15
    if cascade == "1":
        # all three stages; one entered at an odd h runs constituent 2 first
        assert sorted(entered) == [0, 1, 2] and any(h % 2 for h in entered.values()), entered
        assert int(rows) < 16 * 16
    else:
        assert entered == {0: 0} and int(rows) == 16 * 16


@pytest.mark.parametrize("use_kernel", [False, True])
def test_public_decode_equals_the_host_loop(stragglers, use_kernel):
    """turbo_decode (the device loop and one read) against turbo_decode_host
    (a read before every pass), on the plain MAP and on the kernel's plain
    version: bits, flags, n_iter and the MAP rows."""
    k, inputs, _ = stragglers
    args = [torch.from_numpy(a) for a in inputs]
    before = p_td.map_rows
    new = p_td.turbo_decode(*args, k, 8, p_crc.LTE_CRC24B, use_kernel=use_kernel)
    rows_new = p_td.map_rows - before
    old = p_td.turbo_decode_host(*args, k, 8, p_crc.LTE_CRC24B, use_kernel=use_kernel)
    rows_old = p_td.map_rows - before - rows_new
    assert torch.equal(new[0], old[0]) and torch.equal(new[1], old[1])
    assert isinstance(new[2], int) and new[2] == old[2]
    assert rows_new == rows_old > 0


def test_no_crc_runs_every_pass():
    """crc=None: 2 * max_iter passes over every row, n_iter = max_iter."""
    k, B = 40, 3
    rng = np.random.default_rng(1)
    d = [torch.from_numpy(rng.normal(0, 1, (B, k + 4)).astype(np.float32)) for _ in range(3)]
    valid = torch.ones(B, dtype=torch.bool)
    bits, ok, n_iter, (passes, rows) = p_td.turbo_decode_device(*d, valid, k, 3, None,
                                                                use_kernel=False)
    assert int(n_iter) == 3 and int(passes) == 6 and int(rows) == 6 * B and not ok.any()
    old = p_td.turbo_decode_host(*d, valid, k, 3, None, use_kernel=False)
    assert torch.equal(bits, old[0]) and old[2] == 3
