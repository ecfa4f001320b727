"""`correct` on the CPU at a small size: a sound run passes; the control
(the reference one precision down in the program's place) and each fault
that a link cell can have fail."""

import time

import pytest
import torch

from ltebench import control, harness
from ltebench.tests import small_tree


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_tree.make(tmp_path_factory.mktemp("bench"))


def run(root, wrap=None, seed=2 ** 31 + 77):
    return harness.run(root, "small_cell", seed, 0.0, False, torch.device("cpu"),
                       time.perf_counter(), wrap=wrap)


def flip_a_bit(encode, decode):
    """A decoded bit altered where the answer is produced."""
    def broken(rx):
        out, ok, softbuf, ce = decode(rx)
        out = out.clone()
        out[0, 5] ^= 1
        return out, ok, softbuf, ce
    return encode, broken


def half_the_batch(encode, decode):
    """Only the first half of the rows decoded: the rest left at zero."""
    def broken(rx):
        h = rx.shape[0] // 2
        out, ok, softbuf, ce = decode(rx[:h])
        pad = lambda t: torch.cat([t, torch.zeros((rx.shape[0] - h,) + t.shape[1:], dtype=t.dtype)])
        return pad(out), pad(ok), [pad(s) for s in softbuf], pad(ce)
    return encode, broken


def stale(encode, decode):
    """The decode hands back its first answer for every later call."""
    first = []

    def broken(rx):
        if not first:
            first.append(decode(rx))
        return first[0]
    return encode, broken


def test_a_sound_run_is_correct(root):
    out = run(root)
    assert out["correct"], out["check"]
    assert out["check"]["rows_wrong"]["value"] == 0


@pytest.mark.parametrize("fault", [flip_a_bit, half_the_batch, stale])
def test_a_fault_is_not_correct(root, fault):
    out = run(root, wrap=fault)
    assert not out["correct"], out["check"]


def test_the_control_is_not_correct(root):
    res = control.control_numbers(root, "small_cell", 11, torch.device("cpu"))
    assert not res["correct"]
    for name in ("tx_err", "chest_err", "softbuf_err"):
        assert res["check"][name]["value"] > res["check"][name]["limit"], name


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(tmp_path):
    """On the card: python -m pytest -m cuda ltebench/tests"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = harness.run(small_tree.make(tmp_path), "small_cell", 3, 0.5, True,
                      torch.device("cuda", 0), time.perf_counter())
    assert out["correct"] and out["device"]["busy_s"] > 0
