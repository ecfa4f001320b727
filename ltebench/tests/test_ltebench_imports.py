"""What the benchmark's process loads: never JAX, jaxlib, flax or the JAX
package (top-level names compared whole: the port's name begins with the
JAX package's), and, for the reference, nothing of the program."""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

WALK = """
import json, pathlib, sys, tempfile, time
import torch
from ltebench import control, harness, roofline, sets, trace  # noqa: F401
from ltebench.tests import small_tree
spec = harness.load_spec(pathlib.Path({root!r}))
root = small_tree.make(pathlib.Path(tempfile.mkdtemp()))
for cell in spec["workloads"]:
    harness.load_cell(root, cell["name"])
for m in spec["per_layer"]:
    harness.reader(root, m["name"])
harness.run(root, "small_cell", 1, 0.0, False, torch.device("cpu"), time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
from ltebench.reference import link, tables, turbo  # noqa: F401
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def top_level(code: str) -> set:
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=300)
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    """Every module a run loads: the harness, each cell's driver, each
    metric reader, and a whole run of a small cell on the CPU."""
    names = top_level(WALK.format(root=str(ROOT)))
    assert "srslte_emane_tpu_torch" in names  # the program is what it measures
    assert not names & {"jax", "jaxlib", "flax", "srslte_emane_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = top_level(REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "srslte_emane_tpu", "srslte_emane_tpu_torch"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from ltebench import harness

    monkeypatch.setitem(sys.modules, "srslte_emane_tpu_torch.fake", object())
    assert "srslte_emane_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "srslte_emane_tpu.fake", object())
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert {"srslte_emane_tpu", "jaxlib"} <= set(harness.forbidden_modules())
