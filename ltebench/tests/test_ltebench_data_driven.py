"""A configuration, a traffic mix and a per-layer metric are new files that
the harness finds by name; and BENCHMARK.json keeps to the names and units
the contract allows."""

import json
import pathlib
import re
import time

import torch

from ltebench import harness
from ltebench.tests import small_tree

ROOT = pathlib.Path(__file__).resolve().parents[2]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def test_new_files_are_found_by_name(tmp_path):
    root = small_tree.make(tmp_path)
    before = {p: p.read_bytes() for p in (root / "ltebench").rglob("*") if p.is_file()}
    (root / "ltebench" / "metrics" / "calls_seen.small.py").write_text(
        '"""Calls in the window."""\n\n\ndef read(ctx):\n    return float(ctx["calls"])\n')
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "calls_seen.small", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "link (models/pdsch_link.py)",
                              "moves": "link_sf_per_s", "workloads": ["small_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell(root, "small_cell")
    assert cell.config["n_prb"] == 15 and cell.traffic["snr_db"] == [8, 20]
    assert [m["name"] for m in cell.per_layer][-1] == "calls_seen.small"
    assert harness.reader(root, "calls_seen.small")({"calls": 7}) == 7.0
    out = harness.run(root, "small_cell", 2 ** 31 + 5, 0.0, False, torch.device("cpu"),
                      time.perf_counter())
    assert out["correct"] and out["attempted"] >= 2
    assert set(out["metrics"]) == {"link_sf_per_s", "call_p95_ms", "setup_s"}
    assert list(out)[-1] == "check"
    # nothing that was there changed
    assert all(p.read_bytes() == b for p, b in before.items())


def test_benchmark_json_names_and_units():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[key]]
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in spec["workloads"]] + \
            [w["traffic"] for w in spec["workloads"]] + \
            [k for c in spec["configs"] for k in c["reduced"]]:
        assert NAME.fullmatch(n), n
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in spec["end_to_end"]}
    layers = {}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], m["layer"])
        assert (ROOT / "ltebench" / "metrics" / f"{m['name']}.py").is_file()
    for w in spec["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (ROOT / "ltebench" / "traffic" / f"{w['traffic']}.json").is_file()
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("ltebench/")
    assert len(json.dumps(spec)) < 64 * 1024


def test_the_sample_spans_the_whole_window():
    """The check's sample is drawn from every call of the window, the same
    for the same seed and calls, and keeps `per` calls of each stratum."""
    def kept(seed, n=700, strata=7, per=2):
        s = harness.Sample(strata, per, seed)
        for c in range(n):
            s.offer(c, c)
        return s.kept()

    k = kept(2 ** 31 + 9)
    assert k == kept(2 ** 31 + 9) and all(c == v for c, v in k.items())
    assert sorted(c % 7 for c in k) == sorted(list(range(7)) * 2)
    late = [c for seed in range(40) for c in kept(seed) if c >= 350]
    assert 0.35 < len(late) / (40 * 14) < 0.65
