"""A copy of the benchmark's files with one small cell added, for the tests.

`make(tmp)` copies BENCHMARK.json and ltebench/ into tmp and adds, as new
files and entries only, the configuration `small` (the link's
configuration at 15 PRB, 2 subframes a call: two code-block sizes, as at
100 PRB) and the mix `small_mix` (8 and 20 dB, one call of each checked), and the
cell `small_cell` on them, listed in every metric that the link cells
report.  Such a cell runs on the CPU in seconds.
"""

import json
import pathlib
import shutil

from ltebench.systems import pdsch_link

ROOT = pathlib.Path(__file__).resolve().parents[2]


def make(tmp: pathlib.Path, snr_db=(8, 20)) -> pathlib.Path:
    shutil.copytree(ROOT / "ltebench", tmp / "ltebench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    bench = tmp / "ltebench"
    conf = json.loads((bench / "configs" / "pdsch_20mhz_siso_64qam.json").read_text())
    conf.update(name="small", n_prb=15, batch=2)
    conf["tbs"] = pdsch_link.reference_link(conf).tbs
    (bench / "configs" / "small.json").write_text(json.dumps(conf))
    mix = json.loads((bench / "traffic" / "sweep_8_to_20db.json").read_text())
    mix.update(snr_db=list(snr_db), pool=3, check_per_snr=1, trace_calls=2)
    (bench / "traffic" / "small_mix.json").write_text(json.dumps(mix))
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="small",
                                file="ltebench/configs/small.json", reduced=["n_prb", "batch", "tbs"]))
    spec["workloads"].append({"name": "small_cell", "config": "small", "traffic": "small_mix",
                              "chips": 1, "why": "a link cell small enough for the CPU"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "pdsch_sweep" in m.get("workloads", ()):
            m["workloads"].append("small_cell")
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return tmp
