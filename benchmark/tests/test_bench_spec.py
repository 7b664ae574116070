"""The harness finds every piece of a cell by its name, from files alone:
a configuration, a traffic mix and a per-layer metric added as new files,
with a cell in ``BENCHMARK.json`` that names them, run without a change
to any file the benchmark already has."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import spec
from benchmark.tests.helpers import DMC_TINY

BENCH = spec.load_spec()


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_resolves(workload):
    cell = spec.cell(BENCH, workload)
    cfg = spec.config(BENCH, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    assert traffic["mode"] in ("bulk", "live")
    assert hasattr(spec.codec(cfg["codec"]), "Codec")
    assert (spec.ROOT / cfg["reference"]).is_file()
    readers = {m["name"]: spec.reader(m["name"])
               for m in spec.per_layer(BENCH, workload)}
    assert readers and all(callable(r.read) for r in readers.values())
    names = {m["name"] for m in spec.end_to_end(BENCH, workload)}
    assert "setup_s" in names


def test_draws_are_the_seeds():
    big = 2 ** 31 + 12345
    assert spec.draws(big, "qp", 5, 0, 63) == spec.draws(big, "qp", 5, 0, 63)
    assert spec.sub_seed(big, "a") != spec.sub_seed(big, "b")
    assert 0 <= spec.sub_seed(2 ** 70, "x") < 2 ** 63


RUN = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1]); sys.path.insert(1, sys.argv[2])
import torch; torch.set_num_threads(2)
from benchmark.harness import cell, spec
assert str(spec.ROOT) == sys.argv[1], spec.ROOT
r = cell.run("added-cell", 2 ** 31 + 7, 0.2, True,
             t_start=time.perf_counter(), device="cpu")
print(json.dumps({"metrics": r["metrics"], "attempted": r["attempted"]}))
"""


def test_new_files_add_a_cell(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "benchmark").rglob("*") if p.is_file()}
    b = root / "benchmark"
    cfg = spec.config(BENCH, "dmc-perf-1080p-bf16")
    cfg["model"].update(DMC_TINY)
    cfg["frame"] = {"height": 64, "width": 128}
    (b / "configs" / "dmc-tiny-added.json").write_text(json.dumps(cfg))
    (b / "traffic" / "bulk-b2-gop2.json").write_text(json.dumps(dict(
        spec.traffic("bulk-b4-gop8"), streams=2, group=2, sample_from=2)))
    (b / "metrics" / "frames_traced.added.py").write_text(
        "def read(run):\n    return float(run.traced_frames) or None\n")
    added = dict(BENCH)
    added["configs"] = BENCH["configs"] + [{
        "name": "dmc-tiny-added", "source": "https://example.org/added",
        "file": "benchmark/configs/dmc-tiny-added.json", "reduced": [],
        "why": "a test"}]
    added["workloads"] = BENCH["workloads"] + [{
        "name": "added-cell", "config": "dmc-tiny-added",
        "traffic": "bulk-b2-gop2", "chips": 1, "why": "a test"}]
    added["end_to_end"] = [dict(m, workloads=m["workloads"] + ["added-cell"])
                           if m["name"] == "fps" else m
                           for m in BENCH["end_to_end"]]
    added["per_layer"] = BENCH["per_layer"] + [{
        "name": "frames_traced.added", "unit": "frames", "better": "higher",
        "source": "device_trace", "layer": "device", "moves": "fps",
        "workloads": ["added-cell"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(added))
    out = subprocess.run([sys.executable, "-c", RUN, str(root),
                          str(spec.ROOT)], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["metrics"]["frames_traced.added"]["value"] == 4.0
    assert set(res["metrics"]) == {"frames_traced.added"}
    assert res["attempted"] >= 8
    after = {p.relative_to(root): p.read_bytes()
             for p in (root / "benchmark").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())
