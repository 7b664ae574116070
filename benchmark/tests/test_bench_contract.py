"""``BENCHMARK.json`` holds to the benchmark's contract: its keys, the
characters of every name and unit, the files it names, the bounds, and
which cells report which metric."""

from __future__ import annotations

import json
import re

import pytest

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")

BENCH = spec.load_spec()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)


def test_command_and_paths():
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(LINE.match(w) for w in cmd)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (spec.ROOT / p).is_dir()
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entry_keys_and_names(section, keys):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = set(e) - keys
        assert set(e) >= keys and extra <= {"workloads"} \
            and (not extra or section in ("end_to_end", "per_layer")), e
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert LINE.match(e[k]), (k, e[k])
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
        if "better" in e:
            assert e["better"] in ("lower", "higher")


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/") and (spec.ROOT /
                                                       c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert (spec.BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            # the metric it moves is reported in each cell it lists
            assert any(x["name"] == m["moves"]
                       for x in spec.end_to_end(BENCH, w))
        assert (spec.BENCH / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    for w in cells:
        names = {m["name"] for m in spec.end_to_end(BENCH, w)}
        assert "setup_s" in names and len(names) >= 2
        assert spec.per_layer(BENCH, w)
