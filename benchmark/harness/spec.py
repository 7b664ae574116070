"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, a cell's configuration file (its ``file`` there), its
traffic mix (``benchmark/traffic/<traffic>.json``), the codec adapter its
configuration names (``benchmark/codecs/<codec>.py``) and one reader per
per-layer metric (``benchmark/metrics/<name>.py``). A new configuration,
mix or metric is a new file and an entry in ``BENCHMARK.json``; nothing
here changes."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import random
from pathlib import Path
from types import ModuleType
from typing import List

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                   f"{[w['name'] for w in spec['workloads']]})")


def config(spec: dict, name: str, root: Path = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(BENCH / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _module(path: Path, tag: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{tag}: no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{tag}_{path.stem.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def codec(name: str) -> ModuleType:
    """The adapter of a model class: ``benchmark/codecs/<name>.py``."""
    return _module(BENCH / "codecs" / f"{name}.py", "codec")


def reader(name: str) -> ModuleType:
    """A per-layer metric's reader: ``benchmark/metrics/<name>.py``."""
    return _module(BENCH / "metrics" / f"{name}.py", "metric")


def _covers(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def end_to_end(spec: dict, workload: str) -> List[dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in spec["end_to_end"] if _covers(m, workload)]


def per_layer(spec: dict, workload: str) -> List[dict]:
    """The per-layer metrics the cell reports: those that list it, and
    those without a list whose ``moves`` the cell reports."""
    e2e = {m["name"] for m in end_to_end(spec, workload)}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def sub_seed(seed: int, tag: str) -> int:
    """A seed of its own for each use of ``--seed``: 63 bits of
    sha256("<seed>:<tag>"), so any whole number, however large, gives
    streams that do not overlap."""
    h = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def draws(seed: int, tag: str, n: int, lo: int, hi: int) -> List[int]:
    """``n`` whole numbers in [lo, hi], from ``seed``."""
    rng = random.Random(sub_seed(seed, tag))
    return [rng.randint(lo, hi) for _ in range(n)]

