"""What the benchmark loads: every module under ``benchmark/`` imported in
a fresh interpreter leaves no ``jax``, ``jaxlib``, ``flax`` or
``ssgvc_tpu`` among the loaded modules' top-level names, compared whole
(``ssgvc_tpu_torch`` begins with ``ssgvc_tpu``: a prefix is not a match);
the reference loads nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark.harness import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "ssgvc_tpu")

PROBE = r"""
import importlib, importlib.util, json, pathlib, sys
root = pathlib.Path(sys.argv[1]); only = sys.argv[2]
sys.path.insert(0, str(root))
for p in sorted((root / only).rglob("*.py")):
    rel = p.relative_to(root).with_suffix("")
    if "." in rel.name or p.parent.name in ("metrics", "codecs"):
        spec = importlib.util.spec_from_file_location(
            "probe_" + "_".join(rel.parts).replace(".", "_").replace("-", "_"),
            p)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    else:
        importlib.import_module(".".join(rel.parts).replace(".__init__", ""))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def loaded(folder: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE, str(spec.ROOT),
                          folder], capture_output=True, text=True,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_loads_jax_or_the_jax_package():
    tops = loaded("benchmark")
    assert "benchmark" in tops and "torch" in tops
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    tops = loaded("benchmark/reference")
    assert "ssgvc_tpu_torch" not in tops
    assert not tops & set(FORBIDDEN)


def test_the_comparison_is_by_whole_names():
    from benchmark import run

    assert run.forbidden_modules(["ssgvc_tpu_torch", "ssgvc_tpu_torch.ops",
                                  "jaxtyping", "flaxen.sub", "torch"]) == []
    assert run.forbidden_modules(["ssgvc_tpu.models.dmc", "jax.numpy",
                                  "jaxlib", "flax", "torch"]) == [
        "flax", "jax", "jaxlib", "ssgvc_tpu"]
