"""The benchmark of ``ssgvc_tpu_torch`` on NVIDIA GPUs: one process, one
cell, one run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; the weights and
inputs are drawn from ``--seed`` on the card; every shape is warmed up
(set-up), then the window runs for ``--seconds``. With ``--trace 0`` the
result line holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from a profiled stretch inside the window, and a
``breakdown``. After the window the outputs of one group, drawn from the
seed, are compared with the plain fp32 reference (``benchmark/reference``);
the numbers compared and their limits are the last lines on standard
error and the last key of the result line.

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (``platform``,
``kind``, ``count``, ``memory_peak_bytes``; with ``--trace 1``
``busy_s`` and ``window_s``), with ``--trace 1`` ``breakdown``, and last
``checks``.

It exits non-zero and prints no result without a CUDA device (or with
fewer than the cell asks for), and when ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``ssgvc_tpu`` is loaded in the process once the window
has closed. The program's kernels build into its own directory inside the
checkout (``ssgvc_tpu_torch/_build``), on the first run only.
"""

from __future__ import annotations

import time

T_PERF = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names that the process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "ssgvc_tpu")


def process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock: its start
    time from ``/proc/self/stat`` against the boot clock, or, where that
    cannot be read, the moment this module was loaded."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError):
        return T_PERF
    now = time.perf_counter()
    # a clock that disagrees with the module's own load time is not used
    return now - age if now - 60 < now - age <= T_PERF else T_PERF


def forbidden_modules(names=None) -> list:
    """The top-level names, compared whole, of loaded modules (or of
    ``names``) that the benchmark may not hold."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names
                   if n.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    # any extension or Triton cache torch makes stays inside the checkout,
    # at a fixed path (the port's kernels build into ssgvc_tpu_torch/_build)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "benchmark" / ".cache"
                                             / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "benchmark" / ".cache"
                                         / "triton")
    from benchmark.harness import cell, spec

    bench = spec.load_spec(ROOT)
    chips = spec.cell(bench, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: the cell needs {chips} CUDA device(s), this host "
              f"has {have}: nothing is measured", file=sys.stderr)
        return 2
    res = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start=t_start, device="cuda", bench=bench)
    found = forbidden_modules()
    if found:
        print(f"run.py: the process holds {found} after the window: the "
              "benchmark may not load JAX or the JAX package",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": res["peak"]}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if args.trace:
        device.update(busy_s=res["busy_s"], window_s=res["window_s"])
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {res['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
