"""The readings that the comparison's limits are set from.

For each seed, in one process, one run of the cell through the harness's
own ``cell.run``: its set-up, a short window at the cell's own load (the
group the seed samples kept), and the reference's readings of every kept
step (the worst stream's). ``--control int8`` reads the control instead:
the program with its own int8 path on (``harness/control.py``), which
has to read above the limits; ``--fault <name>`` plants a fault of
``benchmark/faults.py`` under the timed path.

    python3 benchmark/readings.py --workload pframe-bulk-b4
        --seeds 1 2 3 [--control int8 | --fault no_bits_z] [--seconds 2]

Prints one JSON line per seed and, last, the largest and the smallest
reading of each number over the seeds. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(workload: str, seed: int, seconds: float, control=None,
             fault=None, device="cuda", bench=None, config=None,
             traffic=None) -> dict:
    """One run of the cell through the harness's own ``cell.run``, with
    ``seconds`` of window: its set-up, window and comparison, and the
    reference's readings of every kept step (the worst stream's)."""
    import torch

    from benchmark.faults import FAULTS
    from benchmark.harness import cell

    res = cell.run(workload, seed, seconds, False,
                   t_start=time.perf_counter(), device=device,
                   control=control, bench=bench, config=config,
                   traffic=traffic, wrap=FAULTS[fault] if fault else None)
    w, per = res["window"], res["per"]
    out = {"seed": seed, "control": control, "fault": fault,
           "qp": w.kept_qp, "frames": w.frames, "window_s": w.seconds,
           "setup_s": res["setup_s"], "reference_s": res["reference_s"],
           "failed": res["failed"], "correct": res["correct"],
           "worst": {k: max(v, key=lambda x: (x != x, x))
                     for k, v in per.items()}, "by_step": per}
    del res, w
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", choices=("int8",), default=None)
    ap.add_argument("--fault", default=None,
                    help="a fault of benchmark/faults.py to plant")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.faults import FAULTS

    if args.fault is not None and args.fault not in FAULTS:
        ap.error(f"--fault: one of {sorted(FAULTS)}")
    import torch

    if not torch.cuda.is_available():
        print("readings.py: no CUDA device", file=sys.stderr)
        return 2
    worst = {}
    for seed in args.seeds:
        r = readings(args.workload, seed, args.seconds, args.control,
                     args.fault)
        print(json.dumps(r), flush=True)
        for k, v in r["worst"].items():
            worst.setdefault(k, []).append(v)
    print(json.dumps({"workload": args.workload, "control": args.control,
                      "fault": args.fault, "seeds": args.seeds,
                      "max_over_seeds": {k: max(v) for k, v in worst.items()},
                      "min_over_seeds": {k: min(v) for k, v in worst.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
