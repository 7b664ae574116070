"""Extract the cycle-by-cycle RD trajectory from a marathon log.

An RD marathon trains both codec variants in warm-restart cycles
(``rd_continue``) and evaluates a 5-QP mini sweep at the end of each
variant's budget, printing ``[variant] bpp=[...]`` / ``psnr=`` / ``roi=``
lines and a ``=== continue cycle N done <when> rc=<rc>`` line per cycle.
This script parses those eval blocks out of the log into
``artifacts/torch/rd_trajectory.json``, so the report can show convergence
(eval PSNR, QP 8 -> 56 separation and the performance-vs-plain ROI gap per
cycle) rather than only the final point. The log itself is not kept.

    python3 -m ssgvc_tpu_torch.experiments.rd_trajectory [logfile]

The default log is ``logs/rd_marathon.log`` under the working directory.
"""

from __future__ import annotations

import os
import re
import sys

from . import ARTIFACTS, write_json

# marathon epochs: a "=== marathon start ... ===" line resets the cycle
# counter; only the latest epoch is reported
RE_START = re.compile(r"^=== marathon start (.+?) \(")
RE_CYCLE = re.compile(r"^=== continue cycle (\d+) done (.+?) rc=(\d+)")
RE_EVAL = re.compile(r"^\[(\w+)\+?\] (bpp|psnr|roi)=\[([^\]]*)\]")

NOTE = ("192px eval mini-sweep (QP 8..56) at the end of each warm-restart "
        "cycle of the port's marathon log, trained on the card; the cycles "
        "of the latest marathon start only.")


def parse(path):
    """Every eval block of the log's latest marathon epoch, by cycle."""
    epochs = [[]]  # list of eval-block lists per marathon epoch
    pending = {}   # variant -> {bpp/psnr/roi}
    with open(path, errors="replace") as f:
        for line in f:
            line = line.strip()
            if RE_START.match(line):
                epochs.append([])
                pending = {}
                continue
            m = RE_EVAL.match(line)
            if m:
                variant, key, vals = m.groups()
                variant = variant.rstrip("+")
                vals = [float(v) for v in vals.split(",") if v.strip()]
                pending.setdefault(variant, {})[key] = vals
                continue
            m = RE_CYCLE.match(line)
            if m and pending:
                cyc, when, rc = m.groups()
                epochs[-1].append({"cycle": int(cyc), "when": when,
                                   "rc": int(rc), "variants": pending})
                pending = {}
    cycles = epochs[-1]
    if pending:
        # a cycle stopped mid-run that already evaluated >= 1 variant
        last = cycles[-1]["cycle"] if cycles else 0
        cycles.append({"cycle": last + 1, "when": "(stopped mid-cycle)",
                       "rc": None, "partial": True, "variants": pending})
    return cycles


def summarize(cycles):
    """Per cycle: each variant's PSNR at QP 56, its QP 8 -> 56 separation,
    ROI-PSNR at QP 56, and the mean ROI gap of performance over plain."""
    rows = []
    for c in cycles:
        row = {"cycle": c["cycle"], "when": c["when"]}
        for v, d in c["variants"].items():
            psnr, roi = d.get("psnr"), d.get("roi")
            if psnr:
                row[f"{v}_psnr_qp56"] = psnr[-1]
                row[f"{v}_qp_separation_db"] = round(psnr[-1] - psnr[0], 3)
            if roi:
                row[f"{v}_roi_qp56"] = roi[-1]
        p, q = c["variants"].get("performance"), c["variants"].get("plain")
        if p and q and p.get("roi") and q.get("roi"):
            # mean ROI advantage of performance over plain across the sweep
            n = min(len(p["roi"]), len(q["roi"]))
            row["roi_gap_db"] = round(
                sum(p["roi"][i] - q["roi"][i] for i in range(n)) / n, 3)
        rows.append(row)
    return rows


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    log = argv[0] if argv else os.path.join("logs", "rd_marathon.log")
    cycles = parse(log)
    out = {"source": os.path.relpath(log), "note": NOTE, "cycles": cycles,
           "summary": summarize(cycles)}
    dst = f"{ARTIFACTS}/rd_trajectory.json"
    write_json(dst, out)
    print(f"wrote {dst} ({len(cycles)} cycles)")
    for r in out["summary"]:
        print(r)
    return out


if __name__ == "__main__":
    main()
