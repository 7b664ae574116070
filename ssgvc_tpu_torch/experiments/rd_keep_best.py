"""Keep-best checkpoint rotation for the fresh-data RD marathon.

After each rd_continue cycle, score each variant's held-out eval from
``artifacts/torch/rd_continued.json`` (mean global PSNR + mean ROI PSNR over
the QP sweep, both on the pinned 192px eval clips) and:

  * snapshot the live checkpoint to ``<live>.best`` when the score improves;
  * restore live from ``.best`` when the cycle regressed badly (more than
    ``DIVERGE_DB`` below best) so the next cycle does not continue from a
    diverged basin;
  * append the cycle's scores to ``artifacts/torch/rd_fresh_trajectory.json``.

The checkpoints are files (``utils/checkpoint.py``): a snapshot or a
restore is a copy renamed over its target.

    python3 -m ssgvc_tpu_torch.experiments.rd_keep_best <cycle_index>
"""

from __future__ import annotations

import json
import os
import sys

from . import ARTIFACTS, copy_checkpoint, write_json

VARIANTS = ("performance", "plain")
BEST_JSON = f"{ARTIFACTS}/rd_fresh_best.json"
TRAJ_JSON = f"{ARTIFACTS}/rd_fresh_trajectory.json"
CONTINUED_JSON = f"{ARTIFACTS}/rd_continued.json"
DIVERGE_DB = 1.0


def live_path(variant: str) -> str:
    return f"{ARTIFACTS}/rd_ckpt_{variant}_tiny-skip"


def score_of(curve: dict) -> float:
    psnr = curve["psnr"]
    roi = curve["roi_psnr"]
    return float(sum(psnr) / len(psnr) + sum(roi) / len(roi))


def _load(path: str, default):
    if not os.path.exists(path):
        return default
    with open(path) as f:
        return json.load(f)


def main(cycle: int = -1) -> list:
    """Score cycle ``cycle``'s rd_continued.json, rotate the snapshots and
    append its row to the trajectory; returns the trajectory."""
    with open(CONTINUED_JSON) as f:
        res = json.load(f)
    best = _load(BEST_JSON, {})
    traj = _load(TRAJ_JSON, [])
    row = {"cycle": cycle}

    for v in VARIANTS:
        cur = res.get("variants", {}).get(v, {})
        if "estimated_rd" not in cur:
            # gated/aborted cycle: rd_continue already restored .prev
            row[v] = {"score": None, "gate": cur.get("gate", "missing")}
            continue
        s = score_of(cur["estimated_rd"])
        row[v] = {"score": round(s, 4),
                  "psnr": [round(p, 3) for p in cur["estimated_rd"]["psnr"]],
                  "roi_psnr": [round(p, 3)
                               for p in cur["estimated_rd"]["roi_psnr"]],
                  "bpp": [round(b, 5) for b in cur["estimated_rd"]["bpp"]]}
        live, bst = live_path(v), live_path(v) + ".best"
        prev_best = best.get(v, {}).get("score", -1e9)
        if s > prev_best:
            copy_checkpoint(live, bst)
            best[v] = {"score": s, "cycle": cycle}
            row[v]["action"] = "new_best"
        elif s < prev_best - DIVERGE_DB and os.path.exists(bst):
            copy_checkpoint(bst, live)
            row[v]["action"] = "diverged_restored_best"
        else:
            row[v]["action"] = "kept_latest"
        print(f"[keep-best][{v}] cycle {cycle}: score {s:.3f} "
              f"(best {max(s, prev_best):.3f}) -> {row[v]['action']}",
              flush=True)

    for k in ("bd_psnr_roi_db", "bd_rate_roi_psnr_pct", "bd_psnr_db",
              "bd_rate_psnr_pct"):
        if k in res:
            row[k] = res[k]

    write_json(BEST_JSON, best)
    traj.append(row)
    write_json(TRAJ_JSON, traj)
    return traj


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else -1)
