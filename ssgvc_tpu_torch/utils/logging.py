"""Experiment logs: the train and val metrics CSVs, the config snapshot and
the per-sequence result JSON. Only the main process writes
(``is_main_process``: rank 0 of torch.distributed when it is initialised);
TensorBoard scalars are written too when asked for and
``torch.utils.tensorboard`` imports.
"""

from __future__ import annotations

import csv
import datetime
import json
import os
from typing import Dict, Optional

import torch

TRAIN_HEADERS = ["epoch", "step", "loss", "bpp", "bpp_y", "bpp_z", "psnr",
                 "mse", "qp_avg"]
VAL_HEADERS = ["epoch", "step", "loss", "bpp", "bpp_y", "bpp_z", "psnr", "mse"]


def is_main_process() -> bool:
    """True on rank 0 of an initialised torch.distributed, and when it is
    not initialised."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


class CSVLogger:
    """train_metrics.csv and val_metrics.csv under ``log_dir`` (columns
    TRAIN_HEADERS, VAL_HEADERS; a missing metric is an empty cell), and
    TensorBoard scalars with ``tensorboard``."""

    def __init__(self, log_dir: str, tensorboard: bool = False):
        self.log_dir = log_dir
        self.train_path = os.path.join(log_dir, "train_metrics.csv")
        self.val_path = os.path.join(log_dir, "val_metrics.csv")
        self._tb = None
        if is_main_process():
            os.makedirs(log_dir, exist_ok=True)
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                    self._tb = SummaryWriter(log_dir)
                except ImportError as e:  # pragma: no cover
                    print(f"[logging] tensorboard unavailable: {e}")

    def _tb_scalars(self, prefix: str, step: int, metrics: Dict):
        if self._tb is None:
            return
        for k, v in metrics.items():
            try:
                self._tb.add_scalar(f"{prefix}/{k}", float(v), step)
            except (TypeError, ValueError):
                pass

    def _write(self, path: str, headers, metrics: Dict):
        if not is_main_process():
            return
        exists = os.path.exists(path)
        with open(path, "a", newline="") as f:
            writer = csv.writer(f)
            if not exists:
                writer.writerow(headers)
            writer.writerow([metrics.get(h, "") for h in headers])

    def log_train(self, step: int, metrics: Dict):
        metrics = dict(metrics)
        metrics.setdefault("step", step)
        metrics.setdefault("epoch", 0)
        self._write(self.train_path, TRAIN_HEADERS, metrics)
        self._tb_scalars("train", step, metrics)
        ts = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        print(f"[{ts}] step {step}: loss {metrics.get('loss', float('nan')):.6f} "
              f"bpp {metrics.get('bpp', float('nan')):.5f} "
              f"psnr {metrics.get('psnr', float('nan')):.2f}", flush=True)

    def log_val(self, step: int, metrics: Dict):
        metrics = dict(metrics)
        metrics.setdefault("step", step)
        metrics.setdefault("epoch", 0)
        self._write(self.val_path, VAL_HEADERS, metrics)
        self._tb_scalars("val", step, metrics)


def save_config_snapshot(log_dir: str, cfg) -> Optional[str]:
    """Write the merged config as ``log_dir/config.json``; returns its path
    (None off the main process)."""
    if not is_main_process():
        return None
    import dataclasses
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "config.json")

    def to_dict(obj):
        if dataclasses.is_dataclass(obj):
            return {f.name: to_dict(getattr(obj, f.name))
                    for f in dataclasses.fields(obj)}
        if isinstance(obj, (list, tuple)):
            return [to_dict(v) for v in obj]
        if isinstance(obj, dict):
            return {str(k): to_dict(v) for k, v in obj.items()}
        return obj

    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2)
    return path


def generate_log_json(frame_results, seq_name: str = "", gop: int = 32):
    """A DCVC-style per-sequence result: I- and P-frame bpp and PSNR,
    averages over all frames (MS-SSIM too), encode and decode times.

    frame_results: list of dicts with keys frame_type ('I'|'P'), bpp, psnr,
    msssim, enc_time, dec_time.
    """
    i_frames = [r for r in frame_results if r.get("frame_type") == "I"]
    p_frames = [r for r in frame_results if r.get("frame_type") == "P"]

    def avg(rows, key):
        vals = [r[key] for r in rows if key in r]
        return float(sum(vals) / len(vals)) if vals else 0.0

    out = {
        "name": seq_name,
        "gop": gop,
        "frame_count": len(frame_results),
        "i_frame_num": len(i_frames),
        "p_frame_num": len(p_frames),
        "ave_i_frame_bpp": avg(i_frames, "bpp"),
        "ave_i_frame_psnr": avg(i_frames, "psnr"),
        "ave_p_frame_bpp": avg(p_frames, "bpp"),
        "ave_p_frame_psnr": avg(p_frames, "psnr"),
        "ave_all_frame_bpp": avg(frame_results, "bpp"),
        "ave_all_frame_psnr": avg(frame_results, "psnr"),
        "ave_all_frame_msssim": avg(frame_results, "msssim"),
        "frame_bpp": [r.get("bpp", 0.0) for r in frame_results],
        "frame_psnr": [r.get("psnr", 0.0) for r in frame_results],
        "avg_enc_time": avg(frame_results, "enc_time"),
        "avg_dec_time": avg(frame_results, "dec_time"),
    }
    return out


def dump_json(obj, path: str, precision: int = 6):
    """Write ``obj`` as JSON with every float rounded to ``precision``
    digits."""

    def round_floats(o):
        if isinstance(o, float):
            return round(o, precision)
        if isinstance(o, dict):
            return {k: round_floats(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [round_floats(v) for v in o]
        return o

    with open(path, "w") as f:
        json.dump(round_floats(obj), f, indent=2)
