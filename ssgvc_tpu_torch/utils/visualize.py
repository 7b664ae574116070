"""Figures: the per-QP statistics of a learned q table (``visualize_q_scale``,
needs matplotlib) and the original / reconstruction panels the trainer
writes at each validation (``save_recon_panel``, a PNG through Pillow).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .transforms import ycbcr2rgb_np


def visualize_q_scale(q_table: np.ndarray, out_dir: str, name: str = "q_scale",
                      make_gif: bool = True,
                      log_wandb: bool = False) -> Dict[str, str]:
    """q_table: (QP, C) learned per-QP scales. Writes mean/std PNG and an
    animated per-QP histogram GIF. Returns written paths.

    ``log_wandb=True``: when a wandb run is live, the written images are
    attached to it; nothing happens when wandb is not installed or no run
    is live."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    q = np.asarray(q_table, np.float32)
    paths = {}

    fig, ax = plt.subplots(figsize=(8, 4))
    mean = q.mean(axis=1)
    std = q.std(axis=1)
    ax.plot(mean, label="mean")
    ax.fill_between(np.arange(len(mean)), mean - std, mean + std, alpha=0.3,
                    label="±std")
    ax.set_xlabel("QP")
    ax.set_ylabel(name)
    ax.legend()
    ax.set_title(f"{name} per-QP statistics")
    stat_path = os.path.join(out_dir, f"{name}_stats.png")
    fig.savefig(stat_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    paths["stats"] = stat_path

    if make_gif:
        try:
            from PIL import Image
            frames = []
            lo, hi = float(q.min()), float(q.max())
            for qp in range(0, q.shape[0], max(1, q.shape[0] // 32)):
                fig, ax = plt.subplots(figsize=(6, 3))
                ax.hist(q[qp], bins=40, range=(lo, hi))
                ax.set_title(f"{name} @ QP {qp}")
                ax.set_ylim(0, q.shape[1] * 0.5)
                fig.canvas.draw()
                buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
                frames.append(Image.fromarray(buf))
                plt.close(fig)
            gif_path = os.path.join(out_dir, f"{name}_hist.gif")
            frames[0].save(gif_path, save_all=True, append_images=frames[1:],
                           duration=150, loop=0)
            paths["gif"] = gif_path
        except ImportError as e:  # pragma: no cover
            print(f"[visualize] gif skipped: {e}")

    if log_wandb:
        try:  # pragma: no cover
            import wandb
            if wandb.run is not None:
                wandb.log({f"{name}/{k}": wandb.Image(p)
                           for k, p in paths.items()})
        except ImportError:
            pass
    return paths


def save_recon_panel(original_ycbcr: np.ndarray, recon_ycbcr: np.ndarray,
                     out_path: str, mask: np.ndarray = None) -> str:
    """The original and the reconstruction side by side (YCbCr -> RGB, 8-bit
    PNG at ``out_path``). ``mask`` (H, W, 1) tints the ROI green on the
    original's half."""
    from PIL import Image

    orig = ycbcr2rgb_np(np.asarray(original_ycbcr))
    rec = ycbcr2rgb_np(np.asarray(recon_ycbcr))
    if mask is not None:
        m = np.asarray(mask)[..., 0] > 0
        green = np.array([0.0, 1.0, 0.0], orig.dtype)
        orig = np.where(m[..., None], 0.65 * orig + 0.35 * green, orig)
    panel = np.concatenate([orig, rec], axis=1)
    img = (np.clip(panel, 0, 1) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    Image.fromarray(img).save(out_path)
    return out_path
