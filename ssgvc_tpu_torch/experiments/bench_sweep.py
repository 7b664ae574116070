"""Throughput sweep over batch size for the 1080p P-frame loop.

The harness of ``bench.py`` (``ssgvc_tpu_torch.bench.measure``, bf16,
``SSGVC_INT8`` held at 0): a GOP of frames with the DPB carried from
frame to frame, the packed ingest (``SSGVC_PACKED=1``) inside the timed
window, each rep ended by reading the GOP's bpp sum on the host. Reports
fps per card = batch * n_frames / time for each batch, ms a step (a frame
of the batch), and TFLOP/s from ``utils/flops.py``'s count of one P-frame
at the batch's shapes, against the H100's 989 TFLOP/s bf16.

Frames, masks, the DPB and the weights come from ``--seed`` (through
``torch.Generator`` on the device): the JAX script salted its keys with
the clock so that no two processes fed XLA the same constants; the port's
eager forward folds no input into a compiled program, so a seed that
repeats a run is kept instead.

    python3 -m ssgvc_tpu_torch.experiments.bench_sweep [b1 b2 ...]
        [--seed 0] [--device=cpu]

``SSGVC_PACKED=1`` runs the loop on pixel-unshuffled frames
(``DMCConfig.packed_io``); ``SSGVC_FRAMES`` sets the GOP length (16).
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Tuple

import torch

from ..utils.flops import H100_BF16_FLOPS
from . import split_device
from .profile_stages import card_line, share_of_peak, share_text


def make_gop_inputs(cfg, b: int, h: int, w: int, n_frames: int,
                    generator: torch.Generator, device
                    ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """(frames (n, b, h, w, 3), masks (n, b, h, w, 1), DPB) at raw
    resolution in the model's dtype, as the JAX script draws them: uniform
    frames, masks where a uniform draw exceeds 0.8, a uniform DPB frame
    and an N(0, 0.1) DPB feature at 1/8 resolution."""
    from ..models.common import compute_dtype

    dt = compute_dtype(cfg.dtype)
    kw = dict(generator=generator, device=device)
    frames = torch.rand((n_frames, b, h, w, 3), **kw).to(dt)
    masks = (torch.rand((n_frames, b, h, w, 1), **kw) > 0.8).to(dt)
    dpb = {"frame": torch.rand((b, h, w, 3), **kw).to(dt),
           "feature": (torch.randn((b, h // 8, w // 8, cfg.ch_d), **kw)
                       * 0.1).to(dt)}
    return frames, masks, dpb


def pframe_flops(cfg, b: int, h: int, w: int) -> int:
    """Products of one P-frame of ``b`` images at h x w, any variant
    (``utils/flops.py`` on the meta device): for the performance variant
    ``profile_stages.count_flops``' "full"."""
    from ..models.dmc import DMC
    from ..utils.flops import count_products
    from .profile_stages import full_frame, make_inputs

    with count_products() as c:
        full_frame(DMC(cfg, device="meta"), make_inputs(cfg, b, h, w, 0,
                                                        "meta"))
    return c.total


def bench_batch(b, h=1088, w=1920, n_frames=16, variant="performance",
                reps=3, *, seed: int = 0, device="cuda"):
    """(fps, ms a step) of a GOP of ``n_frames`` at batch ``b``:
    :func:`ssgvc_tpu_torch.bench.measure` in bf16 (batched ingest, the
    min of ``reps`` timed GOPs after one warm-up, each at ``qp = 33 +
    rep``), packed as ``SSGVC_PACKED`` says."""
    from ..bench import measure
    from ..config import DMCConfig

    packed = os.environ.get("SSGVC_PACKED", "0") == "1"
    n_frames = int(os.environ.get("SSGVC_FRAMES", n_frames))
    cfg = DMCConfig.variant(variant, dtype="bfloat16", packed_io=packed)
    line = measure(variant, b, cfg=cfg, h=h, w=w, n_frames=n_frames,
                   reps=reps, seed=seed, device=device)
    return line["value"], line["ms_per_frame"] * b


def main(argv=None) -> dict:
    device, argv = split_device(sys.argv[1:] if argv is None else argv)
    seed = 0
    if "--seed" in argv:
        i = argv.index("--seed")
        seed = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    batches = [int(a) for a in argv] or [1, 2, 4]
    from ..config import DMCConfig

    packed = os.environ.get("SSGVC_PACKED", "0") == "1"
    h, w = 1088, 1920
    card = card_line(device)
    rows, per_image = {}, None
    for b in batches:
        fps, ms = bench_batch(b, h, w, seed=seed, device=device)
        if per_image is None:
            per_image = pframe_flops(DMCConfig.variant(
                "performance", dtype="bfloat16", packed_io=packed), 1, h, w)
        tfs = per_image * fps / 1e12
        share = share_of_peak(tfs * 1e12, device)
        rows[b] = {"fps": fps, "ms_per_step": ms, "tflops": tfs,
                   "share_of_peak": share}
        print(f"batch={b}: {fps:8.1f} fps/card  {ms:7.2f} ms/step  "
              f"~{tfs:6.1f} TFLOP/s ({share_text(share)} of the H100's "
              f"{H100_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16) [{card}]",
              flush=True)
    return {"batches": rows, "flops_per_frame": per_image,
            "packed": packed, "device": card}


if __name__ == "__main__":
    main()
