"""Synthetic clips made on the caller's device: the JAX package's
``data/device_synth.py`` in torch, the same distribution (not the same
bits), drawn from a ``torch.Generator``.

  * background: uniform(0.2, 0.8) at s/8 resolution, nearest-upsampled 8x;
  * 1-3 objects; sizes uniform in [s/8, s/3); integer velocities in
    [-4, 4]; each object's texture two low-frequency sin gradients and one
    sharp vertical edge;
  * mask = the union of the object rectangles (``roi_subset``: object 0
    and each other object with probability 1/2, painted either way);
  * frames BT.709 YCbCr in [0, 1].

The geometry is broadcast over (batch, object) with static shapes; every
draw is one call for the whole batch.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from ..utils.transforms import KB, KG, KR

MAX_OBJ = 3


def rgb2ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0, 1] -> BT.709 YCbCr, chroma offset +0.5."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = KR * r + KG * g + KB * b
    cb = 0.5 * (b - y) / (1.0 - KB) + 0.5
    cr = 0.5 * (r - y) / (1.0 - KR) + 0.5
    return torch.stack([y, cb, cr], dim=-1)


def _uniform(shape, generator, device, lo=0.0, hi=1.0) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                       device=device)


def _randint(shape, lo: int, hi: int, generator, device) -> torch.Tensor:
    """Integers in [lo, hi), as float32."""
    return torch.randint(lo, hi, shape, generator=generator,
                         device=device).float()


def synth_batch(generator: torch.Generator, batch: int = 8, size: int = 128,
                seq_len: int = 4, roi_subset: bool = False,
                device=None) -> Dict[str, torch.Tensor]:
    """A batch of fresh clips: {"frames": (B, T, s, s, 3) YCbCr float32,
    "masks": (B, T, s, s, 1)}, the layout the trainer takes. ``device``
    defaults to the generator's."""
    dev = torch.device(device) if device is not None else generator.device
    g, s, n = generator, size, batch
    bg = _uniform((n, s // 8, s // 8, 3), g, dev, 0.2, 0.8)
    background = bg.repeat_interleave(8, 1).repeat_interleave(8, 2)
    n_obj = torch.randint(1, MAX_OBJ + 1, (n, 1), generator=g, device=dev)
    roi = torch.ones((n, MAX_OBJ), device=dev)
    if roi_subset:
        roi[:, 1:] = (torch.rand((n, MAX_OBJ - 1), generator=g, device=dev)
                      < 0.5).float()
    # geometry, (B, MAX_OBJ) each
    wh = _uniform((n, MAX_OBJ, 2), g, dev, s / 8, s / 3)
    oh, ow = torch.floor(wh[..., 0]), torch.floor(wh[..., 1])
    pos = _uniform((n, MAX_OBJ, 2), g, dev)
    x0 = torch.floor(pos[..., 0] * (s - ow))
    y0 = torch.floor(pos[..., 1] * (s - oh))
    vel = _randint((n, MAX_OBJ, 2), -4, 5, g, dev)
    painted = torch.arange(MAX_OBJ, device=dev)[None] < n_obj
    # texture: frequencies and phases (2 axes x 3 colours), the edge
    freq = _uniform((n, MAX_OBJ, 2, 3), g, dev, 1.0, 4.0)
    phase = _uniform((n, MAX_OBJ, 2, 3), g, dev, 0.0, 2.0 * math.pi)
    edge = _uniform((n, MAX_OBJ), g, dev, 0.1, 0.9)

    yy = torch.arange(s, dtype=torch.float32, device=dev).reshape(1, s, 1, 1)
    xx = torch.arange(s, dtype=torch.float32, device=dev).reshape(1, 1, s, 1)
    col = lambda t: t.reshape(n, 1, 1, -1)      # (B,) or (B, 3) -> NHWC
    frames, masks = [], []
    for t in range(seq_len):
        frame = background
        mask = torch.zeros((n, s, s, 1), device=dev)
        for k in range(MAX_OBJ):
            h_, w_ = oh[:, k], ow[:, k]
            x = torch.minimum(torch.clamp(x0[:, k] + vel[:, k, 0] * t,
                                          min=0), s - w_)
            y = torch.minimum(torch.clamp(y0[:, k] + vel[:, k, 1] * t,
                                          min=0), s - h_)
            inside = ((yy >= col(y)) & (yy < col(y + h_)) & (xx >= col(x))
                      & (xx < col(x + w_)) & col(painted[:, k]))
            yn = torch.clamp((yy - col(y)) / col(torch.clamp(h_ - 1, min=1)),
                             0, 1)
            xn = torch.clamp((xx - col(x)) / col(torch.clamp(w_ - 1, min=1)),
                             0, 1)
            tex = (0.5 + 0.25 * torch.sin(2 * math.pi * col(freq[:, k, 0])
                                          * yn + col(phase[:, k, 0]))
                   + 0.25 * torch.sin(2 * math.pi * col(freq[:, k, 1]) * xn
                                      + col(phase[:, k, 1])))
            tex = torch.where(xn >= col(edge[:, k]), tex * 0.5 + 0.25, tex)
            frame = torch.where(inside, torch.clamp(tex, 0, 1), frame)
            mask = torch.where(inside & col(roi[:, k] > 0),
                               torch.ones_like(mask), mask)
        frames.append(torch.clamp(rgb2ycbcr(frame), 0, 1))
        masks.append(mask)
    return {"frames": torch.stack(frames, 1), "masks": torch.stack(masks, 1)}


def sample_qp(generator: torch.Generator,
              eval_qps: Sequence[int] = (8, 20, 32, 44, 56),
              device: Optional[torch.device] = None) -> int:
    """A training QP: 55% within +-3 of an eval QP, 25% uniform over [0, 64),
    20% at the ladder's ends ([0, 8) or [56, 64)); clipped to [0, 63]."""
    dev = device if device is not None else generator.device
    r = lambda hi: int(torch.randint(0, hi, (1,), generator=generator,
                                     device=dev))
    u = float(torch.rand((1,), generator=generator, device=dev))
    near = eval_qps[r(len(eval_qps))] + r(7) - 3
    uniform = r(64)
    lo_end = r(8)
    extreme = lo_end if float(torch.rand((1,), generator=generator,
                                         device=dev)) < 0.5 else 63 - lo_end
    qp = near if u < 0.55 else (uniform if u < 0.80 else extreme)
    return min(max(qp, 0), 63)
