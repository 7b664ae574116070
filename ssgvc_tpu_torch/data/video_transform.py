"""Augmentations of a whole clip: each transform draws its randomness once
per clip, from the caller's ``np.random.Generator``, and applies it to
every frame. Frames are (T, H, W, C) float arrays in [0, 1].
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..utils.transforms import rgb2ycbcr_np, yuv_444_to_420


class RandomCropTransform:
    """One random square crop of side ``size`` for the whole clip."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, frames: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        _, h, w, _ = frames.shape
        c = self.size
        top = int(rng.integers(0, max(1, h - c + 1)))
        left = int(rng.integers(0, max(1, w - c + 1)))
        return frames[:, top:top + c, left:left + c]


class RGBtoYUVTransform:
    """BT.709 RGB -> YCbCr; '444' keeps the shape, '420' returns (y, uv)."""

    def __init__(self, fmt: str = "444"):
        if fmt not in ("444", "420"):
            raise ValueError(f"fmt {fmt!r} is not '444' or '420'")
        self.fmt = fmt

    def __call__(self, frames: np.ndarray, rng=None):
        ycc = np.stack([rgb2ycbcr_np(f) for f in frames])
        if self.fmt == "444":
            return ycc
        ys, uvs = [], []
        for f in ycc:
            y, uv = yuv_444_to_420(f)
            ys.append(y)
            uvs.append(uv)
        return np.stack(ys), np.stack(uvs)


class RandomHorizontalFlipSequence:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, frames: np.ndarray, rng=None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        if rng.uniform() < self.p:
            return frames[:, :, ::-1].copy()
        return frames


class RandomRotationSequence:
    """A rotation by a random multiple of 90 degrees."""

    def __init__(self, quarter_turns: Sequence[int] = (0, 1, 2, 3)):
        self.quarter_turns = list(quarter_turns)

    def __call__(self, frames: np.ndarray, rng=None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        k = int(rng.choice(self.quarter_turns))
        if k == 0:
            return frames
        return np.rot90(frames, k, axes=(1, 2)).copy()


class ColorJitterSequence:
    """Brightness, contrast and saturation jitter."""

    def __init__(self, brightness: float = 0.2, contrast: float = 0.2,
                 saturation: float = 0.2):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation

    def __call__(self, frames: np.ndarray, rng=None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        b = 1.0 + rng.uniform(-self.brightness, self.brightness)
        c = 1.0 + rng.uniform(-self.contrast, self.contrast)
        s = 1.0 + rng.uniform(-self.saturation, self.saturation)
        out = frames * b
        mean = out.mean(axis=(1, 2, 3), keepdims=True)
        out = (out - mean) * c + mean
        gray = out.mean(axis=-1, keepdims=True)
        out = (out - gray) * s + gray
        return np.clip(out, 0.0, 1.0).astype(frames.dtype)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, frames, rng=None):
        for t in self.transforms:
            frames = t(frames, rng=rng)
        return frames
