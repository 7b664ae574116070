"""Frame IO: PNG sequences and raw YUV420 planar files, with numpy and
Pillow only.

PNG directories use the ``im%05d.png`` naming (im00001.png, ...), frames
are float RGB in [0, 1]; YUV files are 8-bit planar 4:2:0 (Y, then U, then
V), read and written as (y (H, W), uv (H/2, W/2, 2)) in [0, 1]. Values are
quantized to 8 bits as round(v * 255) with halves up, clipped to [0, 255].
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def _to_u8(a: np.ndarray) -> np.ndarray:
    return np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)


class PNGReader:
    """Reads im00001.png, im00002.png, ... as float RGB in [0, 1]; None
    after the last."""

    def __init__(self, directory: str, start: int = 1):
        self.directory = directory
        self.idx = start

    def read_one_frame(self) -> Optional[np.ndarray]:
        from PIL import Image

        path = os.path.join(self.directory, f"im{self.idx:05d}.png")
        if not os.path.exists(path):
            return None
        self.idx += 1
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"), np.float32) / 255.0


class PNGWriter:
    """Writes float RGB frames in [0, 1] as im00001.png, im00002.png, ..."""

    def __init__(self, directory: str, start: int = 1):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.idx = start

    def write_one_frame(self, rgb: np.ndarray) -> None:
        from PIL import Image

        path = os.path.join(self.directory, f"im{self.idx:05d}.png")
        self.idx += 1
        Image.fromarray(_to_u8(rgb)).save(path)


class YUV420Reader:
    """Raw planar YUV420 8-bit frames as (y, uv) in [0, 1]; None after the
    last whole frame."""

    def __init__(self, path: str, height: int, width: int):
        self.f = open(path, "rb")
        self.h, self.w = height, width

    def read_one_frame(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        h, w = self.h, self.w
        n_y, n_c = h * w, (h // 2) * (w // 2)
        buf = self.f.read(n_y + 2 * n_c)
        if len(buf) < n_y + 2 * n_c:
            return None
        arr = np.frombuffer(buf, np.uint8)
        y = arr[:n_y].reshape(h, w).astype(np.float32) / 255.0
        u = arr[n_y:n_y + n_c].reshape(h // 2, w // 2)
        v = arr[n_y + n_c:].reshape(h // 2, w // 2)
        uv = np.stack([u, v], axis=-1).astype(np.float32) / 255.0
        return y, uv

    def close(self) -> None:
        self.f.close()


class YUV420Writer:
    """Appends (y, uv) frames in [0, 1] to a raw planar YUV420 8-bit
    file."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.f = open(path, "wb")

    def write_one_frame(self, y: np.ndarray, uv: np.ndarray) -> None:
        for plane in (y, uv[..., 0], uv[..., 1]):
            self.f.write(_to_u8(plane).tobytes())

    def close(self) -> None:
        self.f.close()
