"""The segmentation-mask cache: for every frame of every TFRecord, the FRONT
camera's JPEG is decoded and segmented, the instance masks of the kept
classes (COCO 0 person, 2 car, 5 bus by default) are united, cleaned
(threshold 0.5, connected components under ``min_area`` pixels dropped, a
3x3 binary opening) and written atomically as
``<cache_dir>/<tfrecord-stem>/<frame:06d>.npz`` ({"mask": uint8}). Files
that exist are skipped unless ``overwrite``, so a build that was cut off
resumes.

The segmenter is any callable ``rgb_uint8 -> [(soft_mask_f32, class)]``;
``make_yolo_segmenter`` builds ultralytics' YOLOv8-seg, which needs the
``ultralytics`` package and its weights.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from . import tfrecord, waymo_proto

DEFAULT_CLASSES_KEEP = (0, 2, 5)  # COCO person, car, bus


def _morph_open(mask: np.ndarray, k: int = 3) -> np.ndarray:
    """Binary opening (erosion then dilation) with a k x k ones kernel."""
    from numpy.lib.stride_tricks import sliding_window_view

    pad = k // 2

    def erode(m):
        p = np.pad(m, pad, mode="constant", constant_values=1)
        return sliding_window_view(p, (k, k)).min(axis=(2, 3))

    def dilate(m):
        p = np.pad(m, pad, mode="constant", constant_values=0)
        return sliding_window_view(p, (k, k)).max(axis=(2, 3))

    return dilate(erode(mask))


def _connected_components_area_filter(mask: np.ndarray,
                                      min_area: int) -> np.ndarray:
    """Drop the 4-connected components smaller than ``min_area`` (a flood
    fill from each unvisited pixel)."""
    h, w = mask.shape
    seen = np.zeros_like(mask, bool)
    out = np.zeros_like(mask)
    ys, xs = np.nonzero(mask)
    for y0, x0 in zip(ys, xs):
        if seen[y0, x0]:
            continue
        stack = [(y0, x0)]
        comp = []
        seen[y0, x0] = True
        while stack:
            y, x = stack.pop()
            comp.append((y, x))
            for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ny, nx = y + dy, x + dx
                if (0 <= ny < h and 0 <= nx < w and mask[ny, nx]
                        and not seen[ny, nx]):
                    seen[ny, nx] = True
                    stack.append((ny, nx))
        if len(comp) >= min_area:
            for y, x in comp:
                out[y, x] = 1
    return out


def union_instance_masks(instances: Iterable[Tuple[np.ndarray, int]],
                         shape: Tuple[int, int],
                         classes_keep: Sequence[int] = DEFAULT_CLASSES_KEEP,
                         thresh: float = 0.5, min_area: int = 64,
                         morph_kernel: int = 3) -> np.ndarray:
    """Per-instance soft masks -> one clean binary uint8 mask of ``shape``
    (a mask of another size is resized to it first)."""
    union = np.zeros(shape, np.float32)
    for soft_mask, cls in instances:
        if classes_keep and int(cls) not in classes_keep:
            continue
        if soft_mask.shape != shape:
            from PIL import Image
            soft_mask = np.asarray(
                Image.fromarray((soft_mask * 255).astype(np.uint8))
                .resize((shape[1], shape[0]))) / 255.0
        union = np.maximum(union, soft_mask.astype(np.float32))
    binary = (union > thresh).astype(np.uint8)
    if binary.any() and min_area > 0:
        binary = _connected_components_area_filter(binary, min_area)
    if binary.any() and morph_kernel > 1:
        binary = _morph_open(binary, morph_kernel).astype(np.uint8)
    return binary


def atomic_save_npz(path: Path, mask: np.ndarray):
    """Write to a temporary name, then rename: a reader never sees a
    partial file."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp.npz")
    np.savez_compressed(tmp, mask=mask.astype(np.uint8))
    os.replace(tmp, path)


def make_yolo_segmenter(weights: str = "yolov8x-seg.pt", imgsz: int = 640,
                        conf: float = 0.25, iou: float = 0.7) -> Callable:
    """ultralytics' YOLOv8-seg as a segmenter; raises when ultralytics is
    not installed."""
    try:
        from ultralytics import YOLO
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "ultralytics is not installed; pass a segmenter callable to "
            "build_cache instead") from e
    model = YOLO(weights)

    def segment(rgb: np.ndarray) -> List[Tuple[np.ndarray, int]]:
        res = model.predict(rgb, imgsz=imgsz, conf=conf, iou=iou,
                            verbose=False)
        out = []
        for r in res:
            if r.masks is None:
                continue
            for m, cls in zip(r.masks.data.cpu().numpy(),
                              r.boxes.cls.cpu().numpy()):
                out.append((m, int(cls)))
        return out

    return segment


def build_cache(tf_glob, cache_dir: str = "seg_cache",
                segmenter: Optional[Callable] = None,
                classes_keep: Sequence[int] = DEFAULT_CLASSES_KEEP,
                thresh: float = 0.5, min_area: int = 64,
                overwrite: bool = False, max_frames: Optional[int] = None):
    """Fill the mask cache for every frame of every TFRecord that
    ``tf_glob`` (a glob pattern or a list of paths) names. Returns
    {"written": n, "skipped": n}."""
    import glob as _glob

    if segmenter is None:
        segmenter = make_yolo_segmenter()
    paths = (sorted(_glob.glob(tf_glob)) if isinstance(tf_glob, str)
             else list(tf_glob))
    n_done = n_skip = 0
    for tf_path in paths:
        stem = Path(tf_path).stem
        for frame_idx, payload in enumerate(tfrecord.read_records(tf_path)):
            if max_frames is not None and frame_idx >= max_frames:
                break
            out_path = Path(cache_dir) / stem / f"{frame_idx:06d}.npz"
            if out_path.exists() and not overwrite:
                n_skip += 1
                continue
            jpeg = waymo_proto.parse_front_jpeg(payload)
            if jpeg is None:
                continue
            rgb = waymo_proto.decode_jpeg(jpeg)
            instances = segmenter(rgb)
            mask = union_instance_masks(instances, rgb.shape[:2],
                                        classes_keep, thresh, min_area)
            atomic_save_npz(out_path, mask)
            n_done += 1
    return {"written": n_done, "skipped": n_skip}
