"""Training clips from disk, and the data module that batches them.

  * ``WaymoClipDataset``: windows of ``seq_len`` frames per TFRecord with
    stride ``slide``; the FRONT camera's JPEG decoded, BT.709 RGB ->
    YCbCr; masks from the ``seg_cache/<tfrecord-stem>/<frame:06d>.npz``
    cache (``data/build_cache.py``; zeros where missing unless
    ``strict_masks``); one random square crop per window.
  * ``SyntheticClipDataset``: moving textured rectangles with exact masks,
    made from a seed, for when no data is on disk.
  * ``ClipDataModule``: a split by one seeded permutation of the samples,
    each rank's disjoint stride of every epoch's order.
  * ``make_datamodule``: Waymo TFRecords, the Vimeo-90k layouts or the
    synthetic clips, by ``dataset_type`` and what exists on disk.

Batches are numpy dicts {'frames': (B, T, H, W, 3), 'masks': (B, T, H, W,
1)}; ``Trainer`` moves them to its device.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..utils.transforms import rgb2ycbcr_np
from . import tfrecord, waymo_proto


def mask_cache_paths(cache_dir, tf_path, frame_idx: int) -> Tuple[Path, Path]:
    base = Path(tf_path).stem
    d = Path(cache_dir) / base
    return d / f"{frame_idx:06d}.npz", d / f"{frame_idx:06d}.png"


def load_cached_mask(cache_dir, tf_path, frame_idx: int, h: int, w: int,
                     strict: bool) -> np.ndarray:
    """(H, W, 1) float {0,1} from .npz ('mask' uint8) or .png; zeros if
    missing and not strict."""
    p_npz, p_png = mask_cache_paths(cache_dir, tf_path, frame_idx)
    if p_npz.exists():
        data = np.load(p_npz, allow_pickle=False)
        if "mask" not in data:
            raise FileNotFoundError(f"NPZ without 'mask': {p_npz}")
        m = np.asarray(data["mask"], np.uint8)
        if m.shape != (h, w):
            raise ValueError(f"mask shape {m.shape} != image {(h, w)} at {p_npz}")
        return m.astype(np.float32)[..., None]
    if p_png.exists():
        from PIL import Image
        m8 = np.asarray(Image.open(p_png).convert("L"))
        if m8.shape != (h, w):
            raise ValueError(f"mask shape {m8.shape} != image {(h, w)} at {p_png}")
        return (m8 > 127).astype(np.float32)[..., None]
    if strict:
        raise FileNotFoundError(f"mask missing: {p_npz} | {p_png}")
    return np.zeros((h, w, 1), np.float32)


class WaymoClipDataset:
    """Clip windows over TFRecords; __getitem__ -> (frames, masks) NHWC."""

    def __init__(self, tfrecord_paths, seg_cache_dir: str = "seg_cache",
                 seq_len: int = 4, slide: int = 1,
                 crop_size: Optional[int] = 128, strict_masks: bool = False,
                 return_proj: bool = False, proj_mode: str = "occupancy"):
        if isinstance(tfrecord_paths, str):
            tfrecord_paths = sorted(glob.glob(tfrecord_paths))
        self.paths: List[str] = list(tfrecord_paths)
        if not self.paths:
            raise ValueError("No TFRecord files found.")
        self.seg_cache_dir = seg_cache_dir
        self.seq_len = int(seq_len)
        self.slide = int(slide)
        self.crop_size = int(crop_size) if crop_size else None
        self.strict_masks = strict_masks
        self.return_proj = return_proj
        self.proj_mode = proj_mode  # 'occupancy' | 'legacy3' (data/lidar.py)

        self._offsets: Dict[str, List[int]] = {
            p: tfrecord.record_offsets(p) for p in self.paths}
        self._index: List[Tuple[str, int]] = []
        for p in self.paths:
            total = len(self._offsets[p])
            if total >= self.seq_len:
                self._index.extend(
                    (p, s) for s in range(0, total - self.seq_len + 1, self.slide))
        if not self._index:
            raise ValueError("No clip windows (check seq_len/slide).")

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        tf_path, start = self._index[idx]
        offsets = self._offsets[tf_path]

        frames, masks, projs = [], [], []
        with open(tf_path, "rb") as f:
            for frame_idx in range(start, start + self.seq_len):
                payload = tfrecord.read_record_at(f, offsets[frame_idx])
                jpeg = waymo_proto.parse_front_jpeg(payload)
                if jpeg is None:
                    raise RuntimeError(f"no FRONT image in {tf_path}@{frame_idx}")
                rgb = waymo_proto.decode_jpeg(jpeg).astype(np.float32) / 255.0
                h, w = rgb.shape[:2]
                mask = load_cached_mask(self.seg_cache_dir, tf_path, frame_idx,
                                        h, w, self.strict_masks)
                frames.append(np.clip(rgb2ycbcr_np(rgb), 0.0, 1.0))
                masks.append(mask)
                if self.return_proj:
                    from .lidar import project_top_lidar
                    projs.append(project_top_lidar(payload, h, w,
                                                   mode=self.proj_mode))

        frames = np.stack(frames)  # (T, H, W, 3)
        masks = np.stack(masks)    # (T, H, W, 1)
        projs = np.stack(projs) if projs else None
        if self.crop_size is not None:
            t_, h, w, _ = frames.shape
            c = self.crop_size
            if c > h or c > w:
                raise ValueError(f"crop {c} exceeds image {(h, w)}")
            top = int(rng.integers(0, h - c + 1))
            left = int(rng.integers(0, w - c + 1))
            frames = frames[:, top:top + c, left:left + c]
            masks = masks[:, top:top + c, left:left + c]
            if projs is not None:
                projs = projs[:, top:top + c, left:left + c]
        if self.return_proj:
            return frames, masks, projs
        return frames, masks


class SyntheticClipDataset:
    """Deterministic moving-rectangle clips with exact masks (no files).

    Frame = smooth noise background + 1-3 textured moving rectangles;
    mask = union of the rectangles, mimicking the vehicle/person masks the
    YOLO cache provides on Waymo.
    """

    def __init__(self, num_clips: int = 64, seq_len: int = 4,
                 crop_size: int = 128, seed: int = 0,
                 texture: str = "noise", roi_subset: bool = False):
        self.num_clips = num_clips
        self.seq_len = seq_len
        self.size = crop_size
        self.seed = seed
        # roi_subset mimics build_cache's class filter: every object is
        # painted, but only a random subset (always object 0) enters the
        # mask, so the mask carries information the pixels do not
        self.roi_subset = roi_subset
        # 'noise' keeps uniform-noise object textures (hard: incompressible,
        # reconstruction hits the model's capacity floor so PSNR barely moves
        # with rate). 'smooth' uses low-frequency gradients + edges —
        # compressible detail that lets RD curves actually trade and QP
        # sweeps separate in PSNR.
        self.texture = texture

    def __len__(self):
        return self.num_clips

    def _object_texture(self, g, oh: int, ow: int) -> np.ndarray:
        if self.texture == "smooth":
            yy = np.linspace(0, 1, oh, dtype=np.float32)[:, None, None]
            xx = np.linspace(0, 1, ow, dtype=np.float32)[None, :, None]
            f = g.uniform(1.0, 4.0, (2, 3)).astype(np.float32)
            ph = g.uniform(0, 2 * np.pi, (2, 3)).astype(np.float32)
            tex = (0.5 + 0.25 * np.sin(2 * np.pi * f[0] * yy + ph[0])
                   + 0.25 * np.sin(2 * np.pi * f[1] * xx + ph[1]))
            # one sharp edge per object keeps some high-frequency content
            edge = int(g.integers(1, max(ow - 1, 2)))
            tex[:, edge:] = np.clip(tex[:, edge:] * 0.5 + 0.25, 0, 1)
            return np.clip(tex, 0.0, 1.0).astype(np.float32)
        return g.uniform(0, 1, (oh, ow, 3)).astype(np.float32)

    def __getitem__(self, idx: int, rng=None):
        s = self.size
        g = np.random.default_rng(self.seed * 100003 + idx)
        base = g.uniform(0.2, 0.8, (s // 8, s // 8, 3)).astype(np.float32)
        background = np.repeat(np.repeat(base, 8, 0), 8, 1)
        n_obj = int(g.integers(1, 4))
        objs = []
        for _ in range(n_obj):
            oh, ow = int(g.integers(s // 8, s // 3)), int(g.integers(s // 8, s // 3))
            tex = self._object_texture(g, oh, ow)
            x0, y0 = int(g.integers(0, s - ow)), int(g.integers(0, s - oh))
            vx, vy = int(g.integers(-4, 5)), int(g.integers(-4, 5))
            objs.append([tex, x0, y0, vx, vy, True])
        if self.roi_subset:
            # flags drawn AFTER all object draws: painted frames stay
            # bit-identical to roi_subset=False for the same seed (tested)
            for i, obj in enumerate(objs):
                obj[5] = i == 0 or bool(g.random() < 0.5)

        frames, masks = [], []
        for t in range(self.seq_len):
            frame = background.copy()
            mask = np.zeros((s, s, 1), np.float32)
            for tex, x0, y0, vx, vy, in_roi in objs:
                oh, ow = tex.shape[:2]
                x = np.clip(x0 + vx * t, 0, s - ow)
                y = np.clip(y0 + vy * t, 0, s - oh)
                frame[y:y + oh, x:x + ow] = tex
                if in_roi:
                    mask[y:y + oh, x:x + ow] = 1.0
            frames.append(np.clip(rgb2ycbcr_np(frame), 0.0, 1.0))
            masks.append(mask)
        return np.stack(frames), np.stack(masks)


class ClipDataModule:
    """The train / val / test split of ``dataset`` by one permutation seeded
    by ``seed``, and the batch iterators."""

    def __init__(self, dataset, batch_size: int = 4,
                 split=(0.9, 0.1, 0.0), seed: int = 42,
                 rank: int = 0, world: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        n = len(dataset)
        perm = np.random.default_rng(seed).permutation(n)
        n_train = int(round(split[0] * n))
        n_val = int(round(split[1] * n))
        self.train_indices = perm[:n_train]
        self.val_indices = perm[n_train:n_train + n_val]
        self.test_indices = perm[n_train + n_val:]
        self.seed = seed
        # data parallelism with torch DistributedSampler's semantics: each
        # rank iterates a disjoint 1/world stride of every epoch's order,
        # wrap-padded so all ranks take equally many steps; batch_size is
        # the per-rank batch
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} not in [0, {world})")
        self.rank = rank
        self.world = world

    def steps_per_epoch(self) -> int:
        per_host = -(-len(self.train_indices) // self.world)
        return max(1, per_host // self.batch_size)

    def _iter(self, indices: np.ndarray, shuffle: bool, loop: bool,
              seed: int) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(seed)
        if len(indices) == 0:
            return
        epoch = 0
        while True:
            order = rng.permutation(indices) if shuffle else indices
            if self.world > 1:
                # the same seed on every rank -> the same permutation -> the
                # strided shards are disjoint; np.resize wrap-pads so each
                # rank gets exactly ceil(n/world) samples
                per_host = -(-len(order) // self.world)
                order = np.resize(order, per_host * self.world)[
                    self.rank::self.world]
            if len(order) < self.batch_size:
                # splits smaller than a batch: sample with replacement so the
                # iterator still yields full (static-shape) batches
                order = rng.choice(order, size=self.batch_size, replace=True)
            for i in range(0, len(order) - self.batch_size + 1, self.batch_size):
                chunk = order[i:i + self.batch_size]
                frames, masks = [], []
                for j in chunk:
                    f, m = self.dataset.__getitem__(int(j), rng=rng)
                    frames.append(f)
                    masks.append(m)
                yield {"frames": np.stack(frames), "masks": np.stack(masks)}
            epoch += 1
            if not loop:
                return

    def train_iter(self, loop: bool = True):
        return self._iter(self.train_indices, shuffle=True, loop=loop,
                          seed=self.seed)

    def val_iter(self, loop: bool = False):
        return self._iter(self.val_indices, shuffle=False, loop=loop,
                          seed=self.seed + 1)


class _SingleImageClipShim:
    """A single-image dataset as T=1 clips with zero masks."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, idx, rng=None):
        img = self.ds.__getitem__(idx, rng=rng)
        frames = img[None]
        return frames, np.zeros(frames.shape[:3] + (1,), np.float32)


def _make_vimeo(dtype: str, ds_cfg, seq_len: int, crop: int):
    """The Vimeo-90k dataset of ``dtype``: vimeo_septuplet (an mp4 per
    sequence), vimeo / vimeo_image (7-PNG), vimeo_mp4 (a flat directory,
    split files written when missing), vimeo_single_image. None when
    nothing exists on disk (the caller then takes synthetic clips)."""
    from .vimeo import (Vimeo90kDataset, Vimeo90kImageDataset,
                        Vimeo90kMP4Dataset, Vimeo90kSeptupletDataset)

    root = ds_cfg.data_dir
    try:
        if dtype == "vimeo_septuplet":
            # septuplets are 7 frames: clamp, as the 7-PNG branch does
            return Vimeo90kSeptupletDataset(root, n_frames=min(seq_len, 7),
                                            crop_size=crop)
        if dtype == "vimeo_mp4":
            return Vimeo90kMP4Dataset(
                root, crop_size=crop, n_frames=seq_len,
                generate_split=True,
                train_split=getattr(ds_cfg, "train_split", 0.8),
                use_cache=getattr(ds_cfg, "use_cache", True))
        if dtype == "vimeo_single_image":
            return _SingleImageClipShim(
                Vimeo90kImageDataset(root, crop_size=crop))
        # 'vimeo' / 'vimeo_image': the canonical 7-PNG layout
        if os.path.isdir(os.path.join(root, "sequences")):
            return Vimeo90kDataset(root, seq_len=min(seq_len, 7),
                                   crop_size=crop)
    except (FileNotFoundError, RuntimeError, ValueError) as e:
        print(f"[data] vimeo dataset unavailable ({e}); "
              f"falling back to synthetic")
    return None


def make_datamodule(cfg, rank: int = 0, world: int = 1) -> ClipDataModule:
    """The data module of ``cfg`` (a TrainConfig or its DatasetConfig):
    Waymo TFRecords under ``data_dir``, a Vimeo-90k layout, or synthetic
    clips when ``synthetic`` is set or nothing exists on disk."""
    ds_cfg = cfg.dataset if hasattr(cfg, "dataset") else cfg
    crop = ds_cfg.crop_size or (
        ds_cfg.crop[0] if isinstance(ds_cfg.crop, (list, tuple)) else 128)
    seq_len = ds_cfg.seq_len or ds_cfg.n_frames
    dtype = getattr(ds_cfg, "dataset_type", "waymo")

    dataset = None
    if not ds_cfg.synthetic:
        if dtype.startswith("vimeo"):
            dataset = _make_vimeo(dtype, ds_cfg, seq_len, crop)
        else:
            paths = sorted(glob.glob(os.path.join(ds_cfg.data_dir,
                                                  "*.tfrecord")))
            if paths:
                dataset = WaymoClipDataset(
                    paths, seg_cache_dir=ds_cfg.seg_cache_dir,
                    seq_len=seq_len, slide=ds_cfg.slide, crop_size=crop,
                    strict_masks=ds_cfg.strict_masks)
    if dataset is None:
        dataset = SyntheticClipDataset(
            num_clips=ds_cfg.synthetic_num_clips, seq_len=seq_len,
            crop_size=crop)
    return ClipDataModule(dataset, batch_size=ds_cfg.batch_size,
                          split=tuple(ds_cfg.train_val_test_split),
                          seed=getattr(cfg, "seed", 42),
                          rank=rank, world=world)
