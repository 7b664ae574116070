"""Vimeo-90k datasets: the 7-PNG septuplets (``Vimeo90kDataset``), single
frames of them (``Vimeo90kImageDataset``), MP4 clips in a flat directory or
under ``sequences_mp4/`` (``Vimeo90kMP4Dataset``), one MP4 per septuplet
(``Vimeo90kSeptupletDataset``), and the split-file and frame-count helpers.
Each item is (frames (T, H, W, 3) YCbCr float32, masks (T, H, W, 1) zeros).

PNG layout: <root>/sequences/<seq>/<subseq>/im1.png..im7.png with the
sep_trainlist.txt / sep_testlist.txt split files. MP4s decode through cv2,
else av, else imageio with pyav, whichever imports first.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..utils.transforms import rgb2ycbcr_np


def _read_split_file(root: str, name: str) -> Optional[List[str]]:
    path = os.path.join(root, name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def _list_sequences(root: str) -> List[str]:
    seq_dir = os.path.join(root, "sequences")
    out = []
    if not os.path.isdir(seq_dir):
        return out
    for a in sorted(os.listdir(seq_dir)):
        pa = os.path.join(seq_dir, a)
        if not os.path.isdir(pa):
            continue
        for b in sorted(os.listdir(pa)):
            if os.path.isdir(os.path.join(pa, b)):
                out.append(f"{a}/{b}")
    return out


class Vimeo90kDataset:
    """7-PNG septuplets -> (frames (T, H, W, 3) YCbCr, masks zeros)."""

    def __init__(self, root: str, split: str = "train", seq_len: int = 7,
                 crop_size: Optional[int] = 128, to_ycbcr: bool = True):
        self.root = root
        self.seq_len = seq_len
        self.crop_size = crop_size
        self.to_ycbcr = to_ycbcr
        split_file = ("sep_trainlist.txt" if split == "train"
                      else "sep_testlist.txt")
        self.sequences = (_read_split_file(root, split_file)
                          or _list_sequences(root))
        if not self.sequences:
            raise ValueError(f"No Vimeo sequences under {root}")

    def __len__(self):
        return len(self.sequences)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        from PIL import Image

        rng = rng or np.random.default_rng()
        seq = self.sequences[idx]
        frames = []
        for i in range(1, self.seq_len + 1):
            path = os.path.join(self.root, "sequences", seq, f"im{i}.png")
            rgb = np.asarray(Image.open(path).convert("RGB"),
                             np.float32) / 255.0
            frames.append(rgb2ycbcr_np(rgb) if self.to_ycbcr else rgb)
        frames = np.stack(frames)
        if self.crop_size:
            t_, h, w, _ = frames.shape
            c = self.crop_size
            top = int(rng.integers(0, max(1, h - c + 1)))
            left = int(rng.integers(0, max(1, w - c + 1)))
            frames = frames[:, top:top + c, left:left + c]
        masks = np.zeros(frames.shape[:3] + (1,), np.float32)
        return frames, masks


class Vimeo90kImageDataset:
    """Random single frames from septuplets (for intra-model training)."""

    def __init__(self, root: str, split: str = "train",
                 crop_size: Optional[int] = 256, to_ycbcr: bool = True):
        self._seq = Vimeo90kDataset(root, split, seq_len=7,
                                    crop_size=crop_size, to_ycbcr=to_ycbcr)

    def __len__(self):
        return len(self._seq)

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        frames, _ = self._seq.__getitem__(idx, rng=rng)
        return frames[int(rng.integers(0, frames.shape[0]))]


class Vimeo90kMP4Dataset:
    """MP4 clips, in two layouts:

      * ``sequences_mp4/<seq>.mp4`` with '<a>/<b>'-style split entries
      * a flat directory of mp4s whose split
        entries are plain filenames — ``generate_split=True`` writes the
        sep_trainlist/sep_testlist files when missing
        (:func:`generate_train_test_split`), and ``use_cache`` keeps a
        filename->frame-count cache so short clips are filtered without
        re-opening every container.

    ``n_frames``: a random window of that length; None returns the whole
    clip."""

    def __init__(self, root: str, split: str = "train",
                 crop_size: Optional[int] = 256, to_ycbcr: bool = True,
                 n_frames: Optional[int] = None,
                 generate_split: bool = False, train_split: float = 0.8,
                 use_cache: bool = True):
        self.decode = _find_mp4_decoder()
        self.root = root
        self.crop_size = crop_size
        self.to_ycbcr = to_ycbcr
        self.n_frames = n_frames
        list_file = os.path.join(
            root, "sep_trainlist.txt" if split == "train"
            else "sep_testlist.txt")
        if not os.path.exists(list_file) and generate_split:
            generate_train_test_split(root, train_split)
        with open(list_file) as f:
            names = [ln.strip() for ln in f if ln.strip()]
        self.paths = [
            os.path.join(root, n) if n.lower().endswith(".mp4")
            else os.path.join(root, "sequences_mp4", n + ".mp4")
            for n in names]
        if n_frames and use_cache:
            cache = os.path.join(root, "video_frames_cache.txt")
            info = load_video_frames_info(cache)
            # keys are paths relative to root: basenames collide in the
            # nested sequences_mp4/<a>/<b>.mp4 layout, and counting ONLY the
            # missing entries (merged with the loaded cache) keeps the two
            # splits from evicting each other's rows
            key = lambda p: os.path.relpath(p, root)
            missing = [p for p in self.paths if key(p) not in info]
            if missing:
                info = cache_video_frames_info(missing, cache, root=root,
                                               existing=info)
            self.paths = [p for p in self.paths
                          if info.get(key(p), 0) >= n_frames]
        if not self.paths:
            raise RuntimeError(
                f"no mp4 clips with >= {n_frames or 1} frames under {root} "
                f"(split file {os.path.basename(list_file)})")

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int,
                    rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        frames = self.decode(self.paths[idx])  # (T, H, W, 3) uint8 RGB
        frames = frames.astype(np.float32) / 255.0
        if self.n_frames:
            total = frames.shape[0]
            if total < self.n_frames:
                raise RuntimeError(f"{self.paths[idx]} has {total} frames "
                                   f"< {self.n_frames}")
            start = int(rng.integers(0, total - self.n_frames + 1))
            frames = frames[start:start + self.n_frames]
        if self.to_ycbcr:
            frames = np.stack([np.clip(rgb2ycbcr_np(f), 0.0, 1.0)
                               for f in frames])
        if self.crop_size:
            c = self.crop_size
            t_, h, w, _ = frames.shape
            if h < c or w < c:
                raise ValueError(
                    f"clip {self.paths[idx]} is {h}x{w}, smaller than "
                    f"crop_size={c}; resize the video or lower crop_size")
            top = int(rng.integers(0, max(h - c, 0) + 1))
            left = int(rng.integers(0, max(w - c, 0) + 1))
            frames = frames[:, top:top + c, left:left + c]
        masks = np.zeros(frames.shape[:3] + (1,), np.float32)
        return frames, masks


class Vimeo90kSeptupletDataset:
    """One MP4 per septuplet: layout
    ``<root>/sequences/<a>/<b>/<b>.mp4`` with sep_trainlist/sep_testlist
    split files; each item decodes a random ``n_frames`` window."""

    def __init__(self, root: str, split: str = "train", n_frames: int = 7,
                 crop_size: Optional[int] = 128, to_ycbcr: bool = True):
        self.decode = _find_mp4_decoder()
        self.root = root
        self.n_frames = n_frames
        self.crop_size = crop_size
        self.to_ycbcr = to_ycbcr
        names = _read_split_file(
            root, "sep_trainlist.txt" if split == "train"
            else "sep_testlist.txt")
        if names is None:
            raise FileNotFoundError(
                f"no sep_{split}list file under {root} "
                f"(generate_train_test_split can create one)")
        self.paths = []
        for seq in names:  # '00001/0010' -> sequences/00001/0010/0010.mp4
            base = os.path.basename(seq)
            p = os.path.join(root, "sequences", seq, base + ".mp4")
            if os.path.exists(p):
                self.paths.append(p)
        if not self.paths:
            raise RuntimeError(f"no septuplet mp4 files under {root}")

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int,
                    rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        frames = self.decode(self.paths[idx]).astype(np.float32) / 255.0
        total = frames.shape[0]
        if total < self.n_frames:
            raise RuntimeError(
                f"{self.paths[idx]} has {total} frames < {self.n_frames}")
        start = int(rng.integers(0, total - self.n_frames + 1))
        frames = frames[start:start + self.n_frames]
        if self.to_ycbcr:
            frames = np.stack([np.clip(rgb2ycbcr_np(f), 0.0, 1.0)
                               for f in frames])
        if self.crop_size:
            c = self.crop_size
            t_, h, w, _ = frames.shape
            if h < c or w < c:
                raise ValueError(
                    f"clip {self.paths[idx]} is {h}x{w}, smaller than "
                    f"crop_size={c}; resize the video or lower crop_size")
            top = int(rng.integers(0, h - c + 1))
            left = int(rng.integers(0, w - c + 1))
            frames = frames[:, top:top + c, left:left + c]
        masks = np.zeros(frames.shape[:3] + (1,), np.float32)
        return frames, masks


def generate_train_test_split(video_dir: str, train_split: float = 0.8,
                              train_filename: str = "sep_trainlist.txt",
                              test_filename: str = "sep_testlist.txt",
                              seed: int = 42):
    """Write sep_trainlist/sep_testlist from the mp4 files in ``video_dir``:
    a shuffle seeded by ``seed``, ``train_split`` of them to the train
    file."""
    files = sorted(f for f in os.listdir(video_dir)
                   if f.lower().endswith(".mp4"))
    rng = np.random.default_rng(seed)
    files = [files[i] for i in rng.permutation(len(files))]
    cut = int(len(files) * train_split)
    train, test = files[:cut], files[cut:]
    with open(os.path.join(video_dir, train_filename), "w") as f:
        f.writelines(n + "\n" for n in train)
    with open(os.path.join(video_dir, test_filename), "w") as f:
        f.writelines(n + "\n" for n in test)
    return train, test


def cache_video_frames_info(video_files, output_path: str,
                            root: str = None, existing: dict = None):
    """Write the filename -> frame count cache, so that building a dataset
    does not re-open every video. ``root`` keys entries by their path
    relative to it (basenames collide in nested layouts); ``existing`` rows
    are kept, so one split's update never evicts another's."""
    decode_count = _find_frame_counter()
    info = dict(existing or {})
    for path in video_files:
        name = os.path.relpath(path, root) if root else os.path.basename(path)
        if name not in info:
            info[name] = decode_count(path)
    with open(output_path, "w") as f:
        f.writelines(f"{n},{c}\n" for n, c in info.items())
    return info


def load_video_frames_info(cache_path: str):
    """Read the frame-count cache; {} when the file does not exist."""
    info = {}
    if os.path.exists(cache_path):
        with open(cache_path) as f:
            for line in f.read().splitlines():
                parts = line.strip().split(",")
                if len(parts) == 2:
                    info[parts[0]] = int(parts[1])
    return info


def _find_frame_counter():
    """Cheap frame counting: container metadata when cv2 is importable,
    full decode otherwise."""
    try:
        import cv2

        def _count(p):
            cap = cv2.VideoCapture(p)
            n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            cap.release()
            return n
        return _count
    except ImportError:  # pragma: no cover
        decode = _find_mp4_decoder()
        return lambda p: decode(p).shape[0]


def _find_mp4_decoder():
    """The first importable video decoder, as a function path -> (T, H, W,
    3) uint8 RGB: cv2, else av, else imageio with pyav."""
    try:
        import cv2

        def _decode_cv2(p):
            cap = cv2.VideoCapture(p)
            out = []
            while True:
                ok, bgr = cap.read()
                if not ok:
                    break
                out.append(bgr[..., ::-1])
            cap.release()
            if not out:
                raise RuntimeError(f"cv2 decoded no frames from {p}")
            return np.stack(out)
        return _decode_cv2
    except ImportError:
        pass
    try:  # pragma: no cover
        import av

        def _decode_av(p):
            with av.open(p) as container:
                return np.stack([f.to_ndarray(format="rgb24")
                                 for f in container.decode(video=0)])
        return _decode_av
    except ImportError:
        pass
    try:  # pragma: no cover
        import imageio.v3 as iio
        import av as _av  # noqa: F401 - pyav plugin needs it
        return lambda p: np.asarray(iio.imread(p, plugin="pyav"))
    except ImportError:
        pass
    raise RuntimeError(
        "Vimeo90kMP4Dataset needs an MP4 decoder (cv2, av, or imageio+pyav); "
        "none is importable; use the 7-PNG Vimeo90kDataset.")
