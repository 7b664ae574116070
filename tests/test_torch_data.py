"""The port's data path against the JAX package's on the same inputs:
TFRecords, the Waymo proto walker, the lidar projection, the mask cache,
the clip datasets (Waymo, Vimeo-90k, synthetic), the sequence transforms,
the data module and make_datamodule. Both sides are numpy, so every
comparison is exact."""

import os
import zlib

import numpy as np
import pytest

from ssgvc_tpu import config as jcfg
from ssgvc_tpu.data import build_cache as jbc
from ssgvc_tpu.data import dataset as jds
from ssgvc_tpu.data import lidar as jlidar
from ssgvc_tpu.data import tfrecord as jtf
from ssgvc_tpu.data import video_transform as jvt
from ssgvc_tpu.data import vimeo as jvimeo
from ssgvc_tpu.data import waymo_proto as jwp
from ssgvc_tpu_torch import config as tcfg
from ssgvc_tpu_torch.data import build_cache as tbc
from ssgvc_tpu_torch.data import dataset as tds
from ssgvc_tpu_torch.data import lidar as tlidar
from ssgvc_tpu_torch.data import tfrecord as ttf
from ssgvc_tpu_torch.data import video_transform as tvt
from ssgvc_tpu_torch.data import vimeo as tvimeo
from ssgvc_tpu_torch.data import waymo_proto as twp


def equal_clips(a, b):
    """Two (frames, masks[, proj]) items or batches, array for array."""
    assert type(a) is type(b)
    items = a.items() if isinstance(a, dict) else enumerate(a)
    for k, v in items:
        np.testing.assert_array_equal(v, b[k], err_msg=str(k))
        assert v.dtype == b[k].dtype


def write_waymo(path, n_frames=6, hw=(64, 96), seed=0, lidar=False):
    """A TFRecord of smooth random FRONT frames (through the port's
    writer), optionally each with a top-lidar range image."""
    rng = np.random.default_rng(seed)
    records = []
    for _ in range(n_frames):
        base = rng.uniform(0, 255, (hw[0] // 8, hw[1] // 8, 3))
        rgb = np.repeat(np.repeat(base, 8, 0), 8, 1).astype(np.uint8)
        rec = twp.build_frame_proto(twp.encode_jpeg(rgb))
        if lidar:
            ri, cp = lidar_arrays(rng, hw)
            rec += tlidar.build_laser_proto(
                *tlidar.build_range_image_blobs(ri, cp))
        records.append(rec)
    ttf.write_records(str(path), records)
    return records


def lidar_arrays(rng, hw, shape=(6, 10)):
    """A range image and camera projection: valid points, range-0 points,
    other cameras, points off the image and negative coordinates."""
    ri = rng.uniform(0, 90, shape + (4,)).astype(np.float32)
    ri[rng.uniform(size=shape) < 0.2, 0] = 0.0
    cp = np.stack([rng.integers(0, 3, shape),
                   rng.integers(-5, hw[1] + 5, shape),
                   rng.integers(-5, hw[0] + 5, shape),
                   rng.integers(0, 3, shape),
                   rng.integers(-5, hw[1] + 5, shape),
                   rng.integers(-5, hw[0] + 5, shape)], -1)
    return ri, cp


# ------------------------------------------------------------ TFRecords --

def test_tfrecord_round_trip_and_crc(tmp_path):
    rng = np.random.default_rng(0)
    payloads = [b"hello", b"", rng.bytes(5000), bytes(range(256)) * 3]
    for blob in payloads:
        assert ttf.crc32c(blob) == jtf.crc32c(blob)
        assert ttf.masked_crc32c(blob) == jtf.masked_crc32c(blob)
    pt, pj = tmp_path / "t.tfrecord", tmp_path / "j.tfrecord"
    ttf.write_records(str(pt), payloads)
    jtf.write_records(str(pj), payloads)
    assert pt.read_bytes() == pj.read_bytes()
    assert list(ttf.read_records(str(pj), verify_crc=True)) == payloads
    assert ttf.count_records(str(pt)) == jtf.count_records(str(pt)) == 4
    offsets = ttf.record_offsets(str(pt))
    assert offsets == jtf.record_offsets(str(pt))
    with open(pt, "rb") as f:
        assert [ttf.read_record_at(f, o) for o in offsets] == payloads
    # a flipped payload byte: both readers refuse it when verifying
    raw = bytearray(pt.read_bytes())
    raw[offsets[2] + 12 + 10] ^= 1
    bad = tmp_path / "bad.tfrecord"
    bad.write_bytes(bytes(raw))
    for mod in (ttf, jtf):
        with pytest.raises(IOError, match="data crc"):
            list(mod.read_records(str(bad), verify_crc=True))
        assert len(list(mod.read_records(str(bad)))) == 4


def test_proto_walker():
    rgb = (np.random.default_rng(1).uniform(0, 255, (16, 24, 3))
           ).astype(np.uint8)
    jpeg = twp.encode_jpeg(rgb)
    assert jpeg == jwp.encode_jpeg(rgb)
    frame = twp.build_frame_proto(jpeg, camera_name=3,
                                  context_name="seg-123")
    assert frame == jwp.build_frame_proto(jpeg, camera_name=3,
                                          context_name="seg-123")
    frame += twp.build_frame_proto(b"front", context_name="x")
    assert twp.parse_camera_images(frame) == jwp.parse_camera_images(frame)
    assert twp.parse_front_jpeg(frame) == jwp.parse_front_jpeg(frame)
    assert twp.parse_context_name(frame) == jwp.parse_context_name(frame)
    assert list(twp.iter_fields(memoryview(frame)))[0][:2] == (1, 2)
    np.testing.assert_array_equal(twp.decode_jpeg(jpeg), jwp.decode_jpeg(jpeg))


@pytest.mark.parametrize("mode", ["occupancy", "legacy3"])
def test_lidar_projection(mode):
    rng = np.random.default_rng(2)
    hw = (32, 48)
    ri, cp = lidar_arrays(rng, hw)
    blobs = tlidar.build_range_image_blobs(ri, cp)
    assert blobs == jlidar.build_range_image_blobs(ri, cp)
    frame = tlidar.build_laser_proto(*blobs)
    assert frame == jlidar.build_laser_proto(*blobs)
    # another laser first: only the top lidar projects
    frame = tlidar.build_laser_proto(*blobs, laser_name=2) + frame
    got = tlidar.project_top_lidar(frame, *hw, mode=mode)
    want = jlidar.project_top_lidar(frame, *hw, mode=mode)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and got[..., 0].any()
    np.testing.assert_array_equal(
        tlidar.parse_matrix_int32(zlib.decompress(blobs[1])),
        cp.astype(np.int32))
    assert not tlidar.project_top_lidar(b"", *hw).any()


# ------------------------------------------------------------ mask cache --

def stub_segmenter(seed):
    """A seeded stand-in for YOLO: 1-3 soft rectangles per call, of kept
    and dropped classes, one at half resolution (the resize path), one
    speck below min_area."""
    rng = np.random.default_rng(seed)

    def segment(rgb):
        h, w = rgb.shape[:2]
        out = []
        for _ in range(int(rng.integers(1, 4))):
            m = np.zeros((h, w), np.float32)
            y, x = int(rng.integers(0, h - 16)), int(rng.integers(0, w - 16))
            m[y:y + int(rng.integers(8, 16)), x:x + int(rng.integers(8, 16))] \
                = rng.uniform(0.3, 1.0)
            out.append((m, int(rng.choice([0, 2, 5, 7]))))
        half = np.zeros((h // 2, w // 2), np.float32)
        half[2:10, 3:12] = 0.9
        speck = np.zeros((h, w), np.float32)
        speck[0:2, 0:2] = 1.0
        return out + [(half, 2), (speck, 0)]
    return segment


def test_build_cache_with_a_stub_segmenter(tmp_path):
    tfs = [tmp_path / "a.tfrecord", tmp_path / "b.tfrecord"]
    for i, p in enumerate(tfs):
        write_waymo(p, n_frames=3, seed=i)
    stats = {}
    for who, mod in (("t", tbc), ("j", jbc)):
        stats[who] = mod.build_cache(str(tmp_path / "*.tfrecord"),
                                     str(tmp_path / f"cache_{who}"),
                                     segmenter=stub_segmenter(5),
                                     min_area=16)
    assert stats["t"] == stats["j"] == {"written": 6, "skipped": 0}
    files = {who: sorted(p.relative_to(tmp_path / f"cache_{who}")
                         for p in (tmp_path / f"cache_{who}").rglob("*"))
             for who in ("t", "j")}
    assert files["t"] == files["j"] and len(files["t"]) == 8
    for rel in files["t"]:
        if rel.suffix == ".npz":
            a = np.load(tmp_path / "cache_t" / rel)["mask"]
            b = np.load(tmp_path / "cache_j" / rel)["mask"]
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype == np.uint8
    # a second build skips every frame, in both
    again = tbc.build_cache([str(p) for p in tfs], str(tmp_path / "cache_t"),
                            segmenter=stub_segmenter(5), max_frames=2)
    assert again == {"written": 0, "skipped": 4}
    inst = stub_segmenter(9)(np.zeros((40, 56, 3), np.uint8))
    np.testing.assert_array_equal(
        tbc.union_instance_masks(inst, (40, 56), min_area=16),
        jbc.union_instance_masks(inst, (40, 56), min_area=16))


# -------------------------------------------------------------- datasets --

@pytest.mark.parametrize("strict", [False, True])
def test_waymo_clip_dataset(tmp_path, strict):
    tfs = [tmp_path / "a.tfrecord", tmp_path / "b.tfrecord"]
    write_waymo(tfs[0], n_frames=6, seed=3, lidar=True)
    write_waymo(tfs[1], n_frames=5, seed=4, lidar=True)
    cache = tmp_path / "cache"
    tbc.build_cache(str(tfs[0]), str(cache), segmenter=stub_segmenter(1),
                    min_area=16)
    kw = dict(seg_cache_dir=str(cache), seq_len=4, slide=1, crop_size=32,
              strict_masks=strict)
    t = tds.WaymoClipDataset(str(tmp_path / "*.tfrecord"), **kw)
    j = jds.WaymoClipDataset(str(tmp_path / "*.tfrecord"), **kw)
    assert len(t) == len(j) == 5 and t._index == j._index
    for idx in range(len(t)):
        if strict and idx >= 3:       # b.tfrecord has no cached masks
            for ds in (t, j):
                with pytest.raises(FileNotFoundError):
                    ds.__getitem__(idx, rng=np.random.default_rng(idx))
            continue
        equal_clips(t.__getitem__(idx, rng=np.random.default_rng(idx)),
                    j.__getitem__(idx, rng=np.random.default_rng(idx)))
    # the lidar projection beside the frames, uncropped
    kw.update(crop_size=None, strict_masks=False, return_proj=True,
              proj_mode="legacy3")
    equal_clips(tds.WaymoClipDataset([str(tfs[1])], **kw).__getitem__(1),
                jds.WaymoClipDataset([str(tfs[1])], **kw).__getitem__(1))
    for mod in (tds, jds):
        with pytest.raises(ValueError, match="crop"):
            mod.WaymoClipDataset([str(tfs[1])], crop_size=128).__getitem__(0)


def write_pngs(root, seqs, hw=(48, 64), seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    for seq in seqs:
        d = root / "sequences" / seq
        d.mkdir(parents=True)
        for i in range(1, 8):
            Image.fromarray(rng.uniform(0, 255, hw + (3,)).astype(np.uint8)
                            ).save(d / f"im{i}.png")


def write_mp4(path, n_frames=8, size=(64, 48), seed=0):
    import cv2

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 5, size)
    assert w.isOpened()
    for _ in range(n_frames):
        w.write(rng.uniform(0, 255, (size[1], size[0], 3)).astype(np.uint8))
    w.release()


def test_vimeo_loaders(tmp_path):
    png, sept, flat = tmp_path / "png", tmp_path / "sept", tmp_path / "flat"
    write_pngs(png, ("00001/0001", "00001/0002"))
    (png / "sep_testlist.txt").write_text("00001/0002\n")
    for seq in ("00001/0010", "00001/0011"):
        write_mp4(str(sept / "sequences" / seq / f"{seq[-4:]}.mp4"),
                  n_frames=9, seed=int(seq[-2:]))
    (sept / "sep_trainlist.txt").write_text("00001/0010\n00001/0011\n")
    for i in range(5):
        write_mp4(str(flat / f"clip{i}.mp4"), n_frames=4 if i == 4 else 8,
                  seed=i)
    cases = [("Vimeo90kDataset", png, dict(crop_size=32)),
             ("Vimeo90kDataset", png, dict(split="test", seq_len=3,
                                           crop_size=None, to_ycbcr=False)),
             ("Vimeo90kImageDataset", png, dict(crop_size=24)),
             ("Vimeo90kSeptupletDataset", sept, dict(n_frames=7,
                                                     crop_size=32)),
             ("Vimeo90kMP4Dataset", flat, dict(crop_size=32, n_frames=7,
                                               generate_split=True))]
    for name, root, kw in cases:
        t = getattr(tvimeo, name)(str(root), **kw)
        j = getattr(jvimeo, name)(str(root), **kw)
        assert len(t) == len(j) > 0, name
        for idx in range(len(t)):
            a = t.__getitem__(idx, rng=np.random.default_rng(idx))
            b = j.__getitem__(idx, rng=np.random.default_rng(idx))
            equal_clips(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,))
    # the split files and the frame-count cache the MP4 dataset wrote
    assert (flat / "sep_trainlist.txt").read_text().count("clip") == 4
    assert tvimeo.load_video_frames_info(
        str(flat / "video_frames_cache.txt")) == jvimeo.load_video_frames_info(
        str(flat / "video_frames_cache.txt"))


def test_sequence_transforms_under_one_rng():
    frames = np.random.default_rng(3).uniform(
        0, 1, (3, 16, 20, 3)).astype(np.float32)

    def chain(mod):
        return mod.Compose([mod.RandomCropTransform(12),
                            mod.RandomHorizontalFlipSequence(0.5),
                            mod.RandomRotationSequence(),
                            mod.ColorJitterSequence()])

    for seed in range(6):
        equal_clips((chain(tvt)(frames, rng=np.random.default_rng(seed)),),
                    (chain(jvt)(frames, rng=np.random.default_rng(seed)),))
    equal_clips((tvt.RGBtoYUVTransform("444")(frames),),
                (jvt.RGBtoYUVTransform("444")(frames),))
    equal_clips(tvt.RGBtoYUVTransform("420")(frames),
                jvt.RGBtoYUVTransform("420")(frames))


@pytest.mark.parametrize("texture,roi_subset", [("noise", False),
                                                ("smooth", True)])
def test_synthetic_clips(texture, roi_subset):
    kw = dict(num_clips=5, seq_len=3, crop_size=48, seed=2, texture=texture,
              roi_subset=roi_subset)
    t, j = tds.SyntheticClipDataset(**kw), jds.SyntheticClipDataset(**kw)
    for idx in range(5):
        equal_clips(t[idx], j[idx])


# ----------------------------------------------------------- data module --

@pytest.mark.parametrize("world", [1, 3])
def test_clip_datamodule_batches(world):
    ds_t = tds.SyntheticClipDataset(num_clips=11, seq_len=2, crop_size=32)
    ds_j = jds.SyntheticClipDataset(num_clips=11, seq_len=2, crop_size=32)
    for rank in range(world):
        kw = dict(batch_size=2, split=(0.7, 0.3, 0.0), seed=7, rank=rank,
                  world=world)
        t, j = tds.ClipDataModule(ds_t, **kw), jds.ClipDataModule(ds_j, **kw)
        assert t.steps_per_epoch() == j.steps_per_epoch()
        for it_t, it_j in ((t.train_iter(), j.train_iter()),
                           (t.val_iter(loop=True), j.val_iter(loop=True))):
            for _ in range(4):
                equal_clips(next(it_t), next(it_j))
        assert (len(list(t.val_iter())) == len(list(j.val_iter())))
    for mod in (tds, jds):
        with pytest.raises(ValueError, match="rank"):
            mod.ClipDataModule(ds_t, rank=world, world=world)


def datamodule_cases(tmp_path):
    """(dataset_type, data_dir, synthetic) of each make_datamodule branch;
    the empty directories take the synthetic fall-back."""
    waymo, png = tmp_path / "waymo", tmp_path / "png"
    waymo.mkdir()
    write_waymo(waymo / "a.tfrecord", n_frames=7, seed=5)
    write_pngs(png, ("00001/0001", "00001/0002", "00001/0003"))
    sept, flat = tmp_path / "sept", tmp_path / "flat"
    for seq in ("00001/0010", "00001/0011", "00001/0012"):
        write_mp4(str(sept / "sequences" / seq / f"{seq[-4:]}.mp4"),
                  n_frames=6, seed=int(seq[-2:]))
    (sept / "sep_trainlist.txt").write_text(
        "00001/0010\n00001/0011\n00001/0012\n")
    for i in range(4):
        write_mp4(str(flat / f"clip{i}.mp4"), n_frames=6, seed=i)
    empty = tmp_path / "empty"
    empty.mkdir()
    return [("waymo", waymo, False), ("waymo", empty, False),
            ("waymo", waymo, True), ("vimeo", png, False),
            ("vimeo_image", empty, False), ("vimeo_single_image", png, False),
            ("vimeo_septuplet", sept, False), ("vimeo_mp4", flat, False),
            ("vimeo_septuplet", empty, False), ("vimeo_mp4", empty, False)]


def test_make_datamodule_every_dataset_type(tmp_path, capsys):
    for dtype, root, synthetic in datamodule_cases(tmp_path):
        batches, lines = [], []
        for cfg_mod, ds_mod in ((tcfg, tds), (jcfg, jds)):
            cfg = cfg_mod.TrainConfig(seed=3)
            cfg.dataset = cfg_mod.DatasetConfig(
                dataset_type=dtype, data_dir=str(root), batch_size=2,
                seq_len=3, crop_size=32, synthetic=synthetic,
                synthetic_num_clips=6, seg_cache_dir=str(tmp_path / "none"),
                train_val_test_split=(0.75, 0.25, 0.0))
            capsys.readouterr()
            dm = ds_mod.make_datamodule(cfg)
            lines.append(capsys.readouterr().out)
            it = dm.train_iter()
            batches.append((type(dm.dataset).__name__, dm.steps_per_epoch(),
                            next(it), next(it), next(dm.val_iter(loop=True))))
        t, j = batches
        assert t[:2] == j[:2], (dtype, root.name)
        for a, b in zip(t[2:], j[2:]):
            equal_clips(a, b)
        assert lines[0] == lines[1], (dtype, lines)
        falls_back = synthetic or root.name == "empty"
        assert (t[0] == "SyntheticClipDataset") == falls_back, (dtype, t[0])
        assert t[2]["frames"].shape[1:4] == (
            (1, 32, 32) if dtype == "vimeo_single_image" else (3, 32, 32))
