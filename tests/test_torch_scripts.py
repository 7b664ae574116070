"""The port's frame IO (``utils/video_io.py``) and its coding command lines
(``python3 -m ssgvc_tpu_torch.scripts.encode`` / ``.decode``) on the CPU at
the tiny profile, against the JAX package's ``utils/video_io.py`` and
``CodingSession``.

Exact: PNG and YUV420 files byte for byte the JAX package's for the same
arrays, the readers' frames, and the decoded PNGs against the encoder's
reconstructions written the same way. Against the JAX ``CodingSession`` on
the same weights and frames (I + 3 P of 64x64, then a second GOP's
I-frame): the frame types equal, each frame's bits within 2% and the
encoder's reconstructions within 1e-3, the bounds
``test_torch_coding.py::test_codec_matches_jax`` holds the codec to.
"""

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import DMC_HEADS, DMCI_HEADS
from ssgvc_tpu.coding.codec import VideoCodec as JaxVideoCodec
from ssgvc_tpu.coding.session import CodingSession as JaxCodingSession
from ssgvc_tpu.config import profile_model_cfgs as jax_profile
from ssgvc_tpu.models.dmc import DMC as JaxDMC
from ssgvc_tpu.models.dmci import DMCI as JaxDMCI
from ssgvc_tpu.utils import video_io as jvio
from ssgvc_tpu_torch.coding.bitstream import BitstreamReader
from ssgvc_tpu_torch.config import profile_model_cfgs
from ssgvc_tpu_torch.models.dmc import DMC
from ssgvc_tpu_torch.models.dmci import DMCI
from ssgvc_tpu_torch.scripts import decode, encode
from ssgvc_tpu_torch.utils import video_io as tvio
from ssgvc_tpu_torch.utils.transforms import rgb2ycbcr_np, ycbcr2rgb_np
from torch_port_helpers import drawn_params

HW, FRAMES, GOP, QP = 64, 5, 4, 30


def _rgb(seed, n=FRAMES, h=HW, w=HW):
    """Smooth RGB frames in [0, 1] (a gradient drifting frame to frame,
    plus noise), with exact 0 and 1 and half-steps among the values."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    out = []
    for t in range(n):
        base = np.stack([yy + 0.05 * t, xx, 1.0 - yy * xx], -1)
        out.append(np.clip(base + rng.normal(0, 0.05, base.shape), 0, 1))
    out = np.stack(out).astype(np.float32)
    out[:, 0, 0] = (0.0, 1.0, 0.5 / 255)
    return out


@pytest.mark.parametrize("start", [1, 7])
def test_png_files_equal_the_jax_packages(tmp_path, start):
    frames = _rgb(1, 3)
    for vio, d in ((tvio, tmp_path / "port"), (jvio, tmp_path / "jax")):
        writer = vio.PNGWriter(str(d), start=start)
        for f in frames:
            writer.write_one_frame(f)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == [f"im{i:05d}.png" for i in range(start, start + 3)]
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for n in names:
        assert ((tmp_path / "port" / n).read_bytes()
                == (tmp_path / "jax" / n).read_bytes()), n
    ours = tvio.PNGReader(str(tmp_path / "jax"), start=start)
    ref = jvio.PNGReader(str(tmp_path / "jax"), start=start)
    for f in frames:
        a, b = ours.read_one_frame(), ref.read_one_frame()
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        # 8 bits a channel: within half a step of the written frame
        assert np.abs(a - f).max() <= 0.5 / 255 + 1e-6
    assert ours.read_one_frame() is None and ref.read_one_frame() is None


@pytest.mark.parametrize("hw", [(16, 24), (18, 10)])
def test_yuv420_files_equal_the_jax_packages(tmp_path, hw):
    h, w = hw
    rng = np.random.default_rng(2)
    planes = [(rng.uniform(-0.1, 1.1, (h, w)).astype(np.float32),
               rng.uniform(0, 1, (h // 2, w // 2, 2)).astype(np.float32))
              for _ in range(3)]
    for vio, name in ((tvio, "port.yuv"), (jvio, "jax.yuv")):
        writer = vio.YUV420Writer(str(tmp_path / "sub" / name))
        for y, uv in planes:
            writer.write_one_frame(y, uv)
        writer.close()
    data = (tmp_path / "sub" / "port.yuv").read_bytes()
    assert data == (tmp_path / "sub" / "jax.yuv").read_bytes()
    assert len(data) == 3 * (h * w + 2 * (h // 2) * (w // 2))
    ours = tvio.YUV420Reader(str(tmp_path / "sub" / "port.yuv"), h, w)
    ref = jvio.YUV420Reader(str(tmp_path / "sub" / "port.yuv"), h, w)
    for y, uv in planes:
        (ya, uva), (yb, uvb) = ours.read_one_frame(), ref.read_one_frame()
        np.testing.assert_array_equal(ya, yb)
        np.testing.assert_array_equal(uva, uvb)
        np.testing.assert_allclose(ya, np.clip(y, 0, 1), atol=0.5 / 255 +
                                   1e-6)
        np.testing.assert_allclose(uva, uv, atol=0.5 / 255 + 1e-6)
    assert ours.read_one_frame() is None and ref.read_one_frame() is None
    ours.close()
    ref.close()


@pytest.fixture(scope="module")
def coded(tmp_path_factory):
    """A port checkpoint of drawn tiny weights, PNG frames, and the
    scripts' encode -> decode on the CPU: (directory, flax params of the
    DMC and DMCI, encode's stats, decode's frames)."""
    root = tmp_path_factory.mktemp("scripts")
    dmc_cfg, dmci_cfg = profile_model_cfgs("tiny", "performance")
    dmc, dmci = DMC(dmc_cfg, device="cpu"), DMCI(dmci_cfg, device="cpu")
    pp = drawn_params(dmc, 1, DMC_HEADS)
    pi = drawn_params(dmci, 0, DMCI_HEADS)
    torch.save({"params_p": dmc.state_dict(), "params_i": dmci.state_dict()},
               root / "last")
    writer = tvio.PNGWriter(str(root / "frames"))
    for f in _rgb(3):
        writer.write_one_frame(f)
    common = ["--checkpoint", str(root / "last"), "--profile", "tiny",
              "--device=cpu"]
    stats = encode.main(["--input", str(root / "frames"), "--output",
                         str(root / "seq.bin"), "--qp", str(QP), "--gop",
                         str(GOP)] + common)
    frames = decode.main(["--input", str(root / "seq.bin"), "--output",
                          str(root / "decoded")] + common)
    return root, pp, pi, stats, frames


def test_decoded_pngs_equal_the_encoders_recons(coded):
    root, _, _, stats, frames = coded
    assert stats["frame_types"] == ["I", "P", "P", "P", "I"]
    assert len(frames) == FRAMES
    for rec, dec in zip(stats["recons"], frames):
        np.testing.assert_array_equal(rec, dec)
    writer = tvio.PNGWriter(str(root / "recons"))
    for rec in stats["recons"]:
        writer.write_one_frame(ycbcr2rgb_np(rec))
    for t in range(1, FRAMES + 1):
        name = f"im{t:05d}.png"
        assert ((root / "decoded" / name).read_bytes()
                == (root / "recons" / name).read_bytes()), name
    assert not (root / "decoded" / f"im{FRAMES + 1:05d}.png").exists()
    # the container's unit sizes are the bits encode reports
    with open(root / "seq.bin", "rb") as f:
        reader = BitstreamReader(f)
        units = [reader.read_frame() for _ in range(FRAMES)]
        assert reader.read_frame() is None
    assert [len(u["payload"]) * 8 for u in units] == stats["frame_bits"]


def test_encode_prints_the_jax_scripts_lines(coded, capsys, tmp_path):
    root = coded[0]
    stats = encode.main(["--input", str(root / "frames"), "--output",
                         str(tmp_path / "two.bin"), "--checkpoint",
                         str(root / "last"), "--profile", "tiny",
                         "--device=cpu", "--max-frames", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    pixels = HW * HW
    bits = stats["frame_bits"]
    assert lines[-3].startswith(f"frame    0 [I] {bits[0]:8d} bits "
                                f"({bits[0] / pixels:.4f} bpp)  psnr ")
    assert lines[-2].startswith(f"frame    1 [P] {bits[1]:8d} bits ")
    assert lines[-1] == (f"total: {sum(bits)} bits, avg "
                         f"{sum(bits) / 2 / pixels:.4f} bpp -> "
                         f"{tmp_path / 'two.bin'}")


def test_stream_matches_the_jax_coding_session(coded):
    root, pp, pi, stats, _ = coded
    dmc_cfg, dmci_cfg = jax_profile("tiny", "performance")
    to_jax = lambda p: jax.tree_util.tree_map(jnp.asarray, p)
    codec = JaxVideoCodec(JaxDMCI(dmci_cfg), to_jax(pi), JaxDMC(dmc_cfg),
                          to_jax(pp))
    reader = jvio.PNGReader(str(root / "frames"))
    frames = np.stack([rgb2ycbcr_np(reader.read_one_frame())
                       for _ in range(FRAMES)])
    ref = JaxCodingSession(codec, gop_size=GOP).encode_sequence(
        io.BytesIO(), frames, qp=QP)
    assert ref["frame_types"] == stats["frame_types"]
    for nt, nj in zip(stats["frame_bits"], ref["frame_bits"]):
        assert abs(nt - nj) <= 0.02 * nj, (nt, nj)
    for a, b in zip(stats["recons"], ref["recons"]):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-3)


def test_scripts_default_to_the_card(coded, tmp_path):
    root = coded[0]
    if torch.cuda.is_available():
        return
    args = ["--checkpoint", str(root / "last"), "--profile", "tiny"]
    with pytest.raises(RuntimeError, match="CUDA"):
        encode.main(["--input", str(root / "frames"), "--output",
                     str(tmp_path / "x.bin")] + args)
    with pytest.raises(RuntimeError, match="CUDA"):
        decode.main(["--input", str(root / "seq.bin"), "--output",
                     str(tmp_path / "out")] + args)
