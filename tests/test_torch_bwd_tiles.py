"""The partials' partition of the DepthConvBlock backward kernels
``gate_bwd`` and ``dw_bwd`` (``csrc/dcb_bwd.cu``) on the CPU: the tiles
``ops.dcb_grad.bwd_tiles`` chooses, the tile constants against the CUDA
source, the plain per-tile sums (the card's oracle for each partials row)
against a pixel-by-pixel sum, and those rows through the kernel's fixed
reduction order against the sums over every pixel.

Tolerances: the per-tile sums and their reduction at 1e-5 of the largest
magnitude (fp32 sums in another order).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import BWD_SHAPES, TRAIN_B
from ssgvc_tpu_torch.ops import dcb as dcb_ops
from ssgvc_tpu_torch.ops import dcb_grad as dg

F32_TOL = 1e-5
CSRC = Path(dg.__file__).resolve().parent.parent / "csrc"
# every training shape (B = 4), ragged and one-tile frames, and the RD
# recipe's widths (rd-mid: C = 32, 64, 96)
SHAPES = ([(TRAIN_B, h, w, c) for h, w, c, _, _ in BWD_SHAPES]
          + [(2, 5, 7, 32), (3, 1, 1, 64), (4, 2, 2, 96), (1, 12, 20, 32),
             (2, 17, 9, 64), (8, 16, 16, 96)])


def tile_of(t, shape):
    """Tile t's (image, first row, first column), as the kernels' tile_of
    computes it from blockIdx.x."""
    _, h, w, _ = shape
    th, tw, _ = dg.bwd_tiles(shape)
    tiles_y, tiles_x = -(-h // th), -(-w // tw)
    tx, r = t % tiles_x, t // tiles_x
    return r // tiles_y, (r % tiles_y) * th, tx * tw


def tile_index(shape):
    """(B, H, W) int64: the partials row each pixel's sums go to, by the
    kernels' rule (-1 where no tile covers it)."""
    b, h, w, _ = shape
    th, tw, rows = dg.bwd_tiles(shape)
    owner = np.full((b, h, w), -1, np.int64)
    for t in range(rows):
        img, y0, x0 = tile_of(t, shape)
        assert 0 <= img < b and 0 <= y0 < h and 0 <= x0 < w
        block = owner[img, y0:y0 + th, x0:x0 + tw]   # cut off at the edge
        assert (block == -1).all(), f"tile {t} overlaps another"
        block[...] = t
    return owner


@pytest.mark.parametrize("shape", SHAPES)
def test_every_pixel_lies_in_one_tile_of_one_image(shape):
    b, h, w, c = shape
    th, tw, rows = dg.bwd_tiles(shape)
    assert 1 <= th <= min(dg.TILE, h) and 1 <= tw <= min(dg.TILE, w)
    owner = tile_index(shape)
    assert (owner >= 0).all()
    assert np.unique(owner).size == rows
    # no tile holds pixels of two images: each image's tiles are its own
    assert sum(np.unique(owner[i]).size for i in range(b)) == rows
    # the row count is the shape's alone: whatever dtype, device or layout
    for x in (torch.empty(shape, device="meta"),
              torch.empty(shape, dtype=torch.bfloat16, device="meta"),
              torch.empty((b, c, h, w), device="meta").permute(0, 2, 3, 1)):
        assert dg.partial_rows(x) == rows
    assert dg.partial_rows(torch.empty(shape)) == 1     # the CPU: one row


def test_the_kernels_tile_constants_are_the_python_mirror():
    text = (CSRC / "dcb_bwd.cu").read_text()
    for name, value in (("TILE", dg.TILE), ("SLICE", dg.SLICE),
                        ("RED_CHUNK", dg.RED_CHUNK),
                        ("RED_WARPS", dg.RED_WARPS)):
        m = re.search(rf"\bconstexpr int (?:\w+ = \d+, )*{name} = (\d+)",
                      text)
        assert m and int(m.group(1)) == value, name
    assert f"C % {dcb_ops.WIDTH_STEP} != 0" in text
    assert "th > TILE || th > H" in text and "tw > TILE || tw > W" in text
    assert "return Tile{r / tiles_y, (r % tiles_y) * th, tx * tw};" in text
    assert "*grid = dim3((unsigned)tiles, (C + SLICE - 1) / SLICE);" in text


def case(shape, with_q, seed):
    rng = np.random.default_rng(seed)
    b, h, w, c = shape

    def t(*s, std=1.0):
        return torch.from_numpy((rng.standard_normal(s) * std
                                 ).astype(np.float32))
    return dict(a0=t(b, h, w, c), taps=t(9, c, std=1 / 3),
                df=t(b, h, w, 2 * c), p=t(b, h, w, 4 * c), dy=t(b, h, w, c),
                dg=t(b, h, w, c), du=t(b, h, w, c),
                q=1.0 + t(c, std=0.2) if with_q else None,
                resid=t(b, h, w, c) if with_q else None)


def plain_part(k, rows):
    c = k["a0"].shape[-1]
    part = torch.zeros(rows, (dg.GATE_COLS + dg.DW_COLS) * c)
    dg.gate_bwd_plain(k["df"], k["p"], k["dy"], k["q"], k["resid"], part, 0)
    dg.dw_bwd_plain(k["dg"], k["a0"], k["taps"], k["du"], part,
                    dg.GATE_COLS * c)
    return part


def close(got, ref):
    err = float((got.double() - ref.double()).abs().max())
    return err <= F32_TOL * float(ref.abs().max())


@pytest.mark.parametrize("shape", [(2, 5, 7, 32), (3, 1, 1, 64),
                                   (4, 2, 2, 96), (1, 12, 20, 32),
                                   (TRAIN_B, 16, 16, 32)])
@pytest.mark.parametrize("with_q", [False, True])
def test_plain_tile_sums_are_each_tiles_pixels(shape, with_q):
    """Row r of the plain per-tile partials sums exactly tile r's pixels,
    the tile by the kernels' rule: each column against a pixel-by-pixel
    sum (the taps against h = wsilu(a0) at each neighbour, zero beyond the
    image)."""
    k = case(shape, with_q, sum(shape))
    b, h, w, c = shape
    rows = dg.bwd_tiles(shape)[2]
    part = plain_part(k, rows)
    owner = torch.from_numpy(tile_index(shape)).reshape(-1)
    pa, pb = k["p"][..., :2 * c], k["p"][..., 2 * c:]
    dp = torch.cat([k["df"] * dg.wsilu_grad(pa),
                    k["df"] * dg.wsilu_grad(pb)], -1)
    dyq = k["dy"] * k["q"] if with_q else k["dy"]
    dyr = k["dy"] * k["resid"] if with_q else torch.zeros_like(k["dy"])
    hp = F.pad(dg.wsilu(k["a0"]), (0, 0, 1, 1, 1, 1))
    taps = [k["dg"] * hp[:, i:i + h, j:j + w] for i in range(3)
            for j in range(3)]
    wg = dg.dw_bwd_plain(k["dg"], k["a0"], k["taps"], k["du"],
                         torch.zeros(1, dg.DW_COLS * c), 0)
    per_pixel = torch.cat([dp, dyq, dyr, *taps, k["dg"], wg, k["du"]], -1)
    ref = torch.zeros(rows, per_pixel.shape[-1]).index_add_(
        0, owner, per_pixel.reshape(-1, per_pixel.shape[-1]))
    assert close(part, ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_tile_sums_reduced_in_the_kernels_order_are_the_sums(shape):
    """The per-tile rows, through grad_reduce_order (what grad_reduce does
    on the card), sum what the one-row plain partials do."""
    with_q = shape[-1] != 64
    k = case(shape, with_q, 7 + sum(shape))
    whole = plain_part(k, 1)
    tiles = plain_part(k, dg.bwd_tiles(shape)[2])
    assert close(dg.grad_reduce_order(tiles), whole.sum(0))


def test_tile_sums_refuse_another_row_count():
    with pytest.raises(ValueError, match="rows"):
        dg.tile_sums(torch.zeros(2, 9, 9, 8), 3)
