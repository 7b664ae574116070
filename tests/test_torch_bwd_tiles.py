"""The partials' partition of the DepthConvBlock backward kernels
``gate_bwd`` and ``dw_bwd`` (``csrc/dcb_bwd.cu``) on the CPU: the tiles
``ops.dcb_grad.bwd_tiles`` chooses, the tile constants against the CUDA
source, the plain per-tile sums (the card's oracle for each partials row)
against a pixel-by-pixel sum, and those rows through the kernel's fixed
reduction order against the sums over every pixel; ``dw_fwd``'s data flow
over the same tiles against its plain version.

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


#: dw_fwd's own channel slice (csrc/dcb_bwd.cu: it writes no partials);
#: a thread owns 4 channels of one pixel, lane, of the TILE x TILE grid and
#: stages cells lane + j TILE^2 of the window's HALO x HALO grid
DW_SLICE = int(re.search(r"constexpr int DW_SLICE = (\d+);",
                         (CSRC / "dcb_bwd.cu").read_text()).group(1))
HALO = dg.TILE + 2
LANES = dg.TILE * dg.TILE


def dw_fwd_tiles(a0, taps, b2):
    """g as dw_fwd's thread blocks compute it (csrc/dcb_bwd.cu): per tile
    of bwd_tiles and DW_SLICE of channels, the a0 window over the tile and
    a one-pixel halo (cells (r, s) < (th + 2, tw + 2) of the HALO x HALO
    grid), zero beyond the image, turned into h = wsilu(a0); each pixel
    lane of the TILE x TILE grid that lies in the tile summed from b2 tap
    by tap in (i, j) order over its window. Returns g and how many times
    each output was written."""
    b, h, w, c = a0.shape
    th, tw, rows = dg.bwd_tiles(a0.shape)
    # every window cell is some lane's copy
    copies = -(-(HALO * HALO) // LANES)
    cells = torch.arange(LANES)[:, None] + LANES * torch.arange(copies)
    r, s = cells // HALO, cells % HALO
    staged = cells[(r < th + 2) & (s < tw + 2)]
    assert sorted(staged.tolist()) == [
        rr * HALO + ss for rr in range(th + 2) for ss in range(tw + 2)]
    # zeros beyond the image: the halo and the cut-off tile's far side
    pad = F.pad(a0, (0, 0, 1, dg.TILE + 1, 1, dg.TILE + 1))
    g = torch.zeros_like(a0)
    writes = torch.zeros(a0.shape, dtype=torch.int64)
    lane = torch.arange(LANES)
    py, px = lane // dg.TILE, lane % dg.TILE
    keep = (py < th) & (px < tw)
    py, px = py[keep], px[keep]
    for t in range(rows):
        img, y0, x0 = tile_of(t, a0.shape)
        y, x = y0 + py, x0 + px
        inside = (y < h) & (x < w)
        for c0 in range(0, c, DW_SLICE):
            ch = slice(c0, min(c0 + DW_SLICE, c))
            hs = dg.wsilu(pad[img, y0:y0 + th + 2, x0:x0 + tw + 2, ch])
            acc = b2[ch].expand(len(py), -1)
            for ti in range(3):
                for tj in range(3):
                    acc = acc + taps[3 * ti + tj, ch] * hs[py + ti, px + tj]
            g[img, y[inside], x[inside], ch] = acc[inside]
            writes[img, y[inside], x[inside], ch] += 1
    return g, writes


@pytest.mark.parametrize("shape", SHAPES + [(4, 12, 20, 24), (3, 9, 5, 8),
                                            (8, 8, 8, 64), (8, 4, 4, 32),
                                            (8, 1, 1, 32), (2, 17, 9, 40)])
def test_dw_fwd_through_the_kernels_tiles_is_the_plain_version(shape):
    """dw_fwd's data flow (a thread block per tile and channel slice, the
    window staged with a zero halo, h once per staged value, a pixel's 4
    channels a thread) writes every output once, and what it writes is
    dw_fwd_plain's g: the halo stays inside each image, cut-off tiles
    included. Its constants against the .cu: one thread per pixel and
    group of 4 channels, the HALO grid, every slice full (C a multiple of
    DW_SLICE)."""
    text = (CSRC / "dcb_bwd.cu").read_text()
    assert "constexpr int DW_THREADS = TILE * TILE * DW_GROUPS;" in text
    assert "constexpr int DW_GROUPS = DW_SLICE / 4;" in text
    assert "constexpr int HALO = TILE + 2;" in text
    # every slice full: the kernel stages and computes every channel group
    assert DW_SLICE % 4 == 0 and dcb_ops.WIDTH_STEP % DW_SLICE == 0
    k = case(shape, False, 11 + sum(shape))
    b2 = torch.from_numpy(np.random.default_rng(sum(shape)).standard_normal(
        shape[-1]).astype(np.float32))
    g, writes = dw_fwd_tiles(k["a0"], k["taps"], b2)
    assert (writes == 1).all()
    assert close(g, dg.dw_fwd_plain(k["a0"], k["taps"], b2, torch.float32))


def test_tile_sums_refuse_another_row_count():
    with pytest.raises(ValueError, match="rows"):
        dg.tile_sums(torch.zeros(2, 9, 9, 8), 3)
