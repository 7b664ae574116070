"""The plain versions of the port's two DepthConvBlock kernels against the
JAX package's Pallas kernels (interpret mode on the CPU), the planners, the
kernels' weight packing and their schedule rehearsed in plain PyTorch, and
the CPU routing. Kernel-vs-plain on the card lives in
test_torch_kernels_gpu.py.

Tolerances as the Pallas kernels' own tests: atol 2e-5 for one block, 3e-5
for a chain (fp32, another summation order)."""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssgvc_tpu.layers.blocks import DepthConvBlock as JaxDCB
from ssgvc_tpu.ops.pallas_dcb import dcb_fused
from ssgvc_tpu.ops.pallas_dcb_chain import dcb_chain_fused
from ssgvc_tpu_torch.ops import dcb as dcb_ops
from ssgvc_tpu_torch.ops import dcb_chain as chain_ops
from torch_port_helpers import perturbed
from torch_port_helpers import one_torch_thread  # noqa: F401

NAMES = ("dc_0", "dc_2", "dc_3", "ffn_0", "ffn_2")
# the full profile's widths: every single-block and chain site of the
# P-frame and I-frame codecs (the smaller profiles' are in
# test_torch_widths.py)
FULL_DCB_WIDTHS = (128, 192, 256, 320, 368, 384, 512)
FULL_CHAIN_WIDTHS = (128, 256, 320, 384)


def _flax_block(c, seed):
    p = JaxDCB(c).init(jax.random.PRNGKey(seed),
                       jnp.zeros((1, 8, 16, c)))["params"]
    p = perturbed(p, seed=seed + 100)
    return tuple(a for nm in NAMES for a in (p[nm]["kernel"], p[nm]["bias"]))


def _torch_block(flax_block):
    """flax layouts -> the port's: kernels HWIO -> OIHW, biases as is."""
    return tuple(torch.from_numpy(np.ascontiguousarray(
        a.transpose(3, 2, 0, 1) if a.ndim == 4 else a))
        for a in flax_block)


def _x(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("shortcut,with_q", [(False, False), (True, True)])
def test_plain_dcb_matches_pallas_kernel(shortcut, with_q):
    c, h, w = 128, 12, 16
    x = _x((1, h, w, c), 3)
    q = (np.linspace(0.5, 1.5, c, dtype=np.float32).reshape(1, 1, 1, c)
         if with_q else None)
    blk = _flax_block(c, 0)
    ref = dcb_fused(jnp.asarray(x), *map(jnp.asarray, blk),
                    q=None if q is None else jnp.asarray(q),
                    shortcut=shortcut)
    out = dcb_ops.dcb_plain(torch.from_numpy(x), _torch_block(blk),
                            None if q is None else torch.from_numpy(q),
                            shortcut)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("n,h,with_q,scale", [
    (2, 12, False, 0.5), (3, 12, False, 0.5), (4, 16, False, 0.5),
    (2, 8, True, 0.5),        # q_last folded into the last block
    (3, 24, False, 1.0),      # several Pallas row tiles: edge masking
])
def test_plain_chain_matches_pallas_kernel(n, h, with_q, scale):
    c, w = 128, 16
    x = _x((1, h, w, c), 7 + n, scale)
    q = (np.linspace(0.5, 1.5, c, dtype=np.float32).reshape(1, 1, 1, c)
         if with_q else None)
    blocks = [_flax_block(c, j) for j in range(n)]
    ref = dcb_chain_fused(jnp.asarray(x),
                          [tuple(map(jnp.asarray, b)) for b in blocks],
                          q_last=None if q is None else jnp.asarray(q))
    out = chain_ops.dcb_chain_plain(
        torch.from_numpy(x), [_torch_block(b) for b in blocks],
        None if q is None else torch.from_numpy(q))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    c = 128
    blocks = [_torch_block(_flax_block(c, j)) for j in range(2)]
    x = torch.from_numpy(_x((1, 6, 5, c), 1))
    q = torch.linspace(0.5, 1.5, c)
    before = (dcb_ops.launches, chain_ops.launches)
    y1 = dcb_ops.dcb(x, blocks[0], q, shortcut=True)
    y2 = chain_ops.dcb_chain(x, blocks, q)
    assert (dcb_ops.launches, chain_ops.launches) == before
    torch.testing.assert_close(y1, dcb_ops.dcb_plain(x, blocks[0], q, True),
                               rtol=0, atol=0)
    torch.testing.assert_close(y2, chain_ops.dcb_chain_plain(x, blocks, q),
                               rtol=0, atol=0)
    # the kernel entry never takes a CPU tensor: it raises, no fallback
    with pytest.raises(ValueError):
        dcb_ops.dcb_cuda(x.to(torch.bfloat16),
                         dcb_ops.pack_block(blocks[0], torch.bfloat16))


@pytest.mark.parametrize("kernel", ["dcb", "dcb_chain"])
def test_planner_fits_every_main_path_site_in_one_launch(kernel):
    if kernel == "dcb":
        # every single-block site of the P-frame and I-frame codecs: one
        # persistent launch over 8x8 tiles, ragged at the frame's edge
        for (h, w, widths), grid in (((136, 240, (192, 256, 320, 368)),
                                      (17, 30)),
                                     ((68, 120, (128, 256, 384, 512)),
                                      (9, 15)),
                                     ((34, 60, (128,)), (5, 8)),
                                     ((17, 30, (128,)), (3, 4))):
            assert dcb_ops.tile_grid(h, w) == grid
            for c in widths:
                dcb_ops.check_width(c, dcb_ops.MAX_CHANNELS, "dcb")
                assert dcb_ops.smem_bytes(c) <= dcb_ops.SMEM_LIMIT
        return
    # the chains of the main path: one launch each over 8x8 tiles, the last
    # row of tiles ragged at 68x120
    for (h, w, c, n), grid in (((136, 240, 256, 2), (17, 30)),
                               ((136, 240, 256, 4), (17, 30)),
                               ((68, 120, 384, 3), (9, 15))):
        assert chain_ops.tile_grid(h, w) == grid
        assert chain_ops.smem_bytes(c) <= dcb_ops.SMEM_LIMIT
        plan = chain_ops.buffer_plan(n)
        assert len(plan) == n and plan[-1][1] == "y"


def test_packed_params_layout():
    c = 128
    blk = _torch_block(_flax_block(c, 0))
    packed = dcb_ops.pack_params(blk, torch.float32)
    assert packed.numel() == dcb_ops.packed_numel(c)
    w0, b0, w2, b2, w3, b3, wf0, bf0, wf2, bf2 = blk
    off = 8 * c * c
    torch.testing.assert_close(packed[:c * c].reshape(c, c), w0[:, :, 0, 0])
    torch.testing.assert_close(packed[2 * c * c:6 * c * c].reshape(4 * c, c),
                               wf0[:, :, 0, 0])
    torch.testing.assert_close(packed[off:off + 9 * c].reshape(3, 3, c),
                               w2[:, 0].permute(1, 2, 0))
    torch.testing.assert_close(packed[-c:], bf2)


def _np_block(c, rng):
    """Torch-layout fp32 params of one block from numpy, lecun-like scale."""
    def t(shape, std):
        return torch.from_numpy((rng.standard_normal(shape) * std
                                 ).astype(np.float32))
    return (t((c, c, 1, 1), c ** -0.5), t((c,), 0.1),
            t((c, 1, 3, 3), 1 / 3), t((c,), 0.1),
            t((c, c, 1, 1), 0.3 * c ** -0.5), t((c,), 0.1),
            t((4 * c, c, 1, 1), c ** -0.5), t((4 * c,), 0.1),
            t((c, 2 * c, 1, 1), 0.3 * (2 * c) ** -0.5), t((c,), 0.1))


@pytest.mark.parametrize("c", FULL_CHAIN_WIDTHS)
def test_chain_packing_round_trip(c):
    rng = np.random.default_rng(c)
    blocks = [_np_block(c, rng) for _ in range(2)]
    # the bf16 kernel's layout, in fp32
    packed = torch.cat([dcb_ops.pack_block(b, torch.float32) for b in blocks])
    size = dcb_ops.packed_numel(c)
    assert packed.numel() == 2 * size
    for j, blk in enumerate(blocks):
        flat = packed[j * size:(j + 1) * size]
        mats = chain_ops.unpack_block(flat, c)
        w0, b0, w2, b2, w3, b3, wf0, bf0, wf2, bf2 = blk
        torch.testing.assert_close(mats["w0"], w0[:, :, 0, 0], rtol=0, atol=0)
        torch.testing.assert_close(mats["w3"], w3[:, :, 0, 0], rtol=0, atol=0)
        torch.testing.assert_close(mats["wf0"], wf0[:, :, 0, 0], rtol=0,
                                   atol=0)
        torch.testing.assert_close(mats["wf2"], wf2[:, :, 0, 0], rtol=0,
                                   atol=0)
        # the tail (taps and biases) is the single-block kernel's
        torch.testing.assert_close(
            flat[8 * c * c:], dcb_ops.pack_params(blk, torch.float32)[8 * c * c:],
            rtol=0, atol=0)
    # one slab of the canonical layout: 8x8 core matrices, K-adjacent next
    m = torch.arange(16 * 16, dtype=torch.float32).reshape(16, 16)
    flat = chain_ops.canonical(m)
    assert flat[64:72].tolist() == m[0, 8:16].tolist()
    assert flat[8:16].tolist() == m[1, 0:8].tolist()
    assert flat[128:136].tolist() == m[8, 0:8].tolist()


def _emulate_chain(x, packed, n, q_last, shortcut=False):
    """The kernels' schedule, tile by tile, in plain PyTorch (fp32):
    ping-pong buffers, 10x10 windows zero outside the frame, dc_0 on the
    window with h masked to 0 outside it, the depthwise, then stage B,
    every weight read slab by slab from the packed tensor in stream
    order. N=1 with ``shortcut`` (the block's input added to its output
    before ``q_last``) is the single-block kernel's schedule. The block is
    computed at the padded width CP, the frame read and written at C; the
    window holds ``window_rows(c)`` rows, and the rest of stage A's two
    64-row tiles (hb's bytes at C=512) is garbage, here NaN."""
    _, h, w, c = x.shape
    cp = dcb_ops.padded_channels(c)
    T, WIN = chain_ops.TILE, chain_ops.WIN
    KC, KF, KS_A, KS_B = chain_ops.KC, chain_ops.KF, chain_ops.KS_A, chain_ops.KS_B
    tiles_y, tiles_x = chain_ops.tile_grid(h, w)
    nan = torch.full_like(x[0], float("nan"))
    bufs = {"x": x[0], "y": nan.clone(), "s": nan.clone()}
    size = dcb_ops.packed_numel(c)
    for j, (src_name, dst_name) in enumerate(chain_ops.buffer_plan(n)):
        src, dst = bufs[src_name], bufs[dst_name]
        flat = packed[j * size:(j + 1) * size]
        tail = flat[8 * cp * cp:]
        dw = tail[:9 * cp].reshape(3, 3, cp)
        b0, b2, b3 = (tail[k * cp:(k + 1) * cp] for k in (9, 10, 11))
        bf0, bf2 = tail[12 * cp:16 * cp], tail[16 * cp:]
        for t in range(tiles_y * tiles_x):
            y0, x0 = chain_ops.tile_origin(t, tiles_x)
            win = torch.full((2 * 64, cp), float("nan"))
            win[:dcb_ops.window_rows(c)] = 0.0
            inside = torch.zeros(WIN * WIN, 1)
            for r in range(WIN * WIN):
                gy, gx = chain_ops.window_pixel(r, y0, x0)
                if 0 <= gy < h and 0 <= gx < w:
                    win[r, :c] = src[gy, gx]
                    inside[r] = 1.0
            off = 0

            def slab(rows, ks):
                nonlocal off
                m = chain_ops.decanonical(flat[off:off + rows * ks], rows, ks)
                off += rows * ks
                return m

            hb = torch.empty(T * T, cp)
            for c0 in range(0, cp, KC):
                acc = torch.zeros(2 * 64, KC)
                for k0 in range(0, cp, KS_A):
                    acc += win[:, k0:k0 + KS_A] @ slab(KC, KS_A).T
                hch = (dcb_ops.wsilu(acc[:WIN * WIN] + b0[c0:c0 + KC])
                       * inside).reshape(WIN, WIN, KC)
                dwc = sum(hch[dy:dy + T, dx:dx + T] * dw[dy, dx, c0:c0 + KC]
                          for dy in range(3) for dx in range(3))
                hb[:, c0:c0 + KC] = (dwc + b2[c0:c0 + KC]).reshape(T * T, KC)
            pix = [(y0 + p // T, x0 + p % T) for p in range(T * T)]
            valid = [gy < h and gx < w for gy, gx in pix]
            xres = torch.stack([src[gy, gx] if ok else torch.zeros(c)
                                for (gy, gx), ok in zip(pix, valid)])
            xres_p = torch.nn.functional.pad(xres, (0, cp - c))
            u = torch.zeros(T * T, cp)
            for k0 in range(0, cp, KS_B):
                u += hb[:, k0:k0 + KS_B] @ slab(cp, KS_B).T
            u = u + xres_p + b3
            yacc = u + bf2
            half = KF // 2
            for f0 in range(0, 2 * cp, KF):
                fa = torch.zeros(T * T, 2 * KF)
                for k0 in range(0, cp, KS_B):
                    fa += u[:, k0:k0 + KS_B] @ slab(2 * KF, KS_B).T
                parts = []
                for g in range(2):
                    a = fa[:, g * KF:g * KF + half]
                    b = fa[:, g * KF + half:(g + 1) * KF]
                    lo = f0 + g * half
                    parts.append(dcb_ops.wsilu(a + bf0[lo:lo + half])
                                 + dcb_ops.wsilu(b + bf0[2 * cp + lo:
                                                         2 * cp + lo + half]))
                f = torch.cat(parts, 1)
                for k0 in range(0, KF, KS_B):
                    yacc = yacc + f[:, k0:k0 + KS_B] @ slab(cp, KS_B).T
            assert off == 8 * cp * cp
            # the padded channels are exactly 0, and never stored
            assert not yacc[:, c:].any()
            yacc = yacc[:, :c]
            if shortcut:
                yacc = yacc + xres
            if j == n - 1 and q_last is not None:
                yacc = yacc * q_last
            for p, ((gy, gx), ok) in enumerate(zip(pix, valid)):
                if ok:
                    dst[gy, gx] = yacc[p]
    return bufs["y"][None]


@pytest.mark.parametrize("with_q", [False, True])
@pytest.mark.parametrize("n,h,w,c", [(2, 9, 11, 128), (3, 17, 30, 128),
                                     (4, 12, 20, 256)])
def test_chain_schedule_emulation_matches_plain(n, h, w, c, with_q):
    rng = np.random.default_rng(n * 10 + h)
    blocks = [_np_block(c, rng) for _ in range(n)]
    x = torch.from_numpy(_x((1, h, w, c), n + h, 1.0))
    q = torch.linspace(0.5, 1.5, c) if with_q else None
    # the bf16 kernel's layout, in fp32
    packed = torch.cat([dcb_ops.pack_block(b, torch.float32) for b in blocks])
    out = _emulate_chain(x, packed, n, q)
    ref = chain_ops.dcb_chain_plain(x, blocks, q)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("h,w,c,shortcut,with_q", [
    (17, 30, 128, True, True), (9, 13, 384, True, False),
    (12, 20, 320, False, False),
    # the widths of the I-frame codec: 192, 368 (computed at 384), 512
    # (104-row window, 3-slot ring B)
    (9, 13, 192, False, True), (11, 9, 368, True, True),
    (9, 10, 368, False, False), (9, 11, 512, False, False)])
def test_single_block_schedule_emulation_matches_plain(h, w, c, shortcut,
                                                        with_q):
    rng = np.random.default_rng(c + h)
    params = _np_block(c, rng)
    x = torch.from_numpy(_x((1, h, w, c), c + w, 1.0))
    q = torch.linspace(0.5, 1.5, c) if with_q else None
    out = _emulate_chain(x, dcb_ops.pack_block(params, torch.float32), 1, q,
                         shortcut)
    ref = dcb_ops.dcb_plain(x, params, q, shortcut)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("c", FULL_CHAIN_WIDTHS)
def test_chain_shared_memory_fits_and_is_independent_of_n(c):
    # the budget is a function of C alone: the kernel takes no other input
    assert list(inspect.signature(chain_ops.smem_bytes).parameters) == ["c"]
    # stage B's ring fills exactly the window's bytes
    assert chain_ops.RING_B * chain_ops.KS_B == chain_ops.WIN_ROWS
    assert chain_ops.smem_bytes(c) <= dcb_ops.SMEM_LIMIT


@pytest.mark.parametrize("kernel,c", [("dcb", c) for c in FULL_DCB_WIDTHS]
                         + [("dcb_chain", c) for c in FULL_CHAIN_WIDTHS])
def test_shared_memory_fits_every_width_of_each_kernel(kernel, c):
    cp = dcb_ops.padded_channels(c)
    assert cp % 64 == 0 and 0 <= cp - c < 64
    # the window holds its 100 pixels in whole core-matrix groups, and
    # stage B's ring fits in its bytes
    rows = dcb_ops.window_rows(c)
    assert rows % 8 == 0 and rows >= dcb_ops.WIN * dcb_ops.WIN
    assert dcb_ops.ring_b(c) * dcb_ops.KS_B * cp <= rows * cp
    assert dcb_ops.smem_bytes(c) <= dcb_ops.SMEM_LIMIT
    if kernel == "dcb_chain":
        # the chain's widths keep the full window, whose bytes ring B fills
        assert cp == c and rows == dcb_ops.WIN_ROWS
        assert dcb_ops.ring_b(c) * dcb_ops.KS_B == rows


@pytest.mark.parametrize("c", [192, 368, 512])
def test_single_block_packing_round_trip_at_the_i_frame_widths(c):
    """pack_block at a width of the I-frame codec: the matrices come back
    at the computed width with the block's own in their top-left corner,
    the two Wf0 halves apart, and zeros everywhere else."""
    rng = np.random.default_rng(c)
    blk = _np_block(c, rng)
    cp = dcb_ops.padded_channels(c)
    flat = dcb_ops.pack_block(blk, torch.float32)
    assert flat.numel() == dcb_ops.packed_numel(c) == 8 * cp * cp + 17 * cp
    mats = dcb_ops.unpack_block(flat, c)
    w0, b0, w2, b2, w3, b3, wf0, bf0, wf2, bf2 = blk

    def padded(m, rows, cols):
        out = torch.zeros(rows, cols)
        out[:m.shape[0], :m.shape[1]] = m
        return out

    wf0 = wf0[:, :, 0, 0]
    want = {"w0": padded(w0[:, :, 0, 0], cp, cp),
            "w3": padded(w3[:, :, 0, 0], cp, cp),
            "wf0": torch.cat([padded(wf0[:2 * c], 2 * cp, cp),
                              padded(wf0[2 * c:], 2 * cp, cp)]),
            "wf2": padded(wf2[:, :, 0, 0], cp, 2 * cp)}
    for k in want:
        torch.testing.assert_close(mats[k], want[k], rtol=0, atol=0)
    tail = flat[8 * cp * cp:]
    torch.testing.assert_close(tail[:9 * cp].reshape(9, cp)[:, :c],
                               w2.reshape(c, 9).t(), rtol=0, atol=0)
    halves = [padded(h[None], 1, 2 * cp)[0] for h in bf0.split(2 * c)]
    torch.testing.assert_close(tail[12 * cp:16 * cp], torch.cat(halves),
                               rtol=0, atol=0)
    torch.testing.assert_close(tail[16 * cp:16 * cp + c], bf2, rtol=0, atol=0)
    assert not tail[16 * cp + c:].any()


def test_chain_buffer_plan_never_writes_x_and_ends_in_y():
    for n in range(1, 9):
        plan = chain_ops.buffer_plan(n)
        assert plan[0][0] == "x" and plan[-1][1] == "y"
        assert all(dst != "x" and src != dst for src, dst in plan)
        assert all(plan[j][1] == plan[j + 1][0] for j in range(n - 1))
