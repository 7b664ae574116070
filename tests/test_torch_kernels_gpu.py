"""The port's DepthConvBlock kernels against their plain versions, on the
card (marked ``gpu``; skipped where no CUDA device is present).

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them:
``python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q --noconftest``.

Tolerances: in bf16 both sides round at the same points and accumulate in
fp32, in another order; the relative Frobenius error of the output must be
at most 1e-2 (one bf16 rounding is 2^-8 ~ 3.9e-3 relative per element). In
fp32 (``csrc/dcb_tf32.cu`` in 3xTF32 from a computed width of 128 up,
``csrc/dcb_f32.cu`` in SIMT below) the sums are taken in another order and
3xTF32 drops each product's lo x lo term (~2^-22 relative): max |out - ref|
/ max |ref| at most 1e-5, with TF32 off for the plain version (both flags,
set in ``_card``).
"""

import numpy as np
import pytest
import torch

from ssgvc_tpu_torch.ops import dcb as dcb_ops
from ssgvc_tpu_torch.ops import dcb_chain as chain_ops

REL_TOL = 1e-2
F32_TOL = 1e-5
# every width a profile builds (the single block to 512, the chain to 384)
# and one per computed width (C rounded up to 64; 448 at 512)
SINGLE_WIDTHS = (8, 16, 24, 32, 48, 64, 96, 128, 160, 184, 192, 256, 320,
                 368, 384, 448, 512)
CHAIN_WIDTHS = tuple(c for c in SINGLE_WIDTHS if c <= 384 and c != 368)
# one width per fp32 route and computed width: SIMT (CP 64), then 3xTF32
F32_ROUTE_WIDTHS = (32, 96, 160, 256, 320, 368, 512)


def f32_count(c):
    """The launch counter of the fp32 kernel that takes width c."""
    return "launches_tf32" if dcb_ops.uses_tf32(c) else "launches_f32"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def block_params(c, rng, device):
    """Torch-layout fp32 params of one block at a lecun-like scale, with the
    rezero tails (dc_3, ffn_2) small but non-zero."""
    def t(shape, std):
        return torch.tensor(rng.standard_normal(shape) * std,
                            dtype=torch.float32, device=device)
    return (t((c, c, 1, 1), c ** -0.5), t((c,), 0.1),
            t((c, 1, 3, 3), 1 / 3), t((c,), 0.1),
            t((c, c, 1, 1), 0.3 * c ** -0.5), t((c,), 0.1),
            t((4 * c, c, 1, 1), c ** -0.5), t((4 * c,), 0.1),
            t((c, 2 * c, 1, 1), 0.3 * (2 * c) ** -0.5), t((c,), 0.1))


def rel_err(out, ref):
    out, ref = out.float(), ref.float()
    return float(torch.linalg.vector_norm(out - ref)
                 / torch.linalg.vector_norm(ref))


def max_rel(out, ref):
    """max |out - ref| / max |ref|: the fp32 kernels' measure."""
    return float((out - ref).abs().max() / ref.abs().max())


def within(out, ref):
    """The dtype's tolerance: bf16 relative Frobenius, fp32 max relative."""
    assert torch.isfinite(out.float()).all()
    if out.dtype == torch.float32:
        return max_rel(out, ref) <= F32_TOL
    return rel_err(out, ref) <= REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kernel,c", [("dcb", c) for c in SINGLE_WIDTHS]
                         + [("dcb_chain", c) for c in CHAIN_WIDTHS])
def test_kernels_at_every_width(kernel, c, dtype):
    """Both kernels at every width of every profile, in both dtypes, B=2 on
    a ragged 9x13 frame (q on, and the shortcut for the single block)."""
    dev = _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(c)
    x = torch.tensor(rng.standard_normal((2, 9, 13, c)), dtype=dt,
                     device=dev)
    q = torch.linspace(0.5, 1.5, c, device=dev).to(dt)
    counts = (dcb_ops, "launches" if dt == torch.bfloat16 else f32_count(c))
    if kernel == "dcb":
        p = block_params(c, rng, dev)
        before = getattr(*counts)
        out = dcb_ops.dcb(x, p, q, shortcut=True)
        ref = dcb_ops.dcb_plain(x, p, q, True)
    else:
        blocks = [block_params(c, rng, dev) for _ in range(3)]
        counts = (chain_ops, counts[1])
        before = getattr(*counts)
        out = chain_ops.dcb_chain(x, blocks, q)
        ref = chain_ops.dcb_chain_plain(x, blocks, q)
    torch.cuda.synchronize()
    assert getattr(*counts) == before + 1
    assert out.dtype == dt and out.shape == x.shape
    assert within(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["dcb", "dcb_chain"])
def test_fp32_kernels_repeat_bit_for_bit(kernel):
    """The fp32 kernels sum in a fixed order: two launches agree exactly
    (VideoCodec's decoder reproduces its encoder in fp32), on both routes
    (SIMT at C = 32, 3xTF32 at every computed width it takes)."""
    dev = _card()
    rng = np.random.default_rng(11)
    for c in F32_ROUTE_WIDTHS:
        if kernel == "dcb_chain" and c > chain_ops.MAX_CHANNELS:
            continue
        x = torch.tensor(rng.standard_normal((1, 40, 52, c)),
                         dtype=torch.float32, device=dev)
        q = torch.linspace(0.5, 1.5, c, device=dev)
        tf32 = dcb_ops.uses_tf32(c)
        if kernel == "dcb":
            packed = dcb_ops.pack_kernel(block_params(c, rng, dev),
                                         torch.float32)
            fn = dcb_ops.dcb_tf32_cuda if tf32 else dcb_ops.dcb_f32_cuda
            run = lambda: fn(x, packed, q, shortcut=True)
        else:
            packed = chain_ops.pack_chain(
                [block_params(c, rng, dev) for _ in range(3)], torch.float32)
            fn = (chain_ops.dcb_chain_tf32_cuda if tf32
                  else chain_ops.dcb_chain_f32_cuda)
            run = lambda: fn(x, packed, q)
        first, second = run(), run()
        torch.cuda.synchronize()
        assert torch.equal(first, second), c


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kernel", ["dcb", "dcb_chain"])
def test_batch_equals_one_image_at_a_time_at_a_small_width(kernel, dtype):
    """B=4 in one launch equals four B=1 launches bit for bit at C=32
    (computed at 64 in bf16); in fp32 also at one width per computed width
    of the 3xTF32 route."""
    dev = _card()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(12)
    widths = (32,) if dt == torch.bfloat16 else F32_ROUTE_WIDTHS
    for c in widths:
        if kernel == "dcb_chain" and c > chain_ops.MAX_CHANNELS:
            continue
        x = torch.tensor(rng.standard_normal((4, 8, 8, c)), dtype=dt,
                         device=dev)
        if kernel == "dcb":
            p = block_params(c, rng, dev)
            run = lambda t: dcb_ops.dcb(t, p, shortcut=True)
        else:
            blocks = [block_params(c, rng, dev) for _ in range(2)]
            run = lambda t: chain_ops.dcb_chain(t, blocks)
        batched = run(x)
        single = torch.cat([run(x[i:i + 1].contiguous()) for i in range(4)])
        torch.cuda.synchronize()
        assert torch.equal(batched, single), c


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,c,shortcut,with_q", [
    (12, 16, 128, False, False), (17, 30, 128, True, True),
    (20, 24, 320, False, True), (9, 13, 384, True, False),
    (16, 24, 256, False, False),
    # main-path shapes: more tiles than SMs, ragged last tile row or column
    (136, 240, 320, False, False), (68, 120, 384, False, False),
    (68, 120, 256, True, False), (34, 60, 128, True, False),
    # the I-frame codec's widths: C=368 computed at 384, C=512 on its own
    # shared-memory plan; main-path shapes, then small ragged ones
    (136, 240, 368, False, False), (136, 240, 368, True, True),
    (136, 240, 192, False, False), (68, 120, 512, False, False),
    (9, 13, 192, True, True), (11, 9, 368, False, True),
    (17, 30, 512, True, True)])
def test_dcb_kernel_matches_plain(h, w, c, shortcut, with_q):
    dev = _card()
    rng = np.random.default_rng(c + h)
    x = torch.tensor(rng.standard_normal((1, h, w, c)), dtype=torch.bfloat16,
                     device=dev)
    q = (torch.linspace(0.5, 1.5, c, device=dev).to(torch.bfloat16)
         if with_q else None)
    p = block_params(c, rng, dev)
    before = dcb_ops.launches
    out = dcb_ops.dcb(x, p, q, shortcut)
    torch.cuda.synchronize()
    assert dcb_ops.launches == before + 1
    ref = dcb_ops.dcb_plain(x, p, q, shortcut)
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    assert rel_err(out, ref) <= REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,w,c,with_q", [
    (2, 24, 16, 256, False), (4, 20, 28, 256, True), (3, 17, 30, 384, False),
    (2, 9, 11, 128, True),
    (1, 12, 20, 320, True), (5, 12, 20, 128, False),     # N=1 and N=5
    (2, 9, 11, 256, False),   # 4 tiles: fewer than the card's SMs
    (3, 68, 120, 384, False),  # a main-path chain
])
def test_dcb_chain_kernel_matches_plain(n, h, w, c, with_q):
    dev = _card()
    rng = np.random.default_rng(n * 100 + c)
    x = torch.tensor(rng.standard_normal((1, h, w, c)), dtype=torch.bfloat16,
                     device=dev)
    q = (torch.linspace(0.5, 1.5, c, device=dev).to(torch.bfloat16)
         if with_q else None)
    blocks = [block_params(c, rng, dev) for _ in range(n)]
    before = chain_ops.launches
    out = chain_ops.dcb_chain(x, blocks, q)
    torch.cuda.synchronize()
    assert chain_ops.launches == before + 1     # one launch whatever N
    ref = chain_ops.dcb_chain_plain(x, blocks, q)
    assert torch.isfinite(out.float()).all()
    assert rel_err(out, ref) <= REL_TOL


@pytest.mark.gpu
def test_dcb_chain_kernel_repeats_bit_for_bit():
    """Two launches on the same inputs agree exactly: the grid barrier and
    the mbarrier rings carry no state from one launch to the next."""
    dev = _card()
    rng = np.random.default_rng(7)
    c, n = 256, 3
    x = torch.tensor(rng.standard_normal((1, 20, 28, c)),
                     dtype=torch.bfloat16, device=dev)
    packed = chain_ops.pack_chain([block_params(c, rng, dev)
                                   for _ in range(n)], torch.bfloat16)
    first = chain_ops.dcb_chain_cuda(x, packed)
    second = chain_ops.dcb_chain_cuda(x, packed)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_dcb_kernel_repeats_bit_for_bit():
    """Two launches on the same inputs agree exactly: the mbarrier rings
    carry no state from one launch to the next."""
    dev = _card()
    rng = np.random.default_rng(8)
    c = 256
    # 13 x 15 tiles: more than the card's SMs, so thread blocks take
    # several tiles each; ragged last tile row
    x = torch.tensor(rng.standard_normal((1, 100, 120, c)),
                     dtype=torch.bfloat16, device=dev)
    q = torch.linspace(0.5, 1.5, c, device=dev).to(torch.bfloat16)
    packed = dcb_ops.pack_block(block_params(c, rng, dev), torch.bfloat16)
    first = dcb_ops.dcb_cuda(x, packed, q, shortcut=True)
    second = dcb_ops.dcb_cuda(x, packed, q, shortcut=True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take():
    dev = _card()
    rng = np.random.default_rng(0)
    p = block_params(128, rng, dev)
    x = torch.zeros((2, 8, 8, 128), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        dcb_ops.dcb(x[0], p)                         # no batch axis
    with pytest.raises(ValueError):
        dcb_ops.dcb(x.transpose(1, 2), p)            # not contiguous NHWC
    # fp32 runs (csrc/dcb_tf32.cu at C = 128), and so does any width that
    # is a multiple of 8 (C = 200, computed at 256)
    assert dcb_ops.dcb(x[:1].float(), p).dtype == torch.float32
    for dt in (torch.bfloat16, torch.float32):
        dcb_ops.dcb(torch.zeros((1, 8, 8, 200), dtype=dt, device=dev),
                    block_params(200, rng, dev))
    with pytest.raises(TypeError):
        dcb_ops.dcb(x[:1].half(), p)                 # float16
    with pytest.raises(TypeError):
        chain_ops.dcb_chain(x[:1].half(), [p])
    for what, c in (("C % 8 != 0", 60), ("C > 512", 520)):
        for dt in (torch.bfloat16, torch.float32):
            with pytest.raises(ValueError):
                dcb_ops.dcb(torch.zeros((1, 8, 8, c), dtype=dt, device=dev),
                            block_params(c, rng, dev))
    for dt in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError):              # the chain stops at 384
            chain_ops.dcb_chain(torch.zeros((1, 8, 8, 392), dtype=dt,
                                            device=dev),
                                [block_params(392, rng, dev)])


# The SIMT fp32 kernel (csrc/dcb_f32.cu, C <= 64) at the RD recipe's shapes:
# B = 8 images of 1x1 to 8x8 (units of whole images) at C = 32 and 64
RD_SHAPES = [(8, s, s, c) for s in (1, 2, 4, 8) for c in (32, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("shortcut,with_q", [(False, False), (True, False),
                                             (False, True), (True, True)])
@pytest.mark.parametrize("b,h,w,c", RD_SHAPES)
def test_simt_kernel_at_the_rd_shapes(b, h, w, c, shortcut, with_q):
    dev = _card()
    rng = np.random.default_rng(h * 1000 + c)
    x = torch.tensor(rng.standard_normal((b, h, w, c)), dtype=torch.float32,
                     device=dev)
    q = torch.linspace(0.5, 1.5, c, device=dev) if with_q else None
    p = block_params(c, rng, dev)
    before = dcb_ops.launches_f32
    out = dcb_ops.dcb_f32_cuda(x, dcb_ops.pack_f32(p), q, shortcut)
    torch.cuda.synchronize()
    assert dcb_ops.launches_f32 == before + 1
    assert out.shape == x.shape and out.dtype == torch.float32
    assert within(out, dcb_ops.dcb_plain(x, p, q, shortcut))


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,n,with_q", [
    (8, 8, 8, 2, False), (8, 8, 8, 2, True), (8, 8, 8, 4, False),
    (1, 40, 52, 2, True), (1, 40, 52, 4, False)])
def test_simt_chain_at_the_rd_shapes(b, h, w, n, with_q):
    """The chain on whole 8x8 images (in shared memory, no scratch) and on
    a 40x52 frame (tiles: the cooperative path with a grid barrier)."""
    dev = _card()
    c = 64
    rng = np.random.default_rng(n * 100 + h)
    x = torch.tensor(rng.standard_normal((b, h, w, c)), dtype=torch.float32,
                     device=dev)
    q = torch.linspace(0.5, 1.5, c, device=dev) if with_q else None
    blocks = [block_params(c, rng, dev) for _ in range(n)]
    assert dcb_ops.f32_plan(b, h, w).whole == (h * w <= 64)
    before = chain_ops.launches_f32
    out = chain_ops.dcb_chain_f32_cuda(
        x, chain_ops.pack_chain(blocks, torch.float32), q)
    torch.cuda.synchronize()
    assert chain_ops.launches_f32 == before + 1
    assert within(out, chain_ops.dcb_chain_plain(x, blocks, q))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["dcb", "dcb_chain"])
@pytest.mark.parametrize("s", [1, 8])
def test_simt_batch_of_eight_equals_eight_single_images(kernel, s):
    """B = 8 in one launch (one unit of eight 1x1 images, or eight units of
    one 8x8 image) equals eight B = 1 launches bit for bit: the K split is
    C's alone, and each image's arithmetic the same in any unit."""
    dev = _card()
    c = 64
    rng = np.random.default_rng(s + 20)
    x = torch.tensor(rng.standard_normal((8, s, s, c)), dtype=torch.float32,
                     device=dev)
    q = torch.linspace(0.5, 1.5, c, device=dev)
    if kernel == "dcb":
        packed = dcb_ops.pack_f32(block_params(c, rng, dev))
        run = lambda t: dcb_ops.dcb_f32_cuda(t, packed, q, shortcut=True)
    else:
        packed = chain_ops.pack_chain([block_params(c, rng, dev)
                                       for _ in range(4)], torch.float32)
        run = lambda t: chain_ops.dcb_chain_f32_cuda(t, packed, q)
    batched = run(x)
    single = torch.cat([run(x[i:i + 1].contiguous()) for i in range(8)])
    again = run(x)
    torch.cuda.synchronize()
    assert torch.equal(batched, single)
    assert torch.equal(batched, again)


@pytest.mark.gpu
def test_simt_kernel_refuses_wider_blocks():
    """C >= 72 runs on the 3xTF32 kernel; the SIMT launchers refuse it."""
    dev = _card()
    rng = np.random.default_rng(72)
    c = 72
    x = torch.zeros((1, 4, 4, c), dtype=torch.float32, device=dev)
    p = block_params(c, rng, dev)
    with pytest.raises(ValueError):
        dcb_ops.dcb_f32_cuda(x, dcb_ops.pack_f32(p))
    with pytest.raises(ValueError):
        chain_ops.dcb_chain_f32_cuda(x, dcb_ops.pack_f32(p))
    # the routed call takes it, on the 3xTF32 kernel
    before = dcb_ops.launches_tf32
    dcb_ops.dcb(x, p)
    assert dcb_ops.launches_tf32 == before + 1


# ---- qconv: the W8A8 int8 conv (csrc/qconv.cu) ----
# Its plain version sums the int8 products exactly and rounds the epilogue
# as the kernel does, so the two agree bit for bit.

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cin", [1, 40, 64])
@pytest.mark.parametrize("site", [(1, 1, 0), (2, 2, 0), (3, 1, 1), (3, 2, 1)],
                         ids=lambda s: "k%ds%dp%d" % s)
def test_qconv_kernel_matches_plain_bit_for_bit(site, cin, dtype):
    from ssgvc_tpu_torch.ops import qconv as Q

    dev = _card()
    k, s, p = site
    rng = np.random.default_rng(cin * 10 + k)
    x = torch.tensor(rng.standard_normal((2, 13, 21, cin)), dtype=dtype,
                     device=dev)
    w = torch.tensor(rng.standard_normal((72, cin, k, k)) * 0.2,
                     dtype=torch.float32, device=dev)
    b = torch.tensor(rng.standard_normal(72) * 0.1, dtype=torch.float32,
                     device=dev)
    wq, s_w = Q.quantize_weight(w)
    for s_x in (Q.dynamic_scale(x),
                torch.tensor(Q.static_scale(2.0), device=dev)):
        for out_dtype in (dtype, torch.float32):
            before = Q.launches
            out = Q.qconv(x, wq, s_w, b, s_x, k, s, (p, p, p, p), out_dtype)
            ref = Q.qconv_plain(x, wq, s_w, b, s_x, k, s, (p, p, p, p),
                                out_dtype)
            torch.cuda.synchronize()
            assert Q.launches == before + 1
            assert out.shape == ref.shape and out.dtype == out_dtype
            assert torch.equal(out, ref)
    # asymmetric padding and an input view off the 16-byte grid (the
    # per-element loads)
    xs = torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:].view(
        x.shape)
    xs.copy_(x)
    for pads in ((0, p, p, 0), (p, 0, 0, p)):
        out = Q.qconv_cuda(xs, wq, s_w, b, Q.dynamic_scale(x), k, s, pads,
                           dtype)
        ref = Q.qconv_plain(x, wq, s_w, b, Q.dynamic_scale(x), k, s, pads,
                            dtype)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)


@pytest.mark.gpu
def test_qconv_refuses_what_it_does_not_take():
    from ssgvc_tpu_torch.ops import qconv as Q

    dev = _card()
    x = torch.zeros((1, 4, 4, 16), dtype=torch.float16, device=dev)
    wq, s_w = Q.quantize_weight(torch.ones((8, 16, 1, 1), device=dev))
    b = torch.zeros(8, device=dev)
    s_x = torch.ones((), device=dev)
    with pytest.raises(TypeError):
        Q.qconv(x, wq, s_w, b, s_x, 1, 1, (0, 0, 0, 0))
    with pytest.raises(ValueError):
        Q.qconv(x.float(), wq[:, :16].contiguous(), s_w, b, s_x, 1, 1,
                (0, 0, 0, 0))
    with pytest.raises(ValueError):
        Q.qconv(x.float(), wq, s_w, b, s_x.cpu(), 1, 1, (0, 0, 0, 0))
