"""The port's DepthConvBlock kernels against their plain versions, on the
card (marked ``gpu``; skipped where no CUDA device is present).

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them:
``python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q --noconftest``.

Tolerance: both sides round at the same points in bf16 and accumulate in
fp32, in another order; the relative Frobenius error of the output must be
at most 1e-2 (one bf16 rounding is 2^-8 ~ 3.9e-3 relative per element).
"""

import numpy as np
import pytest
import torch

from ssgvc_tpu_torch.ops import dcb as dcb_ops
from ssgvc_tpu_torch.ops import dcb_chain as chain_ops

REL_TOL = 1e-2


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
    with pytest.raises(TypeError):
        dcb_ops.dcb(x[:1].float(), p)                # fp32 on the card
    with pytest.raises(ValueError):
        dcb_ops.dcb(torch.zeros((1, 8, 8, 64), dtype=torch.bfloat16,
                                device=dev), block_params(64, rng, dev))
    with pytest.raises(ValueError):                  # a width off the list
        dcb_ops.dcb(torch.zeros((1, 8, 8, 200), dtype=torch.bfloat16,
                                device=dev), block_params(200, rng, dev))
    with pytest.raises(ValueError):                  # the chain's list
        chain_ops.dcb_chain(torch.zeros((1, 8, 8, 368), dtype=torch.bfloat16,
                                        device=dev),
                            [block_params(368, rng, dev)])
