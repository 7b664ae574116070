"""The DepthConvBlock gradient (ops/dcb_grad.py) on the CPU: the autograd
Functions against the JAX package's conv-path DepthConvBlock under
``jax.grad`` in fp32, and against autograd through ``dcb_plain`` in bf16;
each backward kernel's plain version against autograd of the composition
it replaces; determinism; and the batched plain forward against one image
at a time.

Tolerances: fp32 against JAX, each gradient within 1e-4 of its norm (the
same fp32 math summed in another order). bf16 against autograd through
``dcb_plain``: within 2e-2 of its norm, since autograd rounds each
gradient that crosses a bf16 rounding point to bf16 (2^-8 relative per
element, through up to five such points) while the Functions keep fp32.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from ssgvc_tpu.layers import blocks as jb
from ssgvc_tpu_torch.layers import blocks as tb
from ssgvc_tpu_torch.ops import dcb_grad as dg
from ssgvc_tpu_torch.ops.dcb import dcb_plain
from ssgvc_tpu_torch.ops.dcb_chain import dcb_chain_plain
from ssgvc_tpu_torch.utils.weights import flax_from_state_dict, flatten
from ssgvc_tpu_torch.utils.weights import load_flax_params
from torch_port_helpers import perturbed
from torch_port_helpers import one_torch_thread  # noqa: F401

FP32_TOL = 1e-4
BF16_TOL = 2e-2
C, H, W = 16, 6, 7


def _rng(seed):
    return np.random.default_rng(seed)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _block_params(c, rng, dtype=torch.float32):
    """Torch-layout params of one block, every tensor non-zero."""
    def t(shape, std):
        return torch.tensor(rng.standard_normal(shape) * std, dtype=dtype,
                            requires_grad=True)
    return [t((c, c, 1, 1), c ** -0.5), t((c,), 0.1), t((c, 1, 3, 3), 1 / 3),
            t((c,), 0.1), t((c, c, 1, 1), 0.3 * c ** -0.5), t((c,), 0.1),
            t((4 * c, c, 1, 1), c ** -0.5), t((4 * c,), 0.1),
            t((c, 2 * c, 1, 1), 0.3 * (2 * c) ** -0.5), t((c,), 0.1)]


def _jax_chain_grads(n, b, shortcut, with_q, seed):
    """N JAX DepthConvBlocks in sequence (q on the last), their params
    perturbed from a flax init; returns (params trees, x, q, cotangent,
    grads of sum(out * cot) for (trees, x, q))."""
    rng = _rng(seed)
    x = rng.standard_normal((b, H, W, C)).astype(np.float32)
    q = rng.uniform(0.5, 1.5, C).astype(np.float32) if with_q else None
    cot = rng.standard_normal((b, H, W, C)).astype(np.float32)
    mods = [jb.DepthConvBlock(C, shortcut=shortcut) for _ in range(n)]
    trees = [perturbed(m.init(jax.random.PRNGKey(j), jnp.asarray(x))
                       ["params"], seed=seed + j, scale=0.05)
             for j, m in enumerate(mods)]

    def loss(trees, x, q):
        y = x
        for j, (m, p) in enumerate(zip(mods, trees)):
            y = m.apply({"params": p}, y, q if j == n - 1 else None)
        return jnp.sum(y * cot)

    argnums = (0, 1, 2) if with_q else (0, 1)
    args = (trees, jnp.asarray(x), None if q is None else jnp.asarray(q))
    grads = jax.grad(loss, argnums=argnums)(*args)
    return trees, x, q, cot, grads


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("shortcut,with_q", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_dcb_function_matches_jax_grad(b, shortcut, with_q):
    trees, x, q, cot, grads = _jax_chain_grads(1, b, shortcut, with_q,
                                               seed=10 * b + 2 * shortcut
                                               + with_q)
    blk = load_flax_params(tb.DepthConvBlock(C, shortcut=shortcut,
                                             device="cpu"), trees[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    qt = torch.from_numpy(q).requires_grad_(True) if with_q else None
    y = blk(xt, qt)
    (y * torch.from_numpy(cot)).sum().backward()
    got = flatten(flax_from_state_dict(
        {k: p.grad for k, p in blk.named_parameters()}))
    want = flatten(grads[0][0])
    assert got.keys() == want.keys()
    for k in want:
        assert _rel(got[k], want[k]) < FP32_TOL, k
    assert _rel(xt.grad.numpy(), grads[1]) < FP32_TOL
    if with_q:
        assert _rel(qt.grad.numpy(), grads[2]) < FP32_TOL


@pytest.mark.parametrize("n,b,with_q", [(2, 1, True), (3, 3, False),
                                        (2, 3, True)])
def test_dcb_chain_function_matches_jax_grad(n, b, with_q):
    trees, x, q, cot, grads = _jax_chain_grads(n, b, False, with_q,
                                               seed=100 + n + b)
    blocks = [load_flax_params(tb.DepthConvBlock(C, device="cpu"), t)
              for t in trees]
    xt = torch.from_numpy(x).requires_grad_(True)
    qt = torch.from_numpy(q).requires_grad_(True) if with_q else None
    y = tb.run_chain(xt, blocks, qt)
    (y * torch.from_numpy(cot)).sum().backward()
    for blk, want_tree in zip(blocks, grads[0]):
        got = flatten(flax_from_state_dict(
            {k: p.grad for k, p in blk.named_parameters()}))
        want = flatten(want_tree)
        for k in want:
            assert _rel(got[k], want[k]) < FP32_TOL, k
    assert _rel(xt.grad.numpy(), grads[1]) < FP32_TOL
    if with_q:
        assert _rel(qt.grad.numpy(), grads[2]) < FP32_TOL


def _bf16_case(seed, b, shortcut, with_q):
    rng = _rng(seed)
    x = torch.tensor(rng.standard_normal((b, H, W, C)), dtype=torch.bfloat16)
    q = (torch.tensor(rng.uniform(0.5, 1.5, C), dtype=torch.bfloat16)
         if with_q else None)
    cot = torch.tensor(rng.standard_normal((b, H, W, C)),
                       dtype=torch.float32)
    return x, q, _block_params(C, rng), cot


def _grads(fn, x, q, params, cot):
    x = x.detach().clone().requires_grad_(True)
    q = q.detach().clone().requires_grad_(True) if q is not None else None
    params = [p.detach().clone().requires_grad_(True) for p in params]
    (fn(x, q, params).float() * cot).sum().backward()
    return ([x.grad] + ([q.grad] if q is not None else [])
            + [p.grad for p in params])


@pytest.mark.parametrize("b,shortcut,with_q", [(1, False, True),
                                               (3, True, True),
                                               (3, False, False)])
def test_dcb_function_matches_autograd_of_plain_in_bf16(b, shortcut, with_q):
    x, q, params, cot = _bf16_case(7 + b, b, shortcut, with_q)
    got = _grads(lambda x, q, p: dg.dcb_grad(x, p, q, shortcut), x, q,
                 params, cot)
    want = _grads(lambda x, q, p: dcb_plain(x, p, q, shortcut), x, q,
                  params, cot)
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.dtype == w.dtype, i
        assert _rel(a.float().numpy(), w.float().numpy()) < BF16_TOL, i


def test_dcb_chain_function_matches_autograd_of_plain_in_bf16():
    rng = _rng(31)
    x = torch.tensor(rng.standard_normal((2, H, W, C)), dtype=torch.bfloat16)
    q = torch.tensor(rng.uniform(0.5, 1.5, C), dtype=torch.bfloat16)
    blocks = [_block_params(C, rng) for _ in range(3)]
    cot = torch.tensor(rng.standard_normal((2, H, W, C)), dtype=torch.float32)
    flat = [p for ps in blocks for p in ps]
    split = lambda p: [p[10 * j:10 * j + 10] for j in range(3)]
    got = _grads(lambda x, q, p: dg.dcb_chain_grad(x, split(p), q), x, q,
                 flat, cot)
    want = _grads(lambda x, q, p: dcb_chain_plain(x, split(p), q), x, q,
                  flat, cot)
    for i, (a, w) in enumerate(zip(got, want)):
        assert _rel(a.float().numpy(), w.float().numpy()) < BF16_TOL, i


def _t(rng, shape, scale=1.0):
    return torch.tensor(rng.standard_normal(shape) * scale,
                        dtype=torch.float32)


def test_dw_fwd_plain_is_the_depthwise_composition():
    rng = _rng(3)
    a0, taps, b2 = _t(rng, (2, H, W, C)), _t(rng, (9, C), 0.3), _t(rng, (C,))
    g = dg.dw_fwd_plain(a0, taps, b2, torch.float32)
    ref_h = a0 * torch.sigmoid(4 * a0)
    hp = F.pad(ref_h, (0, 0, 1, 1, 1, 1))
    ref_g = b2 + sum(taps[3 * i + j] * hp[:, i:i + H, j:j + W]
                     for i in range(3) for j in range(3))
    torch.testing.assert_close(g, ref_g, rtol=1e-5, atol=1e-5)
    g16 = dg.dw_fwd_plain(a0, taps, b2, torch.bfloat16)
    assert g16.dtype == torch.bfloat16
    assert torch.equal(g16, g.to(torch.bfloat16))


@pytest.mark.parametrize("h,w,c", [(9, 13, 16), (5, 11, 24), (3, 1, 8)])
def test_dw_fwd_plain_matches_the_jax_blocks_lines(h, w, c):
    """dw_fwd_plain against ssgvc_tpu/layers/blocks.py:490-497 on the XLA
    conv path: the flax DepthConvBlock's dc_0 output (a0) and dc_2 output
    (wsilu, then the grouped 3x3 conv) captured from one apply, with dc_2's
    params as taps and b2; fp32, B = 2, H and W not multiples of the 8x8
    tile. Tolerance: 1e-5 of the largest |g| (ten fp32 terms summed in
    another order, and an ulp between XLA's and torch's sigmoid)."""
    rng = _rng(40 + h)
    x = jnp.asarray(rng.standard_normal((2, h, w, c)).astype(np.float32))
    m = jb.DepthConvBlock(c)
    params = perturbed(m.init(jax.random.PRNGKey(h), x)["params"], seed=h,
                       scale=0.05)
    _, state = m.apply({"params": params}, x, capture_intermediates=True,
                       mutable=["intermediates"])
    inter = state["intermediates"]
    a0 = np.array(inter["dc_0"]["__call__"][0])
    want = np.array(inter["dc_2"]["__call__"][0])
    kernel = params["dc_2"]["kernel"]                  # (3, 3, 1, C)
    assert kernel.shape == (3, 3, 1, c)
    taps = torch.from_numpy(kernel.reshape(9, c).copy())
    b2 = torch.from_numpy(params["dc_2"]["bias"])
    got = dg.dw_fwd_plain(torch.from_numpy(a0), taps, b2, torch.float32)
    assert got.shape == want.shape == (2, h, w, c)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("c", [4, 12, 20])
def test_dw_fwd_kernel_refuses_a_width_off_8_before_the_card(c):
    """dw_fwd_cuda moves 4 channels at a time on 8-channel steps: C % 8 !=
    0 raises at the shape check, the first thing it does (no card
    needed to reach it)."""
    a0 = torch.zeros(2, 3, 3, c)
    with pytest.raises(ValueError, match="multiple of 8"):
        dg.dw_fwd_cuda(a0, torch.zeros(9, c), torch.zeros(c),
                       torch.float32)


@pytest.mark.parametrize("with_q", [False, True])
def test_gate_bwd_plain_is_autograd_of_the_gate(with_q):
    rng = _rng(4 + with_q)
    p = _t(rng, (2, H, W, 4 * C)).requires_grad_(True)
    df = _t(rng, (2, H, W, 2 * C))
    dy = _t(rng, (2, H, W, C))
    q = _t(rng, (C,)) if with_q else None
    resid = _t(rng, (2, H, W, C)) if with_q else None
    f = dg.wsilu(p[..., :2 * C]) + dg.wsilu(p[..., 2 * C:])
    (f * df).sum().backward()
    part = torch.zeros(1, dg.GATE_COLS * C + 3)
    dp, fr, dyq = dg.gate_bwd_plain(df, p.detach(), dy, q, resid, part, 3)
    torch.testing.assert_close(dp, p.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(fr, f.detach())
    assert torch.equal(part[0, :3], torch.zeros(3))
    s = dg.grad_reduce_plain(part)[3:]
    torch.testing.assert_close(s[:4 * C], p.grad.sum((0, 1, 2)))
    dyp = dy * q if with_q else dy
    torch.testing.assert_close(s[4 * C:5 * C], dyp.sum((0, 1, 2)))
    if with_q:
        torch.testing.assert_close(dyq, dyp)
        torch.testing.assert_close(s[5 * C:], (dy * resid).sum((0, 1, 2)))
    else:
        assert dyq is None and not s[5 * C:].any()


def test_dw_bwd_plain_is_autograd_of_the_depthwise():
    rng = _rng(6)
    a0 = _t(rng, (3, H, W, C)).requires_grad_(True)
    taps = _t(rng, (9, C), 0.3).requires_grad_(True)
    b2 = _t(rng, (C,)).requires_grad_(True)
    dgr, du = _t(rng, (3, H, W, C)), _t(rng, (3, H, W, C))
    h = dg.wsilu(a0)
    g = F.conv2d(h.permute(0, 3, 1, 2), taps.t().reshape(C, 1, 3, 3), b2,
                 padding=1, groups=C).permute(0, 2, 3, 1)
    (g * dgr).sum().backward()
    part = torch.zeros(1, dg.DW_COLS * C)
    da0 = dg.dw_bwd_plain(dgr, a0.detach(), taps.detach(), du, part, 0)
    torch.testing.assert_close(da0, a0.grad, rtol=1e-5, atol=1e-5)
    s = dg.grad_reduce_plain(part)
    torch.testing.assert_close(s[:9 * C].reshape(9, C), taps.grad,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s[9 * C:10 * C], b2.grad, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(s[10 * C:11 * C], a0.grad.sum((0, 1, 2)),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s[11 * C:], du.sum((0, 1, 2)))


def test_the_dw_halo_stays_inside_each_image():
    """Image 1's input and gradient never reach image 0's outputs: both
    depthwise passes pad each image with zeros, not its neighbour."""
    rng = _rng(8)
    a0, dgr = _t(rng, (2, H, W, C)), _t(rng, (2, H, W, C))
    taps = _t(rng, (9, C), 0.3)
    b2 = _t(rng, (C,))
    g = dg.dw_fwd_plain(a0, taps, b2, torch.float32)
    part = torch.zeros(1, dg.DW_COLS * C)
    da0 = dg.dw_bwd_plain(dgr, a0, taps, dgr, part, 0)
    a1, d1 = a0.clone(), dgr.clone()
    a1[1] = 0
    d1[1] = 0
    g1 = dg.dw_fwd_plain(a1, taps, b2, torch.float32)
    assert torch.equal(g1[0], g[0])
    assert torch.equal(dg.dw_bwd_plain(d1, a1, taps, d1, part, 0)[0],
                       da0[0])


def test_two_runs_give_bit_equal_gradients():
    x, q, params, cot = _bf16_case(21, 3, True, True)
    fn = lambda x, q, p: dg.dcb_grad(x, p, q, True)
    a = _grads(fn, x, q, params, cot)
    b = _grads(fn, x, q, params, cot)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_plain_forward_equals_one_image_at_a_time(dtype):
    rng = _rng(12)
    x = torch.tensor(rng.standard_normal((3, H, W, C)), dtype=dtype)
    q = torch.tensor(rng.uniform(0.5, 1.5, C), dtype=dtype)
    params = [p.detach() for p in _block_params(C, rng)]
    blocks = [[p.detach() for p in _block_params(C, rng)] for _ in range(2)]
    y = dcb_plain(x, params, q, True)
    yc = dcb_chain_plain(x, blocks, q)
    for i in range(3):
        assert torch.equal(y[i:i + 1], dcb_plain(x[i:i + 1], params, q, True))
        assert torch.equal(yc[i:i + 1], dcb_chain_plain(x[i:i + 1], blocks,
                                                        q))


def test_an_optimizer_step_invalidates_the_packed_weights():
    """The packed-weight caches are keyed on each parameter's storage and
    in-place version: an optimizer step bumps the version, so the next
    forward on the card repacks."""
    blk = tb.DepthConvBlock(C, device="cpu")
    tb.init_(blk, torch.Generator().manual_seed(0))
    x = torch.zeros(1, 2, 2, C)
    before = tb._pack_key(x, blk.core_params())
    for p in blk.parameters():
        p.grad = torch.ones_like(p)
    torch.optim.SGD(blk.parameters(), lr=0.1).step()
    assert tb._pack_key(x, blk.core_params()) != before
