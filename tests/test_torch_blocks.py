"""The port's blocks against the JAX package's flax modules, fp32 on the
CPU, same params (JAX init, zero tails perturbed, through the weight
bridge) and inputs. Tolerance atol 2e-5: the same fp32 math summed in
another order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssgvc_tpu.layers import blocks as jb
from ssgvc_tpu_torch.layers import blocks as tb
from ssgvc_tpu_torch.utils.weights import load_flax_params
from torch_port_helpers import perturbed

ATOL = 2e-5


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 0.5


def _run(jmod, tmod, inputs, *extra):
    """Init jmod on inputs, copy its params into tmod, apply both."""
    jin = tuple(jnp.asarray(a) for a in inputs)
    jarg = jin if len(jin) > 1 else jin[0]
    jextra = tuple(jnp.asarray(e) for e in extra)
    params = perturbed(jmod.init(jax.random.PRNGKey(0), jarg, *jextra)
                       ["params"])
    ref = jmod.apply({"params": params}, jarg, *jextra)
    load_flax_params(tmod, params)
    tin = tuple(torch.from_numpy(a) for a in inputs)
    targ = tin if len(tin) > 1 else tin[0]
    with torch.no_grad():
        out = tmod(targ, *(torch.from_numpy(e) for e in extra))
    return out.numpy(), np.asarray(ref)


def test_wsilu_and_chunk_add():
    x = _x((2, 3, 4, 8), 0) * 8
    np.testing.assert_allclose(tb.wsilu(torch.from_numpy(x)).numpy(),
                               np.asarray(jb.wsilu(jnp.asarray(x))),
                               atol=1e-6)
    np.testing.assert_allclose(
        tb.wsilu_chunk_add(torch.from_numpy(x)).numpy(),
        np.asarray(jb.wsilu_chunk_add(jnp.asarray(x))), atol=1e-6)


# (out C, input widths or None, patch_in, shortcut, with quant_step)
DCB_CASES = [
    (16, (24,), 0, False, False),        # 1x1 adaptor
    (32, (16, 24), 0, True, True),       # Concat1x1 adaptor over a tuple
    (16, (8, 8), 0, False, True),        # tuple summing to C: plain concat
    (16, (3,), 8, False, True),          # pixel_unshuffle(8) + 1x1 adaptor
    (32, (32,), 0, True, True),          # no adaptor, shortcut, quant step
    (16, (16,), 0, False, False),        # no adaptor
]


@pytest.mark.parametrize("c,widths,patch_in,shortcut,with_q", DCB_CASES)
def test_depth_conv_block_matches_jax(c, widths, patch_in, shortcut, with_q):
    hw = (32, 48) if patch_in else (6, 7)
    inputs = [_x((1,) + hw + (w,), 10 + i) for i, w in enumerate(widths)]
    extra = ((np.linspace(0.5, 1.5, c, dtype=np.float32)
              .reshape(1, 1, 1, c),) if with_q else ())
    in_ch = widths if len(widths) > 1 else widths[0]
    jmod = jb.DepthConvBlock(c, shortcut=shortcut, patch_in=patch_in)
    tmod = tb.DepthConvBlock(c, in_ch=in_ch, shortcut=shortcut,
                             patch_in=patch_in, device="cpu")
    out, ref = _run(jmod, tmod, inputs, *extra)
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("c,widths", [(16, (8, 8)), (16, (16,))])
def test_depth_conv_block_force_adaptor_matches_jax(c, widths):
    # force_adaptor keeps the adaptor where the widths alone would drop it:
    # a tuple summing to C (Concat1x1), or C itself (1x1 conv)
    inputs = [_x((1, 6, 7, w), 20 + i) for i, w in enumerate(widths)]
    in_ch = widths if len(widths) > 1 else widths[0]
    jmod = jb.DepthConvBlock(c, force_adaptor=True)
    tmod = tb.DepthConvBlock(c, in_ch=in_ch, force_adaptor=True,
                             device="cpu")
    assert tmod.adaptor is not None
    out, ref = _run(jmod, tmod, inputs)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_subpel_conv2x_matches_jax():
    out, ref = _run(jb.SubpelConv2x(8, 3, padding=1),
                    tb.SubpelConv2x(16, 8, 3, padding=1, device="cpu"),
                    [_x((1, 5, 6, 16), 3)])
    assert out.shape == (1, 10, 12, 8)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_residual_block_with_stride2_matches_jax():
    out, ref = _run(jb.ResidualBlockWithStride2(16),
                    tb.ResidualBlockWithStride2(24, 16, device="cpu"),
                    [_x((1, 10, 12, 24), 4)])
    assert out.shape == (1, 5, 6, 16)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_residual_block_upsample_matches_jax():
    out, ref = _run(jb.ResidualBlockUpsample(16),
                    tb.ResidualBlockUpsample(16, 16, device="cpu"),
                    [_x((1, 4, 5, 16), 5)])
    assert out.shape == (1, 8, 10, 16)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_chain_rejects_blocks_with_adaptor_or_shortcut():
    x = torch.zeros((1, 4, 4, 16))
    for blk in (tb.DepthConvBlock(16, in_ch=8, device="cpu"),
                tb.DepthConvBlock(16, shortcut=True, device="cpu")):
        with pytest.raises(ValueError):
            tb.run_chain(x, [blk])
