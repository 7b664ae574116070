"""The port's pixel (un)shuffle and patching convs against the JAX package,
fp32 on the CPU. The (un)shuffles are permutations: exact. The convs sum
192 products of unit normals (outputs up to ~30) in another order: rtol and
atol 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssgvc_tpu.ops import pixel as jpix
from ssgvc_tpu_torch.ops import pixel as tpix


@pytest.mark.parametrize("r,c", [(2, 5), (8, 3)])
def test_unshuffle_round_trip_and_parity(r, c):
    x = np.random.default_rng(r).standard_normal((2, 4 * r, 3 * r, c)
                                                 ).astype(np.float32)
    u = tpix.pixel_unshuffle(torch.from_numpy(x), r)
    assert u.shape == (2, 4, 3, c * r * r)
    np.testing.assert_array_equal(u.numpy(),
                                  np.asarray(jpix.pixel_unshuffle(
                                      jnp.asarray(x), r)))
    np.testing.assert_array_equal(tpix.pixel_shuffle(u, r).numpy(), x)
    # channel order c*r*r + i*r + j, as torch's NCHW pixel_unshuffle
    ref = torch.nn.functional.pixel_unshuffle(
        torch.from_numpy(x).permute(0, 3, 1, 2), r).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(u.numpy(), ref.numpy())


def test_patch_down_conv_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 32, 24, 3)).astype(np.float32)
    k = rng.standard_normal((1, 1, 192, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    ref = jpix.patch_down_conv(jnp.asarray(x), jnp.asarray(k),
                               jnp.asarray(b), 8)
    w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    out = tpix.patch_down_conv(torch.from_numpy(x), w, torch.from_numpy(b), 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_patch_up_conv_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 4, 3, 16)).astype(np.float32)
    k = rng.standard_normal((1, 1, 16, 192)).astype(np.float32)
    b = rng.standard_normal(192).astype(np.float32)
    ref = jpix.patch_up_conv(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                             8)
    w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    out = tpix.patch_up_conv(torch.from_numpy(x), w, torch.from_numpy(b), 8)
    assert out.shape == (1, 32, 24, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
