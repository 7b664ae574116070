"""Shared set-up for the PyTorch-port parity tests: JAX models initialised
on the CPU, their params perturbed and handed to the port as numpy."""

import numpy as np

import jax
import jax.numpy as jnp

RD_TINY = dict(ch_d=32, ch_y=16, ch_z=16, ch_recon=32)
FULL = dict(ch_d=256, ch_y=128, ch_z=128, ch_recon=320)


def perturbed(tree, seed=1, scale=0.01):
    """Every leaf plus ``scale`` * N(0, 1) noise, so the zero-init tails
    (dc_3, ffn_2) contribute; returned as numpy."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + scale * rng.standard_normal(np.shape(a)).astype(np.float32), tree)


def jax_dmc_params(model, packed_io, ch_d, hw=64, seed=0):
    """JAX DMC params with BOTH feature adaptors declared (a traced
    after_i), perturbed, as a numpy tree."""
    from ssgvc_tpu.ops.pixel import pixel_unshuffle

    x = jnp.zeros((1, hw, hw, 3))
    m = jnp.zeros((1, hw, hw, 1))
    if packed_io:
        x, m = pixel_unshuffle(x, 8), pixel_unshuffle(m, 8)
    dpb = {"frame": x, "feature": jnp.zeros((1, hw // 8, hw // 8, ch_d))}
    p = model.init(jax.random.PRNGKey(seed), x, jnp.int32(3), dpb,
                   after_i=jnp.array(True), mask=m, train=False)["params"]
    return perturbed(p, seed=seed + 1)


DMCI_RD_TINY = dict(enc_dec=48, N=32, z_channel=32)
DMCI_FULL = dict(enc_dec=368, N=256, z_channel=128)


def jax_dmci_params(model, hw=64, seed=0):
    """JAX DMCI params, perturbed, as a numpy tree."""
    x = jnp.zeros((1, hw, hw, 3))
    p = model.init(jax.random.PRNGKey(seed), x, jnp.int32(3),
                   train=False)["params"]
    return perturbed(p, seed=seed + 1)


TINY = dict(ch_d=16, ch_y=8, ch_z=8, ch_recon=16)
DMCI_TINY = dict(enc_dec=32, N=16, z_channel=8)


def drawn_params(model, seed, heads):
    """Weights for the port's ``model`` drawn from ``seed`` as
    ``chip_smoke.random_weights`` draws them (lecun scale, the prior heads
    in ``heads`` at 0.01 so the prior stays O(1); no flax init), loaded into
    ``model``; returns the same params as a flax tree for the JAX
    package."""
    import torch

    import chip_smoke
    from ssgvc_tpu_torch.utils.weights import flax_from_state_dict

    chip_smoke.random_weights(torch, model, seed, heads)
    return flax_from_state_dict(model.state_dict())
