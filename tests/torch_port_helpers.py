"""Shared set-up for the PyTorch-port parity tests: JAX models initialised
on the CPU, their params perturbed and handed to the port as numpy."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for a test module's tests, restored after them: the
    suite runs six test processes on eight cores, where torch's ops on a
    thread per core wait on each other (a test of many small ops ran
    several times slower). Imported by each CPU test module of the port."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

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


def reference_state_dict(params, prefix=""):
    """A reference-style (DCVC-RT) state dict of a flax params tree:
    Sequential indices as their own key components, OIHW conv weights,
    (Q, C, 1, 1) tables, ``prefix`` on every key; ``z_gain`` (which the
    reference lacks) left out."""
    import re

    import torch

    from ssgvc_tpu.utils.torch_import import flatten

    sd = {}
    for path, arr in flatten(params).items():
        if path[-1] == "z_gain":
            continue
        comps = []
        for comp in path[:-1]:
            idx = []
            while (m := re.fullmatch(r"(.+)_(\d+)", comp)):
                comp, d = m.groups()
                idx.insert(0, d)
            comps += [comp, *idx]
        arr = np.asarray(arr, np.float32)
        leaf = path[-1]
        if leaf == "kernel":
            leaf, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:
            arr = arr[:, :, None, None]
        sd[prefix + ".".join(comps + [leaf])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return sd


def tiny_params(seed=3):
    """The JAX tiny DMC (raw io, so its input conv takes the 3-channel
    frame) and the params trees of the tiny DMC and DMCI, drawn through the
    port (no flax init: it takes half a minute op by op)."""
    from chip_smoke import DMC_HEADS, DMCI_HEADS
    from ssgvc_tpu.config import DMCConfig as JaxDMCConfig
    from ssgvc_tpu.models.dmc import DMC as JaxDMC
    from ssgvc_tpu_torch.config import DMCConfig, DMCIConfig
    from ssgvc_tpu_torch.models.dmc import DMC
    from ssgvc_tpu_torch.models.dmci import DMCI

    p = drawn_params(DMC(DMCConfig.variant("performance", **TINY),
                         device="cpu"), seed, DMC_HEADS)
    i = drawn_params(DMCI(DMCIConfig(**DMCI_TINY), device="cpu"), seed + 1,
                     DMCI_HEADS)
    return JaxDMC(JaxDMCConfig.variant("performance", **TINY)), p, i
