"""The port's other four DMC variants (plain, old, fast, mask_prop) against
``DMC.apply`` of the JAX package, fp32 on the CPU, same weights and inputs;
``MaskPredictor`` alone, ``shift_qp`` and the 4-channel raw input.

Tolerances, as in test_torch_dmc.py: the DPB frame and feature at atol
1e-4, bpp_z at rtol 1e-4, bpp and bpp_y at rtol 5e-3 (the rate of a tail
symbol is -log2 of the difference of two erf values within a few fp32 ulp
of 1). ``mask_pred`` (mask_prop's predicted logits) at atol 1e-4.
``MaskPredictor`` alone on a non-square 64x96 frame at atol 1e-5: one
antialiased bilinear downsample, four convs and one bilinear upsample in
fp32, ~1e-7 apart.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssgvc_tpu.config import DMCConfig as JaxDMCConfig
from ssgvc_tpu.models.dmc import DMC as JaxDMC
from ssgvc_tpu.models.dmc import MaskPredictor as JaxMaskPredictor
from ssgvc_tpu.ops.pixel import pixel_unshuffle as jax_unshuffle
from ssgvc_tpu_torch.config import DMCConfig
from ssgvc_tpu_torch.models.dmc import DMC, MaskPredictor
from ssgvc_tpu_torch.utils.weights import load_flax_params
from torch_port_helpers import RD_TINY, jax_dmc_params, perturbed

HW = 64
QP = 30
BPP_RTOL = 5e-3
VARIANTS = ("plain", "old", "fast", "mask_prop")

_params = {}


def _variant_params(name):
    """One JAX init per variant (the params of raw and packed io are the
    same tree), cached for the module."""
    if name not in _params:
        jmodel = JaxDMC(JaxDMCConfig.variant(name, **RD_TINY))
        _params[name] = jax_dmc_params(jmodel, False, RD_TINY["ch_d"],
                                       seed=VARIANTS.index(name))
    return _params[name]


def _inputs(seed, packed_io):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (1, HW, HW, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (1, HW, HW, 1)) > 0.6).astype(np.float32)
    frame = rng.uniform(0, 1, (1, HW, HW, 3)).astype(np.float32)
    feature = (rng.standard_normal((1, HW // 8, HW // 8, RD_TINY["ch_d"]))
               * 0.1).astype(np.float32)
    if packed_io:
        x, mask, frame = (np.asarray(jax_unshuffle(jnp.asarray(a), 8))
                          for a in (x, mask, frame))
    return x, mask, frame, feature


@pytest.mark.parametrize("after_i", [True, False])
@pytest.mark.parametrize("packed_io", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_matches_jax(variant, packed_io, after_i):
    params = _variant_params(variant)
    jmodel = JaxDMC(JaxDMCConfig.variant(variant, packed_io=packed_io,
                                         **RD_TINY))
    x, mask, frame, feature = _inputs(11, packed_io)
    ref = jmodel.apply({"params": params}, jnp.asarray(x), jnp.int32(QP),
                       {"frame": jnp.asarray(frame),
                        "feature": jnp.asarray(feature)},
                       after_i=after_i, mask=jnp.asarray(mask), train=False)

    model = load_flax_params(
        DMC(DMCConfig.variant(variant, packed_io=packed_io, **RD_TINY),
            device="cpu"), params)
    t = lambda a: torch.from_numpy(np.array(a))
    with torch.no_grad():
        out = model(t(x), QP, {"frame": t(frame), "feature": t(feature)},
                    after_i=after_i, mask=t(mask))

    for k, rtol in (("bpp", BPP_RTOL), ("bpp_y", BPP_RTOL), ("bpp_z", 1e-4)):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=rtol, err_msg=k)
    for k in ("frame", "feature"):
        np.testing.assert_allclose(out["dpb"][k].numpy(),
                                   np.asarray(ref["dpb"][k]), atol=1e-4,
                                   err_msg=k)
    if variant == "mask_prop":
        assert out["mask_pred"].shape == mask.shape
        np.testing.assert_allclose(out["mask_pred"].numpy(),
                                   np.asarray(ref["mask_pred"]), atol=1e-4)
    else:
        assert out["mask_pred"] is None and ref["mask_pred"] is None


def test_mask_predictor_non_square_matches_jax():
    cfg = JaxDMCConfig.variant("mask_prop", **RD_TINY)
    d = RD_TINY["ch_d"]
    rng = np.random.default_rng(3)
    prev = rng.uniform(-2, 2, (1, 64, 96, 1)).astype(np.float32)
    ctx = rng.standard_normal((1, 8, 12, d)).astype(np.float32)
    ctx_t = rng.standard_normal((1, 8, 12, d)).astype(np.float32)
    jmod = JaxMaskPredictor(cfg)
    params = perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(prev),
                                 jnp.asarray(ctx), jnp.asarray(ctx_t)
                                 )["params"], seed=4, scale=0.1)
    ref = jmod.apply({"params": params}, jnp.asarray(prev), jnp.asarray(ctx),
                     jnp.asarray(ctx_t))
    mod = load_flax_params(MaskPredictor(DMCConfig.variant("mask_prop",
                                                           **RD_TINY),
                                         dtype=torch.float32, device="cpu"),
                           params)
    out = mod(*(torch.from_numpy(a) for a in (prev, ctx, ctx_t)))
    assert out.shape == (1, 64, 96, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5)


def test_shift_qp_matches_jax():
    params = _variant_params("plain")
    jmodel = JaxDMC(JaxDMCConfig.variant("plain", **RD_TINY))
    model = DMC(DMCConfig.variant("plain", **RD_TINY), device="cpu")
    for fa_idx in range(len(model.cfg.qp_shift)):
        ref = jmodel.apply({"params": params}, jnp.int32(21),
                           jnp.int32(fa_idx), method=jmodel.shift_qp)
        assert model.shift_qp(21, fa_idx) == int(ref)


@pytest.mark.parametrize("variant", ["performance", "fast"])
def test_four_channel_x_carries_the_mask(variant):
    """A raw 4-channel x is split into (x, mask), as the reference's packed
    input; the result equals passing the mask apart."""
    model = DMC(DMCConfig.variant(variant, **RD_TINY), device="cpu")
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(
                0.1 * rng.standard_normal(p.shape).astype(np.float32)))
    x, mask, frame, feature = (torch.from_numpy(a)
                               for a in _inputs(12, False))
    dpb = {"frame": frame, "feature": feature}
    a = model(torch.cat([x, mask], dim=-1), QP, dpb, after_i=True)
    b = model(x, QP, dpb, after_i=True, mask=mask)
    for k in ("bpp", "bpp_y", "bpp_z"):
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(a["dpb"]["frame"], b["dpb"]["frame"])
    assert torch.equal(a["dpb"]["feature"], b["dpb"]["feature"])
