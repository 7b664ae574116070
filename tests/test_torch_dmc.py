"""The port's whole DMC (performance variant) against ``DMC.apply`` of the
JAX package, fp32 on the CPU, same weights and inputs.

Tolerances: the DPB frame and feature at atol 1e-4 (rd-tiny, one frame),
bpp_z at rtol 1e-4. Both sides compute the same fp32 math in another
summation order (~1e-6 relative). At the published widths (C up to 384) the
activations grow through 31 blocks and the difference reaches 4e-4 on the
frame (measured), as it does over three frames of DPB carry at rd-tiny:
those two tests take atol 1e-3. bpp and bpp_y at rtol
5e-3: the rate of a tail symbol is -log2 of the difference of two erf values
within a few fp32 ulp of 1, so a 1-ulp change of one sigma moves bpp_y of
the rd-tiny model by 1.5e-3 relative (measured on the port alone). The
estimate itself is checked on identical inputs in test_torch_entropy.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssgvc_tpu.config import DMCConfig as JaxDMCConfig
from ssgvc_tpu.models.dmc import DMC as JaxDMC
from ssgvc_tpu.models.inference_api import StreamingDMC as JaxStreamingDMC
from ssgvc_tpu.ops.pixel import pixel_unshuffle as jax_unshuffle
from ssgvc_tpu_torch.config import DMCConfig
from ssgvc_tpu_torch.models.dmc import DMC
from ssgvc_tpu_torch.models.inference_api import StreamingDMC
from ssgvc_tpu_torch.utils.weights import load_flax_params
from torch_port_helpers import FULL, RD_TINY, jax_dmc_params
from torch_port_helpers import one_torch_thread  # noqa: F401

HW = 64
QP = 30
BPP_RTOL = 5e-3


def _inputs(seed, ch_d, packed_io):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (1, HW, HW, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (1, HW, HW, 1)) > 0.6).astype(np.float32)
    frame = rng.uniform(0, 1, (1, HW, HW, 3)).astype(np.float32)
    feature = (rng.standard_normal((1, HW // 8, HW // 8, ch_d)) * 0.1
               ).astype(np.float32)
    if packed_io:
        x, mask, frame = (np.asarray(jax_unshuffle(jnp.asarray(a), 8))
                          for a in (x, mask, frame))
    return x, mask, frame, feature


def _compare(widths, packed_io, after_i, seed, atol=1e-4):
    jcfg = JaxDMCConfig.variant("performance", packed_io=packed_io, **widths)
    jmodel = JaxDMC(jcfg)
    params = jax_dmc_params(jmodel, packed_io, widths["ch_d"], seed=seed)
    x, mask, frame, feature = _inputs(seed + 7, widths["ch_d"], packed_io)

    ref = jmodel.apply({"params": params}, jnp.asarray(x), jnp.int32(QP),
                       {"frame": jnp.asarray(frame),
                        "feature": jnp.asarray(feature)},
                       after_i=after_i, mask=jnp.asarray(mask), train=False)

    model = DMC(DMCConfig.variant("performance", packed_io=packed_io,
                                  **widths), device="cpu")
    load_flax_params(model, params)
    t = lambda a: torch.from_numpy(np.array(a))
    with torch.no_grad():
        out = model(t(x), QP, {"frame": t(frame), "feature": t(feature)},
                    after_i=after_i, mask=t(mask))

    for k, rtol in (("bpp", BPP_RTOL), ("bpp_y", BPP_RTOL), ("bpp_z", 1e-4)):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=rtol, err_msg=k)
    for k in ("frame", "feature"):
        np.testing.assert_allclose(out["dpb"][k].numpy(),
                                   np.asarray(ref["dpb"][k]), atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("after_i", [True, False])
def test_dmc_rd_tiny_packed_matches_jax(after_i):
    _compare(RD_TINY, packed_io=True, after_i=after_i, seed=0)


def test_dmc_rd_tiny_raw_io_matches_jax():
    _compare(RD_TINY, packed_io=False, after_i=True, seed=2)


def test_dmc_full_widths_matches_jax():
    _compare(FULL, packed_io=True, after_i=False, seed=4, atol=1e-3)


def test_streaming_matches_jax():
    widths = RD_TINY
    jmodel = JaxDMC(JaxDMCConfig.variant("performance", **widths))
    params = jax_dmc_params(jmodel, False, widths["ch_d"], seed=6)
    jstream = JaxStreamingDMC(jmodel, params)
    model = DMC(DMCConfig.variant("performance", **widths), device="cpu")
    stream = StreamingDMC(load_flax_params(model, params))

    rng = np.random.default_rng(8)
    prev = rng.uniform(0, 1, (1, HW, HW, 3)).astype(np.float32)
    jpacked = jstream.init_dpb(jnp.asarray(prev))
    packed = stream.init_dpb(torch.from_numpy(prev))
    np.testing.assert_allclose(packed.numpy(), np.asarray(jpacked), atol=0)
    for i in range(3):
        frame = rng.uniform(0, 1, (1, HW, HW, 3)).astype(np.float32)
        mask = (rng.uniform(0, 1, (1, HW, HW, 1)) > 0.7).astype(np.float32)
        jpacked, jbpp = jstream.step(jnp.asarray(frame), jnp.asarray(mask),
                                     jnp.int32(QP), jpacked, i == 0)
        packed, bpp = stream.step(torch.from_numpy(frame),
                                  torch.from_numpy(mask), QP, packed, i == 0)
        np.testing.assert_allclose(bpp.numpy(), np.asarray(jbpp),
                                   rtol=BPP_RTOL)
        np.testing.assert_allclose(packed.numpy(), np.asarray(jpacked),
                                   atol=1e-3)
    np.testing.assert_allclose(stream.unpack_frame(packed).numpy(),
                               np.asarray(jstream.unpack_frame(jpacked)),
                               atol=1e-3)
