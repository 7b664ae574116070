"""The port's I-frame codec (DMCI) and its 4-pass checkerboard prior
against the JAX package, fp32 on the CPU, same weights and inputs.

Tolerances: the masks exactly; compress_prior_4x at 1e-5 (the same fp32
math, another summation order in the callables). DMCI at rd-tiny: the
decoded frame at atol 1e-4 and bpp_z at rtol 1e-4 (fp32, ~1e-6 relative
apart); bpp and bpp_y at rtol 5e-3, since the rate of a tail symbol is
-log2 of the difference of two erf values within a few fp32 ulp of 1 (as
in test_torch_dmc.py). At the full widths (C up to 512, 20 blocks at 368)
the activations grow and the frame takes atol 1e-3, as the full-width DMC
test does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssgvc_tpu.config import DMCIConfig as JaxDMCIConfig
from ssgvc_tpu.models import common as jc
from ssgvc_tpu.models.dmci import DMCI as JaxDMCI
from ssgvc_tpu_torch.config import DMCIConfig
from ssgvc_tpu_torch.models import common as tc
from ssgvc_tpu_torch.models.dmci import DMCI
from ssgvc_tpu_torch.utils.weights import load_flax_params
from torch_port_helpers import DMCI_FULL, DMCI_RD_TINY, jax_dmci_params
from torch_port_helpers import one_torch_thread  # noqa: F401

QP = 30
BPP_RTOL = 5e-3


@pytest.mark.parametrize("c,h,w", [(8, 4, 6), (32, 7, 5), (512, 3, 3)])
def test_checkerboard_masks_4x_match_jax(c, h, w):
    ref = jc.checkerboard_masks_4x(c, h, w)
    out = tc.checkerboard_masks_4x(c, h, w, device="cpu")
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    # the four masks tile every (pixel, channel) exactly once
    np.testing.assert_array_equal(sum(o.numpy() for o in out), 1.0)


@pytest.mark.parametrize("with_fm_s", [False, True])
def test_compress_prior_4x_matches_jax(with_fm_s):
    rng = np.random.default_rng(3)
    n, h, w = 8, 6, 10
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    y = f32(1, h, w, n) * 3
    params = f32(1, h, w, 2 * n + 2)
    wr, br = f32(2 * n + 2, n) * 0.3, f32(n) * 0.1
    ad = [(f32(n, 2 * n) * 0.3, f32(n, 2 * n) * 0.3) for _ in range(3)]
    sp = f32(2 * n, 2 * n) * 0.3
    fm_s = (np.abs(f32(1, 1, 1, n)) + 0.5) if with_fm_s else None

    def run(lib, conv, tanh):
        a = lambda t: conv(t)
        return lib(
            a(y), a(params),
            lambda p: p @ a(wr) + a(br),
            [lambda t, m=m: tanh(t[0] @ a(m[0]) + t[1] @ a(m[1]))
             for m in ad],
            lambda x: x @ a(sp),
            None, False, fm_s=None if fm_s is None else a(fm_s))

    ref = run(jc.compress_prior_4x, jnp.asarray, jnp.tanh)
    out = run(tc.compress_prior_4x, torch.from_numpy, torch.tanh)
    for k in ("y_res", "y_q_hat", "y_q_hat_write", "y_hat", "scales_hat"):
        np.testing.assert_allclose(getattr(out, k).numpy(),
                                   np.asarray(getattr(ref, k)), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


def _compare(widths, hw, seed, atol):
    jmodel = JaxDMCI(JaxDMCIConfig(**widths))
    params = jax_dmci_params(jmodel, hw, seed=seed)
    x = np.random.default_rng(seed + 7).uniform(
        0, 1, (1, hw, hw, 3)).astype(np.float32)
    ref = jmodel.apply({"params": params}, jnp.asarray(x), jnp.int32(QP),
                       train=False)
    model = DMCI(DMCIConfig(**widths), device="cpu")
    load_flax_params(model, params)
    with torch.no_grad():
        out = model(torch.from_numpy(x), QP)
    assert out["dpb"]["feature"] is None
    for k, rtol in (("bpp", BPP_RTOL), ("bpp_y", BPP_RTOL), ("bpp_z", 1e-4)):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=rtol, err_msg=k)
    np.testing.assert_allclose(out["dpb"]["frame"].numpy(),
                               np.asarray(ref["dpb"]["frame"]), atol=atol)


def test_dmci_rd_tiny_matches_jax():
    # 96x96: y is 6x6, replicate-padded to 8x8 before the hyper-encoder and
    # its prior params cropped back to 6x6
    _compare(DMCI_RD_TINY, 96, seed=0, atol=1e-4)


def test_dmci_full_widths_matches_jax():
    _compare(DMCI_FULL, 64, seed=2, atol=1e-3)
