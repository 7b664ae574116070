"""The port's estimated-rate GOP evaluation, metrics and colour transforms
against the JAX package's, on the CPU.

Tolerances: the numpy metrics and transforms at 1e-12 (the same float64
code). The GOP (rd-tiny DMCI, then rd-tiny performance DMC, 3 frames at
128x128, fp32): per-frame bpp at rtol 5e-3 (tail-symbol rates, as in
test_torch_dmc.py), PSNR and ROI-PSNR within 1e-2 dB and MS-SSIM within
1e-4 (decoded frames ~1e-5 apart, fp32 in another summation order).
128x128 rather than 96x96: there the P-frame codec's hyper-encoder sees an
unpadded 6x6 y and its hierarchical prior comes back 4x4 against a 6x6
temporal prior, in both packages.
"""

import numpy as np
import pytest

from ssgvc_tpu.config import DMCConfig as JaxDMCConfig
from ssgvc_tpu.config import DMCIConfig as JaxDMCIConfig
from ssgvc_tpu.models.dmc import DMC as JaxDMC
from ssgvc_tpu.models.dmci import DMCI as JaxDMCI
from ssgvc_tpu.training import evaluate as jev
from ssgvc_tpu.utils import metrics as jmet
from ssgvc_tpu.utils import transforms as jtr
from ssgvc_tpu_torch.config import DMCConfig, DMCIConfig
from ssgvc_tpu_torch.models.dmc import DMC
from ssgvc_tpu_torch.models.dmci import DMCI
from ssgvc_tpu_torch.training import evaluate as tev
from ssgvc_tpu_torch.utils import metrics as tmet
from ssgvc_tpu_torch.utils import transforms as ttr
from ssgvc_tpu_torch.utils.weights import load_flax_params
from torch_port_helpers import (DMCI_RD_TINY, RD_TINY, jax_dmc_params,
                                jax_dmci_params)


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(shape), 0, 1).astype(
        np.float32)
    return a, b


@pytest.mark.parametrize("name", ["calc_psnr", "calc_ssim", "calc_msssim",
                                  "calc_msssim_rgb"])
def test_metrics_match_jax(name):
    shape = (96, 100, 3) if name == "calc_msssim_rgb" else (180, 190)
    a, b = _pair(1, shape)
    ref = getattr(jmet, name)(a, b)
    out = getattr(tmet, name)(a, b)
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)
    assert tmet.calc_psnr(a, a) == 99.9


@pytest.mark.parametrize("name", ["rgb2ycbcr_np", "ycbcr2rgb_np"])
def test_colour_transforms_match_jax(name):
    a, _ = _pair(2, (5, 7, 3))
    out = getattr(ttr, name)(a)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, getattr(jtr, name)(a), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("fast", [False, True])
def test_frame_metrics_match_jax(fast):
    a, b = _pair(4, (96, 90, 3))
    mask = (np.arange(96 * 90).reshape(96, 90, 1) % 5 == 0).astype(np.float32)
    if fast:
        out = tev._frame_metrics_fast(0.5, a, b, mask)
        ref = jev._frame_metrics_fast(0.5, a, b, mask)
    else:
        out = tev._frame_metrics("P", 0.5, a, b, mask)
        ref = jev._frame_metrics("P", 0.5, a, b, mask)
    assert out.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, float):
            np.testing.assert_allclose(out[k], v, rtol=1e-12, err_msg=k)
        else:
            assert out[k] == v, k


def test_roi_psnr_matches_jax():
    a, b = _pair(3, (16, 12, 3))
    for mask in (np.zeros((16, 12, 1)), (np.arange(192).reshape(16, 12, 1)
                                         % 3 == 0).astype(np.float32)):
        np.testing.assert_allclose(tev._roi_psnr(a, b, mask),
                                   jev._roi_psnr(a, b, mask), rtol=1e-12)


def test_evaluate_gop_estimated_matches_jax():
    hw, t_len, qp = 128, 3, 30
    index_map, qp_shift = (0, 1, 2), (0, 8, 4)
    jdmci = JaxDMCI(JaxDMCIConfig(**DMCI_RD_TINY))
    jdmc = JaxDMC(JaxDMCConfig.variant("performance", **RD_TINY))
    pi = jax_dmci_params(jdmci, hw, seed=0)
    pp = jax_dmc_params(jdmc, False, RD_TINY["ch_d"], hw=hw, seed=1)
    rng = np.random.default_rng(5)
    frames = rng.uniform(0, 1, (t_len, hw, hw, 3)).astype(np.float32)
    masks = (rng.uniform(0, 1, (t_len, hw, hw, 1)) > 0.7).astype(np.float32)

    ref = jev.evaluate_gop_estimated(jdmci, pi, jdmc, pp, frames, masks, qp,
                                     index_map, qp_shift)
    dmci = load_flax_params(DMCI(DMCIConfig(**DMCI_RD_TINY), device="cpu"),
                            pi)
    dmc = load_flax_params(DMC(DMCConfig.variant("performance", **RD_TINY),
                               device="cpu"), pp)
    out = tev.evaluate_gop_estimated(dmci, dmc, frames, masks, qp, index_map,
                                     qp_shift)
    assert [r["frame_type"] for r in out] == ["I", "P", "P"]
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert o.keys() == r.keys()
        assert o["frame_type"] == r["frame_type"]
        np.testing.assert_allclose(o["bpp"], r["bpp"], rtol=5e-3)
        for k in ("psnr", "roi_psnr"):
            assert abs(o[k] - r[k]) <= 1e-2, (k, o[k], r[k])
        assert abs(o["msssim"] - r["msssim"]) <= 1e-4
