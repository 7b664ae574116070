"""The port's batched RD evaluation (``make_batched_gop_eval``,
``evaluate_rd_batched``) and collapse tripwire (``latent_liveness``,
``liveness_collapsed``) against the JAX package's, on the CPU, at the tiny
profile with the same weights in both (``utils/weights.py``); inputs drawn
from numpy with a seed.

Tolerances: the RD curve as test_torch_evaluate.py holds the GOP: bpp at
rtol 5e-3 (tail-symbol rates are ill-conditioned at the ulp level), PSNR and
ROI-PSNR within 1e-2 dB. The batched path against
``evaluate_gop_estimated`` clip by clip, both in the port: run one clip at a
time, 1e-5 relative (the same ops on the same shapes: they agree exactly on
this CPU); run as one batch of two clips, PSNR and ROI-PSNR still at 1e-5
relative, bpp at rtol 5e-3, since the CPU's convs sum a batch of two in
another order and the rate amplifies those ulps (1e-3 at most here).
Liveness: ``alive_y`` and
``alive_z`` within 2e-3 absolute (one quantizer decision flipped by an fp32
ulp moves them by 1/N, N the latent's size), the cross-clip PSNR within
1e-2 dB, and the same verdict.
"""

import numpy as np
import pytest
import torch

from ssgvc_tpu.config import DMCConfig as JaxDMCConfig
from ssgvc_tpu.config import DMCIConfig as JaxDMCIConfig
from ssgvc_tpu.models.dmc import DMC as JaxDMC
from ssgvc_tpu.models.dmci import DMCI as JaxDMCI
from ssgvc_tpu.training import evaluate as jev
from ssgvc_tpu_torch.config import DMCConfig, DMCIConfig
from ssgvc_tpu_torch.models.dmc import DMC
from ssgvc_tpu_torch.models.dmci import DMCI
from ssgvc_tpu_torch.training import evaluate as tev
from ssgvc_tpu_torch.utils.weights import load_flax_params
from torch_port_helpers import (DMCI_TINY, TINY, jax_dmc_params,
                                jax_dmci_params)

HW, T_LEN, QPS = 64, 3, (8, 32)
INDEX_MAP, QP_SHIFT = (0, 1, 2), (0, 8, 4)


def _clips(seed, n=2, t_len=T_LEN, hw=HW):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 1, (t_len, hw, hw, 3)).astype(np.float32),
             (rng.uniform(0, 1, (t_len, hw, hw, 1)) > 0.7).astype(
                 np.float32)) for _ in range(n)]


def _models(variant):
    """(JAX DMCI, its params, JAX DMC, its params, port DMCI, port DMC) at
    the tiny profile, the same weights in both packages."""
    jdmci = JaxDMCI(JaxDMCIConfig(**DMCI_TINY))
    jdmc = JaxDMC(JaxDMCConfig.variant(variant, **TINY))
    pi = jax_dmci_params(jdmci, HW, seed=0)
    pp = jax_dmc_params(jdmc, False, TINY["ch_d"], hw=HW, seed=1)
    dmci = load_flax_params(DMCI(DMCIConfig(**DMCI_TINY), device="cpu"), pi)
    dmc = load_flax_params(DMC(DMCConfig.variant(variant, **TINY),
                               device="cpu"), pp)
    return jdmci, pi, jdmc, pp, dmci.eval(), dmc.eval()


@pytest.mark.parametrize("variant", ["performance", "mask_prop"])
def test_batched_rd_eval_matches_jax(variant):
    jdmci, pi, jdmc, pp, dmci, dmc = _models(variant)
    clips = _clips(5)
    run_j = jev.make_batched_gop_eval(jdmci, jdmc, INDEX_MAP, QP_SHIFT,
                                      seq_len=T_LEN)
    ref = jev.evaluate_rd_batched(run_j, pi, pp, clips, QPS)
    run_t = tev.make_batched_gop_eval(dmci, dmc, INDEX_MAP, QP_SHIFT, T_LEN)
    out = tev.evaluate_rd_batched(run_t, clips, QPS, device="cpu")
    assert out.keys() == ref.keys()
    assert out["qp"] == ref["qp"] == list(QPS)
    np.testing.assert_allclose(out["bpp"], ref["bpp"], rtol=5e-3)
    for k in ("psnr", "roi_psnr"):
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=1e-2,
                                   err_msg=k)
    # MS-SSIM is opt-in, and needs 88 pixels a side
    assert out["msssim"] == ref["msssim"] == [None] * len(QPS)


def test_batched_rd_eval_returns_recons_and_rates_of_each_frame():
    *_, dmci, dmc = _models("performance")
    clips = _clips(6)
    frames = np.stack([c[0] for c in clips])
    masks = np.stack([c[1] for c in clips])
    run = tev.make_batched_gop_eval(dmci, dmc, INDEX_MAP, QP_SHIFT, T_LEN)
    recons, bpps = run(torch.from_numpy(frames), torch.from_numpy(masks), 20)
    assert tuple(recons.shape) == frames.shape
    assert tuple(bpps.shape) == (len(clips), T_LEN)
    assert torch.isfinite(recons).all() and (bpps > 0).all()
    assert not recons.requires_grad


@pytest.mark.parametrize("variant", ["performance", "mask_prop"])
def test_batched_path_equals_the_gop_evaluation_clip_by_clip(variant):
    *_, dmci, dmc = _models(variant)
    clips = _clips(7)
    run = tev.make_batched_gop_eval(dmci, dmc, INDEX_MAP, QP_SHIFT, T_LEN)
    frames = np.stack([c[0] for c in clips])
    masks = np.stack([c[1] for c in clips])
    qp = 32
    recons, bpps = run(torch.from_numpy(frames), torch.from_numpy(masks), qp)
    for b, (f, m) in enumerate(clips):
        ref = tev.evaluate_gop_estimated(dmci, dmc, f, m, qp, INDEX_MAP,
                                         QP_SHIFT)
        one = run(torch.from_numpy(frames[b:b + 1]),
                  torch.from_numpy(masks[b:b + 1]), qp)
        for t in range(T_LEN):
            for (rec, bpp), batch, i in (((recons, bpps), 2, b),
                                         (one, 1, 0)):
                got = tev._frame_metrics_fast(float(bpp[i, t]), f[t],
                                              rec[i, t].numpy(), m[t])
                for k in ("bpp", "psnr", "roi_psnr"):
                    rtol = 5e-3 if (k, batch) == ("bpp", 2) else 1e-5
                    np.testing.assert_allclose(
                        got[k], ref[t][k], rtol=rtol,
                        err_msg=f"batch of {batch}: clip {b} frame {t} {k}")


def test_latent_liveness_matches_jax():
    _, _, jdmc, pp, _, dmc = _models("performance")
    clip_a, clip_b = _clips(8, n=2, t_len=2)
    ref = jev.latent_liveness(jdmc, pp, clip_a, clip_b)
    out = tev.latent_liveness(dmc, clip_a, clip_b)
    assert out.keys() == ref.keys() == {"8", "32", "56"}
    for qp, r in ref.items():
        assert out[qp].keys() == r.keys()
        for k in ("alive_y", "alive_z"):
            assert abs(out[qp][k] - r[k]) <= 2e-3, (qp, k, out[qp][k], r[k])
        assert abs(out[qp]["recon_cross_clip_psnr"]
                   - r["recon_cross_clip_psnr"]) <= 1e-2, qp
    assert tev.liveness_collapsed(out) == jev.liveness_collapsed(ref)
    # the hooks are gone afterwards
    assert not dmc.encoder._forward_hooks
    assert not dmc.hyper_encoder._forward_hooks


@pytest.mark.parametrize("report", [
    {"8": dict(alive_y=0.2, alive_z=0.1, recon_cross_clip_psnr=14.0),
     "32": dict(alive_y=0.4, alive_z=0.2, recon_cross_clip_psnr=30.0)},
    {"8": dict(alive_y=0.2, alive_z=0.1, recon_cross_clip_psnr=26.0),
     "32": dict(alive_y=0.4, alive_z=0.2, recon_cross_clip_psnr=30.0)},
    {"8": dict(alive_y=0.0, alive_z=0.1, recon_cross_clip_psnr=10.0),
     "32": dict(alive_y=0.0, alive_z=0.0, recon_cross_clip_psnr=12.0)}])
@pytest.mark.parametrize("cross_clip_db", [25.0, 35.0])
def test_liveness_verdict_matches_jax(report, cross_clip_db):
    assert (tev.liveness_collapsed(report, cross_clip_db)
            == jev.liveness_collapsed(report, cross_clip_db))
