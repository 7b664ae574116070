"""The plain reference agrees with the port's ``device="cpu"`` forward in
fp32 at a tiny profile, on weights the benchmark draws: P-frames with the
DPB carried, I-frames. The test imports both; the reference itself
imports nothing of the port."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import weights
from benchmark.reference import dmc as rdmc
from benchmark.reference import dmci as rdmci
from benchmark.reference.layers import pixel_shuffle, pixel_unshuffle
from benchmark.tests.helpers import few_threads, tiny_config

def drawn(model, config, seed):
    sd = weights.draw({k: v.shape for k, v in model.state_dict().items()},
                      config["weights"], seed, "cpu")
    model.load_state_dict(sd, strict=True)
    return sd


@pytest.mark.parametrize("qp", [0, 37, 63])
def test_pframes_agree(qp):
    few_threads()
    from ssgvc_tpu_torch.config import DMCConfig
    from ssgvc_tpu_torch.models.dmc import DMC

    cfg = tiny_config("dmc-perf-1080p-bf16")
    m = dict(cfg["model"], dtype="float32")
    model = DMC(DMCConfig.variant(m.pop("variant"), **m), device="cpu")
    sd = drawn(model, cfg, 100 + qp)
    g = torch.Generator().manual_seed(qp)
    h, w = cfg["frame"]["height"], cfg["frame"]["width"]
    un = lambda t: pixel_unshuffle(t, 8)
    dpb = {"frame": un(torch.rand(2, h, w, 3, generator=g)),
           "feature": 0.1 * torch.randn(2, h // 8, w // 8, m["ch_d"],
                                        generator=g)}
    mine = dict(dpb)
    with torch.no_grad():
        for t in range(3):
            x = un(torch.rand(2, h, w, 3, generator=g))
            mask = un((torch.rand(2, h, w, 1, generator=g) > 0.8).float())
            out = model(x, qp, dpb, after_i=False, mask=mask)
            ref = rdmc.forward(sd, x, mask, qp, mine)
            dpb, mine = out["dpb"], ref
            torch.testing.assert_close(out["dpb"]["frame"], ref["frame"],
                                       rtol=0, atol=1e-5)
            torch.testing.assert_close(out["dpb"]["feature"], ref["feature"],
                                       rtol=1e-4, atol=1e-5)
            for k in ("bpp", "bpp_y", "bpp_z"):
                torch.testing.assert_close(out[k], ref[k], rtol=1e-4, atol=0)
            # the staged reconstruction is the forward's own
            torch.testing.assert_close(
                rdmc.reconstruct(sd, ref["feature"], qp), ref["frame"],
                rtol=0, atol=0)


@pytest.mark.parametrize("qp", [5, 50])
def test_iframes_agree(qp):
    few_threads()
    from ssgvc_tpu_torch.config import DMCIConfig
    from ssgvc_tpu_torch.models.dmci import DMCI

    cfg = tiny_config("dmci-1080p-bf16")
    model = DMCI(DMCIConfig(**dict(cfg["model"], dtype="float32")),
                 device="cpu")
    sd = drawn(model, cfg, 200 + qp)
    h, w = cfg["frame"]["height"], cfg["frame"]["width"]
    x = torch.rand(2, h, w, 3, generator=torch.Generator().manual_seed(qp))
    with torch.no_grad():
        out = model(x, qp)
        ref = rdmci.forward(sd, x, qp)
    torch.testing.assert_close(out["dpb"]["frame"], ref["frame"], rtol=0,
                               atol=1e-5)
    for k in ("bpp", "bpp_y", "bpp_z"):
        torch.testing.assert_close(out[k], ref[k], rtol=1e-4, atol=0)


def test_pixel_shuffles_invert():
    x = torch.randn(2, 16, 24, 3)
    assert torch.equal(pixel_shuffle(pixel_unshuffle(x, 8), 8), x)


def test_weights_follow_the_rule():
    """The draw's scales: lecun for convs, times every matching factor;
    tables about one; the rest small; fills exact; one seed, one draw."""
    cfg = tiny_config("dmci-1080p-bf16")
    t = {"a.dc_3.weight": torch.Size((64, 64, 1, 1)),
         "y_prior_fusion_3.weight": torch.Size((64, 32, 1, 1)),
         "q_scale_enc": torch.Size((64, 32)),
         "dec.dec_2.adaptor.bias": torch.Size((192,)),
         "b.bias": torch.Size((4096,))}
    sd = weights.draw(t, cfg["weights"], 7, "cpu")
    assert float(sd["a.dc_3.weight"].std()) == pytest.approx(0.1 / 8,
                                                             rel=0.05)
    assert float(sd["y_prior_fusion_3.weight"].std()) == pytest.approx(
        0.01 / 32 ** 0.5, rel=0.05)
    assert float(sd["q_scale_enc"].mean()) == pytest.approx(1.0, abs=0.01)
    assert torch.equal(sd["dec.dec_2.adaptor.bias"],
                       torch.full((192,), 0.5))
    assert float(sd["b.bias"].std()) == pytest.approx(0.01, rel=0.05)
    again = weights.draw(t, cfg["weights"], 7, "cpu")
    assert all(torch.equal(sd[k], again[k]) for k in t)
