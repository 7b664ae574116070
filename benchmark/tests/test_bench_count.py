"""The yardstick's product count and roofline arithmetic."""

from __future__ import annotations

import pytest

from benchmark.harness import roofline, spec
from benchmark.tests.helpers import config_file, few_threads


def codec(config, traffic):
    cfg = config_file(config)
    return spec.codec(cfg["codec"]).Codec(cfg, spec.traffic(traffic), 0,
                                          "cpu")


def test_pframe_products():
    """928,285,908,480 FLOP a performance P-frame at 1088x1920: the
    figure of the JAX package's jaxpr and of the port's own count."""
    few_threads()
    c = codec("dmc-perf-1080p-bf16", "bulk-b4-gop8").count()
    assert c.total == 928_285_908_480
    # 31 DepthConvBlocks a frame
    assert len(c.blocks) == 31
    assert sum(roofline.dcb_flops(p, ch) for p, ch in c.blocks) < c.total


def test_iframe_products_match_the_port():
    few_threads()
    import torch

    from ssgvc_tpu_torch.config import DMCIConfig
    from ssgvc_tpu_torch.models.dmci import DMCI
    from ssgvc_tpu_torch.utils.flops import count_products

    c = codec("dmci-1080p-bf16", "bulk-b2-group8").count()
    with count_products() as port:
        DMCI(DMCIConfig(), device="meta")(
            torch.empty((1, 1088, 1920, 3), device="meta"), 3)
    assert c.total == port.total == 2_032_000_458_240
    assert len(c.blocks) == 42


@pytest.mark.parametrize("pixels,c", [(32640, 256), (510, 128), (8160, 512)])
def test_dcb_bound(pixels, c):
    flops = pixels * (16 * c * c + 18 * c)
    assert roofline.dcb_flops(pixels, c) == flops
    nbytes = 2 * (2 * pixels * c + 8 * c * c + 17 * c)
    assert roofline.dcb_bytes(pixels, c, "bfloat16") == nbytes
    assert roofline.dcb_bound_s(pixels, c, "bfloat16") == max(
        flops / 989e12, nbytes / 3.35e12)
