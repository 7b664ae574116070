"""The port's real coder on the card (marked ``gpu``; skipped where no CUDA
device is present): full-width bf16 models through the kernels, encoder
and decoder reproducing each other bit for bit (``torch.equal``).

This file imports neither JAX nor the JAX package:
``python -m pytest tests/test_torch_coding_gpu.py -m gpu -q --noconftest``.
"""

import io

import numpy as np
import pytest
import torch

HW = 128


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _codec(variant, **kw):
    """Full-width bf16 codecs with the smoke's random weights."""
    import chip_smoke
    from ssgvc_tpu_torch.coding.codec import VideoCodec
    from ssgvc_tpu_torch.config import DMCConfig, DMCIConfig
    from ssgvc_tpu_torch.models.dmc import DMC
    from ssgvc_tpu_torch.models.dmci import DMCI

    dev = _card()
    dmci = chip_smoke.random_weights(
        torch, DMCI(DMCIConfig(dtype="bfloat16"), device=dev), 0,
        chip_smoke.DMCI_HEADS)
    dmc = chip_smoke.random_weights(
        torch, DMC(DMCConfig.variant(variant, dtype="bfloat16"), device=dev),
        1)
    return VideoCodec(dmci.eval(), dmc.eval(), **kw)


@pytest.mark.gpu
def test_coded_gop_round_trip_on_the_card():
    codec = _codec("performance", packed_dmc=True)
    dev = codec.device
    g = torch.Generator(device=dev).manual_seed(3)
    frames = torch.rand((4, 1, HW, HW, 3), generator=g, device=dev)
    masks = (torch.rand((4, 1, HW, HW, 1), generator=g, device=dev)
             > 0.7).float()
    enc_i = codec.dmci_compress(frames[0], 32)
    dec_i = codec.dmci_decompress(enc_i["bit_stream"], HW, HW, 32)
    assert torch.equal(enc_i["x_hat"], dec_i["x_hat"])
    feat0 = torch.zeros((1, HW // 8, HW // 8, 256), dtype=torch.bfloat16,
                        device=dev)
    dpb_e = {"frame": enc_i["x_hat"], "feature": feat0}
    dpb_d = {"frame": dec_i["x_hat"], "feature": feat0}
    for t, qp in ((1, 40), (2, 32), (3, 36)):
        out = codec.dmc_compress(frames[t], qp, dpb_e, after_i=(t == 1),
                                 mask=masks[t])
        dec = codec.dmc_decompress(out["bit_stream"], HW, HW, qp, dpb_d,
                                   after_i=(t == 1))
        assert torch.isfinite(out["x_hat"].float()).all()
        assert torch.equal(out["x_hat"], dec["x_hat"])
        for k in ("frame", "feature"):
            assert torch.equal(out["dpb"][k], dec["dpb"][k])
        dpb_e, dpb_d = out["dpb"], dec["dpb"]


@pytest.mark.gpu
def test_mask_prop_session_on_the_card():
    from ssgvc_tpu_torch.coding.session import CodingSession

    codec = _codec("mask_prop")
    rng = np.random.default_rng(5)
    frames = rng.uniform(0, 1, (3, HW, HW, 3)).astype(np.float32)
    masks = (rng.uniform(0, 1, (3, HW, HW, 1)) > 0.7).astype(np.float32)
    session = CodingSession(codec)
    buf = io.BytesIO()
    stats = session.encode_sequence(buf, frames, qp=30, masks=masks)
    buf.seek(0)
    decoded, chain = session.decode_sequence(buf, masks=masks,
                                             return_masks=True)
    assert len(decoded) == 3 and len(chain) == 2
    for rec, enc_rec in zip(decoded, stats["recons"]):
        np.testing.assert_array_equal(rec, enc_rec)
    for dm, em in zip(chain, stats["masks"]):
        np.testing.assert_array_equal(dm, em)
