"""DMCI, the intra (I-frame) codec, in PyTorch.

A GOP starts with it: pixel_unshuffle(8) into a 7-block DepthConvBlock
encoder at ``enc_dec`` channels, a stride-2 conv to the N-channel latent y
(1/16 of the frame), a factorized hyper latent z (1/64), the 4-pass
checkerboard prior (``models/common.compress_prior_4x``) and a 13-block
decoder back to pixel_shuffle(8). Module names are the JAX package's, so
``utils/weights.load_flax_params`` maps its params tree key for key.

Every DepthConvBlock runs through the single-block kernel on the card (42
launches per frame at the full profile); the I-frame codec has no chain
site. The ``* quant_step`` after ``enc.enc_1`` and after ``dec.dec_1_12``
is folded into that block's q: the same in fp32, one bf16 rounding fewer on
the card. ``forward`` estimates the rates; ``coding/codec.py`` codes
them through the same ``transform_analysis`` and ``prior_params``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..config import DMCIConfig
from ..layers.blocks import (Conv, DepthConvBlock, ResidualBlockUpsample,
                             ResidualBlockWithStride2, init_,
                             name_int8_sites)
from ..layers.quant import noise_quant, ste_round
from ..ops.pixel import pixel_shuffle
from .common import (bpp_from_bits, compress_prior_4x,
                     compute_dtype, pad_for_y, qp_gain_ramp_init)
from .entropy import BitEstimator, gaussian_bits_cdf


class IntraEncoder(nn.Module):
    """pixel_unshuffle(8) + 1x1 -> DCB (* quant step) -> 6 DCB -> 3x3
    stride-2 conv to N."""

    def __init__(self, cfg: DMCIConfig, **kw):
        super().__init__()
        d = cfg.enc_dec
        self.enc_1 = DepthConvBlock(d, in_ch=3, patch_in=cfg.patch_size, **kw)
        for i in range(6):
            setattr(self, f"enc_2_{i}", DepthConvBlock(d, **kw))
        self.enc_2_6 = Conv(d, cfg.N, 3, stride=2, padding=1, **kw)

    def forward(self, x, quant_step):
        out = self.enc_1(x, quant_step)
        for i in range(6):
            out = getattr(self, f"enc_2_{i}")(out)
        return self.enc_2_6(out)


class IntraDecoder(nn.Module):
    """RBU to enc_dec -> 12 DCB (* quant step) -> DCB to 3*8*8 ->
    pixel_shuffle(8)."""

    def __init__(self, cfg: DMCIConfig, **kw):
        super().__init__()
        d = cfg.enc_dec
        self.patch_size = cfg.patch_size
        self.dec_1_0 = ResidualBlockUpsample(cfg.N, d, **kw)
        for i in range(1, 13):
            setattr(self, f"dec_1_{i}", DepthConvBlock(d, **kw))
        self.dec_2 = DepthConvBlock(cfg.src, in_ch=d, **kw)

    def forward(self, x, quant_step):
        out = self.dec_1_0(x)
        for i in range(1, 12):
            out = getattr(self, f"dec_1_{i}")(out)
        out = self.dec_1_12(out, quant_step)
        return pixel_shuffle(self.dec_2(out), self.patch_size)


class DMCI(nn.Module):
    """The I-frame codec. ``device`` defaults to "cuda"; pass "cpu" to run
    the plain versions. On the card the config's dtype must be bfloat16.
    Weights are loaded (``utils/weights.py``) or drawn fresh by
    :meth:`init_`. ``forward`` builds an autograd graph unless the caller
    runs it under ``torch.no_grad()``, as every inference path does."""

    def __init__(self, cfg: DMCIConfig = DMCIConfig(), device="cuda"):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DMCI: no CUDA device is available; pass "
                               "device='cpu' to run the plain versions")
        self.cfg = c = cfg
        self.dtype = compute_dtype(cfg.dtype)
        kw = dict(dtype=self.dtype, device=device)
        n, z = c.N, c.z_channel
        self.enc = IntraEncoder(c, **kw)
        self.hyper_enc_0 = DepthConvBlock(z, in_ch=n, **kw)
        self.hyper_enc_1 = ResidualBlockWithStride2(z, z, **kw)
        self.hyper_enc_2 = ResidualBlockWithStride2(z, z, **kw)
        self.hyper_dec_0 = ResidualBlockUpsample(z, z, **kw)
        self.hyper_dec_1 = ResidualBlockUpsample(z, z, **kw)
        self.hyper_dec_2 = DepthConvBlock(n, in_ch=z, **kw)
        self.y_prior_fusion_0 = DepthConvBlock(2 * n, in_ch=n, **kw)
        self.y_prior_fusion_1 = DepthConvBlock(2 * n, **kw)
        self.y_prior_fusion_2 = DepthConvBlock(2 * n, **kw)
        self.y_prior_fusion_3 = Conv(2 * n, 2 * n + 2, **kw)
        self.y_spatial_prior_reduction = Conv(2 * n + 2, n, **kw)
        for i in (1, 2, 3):
            setattr(self, f"y_spatial_prior_adaptor_{i}",
                    DepthConvBlock(2 * n, in_ch=(n, n), force_adaptor=True,
                                   **kw))
        self.y_spatial_prior_0 = DepthConvBlock(2 * n, **kw)
        self.y_spatial_prior_1 = DepthConvBlock(2 * n, **kw)
        self.y_spatial_prior_2 = DepthConvBlock(2 * n, **kw)
        self.y_spatial_prior_3 = Conv(2 * n, 2 * n, **kw)
        self.dec = IntraDecoder(c, **kw)

        def table():
            return nn.Parameter(torch.ones(c.qp_num, c.enc_dec,
                                           device=device))

        self.q_scale_enc = table()
        self.q_scale_dec = table()
        self.z_gain = nn.Parameter(torch.ones(z, device=device))
        self.bit_estimator_z = BitEstimator(c.qp_num, z, device=device)
        name_int8_sites(self)     # SSGVC_INT8 site keys, as flax paths

    def init_(self, generator: torch.Generator) -> "DMCI":
        """Fresh weights as the flax module inits them, drawn on the CPU
        from ``generator``: every conv by ``layers.blocks.init_``;
        q_scale_enc and q_scale_dec geometric QP ramps (``qp_ramp_init``) or
        ones; z_gain ones; the bit estimator N(0, 0.01)."""
        init_(self, generator)
        c = self.cfg
        with torch.no_grad():
            self.z_gain.fill_(1.0)
            for t, inverse in ((self.q_scale_enc, False),
                               (self.q_scale_dec, True)):
                t.copy_(qp_gain_ramp_init(c.qp_num, c.enc_dec,
                                          inverse=inverse)
                        if c.qp_ramp_init else torch.ones(t.shape))
        self.bit_estimator_z.init_(generator)
        return self

    def hyper_enc(self, x):
        x = self.hyper_enc_2(self.hyper_enc_1(self.hyper_enc_0(x)))
        return x * self.z_gain.to(self.dtype)

    def hyper_dec(self, x):
        return self.hyper_dec_2(self.hyper_dec_1(self.hyper_dec_0(x)))

    def y_prior_fusion(self, x):
        x = self.y_prior_fusion_2(self.y_prior_fusion_1(
            self.y_prior_fusion_0(x)))
        return self.y_prior_fusion_3(x)

    def y_spatial_prior(self, x):
        x = self.y_spatial_prior_2(self.y_spatial_prior_1(
            self.y_spatial_prior_0(x)))
        return self.y_spatial_prior_3(x)

    def transform_analysis(self, x, qp):
        """Source frame -> (y, q_dec): the analysis with q_scale_enc folded
        into enc_1's q, and the per-QP decoder scale for ``dec``."""
        take = lambda t: t[qp].reshape(1, 1, 1, -1).to(self.dtype)
        return self.enc(x, take(self.q_scale_enc)), take(self.q_scale_dec)

    def prior_params(self, z_hat, y_shape):
        """z_hat -> the fused prior params, cropped to y's spatial size."""
        params = self.y_prior_fusion(self.hyper_dec(z_hat))
        return params[:, :y_shape[1], :y_shape[2], :]

    def forward(self, x: torch.Tensor, qp, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: (B, H, W, 3) YCbCr in [0, 1]; qp: int. Returns {'dpb':
        {'frame', 'feature': None}, 'bpp', 'bpp_y', 'bpp_z'}."""
        y, q_dec = self.transform_analysis(x, qp)
        # the hyper path sees y replicate-padded to a multiple of 4; its
        # prior params are cropped back to y's size
        z = self.hyper_enc(pad_for_y(y))
        z_hat = ste_round(z)
        z_hat_write = noise_quant(z, generator, train)
        params = self.prior_params(z_hat, y.shape)
        prior = compress_prior_4x(
            y, params, self.y_spatial_prior_reduction,
            (self.y_spatial_prior_adaptor_1, self.y_spatial_prior_adaptor_2,
             self.y_spatial_prior_adaptor_3),
            self.y_spatial_prior, generator, train)

        x_hat = torch.clamp(self.dec(prior.y_hat, q_dec), 0.0, 1.0)

        pixel_num = x.shape[1] * x.shape[2]
        # no sigma floor and no symbol clamp here, unlike the P-frame codec
        bits_y = gaussian_bits_cdf(prior.y_q_hat_write, prior.scales_hat)
        bits_z = self.bit_estimator_z.bits(z_hat_write, qp)
        bpp_y = bpp_from_bits(bits_y, pixel_num)
        bpp_z = bpp_from_bits(bits_z, pixel_num)
        return {
            "dpb": {"frame": x_hat, "feature": None},
            "bpp": bpp_y + bpp_z,
            "bpp_y": bpp_y,
            "bpp_z": bpp_z,
        }
