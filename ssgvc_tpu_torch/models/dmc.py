"""DMC, the conditional inter (P-frame) codec, in PyTorch.

This slice ports the ``performance`` variant (``mask_mode="sft_latent"``,
``mask_source="gt"``, refactor op order): a mask-driven SFT (gamma, beta)
modulates the latent y before the hyper-encoder and the checkerboard
prior. Both ``packed_io`` values and both ``after_i`` values run. The
other variants (plain, old, fast, mask_prop) raise until they are ported.

Temporal redundancy flows through the decoded feature of the previous frame
(the DPB) into FeatureExtractor -> (ctx, ctx_t). Every DepthConvBlock runs
through the hand-written kernels on the card: adaptor-free runs of blocks
(feature extractor 2 + 4, encoder tail 2 with the quant step folded in,
decoder 2, prior fusion 3) as one chained launch each, the rest one launch
per block. Rates are estimated, not entropy-coded.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ..config import DMCConfig
from ..layers.blocks import (Conv, DepthConvBlock, PatchDownConv,
                             PatchUpConv, ResidualBlockUpsample,
                             ResidualBlockWithStride2, SubpelConv2x,
                             run_chain)
from ..layers.quant import noise_quant, ste_round
from .common import bpp_from_bits, compress_prior_2x, compute_dtype
from .entropy import BitEstimator, gaussian_bits


class FeatureExtractor(nn.Module):
    """2 DCB -> (x1, ctx_t = x1*q); 4 more DCB -> ctx."""

    def __init__(self, cfg: DMCConfig, **kw):
        super().__init__()
        d = cfg.ch_d
        for name in ("conv1_0", "conv1_1", "conv2_0", "conv2_1", "conv2_2",
                     "conv2_3"):
            setattr(self, name, DepthConvBlock(d, **kw))

    def part1(self, x, quant):
        x1 = run_chain(x, (self.conv1_0, self.conv1_1))
        return x1, x1 * quant

    def part2(self, x1):
        return run_chain(x1, (self.conv2_0, self.conv2_1, self.conv2_2,
                              self.conv2_3))

    def forward(self, x, quant):
        x1, ctx_t = self.part1(x, quant)
        return self.part2(x1), ctx_t


class Encoder(nn.Module):
    """[unshuffle(8)] -> 1x1 -> DCB over (x, ctx) -> 2 DCB (* quant step)
    -> 3x3 stride-2 conv to ch_y."""

    def __init__(self, cfg: DMCConfig, **kw):
        super().__init__()
        d = cfg.ch_d
        self.conv1 = (Conv(cfg.src, d, **kw) if cfg.packed_io else
                      PatchDownConv(3, d, cfg.patch_size, **kw))
        self.conv2_0 = DepthConvBlock(d, in_ch=(d, d), **kw)
        self.conv2_1 = DepthConvBlock(d, **kw)
        self.conv2_2 = DepthConvBlock(d, **kw)
        self.down = Conv(d, cfg.ch_y, 3, stride=2, padding=1, **kw)

    def forward(self, x, ctx, quant_step):
        f = self.conv2_0((self.conv1(x), ctx))
        f = run_chain(f, (self.conv2_1, self.conv2_2), q_last=quant_step)
        return self.down(f)


class Decoder(nn.Module):
    """up -> * quant step -> DCB over (f, ctx) -> 2 DCB -> 1x1."""

    def __init__(self, cfg: DMCConfig, **kw):
        super().__init__()
        d = cfg.ch_d
        self.recon_residual = cfg.recon_residual
        self.up = SubpelConv2x(cfg.ch_y, d, 3, padding=1, **kw)
        self.conv_0 = DepthConvBlock(d, in_ch=(d, d), **kw)
        self.conv_1 = DepthConvBlock(d, **kw)
        self.conv_2 = DepthConvBlock(d, **kw)
        self.proj = Conv(d, d, **kw)

    def forward(self, x, ctx, quant_step):
        f = self.up(x) * quant_step
        f = self.conv_0((f, ctx))
        f = self.proj(run_chain(f, (self.conv_1, self.conv_2)))
        return f + ctx if self.recon_residual else f


class ReconGeneration(nn.Module):
    """feature -> 4 DCB (recon width) -> * quant step -> 1x1 head
    [-> shuffle(8)] -> clamp to [0, 1]."""

    def __init__(self, cfg: DMCConfig, **kw):
        super().__init__()
        r = cfg.ch_recon
        self.recon_residual = cfg.recon_residual
        self.conv_0 = DepthConvBlock(r, in_ch=cfg.ch_d, **kw)
        self.conv_1 = DepthConvBlock(r, **kw)
        self.conv_2 = DepthConvBlock(r, **kw)
        self.conv_3 = DepthConvBlock(r, **kw)
        self.head = (Conv(r, cfg.src, **kw) if cfg.packed_io else
                     PatchUpConv(r, cfg.src // cfg.patch_size ** 2,
                                 cfg.patch_size, **kw))

    def forward(self, x, quant_step, prev=None):
        f = self.conv_3(self.conv_2(self.conv_1(self.conv_0(x))))
        f = self.head(f * quant_step)
        if self.recon_residual and prev is not None:
            f = f + prev.to(f.dtype)
        return torch.clamp(f, 0.0, 1.0)


class HyperEncoder(nn.Module):
    """DCB -> 2x RBS2, /4 in space."""

    def __init__(self, cfg: DMCConfig, **kw):
        super().__init__()
        z = cfg.ch_z
        self.conv_0 = DepthConvBlock(z, in_ch=cfg.ch_y, **kw)
        self.conv_1 = ResidualBlockWithStride2(z, z, **kw)
        self.conv_2 = ResidualBlockWithStride2(z, z, **kw)

    def forward(self, x):
        return self.conv_2(self.conv_1(self.conv_0(x)))


class HyperDecoder(nn.Module):
    """2x RBU -> DCB to ch_y."""

    def __init__(self, cfg: DMCConfig, **kw):
        super().__init__()
        z = cfg.ch_z
        self.conv_0 = ResidualBlockUpsample(z, z, **kw)
        self.conv_1 = ResidualBlockUpsample(z, z, **kw)
        self.conv_2 = DepthConvBlock(cfg.ch_y, in_ch=z, **kw)

    def forward(self, x):
        return self.conv_2(self.conv_1(self.conv_0(x)))


class PriorFusion(nn.Module):
    """concat(hierarchical, temporal) -> 3 DCB -> 1x1, 3*ch_y wide. The two
    parts' widths (ch_y + 2*ch_y) sum to the block width, so conv_0 has no
    adaptor and all three blocks chain."""

    def __init__(self, cfg: DMCConfig, **kw):
        super().__init__()
        w = cfg.ch_y * 3
        self.dtype = kw["dtype"]
        self.conv_0 = DepthConvBlock(w, **kw)
        self.conv_1 = DepthConvBlock(w, **kw)
        self.conv_2 = DepthConvBlock(w, **kw)
        self.conv_3 = Conv(w, w, **kw)

    def forward(self, parts):
        x = torch.cat([p.to(self.dtype) for p in parts], dim=-1)
        return self.conv_3(run_chain(x, (self.conv_0, self.conv_1,
                                         self.conv_2)))


class SpatialPrior(nn.Module):
    """DCB over (y_hat, params) -> DCB -> 1x1: (scales, means)."""

    def __init__(self, cfg: DMCConfig, **kw):
        super().__init__()
        w = cfg.ch_y * 3
        self.conv_0 = DepthConvBlock(w, in_ch=(cfg.ch_y, w), **kw)
        self.conv_1 = DepthConvBlock(w, **kw)
        self.conv_2 = Conv(w, cfg.ch_y * 2, **kw)

    def forward(self, x):
        return self.conv_2(self.conv_1(self.conv_0(x)))


class SFT(nn.Module):
    """Mask SFT of the performance variant: the encoder's shape on the
    (unshuffled) mask, * q_sft, stride-2 conv to 2*ch_y -> (gamma, beta)."""

    def __init__(self, cfg: DMCConfig, **kw):
        super().__init__()
        d = cfg.ch_d
        self.conv1 = (Conv(cfg.patch_size ** 2, d, **kw) if cfg.packed_io
                      else PatchDownConv(1, d, cfg.patch_size, **kw))
        self.conv2_0 = DepthConvBlock(d, **kw)
        self.conv2_1 = DepthConvBlock(d, **kw)
        self.conv2_2 = DepthConvBlock(d, **kw)
        self.down = Conv(d, cfg.ch_y * 2, 3, stride=2, padding=1, **kw)

    def forward(self, mask, q_sft):
        x = self.conv2_2(self.conv2_1(self.conv2_0(self.conv1(mask))))
        return self.down(x * q_sft).chunk(2, dim=-1)


class DMC(nn.Module):
    """The P-frame codec. ``device`` defaults to "cuda"; pass "cpu" to run
    the plain versions. Weights are loaded, not drawn
    (``utils/weights.py``)."""

    def __init__(self, cfg: DMCConfig = DMCConfig(), device="cuda"):
        super().__init__()
        if (cfg.mask_mode != "sft_latent" or cfg.mask_source != "gt"
                or cfg.legacy_old):
            raise NotImplementedError(
                "the port runs the performance variant only so far "
                f"(mask_mode={cfg.mask_mode!r}, mask_source="
                f"{cfg.mask_source!r}, legacy_old={cfg.legacy_old})")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DMC: no CUDA device is available; pass "
                               "device='cpu' to run the plain versions")
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.dtype)
        kw = dict(dtype=self.dtype, device=device)
        c = cfg
        d = c.ch_d
        qp_total = c.qp_num + c.extra_qp
        self.feature_adaptor_i = (
            DepthConvBlock(d, in_ch=c.src, **kw) if c.packed_io else
            DepthConvBlock(d, in_ch=3, patch_in=c.patch_size, **kw))
        self.feature_adaptor_p = Conv(d, d, **kw)
        self.feature_extractor = FeatureExtractor(c, **kw)
        self.encoder = Encoder(c, **kw)
        self.hyper_encoder = HyperEncoder(c, **kw)
        self.hyper_decoder = HyperDecoder(c, **kw)
        self.temporal_prior_encoder = ResidualBlockWithStride2(
            d, c.ch_y * 2, **kw)
        self.y_prior_fusion = PriorFusion(c, **kw)
        self.y_spatial_prior = SpatialPrior(c, **kw)
        self.decoder = Decoder(c, **kw)
        self.recon_generation_net = ReconGeneration(c, **kw)
        self.mask_sft = SFT(c, **kw)

        def table(ch):
            return nn.Parameter(torch.ones(qp_total, ch, device=device))

        self.q_sft = table(d)
        self.q_encoder = table(d)
        self.q_decoder = table(d)
        self.q_feature = table(d)
        self.q_recon = table(c.ch_recon)
        self.z_gain = nn.Parameter(torch.ones(c.ch_z, device=device))
        self.bit_estimator_z = BitEstimator(qp_total, c.ch_z, device=device)

    def hyper_z(self, y: torch.Tensor) -> torch.Tensor:
        """Hyper analysis with the bootstrap z gain."""
        return self.hyper_encoder(y) * self.z_gain.to(self.dtype)

    def res_prior_param_decoder(self, z_hat, ctx_t):
        hierarchical = self.hyper_decoder(z_hat)
        temporal = self.temporal_prior_encoder(ctx_t)
        h, w = temporal.shape[1], temporal.shape[2]
        return self.y_prior_fusion((hierarchical[:, :h, :w, :], temporal))

    @torch.no_grad()
    def forward(self, x: torch.Tensor, qp, dpb: Dict[str, torch.Tensor],
                after_i: bool = True, mask: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: (B, H, W, 3), or (B, H/8, W/8, 192) with packed_io; mask
        likewise with 1 or 64 channels; qp: int. Returns {'dpb': {'frame',
        'feature'}, 'bpp', 'bpp_y', 'bpp_z', 'mask_pred'}."""
        c = self.cfg
        if mask is None:
            mask_ch = c.patch_size ** 2 if c.packed_io else 1
            mask = torch.zeros(x.shape[:3] + (mask_ch,), dtype=x.dtype,
                               device=x.device)

        take = lambda t: t[qp].reshape(1, 1, 1, -1).to(self.dtype)
        q_encoder = take(self.q_encoder)
        q_decoder = take(self.q_decoder)
        q_feature = take(self.q_feature)
        q_recon = take(self.q_recon)

        feature = (self.feature_adaptor_i(dpb["frame"]) if after_i
                   else self.feature_adaptor_p(dpb["feature"]))
        ctx, ctx_t = self.feature_extractor(feature, q_feature)
        y = self.encoder(x, ctx, q_encoder)

        gamma, beta = self.mask_sft(mask, take(self.q_sft))
        y = y * (1.0 + gamma) + beta

        z = self.hyper_z(y)
        z_hat = ste_round(z)
        z_hat_write = noise_quant(z, generator, train)

        params = self.res_prior_param_decoder(z_hat, ctx_t)
        prior = compress_prior_2x(y, params, self.y_spatial_prior, generator,
                                  train)

        feature_out = self.decoder(prior.y_hat, ctx, q_decoder)
        x_hat = self.recon_generation_net(
            feature_out, q_recon,
            prev=dpb["frame"] if c.recon_residual else None)

        pixel_num = x.shape[1] * x.shape[2]
        if c.packed_io:
            pixel_num *= c.patch_size ** 2   # bpp is per source pixel
        scales_for_bit = (torch.clamp(prior.scales_hat,
                                      min=c.bits_sigma_floor)
                          if c.bits_sigma_floor else prior.scales_hat)
        # the coder's symbol domain is +-127
        y_for_bit = torch.clamp(prior.y_q_hat_write, -127.0, 127.0)
        bits_y = gaussian_bits(y_for_bit, scales_for_bit)
        bits_z = self.bit_estimator_z.bits(z_hat_write, qp)
        bpp_y = bpp_from_bits(bits_y, pixel_num)
        bpp_z = bpp_from_bits(bits_z, pixel_num)
        return {
            "dpb": {"frame": x_hat, "feature": feature_out},
            "bpp": bpp_y + bpp_z,
            "bpp_y": bpp_y,
            "bpp_z": bpp_z,
            "mask_pred": None,
        }
