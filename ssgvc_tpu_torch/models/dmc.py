"""DMC, the conditional inter (P-frame) codec, in PyTorch, all five
variants of ``DMCConfig.variant``:

  * ``performance`` (``mask_mode="sft_latent"``): a mask-driven SFT
    (gamma, beta) modulates the latent y before the hyper-encoder and the
    checkerboard prior;
  * ``fast`` (``"film_hyper"``): a light FiLM of the pooled mask conditions
    only the hyper-encoder's input;
  * ``mask_prop`` (``"film_hyper"``, ``mask_source="propagated"``): as
    ``fast``, but after the first P-frame the mask is predicted on the
    decoder side (``MaskPredictor``) instead of transmitted;
  * ``plain`` (``"none"``) and ``old`` (``"none"``, ``legacy_old``: the
    encoder's ``conv3`` name, the legacy decoder order and the unclamped
    CDF rate).

Both ``packed_io`` values and both ``after_i`` values run. Module names are
the JAX package's, so ``utils/weights.load_flax_params`` maps each
variant's params tree key for key.

Temporal redundancy flows through the decoded feature of the previous frame
(the DPB) into FeatureExtractor -> (ctx, ctx_t). Every DepthConvBlock runs
through the hand-written kernels on the card: adaptor-free runs of blocks
(feature extractor 2 + 4, encoder tail 2 with the quant step folded in,
decoder 2, prior fusion 3) as one chained launch each, the rest one launch
per block. ``forward`` estimates the rates; ``coding/codec.py`` codes
them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import DMCConfig
from ..layers.blocks import (Conv, DepthConvBlock, PatchDownConv,
                             PatchUpConv, ResidualBlockUpsample,
                             ResidualBlockWithStride2, SubpelConv2x, init_,
                             name_int8_sites, run_chain, wsilu)
from ..layers.quant import noise_quant, ste_round
from ..ops.pixel import pixel_shuffle, pixel_unshuffle
from ..parallel import spatial
from .common import (bpp_from_bits, compress_prior_2x,
                     compute_dtype, pad_for_y, qp_gain_ramp_init)
from .entropy import BitEstimator, gaussian_bits, gaussian_bits_cdf


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
    -> 3x3 stride-2 conv to ch_y. The last block is ``conv3`` in the legacy
    (``old``) naming, ``conv2_2`` otherwise."""

    def __init__(self, cfg: DMCConfig, **kw):
        super().__init__()
        d = cfg.ch_d
        self.conv1 = (Conv(cfg.src, d, **kw) if cfg.packed_io else
                      PatchDownConv(3, d, cfg.patch_size, **kw))
        self.conv2_0 = DepthConvBlock(d, in_ch=(d, d), **kw)
        self.conv2_1 = DepthConvBlock(d, **kw)
        self.last = "conv3" if cfg.legacy_old else "conv2_2"
        setattr(self, self.last, DepthConvBlock(d, **kw))
        self.down = Conv(d, cfg.ch_y, 3, stride=2, padding=1, **kw)

    def forward(self, x, ctx, quant_step):
        f = self.conv2_0((self.conv1(x), ctx))
        f = run_chain(f, (self.conv2_1, getattr(self, self.last)),
                      q_last=quant_step)
        return self.down(f)


class Decoder(nn.Module):
    """Refactor order: up -> * quant step -> DCB over (f, ctx) -> 2 DCB ->
    1x1 ``proj``. Legacy order (``old``): up -> DCB over (f, ctx)
    (``conv1_0``) -> 2 DCB (``conv1_1..2``) -> 1x1 ``conv2`` -> * quant
    step."""

    def __init__(self, cfg: DMCConfig, **kw):
        super().__init__()
        d = cfg.ch_d
        self.legacy = cfg.legacy_old
        self.recon_residual = cfg.recon_residual
        self.up = SubpelConv2x(cfg.ch_y, d, 3, padding=1, **kw)
        self.names = (("conv1_0", "conv1_1", "conv1_2", "conv2")
                      if self.legacy else ("conv_0", "conv_1", "conv_2",
                                           "proj"))
        setattr(self, self.names[0], DepthConvBlock(d, in_ch=(d, d), **kw))
        setattr(self, self.names[1], DepthConvBlock(d, **kw))
        setattr(self, self.names[2], DepthConvBlock(d, **kw))
        # recon_residual: the projection starts at zero, so a fresh decoder
        # emits the context it adds back
        setattr(self, self.names[3], Conv(d, d, zero_init=self.recon_residual,
                                          **kw))

    def forward(self, x, ctx, quant_step):
        first, b1, b2, head = (getattr(self, n) for n in self.names)
        f = self.up(x)
        if not self.legacy:
            f = f * quant_step
        f = head(run_chain(first((f, ctx)), (b1, b2)))
        if self.legacy:
            f = f * quant_step
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
        # recon_residual: a zero head, so a fresh model reconstructs the
        # previous decoded frame
        rr = cfg.recon_residual
        self.head = (Conv(r, cfg.src, zero_init=rr, **kw) if cfg.packed_io
                     else PatchUpConv(r, cfg.src // cfg.patch_size ** 2,
                                      cfg.patch_size, zero_init=rr, **kw))

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


class MaskFiLM(nn.Module):
    """Light mask FiLM of ``fast`` and ``mask_prop``: 3x3 conv to ``mid``
    -> ReLU -> 1x1 to 2*ch_y -> (gamma, beta)."""

    def __init__(self, ch_y: int, mid: int = 16, **kw):
        super().__init__()
        self.net_0 = Conv(1, mid, 3, padding=1, **kw)
        self.net_2 = Conv(mid, ch_y * 2, **kw)

    def forward(self, m):
        return self.net_2(F.relu(self.net_0(m))).chunk(2, dim=-1)


def resize_bilinear(x: torch.Tensor, height: int, width: int
                    ) -> torch.Tensor:
    """Bilinear resize of an NHWC tensor, antialiased when it shrinks (as
    ``jax.image.resize`` does), computed in fp32 and returned in x's
    dtype."""
    shrink = height < x.shape[1] or width < x.shape[2]
    out = F.interpolate(x.float().permute(0, 3, 1, 2), size=(height, width),
                        mode="bilinear", align_corners=False,
                        antialias=shrink)
    return out.permute(0, 2, 3, 1).contiguous().to(x.dtype)


class MaskPredictor(nn.Module):
    """Decoder-side mask propagation of ``mask_prop``: the previous mask
    resized to the context's resolution, embedded, fused with (ctx, ctx_t),
    mask logits predicted and resized back."""

    def __init__(self, cfg: DMCConfig, **kw):
        super().__init__()
        d = cfg.ch_d
        mid = d // 4
        self.mask_embed = Conv(1, d, 3, padding=1, **kw)
        self.net_0 = Conv(3 * d, mid, 3, padding=1, **kw)
        self.net_2 = Conv(mid, mid, 3, padding=1, **kw)
        self.net_4 = Conv(mid, 1, **kw)
        self.dtype = kw["dtype"]

    def forward(self, prev_mask, ctx, ctx_t):
        hm, wm = prev_mask.shape[1], prev_mask.shape[2]
        hf, wf = ctx.shape[1], ctx.shape[2]
        m = self.mask_embed(_sharded_resize(prev_mask, hf, wf))
        fused = torch.cat([m, ctx.to(self.dtype), ctx_t.to(self.dtype)],
                          dim=-1)
        x = wsilu(self.net_0(fused))
        logits = self.net_4(wsilu(self.net_2(x)))
        if (hf, wf) != (hm, wm):
            logits = _sharded_resize(logits, hm, wm)
        return logits


def _sharded_resize(x: torch.Tensor, height: int, width: int
                    ) -> torch.Tensor:
    """:func:`resize_bilinear` of a row slab under a row shard
    (``parallel/spatial.py``), equal to the rows the whole frame's resize
    gives: the antialiased downscale by f reaches f / 2 input rows past an
    output row's own f, the upscale one low-resolution row. So the slab
    takes f rows (one row when it grows) of each neighbour slab, which
    keeps its offset a multiple of f and every kept row's weights the
    whole frame's, is resized whole and cropped; at the image's edges no
    row is added and the resize's own edge normalisation stands. Without a
    row shard :func:`resize_bilinear` itself."""
    h = x.shape[1]
    if spatial.current() is None or height == h:
        return resize_bilinear(x, height, width)
    if max(h, height) % min(h, height):
        raise ValueError(f"a row-sharded resize of {h} rows to {height}: "
                         "not a whole factor")
    # input rows a side: f to shrink by f, one to grow
    reach = h // height if height < h else 1
    x, up, down = spatial.halo(x, reach, reach)
    y = resize_bilinear(x, x.shape[1] * height // h, width)
    return spatial.crop(y, up * height // h, down * height // h)


class DMC(nn.Module):
    """The P-frame codec, every variant of ``DMCConfig.variant``.
    ``device`` defaults to "cuda"; pass "cpu" to run the plain versions.
    On the card the config's dtype must be bfloat16. Weights are loaded
    (``utils/weights.py``) or drawn fresh by :meth:`init_`. ``forward``
    builds an autograd graph unless the caller runs it under
    ``torch.no_grad()``, as every inference path does."""

    def __init__(self, cfg: DMCConfig = DMCConfig(), device="cuda"):
        super().__init__()
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

        def table(ch):
            return nn.Parameter(torch.ones(qp_total, ch, device=device))

        if c.mask_mode == "sft_latent":
            self.mask_sft = SFT(c, **kw)
            self.q_sft = table(d)
        elif c.mask_mode == "film_hyper":
            self.mask_film = MaskFiLM(c.ch_y, **kw)
        if c.mask_source == "propagated":
            self.mask_predictor = MaskPredictor(c, **kw)
        self.q_encoder = table(d)
        self.q_decoder = table(d)
        self.q_feature = table(d)
        self.q_recon = table(c.ch_recon)
        self.z_gain = nn.Parameter(torch.ones(c.ch_z, device=device))
        self.bit_estimator_z = BitEstimator(qp_total, c.ch_z, device=device)
        name_int8_sites(self)     # SSGVC_INT8 site keys, as flax paths

    def init_(self, generator: torch.Generator) -> "DMC":
        """Fresh weights as the flax module inits them, drawn on the CPU
        from ``generator``: every conv by ``layers.blocks.init_``; q_encoder
        and q_decoder geometric QP ramps (``qp_ramp_init``) or ones; q_sft,
        q_feature, q_recon and z_gain ones; the bit estimator N(0, 0.01)."""
        init_(self, generator)
        c = self.cfg
        rows = c.qp_num + c.extra_qp
        with torch.no_grad():
            for t in (self.q_feature, self.q_recon, self.z_gain,
                      getattr(self, "q_sft", None)):
                if t is not None:
                    t.fill_(1.0)
            for t, inverse in ((self.q_encoder, False),
                               (self.q_decoder, True)):
                t.copy_(qp_gain_ramp_init(rows, c.ch_d, inverse=inverse)
                        if c.qp_ramp_init else torch.ones(t.shape))
        self.bit_estimator_z.init_(generator)
        return self

    def shift_qp(self, qp, fa_idx):
        """qp + qp_shift[fa_idx]: the QP of a frame at GOP position class
        ``fa_idx``."""
        return qp + self.cfg.qp_shift[fa_idx]

    def predict_mask(self, prev_mask, ctx, ctx_t):
        """Decoder-side mask propagation. With packed io the 1-channel mask
        circulates pixel-unshuffled: it is shuffled back to raw resolution
        for the predictor's resizes and its logits unshuffled again (a
        lossless permutation either way)."""
        c = self.cfg
        if c.packed_io:
            raw = pixel_shuffle(prev_mask, c.patch_size)
            return pixel_unshuffle(self.mask_predictor(raw, ctx, ctx_t),
                                   c.patch_size)
        return self.mask_predictor(prev_mask, ctx, ctx_t)

    def hyper_z(self, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Hyper analysis of the variant's hyper input, with the bootstrap
        z gain: one definition for the estimated and the coded path."""
        return (self.hyper_encoder(self._hyper_input(y, mask))
                * self.z_gain.to(self.dtype))

    def res_prior_param_decoder(self, z_hat, ctx_t):
        hierarchical = self.hyper_decoder(z_hat)
        temporal = self.temporal_prior_encoder(ctx_t)
        h, w = temporal.shape[1], temporal.shape[2]
        return self.y_prior_fusion((hierarchical[:, :h, :w, :], temporal))

    @staticmethod
    def _mask_to_latent_res(mask, y):
        """Average-pool the mask to y's spatial size (integer ratio), clamped
        to [0, 1]."""
        b, hm, wm, _ = mask.shape
        hy, wy = y.shape[1], y.shape[2]
        fh, fw = hm // hy, wm // wy
        m = mask[:, :hy * fh, :wy * fw, :].reshape(b, hy, fh, wy, fw, 1)
        return torch.clamp(m.mean(dim=(2, 4)), 0.0, 1.0)

    def _hyper_input(self, y, mask):
        """The variant's hyper-encoder input: y itself (performance, already
        SFT-modulated), y padded to a multiple of 4 and FiLM-modulated by
        the pooled mask (fast, mask_prop), or y padded (plain, old)."""
        c = self.cfg
        if c.mask_mode == "film_hyper":
            y_pad = pad_for_y(y)
            if c.packed_io:
                # the channel mean of the packed mask is its 8x8 block mean
                mask = mask.mean(dim=-1, keepdim=True)
            m = self._mask_to_latent_res(mask, y)
            pad_b = y_pad.shape[1] - y.shape[1]
            pad_r = y_pad.shape[2] - y.shape[2]
            if pad_b or pad_r:
                m = F.pad(m, (0, 0, 0, pad_r, 0, pad_b))
            gamma, beta = self.mask_film(m)
            return y_pad * (1.0 + gamma) + beta
        if c.mask_mode == "sft_latent":
            return y
        return pad_for_y(y)

    def _split_input(self, x, mask):
        """(x, mask) with the mask defaulted to zeros; a raw 4-channel x
        carries the mask in channel 3."""
        c = self.cfg
        if not c.packed_io and x.shape[-1] > 3:
            if mask is None:
                mask = x[..., 3:4].contiguous()
            x = x[..., :3].contiguous()
        if mask is None:
            mask_ch = c.patch_size ** 2 if c.packed_io else 1
            mask = torch.zeros(x.shape[:3] + (mask_ch,), dtype=x.dtype,
                               device=x.device)
        return x, mask

    def forward(self, x: torch.Tensor, qp, dpb: Dict[str, torch.Tensor],
                after_i: bool = True, mask: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: (B, H, W, 3) (or 4 with the mask in channel 3), or (B, H/8,
        W/8, 192) with packed_io; mask likewise with 1 or 64 channels; qp:
        int. Returns {'dpb': {'frame', 'feature'}, 'bpp', 'bpp_y', 'bpp_z',
        'mask_pred'}; mask_pred is the predicted mask logits (mask_prop) or
        None."""
        c = self.cfg
        x, mask = self._split_input(x, mask)

        take = lambda t: t[qp].reshape(1, 1, 1, -1).to(self.dtype)
        q_encoder = take(self.q_encoder)
        q_decoder = take(self.q_decoder)
        q_feature = take(self.q_feature)
        q_recon = take(self.q_recon)

        feature = (self.feature_adaptor_i(dpb["frame"]) if after_i
                   else self.feature_adaptor_p(dpb["feature"]))
        ctx, ctx_t = self.feature_extractor(feature, q_feature)
        y = self.encoder(x, ctx, q_encoder)

        mask_pred = None
        if c.mask_source == "propagated":
            # after the first P-frame the prediction replaces the mask
            mask_pred = self.predict_mask(mask, ctx, ctx_t)
            if not after_i:
                mask = mask_pred
        if c.mask_mode == "sft_latent":
            gamma, beta = self.mask_sft(mask, take(self.q_sft))
            y = y * (1.0 + gamma) + beta

        z = self.hyper_z(y, mask)
        z_hat = ste_round(z)
        z_hat_write = noise_quant(z, generator, train)

        params = self.res_prior_param_decoder(z_hat, ctx_t)
        prior = compress_prior_2x(y, params, self.y_spatial_prior, generator,
                                  train)

        feature_out = self.decoder(prior.y_hat, ctx, q_decoder)
        x_hat = self.recon_generation_net(
            feature_out, q_recon,
            prev=dpb["frame"] if c.recon_residual else None)

        # the frame's, under a row shard
        pixel_num = spatial.frame_rows(x.shape[1]) * x.shape[2]
        if c.packed_io:
            pixel_num *= c.patch_size ** 2   # bpp is per source pixel
        scales_for_bit = (torch.clamp(prior.scales_hat,
                                      min=c.bits_sigma_floor)
                          if c.bits_sigma_floor else prior.scales_hat)
        if c.legacy_old:
            bits_y = gaussian_bits_cdf(prior.y_q_hat_write, scales_for_bit)
        else:
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
            "mask_pred": mask_pred,
        }
