"""Real bitstream encode/decode: DMCI (I-frames) and DMC (P-frames) with
the host rANS coder.

  * The network stages run on the models' device (the kernels on the card);
    the entropy coder runs on the host (``coding/rans.py``).
  * The encoder runs the decoder's own stage methods (``_dmc_fe``,
    ``_dmc_prior``, ``_dmc_stage_b``, ``_dmc_stage_c``, ``_dmci_stage0``,
    ``_dmci_restore_pass``, ``_dmci_reconstruct``) on the same inputs, so
    both sides compute the prior, the scale indexes and the reconstruction
    with the same operations in the same order. What feeds those stages is
    the same on both sides too: every pass's quantized symbols go to the
    host (the encoder needs them there for rANS anyway) and come back
    through one expression, :meth:`VideoCodec._upload` (contiguous, the
    model's compute dtype). The decoder therefore reproduces the encoder's
    tensors bit for bit, as long as both sides pick the same algorithms:
    leave ``torch.backends.cudnn.benchmark`` off (its default), which lets
    cuDNN choose by timing, call by call.
  * Checkerboard folding: each pass's symbols collapse across the
    complementary channel halves (P) or quarters (I); decoding restores
    them with the pass's mask. Decoding needs 2 (P) / 4 (I) symbol round
    trips, one per pass.
  * The I-frame's pass p >= 1 takes its means from the spatial prior that
    pass p - 1 ran for its scale indexes (``means_next``), on both sides,
    instead of running that prior again.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..models import common
from ..models.dmc import DMC
from ..models.dmci import DMCI
from ..ops.pixel import pixel_shuffle, pixel_unshuffle
from . import cdf as cdf_mod
from .rans import EntropyCoder

SYM_MIN, SYM_MAX = -127, 127  # the packed (symbol<<8)|index words are int16


def _fold2(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return a + b


def _fold4(x: torch.Tensor) -> torch.Tensor:
    a, b, c, d = x.chunk(4, dim=-1)
    return (a + b) + (c + d)


def _restore2(y_q, means, mask):
    return (torch.cat([y_q, y_q], dim=-1) + means) * mask


def _restore4(y_q, means, mask):
    return (torch.cat([y_q] * 4, dim=-1) + means) * mask


def _pack(symbols: np.ndarray, indexes: np.ndarray) -> np.ndarray:
    """Fused (symbol << 8) | index int16 words."""
    return ((symbols.astype(np.int32) << 8)
            + indexes.astype(np.int32)).astype(np.int16).reshape(-1)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _symbols(y_q: torch.Tensor) -> np.ndarray:
    """A pass's folded integer symbols (|s| <= 127) on the host, int8."""
    return _host(y_q.to(torch.int8))


def _take(model, table: torch.Tensor, qp) -> torch.Tensor:
    """The per-QP row of ``table`` as a (1, 1, 1, C) compute-dtype tensor,
    as the models' forwards take it."""
    return table[qp].reshape(1, 1, 1, -1).to(model.dtype)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class VideoCodec:
    """DMCI + DMC (the port's modules, weights loaded, on one device) +
    rANS tables + the per-stage methods of both coding directions.

    ``skip_thres`` > 0 drops from the y stream every position whose
    (decoder-derived) scale, clamped to the table's range, is <=
    skip_thres; both sides compute the same skip set and restore skipped
    symbols as zeros.

    ``coder_profile``: None keeps the 128-level 0.11-16 Gaussian table;
    'gaussian' / 'laplace' select the wide 256-level tables
    (``cdf.REFRACTOR_PROFILES``).

    ``packed_dmc`` runs the P-frame stages on pixel-unshuffled frames
    (``DMCConfig.packed_io``) with the same weights. Frames still enter and
    leave this API raw; the DPB carries the packed frame between P-frames.
    A mask_prop chain stays raw.

    ``enc_time`` / ``dec_time`` are the last call's seconds (device work
    synchronised), ``enc_rans_time`` / ``dec_rans_time`` their host rANS
    part.
    """

    def __init__(self, dmci: DMCI, dmc: DMC, scale_levels: int = 128,
                 ec_part: int = 0, skip_thres: float = 0.0,
                 coder_profile: Optional[str] = None,
                 packed_dmc: bool = False):
        self.device = next(dmc.parameters()).device
        for what, m in (("DMCI", dmci), ("DMC", dmc)):
            dev = next(m.parameters()).device
            if dev != self.device:
                raise ValueError(f"VideoCodec: DMCI and DMC must be on one "
                                 f"device, got {what} on {dev}")
        if packed_dmc and not dmc.cfg.packed_io:
            packed = DMC(dataclasses.replace(dmc.cfg, packed_io=True),
                         device=self.device)
            packed.load_state_dict(dmc.state_dict(), strict=True)
            dmc = packed.eval()
        self.dmci = dmci
        self.dmc = dmc
        self.ec_part = int(ec_part)
        self.skip_thres = float(skip_thres)
        if coder_profile is None:
            self.scale_min, self.scale_max = 0.11, 16.0
            self.scale_levels = scale_levels
            # the pmf support must cover ~3.9 sigma of the largest scale,
            # else high-rate symbols fall off the row and escape-code
            dist, scan = "gaussian", min(64, int(np.ceil(3.9 * 16.0)))
        else:
            prof = cdf_mod.REFRACTOR_PROFILES[coder_profile]
            self.scale_min = prof["scale_min"]
            self.scale_max = prof["scale_max"]
            self.scale_levels = prof["levels"]
            dist, scan = coder_profile, 50   # covers scale_max = 64

        self.ec_i = EntropyCoder()
        self.ec_p = EntropyCoder()
        y_tables = cdf_mod.build_y_cdf_tables(
            scale_min=self.scale_min, scale_max=self.scale_max,
            levels=self.scale_levels, scan_range=scan, distribution=dist)
        self.y_group_i = self.ec_i.add_cdf(*y_tables)
        self.z_group_i = self.ec_i.add_cdf(
            *cdf_mod.build_z_cdf_tables(dmci.bit_estimator_z))
        self.y_group_p = self.ec_p.add_cdf(*y_tables)
        self.z_group_p = self.ec_p.add_cdf(
            *cdf_mod.build_z_cdf_tables(dmc.bit_estimator_z))
        if self.ec_part:
            # two rANS streams per frame, so decoding runs on two threads
            self.ec_i.set_use_two_entropy_coders(True)
            self.ec_p.set_use_two_entropy_coders(True)

        self.enc_time = self.dec_time = 0.0
        self.enc_rans_time = self.dec_rans_time = 0.0

    # ------------------------------------------------------------ helpers

    def _upload(self, a: np.ndarray, model) -> torch.Tensor:
        """Host integers -> a contiguous tensor in ``model``'s compute
        dtype on the codec's device: the one expression through which the
        encoder's and the decoder's stages take symbols."""
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            self.device, model.dtype)

    def _build_idx(self, scales: torch.Tensor) -> torch.Tensor:
        """Scale -> table row of this codec's scale table (fp32)."""
        return cdf_mod.build_indexes_decoder(
            scales, scale_min=self.scale_min, scale_max=self.scale_max,
            levels=self.scale_levels)

    def _keep(self, folded: torch.Tensor) -> torch.Tensor:
        """Skip test, clamp first: positions whose clamped scale exceeds
        skip_thres are coded."""
        return torch.clamp(folded.float(), self.scale_min,
                           self.scale_max) > self.skip_thres

    @staticmethod
    def _apply_skip(y_q: np.ndarray, keep) -> np.ndarray:
        """Zero the skipped symbols, as the decoder restores them."""
        if keep is None:
            return y_q
        return y_q * keep.astype(y_q.dtype)

    def _masks_2x(self, t: torch.Tensor):
        return common.checkerboard_masks_2x(t.shape[-1], t.shape[1],
                                            t.shape[2], dtype=t.dtype,
                                            device=t.device)

    def _masks_4x(self, t: torch.Tensor):
        return common.checkerboard_masks_4x(t.shape[-1], t.shape[1],
                                            t.shape[2], dtype=t.dtype,
                                            device=t.device)

    # ================================================================= DMC =

    def _dmc_fe(self, qp: int, dpb: Dict, after_i: bool) -> Dict:
        """Temporal conditioning from the DPB alone: the decoder runs it
        before it entropy-decodes z, so the device computes it while the
        host decodes."""
        m = self.dmc
        c = m.cfg
        frame = dpb["frame"]
        if c.packed_io and frame.shape[-1] == 3:
            # a raw I-frame reconstruction entering the packed P-loop
            frame = pixel_unshuffle(frame, c.patch_size)
        feature = (m.feature_adaptor_i(frame) if after_i
                   else m.feature_adaptor_p(dpb["feature"]))
        x1, ctx_t = m.feature_extractor.part1(feature,
                                              _take(m, m.q_feature, qp))
        return {"ctx_t": ctx_t, "ctx": m.feature_extractor.part2(x1)}

    def _dmc_predict_mask(self, prev_mask, ctx, ctx_t) -> torch.Tensor:
        """mask_prop's decoder-side prediction, on the raw mask whatever
        the P-stages' io (ctx and ctx_t are at H/8 x W/8 in both)."""
        return self.dmc.mask_predictor(prev_mask, ctx, ctx_t)

    def _dmc_analysis(self, x, mask, qp: int, ctx, ctx_t) -> Dict:
        """Encoder only: source frame and current mask -> (y, z_int8)."""
        m = self.dmc
        c = m.cfg
        if c.packed_io:
            x = pixel_unshuffle(x, c.patch_size)
            mask = pixel_unshuffle(mask, c.patch_size)
        y = m.encoder(x, ctx, _take(m, m.q_encoder, qp))
        if c.mask_mode == "sft_latent":
            gamma, beta = m.mask_sft(mask, _take(m, m.q_sft, qp))
            y = y * (1.0 + gamma) + beta
        z = m.hyper_z(y, mask)
        return {"y": y,
                "z_int8": torch.clamp(torch.round(z), -128, 127).to(
                    torch.int8)}

    def _dmc_prior(self, z_hat, ctx_t) -> Dict:
        """z -> prior params and pass-0 scale indexes (and keep mask)."""
        params3 = self.dmc.res_prior_param_decoder(z_hat, ctx_t)
        _, scales0, _ = params3.chunk(3, dim=-1)
        m0, _ = self._masks_2x(scales0)
        folded = _fold2(scales0 * m0)
        out = {"params3": params3, "idx0": self._build_idx(folded)}
        if self.skip_thres > 0:
            out["keep0"] = self._keep(folded)
        return out

    def _dmc_quantize_pass(self, y, params3, means, q_dec,
                           pass_idx: int) -> torch.Tensor:
        """Encoder only: pass ``pass_idx``'s residuals as folded integer
        symbols. Pass 0 takes (q_dec, means) from params3, pass 1 the
        spatial prior's means and stage B's q_dec."""
        if pass_idx == 0:
            q_dec, _, means = params3.chunk(3, dim=-1)
        q_dec = torch.clamp(q_dec, min=0.5)
        y_s = y * (1.0 / q_dec)
        mk = self._masks_2x(y)[pass_idx]
        y_res = (y_s - means * mk) * mk
        return _fold2(torch.clamp(torch.round(y_res), SYM_MIN, SYM_MAX) * mk)

    def _dmc_stage_b(self, params3, y_q_r0) -> Dict:
        """Restore pass 0, run the spatial prior, pass-1 indexes."""
        q_dec, _, means0 = params3.chunk(3, dim=-1)
        m0, m1 = self._masks_2x(means0)
        y_hat_0 = _restore2(y_q_r0, means0 * m0, m0)
        scales1, means1 = self.dmc.y_spatial_prior(
            (y_hat_0, params3)).chunk(2, dim=-1)
        folded = _fold2(scales1 * m1)
        out = {"y_hat_0": y_hat_0, "means1": means1,
               "idx1": self._build_idx(folded),
               "q_dec": torch.clamp(q_dec, min=0.5)}
        if self.skip_thres > 0:
            out["keep1"] = self._keep(folded)
        return out

    def _dmc_stage_c(self, y_hat_0, means1, y_q_r1, q_dec, qp: int, ctx,
                     prev_frame) -> Dict:
        """Restore pass 1, dequantize, synthesize the frame and feature.
        ``prev_frame`` (the DPB frame) feeds the recon skip of a model
        trained with recon_residual."""
        m = self.dmc
        c = m.cfg
        _, m1 = self._masks_2x(y_hat_0)
        y_hat = (y_hat_0 + _restore2(y_q_r1, means1 * m1, m1)) * q_dec
        feature = m.decoder(y_hat, ctx, _take(m, m.q_decoder, qp))
        if c.recon_residual and c.packed_io and prev_frame.shape[-1] == 3:
            prev_frame = pixel_unshuffle(prev_frame, c.patch_size)
        x_hat = m.recon_generation_net(
            feature, _take(m, m.q_recon, qp),
            prev=prev_frame if c.recon_residual else None)
        if c.packed_io:
            # the DPB keeps the packed frame; the API returns it raw
            return {"x_hat": pixel_shuffle(x_hat, c.patch_size),
                    "frame_dpb": x_hat, "feature": feature}
        return {"x_hat": x_hat, "frame_dpb": x_hat, "feature": feature}

    @torch.no_grad()
    def dmc_compress(self, x, qp: int, dpb, after_i: bool,
                     mask=None) -> Dict:
        """x: (1, H, W, 3) raw frame on the codec's device -> {'bit_stream',
        'x_hat', 'dpb', 'mask_out'}. ``mask`` (1, H, W, 1): for mask_prop
        the chain carry (the GT mask at the first P-frame, the previous
        ``mask_out`` after it)."""
        t0 = time.perf_counter()
        m = self.dmc
        if mask is None:
            mask = torch.zeros(x.shape[:3] + (1,), dtype=x.dtype,
                               device=x.device)
        skip = self.skip_thres > 0

        fe = self._dmc_fe(qp, dpb, after_i)
        mask_out = mask
        if m.cfg.mask_source == "propagated" and not after_i:
            mask_out = self._dmc_predict_mask(mask, fe["ctx"], fe["ctx_t"])
        ana = self._dmc_analysis(x, mask_out, qp, fe["ctx"], fe["ctx_t"])
        z_int8 = _host(ana["z_int8"])

        a = self._dmc_prior(self._upload(z_int8, m), fe["ctx_t"])
        keep0 = _host(a["keep0"]) if skip else None
        y_q_r0 = self._apply_skip(_symbols(self._dmc_quantize_pass(
            ana["y"], a["params3"], None, None, 0)), keep0)
        b = self._dmc_stage_b(a["params3"], self._upload(y_q_r0, m))
        keep1 = _host(b["keep1"]) if skip else None
        y_q_r1 = self._apply_skip(_symbols(self._dmc_quantize_pass(
            ana["y"], None, b["means1"], b["q_dec"], 1)), keep1)
        # stage C runs on the device while the host codes the symbols
        cres = self._dmc_stage_c(b["y_hat_0"], b["means1"],
                                 self._upload(y_q_r1, m), b["q_dec"], qp,
                                 fe["ctx"], dpb["frame"])

        packed0 = _pack(y_q_r0, _host(a["idx0"]))
        packed1 = _pack(y_q_r1, _host(b["idx1"]))
        t_rans = time.perf_counter()
        if skip:
            packed0 = packed0[keep0.reshape(-1)]
            packed1 = packed1[keep1.reshape(-1)]
        self.ec_p.reset()
        zc = m.cfg.ch_z
        self.ec_p.encode_z(np.transpose(z_int8[0], (2, 0, 1)).reshape(-1),
                           self.z_group_p, qp * zc,
                           z_int8.shape[1] * z_int8.shape[2])
        self.ec_p.encode_y(packed0, self.y_group_p)
        self.ec_p.encode_y(packed1, self.y_group_p)
        self.ec_p.flush()
        stream = self.ec_p.get_encoded_stream()
        self.enc_rans_time = time.perf_counter() - t_rans
        _sync(self.device)
        self.enc_time = time.perf_counter() - t0
        return {"bit_stream": stream, "x_hat": cres["x_hat"],
                "dpb": {"frame": cres["frame_dpb"],
                        "feature": cres["feature"]},
                "mask_out": mask_out}

    def _decode_y_pass(self, idx: torch.Tensor, keep) -> np.ndarray:
        """Host rANS decode of one pass, skipped positions as zeros."""
        idx_np = _host(idx)
        t = time.perf_counter()
        if keep is None:
            self.ec_p.decode_y(idx_np.reshape(-1), self.y_group_p)
            vals = self.ec_p.get_decoded_tensor()
        else:
            keep_np = _host(keep).reshape(-1)
            self.ec_p.decode_y(idx_np.reshape(-1)[keep_np], self.y_group_p)
            vals = np.zeros(idx_np.size, np.int32)
            vals[keep_np] = self.ec_p.get_decoded_tensor()
        self.dec_rans_time += time.perf_counter() - t
        return vals.reshape(idx_np.shape)

    @torch.no_grad()
    def dmc_decompress(self, stream: bytes, height: int, width: int, qp: int,
                       dpb, after_i: bool, mask=None) -> Dict:
        """-> {'x_hat', 'dpb', 'mask_out'}. ``mask`` (mask_prop only): the
        decoder's chain carry, the GT mask at the first P-frame and the
        previous ``mask_out`` after it."""
        t0 = time.perf_counter()
        m = self.dmc
        c = m.cfg
        zc = c.ch_z
        z_h, z_w = common.get_downsampled_shape(height, width, 64)
        skip = self.skip_thres > 0

        # the DPB-only conditioning first: the device computes it while the
        # host decodes z
        fe = self._dmc_fe(qp, dpb, after_i)
        mask_out = mask
        if (c.mask_source == "propagated" and not after_i
                and mask is not None):
            mask_out = self._dmc_predict_mask(mask, fe["ctx"], fe["ctx_t"])

        t = time.perf_counter()
        self.ec_p.set_stream(stream)
        self.ec_p.decode_z(zc * z_h * z_w, self.z_group_p, qp * zc,
                           z_h * z_w)
        z_vals = self.ec_p.get_decoded_tensor().reshape(zc, z_h, z_w)
        self.dec_rans_time = time.perf_counter() - t

        a = self._dmc_prior(self._upload(z_vals.transpose(1, 2, 0)[None], m),
                            fe["ctx_t"])
        y_q_r0 = self._decode_y_pass(a["idx0"], a["keep0"] if skip else None)
        b = self._dmc_stage_b(a["params3"], self._upload(y_q_r0, m))
        y_q_r1 = self._decode_y_pass(b["idx1"], b["keep1"] if skip else None)
        cres = self._dmc_stage_c(b["y_hat_0"], b["means1"],
                                 self._upload(y_q_r1, m), b["q_dec"], qp,
                                 fe["ctx"], dpb["frame"])
        _sync(self.device)
        self.dec_time = time.perf_counter() - t0
        return {"x_hat": cres["x_hat"],
                "dpb": {"frame": cres["frame_dpb"],
                        "feature": cres["feature"]},
                "mask_out": mask_out}

    # ================================================================ DMCI =

    def _dmci_analysis(self, x, qp: int) -> Dict:
        """Encoder only: source frame -> (y, z_int8)."""
        m = self.dmci
        y, _ = m.transform_analysis(x, qp)
        z = m.hyper_enc(common.pad_for_y(y))
        return {"y": y,
                "z_int8": torch.clamp(torch.round(z), -128, 127).to(
                    torch.int8)}

    def _dmci_stage0(self, z_hat, y_h: int, y_w: int) -> Dict:
        """z -> prior params, their reduction and pass-0 indexes."""
        m = self.dmci
        params_all = m.prior_params(z_hat, (1, y_h, y_w, m.cfg.N))
        _, _, scales, _ = common.separate_prior_image(params_all)
        mk = self._masks_4x(scales)[0]
        return {"params_all": params_all,
                "reduced": m.y_spatial_prior_reduction(params_all),
                "idx": self._build_idx(_fold4(scales * mk))}

    def _dmci_quantize_pass(self, y, params_all, means_i,
                            pass_idx: int) -> torch.Tensor:
        """Encoder only: pass residuals as folded integer symbols; pass 0
        takes its means from params_all, later passes ``means_i``."""
        q_enc, _, _, means0 = common.separate_prior_image(params_all)
        means = means0 if pass_idx == 0 else means_i
        mk = self._masks_4x(y)[pass_idx]
        y_res = (y * q_enc - means * mk) * mk
        return _fold4(torch.clamp(torch.round(y_res), SYM_MIN, SYM_MAX) * mk)

    def _dmci_restore_pass(self, params_all, reduced, y_hat_so_far, y_q_r,
                           means_i, pass_idx: int) -> Dict:
        """Restore pass ``pass_idx`` with its means (pass 0: params_all's);
        then the next pass's means and scale indexes, or after pass 3 the
        dequantized y_hat."""
        m = self.dmci
        _, q_dec, _, means0 = common.separate_prior_image(params_all)
        masks = self._masks_4x(means0)
        if pass_idx == 0:
            means_i = means0
        mk = masks[pass_idx]
        y_hat_i = _restore4(y_q_r, means_i * mk, mk)
        so_far = y_hat_i if pass_idx == 0 else y_hat_so_far + y_hat_i
        if pass_idx == 3:
            return {"y_hat_so_far": so_far * q_dec, "idx": None,
                    "means_next": None}
        adaptor = (m.y_spatial_prior_adaptor_1, m.y_spatial_prior_adaptor_2,
                   m.y_spatial_prior_adaptor_3)[pass_idx]
        s_next, means_next = m.y_spatial_prior(
            adaptor((so_far, reduced))).chunk(2, dim=-1)
        return {"y_hat_so_far": so_far,
                "idx": self._build_idx(_fold4(s_next * masks[pass_idx + 1])),
                "means_next": means_next}

    def _dmci_reconstruct(self, y_hat, qp: int) -> torch.Tensor:
        m = self.dmci
        return torch.clamp(m.dec(y_hat, _take(m, m.q_scale_dec, qp)), 0.0,
                           1.0)

    def _dmci_passes(self, s0, symbols_of) -> torch.Tensor:
        """The four restore passes, pass p's symbols from
        ``symbols_of(p, idx, means_i)`` (host integers); returns y_hat."""
        idx, y_hat_so_far, means_i = s0["idx"], None, None
        for p in range(4):
            y_q_r = self._upload(symbols_of(p, idx, means_i), self.dmci)
            res = self._dmci_restore_pass(s0["params_all"], s0["reduced"],
                                          y_hat_so_far, y_q_r, means_i, p)
            y_hat_so_far, idx, means_i = (res["y_hat_so_far"], res["idx"],
                                          res["means_next"])
        return y_hat_so_far

    @torch.no_grad()
    def dmci_compress(self, x, qp: int) -> Dict:
        """x: (1, H, W, 3) on the codec's device -> {'bit_stream', 'x_hat',
        'dpb'}."""
        t0 = time.perf_counter()
        ana = self._dmci_analysis(x, qp)
        z_int8 = _host(ana["z_int8"])
        y = ana["y"]
        s0 = self._dmci_stage0(self._upload(z_int8, self.dmci), y.shape[1],
                               y.shape[2])
        packed_list = []

        def symbols_of(p, idx, means_i):
            sym = _symbols(self._dmci_quantize_pass(y, s0["params_all"],
                                                    means_i, p))
            packed_list.append(_pack(sym, _host(idx)))
            return sym

        x_hat = self._dmci_reconstruct(self._dmci_passes(s0, symbols_of), qp)

        t_rans = time.perf_counter()
        self.ec_i.reset()
        zc = self.dmci.cfg.z_channel
        self.ec_i.encode_z(np.transpose(z_int8[0], (2, 0, 1)).reshape(-1),
                           self.z_group_i, qp * zc,
                           z_int8.shape[1] * z_int8.shape[2])
        for packed in packed_list:
            self.ec_i.encode_y(packed, self.y_group_i)
        self.ec_i.flush()
        stream = self.ec_i.get_encoded_stream()
        self.enc_rans_time = time.perf_counter() - t_rans
        _sync(self.device)
        self.enc_time = time.perf_counter() - t0
        return {"bit_stream": stream, "x_hat": x_hat,
                "dpb": {"frame": x_hat, "feature": None}}

    @torch.no_grad()
    def dmci_decompress(self, stream: bytes, height: int, width: int,
                        qp: int) -> Dict:
        t0 = time.perf_counter()
        zc = self.dmci.cfg.z_channel
        z_h, z_w = common.get_downsampled_shape(height, width, 64)
        y_h, y_w = common.get_downsampled_shape(height, width, 16)
        t = time.perf_counter()
        self.ec_i.set_stream(stream)
        self.ec_i.decode_z(zc * z_h * z_w, self.z_group_i, qp * zc,
                           z_h * z_w)
        z_vals = self.ec_i.get_decoded_tensor().reshape(zc, z_h, z_w)
        self.dec_rans_time = time.perf_counter() - t
        s0 = self._dmci_stage0(
            self._upload(z_vals.transpose(1, 2, 0)[None], self.dmci),
            y_h, y_w)

        def symbols_of(p, idx, means_i):
            idx_np = _host(idx)
            t = time.perf_counter()
            self.ec_i.decode_y(idx_np.reshape(-1), self.y_group_i)
            sym = self.ec_i.get_decoded_tensor().reshape(idx_np.shape)
            self.dec_rans_time += time.perf_counter() - t
            return sym

        x_hat = self._dmci_reconstruct(self._dmci_passes(s0, symbols_of), qp)
        _sync(self.device)
        self.dec_time = time.perf_counter() - t0
        return {"x_hat": x_hat, "dpb": {"frame": x_hat, "feature": None}}
