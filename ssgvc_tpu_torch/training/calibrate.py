"""Init-time quantizer-gain calibration for from-scratch training.

A fresh init gives encoder outputs with std ~0.05-0.1, so round(y * gain)
is all zero at every QP and the synthesis learns to ignore the latent.
Calibration measures the latents on one real batch at init and rescales
the gains, keeping each table's geometric QP ramp:

  * DMC: ``q_encoder`` by a scalar (it multiplies the feature right before
    the encoder's last linear conv, so it scales y exactly), then
    ``z_gain`` per channel, measured at the calibrated y;
  * DMCI: ``z_gain`` per channel only.

The latents are taken with forward hooks on ``encoder``,
``hyper_encoder`` (DMC) and ``hyper_enc_2`` (DMCI), where the JAX package
reads flax's captured intermediates. The models are updated in place.
"""

from __future__ import annotations

import torch

TARGET_Y_STD = 3.0
TARGET_Z_STD = 2.0


def _capture(model, module, *args, **kw) -> torch.Tensor:
    """``module``'s output during one no-grad forward of ``model``."""
    seen = []
    handle = module.register_forward_hook(
        lambda _m, _a, out: seen.append(out.detach()))
    try:
        with torch.no_grad():
            model(*args, **kw)
    finally:
        handle.remove()
    return seen[0]


def _channel_scale(arr: torch.Tensor, target: float, lo: float = 0.25,
                   hi: float = 50.0) -> torch.Tensor:
    """Per-channel target / RMS, clipped; dead channels keep 1. RMS about
    zero, not std, so a channel that is mostly a bias offset is not
    amplified into a huge constant latent."""
    a = arr.float()
    rms = torch.sqrt(torch.mean(a * a, dim=tuple(range(a.dim() - 1))))
    c = torch.clamp(target / torch.clamp(rms, min=1e-6), lo, hi)
    return torch.where(rms > 1e-6, c, torch.ones_like(c))


def _scalar_scale(arr: torch.Tensor, target: float, lo: float = 0.25,
                  hi: float = 1000.0) -> float:
    std = float(torch.std(arr.float(), unbiased=False))
    if std <= 1e-6:
        return 1.0
    return float(min(max(target / std, lo), hi))


@torch.no_grad()
def calibrate_dmc(dmc, x, dpb, mask, qp: int = 32,
                  target_y: float = TARGET_Y_STD,
                  target_z: float = TARGET_Z_STD,
                  decoder_inverse: bool = False):
    """Rescale ``q_encoder`` (and with ``decoder_inverse`` divide
    ``q_decoder``) so that std(y) ~ target_y at the mid-QP row, then
    ``z_gain`` so that z's per-channel RMS ~ target_z. Returns ``dmc``."""
    kw = dict(after_i=True, mask=mask, train=False)
    y = _capture(dmc, dmc.encoder, x, qp, dpb, **kw)
    cy = _scalar_scale(y, target_y)
    dmc.q_encoder.mul_(cy)
    if decoder_inverse:
        dmc.q_decoder.div_(cy)
    # second pass at the calibrated y: the hyper analysis is nonlinear
    z = _capture(dmc, dmc.hyper_encoder, x, qp, dpb, **kw)
    dmc.z_gain.mul_(_channel_scale(z, target_z).to(dmc.z_gain.device))
    return dmc


@torch.no_grad()
def calibrate_dmci(dmci, x, qp: int = 32, target_z: float = TARGET_Z_STD):
    """Rescale ``z_gain`` per channel (the y path is left as it is).
    Returns ``dmci``."""
    z = _capture(dmci, dmci.hyper_enc_2, x, qp, train=False)
    dmci.z_gain.mul_(_channel_scale(z, target_z).to(dmci.z_gain.device))
    return dmci
