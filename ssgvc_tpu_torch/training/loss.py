"""Rate-distortion losses, GOP weights and the ALM constrained-optimization
terms: the JAX package's ``training/loss.py`` in torch, fp32 throughout.

``weighted_mse`` is sum(w * se) / sum(w), the weighted-mean semantics of
torch's ``F.mse_loss(..., weight=w, reduction='mean')``.

Under data parallelism a rank holds a shard of the batch, and a ratio of
sums over the batch is not the mean of the ranks' ratios. ``batch_sum``
(``parallel.mesh.group_sum`` over the data group) takes those sums over the
whole batch, differentiably, so every rank computes the global batch's
value, as the JAX package does on its global array; a term that is a mean
over the batch stays the rank's own, and the gradient's mean over the
ranks makes it the global one.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


def compute_lambda(qp, lambda_min: float, lambda_max: float,
                   q_levels: int = 64) -> torch.Tensor:
    """Log-interpolated qp -> lambda."""
    qp = torch.as_tensor(qp, dtype=torch.float32)
    return torch.exp(math.log(lambda_min) + qp / (q_levels - 1)
                     * (math.log(lambda_max) - math.log(lambda_min)))


BatchSum = Optional[Callable[[torch.Tensor], torch.Tensor]]


def weighted_mse(pred: torch.Tensor, target: torch.Tensor,
                 weight: torch.Tensor, batch_sum: BatchSum = None
                 ) -> torch.Tensor:
    """sum(w * (pred-target)^2) / sum(w), the sums over the whole batch
    with ``batch_sum``."""
    se = (pred.float() - target.float()) ** 2
    w = torch.broadcast_to(weight.float(), se.shape)
    num, den = torch.sum(w * se), torch.sum(w)
    if batch_sum is not None:
        num, den = batch_sum(torch.stack([num, den])).unbind()
    return num / torch.clamp(den, min=1e-12)


class RDLoss(NamedTuple):
    loss: torch.Tensor
    bpp: torch.Tensor
    bpp_y: torch.Tensor
    bpp_z: torch.Tensor
    mse: torch.Tensor       # the (possibly ROI-weighted) distortion in the loss
    prev_obj: torch.Tensor  # unweighted MSE, for logging


def rate_distortion_loss(results: dict, target: torch.Tensor, qp, w_t,
                         lambda_min: float, lambda_max: float,
                         q_levels: int = 64,
                         mask: Optional[torch.Tensor] = None,
                         roi_weight: float = 100.0,
                         lambda_normalize: bool = False,
                         batch_sum: BatchSum = None) -> RDLoss:
    """loss = bpp_y + bpp_z + w_t * lambda(qp) * wMSE(1 + roi_weight * m);
    mask (B, H, W, 1) binary. ``lambda_normalize`` divides the whole loss by
    lambda(qp). ``batch_sum``: the wMSE's sums and the ROI's pixel count
    are the whole batch's."""
    bpp = torch.mean(results["bpp"])
    bpp_y = torch.mean(results["bpp_y"])
    bpp_z = torch.mean(results["bpp_z"])
    pred = results["dpb"]["frame"]

    plain_mse = torch.mean((pred.float() - target.float()) ** 2)
    if mask is None:
        mse = plain_mse
    else:
        m = (mask > 0).float()
        wmse = weighted_mse(pred, target, 1.0 + roi_weight * m, batch_sum)
        roi = torch.sum(m)
        if batch_sum is not None:
            roi = batch_sum(roi)
        # no masked pixel: the plain MSE
        mse = torch.where(roi > 0, wmse, plain_mse)

    lam = compute_lambda(qp, lambda_min, lambda_max, q_levels).to(bpp.device)
    loss = bpp_y + bpp_z + w_t * lam * mse
    if lambda_normalize:
        loss = loss / lam
    return RDLoss(loss, bpp, bpp_y, bpp_z, mse, plain_mse)


def roi_mse(pred: torch.Tensor, target: torch.Tensor,
            mask: Optional[torch.Tensor], batch_sum: BatchSum = None
            ) -> torch.Tensor:
    """Mean MSE over the ROI only (the plain MSE where the ROI is empty);
    with ``batch_sum`` over the whole batch's ROI (or pixels)."""
    se = (pred.float() - target.float()) ** 2
    m = (torch.ones_like(se) if mask is None else
         torch.broadcast_to((mask > 0).float(), se.shape))
    sums = torch.stack([torch.sum(m * se), torch.sum(m), torch.sum(se),
                        se.new_full((), float(se.numel()))])
    if batch_sum is not None:
        sums = batch_sum(sums)
    masked = sums[0] / torch.clamp(sums[1], min=1e-12)
    return torch.where(sums[1] > 0, masked, sums[2] / sums[3])


def mse_from_psnr_db(psnr_db, max_val: float = 1.0) -> torch.Tensor:
    return (max_val ** 2) / (10.0 ** (torch.as_tensor(
        psnr_db, dtype=torch.float32) / 10.0))


def psnr_from_mse(mse, max_val: float = 1.0) -> torch.Tensor:
    return 10.0 * torch.log10(max_val ** 2 / (torch.as_tensor(
        mse, dtype=torch.float32) + 1e-12))


def alm_deadzone_penalty(g: torch.Tensor, rho: float,
                         eps: float = 0.0005) -> torch.Tensor:
    """Dead-zone quadratic penalty 0.5 * rho * relu(mean(g) + eps)^2 for
    the inequality g <= 0."""
    gp = torch.clamp(torch.mean(g) + eps, min=0.0)
    return 0.5 * rho * gp ** 2


def alm_ineq_term(g: torch.Tensor, mu: torch.Tensor,
                  rho: float) -> torch.Tensor:
    """Classic AL term (max(0, mu + rho * g)^2 - mu^2) / (2 rho)."""
    t = torch.clamp(mu + rho * torch.mean(g), min=0.0)
    return (t ** 2 - mu ** 2) / (2.0 * rho)


def alm_dual_update(mu: torch.Tensor, h_accum: torch.Tensor,
                    h_count: torch.Tensor, rho: float, mu_max: float = 1e3):
    """mu <- clip(mu + rho * mean(h), 0, mu_max), and the accumulators
    reset; unchanged while nothing was accumulated."""
    g_bar = h_accum / torch.clamp(h_count, min=1.0)
    new_mu = torch.clamp(mu + rho * g_bar, 0.0, mu_max)
    keep = h_count > 0
    zero = torch.zeros_like(h_accum)
    return (torch.where(keep, new_mu, mu), torch.where(keep, zero, h_accum),
            torch.where(keep, zero, h_count))


def init_psnrm_schedule(path: Optional[str],
                        default_db: float = 35.0) -> torch.Tensor:
    """Per-QP PSNRm targets (dB, 64) from a CSV of qp,psnrm_db rows; gaps
    linearly interpolated; ``default_db`` everywhere without one."""
    targets = [float(default_db)] * 64
    if not path or not os.path.exists(path):
        return torch.tensor(targets, dtype=torch.float32)
    pairs = []
    with open(path) as f:
        for row in csv.DictReader(f):
            qp = (row.get("qp") or row.get("QP") or row.get("q")
                  or row.get("index"))
            ps = (row.get("psnrm_db") or row.get("psnr_db")
                  or row.get("PSNRm") or row.get("psnr"))
            if qp is None or ps is None:
                continue
            qp, ps = int(qp), float(ps)
            if 0 <= qp <= 63:
                pairs.append((qp, ps))
    if not pairs:
        return torch.tensor(targets, dtype=torch.float32)
    pairs.sort()
    xs = [q for q, _ in pairs]
    ys = [p for _, p in pairs]
    return torch.tensor(np.interp(np.arange(64), xs, ys), dtype=torch.float32)
