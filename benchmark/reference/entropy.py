"""The codec's rate estimate in plain PyTorch, fp32.

The model defines its Gaussian rate through an fp32 erf of a fixed form:
a clamp at +-3.7439, then a rational polynomial evaluated by fused
multiply-adds. Where both CDF terms lie near 1 the bits are the
difference of two erf values a few ulp apart, so an erf of another form
gives another rate for tail symbols; the reference therefore computes
the same polynomial (each fused multiply-add as an fp64 product and sum
rounded once to fp32). The hyper latent's rate is a per-QP factorized
CDF of four layers.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import Params

ERF_CLAMP = 3.7439212799072266
ERF_NUM = (0.00022905065270606428, 0.0034082909114658833,
           0.050955694168806076, 0.18520832061767578, 1.1283791065216064)
ERF_DEN = (-1.1791603071742429e-07, 2.354796561121475e-05,
           0.0010179625824093819, 0.01407046988606453, 0.11098504811525345,
           0.4974692463874817, 1.0)


def _fma(a: torch.Tensor, b: torch.Tensor, c: float) -> torch.Tensor:
    return (a.double() * b.double() + c).float()


def erf(x: torch.Tensor) -> torch.Tensor:
    """fp32 erf in the model's form."""
    x = torch.clamp(x.float(), -ERF_CLAMP, ERF_CLAMP)
    x2 = x * x
    num = torch.full_like(x2, ERF_NUM[0])
    for c in ERF_NUM[1:]:
        num = _fma(num, x2, c)
    den = torch.full_like(x2, ERF_DEN[0])
    for c in ERF_DEN[1:]:
        den = _fma(den, x2, c)
    return x * num / den


def probs_to_bits(p: torch.Tensor) -> torch.Tensor:
    """-log2(p + 1e-5), at least 0."""
    return torch.clamp(-torch.log(p + 1e-5) / math.log(2.0), min=0.0)


def gaussian_bits(y: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Bits of integer ``y`` under a zero-mean Gaussian of ``sigma``: the
    erf difference, clamped and guarded against NaN and inf."""
    y = torch.nan_to_num(y.float(), nan=0.0, posinf=1e4, neginf=-1e4)
    sigma = torch.nan_to_num(sigma.float(), nan=1e-5, posinf=1e10,
                             neginf=1e-5)
    inv = 1.0 / torch.clamp(sigma, 1e-5, 1e10)
    hi = torch.clamp((y + 0.5) * inv, -12.0, 12.0)
    lo = torch.clamp((y - 0.5) * inv, -12.0, 12.0)
    r2 = 1.0 / math.sqrt(2.0)
    p = 0.5 * (erf(hi * r2) - erf(lo * r2))
    p = torch.clamp(torch.nan_to_num(p, nan=0.0, posinf=0.0, neginf=0.0),
                    min=1e-9)
    return -torch.log2(p)


def gaussian_bits_cdf(y: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Bits of ``y`` as the difference of two normal CDFs."""
    y = y.float()
    s = torch.clamp(sigma.float(), 1e-5, 1e10) * math.sqrt(2.0)
    cdf = lambda v: 0.5 * (1.0 + erf(v / s))
    return probs_to_bits(cdf(y + 0.5) - cdf(y - 0.5))


def factorized_bits(z: torch.Tensor, p: Params, qp: int) -> torch.Tensor:
    """Bits of integer ``z`` under the per-QP factorized CDF: four layers
    x * softplus(h) + b (+ tanh(x) * tanh(a) but in the last), row ``qp``
    of each table, then a sigmoid."""
    def cdf(x):
        for i in range(1, 5):
            layer = p.sub(f"f{i}")
            row = lambda k: layer[k][qp].reshape(1, 1, 1, -1)
            x = x * F.softplus(row("h")) + row("b")
            if i < 4:
                x = x + torch.tanh(x) * torch.tanh(row("a"))
        return torch.sigmoid(x)

    z = z.float()
    return probs_to_bits(cdf(z + 0.5) - cdf(z - 0.5))
