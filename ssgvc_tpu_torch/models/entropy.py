"""Differentiable entropy estimators. All of it runs in fp32, whatever the
dtype of the conv stacks.

  * ``BitEstimator``: per-QP factorized CDF over the hyper latent z
    (4 stacked ``Bitparm`` layers, params (QP, C), rows picked per QP);
  * ``gaussian_bits``: zero-mean Gaussian bits for y, erf-based, hardened
    against NaN/inf and clipped;
  * ``gaussian_bits_cdf``: the CDF-difference variant;
  * ``make_scale_table`` / ``build_scale_indexes``: the log-spaced Gaussian
    scale table and the scale -> table index map.

Both Gaussian estimates use :func:`erf32`, the fp32 erf of the XLA
lowering the JAX package runs on (clamp at +-3.7439, then a rational
polynomial by fused multiply-adds). Where both CDF terms are close to 1 the
bits come from the difference of two erf values a few ulp apart, so an erf
more accurate than the reference's gives another rate for tail symbols
(22.4 against 29.9 bits for y=3, sigma=0.49); this one matches the JAX
package bit for bit.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

_LOG2_RECIP = 1.0 / math.log(2.0)
_ROOT2_RECIP = 1.0 / math.sqrt(2.0)


_ERF_CLAMP = 3.7439212799072266
_ERF_NUM = (0.00022905065270606428, 0.0034082909114658833,
            0.050955694168806076, 0.18520832061767578, 1.1283791065216064)
_ERF_DEN = (-1.1791603071742429e-07, 2.354796561121475e-05,
            0.0010179625824093819, 0.01407046988606453, 0.11098504811525345,
            0.4974692463874817, 1.0)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: float) -> torch.Tensor:
    """fp32 a*b + c with one rounding (the fp64 product of two fp32 values
    is exact)."""
    return (a.double() * b.double() + c).float()


_TWO_RSQRT_PI = 2.0 / math.sqrt(math.pi)


def _erf32_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's lowering of fp32 erf: a clamp, then a rational polynomial."""
    x = torch.clamp(x, -_ERF_CLAMP, _ERF_CLAMP)
    x2 = x * x
    num = torch.full_like(x2, _ERF_NUM[0])
    for c in _ERF_NUM[1:]:
        num = _fma32(num, x2, c)
    den = torch.full_like(x2, _ERF_DEN[0])
    for c in _ERF_DEN[1:]:
        den = _fma32(den, x2, c)
    return x * num / den


class _Erf32(torch.autograd.Function):
    """XLA's erf forward with XLA's erf derivative, 2 / sqrt(pi) *
    exp(-x^2), backward (not the polynomial's own, which is 0 beyond the
    clamp)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _erf32_xla(x)

    @staticmethod
    def backward(ctx, grad):
        x, = ctx.saved_tensors
        return grad * (_TWO_RSQRT_PI * torch.exp(-(x * x)))


def erf32(x: torch.Tensor) -> torch.Tensor:
    """erf in fp32, as XLA lowers it, with XLA's derivative."""
    x = x.float()
    if torch.is_grad_enabled() and x.requires_grad:
        return _Erf32.apply(x)
    return _erf32_xla(x)


def probs_to_bits(probs: torch.Tensor) -> torch.Tensor:
    """-log2(p + 1e-5), clamped at 0."""
    bits = -torch.log(probs + 1e-5) * _LOG2_RECIP
    return torch.clamp(bits, min=0.0)


def gaussian_bits(y: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Hardened erf-based zero-mean Gaussian bit estimate."""
    y = torch.nan_to_num(y.float(), nan=0.0, posinf=1e4, neginf=-1e4)
    sigma = torch.nan_to_num(sigma.float(), nan=1e-5, posinf=1e10,
                             neginf=1e-5)
    sigma = torch.clamp(sigma, 1e-5, 1e10)
    inv_sigma = 1.0 / sigma
    z_hi = torch.clamp((y + 0.5) * inv_sigma, -12.0, 12.0)
    z_lo = torch.clamp((y - 0.5) * inv_sigma, -12.0, 12.0)
    probs = 0.5 * (erf32(z_hi * _ROOT2_RECIP) - erf32(z_lo * _ROOT2_RECIP))
    probs = torch.nan_to_num(probs, nan=0.0, posinf=0.0, neginf=0.0)
    probs = torch.clamp(probs, min=1e-9)
    return -torch.log2(probs)


def gaussian_bits_cdf(y: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Normal CDF difference, then probs_to_bits."""
    y = y.float()
    sigma = torch.clamp(sigma.float(), 1e-5, 1e10)

    def cdf(v):
        return 0.5 * (1.0 + erf32(v / (sigma * math.sqrt(2.0))))

    return probs_to_bits(cdf(y + 0.5) - cdf(y - 0.5))


class Bitparm(nn.Module):
    """One factorized-CDF layer: x*softplus(h)+b (+ tanh(x)*tanh(a) unless
    final); params (qp_num, channel), ``index`` picks the row (an int), or
    one row per sample (a 1-D tensor)."""

    def __init__(self, qp_num: int, channel: int, final: bool = False, *,
                 device="cuda"):
        super().__init__()
        shape = (qp_num, channel)
        self.h = nn.Parameter(torch.zeros(shape, device=device))
        self.b = nn.Parameter(torch.zeros(shape, device=device))
        self.a = (None if final
                  else nn.Parameter(torch.zeros(shape, device=device)))

    def forward(self, x: torch.Tensor, index) -> torch.Tensor:
        row = lambda p: p[index].float().reshape(-1, 1, 1, p.shape[-1])
        x = x * F.softplus(row(self.h)) + row(self.b)
        if self.a is None:
            return x
        return x + torch.tanh(x) * torch.tanh(row(self.a))


class BitEstimator(nn.Module):
    """Per-QP factorized CDF for z: sigmoid of 4 stacked Bitparm layers."""

    def __init__(self, qp_num: int, channel: int, *, device="cuda"):
        super().__init__()
        self.f1 = Bitparm(qp_num, channel, device=device)
        self.f2 = Bitparm(qp_num, channel, device=device)
        self.f3 = Bitparm(qp_num, channel, device=device)
        self.f4 = Bitparm(qp_num, channel, final=True, device=device)

    def init_(self, generator: torch.Generator) -> "BitEstimator":
        """Every layer's h, b and a drawn from N(0, 0.01) as flax inits
        them, on the CPU from ``generator``."""
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(0.01 * torch.randn(p.shape, generator=generator))
        return self

    def get_logits_cdf(self, x: torch.Tensor, index) -> torch.Tensor:
        return self.f4(self.f3(self.f2(self.f1(x, index), index), index),
                       index)

    def get_cdf(self, x: torch.Tensor, index) -> torch.Tensor:
        return torch.sigmoid(self.get_logits_cdf(x, index))

    def forward(self, x: torch.Tensor, index) -> torch.Tensor:
        return self.get_cdf(x, index)

    def bits(self, z: torch.Tensor, index) -> torch.Tensor:
        """-log2(CDF(z+.5) - CDF(z-.5)) via probs_to_bits."""
        z = z.float()
        return probs_to_bits(self.get_cdf(z + 0.5, index)
                             - self.get_cdf(z - 0.5, index))


#: XLA's CPU log (the Cephes polynomial of Eigen's plog): coefficients in
#: the order its three Horner runs take them
_LOG_P = (0.070376836292, -0.1151461031, 0.1167699874, -0.12420140846,
          0.14249322787, -0.16668057665, 0.20000714765, -0.24999993993,
          0.33333331174)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def _log32_xla(x: torch.Tensor) -> torch.Tensor:
    """fp32 log of positive, finite ``x`` as XLA's CPU backend computes it:
    the exponent split off, the mantissa in [sqrt(1/2), sqrt(2)), the
    Cephes polynomial, with the multiply-adds its compiler contracts to
    fused ones. torch's log differs from it by an ulp at ~10% of inputs,
    which moves a log-scale index at a bin edge."""
    f32 = torch.float32
    x = torch.clamp(x.to(f32), min=2.0 ** -126)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).to(f32) + 1.0
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(f32)
    small = m < 0.70710677
    e = e - small.to(f32)
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = x * x
    x3 = x2 * x
    c = [torch.tensor(v, dtype=f32, device=x.device) for v in _LOG_P]
    y = _fma32(_fma32(x, c[0], c[1]), x, c[2])
    y1 = _fma32(_fma32(x, c[3], c[4]), x, c[5])
    y2 = _fma32(_fma32(x, c[6], c[7]), x, c[8])
    y = _fma32(_fma32(y, x3, y1), x3, y2)
    y = _fma32(y, x3, e * torch.tensor(_LOG_Q1, dtype=f32, device=x.device))
    x = _fma32(x2, torch.tensor(-0.5, dtype=f32, device=x.device), x) + y
    return _fma32(e, torch.tensor(_LOG_Q2, dtype=f32, device=x.device), x)


def make_scale_table(scale_min: float = 0.11, scale_max: float = 16.0,
                     levels: int = 128, device=None) -> torch.Tensor:
    """Log-spaced Gaussian scale table (fp32, ``levels`` entries from
    ``scale_min`` to ``scale_max``) on ``device``. The log-spaced line is
    ``jnp.linspace``'s as XLA compiles it (start * (1 - i * (1 / n)) +
    i * (stop * (1 / n)), the second product fused); its exp is torch's,
    within an ulp of XLA's."""
    f32 = torch.float32
    start = torch.tensor(math.log(scale_min), dtype=f32, device=device)
    stop = torch.tensor(math.log(scale_max), dtype=f32, device=device)
    if levels > 1:
        i = torch.arange(levels - 1, dtype=f32, device=device)
        recip = torch.tensor(1.0 / (levels - 1), dtype=f32, device=device)
        line = _fma32(i, stop * recip, start * (1.0 - i * recip))
        line = torch.cat([line, stop[None]])
    else:
        line = start[None]
    return torch.exp(line)


def scale_index_params(scale_min: float = 0.11, scale_max: float = 16.0,
                       levels: int = 128) -> tuple:
    """(log_min, log_step) of the log-scale table: the one definition both
    index maps, :func:`build_scale_indexes` and the coder's
    ``coding/cdf.build_indexes_decoder``, take their bins from."""
    log_min = math.log(scale_min)
    return log_min, (math.log(scale_max) - log_min) / (levels - 1)


def build_scale_indexes(scales: torch.Tensor, scale_min: float = 0.11,
                        scale_max: float = 16.0,
                        levels: int = 128) -> torch.Tensor:
    """Scales -> int32 log-scale table indexes, on the scales' device, in
    fp32 (the entropy math's dtype; a bfloat16 input is widened first):
    clamp to [scale_min, scale_max], then (log(s) - log_min) / log_step
    truncated, as the JAX package computes fp32 scales (XLA's log, a true
    division). A NaN scale takes index 0, as XLA's float-to-int conversion
    gives it (torch's gives INT_MIN).

    A port of the JAX package's public function, which no path of either
    package runs: the coder indexes its tables through
    ``coding/cdf.build_indexes_decoder`` (torch's log times the reciprocal
    step), over the same :func:`scale_index_params`."""
    log_min, log_step = scale_index_params(scale_min, scale_max, levels)
    s = torch.clamp(scales.float(), scale_min, scale_max)
    logs = torch.where(torch.isnan(s), s, _log32_xla(s))
    idx = (logs - log_min) / log_step
    return torch.nan_to_num(idx, nan=0.0).to(torch.int32)
