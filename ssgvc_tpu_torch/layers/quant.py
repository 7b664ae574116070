"""Quantizers: straight-through rounding and the additive-noise proxy.

``torch.round`` rounds half to even, as ``jnp.round`` does. Noise comes from
an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round(x) forward, identity gradient backward."""
    return x + (torch.round(x) - x).detach()


def noise_quant(x: torch.Tensor, generator: Optional[torch.Generator],
                train: bool) -> torch.Tensor:
    """Additive uniform noise U(-0.5, 0.5) in training, hard round at eval."""
    if train:
        if generator is None:
            raise ValueError("noise_quant requires a generator when train=True")
        noise = torch.rand(x.shape, generator=generator, device=x.device,
                           dtype=x.dtype) - 0.5
        return x + noise
    return torch.round(x)
