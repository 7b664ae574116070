"""Streaming per-frame inference with a packed DPB carry.

The DPB travels as ONE tensor (1, H/8, W/8, 3*64 + ch_d): the
pixel-unshuffled reconstruction next to the decoded feature. Each step
drives a raw-io model (``packed_io=False``): it pixel-shuffles the carried
frame back to (1, H, W, 3) before the forward and unshuffles the new one
after it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.pixel import pixel_shuffle, pixel_unshuffle
from .dmc import DMC


class StreamingDMC:
    """Per-frame P-codec forward with a packed DPB."""

    def __init__(self, model: DMC):
        if model.cfg.packed_io:
            raise ValueError("StreamingDMC drives a raw-io model "
                             "(packed_io=False)")
        self.model = model
        c = model.cfg
        self.patch = c.patch_size
        self.frame_ch = 3 * c.patch_size * c.patch_size

    def init_dpb(self, i_frame: torch.Tensor) -> torch.Tensor:
        """Packed DPB from an I-frame reconstruction (feature slot zeros)."""
        xu = pixel_unshuffle(i_frame, self.patch)
        feat = torch.zeros(xu.shape[:3] + (self.model.cfg.ch_d,),
                           dtype=xu.dtype, device=xu.device)
        return torch.cat([xu, feat], dim=-1)

    def unpack_frame(self, packed: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle(packed[..., :self.frame_ch], self.patch)

    @torch.no_grad()
    def step(self, frame: torch.Tensor, mask: torch.Tensor, qp,
             packed_dpb: torch.Tensor, after_i: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One P-frame: returns (new_packed_dpb, bpp)."""
        # a contiguous feature gives the packed-io path's exact products
        dpb = {"frame": self.unpack_frame(packed_dpb),
               "feature": packed_dpb[..., self.frame_ch:].contiguous()}
        out = self.model(frame, qp, dpb, after_i=after_i, mask=mask,
                         train=False)
        xu = pixel_unshuffle(out["dpb"]["frame"], self.patch)
        return torch.cat([xu, out["dpb"]["feature"]], dim=-1), out["bpp"]
