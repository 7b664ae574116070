"""Sequence-level coding sessions: frames <-> container files.

Glues the per-frame codec (``coding/codec.py``) to the container
(``coding/bitstream.py``): one I-frame per GOP, then P-frames at the
per-position QP of ``index_map`` (an index into ``DMCConfig.qp_shift``).
For mask_prop only the first P-frame's mask is used; later frames take the
mask chain the decoder predicts itself.
"""

from __future__ import annotations

from typing import BinaryIO, Dict, List, Optional, Sequence

import numpy as np
import torch

from .bitstream import BitstreamReader, BitstreamWriter
from .codec import VideoCodec

DEFAULT_INDEX_MAP = (0, 1, 0, 2, 0, 2, 0, 2)


class CodingSession:
    """Stateful encode/decode over whole sequences."""

    def __init__(self, codec: VideoCodec,
                 index_map: Sequence[int] = DEFAULT_INDEX_MAP,
                 gop_size: int = 32):
        self.codec = codec
        self.index_map = list(index_map)
        self.gop_size = gop_size

    def _curr_qp(self, qp: int, t: int) -> int:
        return self.codec.dmc.shift_qp(
            qp, self.index_map[t % len(self.index_map)])

    def _device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))[None].to(
            self.codec.device)

    def _feature0(self, height: int, width: int) -> torch.Tensor:
        dmc = self.codec.dmc
        return torch.zeros((1, height // 8, width // 8, dmc.cfg.ch_d),
                           dtype=dmc.dtype, device=self.codec.device)

    def encode_sequence(self, f: BinaryIO, frames: np.ndarray, qp: int,
                        masks: Optional[np.ndarray] = None) -> Dict:
        """frames: (T, H, W, 3) YCbCr in [0, 1]; masks: (T, H, W, 1) or
        None. Writes SPS + I/P units to ``f``; returns stats (bits per
        frame, frame types, the encoder's reconstructions and, for
        mask_prop, its mask chain), all on the host."""
        t_total, h, w, _ = frames.shape
        writer = BitstreamWriter(f)
        propagated = self.codec.dmc.cfg.mask_source == "propagated"
        stats: Dict = {"frame_bits": [], "frame_types": [], "recons": [],
                       "masks": []}
        dpb = None
        mask_carry = None
        for t in range(t_total):
            in_gop = t % self.gop_size
            x = self._device(frames[t])
            if in_gop == 0:
                out = self.codec.dmci_compress(x, qp)
                writer.write_frame(True, h, w, qp, out["bit_stream"])
                dpb = {"frame": out["x_hat"], "feature": self._feature0(h, w)}
                mask_carry = None
                stats["frame_types"].append("I")
            else:
                curr_qp = self._curr_qp(qp, in_gop)
                after_i = in_gop == 1
                mask = self._device(masks[t]) if masks is not None else None
                if propagated and not after_i and mask_carry is not None:
                    # only the first P-frame's mask is transmitted
                    mask = mask_carry
                out = self.codec.dmc_compress(x, curr_qp, dpb,
                                              after_i=after_i, mask=mask)
                writer.write_frame(False, h, w, curr_qp, out["bit_stream"])
                dpb = out["dpb"]
                mask_carry = out["mask_out"]
                if mask_carry is not None:
                    stats["masks"].append(mask_carry[0].float().cpu().numpy())
                stats["frame_types"].append("P")
            stats["frame_bits"].append(len(out["bit_stream"]) * 8)
            stats["recons"].append(out["x_hat"][0].float().cpu().numpy())
        return stats

    def decode_sequence(self, f: BinaryIO,
                        masks: Optional[np.ndarray] = None,
                        return_masks: bool = False):
        """Reads the container; returns the decoded frames (each (H, W, 3),
        on the host). ``masks`` (mask_prop): the out-of-band masks, of which
        only the entries right after an I-frame are used; ``return_masks``
        also returns the decoder's mask chain (one logit map per
        P-frame)."""
        reader = BitstreamReader(f)
        frames: List[np.ndarray] = []
        mask_chain: List[np.ndarray] = []
        dpb = None
        after_i = False
        mask_carry = None
        t = 0
        while True:
            unit = reader.read_frame()
            if unit is None:
                break
            sps = unit["sps"]
            if unit["type"] == "i":
                out = self.codec.dmci_decompress(unit["payload"], sps.height,
                                                 sps.width, unit["qp"])
                dpb = {"frame": out["x_hat"],
                       "feature": self._feature0(sps.height, sps.width)}
                after_i = True
                mask_carry = None
            else:
                if after_i and masks is not None:
                    mask_carry = self._device(masks[t])
                out = self.codec.dmc_decompress(unit["payload"], sps.height,
                                                sps.width, unit["qp"], dpb,
                                                after_i=after_i,
                                                mask=mask_carry)
                dpb = out["dpb"]
                mask_carry = out["mask_out"]
                if mask_carry is not None:
                    mask_chain.append(mask_carry[0].float().cpu().numpy())
                after_i = False
            frames.append(out["x_hat"][0].float().cpu().numpy())
            t += 1
        if return_masks:
            return frames, mask_chain
        return frames
