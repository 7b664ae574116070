"""Encode a PNG frame directory into a stream file:

    python3 -m ssgvc_tpu_torch.scripts.encode --input frames_dir \\
        --output out.bin --checkpoint logs/.../checkpoints/last --qp 32 \\
        [--gop 32] [--variant performance] [--profile full] \\
        [--max-frames N] [--device=cpu]

Frames follow the ``im%05d.png`` naming (im00001.png, ...). Writes the
container (SPS, then I / P units), one I-frame per ``--gop`` frames, no
masks, and prints each frame's bits, bpp and PSNR against the source.
"""

from __future__ import annotations

import argparse
import sys

from . import load_codec, model_args


def main(argv=None):
    """Encode as the command line says; returns the session's stats (bits
    per frame, frame types, the encoder's reconstructions in YCbCr)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--qp", type=int, default=32)
    ap.add_argument("--gop", type=int, default=32)
    ap.add_argument("--max-frames", type=int, default=None)
    model_args(ap)
    args = ap.parse_args(argv)

    import numpy as np

    from ..coding.session import CodingSession
    from ..utils.metrics import calc_psnr
    from ..utils.transforms import rgb2ycbcr_np
    from ..utils.video_io import PNGReader

    session = CodingSession(load_codec(args), gop_size=args.gop)
    reader = PNGReader(args.input)
    frames = []
    while True:
        rgb = reader.read_one_frame()
        if rgb is None or (args.max_frames and len(frames) >= args.max_frames):
            break
        frames.append(rgb2ycbcr_np(rgb))
    if not frames:
        raise SystemExit(f"no frames found in {args.input}")
    frames = np.stack(frames)

    with open(args.output, "wb") as f:
        stats = session.encode_sequence(f, frames, qp=args.qp)

    total_bits = sum(stats["frame_bits"])
    pixels = frames.shape[1] * frames.shape[2]
    for t, (bits, ftype, rec) in enumerate(zip(stats["frame_bits"],
                                               stats["frame_types"],
                                               stats["recons"])):
        psnr = calc_psnr(frames[t], rec)
        print(f"frame {t:4d} [{ftype}] {bits:8d} bits "
              f"({bits / pixels:.4f} bpp)  psnr {psnr:.2f}")
    print(f"total: {total_bits} bits, avg "
          f"{total_bits / len(frames) / pixels:.4f} bpp -> {args.output}")
    return stats


if __name__ == "__main__":
    main(sys.argv[1:])
