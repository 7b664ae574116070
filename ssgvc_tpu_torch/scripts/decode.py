"""Decode a stream file back to PNG frames:

    python3 -m ssgvc_tpu_torch.scripts.decode --input out.bin \\
        --output recon_dir --checkpoint logs/.../checkpoints/last \\
        [--variant performance] [--profile full] [--device=cpu]

Writes im00001.png, im00002.png, ... (RGB) into ``--output``.
"""

from __future__ import annotations

import argparse
import sys

from . import load_codec, model_args


def main(argv=None):
    """Decode as the command line says; returns the decoded frames (YCbCr,
    each (H, W, 3), on the host)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    model_args(ap)
    args = ap.parse_args(argv)

    from ..coding.session import CodingSession
    from ..utils.transforms import ycbcr2rgb_np
    from ..utils.video_io import PNGWriter

    session = CodingSession(load_codec(args))
    writer = PNGWriter(args.output)
    with open(args.input, "rb") as f:
        frames = session.decode_sequence(f)
    for ycbcr in frames:
        writer.write_one_frame(ycbcr2rgb_np(ycbcr))
    print(f"decoded {len(frames)} frames -> {args.output}")
    return frames


if __name__ == "__main__":
    main(sys.argv[1:])
