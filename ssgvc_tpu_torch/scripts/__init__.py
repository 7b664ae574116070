"""The coding command lines: ``python3 -m ssgvc_tpu_torch.scripts.encode``
(a PNG directory to a stream file) and ``.decode`` (back to PNGs), over
``coding.session.CodingSession``. Both read a port checkpoint holding
``params_p`` and ``params_i`` (the video trainer's ``checkpoints/last``)
and run on the card unless ``--device=cpu``.
"""

from __future__ import annotations

import argparse


def model_args(ap: argparse.ArgumentParser) -> None:
    """The arguments both scripts take to build the codec."""
    ap.add_argument("--checkpoint", required=True,
                    help="port checkpoint holding params_p and params_i "
                         "(the video trainer's checkpoints/last)")
    ap.add_argument("--variant", default="performance")
    ap.add_argument("--profile", default="full",
                    help="model size profile (full | tiny | rd-tiny | rd-mid"
                         " | rd-half): must match the checkpoint")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")


def load_codec(args):
    """The VideoCodec of ``args``' checkpoint, profile and variant, its
    models on ``args.device`` in eval mode."""
    from ..coding.codec import VideoCodec
    from ..config import profile_model_cfgs
    from ..models.dmc import DMC
    from ..models.dmci import DMCI
    from ..utils.checkpoint import restore_checkpoint

    ckpt = restore_checkpoint(args.checkpoint)
    missing = [k for k in ("params_p", "params_i") if k not in ckpt]
    if missing:
        raise KeyError(f"checkpoint {args.checkpoint} lacks {missing}")
    dmc_cfg, dmci_cfg = profile_model_cfgs(args.profile, args.variant)
    dmc = DMC(dmc_cfg, device=args.device)
    dmci = DMCI(dmci_cfg, device=args.device)
    dmc.load_state_dict(ckpt["params_p"], strict=True)
    dmci.load_state_dict(ckpt["params_i"], strict=True)
    return VideoCodec(dmci.eval(), dmc.eval())
