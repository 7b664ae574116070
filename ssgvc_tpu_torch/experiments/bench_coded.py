"""REAL-bitstream 1080p benchmark: encode + decode fps through the full
codec (the models on the card + host rANS), one card.

Measures the 'performance' DMC variant end to end: analysis transforms on
the card, two checkerboard symbol round trips per P-frame, C++ rANS on the
host (``csrc/rans.cpp``; a threaded two-stream decode with ``--ec-part``),
the decoder checked bit for bit against the encoder's reconstructions.

``--ec-part``: the two rANS cursors decode on two std::threads, so the
gain follows the host's free cores.

    python3 -m ssgvc_tpu_torch.experiments.bench_coded [n_frames]
        [--ec-part] [--skip 0.12] [--packed] [--profile full]
        [--res 1088x1920] [--dtype float32] [--json PATH] [--label L]
        [--seed 0] [--device=cpu]

Prints per-frame encode / decode latency and fps, plus stream sizes; with
``--json`` adds the entry under ``--label`` to that file (keys of the JAX
script's entry, ``backend`` "cuda" on the card, plus the card's ``device``
line and the models' ``dtype``). Weights are the port's default init at
the profile's widths from ``--seed`` (the JAX script's ``init`` from a
fixed key); the frames are drawn by numpy from ``--seed`` + 1. The models
compute in ``--dtype``, float32 by default as in the JAX script; bfloat16
runs the main path's kernels.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from . import ARTIFACTS, split_device
from .profile_stages import card_line


def make_frames(h: int, w: int, n_frames: int, seed: int):
    """(frames [(1, h, w, 3)] * n, mask (1, h, w, 1)) as the JAX script
    draws them: a uniform base in [0.25, 0.75] plus N(0, 0.02) noise per
    frame, clipped to [0, 1]; a mask where a uniform draw exceeds 0.8."""
    rngn = np.random.default_rng(seed)
    base = rngn.uniform(0.25, 0.75, (1, h, w, 3)).astype(np.float32)
    frames = [np.clip(base + 0.02 * rngn.standard_normal(
        (1, h, w, 3)).astype(np.float32), 0, 1) for _ in range(n_frames)]
    mask = (rngn.uniform(0, 1, (1, h, w, 1)) > 0.8).astype(np.float32)
    return frames, mask


def main(argv=None) -> dict:
    device, args = split_device(sys.argv[1:] if argv is None else argv)
    n_frames = int(args[0]) if args and not args[0].startswith("-") else 9
    ec_part = 1 if "--ec-part" in args else 0
    skip = float(args[args.index("--skip") + 1]) if "--skip" in args else 0.0
    json_path = (args[args.index("--json") + 1]
                 if "--json" in args else None)
    packed = "--packed" in args
    label = (args[args.index("--label") + 1] if "--label" in args
             else f"ec_part={ec_part},skip={skip},packed={int(packed)}")
    profile = (args[args.index("--profile") + 1] if "--profile" in args
               else "full")
    res = (args[args.index("--res") + 1] if "--res" in args else "1088x1920")
    dtype = (args[args.index("--dtype") + 1] if "--dtype" in args
             else "float32")
    seed = int(args[args.index("--seed") + 1]) if "--seed" in args else 0
    if json_path:
        parts = os.path.normpath(json_path).split(os.sep)
        if parts[0] == "artifacts" and parts[:2] != ARTIFACTS.split("/"):
            raise SystemExit(f"--json {json_path}: artifacts/ holds the JAX "
                             f"package's records; the port writes under "
                             f"{ARTIFACTS}/")

    from ..coding.codec import VideoCodec
    from ..config import profile_model_cfgs
    from ..models.dmc import DMC
    from ..models.dmci import DMCI

    h, w = (int(v) for v in res.split("x"))
    dmc_cfg, dmci_cfg = profile_model_cfgs(profile, "performance",
                                           dtype=dtype)
    t0 = time.perf_counter()
    dmci = DMCI(dmci_cfg, device=device).init_(
        torch.Generator().manual_seed(seed)).eval()
    dmc = DMC(dmc_cfg, device=device).init_(
        torch.Generator().manual_seed(seed)).eval()
    print(f"[init] params in {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    codec = VideoCodec(dmci, dmc, ec_part=ec_part, skip_thres=skip,
                       packed_dmc=packed)
    print(f"[init] CDF tables in {time.perf_counter() - t0:.1f}s", flush=True)

    frames_np, mask_np = make_frames(h, w, n_frames, seed + 1)
    frames = [torch.from_numpy(f).to(device) for f in frames_np]
    mask = torch.from_numpy(mask_np).to(device)
    qp = 32

    # ---- encode (the first P-frames warm up; steady state after) ----
    feat0 = torch.zeros((1, h // 8, w // 8, dmc.cfg.ch_d), device=device,
                        dtype=dmc.dtype)
    enc_i = codec.dmci_compress(frames[0], qp)
    dpb = {"frame": enc_i["x_hat"], "feature": feat0}
    i_bits = len(enc_i["bit_stream"])

    streams, enc_times, recons = [], [], []
    for t in range(1, n_frames):
        out = codec.dmc_compress(frames[t], qp, dpb, after_i=(t == 1),
                                 mask=mask)
        streams.append(out["bit_stream"])
        enc_times.append(codec.enc_time)
        recons.append(out["x_hat"].cpu())
        dpb = out["dpb"]
        print(f"[enc] frame {t}: {codec.enc_time * 1e3:7.1f} ms  "
              f"{len(out['bit_stream'])} bytes", flush=True)

    # ---- decode ----
    dec_i = codec.dmci_decompress(enc_i["bit_stream"], h, w, qp)
    dpb = {"frame": dec_i["x_hat"], "feature": feat0}
    dec_times = []
    exact = bool(torch.equal(dec_i["x_hat"], enc_i["x_hat"]))
    for t in range(1, n_frames):
        out = codec.dmc_decompress(streams[t - 1], h, w, qp, dpb,
                                   after_i=(t == 1))
        dec_times.append(codec.dec_time)
        exact &= bool(torch.equal(out["x_hat"].cpu(), recons[t - 1]))
        dpb = out["dpb"]
        print(f"[dec] frame {t}: {codec.dec_time * 1e3:7.1f} ms", flush=True)

    # steady state: skip the first two P-frames (the after-I frame and the
    # first of the kind), as the JAX script skips its compiling ones
    ss_enc = enc_times[2:] or enc_times
    ss_dec = dec_times[2:] or dec_times
    enc_ms = float(np.median(ss_enc)) * 1e3
    dec_ms = float(np.median(ss_dec)) * 1e3
    p_bits = [len(s) for s in streams]
    print(f"\nconfig: ec_part={ec_part} skip_thres={skip}")
    print(f"{h}x{w} REAL coded path ('performance', {n_frames - 1} "
          f"P-frames, {dtype}):")
    print(f"  encode: {enc_ms:7.1f} ms/frame  ({1e3 / enc_ms:6.1f} fps)")
    print(f"  decode: {dec_ms:7.1f} ms/frame  ({1e3 / dec_ms:6.1f} fps)")
    print(f"  I-frame {i_bits}B; P-frames median {int(np.median(p_bits))}B "
          f"({np.median(p_bits) * 8 / (h * w):.4f} bpp)")
    print(f"  decoder bit-exact vs encoder recon: {exact}")

    card = card_line(device)
    entry = {
        "backend": torch.device(device).type,
        "device": card,
        "dtype": dtype,
        "profile": profile,
        "resolution": f"{h}x{w}",
        "n_p_frames": n_frames - 1,
        "ec_part": ec_part, "skip_thres": skip, "packed_dmc": packed,
        "enc_ms_per_frame": round(enc_ms, 2),
        "enc_fps": round(1e3 / enc_ms, 2),
        "dec_ms_per_frame": round(dec_ms, 2),
        "dec_fps": round(1e3 / dec_ms, 2),
        "i_frame_bytes": i_bits,
        "p_frame_bytes_median": int(np.median(p_bits)),
        "p_bpp_median": round(float(np.median(p_bits)) * 8 / (h * w), 4),
        "bit_exact": bool(exact),
    }
    if json_path:
        data = {}
        if os.path.exists(json_path):
            with open(json_path) as f:
                data = json.load(f)
        data[label] = entry
        os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(data, f, indent=2)
        print(f"wrote {json_path} [{label}]")
    return entry


if __name__ == "__main__":
    main()
