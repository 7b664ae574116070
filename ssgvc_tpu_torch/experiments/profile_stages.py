"""Per-stage timing + FLOP accounting for the 1080p P-frame forward.

Times each stage of the 'performance' DMC at 1088x1920 in bf16 and prints a
table of ms, GFLOP and achieved TFLOP/s, plus the whole-frame numbers and
their share of the H100's bf16 peak. Use this to pick kernel and fusion
targets.

The stages are the JAX script's nine (``experiments/profile_stages.py``):
the feature adaptor and extractor, the encoder, the mask SFT, the hyper
encoder, the prior parameters (hyper decoder, temporal prior, fusion), one
pass of the spatial prior, the decoder, the reconstruction and the z rate.
Each is timed on its own between CUDA events (``utils/profiling.timed``)
on inputs the earlier stages computed once. GFLOP are the products of
``utils/flops.py``, counted on the meta device at the same shapes: the JAX
script's XLA ``cost_analysis`` also counted elementwise work.

Weights and inputs come from ``--seed`` (``torch.Generator`` and numpy),
where the JAX script drew them from fixed keys.

    python3 -m ssgvc_tpu_torch.experiments.profile_stages [--seed 0]
        [--res 1088x1920] [--profile full] [--device=cpu]
"""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..utils.flops import H100_BF16_FLOPS
from . import split_device

STAGES = ("feature_extractor", "encoder", "mask_sft", "hyper_encoder",
          "prior_params", "spatial_prior(1x)", "decoder", "recon_generation",
          "bit_estimator_z")


def card_line(device) -> str:
    """``nvidia-smi``'s "name, power.limit" of the first card for a CUDA
    ``device``, "cpu (no card)" for the CPU."""
    import subprocess

    if torch.device(device).type != "cuda":
        return "cpu (no card)"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out[0] if out else "nvidia-smi printed nothing"


def share_of_peak(flops_per_s: float, device):
    """``flops_per_s`` as a share of the H100's bf16 peak on the card; None
    elsewhere: a CPU's rate is no share of a card's."""
    if torch.device(device).type != "cuda":
        return None
    return flops_per_s / H100_BF16_FLOPS


def share_text(share) -> str:
    return "not measured" if share is None else f"{100 * share:.2f}%"


def make_inputs(cfg, b: int, h: int, w: int, seed: int, device
                ) -> Dict[str, torch.Tensor]:
    """The JAX script's inputs, drawn from ``seed`` by numpy: a uniform
    frame, a mask of the pixels where a uniform draw exceeds 0.8, a DPB
    (uniform frame, N(0, 0.1) feature at 1/8 resolution), in the model's
    dtype on ``device``; with ``packed_io`` the frames and the mask are
    pixel-unshuffled by 8."""
    from ..models.common import compute_dtype
    from ..ops.pixel import pixel_unshuffle

    rng = np.random.default_rng(seed)
    dt = compute_dtype(cfg.dtype)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device=device, dtype=dt)

    frame = put(rng.uniform(size=(b, h, w, 3)))
    mask = put(rng.uniform(size=(b, h, w, 1)) > 0.8)
    prev = put(rng.uniform(size=(b, h, w, 3)))
    feature = put(rng.standard_normal((b, h // 8, w // 8, cfg.ch_d)) * 0.1)
    if cfg.packed_io:
        frame, mask, prev = (pixel_unshuffle(t, cfg.patch_size)
                             for t in (frame, mask, prev))
    return {"frame": frame, "mask": mask,
            "dpb": {"frame": prev, "feature": feature}}


def stage_calls(model, inputs, qp: int = 32
                ) -> List[Tuple[str, object, tuple, object]]:
    """[(stage, fn, args, output)] in :data:`STAGES` order: each stage's
    arguments are the earlier stages' outputs, computed here once, as the
    JAX script chains them (the quant steps all ones)."""
    m = model
    cfg = m.cfg
    dt, dev = m.dtype, inputs["frame"].device
    q = torch.ones((1, 1, 1, cfg.ch_d), dtype=dt, device=dev)
    q_rec = torch.ones((1, 1, 1, cfg.ch_recon), dtype=dt, device=dev)
    calls = []

    def add(name, fn, *args):
        out = fn(*args)
        calls.append((name, fn, args, out))
        return out

    with torch.no_grad():
        ctx, ctx_t = add("feature_extractor",
                         lambda f, qv: m.feature_extractor(
                             m.feature_adaptor_p(f), qv),
                         inputs["dpb"]["feature"], q)
        y = add("encoder", m.encoder, inputs["frame"], ctx, q)
        add("mask_sft", m.mask_sft, inputs["mask"], q)
        z = add("hyper_encoder", m.hyper_encoder, y)
        pp = add("prior_params", m.res_prior_param_decoder, z, ctx_t)
        add("spatial_prior(1x)", lambda a, b: m.y_spatial_prior((a, b)), y,
            pp)
        f = add("decoder", m.decoder, y, ctx, q)
        add("recon_generation", m.recon_generation_net, f, q_rec)
        add("bit_estimator_z", m.bit_estimator_z.bits, z, qp)
    return calls


def full_frame(model, inputs, qp: int = 32):
    """The whole P-frame forward (``after_i=False``), as the JAX script's
    ``full``."""
    with torch.no_grad():
        return model(inputs["frame"], qp, inputs["dpb"], after_i=False,
                     mask=inputs["mask"])


def count_flops(cfg, b: int, h: int, w: int) -> Dict[str, int]:
    """FLOP (products, ``utils/flops.py``) of each stage and of the whole
    frame ("full") at these shapes, counted on the meta device (the
    inputs' values are drawn, then dropped)."""
    from ..models.dmc import DMC
    from ..utils.flops import count_products

    model = DMC(cfg, device="meta")
    inputs = make_inputs(cfg, b, h, w, 0, "meta")
    out = {}
    # the outer count stands in for the blocks while the stages' inputs
    # are made; each inner count is one stage's
    with count_products():
        for name, fn, args, _ in stage_calls(model, inputs):
            with count_products() as c:
                fn(*args)
            out[name] = c.total
        with count_products() as c:
            full_frame(model, inputs)
    out["full"] = c.total
    return out


def main(argv=None) -> dict:
    device, argv = split_device(sys.argv[1:] if argv is None else argv)

    def arg(name, default, cast=str):
        return cast(argv[argv.index(name) + 1]) if name in argv else default

    from ..config import profile_model_cfgs
    from ..models.dmc import DMC
    from ..utils.profiling import timed

    seed = arg("--seed", 0, int)
    h, w = (int(v) for v in arg("--res", "1088x1920").split("x"))
    iters = arg("--iters", 5, int)
    cfg, _ = profile_model_cfgs(arg("--profile", "full"), "performance",
                                dtype="bfloat16")
    b = 1
    model = DMC(cfg, device=device).init_(
        torch.Generator().manual_seed(seed)).eval()
    inputs = make_inputs(cfg, b, h, w, seed + 1, device)
    flops = count_flops(cfg, b, h, w)

    t = timed(full_frame, model, inputs, iters=iters)
    fl = flops["full"]
    print(f"FULL P-frame fwd: {t*1e3:8.2f} ms  {fl/1e9:8.1f} GFLOP  "
          f"{fl/t/1e12:6.2f} TFLOP/s  ({1/t:.1f} fps)")
    rows = {}
    print()
    tot = 0.0
    for name, fn, args, _ in stage_calls(model, inputs):
        ts = timed(_no_grad(fn), *args, iters=iters)
        tot += ts
        sf = flops[name]
        eff = sf / ts / 1e12 if sf else 0.0
        rows[name] = {"ms": ts * 1e3, "gflop": sf / 1e9, "tflops": eff}
        print(f"{name:20s} {ts*1e3:8.2f} ms  {sf/1e9:8.1f} GFLOP  "
              f"{eff:6.2f} TFLOP/s")
    print(f"{'sum of stages':20s} {tot*1e3:8.2f} ms")
    share = share_of_peak(fl / t, device)
    card = card_line(device)
    print(f"whole frame: {fl/t/1e12:.2f} TFLOP/s, share of the H100's "
          f"{H100_BF16_FLOPS/1e12:.0f} TFLOP/s bf16: {share_text(share)} "
          f"[{card}]")
    return {"full": {"ms": t * 1e3, "gflop": fl / 1e9,
                     "tflops": fl / t / 1e12, "fps": 1 / t,
                     "share_of_peak": share},
            "stages": rows, "sum_of_stages_ms": tot * 1e3,
            "flops": flops, "device": card, "resolution": f"{h}x{w}"}


def _no_grad(fn):
    def call(*args):
        with torch.no_grad():
            return fn(*args)
    return call


if __name__ == "__main__":
    main()
