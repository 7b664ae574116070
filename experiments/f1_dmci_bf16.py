#!/usr/bin/env python3
"""Does the JAX package's DMCI lose as much in bf16 as the PyTorch port?

    JAX_PLATFORMS=cpu python experiments/f1_dmci_bf16.py [--seed 0]

Runs the full-width I-frame codec (DMCIConfig: enc_dec 368, N 256,
z_channel 128) on the CPU in bfloat16 and in float32, in both packages, on
the weights and the 128x128 frame that ``chip_smoke.py``'s cross-check uses
(``chip_smoke.random_weights`` with the prior heads at 0.01 of lecun scale,
the frame from ``default_rng(seed + 1)`` after the P-frame cross-check's
draws). For each package it prints the share of the 4-pass prior's
quantized symbols (round() decisions) that bf16 flips against fp32, the
latent y's relative error, and the PSNR between the two decoded frames,
then one JSON line with all of it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

HW = 128
QP = 32


def inputs(seed):
    """The cross-check's 128x128 I-frame input: the P-frame draws first,
    in chip_smoke.phase_cross_check's order."""
    rng = np.random.default_rng(seed + 1)
    rng.uniform(0, 1, (1, HW // 8, HW // 8, 192))
    rng.uniform(0, 1, (1, HW // 8, HW // 8, 64))
    rng.uniform(0, 1, (1, HW // 8, HW // 8, 192))
    rng.standard_normal((1, HW // 8, HW // 8, 256))
    return rng.uniform(0, 1, (1, HW, HW, 3)).astype(np.float32)


def run_port(state, x, dtype):
    """(y, symbols, frame) of the port's DMCI on the CPU."""
    import torch

    from ssgvc_tpu_torch.config import DMCIConfig
    from ssgvc_tpu_torch.models import common
    from ssgvc_tpu_torch.models.dmci import DMCI

    m = DMCI(DMCIConfig(dtype=dtype), device="cpu").eval()
    m.load_state_dict(state, strict=True)
    with torch.no_grad():
        y, q_dec = m.transform_analysis(torch.from_numpy(x), QP)
        z_hat = torch.round(m.hyper_enc(common.pad_for_y(y)))
        prior = common.compress_prior_4x(
            y, m.prior_params(z_hat, y.shape), m.y_spatial_prior_reduction,
            (m.y_spatial_prior_adaptor_1, m.y_spatial_prior_adaptor_2,
             m.y_spatial_prior_adaptor_3), m.y_spatial_prior, None, False)
        frame = torch.clamp(m.dec(prior.y_hat, q_dec), 0.0, 1.0)
    f = lambda t: t.float().numpy()
    return f(y), f(prior.y_q_hat), f(frame)


def run_jax(tree, x, dtype):
    """(y, symbols, frame) of the JAX package's DMCI on the CPU."""
    import jax.numpy as jnp

    from ssgvc_tpu.config import DMCIConfig
    from ssgvc_tpu.models import common
    from ssgvc_tpu.models.dmci import DMCI

    def fwd(mod, x, qp):
        y, q_dec = mod.transform_analysis(x, qp)
        z_hat = jnp.round(mod.hyper_enc(common.pad_for_y(y)))
        prior = common.compress_prior_4x(
            y, mod.prior_params(z_hat, y.shape),
            reduction=mod.y_spatial_prior_reduction,
            adaptors=(mod.y_spatial_prior_adaptor_1,
                      mod.y_spatial_prior_adaptor_2,
                      mod.y_spatial_prior_adaptor_3),
            spatial_prior=mod.y_spatial_prior, rng=None, train=False)
        return y, prior.y_q_hat, jnp.clip(mod.dec(prior.y_hat, q_dec), 0, 1)

    model = DMCI(DMCIConfig(dtype=dtype))
    out = model.apply({"params": tree}, jnp.asarray(x), jnp.int32(QP),
                      method=fwd)
    return tuple(np.asarray(o, np.float32) for o in out)


def compare(fp32, bf16):
    (y32, s32, f32), (y16, s16, f16) = fp32, bf16
    mse = float(np.mean((f16.astype(np.float64) - f32) ** 2))
    return {"flip_rate": float(np.mean(s16 != s32)),
            "flips": int(np.sum(s16 != s32)), "symbols": int(s32.size),
            "y_rel": float(np.linalg.norm(y16 - y32) / np.linalg.norm(y32)),
            "psnr_db": 10 * math.log10(1.0 / max(mse, 1e-20))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    import chip_smoke
    from ssgvc_tpu_torch.config import DMCIConfig
    from ssgvc_tpu_torch.models.dmci import DMCI
    from ssgvc_tpu_torch.utils.weights import flax_from_state_dict

    model = chip_smoke.random_weights(
        torch, DMCI(DMCIConfig(), device="cpu"), args.seed,
        chip_smoke.DMCI_HEADS)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tree = flax_from_state_dict(state)
    x = inputs(args.seed)
    result = {}
    for name, run, w in (("port", run_port, state), ("jax", run_jax, tree)):
        outs = {dt: run(w, x, dt) for dt in ("float32", "bfloat16")}
        result[name] = compare(outs["float32"], outs["bfloat16"])
        r = result[name]
        print(f"{name}: bf16 vs fp32 on the CPU, {HW}x{HW} QP {QP}: "
              f"{r['flips']} of {r['symbols']} symbols flipped "
              f"({100 * r['flip_rate']:.3f}%), latent y rel "
              f"{r['y_rel']:.2e}, frame PSNR {r['psnr_db']:.2f} dB")
    print(json.dumps({"f1": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
