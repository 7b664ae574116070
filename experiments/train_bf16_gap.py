#!/usr/bin/env python3
"""How far does a bf16 training gradient fall from the fp32 one, in the JAX
package and in the PyTorch port, on the same weights?

    JAX_PLATFORMS=cpu python experiments/train_bf16_gap.py [--seed 0]

The trainer's ``gop_loss`` (performance variant, I-frame then 2 P-frames,
128x128, B=2, QP 32, train=False: STE rounding, no noise) and its gradient
with respect to the P-frame codec, on the CPU, in bfloat16 and in float32,
in both packages, at the rd-mid widths (ch_d 64, DMCI enc_dec 96): the
full profile is not run on a CPU. Weights come from
``chip_smoke.random_weights`` as ``chip_smoke.train_cross_check`` draws
them, for two recipes:

  * ``smoke``: the codec's own reconstruction, whose random head saturates
    the [0, 1] clamp at most pixels;
  * ``residual``: ``recon_residual`` with the recon head at 0.01 of lecun
    scale (a fresh-from-scratch recipe's operating point: the previous
    frame plus a small correction, unsaturated).

For each recipe and package it prints the share of reconstructed pixels
inside (0, 1), the bf16 loss's relative error and the bf16 gradient's
cosine and relative error against fp32, and the fp32 gradients' cosine
between the packages; then one JSON line with all of it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

HW, B, T, QP = 128, 2, 3, 32
DMC_W = dict(ch_d=64, ch_y=32, ch_z=32, ch_recon=96)
DMCI_W = dict(enc_dec=96, N=64, z_channel=32)


def port_trainer(dtype, rr):
    from ssgvc_tpu_torch.config import DMCConfig, DMCIConfig, TrainConfig
    from ssgvc_tpu_torch.training.trainer import Trainer

    return Trainer(TrainConfig(), device="cpu",
                   dmc_cfg=DMCConfig.variant("performance", dtype=dtype,
                                             recon_residual=rr, **DMC_W),
                   dmci_cfg=DMCIConfig(dtype=dtype, **DMCI_W))


def port_grad(dtype, rr, states, data):
    """(loss, {flax path: gradient}, share of unclamped recon pixels)."""
    import torch

    from ssgvc_tpu_torch.utils.weights import flatten, flax_from_state_dict

    tr = port_trainer(dtype, rr)
    tr.dmc.load_state_dict(states[0], strict=True)
    tr.dmci.load_state_dict(states[1], strict=True)
    inside = []
    tr.dmc.recon_generation_net.register_forward_hook(
        lambda m, a, out: inside.append(
            float(((out > 0) & (out < 1)).float().mean())))
    frames, masks = (torch.from_numpy(data[k]) for k in ("frames", "masks"))
    loss, _ = tr.gop_loss(frames, masks, QP, torch.Generator().manual_seed(0),
                          train=False, eval_mode=False)
    loss.backward()
    grads = flatten(flax_from_state_dict(
        {k: p.grad.float() for k, p in tr.dmc.named_parameters()}))
    return float(loss.detach()), grads, float(np.mean(inside))


def jax_grad(dtype, rr, trees, data):
    import jax
    import jax.numpy as jnp

    from ssgvc_tpu.config import DMCConfig, DMCIConfig, TrainConfig
    from ssgvc_tpu.training.trainer import Trainer
    from ssgvc_tpu_torch.utils.weights import flatten

    tr = Trainer(TrainConfig(), dmc_cfg=DMCConfig.variant(
        "performance", dtype=dtype, recon_residual=rr, **DMC_W),
        dmci_cfg=DMCIConfig(dtype=dtype, **DMCI_W))
    pp, pi = (jax.tree_util.tree_map(jnp.asarray, t) for t in trees)
    frames, masks = (jnp.asarray(data[k]) for k in ("frames", "masks"))
    f = lambda p: tr.gop_loss(p, pi, frames, masks, jnp.int32(QP),
                              jax.random.PRNGKey(0), train=False,
                              eval_mode=False)[0]
    loss, g = jax.jit(jax.value_and_grad(f))(pp)
    return float(loss), flatten(g)


def cosine(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    import chip_smoke
    from ssgvc_tpu_torch.data.device_synth import synth_batch
    from ssgvc_tpu_torch.utils.weights import flatten, flax_from_state_dict

    batch = synth_batch(torch.Generator().manual_seed(args.seed + 4),
                        batch=B, size=HW, seq_len=T, device="cpu")
    data = {k: v.numpy() for k, v in batch.items()}
    out = {}
    for recipe, rr in (("smoke", False), ("residual", True)):
        tr = port_trainer("float32", rr)
        heads = (chip_smoke.TRAIN_HEADS if rr else chip_smoke.DMC_HEADS)
        chip_smoke.random_weights(torch, tr.dmc, args.seed, heads)
        chip_smoke.random_weights(torch, tr.dmci, args.seed,
                                  chip_smoke.DMCI_HEADS)
        states = (tr.dmc.state_dict(), tr.dmci.state_dict())
        trees = (flax_from_state_dict(states[0]),
                 flax_from_state_dict(states[1]))
        keys = list(flatten(trees[0]))
        vec = lambda g: np.concatenate([np.asarray(g[k], np.float32).ravel()
                                        for k in keys])
        res = {("port", dt): port_grad(dt, rr, states, data)
               for dt in ("float32", "bfloat16")}
        res.update({("jax", dt): jax_grad(dt, rr, trees, data)
                    for dt in ("float32", "bfloat16")})
        row = {}
        for pkg in ("port", "jax"):
            (l32, g32), (l16, g16) = ((res[pkg, dt][0], vec(res[pkg, dt][1]))
                                      for dt in ("float32", "bfloat16"))
            row[pkg] = dict(loss_rel=abs(l16 - l32) / abs(l32),
                            grad_cosine=cosine(g16, g32),
                            grad_rel=float(np.linalg.norm(g16 - g32)
                                           / np.linalg.norm(g32)))
        row["inside_01_fp32"] = res["port", "float32"][2]
        row["fp32_port_vs_jax_cosine"] = cosine(
            vec(res["port", "float32"][1]), vec(res["jax", "float32"][1]))
        out[recipe] = row
        print(f"{recipe}: recon pixels inside (0, 1) "
              f"{row['inside_01_fp32']:.3f}; "
              f"bf16 vs fp32: port loss rel {row['port']['loss_rel']:.2e}, "
              f"gradient cosine {row['port']['grad_cosine']:.4f} (rel "
              f"{row['port']['grad_rel']:.3f}); JAX loss rel "
              f"{row['jax']['loss_rel']:.2e}, gradient cosine "
              f"{row['jax']['grad_cosine']:.4f} (rel "
              f"{row['jax']['grad_rel']:.3f}); fp32 port vs JAX gradient "
              f"cosine {row['fp32_port_vs_jax_cosine']:.6f}")
    print(json.dumps({"train_bf16_gap": out, "widths": {"dmc": DMC_W,
                                                        "dmci": DMCI_W},
                      "hw": HW, "batch": B, "seq_len": T, "qp": QP}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
