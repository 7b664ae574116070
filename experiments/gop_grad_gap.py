#!/usr/bin/env python3
"""How close is the port's training gradient to the JAX package's, and how
far does the JAX package's own gradient move between jit and op-by-op?

    JAX_PLATFORMS=cpu python experiments/gop_grad_gap.py [--seed 0]

The trainer's ``gop_loss`` at the tiny profile (fp32, 64x64, B=2, T=3,
QP 20, train=False) and its gradient with respect to the P-frame codec, on
the CPU, on weights drawn by ``chip_smoke.random_weights`` (the setting of
``tests/test_torch_training.py``): the JAX package's gradient jitted and
op by op (``jax.disable_jit``), and the port's. Prints, for the port
against jitted JAX and for op-by-op JAX against jitted JAX, the largest
per-tensor gap (norm of the difference over the tensor's norm) with its
tensor, and the whole gradient's gap; then one JSON line.
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

QP = 20


def gaps(got, want):
    """(largest per-tensor gap, its tensor, whole-gradient gap)."""
    per = {k: np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), 1e-30)
           for k, w in want.items() if np.linalg.norm(w) > 0}
    worst = max(per, key=per.get)
    whole = np.sqrt(sum(np.linalg.norm(got[k] - w) ** 2
                        for k, w in want.items())
                    / sum(np.linalg.norm(w) ** 2 for w in want.values()))
    return float(per[worst]), "/".join(worst), float(whole)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    import chip_smoke
    from ssgvc_tpu.config import TrainConfig as JaxTrainConfig
    from ssgvc_tpu.training.trainer import Trainer as JaxTrainer
    from ssgvc_tpu_torch.config import TrainConfig
    from ssgvc_tpu_torch.data.device_synth import synth_batch
    from ssgvc_tpu_torch.training.trainer import Trainer
    from ssgvc_tpu_torch.utils.weights import flatten, flax_from_state_dict

    cfg = TrainConfig(accumulation_steps=1, model_profile="tiny",
                      precision="32")
    tr = Trainer(cfg, device="cpu")
    chip_smoke.random_weights(torch, tr.dmci, args.seed, chip_smoke.DMCI_HEADS)
    chip_smoke.random_weights(torch, tr.dmc, args.seed + 1,
                              chip_smoke.DMC_HEADS)
    batch = synth_batch(torch.Generator().manual_seed(args.seed + 5),
                        batch=2, size=64, seq_len=3)

    jcfg = JaxTrainConfig(accumulation_steps=1)
    jcfg.model_profile, jcfg.precision = "tiny", "fp32"
    jt = JaxTrainer(jcfg, total_iters=100)
    as_jax = lambda sd: jax.tree_util.tree_map(jnp.asarray,
                                               flax_from_state_dict(sd))
    pp, pi = as_jax(tr.dmc.state_dict()), as_jax(tr.dmci.state_dict())
    frames, masks = (jnp.asarray(batch[k].numpy()) for k in ("frames",
                                                             "masks"))
    f = lambda p: jt.gop_loss(p, pi, frames, masks, jnp.int32(QP),
                              jax.random.PRNGKey(1), train=False,
                              eval_mode=False)[0]
    as_np = lambda tree: {k: np.asarray(v) for k, v in flatten(tree).items()}
    jit = as_np(jax.jit(jax.grad(f))(pp))
    with jax.disable_jit():
        eager = as_np(jax.grad(f)(pp))

    loss, _ = tr.gop_loss(batch["frames"], batch["masks"], QP,
                          torch.Generator().manual_seed(1), train=False,
                          eval_mode=False)
    loss.backward()
    port = as_np(flax_from_state_dict(
        {k: p.grad for k, p in tr.dmc.named_parameters()}))

    out = {}
    for name, got in (("port_vs_jax_jit", port),
                      ("jax_op_by_op_vs_jit", eager)):
        worst, where, whole = gaps(got, jit)
        out[name] = dict(max_tensor_gap=worst, tensor=where,
                         whole_gap=whole)
        print(f"{name}: largest per-tensor gap {worst:.3e} ({where}), "
              f"whole gradient {whole:.3e}")
    print(json.dumps({"gop_grad_gap": out, "profile": "tiny", "hw": 64,
                      "batch": 2, "seq_len": 3, "qp": QP}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
