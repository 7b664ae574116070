#!/usr/bin/env python3
"""Where does the full-width DMCI's bf16 image-loss gradient part from the
fp32 one, on the card and on the CPU?

    python3 experiments/dmci_grad_gap.py [--seed 0]      # on the card

The image trainer's loss (``trainer_image_model.image_loss``: mean(bpp_y)
+ mean(bpp_z) + lambda(32) * mse, train=False: STE rounding, no noise) on
B=2 128x128 frames uniform in [0, 1] from ``--seed`` (the inputs of
``chip_smoke.image_cross_check``), at the full DMCI widths, in four runs
on the same weights: the CPU port in fp32 and in bf16 (plain versions),
the card in bf16 and in fp32 (the kernels). Weight recipes:

  * ``smoke``: ``chip_smoke.random_weights`` with the prior heads at 0.01
    (``DMCI_HEADS``), as the cross-check draws them;
  * ``init``: ``DMCI.init_`` from the seed, the flax-style init the image
    CLI trains from (zero rezero tails, the QP ramps);
  * ``unsat<s>``: ``smoke`` with the reconstruction head drawn small
    (``chip_smoke.unsaturated_recon`` at scale s: dec.dec_2's adaptor and
    tails times s, the adaptor's bias 0.5), so that the reconstruction is
    not clamped at most pixels.

For each recipe and run it prints the share of reconstructed pixels
inside (0, 1) and the loss terms; for each pair of runs the gradient's
cosine and relative error, whole and by module group (each group's share
of the fp32 gradient's squared norm beside it), for the whole loss, the
rate alone and the distortion alone; then one JSON line with all of it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

HW, B, QP = 128, 2, 32
RUNS = (("cpu32", "cpu", "float32"), ("cpu16", "cpu", "bfloat16"),
        ("card16", "cuda", "bfloat16"), ("card32", "cuda", "float32"))
PAIRS = (("card16", "cpu16"), ("cpu16", "cpu32"), ("card16", "cpu32"),
         ("card32", "cpu32"))
TERMS = ("loss", "rate", "distortion")


def group(name: str) -> str:
    """A parameter's module group: enc.enc_1, enc.enc_2, dec.dec_1,
    dec.dec_2, the hyper codec, the prior fusion, the spatial prior, the
    tables."""
    top = name.split(".")[0]
    if top in ("enc", "dec"):
        sub = name.split(".")[1]
        return f"{top}.{sub.rsplit('_', 1)[0] if sub.count('_') > 1 else sub}"
    for prefix in ("hyper", "y_prior_fusion", "y_spatial_prior",
                   "bit_estimator", "q_scale"):
        if top.startswith(prefix):
            return prefix
    return top


def run(torch, dev, dtype, state, x, comp):
    """(loss terms, {term: {param name: fp32 gradient on the CPU}}, share
    of recon pixels inside (0, 1))."""
    from ssgvc_tpu_torch.config import DMCIConfig
    from ssgvc_tpu_torch.models.dmci import DMCI
    from ssgvc_tpu_torch.training.loss import compute_lambda

    model = DMCI(DMCIConfig(dtype=dtype), device=dev)
    model.load_state_dict(state, strict=True)
    xd = x.to(dev)
    out = model(xd, QP, train=False)
    mse = torch.mean((out["dpb"]["frame"].float() - xd) ** 2)
    rate = torch.mean(out["bpp_y"]) + torch.mean(out["bpp_z"])
    dist = compute_lambda(QP, comp.lambda_min, comp.lambda_max,
                          comp.q_levels) * mse
    frame = out["dpb"]["frame"].float()
    inside = float(((frame > 0) & (frame < 1)).float().mean())
    grads = {}
    for term, value in (("rate", rate), ("distortion", dist)):
        model.zero_grad(set_to_none=True)
        value.backward(retain_graph=True)
        grads[term] = {n: (p.grad if p.grad is not None
                           else torch.zeros_like(p)).float().cpu()
                       for n, p in model.named_parameters()}
    grads["loss"] = {n: grads["rate"][n] + grads["distortion"][n]
                     for n in grads["rate"]}
    terms = {"rate": float(rate.detach()), "distortion": float(dist.detach()),
             "loss": float((rate + dist).detach())}
    return terms, grads, inside


def compare(torch, ga, gr):
    """Cosine and relative error of ``ga`` against ``gr``, whole and by
    group, with each group's share of ``gr``'s squared norm."""
    def stats(names):       # in float64: fp32 sums drift by ~0.4% here
        a = torch.cat([ga[n].reshape(-1) for n in names]).double()
        r = torch.cat([gr[n].reshape(-1) for n in names]).double()
        na, nr = torch.linalg.vector_norm(a), torch.linalg.vector_norm(r)
        cos = float(torch.dot(a, r) / (na * nr)) if na * nr > 0 else None
        rel = float(torch.linalg.vector_norm(a - r) / nr) if nr > 0 else None
        return dict(cosine=cos, rel=rel, norm2=float(nr) ** 2)

    whole = stats(list(gr))
    groups = {}
    for n in gr:
        groups.setdefault(group(n), []).append(n)
    by = {g: stats(ns) for g, ns in groups.items()}
    for v in by.values():
        v["share"] = v.pop("norm2") / whole["norm2"]
    whole.pop("norm2")
    return dict(whole=whole, groups=by)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    import chip_smoke
    from ssgvc_tpu_torch.config import CompressionConfig, DMCIConfig
    from ssgvc_tpu_torch.models.dmci import DMCI

    if not torch.cuda.is_available():
        print("dmci_grad_gap: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.phase_device(torch)[0]
    chip_smoke.phase_build()
    rng = np.random.default_rng(args.seed + 160)
    x = torch.tensor(rng.uniform(0, 1, (B, HW, HW, 3)), dtype=torch.float32)
    comp = CompressionConfig()
    result = {"card": card}
    for recipe in ("smoke", "init", "unsat0.1", "unsat0.03", "unsat0.01"):
        model = DMCI(DMCIConfig(), device="cpu")
        if recipe == "init":
            model.init_(torch.Generator().manual_seed(args.seed))
        else:
            chip_smoke.random_weights(torch, model, args.seed,
                                      chip_smoke.DMCI_HEADS)
        if recipe.startswith("unsat"):
            chip_smoke.unsaturated_recon(torch, model,
                                         float(recipe[len("unsat"):]))
        state = model.state_dict()
        runs = {name: run(torch, dev, dtype, state, x, comp)
                for name, dev, dtype in RUNS}
        rec = {"terms": {k: v[0] for k, v in runs.items()},
               "inside": {k: v[2] for k, v in runs.items()}, "pairs": {}}
        print(f"{recipe}: recon pixels inside (0, 1) "
              + ", ".join(f"{k} {v:.4f}" for k, v in rec["inside"].items())
              + "; loss terms " + json.dumps(rec["terms"]))
        for a, r in PAIRS:
            for term in TERMS:
                c = compare(torch, runs[a][1][term], runs[r][1][term])
                rec["pairs"][f"{a}_vs_{r}_{term}"] = c
                worst = sorted(((g, v) for g, v in c["groups"].items()
                                if v["cosine"] is not None),
                               key=lambda kv: kv[1]["cosine"])[:4]
                print(f"  {recipe} {a} vs {r} [{term}]: cosine "
                      f"{c['whole']['cosine']:.5f} (rel "
                      f"{c['whole']['rel']:.3f}); lowest groups "
                      + ", ".join(f"{g} {v['cosine']:.4f} (share "
                                  f"{v['share']:.3f})" for g, v in worst)
                      + f" [{card}]")
        result[recipe] = rec
    print(json.dumps({"dmci_grad_gap": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
