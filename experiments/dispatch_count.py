#!/usr/bin/env python3
"""Count the torch operations one P-frame forward dispatches, here and in
another checkout of the port, on the same weights and inputs.

    python experiments/dispatch_count.py --prev-port _prev/ssgvc_tpu_torch

The host's share of a P-frame grows with the operations it dispatches, so
two checkouts whose forwards dispatch the same operations and give the
same outputs put the same work on the host, whatever their times on a
noisy host say. Runs on the CPU (the plain versions) at rd-tiny widths,
packed io, the performance variant, both ``after_i`` values; prints one
JSON line.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

WIDTHS = dict(ch_d=32, ch_y=16, ch_z=16, ch_recon=32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prev-port", required=True,
                    help="another checkout's ssgvc_tpu_torch/")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    import chip_smoke
    from ssgvc_tpu_torch.config import DMCConfig
    from ssgvc_tpu_torch.models.dmc import DMC

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    chip_smoke.load_prev_port(args.prev_port)
    prev_cfg = importlib.import_module("prev_port.config")
    prev_dmc = importlib.import_module("prev_port.models.dmc")
    new = chip_smoke.random_weights(
        torch, DMC(DMCConfig.variant("performance", packed_io=True,
                                     **WIDTHS), device="cpu"), args.seed)
    prev = prev_dmc.DMC(prev_cfg.DMCConfig.variant(
        "performance", packed_io=True, **WIDTHS), device="cpu")
    prev.load_state_dict(new.state_dict(), strict=True)

    rng = np.random.default_rng(args.seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    x = t(rng.uniform(0, 1, (1, 16, 16, 192)))
    mask = t(rng.uniform(0, 1, (1, 16, 16, 64)) > 0.8)
    dpb = {"frame": t(rng.uniform(0, 1, (1, 16, 16, 192))),
           "feature": t(0.1 * rng.standard_normal((1, 16, 16, 32)))}
    result = {}
    for after_i in (True, False):
        outs, counts = {}, {}
        for name, model in (("prev", prev.eval()), ("new", new.eval())):
            c = Count()
            with torch.no_grad(), c:
                outs[name] = model(x, 32, dpb, after_i=after_i, mask=mask)
            counts[name] = c.n
        same = all(torch.equal(outs["prev"][k], outs["new"][k])
                   for k in ("bpp", "bpp_y", "bpp_z")) and all(
            torch.equal(outs["prev"]["dpb"][k], outs["new"]["dpb"][k])
            for k in ("frame", "feature"))
        result[f"after_i={after_i}"] = dict(ops=counts, outputs_equal=same)
        print(f"after_i={after_i}: ops dispatched per frame prev "
              f"{counts['prev']}, new {counts['new']}; outputs equal: {same}")
    print(json.dumps({"dispatch_count": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
