"""dw_fwd (``csrc/dcb_bwd.cu``: g = dw3x3(wsilu(a0)) + b2) alone, at every
training shape (B = 4, ``chip_smoke.BWD_SHAPES``) and at the RD recipe's
shapes (B = 8, rd-mid widths), g in bf16 and in fp32.

Builds ``dcb_bwd`` (ptxas registers and spills of each instantiation),
then at each shape runs ``chip_smoke.dw_fwd_row``: the kernel against its
plain version, timed (``chip_smoke.cuda_ms``: the card's time) beside the
plain version, cuDNN's depthwise conv alone (no WSiLU) and the bound. With
``--prev-port DIR`` (another checkout's ``ssgvc_tpu_torch/``, e.g. the
parent's unpacked by git archive into a git-ignored directory) that
checkout's kernel on the same inputs, in turns (prev, new, new, prev), its
g equal bit for bit. Last, the sums over the shapes, with the card's name
and power limit.

    python experiments/dw_fwd_turns.py [--prev-port DIR]
                                       (needs a CUDA device and nvcc)
"""

import argparse
import importlib
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402

#: The RD recipe's block backwards (rd-mid: C = 32 and 64 on the SIMT
#: forward, 96 on the 3xTF32 one; 64x64 crops, so images of 8x8 and less)
RD_SHAPES = [(8, 8, 8, 96), (8, 8, 8, 64), (8, 4, 4, 64), (8, 4, 4, 32),
             (8, 2, 2, 32), (8, 1, 1, 32)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prev-port", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dw_fwd_turns: no CUDA device", file=sys.stderr)
        return 1
    from ssgvc_tpu_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    card, _, _ = chip_smoke.phase_device(torch)
    log = _build.build(["dcb_bwd"])["dcb_bwd"]
    entry = "?"
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and "dw_fwd" in entry:
            print(f"  {entry}: {m.group(1)} registers")
        if "spill stores" in line and "dw_fwd" in entry:
            print(f"  {entry}: {line.strip()}")
    pdg = None
    if args.prev_port:
        chip_smoke.load_prev_port(args.prev_port)
        pdg = importlib.import_module("prev_port.ops.dcb_grad")
    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    shapes = [("train", (chip_smoke.TRAIN_B, h, w, c))
              for h, w, c in dict.fromkeys(
                  s[:3] for s in chip_smoke.BWD_SHAPES)]
    shapes += [("rd", s) for s in RD_SHAPES]
    sums = {}
    with torch.no_grad():
        for what, shape in shapes:
            case = chip_smoke.bwd_case(torch, rng, *shape, False, dev,
                                       torch.float32)
            for act in (torch.bfloat16, torch.float32):
                r = chip_smoke.dw_fwd_row(torch, case["a0"], case["taps"],
                                          case["b2"], act, pdg)
                print(f"  {what} {'x'.join(map(str, shape))} g "
                      f"{str(act)[6:]}: {chip_smoke.dw_fwd_text(r)} "
                      f"[{card}]")
                s = sums.setdefault((what, str(act)[6:]), {})
                for k in ("ms", "prev_ms", "plain_ms", "library_ms",
                          "bound_ms"):
                    if k in r:
                        s[k] = s.get(k, 0.0) + r[k]
    for (what, act), s in sums.items():
        print(f"sum over the {what} shapes, g {act}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in s.items()) + f" [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
