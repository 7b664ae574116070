#!/usr/bin/env python3
"""Phase 24 of ``chip_smoke.py`` (the opt-in experiments) on the CPU, at
the tiny profile, with the plain versions in place of the kernels.

    python experiments/p24_cpu_rehearsal.py [--hw 128] [--threads 4]

What the card runs with ``csrc/qconv.cu`` and the DepthConvBlock kernels
runs here through ``qconv_plain`` and the blocks' plain versions, counted
as the kernels' wrappers count; CUDA events become a host timer. The
phase's own code is unchanged: the site listing from the codecs'
SSGVC_INT8=1 forwards, (a) the int8 conv against its plain version
(trivially equal here) with the library route, (b) the int8 P-frame in
modes 1 / 2 and scope 3x3 beside bf16 with the fused-kernel launches,
(c) the int8 coded GOP decoded bit for bit, (d) shiftadd against the
grouped conv, (e) the fused patch convs in bf16 and fp32, (g) the int8
gradient's backward launches and the default TrainConfig's int8
micro-step at the tiny profile; (f), ranks sharing the card, is the
card's alone (tests/test_torch_parallel.py runs the row-sharded int8
frame on the CPU). It prints the
phase's lines and its JSON: the whole-frame differences of (d) and (e)
and the int8 frames' PSNR against bf16 (random weights), which set what
phase 24 gates and what it only prints. Times are the CPU's, not the
card's. ~1.5 min on 4 threads.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = dict(ch_d=16, ch_y=8, ch_z=8, ch_recon=16)
DMCI_TINY = dict(enc_dec=32, N=16, z_channel=8)


def host_ms(torch, fn, reps, warmup=2):
    """chip_smoke.cuda_ms on the host clock."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def stub_card(torch, cs, hw):
    """Point the smoke at the CPU at the tiny widths, and count the plain
    versions as the kernels' wrappers count their launches."""
    import ssgvc_tpu_torch.config as config
    from ssgvc_tpu_torch.layers import blocks
    from ssgvc_tpu_torch.ops import dcb as dcb_ops
    from ssgvc_tpu_torch.ops import dcb_chain as chain_ops
    from ssgvc_tpu_torch.ops import qconv as qconv_ops

    cs.DEVICE = "cpu"
    cs.H = cs.W = hw
    cs.cuda_ms = host_ms
    torch.cuda.synchronize = lambda *a, **k: None
    config.DMCIConfig = functools.partial(config.DMCIConfig, **DMCI_TINY)
    variant = config.DMCConfig.variant
    config.DMCConfig.variant = staticmethod(
        lambda v, **kw: variant(v, **{**TINY, **kw}))

    def counted(fn, module, name="launches"):
        def run(*a, **k):
            setattr(module, name, getattr(module, name) + 1)
            return fn(*a, **k)
        return run

    qconv_ops.qconv_cuda = counted(qconv_ops.qconv_plain, qconv_ops)
    # the forward's and the int8 backward's calls alike
    qconv_ops.qconv = blocks.qconv = counted(qconv_ops.qconv, qconv_ops)
    blocks.dcb_grad = counted(blocks.dcb_grad, dcb_ops)
    blocks.dcb_chain_grad = counted(blocks.dcb_chain_grad, chain_ops)

    class Event:                        # CUDA events on the host clock
        def __init__(self, **kw):
            self.t = None

        def record(self):
            self.t = time.perf_counter()

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return 1e3 * (other.t - self.t)

    torch.cuda.Event = Event
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    train_init = config.TrainConfig.__init__

    def tiny_train(self, *a, **kw):
        train_init(self, *a, **kw)
        self.model_profile = "tiny"

    config.TrainConfig.__init__ = tiny_train
    # (f) spawns ranks that share cuda:0 over gloo: the card's alone (the
    # row shard's CPU runs are tests/test_torch_parallel.py's)
    cs.p24_rows = lambda torch, seed, card, tmp: {"runs": [],
                                                  "skipped": "no card"}


def earlier_phases(torch, cs, hw, seed=0):
    """What phases 4, 5 and 9 hand phase 24: the I-frame's state and
    decoded frame, the packed performance P-frame's state, frames, masks
    and DPB frame, and the fast and mask_prop states; drawn weights."""
    import ssgvc_tpu_torch.config as config
    from ssgvc_tpu_torch.models.dmc import DMC
    from ssgvc_tpu_torch.models.dmci import DMCI

    g = torch.Generator().manual_seed(seed)
    bf16 = torch.bfloat16
    dmci = cs.random_weights(torch, DMCI(config.DMCIConfig(
        dtype="bfloat16"), device="cpu"), seed, cs.DMCI_HEADS).eval()
    with torch.no_grad():
        frame = dmci(torch.rand((1, hw, hw, 3), generator=g),
                     cs.QP)["dpb"]["frame"]
    iframe = {"state": dmci.state_dict(), "frame": frame}

    def state(variant):
        model = DMC(config.DMCConfig.variant(variant, dtype="bfloat16",
                                             packed_io=True), device="cpu")
        return cs.random_weights(torch, model, seed).state_dict()

    main = {"state": state("performance"),
            "frames": torch.rand((3, 1, hw, hw, 3), generator=g).to(bf16),
            "masks": (torch.rand((3, 1, hw, hw, 1), generator=g)
                      > 0.8).to(bf16),
            "dpb_frame": frame.to(bf16)}
    return iframe, main, {v: state(v) for v in ("fast", "mask_prop")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hw", type=int, default=128)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs

    torch.set_num_threads(args.threads)
    stub_card(torch, cs, args.hw)
    iframe, main_path, variant_states = earlier_phases(torch, cs, args.hw)
    out, entry = cs.phase_experiments(torch, 0, "CPU, plain versions",
                                      iframe, main_path, variant_states)
    entry.pop("shapes")
    print(json.dumps({"experiments": out, "qconv": entry}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
