"""Where the 3xTF32 fp32 kernel's time goes, and grad_reduce against the
parent's.

Builds three copies of ``csrc/dcb_tf32.cu`` beside the real one: as it is;
with no wait on (and no refill of) its weight slabs, so the products read
whatever the ring holds; and with one of each k8 step's three wgmmas.
Times each (CUDA events over launches queued behind a sleep, as
``chip_smoke.cuda_ms``) beside the SIMT fp32 kernel (``csrc/dcb_f32.cu``)
at the main path's fp32 shapes. The variants' outputs are wrong by design:
only their times mean anything. They build into the git-ignored
``ssgvc_tpu_torch/_build/probe/``.

Then ``grad_reduce`` (csrc/dcb_bwd.cu) at the partials' shapes of a
training micro-step (chip_smoke phase 13's counts), timed the same way,
beside ``torch.sum(part, 0)`` and, with ``--prev-port DIR``, another
checkout's ``grad_reduce`` (e.g. the parent's, unpacked by git archive),
each weighted by its launches per micro-step.

    python experiments/kernel_probe.py [--prev-port DIR]
                                        (needs a CUDA device and nvcc)
"""

import argparse
import ctypes
import importlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from ssgvc_tpu_torch.ops import _build  # noqa: E402
from ssgvc_tpu_torch.ops import dcb as dcb_ops  # noqa: E402
from test_torch_kernels_gpu import block_params  # noqa: E402

# (variant, [(text in the source, its replacement)])
VARIANTS = [
    ("as is", []),
    ("no weight waits", [
        ("hop::mbar_wait(&full[slot], (acq / P::R) & 1);", ""),
        ("if (leader && rel + P::R < total) issue(rel + P::R);", "")]),
    ("one wgmma of three", [
        ("hop::Tf32<N>::mma(acc, lo[s], dh);", ""),
        ("hop::Tf32<N>::mma(acc, hi[s], dl);", "")]),
]
SHAPES = [(68, 120, 128), (68, 120, 256), (68, 120, 512), (136, 240, 256),
          (136, 240, 368)]
# grad_reduce's partials (rows, columns) in a default-TrainConfig micro-step
# and its launches at each, as chip_smoke phase 13 counts them
REDUCE_SHAPES = {(128, 4608): 46, (128, 5760): 12, (32, 2304): 9,
                 (8, 2304): 6, (2, 2304): 3, (32, 4608): 3, (32, 6912): 15}


def build():
    """{variant: the C entry of its library}, built in parallel."""
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "dcb_tf32.cu").read_text()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS):
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in dcb_tf32.cu")
            text = text.replace(old, new)
        src = out_dir / f"v{i}.cu"
        src.write_text(text)
        cmd = [_build.nvcc_path(), *_build.FLAGS, "-I", str(_build.CSRC),
               "-o", str(out_dir / f"v{i}.so"), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out_dir / f"v{i}.so")
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(str(lib)).ssgvc_dcb_tf32_forward
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, vp]
        fn.restype = i
        fns[name] = fn
    return fns


def reduce_times(card, prev_path):
    """grad_reduce per micro-step: this checkout's, torch.sum's and (with
    prev_path) the other checkout's, each shape's mean time x its
    launches."""
    from ssgvc_tpu_torch.ops import dcb_grad

    fns = {"kernel": dcb_grad.grad_reduce_cuda,
           "torch.sum": lambda part: torch.sum(part, 0)}
    if prev_path:
        chip_smoke.load_prev_port(prev_path)
        fns["prev"] = importlib.import_module(
            "prev_port.ops.dcb_grad").grad_reduce_cuda
    total = dict.fromkeys(fns, 0.0)
    rng = np.random.default_rng(0)
    for (rows, k), n in REDUCE_SHAPES.items():
        part = torch.tensor(rng.standard_normal((rows, k)),
                            dtype=torch.float32, device="cuda")
        line = []
        for name, fn in fns.items():
            ms = chip_smoke.cuda_ms(torch, lambda: fn(part), 20)
            total[name] += ms * n
            line.append(f"{name} {ms:.4f}")
        print(f"  grad_reduce ({rows}, {k}) x{n}: " + ", ".join(line)
              + f" ms [{card}]")
    print("grad_reduce per micro-step: " + ", ".join(
        f"{name} {ms:.4f} ms" for name, ms in total.items()) + f" [{card}]")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prev-port", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_probe: needs a CUDA device", file=sys.stderr)
        return 1
    card, _, _ = chip_smoke.phase_device(torch)
    fns = build()
    dev = torch.device("cuda")
    for h, w, c in SHAPES:
        rng = np.random.default_rng(c)
        x = torch.tensor(rng.standard_normal((1, h, w, c)),
                         dtype=torch.float32, device=dev)
        params = block_params(c, rng, dev)
        packed, simt = dcb_ops.pack_tf32(params), dcb_ops.pack_f32(params)
        y = torch.empty_like(x)
        stream = torch.cuda.current_stream().cuda_stream
        row = []
        for name, fn in fns.items():
            def run(fn=fn):
                rc = fn(x.data_ptr(), y.data_ptr(), y.data_ptr(),
                        packed.data_ptr(), None, 1, h, w, c, 1, 0, stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            row.append(f"{name} {chip_smoke.cuda_ms(torch, run, 20):.4f}")
        simt_ms = chip_smoke.cuda_ms(
            torch, lambda: dcb_ops.dcb_f32_cuda(x, simt), 20)
        print(f"{h}x{w}x{c}: 3xTF32 kernel " + ", ".join(row)
              + f" ms; SIMT kernel {simt_ms:.4f} ms [{card}]", flush=True)
    reduce_times(card, args.prev_port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
