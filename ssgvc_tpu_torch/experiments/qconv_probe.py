"""Where the int8 conv's 1x1 route spends its time, on the card: cut copies
of ``csrc/qconv.cu`` (each with one part of the work taken out), built
beside the real one and timed at the P-frame's heaviest 1x1 shapes, and
the real kernel under other plans (row tile, ring slots) than
``ops.qconv.plan_1x1``'s.

    python3 -m ssgvc_tpu_torch.experiments.qconv_probe [--reps 40]

The cuts: ``no_div`` multiplies by s_x where the kernel divides (the
IEEE division's cost), ``no_quant`` stores the loaded bits unquantized,
``no_load`` quantizes without reading x, ``no_mma`` issues no wgmma (the
ring still streams), ``no_epi`` skips the epilogue's arithmetic and
``no_store`` also its stores. A cut's output is wrong; only its time is
read. The cut sources and their libraries go to ``_build/qconv_probe``.
Prints a line per (shape, variant) and one JSON object last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from .profile_stages import card_line
from .qconv_turns import cuda_ms

SHAPES = [((1, 136, 240, 256), 1024), ((1, 136, 240, 256), 256),
          ((1, 136, 240, 512), 256), ((1, 68, 120, 384), 1536),
          ((1, 68, 120, 384), 384)]

#: (name, [(regex, replacement)]) applied to csrc/qconv.cu
CUTS = [
    ("no_div", [(r"__fdiv_rn\(v, sx\)", "v * sx")]),
    ("no_quant", [(r"v = quant16\(f, sx\);",
                   "v = make_uint4(__float_as_uint(f[0]), "
                   "__float_as_uint(f[5]), __float_as_uint(f[10]), "
                   "__float_as_uint(f[15]));")]),
    ("no_load", [(r"if \(ok\[u\]\) load_raw\(", "if (false) load_raw(")]),
    ("no_mma", [(r"for \(int kk = 0; kk < KC / 32; \+\+kk\)\n",
                 "for (int kk = 0; kk < 0; ++kk)\n")]),
    ("no_epi", [(r"for \(int j = 0; j < SW / 8; \+\+j\) \{",
                 "for (int j = 0; j < 0; ++j) {")]),
    ("no_store", [(r"for \(int j = 0; j < SW / 8; \+\+j\) \{",
                   "for (int j = 0; j < 0; ++j) {"),
                  (r"if \(m < M\)\n(\s*)bulk_store\(",
                   r"if (m < 0)\n\1bulk_store(")]),
]


def build_variant(name, subs, out_dir: Path):
    from ..ops import _build

    src = (_build.CSRC / "qconv.cu").read_text()
    for pat, rep in subs:
        src, n = re.subn(pat, rep, src)
        if n == 0:
            raise RuntimeError(f"{name}: {pat!r} matches nothing")
    cu = out_dir / f"qconv_{name}.cu"
    cu.write_text(src)
    lib = out_dir / f"libqconv_{name}.so"
    return cu, lib


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("qconv_probe: no CUDA device")
    from ..ops import _build
    from ..ops import qconv as Q

    card = card_line("cuda")
    out_dir = _build.BUILD_DIR / "qconv_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, subs in CUTS:
        cu, lib = build_variant(name, subs, out_dir)
        cmd = [_build.nvcc_path(), *_build.FLAGS, f"-I{_build.CSRC}", "-o",
               str(lib), str(cu)]
        jobs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    real = Q._lib()
    libs = {"real": real}
    for name, lib, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{text}")
        cdll = ctypes.CDLL(str(lib))
        fn = cdll.ssgvc_qconv_1x1
        fn.argtypes, fn.restype = real.ssgvc_qconv_1x1.argtypes, ctypes.c_int
        cdll.ssgvc_error_string.argtypes = [ctypes.c_int]
        cdll.ssgvc_error_string.restype = ctypes.c_char_p
        libs[name] = cdll
    rng = np.random.default_rng(args.seed)
    rows = []
    for shape, o in SHAPES:
        b, h, w, cin = shape
        m = b * h * w
        x = torch.tensor(rng.standard_normal(shape), dtype=torch.bfloat16,
                         device="cuda")
        wt = torch.tensor(rng.standard_normal((o, cin, 1, 1)) * cin ** -0.5,
                          dtype=torch.float32, device="cuda")
        bias = torch.zeros(o, device="cuda")
        wq, s_w = Q.quantize_weight(wt)
        packed = Q.pack_weight(wq)
        s_x = Q.dynamic_scale(x).reshape(1)
        y = torch.empty((m, o), dtype=torch.bfloat16, device="cuda")
        plan = Q.plan_1x1(m, cin, o, 2)
        plans = [("plan", plan)]
        for rg, ng in ((2, 1), (1, 2), (1, 1)):
            for stages in (3, 4, 6, 8):
                smem = Q.smem_1x1(rg, ng, plan["bn"], plan["kq"], stages, 2,
                                  o)
                if smem <= Q.SMEM_LIMIT and (rg, ng, stages) != (
                        plan["rg"], plan["ng"], plan["stages"]):
                    plans.append((f"{64 * rg}x{ng}_s{stages}",
                                  dict(plan, rg=rg, ng=ng, stages=stages,
                                       smem=smem)))

        def launch(lib, p):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.ssgvc_qconv_1x1(
                x.data_ptr(), 0, packed.data_ptr(), s_w.data_ptr(),
                bias.data_ptr(), s_x.data_ptr(), y.data_ptr(), 0, m, cin, o,
                p["rg"], p["ng"], p["bn"], p["kq"], p["stages"], p["smem"],
                stream)
            if rc:
                raise RuntimeError(lib.ssgvc_error_string(rc).decode())

        bound = (m * cin * 2 + o * cin + m * o * 2) / 3.35e12 * 1e3
        res = dict(shape=list(shape), out_ch=o, bound_ms=bound,
                   plan=plan, times={})
        for name, lib in libs.items():
            res["times"][name] = cuda_ms(lambda: launch(lib, plan),
                                         args.reps)
        for name, p in plans[1:]:
            res["times"][name] = cuda_ms(lambda: launch(real, p), args.reps)
        torch.cuda.synchronize()
        rows.append(res)
        print(f"  {shape} -> {o} (plan {64 * plan['rg']}x{plan['ng']} "
              f"s{plan['stages']}, bound {bound:.4f} ms): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in res["times"].items())
              + f" [{card}]", flush=True)
    out = dict(card=card, rows=rows)
    print(json.dumps({"qconv_probe": out}))
    return out


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"qconv_probe: {time.perf_counter() - t0:.1f} s")
