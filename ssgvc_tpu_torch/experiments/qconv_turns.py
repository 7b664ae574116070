"""The int8 conv (``ops/qconv.py`` -> ``csrc/qconv.cu``) alone on the card,
at every int8 site shape of the full-width codecs and at stress shapes:
each launch against its plain version bit for bit (bf16 and fp32 in and
out, mode 1's and mode 2's scales), then timed beside its bound, and with
``--prev-port DIR`` in turns with another checkout's kernel (prev, new,
new, prev), summed per int8 P-frame and I-frame.

    python3 -m ssgvc_tpu_torch.experiments.qconv_turns [--prev-port DIR]
        [--reps 40] [--rounds 4] [--seed 0] [--check-only] [--out PATH]

With ``--prev-port`` the host's time a call is measured too, in turns,
at ``HOST_SITES``. The sites and their launches per
int8 P-frame and DMCI I-frame are those ``chip_smoke.py`` phase 24 (a)
records from the full-width forwards (the performance P-frame, the
DMCI I-frame, and the fast and mask_prop P-frames' sites whose Cin is not
a multiple of 16). Prints a line per shape and one JSON object last;
``--out PATH`` writes the rows there as JSON too.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .profile_stages import card_line

#: (x shape, O, kernel, stride, pads, launches per P-frame, per I-frame)
SITES = [
    ((1, 17, 30, 128), 128, 1, 1, (0, 0, 0, 0), 2, 2),
    ((1, 17, 30, 128), 512, 1, 1, (0, 0, 0, 0), 2, 2),
    ((1, 17, 30, 256), 128, 1, 1, (0, 0, 0, 0), 1, 1),
    ((1, 34, 60, 128), 128, 1, 1, (0, 0, 0, 0), 4, 4),
    ((1, 34, 60, 128), 128, 2, 2, (0, 0, 0, 0), 1, 1),
    ((1, 34, 60, 128), 512, 1, 1, (0, 0, 0, 0), 3, 3),
    ((1, 34, 60, 256), 128, 1, 1, (0, 0, 0, 0), 2, 2),
    ((1, 68, 120, 1), 16, 3, 1, (1, 1, 1, 1), 0, 0),
    ((1, 68, 120, 128), 128, 1, 1, (0, 0, 0, 0), 6, 4),
    ((1, 68, 120, 128), 128, 2, 2, (0, 0, 0, 0), 1, 1),
    ((1, 68, 120, 128), 256, 1, 1, (0, 0, 0, 0), 0, 1),
    ((1, 68, 120, 128), 512, 1, 1, (0, 0, 0, 0), 3, 2),
    ((1, 68, 120, 128), 1024, 3, 1, (1, 1, 1, 1), 1, 0),
    ((1, 68, 120, 256), 128, 1, 1, (0, 0, 0, 0), 3, 3),
    ((1, 68, 120, 256), 256, 1, 1, (0, 0, 0, 0), 2, 2),
    ((1, 68, 120, 256), 512, 1, 1, (0, 0, 0, 0), 0, 1),
    ((1, 68, 120, 256), 1024, 1, 1, (0, 0, 0, 0), 1, 1),
    ((1, 68, 120, 256), 1472, 1, 1, (0, 0, 0, 0), 0, 1),
    ((1, 68, 120, 384), 256, 1, 1, (0, 0, 0, 0), 1, 0),
    ((1, 68, 120, 384), 384, 1, 1, (0, 0, 0, 0), 11, 0),
    ((1, 68, 120, 384), 1536, 1, 1, (0, 0, 0, 0), 5, 0),
    ((1, 68, 120, 512), 256, 1, 1, (0, 0, 0, 0), 1, 1),
    ((1, 68, 120, 512), 512, 1, 1, (0, 0, 0, 0), 0, 33),
    ((1, 68, 120, 512), 514, 1, 1, (0, 0, 0, 0), 0, 1),
    ((1, 68, 120, 512), 2048, 1, 1, (0, 0, 0, 0), 0, 15),
    ((1, 68, 120, 514), 256, 1, 1, (0, 0, 0, 0), 0, 1),
    ((1, 68, 120, 768), 384, 1, 1, (0, 0, 0, 0), 5, 0),
    ((1, 68, 120, 1024), 512, 1, 1, (0, 0, 0, 0), 0, 15),
    ((1, 136, 240, 1), 256, 3, 1, (1, 1, 1, 1), 0, 0),
    ((1, 136, 240, 64), 256, 1, 1, (0, 0, 0, 0), 1, 0),
    ((1, 136, 240, 192), 192, 1, 1, (0, 0, 0, 0), 0, 2),
    ((1, 136, 240, 192), 256, 1, 1, (0, 0, 0, 0), 1, 0),
    ((1, 136, 240, 192), 768, 1, 1, (0, 0, 0, 0), 0, 1),
    ((1, 136, 240, 256), 128, 3, 2, (1, 1, 1, 1), 1, 0),
    ((1, 136, 240, 256), 256, 1, 1, (0, 0, 0, 0), 32, 0),
    ((1, 136, 240, 256), 256, 2, 2, (0, 0, 0, 0), 1, 0),
    ((1, 136, 240, 256), 256, 3, 2, (1, 1, 1, 1), 1, 0),
    ((1, 136, 240, 256), 320, 1, 1, (0, 0, 0, 0), 1, 0),
    ((1, 136, 240, 256), 1024, 1, 1, (0, 0, 0, 0), 15, 0),
    ((1, 136, 240, 320), 192, 1, 1, (0, 0, 0, 0), 1, 0),
    ((1, 136, 240, 320), 320, 1, 1, (0, 0, 0, 0), 8, 0),
    ((1, 136, 240, 320), 1280, 1, 1, (0, 0, 0, 0), 4, 0),
    ((1, 136, 240, 368), 192, 1, 1, (0, 0, 0, 0), 0, 1),
    ((1, 136, 240, 368), 256, 3, 2, (1, 1, 1, 1), 0, 1),
    ((1, 136, 240, 368), 368, 1, 1, (0, 0, 0, 0), 0, 40),
    ((1, 136, 240, 368), 1472, 1, 1, (0, 0, 0, 0), 0, 20),
    ((1, 136, 240, 384), 192, 1, 1, (0, 0, 0, 0), 0, 1),
    ((1, 136, 240, 512), 256, 1, 1, (0, 0, 0, 0), 15, 0),
    ((1, 136, 240, 640), 320, 1, 1, (0, 0, 0, 0), 4, 0),
    ((1, 136, 240, 736), 368, 1, 1, (0, 0, 0, 0), 0, 20),
]

#: the 1x1 route's edges, checked bit for bit and not timed: M not a
#: multiple of the row tile (64 or 128 rows), O under 32 / 64, not a
#: multiple of the N tile, O = 1024, O whose rows are not 16-byte multiples
#: (element stores), Cin 16 / 1024 / 2048, and Cin 4096 (over the shared
#: memory: the gemm route)
STRESS = [
    ((2, 7, 9, 16), 8, 1, 1, (0, 0, 0, 0)),
    ((1, 5, 13, 1024), 1024, 1, 1, (0, 0, 0, 0)),
    ((3, 11, 17, 48), 40, 1, 1, (0, 0, 0, 0)),
    ((1, 136, 241, 96), 200, 1, 1, (0, 0, 0, 0)),
    ((1, 9, 9, 32), 1, 1, 1, (0, 0, 0, 0)),
    ((1, 20, 20, 64), 514, 1, 1, (0, 0, 0, 0)),
    ((1, 130, 132, 2048), 96, 1, 1, (0, 0, 0, 0)),
    ((1, 16, 16, 4096), 64, 1, 1, (0, 0, 0, 0)),
]

#: sites whose host time a call is also measured (--prev-port): the
#: P-frame's most launched 1x1 and its 3x3
HOST_SITES = [SITES[34], SITES[19], SITES[12]]

H100_INT8_OPS = 1979e12
H100_BYTES_PER_S = 3.35e12


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn over reps launches by CUDA events, queued
    behind a ``torch.cuda._sleep`` that outlasts their enqueueing, so the
    card, not the host's launch rate, sets the time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / warmup * reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * host_s, 0.5) * 1.98e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(key, size: int):
    """(ms, bound_by): int8 products at the int8 peak, or x read once, the
    weights read once and y written once at the HBM rate, the larger (as
    chip_smoke.py's p24_bound)."""
    (b, h, w, cin), o, k, s, (pt, pb, pl, pr) = key
    ho = (h + pt + pb - k) // s + 1
    wo = (w + pl + pr - k) // s + 1
    m = b * ho * wo
    ops = 2 * m * k * k * cin * o / H100_INT8_OPS
    nbytes = (b * h * w * cin * size + o * k * k * cin + m * o * size
              + 8 * o) / H100_BYTES_PER_S
    return 1e3 * max(ops, nbytes), ("operations" if ops >= nbytes
                                    else "bytes")


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of fn, over ``calls`` calls queued without
    a synchronisation (fewer than the launch queue holds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def host_turns(new, old, rounds: int):
    """(median host us a call of new, of old) over rounds of old, new, new,
    old."""
    t_new, t_old = [], []
    for _ in range(rounds):
        t_old.append(host_us(old))
        t_new += [host_us(new), host_us(new)]
        t_old.append(host_us(old))
    return float(np.median(t_new)), float(np.median(t_old))


def plan_tag(plan) -> str:
    """rows, N groups and ring slots of a 1x1 plan, as "128x1 s5"."""
    if not plan:
        return ""
    return f"{plan['bm']}x{plan['ng']} s{plan['stages']}"


def load_prev(path):
    """Another checkout's port package as ``prev_port``; its ops.qconv."""
    root = Path(path).resolve()
    spec = importlib.util.spec_from_file_location(
        "prev_port", root / "__init__.py",
        submodule_search_locations=[str(root)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["prev_port"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("prev_port.ops.qconv")


def operands(rng, key, dev):
    shape, o, k = key[0], key[1], key[2]
    x32 = torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                       device=dev)
    wt = torch.tensor(rng.standard_normal((o, shape[-1], k, k))
                      * (k * k * shape[-1]) ** -0.5, dtype=torch.float32,
                      device=dev)
    bias = torch.tensor(rng.standard_normal(o) * 0.1, dtype=torch.float32,
                        device=dev)
    return x32, wt, bias


def check(Q, key, x32, wq, s_w, bias, packed) -> str:
    """Every dtype pair and both scale modes against qconv_plain, bit for
    bit; returns the route taken."""
    shape, o, k, s, pads = key[:5]
    dev = x32.device
    for xdt in (torch.bfloat16, torch.float32):
        x = x32.to(xdt)
        absmax = 1.25 * float(x.float().abs().max())
        for mode, s_x in (("1", Q.dynamic_scale(x)),
                          ("2", torch.tensor(Q.static_scale(absmax),
                                             device=dev))):
            for odt in (torch.bfloat16, torch.float32):
                before = (Q.launches_1x1, Q.launches_gemm)
                out = Q.qconv_cuda(x, wq, s_w, bias, s_x, k, s, pads, odt,
                                   packed)
                ref = Q.qconv_plain(x, wq, s_w, bias, s_x, k, s, pads, odt)
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    d = float((out.float() - ref.float()).abs().max())
                    raise RuntimeError(f"qconv {key} {xdt} -> {odt} mode "
                                       f"{mode}: kernel != plain (max |d| "
                                       f"{d})")
    return "1x1" if Q.launches_1x1 > before[0] else "gemm"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prev-port", default=None)
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("qconv_turns: no CUDA device")
    from ..ops import _build
    from ..ops import qconv as Q

    card = card_line("cuda")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    logs = _build.build(["qconv"])
    for line in logs["qconv"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    lib = Q._lib()
    for case in ((2, 1, 128, 256, 5, 2, 1024), (1, 2, 128, 384, 8, 4, 200),
                 (1, 1, 32, 64, 8, 4, 9)):
        want = Q.smem_1x1(*case)
        got = lib.ssgvc_qconv_smem_1x1(*case[:5], int(case[5] == 4),
                                       case[6])
        if got != want:
            raise RuntimeError(f"smem_1x1 {case}: the .cu's {got} != "
                               f"ops.qconv's {want}")
    prev = load_prev(args.prev_port) if args.prev_port else None
    rng = np.random.default_rng(args.seed + 24)
    for key in STRESS:
        x32, wt, bias = operands(rng, key, dev)
        wq, s_w = Q.quantize_weight(wt)
        route = check(Q, key, x32, wq, s_w, bias, None)
        print(f"  stress {key}: {route} route, bit for bit [{card}]",
              flush=True)
    rows = []
    for key in SITES:
        x32, wt, bias = operands(rng, key, dev)
        wq, s_w = Q.quantize_weight(wt)
        packed = Q.pack_weight(wq) if key[2] == 1 else None
        route = check(Q, key, x32, wq, s_w, bias, packed)
        shape, o, k, s, pads, per_p, per_i = key
        row = dict(shape=list(shape), out_ch=o, kernel=k, stride=s,
                   pads=list(pads), per_p=per_p, per_i=per_i, route=route)
        if route == "1x1":
            row["plan"] = Q.route_of(shape, o, k, s, pads, True, 2)[1]
        row["bound_ms"], row["bound_by"] = bound(key[:5], 2)
        if not args.check_only:
            x = x32.to(torch.bfloat16)
            s_x = Q.dynamic_scale(x)
            new = lambda: Q.qconv_cuda(x, wq, s_w, bias, s_x, k, s, pads,
                                       torch.bfloat16, packed)
            if prev is not None:
                old = lambda: prev.qconv_cuda(x, wq, s_w, bias, s_x, k, s,
                                              pads, torch.bfloat16)
                if not torch.equal(old(), new()):
                    raise RuntimeError(f"qconv {key}: prev != new")
                t_new, t_old = [], []
                for _ in range(args.rounds):
                    t_old.append(cuda_ms(old, args.reps))
                    t_new.append(cuda_ms(new, args.reps))
                    t_new.append(cuda_ms(new, args.reps))
                    t_old.append(cuda_ms(old, args.reps))
                row["kernel_ms"] = float(np.median(t_new))
                row["prev_ms"] = float(np.median(t_old))
            else:
                row["kernel_ms"] = cuda_ms(new, args.reps)
            if prev is not None and key in HOST_SITES:
                row["host_us"], row["prev_host_us"] = host_turns(
                    new, old, args.rounds)
            row["share"] = row["bound_ms"] / row["kernel_ms"]
        rows.append(row)
        times = " ".join(f"{f} {row[f]:.4f}" for f in
                         ("kernel_ms", "prev_ms", "host_us",
                          "prev_host_us") if f in row)
        print(f"  qconv {'x'.join(map(str, shape))} -> {o} k{k} s{s} pads "
              f"{pads} P {per_p} I {per_i}: {route} "
              f"{plan_tag(row.get('plan'))} {times} bound "
              f"{row['bound_ms']:.4f} ({row['bound_by']}) [{card}]",
              flush=True)
    out = dict(card=card, sites=len(rows), stress=len(STRESS),
               rounds=args.rounds if prev is not None else 0)
    for frame, per in (("pframe", "per_p"), ("iframe", "per_i")):
        sub = {f: sum(r[f] * r[per] for r in rows if f in r)
               for f in ("kernel_ms", "prev_ms", "bound_ms")
               if any(f in r for r in rows)}
        sub["launches"] = sum(r[per] for r in rows)
        sub["launches_1x1"] = sum(r[per] for r in rows if r["route"] == "1x1")
        out[frame] = sub
    print(json.dumps({"qconv_turns": out}))
    if args.out:
        Path(args.out).write_text(json.dumps(dict(summary=out, rows=rows),
                                             indent=1))
    return out


if __name__ == "__main__":
    main()
