"""Where the SIMT fp32 DepthConvBlock kernel's time goes
(``csrc/dcb_f32.cu``), at the RD recipe's shapes (B = 8 images of 1x1 to
8x8, C = 32 and 64), stage by stage.

Builds copies of the kernel's source with parts cut out, calls each
copy's C entry through ctypes on the same inputs and times it as
``chip_smoke.cuda_ms`` does (launches queued behind a sleep: the card's
time). The cut copies compute wrong outputs by design: only their times
mean anything. With ``--prev-port DIR`` (another checkout's
``ssgvc_tpu_torch/``, e.g. the parent's unpacked by git archive) the same is
done to that checkout's ``csrc/dcb_f32.cu``, which takes the same weights
and arguments. Last, the host's time per launch of each checkout's C entry
(100 calls, no synchronisation). Everything builds into the git-ignored
``ssgvc_tpu_torch/_build/probe/``.

Each variant names what it keeps; the difference between two rows is the
cost of the part between them.

    python experiments/simt_probe.py [--prev-port DIR]
                                     (needs a CUDA device and nvcc)
"""

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from ssgvc_tpu_torch.ops import _build  # noqa: E402
from ssgvc_tpu_torch.ops import dcb as dcb_ops  # noqa: E402
from test_torch_kernels_gpu import block_params  # noqa: E402

OUT = _build.BUILD_DIR / "probe"
SHAPES = [(8, s, s, c) for s, c in ((1, 32), (2, 32), (4, 32), (4, 64),
                                    (8, 64))] + [(1, 136, 240, 8),
                                                 (1, 68, 120, 8)]

# (name, [(text, replacement), ...]) for this checkout's kernel: the cuts,
# from the least kept to all of it
NEW = [
    ("launch only", [("  const Smem<C> sm(raw);\n",
                      "  return;\n  const Smem<C> sm(raw);\n")]),
    ("+ weights in shared memory", [("  uint32_t ph = 0;\n", (
        "  for (int g = 0; g < kGroups; ++g) hop::mbar_wait(&sm.bar[g], 0);"
        "\n  return;\n  uint32_t ph = 0;\n"))]),
    ("everything but the products' k loops",
     [("    if (on) {\n      const float* a = A",
       "    if (false) {\n      const float* a = A")]),
    ("everything but the depthwise", [
        ("  for (int i = tid; i < C * pl.p / 4; i += kThreads) {",
         "  for (int i = tid; i < 0; i += kThreads) {")]),
    ("everything but the input window", [
        ("  if (src != nullptr) {\n    constexpr int kLoads",
         "  if (false) {\n    constexpr int kLoads")]),
    ("wsilu by the accurate expf and division", [
        ("return __fdividef(v, 1.0f + __expf(-4.0f * v));",
         "return v / (1.0f + expf(-4.0f * v));")]),
    ("all of it", []),
]
# the same for the earlier design of csrc/dcb_f32.cu (one thread per
# channel, weights read from L2; e.g. the parent's): block_tile returns after
# the named stage
PREV = [
    ("launch only", [("  extern __shared__ __align__(16) float smem[];\n",
                      "  extern __shared__ __align__(16) float smem[];\n"
                      "  return;\n")]),
    ("+ the window", [("  // ---- stage A:", "  return;\n  // ---- stage A:")]),
    ("+ stage A", [("  // ---- stage B:", "  return;\n  // ---- stage B:")]),
    ("+ stage B", [("  // ---- FFN:", "  return;\n  // ---- FFN:")]),
    ("all of it", []),
]


# clock64() stamps of thread 0 of thread block 0 at the kernel's phase
# boundaries (each right after the barrier or mbarrier wait that opens a
# phase), read back through an added C entry
STAMPS = [
    ("start", "  const Smem<C> sm(raw);\n", "after"),
    ("mbarriers set, weights issued", "  uint32_t ph = 0;\n", "before"),
    ("unit tables", "      setup_unit<C>(sm, pl, u, rank);\n", "after"),
    ("input window and tables", "  // ---- stage A: h", "before"),
    ("wait W0", "  hop::mbar_wait(&s.bar[0], ph);\n", "after"),
    ("h = x W0", "  if (lead) load_group<C>(s, wn, 0);\n", "before"),
    ("wait taps", "  hop::mbar_wait(&s.bar[1], ph);\n", "after"),
    ("depthwise", "  if (lead) load_group<C>(s, wn, 1);\n", "before"),
    ("wait W3", "  hop::mbar_wait(&s.bar[2], ph);\n", "after"),
    ("u = g W3", "  if (lead) load_group<C>(s, wn, 2);\n", "before"),
    ("wait Wf0", "  hop::mbar_wait(&s.bar[3], ph);\n", "after"),
    ("f = u Wf0", "  if (lead) load_group<C>(s, wn, 3);\n", "before"),
    ("wait Wf2", "  hop::mbar_wait(&s.bar[4], ph);\n", "after"),
    ("y = f Wf2", "  if (lead) load_group<C>(s, wn, 4);\n", "before"),
]
STAMP_HEAD = """namespace dcbf {
__device__ long long probe_t[32];
#define STAMP(k) if (threadIdx.x == 0 && blockIdx.x == 0) probe_t[k] = clock64();
"""
STAMP_READ = """
extern "C" int probe_read(long long* out) {
  return cudaMemcpyFromSymbol(out, dcbf::probe_t, sizeof(long long) * 32);
}
"""


def stamp_subs():
    subs = [("namespace dcbf {\n", STAMP_HEAD)]
    for k, (_, at, where) in enumerate(STAMPS):
        mark = f"  STAMP({k});\n"
        subs.append((at, at + mark if where == "after" else mark + at))
    return subs


def build(src_dir: Path, tag: str, variants):
    """One library per variant of src_dir/dcb_f32.cu, nvcc all at once;
    returns {variant: C entry}."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = (src_dir / "dcb_f32.cu").read_text()
    procs = {}
    for k, (name, subs) in enumerate(variants):
        cut = text
        for old, new in subs:
            if old not in cut:
                raise RuntimeError(f"{tag} {name}: {old!r} not in the source")
            cut = cut.replace(old, new, 1)
        cu = OUT / f"{tag}_{k}.cu"
        if name == "stamps":
            cut += STAMP_READ
        cu.write_text(cut)
        so = cu.with_suffix(".so")
        cmd = [_build.nvcc_path(), *[f for f in _build.FLAGS if f != "-v"
                                     and f != "-Xptxas"],
               "-I", str(src_dir), "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{tag} {name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        fn = lib.ssgvc_dcb_f32_forward
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, vp]
        fn.restype = ctypes.c_int
        fn.lib = lib
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prev-port", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("simt_probe: needs a CUDA device", file=sys.stderr)
        return 1
    card, _, _ = chip_smoke.phase_device(torch)
    sets = {"new": build(_build.CSRC, "new", NEW + [("stamps",
                                                         stamp_subs())])}
    if args.prev_port:
        sets["prev"] = build(Path(args.prev_port).resolve() / "csrc", "prev",
                             PREV)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for b, h, w, c in SHAPES:
        rng = np.random.default_rng(c + h)
        x = torch.tensor(rng.standard_normal((b, h, w, c)),
                         dtype=torch.float32, device=dev)
        packed = dcb_ops.pack_f32(block_params(c, rng, dev))
        y = torch.empty_like(x)
        for tag, fns in sets.items():
            row = []
            for name, fn in fns.items():
                if name == "stamps":
                    continue
                def run(fn=fn, name=name):
                    rc = fn(x.data_ptr(), y.data_ptr(), y.data_ptr(),
                            packed.data_ptr(), None, b, h, w, c, 1, 0, stream)
                    if rc:
                        raise RuntimeError(f"{tag} {name}: CUDA error {rc}")
                row.append(f"{name} {1e3 * chip_smoke.cuda_ms(torch, run, 50):.1f}")
            print(f"{tag} kernel {b}x{h}x{w}x{c}, us a launch: "
                  + "; ".join(row) + f" [{card}]", flush=True)
            if "stamps" in fns:
                fn = fns["stamps"]
                for _ in range(3):          # warm: the last launch's stamps
                    fn(x.data_ptr(), y.data_ptr(), y.data_ptr(),
                       packed.data_ptr(), None, b, h, w, c, 1, 0, stream)
                torch.cuda.synchronize()
                t = (ctypes.c_longlong * 32)()
                fn.lib.probe_read(t)
                steps = [f"{STAMPS[k][0]} {t[k] - t[k - 1]}"
                         for k in range(1, len(STAMPS))]
                print(f"  {tag} {b}x{h}x{w}x{c}, SM cycles per phase (thread "
                      f"block 0): " + "; ".join(steps)
                      + f"; total {t[len(STAMPS) - 1] - t[0]} [{card}]",
                      flush=True)
    # the host's side of a launch: the C entry alone, nothing synchronised
    b, h, w, c = SHAPES[0]
    x = torch.zeros((b, h, w, c), device=dev)
    packed = dcb_ops.pack_f32(block_params(c, np.random.default_rng(0), dev))
    for tag, fns in sets.items():
        fn = fns["all of it"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fn(x.data_ptr(), x.data_ptr(), x.data_ptr(), packed.data_ptr(),
               None, b, h, w, c, 1, 0, stream)
        host = (time.perf_counter() - t0) / 100 * 1e6
        torch.cuda.synchronize()
        print(f"{tag} kernel: host us per C-entry call {host:.2f} (the "
              f"queue fills; includes the launch itself) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
