#!/usr/bin/env python3
"""How far do the port's z CDF tables sit from the JAX package's, and what
moves that distance?

    JAX_PLATFORMS=cpu python experiments/f4_z_tables.py

``tests/test_torch_coding.py::test_z_tables_from_the_ports_cdf`` builds the
72x16 z tables of one perturbed BitEstimator twice: from XLA's CPU CDF (the
JAX package) and from torch's (the port). The two CDFs differ by an fp32
ulp or two, and the 16-bit quantization turns some of those ulps into a
frequency step. This script rebuilds both tables the same way, each
setting in a fresh process (XLA reads its flags once), under the settings
that can change either side's CPU code: XLA's vector ISA, preferred vector
width, platform-dependent math, XNNPACK, fusion emitters and fast math,
torch's thread count and ATen's vector ISA. For each it prints the rows
that differ, the largest frequency difference, whether lengths and offsets
agree, the largest CDF difference, the ulps between the support
thresholds (1e-4, 0.9999) and the nearest CDF point, and per table row
the bins whose p 2^16 lies within the measured difference of a rounding
boundary (the most any row has, and the rows with none): how far another
CDF an ulp away could still move a row. One JSON line per setting.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SETTINGS = [
    ("default", {}),
    ("xla isa SSE4_2", {"XLA_FLAGS": "--xla_cpu_max_isa=SSE4_2"}),
    ("xla isa AVX", {"XLA_FLAGS": "--xla_cpu_max_isa=AVX"}),
    ("xla isa AVX2", {"XLA_FLAGS": "--xla_cpu_max_isa=AVX2"}),
    ("xla isa AVX512", {"XLA_FLAGS": "--xla_cpu_max_isa=AVX512"}),
    ("xla vector width 128",
     {"XLA_FLAGS": "--xla_cpu_prefer_vector_width=128"}),
    ("xla vector width 512",
     {"XLA_FLAGS": "--xla_cpu_prefer_vector_width=512"}),
    ("xla platform-dependent math off",
     {"XLA_FLAGS": "--xla_cpu_enable_platform_dependent_math=false"}),
    ("xla platform-dependent math on",
     {"XLA_FLAGS": "--xla_cpu_enable_platform_dependent_math=true"}),
    ("xla xnnpack on", {"XLA_FLAGS": "--xla_cpu_use_xnnpack=true"}),
    ("xla fusion emitters off",
     {"XLA_FLAGS": "--xla_cpu_use_fusion_emitters=false"}),
    ("xla fast math", {"XLA_FLAGS": "--xla_cpu_enable_fast_math=true"}),
    ("torch 1 thread", {"F4_TORCH_THREADS": "1"}),
    ("aten isa avx2", {"ATEN_CPU_CAPABILITY": "avx2"}),
    ("aten isa default", {"ATEN_CPU_CAPABILITY": "default"}),
]


def measure() -> dict:
    """Both packages' z tables on the test's BitEstimator, compared."""
    sys.path.insert(0, str(ROOT))
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from ssgvc_tpu.coding import cdf as jcdf
    from ssgvc_tpu.models.entropy import BitEstimator as JaxBitEstimator
    from ssgvc_tpu_torch.coding import cdf as tcdf
    from ssgvc_tpu_torch.models.entropy import BitEstimator
    from ssgvc_tpu_torch.utils.weights import load_flax_params

    if os.environ.get("F4_TORCH_THREADS"):
        torch.set_num_threads(int(os.environ["F4_TORCH_THREADS"]))
    qp, ch = 72, 16
    jbe = JaxBitEstimator(qp, ch)
    params = jbe.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 1, ch)),
                      jnp.int32(0))["params"]
    rng = np.random.default_rng(16)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.5 * rng.standard_normal(a.shape).astype(
            np.float32), params)
    port = load_flax_params(BitEstimator(qp, ch, device="cpu"), params)
    ref = jcdf.build_z_cdf_tables(params, qp, ch)
    out = tcdf.build_z_cdf_tables(port)

    # both CDFs where build_z_cdf_tables evaluates them, as it does
    ints = np.arange(-16, 17)

    def jax_at(g):
        x = jnp.broadcast_to(jnp.asarray(g, jnp.float32)[None, None, :, None],
                             (qp, 1, len(g), ch))
        return np.asarray(jbe.apply({"params": params}, x,
                                    jnp.arange(qp, dtype=jnp.int32),
                                    method=jbe.get_cdf))[:, 0]

    def port_at(g):
        x = torch.from_numpy(np.asarray(g, np.float32))[None, None, :, None]
        with torch.no_grad():
            return port.get_cdf(x.expand(qp, 1, len(g), ch),
                                torch.arange(qp)).numpy()[:, 0]

    def scaled(lo, hi):
        """Each row's pmf and tail as quantized, times 2^16 / total."""
        pmf = np.clip(hi - lo, 0.0, 1.0)
        rows = []
        for r in range(qp * ch):
            q, c = divmod(r, ch)
            a, n = 16 + int(ref.offsets[r]), int(ref.lengths[r]) - 2
            seg = pmf[q, a:a + n, c]
            full = np.concatenate([seg, [max(1.0 - seg.sum(), 0.0)]]).astype(
                np.float32).astype(np.float64)
            rows.append(full / full.sum() * 65536)
        return rows

    cj = [jax_at(ints - 0.5), jax_at(ints + 0.5), jax_at(ints)]
    ct = [port_at(ints - 0.5), port_at(ints + 0.5), port_at(ints)]
    cdf_diff = max(float(np.abs(a - b).max()) for a, b in zip(cj, ct))
    margin = {str(t): float(np.abs(cj[2].astype(np.float64) - float(t)).min()
                            / np.spacing(np.float32(t)))
              for t in (np.float32(1e-4), np.float32(0.9999))}
    sj, st = scaled(*cj[:2]), scaled(*ct[:2])
    delta = max(float(np.abs(a - b).max()) for a, b in zip(sj, st))
    near = np.array([int((np.abs(s - np.floor(s) - 0.5) <= delta).sum())
                     for s in sj])
    same_len = bool(np.array_equal(out.lengths, ref.lengths))
    same_off = bool(np.array_equal(out.offsets, ref.offsets))
    freq = np.abs(np.diff(out.cdfs.astype(np.int64), axis=1)
                  - np.diff(ref.cdfs.astype(np.int64), axis=1))
    return {"rows": int((out.cdfs != ref.cdfs).any(axis=1).sum()),
            "of": int(out.cdfs.shape[0]), "max_freq_diff": int(freq.max()),
            "lengths_equal": same_len, "offsets_equal": same_off,
            "max_cdf_diff": cdf_diff,
            "threshold_margin_ulps": margin,
            "scaled_pmf_diff_max": delta,
            "row_bins_near_a_boundary_max": int(near.max()),
            "rows_with_none_near": int((near == 0).sum()),
            "rows_with_3_or_more_near": int((near >= 3).sum()),
            "torch_threads": torch.get_num_threads(),
            "xla_flags": os.environ.get("XLA_FLAGS", "")}


def main() -> int:
    if os.environ.get("F4_CHILD"):
        print(json.dumps(measure()))
        return 0
    for name, env in SETTINGS:
        full = {**os.environ, "JAX_PLATFORMS": "cpu", "F4_CHILD": "1", **env}
        proc = subprocess.run([sys.executable, __file__], env=full,
                              capture_output=True, text=True, timeout=600)
        line = proc.stdout.strip().splitlines()[-1] if proc.stdout else ""
        if proc.returncode:
            print(json.dumps({"setting": name, "error":
                              proc.stderr.strip().splitlines()[-1:]}))
            continue
        print(json.dumps({"setting": name, **json.loads(line)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
