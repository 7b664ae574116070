"""Host rANS coder microbenchmark -> artifacts/torch/bench_rans.json.

Measures raw symbol throughput of the port's C++ coder (``csrc/rans.cpp``
through ``coding/rans.py``) on the y scale-table alphabet: 2M symbols drawn
uniformly per CDF row, encoded, then decoded, the best of 3 on both sides.
Decode throughput bounds the coded path's host side at 1080p (hundreds of
thousands of latent symbols a frame), so this number bears directly on
``bench_coded``'s decode fps. No device work: the coder runs on the host.

The draws are the JAX script's (``default_rng(0)``), so both coders see the
same symbols and write the same stream.

    python3 -m ssgvc_tpu_torch.experiments.bench_rans [n_million_symbols]
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Tuple

import numpy as np

from . import ARTIFACTS, write_json


def draw_symbols(lengths: np.ndarray, offsets: np.ndarray, n: int,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(CDF row indexes int32, symbol values int16): ``n`` rows drawn
    uniformly, each symbol uniform over its row's support, as the JAX
    script draws them."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, lengths.shape[0], n).astype(np.int32)
    sym = (rng.integers(0, 1 << 16, n)
           % np.maximum(lengths[idx] - 2, 1)).astype(np.int32)
    return idx, (sym + offsets[idx]).astype(np.int16)


def cpu_model() -> str:
    """The host CPU as /proc/cpuinfo names it: its "model name", with the
    vendor, family and model numbers where that name is missing or
    "unknown" (as on some virtual hosts); else ``platform``'s
    machine."""
    import platform

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = fields.get("model name", "")
    if name and name != "unknown":
        return name
    ids = [f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model")
           if k in fields]
    return ", ".join([f"model name {name or 'missing'}"] + ids) if ids \
        else f"{name or 'unnamed'} ({platform.machine()})"


def main(argv=None) -> dict:
    from ..coding.cdf import build_y_cdf_tables
    from ..coding.rans import RansDecoder, RansEncoder

    argv = sys.argv[1:] if argv is None else argv
    n = int(float(argv[0]) * 1e6) if argv else 2_000_000
    tabs = build_y_cdf_tables()
    cdfs = np.asarray(tabs.cdfs)
    lengths = np.asarray(tabs.lengths)
    offsets = np.asarray(tabs.offsets)

    enc, dec = RansEncoder(), RansDecoder()
    gid_e = enc.add_cdf(cdfs, lengths, offsets)
    gid_d = dec.add_cdf(cdfs, lengths, offsets)
    idx, vals = draw_symbols(lengths, offsets, n)

    # best of 3 on both sides, so encode and decode compare: a single cold
    # encode pays growth and page-fault costs the warm decode never sees
    enc_s = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        enc.reset()
        enc.encode_with_indexes(vals, idx, gid_e)
        enc.flush()
        enc_s = min(enc_s, time.perf_counter() - t0)
    stream = enc.get_encoded_stream()

    best = float("inf")
    for _ in range(3):
        dec.set_stream(stream)
        t0 = time.perf_counter()
        dec.decode_batch(idx, gid_d)
        out = dec.get_decoded()
        best = min(best, time.perf_counter() - t0)
    if not np.array_equal(out.astype(np.int32), vals.astype(np.int32)):
        raise RuntimeError("bench_rans: round-trip mismatch")

    row = {
        "n_symbols": n,
        "stream_mb": round(len(stream) / 1e6, 3),
        "encode_msym_s": round(n / enc_s / 1e6, 1),
        "decode_msym_s": round(n / best / 1e6, 1),
        "provenance": f"one host thread of {os.cpu_count()} (nproc), "
                      f"{cpu_model()}; the port's csrc/rans.cpp built by "
                      "ops/_build.load_host (g++ -O3, no -march)",
        "notes": "the JAX package's coder copied: bucket-indexed symbol "
                 "lookup, 64-bit state / 32-bit-word renorm, division-free "
                 "encode (reciprocal multiply); the threaded 2-stream split "
                 "(ec_part) is not used here",
    }
    write_json(f"{ARTIFACTS}/bench_rans.json", row)
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
