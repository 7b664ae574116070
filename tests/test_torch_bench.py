"""The port's bench (``ssgvc_tpu_torch/bench.py``) against the JAX
package's root ``bench.py``, on the CPU: what it computes and what it
prints, not its times.

  * ``bench.gop`` with ``scan`` ingest (performance variant) and with the
    plain variant (``batched``) equals the JAX script's ``gop`` (a
    ``lax.scan`` written as ``bench.py:189-211``) on the same weights and
    inputs, rd-tiny fp32 at 64x64: bpp at test_torch_dmc.py's rtol 5e-3,
    the last DPB frame's sum at 1e-4.
  * ``scan`` and ``batched`` ingest give equal results (``torch.equal``):
    the permutation is exact and the model sees the same values; ``each``
    sees every frame's DPB and changes nothing.
  * ``calibrate_int8``'s scales equal the JAX ``collect_int8_scales`` of a
    ``mutable=["int8_calib"]`` apply on the same numpy draws, site for
    site, at rtol 1e-4, on four weight and input draws in packed and raw
    io. The calibration apply quantizes with the dynamic scale, so a 1e-7
    difference upstream can flip one int8 rounding at a tie, and a flip
    moves the later sites' maxima by up to 0.5% (2 of those 4 draws flip
    one when the port runs free). So each port site is handed the JAX
    site's input (taken by ``nn.intercept_methods``), and the abs-max of
    what the port itself computed there, from the earlier sites' JAX
    inputs, is held to the JAX scale at the same rtol: the bound holds
    the arithmetic on every draw, and a rounding at a tie moves nothing.
  * ``measure``'s dict has the keys of the JSON line in ``bench.py``
    (read from its source) with ``mfu_pct_h100`` for ``mfu_pct_v5e``, plus
    ``device``; its GOP holds ``max(48 // b, 8)`` frames.
  * ``python3 -m ssgvc_tpu_torch.bench`` on a host without a card prints
    one JSON error line and exits non-zero; under a 1 s deadline the line
    names the worker's last breadcrumb; a held lock refuses the run.
"""

import ast
import functools
import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import DMC_HEADS
from ssgvc_tpu.config import DMCConfig as JaxDMCConfig
from ssgvc_tpu.layers import blocks as jb
from ssgvc_tpu.models.dmc import DMC as JaxDMC
from ssgvc_tpu.ops.pixel import pixel_unshuffle as jax_unshuffle
from ssgvc_tpu_torch import bench
from ssgvc_tpu_torch.config import DMCConfig
from ssgvc_tpu_torch.experiments import bench_sweep, profile_stages
from ssgvc_tpu_torch.layers import blocks as pb
from ssgvc_tpu_torch.models.dmc import DMC
from torch_port_helpers import (RD_TINY, drawn_params,  # noqa: F401
                                one_torch_thread)

ROOT = Path(__file__).resolve().parents[1]
QP = 32
HW = 64
BPP_RTOL = 5e-3


def _draws(seed, n, b, hw=HW):
    rng = np.random.default_rng(seed)
    frames = rng.uniform(size=(n, b, hw, hw, 3)).astype(np.float32)
    masks = (rng.uniform(size=(n, b, hw, hw, 1)) > 0.8).astype(np.float32)
    prev = rng.uniform(size=(b, hw, hw, 3)).astype(np.float32)
    feat = (rng.standard_normal((b, hw // 8, hw // 8, RD_TINY["ch_d"]))
            * 0.1).astype(np.float32)
    return frames, masks, prev, feat


def _port_model(variant, seed):
    cfg = DMCConfig.variant(variant, packed_io=True, **RD_TINY)
    model = DMC(cfg, device="cpu").eval()
    return model, drawn_params(model, seed, DMC_HEADS)


def _port_gop(model, draws, ingest, qp=QP):
    t = torch.from_numpy
    frames, masks, prev, feat = draws
    return bench.gop(model, t(frames), t(masks), qp,
                     {"frame": t(prev), "feature": t(feat)}, ingest)


@pytest.mark.parametrize("variant,ingest", [("performance", "scan"),
                                            ("plain", "batched")])
def test_gop_matches_the_jax_scan(variant, ingest):
    """The JAX script's ``gop`` at B = 2 with its ``SSGVC_INGEST`` branch
    as the case's ingest, and ``bench.gop`` on the same weights."""
    b, n = 2, 2
    ingest_scan = ingest == "scan"
    jm = JaxDMC(JaxDMCConfig.variant(variant, packed_io=True, **RD_TINY))
    model, params = _port_model(variant, 11)
    draws = _draws(12, n, b)

    @jax.jit
    def gop(params, frames, masks, qp, dpb):
        dpb = dict(dpb, frame=jax_unshuffle(dpb["frame"], 8))
        if not ingest_scan:
            fb = frames.reshape((n * b,) + frames.shape[2:])
            mb = masks.reshape((n * b,) + masks.shape[2:])
            frames = jax_unshuffle(fb, 8).reshape((n, b, HW // 8, HW // 8,
                                                   -1))
            masks = jax_unshuffle(mb, 8).reshape((n, b, HW // 8, HW // 8,
                                                  -1))

        def step(dpb, xs):
            frame, mask = xs
            if ingest_scan:
                frame = jax_unshuffle(frame, 8)
                mask = jax_unshuffle(mask, 8)
            out = jm.apply({"params": params}, frame, qp, dpb,
                           after_i=False, mask=mask, train=False)
            return out["dpb"], out["bpp"]

        dpb, bpps = jax.lax.scan(step, dpb, (frames, masks))
        return bpps.sum(), dpb["frame"].sum()

    frames, masks, prev, feat = draws
    want = gop(params, jnp.asarray(frames), jnp.asarray(masks),
               jnp.int32(QP), {"frame": jnp.asarray(prev),
                               "feature": jnp.asarray(feat)})
    got = _port_gop(model, draws, ingest)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=BPP_RTOL)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-4)


def test_scan_and_batched_ingest_are_equal():
    model, _ = _port_model("performance", 13)
    draws = _draws(14, 3, 2)
    scan = _port_gop(model, draws, "scan")
    batched = _port_gop(model, draws, "batched")
    assert all(torch.equal(a, b) for a, b in zip(scan, batched))
    assert all(torch.isfinite(a) for a in scan)
    with pytest.raises(ValueError, match="ingest"):
        _port_gop(model, draws, "stream")


def test_gop_hands_each_frame_on():
    """``gop``'s ``each`` (what ``trace_bench --growth`` times and
    profiles frames by) sees every frame's DPB in order and changes
    nothing; ``--growth`` wants the card."""
    from ssgvc_tpu_torch.experiments import trace_bench

    model, _ = _port_model("performance", 13)
    frames, masks, prev, feat = (torch.from_numpy(a)
                                 for a in _draws(14, 3, 2))
    seen = []
    got = bench.gop(model, frames, masks, QP, {"frame": prev,
                                               "feature": feat},
                    each=lambda t, dpb: seen.append((t, dpb)))
    want = bench.gop(model, frames, masks, QP, {"frame": prev,
                                                "feature": feat})
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [t for t, _ in seen] == [0, 1, 2]
    assert torch.equal(seen[-1][1]["frame"].float().sum(), got[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        trace_bench.main(["--growth", "--device=cpu"])


@pytest.fixture
def int8_state():
    """Both packages' int8 tables empty for the test, given back after."""
    saved = (dict(jb._INT8_SCALES), set(jb._INT8_BAKED), set(jb._INT8_WARNED),
             dict(pb._INT8_SCALES), set(pb._INT8_WARNED))
    for table in (jb._INT8_SCALES, jb._INT8_BAKED, jb._INT8_WARNED,
                  pb._INT8_SCALES, pb._INT8_WARNED):
        table.clear()
    yield
    for table, old in zip((jb._INT8_SCALES, jb._INT8_BAKED, jb._INT8_WARNED,
                           pb._INT8_SCALES, pb._INT8_WARNED), saved):
        table.clear()
        table.update(old)


@functools.lru_cache(maxsize=None)
def _jax_calibration(packed):
    """(jitted calibration apply, its int8 sites in call order) of the JAX
    performance model with ``packed_io=packed``: the ``int8_calib``
    collection and every QuantConv's input, taken by
    ``nn.intercept_methods`` while tracing. One trace serves every draw:
    the weights and inputs are arguments."""
    import flax.linen as nn

    jm = JaxDMC(JaxDMCConfig.variant("performance", packed_io=packed,
                                     **RD_TINY))
    sites = []
    r = 8 if packed else 1

    def ingest(x):
        return jax_unshuffle(x, r) if packed else x

    @jax.jit
    def calibrate(params, frame, mask, prev, feat):
        seen = []

        def grab(next_fun, args, kwargs, context):
            if (isinstance(context.module, jb.QuantConv)
                    and context.method_name == "__call__"):
                seen.append(("/".join(context.module.scope.path), args[0]))
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(grab):
            cal = jm.apply({"params": params}, ingest(frame), jnp.int32(QP),
                           {"frame": ingest(prev), "feature": feat},
                           after_i=False, mask=ingest(mask), train=False,
                           mutable=["int8_calib"])[1]
        sites[:] = [s for s, _ in seen]
        return cal, [x for _, x in seen]

    return calibrate, sites


@pytest.mark.parametrize("seed,packed", [(15, True), (16, True),
                                         (17, False), (18, False)])
def test_int8_calibration_matches_the_jax_scales(monkeypatch, int8_state,
                                                 seed, packed):
    """``SSGVC_INT8=2``'s calibration apply (``bench.py:166-187``) on one
    64x64 frame: the JAX scales by ``collect_int8_scales`` of a
    ``mutable=["int8_calib"]`` apply, the port's by ``calibrate_int8`` on
    the same draws and weights. Each port site is handed the JAX site's
    input (an int8 rounding at a tie cannot carry a 1e-7 difference on to
    later sites); what the port computed for that input from the earlier
    sites' JAX inputs is held to the JAX input's abs-max too."""
    import warnings

    cfg = DMCConfig.variant("performance", packed_io=packed, **RD_TINY)
    model = DMC(cfg, device="cpu").eval()
    params = drawn_params(model, seed, DMC_HEADS)
    frames, masks, prev, feat = _draws(seed + 1, 1, 1)
    frame, mask = frames[0], masks[0]
    monkeypatch.setenv("SSGVC_INT8", "2")
    calibrate, sites = _jax_calibration(packed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cal, inputs = calibrate(params,
                                *map(jnp.asarray, (frame, mask, prev, feat)))
    want = jb.collect_int8_scales(cal["int8_calib"])
    given = {}
    for site, x in zip(sites, inputs):
        given.setdefault(site, []).append(torch.from_numpy(np.array(x)))
    own = {}
    int8_forward = pb.Conv.int8_forward

    def handed(self, x):
        jax_x = given[self.site].pop(0)
        assert jax_x.shape == x.shape, self.site
        absmax = float(x.abs().max()) * bench.INT8_MARGIN
        own[self.site] = max(own.get(self.site, 0.0), absmax)
        return int8_forward(self, jax_x.to(x.dtype))

    t = torch.from_numpy
    with mock.patch.object(pb.Conv, "int8_forward", handed):
        got = bench.calibrate_int8(model, t(frame), t(mask),
                                   {"frame": t(prev), "feature": t(feat)})
    assert set(got) == set(want) == set(own) and len(want) > 100
    assert not any(given.values())     # every JAX call had its port call
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(own[k], want[k], rtol=1e-4, err_msg=k)
    assert pb._INT8_SCALES == got
    monkeypatch.setenv("SSGVC_INT8", "0")
    with pytest.raises(ValueError, match="SSGVC_INT8=2"):
        bench.calibrate_int8(model, t(frame), t(mask),
                             {"frame": t(prev), "feature": t(feat)})


def jax_bench_keys() -> set:
    """The keys of the dict literal the JAX ``bench.py``'s worker passes
    to ``json.dumps``: its JSON line."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "worker")
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
                == "dumps" and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no json.dumps of a dict in bench.py's worker")


@pytest.mark.parametrize("batch", [1, 8])
def test_measure_line_keys_and_frames(batch):
    """``measure`` at rd-tiny fp32 64x64 on the CPU: the JAX line's keys
    with the card's share for the TPU's and the card line; a GOP of
    ``max(48 // b, 8)`` frames; fps, ms a frame and TFLOP/s from one
    timed GOP and the P-frame's product count."""
    cfg = DMCConfig.variant("performance", packed_io=True, **RD_TINY)
    details = {}
    line = bench.measure("performance", batch, cfg=cfg, h=HW, w=HW, reps=1,
                         device="cpu", details=details)
    keys = jax_bench_keys()
    assert "mfu_pct_v5e" in keys
    assert set(line) == (keys - {"mfu_pct_v5e"}) | {"mfu_pct_h100", "device"}
    assert details["n_frames"] == bench.default_frames(batch) \
        == max(48 // batch, 8)
    assert [bench.default_frames(b) for b in (1, 2, 4, 6, 7, 16)] == \
        [48, 24, 12, 8, 8, 8]
    t = details["times_s"][0]
    n = details["n_frames"]
    assert line["value"] == n * batch / t > 0
    assert line["ms_per_frame"] == pytest.approx(1e3 / line["value"])
    assert line["vs_baseline"] == pytest.approx(line["value"] / 30.0)
    flops = bench_sweep.pframe_flops(cfg, batch, HW, HW)
    assert flops == profile_stages.count_flops(cfg, batch, HW, HW)["full"]
    assert line["model_tflops"] == pytest.approx(flops * n / t / 1e12)
    assert line["mfu_pct_h100"] is None          # a CPU's rate
    assert line["device"] == "cpu (no card)"
    assert line["metric"].startswith("64x64 P-frame")
    assert all(np.isfinite(s).all() for s in details["sums"])


def test_measure_int8_calibrates_then_runs_on_qconv(monkeypatch,
                                                    int8_state):
    """``SSGVC_INT8=2`` as the worker sees it (in the environment): the
    product count still runs (on the meta device, as bf16), the scales are
    calibrated before the warm-up, every site has one, and the
    environment is given back."""
    import warnings

    monkeypatch.setenv("SSGVC_INT8", "2")
    cfg = DMCConfig.variant("performance", packed_io=True, **RD_TINY)
    details, crumbs = {}, []
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # no site without its scale
        line = bench.measure("performance", 1, "batched", True, cfg=cfg,
                             h=HW, w=HW, n_frames=2, reps=1, device="cpu",
                             status=crumbs.append, details=details)
    assert line["metric"].endswith("int8-w8a8)")
    assert len(pb._INT8_SCALES) > 100
    assert crumbs[:2] == ["data: generating frames",
                          "calib: int8 static-scale calibration"]
    assert crumbs[2].startswith("warmup: ") and crumbs[3] == \
        "measure: rep 1/1"
    assert os.environ["SSGVC_INT8"] == "2"
    with bench.int8_mode(False):
        flops = bench_sweep.pframe_flops(cfg, 1, HW, HW)
    assert line["model_tflops"] == pytest.approx(
        flops * 2 / details["times_s"][0] / 1e12)


def test_measure_defaults_to_the_card():
    """Without ``device`` the bench builds its model on the card: a host
    without one raises there and measures nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench would measure on it")
    cfg = DMCConfig.variant("performance", packed_io=True, **RD_TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.measure(cfg=cfg, h=HW, w=HW, n_frames=1, reps=1)


def _run_bench(tmp_path, **env):
    """``python3 -m ssgvc_tpu_torch.bench`` from the repo root with its
    lock and status files under ``tmp_path``: (returncode, JSON lines,
    stdout)."""
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("SSGVC_")}
    full.update(TMPDIR=str(tmp_path), **env)
    proc = subprocess.run([sys.executable, "-m", "ssgvc_tpu_torch.bench"],
                          cwd=ROOT, env=full, capture_output=True, text=True,
                          timeout=300)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return proc.returncode, [json.loads(ln) for ln in lines], proc.stdout


def test_bench_without_a_card_prints_one_error_line(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench would measure on it")
    rc, lines, out = _run_bench(tmp_path)
    assert rc != 0
    assert len(lines) == 1 and out.strip().splitlines()[-1].startswith("{")
    line = lines[0]
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0
    assert "no CUDA device" in line["error"]
    assert line["last_phase"] == "worker-exit"
    # the error line carries no figure of an earlier run
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "error",
                         "last_phase"}
    assert list(tmp_path.iterdir()) == [tmp_path / bench.LOCK_NAME]


def test_bench_deadline_names_the_last_breadcrumb(tmp_path):
    rc, lines, _ = _run_bench(tmp_path, SSGVC_BENCH_DEADLINE="1")
    assert rc != 0 and len(lines) == 1
    line = lines[0]
    assert line["error"] == "worker exceeded 1s deadline"
    assert line["last_phase"] == "no breadcrumb" or \
        line["last_phase"].split(" ", 1)[1].startswith("init: ")
    assert line["value"] == 0.0


def test_bench_refuses_a_held_lock(tmp_path, monkeypatch):
    """A second measurement on the card refuses to start while the lock
    is held, and says so in its one line; ``SSGVC_TPU_LOCK_HELD`` skips
    the lock."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.delenv("SSGVC_TPU_LOCK_HELD", raising=False)
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    held = bench.card_lock()
    try:
        rc, lines, _ = _run_bench(tmp_path)
        assert rc != 0 and len(lines) == 1
        assert lines[0]["last_phase"] == "lock"
        assert "card busy" in lines[0]["error"]
        with pytest.raises(TimeoutError):
            bench.card_lock()
        monkeypatch.setenv("SSGVC_TPU_LOCK_HELD", "1")
        assert bench.card_lock() is None
    finally:
        held.close()
