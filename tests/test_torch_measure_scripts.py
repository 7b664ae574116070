"""The port's measuring scripts (``ssgvc_tpu_torch/experiments/
{profile_stages,bench_sweep,trace_bench,bench_coded,bench_rans,smoke_128px,
probe_int8}.py``) and ``utils/flops.py`` against the JAX scripts, on the
CPU: what they compute, not their times.

  * ``utils/flops.py`` counts the products (2 x multiply-adds) the JAX
    package's own jaxpr holds (every ``conv_general_dilated`` and
    ``dot_general``, sub-jaxprs included), exactly: per stage of
    ``profile_stages`` at rd-tiny, and for the whole 1088x1920 performance
    P-frame (928,285,908,480, raw and packed io; ``make_jaxpr`` and the
    meta device only trace shapes).
  * profile_stages' stage outputs equal the JAX stages' on the same weights
    (drawn for the port, carried by ``utils/weights.py``), at
    test_torch_dmc.py's tolerances: features at
    atol 1e-4, the z bits at rtol 1e-4.
  * bench_sweep's GOP equals the JAX script's ``lax.scan`` at B = 2 (bpp at
    test_torch_dmc.py's rtol 5e-3, the last frame's sum at 1e-4).
  * bench_coded's JSON entry has the JAX entry's keys (read from the JAX
    script's source) plus ``device`` and ``dtype``, bit-exact at rd-tiny.
  * bench_rans draws the JAX script's symbols and writes the JAX
    ``librans`` stream byte for byte; its JSON has the JAX row's keys.
  * smoke_128px writes no file; probe_int8's int8 case equals an integer
    reference.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.extend import core as jcore

from ssgvc_tpu.config import DMCConfig as JaxDMCConfig
from ssgvc_tpu.models.dmc import DMC as JaxDMC
from ssgvc_tpu.ops.pixel import pixel_unshuffle as jax_unshuffle
from ssgvc_tpu_torch import bench
from ssgvc_tpu_torch.config import DMCConfig
from ssgvc_tpu_torch.experiments import (bench_coded, bench_rans,
                                         bench_sweep, probe_int8,
                                         profile_stages, rd_full,
                                         smoke_128px)
from ssgvc_tpu_torch.models.dmc import DMC
from chip_smoke import DMC_HEADS
from torch_port_helpers import (RD_TINY, drawn_params,  # noqa: F401
                                one_torch_thread)

ROOT = Path(__file__).resolve().parents[1]
FRAME_FLOPS = 928_285_908_480
QP = 32
BPP_RTOL = 5e-3


def jaxpr_flops(jaxpr) -> int:
    """2 x multiply-adds over every conv_general_dilated and dot_general of
    ``jaxpr`` and its sub-jaxprs."""
    total = 0
    for e in jaxpr.eqns:
        name = e.primitive.name
        out = e.outvars[0].aval.shape if e.outvars else ()
        if name == "conv_general_dilated":
            rhs = e.invars[1].aval.shape
            spec = e.params["dimension_numbers"].rhs_spec
            taps = int(np.prod([rhs[d] for d in spec[2:]]))
            total += 2 * int(np.prod(out)) * rhs[spec[1]] * taps
        elif name == "dot_general":
            (lc, _), _ = e.params["dimension_numbers"]
            lhs = e.invars[0].aval.shape
            total += 2 * int(np.prod(out)) * int(np.prod([lhs[d]
                                                          for d in lc]))
        for v in e.params.values():
            for x in v if isinstance(v, (list, tuple)) else (v,):
                if isinstance(x, jcore.ClosedJaxpr):
                    total += jaxpr_flops(x.jaxpr)
                elif isinstance(x, jcore.Jaxpr):
                    total += jaxpr_flops(x)
    return total


def jax_param_shapes(model, cfg, packed):
    x = jnp.zeros((1, 64, 64, 3))
    m = jnp.zeros((1, 64, 64, 1))
    if packed:
        x, m = jax_unshuffle(x, 8), jax_unshuffle(m, 8)
    dpb = {"frame": x, "feature": jnp.zeros((1, 8, 8, cfg.ch_d))}
    return jax.eval_shape(lambda k: model.init(
        k, x, jnp.int32(QP), dpb, after_i=False, mask=m,
        train=False)["params"], jax.random.PRNGKey(0))


@pytest.mark.parametrize("packed", [False, True], ids=["raw", "packed"])
def test_full_frame_counts_the_jax_jaxprs_products(packed):
    """The performance P-frame at 1088x1920 in bf16: 928,285,908,480
    products in the JAX package's jaxpr and in utils/flops.py."""
    h, w = 1088, 1920
    jcfg = JaxDMCConfig.variant("performance", dtype="bfloat16",
                                packed_io=packed)
    jm = JaxDMC(jcfg)
    r = 8 if packed else 1
    s = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.bfloat16)
    x = s(1, h // r, w // r, 3 * r * r)
    jp = jax.make_jaxpr(lambda p, x, mk, d: jm.apply(
        {"params": p}, x, jnp.int32(QP), d, after_i=False, mask=mk,
        train=False))(jax_param_shapes(jm, jcfg, packed), x,
                      s(1, h // r, w // r, r * r),
                      {"frame": x, "feature": s(1, h // 8, w // 8, 256)})
    assert jaxpr_flops(jp.jaxpr) == FRAME_FLOPS
    cfg = DMCConfig.variant("performance", dtype="bfloat16",
                            packed_io=packed)
    assert bench_sweep.pframe_flops(cfg, 1, h, w) == FRAME_FLOPS


H, W = 64, 128


@pytest.fixture(scope="module")
def stages():
    """Both packages' nine stages at rd-tiny, fp32, on the same weights
    and inputs: (port [(name, output)], JAX {name: (jaxpr FLOP, output)},
    port FLOP by stage)."""
    jm = JaxDMC(JaxDMCConfig.variant("performance", **RD_TINY))
    cfg = DMCConfig.variant("performance", **RD_TINY)
    model = DMC(cfg, device="cpu")
    params = drawn_params(model, 5, DMC_HEADS)
    inputs = profile_stages.make_inputs(cfg, 1, H, W, 6, "cpu")
    port = [(n, out) for n, _, _, out in
            profile_stages.stage_calls(model, inputs, QP)]
    a = lambda t: jnp.asarray(t.numpy())
    feat, frame, mask = (a(inputs["dpb"]["feature"]), a(inputs["frame"]),
                         a(inputs["mask"]))
    q = jnp.ones((1, 1, 1, cfg.ch_d))
    q_rec = jnp.ones((1, 1, 1, cfg.ch_recon))
    ref = {}

    def stage(name, method, *args):
        fn = lambda p, *xs: jm.apply({"params": p}, *xs, method=method)
        flops = jaxpr_flops(jax.make_jaxpr(fn)(params, *args).jaxpr)
        out = jax.jit(fn)(params, *args)
        ref[name] = (flops, out)
        return out

    ctx, ctx_t = stage("feature_extractor", lambda m, f, qv:
                       m.feature_extractor(m.feature_adaptor_p(f), qv),
                       feat, q)
    y = stage("encoder", lambda m, x, c, qv: m.encoder(x, c, qv), frame,
              ctx, q)
    stage("mask_sft", lambda m, mk, qv: m.mask_sft(mk, qv), mask, q)
    z = stage("hyper_encoder", lambda m, y: m.hyper_encoder(y), y)
    pp = stage("prior_params", lambda m, z, c: m.res_prior_param_decoder(
        z, c), z, ctx_t)
    stage("spatial_prior(1x)", lambda m, cat: m.y_spatial_prior(cat),
          jnp.concatenate([y, pp], axis=-1))
    f = stage("decoder", lambda m, y, c, qv: m.decoder(y, c, qv), y, ctx, q)
    stage("recon_generation", lambda m, f, qv: m.recon_generation_net(
        f, qv), f, q_rec)
    stage("bit_estimator_z", lambda m, z: m.bit_estimator_z.bits(
        z, jnp.int32(QP)), z)
    return port, ref, profile_stages.count_flops(cfg, 1, H, W)


@pytest.mark.parametrize("name", profile_stages.STAGES)
def test_stage_counts_and_outputs_match_the_jax_stages(name, stages):
    """Each stage at rd-tiny: utils/flops.py's count equals the JAX stage's
    jaxpr count exactly; its output (the port's stage inputs chained as the
    JAX script chains them) equals the JAX stage's."""
    port, ref, port_flops = stages
    jax_flops, want = ref[name]
    assert port_flops[name] == jax_flops
    got = dict(port)[name]
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if name == "bit_estimator_z":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_stage_counts_sum_to_the_frames():
    """The nine stages (one spatial-prior pass) hold all of the frame's
    products at rd-tiny: the meta count of the stages sums to the whole
    frame's."""
    fl = profile_stages.count_flops(DMCConfig.variant("performance",
                                                      **RD_TINY), 1, H, W)
    assert sum(fl[s] for s in profile_stages.STAGES) == fl["full"] > 0


def test_bench_sweep_gop_matches_the_jax_scan():
    """bench_sweep's GOP (``bench.gop``: packed ingest, DPB carried) at
    B = 2 and the JAX script's ``gop`` (one ingest permutation,
    ``lax.scan`` over the frames) on the same weights and inputs, rd-tiny
    fp32."""
    b, n, hw = 2, 2, 64
    jm = JaxDMC(JaxDMCConfig.variant("performance", packed_io=True,
                                     **RD_TINY))
    cfg = DMCConfig.variant("performance", packed_io=True, **RD_TINY)
    model = DMC(cfg, device="cpu").eval()
    params = drawn_params(model, 8, DMC_HEADS)
    rng = np.random.default_rng(9)
    frames = rng.uniform(size=(n, b, hw, hw, 3)).astype(np.float32)
    masks = (rng.uniform(size=(n, b, hw, hw, 1)) > 0.8).astype(np.float32)
    prev = rng.uniform(size=(b, hw, hw, 3)).astype(np.float32)
    feat = (rng.standard_normal((b, hw // 8, hw // 8, RD_TINY["ch_d"]))
            * 0.1).astype(np.float32)

    @jax.jit
    def gop(params, frames, masks, qp, dpb):
        fb = frames.reshape((n * b,) + frames.shape[2:])
        mb = masks.reshape((n * b,) + masks.shape[2:])
        frames = jax_unshuffle(fb, 8).reshape((n, b, hw // 8, hw // 8, -1))
        masks = jax_unshuffle(mb, 8).reshape((n, b, hw // 8, hw // 8, -1))
        dpb = dict(dpb, frame=jax_unshuffle(dpb["frame"], 8))

        def step(dpb, xs):
            frame, mask = xs
            out = jm.apply({"params": params}, frame, qp, dpb,
                           after_i=False, mask=mask, train=False)
            return out["dpb"], out["bpp"]

        dpb, bpps = jax.lax.scan(step, dpb, (frames, masks))
        return bpps.sum(), dpb["frame"].sum()

    want = gop(params, jnp.asarray(frames), jnp.asarray(masks),
               jnp.int32(QP), {"frame": jnp.asarray(prev),
                               "feature": jnp.asarray(feat)})
    t = torch.from_numpy
    got = bench.gop(model, t(frames), t(masks), QP,
                    {"frame": t(prev), "feature": t(feat)})
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=BPP_RTOL)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-4)


def jax_dict_keys(script: str, name: str) -> set:
    """The keys of the dict literal assigned to ``name`` in the JAX
    script ``experiments/<script>``."""
    tree = ast.parse((ROOT / "experiments" / script).read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no dict {name} in {script}")


def test_bench_coded_entry_and_bit_exact(tmp_path, monkeypatch):
    """bench_coded at rd-tiny 64x64 on the CPU (I + 2 P): every decoded
    frame equal to the encoder's, the JSON entry under its label with the
    JAX entry's keys plus the card line and the dtype."""
    monkeypatch.chdir(tmp_path)
    path = "artifacts/torch/bench_coded.json"
    entry = bench_coded.main(["3", "--profile", "rd-tiny", "--res", "64x64",
                              "--json", path, "--device=cpu"])
    assert entry["bit_exact"] is True
    assert set(entry) == jax_dict_keys("bench_coded.py", "entry") | {
        "device", "dtype"}
    saved = json.loads(Path(path).read_text())
    assert saved == {"ec_part=0,skip=0.0,packed=0": entry}
    assert entry["backend"] == "cpu" and entry["n_p_frames"] == 2


def test_bench_rans_symbols_and_stream_match_the_jax_coder(tmp_path,
                                                           monkeypatch):
    """The JAX script's draws (default_rng(0)), the port's stream byte for
    byte the JAX librans stream on them, and the script's JSON row (the
    JAX row's keys) under artifacts/torch/."""
    from ssgvc_tpu.coding import cdf as jcdf
    from ssgvc_tpu.coding.rans import RansEncoder as JaxEncoder
    from ssgvc_tpu_torch.coding.cdf import build_y_cdf_tables
    from ssgvc_tpu_torch.coding.rans import RansEncoder

    n = 20_000
    tabs = jcdf.build_y_cdf_tables()
    cdfs, lengths, offsets = (np.asarray(a) for a in (
        tabs.cdfs, tabs.lengths, tabs.offsets))
    ptabs = build_y_cdf_tables()
    for a, b in ((cdfs, ptabs.cdfs), (lengths, ptabs.lengths),
                 (offsets, ptabs.offsets)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the JAX script's draws, as it writes them
    rng = np.random.default_rng(0)
    idx = rng.integers(0, cdfs.shape[0], n).astype(np.int32)
    sym = (rng.integers(0, 1 << 16, n)
           % np.maximum(lengths[idx] - 2, 1)).astype(np.int32)
    vals = (sym + offsets[idx]).astype(np.int16)
    got_idx, got_vals = bench_rans.draw_symbols(lengths, offsets, n)
    np.testing.assert_array_equal(got_idx, idx)
    np.testing.assert_array_equal(got_vals, vals)
    streams = []
    for enc in (JaxEncoder(), RansEncoder()):
        g = enc.add_cdf(cdfs, lengths, offsets)
        enc.encode_with_indexes(vals, idx, g)
        enc.flush()
        streams.append(enc.get_encoded_stream())
    assert streams[0] == streams[1]
    monkeypatch.chdir(tmp_path)
    row = bench_rans.main(["0.02"])
    assert json.loads((tmp_path / "artifacts/torch/bench_rans.json")
                      .read_text()) == row
    assert set(row) == jax_dict_keys("bench_rans.py", "row")
    assert row["n_symbols"] == n and row["decode_msym_s"] > 0


def test_smoke_128px_writes_no_file(tmp_path, monkeypatch):
    """Two mega-steps of one step each (the tiny widths, crop 64, batch 2
    on the CPU): finite telemetry, and the working directory stays
    empty."""
    monkeypatch.setattr(rd_full, "DEVICE", rd_full.DEVICE)
    monkeypatch.setattr(smoke_128px, "PROFILE", "tiny")
    monkeypatch.chdir(tmp_path)
    out = smoke_128px.main(["--crop", "64", "--batch", "2", "--k", "1",
                            "--device=cpu"])
    assert list(tmp_path.iterdir()) == []
    for k in ("loss", "bpp", "psnr", "steps_per_s"):
        assert np.isfinite(out[k])


@pytest.mark.parametrize("kh", [1, 3])
def test_probe_int8_case_equals_an_integer_reference(kh):
    """probe_int8's int8 application on the CPU (ops.qconv's plain version)
    against int64 sums of the quantised operands, scaled in fp32 and
    rounded to bf16."""
    from ssgvc_tpu_torch.ops.qconv import dynamic_scale, quantize_weight

    rng = np.random.default_rng(kh)
    b, h, w, c = 1, 6, 10, 32
    x = torch.tensor(rng.normal(size=(b, h, w, c)), dtype=torch.bfloat16)
    w32 = torch.tensor(rng.normal(size=(c, c, kh, kh)) * 0.05,
                       dtype=torch.float32)
    wq, s_w = quantize_weight(w32)
    s_x = dynamic_scale(x)
    bias = torch.zeros(c)
    got = probe_int8.conv_int8(kh, wq, s_w, bias, s_x)(x)

    xq = np.clip(np.rint(x.float().numpy() / s_x.numpy()), -127,
                 127).astype(np.int64)
    p = kh // 2
    xq = np.pad(xq, ((0, 0), (p, p), (p, p), (0, 0)))
    k = wq[:, :kh * kh * c].numpy().astype(np.int64).reshape(c, kh, kh, c)
    acc = np.zeros((b, h, w, c), np.int64)
    for dy in range(kh):
        for dx in range(kh):
            acc += np.einsum("bhwi,oi->bhwo", xq[:, dy:dy + h, dx:dx + w],
                             k[:, dy, dx, :])
    scale = (s_x * s_w).numpy().astype(np.float32)
    ref = torch.from_numpy(acc.astype(np.float32) * scale).to(torch.bfloat16)
    assert torch.equal(got, ref)
    assert probe_int8.bench(probe_int8.conv_int8(kh, wq, s_w, bias, s_x), x,
                            chain=2, reps=1) > 0
