"""The port's opt-in experiments against the JAX package, on the CPU: the
W8A8 int8 convs (``SSGVC_INT8``, ``SSGVC_INT8_SCOPE``) with their scale
table, ``SSGVC_DW=shiftadd`` and the fused patch convs (``FUSE_DOWN`` /
``FUSE_UP``).

Tolerances, measured on this suite's inputs before they were fixed:

* ``qconv_plain`` against ``QuantConv.apply`` (op by op, as the JAX
  package's own tests apply it): bit for bit, int8 values and outputs, in
  fp32 and bf16, modes 1 and 2. Op by op, XLA divides by s_x and keeps the
  epilogue's multiply and add apart, as the port does.
* The tiny performance DMC (weights drawn as the smoke draws them): its
  calibration gives the JAX key set, values within 1.8e-7 relative (rtol
  1e-5 here); mode 2 on the same scales gave the same frame and feature
  bit for bit, and bpp within 1.2e-7 relative; mode 1 within 2.4e-7 on the
  frame. The bound here is test_torch_dmc.py's for the float path (atol
  1e-4, bpp rtol 5e-3): one flipped rounding moves an int8 value by one
  step, which the ~40 sequential quantized convs can carry to the output.
* The DepthConvBlock of ``tests/test_blocks_parity.py``'s int8 case, on its
  weights: measured max |diff| 0 (atol 1e-6 here), with shiftadd too.
* ``dw3x3_shiftadd``: the same elementwise ops in the same order, exact.
* The fused patch convs: fp32 sums of 192 (down) or 11 (up) products in
  another order: rtol and atol 1e-5, as tests/test_torch_pixel.py.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import DMC_HEADS, DMCI_HEADS
from ssgvc_tpu.config import DMCConfig as JaxDMCConfig
from ssgvc_tpu.layers import blocks as jb
from ssgvc_tpu.models.dmc import DMC as JaxDMC
from ssgvc_tpu.ops import pixel as jpix
from ssgvc_tpu_torch.coding.codec import VideoCodec
from ssgvc_tpu_torch.config import DMCConfig, DMCIConfig
from ssgvc_tpu_torch.layers import blocks as pb
from ssgvc_tpu_torch.models.dmc import DMC
from ssgvc_tpu_torch.models.dmci import DMCI
from ssgvc_tpu_torch.ops import pixel as tpix
from ssgvc_tpu_torch.ops import qconv as Q
from ssgvc_tpu_torch.parallel import spatial
from ssgvc_tpu_torch.utils.weights import load_flax_params
from torch_port_helpers import DMCI_TINY, TINY, drawn_params

HW = 64
QP = 32
ATOL = 1e-4
BPP_RTOL = 5e-3
SITES = [(1, 1, 0), (2, 2, 0), (3, 1, 1), (3, 2, 1)]


@pytest.fixture(autouse=True)
def int8_state():
    """Each test starts with both packages' scale tables empty and gives
    them back as it found them."""
    saved = (dict(jb._INT8_SCALES), set(jb._INT8_BAKED), set(jb._INT8_WARNED),
             dict(pb._INT8_SCALES), set(pb._INT8_WARNED))
    jb._INT8_SCALES.clear()
    jb._INT8_BAKED.clear()
    pb._INT8_SCALES.clear()
    pb._INT8_WARNED.clear()
    yield
    jb._INT8_SCALES.clear()
    jb._INT8_SCALES.update(saved[0])
    jb._INT8_BAKED.clear()
    jb._INT8_BAKED.update(saved[1])
    jb._INT8_WARNED.clear()
    jb._INT8_WARNED.update(saved[2])
    pb._INT8_SCALES.clear()
    pb._INT8_SCALES.update(saved[3])
    pb._INT8_WARNED.clear()
    pb._INT8_WARNED.update(saved[4])


# ------------------------------------------------------------- qconv ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("site", SITES, ids=lambda s: "k%ds%dp%d" % s)
def test_qconv_plain_matches_quantconv(monkeypatch, site, dtype):
    """Cin 1, 16 and 40, modes 1 and 2: the quantized input, the int32
    sums and the epilogue equal QuantConv's bit for bit."""
    torch.set_num_threads(1)
    k, s, p = site
    rng = np.random.default_rng(k * 10 + s)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for cin in (1, 16, 40):
        x = rng.standard_normal((2, 9, 11, cin)).astype(np.float32)
        kern = (rng.standard_normal((k, k, cin, 24)) * 0.3).astype(np.float32)
        b = (rng.standard_normal(24) * 0.1).astype(np.float32)
        xj = jnp.asarray(x).astype(jdt)
        xt = torch.from_numpy(x).to(tdt)
        wq, s_w = Q.quantize_weight(torch.from_numpy(
            kern.transpose(3, 2, 0, 1).copy()))
        mod = jb.QuantConv(features=24, kernel_size=(k, k), strides=(s, s),
                           padding=[(p, p), (p, p)])
        for mode in ("1", "2"):
            monkeypatch.setenv("SSGVC_INT8", mode)
            jb._INT8_SCALES.clear()
            jb._INT8_BAKED.clear()
            if mode == "2":
                jb._INT8_SCALES[""] = 3.3       # the root module's site
                s_x = torch.tensor(Q.static_scale(3.3))
            else:
                s_x = Q.dynamic_scale(xt)
            ref = mod.apply({"params": {"kernel": jnp.asarray(kern),
                                        "bias": jnp.asarray(b)}}, xj)
            out = Q.qconv(xt, wq, s_w, torch.from_numpy(b), s_x, k, s,
                          (p, p, p, p))
            assert out.dtype == tdt
            np.testing.assert_array_equal(
                out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                err_msg=f"cin {cin} mode {mode}")


def test_quantize_weight_and_scales_match_quantconv():
    """wq, s_w and both s_x forms equal the JAX package's arithmetic."""
    rng = np.random.default_rng(5)
    kern = (rng.standard_normal((3, 3, 7, 5)) * 0.2).astype(np.float32)
    kern[..., 2] = 0.0                     # an all-zero channel: s_w 1e-12/127
    k = jnp.asarray(kern)
    s_w = jnp.maximum(jnp.max(jnp.abs(k), axis=(0, 1, 2)), 1e-12) / 127.0
    wq_ref = np.asarray(jnp.round(k / s_w).astype(jnp.int8))
    wq, sw = Q.quantize_weight(torch.from_numpy(
        kern.transpose(3, 2, 0, 1).copy()))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(s_w))
    assert wq.shape == (5, 64) and not wq[:, 63].any()
    np.testing.assert_array_equal(
        wq[:, :63].numpy().reshape(5, 3, 3, 7),
        wq_ref.transpose(3, 0, 1, 2))
    x = rng.standard_normal((1, 4, 4, 7)).astype(np.float32)
    ref = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x))), 1e-12) / 127.0
    assert float(Q.dynamic_scale(torch.from_numpy(x))) == float(ref)
    for absmax in (0.37, 5.123456789, 0.0):
        assert Q.static_scale(absmax) == float(
            jnp.float32(max(absmax, 1e-12) / 127.0))


def test_kernel_constants_match_the_source():
    """ops/qconv.py pads K as csrc/qconv.cu steps through it."""
    import re
    from pathlib import Path

    src = (Path(Q.__file__).parent.parent / "csrc" / "qconv.cu").read_text()
    assert int(re.search(r"constexpr int BK = (\d+);", src).group(1)) \
        == Q.K_STEP
    assert "--use_fast_math" not in " ".join(Q._build.FLAGS)
    assert [Q.padded_k(k) for k in (1, 9, 32, 33, 4608)] == [32, 32, 32, 64,
                                                             4608]


def test_missing_site_warns_once_then_is_dynamic(monkeypatch):
    """Mode 2 with no scale for a site: one warning per site, then mode 1's
    dynamic scale, as QuantConv does."""
    torch.set_num_threads(1)
    conv = pb.Conv(8, 6, 3, padding=1, device="cpu")
    conv.site = "enc/down"
    pb.init_(conv, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 5, 6, 8)).astype(np.float32))
    monkeypatch.setenv("SSGVC_INT8", "1")
    with torch.no_grad():
        dyn = conv(x)
    monkeypatch.setenv("SSGVC_INT8", "2")
    with pytest.warns(UserWarning, match="enc/down"), torch.no_grad():
        first = conv(x)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with torch.no_grad():
            again = conv(x)
    assert torch.equal(first, dyn) and torch.equal(again, dyn)
    pb.set_int8_scales({"enc/down": 2.5})
    with torch.no_grad():
        static = conv(x)
    wq, s_w = conv.int8_weight()
    ref = Q.qconv_plain(x, wq, s_w, conv.bias,
                        torch.tensor(Q.static_scale(2.5)), 3, 1,
                        (1, 1, 1, 1), torch.float32)
    assert torch.equal(static, ref) and not torch.equal(static, dyn)


def test_int8_route_is_inference_only_and_not_row_sharded(monkeypatch):
    """The int8 route no longer refuses grad or a row shard. With grad on
    it is differentiable (the bias's gradient is the output gradient's
    sum; the scales' path is held against jax.grad in
    tests/test_torch_int8_grad.py); under a world-1 row shard a conv, and
    a whole codec through spatial_pframe, equal their unsharded int8
    forwards bit for bit."""
    monkeypatch.setenv("SSGVC_INT8", "1")
    conv = pb.Conv(4, 8, 3, padding=1, device="cpu")
    torch.manual_seed(0)
    with torch.no_grad():
        conv.weight.normal_()
    x = torch.randn((1, 8, 8, 4), generator=torch.Generator().manual_seed(1))
    xg = x.clone().requires_grad_(True)
    out = conv(xg)
    out.sum().backward()
    torch.testing.assert_close(conv.bias.grad, torch.full((8,), 64.0))
    assert (conv.weight.grad != 0).sum() == 8      # one abs-max a channel
    assert (xg.grad != 0).sum() == 1                 # x's abs-max
    with torch.no_grad():
        assert torch.equal(conv(x), out)
        with spatial.row_shard(None, [0, 8]):
            assert torch.equal(conv(x), out)
    # a whole codec under a world-1 row shard
    from ssgvc_tpu_torch.parallel.mesh import make_mesh

    model = DMC(DMCConfig.variant("performance", **TINY), device="cpu")
    drawn_params(model, 4, DMC_HEADS)
    rng = np.random.default_rng(4)
    u = lambda *s: torch.from_numpy(rng.uniform(0, 1, s).astype(np.float32))
    frame, mask = u(1, 64, 64, 3), (u(1, 64, 64, 1) > 0.7).float()
    dpb = {"frame": u(1, 64, 64, 3), "feature": u(1, 8, 8, 16) * 0.1}
    new, bpp = spatial.spatial_pframe(model, make_mesh(device="cpu"))(
        None, frame, mask, 20, dpb)
    with torch.no_grad():
        ref = model(frame, 20, dpb, after_i=False, mask=mask)
    for k in ("frame", "feature"):
        assert torch.equal(new[k], ref["dpb"][k]), k
    assert torch.equal(bpp, ref["bpp"])


def test_qconv_routes_by_device_without_fallback():
    """A CPU tensor takes the plain version; anything else is the kernel's,
    which refuses what it does not take instead of falling back."""
    class Card:                         # a CUDA tensor, as qconv sees it
        device = torch.device("cuda")
        dtype = torch.float16

        def contiguous(self):
            return self

    wq, s_w = Q.quantize_weight(torch.ones((4, 2, 1, 1)))
    with pytest.raises(TypeError, match="kernel takes"):
        Q.qconv(Card(), wq, s_w, torch.zeros(4), torch.tensor(1.0), 1, 1,
                (0, 0, 0, 0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        Q.qconv_cuda(torch.ones((1, 2, 2, 2)), wq, s_w, torch.zeros(4),
                     torch.tensor(1.0), 1, 1, (0, 0, 0, 0), torch.float32)


# ------------------------------------------------- the tiny codec ----

def _inputs():
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (1, HW, HW, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (1, HW, HW, 1)) > 0.7).astype(np.float32)
    frame = rng.uniform(0, 1, (1, HW, HW, 3)).astype(np.float32)
    feat = (rng.standard_normal((1, HW // 8, HW // 8, TINY["ch_d"])) * 0.1
            ).astype(np.float32)
    return x, mask, frame, feat


def _jax_apply(model, params, inputs, **kw):
    x, mask, frame, feat = inputs
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return model.apply({"params": params}, jnp.asarray(x),
                           jnp.int32(QP), {"frame": jnp.asarray(frame),
                                           "feature": jnp.asarray(feat)},
                           after_i=False, mask=jnp.asarray(mask),
                           train=False, **kw)


def _port_apply(model, inputs):
    t = torch.from_numpy
    x, mask, frame, feat = inputs
    with torch.no_grad(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return model(t(x), QP, {"frame": t(frame), "feature": t(feat)},
                     after_i=False, mask=t(mask))


def _outputs(out, jax_side):
    f = np.asarray if jax_side else (lambda t: t.numpy())
    return {"frame": f(out["dpb"]["frame"]),
            "feature": f(out["dpb"]["feature"]), "bpp": f(out["bpp"])}


@pytest.fixture(scope="module")
def dmc_case():
    """Both packages' tiny performance DMC on the same drawn weights: the
    calibrations under mode 2 (scope all, then 3x3) and the forwards with
    the collected scales installed and in mode 1."""
    torch.set_num_threads(1)
    port = DMC(DMCConfig.variant("performance", **TINY), device="cpu").eval()
    params = drawn_params(port, 3, DMC_HEADS)
    jmodel = JaxDMC(JaxDMCConfig.variant("performance", **TINY))
    inputs = _inputs()
    out = {"params": params}
    saved = (dict(jb._INT8_SCALES), set(jb._INT8_BAKED),
             dict(pb._INT8_SCALES))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SSGVC_INT8", "2")
        jb._INT8_SCALES.clear()
        pb._INT8_SCALES.clear()
        _, cal = _jax_apply(jmodel, params, inputs, mutable=["int8_calib"])
        out["jax_scales"] = jb.collect_int8_scales(cal["int8_calib"])
        with pb.int8_calibration() as calib:
            _port_apply(port, inputs)
        out["port_calib"] = dict(calib)
        out["port_scales"] = pb.collect_int8_scales(calib)
        jb.set_int8_scales(out["jax_scales"])
        pb.set_int8_scales(out["jax_scales"])
        out["mode2"] = (_outputs(_jax_apply(jmodel, params, inputs), True),
                        _outputs(_port_apply(port, inputs), False))
        mp.setenv("SSGVC_INT8", "1")
        out["mode1"] = (_outputs(_jax_apply(jmodel, params, inputs), True),
                        _outputs(_port_apply(port, inputs), False))
        mp.setenv("SSGVC_INT8", "2")
        mp.setenv("SSGVC_INT8_SCOPE", "3x3")
        jb._INT8_SCALES.clear()
        jb._INT8_BAKED.clear()
        _, cal3 = _jax_apply(jmodel, params, inputs, mutable=["int8_calib"])
        out["jax_3x3"] = set(jb.collect_int8_scales(cal3["int8_calib"]))
        with pb.int8_calibration() as calib3:
            _port_apply(port, inputs)
        out["port_3x3"] = set(calib3)
    for table, old in zip((jb._INT8_SCALES, jb._INT8_BAKED,
                           pb._INT8_SCALES), saved):
        table.clear()
        table.update(old)
    return out


def test_calibration_keys_and_values_match_jax(dmc_case):
    js, ps = dmc_case["jax_scales"], dmc_case["port_scales"]
    assert set(ps) == set(js) and len(js) > 100
    for k in js:
        np.testing.assert_allclose(ps[k], js[k], rtol=1e-5, err_msg=k)
    # the recorded values are fp32 abs-maxes; the margin is a Python float
    k = next(iter(dmc_case["port_calib"]))
    assert dmc_case["port_calib"][k].dtype == torch.float32
    assert ps[k] == float(dmc_case["port_calib"][k]) * 1.25


def test_scope_3x3_sites_match_jax(dmc_case):
    """SSGVC_INT8_SCOPE=3x3: the port's int8 sites are the JAX package's
    conv(..., 3, ...) sites, counted from both calibrations."""
    assert dmc_case["port_3x3"] == dmc_case["jax_3x3"]
    assert dmc_case["jax_3x3"] == {"encoder/down", "decoder/up/conv_0",
                                   "mask_sft/down"}
    port = DMC(DMCConfig.variant("performance", **TINY), device="cpu")
    threes = {m.site for m in port.modules() if isinstance(m, pb.Conv)
              and m.groups == 1 and m.weight.shape[-1] == 3}
    assert threes == dmc_case["port_3x3"]


@pytest.mark.parametrize("mode", ["mode1", "mode2"])
def test_tiny_dmc_under_int8_matches_jax(dmc_case, mode):
    ref, out = dmc_case[mode]
    for k in ("frame", "feature"):
        assert np.isfinite(out[k]).all()
        np.testing.assert_allclose(out[k], ref[k], atol=ATOL, err_msg=k)
    np.testing.assert_allclose(out["bpp"], ref["bpp"], rtol=BPP_RTOL)
    assert 0.0 < float(out["bpp"].sum()) < 24.0


def test_scales_json_interchanges_with_jax(dmc_case, tmp_path):
    """A JAX-saved scale file loads in the port and a port-saved one in
    JAX, each unchanged, in the same JSON form."""
    jb.set_int8_scales(dmc_case["jax_scales"])
    jb.save_int8_scales(str(tmp_path / "jax.json"))
    assert pb.load_int8_scales(str(tmp_path / "jax.json")) \
        == dmc_case["jax_scales"] == pb._INT8_SCALES
    pb.set_int8_scales(dmc_case["port_scales"])
    pb.save_int8_scales(str(tmp_path / "port.json"))
    jb._INT8_BAKED.clear()
    assert jb.load_int8_scales(str(tmp_path / "port.json")) \
        == dmc_case["port_scales"]
    assert (tmp_path / "port.json").read_text() == json.dumps(
        dmc_case["port_scales"], indent=0, sort_keys=True)


def test_coded_gop_mode2_decodes_bit_for_bit(monkeypatch, tmp_path):
    """The tiny codec, I + 2 P at 64x64 under mode 2 with calibrated
    scales: the decoder's frames equal the encoder's, and scales reloaded
    from their file reproduce the encoder's frames bit for bit."""
    torch.set_num_threads(1)
    monkeypatch.setenv("SSGVC_INT8", "2")
    dmci = DMCI(DMCIConfig(**DMCI_TINY), device="cpu").eval()
    dmc = DMC(DMCConfig.variant("performance", **TINY), device="cpu").eval()
    drawn_params(dmci, 0, DMCI_HEADS)
    drawn_params(dmc, 1, DMC_HEADS)
    rng = np.random.default_rng(7)
    frames = [torch.from_numpy(rng.uniform(0, 1, (1, HW, HW, 3)).astype(
        np.float32)) for _ in range(3)]
    mask = torch.from_numpy((rng.uniform(0, 1, (1, HW, HW, 1)) > 0.7
                             ).astype(np.float32))
    feat0 = torch.zeros((1, HW // 8, HW // 8, TINY["ch_d"]))
    with torch.no_grad(), pb.int8_calibration() as calib, \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dpb = {"frame": dmci(frames[0], QP)["dpb"]["frame"],
               "feature": feat0}
        for t in (1, 2):                 # both feature adaptors
            dpb = dmc(frames[t], QP, dpb, after_i=(t == 1), mask=mask)["dpb"]
    pb.set_int8_scales(pb.collect_int8_scales(calib))
    pb.save_int8_scales(str(tmp_path / "scales.json"))
    codec = VideoCodec(dmci, dmc)

    def encode():
        enc_i = codec.dmci_compress(frames[0], QP)
        dpb = {"frame": enc_i["x_hat"], "feature": feat0}
        streams, recons = [enc_i["bit_stream"]], [enc_i["x_hat"]]
        for t in (1, 2):
            out = codec.dmc_compress(frames[t], QP, dpb, after_i=(t == 1),
                                     mask=mask)
            streams.append(out["bit_stream"])
            recons.append(out["x_hat"])
            dpb = out["dpb"]
        return streams, recons

    with warnings.catch_warnings():
        warnings.simplefilter("error")       # every site has its scale
        streams, recons = encode()
    dec_i = codec.dmci_decompress(streams[0], HW, HW, QP)
    assert torch.equal(dec_i["x_hat"], recons[0])
    dpb = {"frame": dec_i["x_hat"], "feature": feat0}
    for t in (1, 2):
        dec = codec.dmc_decompress(streams[t], HW, HW, QP, dpb,
                                   after_i=(t == 1))
        assert torch.isfinite(dec["x_hat"]).all()
        assert torch.equal(dec["x_hat"], recons[t])
        dpb = dec["dpb"]
    pb.set_int8_scales({})
    pb.load_int8_scales(str(tmp_path / "scales.json"))
    streams2, recons2 = encode()
    assert streams2 == streams
    assert all(torch.equal(a, b) for a, b in zip(recons2, recons))


# ----------------------------------------------------- the block ----

def _jax_block_case():
    """tests/test_blocks_parity.py's int8 case: DepthConvBlock(16), its
    init plus 0.02 N(0, 1) noise, x (2, 12, 20, 16)."""
    fm = jb.DepthConvBlock(16)
    x = np.random.default_rng(7).normal(size=(2, 12, 20, 16)).astype(
        np.float32)
    params = fm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(
        lambda p: p + 0.02 * np.random.default_rng(8)
        .standard_normal(p.shape).astype(np.float32), params)
    return fm, params, x


@pytest.mark.parametrize("dw", ["conv", "shiftadd"])
def test_depth_conv_block_int8_matches_jax(monkeypatch, dw):
    torch.set_num_threads(1)
    monkeypatch.setenv("SSGVC_DW", dw)
    monkeypatch.setenv("SSGVC_INT8", "0")
    fm, params, x = _jax_block_case()
    fp = np.asarray(fm.apply(params, jnp.asarray(x)))
    monkeypatch.setenv("SSGVC_INT8", "1")
    ref = np.asarray(fm.apply(params, jnp.asarray(x)))
    block = pb.DepthConvBlock(16, device="cpu")
    load_flax_params(block, jax.tree.map(np.asarray, params["params"]))
    with torch.no_grad():
        out = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    # the JAX test's own property holds in the port too
    assert np.abs(out - fp).max() / np.abs(fp).max() < 0.02


def test_scope_3x3_keeps_the_fused_blocks(monkeypatch):
    """Under scope 3x3 the blocks' 1x1s stay fp: the DepthConvBlocks and
    chains go through the fused ops (ops.dcb_grad) as with int8 off; under
    scope all they run the composition instead."""
    calls = []
    real = (pb.dcb_grad, pb.dcb_chain_grad)
    monkeypatch.setattr(pb, "dcb_grad",
                        lambda *a, **k: calls.append("dcb") or real[0](*a, **k))
    monkeypatch.setattr(pb, "dcb_chain_grad",
                        lambda *a, **k: calls.append("chain")
                        or real[1](*a, **k))
    blocks = [pb.DepthConvBlock(8, device="cpu") for _ in range(3)]
    x = torch.ones((1, 4, 4, 8))
    monkeypatch.setenv("SSGVC_INT8", "2")
    monkeypatch.setenv("SSGVC_INT8_SCOPE", "3x3")
    with torch.no_grad():
        blocks[0](x)
        pb.run_chain(x, blocks[1:])
    assert calls == ["dcb", "chain"]
    monkeypatch.setenv("SSGVC_INT8_SCOPE", "all")
    monkeypatch.setenv("SSGVC_INT8", "1")
    with torch.no_grad():
        blocks[0](x)
        pb.run_chain(x, blocks[1:], q_last=torch.full((8,), 0.5))
    assert calls == ["dcb", "chain"]


def test_dw3x3_shiftadd_matches_jax():
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 7, 9, 12)).astype(np.float32)
    k = rng.standard_normal((3, 3, 1, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    ref = np.asarray(jb.dw3x3_shiftadd(jnp.asarray(h), jnp.asarray(k),
                                       jnp.asarray(b)))
    w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    out = pb.dw3x3_shiftadd(torch.from_numpy(h), w, torch.from_numpy(b))
    np.testing.assert_array_equal(out.numpy(), ref)
    conv = torch.nn.functional.conv2d(
        torch.from_numpy(h).permute(0, 3, 1, 2), w, torch.from_numpy(b),
        padding=1, groups=12).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), conv.numpy(), atol=1e-5)


# ------------------------------------------------ the patch convs ----

def test_fused_patch_down_conv_matches_jax_and_unfused(monkeypatch):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 24, 3)).astype(np.float32)
    k = (rng.standard_normal((1, 1, 192, 7)) * 0.1).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    args = (torch.from_numpy(x), w, torch.from_numpy(b), 8)
    unfused = tpix.patch_down_conv(*args)
    monkeypatch.setattr(jpix, "FUSE_DOWN", True)
    monkeypatch.setattr(tpix, "FUSE_DOWN", True)
    ref = np.asarray(jpix.patch_down_conv(jnp.asarray(x), jnp.asarray(k),
                                          jnp.asarray(b), 8))
    fused = tpix.patch_down_conv(*args)
    assert fused.shape == (2, 2, 3, 7) and fused.is_contiguous()
    np.testing.assert_allclose(fused.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fused.numpy(), unfused.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_fused_patch_up_conv_matches_jax_and_unfused(monkeypatch):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 5, 11)).astype(np.float32)
    k = (rng.standard_normal((1, 1, 11, 3 * 64)) * 0.1).astype(np.float32)
    b = rng.standard_normal(3 * 64).astype(np.float32)
    w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    args = (torch.from_numpy(x), w, torch.from_numpy(b), 8)
    unfused = tpix.patch_up_conv(*args)
    monkeypatch.setattr(jpix, "FUSE_UP", True)
    monkeypatch.setattr(tpix, "FUSE_UP", True)
    ref = np.asarray(jpix.patch_up_conv(jnp.asarray(x), jnp.asarray(k),
                                        jnp.asarray(b), 8))
    fused = tpix.patch_up_conv(*args)
    assert fused.shape == (2, 24, 40, 3) and fused.is_contiguous()
    np.testing.assert_allclose(fused.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fused.numpy(), unfused.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_fused_patch_convs_in_the_raw_io_dmc(monkeypatch):
    """The raw-io tiny DMC with both fused forms against both unfused, on
    the same weights: the same frame within the fused convs' tolerance."""
    torch.set_num_threads(1)
    model = DMC(DMCConfig.variant("performance", **TINY), device="cpu").eval()
    drawn_params(model, 3, DMC_HEADS)
    inputs = _inputs()
    ref = _outputs(_port_apply(model, inputs), False)
    monkeypatch.setattr(tpix, "FUSE_DOWN", True)
    monkeypatch.setattr(tpix, "FUSE_UP", True)
    out = _outputs(_port_apply(model, inputs), False)
    for k in ("frame", "feature"):
        np.testing.assert_allclose(out[k], ref[k], atol=ATOL, err_msg=k)
    np.testing.assert_allclose(out["bpp"], ref["bpp"], rtol=BPP_RTOL)
    assert os.environ.get("SSGVC_FUSE_DOWN", "0") == "0"
