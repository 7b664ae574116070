"""The port's utilities against the JAX package's on the same inputs: the
colour transforms, the CSV logs, the config snapshot and result JSON, the
recon panels, the checkpoint manager's retention, and the import of
reference DCVC-RT state dicts (against the JAX import carried into the port
by ``utils/weights.params_from_flax``)."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssgvc_tpu import config as jcfg
from ssgvc_tpu.utils import checkpoint as jckpt
from ssgvc_tpu.utils import logging as jlog
from ssgvc_tpu.utils import torch_import as jti
from ssgvc_tpu.utils import transforms as jtr
from ssgvc_tpu.utils import visualize as jvis
from ssgvc_tpu_torch import config as tcfg
from ssgvc_tpu_torch.config import DMCConfig, DMCIConfig
from ssgvc_tpu_torch.models.dmc import DMC
from ssgvc_tpu_torch.models.dmci import DMCI
from ssgvc_tpu_torch.utils import checkpoint as tckpt
from ssgvc_tpu_torch.utils import logging as tlog
from ssgvc_tpu_torch.utils import torch_import as tti
from ssgvc_tpu_torch.utils import transforms as ttr
from ssgvc_tpu_torch.utils import visualize as tvis
from ssgvc_tpu_torch.utils.weights import load_flax_params, params_from_flax
from torch_port_helpers import (DMCI_TINY, TINY, tiny_params,
                                reference_state_dict)

HW = 64
QP = 30
BPP_RTOL = 5e-3         # tests/test_torch_dmc.py's tolerances
DPB_ATOL = 1e-4


# ------------------------------------------------------------ transforms --

def test_tensor_colour_transforms_match_jax():
    x = np.random.default_rng(0).uniform(-0.1, 1.1, (2, 5, 7, 3)
                                         ).astype(np.float32)
    for t_fn, j_fn in ((ttr.rgb2ycbcr, jtr.rgb2ycbcr),
                       (ttr.ycbcr2rgb, jtr.ycbcr2rgb)):
        got = t_fn(torch.from_numpy(x))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(j_fn(
            jnp.asarray(x))), rtol=0, atol=1e-6)


def test_numpy_colour_and_420_transforms_equal_jax():
    x = np.random.default_rng(1).uniform(0, 1, (6, 8, 3)).astype(np.float32)
    for name in ("rgb2ycbcr_np", "ycbcr2rgb_np"):
        np.testing.assert_array_equal(getattr(ttr, name)(x),
                                      getattr(jtr, name)(x))
    y, uv = ttr.yuv_444_to_420(x)
    jy, juv = jtr.yuv_444_to_420(x)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(uv, juv)
    np.testing.assert_array_equal(ttr.ycbcr420_to_444_np(y, uv),
                                  jtr.ycbcr420_to_444_np(jy, juv))


# --------------------------------------------------------------- logging --

def test_csv_logs_equal_jax_byte_for_byte(tmp_path):
    rows = [(0, {"loss": 1.5, "bpp": 0.25, "psnr": 30.125, "qp_avg": 12.0,
                 "extra": 3}),
            (1, {"loss": float("nan"), "epoch": 2, "mse": 1e-7}),
            (5, {"bpp_y": np.float32(0.1), "bpp_z": 2})]
    for mod, who in ((tlog, "t"), (jlog, "j")):
        logger = mod.CSVLogger(str(tmp_path / who))
        for step, row in rows:
            logger.log_train(step, row)
            logger.log_val(step, row)
    for name in ("train_metrics.csv", "val_metrics.csv"):
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name
    assert tlog.TRAIN_HEADERS == jlog.TRAIN_HEADERS
    assert tlog.VAL_HEADERS == jlog.VAL_HEADERS
    assert tlog.is_main_process()


def test_config_snapshot_and_result_json_equal_jax(tmp_path):
    overrides = ["epochs=3", "dataset.batch_size=2", "seed=7",
                 "compression.weights_map={0: 1.0, 1: 2.0}"]
    paths = {}
    for mod, cfg_mod, who in ((tlog, tcfg, "t"), (jlog, jcfg, "j")):
        cfg = cfg_mod.load_config(None, overrides)
        paths[who] = mod.save_config_snapshot(str(tmp_path / who), cfg)
    assert (open(paths["t"]).read() == open(paths["j"]).read())
    frames = [{"frame_type": "I", "bpp": 0.5, "psnr": 33.1234567,
               "msssim": 0.98, "enc_time": 0.1, "dec_time": 0.05},
              {"frame_type": "P", "bpp": 0.05, "psnr": 31.0},
              {"frame_type": "P", "bpp": 0.07, "psnr": 30.5, "msssim": 0.9}]
    got = tlog.generate_log_json(frames, "seq", gop=8)
    assert got == jlog.generate_log_json(frames, "seq", gop=8)
    for mod, who in ((tlog, "t"), (jlog, "j")):
        mod.dump_json(got, str(tmp_path / f"{who}.json"), precision=3)
    assert ((tmp_path / "t.json").read_text()
            == (tmp_path / "j.json").read_text())
    assert json.loads((tmp_path / "t.json").read_text())[
        "ave_i_frame_psnr"] == 33.123


def test_recon_panel_pixels_equal_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(2)
    orig = rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)
    recon = rng.uniform(-0.05, 1.05, (24, 32, 3)).astype(np.float32)
    mask = (rng.uniform(size=(24, 32, 1)) > 0.5).astype(np.float32)
    for m in (None, mask):
        pix = []
        for mod, who in ((tvis, "t"), (jvis, "j")):
            path = mod.save_recon_panel(orig, recon,
                                        str(tmp_path / who / "p.png"), mask=m)
            img = Image.open(path)
            assert img.mode == "RGB" and img.size == (64, 24)
            pix.append(np.asarray(img))
        np.testing.assert_array_equal(*pix)


def test_q_scale_figures_written_like_jax(tmp_path):
    pytest.importorskip("matplotlib")
    q = np.random.default_rng(3).uniform(0.5, 2, (6, 16)).astype(np.float32)
    got = tvis.visualize_q_scale(q, str(tmp_path / "t"))
    want = jvis.visualize_q_scale(q, str(tmp_path / "j"))
    assert sorted(got) == sorted(want) == ["gif", "stats"]
    for k in got:
        assert (got[k].replace("/t/", "/") == want[k].replace("/j/", "/"))


# ----------------------------------------------------------- checkpoints --

def test_checkpoint_manager_keeps_the_same_steps_as_jax(tmp_path):
    stream = [(0, 3.0), (1, 2.0), (2, 5.0), (3, 1.0), (4, 2.5), (5, None)]
    managers = {"t": tckpt.CheckpointManager(str(tmp_path / "t"), top_k=2),
                "j": jckpt.CheckpointManager(str(tmp_path / "j"), top_k=2)}
    for step, loss in stream:
        metrics = {} if loss is None else {"val/loss": loss}
        managers["t"].save({"w": torch.full((2,), float(step))}, metrics,
                           step)
        managers["j"].save({"w": np.full((2,), float(step))}, metrics, step)
    kept = {who: sorted(p.name for p in (tmp_path / who).iterdir())
            for who in managers}
    assert kept["t"] == kept["j"] == ["last", "step1", "step3"]
    assert [p.rsplit("/", 1)[1] for p in (managers["t"].best_path,
                                          managers["j"].best_path)] == [
        "step3", "step3"]
    last = tckpt.restore_checkpoint(str(tmp_path / "t" / "last"))
    assert torch.equal(last["w"], torch.full((2,), 5.0))


# ----------------------------------------------------- reference import --

def test_reference_state_dict_import_equals_the_jax_import(tmp_path):
    jdmc, p_params, i_params = tiny_params()
    dmc = DMC(DMCConfig.variant("performance", **TINY), device="cpu")
    dmci = DMCI(DMCIConfig(**DMCI_TINY), device="cpu")
    # the JAX templates' values stand in for the models' init
    load_flax_params(dmc, p_params)
    load_flax_params(dmci, i_params)
    # different values from the templates', so the import shows
    shift = lambda tree: jti.unflatten({k: v + 0.5 for k, v in
                                        jti.flatten(tree).items()})
    ref_p = reference_state_dict(shift(p_params), "p_frame_model.")
    ref_i = reference_state_dict(shift(i_params))
    assert any(v.ndim == 4 and v.shape[1] == 3 * 64 for k, v in
               ref_p.items() if k.startswith("p_frame_model.feature_adaptor"))
    ref_p["p_frame_model.extra.unused"] = torch.zeros(3)
    torch.save({"state_dict": ref_p}, tmp_path / "video.pth")
    torch.save({"model": {"module." + k: v for k, v in ref_i.items()}},
               tmp_path / "image.pth")

    for path, jmodel_params, model in (("video.pth", p_params, dmc),
                                       ("image.pth", i_params, dmci)):
        sd = jti.load_torch_checkpoint(str(tmp_path / path))
        port_sd = tti.load_torch_checkpoint(str(tmp_path / path))
        assert sorted(sd) == sorted(port_sd)
        target = {".".join(k) for k in jti.flatten(jmodel_params)}
        want = params_from_flax(jti.align_params(
            jti.convert_state_dict(jti.normalize_prefix(sd, target)),
            jmodel_params), model)
        got = tti.align_state_dict(tti.convert_state_dict(
            tti.normalize_prefix(port_sd, model.state_dict().keys())),
            model.state_dict())
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        model.load_state_dict(got)

    # one P-frame forward of the imported weights, port against JAX
    jparams = jti.align_params(jti.convert_state_dict(jti.normalize_prefix(
        jti.load_torch_checkpoint(str(tmp_path / "video.pth")),
        {".".join(k) for k in jti.flatten(p_params)})), p_params)
    rng = np.random.default_rng(4)
    x, frame = (rng.uniform(0, 1, (1, HW, HW, 3)).astype(np.float32)
                for _ in range(2))
    mask = (rng.uniform(size=(1, HW, HW, 1)) > 0.6).astype(np.float32)
    feature = (0.1 * rng.standard_normal((1, HW // 8, HW // 8,
                                          TINY["ch_d"]))).astype(np.float32)
    ref = jdmc.apply({"params": jparams}, jnp.asarray(x), jnp.int32(QP),
                     {"frame": jnp.asarray(frame),
                      "feature": jnp.asarray(feature)},
                     after_i=True, mask=jnp.asarray(mask), train=False)
    t = torch.from_numpy
    with torch.no_grad():
        out = dmc(t(x), QP, {"frame": t(frame), "feature": t(feature)},
                  after_i=True, mask=t(mask))
    for k in ("bpp", "bpp_y"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=BPP_RTOL, err_msg=k)
    for k in ("frame", "feature"):
        np.testing.assert_allclose(out["dpb"][k].numpy(),
                                   np.asarray(ref["dpb"][k]), atol=DPB_ATOL,
                                   err_msg=k)


def test_import_refuses_what_the_jax_import_refuses():
    _, p_params, _ = tiny_params()
    dmc = DMC(DMCConfig.variant("performance", **TINY), device="cpu")
    load_flax_params(dmc, p_params)
    ref = reference_state_dict(p_params)
    key = next(k for k in ref if k.endswith("dc.0.weight"))
    for broken, err in (({k: v for k, v in ref.items() if k != key},
                         KeyError),
                        ({**ref, key: ref[key][:, :1]}, ValueError)):
        with pytest.raises(err):
            jti.align_params(jti.convert_state_dict(broken), p_params)
        with pytest.raises(err):
            tti.align_state_dict(tti.convert_state_dict(broken),
                                 dmc.state_dict())


@pytest.mark.parametrize("mode", ["zero", "mean", "kaiming"])
def test_inflate_input_conv_equals_jax(mode):
    k = np.random.default_rng(6).standard_normal((3, 3, 3, 8)
                                                 ).astype(np.float32)
    want = jti.inflate_input_conv(k, extra_in=2, mode=mode)
    got = tti.inflate_input_conv(torch.from_numpy(
        np.ascontiguousarray(k.transpose(3, 2, 0, 1))), extra_in=2, mode=mode)
    assert tuple(got.shape) == (8, 5, 3, 3)
    np.testing.assert_array_equal(got.numpy(), want.transpose(3, 2, 0, 1))
    for mod, arg in ((jti, k), (tti, torch.from_numpy(k))):
        with pytest.raises(ValueError):
            mod.inflate_input_conv(arg, mode="other")


def test_normalize_prefix_and_key_names_equal_jax():
    sd = {"p_frame_model.encoder.conv1.weight": 1,
          "p_frame_model.encoder.conv1.bias": 2,
          "module.encoder.conv1.bias": 3, "other.thing": 4}
    for target in ({"encoder.conv1.weight", "encoder.conv1.bias"},
                   {"encoder.conv1.bias"}, {"nothing"}, set()):
        assert tti.normalize_prefix(sd, target) == jti.normalize_prefix(
            sd, target)
    for key in ("enc.dec.1.3.dc.0.weight", "0.a", "a.b", "y_prior_fusion.3"):
        assert tti.torch_key_to_port_key(key) == ".".join(
            jti.torch_key_to_flax_path(key))
