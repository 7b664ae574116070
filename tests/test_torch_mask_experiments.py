"""The port's mask_prop experiments and the Waymo-format journey
(ssgvc_tpu_torch/experiments/mask_train_phase.py, mask_prop_value.py,
e2e_waymo_format.py) against the JAX scripts (experiments/*.py, imported by
path) on the CPU, at small widths from seeded numpy inputs, the weights
carried across by utils/weights.py.

Tolerances: the zlib side-channel bpp and the journey's TFRecord bytes and
mask cache exactly; mask IoU to 1e-6; one mask_train step's loss at rtol
1e-5 and the updated mask_predictor leaves at atol 1e-5 (no other leaf
moves, in either package); mask_prop_value's curves at 2 QPs with bpp at
rtol 5e-3 (the rate estimate's known ill-conditioning, ROADMAP section 3)
and PSNR at 1e-3 dB.
"""

import filecmp
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import DMC_HEADS, DMCI_HEADS
from ssgvc_tpu.config import DMCConfig as JaxDMCConfig
from ssgvc_tpu.config import DMCIConfig as JaxDMCIConfig
from ssgvc_tpu.config import TrainConfig as JaxTrainConfig
from ssgvc_tpu.data.build_cache import build_cache as jax_build_cache
from ssgvc_tpu.data.dataset import SyntheticClipDataset as JaxClips
from ssgvc_tpu.models.dmc import DMC as JaxDMC
from ssgvc_tpu.models.dmci import DMCI as JaxDMCI
from ssgvc_tpu.training import evaluate as jev
from ssgvc_tpu.training.trainer import Trainer as JaxTrainer
from ssgvc_tpu_torch.config import DMCConfig, DMCIConfig
from ssgvc_tpu_torch.data.build_cache import build_cache
from ssgvc_tpu_torch.experiments import (e2e_waymo_format, mask_prop_value,
                                         mask_train_phase, rd_full)
from ssgvc_tpu_torch.models.dmc import DMC
from ssgvc_tpu_torch.models.dmci import DMCI
from ssgvc_tpu_torch.utils.checkpoint import save_checkpoint
from ssgvc_tpu_torch.utils.weights import flatten, flax_from_state_dict
from torch_port_helpers import DMCI_TINY, TINY, drawn_params

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "experiments"))

import e2e_waymo_format as jax_e2e  # noqa: E402
import mask_prop_value as jax_mpv  # noqa: E402
import mask_train_phase as jax_mtp  # noqa: E402
from torch_port_helpers import one_torch_thread  # noqa: F401

GLOBALS = ("MID_DMC", "MID_DMCI", "PROFILE", "RECON_SKIP", "CKPT_EXTRA",
           "DEVICE")


@pytest.fixture
def port_cpu(monkeypatch, tmp_path):
    """rd_full's globals restored after the test, the port on the CPU in
    ``tmp_path``, one thread (heavy tests under six test processes)."""
    for name in GLOBALS:
        monkeypatch.setattr(rd_full, name, getattr(rd_full, name))
    monkeypatch.setattr(rd_full, "DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield monkeypatch
    torch.set_num_threads(threads)


def test_mask_side_channel_bpp_equals_jax():
    rng = np.random.default_rng(3)
    for shape, p in (((4, 64, 64, 1), 0.3), ((2, 48, 80, 1), 0.05),
                     ((3, 32, 32, 1), 0.9)):
        masks = (rng.uniform(0, 1, shape) < p).astype(np.float32)
        assert mask_prop_value.mask_side_channel_bpp(masks) == \
            jax_mpv.mask_side_channel_bpp(masks)
    clips = mask_train_phase.eval_clips(64)
    m = np.asarray(clips[0][1])
    assert mask_prop_value.mask_side_channel_bpp(m) == \
        jax_mpv.mask_side_channel_bpp(m)


def _prop_models(seed=2):
    """The tiny mask_prop DMC (recon_residual, as the phase builds it) with
    drawn weights: (port model, flax params, JAX model)."""
    cfg = dict(recon_residual=True, **TINY)
    model = DMC(DMCConfig.variant("mask_prop", **cfg), device="cpu")
    params = drawn_params(model, seed, DMC_HEADS)
    return model, params, JaxDMC(JaxDMCConfig.variant("mask_prop", **cfg))


def test_mask_iou_equals_jax(port_cpu):
    """mask_iou on the phase's first held-out clip (seed 777, rng 900) at
    64 px: the same IoU to 1e-6 from the same weights."""
    model, params, jmodel = _prop_models()
    clips = mask_train_phase.eval_clips(64)[:1]
    got = mask_train_phase.mask_iou(model.eval(), None, clips)
    want = jax_mtp.mask_iou(jmodel, jax.tree_util.tree_map(jnp.asarray,
                                                           params), clips)
    assert np.isfinite(got) and 0.0 <= got <= 1.0
    assert abs(got - want) <= 1e-6, (got, want)


def test_one_mask_train_step_equals_jax(port_cpu):
    """One step of the phase's Trainer (mask_train, the BCE alone,
    accumulation 1, lr 1e-3) and of the JAX script's on the same weights,
    batch and QP: the loss, and the mask_predictor leaves after the
    update; every other leaf unmoved in both."""
    rd_full.MID_DMC = TINY
    rd_full.MID_DMCI = DMCI_TINY
    rd_full.RECON_SKIP = True
    tr = mask_train_phase.trainer(10, 1e-3)
    # copies: the step updates the port's tensors in place
    copy = lambda t: jax.tree_util.tree_map(np.array, t)
    params_p = copy(drawn_params(tr.dmc, 4, DMC_HEADS))
    params_i = copy(drawn_params(tr.dmci, 5, DMCI_HEADS))
    start_p = {k: v.clone() for k, v in tr.dmc.state_dict().items()}
    start_i = {k: v.clone() for k, v in tr.dmci.state_dict().items()}
    clips = mask_train_phase.eval_clips(64)
    # the I-frame and one P-frame: the P-frame's DPB comes from the I-frame
    # (coded with train=False) and its predicted mask from that DPB, so the
    # BCE does not see the quantiser noise, whose streams differ between
    # the packages (a second P-frame's DPB would: the spatial prior's
    # context carries the noise in training)
    batch = {"frames": np.stack([clips[0][0][:2]]),
             "masks": np.stack([clips[0][1][:2]])}
    state = tr.init_state(torch.Generator().manual_seed(0),
                          params_p=start_p, params_i=start_i)
    state, aux = tr.train_step(state, batch, 20,
                               torch.Generator().manual_seed(1))

    jcfg = JaxTrainConfig(dmc_variant="mask_prop", mask_train=True,
                          accumulation_steps=1)
    jcfg.optimizer.base_lr = 1e-3
    jtr = JaxTrainer(jcfg, total_iters=10,
                     dmc_cfg=JaxDMCConfig.variant("mask_prop",
                                                  recon_residual=True,
                                                  **TINY),
                     dmci_cfg=JaxDMCIConfig(**DMCI_TINY))
    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    jstate = jtr.init_state(jax.random.PRNGKey(0),
                            params_p=as_jax(params_p),
                            params_i=as_jax(params_i))
    jstate, jaux = jtr.jit_train_step()(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.int32(20), jax.random.PRNGKey(1))

    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]),
                               rtol=1e-5)
    got = flatten(flax_from_state_dict(tr.dmc.state_dict()))
    want = {k: np.asarray(v) for k, v in flatten(jstate.params_p).items()}
    before = flatten(params_p)
    assert got.keys() == want.keys()
    moved = 0
    for k, v in got.items():
        v = np.asarray(v)
        if "mask_predictor" in k[0]:
            np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-5,
                                       err_msg=str(k))
            moved += not np.array_equal(v, before[k])
        else:
            assert np.array_equal(v, before[k]), k
            assert np.array_equal(want[k], before[k]), k
    assert moved


def _write_variant(path, variant, seed):
    """A checkpoint of the tiny ``variant`` (recon_residual) and the tiny
    DMCI with drawn weights; returns their flax trees."""
    dmc = DMC(DMCConfig.variant(variant, recon_residual=True, **TINY),
              device="cpu")
    dmci = DMCI(DMCIConfig(**DMCI_TINY), device="cpu")
    pp = drawn_params(dmc, seed, DMC_HEADS)
    pi = drawn_params(dmci, seed + 1, DMCI_HEADS)
    save_checkpoint(path, {"params_p": dmc.state_dict(),
                           "params_i": dmci.state_dict()})
    return pp, pi


def test_mask_prop_value_curves_equal_jax(port_cpu):
    """mask_prop_value.main at the tiny widths on one held-out clip of 64
    px at 2 QPs, both variants' checkpoints written from drawn weights:
    the JSON has the JAX script's keys, and each curve equals the JAX
    package's evaluate_gop_estimated + rd_sweep on the same weights and
    clips (bpp rtol 5e-3, PSNR and ROI-PSNR 1e-3 dB); the side channel
    equals the JAX function's on the same masks."""
    port_cpu.setattr(mask_prop_value, "CLIPS", 1)
    port_cpu.setattr(rd_full, "set_profile", lambda p: None)
    rd_full.MID_DMC, rd_full.MID_DMCI = TINY, DMCI_TINY
    rd_full.PROFILE, rd_full.CKPT_EXTRA, rd_full.RECON_SKIP = (
        "tiny", "-roisub", True)
    os.makedirs("artifacts/torch")
    weights = {v: _write_variant(rd_full.ckpt_path(v), v, 6 + i)
               for i, v in enumerate(("fast", "mask_prop"))}
    qps = [20, 44]
    res = mask_prop_value.main(["--device=cpu", "--profile", "tiny",
                                "--crop", "64", "--qps", "20,44"])
    with open("artifacts/torch/mask_prop_value.json") as f:
        stored = json.load(f)
    assert set(stored) == {"profile", "crop", "qps",
                           "mask_side_channel_bpp_zlib", "variants",
                           "summary"}
    assert set(stored["summary"]) == {
        "roi_psnr_delta_fast_minus_maskprop", "fast_bpp_with_mask_channel",
        "note"}
    eval_ds = JaxClips(num_clips=8, seq_len=4, crop_size=64, seed=777,
                       texture="smooth", roi_subset=True)
    clips = [eval_ds.__getitem__(0, rng=np.random.default_rng(900))]
    assert stored["mask_side_channel_bpp_zlib"] == float(np.mean(
        [jax_mpv.mask_side_channel_bpp(np.asarray(m)) for _, m in clips]))
    index_map = list(JaxTrainConfig().compression.index_map)
    for variant, (pp, pi) in weights.items():
        jdmc = JaxDMC(JaxDMCConfig.variant(variant, recon_residual=True,
                                           **TINY))
        jdmci = JaxDMCI(JaxDMCIConfig(**DMCI_TINY))
        as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)

        def eval_qp(qp, jdmc=jdmc, jdmci=jdmci, pp=pp, pi=pi):
            out = []
            for frames, masks in clips:
                out.extend(jev.evaluate_gop_estimated(
                    jdmci, as_jax(pi), jdmc, as_jax(pp), frames, masks, qp,
                    index_map, list(jdmc.cfg.qp_shift)))
            return out

        want = jev.rd_sweep(eval_qp, qps=qps)
        got = res["variants"][variant]
        assert got["qp"] == qps
        np.testing.assert_allclose(got["bpp"], want["bpp"], rtol=5e-3,
                                   err_msg=variant)
        for k in ("psnr", "roi_psnr"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3,
                                       err_msg=f"{variant} {k}")


def test_journey_fixture_equals_jax(tmp_path):
    """The journey's TFRecord segment (bytes) and mask cache (every
    array) from one seed, and each frame's box, equal the JAX script's."""
    torch.set_num_threads(1)
    for pkg, make, cache in (("port", e2e_waymo_format, build_cache),
                             ("jax", jax_e2e, jax_build_cache)):
        d = tmp_path / pkg
        d.mkdir()
        boxes = make.make_segment(str(d / "segment_0.tfrecord"), 3,
                                  (64, 96), seed=1)
        (d / "boxes.json").write_text(json.dumps(boxes))
        seg = e2e_waymo_format.segmenter_for(boxes)
        stats = cache(str(d / "segment_0.tfrecord"), str(d / "cache"),
                      segmenter=seg)
        assert stats["written"] == 3
    a, b = tmp_path / "port", tmp_path / "jax"
    assert filecmp.cmp(a / "segment_0.tfrecord", b / "segment_0.tfrecord",
                       shallow=False)
    assert (a / "boxes.json").read_text() == (b / "boxes.json").read_text()
    files = sorted(p.relative_to(a / "cache")
                   for p in (a / "cache").rglob("*.npz"))
    assert len(files) == 3
    assert files == sorted(p.relative_to(b / "cache")
                           for p in (b / "cache").rglob("*.npz"))
    for f in files:
        x, y = np.load(a / "cache" / f), np.load(b / "cache" / f)
        assert x.files == y.files
        for k in x.files:
            assert np.array_equal(x[k], y[k]), (f, k)


def test_short_journey_runs_on_the_cpu_with_the_jax_keys(port_cpu):
    """e2e_waymo_format.main on the CPU, shortened by its keyword
    arguments (2 segments of 4 frames of 64 x 128, 2 intra steps, one
    epoch): every stage ran, the coded eval decoded every frame (it raises
    otherwise), and the JSON carries the JAX script's keys."""
    res = e2e_waymo_format.main(["--device=cpu"], hw=(64, 128), n_frames=4,
                                dmci_steps=2, epochs=1)
    with open("artifacts/torch/e2e_waymo_format.json") as f:
        stored = json.load(f)
    assert stored == json.loads(json.dumps(res))
    assert set(stored) == {"work_dir", "stages", "total_seconds"}
    st = stored["stages"]
    assert set(st) == {"tfrecords", "cache", "dmci_pretrain", "train",
                       "coded_eval"}
    assert st["tfrecords"] == {"segments": 2, "frames_per_segment": 4,
                               "hw": [64, 128]}
    assert st["cache"] == {"masks_written": 8}
    assert set(st["dmci_pretrain"]) == {"seconds", "steps", "train_psnr_db"}
    assert st["dmci_pretrain"]["steps"] == 2
    assert set(st["train"]) == {"seconds", "checkpoint"}
    assert set(st["coded_eval"]) == {"frames", "mean_p_bpp", "mean_p_psnr"}
    frames = st["coded_eval"]["frames"]
    assert [r["frame_type"] for r in frames] == ["I", "P", "P"]
    assert all(np.isfinite(r["bpp"]) and r["bpp"] > 0 for r in frames)
    assert not os.path.exists(stored["work_dir"])
