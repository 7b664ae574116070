"""The port's video trainer CLI (``python3 -m
ssgvc_tpu_torch.trainer_seg_video_model``) on the CPU at the tiny profile:
the files the JAX CLI writes, a resume from ``checkpoints/last`` that is
bit-exact against the live run, and ``load_pretrained`` from reference
DCVC-RT state dicts."""

import copy
import csv
import os

import numpy as np
import pytest
import torch

import trainer_seg_video_model as jax_cli
from ssgvc_tpu.utils import logging as jlog
from ssgvc_tpu.utils import torch_import as jti
from ssgvc_tpu_torch import trainer_seg_video_model as cli
from ssgvc_tpu_torch.data.dataset import SyntheticClipDataset
from ssgvc_tpu_torch.training.trainer import Trainer
from ssgvc_tpu_torch.utils.checkpoint import (load_pretrained,
                                              restore_checkpoint)
from ssgvc_tpu_torch.utils.weights import params_from_flax
from torch_port_helpers import reference_state_dict, tiny_params
from torch_port_helpers import one_torch_thread  # noqa: F401

# 8 clips, 6 for training: 3 steps of B=2 in one epoch, validation every 2
ARGV = ["--device=cpu", "model_profile=tiny", "precision=fp32",
        "dataset.synthetic=true", "dataset.synthetic_num_clips=8",
        "dataset.batch_size=2", "dataset.crop_size=64", "dataset.seq_len=2",
        "dataset.train_val_test_split=[0.75, 0.25, 0.0]", "epochs=1",
        "val_check_interval=2", "log_interval=1", "accumulation_steps=2",
        "save_top_k=1"]
STEPS = 3


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The CLI's run in a fresh working directory: (trainer, state,
    log_dir, working directory)."""
    cwd = tmp_path_factory.mktemp("cli")
    old = os.getcwd()
    os.chdir(cwd)
    try:
        trainer, state, log_dir = cli.main(ARGV)
    finally:
        os.chdir(old)
    return trainer, state, cwd / log_dir, cwd


def test_cli_writes_what_the_jax_cli_writes(run):
    trainer, state, log_dir, cwd = run
    assert ((cwd / cli.CONFIG_PATH).read_text() == cli.DEFAULT_YAML
            == jax_cli.DEFAULT_YAML)
    files = sorted(str(p.relative_to(log_dir)) for p in log_dir.rglob("*")
                   if p.is_file())
    assert files == ["checkpoints/last", "checkpoints/step1", "config.json",
                     "images/recon_p_step1.png", "images/recon_step1.png",
                     "train_metrics.csv", "val_metrics.csv"]
    for name, headers in (("train_metrics.csv", jlog.TRAIN_HEADERS),
                          ("val_metrics.csv", jlog.VAL_HEADERS)):
        with open(log_dir / name) as f:
            rows = list(csv.reader(f))
        assert rows[0] == headers
        assert len(rows) == 1 + (STEPS if name.startswith("train") else 1)
        assert all(np.isfinite(float(v)) for r in rows[1:] for v in r)
    assert state.step == STEPS and trainer.tx.count == 1
    assert trainer.tx.mini_step == 1
    grads = [p.grad for p in trainer.dmc.parameters() if p.grad is not None]
    assert grads and all(torch.isfinite(g).all() for g in grads)


def test_resume_from_last_is_bit_exact(run):
    trainer, state, log_dir, _ = run
    last = str(log_dir / "checkpoints" / "last")
    other = Trainer(trainer.cfg, total_iters=STEPS, device="cpu")
    other.init_state(torch.Generator().manual_seed(1))
    resumed = restore_checkpoint(last, other)
    assert resumed.step == state.step
    for k in ("alm_mu", "alm_h_accum", "alm_h_count"):
        assert torch.equal(getattr(resumed, k), getattr(state, k)), k

    def tensors(tr):
        opt = tr.tx.state_dict()
        out = {f"p/{k}": v for k, v in tr.dmc.state_dict().items()}
        out.update({f"i/{k}": v for k, v in tr.dmci.state_dict().items()})
        out.update({f"acc/{k}": v for k, v in opt["acc"].items()})
        out.update({f"opt/{n}/{k}": v for n, s in opt["state"].items()
                    for k, v in s.items()})
        return ({k: v.clone() for k, v in out.items()},
                (opt["count"], opt["mini_step"]))

    live, live_counts = tensors(trainer)
    got, got_counts = tensors(other)
    assert got_counts == live_counts and sorted(got) == sorted(live)
    for k, v in live.items():
        assert torch.equal(got[k], v), k

    # the next step (an applied update: micro-step 2 of 2) from both
    clips = SyntheticClipDataset(num_clips=2, seq_len=2, crop_size=64,
                                 seed=9)
    batch = {"frames": np.stack([clips[i][0] for i in range(2)]),
             "masks": np.stack([clips[i][1] for i in range(2)])}
    steps = [tr.train_step(st, batch, 17, torch.Generator().manual_seed(4))
             for tr, st in ((trainer, state), (other, resumed))]
    assert steps[0][1]["loss"].item() == steps[1][1]["loss"].item()
    assert steps[0][0].step == steps[1][0].step == STEPS + 1
    after, _ = tensors(trainer)
    for k, v in tensors(other)[0].items():
        assert torch.equal(after[k], v), k
    assert not torch.equal(after["p/encoder.conv1.weight"],
                           live["p/encoder.conv1.weight"])


def test_cli_resumes_from_last(run, tmp_path, monkeypatch):
    _, _, log_dir, _ = run
    monkeypatch.chdir(tmp_path)
    trainer, state, new_dir = cli.main(
        ARGV + ["exp_name=resumed",
                f"resume_from_checkpoint={log_dir / 'checkpoints' / 'last'}"])
    # micro-steps 4-6 with accumulation 2: updates at 4 and 6
    assert state.step == 2 * STEPS and trainer.tx.count == 3
    assert (tmp_path / new_dir / "checkpoints" / "last").is_file()


def test_load_pretrained_from_reference_state_dicts(run, tmp_path):
    trainer, _, log_dir, _ = run
    _, p_params, i_params = tiny_params()
    torch.save({"state_dict": reference_state_dict(p_params, "module.")},
               tmp_path / "video.pth")
    torch.save(reference_state_dict(i_params), tmp_path / "image.pth")
    cfg = copy.deepcopy(trainer.cfg)
    cfg.image_checkpoint_path = str(tmp_path / "image.pth")
    cfg.video_checkpoint_path = str(tmp_path / "video.pth")
    tr = Trainer(cfg, total_iters=STEPS, device="cpu")
    state = load_pretrained(tr, cfg)
    assert state.step == 0 and tr.tx is not None
    for model, params in ((tr.dmc, p_params), (tr.dmci, i_params)):
        want = params_from_flax(jti.align_params(jti.convert_state_dict(
            reference_state_dict(params)), params), model)
        for k, v in model.state_dict().items():
            if k == "z_gain":     # not in a reference checkpoint: the init
                assert torch.equal(v, torch.ones_like(v))
                continue
            assert torch.equal(v, want[k]), k
    # a port checkpoint as the image checkpoint: its params_i
    cfg.image_checkpoint_path = str(log_dir / "checkpoints" / "last")
    cfg.video_checkpoint_path = ""
    load_pretrained(tr, cfg)
    saved = restore_checkpoint(cfg.image_checkpoint_path)["params_i"]
    for k, v in tr.dmci.state_dict().items():
        assert torch.equal(v, saved[k]), k
