"""The port's distortion-only probe (ssgvc_tpu_torch/experiments/probes/
probe_dist_only.py) against the JAX script on the CPU: lambda pinned at 1e5
in both packages, one eval-mode GOP loss on the same weights, the printed
lines, and no work at import. Split from test_torch_diagnostics.py, whose
set-up, weights and tolerances these share (lambda and the copy baseline
bit for bit, the GOP loss at rtol 1e-5).
"""

import re
import subprocess
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
from ssgvc_tpu.data.dataset import ClipDataModule as JaxClipDataModule
from ssgvc_tpu.data.dataset import SyntheticClipDataset as JaxClips
from ssgvc_tpu.training.loss import compute_lambda as jax_lambda
from ssgvc_tpu.training.trainer import Trainer as JaxTrainer
from ssgvc_tpu_torch.experiments import diag_pframe
from ssgvc_tpu_torch.experiments.probes import probe_dist_only as dist_only
from ssgvc_tpu_torch.training.loss import compute_lambda
from test_torch_diagnostics import (ROOT, _models,  # noqa: F401
                                    _write_checkpoint, port_cpu)
from torch_port_helpers import DMCI_RD_TINY, RD_TINY, drawn_params
from torch_port_helpers import one_torch_thread  # noqa: F401


def _jax_dist_only_config(variant):
    """experiments/probes/probe_dist_only.py:19-25."""
    cfg = JaxTrainConfig(dmc_variant=variant, accumulation_steps=1)
    cfg.precision = "fp32"
    cfg.optimizer.base_lr = 7e-4
    cfg.roi_weight = 1.0
    cfg.compression.lambda_min = 1e5
    cfg.compression.lambda_max = 1e5
    return cfg


@pytest.mark.parametrize("qp", [0, 32, 63])
def test_dist_only_lambda_is_pinned_in_both_packages(qp):
    """lambda_min = lambda_max = 1e5: compute_lambda gives one value at
    every QP, the same bit for bit in both packages. That value is
    99999.96875, not 1e5: exp(log(1e5)) in fp32, 4 fp32 steps below 1e5
    (relative 3.1e-7) in both packages."""
    cfg = dist_only.train_config("plain")
    jcfg = _jax_dist_only_config("plain")
    c, jc = cfg.compression, jcfg.compression
    assert (c.lambda_min, c.lambda_max, c.q_levels) == \
        (jc.lambda_min, jc.lambda_max, jc.q_levels) == (1e5, 1e5, 64)
    got = compute_lambda(qp, c.lambda_min, c.lambda_max, c.q_levels)
    want = jax_lambda(jnp.int32(qp), jc.lambda_min, jc.lambda_max,
                      jc.q_levels)
    assert got.dtype == torch.float32
    assert float(got) == float(want) == float(compute_lambda(
        32, c.lambda_min, c.lambda_max, c.q_levels))
    assert abs(float(got) / 1e5 - 1) < 4e-7


def test_dist_only_eval_gop_loss_equals_jax(port_cpu):
    """The distortion-only probe's Trainer and the JAX script's (rd-tiny,
    plain, the same config) on the same weights and the probe's first
    batch: one eval-mode GOP loss (train=False) at rtol 1e-5; the config's
    fields equal the JAX script's."""
    tr = dist_only.trainer("plain", 10, "cpu")
    cfg, jcfg = tr.cfg, _jax_dist_only_config("plain")
    for f in ("precision", "roi_weight", "accumulation_steps",
              "lambda_normalize"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    for f in ("base_lr", "min_lr", "warmup_iters", "optimizer_type"):
        assert getattr(cfg.optimizer, f) == getattr(jcfg.optimizer, f), f
    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)
    pi = copy(drawn_params(tr.dmci, 7, DMCI_HEADS))
    pp = copy(drawn_params(tr.dmc, 8, DMC_HEADS))
    ds = JaxClips(num_clips=512, seq_len=4, crop_size=64, seed=3,
                  texture="smooth")
    batch = next(JaxClipDataModule(ds, batch_size=4, split=(0.95, 0.05, 0.0),
                                   seed=3).train_iter())
    frames, masks = (batch[k][:2] for k in ("frames", "masks"))
    with torch.no_grad():
        loss, aux = tr.gop_loss(torch.from_numpy(frames),
                                torch.from_numpy(masks), 32,
                                torch.Generator().manual_seed(1),
                                train=False, eval_mode=True)
    jt = JaxTrainer(jcfg, total_iters=10,
                    dmc_cfg=JaxDMCConfig.variant("plain", **RD_TINY),
                    dmci_cfg=JaxDMCIConfig(**DMCI_RD_TINY))
    jloss, jaux = jt.gop_loss(pp, pi, jnp.asarray(frames),
                              jnp.asarray(masks), jnp.int32(32),
                              jax.random.PRNGKey(1), train=False,
                              eval_mode=True)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(aux["mse"]), float(jaux["mse"]),
                               rtol=1e-5)


def test_probe_dist_only_main_prints_the_jax_lines(port_cpu, capsys):
    """probe_dist_only.main plain 2 on a performance checkpoint written with
    save_checkpoint: the copy baseline bit for bit the JAX script's on the
    JAX data module's first batch, then step 0's line with a finite
    loss."""
    dmci, dmc, _, _ = _models(seed=13)
    path = diag_pframe.tiny_ckpt_path("performance")
    Path(path).parent.mkdir(parents=True)
    _write_checkpoint(path, dmci, dmc)
    out = dist_only.main(["plain", "2", "--device=cpu"])
    lines = capsys.readouterr().out.splitlines()
    ds = JaxClips(num_clips=512, seq_len=4, crop_size=64, seed=3,
                  texture="smooth")
    first = {k: jnp.asarray(v) for k, v in next(JaxClipDataModule(
        ds, batch_size=4, split=(0.95, 0.05, 0.0),
        seed=3).train_iter()).items()}
    f = np.asarray(first["frames"])
    cp = 10 * np.log10(1.0 / np.mean((f[:, 1:] - f[:, :-1]) ** 2))
    assert out["copy_baseline_psnr"] == float(cp)
    assert lines[0] == f"copy-baseline psnr on train batch: {cp:.2f} dB"
    assert len(lines) == 2
    assert re.fullmatch(r"step 0: loss \d+\.\d bpp \d+\.\d{4} P-psnr "
                        r"\d+\.\d\d \(\d+s\)", lines[1]), lines[1]
    assert np.isfinite(out["steps"][0]["loss"])


def test_probe_dist_only_does_nothing_at_import():
    """The JAX script trains at import; the port's module runs only from
    main."""
    proc = subprocess.run(
        [sys.executable, "-c", "import ssgvc_tpu_torch.experiments.probes."
         "probe_dist_only, ssgvc_tpu_torch.experiments.probes."
         "probe_latent_liveness, ssgvc_tpu_torch.experiments.diag_pframe"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == ""
