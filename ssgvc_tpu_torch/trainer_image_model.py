"""The I-frame (DMCI) trainer's command line, on one CUDA card or
data-parallel on several:

    python3 -m ssgvc_tpu_torch.trainer_image_model [--device=cpu] \\
        dataset.batch_size=16 epochs=5 ...
    torchrun --nproc_per_node=N -m ssgvc_tpu_torch.trainer_image_model \\
        num_devices=N ...

Reads ``image_compression_config.yaml`` from the working directory (written
with the defaults below when missing) and the dotted overrides (an unknown
key raises), builds the data module, then trains the DMCI at full width
with the variable-rate RD loss ``mean(bpp_y) + mean(bpp_z) + lambda(qp) *
mse`` over a random frame of each clip and a random QP: the global-norm
clip, then AdamW on the warmup-cosine schedule for every parameter but the
bit estimator's, which takes AdamW at ``aux_lr``. CSV logs and a config
snapshot go under ``log_dir/<exp_name>_<time>/``, and at the end one
checkpoint, ``checkpoints/last``, holding the DMCI's state_dict under
``params_i`` (what ``image_checkpoint_path`` of the video trainer imports).

As in the JAX package's image trainer, ``optimizer_type`` and
``image_checkpoint_path`` are read by nothing here: the optimizer is
always AdamW and training starts from a fresh init.

Under torchrun (or SLURM, or ``SSGVC_DIST=1``) each process joins the
process group (NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device=cpu``) and
steps its rank's stride of the data: rank 0's init on every rank, the
gradient averaged over the ranks before the clip, the logged metrics the
ranks' means, the quantiser noise seeded per rank (``seed`` on rank 0,
``seed + NOISE_SEED_STRIDE * rank`` elsewhere); ``num_devices`` must be
the process count. Rank 0 alone writes logs and the checkpoint.

``--device=cpu`` runs the plain versions on the CPU; without it the model
is built on the card, and a host with no card raises.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, Tuple

import numpy as np
import torch

CONFIG_PATH = "image_compression_config.yaml"

DEFAULT_YAML = """\
epochs: 10
grad_clip: 5.0
log_interval: 50
out_dir: out
image_checkpoint_path: ''
log_dir: ./logs
seed: 42
precision: bf16-mixed
num_devices: 1
exp_name: image-compression
dataset:
  dataset_type: waymo
  data_dir: ./dataset/waymo
  batch_size: 16
  crop_size: 256
  synthetic: false
optimizer:
  optimizer_type: adamw
  base_lr: 1.0e-4
  min_lr: 1.0e-5
  aux_lr: 5.0e-4
  weight_decay: 0.01
compression:
  lambda_min: 50.0
  lambda_max: 38400.0
  q_levels: 64
"""


def host_draws(host_rng: np.random.Generator, seq_len: int,
               q_levels: int) -> Tuple[int, int]:
    """One step's (frame index into the clip, QP), drawn in that order."""
    t_idx = int(host_rng.integers(0, seq_len))
    qp = int(host_rng.integers(0, q_levels))
    return t_idx, qp


def image_loss(model, x: torch.Tensor, qp: int, comp, train: bool,
               generator=None) -> Tuple[torch.Tensor, Dict]:
    """The RD loss of the I-frame codec on ``x`` (B, H, W, 3) at ``qp``:
    (loss, {loss, bpp, bpp_y, bpp_z, mse, psnr} detached)."""
    from .training.loss import compute_lambda, psnr_from_mse

    out = model(x, qp, train=train, generator=generator)
    mse = torch.mean((out["dpb"]["frame"].float() - x.float()) ** 2)
    lam = compute_lambda(qp, comp.lambda_min, comp.lambda_max, comp.q_levels)
    bpp_y, bpp_z = torch.mean(out["bpp_y"]), torch.mean(out["bpp_z"])
    loss = bpp_y + bpp_z + lam * mse
    aux = {"loss": loss, "bpp": torch.mean(out["bpp"]), "bpp_y": bpp_y,
           "bpp_z": bpp_z, "mse": mse, "psnr": psnr_from_mse(mse)}
    return loss, {k: v.detach() for k, v in aux.items()}


def make_tx(model, cfg, total_iters: int, group=None):
    """The optimizer over ``model``'s parameters: the global-norm clip,
    then AdamW on the warmup-cosine schedule for "main" and AdamW at
    ``aux_lr`` for "aux" (the bit estimator's); the gradient averaged over
    the data-parallel ``group`` first."""
    from .training.optimizers import aux_label, create_optimizers

    opt = cfg.optimizer
    return create_optimizers(model.named_parameters(), "adamw", opt.base_lr,
                             opt.min_lr, opt.aux_lr, opt.weight_decay,
                             opt.warmup_iters, total_iters, cfg.grad_clip,
                             label_fn=aux_label, group=group)


def train_step(model, tx, x: torch.Tensor, qp: int, comp,
               generator) -> Dict:
    """One optimizer step on the image batch ``x`` (the rank's shard);
    returns the aux, averaged over the optimizer's data group (the PSNR
    from the mean MSE)."""
    from .layers.blocks import cudnn_fp32
    from .parallel.mesh import mean_metrics
    from .parallel.spatial import batch_shard
    from .training.loss import psnr_from_mse

    tx.zero_grad()
    # the batch is the rank's shard of the group's (SSGVC_INT8's abs-max)
    with batch_shard(tx.group):
        loss, aux = image_loss(model, x, qp, comp, True, generator)
        with cudnn_fp32(model.dtype, x.device):
            loss.backward()
    tx.step()
    if tx.group is not None:
        aux = mean_metrics(aux, tx.group)
        aux["psnr"] = psnr_from_mse(aux["mse"])
    return aux


def main(argv):
    """Run the image trainer on ``argv`` (``--device=...`` and overrides).
    Returns {"model", "tx", "log_dir", "checkpoint", "steps"}."""
    from .config import DMCIConfig, load_config
    from .data.dataset import make_datamodule
    from .models.dmci import DMCI
    from .parallel.mesh import make_mesh, maybe_init_distributed, replicate
    from .training.trainer import NOISE_SEED_STRIDE
    from .utils.checkpoint import image_checkpoint, save_checkpoint
    from .utils.logging import (CSVLogger, is_main_process,
                                save_config_snapshot)

    device = "cuda"
    overrides = []
    for arg in argv:
        if arg.startswith("--device="):
            device = arg.partition("=")[2]
        else:
            overrides.append(arg)
    if not os.path.exists(CONFIG_PATH):
        with open(CONFIG_PATH, "w") as f:
            f.write(DEFAULT_YAML)
        print(f"[config] wrote default {CONFIG_PATH}")
    cfg = load_config(CONFIG_PATH, overrides)
    rank, world = 0, 1
    if maybe_init_distributed(device):
        rank = torch.distributed.get_rank()
        world = torch.distributed.get_world_size()
    dm = make_datamodule(cfg, rank=rank, world=world)
    mesh = make_mesh(cfg.num_devices, device=device)
    device = mesh.device
    steps_per_epoch = dm.steps_per_epoch()
    total_iters = cfg.epochs * steps_per_epoch

    log_dir = os.path.join(cfg.log_dir,
                           f"{cfg.exp_name}_{time.strftime('%Y%m%d_%H%M%S')}")
    logger = CSVLogger(log_dir)
    save_config_snapshot(log_dir, cfg)

    dtype = "bfloat16" if "bf16" in cfg.precision else "float32"
    model = DMCI(DMCIConfig(dtype=dtype), device=device)
    model.init_(torch.Generator().manual_seed(cfg.seed))
    replicate(mesh, model)
    tx = make_tx(model, cfg, total_iters, group=mesh.group("data"))

    comp = cfg.compression
    noise = torch.Generator(device=model.q_scale_enc.device).manual_seed(
        cfg.seed + NOISE_SEED_STRIDE * rank)
    host_rng = np.random.default_rng(cfg.seed)
    train_it = dm.train_iter()
    print(f"[image-trainer] steps={total_iters} devices={mesh.size}")
    for step in range(total_iters):
        batch = next(train_it)
        # every frame of the clip is a training image
        t_idx, qp = host_draws(host_rng, batch["frames"].shape[1],
                               comp.q_levels)
        x = torch.as_tensor(batch["frames"][:, t_idx]).to(
            model.q_scale_enc.device, torch.float32)
        aux = train_step(model, tx, x, qp, comp, noise)
        if step % cfg.log_interval == 0:
            logger.log_train(step, {k: float(v) for k, v in aux.items()})

    path = os.path.abspath(os.path.join(log_dir, "checkpoints", "last"))
    if is_main_process():
        save_checkpoint(path, image_checkpoint(model))
        print(f"[done] checkpoint at {path}")
    return {"model": model, "tx": tx, "log_dir": log_dir,
            "checkpoint": path, "steps": total_iters}


if __name__ == "__main__":
    main(sys.argv[1:])
