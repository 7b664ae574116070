"""The video trainer's command line, on one CUDA card or data-parallel on
several:

    python3 -m ssgvc_tpu_torch.trainer_seg_video_model [--device=cpu] \\
        key=value dataset.batch_size=8 ...
    torchrun --nproc_per_node=N -m ssgvc_tpu_torch.trainer_seg_video_model \\
        num_devices=N ...

Reads ``video_compression_config.yaml`` from the working directory (written
with the defaults below when missing) and the dotted overrides (an unknown
key raises), builds the mask cache when ``build_cache=true``, builds the
data module (Waymo TFRecords, Vimeo-90k or synthetic clips), then trains:
CSV logs and a config snapshot under ``log_dir/<exp_name>_<time>/``, a
checkpoint after each validation (``checkpoints/last`` and the
``save_top_k`` best by val loss), recon panels under ``images/``, and
``checkpoints/last`` again at the end. ``resume_from_checkpoint`` resumes
from a port checkpoint; ``image_checkpoint_path`` /
``video_checkpoint_path`` import pretrained weights.

Under torchrun (or SLURM, or ``SSGVC_DIST=1``) each process joins the
process group (``parallel.mesh.maybe_init_distributed``: NCCL on
``cuda:LOCAL_RANK``, gloo with ``--device=cpu``), iterates its rank's
stride of every epoch with ``dataset.batch_size`` clips a step, and the
trainer averages the gradient over the ranks; ``num_devices`` must be the
process count. With ``build_cache``, local rank 0 of each host builds the
mask cache while the other ranks wait. Rank 0 alone writes logs and
checkpoints.

``--device=cpu`` runs the plain versions on the CPU; without it the models
are built on the card, and a host with no card raises.
"""

from __future__ import annotations

import os
import sys
import time

CONFIG_PATH = "video_compression_config.yaml"

DEFAULT_YAML = """\
epochs: 25
accumulation_steps: 8
grad_clip: 5.0
log_interval: 50
out_dir: out
dmc_variant: performance  # or: old / fast / mask_prop
image_checkpoint_path: ''
video_checkpoint_path: ''
log_dir: ./logs
seed: 42
precision: bf16-mixed
num_devices: 1
resume_from_checkpoint: null
build_cache: false
dataset:
  dataset_type: waymo
  data_dir: ./dataset/waymo
  seg_cache_dir: seg_cache
  batch_size: 32
  num_workers: 4
  seq_len: 4
  slide: 1
  crop_size: 128
  train_val_test_split: [0.9, 0.1, 0.0]
  strict_masks: false
  synthetic: false
optimizer:
  optimizer_type: adamw
  base_lr: 1.0e-4
  min_lr: 1.0e-5
  aux_lr: 5.0e-4
  weight_decay: 0.01
  warmup_iters: 0
compression:
  lambda_min: 50.0
  lambda_max: 38400.0
  q_levels: 64
  index_map: [0, 1, 0, 2, 0, 2, 0, 2]
  weights_map: {0: 0.5, 1: 1.2, 2: 0.9}
"""


def main(argv):
    """Run the trainer on ``argv`` (``--device=...`` and overrides).
    Returns (trainer, final state, log directory)."""
    import torch

    from .config import load_config
    from .data.dataset import make_datamodule
    from .parallel.mesh import (local_rank, make_mesh,
                                 maybe_init_distributed)
    from .training.trainer import Trainer
    from .utils.checkpoint import (CheckpointManager, load_pretrained,
                                   restore_checkpoint, save_checkpoint,
                                   train_checkpoint)
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

    # join the process group before the cache and the data module: one
    # process a host builds the cache, and each rank iterates its own
    # stride of every epoch
    rank, world = 0, 1
    if maybe_init_distributed(device):
        rank = torch.distributed.get_rank()
        world = torch.distributed.get_world_size()
    if cfg.build_cache:
        if local_rank() == 0:
            from .data.build_cache import build_cache
            stats = build_cache(
                os.path.join(cfg.dataset.data_dir, "*.tfrecord"),
                cfg.dataset.seg_cache_dir)
            print(f"[cache] {stats}")
        if world > 1:
            torch.distributed.barrier()
    dm = make_datamodule(cfg, rank=rank, world=world)
    mesh = make_mesh(cfg.num_devices, device=device)
    steps_per_epoch = dm.steps_per_epoch()
    total_iters = cfg.epochs * steps_per_epoch

    log_dir = os.path.join(cfg.log_dir,
                           f"{cfg.exp_name}_{time.strftime('%Y%m%d_%H%M%S')}")
    logger = CSVLogger(log_dir)
    save_config_snapshot(log_dir, cfg)

    trainer = Trainer(cfg, total_iters=total_iters, device=mesh.device,
                      mesh=mesh)
    print(f"[trainer] variant={cfg.dmc_variant} device={trainer.device} "
          f"devices={mesh.size} steps/epoch={steps_per_epoch} "
          f"total={total_iters}")

    state = None
    if cfg.resume_from_checkpoint:
        trainer.init_state(torch.Generator().manual_seed(cfg.seed))
        state = restore_checkpoint(cfg.resume_from_checkpoint, trainer)
        print(f"[resume] restored {cfg.resume_from_checkpoint} at step "
              f"{state.step}")
    elif cfg.image_checkpoint_path or cfg.video_checkpoint_path:
        state = load_pretrained(trainer, cfg)

    # float <= 1: a fraction of an epoch; int > 1: every N steps
    vci = cfg.val_check_interval
    val_every = int(vci) if vci > 1 else max(1, int(steps_per_epoch * vci))

    ckpt_dir = os.path.join(log_dir, "checkpoints")
    ckpt_manager = CheckpointManager(ckpt_dir, monitor="val/loss",
                                     top_k=cfg.save_top_k)
    state = trainer.fit(dm.train_iter(), dm.val_iter(loop=True),
                        steps=total_iters, val_every=val_every,
                        log_every=cfg.log_interval, seed=cfg.seed,
                        logger=logger, state=state,
                        steps_per_epoch=steps_per_epoch,
                        ckpt_manager=ckpt_manager,
                        image_log_dir=os.path.join(log_dir, "images"))

    ckpt_path = os.path.join(ckpt_dir, "last")
    if is_main_process():
        save_checkpoint(ckpt_path, train_checkpoint(trainer, state))
        print(f"[done] checkpoint at {ckpt_path} "
              f"(best: {ckpt_manager.best_path})")
    return trainer, state, log_dir


if __name__ == "__main__":
    main(sys.argv[1:])
