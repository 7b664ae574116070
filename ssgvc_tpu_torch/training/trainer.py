"""The trainer: the JAX package's ``training/trainer.py`` in PyTorch, on one
card (or the CPU when asked).

  * A GOP: frame 0 through the frozen I-frame codec under ``no_grad``, then
    P-frames 1..T-1 (``after_i`` for frame 1), the DPB detached between
    frames, each frame's QP ``qp + qp_shift[index_map[t % 8]]`` and weight
    ``weights_map[index_map[t % 8]]``; the loss is the mean of the frames'.
  * Per-frame remat, as ``jax.checkpoint``: ``torch.utils.checkpoint``
    (non-reentrant). torch's checkpoint replays the global RNG, not an
    explicit generator, so each frame's quantiser noise comes from its own
    generator, seeded by a draw made outside the checkpointed function:
    the recompute sees the same noise.
  * The optimizer (``training/optimizers.TrainOptimizer``): global-norm
    clip, then backbone at 0.3x the cosine LR and 0.5x weight decay, probe
    (mask_sft / q_sft / mask_predictor) at the full LR, aux
    (bit_estimator) at the fixed ``aux_lr``; ``mask_train`` updates
    mask_predictor alone on the mask BCE; ``accumulation_steps`` k applies
    the mean gradient of k micro-batches.
  * ``constraint_opt`` (ALM): rate + a dead-zone penalty on the ROI-MSE
    constraint, the dual ascent on the accumulation boundary.

One device: ``num_devices`` other than 1 raises (``parallel/`` is ROADMAP
§1 item 7). ``fit`` saves checkpoints (``utils/checkpoint.py``) and writes
recon panels (``utils/visualize.py``) after each validation.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import DMCConfig, DMCIConfig, TrainConfig
from ..layers.blocks import cudnn_fp32
from ..models.dmc import DMC
from ..models.dmci import DMCI
from .loss import (alm_deadzone_penalty, alm_dual_update, init_psnrm_schedule,
                   mse_from_psnr_db, psnr_from_mse, rate_distortion_loss,
                   roi_mse)
from .optimizers import TrainOptimizer
from .schedule import warmup_cosine

METRICS = ("loss", "bpp", "bpp_y", "bpp_z", "mse", "prev_obj", "g_mean")


def param_label(path: Tuple[str, ...]) -> str:
    """The backbone / probe / aux split of a parameter by its path."""
    joined = "/".join(str(p) for p in path)
    if "bit_estimator" in joined:
        return "aux"
    if "mask_sft" in joined or "q_sft" in joined or "mask_predictor" in joined:
        return "probe"
    return "backbone"


def mask_train_label(path: Tuple[str, ...]) -> str:
    return ("mask_predictor"
            if "mask_predictor" in "/".join(str(p) for p in path)
            else "frozen")


@dataclass
class TrainState:
    """What a step carries besides the models' parameters and the
    optimizer: the step count and the ALM dual state."""
    step: int
    alm_mu: torch.Tensor
    alm_h_accum: torch.Tensor
    alm_h_count: torch.Tensor


class Trainer:
    """Owns the models and the optimizer, and runs the train and eval
    steps. ``device`` defaults to "cuda"; pass "cpu" to run the plain
    versions."""

    def __init__(self, cfg: TrainConfig, total_iters: int = 10000,
                 dmc_cfg: Optional[DMCConfig] = None,
                 dmci_cfg: Optional[DMCIConfig] = None, device="cuda"):
        if cfg.num_devices != 1:
            raise NotImplementedError(
                f"num_devices={cfg.num_devices}: the port trains on one "
                "device; data parallelism is ROADMAP §1 item 7 (parallel/)")
        self.cfg = cfg
        self.device = torch.device(device)
        dtype = "bfloat16" if "bf16" in cfg.precision else "float32"
        if dmc_cfg is None:
            rr = getattr(cfg, "recon_residual", False)
            if getattr(cfg, "model_profile", "full") == "tiny":
                dmc_cfg = DMCConfig.variant(cfg.dmc_variant, dtype=dtype,
                                            ch_d=16, ch_y=8, ch_z=8,
                                            ch_recon=16, recon_residual=rr)
                dmci_cfg = dmci_cfg or DMCIConfig(enc_dec=32, N=16,
                                                  z_channel=8)
            else:
                dmc_cfg = DMCConfig.variant(cfg.dmc_variant, dtype=dtype,
                                            recon_residual=rr)
        self.dmc_cfg = dmc_cfg
        self.dmci_cfg = dmci_cfg or DMCIConfig(dtype=dtype)
        self.dmc = DMC(self.dmc_cfg, device=self.device)
        self.dmci = DMCI(self.dmci_cfg, device=self.device)
        self.dmci.requires_grad_(False)           # frozen
        self.index_map = list(cfg.compression.index_map)
        wm = cfg.compression.weights_map
        self.weights = [float(wm[k]) for k in sorted(wm)]
        self.psnrm_targets = init_psnrm_schedule(cfg.psnrm_target_path,
                                                 cfg.psnrm_default_db)
        self.sched = warmup_cosine(cfg.optimizer.base_lr,
                                   cfg.optimizer.min_lr,
                                   cfg.optimizer.warmup_iters, total_iters)
        self.remat = True      # per-frame recompute in training
        self.tx: Optional[TrainOptimizer] = None

    # ------------------------------------------------------------------ init

    def make_tx(self, named_params) -> TrainOptimizer:
        """The trainer's optimizer chain over (name, parameter) pairs."""
        cfg, sched = self.cfg, self.sched
        wd = cfg.optimizer.weight_decay
        if cfg.mask_train:
            # only mask_predictor trains; every other gradient still counts
            # in the clip's norm
            label_fn, groups = mask_train_label, {"mask_predictor": (sched,
                                                                     wd)}
        else:
            aux_lr = cfg.optimizer.aux_lr
            label_fn = param_label
            groups = {"backbone": (lambda s: 0.3 * sched(s), wd * 0.5),
                      "probe": (sched, wd),
                      "aux": (lambda s: aux_lr, wd)}
        return TrainOptimizer(named_params, label_fn, groups,
                              cfg.optimizer.optimizer_type, cfg.grad_clip,
                              cfg.accumulation_steps)

    def example_batch(self, batch_size=2, seq_len=4, hw=(64, 64)) -> Dict:
        h, w = hw
        return {"frames": torch.zeros((batch_size, seq_len, h, w, 3)),
                "masks": torch.zeros((batch_size, seq_len, h, w, 1))}

    def _on_device(self, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """A batch's frames and masks (tensors or the data module's numpy
        arrays) as float32 tensors on the trainer's device."""
        return tuple(torch.as_tensor(batch[k]).to(self.device, torch.float32)
                     for k in ("frames", "masks"))

    def _zero_feature(self, frames: torch.Tensor) -> torch.Tensor:
        p = self.dmc_cfg.patch_size
        return torch.zeros((frames.shape[0], frames.shape[2] // p,
                            frames.shape[3] // p, self.dmc_cfg.ch_d),
                           dtype=frames.dtype, device=frames.device)

    def init_state(self, generator: torch.Generator,
                   batch: Optional[Dict] = None, params_p=None,
                   params_i=None) -> TrainState:
        """Fresh weights drawn from ``generator`` (a CPU generator) unless
        state dicts are carried in; gain calibration only for a fresh init
        and only on a batch with signal; a new optimizer."""
        from .calibrate import calibrate_dmc, calibrate_dmci

        frames, masks = self._on_device(batch or self.example_batch())
        fresh_i = params_i is None
        if fresh_i:
            self.dmci.init_(generator)
        else:
            self.dmci.load_state_dict(params_i, strict=True)
        fresh_p = params_p is None
        if fresh_p:
            self.dmc.init_(generator)
        else:
            self.dmc.load_state_dict(params_p, strict=True)
        if self.cfg.calibrate_gains and float(frames.std(correction=0)) > 1e-4:
            if fresh_i:
                calibrate_dmci(self.dmci, frames[:, 0])
            if fresh_p:
                dpb = {"frame": frames[:, 0],
                       "feature": self._zero_feature(frames)}
                calibrate_dmc(self.dmc, frames[:, 1], dpb, masks[:, 1])
        self.tx = self.make_tx(self.dmc.named_parameters())
        zero = torch.zeros((), device=self.device)
        return TrainState(step=0, alm_mu=torch.full(
            (), float(self.cfg.lagr_init_lambda), device=self.device),
            alm_h_accum=zero.clone(), alm_h_count=zero.clone())

    # ------------------------------------------------------------- GOP loss

    def _frame_step(self, frames, masks, qp: int, t: int, after_i: bool,
                    seed: int, train: bool, eval_mode: bool, dpb_frame,
                    dpb_feature):
        """One P-frame: (new DPB frame, new DPB feature, both detached;
        metrics (7,))."""
        cfg, comp = self.cfg, self.cfg.compression
        fa_idx = self.index_map[t % 8]
        curr_qp = qp + self.dmc_cfg.qp_shift[fa_idx]
        w_t = 1.0 if eval_mode else self.weights[fa_idx]
        frame, gt_mask = frames[:, t], masks[:, t]
        m_in = None if eval_mode else gt_mask   # eval feeds 3 channels only
        gen = None
        if train:
            gen = torch.Generator(device=frame.device).manual_seed(seed)
        out = self.dmc(frame, curr_qp, {"frame": dpb_frame,
                                        "feature": dpb_feature},
                       after_i=after_i, mask=m_in, train=train,
                       generator=gen)
        g = torch.zeros((), device=frame.device)
        if cfg.constraint_opt:
            rd = rate_distortion_loss(out, frame, qp, w_t, comp.lambda_min,
                                      comp.lambda_max, comp.q_levels,
                                      mask=None, roi_weight=cfg.roi_weight)
            qp_eff = min(max(curr_qp, 0), 63)
            tau = mse_from_psnr_db(self.psnrm_targets[qp_eff]).to(g.device)
            g = ((roi_mse(out["dpb"]["frame"], frame, gt_mask) - tau)
                 / (tau + 1e-12))
            rd = rd._replace(loss=rd.bpp_y + rd.bpp_z
                             + cfg.alm_penalty_scale
                             * alm_deadzone_penalty(g, cfg.lagr_rho))
        else:
            rd = rate_distortion_loss(out, frame, qp, w_t, comp.lambda_min,
                                      comp.lambda_max, comp.q_levels,
                                      mask=gt_mask,
                                      roi_weight=cfg.roi_weight,
                                      lambda_normalize=cfg.lambda_normalize)
        loss = rd.loss
        if cfg.mask_train and out.get("mask_pred") is not None:
            # the loss is the BCE alone; the optimizer trains only
            # mask_predictor
            loss = F.binary_cross_entropy_with_logits(
                out["mask_pred"].float(), gt_mask)
        metrics = torch.stack([loss, rd.bpp, rd.bpp_y, rd.bpp_z, rd.mse,
                               rd.prev_obj, g])
        return (out["dpb"]["frame"].detach(), out["dpb"]["feature"].detach(),
                metrics)

    def _p_frame_losses(self, frames, masks, qp: int, dpb: Dict,
                        generator: torch.Generator, train: bool,
                        eval_mode: bool) -> torch.Tensor:
        """P-frames 1..T-1; returns the metrics stack (T-1, 7)."""
        seq_len = frames.shape[1]
        # one noise seed per frame, drawn outside any checkpointed function
        seeds = torch.randint(0, 2 ** 62, (seq_len,),
                              generator=generator).tolist()
        frame, feature = dpb["frame"], dpb["feature"]
        rows = []
        for t in range(1, seq_len):
            fn = functools.partial(self._frame_step, frames, masks, qp, t,
                                   t == 1, seeds[t], train, eval_mode)
            if self.remat and not eval_mode:
                frame, feature, m = checkpoint(fn, frame, feature,
                                               use_reentrant=False)
            else:
                frame, feature, m = fn(frame, feature)
            rows.append(m)
        return torch.stack(rows)

    def gop_loss(self, frames, masks, qp: int, generator: torch.Generator,
                 train: bool, eval_mode: bool):
        """A whole GOP: the I-frame (frozen), then the P-frames. Returns
        (scalar loss, aux metrics of detached scalars)."""
        with torch.no_grad():
            i_out = self.dmci(frames[:, 0], qp, train=False)
        dpb = {"frame": i_out["dpb"]["frame"],
               "feature": self._zero_feature(frames)}
        metrics = self._p_frame_losses(frames, masks, qp, dpb, generator,
                                       train, eval_mode)
        mean = metrics.mean(dim=0)
        aux = {k: mean[i].detach() for i, k in enumerate(METRICS)}
        aux["psnr"] = psnr_from_mse(aux["prev_obj"])
        aux["i_bpp"] = torch.mean(i_out["bpp"]).float()
        return mean[0], aux

    # ----------------------------------------------------------------- steps

    def backward(self, loss: torch.Tensor) -> None:
        """``loss.backward()``, an fp32 model's conv gradients in full fp32
        too (cuDNN's TF32 default off for the backward, as for each
        forward)."""
        with cudnn_fp32(self.dmc.dtype, self.device):
            loss.backward()

    def train_step(self, state: TrainState, batch: Dict, qp: int,
                   generator: torch.Generator):
        """One micro-batch: forward, backward, the optimizer (which applies
        on the accumulation boundary), the ALM dual state."""
        if self.tx is None:
            raise RuntimeError("init_state first")
        frames, masks = self._on_device(batch)
        self.tx.zero_grad()
        loss, aux = self.gop_loss(frames, masks, qp, generator, train=True,
                                  eval_mode=False)
        self.backward(loss)
        self.tx.step()
        if self.cfg.constraint_opt:
            state.alm_h_accum = state.alm_h_accum + aux["g_mean"]
            state.alm_h_count = state.alm_h_count + 1.0
            acc = self.cfg.accumulation_steps or 1
            # the dual ascent runs per optimizer step: on the boundary with
            # accumulation, where the micro-step count wraps to 0
            if acc <= 1 or self.tx.mini_step == 0:
                state.alm_mu, state.alm_h_accum, state.alm_h_count = \
                    alm_dual_update(state.alm_mu, state.alm_h_accum,
                                    state.alm_h_count, self.cfg.lagr_rho,
                                    mu_max=self.cfg.lagr_lambda_max)
        state.step += 1
        return state, aux

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Dict, qp: int,
                  generator: torch.Generator) -> Dict:
        frames, masks = self._on_device(batch)
        _, aux = self.gop_loss(frames, masks, qp, generator, train=False,
                               eval_mode=True)
        return aux

    # ------------------------------------------------------------- fit loop

    def fit(self, train_iter, val_iter=None, steps: int = 100,
            val_every: int = 0, log_every: int = 10, seed: int = 0,
            logger=None, state: Optional[TrainState] = None,
            steps_per_epoch: int = 0, ckpt_manager=None,
            image_log_dir: Optional[str] = None) -> TrainState:
        """The host loop: a QP per batch from
        ``np.random.default_rng(seed).integers(0, 64)``, step, log,
        validate; after each validation ``ckpt_manager``
        (``utils.checkpoint.CheckpointManager``) saves the checkpoint with
        the val loss, and ``image_log_dir`` gets the recon panels of the
        last train batch. ``logger`` is duck-typed (``log_train(step,
        row)``, ``log_val(step, row)``). Returns the final state."""
        gen = torch.Generator().manual_seed(seed)
        batches = []
        if state is None:
            first = next(train_iter)
            state = self.init_state(gen, first)
            batches = [first]
        host_rng = np.random.default_rng(seed)
        qp_sum, qp_cnt = 0.0, 0
        for step in range(steps):
            batch = batches.pop() if batches else next(train_iter)
            qp = int(host_rng.integers(0, 64))
            qp_sum += qp
            qp_cnt += 1
            state, aux = self.train_step(state, batch, qp, gen)
            if logger is not None and step % log_every == 0:
                row = {k: float(v) for k, v in aux.items()}
                row["qp_avg"] = qp_sum / max(qp_cnt, 1)
                if steps_per_epoch:
                    row["epoch"] = step // steps_per_epoch
                qp_sum, qp_cnt = 0.0, 0
                logger.log_train(step, row)
            if (val_iter is not None and val_every
                    and (step + 1) % val_every == 0):
                val = self.validate(state, val_iter, logger=logger,
                                    step=step, seed=seed + step,
                                    epoch=(step // steps_per_epoch
                                           if steps_per_epoch else 0))
                if ckpt_manager is not None and val:
                    from ..utils.checkpoint import train_checkpoint
                    ckpt_manager.save(train_checkpoint(self, state),
                                      {"val/loss": val.get("loss")}, step)
                if image_log_dir and val:
                    self._log_recon_images(batch, image_log_dir, step)
        return state

    @torch.no_grad()
    def _log_recon_images(self, batch: Dict, out_dir: str, step: int):
        """Recon panels of the batch's first clip at QP 32, on the main
        process: the I-frame (``recon_step<N>.png``), then the trained
        model's first P-frame from that I-frame, the ROI tinted
        (``recon_p_step<N>.png``)."""
        from ..utils.logging import is_main_process
        from ..utils.visualize import save_recon_panel

        if not is_main_process():
            return
        frames, masks = self._on_device({"frames": batch["frames"][:1],
                                         "masks": batch["masks"][:1]})
        i_out = self.dmci(frames[:, 0], 32, train=False)
        host = lambda t: t[0].float().cpu().numpy()
        os.makedirs(out_dir, exist_ok=True)
        save_recon_panel(host(frames[:, 0]), host(i_out["dpb"]["frame"]),
                         os.path.join(out_dir, f"recon_step{step}.png"))
        if frames.shape[1] > 1:
            dpb = {"frame": i_out["dpb"]["frame"],
                   "feature": self._zero_feature(frames)}
            p_out = self.dmc(frames[:, 1], 32, dpb, after_i=True,
                             mask=masks[:, 1], train=False)
            save_recon_panel(host(frames[:, 1]), host(p_out["dpb"]["frame"]),
                             os.path.join(out_dir, f"recon_p_step{step}.png"),
                             mask=host(masks[:, 1]))

    def validate(self, state: TrainState, val_iter, n_batches: int = 8,
                 logger=None, step: int = 0, seed: int = 0,
                 epoch: int = 0) -> Dict[str, float]:
        host_rng = np.random.default_rng(seed)
        gen = torch.Generator().manual_seed(seed)
        agg: Dict[str, float] = {}
        count = 0
        for _ in range(n_batches):
            try:
                batch = next(val_iter)
            except StopIteration:
                break
            qp = int(host_rng.integers(0, 64))
            aux = self.eval_step(state, batch, qp, gen)
            for k, v in aux.items():
                agg[k] = agg.get(k, 0.0) + float(v)
            count += 1
        if count:
            agg = {k: v / count for k, v in agg.items()}
            agg["epoch"] = epoch
            if logger is not None:
                logger.log_val(step, agg)
        return agg
