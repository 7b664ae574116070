#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0] [--frames 8] [--prev-port DIR]

Phases (any failure exits non-zero and prints no result line):
  1. device: the card's name and power limit (nvidia-smi), name and count;
  2. build: the DepthConvBlock kernels from ssgvc_tpu_torch/csrc (dcb,
     dcb_chain, dcb_bwd, dcb_f32, dcb_tf32), one nvcc each, started
     together; prints registers, shared memory and spill bytes of every
     instantiation (one per computed width CP; the SIMT kernel's one per
     C), the 3xTF32 and SIMT kernels' shared-memory plans and the SIMT
     kernel's unit plans and K split as compiled (each fails unless
     ops/dcb.py's mirror agrees), and the wgmma kernels' wgmma (HGMMA) and
     every weight-staging kernel's bulk-copy (UBLKCP) instructions from
     cuobjdump (none fails);
  3. kernels: each kernel at every shape the P-frame and I-frame codecs
     give it, against its plain PyTorch version on the same bf16 inputs
     (relative Frobenius error <= 1e-2), timed with CUDA events, beside its
     bound; each chain also beside N launches of the single-block kernel
     on the same blocks (seq_ms), timed in turns (chain, seq, seq, chain).
     Every time in this script is a mean over a run of launches queued
     behind a torch.cuda._sleep (cuda_ms), so the card sets it, not the
     host's launch rate.
     With --prev-port DIR (another checkout's ssgvc_tpu_torch/, e.g. the
     parent commit's unpacked by git archive into a git-ignored directory)
     that checkout's kernels are built and timed in the same turns as
     prev_ms (prev, new, ..., new, prev) at every P-frame and I-frame
     shape, through its own layers.blocks (DepthConvBlock(c,
     shortcut=sc) and run_chain) on
     blocks holding the same weights, as its main path calls them;
  4. I-frame: the DMCI intra codec at full width (enc_dec 368, N 256,
     z_channel 128), bf16 compute, a raw 1088x1920 frame at QP 32, weights
     drawn from --seed; 42 single-block launches and no chained one per
     frame; timed IFRAME_RUNS times after a warm-up, ms/frame their median;
  5. main path: the performance-variant P-frame codec at full width
     (ch_d 256, ch_y 128, ch_z 128, ch_recon 320), bf16 compute, packed io,
     1088x1920 frames, a GOP of --frames P-frames carrying the DPB from the
     decoded I-frame, weights drawn from --seed; every launch counted (19
     single + 5 chained on the frame after the I-frame, 18 + 5 on the
     others); the GOP is timed GOP_RUNS times, ms/frame their median,
     with the time by which the host had queued each GOP beside it; with
     --prev-port also the other checkout's DMC (its own models.dmc) on the
     same weights, PREV_ROUNDS rounds of (prev, new, new, prev) GOPs;
  6. streaming: StreamingDMC (raw io) on the same weights, first 3 frames
     and starting DPB, against the packed-io GOP;
  7. GOP: training/evaluate.evaluate_gop_estimated on the card, the I-frame
     codec then the raw-io P-frame codec on the same weights, an I-frame
     and 3 P-frames from --seed, every frame's launches counted; prints
     each frame's bpp, PSNR, ROI-PSNR and MS-SSIM (random weights: a run
     check, not a rate-distortion result). Not timed: the host metrics run
     inside it;
  8. cross-check: the same weights of both codecs at 128x128 through the
     CPU port in fp32 (plain versions) and the card in bf16 (kernels);
  9. variants: the other four P-frame variants (plain, old, fast,
     mask_prop) at full width, bf16, packed io, 1088x1920, weights drawn
     from --seed, each coding a GOP of VARIANT_P_FRAMES P-frames from the
     decoded I-frame with its launches counted (16 single + 5 chained on
     the frame after the I-frame, 15 + 5 after), timed VARIANT_RUNS times
     in turns with the performance variant on the same GOP (ms/frame the
     median);
     then each against the CPU port in fp32 at 128x128, both after_i
     values (mask_prop also the sign of its predicted mask logits);
 10. coded GOP: coding.codec.VideoCodec (the real rANS coder) with the
     full-width I-frame codec and the performance P-frame codec, bf16,
     packed_dmc, raw 1088x1920 frames (phase 7's), I + 3 P at INDEX_MAP's
     QPs: every frame encoded, then decoded from its stream alone, each
     decoded frame and DPB equal (torch.equal) to the encoder's; encoder
     and decoder launches counted per frame (I 42 / 32; P 19+5 / 12+4 after
     the I-frame, 18+5 / 11+4 after); bytes, real beside phase 7's
     estimated bpp, encode and decode ms with their host rANS part, peak
     memory; after a warm-up GOP, CODED_RUNS timed ones, each frame's ms
     their median. Then a mask_prop GOP of
     I + 2 P through coding.session.CodingSession and an in-memory file:
     the decoded frames and the decoder's mask chain equal the encoder's.
 11. batch: both forward kernels at every training shape with B = 4
     against their plain versions (relative Frobenius error <= 1e-2) and
     against four B = 1 launches, bit for bit, timed beside them;
 12. backward kernels: each kernel of ops/dcb_grad.py (csrc/dcb_bwd.cu)
     at every shape a training micro-step gives it, B = 4, against its
     plain version on the same inputs, gate_bwd's and dw_bwd's partials
     row by row against the plain sums over each row's tile
     (ops.dcb_grad.bwd_tiles), timed with CUDA events beside its bound
     (the bytes of its function: each input read once, each output and
     per-channel sum written once) and the library call that computes the
     same function, where there is one (grad_reduce: torch.sum, and its
     result bit for bit against ops.dcb_grad.grad_reduce_order, the same
     additions on the CPU; dw_fwd: cuDNN's depthwise conv alone, without
     WSiLU); dw_fwd also with an fp32 g; with --prev-port also the other
     checkout's kernels on the same inputs (gate_bwd and dw_bwd on their
     own partials), in turns (prev, new, new, prev), and dw_fwd's g, in
     bf16 and fp32, equal to that checkout's (max |difference| 0); the
     per-micro-step sums weigh each shape's time by the block backwards
     counted there in phase 13 (a shape counted there and not timed here
     fails);
 13. training: training.trainer.Trainer with the default TrainConfig
     (performance variant, full profile, bf16-mixed, accumulation_steps 8,
     clip 5.0, AdamW), fresh calibrated weights from --seed, TRAIN_STEPS
     micro-steps on data.device_synth.synth_batch(B=4, 128x128, T=4) on the
     card: every loss finite, the parameters unchanged through micro-step
     7 and changed at 8, every DepthConvBlock parameter's gradient finite
     and nonzero, every kernel's launches per micro-step counted (counts
     set to 0 just before each micro-step, read just after), ms per
     micro-step (CUDA events, median of steps 3-10), peak memory; then
     validate on VAL_BATCHES batches, one train_step each of mask_prop
     with mask_train and of constraint_opt; then the card's bf16 gop_loss
     and gradient against the CPU port's fp32 on the same weights (full
     width, recon_residual, 128x128, B = 2, train=False): loss within
     5e-2, gradient cosine >= XTRAIN_COSINE to the CPU's fp32 one and >=
     XTRAIN_KERNEL_COSINE to the CPU port's own bf16 one (the same
     rounding points, so what is left is the card's kernels), the dots
     and norms over the whole gradient in float64;
 14. widths: both kernels in bf16 and fp32 at every width of every profile
     and every computed width (WIDTH_SINGLE to 512, WIDTH_CHAIN to 384), on
     B=4 8x8 (a 64x64 crop), B=4 24x24 (a 192x192 clip) and B=1 136x240
     frames and their hyper and prior sites (B=8 4x4, B=4 12x12, 68x120,
     17x30: cut-off and partly filled tiles), each against its plain version (bf16 relative Frobenius 1e-2,
     fp32 max |d| / max |ref| 1e-5 with TF32 off), one launch per call,
     timed beside its plain version and its bound (989 TFLOP/s bf16; fp32
     by route: 3 x 495 TFLOP/s TF32 on the 3xTF32 kernel, C >= 72, 67
     TFLOP/s on the SIMT one below; at C <= 64 the 3xTF32 kernel on the
     same inputs beside the SIMT one, and with --prev-port the other
     checkout's SIMT kernel in turns, prev_ms); then the fp32 kernels at
     every P-frame and I-frame shape (all on the 3xTF32 route) as phase 3
     times the bf16 ones, with --prev-port's fp32 kernels in the same
     turns;
 15. fp32 at full width: DMCIConfig() and the performance DMCConfig at
     their default dtype, float32, on phases 4-5's weights, an I-frame and
     FP32_P_FRAMES P-frames of 1088x1920 with packed io, launches per frame
     on the 3xTF32 kernels only (I 42; P 19+5, then 18+5), ms per I- and
     P-frame, peak memory; DMC(DMCConfig()) (plain, raw io) codes a
     P-frame; then phase 8's cross-check with the card in fp32: each frame
     10 dB closer to the CPU's fp32 than the card's bf16 got in phase 8,
     with the flipped round(y) counts printed;
 16. rd-half in bf16: I + RDHALF_P_FRAMES P-frames of 1088x1920 (the CP =
     192 chains, C = 160 and 184 at frame size), launches per frame, ms
     per I- and P-frame;
 17. the RD recipe (experiments/rd_tpu.py): rd-mid, performance, fp32,
     RD_STEPS micro-steps of B=RD_B 64x64 T=4 device_synth clips with the
     recipe's optimizer settings (losses finite, every DepthConvBlock
     gradient finite and nonzero, launches on both fp32 routes (SIMT at C
     <= 64, 3xTF32 at C = 96) and the backward kernels only), ms per
     micro-step, peak memory; then
     make_batched_gop_eval + evaluate_rd_batched over RD_EVAL_CLIPS
     192x192 clips at EVAL_QPS (s per QP) and latent_liveness /
     liveness_collapsed on two of them; then the SIMT fp32 kernels
     (phase 14's C <= 64 route) at each operand shape the last micro-step
     launched them at, against their plain versions (fp32 1e-5) and timed
     beside them and the bound (with --prev-port the other checkout's SIMT
     kernel in turns, prev_ms): their kernels-line entries are these times
     x launches per micro-step; likewise each backward kernel (fp32
     activations) at each shape the last micro-step launched it at
     (ops.dcb_grad.shape_launches), against its plain version, beside it,
     the library call and the bound, with --prev-port in turns with the
     other checkout's (dw_fwd's g equal to its);
 18. coded fp32: VideoCodec at rd-mid in float32, I + 2 P of 192x192,
     every decoded frame and DPB torch.equal to the encoder's;
 19. train CLI: ssgvc_tpu_torch.trainer_seg_video_model.main in a
     temporary working directory (the default YAML written there), on
     Waymo TFRecords written from --seed (CLI_RECORDS records of 1920x1280
     FRONT JPEGs, the Waymo front camera's size, through the port's
     build_frame_proto and write_records) with their mask cache built by
     data.build_cache and a seeded stub segmenter; phase 13's default
     TrainConfig (full profile, bf16-mixed, performance, B=4 128x128 T=4,
     accumulation 8): CLI_EPOCHS epochs of 2 steps, validation every
     CLI_VAL_EVERY steps (twice), save_top_k CLI_TOP_K; every file the JAX
     CLI writes (the CSVs with the JAX headers, the config snapshot,
     checkpoints/last and at most save_top_k step checkpoints, both recon
     panels per validation), every loss and gradient finite, dcb,
     dcb_chain and the four backward kernels launched (counts set to 0
     just before main, read just after); checkpoints/last restored into a
     new Trainer equal to the live state (torch.equal on every parameter
     and optimizer tensor, the step and the ALM scalars) and an eval_step
     from each equal bit for bit on one batch, QP and generator; then the
     CLI again with resume_from_checkpoint=last for 2 more steps. Timed:
     the host time inside next(train_iter) per step (the data path: JPEG
     decode, colour conversion, mask load and crop), CUDA events around
     train_step as in phase 13, and the host time from a step's next() to
     its train_step's end.
 20. image CLI: ssgvc_tpu_torch.trainer_image_model.main in a temporary
     working directory (its default YAML written there: full DMCI,
     bf16-mixed, B=16 256x256) on phase 19's fixture, IMAGE_EPOCHS steps;
     the YAML, the config snapshot, the CSV with the JAX header (every
     logged value finite) and checkpoints/last holding params_i equal to
     the model; every parameter moved from the init; launches per step
     (counts set to 0 just before main, read just after: dcb 42, the chain
     0, each backward kernel 42); checkpoints/last imported through
     load_pretrained (image_checkpoint_path) into a fresh full-profile
     Trainer, its DMCI equal (torch.equal); dcb at every forward shape of
     the step (forward hooks) and each backward kernel at every shape the
     step launched it at (ops.dcb_grad.shape_launches), against their
     plain versions as phases 11-12 hold them (the partials row by row),
     timed beside the plain version, library call and bound, with
     --prev-port the other checkout's in turns; the image loss and its
     DMCI gradient on one batch (B=2, 128x128, QP 32, train=False, the
     same weights) on the card in bf16 against the CPU port in fp32 and
     bf16 (loss within 5e-2, cosine >= XTRAIN_COSINE / XTRAIN_KERNEL_COSINE);
     timed as phase 19: data, train_step, the whole step; peak memory;
 21. scripts: SCRIPT_FRAMES 1920x1280 frames of the fixture written as
     im%05d.png by the port's PNGWriter, then scripts.encode.main with
     phase 19's checkpoints/last (full profile, performance, float32 as
     profile_model_cfgs gives it, QP 32, GOP SCRIPT_GOP: I + 3 P twice) and
     scripts.decode.main on the .bin it wrote: every decoded PNG equal,
     array for array, to the encoder's reconstruction written through
     ycbcr2rgb_np and PNGWriter; the bits per frame equal to the
     container's unit sizes; the kernels' launches per side (3xTF32:
     script_launches); host seconds around each main and ms per frame;
     bpp and PSNR per frame. Then the scripts' default GOP
     (SCRIPT_LONG_GOP = 32) over all SCRIPT_LONG_FRAMES frames of the
     fixture (I + 15 P) from a checkpoint of drawn weights (random_weights,
     the prior heads at 0.01) that the phase writes in the port's format:
     the same checks, and every P-frame's DPB finite on both sides, the
     decoder's DPB feature maxima equal to the encoder's, printed per
     frame;
 22. tools: the graft entry (ssgvc_tpu_torch.graft_entry.entry() with no
     device: its params, args and outputs on the card; ENTRY_LAUNCHES dcb
     / dcb_chain launches per call; ms per call by profiling.timed; and
     debug.cpu_cross_check of its example args, then of drawn weights on
     seeded frames, each gated as phase 8: bpp within 5e-2, frame PSNR >=
     30 dB, every output finite); debug.layer_forensics of the entry's
     model on the card (no module non-finite; the module count and the
     top 5 by norm); profiling.trace around one warm 1088x1920 P-frame of
     phase 5's model, the exported trace's device time split into the
     port's kernels (their launches equal to the counters') and the top
     10 other device ops; profiling.device_memory_stats after phase 5's
     first GOP (its peak equal to phase 5's peak_bytes: both read the
     caching allocator's one peak counter, so this checks only the
     helper's mapping of torch.cuda.memory_stats keys, not a second
     measurement);
 23. parallel: (a) graft_entry.dryrun_multichip(1) on the card (NCCL,
     world 1, one spawned rank): its ok line; (b) the default TrainConfig
     (full, bf16-mixed) on phase 13's batches and weights, P23_STEPS
     micro-steps (one update at the accumulation boundary) twice without a
     process group and once through Trainer(mesh=make_mesh(1)) in an NCCL
     group of 1: bit for bit where the two plain runs are, else within
     their spread; ms per micro-step of each; (c) two ranks sharing cuda:0
     over gloo (NCCL takes no two ranks on one device): the row-sharded
     performance P-frame at full width (bf16, packed io, the main path's
     1088 x 1920 frames handed out in even slabs of 544 rows and worked
     on slabs of whole 64-row units, 576 and 512; phase 5's weights) over
     a GOP of P23_FRAMES carrying the sharded DPB, against the unsharded
     P-frame on the card on the same inputs: per frame the relative
     Frobenius error and max |diff| of the gathered frame and feature (<=
     P23_REL), the bpp's relative difference (<= P23_BPP_REL), each rank's
     launches (those of the unsharded frame, 18 + 5); one frame again in
     fp32 (the 3xTF32 and the SIMT kernels) at tests/test_mesh.py's
     tolerances; then the bf16 frame over 4 and over 8 ranks (P23_WIDE;
     largest slabs 320 and 192 rows); ms per frame, each rank's unit slab,
     the halo bytes and the redistribution bytes (even slabs to units and
     the DPB back) each rank sent and each rank's peak memory above what
     it held before the GOP, beside the unsharded ones, not gated (the
     ranks share one card and the halos cross host memory: not a latency
     result); (e) mask_prop's full-width frame over 2 ranks the same way
     (its predictor resizes across the slabs); (d) two ranks on cuda:0
     over gloo, the full-width
     data-parallel micro-step (accumulation 1, train=False, phase 13's
     cross-check weights) with B=1 a rank against the world-1 step on the
     same B=2 batch: the loss within
     P23_DP_LOSS, the reduced gradient's cosine >= P23_DP_COSINE (fp64
     dots), the parameters equal on both ranks after that update and after
     a train_step whose noise is seeded per rank; that train_step's time
     and the gradient's all-reduce's alone. Any failing rank fails the
     phase;
 24. experiments: the JAX package's opt-in flags on the card. (a) The W8A8
     int8 conv csrc/qconv.cu at every int8 site shape of the full-width
     P-frame (packed io, both feature adaptors) and I-frame, and the
     small-Cin sites of the fast and mask_prop P-frames, recorded from
     their SSGVC_INT8=1 forwards: equal to qconv_plain bit for bit in bf16
     and fp32 with mode 1's and mode 2's scales; timed (bf16) beside the
     plain version, the bf16 route the port takes with int8 off and, at
     the 1x1 sites, quantize + torch._int_mm + dequant (equal to the
     kernel bit for bit), with its bound (int8 products at 1979 TOP/s or
     the bytes, the larger). (b) Phase 5's P-frame GOP (P24_FRAMES
     frames) under mode 2 (scales calibrated on two frames, saved and
     loaded into a fresh model: its frames equal bit for bit), mode 1 and
     mode 2 at scope 3x3 (dcb / dcb_chain 19 + 5 then 18 + 5 a frame),
     each beside the bf16 GOP: ms per frame, qconv launches per frame,
     PSNR against the bf16 recon and bpp, every frame finite and bpp in
     P24_BPP. (c) Phase 10's codec on I + 2 P under mode 2 with scales
     calibrated through the encoder and loaded on both sides: the decoded
     frames equal the encoder's bit for bit. (d) SSGVC_DW=shiftadd in the
     mode-2 P-frame against the grouped conv: every block's dw op on the
     frame's own inputs within REL_TOL, both frames timed. (e) FUSE_DOWN /
     FUSE_UP in phase 6's raw-io P-frame, bf16 and fp32: each patch conv
     on the frame's own inputs within REL_TOL (bf16) or P24_F32_TOL
     (fp32, max relative), both frames timed. The whole frames of (d) and
     (e) are printed, not gated: a bf16 rounding anywhere flips latent
     roundings (experiments/p24_cpu_rehearsal.py, this phase on the CPU at
     the tiny profile, moves the frame 5-8% in relative Frobenius). (f)
     Modes 1 and 2 under the 2-rank row shard of (c): one full-width
     1088 x 1920 frame against the unsharded int8 frame on the card (mode
     1's abs-max the frame's over both slabs; mode 2 on scales calibrated
     unsharded), within P24_SHARD_GATE, qconv's launches on each rank
     those of the unsharded frame. (g) The int8 gradient: the tiny
     profile's int8 micro-step records every qconv call, and each shape
     the backward launched (the int32 sums recomputed from x's int8
     values, unit scales, zero bias, fp32 out) runs against qconv_plain
     bit for bit; then one default-TrainConfig micro-step under
     SSGVC_INT8=1 at full width: finite loss and gradients, ms, peak
     memory, qconv's launches forward and backward, and each recorded
     shape timed (the kernels line's qconv "training", beside its bound:
     each shape's int8 products or bytes, p24_bound, x its launches).
 25. the RD harness (ssgvc_tpu_torch/experiments/) in a temporary working
     directory. (a) rd_tpu.main at rd-half (ch_d 128, enc_dec 184), fp32,
     the committed marathon recipe (--lnorm --recon-skip, B=32 64x64 T=4),
     mega-steps of P25_K micro-steps, sized by P25_TPU's flags, the gate
     after one mega-step (rd_full.GATE_STEP) and each DMCI init probed two
     (rd_tpu.DMCI_PROBE_STEPS): rd_tpu.json with exactly the JAX runner's
     keys, every stored curve finite with bpp > 0 (MS-SSIM at 192 px), the
     BD fields equal to bd_rate / bd_psnr of the stored curves (NaN only
     where the curves' ranges do not overlap), the DMCI
     and both variants' checkpoints restored equal (torch.equal) to the
     params the run kept, launches on the fp32 forward routes and all four
     backward kernels and none in bf16 (counts set to 0 just before main,
     read just after); every fp32 forward kernel (F32_TOL) and every
     backward kernel (BWD_FP32_TOL) at each operand shape of each run's
     last mega-step against its plain version on random inputs, timed;
     ms per mega-step and micro-steps per second of the
     DMCI pretrain and of each variant (host clock: a mega-step ends by
     reading its means), the synchronising calls of one mega-step each
     (torch.cuda.set_sync_debug_mode), s per in-run eval, peak memory. (b)
     rd_eval.main on (a)'s checkpoints at 64 px with the coded check (every
     decoded frame equal to the encoder's), real against estimated bpp.
     (c) rd_continue.main for a few host-data steps (the .prev snapshots),
     then rd_keep_best.main(0) (the .best snapshots equal to live) and
     main(1) on curves DIVERGE_DB lower with live perturbed: live restored
     equal to .best. (d) rd_full.main at rd-mid and rd_demo.main (its
     fixed demo widths, DMCI_MIN_STEPS lowered) on the host data path:
     their JSON with the JAX keys, finite.

The last lines are JSON objects: {"main_path": ...}, {"variants": ...},
{"coded": ...}, {"training": ...}, {"cross_check": ...}, {"fp32": ...},
{"rd_half": ...}, {"rd_recipe": ...}, {"coded_fp32": ...},
{"train_cli": ...}, {"image_cli": ...}, {"scripts": ...}, {"tools": ...},
{"parallel": ...}, {"experiments": ...}, {"rd_harness": ...},
{"kernels": [...]}, and last
{"ok": true, "device":
{"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

import numpy as np

H100_BF16_FLOPS = 989e12     # dense tensor-core peak, H100 SXM data sheet
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores, the same
H100_TF32_FLOPS = 495e12     # dense TF32 tensor cores, the same; 3xTF32
#                              does three products per fp32 one
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
REL_TOL = 1e-2               # kernel vs plain, relative Frobenius error
F32_TOL = 1e-5               # fp32 kernel vs plain, max |d| / max |ref|
H, W = 1088, 1920
QP = 32
GOP_RUNS = 3                 # timed GOPs; ms/frame is their median
PREV_ROUNDS = 8              # --prev-port: rounds of (prev, new, new, prev)
#                              GOPs in phase 5; ms/frame their medians
IFRAME_RUNS = 3              # timed I-frames; ms/frame is their median
GOP_P_FRAMES = 3             # P-frames after the I-frame in phase 7
# the GOP's QP offsets by frame, as the JAX package's CompressionConfig
# default (index_map into DMCConfig.qp_shift)
INDEX_MAP = (0, 1, 0, 2, 0, 2, 0, 2)
DEVICE = "cuda"
VARIANTS = ("plain", "old", "fast", "mask_prop")
VARIANT_P_FRAMES = 3         # P-frames per variant GOP in phase 9
VARIANT_RUNS = 8             # timed GOPs per variant, in turns; ms/frame
#                              the median
CODED_RUNS = 3               # timed coded GOPs; ms per frame the median
MASK_SIGN_TOL = 0.95         # mask_prop: share of predicted-logit signs
#                              the card's bf16 must share with CPU fp32

# (rows, cols, C, shortcut, launches per P-frame, sites)
SINGLE_SHAPES = [
    (136, 240, 256, False, 5, "encoder.conv2_0, mask_sft.conv2_0..2, "
     "decoder.conv_0 (+ feature_adaptor_i after an I-frame)"),
    (136, 240, 320, False, 4, "recon_generation_net.conv_0..3"),
    (68, 120, 128, False, 2, "hyper_encoder.conv_0, hyper_decoder.conv_2"),
    (68, 120, 128, True, 1, "hyper_decoder.conv_1.conv"),
    (34, 60, 128, True, 2, "hyper_encoder.conv_1.conv, "
     "hyper_decoder.conv_0.conv"),
    (17, 30, 128, True, 1, "hyper_encoder.conv_2.conv"),
    (68, 120, 256, True, 1, "temporal_prior_encoder.conv"),
    (68, 120, 384, False, 2, "y_spatial_prior.conv_0..1"),
]
# the I-frame codec's single-block sites: (rows, cols, C, shortcut,
# launches per I-frame, sites); 42 in all, no chain
IFRAME_SHAPES = [
    (136, 240, 368, False, 19, "enc.enc_1 (q), enc.enc_2_0..5, "
     "dec.dec_1_1..12 (q on dec_1_12)"),
    (136, 240, 368, True, 1, "dec.dec_1_0.conv"),
    (136, 240, 192, False, 1, "dec.dec_2"),
    (68, 120, 512, False, 15, "y_prior_fusion_0..2, "
     "y_spatial_prior_adaptor_1..3, y_spatial_prior_0..2 x 3 passes"),
    (68, 120, 256, False, 1, "hyper_dec_2"),
    (68, 120, 128, False, 1, "hyper_enc_0"),
    (68, 120, 128, True, 1, "hyper_dec_1.conv"),
    (34, 60, 128, True, 2, "hyper_enc_1.conv, hyper_dec_0.conv"),
    (17, 30, 128, True, 1, "hyper_enc_2.conv"),
]
IFRAME_LAUNCHES = sum(s[4] for s in IFRAME_SHAPES)
# (rows, cols, C, blocks, q_last, launches per P-frame, sites)
CHAIN_SHAPES = [
    (136, 240, 256, 2, False, 2, "feature_extractor.conv1_0..1, "
     "decoder.conv_1..2"),
    (136, 240, 256, 2, True, 1, "encoder.conv2_1..2 (q_last=quant_step)"),
    (136, 240, 256, 4, False, 1, "feature_extractor.conv2_0..3"),
    (68, 120, 384, 3, False, 1, "y_prior_fusion.conv_0..2"),
]

# Training (phases 11-13): the default TrainConfig's batch, crop and GOP
TRAIN_B, TRAIN_HW, TRAIN_T = 4, 128, 4
TRAIN_STEPS = 10             # micro-steps; accumulation_steps is 8
TRAIN_TIMED = slice(2, 10)   # ms per micro-step: the median of steps 3-10
VAL_BATCHES = 2
BWD_FP32_TOL = 1e-4          # backward kernel vs plain, fp32 outputs
# Training cross-check, gradient cosine limits: the card's bf16 against
# the CPU port's fp32, and against the CPU port's bf16 (plain versions at
# the same rounding points: what differs is the card's kernels and the
# order of their sums)
XTRAIN_COSINE = 0.98
XTRAIN_KERNEL_COSINE = 0.99
# Launches per training micro-step (T=4: the frozen I-frame, then three
# P-frames, the first after the I-frame; per-frame remat runs each
# P-frame's forward twice, and each chain's backward recomputes its
# blocks' inputs with N - 1 single-block launches: 8 per P-frame)
TRAIN_LAUNCHES = {"dcb": IFRAME_LAUNCHES + 2 * (19 + 18 + 18) + 3 * 8,
                  "dcb_chain": 2 * 3 * 5, "dcb_f32": 0, "dcb_chain_f32": 0,
                  "dcb_tf32": 0, "dcb_chain_tf32": 0,
                  "dw_fwd": 94, "gate_bwd": 94, "dw_bwd": 94,
                  "grad_reduce": 94}
# The shapes a micro-step's block backwards give their kernels (B = 4,
# 128x128 crop): (rows, cols, C, q, sites); the launches at each are
# counted in phase 13
BWD_SHAPES = [
    (16, 16, 256, False, "feature_adaptor_i (frame 1), encoder.conv2_0, "
     "mask_sft.conv2_0..2, decoder.conv_0..2, feature_extractor.*, "
     "encoder.conv2_1"),
    (16, 16, 256, True, "encoder.conv2_2 (the chain's last, * q)"),
    (16, 16, 320, False, "recon_generation_net.conv_0..3"),
    (8, 8, 128, False, "hyper_encoder.conv_0, hyper_decoder.conv_1.conv, "
     "hyper_decoder.conv_2"),
    (4, 4, 128, False, "hyper_encoder.conv_1.conv, "
     "hyper_decoder.conv_0.conv"),
    (2, 2, 128, False, "hyper_encoder.conv_2.conv"),
    (8, 8, 256, False, "temporal_prior_encoder.conv"),
    (8, 8, 384, False, "y_spatial_prior.conv_0..1, "
     "y_prior_fusion.conv_0..2"),
]
# Forward shapes of a training micro-step, B = 4: (rows, cols, C,
# shortcut, q) for dcb (the P-frame's, then the I-frame's), (rows, cols,
# C, N, q) for dcb_chain
TRAIN_SINGLE = [(16, 16, 256, False, False), (16, 16, 320, False, False),
                (8, 8, 128, False, False), (8, 8, 128, True, False),
                (4, 4, 128, True, False), (2, 2, 128, True, False),
                (8, 8, 256, True, False), (8, 8, 384, False, False),
                (16, 16, 368, False, True), (16, 16, 368, True, False),
                (16, 16, 192, False, False), (8, 8, 512, False, False),
                (8, 8, 256, False, False)]
TRAIN_CHAIN = [(16, 16, 256, 2, False), (16, 16, 256, 2, True),
               (16, 16, 256, 4, False), (8, 8, 384, 3, False)]


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn over reps launches, by CUDA events. The
    launches are queued behind a torch.cuda._sleep that outlasts their
    enqueueing (twice the host's time for reps calls, measured on the
    warm-up), so the start event fires on a full queue and the card, not
    the host's launch rate, sets the time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / warmup * reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # at most the SM clock's 1.98 GHz: the sleep lasts at least this long
    torch.cuda._sleep(int(min(2 * host_s, 0.5) * 1.98e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_f32(torch, what, out, ref, tol=F32_TOL):
    """Fail unless the fp32 ``out`` is finite and max |out - ref| / max
    |ref| <= ``tol`` (the plain version with TF32 off: main sets both
    flags); returns (that ratio, max abs error)."""
    diff = (out - ref).abs()
    rel = float(diff.max() / ref.abs().max())
    if not torch.isfinite(out).all():
        fail(f"{what}: output not finite")
    if not rel <= tol:
        fail(f"{what} disagrees with plain: max rel {rel:.3g} > {tol}")
    return rel, float(diff.max())


def check_kernel(torch, what, out, ref):
    """The kernel's dtype's check: bf16 relative Frobenius (REL_TOL), fp32
    max relative (F32_TOL)."""
    if out.dtype == torch.float32:
        return check_f32(torch, what, out, ref)
    return check_close(torch, what, out, ref)


def check_close(torch, what, out, ref, tol=REL_TOL):
    """Fail unless ``out`` is finite and within ``tol`` of ``ref`` in
    relative Frobenius error; returns (that error, max abs error)."""
    diff = (out.float() - ref.float())
    rel = float(torch.linalg.vector_norm(diff)
                / torch.linalg.vector_norm(ref.float()))
    if not torch.isfinite(out.float()).all():
        fail(f"{what}: output not finite")
    if not rel <= tol:                  # NaN (a zero reference) fails too
        fail(f"{what} disagrees with plain: rel {rel:.3g} > {tol}")
    return rel, float(diff.abs().max())


def block_params(torch, c, rng, device):
    """Torch-layout fp32 params of one block, lecun-like, small non-zero
    rezero tails (dc_3, ffn_2)."""
    def t(shape, std):
        return torch.tensor(rng.standard_normal(shape) * std,
                            dtype=torch.float32, device=device)
    return (t((c, c, 1, 1), c ** -0.5), t((c,), 0.1),
            t((c, 1, 3, 3), 1 / 3), t((c,), 0.1),
            t((c, c, 1, 1), 0.3 * c ** -0.5), t((c,), 0.1),
            t((4 * c, c, 1, 1), c ** -0.5), t((4 * c,), 0.1),
            t((c, 2 * c, 1, 1), 0.3 * (2 * c) ** -0.5), t((c,), 0.1))


def bound_times(h, w, c, n, f32=False, b=1):
    """(seconds for the block products at the route's peak: bf16 tensor
    cores; for fp32, three TF32 products each on the 3xTF32 route
    (ops.dcb.uses_tf32), fp32 outside the tensor cores on the SIMT one;
    seconds for the bytes at the HBM rate: x read once, y written once, the
    weights read once), at the block's true C (not the width the kernel
    computes it at), for b images."""
    from ssgvc_tpu_torch.ops.dcb import uses_tf32

    flops = n * b * h * w * (16 * c * c + 18 * c)
    size = 4 if f32 else 2
    nbytes = size * (2 * b * h * w * c) + n * size * (8 * c * c + 17 * c)
    if not f32:
        ops_s = flops / H100_BF16_FLOPS
    elif uses_tf32(c):
        ops_s = 3 * flops / H100_TF32_FLOPS
    else:
        ops_s = flops / H100_FP32_FLOPS
    return ops_s, nbytes / H100_BYTES_PER_S


def bound_ms(h, w, c, n, f32=False, b=1) -> float:
    """Least time on an H100 SXM: the larger of :func:`bound_times`."""
    return 1e3 * max(bound_times(h, w, c, n, f32, b))


def bound_by(h, w, c, n, f32=False, b=1) -> str:
    ops, mem = bound_times(h, w, c, n, f32, b)
    return "operations" if ops >= mem else "bytes"


def f32_route(c):
    """(kernel name suffix, launch counter) of the fp32 kernel that takes a
    block of c channels: the 3xTF32 one or the SIMT one."""
    from ssgvc_tpu_torch.ops.dcb import uses_tf32

    return ("_tf32", "launches_tf32") if uses_tf32(c) else \
        ("_f32", "launches_f32")


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        "nvidia-smi unavailable"
    print(card)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device: {name}, count {count}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; host: {os.cpu_count()} CPUs, load "
          f"average {', '.join(f'{x:.2f}' for x in os.getloadavg())}")
    return card, name, count


def phase_build():
    from ssgvc_tpu_torch.ops import _build
    from ssgvc_tpu_torch.ops import dcb as dcb_ops

    t0 = time.time()
    names = ["dcb", "dcb_chain", "dcb_bwd", "dcb_f32", "dcb_tf32", "qconv"]
    logs = _build.build(names)
    print(f"build: {time.time() - t0:.1f} s")
    for name in names:
        # ptxas -v: an entry's properties (stack, spills), then its registers
        entry, spill = "?", ""
        for line in logs[name].splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                entry = m.group(1)
            elif "spill stores" in line:
                spill = line.strip()
            m = re.search(r"Used (\d+) registers", line)
            if m:
                # template flags: dcb [shortcut, padded], dcb_chain [padded]
                c = re.search(r"ILi(\d+)E((?:Lb\dE)*)", entry)
                flags = re.findall(r"Lb(\d)E", c.group(2)) if c else []
                width = "C" if name == "dcb_f32" else "CP"
                what = (f"{width}={c.group(1)}" + (f" [{','.join(flags)}]"
                                                   if flags else "")
                        if c else entry)
                print(f"  [{name}] {what}: {spill}, {m.group(1)} registers")
    print("  [dcb, dcb_chain] dynamic shared memory, any N: " + ", ".join(
        f"CP={c} {dcb_ops.smem_bytes(c)} B"
        for c in dcb_ops.COMPUTED_WIDTHS))
    # the 3xTF32 kernel's plan, as compiled, against ops/dcb.py's mirror
    lib = _build.load("dcb_tf32")
    lib.ssgvc_dcb_tf32_smem.argtypes = [ctypes.c_int]
    lib.ssgvc_dcb_tf32_smem.restype = ctypes.c_int
    plan = {c: lib.ssgvc_dcb_tf32_smem(c)
            for c in dcb_ops.COMPUTED_WIDTHS if dcb_ops.uses_tf32(c)}
    if plan != {c: dcb_ops.tf32_smem_bytes(c) for c in plan}:
        fail(f"dcb_tf32 shared memory {plan} != ops/dcb.py's")
    print("  [dcb_tf32] dynamic shared memory: " + ", ".join(
        f"CP={c} {b} B ({dcb_ops.tf32_slots(c)} slots of "
        f"{dcb_ops.tf32_slot_bytes(c)} B a warpgroup)"
        for c, b in plan.items()))
    # the SIMT kernel's shared memory, unit plans and K split, as compiled
    lib = _build.load("dcb_f32")
    ip = ctypes.POINTER(ctypes.c_int)
    lib.ssgvc_dcb_f32_smem.argtypes = [ctypes.c_int]
    lib.ssgvc_dcb_f32_ksplit.argtypes = [ctypes.c_int]
    lib.ssgvc_dcb_f32_plan.argtypes = [ctypes.c_int] * 3 + [ip]
    widths = range(dcb_ops.WIDTH_STEP, dcb_ops.F32_MAX_CHANNELS + 1,
                   dcb_ops.WIDTH_STEP)
    smem = {c: lib.ssgvc_dcb_f32_smem(c) for c in widths}
    if smem != {c: dcb_ops.f32_smem_bytes(c) for c in widths}:
        fail(f"dcb_f32 shared memory {smem} != ops/dcb.py's")
    if any(lib.ssgvc_dcb_f32_ksplit(c) != dcb_ops.f32_ksplit(c)
           for c in widths):
        fail("dcb_f32 K split != ops/dcb.py's")
    out = (ctypes.c_int * len(dcb_ops.F32Plan._fields))()
    for b, h, w in F32_PLAN_SHAPES:
        lib.ssgvc_dcb_f32_plan(b, h, w, out)
        if tuple(out) != tuple(dcb_ops.f32_plan(b, h, w)):
            fail(f"dcb_f32 plan of {(b, h, w)}: {tuple(out)} != "
                 f"{dcb_ops.f32_plan(b, h, w)}")
    print("  [dcb_f32] dynamic shared memory: " + ", ".join(
        f"C={c} {b} B" for c, b in smem.items()) + f"; unit plans of "
        f"{len(F32_PLAN_SHAPES)} shapes and the K split as ops/dcb.py's")
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    for name in ("dcb", "dcb_chain", "dcb_tf32", "dcb_f32"):
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(_build._lib_path(name))],
                              capture_output=True, text=True,
                              timeout=120).stdout
        hgmma = [ln.split(";")[0].strip() for ln in sass.splitlines()
                 if "HGMMA" in ln]
        print(f"  [{name}] SASS: {len(hgmma)} HGMMA, "
              f"{sass.count('UBLKCP')} UBLKCP (bulk copy), e.g. "
              f"{hgmma[0] if hgmma else 'none'}")
        if "UBLKCP" not in sass or (name != "dcb_f32" and not hgmma):
            fail(f"{name} kernel issues no wgmma or no bulk copy")


def load_prev_port(path):
    """Another checkout's port package, imported as ``prev_port``; its
    kernels build into its own ``_build/``. Returns its layers.blocks
    module."""
    import importlib
    import importlib.util

    root = Path(path).resolve()
    spec = importlib.util.spec_from_file_location(
        "prev_port", root / "__init__.py",
        submodule_search_locations=[str(root)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["prev_port"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("prev_port.layers.blocks")


def prev_modules(torch, prev, c, shortcut, blocks, dtype):
    """The other checkout's DepthConvBlocks (``prev``: its layers.blocks)
    holding these weights, on the card in ``dtype``."""
    mods = [prev.DepthConvBlock(c, shortcut=shortcut, dtype=dtype,
                                device="cuda") for _ in blocks]
    with torch.no_grad():
        for m, params in zip(mods, blocks):
            for dst, src in zip(m.core_params(), params):
                dst.copy_(src)
    return mods


def timed_turns(torch, fns, reps):
    """Mean cuda_ms of each of fns ({"new": fn, "prev": fn}) over the turns
    prev, new, new, prev, and each turn's time."""
    order = ["prev", "new", "new", "prev"] if "prev" in fns else ["new"]
    times = {k: [] for k in fns}
    for k in order:
        times[k].append(cuda_ms(torch, fns[k], reps))
    return {k: sum(v) / len(v) for k, v in times.items()}, times


def phase_kernels(torch, seed, card, prev=None, f32=False):
    """Both kernels at every P-frame and I-frame shape against their plain
    versions, timed: the bf16 wgmma kernels (with N launches of the single
    block beside each chain), or with ``f32`` the fp32 kernels the shapes
    route to, 3xTF32 (csrc/dcb_tf32.cu) at every main-path width (the SIMT
    kernel takes C <= 64 only); --prev-port's kernels in turns in both
    dtypes."""
    from ssgvc_tpu_torch.ops import dcb as dcb_ops
    from ssgvc_tpu_torch.ops import dcb_chain as chain_ops

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    bf16 = torch.bfloat16
    act = torch.float32 if f32 else bf16

    def inputs(h, w, c, n, with_q):
        x = torch.tensor(rng.standard_normal((1, h, w, c)), dtype=act,
                         device=dev)
        q = (torch.linspace(0.5, 1.5, c, device=dev).to(act) if with_q
             else None)
        return x, q, [block_params(torch, c, rng, dev) for _ in range(n)]

    def prev_blocks(c, shortcut, blocks):
        return prev_modules(torch, prev, c, shortcut, blocks, act)

    def in_turns(what, fns, middle, ref, plain, h, w, c, n):
        """Check every variant against ref, then time them in turns:
        (prev,) middle, reversed middle (, prev)."""
        outs = {k: fn() for k, fn in fns.items()}
        torch.cuda.synchronize()
        rel, max_err = check_kernel(torch, f"{what} at {(h, w, c, n)}",
                                    outs["kernel"], ref)
        for k in ("seq", "prev"):
            if k in outs:
                check_kernel(torch, f"{k} at {(h, w, c, n)}", outs[k], ref)
        order = middle + middle[::-1]
        if "prev" in fns:
            order = ["prev"] + order + ["prev"]
        times = {k: [] for k in fns}
        for k in order:
            times[k].append(cuda_ms(torch, fns[k], 20))
        r = {f"{k}_ms": sum(v) / len(v) for k, v in times.items()}
        r.update(plain_ms=cuda_ms(torch, plain, 5),
                 bound_us=1e3 * bound_ms(h, w, c, n, f32), rel_err=rel,
                 max_err=max_err, turns={k: times[k] for k in times})
        return r

    def run_single(h, w, c, shortcut, with_prev):
        x, _, blocks = inputs(h, w, c, 1, False)
        # packed once, outside every timed loop
        packed = dcb_ops.pack_kernel(blocks[0], act)
        middle = ["kernel"]
        if not f32:
            fns = {"kernel": lambda: dcb_ops.dcb_cuda(x, packed, None,
                                                      shortcut)}
        else:       # every main-path width is on the 3xTF32 route
            fns = {"kernel": lambda: dcb_ops.dcb_tf32_cuda(x, packed, None,
                                                           shortcut)}
        if with_prev:
            mod = prev_blocks(c, shortcut, blocks)[0]
            fns["prev"] = lambda: mod(x)
        plain = lambda: dcb_ops.dcb_plain(x, blocks[0], None, shortcut)
        return in_turns("dcb", fns, middle, plain(), plain, h, w, c, 1)

    def run_chain(h, w, c, n, with_q):
        x, q, blocks = inputs(h, w, c, n, with_q)
        # packed once, outside every timed loop
        packed = chain_ops.pack_chain(blocks, act)
        singles = [dcb_ops.pack_block(p, bf16) for p in blocks]
        plain = lambda: chain_ops.dcb_chain_plain(x, blocks, q)
        if f32:
            fns = {"kernel": lambda: chain_ops.dcb_chain_tf32_cuda(x, packed,
                                                                   q)}
            middle = ["kernel"]
            if prev is not None:
                mods = prev_blocks(c, False, blocks)
                fns["prev"] = lambda: prev.run_chain(x, mods, q)
            return in_turns("dcb_chain" + f32_route(c)[0], fns, middle,
                            plain(), plain, h, w, c, n)

        def seq():
            y = x
            for j, pk in enumerate(singles):
                y = dcb_ops.dcb_cuda(y, pk, q if j == n - 1 else None)
            return y

        fns = {"kernel": lambda: chain_ops.dcb_chain_cuda(x, packed, q),
               "seq": seq}
        if prev is not None:
            mods = prev_blocks(c, False, blocks)
            fns["prev"] = lambda: prev.run_chain(x, mods, q)
        return in_turns("dcb_chain", fns, ["kernel", "seq"], plain(), plain,
                        h, w, c, n)

    def sums(rows):
        """Per-shape numbers x launches per frame, summed."""
        return dict(
            ms=sum(r["kernel_ms"] * r["launches_per_frame"] for r in rows),
            plain_ms=sum(r["plain_ms"] * r["launches_per_frame"]
                         for r in rows),
            bound_ms=sum(r["bound_us"] * r["launches_per_frame"]
                         for r in rows) / 1e3,
            max_abs_err=max(r["max_err"] for r in rows))

    entries = []
    # every P- and I-frame width takes the 3xTF32 route in fp32
    sfx, src_single, src_chain = (
        ("_tf32", "ssgvc_tpu_torch/csrc/dcb_tf32.cu",
         "ssgvc_tpu_torch/csrc/dcb_tf32.cu") if f32 else
        ("", "ssgvc_tpu_torch/csrc/dcb.cu",
         "ssgvc_tpu_torch/csrc/dcb_chain.cu"))
    if f32 and not all(dcb_ops.uses_tf32(s[2])
                       for s in SINGLE_SHAPES + IFRAME_SHAPES + CHAIN_SHAPES):
        fail("a main-path width is not on the 3xTF32 route")
    for name, shapes, source, replaces in (
            ("dcb" + sfx, SINGLE_SHAPES + IFRAME_SHAPES, src_single,
             "ssgvc_tpu/ops/pallas_dcb.py:68"),
            ("dcb_chain" + sfx, CHAIN_SHAPES, src_chain,
             "ssgvc_tpu/ops/pallas_dcb_chain.py:61")):
        rows = []
        single = not name.startswith("dcb_chain")
        for k, shape in enumerate(shapes):
            frame = "I" if single and k >= len(SINGLE_SHAPES) else "P"
            if single:
                h, w, c, shortcut, per_frame, sites = shape
                n, with_q = 1, False
                r = run_single(h, w, c, shortcut, prev is not None)
            else:
                h, w, c, n, with_q, per_frame, sites = shape
                shortcut = False
                r = run_chain(h, w, c, n, with_q)
            r.update(shape=[h, w, c], blocks=n, shortcut=shortcut,
                     q=with_q, frame=frame, launches_per_frame=per_frame,
                     sites=sites, share=r["bound_us"] / 1e3 / r["kernel_ms"])
            rows.append(r)
            line = (f"  {name} [{frame}] {h}x{w}x{c} n={n} "
                    f"sc={int(shortcut)} q={int(with_q)}: kernel "
                    f"{r['kernel_ms']:.4f} ms")
            if "seq_ms" in r:
                line += f", seq ({n} x dcb) {r['seq_ms']:.4f} ms"
            if "prev_ms" in r:
                line += f", prev {r['prev_ms']:.4f} ms"
            # derived, not measured: by design every 8x8 tile copies its
            # block's four matrices (8 C^2 bf16) into shared memory once
            if not f32:
                wbytes = math.prod(dcb_ops.tile_grid(h, w)) * n * 16 * c * c
                line += (f", weight bytes copied by design "
                         f"{wbytes / 1e6:.0f} MB / kernel time = "
                         f"{wbytes / r['kernel_ms'] / 1e9:.2f} TB/s "
                         f"(derived)")
            print(line + f", plain {r['plain_ms']:.4f} ms, bound "
                  f"{r['bound_us']:.1f} us (share {r['share']:.3f}), rel "
                  f"{r['rel_err']:.2e}, max abs {r['max_err']:.3g} [{card}]")
        p_rows = [r for r in rows if r["frame"] == "P"]
        i_rows = [r for r in rows if r["frame"] == "I"]
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=None, **sums(p_rows),
            bound_by="operations", library_ms=None,
            per="P-frame: per-shape time x launches per frame, summed; "
                "'iframe' the same per I-frame",
            iframe=dict(launches=None, **(sums(i_rows) if i_rows else {})),
            shapes=rows)
        # the largest error over every shape, of either codec
        entry["max_abs_err"] = max(r["max_err"] for r in rows)
        for k in ("seq_ms", "prev_ms"):
            if p_rows and all(k in r for r in p_rows):
                entry[k] = sum(r[k] * r["launches_per_frame"]
                               for r in p_rows)
            if i_rows and all(k in r for r in i_rows):
                entry["iframe"][k] = sum(r[k] * r["launches_per_frame"]
                                         for r in i_rows)
        entries.append(entry)
    return entries


#: The prior heads that emit (q, scales, means), per codec.
DMC_HEADS = {("y_prior_fusion", "conv_3"), ("y_spatial_prior", "conv_2")}
DMCI_HEADS = {("y_prior_fusion_3",), ("y_spatial_prior_3",)}
#: The training cross-check's: also the recon head, so that with
#: recon_residual the reconstruction is the previous frame plus a small
#: correction, not a random head's output saturating the [0, 1] clamp
TRAIN_HEADS = DMC_HEADS | {("recon_generation_net", "head")}


def random_weights(torch, model, seed, heads=DMC_HEADS):
    """A flax-layout params tree drawn from ``seed``, loaded into ``model``
    through the weight bridge: lecun-normal kernels, the rezero tails
    (dc_3, ffn_2) at 0.1 of that, the two prior heads (module paths in
    ``heads``) that emit (q, scales, means) at 0.01 of it so the prior
    stays O(1) as in a trained codec, near-one per-QP tables, small
    biases."""
    from ssgvc_tpu_torch.utils.weights import (flax_from_state_dict, flatten,
                                               load_flax_params, unflatten)

    rng = np.random.default_rng(seed)
    flat = {}
    for path, tmpl in flatten(flax_from_state_dict(model.state_dict())).items():
        leaf = path[-1]
        if leaf == "kernel":
            std = int(np.prod(tmpl.shape[:-1])) ** -0.5
            if path[-2] in ("dc_3", "ffn_2"):
                std *= 0.1
            if tuple(path[:-1]) in heads:
                std *= 0.01
            arr = rng.standard_normal(tmpl.shape) * std
        elif leaf.startswith("q_") or leaf == "z_gain":
            arr = 1.0 + 0.05 * rng.standard_normal(tmpl.shape)
        else:                                   # biases, Bitparm h/b/a
            arr = 0.01 * rng.standard_normal(tmpl.shape)
        flat[path] = arr.astype(np.float32)
    load_flax_params(model, unflatten(flat))
    return model


def check_frame(torch, what, bpp, frame):
    """bpp finite and > 0, the decoded frame finite in [0, 1]."""
    b = bpp.float().cpu().numpy()
    if not (np.isfinite(b).all() and (b > 0).all()):
        fail(f"{what}: bpp not finite and positive: {b}")
    fr = frame.float()
    if not (torch.isfinite(fr).all() and fr.min() >= 0 and fr.max() <= 1):
        fail(f"{what}: decoded frame not finite in [0, 1]")
    return b


def phase_iframe(torch, seed, card):
    """The I-frame codec at full width on one raw 1088x1920 frame."""
    from ssgvc_tpu_torch.config import DMCIConfig
    from ssgvc_tpu_torch.models.dmci import DMCI
    from ssgvc_tpu_torch.ops import dcb as dcb_ops
    from ssgvc_tpu_torch.ops import dcb_chain as chain_ops

    cfg = DMCIConfig(dtype="bfloat16")
    model = random_weights(torch, DMCI(cfg, device=DEVICE), seed,
                           DMCI_HEADS).eval()
    g = torch.Generator(device=DEVICE).manual_seed(seed + 10)
    x = torch.rand((1, H, W, 3), generator=g, device=DEVICE)
    want = (IFRAME_LAUNCHES, 0)
    runs = []
    with torch.no_grad():
        model(x, QP)                     # warm-up: cuBLAS/cuDNN plans
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in range(IFRAME_RUNS):
            dcb_ops.launches = 0
            chain_ops.launches = 0
            t0 = time.perf_counter()
            out = model(x, QP)
            torch.cuda.synchronize()
            runs.append(1e3 * (time.perf_counter() - t0))
            launches = (dcb_ops.launches, chain_ops.launches)
            if launches != want:
                fail(f"I-frame launches {launches}, expected {want}")
            if k == 0:
                peak = torch.cuda.max_memory_allocated()
    b = check_frame(torch, "I-frame", out["bpp"], out["dpb"]["frame"])
    ms = float(np.median(runs))
    print(f"I-frame: DMCI enc_dec {cfg.enc_dec} N {cfg.N} z {cfg.z_channel} "
          f"bf16 {H}x{W}, {ms:.2f} ms/frame (median of {IFRAME_RUNS}: "
          f"{', '.join(f'{r:.2f}' for r in runs)}; warm-up excluded), peak "
          f"{peak / 2**20:.0f} MiB allocated, launches dcb {launches[0]} "
          f"dcb_chain {launches[1]}, bpp {float(b[0]):.4f} (y "
          f"{float(out['bpp_y'][0]):.4f}, z {float(out['bpp_z'][0]):.4f}) "
          f"[{card}]")
    # on the host, so that the P-frame phase's peak memory is its own
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return dict(launches=launches, ms_per_frame=ms, ms_runs=runs,
                peak_bytes=peak, bpp=float(b[0]), frame=out["dpb"]["frame"],
                state=state)


def phase_main_path(torch, seed, frames_n, card, dpb_frame, prev=None):
    """The performance-variant GOP; with ``prev`` (another checkout's
    port) also that checkout's DMC on the same weights, timed in turns
    with this one's (prev, new, new, prev)."""
    from ssgvc_tpu_torch.config import DMCConfig
    from ssgvc_tpu_torch.utils.profiling import device_memory_stats
    from ssgvc_tpu_torch.models.dmc import DMC
    from ssgvc_tpu_torch.ops import dcb as dcb_ops
    from ssgvc_tpu_torch.ops import dcb_chain as chain_ops
    from ssgvc_tpu_torch.ops.pixel import pixel_unshuffle

    cfg = DMCConfig.variant("performance", dtype="bfloat16", packed_io=True)
    model = random_weights(torch, DMC(cfg, device=DEVICE), seed).eval()
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    bf16 = torch.bfloat16
    frames = torch.rand((frames_n, 1, H, W, 3), generator=g, device=DEVICE
                        ).to(bf16)
    masks = (torch.rand((frames_n, 1, H, W, 1), generator=g, device=DEVICE)
             > 0.8).to(bf16)
    # the DPB after an I-frame: its decoded frame and a zero feature
    dpb_frame = dpb_frame.to(bf16)
    dpb_feature = torch.zeros((1, H // 8, W // 8, cfg.ch_d), dtype=bf16,
                              device=DEVICE)

    def gop(count_check, m=model):
        """The packed-io GOP loop; ingest (one unshuffle of the GOP)
        counted."""
        fp = pixel_unshuffle(frames.reshape(frames_n, H, W, 3), 8)
        mp = pixel_unshuffle(masks.reshape(frames_n, H, W, 1), 8)
        dpb = {"frame": pixel_unshuffle(dpb_frame, 8), "feature": dpb_feature}
        bpps, outs = [], []
        for i in range(frames_n):
            before = (dcb_ops.launches, chain_ops.launches)
            out = m(fp[i:i + 1], QP, dpb, after_i=(i == 0),
                    mask=mp[i:i + 1])
            dpb = out["dpb"]
            bpps.append(out["bpp"])
            if i < 3:
                outs.append(dpb["frame"])
            if count_check:
                got = (dcb_ops.launches - before[0],
                       chain_ops.launches - before[1])
                want = (19 if i == 0 else 18, 5)
                if got != want:
                    fail(f"frame {i}: launches {got}, expected {want}")
        return torch.cat(bpps), outs, dpb

    def timed(m=model, count_check=False):
        """(ms/frame, ms/frame until the host had queued the whole GOP)."""
        t0 = time.perf_counter()
        res = gop(count_check, m)
        t_queued = time.perf_counter()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        return (1e3 * (t1 - t0) / frames_n, 1e3 * (t_queued - t0) / frames_n,
                res)

    want = (18 * frames_n + 1, 5 * frames_n)
    runs, queued = [], []
    with torch.no_grad():
        gop(False)                       # warm-up: cuBLAS/cuDNN plans
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the host clock varies from run to run: time the GOP a few times,
        # each with the counts set to 0 just before it and read just after;
        # peak memory is the first run's, before any run's outputs linger
        for k in range(GOP_RUNS):
            dcb_ops.launches = 0
            chain_ops.launches = 0
            ms, q_ms, (bpps, outs, dpb) = timed(count_check=True)
            runs.append(ms)
            queued.append(q_ms)
            launches = (dcb_ops.launches, chain_ops.launches)
            if launches != want:
                fail(f"GOP launches {launches}, expected {want}")
            if k == 0:
                peak = torch.cuda.max_memory_allocated()
                # the same allocator counter under another key: this holds
                # the helper's key mapping, it measures nothing anew
                memory = device_memory_stats()
                if memory["cuda:0"]["peak_bytes_in_use"] != peak:
                    fail(f"device_memory_stats {memory} disagrees with "
                         f"max_memory_allocated {peak}")
    b = check_frame(torch, "main path", bpps, dpb["frame"])
    if not torch.isfinite(dpb["feature"].float()).all():
        fail("DPB feature not finite")
    ms = float(np.median(runs))
    print(f"main path: {frames_n} P-frames {H}x{W}, {ms:.2f} ms/frame "
          f"({1e3 / ms:.2f} fps; median of {GOP_RUNS} GOPs: "
          f"{', '.join(f'{r:.2f}' for r in runs)}; ingest included, warm-up "
          f"excluded; the host had queued each GOP after "
          f"{', '.join(f'{r:.2f}' for r in queued)} ms/frame), peak "
          f"{peak / 2**20:.0f} MiB allocated, launches dcb {launches[0]} "
          f"dcb_chain {launches[1]}, bpp {np.round(b, 4).tolist()} [{card}]")
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    result = dict(launches=launches, ms_per_frame=ms, ms_runs=runs,
                  queued_ms_runs=queued, peak_bytes=peak,
                  memory_stats=memory, bpps=b, outs=outs,
                  state=state, frames=frames[:3], masks=masks[:3],
                  dpb_frame=dpb_frame)
    if prev is not None:
        import importlib

        prev_cfg = importlib.import_module("prev_port.config")
        prev_dmc = importlib.import_module("prev_port.models.dmc")
        other = prev_dmc.DMC(prev_cfg.DMCConfig.variant(
            "performance", dtype="bfloat16", packed_io=True), device=DEVICE)
        other.load_state_dict(model.state_dict(), strict=True)
        other.eval()
        turns = {"prev": [], "new": []}
        with torch.no_grad():
            gop(False, other)            # warm-up
            for _ in range(PREV_ROUNDS):
                for who in ("prev", "new", "new", "prev"):
                    turns[who].append(
                        timed(other if who == "prev" else model)[0])
        result["turns"] = {k: dict(ms_per_frame=float(np.median(v)),
                                   ms_runs=v) for k, v in turns.items()}
        new_ms, prev_ms = (result["turns"][k]["ms_per_frame"]
                           for k in ("new", "prev"))
        print(f"main path in turns with the other checkout's DMC (prev, new,"
              f" new, prev) x {PREV_ROUNDS}: new {new_ms:.2f} ms/frame, prev "
              f"{prev_ms:.2f} ({100 * (new_ms / prev_ms - 1):+.1f}%) "
              f"[{card}]")
    return result


def phase_streaming(torch, main):
    from ssgvc_tpu_torch.config import DMCConfig
    from ssgvc_tpu_torch.models.dmc import DMC
    from ssgvc_tpu_torch.models.inference_api import StreamingDMC
    from ssgvc_tpu_torch.ops.pixel import pixel_shuffle

    cfg = DMCConfig.variant("performance", dtype="bfloat16", packed_io=False)
    model = DMC(cfg, device=DEVICE)
    model.load_state_dict(main["state"], strict=True)
    stream = StreamingDMC(model.eval())
    packed = stream.init_dpb(main["dpb_frame"])
    worst_bpp, worst_px = 0.0, 0.0
    for i in range(3):
        packed, bpp = stream.step(main["frames"][i], main["masks"][i], QP,
                                  packed, after_i=(i == 0))
        ref_bpp = float(main["bpps"][i])
        rel = abs(float(bpp.float()) - ref_bpp) / ref_bpp
        px = float((stream.unpack_frame(packed).float()
                    - pixel_shuffle(main["outs"][i], 8).float()).abs().max())
        worst_bpp, worst_px = max(worst_bpp, rel), max(worst_px, px)
    # the 8x8 patching is a permutation: the same ops on the same values,
    # so only bf16 rounding of equal sums taken in another order can differ
    print(f"streaming: 3 frames raw io vs packed GOP: bpp rel {worst_bpp:.2e}"
          f" (tol 1e-3), frame max abs {worst_px:.3g} (tol 2^-6)")
    if worst_bpp > 1e-3 or worst_px > 2 ** -6:
        fail("streaming (raw io) disagrees with the packed-io GOP")


def phase_gop(torch, seed, iframe, main, card):
    """evaluate_gop_estimated on the card: the I-frame codec, then the
    raw-io P-frame codec, launches counted per frame."""
    from ssgvc_tpu_torch.config import DMCConfig, DMCIConfig
    from ssgvc_tpu_torch.models.dmc import DMC
    from ssgvc_tpu_torch.models.dmci import DMCI
    from ssgvc_tpu_torch.ops import dcb as dcb_ops
    from ssgvc_tpu_torch.ops import dcb_chain as chain_ops
    from ssgvc_tpu_torch.training.evaluate import evaluate_gop_estimated

    dmci = DMCI(DMCIConfig(dtype="bfloat16"), device=DEVICE)
    dmci.load_state_dict(iframe["state"], strict=True)
    cfg = DMCConfig.variant("performance", dtype="bfloat16", packed_io=False)
    dmc = DMC(cfg, device=DEVICE)
    dmc.load_state_dict(main["state"], strict=True)
    counts, start = [], []

    def before(module, args):
        start[:] = (dcb_ops.launches, chain_ops.launches)

    def after(module, args, out):
        counts.append((dcb_ops.launches - start[0],
                       chain_ops.launches - start[1]))

    for m in (dmci, dmc):
        m.eval()
        m.register_forward_pre_hook(before)
        m.register_forward_hook(after)
    rng = np.random.default_rng(seed + 2)
    t_len = 1 + GOP_P_FRAMES
    frames = rng.uniform(0, 1, (t_len, H, W, 3)).astype(np.float32)
    masks = (rng.uniform(0, 1, (t_len, H, W, 1)) > 0.8).astype(np.float32)
    dcb_ops.launches = 0
    chain_ops.launches = 0
    results = evaluate_gop_estimated(dmci, dmc, frames, masks, QP,
                                     index_map=INDEX_MAP,
                                     qp_shift=cfg.qp_shift)
    launches = (dcb_ops.launches, chain_ops.launches)
    want = ([(IFRAME_LAUNCHES, 0), (19, 5)]
            + [(18, 5)] * (GOP_P_FRAMES - 1))
    if counts != want:
        fail(f"GOP launches per frame {counts}, expected {want}")
    total = tuple(map(sum, zip(*want)))
    if launches != total:
        fail(f"GOP launches {launches}, expected {total}")
    for t, r in enumerate(results):
        vals = [r["bpp"], r["psnr"], r["roi_psnr"], r["msssim"]]
        if not (np.isfinite(vals).all() and r["bpp"] > 0):
            fail(f"GOP frame {t}: metrics not finite or bpp <= 0: {r}")
        print(f"GOP frame {t} ({r['frame_type']}, launches dcb "
              f"{counts[t][0]} dcb_chain {counts[t][1]}): bpp "
              f"{r['bpp']:.4f}, PSNR {r['psnr']:.2f} dB, ROI-PSNR "
              f"{r['roi_psnr']:.2f} dB, MS-SSIM {r['msssim']:.4f} "
              f"(random weights: a run check) [{card}]")
    return dict(launches=launches, per_frame=counts, results=results)


def phase_cross_check(torch, main, iframe, seed, card_dtype="bfloat16",
                      floors=None):
    """Both codecs' weights at 128x128 through the CPU port in fp32 and the
    card in ``card_dtype``. In bf16 (phase 8) the bf16 tolerances hold;
    with ``floors`` (phase 15, fp32 on the card) each frame's PSNR to the
    CPU's must reach its floor. Returns the PSNRs, bpps and the flipped
    round(y) counts of both codecs' latents."""
    from ssgvc_tpu_torch.config import DMCConfig, DMCIConfig
    from ssgvc_tpu_torch.models.dmc import DMC
    from ssgvc_tpu_torch.models.dmci import DMCI

    rng = np.random.default_rng(seed + 1)
    hw = 128
    x = rng.uniform(0, 1, (1, hw // 8, hw // 8, 192)).astype(np.float32)
    mask = (rng.uniform(0, 1, (1, hw // 8, hw // 8, 64)) > 0.8
            ).astype(np.float32)
    frame = rng.uniform(0, 1, (1, hw // 8, hw // 8, 192)).astype(np.float32)
    feature = (rng.standard_normal((1, hw // 8, hw // 8, 256)) * 0.1
               ).astype(np.float32)
    label = "bf16" if card_dtype == "bfloat16" else "fp32"
    results, ys = [], []          # [CPU fp32, card]
    for dev, dtype in (("cpu", "float32"), (DEVICE, card_dtype)):
        cfg = DMCConfig.variant("performance", dtype=dtype, packed_io=True)
        model = DMC(cfg, device=dev)
        model.load_state_dict(main["state"], strict=True)
        y_taps = []
        ys.append(y_taps)
        model.encoder.register_forward_hook(
            lambda m, a, out, t=y_taps: t.append(out.float().cpu()))
        cast = lambda a: torch.from_numpy(a).to(dev, model.dtype)
        outs = []
        dpb = {"frame": cast(frame), "feature": cast(feature)}
        with torch.no_grad():
            for after_i in (True, False):
                out = model(cast(x), QP, dpb, after_i=after_i,
                            mask=cast(mask))
                outs.append((float(out["bpp"].float()),
                             out["dpb"]["frame"].float().cpu()))
        results.append(outs)
    r = {"p_psnr": [], "p_flips": []}
    for i, ((b_cpu, f_cpu), (b_gpu, f_gpu)) in enumerate(zip(*results)):
        flips = int((torch.round(ys[0][i]) != torch.round(ys[1][i])).sum())
        what = f"P-frame after_i={i == 0}"
        psnr = cross_check_pair(
            what, b_cpu, f_cpu, b_gpu, f_gpu, label=label,
            psnr_tol=30.0 if floors is None else floors["p"][i],
            extra=f", flipped round(y) {flips} of {ys[0][i].numel()}")
        r["p_psnr"].append(psnr)
        r["p_flips"].append(flips)

    # The I-frame codec: end to end, then its analysis (the latent y) and
    # its synthesis alone on the fp32 run's y_hat. Its 4-pass prior chains
    # the quantizer's round() decisions: bf16 flips ~0.5% of them (CPU
    # plain versions in bf16 against fp32, 128x128), each a whole step
    # that the random 13-block decoder spreads over a 16x16 patch, so the
    # frames end to end agree at ~22 dB, and the tolerance there is 18 dB;
    # the decoder alone on the same y_hat agreed at 43 dB and is held at
    # 30 dB like the P-frame codec.
    xi = rng.uniform(0, 1, (1, hw, hw, 3)).astype(np.float32)
    results, taps = [], []
    for dev, dtype in (("cpu", "float32"), (DEVICE, card_dtype)):
        model = DMCI(DMCIConfig(dtype=dtype), device=dev)
        model.load_state_dict(iframe["state"], strict=True)
        tap = {"model": model}
        taps.append(tap)
        model.enc.register_forward_hook(
            lambda m, a, out, tap=tap: tap.__setitem__("y", out.float().cpu()))
        model.dec.register_forward_pre_hook(
            lambda m, a, tap=tap: tap.__setitem__("dec_in", a))
        with torch.no_grad():
            out = model(torch.from_numpy(xi).to(dev), QP)
        results.append((float(out["bpp"].float()),
                        out["dpb"]["frame"].float().cpu()))
    y32, yc = taps[0]["y"], taps[1]["y"]
    flips = int((torch.round(y32) != torch.round(yc)).sum())
    r["i_psnr"] = cross_check_pair(
        "I-frame", *results[0], *results[1], label=label,
        psnr_tol=18.0 if floors is None else floors["i"],
        extra=f", flipped round(y) {flips} of {y32.numel()}")
    r["i_flips"] = flips
    rel_y = float(torch.linalg.vector_norm(yc - y32)
                  / torch.linalg.vector_norm(y32))
    y_hat, q_dec = taps[0]["dec_in"]
    mc = taps[1]["model"]
    with torch.no_grad():
        fc = torch.clamp(mc.dec(y_hat.to(DEVICE, mc.dtype),
                                q_dec.to(DEVICE, mc.dtype)), 0.0, 1.0)
    mse = float(((fc.float().cpu() - results[0][1]) ** 2).mean())
    psnr = 10 * math.log10(1.0 / max(mse, 1e-20))
    r.update(i_rel_y=rel_y, i_dec_psnr=psnr)
    print(f"cross-check I-frame parts 128x128 (card {label}): latent y rel "
          f"{rel_y:.2e} (tol 2e-2); decoder alone on the fp32 run's y_hat, "
          f"frame PSNR {psnr:.1f} dB (tol >= 30)")
    if rel_y > 2e-2 or psnr < 30:
        fail(f"I-frame: card {label} and CPU fp32 disagree beyond the "
             "tolerance in the analysis or the synthesis")
    return r


def cross_check_pair(what, b_cpu, f_cpu, b_gpu, f_gpu, psnr_tol=30.0,
                     label="bf16", extra="", hw="128x128", cpu="fp32"):
    """bpp within 5e-2 relative and the frames within ``psnr_tol`` dB of
    each other, the CPU (in ``cpu``) against the card; returns the
    PSNR."""
    rel = abs(b_gpu - b_cpu) / b_cpu
    mse = float(((f_gpu - f_cpu) ** 2).mean())
    psnr = 10 * math.log10(1.0 / max(mse, 1e-20))
    print(f"cross-check {what} {hw}: bpp cpu-{cpu} {b_cpu:.5f} "
          f"card-{label} {b_gpu:.5f} (rel {rel:.2e}, tol 5e-2), frame PSNR "
          f"between them {psnr:.1f} dB (tol >= {psnr_tol:g}){extra}")
    # bf16 rounds activations to 8 bits of mantissa and flips some
    # round() decisions of the quantizer, so the two agree only loosely
    if rel > 5e-2 or psnr < psnr_tol:
        fail(f"{what}: card {label} and CPU {cpu} disagree beyond the "
             "tolerance")
    return psnr


def phase_variants(torch, seed, card, iframe, main):
    """The other P-frame variants at full width on a short packed-io GOP
    from the decoded I-frame, beside the performance variant on the same
    GOP; launches counted per frame, GOPs timed."""
    from ssgvc_tpu_torch.config import DMCConfig
    from ssgvc_tpu_torch.models.dmc import DMC
    from ssgvc_tpu_torch.ops import dcb as dcb_ops
    from ssgvc_tpu_torch.ops import dcb_chain as chain_ops
    from ssgvc_tpu_torch.ops.pixel import pixel_unshuffle

    bf16 = torch.bfloat16
    n = VARIANT_P_FRAMES
    g = torch.Generator(device=DEVICE).manual_seed(seed + 20)
    frames = pixel_unshuffle(torch.rand((n, H, W, 3), generator=g,
                                        device=DEVICE), 8).to(bf16)
    masks = pixel_unshuffle((torch.rand((n, H, W, 1), generator=g,
                                        device=DEVICE) > 0.8).float(),
                            8).to(bf16)
    dpb0 = {"frame": pixel_unshuffle(iframe["frame"].to(bf16), 8),
            "feature": torch.zeros((1, H // 8, W // 8, 256), dtype=bf16,
                                   device=DEVICE)}
    names = ("performance",) + VARIANTS
    models, cfgs = {}, {}
    for variant in names:
        cfg = cfgs[variant] = DMCConfig.variant(variant, dtype="bfloat16",
                                                packed_io=True)
        model = DMC(cfg, device=DEVICE)
        if variant == "performance":
            model.load_state_dict(main["state"], strict=True)
        else:
            random_weights(torch, model, seed)
        models[variant] = model.eval()

    def gop(variant):
        """The GOP; a propagated mask chain takes the GT mask at the first
        P-frame only, as evaluate_gop_estimated does."""
        model, cfg = models[variant], cfgs[variant]
        dpb, carry, counts, bpps = dpb0, None, [], []
        for i in range(n):
            m = carry if carry is not None else masks[i:i + 1]
            before = (dcb_ops.launches, chain_ops.launches)
            out = model(frames[i:i + 1], QP, dpb, after_i=(i == 0), mask=m)
            counts.append((dcb_ops.launches - before[0],
                           chain_ops.launches - before[1]))
            if cfg.mask_source == "propagated":
                carry = m if i == 0 else out["mask_pred"]
            dpb = out["dpb"]
            bpps.append(out["bpp"])
        return counts, torch.cat(bpps), dpb

    runs = {v: [] for v in names}
    queued = {v: [] for v in names}
    last = {}
    with torch.no_grad():
        for variant in names:
            gop(variant)                 # warm-up: cuBLAS/cuDNN plans
        torch.cuda.synchronize()
        # in turns, the order reversed every round, so that a drift of the
        # shared host's load falls on every variant alike
        for r in range(VARIANT_RUNS):
            for variant in (names if r % 2 == 0 else names[::-1]):
                sft = 3 if cfgs[variant].mask_mode == "sft_latent" else 0
                want = [(16 + sft if i == 0 else 15 + sft, 5)
                        for i in range(n)]
                dcb_ops.launches = 0
                chain_ops.launches = 0
                t0 = time.perf_counter()
                counts, bpps, dpb = gop(variant)
                t_queued = time.perf_counter()
                torch.cuda.synchronize()
                runs[variant].append(1e3 * (time.perf_counter() - t0) / n)
                queued[variant].append(1e3 * (t_queued - t0) / n)
                launches = (dcb_ops.launches, chain_ops.launches)
                if counts != want or launches != tuple(map(sum,
                                                           zip(*want))):
                    fail(f"variant {variant}: launches per frame {counts} "
                         f"(total {launches}), expected {want}")
                last[variant] = (counts, launches, bpps, dpb)
    results, states = {}, {}
    for variant in names:
        counts, launches, bpps, dpb = last[variant]
        b = check_frame(torch, f"variant {variant}", bpps, dpb["frame"])
        results[variant] = dict(ms_per_frame=float(np.median(runs[variant])),
                                ms_runs=runs[variant],
                                queued_ms_runs=queued[variant],
                                launches_per_frame=counts,
                                launches=launches, bpp=b.tolist())
        if variant != "performance":
            states[variant] = {k: v.detach().cpu() for k, v
                               in models[variant].state_dict().items()}
    del models
    perf = results["performance"]["ms_per_frame"]
    for variant, r in results.items():
        r["vs_performance"] = r["ms_per_frame"] / perf
        print(f"variant {variant}: {n} P-frames {H}x{W} packed io bf16, "
              f"{r['ms_per_frame']:.2f} ms/frame (median of {VARIANT_RUNS} "
              f"in turns: {', '.join(f'{x:.2f}' for x in r['ms_runs'])}; "
              f"queued by the host after "
              f"{', '.join(f'{x:.2f}' for x in r['queued_ms_runs'])}), "
              f"{r['vs_performance']:.3f} x performance's "
              f"{perf:.2f}, launches per frame {r['launches_per_frame']}, "
              f"bpp {np.round(r['bpp'], 4).tolist()} [{card}]")
    return results, states


def phase_variants_cross_check(torch, states, seed):
    """Each variant's weights at 128x128 through the CPU port in fp32 and
    the card in bf16, both after_i values; mask_prop also the signs of its
    predicted mask logits."""
    from ssgvc_tpu_torch.config import DMCConfig
    from ssgvc_tpu_torch.models.dmc import DMC

    rng = np.random.default_rng(seed + 3)
    hw = 128
    x = rng.uniform(0, 1, (1, hw // 8, hw // 8, 192)).astype(np.float32)
    mask = (rng.uniform(0, 1, (1, hw // 8, hw // 8, 64)) > 0.8
            ).astype(np.float32)
    frame = rng.uniform(0, 1, (1, hw // 8, hw // 8, 192)).astype(np.float32)
    feature = (rng.standard_normal((1, hw // 8, hw // 8, 256)) * 0.1
               ).astype(np.float32)
    signs = {}
    for variant, state in states.items():
        results = {}
        for dev, dtype in (("cpu", "float32"), (DEVICE, "bfloat16")):
            model = DMC(DMCConfig.variant(variant, dtype=dtype,
                                          packed_io=True), device=dev)
            model.load_state_dict(state, strict=True)
            model.eval()
            cast = lambda a: torch.from_numpy(a).to(dev, model.dtype)
            dpb = {"frame": cast(frame), "feature": cast(feature)}
            outs = []
            with torch.no_grad():
                for after_i in (True, False):
                    out = model(cast(x), QP, dpb, after_i=after_i,
                                mask=cast(mask))
                    pred = out["mask_pred"]
                    outs.append((float(out["bpp"].float()),
                                 out["dpb"]["frame"].float().cpu(),
                                 None if pred is None else
                                 pred.float().cpu()))
            results[dtype] = outs
        for i, (cpu, card) in enumerate(zip(results["float32"],
                                            results["bfloat16"])):
            what = f"{variant} after_i={i == 0}"
            cross_check_pair(what, cpu[0], cpu[1], card[0], card[1])
            if cpu[2] is not None:
                agree = float((torch.sign(cpu[2]) == torch.sign(card[2])
                               ).float().mean())
                signs[what] = agree
                print(f"cross-check {what}: predicted mask logits share "
                      f"their sign in {agree:.4f} of pixels (tol >= "
                      f"{MASK_SIGN_TOL})")
                if agree < MASK_SIGN_TOL:
                    fail(f"{what}: the card's predicted mask disagrees in "
                         "sign with CPU fp32")
    return signs


def phase_coded(torch, seed, card, iframe, main, gop, mask_prop_state):
    """The real coder: VideoCodec on phase 7's frames, encoded and then
    decoded from the streams alone, then a mask_prop CodingSession."""
    import io

    from ssgvc_tpu_torch.coding.codec import VideoCodec
    from ssgvc_tpu_torch.coding.session import CodingSession
    from ssgvc_tpu_torch.config import DMCConfig, DMCIConfig
    from ssgvc_tpu_torch.models.dmc import DMC
    from ssgvc_tpu_torch.models.dmci import DMCI
    from ssgvc_tpu_torch.ops import dcb as dcb_ops
    from ssgvc_tpu_torch.ops import dcb_chain as chain_ops

    dmci = DMCI(DMCIConfig(dtype="bfloat16"), device=DEVICE)
    dmci.load_state_dict(iframe["state"], strict=True)
    cfg = DMCConfig.variant("performance", dtype="bfloat16")
    dmc = DMC(cfg, device=DEVICE)
    dmc.load_state_dict(main["state"], strict=True)
    t0 = time.perf_counter()
    codec = VideoCodec(dmci.eval(), dmc.eval(), packed_dmc=True)
    setup_s = time.perf_counter() - t0
    # phase 7's frames, masks and QPs, so its estimated bpp compares
    rng = np.random.default_rng(seed + 2)
    t_len = 1 + GOP_P_FRAMES
    frames = rng.uniform(0, 1, (t_len, H, W, 3)).astype(np.float32)
    masks = (rng.uniform(0, 1, (t_len, H, W, 1)) > 0.8).astype(np.float32)
    qps = [QP] + [dmc.shift_qp(QP, INDEX_MAP[t % len(INDEX_MAP)])
                  for t in range(1, t_len)]
    dev = lambda a: torch.from_numpy(a)[None].to(DEVICE)
    feat0 = torch.zeros((1, H // 8, W // 8, cfg.ch_d), dtype=torch.bfloat16,
                        device=DEVICE)
    want_enc = [(IFRAME_LAUNCHES, 0), (19, 5)] + [(18, 5)] * (t_len - 2)
    want_dec = [(IFRAME_LAUNCHES - 10, 0), (12, 4)] + [(11, 4)] * (t_len - 2)

    def counted(fn, *args, **kw):
        before = (dcb_ops.launches, chain_ops.launches)
        out = fn(*args, **kw)
        return out, (dcb_ops.launches - before[0],
                     chain_ops.launches - before[1])

    def row(out, launches, side):
        t = codec.enc_time if side == "enc" else codec.dec_time
        r = codec.enc_rans_time if side == "enc" else codec.dec_rans_time
        return dict(out=out, launches=launches, ms=1e3 * t, rans_ms=1e3 * r)

    def run():
        enc, dec = [], []
        out, n = counted(codec.dmci_compress, dev(frames[0]), qps[0])
        enc.append(row(out, n, "enc"))
        dpb = {"frame": out["x_hat"], "feature": feat0}
        for t in range(1, t_len):
            out, n = counted(codec.dmc_compress, dev(frames[t]), qps[t],
                             dpb, after_i=(t == 1), mask=dev(masks[t]))
            enc.append(row(out, n, "enc"))
            dpb = out["dpb"]
        out, n = counted(codec.dmci_decompress, enc[0]["out"]["bit_stream"],
                         H, W, qps[0])
        dec.append(row(out, n, "dec"))
        dpb = {"frame": out["x_hat"], "feature": feat0}
        for t in range(1, t_len):
            out, n = counted(codec.dmc_decompress,
                             enc[t]["out"]["bit_stream"], H, W, qps[t], dpb,
                             after_i=(t == 1))
            dec.append(row(out, n, "dec"))
            dpb = out["dpb"]
        for t, (e, d) in enumerate(zip(enc, dec)):
            same = torch.equal(e["out"]["x_hat"], d["out"]["x_hat"])
            for k in ("frame", "feature"):
                a, b = e["out"]["dpb"][k], d["out"]["dpb"][k]
                same &= (a is None and b is None) or torch.equal(a, b)
            if not same:
                fail(f"coded frame {t}: the decoder's frame or DPB differs "
                     "from the encoder's")
        if [e["launches"] for e in enc] != want_enc or \
                [d["launches"] for d in dec] != want_dec:
            fail(f"coded GOP launches: encoder "
                 f"{[e['launches'] for e in enc]} (expected {want_enc}), "
                 f"decoder {[d['launches'] for d in dec]} (expected "
                 f"{want_dec})")
        return enc, dec

    run()                                # warm-up, checked the same way
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for k in range(CODED_RUNS):
        dcb_ops.launches = 0
        chain_ops.launches = 0
        enc, dec = run()
        launches = (dcb_ops.launches, chain_ops.launches)
        total = tuple(map(sum, zip(*(want_enc + want_dec))))
        if launches != total:
            fail(f"coded GOP launches {launches}, expected {total}")
        if k == 0:
            peak = torch.cuda.max_memory_allocated()
        for r in enc + dec:              # keep the stream and the frame
            r["out"] = {"bit_stream": r["out"].get("bit_stream"),
                        "x_hat": r["out"]["x_hat"]}
        if runs and [e["out"]["bit_stream"] for e in enc] != \
                [e["out"]["bit_stream"] for e in runs[0]["enc"]]:
            fail("coded GOP: the same frames gave other streams in another "
                 "run")
        runs.append({"enc": enc, "dec": dec})

    def med(side, t, key):
        """Frame t's median over the timed GOPs."""
        return float(np.median([r[side][t][key] for r in runs]))

    frames_out = []
    for t, (e, d) in enumerate(zip(enc, dec)):
        nbytes = len(e["out"]["bit_stream"])
        real = nbytes * 8 / (H * W)
        est = gop["results"][t]["bpp"]
        check_frame(torch, f"coded frame {t}", torch.tensor([real]),
                    d["out"]["x_hat"])
        frames_out.append(dict(
            type="I" if t == 0 else "P", qp=qps[t], bytes=nbytes,
            bpp_real=real, bpp_estimated=est, enc_launches=e["launches"],
            dec_launches=d["launches"], enc_ms=med("enc", t, "ms"),
            enc_rans_ms=med("enc", t, "rans_ms"), dec_ms=med("dec", t, "ms"),
            dec_rans_ms=med("dec", t, "rans_ms"),
            enc_ms_runs=[r["enc"][t]["ms"] for r in runs],
            dec_ms_runs=[r["dec"][t]["ms"] for r in runs]))
        f = frames_out[-1]
        print(f"coded frame {t} ({f['type']}, QP {f['qp']}): {nbytes} bytes"
              f", real bpp {real:.4f} (phase 7 estimated {est:.4f}, ratio "
              f"{real / est:.3f}); median of {CODED_RUNS} GOPs: encode "
              f"{f['enc_ms']:.2f} ms (host rANS "
              f"{f['enc_rans_ms']:.2f}), decode {f['dec_ms']:.2f} ms (host "
              f"rANS {f['dec_rans_ms']:.2f}); launches encoder "
              f"{e['launches']}, decoder {d['launches']} [{card}]")
    print(f"coded GOP: I + {GOP_P_FRAMES} P {H}x{W}, every decoded frame and "
          f"DPB equal to the encoder's (torch.equal), the same streams in "
          f"all {CODED_RUNS + 1} runs, peak "
          f"{peak / 2**20:.0f} MiB allocated, codec set-up (CDF tables) "
          f"{setup_s:.2f} s, launches {launches} [{card}]")

    # mask_prop through a CodingSession and an in-memory file
    dmc_mp = DMC(DMCConfig.variant("mask_prop", dtype="bfloat16"),
                 device=DEVICE)
    dmc_mp.load_state_dict(mask_prop_state, strict=True)
    session = CodingSession(VideoCodec(dmci, dmc_mp.eval(), packed_dmc=True))
    buf = io.BytesIO()
    dcb_ops.launches = 0
    chain_ops.launches = 0
    stats = session.encode_sequence(buf, frames[:3], QP, masks=masks[:3])
    buf.seek(0)
    decoded, chain = session.decode_sequence(buf, masks=masks[:3],
                                             return_masks=True)
    mp_launches = (dcb_ops.launches, chain_ops.launches)
    ok = (len(decoded) == 3 and len(chain) == 2
          and all(np.array_equal(a, b)
                  for a, b in zip(decoded, stats["recons"]))
          and all(np.array_equal(a, b) for a, b in zip(chain,
                                                       stats["masks"])))
    if not ok:
        fail("mask_prop session: decoded frames or mask chain differ from "
             "the encoder's")
    if 0 in mp_launches:
        fail(f"mask_prop session: launches {mp_launches}")
    print(f"coded mask_prop session: I + 2 P {H}x{W} through an in-memory "
          f"file ({buf.getbuffer().nbytes} bytes, frames "
          f"{stats['frame_bits']} bits), decoded frames and mask chain equal "
          f"to the encoder's, launches {mp_launches} [{card}]")
    for f in frames_out:
        f["enc_launches"] = list(f["enc_launches"])
        f["dec_launches"] = list(f["dec_launches"])
    return dict(frames=frames_out, peak_bytes=peak, launches=launches,
                setup_s=setup_s,
                mask_prop_session=dict(bits=stats["frame_bits"],
                                       launches=mp_launches))


def phase_batch(torch, seed, card):
    """Both forward kernels at the training shapes: one launch on a batch
    of TRAIN_B images against the plain version (REL_TOL) and against
    TRAIN_B launches on one image each, bit for bit, both timed. Returns
    {kernel name: [rows]}."""
    from ssgvc_tpu_torch.ops import dcb as dcb_ops
    from ssgvc_tpu_torch.ops import dcb_chain as chain_ops

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 40)
    bf16 = torch.bfloat16
    rows = {"dcb": [], "dcb_chain": []}
    cases = ([("dcb", h, w, c, 1, sc, q) for h, w, c, sc, q in TRAIN_SINGLE]
             + [("dcb_chain", h, w, c, n, False, q)
                for h, w, c, n, q in TRAIN_CHAIN])
    for name, h, w, c, n, sc, with_q in cases:
        x = torch.tensor(rng.standard_normal((TRAIN_B, h, w, c)), dtype=bf16,
                         device=dev)
        q = (torch.linspace(0.5, 1.5, c, device=dev).to(bf16) if with_q
             else None)
        blocks = [block_params(torch, c, rng, dev) for _ in range(n)]
        if name == "dcb":
            packed = dcb_ops.pack_block(blocks[0], bf16)
            run = lambda t: dcb_ops.dcb_cuda(t, packed, q, sc)
            plain = dcb_ops.dcb_plain(x, blocks[0], q, sc)
        else:
            packed = chain_ops.pack_chain(blocks, bf16)
            run = lambda t: chain_ops.dcb_chain_cuda(t, packed, q)
            plain = chain_ops.dcb_chain_plain(x, blocks, q)
        ones = [x[i:i + 1].contiguous() for i in range(TRAIN_B)]
        batched = run(x)
        single = torch.cat([run(t) for t in ones])
        torch.cuda.synchronize()
        rel, max_err = check_close(
            torch, f"{name} {TRAIN_B}x{h}x{w}x{c} n={n} sc={int(sc)} "
            f"q={int(with_q)}", batched, plain)
        if not torch.equal(batched, single):
            fail(f"{name} {TRAIN_B}x{h}x{w}x{c} n={n}: the batched launch "
                 "differs from one launch per image")
        ms = cuda_ms(torch, lambda: run(x), 20)
        ms1 = cuda_ms(torch, lambda: [run(t) for t in ones], 20)
        rows[name].append(dict(shape=[TRAIN_B, h, w, c], blocks=n,
                               shortcut=sc, q=with_q, ms=ms, b1_x_b_ms=ms1,
                               rel_err=rel, max_abs_err=max_err))
        print(f"  batch {name} {TRAIN_B}x{h}x{w}x{c} n={n} sc={int(sc)} "
              f"q={int(with_q)}: vs plain rel {rel:.2e} (max abs "
              f"{max_err:.3g}), equal bit for bit to {TRAIN_B} launches of "
              f"B=1; B={TRAIN_B} {ms:.4f} ms, {TRAIN_B} x B=1 {ms1:.4f} ms "
              f"[{card}]")
    return rows


def bwd_case(torch, rng, b, h, w, c, with_q, dev, act=None):
    """Inputs of one block backward's kernels at a shape: fp32, dy in the
    block's dtype ``act`` (bf16 by default)."""
    def t(*shape, std=1.0):
        return torch.tensor(rng.standard_normal(shape) * std,
                            dtype=torch.float32, device=dev)
    return dict(a0=t(b, h, w, c), taps=t(9, c, std=1 / 3), b2=t(c, std=0.1),
                df=t(b, h, w, 2 * c), p=t(b, h, w, 4 * c),
                dy=t(b, h, w, c).to(act or torch.bfloat16), dg=t(b, h, w, c),
                du=t(b, h, w, c), q=1.0 + t(c, std=0.2) if with_q else None,
                resid=t(b, h, w, c) if with_q else None)


def check_rows(torch, what, part, ref, tol=BWD_FP32_TOL):
    """Fail unless each row of the partials ``part`` is finite and within
    ``tol`` of the same row of ``ref`` in relative norm: each tile's sums,
    so a sum assigned to the wrong tile fails even where the total holds."""
    norm = torch.linalg.vector_norm
    rel = norm(part - ref, dim=1) / norm(ref, dim=1)
    if not torch.isfinite(part).all() or not (rel <= tol).all():
        fail(f"{what}: per-tile partial sums disagree with the plain ones, "
             f"worst row rel {float(rel.max()):.3g} > {tol}")


def check_backward_kernels(torch, case):
    """Each backward kernel against its plain version on ``case``; fails
    beyond BWD_FP32_TOL (fp32 outputs and each tile's partial sums) or
    REL_TOL (bf16 outputs). Returns {kernel: max abs error of its
    outputs}."""
    from ssgvc_tpu_torch.ops import dcb_grad as dg

    a0, taps, b2 = case["a0"], case["taps"], case["b2"]
    q, resid, act = case["q"], case["resid"], case["dy"].dtype
    b, h, w, c = a0.shape
    errs = {}
    act_tol = REL_TOL if act == torch.bfloat16 else BWD_FP32_TOL
    what = f"at {(b, h, w, c)} {str(act)[6:]} q={q is not None}"

    def cmp(kernel, out_name, out, ref, tol=BWD_FP32_TOL):
        _, err = check_close(torch, f"{kernel} {what}: {out_name}", out, ref,
                             tol)
        errs[kernel] = max(errs.get(kernel, 0.0), err)

    cmp("dw_fwd", "g", dg.dw_fwd_cuda(a0, taps, b2, act),
        dg.dw_fwd_plain(a0, taps, b2, act), act_tol)
    cols = (dg.GATE_COLS + dg.DW_COLS) * c
    rows = dg.partial_rows(a0)
    part_k = torch.zeros(rows, cols, device=a0.device)
    part_t = torch.zeros(rows, cols, device=a0.device)   # plain, per tile
    part_p = torch.zeros(1, cols, device=a0.device)      # plain, in all
    kern = dg.gate_bwd_cuda(case["df"], case["p"], case["dy"], q, resid,
                            part_k, 0)
    plain = dg.gate_bwd_plain(case["df"], case["p"], case["dy"], q, resid,
                              part_p, 0)
    dg.gate_bwd_plain(case["df"], case["p"], case["dy"], q, resid, part_t, 0)
    cmp("gate_bwd", "dp", kern[0], plain[0])
    cmp("gate_bwd", "f", kern[1], plain[1], act_tol)
    if q is not None:
        cmp("gate_bwd", "dy * q", kern[2], plain[2])
    col = dg.GATE_COLS * c
    dw = (case["dg"], a0, taps, case["du"])
    da0k = dg.dw_bwd_cuda(*dw, part_k, col)
    da0p = dg.dw_bwd_plain(*dw, part_p, col)
    dg.dw_bwd_plain(*dw, part_t, col)
    cmp("dw_bwd", "da0", da0k, da0p)
    torch.cuda.synchronize()
    check_rows(torch, f"gate_bwd {what}", part_k[:, :col], part_t[:, :col])
    check_rows(torch, f"dw_bwd {what}", part_k[:, col:], part_t[:, col:])
    sk = dg.grad_reduce_cuda(part_k)
    sp = dg.grad_reduce_plain(part_p)
    if not torch.equal(sk.cpu(), dg.grad_reduce_order(part_k.cpu())):
        fail(f"grad_reduce {what}: not grad_reduce_order's sums bit for bit")
    cmp("grad_reduce", "the partials' sum", sk,
        dg.grad_reduce_plain(part_k))
    # each kernel's partial sums, reduced, against the plain sums
    cmp("gate_bwd", "bias and q partial sums", sk[:col], sp[:col])
    cmp("dw_bwd", "tap and bias partial sums", sk[col:], sp[col:])
    return errs


def bwd_bytes(b, h, w, c, with_q, size=2):
    """Bytes each backward kernel's function must move at a shape: each
    input read once, each output written once, and for gate_bwd and dw_bwd
    their per-channel sums written once (not the partials, whose count is
    the partition's: the bound is the same work whatever partition runs
    it); grad_reduce reads the partials it is given. ``size``: bytes of an
    activation in the block's dtype (dw_fwd's g, gate_bwd's dy and f)."""
    from ssgvc_tpu_torch.ops import dcb_grad as dg

    m, rows = b * h * w, dg.bwd_tiles((b, h, w, c))[2]
    # df, p and dp in fp32; dy and f (2C) in the block's dtype; the 6C sums
    gate = 4 * m * c * (2 + 4 + 4) + size * m * c * 3 + 4 * 6 * c
    if with_q:
        gate += 4 * c + 2 * 4 * m * c              # q, resid, dy * q
    return {"dw_fwd": 4 * m * c + size * m * c + 40 * c,
            "gate_bwd": gate,
            "dw_bwd": 4 * m * c * 4 + 36 * c + 4 * 12 * c,
            "grad_reduce": 4 * rows * 18 * c + 4 * 18 * c}


#: What each backward kernel takes the place of: the JAX package trains
#: through XLA's autodiff of its DepthConvBlock conv composition, so these
#: are the lines whose gradient the kernel computes (no Pallas kernel)
BWD_REPLACES = {"dw_fwd": "ssgvc_tpu/layers/blocks.py:491",
                "gate_bwd": "ssgvc_tpu/layers/blocks.py:504",
                "dw_bwd": "ssgvc_tpu/layers/blocks.py:497",
                "grad_reduce": "ssgvc_tpu/layers/blocks.py:490"}


def bwd_key(kernel, b, h, w, c, with_q):
    """The operand shape ``ops.dcb_grad`` counts ``kernel``'s launches by
    (``shape_launches``) at one block backward's shape."""
    from ssgvc_tpu_torch.ops import dcb_grad as dg

    if kernel == "gate_bwd":
        return (b, h, w, c, with_q)
    if kernel == "grad_reduce":
        return (dg.bwd_tiles((b, h, w, c))[2],
                (dg.GATE_COLS + dg.DW_COLS) * c)
    return (b, h, w, c)


def dw_fwd_row(torch, a0, taps, b2, act, pdg=None, reps=20):
    """dw_fwd at one shape with g in ``act``: against its plain version
    (REL_TOL in bf16, BWD_FP32_TOL in fp32); with ``pdg`` (the other
    checkout's ops.dcb_grad) its g against that checkout's kernel's (fails
    on any difference) and its time in turns with it (prev, new, new,
    prev); beside the plain version, cuDNN's depthwise conv alone (no
    WSiLU: less work) and the bound (a0 read, g written, taps and b2
    read)."""
    import torch.nn.functional as F

    from ssgvc_tpu_torch.ops import dcb_grad as dg

    b, h, w, c = a0.shape
    what = f"dw_fwd at {(b, h, w, c)} {str(act)[6:]}"
    kern = lambda: dg.dw_fwd_cuda(a0, taps, b2, act)
    plain = lambda: dg.dw_fwd_plain(a0, taps, b2, act)
    hn = dg.wsilu(a0).permute(0, 3, 1, 2)
    wdw = taps.t().reshape(c, 1, 3, 3)
    g = kern()
    _, err = check_close(torch, what, g, plain(),
                         REL_TOL if act == torch.bfloat16 else BWD_FP32_TOL)
    fns = {"new": kern}
    if pdg is not None:
        fns["prev"] = lambda: pdg.dw_fwd_cuda(a0, taps, b2, act)
        diff = float((g.float() - fns["prev"]().float()).abs().max())
        if not diff == 0.0:
            fail(f"{what}: g differs from the other checkout's by up to "
                 f"{diff}")
    means, turns = timed_turns(torch, fns, reps)
    nbytes = bwd_bytes(b, h, w, c, False, act.itemsize)["dw_fwd"]
    r = dict(ms=means["new"], plain_ms=cuda_ms(torch, plain, reps),
             library_ms=cuda_ms(torch, lambda: F.conv2d(
                 hn, wdw, b2, padding=1, groups=c), reps),
             bytes=nbytes, bound_ms=1e3 * nbytes / H100_BYTES_PER_S,
             max_abs_err=err)
    if "prev" in means:
        r.update(prev_ms=means["prev"], turns=turns, prev_max_abs_diff=0.0)
    return r


def dw_fwd_text(r):
    """One dw_fwd row's times, as phases 12 and 17 print them."""
    prev = (f", parent {r['prev_ms']:.4f} (g equal bit for bit)"
            if "prev_ms" in r else "")
    return (f"kernel {r['ms']:.4f} ms{prev}, plain {r['plain_ms']:.4f}, "
            f"cuDNN depthwise alone {r['library_ms']:.4f}, bound "
            f"{1e3 * r['bound_ms']:.2f} us ({r['bytes']} B at 3.35 TB/s), "
            f"max abs {r['max_abs_err']:.3g}")


def phase_backward_kernels(torch, seed, card, prev=False, shapes=None):
    """Each backward kernel at every block-backward shape (``shapes``:
    (B, rows, cols, C, q, sites); by default BWD_SHAPES at B = TRAIN_B),
    against its plain version; timed beside its plain version, its bound
    and a library call, once per operand shape it counts launches by; with
    ``prev`` (--prev-port loaded) also the other checkout's kernels on the
    same inputs (gate_bwd and dw_bwd on their own partials), in turns
    (prev, new, new, prev). dw_fwd also with an fp32 g (its row's "f32"),
    and its g equal to the other checkout's in both dtypes. Returns
    {kernel: [rows]}; :func:`weigh_bwd` weighs them by the launches a step
    makes at each."""
    import importlib

    from ssgvc_tpu_torch.ops import dcb_grad as dg

    if shapes is None:
        shapes = [(TRAIN_B, *s) for s in BWD_SHAPES]
    pdg = importlib.import_module("prev_port.ops.dcb_grad") if prev else None
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 50)
    names = list(BWD_REPLACES)
    rows = {k: [] for k in names}
    for b, h, w, c, with_q, sites in shapes:
        case = bwd_case(torch, rng, b, h, w, c, with_q, dev)
        errs = check_backward_kernels(torch, case)
        a0, taps, b2, q = case["a0"], case["taps"], case["b2"], case["q"]
        cols = (dg.GATE_COLS + dg.DW_COLS) * c
        part_k = torch.zeros(dg.partial_rows(a0), cols, device=dev)
        part_p = torch.zeros(1, cols, device=dev)
        col = dg.GATE_COLS * c
        gate = (case["df"], case["p"], case["dy"], q, case["resid"])
        dw = (case["dg"], a0, taps, case["du"])
        wdw = taps.t().reshape(c, 1, 3, 3)
        hn = dg.wsilu(a0).permute(0, 3, 1, 2)
        dgn = case["dg"].permute(0, 3, 1, 2)
        fns = {
            "gate_bwd": (lambda: dg.gate_bwd_cuda(*gate, part_k, 0),
                         lambda: dg.gate_bwd_plain(*gate, part_p, 0), None),
            "dw_bwd": (lambda: dg.dw_bwd_cuda(*dw, part_k, col),
                       lambda: dg.dw_bwd_plain(*dw, part_p, col),
                       # the depthwise conv's input, tap and bias gradients
                       # in one call, without WSiLU and the b0 / b3 sums
                       lambda: torch.ops.aten.convolution_backward(
                           dgn, hn, wdw, [c], [1, 1], [1, 1], [1, 1], False,
                           [0, 0], c, [True, True, True])),
            "grad_reduce": (lambda: dg.grad_reduce_cuda(part_k),
                            lambda: dg.grad_reduce_plain(part_k),
                            lambda: torch.sum(part_k, 0))}
        prev_fns = {}
        if pdg is not None:
            # the other checkout's kernels on the same inputs, each with
            # its own partials (its partition's rows)
            part_q = torch.zeros(pdg.partial_rows(a0), cols, device=dev)
            pdg.gate_bwd_cuda(*gate, part_q, 0)
            pdg.dw_bwd_cuda(*dw, part_q, col)
            prev_fns = {"gate_bwd": lambda: pdg.gate_bwd_cuda(*gate, part_q,
                                                              0),
                        "dw_bwd": lambda: pdg.dw_bwd_cuda(*dw, part_q, col),
                        "grad_reduce": lambda: pdg.grad_reduce_cuda(part_q)}
        nbytes = bwd_bytes(b, h, w, c, with_q)
        for k in names:
            key = bwd_key(k, b, h, w, c, with_q)
            r = dict(key=key, shape=[b, h, w, c], q=with_q, sites=sites)
            if k == "dw_fwd":
                # g in bf16 (the default micro-step's) and in fp32
                r.update(dw_fwd_row(torch, a0, taps, b2, torch.bfloat16,
                                    pdg))
                r["f32"] = dw_fwd_row(torch, a0, taps, b2, torch.float32,
                                      pdg)
                r["max_abs_err"] = max(r["max_abs_err"], errs[k])
                rows[k].append(r)
                for dt, x in (("bf16", r), ("fp32", r["f32"])):
                    print(f"  dw_fwd {b}x{h}x{w}x{c} g {dt}: "
                          f"{dw_fwd_text(x)} [{card}]")
                continue
            kern, plain, lib = fns[k]
            if k in prev_fns:
                turns = {"prev": [], "new": []}
                for who in ("prev", "new", "new", "prev"):
                    turns[who].append(cuda_ms(
                        torch, prev_fns[k] if who == "prev" else kern, 20))
                r.update(ms=sum(turns["new"]) / 2,
                         prev_ms=sum(turns["prev"]) / 2, turns=turns,
                         prev_rows=part_q.shape[0])
            else:
                r["ms"] = cuda_ms(torch, kern, 20)
            r.update(plain_ms=cuda_ms(torch, plain, 20),
                     library_ms=cuda_ms(torch, lib, 20) if lib else None,
                     bytes=nbytes[k],
                     bound_ms=1e3 * nbytes[k] / H100_BYTES_PER_S,
                     max_abs_err=errs[k], rows=part_k.shape[0])
            rows[k].append(r)
            lib_txt = (f", library {r['library_ms']:.4f}" if lib else "")
            prev_txt = (f", prev {r['prev_ms']:.4f} ({r['prev_rows']} rows)"
                        if "prev_ms" in r else "")
            print(f"  {k} {b}x{h}x{w}x{c} q={int(with_q)}: kernel "
                  f"{r['ms']:.4f} ms ({r['rows']} partial rows){prev_txt}, "
                  f"plain {r['plain_ms']:.4f}{lib_txt}, bound "
                  f"{1e3 * r['bound_ms']:.2f} us ({nbytes[k]} B at 3.35 "
                  f"TB/s), max abs {r['max_abs_err']:.3g} [{card}]")
    return rows


def weigh_bwd(rows, shape_counts, what):
    """Each backward kernel's timed rows (:func:`phase_backward_kernels`)
    weighed by the block backwards one step ran at each shape
    (``shape_counts``: ``ops.dcb_grad.shape_launches`` of one step; one
    gate_bwd launch per block backward, keyed by shape and q), summed:
    {kernel: {launches, ms, plain_ms, bound_ms, library_ms, max_abs_err,
    [prev_ms], shapes}}. Fails if the step ran a block backward at a shape
    that was not timed, or launched a kernel at an operand shape that its
    timed rows do not hold."""
    blocks = {key: n for (name, key), n in shape_counts.items()
              if name == "gate_bwd"}
    timed = {(*r["shape"], r["q"]) for r in rows["gate_bwd"]}
    if set(blocks) - timed:
        fail(f"{what} ran block backwards at {sorted(set(blocks) - timed)},"
             " shapes that were not timed")
    out = {}
    for k, rs in rows.items():
        counted = {key: n for (name, key), n in shape_counts.items()
                   if name == k}
        for r in rs:
            r["per_step"] = blocks.get((*r["shape"], r["q"]), 0)
        if (set(counted) - {r["key"] for r in rs}
                or sum(counted.values()) != sum(r["per_step"] for r in rs)):
            fail(f"{k} in {what}: launches by operand shape {counted} are "
                 "not the block backwards' at the timed shapes")
        per = lambda key: sum(r[key] * r["per_step"] for r in rs)
        out[k] = dict(
            launches=sum(counted.values()), ms=per("ms"),
            plain_ms=per("plain_ms"), bound_ms=per("bound_ms"),
            library_ms=(per("library_ms") if rs[0]["library_ms"] is not None
                        else None),
            max_abs_err=max(r["max_abs_err"] for r in rs), shapes=rs)
        if "prev_ms" in rs[0]:
            out[k]["prev_ms"] = per("prev_ms")
    return out


def backward_entries(rows, shape_counts, card):
    """One {"kernels"} entry per backward kernel: each timed shape's
    numbers times the block backwards a training micro-step ran at it
    (``shape_counts``, phase 13), summed (:func:`weigh_bwd`)."""
    entries = []
    for k, s in weigh_bwd(rows, shape_counts, "a training micro-step").items():
        rs = s.pop("shapes")
        entries.append(dict(
            name=k, route="cuda", source="ssgvc_tpu_torch/csrc/dcb_bwd.cu",
            replaces=BWD_REPLACES[k], bound_by="bytes", **s,
            per="training micro-step: per-shape time x block backwards per "
                "micro-step at that shape (counted), summed", shapes=rs))
        print(f"  {k} launches per micro-step by shape: "
              + ", ".join(f"{r['shape']} q={int(r['q'])} x{r['per_step']}"
                          for r in rs)
              + f"; {entries[-1]['ms']:.3f} ms per micro-step"
              + (f" (prev {entries[-1]['prev_ms']:.3f} in turns)"
                 if "prev_ms" in entries[-1] else "") + f" [{card}]")
    return entries


def dcb_modules(model):
    """(name, DepthConvBlock) of every block of ``model``."""
    from ssgvc_tpu_torch.layers.blocks import DepthConvBlock

    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, DepthConvBlock)]


def launch_counts():
    """Every kernel's launch count: (reset, read) functions; reset also
    clears the backward kernels' counts by shape."""
    from ssgvc_tpu_torch.ops import dcb as dcb_ops
    from ssgvc_tpu_torch.ops import dcb_chain as chain_ops
    from ssgvc_tpu_torch.ops import dcb_grad as dg

    def reset():
        dcb_ops.launches = dcb_ops.launches_f32 = dcb_ops.launches_tf32 = 0
        chain_ops.launches = chain_ops.launches_f32 = 0
        chain_ops.launches_tf32 = 0
        for k in dg.launches:
            dg.launches[k] = 0
        dg.shape_launches.clear()
        dcb_ops.shape_launches_f32.clear()
        chain_ops.shape_launches_f32.clear()

    def read():
        return {"dcb": dcb_ops.launches, "dcb_chain": chain_ops.launches,
                "dcb_f32": dcb_ops.launches_f32,
                "dcb_chain_f32": chain_ops.launches_f32,
                "dcb_tf32": dcb_ops.launches_tf32,
                "dcb_chain_tf32": chain_ops.launches_tf32, **dg.launches}
    return reset, read


def phase_train(torch, seed, card):
    """The trainer at full width on the card: TRAIN_STEPS micro-steps of
    the default TrainConfig, then validate, then one step each of the
    mask_train and constraint_opt modes."""
    from ssgvc_tpu_torch.config import TrainConfig
    from ssgvc_tpu_torch.data.device_synth import synth_batch
    from ssgvc_tpu_torch.ops import dcb_grad as dg
    from ssgvc_tpu_torch.training.trainer import Trainer

    reset, read = launch_counts()
    cfg = TrainConfig()
    g = torch.Generator(device=DEVICE).manual_seed(seed + 30)
    batch = lambda: synth_batch(g, batch=TRAIN_B, size=TRAIN_HW,
                                seq_len=TRAIN_T)
    tr = Trainer(cfg, device=DEVICE)
    first = batch()
    t0 = time.perf_counter()
    state = tr.init_state(torch.Generator().manual_seed(seed), first)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = dict(tr.dmc.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    host = np.random.default_rng(seed)
    noise = torch.Generator().manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    ms, losses, counts = [], [], []
    for k in range(TRAIN_STEPS):
        b = first if k == 0 else batch()
        qp = int(host.integers(0, 64))
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        reset()
        e0.record()
        state, aux = tr.train_step(state, b, qp, noise)
        e1.record()
        e1.synchronize()
        counts.append(read())
        shape_counts = dict(dg.shape_launches)
        ms.append(e0.elapsed_time(e1))
        row = {key: float(v) for key, v in aux.items()}
        losses.append(row)
        if not all(math.isfinite(v) for v in row.values()):
            fail(f"micro-step {k + 1}: a loss or metric is not finite: {row}")
        if counts[-1] != TRAIN_LAUNCHES:
            fail(f"micro-step {k + 1}: launches {counts[-1]}, expected "
                 f"{TRAIN_LAUNCHES}")
        changed = [n for n, p in params.items()
                   if not torch.equal(p.detach(), start[n])]
        if k + 1 < cfg.accumulation_steps and changed:
            fail(f"micro-step {k + 1}: parameters changed before the "
                 f"accumulation boundary: {changed[:4]}")
        if k + 1 == cfg.accumulation_steps:
            n_changed = len(changed)
            tails = [n for n in params
                     if n.endswith(("dc_3.weight", "ffn_2.weight"))]
            if not n_changed or any(n not in changed for n in tails):
                fail(f"micro-step {k + 1}: the update at the accumulation "
                     f"boundary left {len(params) - n_changed} of "
                     f"{len(params)} parameters (tails among them) as they "
                     "were")
        print(f"  micro-step {k + 1} (QP {qp}): loss {row['loss']:.4f}, bpp "
              f"{row['bpp']:.4f}, PSNR {row['psnr']:.2f} dB, {ms[-1]:.1f} ms"
              f", {len(changed)} of {len(params)} parameters changed since "
              f"init [{card}]")
    peak = torch.cuda.max_memory_allocated()
    # micro-step 10's own gradient (set by its backward; no update since 8)
    zero, bad = [], []
    for name, m in dcb_modules(tr.dmc):
        for pn, p in zip(("dc_0.weight", "dc_0.bias", "dc_2.weight",
                          "dc_2.bias", "dc_3.weight", "dc_3.bias",
                          "ffn_0.weight", "ffn_0.bias", "ffn_2.weight",
                          "ffn_2.bias"), m.core_params()):
            if p.grad is None or not torch.isfinite(p.grad).all():
                bad.append(f"{name}.{pn}")
            elif not p.grad.abs().max() > 0:
                zero.append(f"{name}.{pn}")
    if bad or zero:
        fail(f"DepthConvBlock gradients not finite: {bad[:6]}; zero: "
             f"{zero[:6]}")
    n_dcb = len(dcb_modules(tr.dmc))
    step_ms = float(np.median(ms[TRAIN_TIMED]))
    print(f"training: {TRAIN_STEPS} micro-steps B={TRAIN_B} "
          f"{TRAIN_HW}x{TRAIN_HW} T={TRAIN_T}, {step_ms:.1f} ms per "
          f"micro-step (CUDA events, median of steps 3-10: "
          f"{', '.join(f'{x:.1f}' for x in ms[TRAIN_TIMED])}), peak "
          f"{peak / 2**20:.0f} MiB allocated, init + calibration "
          f"{init_s:.1f} s, launches per micro-step {counts[-1]}, "
          f"{10 * n_dcb} DepthConvBlock parameter gradients finite and "
          f"nonzero [{card}]")

    # validation: no graph, no backward
    reset()
    val = tr.validate(state, iter([batch() for _ in range(VAL_BATCHES)]),
                      n_batches=VAL_BATCHES, seed=seed)
    val_counts = read()
    want = {"dcb": VAL_BATCHES * (IFRAME_LAUNCHES + 19 + 18 + 18),
            "dcb_chain": VAL_BATCHES * 15}
    if not (all(math.isfinite(v) for v in val.values())
            and {k: val_counts[k] for k in want} == want
            and not any(val_counts[k] for k in BWD_REPLACES)):
        fail(f"validate: metrics {val}, launches {val_counts} (expected "
             f"{want} and no backward)")
    print(f"  validate on {VAL_BATCHES} batches: loss {val['loss']:.4f}, "
          f"bpp {val['bpp']:.4f}, PSNR {val['psnr']:.2f} dB, launches "
          f"{val_counts} [{card}]")
    del tr, state, params, start

    modes = {}
    for what, kw in (("mask_prop, mask_train", dict(dmc_variant="mask_prop",
                                                    mask_train=True)),
                     ("constraint_opt", dict(constraint_opt=True))):
        other = Trainer(TrainConfig(**kw), device=DEVICE)
        b = batch()
        st = other.init_state(torch.Generator().manual_seed(seed), b)
        st, aux = other.train_step(st, b, QP, noise)
        row = {key: float(v) for key, v in aux.items()}
        grads = [p.grad for n, p in other.dmc.named_parameters()
                 if p.grad is not None and (not kw.get("mask_train")
                                            or "mask_predictor" in n)]
        if not (grads and all(math.isfinite(v) for v in row.values())
                and all(torch.isfinite(gr).all() for gr in grads)
                and any(gr.abs().max() > 0 for gr in grads)):
            fail(f"train_step with {what}: metrics {row}")
        modes[what] = row
        print(f"  train_step with {what}: loss {row['loss']:.4f}, g_mean "
              f"{row['g_mean']:.4f}, {len(grads)} trained gradients finite "
              f"[{card}]")
        del other, st
    return dict(ms_per_micro_step=step_ms, ms_runs=ms, peak_bytes=peak,
                init_s=init_s, launches_per_micro_step=counts[-1],
                shape_counts=shape_counts,
                losses=losses, val=val, val_launches=val_counts, modes=modes,
                batch=TRAIN_B, crop=TRAIN_HW, seq_len=TRAIN_T,
                accumulation_steps=cfg.accumulation_steps)


def train_cross_check(torch, seed, device=DEVICE, hw=TRAIN_HW, b=2, t=3):
    """gop_loss and its gradient at full width, train=False (STE rounding:
    no noise), on the same weights (recon_residual, TRAIN_HEADS: an
    unsaturated reconstruction): ``device`` in bf16 against the CPU port in
    fp32, beside the CPU port's own bf16 (plain versions) against its fp32,
    the gap bf16 alone opens, and the card against that CPU bf16. Passes
    when the loss agrees with fp32 within 5e-2 and the card's gradient
    cosine is >= XTRAIN_COSINE to fp32's and >= XTRAIN_KERNEL_COSINE to
    the CPU bf16 one. Returns the numbers."""
    from ssgvc_tpu_torch.config import TrainConfig
    from ssgvc_tpu_torch.data.device_synth import synth_batch
    from ssgvc_tpu_torch.training.trainer import Trainer

    data = synth_batch(torch.Generator().manual_seed(seed + 4), batch=b,
                       size=hw, seq_len=t, device="cpu")
    out, states = {}, None
    for name, dev, precision in (("cpu32", "cpu", "32"),
                                 ("cpu16", "cpu", "bf16-mixed"),
                                 ("card", device, "bf16-mixed")):
        t0 = time.perf_counter()
        tr = Trainer(TrainConfig(precision=precision, recon_residual=True),
                     device=dev)
        if states is None:
            random_weights(torch, tr.dmc, seed, TRAIN_HEADS)
            random_weights(torch, tr.dmci, seed, DMCI_HEADS)
            states = (tr.dmc.state_dict(), tr.dmci.state_dict())
        else:
            tr.dmc.load_state_dict(states[0], strict=True)
            tr.dmci.load_state_dict(states[1], strict=True)
        loss, _ = tr.gop_loss(data["frames"].to(dev), data["masks"].to(dev),
                              QP, torch.Generator().manual_seed(seed),
                              train=False, eval_mode=False)
        loss.backward()
        # float64, as phase 20: an fp32 dot over the whole gradient drifts
        grad = torch.cat([p.grad.double().reshape(-1).cpu()
                          for p in tr.dmc.parameters()])
        out[name] = (float(loss.detach()), grad, time.perf_counter() - t0)

    def gap(a, ref):
        (la, ga, _), (lr, gr, _) = out[a], out[ref]
        cos = torch.dot(ga, gr) / (torch.linalg.vector_norm(ga)
                                   * torch.linalg.vector_norm(gr))
        return dict(loss_rel=abs(la - lr) / abs(lr), grad_cosine=float(cos),
                    grad_rel=float(torch.linalg.vector_norm(ga - gr)
                                   / torch.linalg.vector_norm(gr)))

    r = dict(card_vs_cpu32=gap("card", "cpu32"),
             cpu16_vs_cpu32=gap("cpu16", "cpu32"),
             card_vs_cpu16=gap("card", "cpu16"),
             seconds={k: v[2] for k, v in out.items()})
    c, g, k = r["card_vs_cpu32"], r["cpu16_vs_cpu32"], r["card_vs_cpu16"]
    print(f"cross-check training {hw}x{hw} B={b} T={t} (recon_residual): "
          f"gop_loss card-bf16 vs cpu-fp32 rel {c['loss_rel']:.2e} (tol "
          f"5e-2), gradient cosine {c['grad_cosine']:.5f} (tol >= "
          f"{XTRAIN_COSINE}; rel {c['grad_rel']:.3f}); card-bf16 vs cpu-bf16"
          f" cosine {k['grad_cosine']:.5f} (tol >= {XTRAIN_KERNEL_COSINE}; "
          f"rel {k['grad_rel']:.3f}); the CPU's own bf16 vs fp32: loss rel "
          f"{g['loss_rel']:.2e}, cosine {g['grad_cosine']:.5f} (rel "
          f"{g['grad_rel']:.3f}); seconds {r['seconds']}")
    if not (c["loss_rel"] <= 5e-2 and c["grad_cosine"] >= XTRAIN_COSINE
            and k["grad_cosine"] >= XTRAIN_KERNEL_COSINE):
        fail("training: the card's bf16 gop_loss or gradient is too far "
             "from the CPU port's fp32 or bf16 one")
    return r


# Phases 14-18 of this slice: every profile's widths, float32, the RD recipe

#: Widths of phase 14: every width a profile builds, one per computed width
#: (C rounded up to 64; 448 at 512), the single block to 512 and the chain
#: to 384
WIDTH_SINGLE = (8, 16, 24, 32, 48, 64, 96, 128, 160, 184, 192, 256, 320,
                384, 448, 512)
WIDTH_CHAIN = (8, 16, 24, 32, 48, 64, 96, 128, 160, 192, 256, 320, 384)
#: (B, rows, cols, what): a 64x64 training crop, a 192x192 eval clip and a
#: 1088x1920 frame, each packed 8x8; then the same at the hyper and prior
#: sites (/16, /64), whose last 8x8 tiles (8x4 in the fp32 kernel) are cut
#: off or only partly filled
WIDTH_FRAMES = ((4, 8, 8, "64x64 crop"), (4, 24, 24, "192x192 clip"),
                (1, 136, 240, "1088x1920"),
                (8, 4, 4, "64x64 crop /16"), (4, 12, 12, "192x192 clip /16"),
                (1, 68, 120, "1088x1920 /16"), (1, 17, 30, "1088x1920 /64"))
WIDTH_CHAIN_N = 2
FP32_P_FRAMES = 7            # P-frames after the I-frame in phase 15
FP32_RUNS = 2                # timed fp32 GOPs; ms their median
RDHALF_P_FRAMES = 7          # the same at rd-half, bf16 (phase 16)
RDHALF_RUNS = 3
# The RD recipe (experiments/rd_tpu.py:train_variant_tpu, rd_full.py): the
# rd-mid profile, performance variant, fp32, crop 64, T = 4, base_lr 7e-4,
# min_lr 5e-5, roi_weight 100, lambda_normalize off (rd_full.LNORM),
# accumulation 1; the recipe's batch is 32, here 8 to bound the smoke's
# time (a micro-step is host-bound: its time barely grows with B)
RD_PROFILE = {"dmc": dict(ch_d=64, ch_y=32, ch_z=32, ch_recon=96),
              "dmci": dict(enc_dec=96, N=64, z_channel=32)}
RD_B, RD_CROP, RD_T, RD_STEPS = 8, 64, 4, 10
RD_EVAL_CLIPS, RD_EVAL_CROP = 6, 192
EVAL_QPS = (8, 20, 32, 44, 56)     # experiments/rd_full.py:EVAL_QPS
RDHALF_PROFILE = {"dmc": dict(ch_d=128, ch_y=64, ch_z=64, ch_recon=160),
                  "dmci": dict(enc_dec=184, N=128, z_channel=64)}


#: (B, H, W) whose SIMT unit plans phase 2 checks against ops/dcb.py: the RD
#: recipe's, a ragged batch, phase 14's frames
F32_PLAN_SHAPES = ((8, 1, 1), (8, 2, 2), (8, 4, 4), (8, 8, 8), (3, 5, 7),
                   (1, 40, 52), (4, 24, 24), (1, 17, 30), (1, 136, 240))
PEAK_TEXT = {"": "989 TFLOP/s bf16", "_f32": "67 TFLOP/s fp32",
             "_tf32": "3 x 495 TFLOP/s TF32"}


def phase_widths(torch, seed, card, prev=None):
    """Both kernels in both dtypes at every width of WIDTH_SINGLE /
    WIDTH_CHAIN and every frame of WIDTH_FRAMES against their plain
    versions (bf16 REL_TOL, fp32 F32_TOL), one launch per call counted,
    timed beside the plain version and the bound; the SIMT cases (fp32, C
    <= 64) beside the 3xTF32 kernel and, with ``prev`` (the other
    checkout's layers.blocks), in turns with that checkout's kernel.
    Returns {kernel name: [rows]}."""
    from ssgvc_tpu_torch.ops import dcb as dcb_ops
    from ssgvc_tpu_torch.ops import dcb_chain as chain_ops

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 60)
    rows = {k + sfx: [] for k in ("dcb", "dcb_chain")
            for sfx in ("", "_f32", "_tf32")}
    single = {"": dcb_ops.dcb_cuda, "_f32": dcb_ops.dcb_f32_cuda,
              "_tf32": dcb_ops.dcb_tf32_cuda}
    chain = {"": chain_ops.dcb_chain_cuda,
             "_f32": chain_ops.dcb_chain_f32_cuda,
             "_tf32": chain_ops.dcb_chain_tf32_cuda}
    cases = ([("dcb", c) for c in WIDTH_SINGLE]
             + [("dcb_chain", c) for c in WIDTH_CHAIN])
    for f32 in (False, True):
        dt = torch.float32 if f32 else torch.bfloat16
        for kernel, c in cases:
            for b, h, w, what in WIDTH_FRAMES:
                n = 1 if kernel == "dcb" else WIDTH_CHAIN_N
                x = torch.tensor(rng.standard_normal((b, h, w, c)), dtype=dt,
                                 device=dev)
                q = torch.linspace(0.5, 1.5, c, device=dev).to(dt)
                blocks = [block_params(torch, c, rng, dev) for _ in range(n)]
                sfx, count = f32_route(c) if f32 else ("", "launches")
                if kernel == "dcb":
                    packed = dcb_ops.pack_kernel(blocks[0], dt)
                    fn = single[sfx]
                    run = lambda: fn(x, packed, q, True)
                    plain = lambda: dcb_ops.dcb_plain(x, blocks[0], q, True)
                    mod = dcb_ops
                else:
                    packed = chain_ops.pack_chain(blocks, dt)
                    fn = chain[sfx]
                    run = lambda: fn(x, packed, q)
                    plain = lambda: chain_ops.dcb_chain_plain(x, blocks, q)
                    mod = chain_ops
                before = getattr(mod, count)
                out = run()
                launched = getattr(mod, count) - before
                torch.cuda.synchronize()
                name = kernel + sfx
                rel, max_err = check_kernel(
                    torch, f"{name} {b}x{h}x{w}x{c} n={n}", out, plain())
                if launched != 1:
                    fail(f"{name} {b}x{h}x{w}x{c}: {launched} launches for "
                         "one call")
                fns = {"new": run}
                if sfx == "_f32" and prev is not None:
                    mods = prev_modules(torch, prev, c, kernel == "dcb",
                                        blocks, dt)
                    fns["prev"] = ((lambda: mods[0](x, q)) if kernel == "dcb"
                                   else (lambda: prev.run_chain(x, mods, q)))
                    check_f32(torch, f"prev {name} {b}x{h}x{w}x{c} n={n}",
                              fns["prev"](), plain())
                means, turns = timed_turns(torch, fns, 10)
                r = dict(shape=[b, h, w, c], blocks=n, frame=what,
                         cp=dcb_ops.padded_channels(c), ms=means["new"],
                         plain_ms=cuda_ms(torch, plain, 3),
                         bound_ms=bound_ms(h, w, c, n, f32, b),
                         bound_by=bound_by(h, w, c, n, f32, b),
                         launches=launched, rel_err=rel, max_abs_err=max_err)
                alt = ""
                if sfx == "_f32":
                    # the routing rule's evidence: the 3xTF32 kernel (at a
                    # computed width of 128) on the same inputs
                    if kernel == "dcb":
                        tp = dcb_ops.pack_tf32(blocks[0])
                        trun = lambda: dcb_ops.dcb_tf32_cuda(x, tp, q, True)
                    else:
                        tp = torch.cat([dcb_ops.pack_tf32(p) for p in blocks])
                        trun = lambda: chain_ops.dcb_chain_tf32_cuda(x, tp,
                                                                     q)
                    check_f32(torch, f"{kernel}_tf32 {b}x{h}x{w}x{c} n={n}",
                              trun(), plain())
                    r["tf32_ms"] = cuda_ms(torch, trun, 10)
                    alt = f", 3xTF32 kernel {r['tf32_ms']:.4f} ms"
                    if "prev" in means:
                        r.update(prev_ms=means["prev"], turns=turns)
                        alt += (f", prev {r['prev_ms']:.4f} ms ("
                                f"{r['ms'] / r['prev_ms'] - 1:+.1%})")
                rows[name].append(r)
                print(f"  widths {name} {b}x{h}x{w}x{c} (CP {r['cp']}, "
                      f"{what}) n={n}: kernel {r['ms']:.4f} ms{alt}, plain "
                      f"{r['plain_ms']:.4f} ms, bound {1e3 * r['bound_ms']:.2f}"
                      f" us ({r['bound_by']}, "
                      f"{PEAK_TEXT[sfx]}), {launched} launch, "
                      f"{'max rel' if f32 else 'rel'} {rel:.2e} [{card}]")
    simt = [r for k in ("dcb_f32", "dcb_chain_f32") for r in rows[k]]
    slower = [(r["shape"], r["blocks"]) for r in simt
              if r["ms"] >= r["tf32_ms"]]
    print(f"  widths: the SIMT fp32 kernel (C <= 64) faster than the 3xTF32 "
          f"one in {len(simt) - len(slower)} of {len(simt)} cases; slower "
          f"at {slower} [{card}]")
    if prev is not None:
        worst = max(simt, key=lambda r: r["ms"] / r["prev_ms"])
        ratio = worst["ms"] / worst["prev_ms"]
        print(f"  widths: the SIMT kernel against --prev-port's in turns: "
              f"{sum(r['ms'] < r['prev_ms'] for r in simt)} of {len(simt)} "
              f"cases faster; the largest ratio {ratio:.3f} at "
              f"{worst['shape']} n={worst['blocks']} [{card}]")
    return rows


def phase_f32_shapes(torch, seed, card, counts, prev=None,
                     where="RD-recipe", reps=20):
    """The fp32 kernels (SIMT ``dcb_f32`` / ``dcb_chain_f32``, 3xTF32
    ``dcb_tf32`` / ``dcb_chain_tf32``) at each operand shape a training
    step launched them at (``counts``: {kernel: {key: launches}}, phase
    17's last micro-step or phase 25's last mega-steps; keys (B, H, W, C,
    shortcut or N, q)), on random inputs and weights, against their plain
    versions (F32_TOL) and timed beside them and the bound; with ``prev``
    (the other checkout's layers.blocks) that checkout's block on the same
    inputs, in turns (prev, new, new, prev). Returns {kernel: [rows]}."""
    from ssgvc_tpu_torch.ops import dcb as dcb_ops
    from ssgvc_tpu_torch.ops import dcb_chain as chain_ops

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 70)
    run_fn = {"dcb_f32": dcb_ops.dcb_f32_cuda,
              "dcb_tf32": dcb_ops.dcb_tf32_cuda,
              "dcb_chain_f32": chain_ops.dcb_chain_f32_cuda,
              "dcb_chain_tf32": chain_ops.dcb_chain_tf32_cuda}
    rows = {}
    for name, keyed in counts.items():
        rows[name] = []
        single = not name.startswith("dcb_chain")
        pack = (dcb_ops.pack_tf32 if name.endswith("_tf32")
                else dcb_ops.pack_f32)
        fn = run_fn[name]
        for key, launched in sorted(keyed.items()):
            b, h, w, c, extra, with_q = key
            n = 1 if single else extra
            x = torch.tensor(rng.standard_normal((b, h, w, c)),
                             dtype=torch.float32, device=dev)
            q = (torch.linspace(0.5, 1.5, c, device=dev) if with_q
                 else None)
            blocks = [block_params(torch, c, rng, dev) for _ in range(n)]
            packed = torch.cat([pack(p) for p in blocks])
            if single:
                run = lambda: fn(x, packed, q, extra)
                plain = lambda: dcb_ops.dcb_plain(x, blocks[0], q, extra)
            else:
                run = lambda: fn(x, packed, q)
                plain = lambda: chain_ops.dcb_chain_plain(x, blocks, q)
            ref = plain()
            rel, max_err = check_f32(torch, f"{name} at {key}", run(), ref)
            fns = {"new": run}
            if prev is not None:
                mods = prev_modules(torch, prev, c, single and bool(extra),
                                    blocks, torch.float32)
                fns["prev"] = ((lambda: mods[0](x, q)) if single
                               else (lambda: prev.run_chain(x, mods, q)))
                check_f32(torch, f"prev {name} at {key}", fns["prev"](), ref)
            means, turns = timed_turns(torch, fns, reps)
            r = dict(key=list(key), blocks=n, per_step=launched,
                     ms=means["new"], plain_ms=cuda_ms(torch, plain, 5),
                     bound_ms=bound_ms(h, w, c, n, True, b),
                     bound_by=bound_by(h, w, c, n, True, b), rel_err=rel,
                     max_abs_err=max_err)
            line = ""
            if "prev" in means:
                r.update(prev_ms=means["prev"], turns=turns)
                line = f", parent {r['prev_ms']:.4f} ms"
            rows[name].append(r)
            print(f"  {name} at {where} shape {key} (x{launched} per "
                  f"step): kernel {r['ms']:.4f} ms{line}, plain "
                  f"{r['plain_ms']:.4f} ms, bound {1e3 * r['bound_ms']:.2f} "
                  f"us ({r['bound_by']}), max rel {rel:.2e} [{card}]")
    return rows


def simt_entries(widths, rd_counts, shapes):
    """{"kernels"} entries of the SIMT fp32 kernel, the route of C <= 64
    (no full-width site), per RD-recipe micro-step (phase 17, its main
    path): each shape's ms, plain ms and bound (:func:`phase_f32_shapes`)
    times its launches there, summed; max_abs_err over those shapes and
    every SIMT width case of phase 14."""
    out = []
    for name in ("dcb_f32", "dcb_chain_f32"):
        rs = shapes[name]
        per = lambda k: sum(r[k] * r["per_step"] for r in rs)
        if sum(r["per_step"] for r in rs) != rd_counts[name]:
            fail(f"{name}: launches by shape {rs} are not the micro-step's "
                 f"{rd_counts[name]}")
        out.append(dict(
            name=name, route="cuda",
            source="ssgvc_tpu_torch/csrc/dcb_f32.cu",
            replaces=("ssgvc_tpu/ops/pallas_dcb.py:68" if name == "dcb_f32"
                      else "ssgvc_tpu/ops/pallas_dcb_chain.py:61"),
            launches=rd_counts[name], max_abs_err=max(
                x["max_abs_err"] for x in widths[name] + rs),
            ms=per("ms"), plain_ms=per("plain_ms"),
            bound_ms=per("bound_ms"),
            parent_ms=(per("prev_ms") if all("prev_ms" in r for r in rs)
                       else None),
            bound_by=("operations" if any(r["bound_by"] == "operations"
                                         for r in rs) else "bytes"),
            library_ms=None,
            per="RD-recipe micro-step (rd-mid fp32, phase 17): each shape's "
                "time x its launches there, summed",
            shapes=rs, widths=widths[name]))
        parent = out[-1]["parent_ms"]
        print(f"  {name}: {out[-1]['ms']:.3f} ms per RD-recipe micro-step "
              f"({rd_counts[name]} launches), bound "
              f"{out[-1]['bound_ms']:.4f} ms" + (
                  f", parent {parent:.3f} ms" if parent is not None else ""))
    return out


def synced_ms(torch, fn):
    """(fn's result, host ms around it, the device synchronised)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def coded_gop(torch, dmci, dmc, frames, masks, qps, counts, want):
    """An I-frame then P-frames (packed io, the DPB carried), each frame
    timed with the device synchronised and its launches (``counts``:
    launch_counts' (reset, read)) compared with ``want`` (per frame: a dict
    of the counts that must match, the rest 0). Returns (per-frame ms,
    bpps, last DPB)."""
    from ssgvc_tpu_torch.ops.pixel import pixel_unshuffle

    reset, read = counts
    ms, bpps = [], []
    with torch.no_grad():
        reset()
        out, t = synced_ms(torch, lambda: dmci(frames[0], qps[0]))
        ms.append(t)
        got = [read()]
        bpps.append(out["bpp"])
        fp = pixel_unshuffle(frames[1:, 0], 8)
        mp = pixel_unshuffle(masks[1:, 0], 8)
        dpb = {"frame": pixel_unshuffle(out["dpb"]["frame"], 8),
               "feature": torch.zeros(
                   (1, fp.shape[1], fp.shape[2], dmc.cfg.ch_d),
                   dtype=dmc.dtype, device=fp.device)}
        for i in range(fp.shape[0]):
            reset()
            out, t = synced_ms(torch, lambda: dmc(
                fp[i:i + 1], qps[i + 1], dpb, after_i=(i == 0),
                mask=mp[i:i + 1]))
            ms.append(t)
            got.append(read())
            bpps.append(out["bpp"])
            dpb = out["dpb"]
    for i, (g, w) in enumerate(zip(got, want)):
        bad = {k: v for k, v in g.items() if v != w.get(k, 0)}
        if bad:
            fail(f"frame {i}: launches {g}, expected {w}")
    return ms, torch.cat(bpps), dpb, got


def gop_inputs(torch, seed, p_frames, dtype):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    frames = torch.rand((1 + p_frames, 1, H, W, 3), generator=g,
                        device=DEVICE).to(dtype)
    masks = (torch.rand((1 + p_frames, 1, H, W, 1), generator=g,
                        device=DEVICE) > 0.8).to(dtype)
    return frames, masks


def run_gops(torch, what, dmci, dmc, frames, masks, runs, want, card):
    """A warm-up GOP, then ``runs`` timed ones: ms per I-frame and per
    P-frame (medians over the runs; a P-frame's the mean over the GOP's),
    peak memory of the first timed run."""
    counts = launch_counts()
    n_p = frames.shape[0] - 1
    qps = [QP] + [QP] * n_p
    coded_gop(torch, dmci, dmc, frames, masks, qps, counts, want)
    torch.cuda.reset_peak_memory_stats()
    i_ms, p_ms = [], []
    for k in range(runs):
        ms, bpps, dpb, got = coded_gop(torch, dmci, dmc, frames, masks, qps,
                                       counts, want)
        if k == 0:
            peak = torch.cuda.max_memory_allocated()
        i_ms.append(ms[0])
        p_ms.append(float(np.mean(ms[1:])))
    b = check_frame(torch, what, bpps, dpb["frame"])
    r = dict(i_ms=float(np.median(i_ms)), p_ms=float(np.median(p_ms)),
             i_ms_runs=i_ms, p_ms_runs=p_ms, peak_bytes=peak,
             bpps=b.tolist(), launches_per_frame=got)
    print(f"{what}: I + {n_p} P {H}x{W}, {r['i_ms']:.2f} ms per I-frame, "
          f"{r['p_ms']:.2f} ms per P-frame (medians of {runs} GOPs after a "
          f"warm-up: I {', '.join(f'{x:.2f}' for x in i_ms)}; P "
          f"{', '.join(f'{x:.2f}' for x in p_ms)}), peak "
          f"{peak / 2**20:.0f} MiB allocated, launches per frame I "
          f"{got[0]}, P1 {got[1]}, P2 {got[2]}, bpp "
          f"{np.round(b, 4).tolist()} [{card}]")
    return r


#: The fp32 kernels of both routes: rd-mid runs both (C <= 64 on the SIMT
#: kernel, C = 96 on the 3xTF32 one)
FP32_KERNELS = ("dcb_f32", "dcb_chain_f32", "dcb_tf32", "dcb_chain_tf32")


def fp32_want(single, chain):
    """Launches of a full-width fp32 frame: every width on the 3xTF32
    route."""
    return {"dcb_tf32": single, "dcb_chain_tf32": chain}


def phase_fp32_full(torch, seed, card, iframe, main, plain_state):
    """float32 at full width on the card: DMCIConfig() and the performance
    DMCConfig at their default dtype (float32) on the I-frame's and the
    P-frame path's weights, an I-frame and FP32_P_FRAMES P-frames of
    1088x1920 with packed io, timed; every launch on the fp32 kernels. Then
    the bare default DMCConfig() (plain variant, raw io) codes one P-frame
    on the plain variant's weights."""
    from ssgvc_tpu_torch.config import DMCConfig, DMCIConfig
    from ssgvc_tpu_torch.models.dmc import DMC
    from ssgvc_tpu_torch.models.dmci import DMCI

    dmci = DMCI(DMCIConfig(), device=DEVICE)
    dmci.load_state_dict(iframe["state"], strict=True)
    dmc = DMC(DMCConfig.variant("performance", packed_io=True),
              device=DEVICE)
    dmc.load_state_dict(main["state"], strict=True)
    if not dmci.dtype == dmc.dtype == torch.float32:
        fail("the default configs are not float32")
    frames, masks = gop_inputs(torch, seed + 70, FP32_P_FRAMES,
                               torch.float32)
    want = ([fp32_want(IFRAME_LAUNCHES, 0), fp32_want(19, 5)]
            + [fp32_want(18, 5)] * (FP32_P_FRAMES - 1))
    r = run_gops(torch, "fp32 full width", dmci.eval(), dmc.eval(), frames,
                 masks, FP32_RUNS, want, card)
    # per GOP of P-frames, and per I-frame, by kernel: the last timed GOP's
    # counts
    got = r["launches_per_frame"]
    r["launches"] = {k: (sum(g[k] for g in got[1:]), got[0][k])
                     for k in ("dcb_tf32", "dcb_chain_tf32")}
    del dmc

    bare = DMC(DMCConfig(), device=DEVICE)
    bare.load_state_dict(plain_state, strict=True)
    reset, read = launch_counts()
    with torch.no_grad():
        i_out = dmci(frames[0], QP)
        dpb = {"frame": i_out["dpb"]["frame"],
               "feature": torch.zeros((1, H // 8, W // 8, 256),
                                      device=DEVICE)}
        reset()
        out = bare.eval()(frames[1, 0][None], QP, dpb, after_i=True)
        got = read()
    b = check_frame(torch, "DMC(DMCConfig()) P-frame", out["bpp"],
                    out["dpb"]["frame"])
    if {k: v for k, v in got.items() if v} != fp32_want(16, 5):
        fail(f"DMC(DMCConfig()): launches {got}")
    print(f"  DMC(DMCConfig()) (plain, raw io, {bare.dtype}) and "
          f"DMCI(DMCIConfig()) ({dmci.dtype}) on the card: a P-frame "
          f"{H}x{W} after the I-frame, bpp {float(b[0]):.4f}, launches "
          f"dcb_tf32 {got['dcb_tf32']} dcb_chain_tf32 "
          f"{got['dcb_chain_tf32']} [{card}]")
    return r


def phase_rdhalf(torch, seed, card):
    """The rd-half profile in bf16 (the CP = 192 chains, C = 160 and 184
    at frame size): I + RDHALF_P_FRAMES P-frames of 1088x1920, packed io,
    weights drawn from --seed."""
    from ssgvc_tpu_torch.config import DMCConfig, DMCIConfig
    from ssgvc_tpu_torch.models.dmc import DMC
    from ssgvc_tpu_torch.models.dmci import DMCI

    dmci = random_weights(torch, DMCI(DMCIConfig(
        dtype="bfloat16", **RDHALF_PROFILE["dmci"]), device=DEVICE),
        seed + 80, DMCI_HEADS)
    dmc = random_weights(torch, DMC(DMCConfig.variant(
        "performance", dtype="bfloat16", packed_io=True,
        **RDHALF_PROFILE["dmc"]), device=DEVICE), seed + 81)
    frames, masks = gop_inputs(torch, seed + 82, RDHALF_P_FRAMES,
                               torch.bfloat16)
    bf = lambda s, c: {"dcb": s, "dcb_chain": c}
    want = ([bf(IFRAME_LAUNCHES, 0), bf(19, 5)]
            + [bf(18, 5)] * (RDHALF_P_FRAMES - 1))
    return run_gops(torch, "rd-half bf16", dmci.eval(), dmc.eval(), frames,
                    masks, RDHALF_RUNS, want, card)


def phase_rd_recipe(torch, seed, card):
    """The RD recipe's path on the card (experiments/rd_tpu.py): the
    performance variant at rd-mid in fp32, RD_STEPS train_steps of B=RD_B
    device_synth clips (crop RD_CROP, T=RD_T) with the recipe's optimizer
    settings; then the batched RD evaluation over RD_EVAL_CLIPS clips of
    RD_EVAL_CROP at EVAL_QPS, then the liveness probe on two of them."""
    from ssgvc_tpu_torch.config import DMCConfig, DMCIConfig, TrainConfig
    from ssgvc_tpu_torch.data.device_synth import synth_batch
    from ssgvc_tpu_torch.ops import dcb as dcb_ops
    from ssgvc_tpu_torch.ops import dcb_chain as chain_ops
    from ssgvc_tpu_torch.ops import dcb_grad as dg
    from ssgvc_tpu_torch.training.evaluate import (evaluate_rd_batched,
                                                   latent_liveness,
                                                   liveness_collapsed,
                                                   make_batched_gop_eval)
    from ssgvc_tpu_torch.training.trainer import Trainer

    cfg = TrainConfig(dmc_variant="performance", accumulation_steps=1,
                      precision="fp32", roi_weight=100.0,
                      lambda_normalize=False)
    cfg.optimizer.base_lr = 7e-4
    cfg.optimizer.min_lr = 5e-5
    tr = Trainer(cfg, total_iters=RD_STEPS,
                 dmc_cfg=DMCConfig.variant("performance",
                                           **RD_PROFILE["dmc"]),
                 dmci_cfg=DMCIConfig(**RD_PROFILE["dmci"]), device=DEVICE)
    if tr.dmc.dtype != torch.float32:
        fail("the RD recipe's DMC is not float32")
    g = torch.Generator(device=DEVICE).manual_seed(seed + 90)
    batch = lambda: synth_batch(g, batch=RD_B, size=RD_CROP, seq_len=RD_T)
    first = batch()
    state = tr.init_state(torch.Generator().manual_seed(seed + 91), first)
    reset, read = launch_counts()
    noise = torch.Generator().manual_seed(seed + 92)
    host = np.random.default_rng(seed + 93)
    torch.cuda.reset_peak_memory_stats()
    ms, counts, losses = [], [], []
    for k in range(RD_STEPS):
        b = first if k == 0 else batch()
        qp = int(host.integers(0, 64))
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        reset()
        e0.record()
        state, aux = tr.train_step(state, b, qp, noise)
        e1.record()
        e1.synchronize()
        counts.append(read())
        ms.append(e0.elapsed_time(e1))
        row = {key: float(v) for key, v in aux.items()}
        losses.append(row)
        if not all(math.isfinite(v) for v in row.values()):
            fail(f"RD recipe micro-step {k + 1}: not finite: {row}")
        c = counts[-1]
        if c["dcb"] or c["dcb_chain"] or not all(
                c[k] for k in (*FP32_KERNELS, *BWD_REPLACES)):
            fail(f"RD recipe micro-step {k + 1}: launches {c}")
    peak = torch.cuda.max_memory_allocated()
    # the last micro-step's SIMT launches by operand shape (timed by
    # phase_f32_shapes)
    simt_counts = {"dcb_f32": dict(dcb_ops.shape_launches_f32),
                   "dcb_chain_f32": dict(chain_ops.shape_launches_f32)}
    # and the backward kernels' (timed by phase_rd_backward)
    bwd_counts = dict(dg.shape_launches)
    bad, zero = [], []
    for name, m in dcb_modules(tr.dmc):
        for p in m.core_params():
            if p.grad is None or not torch.isfinite(p.grad).all():
                bad.append(name)
            elif not p.grad.abs().max() > 0:
                zero.append(name)
    if bad or zero:
        fail(f"RD recipe: DepthConvBlock gradients not finite {bad[:4]} or "
             f"zero {zero[:4]}")
    step_ms = float(np.median(ms[2:]))
    print(f"RD recipe: rd-mid performance fp32, {RD_STEPS} micro-steps B="
          f"{RD_B} {RD_CROP}x{RD_CROP} T={RD_T}, {step_ms:.1f} ms per "
          f"micro-step (CUDA events, median of steps 3-{RD_STEPS}: "
          f"{', '.join(f'{x:.1f}' for x in ms[2:])}), peak "
          f"{peak / 2**20:.0f} MiB allocated, losses "
          f"{[round(r['loss'], 4) for r in losses]}, launches per micro-step "
          f"{counts[-1]}, {10 * len(dcb_modules(tr.dmc))} DepthConvBlock "
          f"gradients finite and nonzero [{card}]")
    print("  RD recipe backward kernels' launches per micro-step by operand "
          "shape: " + ", ".join(f"{k} {list(key)} x{n}" for (k, key), n
                                in sorted(bwd_counts.items())))

    clips_t = synth_batch(torch.Generator(device=DEVICE).manual_seed(
        seed + 94), batch=RD_EVAL_CLIPS, size=RD_EVAL_CROP, seq_len=RD_T)
    clips = [(clips_t["frames"][i].cpu().numpy(),
              clips_t["masks"][i].cpu().numpy())
             for i in range(RD_EVAL_CLIPS)]
    run = make_batched_gop_eval(tr.dmci, tr.dmc, tr.index_map,
                                tr.dmc_cfg.qp_shift, seq_len=RD_T)
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    curve = evaluate_rd_batched(run, clips, EVAL_QPS, device=DEVICE)
    eval_s = (time.perf_counter() - t0) / len(EVAL_QPS)
    eval_counts = read()
    if not (curve["qp"] == list(EVAL_QPS)
            and all(math.isfinite(v) and v > 0 for v in curve["bpp"])
            and all(math.isfinite(v) for v in curve["psnr"]
                    + curve["roi_psnr"])
            and all(eval_counts[k] for k in FP32_KERNELS)
            and not eval_counts["dcb"]):
        fail(f"RD eval: curve {curve}, launches {eval_counts}")
    print(f"  RD eval (make_batched_gop_eval + evaluate_rd_batched): "
          f"{RD_EVAL_CLIPS} clips {RD_EVAL_CROP}x{RD_EVAL_CROP} T={RD_T}, "
          f"{eval_s:.3f} s per QP (host metrics included), curve bpp "
          f"{np.round(curve['bpp'], 4).tolist()} PSNR "
          f"{np.round(curve['psnr'], 2).tolist()} ROI-PSNR "
          f"{np.round(curve['roi_psnr'], 2).tolist()}, launches "
          f"{eval_counts} [{card}]")
    report = latent_liveness(tr.dmc, clips[0], clips[1])
    collapsed = liveness_collapsed(report)
    if not all(math.isfinite(v) for r in report.values()
               for v in r.values()):
        fail(f"liveness: {report}")
    print(f"  liveness on two clips: {report}, collapsed {collapsed} "
          f"({RD_STEPS} micro-steps from fresh weights: a run check) "
          f"[{card}]")
    return dict(ms_per_micro_step=step_ms, ms_runs=ms, peak_bytes=peak,
                launches_per_micro_step=counts[-1], losses=losses,
                eval_s_per_qp=eval_s, curve=curve, eval_launches=eval_counts,
                liveness=report, collapsed=collapsed, batch=RD_B,
                crop=RD_CROP, seq_len=RD_T, simt_counts=simt_counts,
                bwd_shape_launches=[
                    dict(kernel=k, key=list(key), launches=n)
                    for (k, key), n in sorted(bwd_counts.items())])


#: what phase_rd_backward's sums are per, at phase 17's shapes
RD_BWD_PER = ("RD-recipe micro-step (rd-mid fp32, phase 17): each shape's "
              "time x its launches there, summed")


def rd_bwd_row(torch, k, key, rng, dev, pdg, reps=20):
    """gate_bwd, dw_bwd or grad_reduce with fp32 activations (the RD
    recipe's) at one operand shape ``key``, on random inputs: against its
    plain version (gate_bwd and dw_bwd by check_backward_kernels at the
    block's shape; grad_reduce on random partials of ``key``'s shape, also
    bit for bit against grad_reduce_order), timed beside the plain version,
    the library call (dw_bwd: convolution_backward; grad_reduce: torch.sum)
    and the bound; with ``pdg`` (the other checkout's ops.dcb_grad) its
    kernel on the same inputs, with its own partials, in turns (prev, new,
    new, prev)."""
    from ssgvc_tpu_torch.ops import dcb_grad as dg

    lib = prev = None
    if k == "grad_reduce":
        n, cols = key
        part = torch.tensor(rng.standard_normal((n, cols)),
                            dtype=torch.float32, device=dev)
        kern = lambda: dg.grad_reduce_cuda(part)
        plain = lambda: dg.grad_reduce_plain(part)
        lib = lambda: torch.sum(part, 0)
        if pdg is not None:
            prev = lambda: pdg.grad_reduce_cuda(part)
        _, err = check_close(torch, f"grad_reduce at {key}", kern(), plain(),
                             BWD_FP32_TOL)
        if not torch.equal(kern().cpu(), dg.grad_reduce_order(part.cpu())):
            fail(f"grad_reduce at {key}: not grad_reduce_order's sums bit "
                 "for bit")
        nbytes = 4 * n * cols + 4 * cols
    else:
        b, h, w, c = key[:4]
        with_q = k == "gate_bwd" and bool(key[4])
        case = bwd_case(torch, rng, b, h, w, c, with_q, dev, torch.float32)
        err = check_backward_kernels(torch, case)[k]
        cols = (dg.GATE_COLS + dg.DW_COLS) * c
        part_k = torch.zeros(dg.partial_rows(case["a0"]), cols, device=dev)
        part_p = torch.zeros(1, cols, device=dev)
        part_q = (torch.zeros(pdg.partial_rows(case["a0"]), cols, device=dev)
                  if pdg is not None else None)
        if k == "gate_bwd":
            args, col, name = (case["df"], case["p"], case["dy"], case["q"],
                               case["resid"]), 0, "gate_bwd"
        else:
            args, col, name = (case["dg"], case["a0"], case["taps"],
                               case["du"]), dg.GATE_COLS * c, "dw_bwd"
            hn = dg.wsilu(case["a0"]).permute(0, 3, 1, 2)
            dgn = case["dg"].permute(0, 3, 1, 2)
            wdw = case["taps"].t().reshape(c, 1, 3, 3)
            lib = lambda: torch.ops.aten.convolution_backward(
                dgn, hn, wdw, [c], [1, 1], [1, 1], [1, 1], False, [0, 0], c,
                [True, True, True])
        kern = lambda: getattr(dg, name + "_cuda")(*args, part_k, col)
        plain = lambda: getattr(dg, name + "_plain")(*args, part_p, col)
        if pdg is not None:
            prev = lambda: getattr(pdg, name + "_cuda")(*args, part_q, col)
        nbytes = bwd_bytes(b, h, w, c, with_q, 4)[k]
    fns = {"new": kern} if prev is None else {"new": kern, "prev": prev}
    means, turns = timed_turns(torch, fns, reps)
    r = dict(ms=means["new"], plain_ms=cuda_ms(torch, plain, reps),
             library_ms=cuda_ms(torch, lib, reps) if lib else None,
             bytes=nbytes, bound_ms=1e3 * nbytes / H100_BYTES_PER_S,
             max_abs_err=err)
    if prev is not None:
        r.update(prev_ms=means["prev"], turns=turns)
    return r


def phase_rd_backward(torch, seed, card, shape_launches, prev=False,
                      where="RD-recipe", per=RD_BWD_PER, reps=20):
    """Each backward kernel with fp32 activations (the RD recipe's) at each
    operand shape an fp32 training step launched it at (``shape_launches``:
    phase 17's bwd_shape_launches, or phase 25's), on random inputs: dw_fwd
    by :func:`dw_fwd_row`, the others by :func:`rd_bwd_row`; with ``prev``
    (--prev-port loaded) the other checkout's kernels in turns (dw_fwd's g
    equal to its). Returns {kernel: the kernels-line summary: each shape's
    times x its launches, summed}."""
    import importlib

    pdg = importlib.import_module("prev_port.ops.dcb_grad") if prev else None
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 110)
    rows = {k: [] for k in BWD_REPLACES}
    for e in shape_launches:
        k, key = e["kernel"], tuple(e["key"])
        if k == "dw_fwd":
            case = bwd_case(torch, rng, *key, False, dev, torch.float32)
            r = dw_fwd_row(torch, case["a0"], case["taps"], case["b2"],
                           torch.float32, pdg, reps)
        else:
            r = rd_bwd_row(torch, k, key, rng, dev, pdg, reps)
        r.update(shape=list(key), per_step=e["launches"])
        rows[k].append(r)
        prev_txt = (f", parent {r['prev_ms']:.4f} in turns"
                    if "prev_ms" in r else "")
        lib_txt = (f", library {r['library_ms']:.4f}"
                   if r["library_ms"] is not None else "")
        print(f"  {k} at {where} shape {list(key)} fp32 (x"
              f"{e['launches']} per step): kernel {r['ms']:.4f} ms"
              f"{prev_txt}, plain {r['plain_ms']:.4f}{lib_txt}, bound "
              f"{1e3 * r['bound_ms']:.2f} us ({r['bytes']} B at 3.35 TB/s), "
              f"max abs {r['max_abs_err']:.3g} [{card}]")
    out = {}
    for k, rs in rows.items():
        if not rs:
            fail(f"{k}: no launch counted in the {where} step")
        sum_of = lambda f: sum(r[f] * r["per_step"] for r in rs)
        out[k] = dict(launches=sum(r["per_step"] for r in rs),
                      ms=sum_of("ms"), plain_ms=sum_of("plain_ms"),
                      library_ms=(sum_of("library_ms")
                                  if rs[0]["library_ms"] is not None
                                  else None),
                      bound_ms=sum_of("bound_ms"),
                      max_abs_err=max(r["max_abs_err"] for r in rs),
                      per=per, shapes=rs)
        if pdg is not None:
            out[k]["prev_ms"] = sum_of("prev_ms")
        print(f"  {k}: {out[k]['ms']:.3f} ms per {where} step "
              f"({out[k]['launches']} launches), plain "
              f"{out[k]['plain_ms']:.3f}, bound {out[k]['bound_ms']:.4f} ms"
              + (f", parent {out[k]['prev_ms']:.3f} ms in turns"
                 if pdg is not None else "") + f" [{card}]")
    return out


def phase_coded_f32(torch, seed, card):
    """The real coder in fp32: VideoCodec at rd-mid, float32, I + 2 P of
    192x192; every decoded frame and DPB equal (torch.equal) to the
    encoder's; launches on the fp32 kernels only."""
    from ssgvc_tpu_torch.coding.codec import VideoCodec
    from ssgvc_tpu_torch.config import DMCConfig, DMCIConfig
    from ssgvc_tpu_torch.models.dmc import DMC
    from ssgvc_tpu_torch.models.dmci import DMCI

    hw, t_len = RD_EVAL_CROP, 3
    dmci = random_weights(torch, DMCI(DMCIConfig(**RD_PROFILE["dmci"]),
                                      device=DEVICE), seed + 100, DMCI_HEADS)
    dmc = random_weights(torch, DMC(DMCConfig.variant(
        "performance", **RD_PROFILE["dmc"]), device=DEVICE), seed + 101)
    codec = VideoCodec(dmci.eval(), dmc.eval())
    rng = np.random.default_rng(seed + 102)
    frames = rng.uniform(0, 1, (t_len, hw, hw, 3)).astype(np.float32)
    masks = (rng.uniform(0, 1, (t_len, hw, hw, 1)) > 0.8).astype(np.float32)
    dev = lambda a: torch.from_numpy(a)[None].to(DEVICE)
    reset, read = launch_counts()
    reset()
    enc = codec.dmci_compress(dev(frames[0]), QP)
    dec = codec.dmci_decompress(enc["bit_stream"], hw, hw, QP)
    same = [torch.equal(enc["x_hat"], dec["x_hat"])]
    nbytes = [len(enc["bit_stream"])]
    feat0 = torch.zeros((1, hw // 8, hw // 8, dmc.cfg.ch_d), device=DEVICE)
    dpb_e = {"frame": enc["x_hat"], "feature": feat0}
    dpb_d = {"frame": dec["x_hat"], "feature": feat0}
    for t in range(1, t_len):
        e = codec.dmc_compress(dev(frames[t]), QP, dpb_e, after_i=(t == 1),
                               mask=dev(masks[t]))
        d = codec.dmc_decompress(e["bit_stream"], hw, hw, QP, dpb_d,
                                 after_i=(t == 1))
        same.append(torch.equal(e["x_hat"], d["x_hat"])
                    and torch.equal(e["dpb"]["frame"], d["dpb"]["frame"])
                    and torch.equal(e["dpb"]["feature"],
                                    d["dpb"]["feature"]))
        nbytes.append(len(e["bit_stream"]))
        dpb_e, dpb_d = e["dpb"], d["dpb"]
    got = read()
    if not all(same):
        fail(f"fp32 coded GOP: decoder differs from the encoder: {same}")
    if got["dcb"] or got["dcb_chain"] or not all(got[k]
                                                 for k in FP32_KERNELS):
        fail(f"fp32 coded GOP: launches {got}")
    if dmc.dtype != torch.float32 or dec["x_hat"].dtype != torch.float32:
        fail("fp32 coded GOP: not float32")
    print(f"coded fp32: VideoCodec rd-mid float32, I + {t_len - 1} P "
          f"{hw}x{hw}, bytes {nbytes}, every decoded frame and DPB equal to "
          f"the encoder's (torch.equal), launches {got} [{card}]")
    return dict(bytes=nbytes, launches=got)


#: Phase 19: the Waymo fixture (records per TFRecord: 5 + 5 clip windows
#: of 4 frames, 8 of them for training), its frames' size (the Waymo front
#: camera's), and the run: 2 steps an epoch, validation every
#: CLI_VAL_EVERY steps; the model profile (the rehearsal on the CPU sets
#: "tiny")
CLI_RECORDS = (8, 8)
WAYMO_HW = (1280, 1920)
CLI_EPOCHS, CLI_VAL_EVERY, CLI_TOP_K, CLI_RESUME_STEPS = 5, 5, 1, 2
CLI_PROFILE = "full"


def waymo_fixture(root: Path, seed: int) -> None:
    """TFRecords of WAYMO_HW FRONT JPEGs under ``root/waymo`` (a coarse
    scene panning by 32 pixels a frame, plus noise, so the JPEGs carry
    detail) and their mask cache under ``root/seg_cache``, built by
    build_cache with a stub segmenter seeded from ``seed``: 1-3
    rectangles a frame, of kept and dropped classes."""
    from ssgvc_tpu_torch.data import tfrecord, waymo_proto
    from ssgvc_tpu_torch.data.build_cache import build_cache

    rng = np.random.default_rng(seed + 140)
    h, w = WAYMO_HW
    (root / "waymo").mkdir()
    for i, n in enumerate(CLI_RECORDS):
        scene = rng.uniform(30, 225, (h // 32, w // 32 + n, 3))
        records = []
        for t in range(n):
            coarse = scene[:, t:t + w // 32]
            rgb = np.repeat(np.repeat(coarse, 32, 0), 32, 1)
            rgb = np.clip(rgb + rng.normal(0, 4, rgb.shape), 0, 255)
            records.append(waymo_proto.build_frame_proto(
                waymo_proto.encode_jpeg(rgb.astype(np.uint8)),
                context_name=f"fixture-{i}"))
        tfrecord.write_records(str(root / "waymo" / f"seg{i}.tfrecord"),
                               records)
    seg_rng = np.random.default_rng(seed + 141)

    def segment(rgb):
        out = []
        for _ in range(int(seg_rng.integers(1, 4))):
            m = np.zeros(rgb.shape[:2], np.float32)
            ph, pw = (int(v) for v in seg_rng.integers(60, 160, 2))
            y = int(seg_rng.integers(0, rgb.shape[0] - ph))
            x = int(seg_rng.integers(0, rgb.shape[1] - pw))
            m[y:y + ph, x:x + pw] = 0.9
            out.append((m, int(seg_rng.choice((0, 2, 5, 7)))))
        return out

    stats = build_cache(str(root / "waymo" / "*.tfrecord"),
                        str(root / "seg_cache"), segmenter=segment)
    if stats != {"written": sum(CLI_RECORDS), "skipped": 0}:
        fail(f"mask cache: {stats}")


def timed_train_iter(timing):
    """``ClipDataModule.train_iter`` that records each batch's host time
    inside next() in ``timing["data_ms"]`` and when that next() began in
    ``timing["start"]``: the data path, timed without a CLI option."""
    from ssgvc_tpu_torch.data import dataset as ds_mod

    train_iter = ds_mod.ClipDataModule.train_iter

    def timed_iter(self, loop=True):
        t0 = time.perf_counter()
        for batch in train_iter(self, loop):
            timing["data_ms"].append(1e3 * (time.perf_counter() - t0))
            timing["start"].append(t0)
            yield batch
            t0 = time.perf_counter()
    return timed_iter


def phase_train_cli(torch, seed, card, root: Path):
    """The trainer CLI from data on disk (module docstring, phase 19), in
    ``root / "video"``, on the fixture it writes under ``root`` (kept there
    for phases 20-21, as is the run's checkpoints/last: the result's
    "last")."""
    import csv
    from unittest import mock

    from ssgvc_tpu_torch import trainer_seg_video_model as cli
    from ssgvc_tpu_torch.data import dataset as ds_mod
    from ssgvc_tpu_torch.training.trainer import Trainer
    from ssgvc_tpu_torch.utils.checkpoint import restore_checkpoint
    from ssgvc_tpu_torch.utils.logging import TRAIN_HEADERS, VAL_HEADERS

    timing = {"data_ms": [], "step_ms": [], "wall_ms": [], "start": []}
    timed_iter = timed_train_iter(timing)
    train_step = Trainer.train_step

    def timed_step(self, state, batch, qp, generator):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, aux = train_step(self, state, batch, qp, generator)
        e1.record()
        e1.synchronize()
        timing["step_ms"].append(e0.elapsed_time(e1))
        timing["wall_ms"].append(1e3 * (time.perf_counter()
                                        - timing["start"][-1]))
        row = {k: float(v) for k, v in aux.items()}
        if not all(math.isfinite(v) for v in row.values()):
            fail(f"train CLI step {state.step}: not finite: {row}")
        return state, aux

    reset, read = launch_counts()
    argv = [f"--device={DEVICE}", f"model_profile={CLI_PROFILE}",
            "precision=bf16-mixed", "dmc_variant=performance",
            f"dataset.batch_size={TRAIN_B}", f"dataset.crop_size={TRAIN_HW}",
            f"dataset.seq_len={TRAIN_T}", "dataset.dataset_type=waymo",
            f"dataset.data_dir={root / 'waymo'}",
            f"dataset.seg_cache_dir={root / 'seg_cache'}",
            "dataset.train_val_test_split=[0.8, 0.2, 0.0]",
            f"epochs={CLI_EPOCHS}", f"val_check_interval={CLI_VAL_EVERY}",
            f"save_top_k={CLI_TOP_K}", "log_interval=1", f"seed={seed}"]
    work = root / "video"
    work.mkdir()
    t0 = time.perf_counter()
    waymo_fixture(root, seed)
    fixture_s = time.perf_counter() - t0
    with contextlib.chdir(work), \
            mock.patch.object(ds_mod.ClipDataModule, "train_iter",
                              timed_iter), \
            mock.patch.object(Trainer, "train_step", timed_step):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        t0 = time.perf_counter()
        trainer, state, log_dir = cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read()
        peak = torch.cuda.max_memory_allocated()
        steps = len(timing["step_ms"])
        windows = sum(n - TRAIN_T + 1 for n in CLI_RECORDS)
        want_steps = CLI_EPOCHS * (round(0.8 * windows) // TRAIN_B)
        launched = ("dcb", "dcb_chain", *BWD_REPLACES)
        if steps != want_steps or not all(counts[k] for k in launched):
            fail(f"train CLI: {steps} steps (expected {want_steps}), "
                 f"launches {counts}")
        log = work / log_dir
        files = sorted(str(p.relative_to(log)) for p in log.rglob("*")
                       if p.is_file())
        vals = [s for s in range(steps) if (s + 1) % CLI_VAL_EVERY == 0]
        tops = [f for f in files if f.startswith("checkpoints/step")]
        want = ({"checkpoints/last", "config.json", "train_metrics.csv",
                 "val_metrics.csv"}
                | {f"images/recon{p}_step{s}.png" for s in vals
                   for p in ("", "_p")})
        if not (want <= set(files) and 1 <= len(tops) <= CLI_TOP_K
                and set(files) == want | set(tops)):
            fail(f"train CLI wrote {files}")
        for name, headers, n in (("train_metrics.csv", TRAIN_HEADERS, steps),
                                 ("val_metrics.csv", VAL_HEADERS, len(vals))):
            with open(log / name) as f:
                rows = list(csv.reader(f))
            if not (rows[0] == headers and len(rows) == n + 1
                    and all(math.isfinite(float(v)) for r in rows[1:]
                            for v in r)):
                fail(f"train CLI {name}: {rows[:3]}... ({len(rows)} rows)")
        grads = [p.grad for p in trainer.dmc.parameters()
                 if p.grad is not None]
        if not (grads and all(torch.isfinite(g).all() for g in grads)):
            fail("train CLI: a gradient is not finite")

        # checkpoints/last into a new Trainer: the same state
        last = str(log / "checkpoints" / "last")
        other = Trainer(trainer.cfg, total_iters=steps, device=DEVICE)
        other.init_state(torch.Generator().manual_seed(seed + 1))
        restored = restore_checkpoint(last, other)

        def tensors(tr, st):
            opt = tr.tx.state_dict()
            out = {f"dmc/{k}": v for k, v in tr.dmc.state_dict().items()}
            out.update({f"dmci/{k}": v
                        for k, v in tr.dmci.state_dict().items()})
            out.update({f"acc/{k}": v for k, v in (opt["acc"] or {}).items()})
            out.update({f"opt/{n}/{k}": v for n, sd in opt["state"].items()
                        for k, v in sd.items()})
            out.update({k: getattr(st, k) for k in ("alm_mu", "alm_h_accum",
                                                     "alm_h_count")})
            return out, (st.step, opt["count"], opt["mini_step"])

        live, live_n = tensors(trainer, state)
        got, got_n = tensors(other, restored)
        differ = [k for k in live if k not in got
                  or not torch.equal(got[k].cpu(), live[k].cpu())]
        if live_n != got_n or set(got) != set(live) or differ:
            fail(f"train CLI: the restored state differs from the live one: "
                 f"counts {got_n} vs {live_n}, {differ[:5]}")
        batch = next(ds_mod.make_datamodule(trainer.cfg).val_iter(loop=True))
        evals = [tr.eval_step(st, batch, QP,
                              torch.Generator().manual_seed(seed + 2))
                 for tr, st in ((trainer, state), (other, restored))]
        if not all(torch.equal(evals[0][k], evals[1][k]) for k in evals[0]):
            fail(f"train CLI: eval_step from the restored state differs: "
                 f"{evals}")
        del other, restored

        # the CLI again, resuming from last for CLI_RESUME_STEPS steps
        n_before = len(timing["step_ms"])
        # 2 steps an epoch
        trainer2, state2, log_dir2 = cli.main(
            argv + [f"epochs={CLI_RESUME_STEPS // 2}", "exp_name=resumed",
                    f"resume_from_checkpoint={last}"])
        resumed_steps = len(timing["step_ms"]) - n_before
        if not (resumed_steps == CLI_RESUME_STEPS
                and state2.step == state.step + CLI_RESUME_STEPS
                and (work / log_dir2 / "checkpoints" / "last").is_file()):
            fail(f"train CLI resume: {resumed_steps} steps to step "
                 f"{state2.step} from {state.step}")
        del trainer, trainer2
    med = lambda xs: float(np.median(xs[:steps]))
    out = dict(source="waymo", steps=steps + resumed_steps,
               ms_per_step=med(timing["wall_ms"]),
               data_ms_per_step=med(timing["data_ms"]),
               step_ms=med(timing["step_ms"]), val_runs=len(vals),
               checkpoints=len(tops) + 1, resumed_step=state2.step,
               peak_mib=peak / 2 ** 20, launches=counts,
               data_ms_runs=timing["data_ms"][:steps],
               step_ms_runs=timing["step_ms"][:steps],
               wall_ms_runs=timing["wall_ms"][:steps],
               run_s=run_s, fixture_s=fixture_s,
               records=list(CLI_RECORDS), frame_hw=list(WAYMO_HW),
               last=last)
    print(f"train CLI: {steps} steps of B={TRAIN_B} {TRAIN_HW}x{TRAIN_HW} "
          f"T={TRAIN_T} clips of {WAYMO_HW[1]}x{WAYMO_HW[0]} Waymo JPEGs "
          f"(fixture and mask cache {fixture_s:.1f} s), "
          f"{out['ms_per_step']:.1f} ms per step (host, next() to the "
          f"step's end; median), of which data {out['data_ms_per_step']:.1f}"
          f" ms (host, inside next()) and train_step {out['step_ms']:.1f} ms"
          f" (CUDA events); {len(vals)} validations, files {files}; whole "
          f"run {run_s:.1f} s; peak {out['peak_mib']:.0f} MiB allocated; "
          f"launches {counts}; restored state equal, eval_step equal bit "
          f"for bit; resumed {resumed_steps} steps to step {state2.step} "
          f"[{card}]")
    return out


#: Phase 20: the image CLI's run on phase 19's fixture, at its default
#: YAML's model and data (full DMCI, bf16-mixed, B=16 256x256 crops of
#: T=4 clips; 9 training windows, so one step an epoch); a step's launches
#: (one forward and one backward of each of the DMCI's 42 blocks)
IMAGE_EPOCHS = 3
IMAGE_B, IMAGE_HW = 16, 256
IMAGE_LAUNCHES = {"dcb": 42, "dcb_chain": 0, "dcb_f32": 0,
                  "dcb_chain_f32": 0, "dcb_tf32": 0, "dcb_chain_tf32": 0,
                  "dw_fwd": 42, "gate_bwd": 42, "dw_bwd": 42,
                  "grad_reduce": 42}
IMAGE_LOGGED = ("loss", "bpp", "bpp_y", "bpp_z", "mse", "psnr")
# The shapes an image step's block backwards give their kernels at the
# full profile (B = 16, 256x256 crops): (rows, cols, C, q, sites)
IMAGE_BWD_SHAPES = [
    (32, 32, 368, False, "enc.enc_2_0..5, dec.dec_1_0.conv, "
     "dec.dec_1_1..11"),
    (32, 32, 368, True, "enc.enc_1 (* q_scale_enc), dec.dec_1_12 (* q)"),
    (32, 32, 192, False, "dec.dec_2"),
    (16, 16, 512, False, "y_prior_fusion_0..2, y_spatial_prior_adaptor_1..3"
     ", y_spatial_prior_0..2 (three passes)"),
    (16, 16, 256, False, "hyper_dec_2"),
    (16, 16, 128, False, "hyper_enc_0, hyper_dec_1.conv"),
    (8, 8, 128, False, "hyper_enc_1.conv, hyper_dec_0.conv"),
    (4, 4, 128, False, "hyper_enc_2.conv"),
]


def dcb_forward_shapes(torch, model, x):
    """{(B, rows, cols, C, shortcut, q): blocks} of every DepthConvBlock
    launch of one forward of ``model`` on ``x`` (no graph)."""
    shapes = {}

    def hook(mod, args, out):
        key = (*out.shape, mod.shortcut, len(args) > 1 and args[1] is not None)
        shapes[key] = shapes.get(key, 0) + 1

    handles = [m.register_forward_hook(hook) for _, m in dcb_modules(model)]
    try:
        with torch.no_grad():
            model(x, QP)
    finally:
        for h in handles:
            h.remove()
    return shapes


def dcb_step_rows(torch, seed, card, shapes, prev=None):
    """The bf16 single-block kernel at each forward shape of ``shapes``
    ({(B, rows, cols, C, shortcut, q): launches per step}): against its
    plain version (REL_TOL), timed beside it and its bound, with
    ``prev`` (--prev-port's layers.blocks) the other checkout's block in
    turns. Returns the step's sums (time x launches) with the rows."""
    from ssgvc_tpu_torch.ops import dcb as dcb_ops

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 150)
    bf16 = torch.bfloat16
    rows = []
    for (b, h, w, c, sc, with_q), n in sorted(shapes.items()):
        x = torch.tensor(rng.standard_normal((b, h, w, c)), dtype=bf16,
                         device=dev)
        q = (torch.linspace(0.5, 1.5, c, device=dev).to(bf16) if with_q
             else None)
        params = block_params(torch, c, rng, dev)
        packed = dcb_ops.pack_kernel(params, bf16)
        fns = {"new": lambda: dcb_ops.dcb_cuda(x, packed, q, sc)}
        if prev is not None:
            mod = prev_modules(torch, prev, c, sc, [params], bf16)[0]
            fns["prev"] = lambda: mod(x, q)
        plain = lambda: dcb_ops.dcb_plain(x, params, q, sc)
        ref = plain()
        what = f"dcb {b}x{h}x{w}x{c} sc={int(sc)} q={int(with_q)}"
        rel, err = check_close(torch, what, fns["new"](), ref)
        if "prev" in fns:
            check_close(torch, f"the other checkout's {what}", fns["prev"](),
                        ref)
        means, turns = timed_turns(torch, fns, 20)
        r = dict(shape=[b, h, w, c], shortcut=sc, q=with_q, per_step=n,
                 ms=means["new"], plain_ms=cuda_ms(torch, plain, 5),
                 bound_ms=bound_ms(h, w, c, 1, b=b),
                 bound_by=bound_by(h, w, c, 1, b=b), rel_err=rel,
                 max_abs_err=err)
        if "prev" in means:
            r.update(prev_ms=means["prev"], turns=turns)
        rows.append(r)
        prev_txt = (f", parent {r['prev_ms']:.4f} in turns"
                    if "prev_ms" in r else "")
        print(f"  {what} (x{n} per image step): kernel {r['ms']:.4f} ms"
              f"{prev_txt}, plain {r['plain_ms']:.4f}, bound "
              f"{1e3 * r['bound_ms']:.1f} us ({r['bound_by']}), rel "
              f"{rel:.2e}, max abs {err:.3g} [{card}]")
    per = lambda k: sum(r[k] * r["per_step"] for r in rows)
    out = dict(launches=sum(r["per_step"] for r in rows), ms=per("ms"),
               plain_ms=per("plain_ms"), bound_ms=per("bound_ms"),
               library_ms=None, max_abs_err=max(r["max_abs_err"]
                                                for r in rows),
               per="image-CLI step (phase 20): per-shape time x launches "
                   "per step, summed", shapes=rows)
    if prev is not None:
        out["prev_ms"] = per("prev_ms")
    return out


#: The image cross-check's reconstruction head scale (unsaturated_recon):
#: the largest of 0.1, 0.03, 0.01 whose full-width reconstruction keeps
#: >= 95% of its pixels inside (0, 1) at CPU fp32 (97.3% at 0.1,
#: experiments/dmci_grad_gap.py on the card)
IMAGE_RECON_SCALE = 0.1


def unsaturated_recon(torch, model, scale):
    """Draw ``model``'s (a DMCI's) reconstruction head small: dec.dec_2's
    adaptor and residual tails (dc_3, ffn_2) times ``scale`` and the
    adaptor's bias at 0.5, so the reconstruction sits inside the [0, 1]
    clamp around mid-grey, as a trained codec's does, instead of
    saturating it at most pixels."""
    blk = model.dec.dec_2
    with torch.no_grad():
        for conv in (blk.adaptor, blk.dc_3, blk.ffn_2):
            conv.weight.mul_(scale)
        blk.adaptor.bias.fill_(0.5)
    return model


def image_cross_check(torch, seed, hw=128, b=2):
    """The image loss and its DMCI gradient at full width, train=False, on
    the same weights (DMCI_HEADS, the reconstruction head unsaturated:
    :func:`unsaturated_recon`; at random weights the clamp saturates most
    pixels, and which ones flips with bf16's rounding): the card in bf16
    against the CPU port in fp32, beside the CPU port's own bf16 (the same
    rounding points) and the card against that CPU bf16. Passes when the loss agrees with fp32
    within 5e-2 and the card's gradient cosine is >= XTRAIN_COSINE to
    fp32's and >= XTRAIN_KERNEL_COSINE to the CPU bf16 one."""
    from ssgvc_tpu_torch.config import CompressionConfig, DMCIConfig
    from ssgvc_tpu_torch.models.dmci import DMCI
    from ssgvc_tpu_torch.trainer_image_model import image_loss

    rng = np.random.default_rng(seed + 160)
    x = torch.tensor(rng.uniform(0, 1, (b, hw, hw, 3)), dtype=torch.float32)
    out, state = {}, None
    for name, dev, dtype in (("cpu32", "cpu", "float32"),
                             ("cpu16", "cpu", "bfloat16"),
                             ("card", DEVICE, "bfloat16")):
        t0 = time.perf_counter()
        model = DMCI(DMCIConfig(dtype=dtype), device=dev)
        if state is None:
            random_weights(torch, model, seed, DMCI_HEADS)
            unsaturated_recon(torch, model, IMAGE_RECON_SCALE)
            state = model.state_dict()
        else:
            model.load_state_dict(state, strict=True)
        loss, _ = image_loss(model, x.to(dev), QP, CompressionConfig(),
                             train=False)
        loss.backward()
        # float64: an fp32 dot over the ~60M entries drifts by ~0.4%
        grad = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).double().reshape(-1).cpu()
                          for p in model.parameters()])
        out[name] = (float(loss.detach()), grad, time.perf_counter() - t0)
        del model

    def gap(a, ref):
        (la, ga, _), (lr, gr, _) = out[a], out[ref]
        cos = torch.dot(ga, gr) / (torch.linalg.vector_norm(ga)
                                   * torch.linalg.vector_norm(gr))
        return dict(loss_rel=abs(la - lr) / abs(lr), grad_cosine=float(cos),
                    grad_rel=float(torch.linalg.vector_norm(ga - gr)
                                   / torch.linalg.vector_norm(gr)))

    r = dict(card_vs_cpu32=gap("card", "cpu32"),
             cpu16_vs_cpu32=gap("cpu16", "cpu32"),
             card_vs_cpu16=gap("card", "cpu16"),
             loss={k: v[0] for k, v in out.items()},
             seconds={k: v[2] for k, v in out.items()})
    c, g, k = r["card_vs_cpu32"], r["cpu16_vs_cpu32"], r["card_vs_cpu16"]
    print(f"cross-check image loss {hw}x{hw} B={b} QP {QP} (recon head at "
          f"{IMAGE_RECON_SCALE}): card-bf16 vs "
          f"cpu-fp32 loss rel {c['loss_rel']:.2e} (tol 5e-2), DMCI gradient"
          f" cosine {c['grad_cosine']:.5f} (tol >= {XTRAIN_COSINE}; rel "
          f"{c['grad_rel']:.3f}); card-bf16 vs cpu-bf16 cosine "
          f"{k['grad_cosine']:.5f} (tol >= {XTRAIN_KERNEL_COSINE}; rel "
          f"{k['grad_rel']:.3f}); the CPU's own bf16 vs fp32: loss rel "
          f"{g['loss_rel']:.2e}, cosine {g['grad_cosine']:.5f}; seconds "
          f"{r['seconds']}")
    if not (c["loss_rel"] <= 5e-2 and c["grad_cosine"] >= XTRAIN_COSINE
            and k["grad_cosine"] >= XTRAIN_KERNEL_COSINE):
        fail("image CLI: the card's bf16 image loss or DMCI gradient is too "
             "far from the CPU port's fp32 or bf16 one")
    return r


def phase_image_cli(torch, seed, card, root: Path, prev=None):
    """The image trainer CLI (module docstring, phase 20) in ``root /
    "image"`` on phase 19's fixture under ``root``. Returns its numbers,
    with "dcb" (the forward kernel's rows) and "backward" (each backward
    kernel's, weighed by a step's launches) for the kernels line."""
    import csv
    from unittest import mock

    from ssgvc_tpu_torch import trainer_image_model as icli
    from ssgvc_tpu_torch.config import DMCIConfig, TrainConfig
    from ssgvc_tpu_torch.data import dataset as ds_mod
    from ssgvc_tpu_torch.models.dmci import DMCI
    from ssgvc_tpu_torch.ops import dcb_grad as dg
    from ssgvc_tpu_torch.training.trainer import Trainer
    from ssgvc_tpu_torch.utils.checkpoint import (load_pretrained,
                                                  restore_checkpoint)
    from ssgvc_tpu_torch.utils.logging import TRAIN_HEADERS

    timing = {"data_ms": [], "step_ms": [], "wall_ms": [], "start": []}
    timed_iter = timed_train_iter(timing)
    train_step = icli.train_step

    def timed_step(*args):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        aux = train_step(*args)
        e1.record()
        e1.synchronize()
        timing["step_ms"].append(e0.elapsed_time(e1))
        timing["wall_ms"].append(1e3 * (time.perf_counter()
                                        - timing["start"][-1]))
        return aux

    reset, read = launch_counts()
    work = root / "image"
    work.mkdir()
    argv = [f"--device={DEVICE}", f"dataset.data_dir={root / 'waymo'}",
            f"dataset.seg_cache_dir={root / 'seg_cache'}",
            f"epochs={IMAGE_EPOCHS}", "log_interval=1", f"seed={seed}"]
    with contextlib.chdir(work), \
            mock.patch.object(ds_mod.ClipDataModule, "train_iter",
                              timed_iter), \
            mock.patch.object(icli, "train_step", timed_step):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        t0 = time.perf_counter()
        res = icli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read()
        shape_counts = dict(dg.shape_launches)
    peak = torch.cuda.max_memory_allocated()
    model, steps = res["model"], res["steps"]
    want = {k: v * steps for k, v in IMAGE_LAUNCHES.items()}
    if not (steps == IMAGE_EPOCHS == len(timing["step_ms"])
            and counts == want):
        fail(f"image CLI: {steps} steps ({len(timing['step_ms'])} timed; "
             f"expected {IMAGE_EPOCHS}), launches {counts}, expected {want}")
    per_step = {}
    for key, n in shape_counts.items():
        if n % steps:
            fail(f"image CLI: {n} launches of {key} in {steps} steps")
        per_step[key] = n // steps

    # the files the JAX CLI writes
    if (work / icli.CONFIG_PATH).read_text() != icli.DEFAULT_YAML:
        fail("image CLI: the YAML it wrote is not its default")
    log = work / res["log_dir"]
    files = sorted(str(p.relative_to(log)) for p in log.rglob("*")
                   if p.is_file())
    if files != ["checkpoints/last", "config.json", "train_metrics.csv"]:
        fail(f"image CLI wrote {files}")
    with open(log / "train_metrics.csv") as f:
        rows = list(csv.reader(f))
    cols = [rows[0].index(k) for k in IMAGE_LOGGED]
    if not (rows[0] == TRAIN_HEADERS and len(rows) == steps + 1
            and all(math.isfinite(float(r[i])) for r in rows[1:]
                    for i in cols)):
        fail(f"image CLI train_metrics.csv: {rows}")
    ckpt = restore_checkpoint(res["checkpoint"])
    live = model.state_dict()
    if not (list(ckpt) == ["params_i"] and ckpt["params_i"].keys()
            == live.keys() and all(torch.equal(ckpt["params_i"][k],
                                               v.cpu())
                                   for k, v in live.items())):
        fail("image CLI: checkpoints/last is not the model's params_i")
    # the parameters moved from the init the CLI drew
    init = DMCI(DMCIConfig(dtype="bfloat16"), device="cpu").init_(
        torch.Generator().manual_seed(seed)).state_dict()
    still = [k for k, v in live.items() if torch.equal(v.cpu(), init[k])]
    if still:
        fail(f"image CLI: {len(still)} of {len(live)} parameters did not "
             f"move: {still[:6]}")
    # checkpoints/last imported into the video trainer's DMCI
    cfg = TrainConfig(image_checkpoint_path=res["checkpoint"], seed=seed,
                      model_profile=CLI_PROFILE)
    tr = Trainer(cfg, total_iters=1, device=DEVICE)
    load_pretrained(tr, cfg)
    differ = [k for k, v in tr.dmci.state_dict().items()
              if not torch.equal(v, live[k])]
    if differ:
        fail(f"image CLI: the imported DMCI differs: {differ[:6]}")
    del tr
    # every forward and backward kernel at every shape the step gave it
    x = torch.rand((IMAGE_B, IMAGE_HW, IMAGE_HW, 3), device=DEVICE,
                   generator=torch.Generator(DEVICE).manual_seed(seed))
    fwd_shapes = dcb_forward_shapes(torch, model, x)
    if sum(fwd_shapes.values()) != IMAGE_LAUNCHES["dcb"]:
        fail(f"image CLI: forward shapes {fwd_shapes}")
    del model, res, x
    with torch.no_grad():
        dcb_rows = dcb_step_rows(torch, seed, card, fwd_shapes, prev)
        blocks = sorted(key for (k, key) in per_step if k == "gate_bwd")
        sites = {(IMAGE_B, *x[:4]): x[4] for x in IMAGE_BWD_SHAPES}
        bwd_rows = phase_backward_kernels(
            torch, seed + 1, card, prev is not None,
            [(*key, sites.get(key, "image step")) for key in blocks])
    if CLI_PROFILE == "full" and blocks != sorted(
            (IMAGE_B, *x[:4]) for x in IMAGE_BWD_SHAPES):
        fail(f"image CLI: block backwards at {blocks}, not at "
             "IMAGE_BWD_SHAPES")
    backward = weigh_bwd(bwd_rows, per_step, "an image-CLI step")
    for k, r in backward.items():
        r["per"] = ("image-CLI step (phase 20): per-shape time x block "
                    "backwards per step at that shape (counted), summed")
        print(f"  {k} per image step: {r['launches']} launches, "
              f"{r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, bound "
              f"{r['bound_ms']:.4f}"
              + (f", library {r['library_ms']:.3f}"
                 if r["library_ms"] is not None else "")
              + (f", parent {r['prev_ms']:.3f} in turns" if "prev_ms" in r
                 else "") + f") [{card}]")
    print(f"  dcb per image step: {dcb_rows['launches']} launches, "
          f"{dcb_rows['ms']:.3f} ms (plain {dcb_rows['plain_ms']:.3f}, bound"
          f" {dcb_rows['bound_ms']:.4f}"
          + (f", parent {dcb_rows['prev_ms']:.3f} in turns"
             if "prev_ms" in dcb_rows else "") + f") [{card}]")
    xcheck = image_cross_check(torch, seed)
    med = lambda xs: float(np.median(xs))
    out = dict(source="waymo", steps=steps, batch=IMAGE_B, crop=IMAGE_HW,
               ms_per_step=med(timing["wall_ms"]),
               data_ms_per_step=med(timing["data_ms"]),
               step_ms=med(timing["step_ms"]),
               data_ms_runs=timing["data_ms"],
               step_ms_runs=timing["step_ms"],
               wall_ms_runs=timing["wall_ms"], run_s=run_s,
               peak_mib=peak / 2 ** 20, launches_per_step=IMAGE_LAUNCHES,
               losses=[{k: float(r[i]) for k, i in zip(IMAGE_LOGGED, cols)}
                       for r in rows[1:]],
               cross_check=xcheck, dcb=dcb_rows, backward=backward)
    print(f"image CLI: {steps} steps of B={IMAGE_B} {IMAGE_HW}x{IMAGE_HW} "
          f"crops of {WAYMO_HW[1]}x{WAYMO_HW[0]} Waymo JPEGs, "
          f"{out['ms_per_step']:.1f} ms per step (host, next() to the step's"
          f" end; median), of which data {out['data_ms_per_step']:.1f} ms "
          f"(host, inside next()) and train_step {out['step_ms']:.1f} ms "
          f"(CUDA events); whole run {run_s:.1f} s; peak "
          f"{out['peak_mib']:.0f} MiB allocated; launches per step "
          f"{IMAGE_LAUNCHES}; files {files}; every parameter moved; "
          f"checkpoints/last imported into the video trainer exactly "
          f"[{card}]")
    return out


#: Phase 21: the scripts on the first SCRIPT_FRAMES frames of the fixture
#: (one record file's) at phase 10's QP, an I-frame every SCRIPT_GOP
#: frames: the GOP phase 19's checkpoint trained on (T=4). Its 10 steps
#: leave a DPB that grows with each P-frame, in the JAX package as in the
#: port (F6, experiments/f6_dpb_growth.py: the tiny profile's feature
#: ~4-10x a frame, past 1e7 by the ninth), so that checkpoint codes GOPs
#: of 4. The scripts' default GOP of 32 (scripts/encode.py's --gop) is
#: coded after it, over all SCRIPT_LONG_FRAMES frames of the fixture (I +
#: 15 P), from weights drawn as random_weights draws them (the prior heads
#: at 0.01) and written in the port's checkpoint format. Launches per side:
#: the full profile in fp32 (profile_model_cfgs' default dtype) takes the
#: 3xTF32 kernels, per I-frame 42 / 32 and per P-frame 19+5 / 12+4 after
#: the I-frame, 18+5 / 11+4 after (encoder / decoder, as phase 10)
SCRIPT_FRAMES, SCRIPT_GOP = 8, TRAIN_T
SCRIPT_LONG_FRAMES, SCRIPT_LONG_GOP = sum(CLI_RECORDS), 32


def script_launches(frames=SCRIPT_FRAMES, gop=SCRIPT_GOP):
    """{side: {kernel: launches}} of ``frames`` frames, ``gop`` a GOP."""
    per = {"encode": ((42, 0), (19, 5), (18, 5)),
           "decode": ((32, 0), (12, 4), (11, 4))}
    out = {}
    for side, (i, after, other) in per.items():
        kinds = [i if t % gop == 0 else after if t % gop == 1
                 else other for t in range(frames)]
        out[side] = {"dcb_tf32": sum(k[0] for k in kinds),
                     "dcb_chain_tf32": sum(k[1] for k in kinds)}
    return out


def script_pngs(root: Path, out_dir: Path, frames: int):
    """The fixture's first ``frames`` frames (record files in order) as
    im%05d.png under ``out_dir`` by the port's PNGWriter; returns them as
    YCbCr, read back through PNGReader."""
    from ssgvc_tpu_torch.data import tfrecord, waymo_proto
    from ssgvc_tpu_torch.utils.transforms import rgb2ycbcr_np
    from ssgvc_tpu_torch.utils.video_io import PNGReader, PNGWriter

    writer = PNGWriter(str(out_dir))
    left = frames
    for i in range(len(CLI_RECORDS)):
        with contextlib.closing(tfrecord.read_records(
                str(root / "waymo" / f"seg{i}.tfrecord"))) as records:
            for _, rec in zip(range(left), records):
                rgb = np.asarray(waymo_proto.decode_jpeg(
                    waymo_proto.parse_front_jpeg(rec)), np.float32) / 255.0
                writer.write_one_frame(rgb)
                left -= 1
        if not left:
            break
    reader = PNGReader(str(out_dir))
    out = [reader.read_one_frame() for _ in range(frames)]
    if reader.read_one_frame() is not None or any(f is None or f.shape != (
            *WAYMO_HW, 3) for f in out):
        fail("scripts: the frames written are not the fixture's")
    return np.stack([rgb2ycbcr_np(f) for f in out])


def code_with_scripts(torch, work: Path, n: int, gop: int, checkpoint: str):
    """scripts.encode.main on the ``n`` frames under ``work / "frames"``
    (GOP ``gop``) and scripts.decode.main on the stream it wrote, with
    ``checkpoint``: every decoded PNG equal to the encoder's
    reconstruction, the bits per frame the container's unit sizes, the
    launches per side script_launches'.
    Each P-frame's DPB, as each side's codec returns it, is logged:
    {side: [(finite, feature max |.|)]}. Returns (sides, stats, dpbs)."""
    from unittest import mock

    from ssgvc_tpu_torch.coding.bitstream import BitstreamReader
    from ssgvc_tpu_torch.coding.codec import VideoCodec
    from ssgvc_tpu_torch.coding.session import CodingSession
    from ssgvc_tpu_torch.scripts import decode, encode
    from ssgvc_tpu_torch.utils.transforms import ycbcr2rgb_np
    from ssgvc_tpu_torch.utils.video_io import PNGReader, PNGWriter

    model = ["--checkpoint", checkpoint, "--profile", CLI_PROFILE,
             "--variant", "performance", f"--device={DEVICE}"]
    reset, read = launch_counts()
    # the host clock inside encode_sequence / decode_sequence: the coding
    # alone, without the checkpoint, the models and the PNG files
    coding_s = {}
    dpbs = {"encode": [], "decode": []}

    def timed(side, fn):
        def run(self, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *args, **kw)
            torch.cuda.synchronize()
            coding_s[side] = time.perf_counter() - t0
            return out
        return run

    def logged(side, fn):
        def run(self, *args, **kw):
            out = fn(self, *args, **kw)
            d = out["dpb"]
            finite = bool(torch.isfinite(d["feature"].float()).all()
                          and torch.isfinite(d["frame"].float()).all())
            dpbs[side].append((finite, float(d["feature"].float().abs()
                                              .max())))
            return out
        return run

    sides = {}
    with mock.patch.object(CodingSession, "encode_sequence",
                           timed("encode", CodingSession.encode_sequence)), \
            mock.patch.object(CodingSession, "decode_sequence",
                              timed("decode",
                                    CodingSession.decode_sequence)), \
            mock.patch.object(VideoCodec, "dmc_compress",
                              logged("encode", VideoCodec.dmc_compress)), \
            mock.patch.object(VideoCodec, "dmc_decompress",
                              logged("decode", VideoCodec.dmc_decompress)):
        for side, fn, args in (
                ("encode", encode.main,
                 ["--input", str(work / "frames"), "--output",
                  str(work / "seq.bin"), "--qp", str(QP), "--gop",
                  str(gop)]),
                ("decode", decode.main,
                 ["--input", str(work / "seq.bin"), "--output",
                  str(work / "decoded")])):
            torch.cuda.synchronize()
            reset()
            t0 = time.perf_counter()
            result = fn(args + model)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            got = read()
            sides[side] = dict(result=result, s=s, launches=got,
                               ms_per_frame=1e3 * s / n,
                               coding_ms_per_frame=1e3 * coding_s[side] / n)
            want = script_launches(n, gop)[side]
            if not all(got[k] == want.get(k, 0) for k in got):
                fail(f"scripts: {side} launches {got}, expected {want}")
    stats, decoded = sides["encode"]["result"], sides["decode"]["result"]
    if stats["frame_types"] != ["P" if t % gop else "I" for t in range(n)]:
        fail(f"scripts: frame types {stats['frame_types']}")
    # the encoder's reconstructions written as decode writes its frames
    recons = PNGWriter(str(work / "recons"))
    for rec in stats["recons"]:
        recons.write_one_frame(ycbcr2rgb_np(rec))
    dec_png, rec_png = (PNGReader(str(work / d)) for d in ("decoded",
                                                           "recons"))
    for t in range(n):
        a, b = dec_png.read_one_frame(), rec_png.read_one_frame()
        if a is None or b is None or not np.array_equal(a, b):
            fail(f"scripts: decoded PNG {t + 1} differs from the "
                 "encoder's reconstruction")
    if dec_png.read_one_frame() is not None or len(decoded) != n:
        fail(f"scripts: decode wrote {len(decoded)} frames")
    with open(work / "seq.bin", "rb") as f:
        bs = BitstreamReader(f)
        units = [bs.read_frame() for _ in range(n)]
        if bs.read_frame() is not None:
            fail("scripts: the stream holds more units than frames")
    if [len(u["payload"]) * 8 for u in units] != stats["frame_bits"]:
        fail(f"scripts: bits per frame {stats['frame_bits']} are not the "
             "container's unit sizes")
    return sides, stats, dpbs


def drawn_checkpoint(torch, seed, path: Path) -> str:
    """The full profile's DMC and DMCI (float32, as profile_model_cfgs
    gives them) with weights drawn from ``seed`` by random_weights (the
    prior heads at 0.01), saved at ``path`` in the port's checkpoint
    format (params_p, params_i)."""
    from ssgvc_tpu_torch.config import profile_model_cfgs
    from ssgvc_tpu_torch.models.dmc import DMC
    from ssgvc_tpu_torch.models.dmci import DMCI
    from ssgvc_tpu_torch.utils.checkpoint import save_checkpoint

    dmc_cfg, dmci_cfg = profile_model_cfgs(CLI_PROFILE, "performance")
    dmc = random_weights(torch, DMC(dmc_cfg, device="cpu"), seed + 21)
    dmci = random_weights(torch, DMCI(dmci_cfg, device="cpu"), seed + 22,
                          DMCI_HEADS)
    return save_checkpoint(str(path), {"params_p": dmc.state_dict(),
                                       "params_i": dmci.state_dict()})


def phase_scripts(torch, seed, card, root: Path, checkpoint: str):
    """The encode and decode scripts (module docstring, phase 21) in
    ``root / "scripts"`` on the fixture under ``root``: GOPs of SCRIPT_GOP
    with phase 19's ``checkpoint``, then the scripts' default GOP over the
    whole fixture with drawn weights."""
    from ssgvc_tpu_torch.utils.metrics import calc_psnr

    work = root / "scripts"
    frames = script_pngs(root, work / "frames", SCRIPT_FRAMES)
    sides, stats, _ = code_with_scripts(torch, work, SCRIPT_FRAMES,
                                        SCRIPT_GOP, checkpoint)
    if not all(np.isfinite(r).all() for r in stats["recons"]):
        fail("scripts: an encoder reconstruction is not finite")
    pixels = WAYMO_HW[0] * WAYMO_HW[1]
    bpp = [b / pixels for b in stats["frame_bits"]]
    psnr = [calc_psnr(frames[t], stats["recons"][t])
            for t in range(SCRIPT_FRAMES)]
    if not all(math.isfinite(p) for p in psnr):
        fail(f"scripts: PSNR {psnr}")
    out = dict(frames=SCRIPT_FRAMES, frame_hw=list(WAYMO_HW), qp=QP,
               gop=SCRIPT_GOP, profile=CLI_PROFILE, dtype="float32",
               frame_types=stats["frame_types"],
               frame_bits=stats["frame_bits"], bpp=bpp, psnr=psnr,
               bytes=(work / "seq.bin").stat().st_size,
               **{f"{side}_{k}": v[k] for side, v in sides.items()
                  for k in ("s", "ms_per_frame", "coding_ms_per_frame",
                            "launches")})
    print(f"scripts: {SCRIPT_FRAMES} frames {WAYMO_HW[1]}x{WAYMO_HW[0]} PNG "
          f"-> {out['bytes']} bytes -> PNG (profile {CLI_PROFILE}, float32,"
          f" QP {QP}, GOP {SCRIPT_GOP}); encode {out['encode_s']:.2f} s "
          f"({out['encode_ms_per_frame']:.1f} ms per frame, host clock "
          f"around main: checkpoint, models and PNG reads included; "
          f"encode_sequence {out['encode_coding_ms_per_frame']:.1f}), "
          f"decode {out['decode_s']:.2f} s ({out['decode_ms_per_frame']:.1f}"
          f" ms per frame, PNG writes included; decode_sequence "
          f"{out['decode_coding_ms_per_frame']:.1f}); bpp "
          f"{', '.join(f'{v:.4f}' for v in bpp)}; PSNR "
          f"{', '.join(f'{v:.2f}' for v in psnr)} dB; every decoded PNG "
          f"equal to the encoder's reconstruction; launches encode "
          f"{sides['encode']['launches']}, decode "
          f"{sides['decode']['launches']} [{card}]")

    # the scripts' default GOP over the whole fixture, from drawn weights
    work = root / "scripts_gop32"
    frames = script_pngs(root, work / "frames", SCRIPT_LONG_FRAMES)
    ckpt = drawn_checkpoint(torch, seed, work / "drawn.ckpt")
    sides, stats, dpbs = code_with_scripts(torch, work, SCRIPT_LONG_FRAMES,
                                           SCRIPT_LONG_GOP, ckpt)
    p_frames = SCRIPT_LONG_FRAMES - 1
    if any(len(v) != p_frames for v in dpbs.values()):
        fail(f"scripts GOP {SCRIPT_LONG_GOP}: DPBs logged "
             f"{ {k: len(v) for k, v in dpbs.items()} }")
    if not all(ok for v in dpbs.values() for ok, _ in v):
        fail(f"scripts GOP {SCRIPT_LONG_GOP}: a DPB is not finite: {dpbs}")
    if dpbs["encode"] != dpbs["decode"]:
        fail(f"scripts GOP {SCRIPT_LONG_GOP}: the decoder's DPB feature "
             "maxima differ from the encoder's")
    feature_max = [m for _, m in dpbs["encode"]]
    psnr = [calc_psnr(frames[t], stats["recons"][t])
            for t in range(SCRIPT_LONG_FRAMES)]
    out["gop32"] = dict(
        frames=SCRIPT_LONG_FRAMES, gop=SCRIPT_LONG_GOP, weights="drawn",
        frame_types=stats["frame_types"], frame_bits=stats["frame_bits"],
        dpb_feature_max=feature_max, psnr=psnr,
        **{f"{side}_{k}": v[k] for side, v in sides.items()
           for k in ("s", "ms_per_frame", "coding_ms_per_frame",
                     "launches")})
    print(f"scripts GOP {SCRIPT_LONG_GOP}: {SCRIPT_LONG_FRAMES} frames (I + "
          f"{p_frames} P) from drawn weights (prior heads at 0.01) in a port "
          f"checkpoint; every DPB finite on both sides, the decoder's "
          f"feature maxima equal to the encoder's; DPB feature max per "
          f"P-frame {', '.join(f'{v:.4g}' for v in feature_max)}; PSNR "
          f"{', '.join(f'{v:.2f}' for v in psnr)} dB; every decoded PNG "
          f"equal to the encoder's reconstruction; encode "
          f"{sides['encode']['ms_per_frame']:.1f} ms per frame "
          f"(encode_sequence {sides['encode']['coding_ms_per_frame']:.1f}),"
          f" decode {sides['decode']['ms_per_frame']:.1f} "
          f"({sides['decode']['coding_ms_per_frame']:.1f}); launches encode "
          f"{sides['encode']['launches']}, decode "
          f"{sides['decode']['launches']} [{card}]")
    return out

#: Phase 22: the graft entry's P-frame (raw io, 256x256, after an I-frame:
#: 19 dcb + 5 dcb_chain launches a call), the debug and profiling tools on
#: the card
ENTRY_LAUNCHES = {"dcb": 19, "dcb_chain": 5}
ENTRY_TIMED = 20              # profiling.timed calls; ms per call the median
#: kernel names of the port's bf16 forward kernels in a profiler trace
PORT_KERNELS = re.compile(r"\b(dcb_kernel|chain_kernel)\b")


def entry_cross_check(torch, what, fn, args):
    """debug.cpu_cross_check of ``fn(*args)``; gated as phase 8 gates a
    bf16 P-frame (cross_check_pair), the CPU in bf16 too (the same
    function on CPU copies of the arguments). Returns (max |diff| per
    output, PSNR)."""
    from ssgvc_tpu_torch.utils.debug import cpu_cross_check

    outs = []

    def run(*a):
        with torch.no_grad():
            outs.append(fn(*a))
        return outs[-1]

    diffs = cpu_cross_check(run, *args, atol=float("inf"))
    card, cpu = outs
    if not all(torch.isfinite(v.float()).all() for o in outs
               for v in (o["bpp"], o["dpb"]["frame"], o["dpb"]["feature"])):
        fail(f"{what}: an output is not finite")
    psnr = cross_check_pair(
        what, float(cpu["bpp"].sum()), cpu["dpb"]["frame"].float().numpy(),
        float(card["bpp"].sum()), card["dpb"]["frame"].float().cpu().numpy(),
        hw="256x256", cpu="bf16",
        extra=f"; cpu_cross_check max |diff| {diffs}")
    return diffs, psnr


def trace_split(trace_dir: Path):
    """Device time of the exported trace by kernel name: the port's kernels
    and every other device op (kernels, copies, sets), in ms."""
    files = sorted(trace_dir.glob("*.pt.trace.json"))
    if len(files) != 1:
        fail(f"trace: expected one trace file in {trace_dir}, got {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    port, other = {}, {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy",
                                                      "gpu_memset"):
            continue
        name = e["name"]
        m = PORT_KERNELS.search(name)
        key, into = (m.group(1), port) if m else (name, other)
        n, ms = into.get(key, (0, 0.0))
        into[key] = (n + 1, ms + e["dur"] / 1e3)
    return port, other


def phase_tools(torch, seed, card, main, root: Path):
    """The graft entry, layer_forensics and a torch.profiler trace of a
    full-width P-frame (module docstring, phase 22)."""
    from ssgvc_tpu_torch import graft_entry
    from ssgvc_tpu_torch.config import DMCConfig
    from ssgvc_tpu_torch.models.dmc import DMC
    from ssgvc_tpu_torch.ops.pixel import pixel_unshuffle
    from ssgvc_tpu_torch.utils import debug, profiling

    out = {}
    # the entry, on the card without being asked
    fn, args = graft_entry.entry()
    params, frame, mask, qp, dpb = args
    if not all(t.is_cuda for t in (*params.values(), frame, mask,
                                   *dpb.values())):
        fail("graft entry: its params and example args are not on the card")
    reset, read = launch_counts()
    with torch.no_grad():
        fn(*args)                                   # warm-up
        torch.cuda.synchronize()
        reset()
        res = fn(*args)
        torch.cuda.synchronize()
        got = read()
        if not all(v.is_cuda for _, v in debug.keyed_leaves(res)):
            fail("graft entry: its outputs are not on the card")
        if any(got[k] != ENTRY_LAUNCHES.get(k, 0) for k in got):
            fail(f"graft entry: launches per call {got}, expected "
                 f"{ENTRY_LAUNCHES}")
        ms = 1e3 * profiling.timed(fn, *args, iters=ENTRY_TIMED)
    out["entry"] = dict(ms_per_call=ms, launches_per_call=ENTRY_LAUNCHES)
    diffs, psnr = entry_cross_check(torch, "graft entry (its example args)",
                                    fn, args)
    out["entry"]["cpu_cross_check"] = diffs
    # the same fn on drawn weights and seeded frames: a cross-check that
    # moves every kernel's inputs off zero
    cfg = DMCConfig.variant("performance", dtype="bfloat16")
    model = random_weights(torch, DMC(cfg, device=DEVICE), seed + 22).eval()
    drawn = dict(model.state_dict())
    g = torch.Generator(device=DEVICE).manual_seed(seed + 22)
    hw = (1, graft_entry.H, graft_entry.W)
    seeded = (torch.rand(hw + (3,), generator=g, device=DEVICE),
              (torch.rand(hw + (1,), generator=g, device=DEVICE)
               > 0.8).float(), graft_entry.QP,
              {"frame": torch.rand(hw + (3,), generator=g, device=DEVICE),
               "feature": torch.zeros_like(dpb["feature"])})
    diffs, psnr = entry_cross_check(
        torch, "graft entry (drawn weights, seeded frames)", fn,
        (drawn,) + seeded)
    out["entry"]["cpu_cross_check_drawn"] = dict(max_abs_diff=diffs,
                                                 frame_psnr=psnr)
    print(f"graft entry: entry() on {params['q_recon'].device}, "
          f"{ms:.3f} ms per P-frame call (1x256x256 bf16, median of "
          f"{ENTRY_TIMED}, CUDA events), launches per call {got['dcb']} dcb "
          f"+ {got['dcb_chain']} dcb_chain [{card}]")

    # layer_forensics of the entry's model, on its params and the seeded
    # frames
    model.load_state_dict(params, strict=True)
    stats = debug.layer_forensics(model, seeded[0], graft_entry.QP,
                                  seeded[3], top_k=10 ** 6, after_i=True,
                                  mask=seeded[1], train=False)
    bad = {k: v for k, v in stats.items() if v["nonfinite"]}
    if bad:
        fail(f"layer_forensics: non-finite outputs {bad}")
    top = list(stats.items())[:5]
    out["forensics"] = dict(modules=len(stats), top5={
        k: {"norm": v["norm"], "max_abs": v["max_abs"]} for k, v in top})
    print(f"layer_forensics of the entry's model on the card: {len(stats)} "
          f"modules, none non-finite; top 5 by norm: "
          + "; ".join(f"{k} {v['norm']:.4g} (max {v['max_abs']:.4g}, "
                      f"{v['dtype']})" for k, v in top))

    # one warm full-width P-frame of phase 5's model under torch.profiler
    pcfg = DMCConfig.variant("performance", dtype="bfloat16", packed_io=True)
    pmodel = DMC(pcfg, device=DEVICE)
    pmodel.load_state_dict(main["state"], strict=True)
    pmodel.eval()
    fp = pixel_unshuffle(main["frames"].reshape(-1, H, W, 3), 8)
    mp = pixel_unshuffle(main["masks"].reshape(-1, H, W, 1), 8)
    dpb = {"frame": pixel_unshuffle(main["dpb_frame"], 8),
           "feature": torch.zeros((1, H // 8, W // 8, pcfg.ch_d),
                                  dtype=torch.bfloat16, device=DEVICE)}
    with torch.no_grad():
        dpb = pmodel(fp[0:1], QP, dpb, after_i=True, mask=mp[0:1])["dpb"]
        for _ in range(2):                         # warm
            pmodel(fp[1:2], QP, dpb, after_i=False, mask=mp[1:2])
        torch.cuda.synchronize()
        reset()
        with profiling.trace(str(root / "trace")) as trace_dir:
            pmodel(fp[1:2], QP, dpb, after_i=False, mask=mp[1:2])
        got = read()
    port, other = trace_split(Path(trace_dir))
    if (port.get("dcb_kernel", (0,))[0], port.get("chain_kernel", (0,))[0]
            ) != (got["dcb"], got["dcb_chain"]) or got["dcb"] != 18:
        fail(f"trace: port kernels {port} against launches {got}")
    ranked = sorted(other.items(), key=lambda kv: -kv[1][1])
    port_ms = sum(v[1] for v in port.values())
    other_ms = sum(v[1] for v in other.values())
    out["trace"] = dict(
        frame_hw=[H, W], port_kernels={k: dict(launches=n, ms=t)
                                       for k, (n, t) in port.items()},
        port_ms=port_ms, other_ms=other_ms, other_ops=len(other),
        other_launches=sum(v[0] for v in other.values()),
        top10=[dict(name=k[:160], launches=n, ms=t)
               for k, (n, t) in ranked[:10]])
    print(f"trace of one warm {H}x{W} bf16 P-frame (phase 5's model; "
          f"torch.profiler, device time from the exported trace): port "
          f"kernels {port_ms:.3f} ms ("
          + ", ".join(f"{k} {n} x, {t:.3f} ms" for k, (n, t) in port.items())
          + f"); other device ops {other_ms:.3f} ms in "
          f"{out['trace']['other_launches']} launches of {len(other)} "
          f"kinds; top 10: "
          + "; ".join(f"{k[:90]} {n} x {t:.3f} ms"
                      for k, (n, t) in ranked[:10]) + f" [{card}]")
    out["memory_after_phase5"] = main["memory_stats"]
    print(f"device_memory_stats after phase 5's first GOP: "
          f"{main['memory_stats']} (peak_bytes_in_use equals phase 5's "
          f"peak_bytes {main['peak_bytes']}, the same allocator counter) "
          f"[{card}]")
    return out


# Phase 23: parallel/ on the card. One H100: NCCL at world 1, and two ranks
# sharing cuda:0 over gloo (NCCL takes no two ranks on one device).
P23_H = H                    # the main path's 1088 rows: 17 units of 64,
#                              worked on uneven slabs of whole units
P23_WIDE = (4, 8)            # (c): one bf16 frame over 4 and over 8 ranks
P23_FRAMES = 3               # the sharded GOP (after_i=False)
P23_STEPS = 8                # (b): the default accumulation, one update
P23_REL = 1e-2               # (c) bf16: relative Frobenius, the kernels'
P23_BPP_REL = 1e-3           # (c) bf16: bpp relative difference
#: (c) fp32: tests/test_mesh.py's tolerances
P23_F32_TOL = {"bpp": (3e-4, 1e-5), "frame": (2e-5, 1e-4),
               "feature": (2e-5, 2e-4)}
P23_DP_LOSS = 1e-3           # (d): loss, relative
#: (d): the gradient's cosine (fp64 dots). The tiny profile's CPU
#: rehearsal (bf16, plain versions) read 0.9952 (1.25e-4 on the loss);
#: 0.99 is phase 13's bf16 gate (XTRAIN_KERNEL_COSINE)
P23_DP_COSINE = XTRAIN_KERNEL_COSINE
P23_WANT = (18, 5)           # launches per after_i=False P-frame
#: graft_entry.dryrun_multichip's DMC widths, every one <= 64: fp32 runs
#: them on the SIMT kernels
P23_TINY = dict(ch_d=16, ch_y=8, ch_z=8, ch_recon=16)
#: (c)'s runs of the performance variant, each against the unsharded
#: P-frame on the same inputs and weights: at full width in bf16 over a GOP
#: of P23_FRAMES and in fp32 (3xTF32) one frame; at the dry run's widths in
#: fp32 (SIMT) one frame of the full frame (8x8 tiles) and one of the dry
#: run's raw 128 x 64 frame (whole-image units on slabs of 4 rows at y's
#: scale); "counters": the suffix of the launch counts the run reads
P23_RUNS = (
    dict(name="bf16", variant="performance", dtype="bfloat16", widths={},
         h=P23_H, w=W, packed=True, frames=P23_FRAMES, counters=""),
    dict(name="fp32 3xTF32", variant="performance", dtype="float32",
         widths={}, h=P23_H, w=W, packed=True, frames=1, counters="_tf32"),
    dict(name="fp32 SIMT", variant="performance", dtype="float32",
         widths=P23_TINY, h=P23_H, w=W, packed=True, frames=1,
         counters="_f32"),
    dict(name="fp32 SIMT dry-run frame", variant="performance",
         dtype="float32", widths=P23_TINY, h=128, w=64, packed=False,
         frames=1, counters="_f32"),
    # (e): the variant whose mask predictor resizes across the slabs
    dict(name="mask_prop bf16", variant="mask_prop", dtype="bfloat16",
         widths={}, h=P23_H, w=W, packed=True, frames=1, counters="",
         label="e"),
)


@contextlib.contextmanager
def captured_fd1():
    """File descriptor 1 (where spawned children write too) into a
    temporary file for the duration; yields a list that gets its text."""
    sys.stdout.flush()
    saved = os.dup(1)
    out = []
    with tempfile.TemporaryFile() as f:
        os.dup2(f.fileno(), 1)
        try:
            yield out
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
            f.seek(0)
            out.append(f.read().decode())


def p23_peak(torch, reset=False):
    """The allocator's peak (after ``reset``: the bytes allocated then)."""
    if reset:
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()
    return torch.cuda.max_memory_allocated()


def p23_dryrun():
    """(a) graft_entry.dryrun_multichip(1): NCCL at world 1."""
    from ssgvc_tpu_torch.graft_entry import dryrun_multichip

    t0 = time.perf_counter()
    with captured_fd1() as out:
        dryrun_multichip(1)
    text = out[0]
    line = [ln for ln in text.splitlines()
            if ln.startswith("dryrun_multichip ok: 1 devices, loss=")]
    if len(line) != 1:
        fail(f"dryrun_multichip(1) printed no ok line:\n{text[-2000:]}")
    loss = float(line[0].split("loss=")[1].split(",")[0])
    bpp = float(line[0].split("spatial_bpp=")[1])
    if not (math.isfinite(loss) and math.isfinite(bpp)):
        fail(f"dryrun_multichip(1): {line[0]}")
    print(f"  (a) {line[0]} (NCCL, world 1; "
          f"{time.perf_counter() - t0:.1f} s with the spawn)")
    return dict(line=line[0], loss=loss, spatial_bpp=bpp)


def p23_micro_steps(torch, tr, seed, batches, params):
    """P23_STEPS micro-steps of ``tr`` from ``params`` (state dicts of the
    DMC and DMCI) on ``batches`` at phase 13's QPs and noise: (losses, ms
    each, the DMC's parameters after)."""
    state = tr.init_state(torch.Generator().manual_seed(seed), batches[0],
                          params_p=params[0], params_i=params[1])
    host = np.random.default_rng(seed)
    noise = torch.Generator().manual_seed(seed)
    losses, ms = [], []
    for b in batches:
        qp = int(host.integers(0, 64))
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, aux = tr.train_step(state, b, qp, noise)
        e1.record()
        e1.synchronize()
        ms.append(e0.elapsed_time(e1))
        losses.append(float(aux["loss"]))
    return losses, ms, {k: v.detach().clone()
                        for k, v in tr.dmc.state_dict().items()}


def p23_world1(torch, seed, card, tmp: Path):
    """(b) the default TrainConfig through Trainer(mesh=make_mesh(1)) in an
    NCCL group of 1 against the trainer with no group, phase 13's batch
    and weights: P23_STEPS micro-steps (one update at the accumulation
    boundary) twice without a group, once in the group."""
    import torch.distributed as dist

    from ssgvc_tpu_torch.config import TrainConfig
    from ssgvc_tpu_torch.data.device_synth import synth_batch
    from ssgvc_tpu_torch.parallel.mesh import make_mesh
    from ssgvc_tpu_torch.training.trainer import Trainer

    g = torch.Generator(device=DEVICE).manual_seed(seed + 30)
    batches = [synth_batch(g, batch=TRAIN_B, size=TRAIN_HW, seq_len=TRAIN_T)
               for _ in range(P23_STEPS)]
    plain = Trainer(TrainConfig(), device=DEVICE)
    plain.init_state(torch.Generator().manual_seed(seed), batches[0])
    params = tuple({k: v.detach().clone() for k, v in m.state_dict().items()}
                   for m in (plain.dmc, plain.dmci))
    runs = [p23_micro_steps(torch, plain, seed, batches, params)
            for _ in range(2)]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp / 'rdzv_b'}",
                            rank=0, world_size=1)
    try:
        grouped = Trainer(TrainConfig(), device=DEVICE,
                          mesh=make_mesh(1, device=DEVICE))
        if grouped.group is None:
            fail("(b): the world-1 mesh has no NCCL group")
        runs.append(p23_micro_steps(torch, grouped, seed, batches, params))
    finally:
        dist.destroy_process_group()

    def gap(a, b):
        """(max |loss diff|, max |param diff|) of two runs."""
        lg = max(abs(x - y) for x, y in zip(a[0], b[0]))
        pg = max(float((a[2][k].float() - b[2][k].float()).abs().max())
                 for k in a[2])
        return lg, pg

    spread, dp = gap(runs[0], runs[1]), gap(runs[0], runs[2])
    exact = spread == (0.0, 0.0)
    moved = sum(not torch.equal(runs[2][2][k], params[0][k])
                for k in params[0])
    ms = [float(np.median(r[1][1:])) for r in runs]
    print(f"  (b) world-1 data-parallel step: default TrainConfig, "
          f"{P23_STEPS} micro-steps of B={TRAIN_B} {TRAIN_HW}x{TRAIN_HW} "
          f"T={TRAIN_T} (one update); two plain runs differ by loss "
          f"{spread[0]:.3g}, parameters {spread[1]:.3g}; the NCCL world-1 "
          f"run from the first by {dp[0]:.3g} / {dp[1]:.3g} ("
          f"{'bit for bit required' if exact else 'within the spread'}); "
          f"{moved} parameters moved; ms per micro-step (median of steps "
          f"2-{P23_STEPS}) plain {ms[0]:.1f} / {ms[1]:.1f}, NCCL world 1 "
          f"{ms[2]:.1f} [{card}]")
    if not moved:
        fail("(b): no parameter moved at the accumulation boundary")
    if exact and dp != (0.0, 0.0) or not exact and (
            dp[0] > spread[0] or dp[1] > spread[1]):
        fail(f"(b): the NCCL world-1 step differs from the plain one by "
             f"{dp}; two plain runs by {spread}")
    return dict(plain_deterministic=exact, plain_spread=list(spread),
                world1_vs_plain=list(dp), ms_per_micro_step_plain=ms[:2],
                ms_per_micro_step_world1=ms[2], losses=runs[2][0],
                parameters_moved=moved)


def p23_join(torch, rank, world, rdzv):
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                            world_size=world)


def p23_model(torch, run, seed, device):
    """The DMC of a row-sharded run (the performance variant unless the
    run names another), drawn from ``seed``."""
    from ssgvc_tpu_torch.config import DMCConfig
    from ssgvc_tpu_torch.models.dmc import DMC

    cfg = DMCConfig.variant(run.get("variant", "performance"),
                            dtype=run["dtype"], packed_io=run["packed"],
                            **run["widths"])
    return random_weights(torch, DMC(cfg, device=device), seed).eval()


def p23_zero_counts():
    from ssgvc_tpu_torch.ops import dcb as dcb_ops
    from ssgvc_tpu_torch.ops import dcb_chain as chain_ops
    from ssgvc_tpu_torch.ops import qconv as Q

    for m in (dcb_ops, chain_ops):
        m.launches = m.launches_f32 = m.launches_tf32 = 0
    Q.launches = 0


def p23_counts(run):
    """(dcb, dcb_chain) launches of the run's kernels since
    :func:`p23_zero_counts`, and qconv's for an int8 run."""
    from ssgvc_tpu_torch.ops import dcb as dcb_ops
    from ssgvc_tpu_torch.ops import dcb_chain as chain_ops
    from ssgvc_tpu_torch.ops import qconv as Q

    out = tuple(getattr(m, "launches" + run["counters"])
                for m in (dcb_ops, chain_ops))
    return out + (Q.launches,) if run.get("int8", "0") != "0" else out


def p23_int8(run):
    """The run's SSGVC_INT8 mode and mode-2 scales installed
    (p24_env)."""
    from ssgvc_tpu_torch.layers import blocks

    blocks.set_int8_scales(run.get("scales", {}))
    return p24_env(SSGVC_INT8=run.get("int8", "0"), SSGVC_INT8_SCOPE=None,
                   SSGVC_DW=None)


def p23_compare(torch, full, bpp, ref):
    """The gathered DPB and bpp against the unsharded frame's: relative
    Frobenius, max |diff| and the worst excess over P23_F32_TOL."""
    row = {}
    for k in ("frame", "feature"):
        a, b = full[k].float().cpu(), ref[k].float()
        row[k] = dict(
            rel_fro=float(torch.linalg.vector_norm(a - b)
                          / torch.linalg.vector_norm(b)),
            max_abs=float((a - b).abs().max()),
            excess=float(((a - b).abs() - P23_F32_TOL[k][1]
                          - P23_F32_TOL[k][0] * b.abs()).max()))
    b0, b1 = float(ref["bpp"][0]), float(bpp[0])
    row.update(bpp=b1, bpp_ref=b0, bpp_rel=abs(b1 - b0) / abs(b0),
               bpp_excess=(abs(b1 - b0) - P23_F32_TOL["bpp"][1]
                           - P23_F32_TOL["bpp"][0] * abs(b0)))
    return row


def p23_rows_rank(rank, world, rdzv, path, tag):
    """One rank of a row-sharded spawn on cuda:0 over gloo, every run of
    rows_<tag>_case.pt: the parent's weights (from the seed) and inputs;
    writes rows_<tag><r>.json (rank 0 with the comparisons against the
    parent's unsharded outputs)."""
    import torch
    import torch.distributed as dist

    from ssgvc_tpu_torch.parallel import spatial
    from ssgvc_tpu_torch.parallel.mesh import make_mesh
    from ssgvc_tpu_torch.parallel.spatial import (gather_rows, row_sharding,
                                                  shard_rows, spatial_pframe)

    case = torch.load(Path(path) / f"rows_{tag}_case.pt")
    p23_join(torch, rank, world, rdzv)
    try:
        mesh = make_mesh(world, device="cuda:0")
        sh = row_sharding(mesh)
        out = {"rank": rank, "runs": []}
        for run in case["runs"]:
            with p23_int8(run), warnings.catch_warnings():
                warnings.simplefilter("error")    # no site without a scale
                fn = spatial_pframe(p23_model(torch, run, case["seed"],
                                              "cuda:0"), mesh)
                dpb = shard_rows(mesh, run["dpb"])
                rows = run["frames"][0].shape[1]
                unit = spatial.SLAB_ROWS // (8 if run["packed"] else 1)
                # warm-up (cuBLAS / cuDNN plans), its DPB dropped
                fn(None, *shard_rows(mesh, (run["frames"][0],
                                            run["masks"][0])), QP, dpb)
                torch.cuda.synchronize()
                base = p23_peak(torch, reset=True)
                frames = []
                for i, (x, m) in enumerate(zip(run["frames"],
                                               run["masks"])):
                    xs, ms = shard_rows(mesh, (x, m))
                    p23_zero_counts()
                    spatial.halo_bytes = spatial.move_bytes = 0
                    dist.barrier()
                    t0 = time.perf_counter()
                    dpb, bpp = fn(None, xs, ms, QP, dpb)
                    torch.cuda.synchronize()
                    dist.barrier()
                    row = dict(ms=1e3 * (time.perf_counter() - t0),
                               launches=list(p23_counts(run)),
                               slab=list(sh.rows(rows, unit)),
                               halo_bytes=spatial.halo_bytes,
                               move_bytes=spatial.move_bytes)
                    full = gather_rows(mesh, dpb)
                    if rank == 0:
                        row.update(p23_compare(torch, full, bpp,
                                               run["ref"][i]))
                    frames.append(row)
            out["runs"].append(dict(frames=frames,
                                    peak=p23_peak(torch) - base))
            del fn, dpb
        (Path(path) / f"rows_{tag}{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def p23_refs(torch, seed, runs):
    """Each run's inputs drawn on the card (the DPB after an I-frame-like
    frame, then the run's P-frames carrying it), mode 2's scales
    calibrated on its first frame, and the unsharded P-frames' outputs,
    launches, ms and peak memory, all under the run's int8 mode."""
    from ssgvc_tpu_torch.layers import blocks
    from ssgvc_tpu_torch.ops.pixel import pixel_unshuffle

    g = torch.Generator(device=DEVICE).manual_seed(seed + 23)
    out = []
    for run in runs:
        dt = getattr(torch, run["dtype"])

        def draw(c, mask=False):
            t = torch.rand((1, run["h"], run["w"], c), generator=g,
                           device=DEVICE)
            t = (t > 0.8).float() if mask else t
            return (pixel_unshuffle(t, 8) if run["packed"] else t).to(dt)

        model = p23_model(torch, run, seed, DEVICE)
        frames = [draw(3) for _ in range(run["frames"])]
        masks = [draw(1, mask=True) for _ in range(run["frames"])]
        with torch.no_grad():
            zero = torch.zeros((1, run["h"] // 8, run["w"] // 8,
                                model.cfg.ch_d), dtype=dt, device=DEVICE)
            start = model(draw(3), QP, {"frame": draw(3), "feature": zero},
                          after_i=True, mask=draw(1, mask=True))["dpb"]
            if run.get("int8") == "2":
                with p24_env(SSGVC_INT8="2", SSGVC_INT8_SCOPE=None), \
                        warnings.catch_warnings(), \
                        blocks.int8_calibration() as calib:
                    warnings.simplefilter("ignore")   # no scale yet
                    blocks.set_int8_scales({})
                    model(frames[0], QP, start, after_i=False, mask=masks[0])
                run = dict(run, scales=blocks.collect_int8_scales(calib))
            with p23_int8(run):
                model(frames[0], QP, start, after_i=False,
                      mask=masks[0])                  # warm-up
                torch.cuda.synchronize()
                base = p23_peak(torch, reset=True)
                dpb, refs, times, counts = start, [], [], []
                for x, m in zip(frames, masks):
                    p23_zero_counts()
                    t0 = time.perf_counter()
                    o = model(x, QP, dpb, after_i=False, mask=m)
                    torch.cuda.synchronize()
                    times.append(1e3 * (time.perf_counter() - t0))
                    counts.append(list(p23_counts(run)))
                    dpb = o["dpb"]
                    refs.append({"frame": dpb["frame"].cpu(),
                                 "feature": dpb["feature"].cpu(),
                                 "bpp": o["bpp"].float().cpu()})
                peak = p23_peak(torch) - base
        if run.get("variant", "performance") == "performance" and \
                run.get("int8", "0") == "0" and \
                any(tuple(c) != P23_WANT for c in counts):
            fail(f"unsharded {run['name']}: launches {counts}, expected "
                 f"{list(P23_WANT)} a frame")
        out.append(dict(
            run, frames=[f.cpu() for f in frames],
            masks=[m.cpu() for m in masks],
            dpb={k: v.cpu() for k, v in start.items()}, ref=refs, ms=times,
            launches=counts, peak=peak))
        del model, start, dpb, o
    return out


def p23_spawn_rows(torch, seed, card, tmp: Path, runs, world, tag):
    """``runs`` (from :func:`p23_refs`) row-sharded over ``world`` ranks
    sharing cuda:0 over gloo, each against its unsharded P-frames: printed
    per frame with each rank's launches (those of the unsharded frame),
    unit slab, halo and redistribution bytes and ms; gated per run by
    dtype (bf16: P23_REL / P23_BPP_REL; fp32: tests/test_mesh.py's; int8:
    the run's "gate"). Returns the runs' records and the spawn's time."""
    import torch.multiprocessing as mp

    case = {"seed": seed, "runs": runs}
    torch.save(case, tmp / f"rows_{tag}_case.pt")
    t0 = time.perf_counter()
    mp.spawn(p23_rows_rank, args=(world, str(tmp / f"rdzv_{tag}"),
                                  str(tmp), tag),
             nprocs=world, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [json.loads((tmp / f"rows_{tag}{r}.json").read_text())
             for r in range(world)]
    bad, out = [], []
    for j, run in enumerate(runs):
        label = run.get("label", tag)
        per_rank = [r["runs"][j] for r in ranks]
        for i, row in enumerate(per_rank[0]["frames"]):
            others = [k["frames"][i] for k in per_rank]
            for r, x in enumerate(others):
                if x["launches"] != run["launches"][i]:
                    bad.append(f"{run['name']} frame {i} rank {r} launches "
                               f"{x['launches']}")
            if run.get("gate"):
                gate = run["gate"]
                ok = (row["frame"]["max_abs"] <= gate["max_abs"]
                      and row["feature"]["max_abs"] <= gate["max_abs"]
                      and row["bpp_rel"] <= gate["bpp_rel"])
                text = (f"gate max|d| {gate['max_abs']}, bpp rel "
                        f"{gate['bpp_rel']}")
            elif run["dtype"] == "bfloat16":
                ok = (row["frame"]["rel_fro"] <= P23_REL
                      and row["feature"]["rel_fro"] <= P23_REL
                      and row["bpp_rel"] <= P23_BPP_REL)
                text = f"tol rel {P23_REL}, bpp rel {P23_BPP_REL}"
            else:
                ok = (row["frame"]["excess"] <= 0
                      and row["feature"]["excess"] <= 0
                      and row["bpp_excess"] <= 0)
                text = (f"excess over test_mesh.py's tolerances: frame "
                        f"{row['frame']['excess']:.3g}, feature "
                        f"{row['feature']['excess']:.3g}, bpp "
                        f"{row['bpp_excess']:.3g}")
            per = "; ".join(
                f"rank {r}: slab {x['slab']}, launches {x['launches']}, "
                f"halo {x['halo_bytes']} B, moved {x['move_bytes']} B, "
                f"{x['ms']:.1f} ms" for r, x in enumerate(others))
            print(f"  ({label}) {run['name']} {run['h']}x{run['w']} over "
                  f"{world} ranks, frame {i}: frame rel "
                  f"{row['frame']['rel_fro']:.3g} max|d| "
                  f"{row['frame']['max_abs']:.3g}, feature rel "
                  f"{row['feature']['rel_fro']:.3g} max|d| "
                  f"{row['feature']['max_abs']:.3g}, bpp {row['bpp']:.6f} vs "
                  f"{row['bpp_ref']:.6f} (rel {row['bpp_rel']:.3g}; {text});"
                  f" unsharded launches {run['launches'][i]}, "
                  f"{run['ms'][i]:.2f} ms; {per} [{card}]")
            if not ok:
                bad.append(f"{run['name']} frame {i}: {row}")
        print(f"  ({label}) {run['name']} over {world} ranks: peak memory "
              f"above what was allocated before the frames (weights, "
              f"inputs, the DPB) by rank "
              f"{[round(k['peak'] / 2**20, 1) for k in per_rank]} MiB, "
              f"unsharded {run['peak'] / 2**20:.1f} MiB [{card}]")
        out.append(dict(name=run["name"], variant=run.get("variant"),
                        dtype=run["dtype"], h=run["h"], w=run["w"],
                        widths=run["widths"], counters=run["counters"],
                        int8=run.get("int8", "0"), world=world,
                        ranks=per_rank, unsharded_ms=run["ms"],
                        unsharded_launches=run["launches"],
                        unsharded_peak=run["peak"]))
    print(f"  ({tag}) {world} ranks: neither the times nor the peaks are "
          f"gated, and the times are not a latency result: the ranks share "
          f"one card and every halo crosses host memory (gloo); spawn and "
          f"all {spawn_s:.1f} s [{card}]")
    if bad:
        fail(f"({tag}) row-sharded P-frame over {world} ranks: "
             + "; ".join(bad))
    return out, spawn_s


def p23_rows(torch, seed, card, tmp: Path):
    """(c) the row-sharded P-frame on two ranks sharing cuda:0 over gloo,
    each of P23_RUNS ((e): mask_prop's among them) against the unsharded
    P-frame on the card on the same inputs; then the bf16 run's first
    frame over each of P23_WIDE ranks."""
    runs = p23_refs(torch, seed, P23_RUNS)
    out, spawn_s = p23_spawn_rows(torch, seed, card, tmp, runs, 2, "c")
    wide = {}
    first = dict(runs[0], frames=runs[0]["frames"][:1],
                 masks=runs[0]["masks"][:1], ref=runs[0]["ref"][:1],
                 ms=runs[0]["ms"][:1], launches=runs[0]["launches"][:1])
    for n in P23_WIDE:
        rec, secs = p23_spawn_rows(torch, seed, card, tmp, [first], n,
                                   f"c{n}")
        wide[n] = dict(run=rec[0], spawn_s=secs)
    return dict(runs=out, spawn_s=spawn_s, wide=wide)


def p23_dp_rank(rank, world, rdzv, path):
    """(d) one rank of the data-parallel micro-step on cuda:0 over gloo:
    its B=1 shard; the noise-free micro-step (train=False), then a
    train_step with the noise seeded per rank."""
    import hashlib

    import torch
    import torch.distributed as dist

    from ssgvc_tpu_torch.config import TrainConfig
    from ssgvc_tpu_torch.parallel.mesh import (all_reduce_mean_, make_mesh,
                                               mean_metrics)
    from ssgvc_tpu_torch.training.trainer import Trainer

    case = torch.load(Path(path) / "dp_case.pt")
    dev = "cuda:0"
    p23_join(torch, rank, world, rdzv)
    try:
        cfg = TrainConfig(accumulation_steps=1, num_devices=world,
                          recon_residual=True)
        tr = Trainer(cfg, device=dev, mesh=make_mesh(world, device=dev))
        per = case["batch"]["frames"].shape[0] // world
        batch = {k: v[rank * per:(rank + 1) * per].to(dev)
                 for k, v in case["batch"].items()}
        state = tr.init_state(torch.Generator().manual_seed(0), batch,
                              params_p=case["params"][0],
                              params_i=case["params"][1])
        tr.tx.zero_grad()
        loss, _ = tr.gop_loss(batch["frames"], batch["masks"], QP,
                              torch.Generator().manual_seed(1), train=False,
                              eval_mode=False)
        tr.backward(loss)
        tr.tx.step()
        mean = float(mean_metrics({"loss": loss.detach()}, tr.group)["loss"])
        # the gradient's all-reduce alone, on copies (one flat buffer)
        grads = [p.grad.clone() for p in tr.dmc.parameters()]
        dist.barrier()
        t0 = time.perf_counter()
        all_reduce_mean_(grads, tr.group)
        torch.cuda.synchronize()
        reduce_ms = 1e3 * (time.perf_counter() - t0)

        def digest():
            h = hashlib.sha256()
            for v in tr.dmc.state_dict().values():
                h.update(v.detach().cpu().numpy().tobytes())
            return h.hexdigest()

        out = {"loss": mean, "local_loss": float(loss.detach()),
               "after_step": digest(), "all_reduce_ms": reduce_ms,
               "grad_bytes": sum(g.numel() * g.element_size()
                                 for g in grads)}
        if rank == 0:
            torch.save(torch.cat([p.grad.double().reshape(-1).cpu()
                                  for p in tr.dmc.parameters()]),
                       Path(path) / "dp_grad.pt")
        # the second micro-step of the process (cuDNN's and cuBLAS's plans
        # made by the first), timed
        dist.barrier()
        t0 = time.perf_counter()
        state, aux = tr.train_step(state, batch, QP,
                                   torch.Generator().manual_seed(10 + rank))
        torch.cuda.synchronize()
        out.update(train_loss=float(aux["loss"]), after_train_step=digest(),
                   step_ms=1e3 * (time.perf_counter() - t0))
        (Path(path) / f"dp{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def p23_dp(torch, seed, card, tmp: Path):
    """(d) the full-width data-parallel micro-step on two ranks sharing
    cuda:0 over gloo, B=1 a rank, against the world-1 step on the same
    B=2 batch (the default TrainConfig at accumulation 1, train=False:
    the quantiser noise is seeded per rank), on phase 13's cross-check
    weights (recon_residual, TRAIN_HEADS): a fresh init's reconstruction
    sits on the [0, 1] clamp, and its bf16 gradient turns with each
    rounding (cosine 0.004 between the two in the tiny CPU rehearsal,
    0.99925 on these weights)."""
    import torch.multiprocessing as mp

    from ssgvc_tpu_torch.config import TrainConfig
    from ssgvc_tpu_torch.data.device_synth import synth_batch
    from ssgvc_tpu_torch.training.trainer import Trainer

    g = torch.Generator(device=DEVICE).manual_seed(seed + 30)
    batch = synth_batch(g, batch=2, size=TRAIN_HW, seq_len=TRAIN_T)
    tr = Trainer(TrainConfig(accumulation_steps=1, recon_residual=True),
                 device=DEVICE)
    random_weights(torch, tr.dmc, seed, TRAIN_HEADS)
    random_weights(torch, tr.dmci, seed, DMCI_HEADS)
    params = tuple({k: v.detach().cpu().clone()
                    for k, v in m.state_dict().items()}
                   for m in (tr.dmc, tr.dmci))
    tr.init_state(torch.Generator().manual_seed(seed), batch,
                  params_p=params[0], params_i=params[1])
    tr.tx.zero_grad()
    loss, _ = tr.gop_loss(batch["frames"], batch["masks"], QP,
                          torch.Generator().manual_seed(1), train=False,
                          eval_mode=False)
    tr.backward(loss)
    tr.tx.step()
    ref = torch.cat([p.grad.double().reshape(-1).cpu()
                     for p in tr.dmc.parameters()])
    loss = float(loss.detach())
    del tr
    torch.save({"batch": {k: v.cpu() for k, v in batch.items()},
                "params": params}, tmp / "dp_case.pt")
    t0 = time.perf_counter()
    mp.spawn(p23_dp_rank, args=(2, str(tmp / "rdzv_d"), str(tmp)), nprocs=2,
             join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [json.loads((tmp / f"dp{r}.json").read_text()) for r in range(2)]
    dp = torch.load(tmp / "dp_grad.pt")
    cos = float(torch.dot(dp, ref) / (torch.linalg.vector_norm(dp)
                                      * torch.linalg.vector_norm(ref)))
    rel = abs(ranks[0]["loss"] - loss) / abs(loss)
    same = all(ranks[0][k] == ranks[1][k] for k in
               ("loss", "after_step", "train_loss", "after_train_step"))
    print(f"  (d) data-parallel micro-step, 2 ranks x B=1 on cuda:0 (gloo) "
          f"vs world 1 on B=2 ({TRAIN_HW}x{TRAIN_HW} T={TRAIN_T}, "
          f"train=False): loss {ranks[0]['loss']:.6f} vs {loss:.6f} (rel "
          f"{rel:.3g}, tol {P23_DP_LOSS}; the ranks' own "
          f"{ranks[0]['local_loss']:.6f} / {ranks[1]['local_loss']:.6f}), "
          f"gradient cosine {cos:.6f} (fp64, tol >= {P23_DP_COSINE}); "
          f"losses and parameters equal across the ranks after the update "
          f"and after a train_step with per-rank noise: {same}; that "
          f"train_step {ranks[0]['step_ms']:.1f} / {ranks[1]['step_ms']:.1f} "
          f"ms on the two ranks, the gradient's all-reduce alone "
          f"({ranks[0]['grad_bytes'] / 2**20:.1f} MiB, through host memory) "
          f"{ranks[0]['all_reduce_ms']:.1f} / {ranks[1]['all_reduce_ms']:.1f}"
          f" ms; spawn and all {spawn_s:.1f} s [{card}]")
    if not (rel <= P23_DP_LOSS and cos >= P23_DP_COSINE and same):
        fail(f"(d) data-parallel micro-step: loss rel {rel}, cosine {cos}, "
             f"ranks equal {same}: {ranks}")
    return dict(loss=ranks[0]["loss"], world1_loss=loss, loss_rel=rel,
                grad_cosine=cos, ranks_equal=same, spawn_s=spawn_s,
                step_ms=[r["step_ms"] for r in ranks],
                all_reduce_ms=[r["all_reduce_ms"] for r in ranks],
                grad_bytes=ranks[0]["grad_bytes"])


def phase_parallel(torch, seed, card):
    """parallel/ and dryrun_multichip on the card (module docstring, phase
    23)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        out = {"dryrun": p23_dryrun()}
        out["world1"] = p23_world1(torch, seed, card, tmp)
        out["rows"] = p23_rows(torch, seed, card, tmp)
        out["data_parallel"] = p23_dp(torch, seed, card, tmp)
    out["seconds"] = time.perf_counter() - t0
    print(f"parallel: phase 23 in {out['seconds']:.1f} s [{card}]")
    return out


# ---- phase 24: the opt-in experiments (SSGVC_INT8, SSGVC_DW, FUSE_*) ----
P24_FRAMES = 3               # P-frames of (b)'s int8 GOPs
P24_RUNS = 2                 # timed GOPs per route in (b); ms their median
P24_REPS = 10                # launches per cuda_ms in (a)
P24_BPP = (0.0, 24.0)        # (b): bpp range, as tests/test_int8.py:91-96
P24_F32_TOL = F32_TOL        # (e) fp32 fused vs unfused patch convs
P24_WANT_3X3 = ((19, 5), (18, 5))   # (b) scope 3x3: the fused kernels'
#                                     launches on the first P-frame, then
H100_INT8_OPS = 1979e12      # dense int8 tensor-core peak, H100 SXM
#: (f) a whole int8 frame row-sharded against the unsharded one: room for
#: a flipped latent rounding (the JAX package's own shards moved its int8
#: frame 0.055 max |d|, bpp 1.7e-4 relative, at 1088 rows over 4 on the
#: CPU)
P24_SHARD_GATE = dict(max_abs=0.1, bpp_rel=1e-3)


@contextlib.contextmanager
def p24_env(**env):
    """The experiment variables set as given (None: unset) for the body,
    restored after."""
    old = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def p24_psnr(torch, a, b) -> float:
    mse = float(((a.float() - b.float()) ** 2).mean())
    return 10 * math.log10(1.0 / max(mse, 1e-20))


def p24_rel(torch, a, b) -> float:
    return float(torch.linalg.vector_norm(a.float() - b.float())
                 / torch.linalg.vector_norm(b.float()))


def p24_sites(torch, iframe, main, variant_states):
    """Every int8 site the full-width codecs reach under SSGVC_INT8=1,
    recorded from their forwards (not listed by hand): the performance
    P-frame (packed io; after_i True and False, so both feature adaptors),
    the DMCI I-frame, and the sites of the fast and mask_prop P-frames
    whose Cin is not a multiple of 16 (the kernel's per-element loads).
    Returns {key: {"P": per P-frame, "I": per I-frame, ...}} with key
    (B, H, W, Cin, O, k, stride, pads)."""
    from ssgvc_tpu_torch.config import DMCConfig, DMCIConfig
    from ssgvc_tpu_torch.layers import blocks
    from ssgvc_tpu_torch.models.dmc import DMC
    from ssgvc_tpu_torch.models.dmci import DMCI
    from ssgvc_tpu_torch.ops.pixel import pixel_unshuffle

    sites, where = {}, [None]
    real = blocks.qconv

    def record(x, wq, s_w, bias, s_x, kernel, stride, pads, out_dtype=None):
        key = (*x.shape, wq.shape[0], kernel, stride, tuple(pads))
        row = sites.setdefault(key, {})
        row[where[0]] = row.get(where[0], 0) + 1
        return real(x, wq, s_w, bias, s_x, kernel, stride, pads, out_dtype)

    bf16 = torch.bfloat16
    frame = pixel_unshuffle(main["frames"][0].to(bf16), 8)
    mask = pixel_unshuffle(main["masks"][0].to(bf16), 8)
    blocks.qconv = record
    try:
        with torch.no_grad(), p24_env(SSGVC_INT8="1",
                                      SSGVC_INT8_SCOPE=None):
            dmci = DMCI(DMCIConfig(dtype="bfloat16"), device=DEVICE)
            dmci.load_state_dict(iframe["state"], strict=True)
            where[0] = "I"
            dmci.eval()(iframe["frame"].to(bf16), QP)
            del dmci
            for variant, state in (("performance", main["state"]),
                                   ("fast", variant_states["fast"]),
                                   ("mask_prop",
                                    variant_states["mask_prop"])):
                model = DMC(DMCConfig.variant(variant, dtype="bfloat16",
                                              packed_io=True),
                            device=DEVICE)
                model.load_state_dict(state, strict=True)
                model.eval()
                dpb = {"frame": pixel_unshuffle(main["dpb_frame"], 8),
                       "feature": torch.zeros(
                           (1, H // 8, W // 8, model.cfg.ch_d), dtype=bf16,
                           device=DEVICE)}
                for after_i in (True, False):
                    where[0] = (("P_after_i" if after_i else "P")
                                if variant == "performance"
                                else f"{variant}{'_after_i' * after_i}")
                    model(frame, QP, dpb, after_i=after_i, mask=mask)
                del model
    finally:
        blocks.qconv = real
    torch.cuda.synchronize()
    # the variants' sites with the 16-channel loads repeat the performance
    # codec's widths: keep their small-Cin ones
    return {k: v for k, v in sites.items()
            if any(w in ("I", "P", "P_after_i") for w in v) or k[3] % 16}


def p24_bound(key, size):
    """(ms, bound_by): int8 products at the int8 peak, or x read once, wq
    read once and y written once at the HBM rate, the larger."""
    b, h, w, cin, o, k, s, (pt, pb, pl, pr) = key
    ho = (h + pt + pb - k) // s + 1
    wo = (w + pl + pr - k) // s + 1
    m = b * ho * wo
    ops = 2 * m * k * k * cin * o / H100_INT8_OPS
    nbytes = (b * h * w * cin * size + o * k * k * cin + m * o * size
              + 8 * o) / H100_BYTES_PER_S
    return 1e3 * max(ops, nbytes), ("operations" if ops >= nbytes
                                    else "bytes")


def p24_kernel_rows(torch, seed, card, sites):
    """(a) qconv against qconv_plain bit for bit at every site shape, in
    bf16 and fp32, with mode 1's and mode 2's scales; timed in bf16 beside
    the plain version, the bf16 route the port takes with int8 off
    (F.linear / cuDNN) and, at the 1x1 sites, the library route (torch ops
    quantize, torch._int_mm, dequant), which must equal the kernel."""
    import torch.nn.functional as F

    from ssgvc_tpu_torch.ops import qconv as Q

    rng = np.random.default_rng(seed + 24)
    rows, worst = [], 0.0
    for key, per in sorted(sites.items()):
        b, h, w, cin, o, k, s, pads = key
        x32 = torch.tensor(rng.standard_normal((b, h, w, cin)),
                           dtype=torch.float32, device=DEVICE)
        wt = torch.tensor(rng.standard_normal((o, cin, k, k))
                          * (k * k * cin) ** -0.5, dtype=torch.float32,
                          device=DEVICE)
        bias = torch.tensor(rng.standard_normal(o) * 0.1,
                            dtype=torch.float32, device=DEVICE)
        wq, s_w = Q.quantize_weight(wt)
        row = dict(shape=list(key[:4]), out_ch=o, kernel=k, stride=s,
                   pads=list(pads), per_frame=per)
        for dt in (torch.bfloat16, torch.float32):
            x = x32.to(dt)
            absmax = 1.25 * float(x.float().abs().max())
            for mode, s_x in (("1", Q.dynamic_scale(x)),
                              ("2", torch.tensor(Q.static_scale(absmax),
                                                 device=DEVICE))):
                out = Q.qconv_cuda(x, wq, s_w, bias, s_x, k, s, pads, dt)
                ref = Q.qconv_plain(x, wq, s_w, bias, s_x, k, s, pads, dt)
                torch.cuda.synchronize()
                d = float((out.float() - ref.float()).abs().max())
                worst = max(worst, d)
                if not torch.isfinite(out.float()).all() or \
                        not torch.equal(out, ref):
                    fail(f"qconv {key} {dt} mode {mode}: kernel != plain "
                         f"(max |d| {d})")
        x = x32.to(torch.bfloat16)
        s_x = Q.dynamic_scale(x)
        row["kernel_ms"] = cuda_ms(torch, lambda: Q.qconv_cuda(
            x, wq, s_w, bias, s_x, k, s, pads, torch.bfloat16), P24_REPS)
        row["plain_ms"] = cuda_ms(torch, lambda: Q.qconv_plain(
            x, wq, s_w, bias, s_x, k, s, pads, torch.bfloat16), 3, 1)
        wb, bb = wt.to(torch.bfloat16), bias.to(torch.bfloat16)
        if k == 1 and s == 1:
            bf16 = lambda: F.linear(x, wb[:, :, 0, 0], bb)
        else:
            bf16 = lambda: F.conv2d(
                F.pad(x.permute(0, 3, 1, 2), (pads[2], pads[3], pads[0],
                                              pads[1])), wb, bb,
                s).permute(0, 2, 3, 1).contiguous()
        row["bf16_ms"] = cuda_ms(torch, bf16, P24_REPS)
        row["library_ms"] = None
        if k == 1 and s == 1:
            kk = cin
            wt_k = wq[:, :kk].contiguous().t()

            def library():
                xq = torch.clamp(torch.round(x.float() / s_x), -127,
                                 127).to(torch.int8).reshape(-1, kk)
                acc = torch._int_mm(xq, wt_k)
                y = acc.float() * (s_x * s_w) + bias
                return y.to(torch.bfloat16).reshape(b, h, w, o)
            try:
                lib_out = library()
            except RuntimeError as e:       # _int_mm's shape rules
                row["library_refused"] = str(e).splitlines()[0][:120]
            else:
                out = Q.qconv_cuda(x, wq, s_w, bias, s_x, k, s, pads,
                                   torch.bfloat16)
                torch.cuda.synchronize()
                if not torch.equal(lib_out, out):
                    fail(f"qconv {key}: the library route (_int_mm) != the "
                         "kernel")
                row["library_ms"] = cuda_ms(torch, library, P24_REPS)
        row["bound_ms"], row["bound_by"] = p24_bound(key, 2)
        row["share"] = row["bound_ms"] / row["kernel_ms"]
        rows.append(row)
        lib = (f"{row['library_ms']:.4f}" if row["library_ms"] is not None
               else row.get("library_refused", "n/a"))
        print(f"  qconv {b}x{h}x{w}x{cin} -> {o} k{k} s{s} pads {pads} "
              f"{per}: kernel {row['kernel_ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f}, bf16 route {row['bf16_ms']:.4f}, "
              f"library (_int_mm) {lib}, bound {row['bound_ms']:.4f} "
              f"({row['bound_by']}, share {row['share']:.3f}); bit for bit "
              f"in bf16 and fp32, modes 1 and 2 [{card}]")
    return rows, worst


def p24_gop(torch, model, frames, masks, dpb, counters=None):
    """The packed-io GOP as phase 5 runs it; returns (frames, bpps,
    per-frame launch counts of ``counters`` (module, attribute) pairs)."""
    outs, bpps, counts = [], [], []
    for i in range(frames.shape[0]):
        before = [getattr(m, a) for m, a in counters or ()]
        out = model(frames[i:i + 1], QP, dpb, after_i=(i == 0),
                    mask=masks[i:i + 1])
        dpb = out["dpb"]
        outs.append(dpb["frame"])
        bpps.append(out["bpp"].float())
        counts.append(tuple(getattr(m, a) - n
                            for (m, a), n in zip(counters or (), before)))
    return outs, torch.cat(bpps), counts


def p24_timed(torch, fn, runs=P24_RUNS):
    """(median ms of fn over ``runs`` calls after one warm-up, last
    result)."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times)), res


def p24_pframe(torch, card, main, tmp: Path):
    """(b) the full-width performance P-frame GOP under int8: mode 2 with
    scales calibrated on the GOP's first two frames, saved and loaded into
    a fresh model (bit for bit); mode 1; mode 2 at scope 3x3 (the fused
    kernels' launches); each beside the bf16 GOP. Returns the numbers and
    mode 2's scales."""
    from ssgvc_tpu_torch.config import DMCConfig
    from ssgvc_tpu_torch.layers import blocks
    from ssgvc_tpu_torch.models.dmc import DMC
    from ssgvc_tpu_torch.ops import dcb as dcb_ops
    from ssgvc_tpu_torch.ops import dcb_chain as chain_ops
    from ssgvc_tpu_torch.ops import qconv as Q
    from ssgvc_tpu_torch.ops.pixel import pixel_shuffle, pixel_unshuffle

    bf16 = torch.bfloat16
    cfg = DMCConfig.variant("performance", dtype="bfloat16", packed_io=True)

    def fresh():
        m = DMC(cfg, device=DEVICE)
        m.load_state_dict(main["state"], strict=True)
        return m.eval()

    n = P24_FRAMES
    frames = pixel_unshuffle(main["frames"][:n].reshape(n, H, W, 3), 8)
    masks = pixel_unshuffle(main["masks"][:n].reshape(n, H, W, 1), 8)
    dpb = {"frame": pixel_unshuffle(main["dpb_frame"].to(bf16), 8),
           "feature": torch.zeros((1, H // 8, W // 8, cfg.ch_d), dtype=bf16,
                                  device=DEVICE)}
    counters = ((Q, "launches"), (dcb_ops, "launches"),
                (chain_ops, "launches"))
    model = fresh()
    raw = lambda f: pixel_shuffle(f, 8)
    out = {}
    with torch.no_grad():
        with p24_env(SSGVC_INT8="0", SSGVC_INT8_SCOPE=None, SSGVC_DW=None):
            ms, (ref, ref_bpp, _) = p24_timed(
                torch, lambda: p24_gop(torch, model, frames, masks, dpb))
        out["bf16"] = dict(ms_per_frame=ms / n, bpp=ref_bpp.tolist())
        with p24_env(SSGVC_INT8="2", SSGVC_INT8_SCOPE=None, SSGVC_DW=None):
            blocks.set_int8_scales({})
            with warnings.catch_warnings(), \
                    blocks.int8_calibration() as calib:
                warnings.simplefilter("ignore")   # every site is missing
                p24_gop(torch, model, frames[:2], masks[:2], dpb)
            scales = blocks.collect_int8_scales(calib)
            blocks.set_int8_scales(scales)
            blocks.save_int8_scales(str(tmp / "scales.json"))
            with warnings.catch_warnings():
                warnings.simplefilter("error")    # no site without a scale
                ms2, res2 = p24_timed(torch, lambda: p24_gop(
                    torch, model, frames, masks, dpb, counters))
                other = fresh()
                blocks.set_int8_scales({})
                loaded = blocks.load_int8_scales(str(tmp / "scales.json"))
                res_b = p24_gop(torch, other, frames, masks, dpb)
                del other
            if loaded != scales or not all(
                    torch.equal(a, b) for a, b in zip(res2[0], res_b[0])) \
                    or not torch.equal(res2[1], res_b[1]):
                fail("(b) mode 2: the fresh model with the reloaded scales "
                     "differs from the calibrated one")
        runs = {"mode2": (ms2, res2)}
        for name, env in (("mode1", dict(SSGVC_INT8="1",
                                         SSGVC_INT8_SCOPE=None)),
                          ("mode2_3x3", dict(SSGVC_INT8="2",
                                             SSGVC_INT8_SCOPE="3x3"))):
            with p24_env(SSGVC_DW=None, **env):
                for m, a in counters:
                    setattr(m, a, 0)
                runs[name] = p24_timed(torch, lambda: p24_gop(
                    torch, model, frames, masks, dpb, counters))
    for name, (ms, (recons, bpps, counts)) in runs.items():
        for f in recons:
            if not torch.isfinite(f.float()).all():
                fail(f"(b) {name}: a frame is not finite")
        b = bpps.cpu().numpy()
        if not (np.isfinite(b).all() and (b > P24_BPP[0]).all()
                and (b < P24_BPP[1]).all()):
            fail(f"(b) {name}: bpp {b} outside {P24_BPP}")
        psnr = [p24_psnr(torch, raw(a), raw(r)) for a, r in zip(recons, ref)]
        qc = [c[0] for c in counts]
        fused = [c[1:] for c in counts]
        if not all(qc):
            fail(f"(b) {name}: a frame launched no qconv: {qc}")
        if name == "mode2_3x3":
            want = [P24_WANT_3X3[0]] + [P24_WANT_3X3[1]] * (n - 1)
            if fused != want:
                fail(f"(b) scope 3x3: dcb / dcb_chain launches {fused}, "
                     f"expected {want}")
        elif any(f != (0, 0) for f in fused):
            fail(f"(b) {name}: the fused kernels ran under scope all: "
                 f"{fused}")
        out[name] = dict(ms_per_frame=ms / n, qconv_per_frame=qc,
                         fused_per_frame=fused, psnr_vs_bf16=psnr,
                         bpp=b.tolist(),
                         bpp_rel_vs_bf16=(b / ref_bpp.cpu().numpy()
                                          - 1).tolist())
        print(f"  (b) {name}: {n} P-frames {H}x{W} packed io bf16, "
              f"{ms / n:.2f} ms/frame (bf16 default "
              f"{out['bf16']['ms_per_frame']:.2f}; median of {P24_RUNS}), "
              f"qconv launches per frame {qc}, dcb/dcb_chain {fused}, PSNR "
              f"of the recon vs bf16's {[round(p, 2) for p in psnr]} dB, "
              f"bpp {np.round(b, 4).tolist()} (rel vs bf16 "
              f"{np.round(out[name]['bpp_rel_vs_bf16'], 4).tolist()}) "
              f"[{card}]")
    out["mode2"]["reloaded_equal"] = True
    out["sites_calibrated"] = len(scales)
    print(f"  (b) mode 2: {len(scales)} sites calibrated on 2 frames, "
          f"saved, loaded into a fresh model: its GOP equal bit for bit")
    out["qconv_launches"] = runs["mode1"][1][2]
    return out, scales


def p24_coded(torch, card, iframe, main):
    """(c) phase 10's codec (full width, packed P-frames) on I + 2 P under
    mode 2: scales calibrated through the encoder, saved, loaded before
    encoding and again before decoding; the decoder's frames equal the
    encoder's bit for bit."""
    from ssgvc_tpu_torch.coding.codec import VideoCodec
    from ssgvc_tpu_torch.config import DMCConfig, DMCIConfig
    from ssgvc_tpu_torch.layers import blocks
    from ssgvc_tpu_torch.models.dmc import DMC
    from ssgvc_tpu_torch.models.dmci import DMCI
    from ssgvc_tpu_torch.ops import qconv as Q

    dmci = DMCI(DMCIConfig(dtype="bfloat16"), device=DEVICE)
    dmci.load_state_dict(iframe["state"], strict=True)
    cfg = DMCConfig.variant("performance", dtype="bfloat16")
    dmc = DMC(cfg, device=DEVICE)
    dmc.load_state_dict(main["state"], strict=True)
    codec = VideoCodec(dmci.eval(), dmc.eval(), packed_dmc=True)
    frames = [main["frames"][i].float() for i in range(3)]
    mask = main["masks"][0].float()
    feat0 = torch.zeros((1, H // 8, W // 8, cfg.ch_d), dtype=torch.bfloat16,
                        device=DEVICE)

    def encode():
        enc = codec.dmci_compress(frames[0], QP)
        dpb = {"frame": enc["x_hat"], "feature": feat0}
        streams, recons = [enc["bit_stream"]], [enc["x_hat"]]
        for t in (1, 2):
            o = codec.dmc_compress(frames[t], QP, dpb, after_i=(t == 1),
                                   mask=mask)
            streams.append(o["bit_stream"])
            recons.append(o["x_hat"])
            dpb = o["dpb"]
        return streams, recons

    with tempfile.TemporaryDirectory() as tmp, \
            p24_env(SSGVC_INT8="2", SSGVC_INT8_SCOPE=None, SSGVC_DW=None):
        path = str(Path(tmp) / "scales.json")
        blocks.set_int8_scales({})
        with warnings.catch_warnings(), blocks.int8_calibration() as calib:
            warnings.simplefilter("ignore")
            encode()
        blocks.set_int8_scales(blocks.collect_int8_scales(calib))
        blocks.save_int8_scales(path)
        blocks.set_int8_scales({})
        blocks.load_int8_scales(path)
        Q.launches = 0
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            streams, recons = encode()
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        enc_launches = Q.launches
        blocks.set_int8_scales({})
        blocks.load_int8_scales(path)
        Q.launches = 0
        t0 = time.perf_counter()
        dec = codec.dmci_decompress(streams[0], H, W, QP)
        same = [torch.equal(dec["x_hat"], recons[0])]
        dpb = {"frame": dec["x_hat"], "feature": feat0}
        for t in (1, 2):
            d = codec.dmc_decompress(streams[t], H, W, QP, dpb,
                                     after_i=(t == 1))
            same.append(torch.equal(d["x_hat"], recons[t])
                        and bool(torch.isfinite(d["x_hat"].float()).all()))
            dpb = d["dpb"]
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        dec_launches = Q.launches
        n_scales = len(blocks._INT8_SCALES)
        blocks.set_int8_scales({})
    nbytes = [len(s) for s in streams]
    print(f"  (c) coded I + 2 P {H}x{W} under mode 2 ({n_scales} calibrated "
          f"sites loaded on both sides): decoded frames equal the "
          f"encoder's {same}; bytes {nbytes}; qconv launches encoder "
          f"{enc_launches}, decoder {dec_launches}; encode {enc_s:.2f} s, "
          f"decode {dec_s:.2f} s [{card}]")
    if not all(same) or not enc_launches or not dec_launches:
        fail(f"(c) int8 coded GOP: decoder equal {same}, qconv launches "
             f"{enc_launches} / {dec_launches}")
    return dict(equal=same, bytes=nbytes, sites=n_scales,
                qconv_launches=[enc_launches, dec_launches],
                encode_s=enc_s, decode_s=dec_s)


def p24_shiftadd(torch, card, main, scales):
    """(d) the scope-all mode-2 P-frame with SSGVC_DW=shiftadd against the
    grouped conv (cuDNN's depthwise): every block's dw op on the frame's
    own inputs (recorded from the conv run) within the kernels' bf16 gate;
    the two frames timed; the whole frame's difference printed (a bf16
    rounding anywhere flips latent roundings: experiments/
    p24_cpu_rehearsal.py moves the frame 7.7% in relative Frobenius, PSNR
    32.9 dB)."""
    from ssgvc_tpu_torch.config import DMCConfig
    from ssgvc_tpu_torch.layers import blocks
    from ssgvc_tpu_torch.models.dmc import DMC
    from ssgvc_tpu_torch.ops.pixel import pixel_shuffle, pixel_unshuffle

    bf16 = torch.bfloat16
    model = DMC(DMCConfig.variant("performance", dtype="bfloat16",
                                  packed_io=True), device=DEVICE)
    model.load_state_dict(main["state"], strict=True)
    model.eval()
    x = pixel_unshuffle(main["frames"][1].to(bf16), 8)
    m = pixel_unshuffle(main["masks"][1].to(bf16), 8)
    dpb = {"frame": pixel_unshuffle(main["dpb_frame"].to(bf16), 8),
           "feature": torch.zeros((1, H // 8, W // 8, model.cfg.ch_d),
                                  dtype=bf16, device=DEVICE)}
    seen = []
    hooks = [mod.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args[0])))
        for name, mod in model.named_modules() if name.endswith(".dc_2")]
    blocks.set_int8_scales(scales)
    res = {}
    with torch.no_grad():
        for dw in ("conv", "shiftadd"):
            with p24_env(SSGVC_INT8="2", SSGVC_INT8_SCOPE=None, SSGVC_DW=dw):
                res[dw] = p24_timed(torch, lambda: model(
                    x, QP, dpb, after_i=False, mask=m), 3)
            for h in hooks:
                h.remove()
            hooks = []
        sites = seen[:len(seen) // 4]        # one forward's (4 ran)
        worst, conv_ms, shift_ms = 0.0, 0.0, 0.0
        for mod, h in sites:
            w, b = mod.weight.to(bf16), mod.bias.to(bf16)
            ref = mod(h)
            out = blocks.dw3x3_shiftadd(h, w, b)
            rel, _ = check_close(torch, "(d) dw3x3_shiftadd", out, ref)
            worst = max(worst, rel)
            conv_ms += cuda_ms(torch, lambda: mod(h), P24_REPS)
            shift_ms += cuda_ms(torch, lambda: blocks.dw3x3_shiftadd(
                h, w, b), P24_REPS)
    blocks.set_int8_scales({})
    a, c = res["shiftadd"][1], res["conv"][1]
    for o in (a, c):
        check_frame(torch, "(d) int8 P-frame", o["bpp"],
                    pixel_shuffle(o["dpb"]["frame"], 8))
    fa, fc = pixel_shuffle(a["dpb"]["frame"], 8), pixel_shuffle(
        c["dpb"]["frame"], 8)
    out = dict(ms_per_frame={"conv": res["conv"][0],
                             "shiftadd": res["shiftadd"][0]},
               dw_sites=len(sites), dw_rel_worst=worst,
               dw_ms={"conv": conv_ms, "shiftadd": shift_ms},
               frame_rel=p24_rel(torch, fa, fc),
               frame_psnr=p24_psnr(torch, fa, fc),
               bpp_rel=float(a["bpp"].float() / c["bpp"].float() - 1))
    print(f"  (d) SSGVC_DW=shiftadd, int8 mode 2 P-frame {H}x{W}: "
          f"{out['ms_per_frame']['shiftadd']:.2f} ms vs grouped conv "
          f"{out['ms_per_frame']['conv']:.2f} ms; the {len(sites)} dw ops on "
          f"the frame's own inputs: worst rel {worst:.3g} (tol {REL_TOL}), "
          f"summed {shift_ms:.4f} ms vs cuDNN {conv_ms:.4f} ms; whole frame "
          f"rel {out['frame_rel']:.3g}, PSNR {out['frame_psnr']:.2f} dB, bpp "
          f"rel {out['bpp_rel']:.3g} (not gated) [{card}]")
    return out


def p24_fused(torch, card, main):
    """(e) phase 6's raw-io P-frame with FUSE_DOWN and FUSE_UP on against
    off, in bf16 and in fp32 (the 3xTF32 kernels): each patch conv on the
    frame's own inputs (recorded from the unfused run) within the kernels'
    gates (bf16 relative Frobenius REL_TOL, fp32 max relative
    P24_F32_TOL); the frames timed; the whole frame's difference printed
    (latent roundings flip: experiments/p24_cpu_rehearsal.py moves the
    bf16 frame 5.1% in relative Frobenius)."""
    from ssgvc_tpu_torch.config import DMCConfig
    from ssgvc_tpu_torch.layers import blocks
    from ssgvc_tpu_torch.models.dmc import DMC
    from ssgvc_tpu_torch.ops import pixel

    out = {}
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        model = DMC(DMCConfig.variant("performance", dtype=dtype,
                                      packed_io=False), device=DEVICE)
        model.load_state_dict(main["state"], strict=True)
        model.eval()
        x, m = main["frames"][1].to(dt), main["masks"][1].to(dt)
        dpb = {"frame": main["dpb_frame"].to(dt),
               "feature": torch.zeros((1, H // 8, W // 8, model.cfg.ch_d),
                                      dtype=dt, device=DEVICE)}
        seen = []
        hooks = [mod.register_forward_pre_hook(
            lambda mod, args: seen.append((mod, args[0])))
            for mod in model.modules()
            if isinstance(mod, (blocks.PatchDownConv, blocks.PatchUpConv))]
        res = {}
        with torch.no_grad():
            for fused in (False, True):
                pixel.FUSE_DOWN = pixel.FUSE_UP = fused
                try:
                    res[fused] = p24_timed(torch, lambda: model(
                        x, QP, dpb, after_i=False, mask=m), 3)
                finally:
                    pixel.FUSE_DOWN = pixel.FUSE_UP = False
                for h in hooks:
                    h.remove()
                hooks = []
            sites = seen[:len(seen) // 4]
            worst, ms = 0.0, {False: 0.0, True: 0.0}
            for mod, t in sites:
                ref = mod(t)
                pixel.FUSE_DOWN = pixel.FUSE_UP = True
                try:
                    got = mod(t)
                    ms[True] += cuda_ms(torch, lambda: mod(t), P24_REPS)
                finally:
                    pixel.FUSE_DOWN = pixel.FUSE_UP = False
                ms[False] += cuda_ms(torch, lambda: mod(t), P24_REPS)
                rel = (check_f32(torch, "(e) fused patch conv", got, ref,
                                 P24_F32_TOL)[0] if dt == torch.float32
                       else check_close(torch, "(e) fused patch conv", got,
                                        ref)[0])
                worst = max(worst, rel)
        fu, un = res[True][1], res[False][1]
        for o in (fu, un):
            check_frame(torch, f"(e) {dtype} raw-io P-frame", o["bpp"],
                        o["dpb"]["frame"])
        r = dict(ms_per_frame={"unfused": res[False][0],
                               "fused": res[True][0]},
                 sites=[type(mod).__name__ for mod, _ in sites],
                 site_worst=worst, site_ms={"unfused": ms[False],
                                            "fused": ms[True]},
                 frame_rel=p24_rel(torch, fu["dpb"]["frame"],
                                   un["dpb"]["frame"]),
                 frame_psnr=p24_psnr(torch, fu["dpb"]["frame"],
                                     un["dpb"]["frame"]),
                 bpp_rel=float(fu["bpp"].float() / un["bpp"].float() - 1))
        out[dtype] = r
        tol = P24_F32_TOL if dt == torch.float32 else REL_TOL
        print(f"  (e) FUSE_DOWN + FUSE_UP, raw-io P-frame {H}x{W} {dtype}: "
              f"{r['ms_per_frame']['fused']:.2f} ms vs unfused "
              f"{r['ms_per_frame']['unfused']:.2f} ms; the patch convs "
              f"{r['sites']} on the frame's own inputs: worst "
              f"{'max rel' if dt == torch.float32 else 'rel'} {worst:.3g} "
              f"(tol {tol}), summed {ms[True]:.4f} ms fused vs "
              f"{ms[False]:.4f} unfused; whole frame rel "
              f"{r['frame_rel']:.3g}, PSNR {r['frame_psnr']:.2f} dB, bpp rel "
              f"{r['bpp_rel']:.3g} (not gated) [{card}]")
        del model, res, seen, sites
    return out


def p24_rows(torch, seed, card, tmp: Path):
    """(f) SSGVC_INT8 modes 1 and 2 under the 2-rank row shard: one
    full-width 1088 x 1920 performance P-frame (bf16, packed io; mode 2 on
    scales calibrated on the unsharded frame), against the unsharded int8
    frame on the card (P24_SHARD_GATE), qconv's launches on each rank
    those of the unsharded frame."""
    base = dict(P23_RUNS[0], frames=1, gate=P24_SHARD_GATE, label="f")
    runs = p23_refs(torch, seed, [dict(base, name=f"int8 mode {m}", int8=m)
                                  for m in ("1", "2")])
    out, spawn_s = p23_spawn_rows(torch, seed, card, tmp, runs, 2, "f")
    for r in out:
        f = r["ranks"][0]["frames"][0]
        r["bit_for_bit"] = (f["frame"]["max_abs"] == 0
                            and f["feature"]["max_abs"] == 0
                            and f["bpp_rel"] == 0)
    return dict(runs=out, spawn_s=spawn_s)


@contextlib.contextmanager
def p24_qconv_calls():
    """Every ops.qconv.qconv call in the body, keyed (x shape, O, kernel,
    stride, pads, x dtype, out dtype, "bwd" inside the int8 backward
    else "fwd") with its count; yields the dict."""
    from ssgvc_tpu_torch.layers import blocks
    from ssgvc_tpu_torch.ops import qconv as Q

    calls, where = {}, ["fwd"]
    real, real_bwd = Q.qconv, Q._QConvGrad.backward

    def record(x, wq, s_w, bias, s_x, kernel, stride, pads, out_dtype=None):
        out_dtype = out_dtype or x.dtype
        key = (tuple(x.shape), wq.shape[0], kernel, stride, tuple(pads),
               str(x.dtype), str(out_dtype), where[0])
        calls[key] = calls.get(key, 0) + 1
        return real(x, wq, s_w, bias, s_x, kernel, stride, pads, out_dtype)

    def backward(ctx, g):
        where[0] = "bwd"
        try:
            return real_bwd(ctx, g)
        finally:
            where[0] = "fwd"

    Q.qconv = blocks.qconv = record
    Q._QConvGrad.backward = staticmethod(backward)
    try:
        yield calls
    finally:
        Q.qconv = blocks.qconv = real
        Q._QConvGrad.backward = staticmethod(real_bwd)


def p24_call_inputs(torch, rng, key):
    """Operands of a recorded qconv call: x (int8 values in fp32 for a
    backward call, whose scales are units and bias zero), the quantized
    weight, scales and bias."""
    from ssgvc_tpu_torch.ops import qconv as Q

    shape, o, k, s, pads, xdt, odt, where = key
    cin = shape[-1]
    wt = torch.tensor(rng.standard_normal((o, cin, k, k)),
                      dtype=torch.float32, device=DEVICE)
    wq, s_w = Q.quantize_weight(wt)
    if where == "bwd":
        x = torch.tensor(rng.integers(-127, 128, shape), dtype=torch.float32,
                         device=DEVICE)
        return x, wq, torch.ones_like(s_w), torch.zeros_like(s_w), \
            torch.ones((), device=DEVICE)
    x = torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                     device=DEVICE).to(getattr(torch, xdt.split(".")[-1]))
    bias = torch.tensor(rng.standard_normal(o) * 0.1, dtype=torch.float32,
                        device=DEVICE)
    return x, wq, s_w, bias, Q.dynamic_scale(x)


def p24_train(torch, seed, card):
    """(g) the int8 gradient on the card: the tiny profile's int8 micro-
    step (SSGVC_INT8=1) records every qconv call; each backward call's
    shape (the recomputed int32 sums: x's int8 values, unit scales, zero
    bias, fp32 out) launched against qconv_plain, bit for bit. Then one
    default-TrainConfig micro-step under SSGVC_INT8=1 at full width (B=4
    128x128 T=4, after one untimed): finite loss and gradients, ms, peak
    memory, qconv's launches forward and backward, and each recorded
    shape timed (kernel, plain), summed per micro-step."""
    from ssgvc_tpu_torch.config import TrainConfig
    from ssgvc_tpu_torch.data.device_synth import synth_batch
    from ssgvc_tpu_torch.ops import qconv as Q
    from ssgvc_tpu_torch.training.trainer import Trainer

    rng = np.random.default_rng(seed + 25)
    g = torch.Generator(device=DEVICE).manual_seed(seed + 30)

    def micro_step(tr, batch, gen):
        tr.tx.zero_grad()
        loss, _ = tr.gop_loss(batch["frames"], batch["masks"], QP, gen,
                              train=True, eval_mode=False)
        tr.backward(loss)
        grads = [p.grad.detach().clone() for p in tr.dmc.parameters()
                 if p.grad is not None]
        tr.tx.step()
        return loss.detach(), grads

    with p24_env(SSGVC_INT8="1", SSGVC_INT8_SCOPE=None, SSGVC_DW=None):
        cfg = TrainConfig()
        cfg.model_profile = "tiny"
        tiny = Trainer(cfg, device=DEVICE)
        batch = synth_batch(g, batch=2, size=64, seq_len=3)
        tiny.init_state(torch.Generator().manual_seed(seed), batch)
        with p24_qconv_calls() as tiny_calls:
            loss, _ = micro_step(tiny, batch,
                                 torch.Generator().manual_seed(seed))
        bwd = {k: n for k, n in tiny_calls.items() if k[-1] == "bwd"}
        if not bwd or not math.isfinite(float(loss)):
            fail(f"(g) tiny int8 micro-step: loss {float(loss)}, backward "
                 f"qconv calls {bwd}")
        for key in sorted(bwd):
            x, wq, s_w, bias, s_x = p24_call_inputs(torch, rng, key)
            shape, o, k, s, pads = key[:5]
            out = Q.qconv_cuda(x, wq, s_w, bias, s_x, k, s, pads,
                               torch.float32)
            ref = Q.qconv_plain(x, wq, s_w, bias, s_x, k, s, pads,
                                torch.float32)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                fail(f"(g) qconv backward shape {key}: kernel != plain "
                     f"(max |d| {float((out - ref).abs().max())})")
        print(f"  (g) tiny int8 micro-step: {sum(bwd.values())} backward "
              f"qconv launches at {len(bwd)} shapes, each equal to "
              f"qconv_plain bit for bit (fp32 out, x's int8 values, unit "
              f"scales) [{card}]")
        del tiny

        tr = Trainer(TrainConfig(), device=DEVICE)
        batch = synth_batch(g, batch=TRAIN_B, size=TRAIN_HW,
                            seq_len=TRAIN_T)
        tr.init_state(torch.Generator().manual_seed(seed), batch)
        micro_step(tr, batch, torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        Q.launches = 0
        with p24_qconv_calls() as calls:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            loss, grads = micro_step(tr, batch,
                                     torch.Generator().manual_seed(seed + 1))
            e1.record()
            e1.synchronize()
        ms = e0.elapsed_time(e1)
        peak = torch.cuda.max_memory_allocated()
        launches = Q.launches
        finite = all(bool(torch.isfinite(x).all()) for x in grads)
        nonzero = sum(bool((x != 0).any()) for x in grads)
        if not (math.isfinite(float(loss)) and finite and nonzero
                and launches == sum(calls.values())):
            fail(f"(g) full-width int8 micro-step: loss {float(loss)}, "
                 f"gradients finite {finite}, {nonzero} nonzero, qconv "
                 f"launches {launches} for {sum(calls.values())} calls")
        rows = []
        for key, n in sorted(calls.items()):
            x, wq, s_w, bias, s_x = p24_call_inputs(torch, rng, key)
            shape, o, k, s, pads, _, odt, where = key
            odt = getattr(torch, odt.split(".")[-1])
            rows.append(dict(
                key=[list(shape), o, k, s, list(pads), key[5], key[6],
                     where], launches=n,
                bound_ms=p24_bound((*shape, o, k, s, tuple(pads)),
                                   x.element_size())[0],
                kernel_ms=cuda_ms(torch, lambda: Q.qconv_cuda(
                    x, wq, s_w, bias, s_x, k, s, pads, odt), P24_REPS),
                plain_ms=cuda_ms(torch, lambda: Q.qconv_plain(
                    x, wq, s_w, bias, s_x, k, s, pads, odt), 3, 1)))
    by = lambda w, f: sum(r[f] * r["launches"] for r in rows
                          if w in (None, r["key"][-1]))
    out = dict(ms_per_micro_step=ms, peak_bytes=peak, loss=float(loss),
               grads_nonzero=nonzero, grads=len(grads),
               launches=launches,
               forward_launches=sum(r["launches"] for r in rows
                                    if r["key"][-1] == "fwd"),
               backward_launches=sum(r["launches"] for r in rows
                                     if r["key"][-1] == "bwd"),
               qconv_ms=by(None, "kernel_ms"),
               qconv_plain_ms=by(None, "plain_ms"),
               qconv_backward_ms=by("bwd", "kernel_ms"),
               qconv_bound_ms=by(None, "bound_ms"),
               tiny_backward_shapes=len(bwd), shapes=rows)
    print(f"  (g) full-width default TrainConfig micro-step under "
          f"SSGVC_INT8=1 (B={TRAIN_B} {TRAIN_HW}x{TRAIN_HW} T={TRAIN_T}): "
          f"loss {float(loss):.5f}, {nonzero} of {len(grads)} gradients "
          f"nonzero, all finite; {ms:.1f} ms, peak {peak / 2**20:.1f} MiB; "
          f"qconv launches {launches} ({out['forward_launches']} forward, "
          f"{out['backward_launches']} backward recomputing the sums) at "
          f"{len(rows)} shapes: {out['qconv_ms']:.3f} ms of kernel time per "
          f"micro-step ({out['qconv_backward_ms']:.3f} of it backward), "
          f"plain {out['qconv_plain_ms']:.3f}, bound "
          f"{out['qconv_bound_ms']:.3f} [{card}]")
    return out


def phase_experiments(torch, seed, card, iframe, main, variant_states):
    """The opt-in experiments on the card (module docstring, phase 24)."""
    from ssgvc_tpu_torch.layers import blocks

    t0 = time.perf_counter()
    saved = dict(blocks._INT8_SCALES)
    with tempfile.TemporaryDirectory() as tmp:
        sites = p24_sites(torch, iframe, main, variant_states)
        with torch.no_grad():
            rows, worst = p24_kernel_rows(torch, seed, card, sites)
        pframe, scales = p24_pframe(torch, card, main, Path(tmp))
        coded = p24_coded(torch, card, iframe, main)
        shiftadd = p24_shiftadd(torch, card, main, scales)
        fused = p24_fused(torch, card, main)
        sharded = p24_rows(torch, seed, card, Path(tmp))
        train = p24_train(torch, seed, card)
    blocks.set_int8_scales(saved)
    # the kernels-line entry: per mode-1 P-frame (after the first) and per
    # I-frame, each shape's time x its launches there, summed
    p_rows = [r for r in rows if "P" in r["per_frame"]]
    i_rows = [r for r in rows if "I" in r["per_frame"]]

    def total(rs, key, frame):
        return sum(r[key] * r["per_frame"][frame] for r in rs)

    launches = [c[0] for c in pframe.pop("qconv_launches")]
    if sum(r["per_frame"]["P"] for r in p_rows) != launches[-1]:
        fail(f"qconv: the site list's launches per P-frame "
             f"{sum(r['per_frame']['P'] for r in p_rows)} != (b)'s "
             f"{launches[-1]}")
    ops_ms = sum(p24_bound(tuple(r["shape"]) + (r["out_ch"], r["kernel"],
                                                r["stride"],
                                                tuple(r["pads"])), 2)[0]
                 * r["per_frame"]["P"] for r in p_rows
                 if r["bound_by"] == "operations")
    bound = total(p_rows, "bound_ms", "P")
    lib_rows = [r for r in p_rows if r["library_ms"] is not None]
    entry = dict(
        name="qconv", route="cuda", source="ssgvc_tpu_torch/csrc/qconv.cu",
        replaces="ssgvc_tpu/layers/blocks.py:234",
        replaces_what="QuantConv's XLA int8 conv (lax.conv_general_dilated "
                      "on int8, :234-238); not a Pallas kernel",
        launches=sum(launches), max_abs_err=worst,
        ms=total(p_rows, "kernel_ms", "P"),
        plain_ms=total(p_rows, "plain_ms", "P"),
        bound_ms=bound,
        bound_by="operations" if ops_ms >= bound / 2 else "bytes",
        library_ms=(total(lib_rows, "library_ms", "P")
                    if len(lib_rows) == len([r for r in p_rows
                                             if r["kernel"] == 1
                                             and r["stride"] == 1])
                    else None),
        library_sites="the 1x1 sites (torch._int_mm); the other sites have "
                      "no PyTorch int8 conv",
        library_1x1_kernel_ms=total(lib_rows, "kernel_ms", "P"),
        bf16_route_ms=total(p_rows, "bf16_ms", "P"),
        per="int8 mode-1 P-frame after the first (phase 24 (b)): per-shape "
            "time x launches per frame, summed; 'launches' the mode-1 GOP's "
            "total (per frame: launches_per_frame); 'iframe' the same per "
            "DMCI I-frame",
        launches_per_frame=launches,
        training=dict(
            launches=train["launches"],
            forward_launches=train["forward_launches"],
            backward_launches=train["backward_launches"],
            ms=train["qconv_ms"], plain_ms=train["qconv_plain_ms"],
            backward_ms=train["qconv_backward_ms"],
            bound_ms=train["qconv_bound_ms"],
            per="int8 (SSGVC_INT8=1) default-TrainConfig micro-step at full "
                "width (phase 24 (g)): per-shape time x launches, summed"),
        iframe=dict(launches=sum(r["per_frame"]["I"] for r in i_rows),
                    ms=total(i_rows, "kernel_ms", "I"),
                    plain_ms=total(i_rows, "plain_ms", "I"),
                    bound_ms=total(i_rows, "bound_ms", "I"),
                    bf16_route_ms=total(i_rows, "bf16_ms", "I")),
        shapes=rows)
    seconds = time.perf_counter() - t0
    print(f"experiments: phase 24 in {seconds:.1f} s; qconv per int8 "
          f"P-frame {entry['ms']:.3f} ms (bound {entry['bound_ms']:.3f}, "
          f"plain {entry['plain_ms']:.3f}, bf16 route "
          f"{entry['bf16_route_ms']:.3f}, _int_mm at the 1x1 sites "
          f"{entry['library_ms']}) [{card}]")
    return dict(pframe=pframe, coded=coded, shiftadd=shiftadd, fused=fused,
                sharded=sharded, train=train, sites=len(rows),
                seconds=seconds), entry


# Phase 25: the RD harness (ssgvc_tpu_torch/experiments/), in a temporary
# working directory. (a) rd_tpu.main: the committed marathon recipe
# (--lnorm --recon-skip) at rd-half, fp32, B=32 64x64 crops, sized for the
# smoke's time by its flags and two module constants; (b) rd_eval.main on
# (a)'s checkpoints at one crop with the coded check; (c) rd_continue.main
# for a few steps, then rd_keep_best.main(0) and (1) on its JSON; (d)
# rd_full.main at rd-mid and rd_demo.main (its own fixed widths: it has no
# profile flag) on the host data path.
P25_K = 2                    # micro-steps per mega-step
P25_TPU = ["--profile", "half", "--lnorm", "--recon-skip", "--batch", "32",
           "--crop", "64", "--k", str(P25_K), "--dmci-steps", "8",
           "--steps", "16", "--eval-every", "8", "--eval-clips", "2",
           "--eval-crop", "192", "--budget-min", "3"]
P25_GATE_STEP = 2            # rd_full.GATE_STEP: the gate after a mega-step
P25_PROBE = 4                # rd_tpu.DMCI_PROBE_STEPS: 2 mega-steps an init
P25_EVAL = ["--profile", "half", "--crops", "64"]
P25_CONTINUE = ["4", "--profile", "half", "--lnorm", "--recon-skip",
                "--budget-min", "1"]
P25_FULL = ["4", "--profile", "mid", "--lnorm", "--recon-skip",
            "--budget-min", "0.5"]
P25_DEMO = ["4"]
P25_DEMO_DMCI = 20           # rd_demo.DMCI_MIN_STEPS (800 in the recipe)
P25_SYNC_SITES = 5           # the source lines most syncs came from
P25_REPS = 5                 # timed launches a kernel shape in (a)
#: the JAX scripts' JSON keys: experiments/rd_tpu.py:482-540,
#: rd_eval.py:96-190, rd_continue.py:291-447, rd_full.py:287-391,
#: rd_demo.py:590-631
RD_TPU_KEYS = {"runner", "budget_min", "k", "crop", "batch", "profile",
               "eval_crop", "steps_schedule", "lambda_normalize",
               "recon_residual", "roi_subset", "roi_weight", "backend",
               "variants", "bd_rate_roi_psnr_pct", "bd_psnr_roi_db",
               "bd_rate_psnr_pct", "bd_psnr_db"}
RD_TPU_VARIANT_KEYS = {"estimated_rd", "best_step", "score", "liveness",
                       "bpp_monotone_increasing_in_qp"}
CURVE_KEYS = {"qp", "bpp", "psnr", "roi_psnr", "msssim"}
RD_EVAL_KEYS = {"profile", "crops", "ckpt_extra", "roi_subset"}
RD_EVAL_CROP_KEYS = {"trivial_bounds", "performance", "plain",
                     "bd_rate_roi_psnr_pct", "bd_rate_psnr_pct",
                     "bd_psnr_roi_db"}
RD_CONTINUED_KEYS = {"continued_steps", "budget_min", "variants",
                     "bd_rate_roi_psnr_pct", "bd_psnr_roi_db",
                     "bd_rate_psnr_pct", "bd_psnr_db"}
RD_FULL_KEYS = {"steps", "budget_min", "lambda_normalize", "recon_residual",
                "profile", "model", "variants", "bd_rate_roi_psnr_pct",
                "bd_rate_psnr_pct", "bd_psnr_roi_db", "estimate_vs_real_bpp"}
RD_DEMO_KEYS = {"steps", "variants", "coded_gop_qp24",
                "estimate_vs_real_bpp_qp24"}


def p25_keys(what, got, want):
    if set(got) != set(want):
        fail(f"{what}: keys {sorted(got)} != the JAX script's {sorted(want)}")


def p25_curve(what, curve, msssim=False):
    """A curve's keys, finite values, bpp > 0 (and MS-SSIM where asked)."""
    p25_keys(what, [k for k in curve if k in CURVE_KEYS], CURVE_KEYS)
    vals = curve["bpp"] + curve["psnr"] + curve["roi_psnr"]
    if msssim:
        vals = vals + [m if m is not None else math.nan
                       for m in curve["msssim"]]
    if not (all(math.isfinite(v) for v in vals)
            and all(b > 0 for b in curve["bpp"])):
        fail(f"{what}: curve not finite or bpp <= 0: {curve}")


def p25_same(torch, what, a, b):
    if a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in a):
        fail(f"{what}: the restored checkpoint differs from the run's")


#: the axis each BD field averages over: the overlap of the two curves'
#: ranges on it (PSNR for a BD-rate, the rate for a BD-PSNR)
P25_BD_AXIS = {"bd_rate_roi_psnr_pct": "roi_psnr", "bd_psnr_roi_db": "bpp",
               "bd_rate_psnr_pct": "psnr", "bd_psnr_db": "bpp"}


def p25_bd_fields(stored, want, perf, plain):
    """Fail unless each stored BD field equals ``want``'s: finite where the
    curves' ranges on its axis overlap, NaN (as bd_rate / bd_psnr give)
    only where they do not."""
    for k, v in want.items():
        a, t = plain[P25_BD_AXIS[k]], perf[P25_BD_AXIS[k]]
        overlap = min(max(a), max(t)) > max(min(a), min(t))
        ok = (math.isfinite(v) and stored[k] == v if overlap
              else math.isnan(v) and math.isnan(stored[k]))
        if not ok:
            fail(f"(a) {k} {stored[k]} against bd_rate / bd_psnr of the "
                 f"stored curves {v} (ranges on {P25_BD_AXIS[k]} "
                 f"{'overlap' if overlap else 'apart'}: {a}, {t})")


def p25_shapes_clear():
    from ssgvc_tpu_torch.ops import dcb as dcb_ops
    from ssgvc_tpu_torch.ops import dcb_chain as chain_ops
    from ssgvc_tpu_torch.ops import dcb_grad as dg

    for d in (dcb_ops.shape_launches_f32, dcb_ops.shape_launches_tf32,
              chain_ops.shape_launches_f32, chain_ops.shape_launches_tf32,
              dg.shape_launches):
        d.clear()


def p25_shapes_read():
    """The fp32 forward kernels' and the backward kernels' launches by
    operand shape since :func:`p25_shapes_clear`: ({kernel: {key: n}},
    {(kernel, key): n})."""
    from ssgvc_tpu_torch.ops import dcb as dcb_ops
    from ssgvc_tpu_torch.ops import dcb_chain as chain_ops
    from ssgvc_tpu_torch.ops import dcb_grad as dg

    fwd = {"dcb_f32": dcb_ops.shape_launches_f32,
           "dcb_tf32": dcb_ops.shape_launches_tf32,
           "dcb_chain_f32": chain_ops.shape_launches_f32,
           "dcb_chain_tf32": chain_ops.shape_launches_tf32}
    return ({k: dict(d) for k, d in fwd.items() if d},
            dict(dg.shape_launches))


def p25_kernel_shapes(torch, seed, card, shapes):
    """Every fp32 forward kernel and every backward kernel at each operand
    shape the last mega-step of each run of (a) launched it at (``shapes``:
    {run: p25_shapes_read()}), against its plain version at phase 14's and
    phase 17's gates (F32_TOL forward, BWD_FP32_TOL backward), timed.
    Returns {kernel: summary}."""
    fwd, bwd = {}, {}
    for f, b in shapes.values():
        for k, keyed in f.items():
            for key, n in keyed.items():
                fwd.setdefault(k, {})
                fwd[k][key] = fwd[k].get(key, 0) + n
        for kk, n in b.items():
            bwd[kk] = bwd.get(kk, 0) + n
    if "dcb_tf32" not in fwd:
        fail(f"(a) no 3xTF32 launch by shape in the mega-steps: "
             f"{sorted(fwd)}")
    where = "rd-half harness"
    per = ("the last mega-step of each run of phase 25 (a) (DMCI "
           "pretrain, performance, plain): each shape's time x its "
           "launches there, summed")
    with torch.no_grad():
        rows = phase_f32_shapes(torch, seed + 5, card, fwd, where=where,
                                reps=P25_REPS)
        out = phase_rd_backward(
            torch, seed + 5, card,
            [dict(kernel=k, key=list(key), launches=n)
             for (k, key), n in sorted(bwd.items())],
            where=where, per=per, reps=P25_REPS)
    for k, rs in rows.items():
        sum_of = lambda f: sum(r[f] * r["per_step"] for r in rs)
        out[k] = dict(launches=sum(r["per_step"] for r in rs),
                      ms=sum_of("ms"), plain_ms=sum_of("plain_ms"),
                      bound_ms=sum_of("bound_ms"),
                      max_abs_err=max(r["max_abs_err"] for r in rs),
                      max_rel_err=max(r["rel_err"] for r in rs), per=per,
                      shapes=rs)
    for k in out:
        out[k]["shapes"] = len(out[k]["shapes"])
        print(f"  (a) {k} held against its plain version at "
              f"{out[k]['shapes']} rd-half shapes ({out[k]['launches']} "
              f"launches in the runs' last mega-steps), max abs "
              f"{out[k]['max_abs_err']:.3g} [{card}]")
    return out


@contextlib.contextmanager
def p25_instrument(torch, rd_tpu, evaluate):
    """Wrap rd_tpu's mega-step makers (ms per call by the host clock: a
    mega-step ends by reading its means back; the second call of each run
    is watched by torch.cuda.set_sync_debug_mode and its synchronising
    calls counted instead; each call's kernel launches by operand shape
    kept, so the last of each run stays), its pretrain and variant runners
    (their returned params kept) and evaluate_rd_batched (s per call)."""
    rec = {"label": "dmci", "mega": {}, "syncs": {}, "sync_sites": {},
           "evals": [], "best": {}, "shapes": {}}
    real = {n: getattr(rd_tpu, n) for n in (
        "make_dmci_megastep", "make_dmc_megastep", "pretrain_dmci_tpu",
        "train_variant_tpu")}
    real_eval = evaluate.evaluate_rd_batched

    def timed(make):
        def build(*a, **kw):
            mega = make(*a, **kw)

            def call(*args):
                label = rec["label"]
                times = rec["mega"].setdefault(label, [])
                p25_shapes_clear()
                try:
                    return watched(label, times, *args)
                finally:
                    rec["shapes"][label] = p25_shapes_read()

            def watched(label, times, *args):
                if label in rec["syncs"] or not times:
                    t0 = time.perf_counter()
                    out = mega(*args)
                    times.append(1e3 * (time.perf_counter() - t0))
                    return out
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        out = mega(*args)
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                sites = [f"{os.path.relpath(w.filename)}:{w.lineno}"
                         for w in caught
                         if "synchroniz" in str(w.message)]
                rec["syncs"][label] = len(sites)
                rec["sync_sites"][label] = sorted(
                    ((sites.count(x), x) for x in set(sites)),
                    reverse=True)[:P25_SYNC_SITES]
                return out
            return call
        return build

    def pretrain(*a, **kw):
        rec["label"] = "dmci"
        model, params = real["pretrain_dmci_tpu"](*a, **kw)
        rec["dmci_params"] = params
        return model, params

    def variant(name, *a, **kw):
        rec["label"] = name
        tr, out, ok = real["train_variant_tpu"](name, *a, **kw)
        if ok:
            rec["best"][name] = (out["best"]["params_p"],
                                 {k: v.detach().cpu().clone() for k, v in
                                  tr.dmci.state_dict().items()})
        return tr, out, ok

    def ev(*a, **kw):
        t0 = time.perf_counter()
        out = real_eval(*a, **kw)
        rec["evals"].append((rec["label"], bool(kw.get("compute_msssim")),
                             time.perf_counter() - t0))
        return out

    rd_tpu.make_dmci_megastep = timed(real["make_dmci_megastep"])
    rd_tpu.make_dmc_megastep = timed(real["make_dmc_megastep"])
    rd_tpu.pretrain_dmci_tpu = pretrain
    rd_tpu.train_variant_tpu = variant
    evaluate.evaluate_rd_batched = ev
    try:
        yield rec
    finally:
        for n, f in real.items():
            setattr(rd_tpu, n, f)
        evaluate.evaluate_rd_batched = real_eval


def p25_rd_tpu(torch, card):
    """(a): rd_tpu.main at rd-half; returns (its numbers, launches)."""
    from ssgvc_tpu_torch.experiments import rd_full, rd_tpu
    from ssgvc_tpu_torch.training import evaluate
    from ssgvc_tpu_torch.training.evaluate import bd_psnr, bd_rate
    from ssgvc_tpu_torch.utils.checkpoint import restore_checkpoint

    reset, read = launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with p25_instrument(torch, rd_tpu, evaluate) as rec:
        reset()
        rd_tpu.main(P25_TPU)
        counts = read()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    with open(f"{rd_full.ARTIFACTS}/rd_tpu.json") as f:
        stored = json.load(f)
    p25_keys("(a) rd_tpu.json", stored, RD_TPU_KEYS)
    for v in ("performance", "plain"):
        p25_keys(f"(a) {v}", stored["variants"][v], RD_TPU_VARIANT_KEYS)
        p25_curve(f"(a) {v}", stored["variants"][v]["estimated_rd"],
                  msssim=True)
    perf = stored["variants"]["performance"]["estimated_rd"]
    plain = stored["variants"]["plain"]["estimated_rd"]
    want = {"bd_rate_roi_psnr_pct": bd_rate(plain["bpp"], plain["roi_psnr"],
                                            perf["bpp"], perf["roi_psnr"]),
            "bd_psnr_roi_db": bd_psnr(plain["bpp"], plain["roi_psnr"],
                                      perf["bpp"], perf["roi_psnr"]),
            "bd_rate_psnr_pct": bd_rate(plain["bpp"], plain["psnr"],
                                        perf["bpp"], perf["psnr"]),
            "bd_psnr_db": bd_psnr(plain["bpp"], plain["psnr"], perf["bpp"],
                                  perf["psnr"])}
    p25_bd_fields(stored, want, perf, plain)
    p25_same(torch, "(a) DMCI",
             restore_checkpoint(rd_full.dmci_ckpt_path())["params_i"],
             rec["dmci_params"])
    for v, (params_p, params_i) in rec["best"].items():
        ck = restore_checkpoint(rd_full.ckpt_path(v))
        p25_same(torch, f"(a) {v} params_p", ck["params_p"], params_p)
        p25_same(torch, f"(a) {v} params_i", ck["params_i"], params_i)
    if set(rec["best"]) != {"performance", "plain"}:
        fail(f"(a) variants trained: {sorted(rec['best'])}")
    if counts["dcb"] or counts["dcb_chain"] or not all(
            counts[k] for k in ("dcb_tf32", "dcb_chain_tf32",
                                *BWD_REPLACES)):
        fail(f"(a) launches {counts}: want the fp32 forward routes and the "
             f"four backward kernels, no bf16 launch")
    runs = {}
    for label, times in rec["mega"].items():
        warm = times[1:] or times
        ms = float(np.median(warm))
        runs[label] = dict(mega_steps=len(times) + (label in rec["syncs"]),
                           ms_per_mega_step=ms, ms_runs=times,
                           micro_steps_per_s=1e3 * P25_K / ms,
                           syncs_per_mega_step=rec["syncs"].get(label),
                           sync_sites=rec["sync_sites"].get(label))
        print(f"  (a) {label}: {runs[label]['mega_steps']} mega-steps of "
              f"{P25_K}, {ms:.1f} ms per mega-step (host clock, median of "
              f"{len(warm)} after the first; one more watched for syncs), "
              f"{runs[label]['micro_steps_per_s']:.2f} micro-steps/s, "
              f"{runs[label]['syncs_per_mega_step']} synchronising calls in "
              f"one mega-step (most from {runs[label]['sync_sites']}) "
              f"[{card}]")
    evals = [dict(variant=l, msssim=m, s=s) for l, m, s in rec["evals"]]
    in_run = [e["s"] for e in evals if not e["msssim"]]
    print(f"  (a) rd_tpu.main rd-half fp32 {' '.join(P25_TPU)}: "
          f"{seconds:.1f} s; s per in-run eval (2 clips 192x192, 5 QPs, "
          f"batched) {np.round(in_run, 3).tolist()}, with MS-SSIM "
          f"{[round(e['s'], 3) for e in evals if e['msssim']]}; peak "
          f"{peak / 2**20:.1f} MiB; launches {counts}; scores "
          f"{[round(stored['variants'][v]['score'], 3) for v in rec['best']]}"
          f", BD-rate ROI {stored['bd_rate_roi_psnr_pct']}; checkpoints "
          f"restored equal (torch.equal) [{card}]")
    return dict(seconds=seconds, peak_bytes=peak, launches=counts,
                shapes=rec["shapes"], runs=runs, evals=evals,
                s_per_eval=float(np.median(in_run)) if in_run else None,
                scores={v: stored["variants"][v]["score"]
                        for v in rec["best"]},
                bd={k: stored[k] for k in want}), counts


def p25_rd_eval(torch, card):
    """(b): rd_eval.main on (a)'s checkpoints at one crop, the coded check
    (evaluate_gop_coded raises unless every decoded frame equals the
    encoder's)."""
    from ssgvc_tpu_torch.experiments import rd_eval

    t0 = time.perf_counter()
    rd_eval.main(P25_EVAL)
    seconds = time.perf_counter() - t0
    with open(f"{rd_eval.ARTIFACTS}/rd_eval.json") as f:
        res = json.load(f)
    p25_keys("(b) rd_eval.json", res, RD_EVAL_KEYS)
    crop = res["crops"][P25_EVAL[P25_EVAL.index("--crops") + 1]]
    p25_keys("(b) crop", crop, RD_EVAL_CROP_KEYS)
    gaps = {}
    for v in ("performance", "plain"):
        p25_curve(f"(b) {v}", crop[v])
        gaps[v] = crop[v]["est_vs_real_bpp"]
        if [int(q) for q in gaps[v]] != list(EVAL_QPS) or not all(
                math.isfinite(g[k]) and g[k] > 0 for g in gaps[v].values()
                for k in ("estimated", "real")):
            fail(f"(b) {v}: coded check {gaps[v]}")
    print(f"  (b) rd_eval.main {' '.join(P25_EVAL)}: {seconds:.1f} s; "
          f"decoded frames equal the encoder's at every QP; real vs "
          f"estimated bpp (clip 0, P-frames): " + "; ".join(
              f"{v} " + ", ".join(f"QP {q} {g['real']:.4f} / "
                                  f"{g['estimated']:.4f}"
                                  for q, g in gaps[v].items())
              for v in gaps) + f" [{card}]")
    return dict(seconds=seconds, est_vs_real_bpp=gaps)


def p25_continue(torch, card):
    """(c): rd_continue.main for a few steps (the .prev snapshots), then
    rd_keep_best.main(0) (the .best snapshots) and main(1) on a forced
    regression: live restored from .best."""
    import filecmp

    from ssgvc_tpu_torch.experiments import rd_continue, rd_full, rd_keep_best
    from ssgvc_tpu_torch.utils.checkpoint import save_checkpoint

    t0 = time.perf_counter()
    rd_continue.main(P25_CONTINUE)
    seconds = time.perf_counter() - t0
    with open(rd_keep_best.CONTINUED_JSON) as f:
        res = json.load(f)
    p25_keys("(c) rd_continued.json", res, RD_CONTINUED_KEYS)
    live = {v: rd_full.ckpt_path(v) for v in rd_keep_best.VARIANTS}
    for v, path in live.items():
        p25_curve(f"(c) {v}", res["variants"][v]["estimated_rd"],
                  msssim=True)
        if not os.path.exists(path + ".prev"):
            fail(f"(c) no .prev snapshot of {path}")
    real_live = rd_keep_best.live_path
    # the keep-best rotation names the marathon's tiny-skip files; here it
    # rotates (c)'s rd-half checkpoints
    rd_keep_best.live_path = lambda v: live[v]
    try:
        first = rd_keep_best.main(0)[-1]
        for v, path in live.items():
            if (first[v].get("action") != "new_best"
                    or not filecmp.cmp(path, path + ".best", shallow=False)):
                fail(f"(c) keep-best cycle 0 {v}: {first[v]}")
        # a forced regression: each curve DIVERGE_DB lower in PSNR and in
        # ROI-PSNR, and live checkpoints that differ from .best
        for c in res["variants"].values():
            for k in ("psnr", "roi_psnr"):
                c["estimated_rd"][k] = [p - rd_keep_best.DIVERGE_DB
                                        for p in c["estimated_rd"][k]]
        with open(rd_keep_best.CONTINUED_JSON, "w") as f:
            json.dump(res, f)
        for path in live.values():
            ck = torch.load(path, map_location="cpu", weights_only=True)
            key = next(iter(ck["params_p"]))
            ck["params_p"][key] = ck["params_p"][key] + 1.0
            save_checkpoint(path, ck)
            if filecmp.cmp(path, path + ".best", shallow=False):
                fail("(c) the perturbed live checkpoint equals .best")
        second = rd_keep_best.main(1)[-1]
        for v, path in live.items():
            if (second[v].get("action") != "diverged_restored_best"
                    or not filecmp.cmp(path, path + ".best", shallow=False)):
                fail(f"(c) keep-best cycle 1 {v}: {second[v]}")
    finally:
        rd_keep_best.live_path = real_live
    print(f"  (c) rd_continue.main {' '.join(P25_CONTINUE)}: {seconds:.1f} s,"
          f" .prev snapshots written; rd_keep_best cycle 0 "
          f"{[first[v]['action'] for v in live]} (.best equal to live), "
          f"cycle 1 on curves {rd_keep_best.DIVERGE_DB} dB lower in PSNR and "
          f"ROI-PSNR "
          f"{[second[v]['action'] for v in live]} (live equal to .best "
          f"again) [{card}]")
    return dict(seconds=seconds, cycle0=first, cycle1=second)


def p25_host_runs(torch, card):
    """(d): rd_full.main at rd-mid and rd_demo.main on the host data path."""
    from ssgvc_tpu_torch.experiments import rd_demo, rd_full

    out = {}
    for name, fn, argv, keys in (
            ("rd_full", rd_full.main, P25_FULL, RD_FULL_KEYS),
            ("rd_demo", rd_demo.main, P25_DEMO, RD_DEMO_KEYS)):
        t0 = time.perf_counter()
        fn(list(argv))
        seconds = time.perf_counter() - t0
        with open(f"{rd_full.ARTIFACTS}/{name}.json") as f:
            stored = json.load(f)
        p25_keys(f"(d) {name}.json", stored, keys)
        for v in ("performance", "plain"):
            p25_curve(f"(d) {name} {v}",
                      stored["variants"][v]["estimated_rd"],
                      msssim=name == "rd_full")
        real = (stored["estimate_vs_real_bpp"] if name == "rd_full"
                else {"24": stored["estimate_vs_real_bpp_qp24"]})
        if not all(math.isfinite(r["real"]) and r["real"] > 0
                   for r in real.values()):
            fail(f"(d) {name}: real bpp {real}")
        out[name] = dict(seconds=seconds, est_vs_real_bpp=real)
        print(f"  (d) {name}.main {' '.join(argv)}: {seconds:.1f} s, "
              f"{name}.json with the JAX keys, finite; real vs estimated "
              f"bpp {real} [{card}]")
    return out


def phase_rd_harness(torch, seed, card):
    """Phase 25: the RD harness on the card (module docstring)."""
    from ssgvc_tpu_torch.experiments import rd_demo, rd_full, rd_tpu

    t0 = time.perf_counter()
    saved = (rd_full.GATE_STEP, rd_tpu.DMCI_PROBE_STEPS,
             rd_demo.DMCI_MIN_STEPS)
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        rd_full.GATE_STEP, rd_tpu.DMCI_PROBE_STEPS = P25_GATE_STEP, P25_PROBE
        rd_demo.DMCI_MIN_STEPS = P25_DEMO_DMCI
        try:
            tpu, counts = p25_rd_tpu(torch, card)
            ev = p25_rd_eval(torch, card)
            cont = p25_continue(torch, card)
            host = p25_host_runs(torch, card)
        finally:
            os.chdir(old)
            (rd_full.GATE_STEP, rd_tpu.DMCI_PROBE_STEPS,
             rd_demo.DMCI_MIN_STEPS) = saved
    tpu["kernels"] = p25_kernel_shapes(torch, seed, card,
                                       tpu.pop("shapes"))
    seconds = time.perf_counter() - t0
    print(f"rd harness: phase 25 in {seconds:.1f} s [{card}]")
    return dict(rd_tpu=tpu, rd_eval=ev, rd_continue=cont, host=host,
                seconds=seconds), counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--prev-port", default=None,
                    help="another checkout's ssgvc_tpu_torch/ whose "
                         "kernels are timed in turns with this one's")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import ssgvc_tpu_torch  # noqa: F401  (fails outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card, kind, count = phase_device(torch)
    phase_build()
    prev = load_prev_port(args.prev_port) if args.prev_port else None
    with torch.no_grad():
        kernels = phase_kernels(torch, args.seed, card, prev)
    iframe = phase_iframe(torch, args.seed, card)
    main_path = phase_main_path(torch, args.seed, args.frames, card,
                                iframe["frame"], prev)
    for entry, p_count, i_count in zip(kernels, main_path["launches"],
                                       iframe["launches"]):
        entry["launches"] = p_count
        entry["iframe"]["launches"] = i_count
    phase_streaming(torch, main_path)
    gop = phase_gop(torch, args.seed, iframe, main_path, card)
    xc16 = phase_cross_check(torch, main_path, iframe, args.seed)
    variants, variant_states = phase_variants(torch, args.seed, card, iframe,
                                              main_path)
    signs = phase_variants_cross_check(torch, variant_states, args.seed)
    coded = phase_coded(torch, args.seed, card, iframe, main_path, gop,
                        variant_states["mask_prop"])
    with torch.no_grad():
        batch = phase_batch(torch, args.seed, card)
        bwd_rows = phase_backward_kernels(torch, args.seed, card,
                                          prev is not None)
    training = phase_train(torch, args.seed, card)
    counts = training["launches_per_micro_step"]
    backward = backward_entries(bwd_rows, training.pop("shape_counts"), card)
    for entry in kernels:
        entry["training"] = dict(
            launches=counts[entry["name"]],
            per="launches per training micro-step; B=4 shapes timed "
                "against B launches of one image each (phase 11)",
            shapes=batch[entry["name"]])
    for entry in backward:
        entry["launches"] = counts[entry["name"]]
        if not entry["launches"]:
            fail(f"{entry['name']}: no launch in a training micro-step")
    training["cross_check"] = train_cross_check(torch, args.seed)

    # every profile's widths, float32, the RD recipe (phases 14-18)
    with torch.no_grad():
        widths = phase_widths(torch, args.seed, card, prev)
        kernels_f32 = phase_kernels(torch, args.seed, card, prev,
                                    f32=True)
    fp32 = phase_fp32_full(torch, args.seed, card, iframe, main_path,
                           variant_states["plain"])
    # the same weights as phase 8, fp32 on the card: 10 dB closer to the
    # CPU's fp32 than the card's bf16 got there, frame by frame
    floors = {"p": [p + 10 for p in xc16["p_psnr"]],
              "i": xc16["i_psnr"] + 10}
    xc32 = phase_cross_check(torch, main_path, iframe, args.seed,
                             "float32", floors)
    rd_half = phase_rdhalf(torch, args.seed, card)
    rd = phase_rd_recipe(torch, args.seed, card)
    with torch.no_grad():
        simt = phase_f32_shapes(torch, args.seed, card,
                                rd.pop("simt_counts"), prev)
        rd_bwd = phase_rd_backward(torch, args.seed, card,
                                   rd["bwd_shape_launches"],
                                   prev is not None)
    coded32 = phase_coded_f32(torch, args.seed, card)
    # phases 19-21 share the Waymo fixture; 21 codes with 19's checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        train_cli = phase_train_cli(torch, args.seed, card, root)
        image_cli = phase_image_cli(torch, args.seed, card, root, prev)
        scripts = phase_scripts(torch, args.seed, card, root,
                                train_cli.pop("last"))
        tools = phase_tools(torch, args.seed, card, main_path, root)
    parallel = phase_parallel(torch, args.seed, card)
    experiments, qconv_entry = phase_experiments(
        torch, args.seed, card, iframe, main_path, variant_states)
    rd_harness, rd_counts = phase_rd_harness(torch, args.seed, card)
    next(e for e in kernels if e["name"] == "dcb")["image_step"] = \
        image_cli.pop("dcb")
    for entry in backward:
        entry["image_step"] = image_cli["backward"].pop(entry["name"])
    image_cli.pop("backward")
    for entry in kernels:
        entry["widths"] = widths[entry["name"]]
    for entry in kernels_f32:
        p_count, i_count = fp32["launches"][entry["name"]]
        entry["launches"] = p_count
        entry["iframe"]["launches"] = i_count
        entry["per"] = ("fp32 P-frame (phase 15's GOP): per-shape time x "
                        "launches per frame, summed; 'iframe' the same per "
                        "I-frame")
        entry["widths"] = widths[entry["name"]]
        entry["training"] = dict(
            launches=rd["launches_per_micro_step"][entry["name"]],
            per="launches per RD-recipe micro-step (rd-mid fp32, phase 17)")
        entry["scripts"] = {side: scripts[f"{side}_launches"][entry["name"]]
                            for side in ("encode", "decode")}
    kernels_f32 += simt_entries(widths, rd["launches_per_micro_step"], simt)
    for entry in backward:
        entry["rd_recipe_launches"] = \
            rd["launches_per_micro_step"][entry["name"]]
        r = rd_bwd[entry["name"]]
        if r["launches"] != entry["rd_recipe_launches"]:
            fail(f"{entry['name']}: RD launches by shape {r['launches']} != "
                 f"the micro-step's {entry['rd_recipe_launches']}")
        entry["rd_recipe"] = r
    kernels += kernels_f32 + backward + [qconv_entry]
    for entry in kernels:
        if entry["name"] in rd_counts:
            entry["rd_harness"] = dict(
                launches=rd_counts[entry["name"]],
                per="launches in phase 25 (a)'s rd_tpu.main (rd-half fp32: "
                    "the DMCI pretrain, two variants, their evals)")
    # the row-sharded frames' launches, per run, rank and frame (phase 23
    # (c)), on the entries of the kernels each run's counters count
    for entry in kernels:
        kernel = entry["name"]
        if not kernel.startswith("dcb"):
            continue
        suffix = next((x for x in ("_tf32", "_f32") if kernel.endswith(x)),
                      "")
        i = int(kernel.startswith("dcb_chain"))
        rows = parallel["rows"]
        every = [(r["name"], r) for r in rows["runs"]] + [
            (f"{w['run']['name']} over {n} ranks", w["run"])
            for n, w in rows["wide"].items()]
        runs = {name: [[f["launches"][i] for f in k["frames"]]
                       for k in r["ranks"]]
                for name, r in every if r["counters"] == suffix}
        if runs:
            entry["parallel"] = dict(
                launches=runs,
                per="row-sharded P-frame, per run of phase 23 (c) and (e), "
                    "per rank (2, 4 or 8 ranks on one card), per frame")
    print(json.dumps({"main_path": {
        "ms_per_frame": main_path["ms_per_frame"],
        "ms_per_frame_runs": main_path["ms_runs"],
        "queued_ms_per_frame_runs": main_path["queued_ms_runs"],
        "turns_with_prev": main_path.get("turns"),
        "peak_bytes": main_path["peak_bytes"],
        "iframe_ms": iframe["ms_per_frame"],
        "iframe_ms_runs": iframe["ms_runs"],
        "iframe_peak_bytes": iframe["peak_bytes"],
        "gop_launches_per_frame": gop["per_frame"],
        "gop": [{k: r[k] for k in ("frame_type", "bpp", "psnr", "roi_psnr",
                                   "msssim")} for r in gop["results"]],
        "card": card}}))
    print(json.dumps({"variants": {**variants, "mask_sign_agreement": signs,
                                   "card": card}}))
    print(json.dumps({"coded": {**coded, "card": card}}))
    print(json.dumps({"training": {**training, "card": card}}))
    print(json.dumps({"cross_check": {"bf16": xc16, "fp32": xc32,
                                      "card": card}}))
    print(json.dumps({"fp32": {**fp32, "card": card}}))
    print(json.dumps({"rd_half": {**rd_half, "card": card}}))
    print(json.dumps({"rd_recipe": {**rd, "card": card}}))
    print(json.dumps({"coded_fp32": {**coded32, "card": card}}))
    print(json.dumps({"train_cli": {**train_cli, "card": card}}))
    print(json.dumps({"image_cli": {**image_cli, "card": card}}))
    print(json.dumps({"scripts": {**scripts, "card": card}}))
    print(json.dumps({"tools": {**tools, "card": card}}))
    print(json.dumps({"parallel": {**parallel, "card": card}}))
    print(json.dumps({"experiments": {**experiments, "card": card}}))
    print(json.dumps({"rd_harness": {**rd_harness, "card": card}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
