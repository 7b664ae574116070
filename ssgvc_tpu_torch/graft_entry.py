"""The flagship model's P-frame forward as one pure function, and a dry
run of the data-parallel and row-sharded paths over n ranks:

    from ssgvc_tpu_torch.graft_entry import dryrun_multichip, entry
    fn, args = entry()          # on the card; entry(device="cpu") for the CPU
    out = fn(*args)             # {'dpb': {'frame', 'feature'}, 'bpp', ...}
    dryrun_multichip(2)         # 2 cards over NCCL; device="cpu": gloo

``entry`` mirrors the JAX package's ``__graft_entry__.entry``: the DMC
performance variant in bf16, raw io, one 256x256 frame, a zero frame, mask
and DPB, QP 32, the P-frame after an I-frame (``after_i=True``), estimated
rates (``train=False``). Its 31 DepthConvBlocks run as 19 single-block and
5 chained kernel launches on the card.

``dryrun_multichip`` mirrors the JAX module's: one train step over an
n-rank data mesh, then the P-frame row-sharded over the same ranks
(``parallel/``), on tiny shapes, in n processes it spawns.
"""

from __future__ import annotations

import os
import tempfile

import torch

from .config import DMCConfig
from .models.dmc import DMC

#: the example's batch, frame size and QP
B, H, W = 1, 256, 256
QP = 32


def entry(device=None):
    """(fn, example_args) of one P-frame forward of the flagship model.
    ``fn(params, frame, mask, qp, dpb)`` runs ``DMC.forward`` with
    ``params`` (a state_dict) through ``torch.func.functional_call``, so it
    is pure in them. The example params are the port's own init
    (``DMC.init_`` from a ``torch.Generator`` seeded 0). ``device``
    defaults to "cuda"; without a CUDA device that raises, as the models
    do."""
    device = torch.device("cuda" if device is None else device)
    cfg = DMCConfig.variant("performance", dtype="bfloat16")
    model = DMC(cfg, device=device)
    model.init_(torch.Generator().manual_seed(0))
    model.eval()

    zeros = lambda *shape: torch.zeros(shape, device=device)
    frame = zeros(B, H, W, 3)
    mask = zeros(B, H, W, 1)
    p = cfg.patch_size
    dpb = {"frame": zeros(B, H, W, 3),
           "feature": zeros(B, H // p, W // p, cfg.ch_d)}
    params = dict(model.state_dict())

    def fn(params, frame, mask, qp, dpb):
        return torch.func.functional_call(
            model, params, (frame, qp, dpb),
            dict(after_i=True, mask=mask, train=False))

    return fn, (params, frame, mask, QP, dpb)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One full train step over an ``n_devices``-rank data mesh, then the
    row-sharded P-frame over the same ranks, on tiny shapes; prints
    ``dryrun_multichip ok: n devices, loss=..., spatial_bpp=...`` (rank
    0), as the JAX package's ``dryrun_multichip``.

    It spawns one process a rank (``torch.multiprocessing.spawn``, a file
    rendezvous in a temporary directory). ``device`` defaults to "cuda":
    NCCL, rank r on ``cuda:r``, which needs n cards. ``device="cpu"`` runs
    gloo on n CPU processes, as the JAX function runs on n virtual CPU
    devices. A failing rank raises here."""
    import torch.multiprocessing as mp

    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(
            f"dryrun_multichip: {n_devices} ranks over NCCL need "
            f"{n_devices} CUDA devices, {torch.cuda.device_count()} visible; "
            f"pass device=\"cpu\" for {n_devices} gloo processes on the CPU")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_dryrun_rank, args=(n_devices, kind,
                                     os.path.join(tmp, "rdzv")),
                 nprocs=n_devices, join=True)


def _dryrun_rank(rank: int, n_devices: int, kind: str, rdzv: str) -> None:
    """One rank of :func:`dryrun_multichip` (the JAX module's
    ``_dryrun_multichip_inproc``)."""
    import torch.distributed as dist

    from .config import DMCIConfig, TrainConfig
    from .parallel.mesh import make_mesh, shard_batch
    from .parallel.spatial import shard_rows, spatial_pframe
    from .training.trainer import Trainer

    if kind == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                            init_method=f"file://{rdzv}", rank=rank,
                            world_size=n_devices)
    try:
        cfg = TrainConfig()
        cfg.precision = "fp32"
        cfg.num_devices = n_devices
        mesh = make_mesh(n_devices, device=dev)
        trainer = Trainer(
            cfg, total_iters=10,
            dmc_cfg=DMCConfig.variant("performance", ch_d=16, ch_y=8,
                                      ch_z=8, ch_recon=16),
            dmci_cfg=DMCIConfig(enc_dec=32, N=16, z_channel=8),
            device=dev, mesh=mesh)
        # the global batch of zeros (no calibration), each rank its shard
        b = max(n_devices, 2)
        per = b // n_devices
        local = slice(rank * per, (rank + 1) * per)
        batch = shard_batch(mesh, {
            "frames": torch.zeros((b, 3, 64, 64, 3))[local],
            "masks": torch.zeros((b, 3, 64, 64, 1))[local]})
        state = trainer.init_state(torch.Generator().manual_seed(0), batch)
        state, aux = trainer.train_step(state, batch, 20,
                                        torch.Generator().manual_seed(1))
        loss = float(aux["loss"])
        if not torch.isfinite(torch.tensor(loss)):
            raise RuntimeError("non-finite loss in dryrun")

        # inference-side sharding: one stream's P-frame with H split over
        # the same ranks (halo exchanges, the bits' all-reduce)
        h = 8 * 8 * n_devices
        zeros = lambda *shape: torch.zeros(shape)
        dpb = {"frame": zeros(1, h, 64, 3),
               "feature": zeros(1, h // 8, 8, trainer.dmc_cfg.ch_d)}
        sp = spatial_pframe(trainer.dmc, mesh)
        frame, mask = shard_rows(mesh, (zeros(1, h, 64, 3),
                                        zeros(1, h, 64, 1)))
        _, bpp = sp(dict(trainer.dmc.state_dict()), frame, mask, 20,
                    shard_rows(mesh, dpb))
        if not bool(torch.isfinite(bpp).all()):
            raise RuntimeError("non-finite bpp in spatial dryrun")
        if rank == 0:
            print(f"dryrun_multichip ok: {n_devices} devices, "
                  f"loss={loss:.4f}, spatial_bpp={float(bpp.sum()):.4f}",
                  flush=True)
    finally:
        dist.destroy_process_group()
