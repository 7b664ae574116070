"""Rank functions for tests/test_torch_parallel.py, run in processes that
``torch.multiprocessing.spawn`` starts (gloo on the CPU, a file rendezvous).

A spawned process imports the module that holds its function, so this one
imports nothing of JAX: the test's own process computes every reference
and passes numpy arrays in; each rank writes what it saw to
``<out>/rank<r>.pt`` for the test to read after the join.
"""

import os

import numpy as np
import torch
import torch.distributed as dist


def _join(rank: int, world: int, rdzv: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                            world_size=world)


def _save(out: str, rank: int, obj) -> None:
    torch.save(obj, os.path.join(out, f"rank{rank}.pt"))


def _dmc(variant: str, widths: dict, params):
    from ssgvc_tpu_torch.config import DMCConfig
    from ssgvc_tpu_torch.models.dmc import DMC
    from ssgvc_tpu_torch.utils.weights import load_flax_params

    model = DMC(DMCConfig.variant(variant, **widths), device="cpu")
    return load_flax_params(model, params).eval()


def pframe_rows(rank: int, world: int, rdzv: str, out: str, case: dict):
    """GOPs of P-frames row-sharded over the spatial axis (1-D mesh, or a
    data x spatial mesh with ``case["spatial"]`` < world): per frame the
    gathered DPB and per-sample bpp, and this rank's slab rows. ``case``
    is one run, or holds a list of them under "runs" (each with its own
    variant, weights, inputs and ``SSGVC_INT8`` mode and scales)."""
    from ssgvc_tpu_torch.parallel.mesh import make_mesh

    _join(rank, world, rdzv)
    try:
        if case["spatial"] == world:
            mesh = make_mesh(world, device="cpu")
            axes = ("data", None)
        else:
            mesh = make_mesh(axis_names=("data", "spatial"),
                             spatial=case["spatial"], device="cpu")
            axes = ("spatial", "data")
        if "runs" in case:
            seen = {"runs": [_rows_run(mesh, axes, run)
                             for run in case["runs"]]}
        else:
            seen = _rows_run(mesh, axes, case)
        _save(out, rank, seen)
    finally:
        dist.destroy_process_group()


def _rows_run(mesh, axes, run: dict) -> dict:
    from ssgvc_tpu_torch.layers import blocks
    from ssgvc_tpu_torch.parallel import spatial
    from ssgvc_tpu_torch.parallel.mesh import all_gather_cat

    axis, batch_axis = axes
    mode = run.get("int8", "0")
    os.environ["SSGVC_INT8"] = mode
    blocks.set_int8_scales(run.get("scales", {}))
    try:
        model = _dmc(run["variant"], run["widths"], run["params"])
        fn = spatial.spatial_pframe(model, mesh, axis, batch_axis)
        t = lambda a: torch.from_numpy(np.asarray(a))
        dpb = spatial.shard_rows(mesh, {k: t(v)
                                        for k, v in run["dpb"].items()},
                                 axis, batch_axis)
        sh = spatial.row_sharding(mesh, axis, batch_axis)
        h = run["dpb"]["frame"].shape[1]
        seen = {"rows": sh.rows(h),
                "unit_rows": sh.rows(h, spatial.SLAB_ROWS),
                "feature_rows": sh.rows(run["dpb"]["feature"].shape[1]),
                "batch": sh.batch(run["dpb"]["frame"].shape[0]),
                "slab_shapes": {k: tuple(v.shape) for k, v in dpb.items()},
                "frames": []}
        for x, m in zip(run["frames"], run["masks"]):
            xs, ms = spatial.shard_rows(mesh, (t(x), t(m)), axis,
                                        batch_axis)
            spatial.move_bytes = 0
            dpb, bpp = fn(None, xs, ms, run["qp"], dpb)
            full = spatial.gather_rows(mesh, dpb, axis, batch_axis)
            seen["frames"].append({
                "frame": full["frame"].numpy(),
                "feature": full["feature"].numpy(),
                "bpp": all_gather_cat(bpp, sh.batch_group).numpy(),
                "slab_shapes": {k: tuple(v.shape) for k, v in dpb.items()},
                "move_bytes": spatial.move_bytes})
        return seen
    finally:
        os.environ.pop("SSGVC_INT8", None)
        blocks.set_int8_scales({})


def _tiny_trainer(world: int, **kw):
    from ssgvc_tpu_torch.config import TrainConfig
    from ssgvc_tpu_torch.parallel.mesh import make_mesh
    from ssgvc_tpu_torch.training.trainer import Trainer

    cfg = TrainConfig(num_devices=world, **kw)
    cfg.model_profile, cfg.precision = "tiny", "32"
    return Trainer(cfg, total_iters=100, device="cpu",
                   mesh=make_mesh(world, device="cpu"))


def _shard(batch: dict, rank: int, world: int) -> dict:
    per = batch["frames"].shape[0] // world
    return {k: torch.from_numpy(v[rank * per:(rank + 1) * per])
            for k, v in batch.items()}


def _params(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def dp_gradient(rank: int, world: int, rdzv: str, out: str, case: dict):
    """The data-parallel step of the tiny fp32 trainer, each rank its
    shard of ``case["batch"]``: the optimizer's reduced gradient of
    gop_loss (train=False, no clip), the loss's mean, the parameters after
    that update and after one train_step (the noise seeded per rank); then
    the image CLI's step (:func:`_image_step`) in the same group."""
    from ssgvc_tpu_torch.parallel.mesh import mean_metrics
    from ssgvc_tpu_torch.utils.weights import load_flax_params

    _join(rank, world, rdzv)
    try:
        tr = _tiny_trainer(world, accumulation_steps=1, grad_clip=1e30)
        load_flax_params(tr.dmc, case["params_p"])
        load_flax_params(tr.dmci, case["params_i"])
        batch = _shard(case["batch"], rank, world)
        state = tr.init_state(torch.Generator().manual_seed(0), batch,
                              params_p=tr.dmc.state_dict(),
                              params_i=tr.dmci.state_dict())
        tr.tx.zero_grad()
        loss, _ = tr.gop_loss(batch["frames"], batch["masks"], case["qp"],
                              torch.Generator().manual_seed(1), train=False,
                              eval_mode=False)
        tr.backward(loss)
        tr.tx.step()
        grads = {k: p.grad.detach().clone()
                 for k, p in tr.dmc.named_parameters()}
        mean = float(mean_metrics({"loss": loss.detach()}, tr.group)["loss"])
        after_step = _params(tr.dmc)
        state, aux = tr.train_step(state, batch, case["qp"],
                                   torch.Generator().manual_seed(10 + rank))
        _save(out, rank, {"grads": grads, "local_loss": float(loss.detach()),
                          "loss": mean, "after_step": after_step,
                          "train_loss": float(aux["loss"]),
                          "after_train_step": _params(tr.dmc),
                          "image": _image_step(rank, world, case["image"]),
                          "int8": _int8_step(rank, world, case)})
    finally:
        dist.destroy_process_group()


def _int8_step(rank: int, world: int, case: dict) -> dict:
    """The data-parallel step of :func:`dp_gradient` under SSGVC_INT8=1
    (mode 1's abs-max the global batch's): the reduced gradient of
    gop_loss (train=False) and the loss's mean, then one train_step (the
    noise seeded per rank): its loss and the parameters after it."""
    from ssgvc_tpu_torch.parallel.mesh import mean_metrics
    from ssgvc_tpu_torch.utils.weights import load_flax_params

    os.environ["SSGVC_INT8"] = "1"
    try:
        tr = _tiny_trainer(world, accumulation_steps=1, grad_clip=1e30)
        load_flax_params(tr.dmc, case["params_p"])
        load_flax_params(tr.dmci, case["params_i"])
        batch = _shard(case["batch"], rank, world)
        state = tr.init_state(torch.Generator().manual_seed(0), batch,
                              params_p=tr.dmc.state_dict(),
                              params_i=tr.dmci.state_dict())
        tr.tx.zero_grad()
        loss, _ = tr.gop_loss(batch["frames"], batch["masks"], case["qp"],
                              torch.Generator().manual_seed(1), train=False,
                              eval_mode=False)
        tr.backward(loss)
        tr.tx.step()
        grads = {k: p.grad.detach().clone()
                 for k, p in tr.dmc.named_parameters()}
        mean = float(mean_metrics({"loss": loss.detach()}, tr.group)["loss"])
        state, aux = tr.train_step(state, batch, case["qp"],
                                   torch.Generator().manual_seed(10 + rank))
        return {"grads": grads, "loss": mean,
                "local_loss": float(loss.detach()),
                "train_loss": float(aux["loss"]),
                "after_train_step": _params(tr.dmc)}
    finally:
        os.environ.pop("SSGVC_INT8", None)


def _image_step(rank: int, world: int, case: dict) -> dict:
    """One step of the image CLI's data-parallel path on the rank's shard
    of ``case["x"]``, as its ``main`` sets it up: the tiny DMCI drawn from
    a seed that differs by rank, then ``replicate`` (rank 0's weights on
    every rank), ``make_tx`` over the data group and ``train_step`` with the
    quantiser noise seeded per rank. Returns the weights after replicate,
    the reduced gradient, the averaged aux and the weights after the
    step."""
    from ssgvc_tpu_torch import config as tcfg
    from ssgvc_tpu_torch import trainer_image_model as cli
    from ssgvc_tpu_torch.models.dmci import DMCI
    from ssgvc_tpu_torch.parallel.mesh import make_mesh, replicate
    from ssgvc_tpu_torch.training.trainer import NOISE_SEED_STRIDE

    mesh = make_mesh(world, device="cpu")
    model = DMCI(tcfg.DMCIConfig(**case["widths"]), device="cpu")
    model.init_(torch.Generator().manual_seed(case["seed"] + rank))
    own = _params(model)
    replicate(mesh, model)
    init = _params(model)
    tx = cli.make_tx(model, tcfg.TrainConfig(), 100,
                     group=mesh.group("data"))
    x = torch.from_numpy(case["x"])
    per = x.shape[0] // world
    noise = torch.Generator().manual_seed(case["seed"]
                                          + NOISE_SEED_STRIDE * rank)
    aux = cli.train_step(model, tx, x[rank * per:(rank + 1) * per],
                         case["qp"], tcfg.CompressionConfig(), noise)
    return {"own_init": own, "init": init,
            "grads": {k: p.grad.detach().clone()
                      for k, p in model.named_parameters()},
            "aux": {k: float(v) for k, v in aux.items()},
            "after_step": _params(model)}


def calibration_and_alm(rank: int, world: int, rdzv: str, out: str,
                        case: dict):
    """Gain calibration of a fresh init on the rank's shard of
    ``case["batch"]`` (the gains), then two micro-steps of constraint_opt
    at accumulation 2 from ``case``'s weights (the ALM state after each)."""
    from ssgvc_tpu_torch.utils.weights import load_flax_params

    _join(rank, world, rdzv)
    try:
        batch = _shard(case["batch"], rank, world)
        tr = _tiny_trainer(world)
        tr.init_state(torch.Generator().manual_seed(0), batch)
        gains = {"q_encoder": tr.dmc.q_encoder.detach().clone(),
                 "z_gain": tr.dmc.z_gain.detach().clone(),
                 "dmci_z_gain": tr.dmci.z_gain.detach().clone()}
        tr = _tiny_trainer(world, constraint_opt=True, accumulation_steps=2)
        load_flax_params(tr.dmc, case["params_p"])
        load_flax_params(tr.dmci, case["params_i"])
        state = tr.init_state(torch.Generator().manual_seed(0), batch,
                              params_p=tr.dmc.state_dict(),
                              params_i=tr.dmci.state_dict())
        alm = []
        gen = torch.Generator().manual_seed(3 + rank)
        for _ in range(2):
            state, aux = tr.train_step(state, batch, case["qp"], gen)
            alm.append((float(state.alm_mu), float(state.alm_h_accum),
                        float(state.alm_h_count), float(aux["g_mean"])))
        _save(out, rank, {"gains": gains, "alm": alm})
    finally:
        dist.destroy_process_group()
