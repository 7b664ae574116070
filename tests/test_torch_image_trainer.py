"""The port's I-frame trainer CLI (``python3 -m
ssgvc_tpu_torch.trainer_image_model``) on the CPU at the tiny DMCI widths,
against the JAX package's ``trainer_image_model.py``: the image loss and
its gradient against the JAX formula on the same weights, three optimizer
steps against the JAX CLI's optax chain, the host draws' order, and the
CLI's files (the YAML, the CSV, ``checkpoints/last`` with ``params_i``,
which the port's ``load_pretrained`` imports).

Tolerances: the loss at rtol 5e-3 and each gradient tensor within
GRAD_TENSOR_TOL of its norm, the whole gradient within 1e-3 (the rate's
derivative carries rounding noise: ``test_torch_training.py``); optimizer
steps at 1e-6.
"""

import csv
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.traverse_util import flatten_dict, unflatten_dict

import trainer_image_model as jax_cli
from chip_smoke import DMCI_HEADS
from ssgvc_tpu.config import DMCIConfig as JaxDMCIConfig
from ssgvc_tpu.models.dmci import DMCI as JaxDMCI
from ssgvc_tpu.training.loss import compute_lambda as jax_lambda
from ssgvc_tpu.training.loss import psnr_from_mse as jax_psnr
from ssgvc_tpu.training.schedule import warmup_cosine as jax_sched
from ssgvc_tpu.utils import logging as jlog
from ssgvc_tpu_torch import config as tcfg
from ssgvc_tpu_torch import trainer_image_model as cli
from ssgvc_tpu_torch.data.dataset import make_datamodule
from ssgvc_tpu_torch.models.dmci import DMCI
from ssgvc_tpu_torch.training.trainer import Trainer
from ssgvc_tpu_torch.utils.checkpoint import (load_pretrained,
                                              restore_checkpoint)
from ssgvc_tpu_torch.utils.weights import flatten, flax_from_state_dict
from test_torch_training import GRAD_TENSOR_TOL
from torch_port_helpers import DMCI_TINY, drawn_params

TINY_DMCI = functools.partial(tcfg.DMCIConfig, **DMCI_TINY)
# 4 synthetic clips of T=4, 4 for training at B=2: 2 steps an epoch
ARGV = ["--device=cpu", "dataset.synthetic=true",
        "dataset.synthetic_num_clips=4", "dataset.batch_size=2",
        "dataset.crop_size=64", "dataset.train_val_test_split=[1.0, 0.0, 0.0]",
        "epochs=2", "log_interval=1", "seed=5"]
STEPS = 4
LOGGED = ("loss", "bpp", "bpp_y", "bpp_z", "mse", "psnr")


def _comp():
    return tcfg.CompressionConfig()


@functools.lru_cache(maxsize=1)
def _loss_case():
    """The port's tiny fp32 DMCI with drawn weights, a batch and the JAX
    formula's loss, aux and gradient on the same weights (train=False)."""
    model = DMCI(TINY_DMCI(), device="cpu")
    params = jax.tree_util.tree_map(jnp.asarray,
                                    drawn_params(model, 7, DMCI_HEADS))
    x = np.random.default_rng(8).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    comp, qp, jmodel = _comp(), 21, JaxDMCI(JaxDMCIConfig(**DMCI_TINY))

    def loss_fn(p):     # trainer_image_model.py's loss, at train=False
        out = jmodel.apply({"params": p}, jnp.asarray(x), qp, train=False)
        mse = jnp.mean((out["dpb"]["frame"].astype(jnp.float32)
                        - jnp.asarray(x)) ** 2)
        lam = jax_lambda(qp, comp.lambda_min, comp.lambda_max, comp.q_levels)
        loss = jnp.mean(out["bpp_y"]) + jnp.mean(out["bpp_z"]) + lam * mse
        return loss, {"loss": loss, "bpp": jnp.mean(out["bpp"]),
                      "bpp_y": jnp.mean(out["bpp_y"]),
                      "bpp_z": jnp.mean(out["bpp_z"]), "mse": mse,
                      "psnr": jax_psnr(mse)}

    (_, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    return model, x, qp, {k: float(v) for k, v in aux.items()}, \
        {k: np.asarray(v) for k, v in flatten(grads).items()}


def test_image_loss_and_gradient_match_jax():
    model, x, qp, jaux, jgrads = _loss_case()
    model.zero_grad(set_to_none=True)
    loss, aux = cli.image_loss(model, torch.from_numpy(x), qp, _comp(),
                               train=False)
    loss.backward()
    assert set(aux) == set(LOGGED) == set(jaux)
    for k in LOGGED:
        np.testing.assert_allclose(float(aux[k]), jaux[k], rtol=5e-3,
                                   err_msg=k)
    grads = {k: np.asarray(v) for k, v in flatten(flax_from_state_dict(
        {n: p.grad for n, p in model.named_parameters()})).items()}
    assert grads.keys() == jgrads.keys()
    zero, err2, norm2 = set(), 0.0, 0.0
    for k, j in jgrads.items():
        scale = np.linalg.norm(j)
        err = np.linalg.norm(grads[k] - j)
        assert err <= GRAD_TENSOR_TOL * scale or (scale == 0 and err == 0), \
            (k, err, scale)
        if scale == 0:
            zero.add(k[0])
        err2, norm2 = err2 + err ** 2, norm2 + scale ** 2
    assert np.sqrt(err2 / norm2) <= 1e-3
    # at train=False the spatial prior's means cancel through the
    # straight-through round, and its scales (the head drawn at 0.01) sit
    # near zero where the rate is flat: in both packages its modules, and
    # only they, get no gradient
    assert zero == {"y_spatial_prior_reduction", "y_spatial_prior_0",
                    "y_spatial_prior_1", "y_spatial_prior_2",
                    "y_spatial_prior_3", "y_spatial_prior_adaptor_1",
                    "y_spatial_prior_adaptor_2", "y_spatial_prior_adaptor_3"}


def test_optimizer_matches_the_jax_clis_optax_chain():
    """Three steps of make_tx on the DMCI's parameters against
    trainer_image_model.py's chain: the clip, then adamw on the schedule
    for "main" and at aux_lr for "aux" (by "bit_estimator" in the path)."""
    cfg = tcfg.TrainConfig(grad_clip=0.5)
    cfg.optimizer = dataclasses.replace(cfg.optimizer, base_lr=1e-2,
                                        min_lr=1e-3, aux_lr=5e-2,
                                        weight_decay=0.1)
    model = DMCI(TINY_DMCI(), device="cpu")
    model.init_(torch.Generator().manual_seed(0))
    tx = cli.make_tx(model, cfg, total_iters=10)
    opt = cfg.optimizer
    sched = jax_sched(opt.base_lr, opt.min_lr, opt.warmup_iters, 10)

    def labels_fn(params):
        flat = flatten_dict(params)
        return unflatten_dict({k: "aux" if "bit_estimator" in "/".join(
            map(str, k)) else "main" for k in flat})

    jtx = optax.chain(
        optax.clip_by_global_norm(cfg.grad_clip),
        optax.multi_transform(
            {"main": optax.adamw(sched, weight_decay=opt.weight_decay),
             "aux": optax.adamw(opt.aux_lr, weight_decay=opt.weight_decay)},
            labels_fn))
    to_jax = lambda sd: jax.tree_util.tree_map(
        jnp.asarray, flax_from_state_dict(sd))
    jparams = to_jax({k: v.detach().clone() for k, v in
                      model.state_dict().items()})
    jstate = jtx.init(jparams)
    assert {tx.labels[i] for i, n in enumerate(tx.names)
            if "bit_estimator" in n} == {"aux"}
    rng = np.random.default_rng(1)
    for _ in range(3):
        grads = {n: torch.from_numpy(rng.standard_normal(p.shape).astype(
            np.float32)) for n, p in model.named_parameters()}
        tx.zero_grad()
        for n, p in model.named_parameters():
            p.grad = grads[n].clone()
        tx.step()
        upd, jstate = jtx.update(to_jax(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
    got = flatten(flax_from_state_dict(model.state_dict()))
    want = flatten(jparams)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=str(k))


def test_host_draws_take_t_idx_before_qp():
    """trainer_image_model.py's loop draws t_idx, then qp, from one
    default_rng(seed) every step."""
    ours, ref = np.random.default_rng(42), np.random.default_rng(42)
    for _ in range(20):
        t_idx = int(ref.integers(0, 4))
        qp = int(ref.integers(0, 64))
        assert cli.host_draws(ours, 4, 64) == (t_idx, qp)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The CLI at the tiny DMCI widths in a fresh working directory, every
    train_step's (x, qp) recorded: (result, working directory, calls)."""
    cwd = tmp_path_factory.mktemp("image_cli")
    calls = []
    step = cli.train_step

    def recording(model, tx, x, qp, comp, generator):
        calls.append((x.clone(), qp))
        return step(model, tx, x, qp, comp, generator)

    old = os.getcwd()
    os.chdir(cwd)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tcfg, "DMCIConfig", TINY_DMCI)
            mp.setattr(cli, "train_step", recording)
            out = cli.main(ARGV)
    finally:
        os.chdir(old)
    return out, cwd, calls


def test_cli_writes_what_the_jax_cli_writes(run, tmp_path):
    out, cwd, _ = run
    assert ((cwd / cli.CONFIG_PATH).read_text() == cli.DEFAULT_YAML
            == jax_cli.DEFAULT_YAML)
    log_dir = cwd / out["log_dir"]
    files = sorted(str(p.relative_to(log_dir)) for p in log_dir.rglob("*")
                   if p.is_file())
    assert files == ["checkpoints/last", "config.json", "train_metrics.csv"]
    assert out["steps"] == STEPS
    with open(log_dir / "train_metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == STEPS
    assert [int(r["step"]) for r in rows] == list(range(STEPS))
    assert all(np.isfinite(float(r[k])) for r in rows for k in LOGGED)
    # the JAX logger writes the same rows byte for byte
    jlogger = jlog.CSVLogger(str(tmp_path))
    for r in rows:
        jlogger.log_train(int(r["step"]), {k: float(r[k]) for k in LOGGED})
    assert ((tmp_path / "train_metrics.csv").read_text()
            == (log_dir / "train_metrics.csv").read_text())


def test_cli_trains_on_the_drawn_frame_and_qp(run):
    """Step k trains on frame t_idx of the k-th batch of a fresh train_iter
    at the drawn QP, t_idx and qp from host_draws on default_rng(seed)."""
    out, _, calls = run
    cfg = tcfg.load_config(None, ARGV[1:])
    it = make_datamodule(cfg).train_iter()
    host = np.random.default_rng(cfg.seed)
    assert len(calls) == STEPS
    for x, qp in calls:
        batch = next(it)
        t_idx, want_qp = cli.host_draws(host, batch["frames"].shape[1], 64)
        assert qp == want_qp
        assert torch.equal(x, torch.from_numpy(batch["frames"][:, t_idx]))
    assert out["tx"].count == STEPS


def test_checkpoint_holds_params_i_and_imports_into_the_video_trainer(run):
    out, cwd, _ = run
    ckpt = restore_checkpoint(out["checkpoint"])
    assert list(ckpt) == ["params_i"]
    live = out["model"].state_dict()
    assert ckpt["params_i"].keys() == live.keys()
    for k, v in live.items():
        assert torch.equal(ckpt["params_i"][k], v), k
    cfg = tcfg.TrainConfig(image_checkpoint_path=out["checkpoint"],
                           precision="32")
    cfg.model_profile = "tiny"
    tr = Trainer(cfg, total_iters=2, device="cpu")
    load_pretrained(tr, cfg)
    for k, v in tr.dmci.state_dict().items():
        assert torch.equal(v, live[k]), k


def test_cli_takes_one_device_and_defaults_to_the_card(tmp_path,
                                                       monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcfg, "DMCIConfig", TINY_DMCI)
    # without a process group: make_mesh's refusal (two ranks take
    # torchrun)
    with pytest.raises(ValueError, match="requested but only"):
        cli.main(ARGV + ["num_devices=2"])
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(ARGV[1:])
