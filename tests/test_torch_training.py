"""The port's training path on the CPU against the JAX package's: the
training configs, losses, schedule and ALM terms, the optimizer chain
(clip, three label groups, accumulation) against optax, the flax inits, the
gain calibration, the synthetic clip source, the trainer's GOP loss and its
gradient, remat, fit, and the inference paths' no-grad.

Tolerances: losses, schedule, ALM terms and optimizer steps at 1e-6 (the
same fp32 formulas); calibrated gains at rtol 1e-4; the GOP loss at rtol
5e-3, as bpp is held elsewhere (ROADMAP §3: the rate estimate is
ill-conditioned at the ulp level); the whole gradient within 1e-3 of its
norm and each tensor within GRAD_TENSOR_TOL of its own; lecun draws' std
within 5% on tensors of at least 4096 elements.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from chip_smoke import DMC_HEADS, DMCI_HEADS
from ssgvc_tpu import config as jcfg
from ssgvc_tpu.data.dataset import SyntheticClipDataset
from ssgvc_tpu.training import loss as jloss
from ssgvc_tpu.training import optimizers as jopt
from ssgvc_tpu.training import schedule as jsched
from ssgvc_tpu.training.trainer import Trainer as JaxTrainer
from ssgvc_tpu.training.trainer import param_label as jax_param_label
from ssgvc_tpu_torch import config as tcfg
from ssgvc_tpu_torch.data.device_synth import sample_qp, synth_batch
from ssgvc_tpu_torch.models.dmc import DMC
from ssgvc_tpu_torch.models.dmci import DMCI
from ssgvc_tpu_torch.training import loss as tloss
from ssgvc_tpu_torch.training import optimizers as topt
from ssgvc_tpu_torch.training import schedule as tsched
from ssgvc_tpu_torch.training.trainer import (Trainer, mask_train_label,
                                              param_label)
from ssgvc_tpu_torch.utils.weights import flatten, flax_from_state_dict
from torch_port_helpers import DMCI_TINY, TINY, drawn_params
from torch_port_helpers import one_torch_thread  # noqa: F401

TIGHT = dict(rtol=1e-6, atol=1e-6)
# Per gradient tensor. The rate's derivative in sigma is a difference of
# two nearly equal terms for many symbols, so the prior branch's gradients
# carry rounding noise well above fp32's: the JAX package's own gop_loss
# gradient, jitted against op by op on the same weights, differs by up to
# 2.2e-3 of a tensor's norm there (y_prior_fusion.conv_0.dc_0.bias); the
# port differs from the jitted one by at most 3.2e-3, the whole gradient by
# 1.4e-4 (experiments/gop_grad_gap.py).
GRAD_TENSOR_TOL = 5e-3


def _np(t):
    return np.asarray(t.detach().numpy() if torch.is_tensor(t) else t,
                      np.float64)


# ------------------------------------------------------------- configs --

def test_train_config_defaults_match_jax():
    for t, j in ((tcfg.TrainConfig(), jcfg.TrainConfig()),
                 (tcfg.OptimizerConfig(), jcfg.OptimizerConfig()),
                 (tcfg.CompressionConfig(), jcfg.CompressionConfig()),
                 (tcfg.DatasetConfig(), jcfg.DatasetConfig())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_load_config_matches_jax(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text("epochs: 3\nnum_gpus: 1\nunknown_key: 7\n"
                    "dataset:\n  batch_size: 2\n  crop_size: 64\n"
                    "optimizer:\n  base_lr: 0.0003\n")
    ov = ["optimizer.optimizer_type=lion", "dataset.seq_len=3",
          "compression.index_map=[0,1,2]", "mask_train=true"]
    t, j = tcfg.load_config(str(path), ov), jcfg.load_config(str(path), ov)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.optimizer.optimizer_type == "lion" and t.dataset.seq_len == 3


@pytest.mark.parametrize("bad", ["max_iters=5", "dataset.nope=1",
                                 "nosection.key=1"])
def test_load_config_refuses_unknown_override_keys(bad):
    with pytest.raises(KeyError):
        jcfg.load_config(None, [bad])
    with pytest.raises(KeyError):
        tcfg.load_config(None, [bad])


# ------------------------------------------------ losses and schedule --

@pytest.mark.parametrize("qp", [0, 17, 40, 63])
def test_compute_lambda_matches_jax(qp):
    np.testing.assert_allclose(_np(tloss.compute_lambda(qp, 50.0, 38400.0)),
                               np.asarray(jloss.compute_lambda(qp, 50.0,
                                                               38400.0)),
                               rtol=1e-6)


def _rd_inputs(seed, empty_mask=False):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (2, 8, 8, 1)) > 0.6).astype(np.float32)
    if empty_mask:
        mask[:] = 0
    bpp = rng.uniform(0.1, 1, (3, 2)).astype(np.float32)
    return pred, target, mask, bpp


@pytest.mark.parametrize("with_mask,empty,normalize", [
    (False, False, False), (True, False, False), (True, True, False),
    (True, False, True)])
def test_rate_distortion_loss_matches_jax(with_mask, empty, normalize):
    pred, target, mask, bpp = _rd_inputs(3, empty)

    def run(lib, cast):
        res = {"bpp": cast(bpp[0] + bpp[1]), "bpp_y": cast(bpp[0]),
               "bpp_z": cast(bpp[1]), "dpb": {"frame": cast(pred)}}
        return lib.rate_distortion_loss(
            res, cast(target), 23, 0.9, 50.0, 38400.0, 64,
            mask=cast(mask) if with_mask else None, roi_weight=100.0,
            lambda_normalize=normalize)

    t = run(tloss, torch.from_numpy)
    j = run(jloss, jnp.asarray)
    for a, b in zip(t, j):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TIGHT)


@pytest.mark.parametrize("kind", ["mask", "empty", "none"])
def test_roi_and_weighted_mse_match_jax(kind):
    pred, target, mask, _ = _rd_inputs(4, kind == "empty")
    m = None if kind == "none" else mask
    t = tloss.roi_mse(torch.from_numpy(pred), torch.from_numpy(target),
                      None if m is None else torch.from_numpy(m))
    j = jloss.roi_mse(jnp.asarray(pred), jnp.asarray(target),
                      None if m is None else jnp.asarray(m))
    np.testing.assert_allclose(_np(t), np.asarray(j), **TIGHT)
    w = 1.0 + 100.0 * mask
    np.testing.assert_allclose(
        _np(tloss.weighted_mse(torch.from_numpy(pred),
                               torch.from_numpy(target), torch.from_numpy(w))),
        np.asarray(jloss.weighted_mse(jnp.asarray(pred), jnp.asarray(target),
                                      jnp.asarray(w))), **TIGHT)


def test_psnr_mse_helpers_match_jax():
    for v in (20.0, 35.0, 48.5):
        np.testing.assert_allclose(_np(tloss.mse_from_psnr_db(v)),
                                   np.asarray(jloss.mse_from_psnr_db(v)),
                                   rtol=1e-6)
    for m in (1e-4, 3e-3, 0.2):
        np.testing.assert_allclose(_np(tloss.psnr_from_mse(m)),
                                   np.asarray(jloss.psnr_from_mse(m)),
                                   rtol=1e-6)


@pytest.mark.parametrize("g", [-0.3, -0.0004, 0.02, 1.7])
def test_alm_terms_match_jax(g):
    ga = np.array([g, 0.5 * g], np.float32)
    mu = np.float32(0.7)
    np.testing.assert_allclose(
        _np(tloss.alm_deadzone_penalty(torch.from_numpy(ga), 5.0)),
        np.asarray(jloss.alm_deadzone_penalty(jnp.asarray(ga), 5.0)), **TIGHT)
    np.testing.assert_allclose(
        _np(tloss.alm_ineq_term(torch.from_numpy(ga), torch.tensor(mu), 5.0)),
        np.asarray(jloss.alm_ineq_term(jnp.asarray(ga), jnp.asarray(mu),
                                       5.0)), **TIGHT)
    for count in (0.0, 3.0):
        args = (np.float32(mu), np.float32(3 * g), np.float32(count))
        t = tloss.alm_dual_update(*map(torch.tensor, args), 5.0, mu_max=2.0)
        j = jloss.alm_dual_update(*map(jnp.asarray, args), 5.0, mu_max=2.0)
        for a, b in zip(t, j):
            np.testing.assert_allclose(_np(a), np.asarray(b), **TIGHT)


def test_psnrm_schedule_matches_jax(tmp_path):
    path = tmp_path / "psnrm.csv"
    path.write_text("qp,psnrm_db\n0,30.5\n20,33.0\n63,41.25\n70,1\n")
    for p in (str(path), None, str(tmp_path / "missing.csv")):
        np.testing.assert_allclose(
            _np(tloss.init_psnrm_schedule(p, 36.0)),
            np.asarray(jloss.init_psnrm_schedule(p, 36.0)), **TIGHT)


@pytest.mark.parametrize("warmup", [0, 5])
def test_warmup_cosine_matches_jax(warmup):
    t = tsched.warmup_cosine(1e-4, 1e-5, warmup, 50)
    j = jsched.warmup_cosine(1e-4, 1e-5, warmup, 50)
    for step in (0, 1, 4, 5, 6, 27, 49, 50, 80):
        np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6)


# ----------------------------------------------------------- optimizers --

def test_param_labels_match_jax():
    for path in (("bit_estimator_z", "f1", "h"), ("mask_sft", "conv1",
                                                   "weight"),
                 ("q_sft",), ("mask_predictor", "net_0", "bias"),
                 ("encoder", "conv1", "weight"), ("q_encoder",)):
        assert param_label(path) == jax_param_label(path)
    assert mask_train_label(("mask_predictor", "net_0", "weight")) == \
        "mask_predictor"
    assert mask_train_label(("encoder", "conv1", "weight")) == "frozen"
    assert topt.aux_label(("bit_estimator_z", "f1", "h")) == \
        jopt.aux_label(("bit_estimator_z", "f1", "h")) == "aux"


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {("encoder", "conv1", "weight"): (6, 5),
              ("q_sft",): (4, 3), ("bit_estimator_z", "f1", "h"): (3, 4),
              ("mask_predictor", "net_0", "bias"): (5,)}
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return out


def _run_both(cfg_kw, n_steps, seed=0):
    """The same gradients through the port's and the JAX trainer's
    optimizer chains; returns both trees after each step."""
    def cfgs(mod):
        cfg = mod.TrainConfig(**cfg_kw.get("top", {}))
        for k, v in cfg_kw.get("optimizer", {}).items():
            setattr(cfg.optimizer, k, v)
        cfg.model_profile = "tiny"
        cfg.precision = "32"
        return cfg

    tr = Trainer(cfgs(tcfg), total_iters=20, device="cpu")
    jt = JaxTrainer(cfgs(jcfg), total_iters=20)
    flat = _opt_tree(seed)
    params = {".".join(k): torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in flat.items()}
    tx = tr.make_tx(list(params.items()))
    jparams = jax.tree_util.tree_map(jnp.asarray, _nest(flat))
    jstate = jt.tx.init(jparams)
    rng = np.random.default_rng(seed + 1)
    out = []
    for _ in range(n_steps):
        grads = {k: (2.0 * rng.standard_normal(v.shape)).astype(np.float32)
                 for k, v in flat.items()}
        tx.zero_grad()
        for k, g in grads.items():
            params[".".join(k)].grad = torch.from_numpy(g)
        tx.step()
        upd, jstate = jt.tx.update(
            jax.tree_util.tree_map(jnp.asarray, _nest(grads)), jstate,
            jparams)
        jparams = optax.apply_updates(jparams, upd)
        out.append(({k: params[".".join(k)].detach().numpy().copy()
                     for k in flat},
                    {k: np.asarray(v) for k, v in flatten(jparams).items()}))
    return out


@pytest.mark.parametrize("opt", ["adamw", "adam", "lion"])
@pytest.mark.parametrize("n_steps", [1, 3])
def test_optimizer_steps_match_optax(opt, n_steps):
    kw = {"top": dict(accumulation_steps=1, grad_clip=1.0),
          "optimizer": dict(optimizer_type=opt, base_lr=1e-2, min_lr=1e-3,
                            aux_lr=5e-2, weight_decay=0.1, warmup_iters=2)}
    for t, j in _run_both(kw, n_steps)[-1:]:
        assert t.keys() == j.keys()
        for k in t:
            np.testing.assert_allclose(t[k], j[k], **TIGHT, err_msg=str(k))


def test_mask_train_optimizer_matches_optax():
    kw = {"top": dict(accumulation_steps=1, mask_train=True,
                      dmc_variant="mask_prop", grad_clip=1.0),
          "optimizer": dict(base_lr=1e-2)}
    steps = _run_both(kw, 2)
    start = _opt_tree(0)
    for t, j in steps:
        for k in t:
            np.testing.assert_allclose(t[k], j[k], **TIGHT, err_msg=str(k))
    t, _ = steps[-1]
    for k in t:
        moved = not np.array_equal(t[k], start[k])
        assert moved == ("mask_predictor" in k), k


@pytest.mark.parametrize("opt", ["adamw", "lion"])
def test_accumulation_matches_optax_multisteps(opt):
    kw = {"top": dict(accumulation_steps=3, grad_clip=1.0),
          "optimizer": dict(optimizer_type=opt, base_lr=1e-2,
                            weight_decay=0.1)}
    start = _opt_tree(0)
    for i, (t, j) in enumerate(_run_both(kw, 6)):
        for k in t:
            np.testing.assert_allclose(t[k], j[k], **TIGHT, err_msg=str(k))
            # no update and no decay between boundaries
            if i in (0, 1):
                assert np.array_equal(t[k], start[k])


def test_clip_is_optax_not_clip_grad_norm():
    g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]
    norm = topt.clip_by_global_norm_(g, 6.5)
    assert float(norm) == 13.0
    want = optax.clip_by_global_norm(6.5).update(
        [jnp.array([3.0, 4.0]), jnp.array([12.0])], None)[0]
    for a, b in zip(g, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TIGHT)
    small = [torch.tensor([0.3, 0.4])]
    topt.clip_by_global_norm_(small, 6.5)
    assert torch.equal(small[0], torch.tensor([0.3, 0.4]))


def test_create_optimizers_matches_jax():
    flat = _opt_tree(2)
    params = {".".join(k): torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in flat.items()}
    tx = topt.create_optimizers(list(params.items()), "adamw", 1e-2, 1e-3,
                                5e-2, 0.1, 0, 10, 1.0)
    jtx = jopt.create_optimizers("adamw", 1e-2, 1e-3, 5e-2, 0.1, 0, 10, 1.0)
    jp = jax.tree_util.tree_map(jnp.asarray, _nest(flat))
    st = jtx.init(jp)
    rng = np.random.default_rng(3)
    for _ in range(2):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in flat.items()}
        for k, g in grads.items():
            params[".".join(k)].grad = torch.from_numpy(g)
        tx.step()
        upd, st = jtx.update(jax.tree_util.tree_map(jnp.asarray,
                                                    _nest(grads)), st, jp)
        jp = optax.apply_updates(jp, upd)
    for k, v in flatten(jp).items():
        np.testing.assert_allclose(params[".".join(k)].detach().numpy(),
                                   np.asarray(v), **TIGHT)


# ------------------------------------------------------- device_synth --

def test_synth_batch_shapes_ranges_and_seeding():
    g = lambda s: torch.Generator().manual_seed(s)
    out = synth_batch(g(0), batch=4, size=64, seq_len=3)
    assert out["frames"].shape == (4, 3, 64, 64, 3)
    assert out["masks"].shape == (4, 3, 64, 64, 1)
    f, m = out["frames"].numpy(), out["masks"].numpy()
    assert f.min() >= 0.0 and f.max() <= 1.0
    assert set(np.unique(m)) <= {0.0, 1.0}
    assert (m.reshape(4, -1).max(axis=1) == 1.0).all()
    a = synth_batch(g(1), batch=2, size=64, seq_len=2)["frames"]
    b = synth_batch(g(2), batch=2, size=64, seq_len=2)["frames"]
    c = synth_batch(g(1), batch=2, size=64, seq_len=2)["frames"]
    assert float((a - b).abs().max()) > 1e-3
    assert torch.equal(a, c)
    moving = synth_batch(g(3), batch=8, size=64, seq_len=4)["masks"].numpy()
    moved = np.abs(moving[:, 1:] - moving[:, :-1]).reshape(8, -1).max(1) > 0
    assert moved.sum() >= 4


def test_synth_batch_distribution_matches_the_numpy_generator():
    size, t_len, n = 64, 4, 24
    host = SyntheticClipDataset(num_clips=n, seq_len=t_len, crop_size=size,
                                seed=11, texture="smooth")
    hf, hm = zip(*[host[i] for i in range(n)])
    hf, hm = np.stack(hf), np.stack(hm)
    d = synth_batch(torch.Generator().manual_seed(11), batch=n, size=size,
                    seq_len=t_len)
    df, dm = d["frames"].numpy(), d["masks"].numpy()
    assert abs(hm.mean() - dm.mean()) < 0.10
    assert abs(hf.mean() - df.mean()) < 0.05
    assert abs(hf.std() - df.std()) < 0.05
    hg = np.abs(np.diff(hf[..., 0], axis=-1)).mean()
    dg = np.abs(np.diff(df[..., 0], axis=-1)).mean()
    assert abs(hg - dg) < 0.02


def test_roi_subset_mask_is_an_informative_subset():
    size, t_len, n = 64, 4, 24
    g = lambda: torch.Generator().manual_seed(7)
    full = synth_batch(g(), batch=n, size=size, seq_len=t_len)
    sub = synth_batch(g(), batch=n, size=size, seq_len=t_len,
                      roi_subset=True)
    cov_all = float(full["masks"].mean())
    cov_sub = float(sub["masks"].mean())
    assert cov_sub < cov_all * 0.95
    per_clip = sub["masks"].reshape(n, -1).mean(1)
    assert (per_clip > 0).all()
    host = SyntheticClipDataset(num_clips=n, seq_len=t_len, crop_size=size,
                                seed=7, texture="smooth", roi_subset=True)
    hm = np.stack([host[i][1] for i in range(n)])
    assert abs(hm.mean() - cov_sub) < 0.10


def test_sample_qp_distribution():
    g = torch.Generator().manual_seed(0)
    qps = np.array([sample_qp(g) for _ in range(512)])
    assert qps.min() >= 0 and qps.max() <= 63
    near = np.abs(qps[:, None] - np.array([8, 20, 32, 44, 56])).min(1) <= 3
    assert 0.55 < near.mean() < 0.95
    ends = (qps < 8) | (qps >= 56)
    assert ends.mean() > 0.15


# ------------------------------------------------------------ trainer --

def _tiny_trainer(**kw):
    kw.setdefault("accumulation_steps", 1)
    cfg = tcfg.TrainConfig(**kw)
    cfg.model_profile, cfg.precision = "tiny", "32"
    return Trainer(cfg, total_iters=100, device="cpu")


def _tiny_batch(b=2, t=3, hw=64, seed=5):
    return synth_batch(torch.Generator().manual_seed(seed), batch=b,
                       size=hw, seq_len=t)


@functools.lru_cache(maxsize=1)
def _gop_case():
    """The port's tiny trainer with drawn weights, and the JAX package's
    gop_loss and gradient on the same weights and batch (train=False)."""
    tr = _tiny_trainer()
    pi = drawn_params(tr.dmci, 0, DMCI_HEADS)
    pp = drawn_params(tr.dmc, 1, DMC_HEADS)
    batch = _tiny_batch()
    cfg = jcfg.TrainConfig(accumulation_steps=1)
    cfg.model_profile, cfg.precision = "tiny", "fp32"
    jt = JaxTrainer(cfg, total_iters=100)
    frames, masks = (jnp.asarray(batch[k].numpy()) for k in ("frames",
                                                             "masks"))
    jpi, jpp = (jax.tree_util.tree_map(jnp.asarray, p) for p in (pi, pp))
    f = lambda p: jt.gop_loss(p, jpi, frames, masks, jnp.int32(20),
                              jax.random.PRNGKey(1), train=False,
                              eval_mode=False)[0]
    loss, grads = jax.jit(jax.value_and_grad(f))(jpp)
    return tr, batch, float(loss), {k: np.asarray(v)
                                    for k, v in flatten(grads).items()}


def _port_grads(tr, batch, qp=20, train=False, seed=1):
    tr.dmc.zero_grad(set_to_none=True)
    loss, aux = tr.gop_loss(batch["frames"], batch["masks"], qp,
                            torch.Generator().manual_seed(seed), train=train,
                            eval_mode=False)
    loss.backward()
    grads = flatten(flax_from_state_dict(
        {k: p.grad for k, p in tr.dmc.named_parameters()}))
    return (float(loss.detach()), {k: np.asarray(v) for k, v in grads.items()},
            aux)


def test_gop_loss_and_gradient_match_jax():
    tr, batch, jloss_v, jgrads = _gop_case()
    loss, grads, aux = _port_grads(tr, batch)
    np.testing.assert_allclose(loss, jloss_v, rtol=5e-3)
    assert grads.keys() == jgrads.keys()
    nonzero, err2, norm2 = 0, 0.0, 0.0
    for k, j in jgrads.items():
        scale = np.linalg.norm(j)
        err = np.linalg.norm(grads[k] - j)
        assert err <= GRAD_TENSOR_TOL * scale or (scale == 0 and err == 0), \
            (k, err, scale)
        nonzero += scale > 0
        err2, norm2 = err2 + err ** 2, norm2 + scale ** 2
    assert np.sqrt(err2 / norm2) <= 1e-3
    assert nonzero > 0.9 * len(jgrads)
    assert all(np.isfinite(float(v)) for v in aux.values())


def test_remat_replays_the_quantiser_noise():
    """Per-frame checkpointing recomputes each frame with the same noise:
    train=True gradients with and without remat are equal."""
    tr, batch, _, _ = _gop_case()
    tr.remat = True
    a = _port_grads(tr, batch, train=True, seed=9)
    tr.remat = False
    try:
        b = _port_grads(tr, batch, train=True, seed=9)
    finally:
        tr.remat = True
    assert a[0] == b[0]
    for k in a[1]:
        np.testing.assert_array_equal(a[1][k], b[1][k], err_msg=str(k))
    c = _port_grads(tr, batch, train=True, seed=10)
    assert c[0] != a[0]


def test_train_step_accumulates_then_updates():
    tr = _tiny_trainer(accumulation_steps=3)
    batch = _tiny_batch()
    state = tr.init_state(torch.Generator().manual_seed(0), batch)
    start = {k: v.clone() for k, v in tr.dmc.state_dict().items()}
    gen = torch.Generator().manual_seed(3)
    for i in range(3):
        state, aux = tr.train_step(state, batch, 20, gen)
        same = all(torch.equal(v, start[k])
                   for k, v in tr.dmc.state_dict().items())
        assert same == (i < 2)
        assert np.isfinite(float(aux["loss"]))
    assert state.step == 3 and tr.tx.count == 1 and tr.tx.mini_step == 0


def test_fresh_init_calibrates_only_on_signal():
    tr = _tiny_trainer()
    tr.init_state(torch.Generator().manual_seed(0), tr.example_batch())
    assert torch.equal(tr.dmc.z_gain, torch.ones_like(tr.dmc.z_gain))
    tr.init_state(torch.Generator().manual_seed(0), _tiny_batch())
    assert not torch.equal(tr.dmc.z_gain, torch.ones_like(tr.dmc.z_gain))
    assert not torch.equal(tr.dmci.z_gain, torch.ones_like(tr.dmci.z_gain))
    # carried-in weights are not recalibrated
    pp = {k: v.clone() for k, v in tr.dmc.state_dict().items()}
    pi = {k: v.clone() for k, v in tr.dmci.state_dict().items()}
    tr.init_state(torch.Generator().manual_seed(1), _tiny_batch(),
                  params_p=pp, params_i=pi)
    assert all(torch.equal(v, pp[k]) for k, v in tr.dmc.state_dict().items())


def test_constraint_opt_dual_update_on_the_boundary():
    tr = _tiny_trainer(constraint_opt=True, accumulation_steps=2)
    batch = _tiny_batch()
    state = tr.init_state(torch.Generator().manual_seed(0), batch)
    mu0 = float(state.alm_mu)
    gen = torch.Generator().manual_seed(3)
    state, aux = tr.train_step(state, batch, 40, gen)
    assert float(state.alm_mu) == mu0 and float(state.alm_h_count) == 1.0
    state, aux = tr.train_step(state, batch, 40, gen)
    assert float(state.alm_h_count) == 0.0
    assert float(state.alm_mu) != mu0
    assert np.isfinite(float(aux["g_mean"]))


def test_mask_train_updates_only_the_mask_predictor():
    tr = _tiny_trainer(dmc_variant="mask_prop", mask_train=True)
    batch = _tiny_batch()
    state = tr.init_state(torch.Generator().manual_seed(0), batch)
    start = {k: v.clone() for k, v in tr.dmc.state_dict().items()}
    state, aux = tr.train_step(state, batch, 20,
                               torch.Generator().manual_seed(1))
    for k, v in tr.dmc.state_dict().items():
        assert torch.equal(v, start[k]) != ("mask_predictor" in k), k
    assert np.isfinite(float(aux["loss"]))


def test_fit_runs_three_steps_and_validates(tmp_path):
    tr = _tiny_trainer()

    def batches(seed):
        g = torch.Generator().manual_seed(seed)
        while True:
            yield synth_batch(g, batch=2, size=64, seq_len=3)

    rows = {"train": [], "val": []}

    class Log:
        def log_train(self, step, row):
            rows["train"].append((step, row))

        def log_val(self, step, row):
            rows["val"].append((step, row))

    state = tr.fit(batches(0), val_iter=batches(1), steps=3, val_every=3,
                   log_every=1, seed=4, logger=Log(), steps_per_epoch=2)
    assert state.step == 3 and tr.tx.count == 3
    assert [s for s, _ in rows["train"]] == [0, 1, 2]
    assert all(np.isfinite(v) for _, r in rows["train"] for v in r.values())
    assert [s for s, _ in rows["val"]] == [2]
    assert rows["train"][-1][1]["epoch"] == 1
    # after each validation: the checkpoint, with the val loss, and the
    # recon panels
    saved = []

    class Ckpt:
        def save(self, ckpt, metrics, step):
            saved.append((sorted(ckpt), metrics, step))

    tr.fit(batches(0), val_iter=batches(1), steps=1, val_every=1,
           ckpt_manager=Ckpt(), image_log_dir=str(tmp_path), state=state)
    assert [(keys, step) for keys, _, step in saved] == [(
        ["alm_h_accum", "alm_h_count", "alm_mu", "opt_state", "params_i",
         "params_p", "step"], 0)]
    assert np.isfinite(saved[0][1]["val/loss"])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "recon_p_step0.png", "recon_step0.png"]


def test_trainer_takes_one_device_and_defaults_to_the_card():
    """num_devices=2 without a process group: make_mesh's refusal (two
    ranks take torchrun, tests/test_torch_parallel.py)."""
    cfg = tcfg.TrainConfig(num_devices=2)
    with pytest.raises(ValueError, match="requested but only"):
        Trainer(cfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(tcfg.TrainConfig())


# ------------------------------------------------ inference no-grad --

def test_inference_paths_build_no_graph():
    from ssgvc_tpu_torch.coding.codec import VideoCodec
    from ssgvc_tpu_torch.models.inference_api import StreamingDMC
    from ssgvc_tpu_torch.training.evaluate import evaluate_gop_estimated

    dmci = DMCI(tcfg.DMCIConfig(**DMCI_TINY), device="cpu")
    dmc = DMC(tcfg.DMCConfig.variant("performance", **TINY), device="cpu")
    drawn_params(dmci, 0, DMCI_HEADS)
    drawn_params(dmc, 1, DMC_HEADS)
    seen = []
    for m in (dmci, dmc):
        m.register_forward_hook(lambda mod, a, out: seen.append(
            (torch.is_grad_enabled(), out["bpp"].requires_grad)))
    rng = np.random.default_rng(0)
    hw = 64
    frames = rng.uniform(0, 1, (3, hw, hw, 3)).astype(np.float32)
    masks = (rng.uniform(0, 1, (3, hw, hw, 1)) > 0.7).astype(np.float32)
    evaluate_gop_estimated(dmci, dmc, frames, masks, 20, (0, 1, 2),
                           (0, 8, 4))
    assert len(seen) == 3 and not any(g or r for g, r in seen)

    t = lambda a: torch.from_numpy(a)[None]
    codec = VideoCodec(dmci, dmc)
    out_i = codec.dmci_compress(t(frames[0]), 20)
    feat = torch.zeros((1, hw // 8, hw // 8, TINY["ch_d"]))
    out_p = codec.dmc_compress(t(frames[1]), 20, {"frame": out_i["x_hat"],
                                                  "feature": feat},
                               after_i=True, mask=t(masks[1]))
    for x in (out_i["x_hat"], out_p["x_hat"], *out_p["dpb"].values()):
        assert not x.requires_grad and x.grad_fn is None

    stream = StreamingDMC(dmc)
    packed, bpp = stream.step(t(frames[1]), t(masks[1]), 20,
                              stream.init_dpb(out_i["x_hat"]), after_i=True)
    assert not packed.requires_grad and not bpp.requires_grad
    assert packed.grad_fn is None

    # a training forward builds the graph
    seen.clear()
    out = dmc(t(frames[1]), 20, {"frame": out_i["x_hat"], "feature": feat},
              mask=t(masks[1]))
    assert out["bpp"].requires_grad and seen == [(True, True)]
