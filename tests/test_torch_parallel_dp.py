"""The port's data-parallel training (parallel/mesh.py, the trainer's and
the image CLI's steps) over 2 ranks on the CPU over gloo, against one
device's on the global batch and the JAX package's gop_loss gradient; the
gain calibration and the ALM state over 2 ranks. Tolerances as
test_torch_parallel.py's docstring states them; its spawn helper."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_dist_worker as worker
from chip_smoke import DMC_HEADS, DMCI_HEADS
from ssgvc_tpu import config as jcfg
from ssgvc_tpu.training.trainer import Trainer as JaxTrainer
from ssgvc_tpu_torch import trainer_image_model as image_cli
from ssgvc_tpu_torch.config import (CompressionConfig, DMCIConfig,
                                    TrainConfig)
from ssgvc_tpu_torch.data.device_synth import synth_batch
from ssgvc_tpu_torch.models.dmci import DMCI
from ssgvc_tpu_torch.training.loss import psnr_from_mse
from ssgvc_tpu_torch.training.trainer import NOISE_SEED_STRIDE, Trainer
from ssgvc_tpu_torch.utils.weights import (flatten, flax_from_state_dict,
                                           load_flax_params)
from test_torch_parallel import _spawn
from test_torch_training import GRAD_TENSOR_TOL
from torch_port_helpers import DMCI_TINY, drawn_params
from torch_port_helpers import one_torch_thread  # noqa: F401

TINY_DMCI = functools.partial(DMCIConfig, **DMCI_TINY)

# The whole data-parallel gradient against one device's on the global
# batch. One device's own gradient moves by 1.6e-5 of its norm between one
# and eight CPU threads (another summation order), and the data-parallel
# one sat 4.1e-5 from it, almost all of it in the prior branch
# (y_prior_fusion, ~9e-4 of each tensor's norm: the rate's sigma
# derivative, test_torch_training's GRAD_TENSOR_TOL note); every other
# tensor within ~2e-6 of its own.
DP_GRAD_TOL = 1e-4


def _tiny_trainer(**kw):
    cfg = TrainConfig(**kw)
    cfg.model_profile, cfg.precision = "tiny", "32"
    return Trainer(cfg, total_iters=100, device="cpu")


@functools.lru_cache(maxsize=1)
def _dp_case():
    """Drawn weights of the tiny trainer, a B=2 T=2 batch, and the JAX
    package's gop_loss gradient on it (train=False, QP 20)."""
    tr = _tiny_trainer()
    pi = drawn_params(tr.dmci, 0, DMCI_HEADS)
    pp = drawn_params(tr.dmc, 1, DMC_HEADS)
    batch = synth_batch(torch.Generator().manual_seed(5), batch=2, size=64,
                        seq_len=2)
    batch = {k: v.numpy() for k, v in batch.items()}
    cfg = jcfg.TrainConfig(accumulation_steps=1)
    cfg.model_profile, cfg.precision = "tiny", "fp32"
    jt = JaxTrainer(cfg, total_iters=100)
    frames, masks = (jnp.asarray(batch[k]) for k in ("frames", "masks"))
    jpi, jpp = (jax.tree_util.tree_map(jnp.asarray, p) for p in (pi, pp))
    f = lambda p: jt.gop_loss(p, jpi, frames, masks, jnp.int32(20),
                              jax.random.PRNGKey(1), train=False,
                              eval_mode=False)[0]
    _, grads = jax.jit(jax.value_and_grad(f))(jpp)
    jgrads = {k: np.asarray(v) for k, v in flatten(grads).items()}
    return dict(params_p=pp, params_i=pi, batch=batch, qp=20), jgrads


def _flax_grads(named):
    return {k: np.asarray(v) for k, v in flatten(flax_from_state_dict(
        {n: g for n, g in named.items()})).items()}


IMAGE_CASE = dict(widths=DMCI_TINY, seed=5, qp=21,
                  x=np.random.default_rng(8).uniform(
                      0, 1, (2, 64, 64, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def dp_seen(tmp_path_factory):
    """One 2-rank spawn of ``worker.dp_gradient``: the video trainer's
    data-parallel step, then the image CLI's in the same group."""
    case, _ = _dp_case()
    return _spawn(worker.dp_gradient, 2, tmp_path_factory.mktemp("dp"),
                  {**case, "image": IMAGE_CASE})


def test_data_parallel_gradient_matches_one_device_and_jax(dp_seen):
    """2 ranks, B=1 each: the optimizer's reduced gradient against one
    device's on the global B=2 batch (DP_GRAD_TOL of its norm, and each
    tensor by GRAD_TENSOR_TOL) and against the JAX gop_loss gradient
    (GRAD_TENSOR_TOL); the loss equal on both ranks
    and to one device's; the parameters equal bit for bit across the
    ranks after that update and after a train_step whose noise differs by
    rank."""
    case, jgrads = _dp_case()
    seen = dp_seen

    tr = _tiny_trainer(accumulation_steps=1)
    load_flax_params(tr.dmc, case["params_p"])
    load_flax_params(tr.dmci, case["params_i"])
    tr.dmc.zero_grad(set_to_none=True)
    loss, _ = tr.gop_loss(torch.from_numpy(case["batch"]["frames"]),
                          torch.from_numpy(case["batch"]["masks"]), 20,
                          torch.Generator().manual_seed(1), train=False,
                          eval_mode=False)
    loss.backward()
    # unused parameters (the after-I adaptor): None, the optimizer's zeros
    one = {k: torch.zeros_like(p) if p.grad is None else p.grad
           for k, p in tr.dmc.named_parameters()}
    loss = float(loss.detach())

    assert seen[0]["loss"] == seen[1]["loss"]
    assert seen[0]["local_loss"] != seen[1]["local_loss"]
    np.testing.assert_allclose(seen[0]["loss"], loss, rtol=1e-6)
    assert seen[0]["train_loss"] == seen[1]["train_loss"]
    for key in ("after_step", "after_train_step"):
        for k, v in seen[0][key].items():
            assert torch.equal(v, seen[1][key][k]), (key, k)
    dp = torch.cat([seen[0]["grads"][k].reshape(-1) for k in one])
    ref = torch.cat([g.reshape(-1) for g in one.values()])
    err = float(torch.linalg.vector_norm(dp - ref))
    assert err <= DP_GRAD_TOL * float(torch.linalg.vector_norm(ref)), err
    _hold_by_tensor(_flax_grads(seen[0]["grads"]), _flax_grads(one))
    _hold_by_tensor(_flax_grads(seen[0]["grads"]), jgrads)


def test_int8_data_parallel_step_matches_one_device(dp_seen, monkeypatch):
    """SSGVC_INT8=1 under the data mesh: 2 ranks with B=1 each, mode 1's
    abs-max the global batch's at every site (Trainer's batch_shard), its
    gradient's tie count and d s_x over both ranks. The loss's mean and
    the reduced gradient against one device's on the global B=2 batch (as
    the float step, DP_GRAD_TOL of the norm and GRAD_TENSOR_TOL a tensor);
    a train_step with per-rank noise leaves the ranks equal."""
    case, _ = _dp_case()
    seen = [s["int8"] for s in dp_seen]
    monkeypatch.setenv("SSGVC_INT8", "1")
    tr = _tiny_trainer(accumulation_steps=1)
    load_flax_params(tr.dmc, case["params_p"])
    load_flax_params(tr.dmci, case["params_i"])
    tr.dmc.zero_grad(set_to_none=True)
    loss, _ = tr.gop_loss(torch.from_numpy(case["batch"]["frames"]),
                          torch.from_numpy(case["batch"]["masks"]), 20,
                          torch.Generator().manual_seed(1), train=False,
                          eval_mode=False)
    tr.backward(loss)
    one = {k: torch.zeros_like(p) if p.grad is None else p.grad
           for k, p in tr.dmc.named_parameters()}
    assert seen[0]["loss"] == seen[1]["loss"]
    assert seen[0]["local_loss"] != seen[1]["local_loss"]
    np.testing.assert_allclose(seen[0]["loss"], float(loss.detach()),
                               rtol=1e-6)
    assert seen[0]["train_loss"] == seen[1]["train_loss"]
    for k, v in seen[0]["after_train_step"].items():
        assert torch.equal(v, seen[1]["after_train_step"][k]), k
    dp = torch.cat([seen[0]["grads"][k].reshape(-1) for k in one])
    ref = torch.cat([g.reshape(-1) for g in one.values()])
    err = float(torch.linalg.vector_norm(dp - ref))
    assert err <= DP_GRAD_TOL * float(torch.linalg.vector_norm(ref)), err
    _hold_by_tensor(_flax_grads(seen[0]["grads"]), _flax_grads(one))


def test_image_cli_step_on_two_ranks_matches_one_device(dp_seen):
    """The image CLI's data-parallel step (``replicate``, ``make_tx`` over
    the data group, ``train_step``), 2 ranks with B=1 each, against one
    device's step on the B=2 batch with the same weights and each sample's
    noise drawn from its rank's generator: the loss is the batch's mean
    and the DMCI is per sample, so that step's loss is the mean of the two
    samples' losses. Rank 0's init on both ranks, the reduced gradient
    (DP_GRAD_TOL of its norm), the averaged metrics with the PSNR from the
    mean MSE (rtol 1e-6), the parameters equal across the ranks bit for bit
    and to one device's within 1e-6."""
    seen = [s["image"] for s in dp_seen]
    c = IMAGE_CASE
    model = DMCI(TINY_DMCI(), device="cpu")
    model.init_(torch.Generator().manual_seed(c["seed"]))
    for k, v in model.state_dict().items():
        for s in seen:
            assert torch.equal(s["init"][k], v), k
    assert any(not torch.equal(seen[1]["own_init"][k], v)
               for k, v in model.state_dict().items())

    tx = image_cli.make_tx(model, TrainConfig(), 100)
    tx.zero_grad()
    x = torch.from_numpy(c["x"])
    pairs = [image_cli.image_loss(
        model, x[r:r + 1], c["qp"], CompressionConfig(), True,
        torch.Generator().manual_seed(c["seed"] + NOISE_SEED_STRIDE * r))
        for r in range(2)]
    ((pairs[0][0] + pairs[1][0]) / 2).backward()
    tx.step()
    mean = {k: (pairs[0][1][k] + pairs[1][1][k]) / 2 for k in pairs[0][1]}
    mean["psnr"] = psnr_from_mse(mean["mse"])

    assert seen[0]["aux"] == seen[1]["aux"]
    assert seen[0]["aux"].keys() == mean.keys()
    for k, v in mean.items():
        np.testing.assert_allclose(seen[0]["aux"][k], float(v), rtol=1e-6,
                                   err_msg=k)
    ref = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
    dp = torch.cat([seen[0]["grads"][k].reshape(-1)
                    for k, _ in model.named_parameters()])
    err = float(torch.linalg.vector_norm(dp - ref))
    assert err <= DP_GRAD_TOL * float(torch.linalg.vector_norm(ref)), err
    assert any(not torch.equal(seen[0]["after_step"][k], seen[0]["init"][k])
               for k in seen[0]["init"])
    for k, v in model.state_dict().items():
        assert torch.equal(seen[0]["after_step"][k],
                           seen[1]["after_step"][k]), k
        np.testing.assert_allclose(seen[0]["after_step"][k].numpy(),
                                   v.numpy(), rtol=0, atol=1e-6, err_msg=k)


def _hold_by_tensor(grads, refs):
    """test_torch_training's rule: each tensor within GRAD_TENSOR_TOL of its
    own norm."""
    assert grads.keys() == refs.keys()
    for k, j in refs.items():
        scale = np.linalg.norm(j)
        e = np.linalg.norm(grads[k] - j)
        assert e <= GRAD_TENSOR_TOL * scale or (scale == 0 and e == 0), \
            (k, e, scale)


def test_calibration_and_alm_over_two_ranks_match_one_device(tmp_path):
    """Gain calibration on 2 ranks' shards equals one device's on the
    global batch; constraint_opt at accumulation 2: the ALM state after
    each micro-step equals one device's (the dual update on the
    boundary)."""
    case, _ = _dp_case()
    seen = _spawn(worker.calibration_and_alm, 2, tmp_path, case)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}

    tr = _tiny_trainer()
    tr.init_state(torch.Generator().manual_seed(0), batch)
    want = {"q_encoder": tr.dmc.q_encoder, "z_gain": tr.dmc.z_gain,
            "dmci_z_gain": tr.dmci.z_gain}
    assert not torch.equal(tr.dmc.z_gain, torch.ones_like(tr.dmc.z_gain))
    for k, v in want.items():
        assert torch.equal(seen[0]["gains"][k], seen[1]["gains"][k]), k
        np.testing.assert_allclose(seen[0]["gains"][k].numpy(),
                                   v.detach().numpy(), rtol=1e-5, err_msg=k)

    tr = _tiny_trainer(constraint_opt=True, accumulation_steps=2)
    load_flax_params(tr.dmc, case["params_p"])
    load_flax_params(tr.dmci, case["params_i"])
    state = tr.init_state(torch.Generator().manual_seed(0), batch,
                          params_p=tr.dmc.state_dict(),
                          params_i=tr.dmci.state_dict())
    gen = torch.Generator().manual_seed(3)
    mu0 = float(state.alm_mu)
    for i in range(2):
        state, aux = tr.train_step(state, batch, case["qp"], gen)
        got = seen[0]["alm"][i]
        assert got == seen[1]["alm"][i]
        np.testing.assert_allclose(
            got, (float(state.alm_mu), float(state.alm_h_accum),
                  float(state.alm_h_count), float(aux["g_mean"])),
            rtol=1e-5, atol=1e-7)
    assert seen[0]["alm"][1][0] != mu0 and seen[0]["alm"][1][2] == 0.0
