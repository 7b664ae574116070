"""The port's RD experiment harness (``ssgvc_tpu_torch/experiments/``) on
the CPU against the JAX package's scripts (``experiments/rd_*.py``,
imported by path): the checkpoint names, the host QP sampler, the DMCI
cosine schedule against optax, the keep-best rotation, the DMCI mega-step's
loss and gradient, both mega-steps against hand-run steps, and the whole
``rd_tpu.main`` run at rd-tiny, its saved best weights carried into the JAX
models and evaluated there.

Tolerances: the schedule at rtol 1e-6 (XLA's and torch's fp32 cos); the
DMCI loss, its mse and bpp at rtol 5e-3 and the gradient as
``test_torch_image_trainer.py`` holds the image loss's (each tensor within
GRAD_TENSOR_TOL of its norm, the whole within 1e-3; train=False, since the
packages draw different quantiser noise); the mega-steps bit for bit
against the same steps run by hand, their means at rtol 1e-6; the RD curve
of the saved weights as ``test_torch_evaluate_batched.py`` holds it: bpp at
rtol 5e-3, PSNR and ROI-PSNR within 1e-2 dB.
"""

import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from chip_smoke import DMCI_HEADS, RD_TPU_KEYS, RD_TPU_VARIANT_KEYS
from ssgvc_tpu.config import DMCConfig as JaxDMCConfig
from ssgvc_tpu.config import DMCIConfig as JaxDMCIConfig
from ssgvc_tpu.config import MODEL_PROFILES
from ssgvc_tpu.data.dataset import SyntheticClipDataset
from ssgvc_tpu.models.dmc import DMC as JaxDMC
from ssgvc_tpu.models.dmci import DMCI as JaxDMCI
from ssgvc_tpu.training import evaluate as jev
from ssgvc_tpu.training.loss import compute_lambda as jax_lambda
from ssgvc_tpu_torch import config as tcfg
from ssgvc_tpu_torch.experiments import (rd_full, rd_keep_best, rd_tpu)
from ssgvc_tpu_torch.models.dmci import DMCI
from ssgvc_tpu_torch.training.evaluate import bd_psnr, bd_rate
from ssgvc_tpu_torch.utils.checkpoint import restore_checkpoint
from ssgvc_tpu_torch.utils.weights import flatten, flax_from_state_dict
from test_torch_training import GRAD_TENSOR_TOL
from torch_port_helpers import drawn_params

sys.path.insert(0, str(Path(__file__).resolve().parent.parent
                       / "experiments"))

import rd_full as jax_rd_full  # noqa: E402
import rd_keep_best as jax_keep_best  # noqa: E402

#: the JAX runner's JSON keys, experiments/rd_tpu.py:482-540
JAX_RD_TPU_KEYS = {"runner", "budget_min", "k", "crop", "batch", "profile",
                   "eval_crop", "steps_schedule", "lambda_normalize",
                   "recon_residual", "roi_subset", "roi_weight", "backend",
                   "variants", "bd_rate_roi_psnr_pct", "bd_psnr_roi_db",
                   "bd_rate_psnr_pct", "bd_psnr_db"}
JAX_VARIANT_KEYS = {"estimated_rd", "best_step", "score", "liveness",
                    "bpp_monotone_increasing_in_qp"}
GLOBALS = ("MID_DMC", "MID_DMCI", "PROFILE", "RECON_SKIP", "CKPT_EXTRA",
           "LNORM")
RD_TINY_DMCI = MODEL_PROFILES["rd-tiny"]["dmci"]


@pytest.fixture
def harness(monkeypatch):
    """Both packages' rd_full globals and the port's device and sizing
    constants, restored after the test; the port on the CPU."""
    for mod in (rd_full, jax_rd_full):
        for name in GLOBALS:
            monkeypatch.setattr(mod, name, getattr(mod, name))
    monkeypatch.setattr(rd_full, "DEVICE", "cpu")
    monkeypatch.setattr(rd_full, "GATE_STEP", rd_full.GATE_STEP)
    monkeypatch.setattr(rd_tpu, "DMCI_PROBE_STEPS", rd_tpu.DMCI_PROBE_STEPS)
    monkeypatch.setattr(rd_tpu, "ROI_SUBSET", False)
    return monkeypatch


# ----------------------------------------------------------- helpers --

@pytest.mark.parametrize("extra", ["", "-roisub"])
@pytest.mark.parametrize("recon_skip", [False, True])
@pytest.mark.parametrize("profile", ["tiny", "mid", "half"])
def test_checkpoint_names_and_profiles_equal_jax(harness, profile,
                                                 recon_skip, extra):
    for mod in (rd_full, jax_rd_full):
        mod.set_profile(profile)
        mod.RECON_SKIP = recon_skip
        mod.CKPT_EXTRA = extra
    assert rd_full.MID_DMC == jax_rd_full.MID_DMC
    assert rd_full.MID_DMCI == jax_rd_full.MID_DMCI
    base = os.path.basename
    for v in ("performance", "plain", "fast"):
        assert base(rd_full.ckpt_path(v)) == base(jax_rd_full.ckpt_path(v))
        assert rd_full.ckpt_path(v).startswith("artifacts/torch/")
    assert base(rd_full.dmci_ckpt_path()) == base(jax_rd_full.dmci_ckpt_path())
    with pytest.raises(SystemExit):
        rd_full.set_profile("full")


def test_sample_qp_draws_equal_jax():
    ours, ref = np.random.default_rng(11), np.random.default_rng(11)
    got = [rd_full.sample_qp(ours) for _ in range(2000)]
    want = [jax_rd_full.sample_qp(ref) for _ in range(2000)]
    assert got == want
    assert rd_full.EVAL_QPS == jax_rd_full.EVAL_QPS
    assert min(got) == 0 and max(got) == 63


def test_bd_fields_equal_the_jax_runners_order():
    """rd_full.bd_fields on two curves whose ranges overlap equals
    experiments/rd_tpu.py:532-539 (plain the anchor, performance the test,
    through the JAX package's bd_rate / bd_psnr): finite, and the anchor
    matters (swapped, every field changes sign)."""
    plain = {"bpp": [0.11, 0.19, 0.37, 0.72, 1.30],
             "psnr": [27.2, 30.1, 33.0, 35.8, 38.1],
             "roi_psnr": [25.0, 28.3, 31.1, 34.2, 36.9]}
    perf = {"bpp": [0.09, 0.16, 0.30, 0.61, 1.12],
            "psnr": [27.4, 30.5, 33.2, 36.3, 38.4],
            "roi_psnr": [26.1, 29.2, 32.5, 35.1, 37.8]}
    names = ("bd_rate_roi_psnr_pct", "bd_psnr_roi_db", "bd_rate_psnr_pct",
             "bd_psnr_db")
    got = rd_full.bd_fields(perf, plain, *names)
    want = {
        "bd_rate_roi_psnr_pct": jev.bd_rate(
            plain["bpp"], plain["roi_psnr"], perf["bpp"], perf["roi_psnr"]),
        "bd_psnr_roi_db": jev.bd_psnr(
            plain["bpp"], plain["roi_psnr"], perf["bpp"], perf["roi_psnr"]),
        "bd_rate_psnr_pct": jev.bd_rate(
            plain["bpp"], plain["psnr"], perf["bpp"], perf["psnr"]),
        "bd_psnr_db": jev.bd_psnr(
            plain["bpp"], plain["psnr"], perf["bpp"], perf["psnr"])}
    assert set(got) == set(want)
    for k in names:
        assert np.isfinite(want[k])
        assert got[k] == pytest.approx(want[k], rel=1e-9)
    assert got["bd_rate_roi_psnr_pct"] < 0 < got["bd_psnr_roi_db"]
    swapped = rd_full.bd_fields(plain, perf, *names)
    assert all(np.sign(swapped[k]) == -np.sign(got[k]) for k in names)


@pytest.mark.parametrize("peak,steps", [(1e-3, 8000), (1e-3, 1), (7e-4, 37)])
def test_dmci_cosine_schedule_equals_optax(peak, steps):
    """rd_tpu.py:159: cosine_decay_schedule(peak, max(steps, 1),
    alpha=0.05), at the update counts the optimizer passes (int32 under
    optax)."""
    ours = rd_tpu.cosine_decay_schedule(peak, steps, alpha=0.05)
    ref = optax.cosine_decay_schedule(peak, steps, alpha=0.05)
    for count in sorted({0, 1, steps // 2, max(steps - 1, 0), steps,
                         steps + 5, 2 * steps + 3}):
        np.testing.assert_allclose(ours(count),
                                   float(ref(jnp.int32(count))), rtol=1e-6,
                                   err_msg=str(count))
    assert ours(10 * steps) == pytest.approx(0.05 * peak, rel=1e-6)


# ------------------------------------------------------- keep-best --

def _curve(base):
    return {"psnr": [base + 0.1 * i for i in range(5)],
            "roi_psnr": [base - 7.0 + 0.05 * i for i in range(5)],
            "bpp": [0.02 * (i + 1) for i in range(5)]}


#: rd_continued.json cycle by cycle: (performance PSNR or a gate, plain's)
CYCLES = [(21.0, 20.0), (20.8, 19.9), (18.0, 17.0), (21.5, "gate"),
          (19.0, 20.5)]


def test_keep_best_decisions_and_trajectory_equal_jax(tmp_path,
                                                      monkeypatch):
    """The same rd_continued.json sequence through both scripts: the JAX
    one rotating checkpoint directories, the port's checkpoint files. The
    trajectory and best JSON are equal, and after every cycle each live
    checkpoint and snapshot holds the same cycle's marker in both."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    for d in (jdir, tdir):
        (d / "artifacts" / "torch").mkdir(parents=True)

    def marker(path, is_dir):
        p = Path(path) / "marker.txt" if is_dir else Path(path)
        return p.read_text() if p.exists() else None

    for cycle, (perf, plain) in enumerate(CYCLES):
        res = {"variants": {}, "bd_psnr_roi_db": 0.1 * cycle}
        for v, base in (("performance", perf), ("plain", plain)):
            res["variants"][v] = ({"gate": "aborted_collapse_restored_prev"}
                                  if base == "gate"
                                  else {"estimated_rd": _curve(base)})
        tag = f"cycle{cycle}"
        # the JAX side's live checkpoints are directories
        monkeypatch.chdir(jdir)
        with open("artifacts/rd_continued.json", "w") as f:
            json.dump(res, f)
        for v in rd_keep_best.VARIANTS:
            os.makedirs(jax_keep_best.live_path(v), exist_ok=True)
            Path(jax_keep_best.live_path(v), "marker.txt").write_text(tag)
        monkeypatch.setattr(sys, "argv", ["rd_keep_best.py", str(cycle)])
        jax_keep_best.main()
        # the port's are files
        monkeypatch.chdir(tdir)
        with open(rd_keep_best.CONTINUED_JSON, "w") as f:
            json.dump(res, f)
        for v in rd_keep_best.VARIANTS:
            Path(rd_keep_best.live_path(v)).write_text(tag)
        traj = rd_keep_best.main(cycle)
        for v in rd_keep_best.VARIANTS:
            for suffix in ("", ".best"):
                assert (marker(tdir / (rd_keep_best.live_path(v) + suffix),
                               False)
                        == marker(jdir / (jax_keep_best.live_path(v)
                                          + suffix), True)), (cycle, v,
                                                             suffix)
    for ours, ref in ((rd_keep_best.TRAJ_JSON, jax_keep_best.TRAJ_JSON),
                      (rd_keep_best.BEST_JSON, jax_keep_best.BEST_JSON)):
        assert (json.loads((tdir / ours).read_text())
                == json.loads((jdir / ref).read_text()))
    actions = [[r[v].get("action") for v in rd_keep_best.VARIANTS]
               for r in traj]
    assert actions == [["new_best", "new_best"], ["kept_latest",
                                                  "kept_latest"],
                       ["diverged_restored_best", "diverged_restored_best"],
                       ["new_best", None], ["diverged_restored_best",
                                            "new_best"]]
    assert (rd_keep_best.VARIANTS, rd_keep_best.DIVERGE_DB) == (
        jax_keep_best.VARIANTS, jax_keep_best.DIVERGE_DB)


# ------------------------------------------------------ mega-steps --

@pytest.mark.parametrize("lnorm", [False, True])
def test_dmci_megastep_loss_and_gradient_match_jax(lnorm):
    """rd_tpu.py:87-95's loss on the same weights, batch and QP."""
    torch.set_num_threads(1)
    model = DMCI(tcfg.DMCIConfig(**RD_TINY_DMCI), device="cpu")
    params = jax.tree_util.tree_map(jnp.asarray,
                                    drawn_params(model, 9, DMCI_HEADS))
    x = np.random.default_rng(10).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    qp, jmodel = 27, JaxDMCI(JaxDMCIConfig(**RD_TINY_DMCI))

    def loss_fn(p):         # rd_tpu.py:87-95, at train=False
        out = jmodel.apply({"params": p}, jnp.asarray(x), qp, train=False)
        mse = jnp.mean((out["dpb"]["frame"].astype(jnp.float32)
                        - jnp.asarray(x)) ** 2)
        lam = jax_lambda(qp, 50.0, 38400.0)
        loss = jnp.mean(out["bpp"]) + lam * mse
        if lnorm:
            loss = loss / lam
        return loss, (mse, jnp.mean(out["bpp"]))

    (jl, (jmse, jbpp)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    loss, (mse, bpp) = rd_full.dmci_loss(model, torch.from_numpy(x), qp,
                                         lnorm, None, train=False)
    loss.backward()
    for got, want in ((loss, jl), (mse, jmse), (bpp, jbpp)):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=5e-3)
    grads = {k: np.asarray(v) for k, v in flatten(flax_from_state_dict(
        {n: p.grad for n, p in model.named_parameters()})).items()}
    jgrads = {k: np.asarray(v) for k, v in flatten(jgrads).items()}
    assert grads.keys() == jgrads.keys()
    err2 = norm2 = 0.0
    for k, j in jgrads.items():
        scale, err = np.linalg.norm(j), np.linalg.norm(grads[k] - j)
        assert err <= GRAD_TENSOR_TOL * scale or (scale == 0 and err == 0), \
            (k, err, scale)
        err2, norm2 = err2 + err ** 2, norm2 + scale ** 2
    assert np.sqrt(err2 / norm2) <= 1e-3


def test_dmci_optimizer_is_the_jax_runners_optax_chain():
    """rd_tpu.py:159-160: clip_by_global_norm(5.0), then adamw on the
    cosine schedule (optax's default weight decay, 1e-4), three steps on
    the same gradients."""
    model = DMCI(tcfg.DMCIConfig(**RD_TINY_DMCI), device="cpu")
    model.init_(torch.Generator().manual_seed(0))
    sched = rd_tpu.cosine_decay_schedule(1e-2, 5, alpha=0.05)
    tx = rd_full.dmci_tx(model, sched)
    jtx = optax.chain(optax.clip_by_global_norm(5.0), optax.adamw(
        optax.cosine_decay_schedule(1e-2, 5, alpha=0.05)))
    to_jax = lambda sd: jax.tree_util.tree_map(jnp.asarray,
                                               flax_from_state_dict(sd))
    jparams = to_jax({k: v.detach().clone() for k, v in
                      model.state_dict().items()})
    jstate = jtx.init(jparams)

    @jax.jit
    def jstep(grads, jstate, jparams):
        upd, jstate = jtx.update(grads, jstate, jparams)
        return optax.apply_updates(jparams, upd), jstate

    rng = np.random.default_rng(3)
    for scale in (0.01, 10.0, 0.01):        # unclipped, clipped, unclipped
        grads = {n: torch.from_numpy(scale * rng.standard_normal(
            p.shape).astype(np.float32)) for n, p in model.named_parameters()}
        tx.zero_grad()
        for n, p in model.named_parameters():
            p.grad = grads[n].clone()
        tx.step()
        jparams, jstate = jstep(to_jax(grads), jstate, jparams)
    got = flatten(flax_from_state_dict(model.state_dict()))
    for k, want in flatten(jparams).items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want),
                                   rtol=1e-6, atol=1e-6, err_msg=str(k))


def _tiny_trainer():
    tr = rd_full.variant_trainer("performance", 10, True)
    batch0 = rd_tpu.synth_batch(torch.Generator().manual_seed(2), batch=2,
                                size=64, seq_len=2)
    return tr, tr.init_state(torch.Generator().manual_seed(1), batch0)


def test_dmc_megastep_equals_hand_run_train_steps(harness):
    """make_dmc_megastep(k=3): three train_steps, each on a fresh
    synth_batch and a device_synth QP from the run's keys, bit for bit,
    and the means of their loss, bpp and PSNR."""
    torch.set_num_threads(1)
    rd_full.set_profile("tiny")
    rd_full.RECON_SKIP = True
    a, state_a = _tiny_trainer()
    b, state_b = _tiny_trainer()
    mega = rd_tpu.make_dmc_megastep(a, 3, 2, 64, 2)
    state_a, means = mega(state_a, rd_tpu.make_keys(5, False))
    keys = rd_tpu.make_keys(5, False)
    rows = []
    for _ in range(3):
        batch = rd_tpu.synth_batch(keys.data, batch=2, size=64, seq_len=2)
        qp = rd_tpu.sample_qp_dev(keys.qp)
        state_b, aux = b.train_step(state_b, batch, qp, keys.noise)
        rows.append([float(aux[k]) for k in ("loss", "bpp", "psnr")])
    np.testing.assert_allclose(means, np.mean(rows, axis=0), rtol=1e-6)
    assert state_a.step == state_b.step == 3 and a.tx.count == 3
    for (n, p), q in zip(a.dmc.named_parameters(), b.dmc.parameters()):
        assert torch.equal(p, q), n


def test_dmci_megastep_equals_hand_run_steps(harness):
    """make_dmci_megastep(k=2): two dmci_steps on fresh synth_batch frames
    and device_synth QPs, bit for bit, and their mean mse and bpp."""
    torch.set_num_threads(1)
    models = [DMCI(tcfg.DMCIConfig(**RD_TINY_DMCI), device="cpu")
              for _ in range(2)]
    for m in models:
        m.init_(torch.Generator().manual_seed(4))
    sched = rd_tpu.cosine_decay_schedule(1e-3, 4, alpha=0.05)
    txs = [rd_full.dmci_tx(m, sched) for m in models]
    mega = rd_tpu.make_dmci_megastep(models[0], 2, 2, 64, True)
    means = mega(txs[0], rd_tpu.make_keys(6, True))
    keys = rd_tpu.make_keys(6, True)
    rows = []
    for _ in range(2):
        x = rd_tpu.synth_batch(keys.data, batch=2, size=64,
                               seq_len=1)["frames"][:, 0]
        qp = rd_tpu.sample_qp_dev(keys.qp)
        rows.append([float(v) for v in rd_full.dmci_step(
            models[1], txs[1], x, qp, True, keys.noise)])
    np.testing.assert_allclose(means, np.mean(rows, axis=0), rtol=1e-6)
    for (n, p), q in zip(models[0].named_parameters(),
                         models[1].parameters()):
        assert torch.equal(p, q), n


# ------------------------------------------------------- the slice --

RUN_ARGS = ["--device=cpu", "--profile", "tiny", "--lnorm", "--recon-skip",
            "--k", "1", "--dmci-steps", "2", "--steps", "3",
            "--eval-every", "2", "--eval-clips", "2", "--eval-crop", "64",
            "--batch", "2", "--budget-min", "10"]


@pytest.fixture(scope="module")
def rd_run(tmp_path_factory):
    """rd_tpu.main at rd-tiny on the CPU with the smallest sizes (the gate
    after one step, one-step DMCI probes) in a fresh working directory:
    (its results, the directory)."""
    cwd = tmp_path_factory.mktemp("rd_tpu")
    old = os.getcwd()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for name in GLOBALS + ("DEVICE", "GATE_STEP"):
            mp.setattr(rd_full, name, getattr(rd_full, name))
        mp.setattr(rd_full, "GATE_STEP", 1)
        mp.setattr(rd_tpu, "DMCI_PROBE_STEPS", 1)
        mp.setattr(rd_tpu, "ROI_SUBSET", False)
        os.chdir(cwd)
        try:
            res = rd_tpu.main(list(RUN_ARGS))
            paths = {v: rd_full.ckpt_path(v) for v in ("performance",
                                                       "plain")}
            paths["dmci"] = rd_full.dmci_ckpt_path()
        finally:
            os.chdir(old)
    return res, cwd, paths


def test_rd_tpu_writes_the_jax_runners_json(rd_run):
    res, cwd, paths = rd_run
    stored = json.loads((cwd / "artifacts/torch/rd_tpu.json").read_text())
    assert set(stored) == JAX_RD_TPU_KEYS == RD_TPU_KEYS
    assert JAX_VARIANT_KEYS == RD_TPU_VARIANT_KEYS
    for v in ("performance", "plain"):
        assert set(stored["variants"][v]) == JAX_VARIANT_KEYS
        assert stored["variants"][v]["estimated_rd"]["qp"] == rd_full.EVAL_QPS
    assert (stored["profile"], stored["k"], stored["backend"],
            stored["recon_residual"], stored["lambda_normalize"]) == (
        "tiny", 1, "cpu", True, True)
    perf = stored["variants"]["performance"]["estimated_rd"]
    plain = stored["variants"]["plain"]["estimated_rd"]
    for name, fn, key in (("bd_rate_roi_psnr_pct", bd_rate, "roi_psnr"),
                          ("bd_psnr_roi_db", bd_psnr, "roi_psnr"),
                          ("bd_rate_psnr_pct", bd_rate, "psnr"),
                          ("bd_psnr_db", bd_psnr, "psnr")):
        want = fn(plain["bpp"], plain[key], perf["bpp"], perf[key])
        jwant = getattr(jev, fn.__name__)(plain["bpp"], plain[key],
                                          perf["bpp"], perf[key])
        assert stored[name] == pytest.approx(want, nan_ok=True)
        assert stored[name] == pytest.approx(jwant, rel=1e-9, nan_ok=True)
    # the pretrained DMCI is the anchor both variants saved
    dmci = restore_checkpoint(str(cwd / paths["dmci"]))["params_i"]
    for v in ("performance", "plain"):
        ck = restore_checkpoint(str(cwd / paths[v]))
        assert ck["params_i"].keys() == dmci.keys()
        assert all(torch.equal(ck["params_i"][k], t)
                   for k, t in dmci.items())


@pytest.mark.parametrize("variant", ["performance", "plain"])
def test_saved_best_weights_give_the_stored_curve_in_jax(rd_run, variant):
    """The variant's checkpoint (its best params_p, the DMCI anchor) in the
    JAX DMC / DMCI: JAX's evaluate_rd_batched on the pinned eval clips at
    EVAL_QPS equals the curve rd_tpu.json stores."""
    _, cwd, paths = rd_run
    stored = json.loads((cwd / "artifacts/torch/rd_tpu.json").read_text())
    curve = stored["variants"][variant]["estimated_rd"]
    ck = restore_checkpoint(str(cwd / paths[variant]))
    to_jax = lambda sd: jax.tree_util.tree_map(jnp.asarray,
                                               flax_from_state_dict(sd))
    jdmc = JaxDMC(JaxDMCConfig.variant(variant, recon_residual=True,
                                       **MODEL_PROFILES["rd-tiny"]["dmc"]))
    jdmci = JaxDMCI(JaxDMCIConfig(**RD_TINY_DMCI))
    ds = SyntheticClipDataset(num_clips=8, seq_len=4, crop_size=64, seed=777,
                              texture="smooth")
    clips = [ds.__getitem__(i, rng=np.random.default_rng(900 + i))
             for i in range(2)]
    run = jev.make_batched_gop_eval(jdmci, jdmc, tcfg.CompressionConfig()
                                    .index_map, jdmc.cfg.qp_shift, seq_len=4)
    ref = jev.evaluate_rd_batched(run, to_jax(ck["params_i"]),
                                  to_jax(ck["params_p"]), clips,
                                  jax_rd_full.EVAL_QPS, compute_msssim=True)
    assert curve["qp"] == ref["qp"]
    np.testing.assert_allclose(curve["bpp"], ref["bpp"], rtol=5e-3)
    for k in ("psnr", "roi_psnr"):
        np.testing.assert_allclose(curve[k], ref[k], rtol=0, atol=1e-2,
                                   err_msg=k)
    assert curve["msssim"] == ref["msssim"] == [None] * 5     # 64 px


def _rerun(rd_run, tmp_path, monkeypatch, files, extra):
    """rd_tpu.main again in ``tmp_path`` holding ``files`` of the first
    run's artifacts, with --reuse-dmci and ``extra`` flags."""
    _, cwd, paths = rd_run
    (tmp_path / "artifacts" / "torch").mkdir(parents=True)
    for name in files:
        shutil.copyfile(cwd / paths[name], tmp_path / paths[name])
    for name in GLOBALS + ("DEVICE",):
        monkeypatch.setattr(rd_full, name, getattr(rd_full, name))
    monkeypatch.setattr(rd_full, "GATE_STEP", 1)
    monkeypatch.setattr(rd_tpu, "DMCI_PROBE_STEPS", 1)
    monkeypatch.chdir(tmp_path)
    return rd_tpu.main(list(RUN_ARGS) + ["--reuse-dmci"] + extra), paths


def test_rd_tpu_resumes_from_its_checkpoints(rd_run, tmp_path, monkeypatch):
    """A second run over the first's checkpoints: the DMCI reused as saved
    (--reuse-dmci), each variant resumed from its checkpoint (no fresh
    init), the pre-run checkpoint kept as ``.prev``, and the new
    checkpoints anchored on the reused DMCI."""
    _, cwd, paths = rd_run
    monkeypatch.setattr(rd_tpu, "_fresh_init_with_gate", lambda *a, **k:
                        pytest.fail("a fresh init on resume"))
    res, _ = _rerun(rd_run, tmp_path, monkeypatch,
                    ("dmci", "performance", "plain"), [])
    dmci = restore_checkpoint(paths["dmci"])["params_i"]
    first_dmci = restore_checkpoint(str(cwd / paths["dmci"]))["params_i"]
    assert all(torch.equal(dmci[k], t) for k, t in first_dmci.items())
    for v in ("performance", "plain"):
        assert "estimated_rd" in res["variants"][v]
        prev = restore_checkpoint(paths[v] + ".prev")
        first = restore_checkpoint(str(cwd / paths[v]))
        for part in ("params_p", "params_i"):
            assert all(torch.equal(prev[part][k], t)
                       for k, t in first[part].items())
        new = restore_checkpoint(paths[v])
        assert all(torch.equal(new["params_i"][k], t)
                   for k, t in dmci.items())


def test_rd_tpu_restores_on_divergence(rd_run, tmp_path, monkeypatch,
                                       capsys):
    """A mega-step whose PSNR comes back NaN restarts the variant from its
    last weights with a fresh optimizer (no eval has kept a best yet), and
    the run goes on to its curve."""
    real = rd_tpu.make_dmc_megastep
    inits = []

    def make(trainer, *a):
        mega, calls = real(trainer, *a), []
        init_state = trainer.init_state

        def counted(*args, **kw):
            inits.append(kw.get("params_p") is not None)
            return init_state(*args, **kw)

        trainer.init_state = counted

        def call(state, keys):
            calls.append(1)
            state, (loss, bpp, psnr) = mega(state, keys)
            return state, (loss, bpp, float("nan") if len(calls) == 2
                           else psnr)
        return call

    monkeypatch.setattr(rd_tpu, "make_dmc_megastep", make)
    res, _ = _rerun(rd_run, tmp_path, monkeypatch, ("dmci",),
                    ["--variants", "performance"])
    out = capsys.readouterr().out
    assert "[performance] DIVERGED at step 2 (nan dB" in out
    assert "restoring last params" in out
    assert inits == [False, True]       # the fresh init, then the restore
    curve = res["variants"]["performance"]["estimated_rd"]
    assert all(np.isfinite(curve["bpp"] + curve["psnr"]))
