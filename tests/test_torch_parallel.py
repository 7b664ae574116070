"""The port's parallel/ (data-parallel training over torch.distributed, the
row-sharded P-frame) and graft_entry.dryrun_multichip, on the CPU over gloo,
against the JAX package.

The JAX side's reference is its unsharded ``model.apply`` (tests/test_mesh.py
holds the JAX package's own sharded path against that), its gop_loss
gradient on the global batch, and one device's calibration; the weights go
across through utils/weights.py. The ranks run in processes spawned from
tests/_torch_dist_worker.py (no JAX there), one spawn a case (the video
trainer's and the image CLI's data-parallel steps share one), a file
rendezvous under the test's tmp_path. The image CLI's step is held to one
device's on the same weights and noise.

Tolerances: the row-sharded P-frame against the JAX forward and the port's
unsharded one at tests/test_mesh.py's (bpp rtol 3e-4 / atol 1e-5, frame
rtol 2e-5 / atol 1e-4, feature rtol 2e-5 / atol 2e-4), on drawn weights;
the data-parallel gradient within DP_GRAD_TOL of its norm of one device's
on the global batch, and against that and the JAX gradient by
test_torch_training's GRAD_TENSOR_TOL rule per tensor; the reduced losses
at rtol 1e-6; gains and ALM state at rtol 1e-5 (one device's calibration
sums in another order); across ranks, bit for bit.
"""

import contextlib
import functools
import warnings

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

import _torch_dist_worker as worker
from chip_smoke import DMC_HEADS, DMCI_HEADS
from ssgvc_tpu import config as jcfg
from ssgvc_tpu.config import DMCConfig as JaxDMCConfig
from ssgvc_tpu.layers import blocks as jb
from ssgvc_tpu.models.dmc import DMC as JaxDMC
from ssgvc_tpu.training.trainer import Trainer as JaxTrainer
from ssgvc_tpu_torch import trainer_image_model as image_cli
from ssgvc_tpu_torch.config import (CompressionConfig, DMCConfig,
                                    DMCIConfig, TrainConfig)
from ssgvc_tpu_torch.data.device_synth import synth_batch
from ssgvc_tpu_torch.layers import blocks as pb
from ssgvc_tpu_torch.models.dmc import DMC
from ssgvc_tpu_torch.models.dmci import DMCI
from ssgvc_tpu_torch.parallel import mesh as mesh_mod
from ssgvc_tpu_torch.parallel import spatial
from ssgvc_tpu_torch.training.loss import psnr_from_mse
from ssgvc_tpu_torch.training.trainer import NOISE_SEED_STRIDE, Trainer
from ssgvc_tpu_torch.utils.weights import (flatten, flax_from_state_dict,
                                           load_flax_params)
from test_torch_training import GRAD_TENSOR_TOL
from torch_port_helpers import DMCI_TINY, TINY, drawn_params

TINY_DMCI = functools.partial(DMCIConfig, **DMCI_TINY)

# The whole data-parallel gradient against one device's on the global
# batch. One device's own gradient moves by 1.6e-5 of its norm between one
# and eight CPU threads (another summation order), and the data-parallel
# one sat 4.1e-5 from it, almost all of it in the prior branch
# (y_prior_fusion, ~9e-4 of each tensor's norm: the rate's sigma
# derivative, test_torch_training's GRAD_TENSOR_TOL note); every other
# tensor within ~2e-6 of its own.
DP_GRAD_TOL = 1e-4
MESH_TOL = {"bpp": dict(rtol=3e-4, atol=1e-5),
            "frame": dict(rtol=2e-5, atol=1e-4),
            "feature": dict(rtol=2e-5, atol=2e-4)}


def _spawn(fn, world, tmp_path, case):
    out = tmp_path / "out"
    out.mkdir()
    mp.spawn(fn, args=(world, str(tmp_path / "rdzv"), str(out), case),
             nprocs=world, join=True)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# ------------------------------------------------------- single process --

def test_make_mesh_is_world_1_without_a_process_group():
    m = mesh_mod.make_mesh()
    assert m.size == 1 and m.shape == {"data": 1}
    assert m.group("data") is None and m.index("data") == 0
    assert mesh_mod.make_mesh(1).size == 1
    batch = {"frames": np.zeros((2, 3, 8, 8, 3), np.float32)}
    local = mesh_mod.shard_batch(mesh_mod.make_mesh(device="cpu"), batch)
    assert local["frames"].shape == (2, 3, 8, 8, 3)
    assert torch.is_tensor(local["frames"])
    m2 = mesh_mod.make_mesh(axis_names=("data", "spatial"), spatial=1,
                            device="cpu")
    assert m2.shape == {"data": 1, "spatial": 1}


def test_make_mesh_rejects_too_many_devices():
    with pytest.raises(ValueError, match="requested but only"):
        mesh_mod.make_mesh(2)


def test_make_mesh_2d_validates_divisibility():
    with pytest.raises(ValueError, match="must divide"):
        mesh_mod.make_mesh(axis_names=("data", "spatial"), spatial=2)


def test_maybe_init_distributed_is_a_no_op_without_env(monkeypatch):
    for k in ("SSGVC_DIST", "WORLD_SIZE", "SLURM_NTASKS"):
        monkeypatch.delenv(k, raising=False)
    assert mesh_mod.maybe_init_distributed() is False
    assert not torch.distributed.is_initialized()


def test_collectives_do_nothing_on_a_world_1_mesh():
    t = torch.arange(4.0)
    mesh_mod.all_reduce_mean_([t], None)
    mesh_mod.broadcast_([t], None)
    assert torch.equal(t, torch.arange(4.0))
    assert mesh_mod.group_sum(t, None) is t
    assert mesh_mod.all_gather_cat(t, None) is t
    assert spatial.current() is None


def test_slab_rule_and_mask_prop_refuse_a_row_shard():
    """What the row shard still refuses: an H that is not whole 64-pixel-
    row units, or fewer units than ranks (a ValueError naming the case).
    The slab rule itself is gone: any even split of whole units runs, on
    slabs of whole units (1088 rows over 2, 4 and 8 ranks below).
    mask_prop no longer refuses: under a
    world-1 row shard it equals its unsharded forward bit for bit."""
    with pytest.raises(ValueError, match="multiple of 64 pixel rows"):
        spatial.unit_bounds(96, 2, 64)
    with pytest.raises(ValueError, match="each rank needs at least one"):
        spatial.unit_bounds(64, 2, 64)
    want = {2: [576, 512], 4: [256, 320, 256, 256],
            8: [128, 128, 128, 192, 128, 128, 128, 128]}
    for n, slabs in want.items():
        b = spatial.unit_bounds(1088, n, 64)
        assert [b[i + 1] - b[i] for i in range(n)] == slabs
        even = 1088 // n
        # every boundary within a neighbour's slab of the even one
        assert all(abs(b[i] - i * even) < even for i in range(n + 1))
        assert spatial.unit_bounds(1088 // 8, n, 8) == [x // 8 for x in b]
    m = mesh_mod.make_mesh(device="cpu")
    prop = DMC(DMCConfig.variant("mask_prop", **TINY), device="cpu")
    drawn_params(prop, 2, DMC_HEADS)
    rng = np.random.default_rng(2)
    u = lambda *s: torch.from_numpy(rng.uniform(0, 1, s).astype(np.float32))
    x, mask = u(1, 128, 64, 3), (u(1, 128, 64, 1) > 0.7).float()
    dpb = {"frame": u(1, 128, 64, 3), "feature": u(1, 16, 8, 16) * 0.1}
    new_dpb, bpp = spatial.spatial_pframe(prop, m)(None, x, mask, 20, dpb)
    with torch.no_grad():
        ref = prop(x, 20, dpb, after_i=False, mask=mask)
    for k in ("frame", "feature"):
        assert torch.equal(new_dpb[k], ref["dpb"][k]), k
    assert torch.equal(bpp, ref["bpp"])


# ------------------------------------------------- the row-sharded frame --

def _jax_gop(variant, params, frames, masks, dpb, qp):
    model = JaxDMC(JaxDMCConfig.variant(variant, **TINY))
    out = []
    d = {k: jnp.asarray(v) for k, v in dpb.items()}
    for x, m in zip(frames, masks):
        r = model.apply({"params": params}, jnp.asarray(x), jnp.int32(qp), d,
                        after_i=False, mask=jnp.asarray(m), train=False)
        d = r["dpb"]
        out.append({"frame": np.asarray(d["frame"]),
                    "feature": np.asarray(d["feature"]),
                    "bpp": np.asarray(r["bpp"])})
    return out


def _port_gop(variant, params, frames, masks, dpb, qp):
    model = DMC(DMCConfig.variant(variant, **TINY), device="cpu")
    load_flax_params(model, params).eval()
    t = lambda a: torch.from_numpy(np.asarray(a))
    d = {k: t(v) for k, v in dpb.items()}
    out = []
    with torch.no_grad():
        for x, m in zip(frames, masks):
            r = model(t(x), qp, d, after_i=False, mask=t(m))
            d = r["dpb"]
            out.append({"frame": d["frame"].numpy(),
                        "feature": d["feature"].numpy(),
                        "bpp": r["bpp"].numpy()})
    return out


def _check_gop(got, refs):
    for i, frame in enumerate(got):
        for what, ref in refs.items():
            for k, tol in MESH_TOL.items():
                np.testing.assert_allclose(
                    frame[k], ref[i][k], **tol,
                    err_msg=f"frame {i} {k} against {what}")


def _pframe_case(variant, b, h, w, frames, spatial_n, seed=0):
    """test_mesh.py's inputs (uniform frames, masks > 0.7, feature N(0,
    0.1)), ``frames`` P-frames of them, on weights drawn as the smoke draws
    them (``drawn_params``: the prior heads at 0.01, so the rate estimate
    is not dominated by tail symbols, whose bits a 1-ulp change of sigma
    moves by a percent)."""
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(0, 1, s).astype(np.float32)
    xs = [u(b, h, w, 3) for _ in range(frames)]
    ms = [(u(b, h, w, 1) > 0.7).astype(np.float32) for _ in range(frames)]
    dpb = {"frame": u(b, h, w, 3),
           "feature": (rng.standard_normal((b, h // 8, w // 8, TINY["ch_d"]))
                       * 0.1).astype(np.float32)}
    params = drawn_params(DMC(DMCConfig.variant(variant, **TINY),
                              device="cpu"), seed, DMC_HEADS)
    return dict(variant=variant, widths=TINY, params=params, frames=xs,
                masks=ms, dpb=dpb, qp=32, spatial=spatial_n)


def test_row_sharded_pframe_on_two_ranks_matches_jax(tmp_path):
    """The performance P-frame, h = 128 split over 2 ranks, a GOP of 3
    frames carrying the sharded DPB: each rank's slab and row offset, the
    gathered DPB and bpp against the JAX package's unsharded forward and
    the port's."""
    case = _pframe_case("performance", 1, 128, 64, 3, spatial_n=2)
    seen = _spawn(worker.pframe_rows, 2, tmp_path, case)
    for r, s in enumerate(seen):
        assert s["rows"] == (64 * r, 64 * (r + 1))
        assert s["feature_rows"] == (8 * r, 8 * (r + 1))
        assert s["slab_shapes"] == {"frame": (1, 64, 64, 3),
                                    "feature": (1, 8, 8, 16)}
    for i in range(3):
        for k in ("frame", "feature", "bpp"):
            np.testing.assert_array_equal(seen[0]["frames"][i][k],
                                          seen[1]["frames"][i][k])
    args = (case["params"], case["frames"], case["masks"], case["dpb"], 32)
    _check_gop(seen[0]["frames"], {"JAX": _jax_gop("performance", *args),
                                   "port": _port_gop("performance", *args)})


def test_row_sharded_plain_pframe_on_a_data_x_spatial_mesh(tmp_path):
    """The plain variant on a 2 x 2 data x spatial mesh (b = 2 over data,
    h = 128 over spatial), one frame as tests/test_mesh.py's: per-sample
    bpp and the DPB against one device's."""
    case = _pframe_case("plain", 2, 128, 32, 1, spatial_n=2, seed=1)
    seen = _spawn(worker.pframe_rows, 4, tmp_path, case)
    for r, s in enumerate(seen):
        d, sp = divmod(r, 2)
        assert s["batch"] == (d, d + 1)
        assert s["rows"] == (64 * sp, 64 * (sp + 1))
        assert s["slab_shapes"]["frame"] == (1, 64, 32, 3)
        assert s["frames"][0]["bpp"].shape == (2,)
    args = (case["params"], case["frames"], case["masks"], case["dpb"], 32)
    _check_gop(seen[0]["frames"], {"JAX": _jax_gop("plain", *args),
                                   "port": _port_gop("plain", *args)})


def _int8_scales(params, case):
    """Mode 2's scales: the port's unsharded calibration on the case's
    first frame (collected as the JAX package collects them)."""
    model = DMC(DMCConfig.variant(case["variant"], **TINY), device="cpu")
    load_flax_params(model, params).eval()
    t = lambda a: torch.from_numpy(np.asarray(a))
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setenv("SSGVC_INT8", "2")
        saved = dict(pb._INT8_SCALES)
        pb.set_int8_scales({})
        with warnings.catch_warnings(), pb.int8_calibration() as calib:
            warnings.simplefilter("ignore")
            model(t(case["frames"][0]), case["qp"],
                  {k: t(v) for k, v in case["dpb"].items()},
                  after_i=False, mask=t(case["masks"][0]))
        pb.set_int8_scales(saved)
    return pb.collect_int8_scales(calib)


@contextlib.contextmanager
def _int8_env(mode, scales):
    """Both packages in SSGVC_INT8 ``mode`` with ``scales`` installed."""
    saved = (dict(jb._INT8_SCALES), set(jb._INT8_BAKED),
             dict(pb._INT8_SCALES))
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mp.setenv("SSGVC_INT8", mode)
        jb._INT8_SCALES.clear()
        jb._INT8_BAKED.clear()
        jb._INT8_SCALES.update(scales)
        pb.set_int8_scales(scales)
        try:
            yield
        finally:
            for table, old in zip((jb._INT8_SCALES, jb._INT8_BAKED,
                                   pb._INT8_SCALES), saved):
                table.clear()
                table.update(old)


#: the 2-rank runs of one spawn (:func:`rows2_seen`): the uneven slabs of
#: 192 rows (units 128 + 64 against the even 96 + 96), a GOP of 2; each
#: other variant at 128 rows, one frame; the performance frame in int8
#: modes 1 and 2
ROWS2_RUNS = (("uneven", "performance", 192, 2, "0"),
              ("old", "old", 128, 1, "0"), ("fast", "fast", 128, 1, "0"),
              ("mask_prop", "mask_prop", 128, 1, "0"),
              ("int8_mode1", "performance", 128, 1, "1"),
              ("int8_mode2", "performance", 128, 1, "2"))
#: int8 frames: tests/test_torch_experiments.py's bound for a whole int8
#: frame against JAX (one flipped rounding moves an int8 value a step)
INT8_TOL = {"frame": dict(atol=1e-4, rtol=0), "feature": dict(atol=1e-4,
                                                               rtol=0),
            "bpp": dict(rtol=5e-3, atol=0)}


@pytest.fixture(scope="module")
def rows2_seen(tmp_path_factory):
    """One 2-rank spawn of ``worker.pframe_rows`` over ROWS2_RUNS; returns
    (what each rank saw, the runs with their references: the JAX
    package's unsharded forward and the port's, in the run's int8
    mode)."""
    torch.set_num_threads(1)
    runs = []
    for i, (name, variant, h, frames, mode) in enumerate(ROWS2_RUNS):
        case = _pframe_case(variant, 1, h, 64, frames, spatial_n=2,
                            seed=10 + i)
        case.update(name=name, int8=mode)
        case["scales"] = (_int8_scales(case["params"], case)
                          if mode == "2" else {})
        args = (case["params"], case["frames"], case["masks"], case["dpb"],
                case["qp"])
        with _int8_env(mode, case["scales"]):
            case["refs"] = {"JAX": _jax_gop(variant, *args),
                            "port": _port_gop(variant, *args)}
        runs.append(case)
    seen = _spawn(worker.pframe_rows, 2, tmp_path_factory.mktemp("rows2"),
                  {"spatial": 2, "runs": runs})
    return seen, runs


def _run(rows2_seen, name):
    seen, runs = rows2_seen
    j = [r["name"] for r in runs].index(name)
    return [s["runs"][j] for s in seen], runs[j]


@pytest.mark.parametrize("h,n", [(192, 2), (320, 4)])
def test_uneven_slabs_match_jax(h, n, rows2_seen, tmp_path):
    """H = 192 over 2 ranks (3 units: slabs of 128 and 64 rows against the
    even 96) and 320 over 4 (5 units: 64, 128, 64, 64 against 80 each):
    the even slabs in and out, each rank's unit slab, the rows moved
    between neighbours, the gathered DPB and bpp of a 2-frame GOP against
    the JAX package's unsharded forward and the port's."""
    if n == 2:
        seen, case = _run(rows2_seen, "uneven")
        refs = case["refs"]
    else:
        case = _pframe_case("performance", 1, h, 64, 2, spatial_n=n,
                            seed=20)
        seen = _spawn(worker.pframe_rows, n, tmp_path, case)
        args = (case["params"], case["frames"], case["masks"], case["dpb"],
                32)
        refs = {"JAX": _jax_gop("performance", *args),
                "port": _port_gop("performance", *args)}
    units = spatial.unit_bounds(h, n, 64)
    even = h // n
    for r, s in enumerate(seen):
        assert s["rows"] == (even * r, even * (r + 1))
        assert s["unit_rows"] == (units[r], units[r + 1])
        assert s["slab_shapes"]["frame"] == (1, even, 64, 3)
        for f in s["frames"]:
            # the new DPB back in the even partition
            assert f["slab_shapes"] == {"frame": (1, even, 64, 3),
                                        "feature": (1, even // 8, 8, 16)}
            # rows go between neighbours where a boundary moved
            moved = any(units[i] != even * i for i in (r, r + 1))
            assert (f["move_bytes"] > 0) == moved
        for i in range(len(case["frames"])):
            for k in ("frame", "feature", "bpp"):
                np.testing.assert_array_equal(s["frames"][i][k],
                                              seen[0]["frames"][i][k])
    _check_gop(seen[0]["frames"], refs)


def test_uneven_slabs_on_a_data_x_spatial_mesh(tmp_path):
    """The uneven slabs on a 2 x 2 data x spatial mesh: b = 2 over data,
    h = 192 over spatial (units of 128 and 64 rows against the even 96),
    the performance variant, one frame: per-sample bpp and the DPB against
    the JAX package's unsharded forward and the port's."""
    case = _pframe_case("performance", 2, 192, 64, 1, spatial_n=2, seed=21)
    seen = _spawn(worker.pframe_rows, 4, tmp_path, case)
    for r, s in enumerate(seen):
        d, sp = divmod(r, 2)
        assert s["batch"] == (d, d + 1)
        assert s["rows"] == (96 * sp, 96 * (sp + 1))
        assert s["unit_rows"] == ((0, 128), (128, 192))[sp]
        assert s["frames"][0]["bpp"].shape == (2,)
    args = (case["params"], case["frames"], case["masks"], case["dpb"], 32)
    _check_gop(seen[0]["frames"], {"JAX": _jax_gop("performance", *args),
                                   "port": _port_gop("performance", *args)})


@pytest.mark.parametrize("variant", ["old", "fast", "mask_prop"])
def test_every_variant_under_a_row_shard_matches_jax(variant, rows2_seen):
    """The variants PR-17's tests left out, one frame of 128 rows over 2
    ranks (mask_prop's predictor resizes its slab with the resize's reach
    of the neighbours' rows): the gathered DPB and bpp against the JAX
    package's unsharded forward and the port's."""
    seen, case = _run(rows2_seen, variant)
    np.testing.assert_array_equal(seen[0]["frames"][0]["frame"],
                                  seen[1]["frames"][0]["frame"])
    _check_gop(seen[0]["frames"], case["refs"])


@pytest.mark.parametrize("mode", ["1", "2"])
def test_int8_under_a_row_shard_matches_one_device(mode, rows2_seen):
    """SSGVC_INT8 under the 2-rank row shard (mode 1's abs-max the frame's,
    over both slabs; mode 2 on scales calibrated unsharded): the gathered
    DPB and bpp against the port's unsharded int8 frame (MESH_TOL) and
    against the JAX package's (INT8_TOL, the int8 frame's bound)."""
    seen, case = _run(rows2_seen, f"int8_mode{mode}")
    if mode == "2":
        assert len(case["scales"]) > 50
    got = seen[0]["frames"]
    _check_gop(got, {"port": case["refs"]["port"]})
    for k, tol in INT8_TOL.items():
        np.testing.assert_allclose(got[0][k], case["refs"]["JAX"][0][k],
                                   **tol, err_msg=k)


# --------------------------------------------------------- data parallel --

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


# ----------------------------------------------------------- the dry run --

def test_dryrun_multichip_on_two_cpu_ranks_and_no_card(capfd):
    from ssgvc_tpu_torch.graft_entry import dryrun_multichip

    dryrun_multichip(2, device="cpu")
    out = capfd.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("dryrun_multichip")]
    assert len(line) == 1 and line[0].startswith(
        "dryrun_multichip ok: 2 devices, loss="), out
    loss = float(line[0].split("loss=")[1].split(",")[0])
    bpp = float(line[0].split("spatial_bpp=")[1])
    assert np.isfinite(loss) and np.isfinite(bpp)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            dryrun_multichip(2)
