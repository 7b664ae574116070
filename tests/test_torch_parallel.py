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
device's on the same weights and noise. This file's tolerances and helpers
serve its siblings, which split the spawns so that no one test process
holds them all: test_torch_parallel_rows.py (the 2-rank row-shard runs of
one spawn), test_torch_parallel_mesh.py (4 ranks) and
test_torch_parallel_dp.py (the data-parallel steps, the calibration).

Tolerances: the row-sharded P-frame against the JAX forward and the port's
unsharded one at tests/test_mesh.py's (bpp rtol 3e-4 / atol 1e-5, frame
rtol 2e-5 / atol 1e-4, feature rtol 2e-5 / atol 2e-4), on drawn weights;
the data-parallel gradient within DP_GRAD_TOL of its norm of one device's
on the global batch, and against that and the JAX gradient by
test_torch_training's GRAD_TENSOR_TOL rule per tensor; the reduced losses
at rtol 1e-6; gains and ALM state at rtol 1e-5 (one device's calibration
sums in another order); across ranks, bit for bit.
"""

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax.numpy as jnp

import _torch_dist_worker as worker
from chip_smoke import DMC_HEADS
from ssgvc_tpu.config import DMCConfig as JaxDMCConfig
from ssgvc_tpu.models.dmc import DMC as JaxDMC
from ssgvc_tpu_torch.config import DMCConfig
from ssgvc_tpu_torch.models.dmc import DMC
from ssgvc_tpu_torch.parallel import mesh as mesh_mod
from ssgvc_tpu_torch.parallel import spatial
from ssgvc_tpu_torch.utils.weights import load_flax_params
from torch_port_helpers import TINY, drawn_params
from torch_port_helpers import one_torch_thread  # noqa: F401

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


def test_row_shard_takes_every_h_the_jax_rule_takes():
    """The row shard's partition of H into unit slabs, and its one refusal.
    Every boundary but the last is on a whole 64-pixel-row unit; an H that
    is not whole units leaves the partial unit on the last slab that holds
    rows, beside a whole one (208 rows over 2: 128 + 80); with fewer units
    than ranks some slabs are empty (64 rows over 2: 64 + 0; 128 over 4:
    64, 0, 64, 0). The one refusal left is the JAX package's rule
    (ssgvc_tpu/parallel/spatial.py:16-18): slabs of H / n rows that are
    not a multiple of 8 pixel rows (200 over 2: 100 each), or rows that do
    not split evenly. mask_prop under a world-1 row shard equals its
    unsharded forward bit for bit."""
    assert spatial.unit_bounds(208, 2, 64) == [0, 128, 208]
    assert spatial.unit_bounds(64, 2, 64) == [0, 64, 64]
    assert spatial.unit_bounds(128, 4, 64) == [0, 64, 64, 128, 128]
    # packed rows (units of 8): 720 over 2 and 1440 over 4
    assert spatial.unit_bounds(90, 2, 8) == [0, 48, 90]
    assert spatial.unit_bounds(180, 4, 8) == [0, 48, 88, 136, 180]
    # below one unit the whole frame is the last rank's
    assert spatial.unit_bounds(48, 2, 64) == [0, 0, 48]
    for rows, n in ((200, 2), (96, 8), (100, 4), (65, 1)):
        jax_takes = rows % n == 0 and (rows // n) % 8 == 0
        assert not jax_takes
        with pytest.raises(ValueError, match="multiple of 8 pixel rows"):
            spatial.unit_bounds(rows, n, 64)
    for rows, n in ((96, 2), (208, 2), (64, 2), (720, 2), (1440, 4),
                    (192, 8), (24, 3), (1088, 8)):
        b = spatial.unit_bounds(rows, n, 64)
        assert b[0] == 0 and b[-1] == rows and b == sorted(b)
        assert all(x % 64 == 0 for x in b[:-1])
        last = max(i for i in range(n) if b[i + 1] > b[i])
        # the last slab with rows holds the partial unit beside a whole one
        if rows % 64 and rows > 64:
            assert b[last + 1] - b[last] > 64
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


def _check_uneven(seen, case, refs, h, n):
    """What each of ``n`` ranks saw of a row-sharded GOP of ``h`` rows on
    whole 64-row units: the even slabs in and out, each rank's unit slab,
    the rows moved between ranks where a boundary moved, the gathered DPB
    and bpp against ``refs``, equal on every rank bit for bit."""
    units = spatial.unit_bounds(h, n, 64)
    assert len(case["frames"]) == 2
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
