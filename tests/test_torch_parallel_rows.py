"""The port's row-sharded P-frame (parallel/spatial.py) over 2 ranks on the
CPU over gloo, against the JAX package's unsharded forward and the port's:
the uneven slabs, every other variant and int8 modes 1 and 2, each run of
one 2-rank spawn (rows2_seen).
Tolerances (MESH_TOL) and helpers are test_torch_parallel.py's."""

import contextlib
import warnings

import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from ssgvc_tpu.layers import blocks as jb
from ssgvc_tpu_torch.config import DMCConfig
from ssgvc_tpu_torch.layers import blocks as pb
from ssgvc_tpu_torch.models.dmc import DMC
from ssgvc_tpu_torch.utils.weights import load_flax_params
from test_torch_parallel import (_check_gop, _check_uneven, _jax_gop,
                                 _pframe_case, _port_gop, _spawn)
from torch_port_helpers import TINY
from torch_port_helpers import one_torch_thread  # noqa: F401

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
#: 192 rows (units 128 + 64 against the even 96 + 96), a GOP of 2; 208
#: rows (3 units and 16 rows: 128 + 80 against 104 + 104; the fast
#: variant, since the performance variant refuses an H whose y rows are
#: not a multiple of 4 in both packages) and 64 rows (one unit for two
#: ranks: 64 + 0 against 32 + 32), a GOP of 2 each; each other variant at
#: 128 rows, one frame; the performance frame in int8 modes 1 and 2
ROWS2_RUNS = (("uneven", "performance", 192, 2, "0"),
              ("ragged", "fast", 208, 2, "0"),
              ("one_unit", "performance", 64, 2, "0"),
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


#: the 2-rank cases of test_uneven_slabs_match_jax, by their run
ROWS2_BY_H = {192: "uneven", 208: "ragged", 64: "one_unit"}


@pytest.mark.parametrize("h,n", [(192, 2), (208, 2), (64, 2)])
def test_uneven_slabs_match_jax(h, n, rows2_seen):
    """H = 192 over 2 ranks (3 units: slabs of 128 and 64 rows against the
    even 96), 208 over 2 (3 units and 16 rows: 128 and 80 against 104, the
    partial unit on the last slab; the fast variant) and 64 over 2 (one
    unit for two ranks: 64 and an empty slab against 32): the even slabs
    in and out, each rank's unit slab, the rows moved between ranks, the
    gathered DPB and bpp of a 2-frame GOP against the JAX package's
    unsharded forward and the port's, equal on both ranks bit for bit
    (_check_uneven). 320 over 4 ranks is test_torch_parallel_mesh.py's
    case of the same test."""
    seen, case = _run(rows2_seen, ROWS2_BY_H[h])
    _check_uneven(seen, case, case["refs"], h, n)


@pytest.mark.parametrize("variant", ["old", "fast", "mask_prop"])
def test_every_variant_under_a_row_shard_matches_jax(variant, rows2_seen):
    """The variants the 2-rank frame test leaves out, one frame of 128
    rows over 2 ranks (mask_prop's predictor resizes its slab with the
    resize's reach of the neighbours' rows): the gathered DPB and bpp
    against the JAX package's unsharded forward and the port's."""
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
