"""The port's row-sharded P-frame over 4 ranks on the CPU over gloo,
against the JAX package's unsharded forward and the port's: the uneven
slabs of 320 rows over 4 ranks, and the 2 x 2 data x spatial mesh (the
plain variant; the uneven slabs). Tolerances (MESH_TOL) and helpers are
test_torch_parallel.py's."""

import pytest

import _torch_dist_worker as worker
from test_torch_parallel import (_check_gop, _check_uneven, _jax_gop,
                                 _pframe_case, _port_gop, _spawn)
from torch_port_helpers import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("h,n", [(320, 4)])
def test_uneven_slabs_match_jax(h, n, tmp_path):
    """H = 320 over 4 ranks (5 units: 64, 128, 64, 64 against 80 each): the
    even slabs in and out, each rank's unit slab, the rows moved between
    ranks, the gathered DPB and bpp of a 2-frame GOP against the JAX
    package's unsharded forward and the port's, equal on every rank bit
    for bit (_check_uneven). The cases over 2 ranks are in
    test_torch_parallel_rows.py."""
    case = _pframe_case("performance", 1, h, 64, 2, spatial_n=n, seed=20)
    seen = _spawn(worker.pframe_rows, n, tmp_path, case)
    args = (case["params"], case["frames"], case["masks"], case["dpb"], 32)
    _check_uneven(seen, case, {"JAX": _jax_gop("performance", *args),
                               "port": _port_gop("performance", *args)},
                  h, n)


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
