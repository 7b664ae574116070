"""The port's utils/debug.py, utils/profiling.py and the scale-table helpers
of models/entropy.py against the JAX package's, on the same inputs.

Tolerances: ``tree_stats``, ``param_summary``, ``dump_bad_batch``,
``DebugProbe``'s and ``finite_check``'s messages are exact (the same numpy
code on the same arrays, or the same strings); ``tree_norm`` rtol 1e-6
(each leaf's fp32 sum of squares in torch's order against XLA's);
``layer_forensics``'s shared modules rtol 1e-4 in norm and max |.| (fp32
forward passes of two packages; measured <= 1.1e-7); the scale table
within 1 ulp of XLA's (its line is ``jnp.linspace``'s bit for bit, its exp
torch's); the scale indexes exact.
"""

import io
import math
from contextlib import redirect_stdout
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssgvc_tpu.models import entropy as jentropy
from ssgvc_tpu.utils import debug as jdebug
from ssgvc_tpu.utils import profiling as jprof
from ssgvc_tpu_torch.models import entropy as tentropy
from ssgvc_tpu_torch.utils import debug as tdebug
from ssgvc_tpu_torch.utils import profiling as tprof
from ssgvc_tpu_torch.utils.weights import flax_from_state_dict

from torch_port_helpers import TINY, tiny_params
from torch_port_helpers import one_torch_thread  # noqa: F401


@lru_cache(maxsize=1)
def tiny():
    """(JAX tiny DMC, its params, the port's DMC holding them)."""
    from ssgvc_tpu_torch.config import DMCConfig
    from ssgvc_tpu_torch.models.dmc import DMC
    from ssgvc_tpu_torch.utils.weights import load_flax_params

    jm, p, _ = tiny_params()
    port = load_flax_params(DMC(DMCConfig.variant("performance", **TINY),
                                device="cpu"), p).eval()
    return jm, p, port


def inputs(seed=0, hw=64):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (1, hw, hw, 3)).astype(np.float32)
    m = (rng.uniform(0, 1, (1, hw, hw, 1)) > 0.5).astype(np.float32)
    f = rng.uniform(0, 1, (1, hw, hw, 3)).astype(np.float32)
    g = rng.standard_normal((1, hw // 8, hw // 8, TINY["ch_d"])).astype(
        np.float32)
    return x, m, f, g


def named_grads(port, seed=5):
    """Gradient-like named tensors of the port's parameters, a few of them
    non-finite."""
    rng = np.random.default_rng(seed)
    grads = {n: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(
        np.float32)) for n, p in port.named_parameters()}
    bad = "encoder.conv2_0.dc_0.weight"
    grads[bad].view(-1)[:3] = torch.tensor([float("nan"), float("inf"), 7.0])
    return grads


@pytest.mark.parametrize("which", ["module", "state_dict", "grads"])
def test_tree_norm_and_stats_match_jax(which):
    _, p, port = tiny()
    if which == "module":
        tree, ref = port, p
    elif which == "state_dict":
        tree, ref = port.state_dict(), p
    else:
        tree = named_grads(port)
        ref = flax_from_state_dict(tree)
    got = tdebug.tree_stats(tree, top_k=10 ** 6)
    want = jdebug.tree_stats(ref, top_k=10 ** 6)
    assert list(got) == list(want)
    np.testing.assert_equal(got, want)          # NaN equal to NaN
    assert list(tdebug.tree_stats(tree, top_k=4)) == list(want)[:4]
    if which == "grads":
        assert got["encoder/conv2_0/dc_0/kernel"]["nonfinite"] == 2
        assert math.isnan(tdebug.tree_norm(tree))
        assert math.isnan(jdebug.tree_norm(ref))
    else:
        np.testing.assert_allclose(tdebug.tree_norm(tree),
                                   jdebug.tree_norm(ref), rtol=1e-6)


@pytest.mark.parametrize("max_depth", [1, 2, 3])
def test_param_summary_equals_jax_string(max_depth):
    _, p, port = tiny()
    want = jprof.param_summary(p, max_depth=max_depth)
    assert tprof.param_summary(port, max_depth=max_depth) == want
    assert tprof.param_summary(port.state_dict(), max_depth=max_depth) == want
    assert tprof.param_summary(p, max_depth=max_depth) == want


def test_dump_bad_batch_writes_the_jax_file(tmp_path):
    rng = np.random.default_rng(2)
    frames = rng.standard_normal((2, 3, 8, 8, 3)).astype(np.float32)
    masks = (rng.uniform(size=(2, 3, 8, 8, 1)) > 0.5).astype(np.float32)
    metrics = {"loss": float("nan"), "bpp": 0.25, "hist": [1.0, 2.0]}
    pj = jdebug.dump_bad_batch(str(tmp_path / "j"),
                               {"frames": jnp.asarray(frames),
                                "masks": jnp.asarray(masks)}, metrics, 7)
    pt = tdebug.dump_bad_batch(str(tmp_path / "t"),
                               {"frames": torch.from_numpy(frames),
                                "masks": torch.from_numpy(masks)},
                               {k: (torch.tensor(v) if k == "bpp" else v)
                                for k, v in metrics.items()}, 7)
    assert pt.split("/")[-1] == pj.split("/")[-1] == "bad_batch_step7.npz"
    with np.load(pj) as a, np.load(pt) as b:
        assert sorted(a.files) == sorted(b.files) == [
            "frames", "masks", "metric_bpp", "metric_loss"]
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def run_probe(mod, tmp, metrics, grads, steps=1, **kw):
    probe = mod.DebugProbe(enabled=True, save_dir=str(tmp), **kw)
    out = io.StringIO()
    with redirect_stdout(out):
        oks = [probe.after_step({"x": np.zeros(2, np.float32)}, metrics,
                                grads) for _ in range(steps)]
    return oks, out.getvalue().replace(str(tmp), "DIR")


def test_debug_probe_messages_match_jax(tmp_path):
    _, _, port = tiny()
    grads = named_grads(port)
    ref = flax_from_state_dict(grads)
    bad = {"loss": float("nan"), "bpp": 0.5, "vec": np.ones(3)}
    assert run_probe(tdebug, tmp_path / "t", bad, grads) == \
        run_probe(jdebug, tmp_path / "j", bad, ref)
    oks, text = run_probe(tdebug, tmp_path / "t", bad, grads)
    assert oks == [False] and text.count("[DebugProbe]   grad ") == 5
    assert "batch dumped to DIR/bad_batch_step1.npz" in text
    good = {"loss": torch.tensor(1.5), "bpp": 0.5}
    finite = {k: v for k, v in grads.items() if torch.isfinite(v).all()}
    t = run_probe(tdebug, tmp_path / "t", good, finite, steps=4, log_every=2)
    j = run_probe(jdebug, tmp_path / "j", {"loss": 1.5, "bpp": 0.5},
                  flax_from_state_dict(finite), steps=4, log_every=2)
    assert t == j and t[0] == [True] * 4
    assert t[1].count("grad_norm=") == 2
    assert tdebug.DebugProbe().after_step({}, bad) is True   # disabled


def test_finite_check_passes_through_and_warns_as_jax(capsys):
    x = torch.tensor([1.0, 2.0])
    assert tdebug.finite_check(x, "ok") is x
    assert capsys.readouterr().out == ""
    for vals in ([1.0, np.nan, np.inf, -2.0], [np.nan, np.nan],
                 [0.1, -np.inf]):
        a = np.array(vals, np.float32)
        jdebug.finite_check(jnp.asarray(a), "stage")
        jax.effects_barrier()
        want = capsys.readouterr().out
        assert want.startswith("[NaNGuard] non-finite activations after "
                               "stage (min=")
        bad = torch.from_numpy(a)
        assert tdebug.finite_check(bad, "stage") is bad
        assert capsys.readouterr().out == want
    tdebug.finite_check(torch.tensor([float("nan")]), "off", enabled=False)
    assert capsys.readouterr().out == ""


#: Every module the JAX DMC's capture_intermediates reports that the port's
#: hooks do not see: the five inner convs of each DepthConvBlock (the kernel
#: reads their weights; no conv module runs) and the blocks of the chained
#: runs (one launch per run; no block's __call__ runs).
CHAINED = ("feature_extractor/conv1_0", "feature_extractor/conv1_1",
           "feature_extractor/conv2_0", "feature_extractor/conv2_1",
           "feature_extractor/conv2_2", "feature_extractor/conv2_3",
           "encoder/conv2_1", "encoder/conv2_2", "decoder/conv_1",
           "decoder/conv_2", "y_prior_fusion/conv_0", "y_prior_fusion/conv_1",
           "y_prior_fusion/conv_2")
INNER = ("dc_0", "dc_2", "dc_3", "ffn_0", "ffn_2")


def test_layer_forensics_matches_jax_on_the_modules_both_run():
    jm, p, port = tiny()
    x, m, f, g = inputs()
    want = jdebug.layer_forensics(
        jm, {"params": p}, jnp.asarray(x), jnp.int32(30),
        {"frame": jnp.asarray(f), "feature": jnp.asarray(g)}, top_k=10 ** 6,
        after_i=False, mask=jnp.asarray(m), train=False)
    T = torch.from_numpy
    got = tdebug.layer_forensics(port, T(x), 30, {"frame": T(f),
                                                  "feature": T(g)},
                                 top_k=10 ** 6, after_i=False, mask=T(m),
                                 train=False)
    assert set(got) <= set(want)
    blocks = {k.rsplit("/", 2)[0] for k in want
              if k.rsplit("/", 2)[-2] in INNER}
    lacking = ({f"{b}/{c}/__call__" for b in blocks for c in INNER}
               | {f"{b}/__call__" for b in CHAINED})
    assert set(want) - set(got) == lacking
    assert (len(got), len(want), len(blocks)) == (55, 223, 31)
    for k, s in got.items():
        assert (s["shape"], s["dtype"], s["nonfinite"]) == (
            want[k]["shape"], want[k]["dtype"], want[k]["nonfinite"]), k
        np.testing.assert_allclose([s["norm"], s["max_abs"]],
                                   [want[k]["norm"], want[k]["max_abs"]],
                                   rtol=1e-4, err_msg=k)
    top = tdebug.layer_forensics(port, T(x), 30, {"frame": T(f),
                                                  "feature": T(g)},
                                 after_i=False, mask=T(m), train=False)
    assert list(top) == list(got)[:20]


def test_layer_forensics_reports_a_tensor_of_each_module_once():
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(2, 2)
            self.pair = torch.nn.Identity()

        def forward(self, x):
            a = self.lin(x)
            self.lin(a * 100)            # a second call is not reported
            return {"a": a, "p": (self.pair(a), a)}

    torch.manual_seed(0)
    net = Net()
    x = torch.randn(3, 2)
    stats = tdebug.layer_forensics(net, x)
    assert set(stats) == {"lin/__call__", "pair/__call__"}   # the dict: none
    ref = net.lin(x).detach().numpy()
    assert stats["lin/__call__"]["norm"] == float(np.linalg.norm(ref))
    assert stats["lin/__call__"]["shape"] == (3, 2)


def test_cpu_cross_check_keys_are_keystr_and_zero_on_the_cpu():
    jm, p, port = tiny()
    x, m, f, g = inputs(1)
    out = jm.apply({"params": p}, jnp.asarray(x), jnp.int32(30),
                   {"frame": jnp.asarray(f), "feature": jnp.asarray(g)},
                   after_i=False, mask=jnp.asarray(m), train=False)
    keys = [jax.tree_util.keystr(k) for k, _ in
            jax.tree_util.tree_flatten_with_path(out)[0]]
    T = torch.from_numpy

    def fn(model, x, dpb, mask):
        with torch.no_grad():
            return model(x, 30, dpb, after_i=False, mask=mask, train=False)

    diffs = tdebug.cpu_cross_check(fn, port, T(x), {"frame": T(f),
                                                    "feature": T(g)}, T(m))
    assert list(diffs) == keys == ["['bpp']", "['bpp_y']", "['bpp_z']",
                                   "['dpb']['feature']", "['dpb']['frame']"]
    assert all(v == 0.0 for v in diffs.values())
    # lists, tuples, None and scalars, keyed as keystr keys them
    tree = {"b": [np.ones(2), (3.0, None)], "a": np.zeros(1)}
    want = [jax.tree_util.keystr(k) for k, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [k for k, _ in tdebug.keyed_leaves(tree)] == want


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    import json

    with tprof.trace(str(tmp_path / "tr")) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert d == str(tmp_path / "tr")
    files = list((tmp_path / "tr").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_timed_and_memory_stats_on_the_cpu():
    calls = []

    def fn(a, scale=1.0):
        calls.append(1)
        return {"y": a * scale}

    a = torch.ones(8)
    s = tprof.timed(fn, a, iters=3, scale=2.0)
    assert isinstance(s, float) and 0.0 < s < 5.0 and len(calls) == 4
    fetched = []
    tprof.timed(fn, a, iters=2, fetch=lambda o: fetched.append(1) or
                o["y"].sum())
    assert len(fetched) == 3
    stats = tprof.device_memory_stats()
    assert stats == {"cpu": {"bytes_in_use": None, "peak_bytes_in_use": None,
                             "bytes_limit": None}}
    # the JAX package's CPU devices report no statistics either
    assert all(v == stats["cpu"]
               for v in jprof.device_memory_stats().values())


def test_average_meter_matches_jax():
    t, j = tprof.AverageMeter(), jprof.AverageMeter()
    assert t.avg == j.avg == 0.0
    for v, n in ((1.0, 1), (2.5, 3), (torch.tensor(4.0), 2)):
        t.update(v, n)
        j.update(float(v), n)
    assert (t.sum, t.count, t.avg) == (j.sum, j.count, j.avg)
    t.reset()
    assert (t.sum, t.count) == (0.0, 0)


@pytest.mark.parametrize("args", [(), (0.11, 64.0, 256), (0.01, 64.0, 256),
                                  (0.3, 3.0, 64)])
def test_scale_table_within_an_ulp_of_jax(args):
    want = np.asarray(jentropy.make_scale_table(*args))
    got = tentropy.make_scale_table(*args).numpy()
    assert got.dtype == want.dtype == np.float32
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, ulps.max()


@pytest.mark.parametrize("args", [(), (0.11, 64.0, 256)])
def test_scale_indexes_equal_jax_edges_and_nan_included(args):
    """Exact, at random scales, at and beyond both ends, at every table
    entry and an ulp either side of it (the bin edges: there XLA's log and
    torch's differ), and at NaN and +-inf. A NaN's index is whatever XLA's
    conversion gives here, read from JAX."""
    lo, hi = (args[0], args[1]) if args else (0.11, 16.0)
    rng = np.random.default_rng(3)
    tab = np.asarray(jentropy.make_scale_table(*args))
    s = np.concatenate([
        rng.uniform(-1.0, 1.5 * hi, 20000),
        np.exp(rng.uniform(math.log(lo / 2), math.log(2 * hi), 20000)),
        tab, np.nextafter(tab, np.float32(0)), np.nextafter(tab, np.float32(
            1e9)),
        [np.nan, np.inf, -np.inf, lo, hi, 0.0, -0.0, -1.0, 1e30, 1e-40,
         np.nextafter(np.float32(lo), np.float32(0)),
         np.nextafter(np.float32(hi), np.float32(1e9))]]).astype(np.float32)
    want = np.asarray(jentropy.build_scale_indexes(jnp.asarray(s), *args))
    got = tentropy.build_scale_indexes(torch.from_numpy(s), *args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[len(s) - 12] == int(want[len(s) - 12])      # NaN
    # torch's own log and int cast would not do
    naive = ((torch.log(torch.clamp(torch.from_numpy(s), lo, hi))
              - math.log(lo)) / ((math.log(hi) - math.log(lo))
                                 / ((256 if args else 128) - 1))
             ).to(torch.int32).numpy()
    assert (naive != want).sum() > 0


def test_helpers_take_the_tensors_device():
    s = torch.tensor([0.5, float("nan")])
    assert tentropy.build_scale_indexes(s).device == s.device
    assert tentropy.make_scale_table(device="cpu").device.type == "cpu"
    assert tentropy.make_scale_table().device.type == "cpu"   # the default
