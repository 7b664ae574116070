"""The port's graft entry (ssgvc_tpu_torch/graft_entry.py) against the JAX
package's ``__graft_entry__.entry``.

Tolerances, from the CPU bf16 gaps measured here:
  * the JAX entry's params (``params_from_flax``) on its example args
    (zeros): bpp, bpp_z within 1e-5 relative (measured 4.6e-7), bpp_y
    (~4e-6 bits) at atol 1e-9 (measured 3.2e-10), the DPB exactly zero in
    both. At seeded frames these flax-init weights leave bf16 chaotic in
    both packages (the JAX package's own bf16 frame 5.3 dB PSNR from its
    fp32 one), so seeded frames are held on drawn weights instead:
  * drawn weights (``drawn_params``: lecun draws, the prior heads at 0.01)
    in both packages, seeded frames: the port's bf16 against the JAX
    package's bf16, frame PSNR >= 29 dB (measured 31.56; the JAX package's
    own bf16 reads 31.41 against its fp32), feature relative Frobenius
    error <= 0.08 (measured 0.051), bpp, bpp_y and bpp_z within 1e-3
    relative (measured 8.0e-5, 8.2e-5, 2.4e-5). A wrong call fails all
    three: QP off by one reads 21.1 dB, 0.166 and 3.6e-3; a zero mask
    9.8 dB; ``after_i=False`` 6.8 dB; the input frame as the DPB frame
    12.2 dB.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssgvc_tpu_torch import graft_entry
from ssgvc_tpu_torch.utils.debug import keyed_leaves
from ssgvc_tpu_torch.utils.weights import params_from_flax


@lru_cache(maxsize=1)
def jax_entry():
    """The JAX entry's fn (jitted) and example args, once per process. Its
    flax init of the full DMC runs jitted (~15 s on the CPU against ~40 s
    op by op); those params equal the entry's own call within 1.1e-7
    relative (XLA fuses the initialisers' scaling)."""
    import __graft_entry__

    made = {}

    def build():
        made["fn"], args = __graft_entry__.entry()
        return args

    args = jax.jit(build)()
    return jax.jit(made["fn"]), args


@lru_cache(maxsize=1)
def port_entry():
    return graft_entry.entry(device="cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the six test processes share the host's cores,
    and a full-width bf16 forward on eight threads each slows to a crawl
    there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded(seed=0, hw=256, ch=256):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (1, hw, hw, 3)).astype(np.float32),
            (rng.uniform(0, 1, (1, hw, hw, 1)) > 0.5).astype(np.float32),
            rng.uniform(0, 1, (1, hw, hw, 3)).astype(np.float32),
            rng.standard_normal((1, hw // 8, hw // 8, ch)).astype(np.float32))


def flat(out):
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v,
                          np.float32) for k, v in keyed_leaves(out)}


def jax_flat(out):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_flatten_with_path(out)[0]}


def test_entry_structure_shapes_and_dtypes_equal_jax():
    jfn, jargs = jax_entry()
    fn, args = port_entry()
    params, frame, mask, qp, dpb = args
    assert qp == graft_entry.QP == int(jargs[3])
    for t, j in ((frame, jargs[1]), (mask, jargs[2]),
                 (dpb["frame"], jargs[4]["frame"]),
                 (dpb["feature"], jargs[4]["feature"])):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        assert not t.any()
    with torch.no_grad():
        out = fn(*args)
    jout = jfn(*jargs)
    got = [(k, tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in keyed_leaves(out)]
    want = [(jax.tree_util.keystr(k), v.shape, str(v.dtype))
            for k, v in jax.tree_util.tree_flatten_with_path(jout)[0]]
    assert got == want
    assert out["mask_pred"] is None


def test_entry_params_are_the_ports_seeded_init_and_fn_is_pure():
    from ssgvc_tpu_torch.config import DMCConfig
    from ssgvc_tpu_torch.models.dmc import DMC

    fn, args = port_entry()
    params = args[0]
    ref = DMC(DMCConfig.variant("performance", dtype="bfloat16"),
              device="cpu").init_(torch.Generator().manual_seed(0))
    sd = ref.state_dict()
    assert list(params) == list(sd)
    assert all(torch.equal(params[k], sd[k]) for k in sd)
    x, m, f, g = (torch.from_numpy(a) for a in seeded(1, hw=64))
    dpb = {"frame": f, "feature": g}
    with torch.no_grad():
        a = flat(fn(params, x, m, 32, dpb))
        scaled = dict(params, q_recon=params["q_recon"] * 0.5)
        c = flat(fn(scaled, x, m, 32, dpb))
        d = flat(fn(params, x, m, 32, dpb))
    assert not np.array_equal(a["['dpb']['frame']"], c["['dpb']['frame']"])
    assert torch.equal(params["q_recon"], sd["q_recon"])   # not mutated
    # the same params give the same outputs, before and after other ones
    assert all(np.array_equal(a[k], d[k]) for k in a)


def test_entry_matches_jax_on_its_params():
    jfn, jargs = jax_entry()
    fn, args = port_entry()
    # the JAX init declares no feature_adaptor_p (after_i=True): the
    # port's stays from its own init, unused on this path
    sd = params_from_flax(jax.tree_util.tree_map(np.asarray, jargs[0]))
    assert set(args[0]) - set(sd) == {"feature_adaptor_p.weight",
                                      "feature_adaptor_p.bias"}
    with torch.no_grad():
        got = flat(fn(sd, *args[1:]))
    want = jax_flat(jfn(*jargs))
    for k in ("['bpp']", "['bpp_z']"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["['bpp_y']"], want["['bpp_y']"],
                               atol=1e-9)
    for k in ("['dpb']['frame']", "['dpb']['feature']"):
        assert not got[k].any() and not want[k].any()


def test_entry_matches_jax_bf16_on_drawn_weights():
    from chip_smoke import DMC_HEADS
    from ssgvc_tpu_torch.config import DMCConfig
    from ssgvc_tpu_torch.models.dmc import DMC

    from torch_port_helpers import drawn_params

    jfn, jargs = jax_entry()
    fn, args = port_entry()
    model = DMC(DMCConfig.variant("performance", dtype="bfloat16"),
                device="cpu")
    jparams = drawn_params(model, 22, DMC_HEADS)
    jparams.pop("feature_adaptor_p")        # not declared after an I-frame
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    assert (jax.tree_util.tree_structure(jparams)
            == jax.tree_util.tree_structure(jargs[0]))
    x, m, f, g = seeded()
    T = torch.from_numpy
    with torch.no_grad():
        port = flat(fn(dict(model.state_dict()), T(x), T(m), 32,
                       {"frame": T(f), "feature": T(g)}))
    want = jax_flat(jfn(jparams, jnp.asarray(x), jnp.asarray(m), jargs[3],
                        {"frame": jnp.asarray(f), "feature": jnp.asarray(g)}))
    assert set(port) == set(want)
    assert all(np.isfinite(v).all() for v in port.values())

    fr, fe = "['dpb']['frame']", "['dpb']['feature']"
    err = np.mean((port[fr].astype(np.float64) - want[fr]) ** 2)
    assert 10 * np.log10(1.0 / err) >= 29.0
    fro = (np.linalg.norm(port[fe].astype(np.float64) - want[fe])
           / np.linalg.norm(want[fe]))
    assert fro <= 0.08
    for k in ("['bpp']", "['bpp_y']", "['bpp_z']"):
        np.testing.assert_allclose(port[k], want[k], rtol=1e-3, err_msg=k)


def test_entry_takes_the_card_by_default_and_never_falls_back():
    if torch.cuda.is_available():
        fn, args = graft_entry.entry()
        assert args[1].device.type == "cuda"
        assert all(t.device.type == "cuda" for t in args[0].values())
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            graft_entry.entry()
    assert graft_entry.entry(device="cpu")[1][1].device.type == "cpu"
