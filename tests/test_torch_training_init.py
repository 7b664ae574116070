"""The port's flax-style inits and gain calibration against the JAX
package's, on the CPU: each DMC variant's and the DMCI's parameter families
(ramps, zeros, ones, lecun draws within their truncation, the bit
estimator's N(0, 0.01)), seeded inits, and calibrate_dmc / calibrate_dmci.
Split from test_torch_training.py (its tolerances: ramps at 3 ulp,
calibrated gains at rtol 1e-4, lecun draws' std within 5% on tensors of at
least 4096 elements), so that one test process does not hold both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssgvc_tpu import config as jcfg
from ssgvc_tpu.models.common import qp_gain_ramp_init as jax_ramp
from ssgvc_tpu.models.dmc import DMC as JaxDMC
from ssgvc_tpu.models.dmci import DMCI as JaxDMCI
from ssgvc_tpu.training import calibrate as jcal
from ssgvc_tpu_torch import config as tcfg
from ssgvc_tpu_torch.models.dmc import DMC
from ssgvc_tpu_torch.models.dmci import DMCI
from ssgvc_tpu_torch.training import calibrate as tcal
from ssgvc_tpu_torch.utils.weights import flatten, flax_from_state_dict
from torch_port_helpers import DMCI_TINY, TINY
from torch_port_helpers import one_torch_thread  # noqa: F401


RD_MID = dict(ch_d=64, ch_y=32, ch_z=32, ch_recon=96)
DMCI_RD_MID = dict(enc_dec=96, N=64, z_channel=32)
TRUNC = 0.87962566103423978
RAMPS = ("q_encoder", "q_decoder", "q_scale_enc", "q_scale_dec")
# The ramps are exp(linspace(log lo, log hi)) in both packages, in the same
# order of operations; XLA's CPU exp and its fused multiply-add in the line
# differ from torch's by 1-2 ulp on a few rows (4 of 72), the reciprocal
# ramp by up to 3, so the ramps are held at 3 ulp, their end rows exactly
RAMP_RTOL = 4e-7


def _jax_init_dmc(cfg, hw=64):
    x = jnp.zeros((1, hw, hw, 3))
    dpb = {"frame": x, "feature": jnp.zeros((1, hw // 8, hw // 8,
                                             cfg.ch_d))}
    return jax.jit(lambda k: JaxDMC(cfg).init(
        {"params": k, "noise": k}, x, jnp.int32(3), dpb,
        after_i=jnp.array(True), mask=jnp.zeros((1, hw, hw, 1)),
        train=False)["params"])(jax.random.PRNGKey(0))


def _jax_init_dmci(cfg, hw=64):
    return jax.jit(lambda k: JaxDMCI(cfg).init(
        k, jnp.zeros((1, hw, hw, 3)), jnp.int32(3),
        train=False)["params"])(jax.random.PRNGKey(0))


def _check_init_families(port_model, jax_tree):
    want = {k: np.asarray(v) for k, v in flatten(jax_tree).items()}
    got = {k: np.asarray(v) for k, v in
           flatten(flax_from_state_dict(port_model.state_dict())).items()}
    assert got.keys() == want.keys()
    pooled = {"port": [], "jax": []}
    n_lecun = 0
    for k, j in want.items():
        t = got[k]
        if "bit_estimator" in "/".join(k):
            pooled["port"].append(t.ravel())
            pooled["jax"].append(j.ravel())
        elif k[-1] in RAMPS:
            np.testing.assert_allclose(t, j, rtol=RAMP_RTOL, err_msg=str(k))
        elif not j.any():
            assert not t.any(), k
        elif np.all(j == 1):
            assert np.all(t == 1), k
        else:
            assert k[-1] == "kernel", k
            sigma = np.prod(j.shape[:-1]) ** -0.5
            bound = 2 * sigma / TRUNC * (1 + 1e-6)
            assert np.abs(t).max() <= bound and np.abs(j).max() <= bound, k
            if t.size >= 4096:
                n_lecun += 1
                assert abs(t.std() / sigma - 1) < 0.05, (k, t.std(), sigma)
                assert abs(j.std() / sigma - 1) < 0.05, (k, j.std(), sigma)
    assert n_lecun >= 5
    for side in pooled:
        v = np.concatenate(pooled[side])
        assert abs(v.std() / 0.01 - 1) < 0.05 and abs(v.mean()) < 1e-3, side


@pytest.mark.parametrize("variant,rr", [("performance", False),
                                        ("mask_prop", True)])
def test_dmc_init_matches_flax_families(variant, rr):
    cfg = dict(RD_MID, recon_residual=rr)
    jtree = _jax_init_dmc(jcfg.DMCConfig.variant(variant, **cfg))
    model = DMC(tcfg.DMCConfig.variant(variant, **cfg), device="cpu")
    model.init_(torch.Generator().manual_seed(0))
    _check_init_families(model, jtree)
    if rr:
        assert not model.decoder.proj.weight.any()
        assert not model.recon_generation_net.head.weight.any()


def test_dmci_init_matches_flax_families():
    jtree = _jax_init_dmci(jcfg.DMCIConfig(**DMCI_RD_MID))
    model = DMCI(tcfg.DMCIConfig(**DMCI_RD_MID), device="cpu")
    model.init_(torch.Generator().manual_seed(0))
    _check_init_families(model, jtree)


def test_init_is_seeded_and_ramp_matches_jax():
    from ssgvc_tpu_torch.models.common import qp_gain_ramp_init

    for inverse in (False, True):
        for rows in (1, 64, 72):
            want = np.asarray(jax_ramp(inverse=inverse)(None, (rows, 5)))
            got = qp_gain_ramp_init(rows, 5, inverse=inverse).numpy()
            np.testing.assert_allclose(got, want, rtol=RAMP_RTOL)
            assert np.array_equal(got[[0, -1]], want[[0, -1]])
            assert (np.diff(got[:, 0]) != 0).all() or rows == 1
    a = DMC(tcfg.DMCConfig(**TINY), device="cpu").init_(
        torch.Generator().manual_seed(7))
    b = DMC(tcfg.DMCConfig(**TINY), device="cpu").init_(
        torch.Generator().manual_seed(7))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))


# ----------------------------------------------------------- calibrate --

def _calib_inputs(hw=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (2, hw, hw, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (2, hw, hw, 1)) > 0.7).astype(np.float32)
    frame = rng.uniform(0, 1, (2, hw, hw, 3)).astype(np.float32)
    feature = np.zeros((2, hw // 8, hw // 8, TINY["ch_d"]), np.float32)
    return x, mask, frame, feature


def test_calibrate_dmc_matches_jax():
    x, mask, frame, feature = _calib_inputs()
    cfg = dict(TINY)
    model = DMC(tcfg.DMCConfig.variant("performance", **cfg), device="cpu")
    model.init_(torch.Generator().manual_seed(1))
    tree = flax_from_state_dict(model.state_dict())
    jm = JaxDMC(jcfg.DMCConfig.variant("performance", **cfg))
    jdpb = {"frame": jnp.asarray(frame), "feature": jnp.asarray(feature)}
    ref = jcal.calibrate_dmc(jm, jax.tree_util.tree_map(jnp.asarray, tree),
                             jnp.asarray(x), jdpb, jnp.asarray(mask))
    t = lambda a: torch.from_numpy(a)
    tcal.calibrate_dmc(model, t(x), {"frame": t(frame),
                                     "feature": t(feature)}, t(mask))
    for k in ("q_encoder", "q_decoder", "z_gain"):
        np.testing.assert_allclose(getattr(model, k).detach().numpy(),
                                   np.asarray(ref[k]), rtol=1e-4)
    assert not np.allclose(np.asarray(ref["z_gain"]), 1.0)


def test_calibrate_dmci_matches_jax():
    x = _calib_inputs()[0]
    model = DMCI(tcfg.DMCIConfig(**DMCI_TINY), device="cpu")
    model.init_(torch.Generator().manual_seed(2))
    tree = flax_from_state_dict(model.state_dict())
    ref = jcal.calibrate_dmci(JaxDMCI(jcfg.DMCIConfig(**DMCI_TINY)),
                              jax.tree_util.tree_map(jnp.asarray, tree),
                              jnp.asarray(x))
    tcal.calibrate_dmci(model, torch.from_numpy(x))
    np.testing.assert_allclose(model.z_gain.detach().numpy(),
                               np.asarray(ref["z_gain"]), rtol=1e-4)
    assert not np.allclose(np.asarray(ref["z_gain"]), 1.0)
