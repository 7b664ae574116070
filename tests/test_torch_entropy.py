"""The port's entropy estimators and checkerboard prior against the JAX
package, fp32 on the CPU, on identical inputs.

Tolerances: bits at rtol 1e-5 / atol 1e-5 (the same fp32 formula; the port
reproduces the JAX package's fp32 erf, so even tail symbols agree); the
masks exactly; the prior's tensors at atol 1e-5. ``gaussian_bits`` at
rtol 1e-4 / atol 1e-4: its log2 and reciprocal are the host library's, and
one run of the whole suite under pytest-xdist saw the port's bits drift by
up to 4.4e-5 relative from those of a lone run of the same inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssgvc_tpu.models import common as jc
from ssgvc_tpu.models import entropy as je
from ssgvc_tpu_torch.models import common as tc
from ssgvc_tpu_torch.models import entropy as te
from torch_port_helpers import perturbed

TOL = dict(rtol=1e-5, atol=1e-5)


def test_erf32_is_the_reference_erf():
    x = np.concatenate([np.linspace(-6, 6, 20001, dtype=np.float32),
                        np.random.default_rng(0).standard_normal(20000)
                        .astype(np.float32) * 3])
    np.testing.assert_array_equal(te.erf32(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.lax.erf(jnp.asarray(x))))


def test_gaussian_bits_matches_jax_including_nan_and_inf():
    rng = np.random.default_rng(1)
    y = np.round(rng.standard_normal(4000) * 4).astype(np.float32)
    s = (np.abs(rng.standard_normal(4000)) * 2 + 0.05).astype(np.float32)
    y[:6] = [np.nan, np.inf, -np.inf, 1e6, -3.0, 0.0]
    s[6:12] = [np.nan, np.inf, -np.inf, 0.0, -1.0, 1e12]
    ref = np.asarray(je.gaussian_bits(jnp.asarray(y), jnp.asarray(s)))
    out = te.gaussian_bits(torch.from_numpy(y), torch.from_numpy(s)).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_gaussian_bits_cdf_matches_jax():
    rng = np.random.default_rng(2)
    y = np.round(rng.standard_normal(4000) * 3).astype(np.float32)
    s = (np.abs(rng.standard_normal(4000)) + 0.11).astype(np.float32)
    np.testing.assert_allclose(
        te.gaussian_bits_cdf(torch.from_numpy(y), torch.from_numpy(s)).numpy(),
        np.asarray(je.gaussian_bits_cdf(jnp.asarray(y), jnp.asarray(s))),
        **TOL)


@pytest.mark.parametrize("qp", [0, 31, 71])
def test_bit_estimator_matches_jax(qp):
    qp_num, ch = 72, 16
    z = np.round(np.random.default_rng(qp).standard_normal((1, 5, 6, ch))
                 * 3).astype(np.float32)
    jmod = je.BitEstimator(qp_num, ch)
    params = perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(z),
                                 jnp.int32(qp))["params"], scale=0.5)
    ref = jmod.apply({"params": params}, jnp.asarray(z), jnp.int32(qp),
                     method=je.BitEstimator.bits)
    tmod = te.BitEstimator(qp_num, ch, device="cpu")
    with torch.no_grad():
        for name in ("f1", "f2", "f3", "f4"):
            for leaf, arr in params[name].items():
                getattr(getattr(tmod, name), leaf).copy_(torch.from_numpy(arr))
        out = tmod.bits(torch.from_numpy(z), qp)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_checkerboard_masks_2x_match_jax():
    for m_t, m_j in zip(tc.checkerboard_masks_2x(6, 5, 7, device="cpu"),
                        jc.checkerboard_masks_2x(6, 5, 7)):
        np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))


def test_pad_for_y_matches_jax():
    y = np.random.default_rng(3).standard_normal((1, 5, 6, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tc.pad_for_y(torch.from_numpy(y)).numpy(),
        np.asarray(jc.pad_for_y(jnp.asarray(y))))


def test_compress_prior_2x_matches_jax_at_eval():
    rng = np.random.default_rng(4)
    c, h, w = 8, 6, 10
    y = (rng.standard_normal((1, h, w, c)) * 4).astype(np.float32)
    params = (rng.standard_normal((1, h, w, 3 * c)) * 2).astype(np.float32)
    proj = (rng.standard_normal((4 * c, 2 * c)) * 0.3).astype(np.float32)

    def jprior(parts):      # a linear spatial prior over the implicit concat
        return jnp.concatenate(parts, -1) @ jnp.asarray(proj)

    def tprior(parts):
        return torch.cat(parts, -1) @ torch.from_numpy(proj)

    ref = jc.compress_prior_2x(jnp.asarray(y), jnp.asarray(params), jprior,
                               None, False)
    out = tc.compress_prior_2x(torch.from_numpy(y), torch.from_numpy(params),
                               tprior, None, False)
    for name in ref._fields:
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), **TOL,
                                   err_msg=name)
    bits = tc.bpp_from_bits(torch.from_numpy(y), 64)
    np.testing.assert_allclose(bits.numpy(), np.asarray(
        jc.bpp_from_bits(jnp.asarray(y), 64)), **TOL)
