"""F6 (ROADMAP §3): the DPB of a 10-step tiny checkpoint grows in both
packages, and the port follows the JAX package up to the step's own
conditioning (``experiments/f6_dpb_growth.py``).

The port's tiny profile is trained 10 steps on the CPU, its P-frame
weights carried into the JAX ``DMC``, and one clip rolled 9 P-frames. The
teacher-forced difference (the port fed the JAX package's DPB, against the
JAX output; relative max |.| of the feature) is held two ways:

  * frames 1-3, before the first quantizer tie: within K = 10 times the
    JAX package's own 1-ulp step (its output moved by the DPB scaled by
    1 + 2^-23), and within max(1e-3, K x that step). Measured: 1.2e-5,
    4.1e-5, 5.9e-4 against steps of 3.0e-6, 4.0e-5, 1.4e-4 (at most 4.3x).
  * from the first frame past 1e-3 on (frame 4: 6.1e-2 against a JAX step
    of 4.5e-3), a rounding of the latent y flips: there both packages'
    ``layer_forensics`` on that frame's identical inputs must agree in
    every module that runs before the quantized y_hat within
    max(K x the JAX package's 1-ulp difference, 1e-6) (measured at most
    4.2e-7); the decoder and the reconstruction net, fed by y_hat, are
    reported and not held.
"""

import importlib.util
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
K = 10.0
TIE = 4


@lru_cache(maxsize=1)
def f6():
    spec = importlib.util.spec_from_file_location(
        "f6_dpb_growth", ROOT / "experiments" / "f6_dpb_growth.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_thread():
    """The tiny profile's ops gain nothing from more threads (measured: the
    same time at 1 and 8), and one keeps the test from contending with
    the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_teacher_forced_port_within_the_steps_conditioning(one_thread):
    m = f6()
    assert m.K == K
    pk = m.Packages(m.train_tiny())
    frames, masks = m.clip(9)
    rows, jax_in = m.roll(pk, frames, masks)
    assert [r["frame"] for r in rows] == list(range(1, 10))
    assert [r["forced_rel"] > 1e-3 for r in rows].index(True) + 1 == TIE
    for r in rows[:TIE - 1]:
        assert r["forced_rel"] <= K * r["ulp_rel"], r
        assert r["forced_rel"] <= max(1e-3, K * r["ulp_rel"]), r
    n_port, n_jax, mods, _, first_before = m.forensics_at(
        pk, frames, masks, jax_in, TIE)
    before = [r for r in mods if r["before_y_hat"]]
    assert len(before) >= 35 and len(mods) - len(before) >= 10, mods
    for r in before:
        assert r["port"] <= max(K * r["ulp"], m.FLOOR), r
    assert first_before is None
    for r in rows:
        assert r["port_finite"] and r["jax_finite"], r
    # the blow-up is the reference's own: the JAX package's DPB grows by
    # orders of magnitude too
    jax_max = [r["jax_max"] for r in rows]
    assert jax_max[-1] > 1e3 * jax_max[0]
    assert np.isfinite([r["free_rel"] for r in rows]).all()
