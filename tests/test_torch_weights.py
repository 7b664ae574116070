"""The weight bridge: flax params tree -> the port's state_dict, every leaf
consumed, names and shapes checked, and back through the JAX package's own
torch importer exactly."""

import numpy as np
import pytest
import torch

from ssgvc_tpu.config import DMCConfig as JaxDMCConfig
from ssgvc_tpu.models.dmc import DMC as JaxDMC
from ssgvc_tpu.utils.torch_import import align_params, convert_state_dict
from ssgvc_tpu_torch.config import DMCConfig
from ssgvc_tpu_torch.models.dmc import DMC
from ssgvc_tpu_torch.utils import weights
from torch_port_helpers import RD_TINY, jax_dmc_params
from torch_port_helpers import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def bridge():
    params = jax_dmc_params(
        JaxDMC(JaxDMCConfig.variant("performance", packed_io=True,
                                    **RD_TINY)), True, RD_TINY["ch_d"])
    model = DMC(DMCConfig.variant("performance", packed_io=True, **RD_TINY),
                device="cpu")
    return params, model


def test_every_flax_leaf_is_consumed(bridge):
    params, model = bridge
    sd = weights.params_from_flax(params, model)
    assert len(sd) == len(weights.flatten(params)) == len(model.state_dict())
    assert sd["encoder.conv2_0.dc_0.weight"].shape == (32, 32, 1, 1)
    assert sd["encoder.conv2_0.dc_2.weight"].shape == (32, 1, 3, 3)
    assert sd["q_encoder"].shape == (72, 32)
    np.testing.assert_array_equal(
        sd["encoder.down.weight"].numpy(),
        params["encoder"]["down"]["kernel"].transpose(3, 2, 0, 1))


def test_missing_extra_and_misshapen_keys_raise(bridge):
    params, model = bridge
    flat = weights.flatten(params)
    missing = dict(flat)
    missing.pop(("encoder", "conv2_0", "dc_3", "kernel"))
    with pytest.raises(KeyError, match="1 missing"):
        weights.params_from_flax(weights.unflatten(missing), model)
    extra = dict(flat)
    extra[("encoder", "bogus", "bias")] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="1 unexpected"):
        weights.params_from_flax(weights.unflatten(extra), model)
    bad = dict(flat)
    bad[("z_gain",)] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="z_gain"):
        weights.params_from_flax(weights.unflatten(bad), model)


def test_round_trip_through_the_jax_importer_is_exact(bridge):
    params, model = bridge
    weights.load_flax_params(model, params)
    back = align_params(convert_state_dict(model.state_dict()), params)
    ref = weights.flatten(params)
    got = weights.flatten(back)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))
    # and the port's own inverse
    mine = weights.flatten(weights.flax_from_state_dict(model.state_dict()))
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=str(k))
