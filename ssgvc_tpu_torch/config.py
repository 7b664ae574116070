"""Model configuration of the PyTorch port: the intra codec's DMCIConfig,
the inter codec's DMCConfig, the named size profiles and their constructor.

The port keeps its own copy of these dataclasses so that it imports nothing
of the JAX package; field names, defaults and presets are the same, so a
configuration means the same model in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class DMCIConfig:
    """Intra (I-frame) codec, ``models/dmci.py``: 8x8 patches of the raw
    frame (``src`` = 3*8*8 channels), ``enc_dec`` channels in the encoder
    and decoder blocks, ``N`` in the latent y, ``z_channel`` in the hyper
    latent, ``qp_num`` rows in the per-QP tables."""
    patch_size: int = 8
    src: int = 3 * 8 * 8
    enc_dec: int = 368
    N: int = 256
    z_channel: int = 128
    qp_num: int = 64
    dtype: str = "float32"
    qp_ramp_init: bool = True


@dataclass(frozen=True)
class DMCConfig:
    """Inter (P-frame) codec.

    ``mask_mode``: none | sft_latent (performance) | film_hyper (fast,
    mask_prop); ``mask_source``: gt | propagated. ``packed_io``: frames,
    masks and the DPB frame enter and leave pixel-unshuffled
    (H/8, W/8, 192). ``bits_sigma_floor`` clamps the sigma of the rate
    estimate to the real coder's smallest scale. ``recon_residual`` adds
    the context / previous frame back after the decoder and recon heads.
    """
    patch_size: int = 8
    src: int = 3 * 8 * 8
    ch_d: int = 256
    ch_y: int = 128
    ch_z: int = 128
    ch_recon: int = 320
    qp_shift: Tuple[int, int, int] = (0, 8, 4)
    extra_qp: int = 8
    qp_num: int = 64
    dtype: str = "float32"
    mask_mode: str = "none"
    mask_source: str = "gt"
    legacy_old: bool = False
    packed_io: bool = False
    bits_sigma_floor: float = 0.11
    qp_ramp_init: bool = True
    recon_residual: bool = False

    @staticmethod
    def variant(name: str, **kw) -> "DMCConfig":
        presets = {
            "old": dict(mask_mode="none", mask_source="gt", legacy_old=True),
            "plain": dict(mask_mode="none", mask_source="gt"),
            "performance": dict(mask_mode="sft_latent", mask_source="gt"),
            "fast": dict(mask_mode="film_hyper", mask_source="gt"),
            "mask_prop": dict(mask_mode="film_hyper", mask_source="propagated"),
        }
        if name not in presets:
            raise ValueError(
                f"Unknown dmc_variant={name!r}. Expected one of "
                f"{sorted(presets)}")
        return DMCConfig(**{**presets[name], **kw})


#: Named model-size profiles. "full" is the published size; the smaller
#: tiers keep the architecture with fewer channels.
MODEL_PROFILES = {
    "full": dict(dmc={}, dmci={}),
    "tiny": dict(dmc=dict(ch_d=16, ch_y=8, ch_z=8, ch_recon=16),
                 dmci=dict(enc_dec=32, N=16, z_channel=8)),
    "rd-tiny": dict(dmc=dict(ch_d=32, ch_y=16, ch_z=16, ch_recon=32),
                    dmci=dict(enc_dec=48, N=32, z_channel=32)),
    "rd-mid": dict(dmc=dict(ch_d=64, ch_y=32, ch_z=32, ch_recon=96),
                   dmci=dict(enc_dec=96, N=64, z_channel=32)),
    "rd-half": dict(dmc=dict(ch_d=128, ch_y=64, ch_z=64, ch_recon=160),
                    dmci=dict(enc_dec=184, N=128, z_channel=64)),
}


def profile_model_cfgs(profile: str, variant: str = "performance",
                       dtype: str = "float32", **dmc_overrides):
    """(DMCConfig, DMCIConfig) for a named size profile."""
    if profile not in MODEL_PROFILES:
        raise ValueError(f"Unknown profile {profile!r}; expected one of "
                         f"{sorted(MODEL_PROFILES)}")
    p = MODEL_PROFILES[profile]
    dmc = DMCConfig.variant(variant, dtype=dtype,
                            **{**p["dmc"], **dmc_overrides})
    dmci = DMCIConfig(dtype=dtype, **p["dmci"])
    return dmc, dmci
