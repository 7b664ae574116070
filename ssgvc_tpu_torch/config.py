"""Configuration of the PyTorch port: the intra codec's DMCIConfig, the
inter codec's DMCConfig, the named size profiles and their constructor, and
the training schema (TrainConfig with its dataset, optimizer and
compression sections) with ``load_config``.

The port keeps its own copy of these dataclasses so that it imports nothing
of the JAX package; field names, defaults and presets are the same, so a
configuration means the same model and the same training run in both
packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


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


# --------------------------- training configs ---------------------------

@dataclass
class OptimizerConfig:
    optimizer_type: str = "adamw"
    base_lr: float = 1e-4
    min_lr: float = 1e-5
    aux_lr: float = 5e-4
    weight_decay: float = 0.01
    warmup_iters: int = 0


@dataclass
class CompressionConfig:
    lambda_min: float = 50.0
    lambda_max: float = 38400.0
    q_levels: int = 64
    index_map: List[int] = field(default_factory=lambda: [0, 1, 0, 2, 0, 2,
                                                          0, 2])
    weights_map: Dict[int, float] = field(
        default_factory=lambda: {0: 0.5, 1: 1.2, 2: 0.9})


@dataclass
class DatasetConfig:
    dataset_type: str = "waymo"
    data_dir: str = "./dataset/waymo"
    seg_cache_dir: str = "seg_cache"
    batch_size: int = 4
    num_workers: int = 0
    n_frames: int = 4
    seq_len: Optional[int] = 4
    slide: int = 1
    crop: Any = field(default_factory=lambda: [128, 128])
    crop_size: Optional[int] = 128
    yuv_format: str = "444"
    train_val_test_split: Tuple[float, float, float] = (0.9, 0.1, 0.0)
    train_split: float = 0.9
    use_cache: bool = True
    strict_masks: bool = False
    synthetic: bool = False           # synthetic frames when no data exists
    synthetic_num_clips: int = 64


@dataclass
class TrainConfig:
    """Top-level training schema, the JAX package's field for field."""
    epochs: int = 25
    dtype: str = "float32"
    accumulation_steps: int = 8
    grad_clip: float = 5.0

    log_interval: int = 50
    val_check_interval: float = 1.0
    save_top_k: int = 3

    out_dir: str = "out"
    image_checkpoint_path: str = ""
    video_checkpoint_path: str = ""
    psnrm_target_path: Optional[str] = None
    psnrm_default_db: float = 35.0
    dmc_variant: str = "performance"
    build_cache: bool = False
    constraint_opt: bool = False
    mask_train: bool = False
    roi_weight: float = 100.0         # ROI MSE weight (1 + w*mask)
    # divide the RD loss by lambda(qp): the same per-QP optimum, balanced
    # gradients across mixed-QP batches
    lambda_normalize: bool = False
    # init-time quantizer-gain calibration (training/calibrate.py): fresh
    # inits only
    calibrate_gains: bool = True
    # recon = previous frame + a zero-init correction
    # (DMCConfig.recon_residual)
    recon_residual: bool = False

    exp_name: str = "video-compression-waymo"
    model_profile: str = "full"       # full | tiny (CI/smoke runs)
    log_dir: str = "./logs"
    seed: int = 42
    precision: str = "bf16-mixed"     # bf16 compute, fp32 params/entropy
    num_devices: int = 1
    resume_from_checkpoint: Optional[str] = None

    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    compression: CompressionConfig = field(default_factory=CompressionConfig)

    # ALM / constrained-optimization hyperparameters
    lagr_rho: float = 5.0
    lagr_init_lambda: float = 1.0   # initial ALM dual variable mu
    lagr_lambda_max: float = 1e3    # clamp for mu in the dual ascent
    alm_penalty_scale: float = 0.3


def _merge_into_dataclass(obj, data: dict):
    for key, value in data.items():
        if not hasattr(obj, key):
            continue  # unknown YAML keys are tolerated
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _merge_into_dataclass(current, value)
        else:
            setattr(obj, key, value)
    return obj


def load_config(yaml_path: Optional[str] = None,
                overrides: Optional[List[str]] = None) -> TrainConfig:
    """YAML file + dotted CLI overrides -> TrainConfig. YAML keys the schema
    lacks are ignored; an override's unknown key raises."""
    cfg = TrainConfig()
    data: dict = {}
    if yaml_path:
        import yaml
        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
    # accept the reference's num_gpus spelling
    if "num_gpus" in data:
        data["num_devices"] = data.pop("num_gpus")
    _merge_into_dataclass(cfg, data)
    for ov in overrides or []:
        if "=" not in ov:
            continue
        key, _, raw = ov.partition("=")
        if key == "num_gpus":
            key = "num_devices"
        import yaml
        value = yaml.safe_load(raw)
        node = cfg
        parts = key.split(".")
        for comp in parts[:-1]:
            if not hasattr(node, comp):
                raise KeyError(f"unknown config section {comp!r} in "
                               f"override {ov!r}")
            node = getattr(node, comp)
        if not hasattr(node, parts[-1]):
            raise KeyError(f"unknown config key {key!r} in override {ov!r} "
                           f"(did you mean one of "
                           f"{sorted(vars(node))[:8]}...?)")
        setattr(node, parts[-1], value)
    return cfg
