"""The port stands alone: no module of ssgvc_tpu_torch, and not
chip_smoke.py, imports JAX, flax or the JAX package; and its entry points
target the card unless asked for the CPU, with no fallback."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ssgvc_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = sorted((ROOT / "ssgvc_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_dmc_defaults_to_the_card_and_never_falls_back():
    from ssgvc_tpu_torch.config import DMCConfig
    from ssgvc_tpu_torch.models.dmc import DMC

    cfg = DMCConfig.variant("performance", **dict(ch_d=32, ch_y=16, ch_z=16,
                                                  ch_recon=32))
    if torch.cuda.is_available():
        model = DMC(cfg)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            DMC(cfg)
    model = DMC(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_dmci_defaults_to_the_card_and_never_falls_back():
    from ssgvc_tpu_torch.config import DMCIConfig
    from ssgvc_tpu_torch.models.dmci import DMCI

    cfg = DMCIConfig(enc_dec=48, N=32, z_channel=32)
    if torch.cuda.is_available():
        model = DMCI(cfg)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            DMCI(cfg)
    model = DMCI(cfg, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_other_variants_are_refused_until_ported():
    from ssgvc_tpu_torch.config import DMCConfig
    from ssgvc_tpu_torch.models.dmc import DMC

    for name in ("plain", "old", "fast", "mask_prop"):
        with pytest.raises(NotImplementedError):
            DMC(DMCConfig.variant(name, ch_d=16, ch_y=8, ch_z=8,
                                  ch_recon=16), device="cpu")
