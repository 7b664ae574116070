"""Reference DCVC-RT state dicts (PyTorch checkpoints of the reference
codec) into the port's models.

The port's parameter names are the reference's with each ``Sequential``
index merged into the name before it by "_" ('enc.dec.1.3.dc.0.weight' ->
'enc.dec_1_3.dc_0.weight'); conv weights keep their OIHW layout (depthwise
included); per-QP tables and Bitparm params stored as (Q, C, 1, 1) become
(Q, C); everything else passes through. ``align_state_dict`` then fills a
model's state_dict from the result.

Also the reference's transfer-learning helpers: ``normalize_prefix``
(choose the wrapper prefix that matches the model best) and
``inflate_input_conv`` (widen an input conv by an extra, e.g. mask,
channel).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# Parameters the port has beyond the reference's: a reference checkpoint
# lacks them, and they keep the model's init value (z_gain's ones are the
# identity)
DEFAULT_OK_LEAVES = frozenset({"z_gain"})


def torch_key_to_port_key(key: str) -> str:
    """'enc.dec.0.dc.2.weight' -> 'enc.dec_0.dc_2.weight'."""
    parts = []
    for comp in key.split("."):
        if comp.isdigit() and parts:
            parts[-1] = f"{parts[-1]}_{comp}"
        else:
            parts.append(comp)
    return ".".join(parts)


def convert_state_dict(state_dict: Mapping[str, object]
                       ) -> Dict[str, torch.Tensor]:
    """A reference state_dict -> {port name: fp32 CPU tensor}."""
    out = {}
    for key, value in state_dict.items():
        t = (value.detach().cpu() if torch.is_tensor(value)
             else torch.as_tensor(np.asarray(value)))
        name = torch_key_to_port_key(key)
        leaf = name.rsplit(".", 1)[-1]
        if (leaf != "weight" and t.ndim == 4 and t.shape[2] == 1
                and t.shape[3] == 1):
            t = t[:, :, 0, 0]     # per-QP tables, Bitparm h / b / a
        out[name] = t.to(torch.float32).contiguous()
    return out


def align_state_dict(src: Mapping[str, torch.Tensor],
                     template: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """``template`` (a model's state_dict) filled from ``src``. Keys of
    ``src`` the model lacks are dropped; a key the model needs and ``src``
    lacks raises KeyError, except a DEFAULT_OK_LEAVES parameter, which keeps
    the template's value; a shape mismatch raises ValueError."""
    missing = [k for k in template if k not in src
               and k.rsplit(".", 1)[-1] not in DEFAULT_OK_LEAVES]
    if missing:
        raise KeyError(f"checkpoint missing {len(missing)} params, e.g. "
                       f"{missing[:5]}")
    out = {}
    for key, tmpl in template.items():
        if key not in src:
            out[key] = tmpl
            continue
        t = src[key]
        if tuple(t.shape) != tuple(tmpl.shape):
            raise ValueError(f"shape mismatch at {key}: checkpoint "
                             f"{tuple(t.shape)} vs model {tuple(tmpl.shape)}")
        out[key] = t
    return out


def normalize_prefix(state_dict: Mapping[str, object],
                     target_keys) -> Dict[str, object]:
    """``state_dict`` with the wrapper prefix ('module.', 'model.',
    'p_frame_model.', ...) stripped whose removal matches the most of
    ``target_keys``; keys without that prefix are dropped. No prefix wins
    a tie."""
    target = set(target_keys)
    candidates = ["", "module.", "model.", "p_frame_model.", "i_frame_model.",
                  "net.", "_orig_mod."]
    best, best_overlap = state_dict, -1
    for prefix in candidates:
        if prefix:
            sub = {k[len(prefix):]: v for k, v in state_dict.items()
                   if k.startswith(prefix)}
        else:
            sub = dict(state_dict)
        overlap = len(target & set(sub))
        if overlap > best_overlap:
            best, best_overlap = sub, overlap
    return dict(best)


def inflate_input_conv(weight: torch.Tensor, extra_in: int = 1,
                       mode: str = "zero") -> torch.Tensor:
    """An OIHW conv weight widened to I + ``extra_in`` input channels. The
    new slice is zero (the function is unchanged at load time), the mean of
    the existing input channels, or kaiming-normal draws seeded by 0 (drawn
    as (H, W, extra_in, O), the reference layout)."""
    k = weight.detach().cpu().numpy().transpose(2, 3, 1, 0)   # HWIO
    h, w, i, o = k.shape
    if mode == "zero":
        extra = np.zeros((h, w, extra_in, o), dtype=k.dtype)
    elif mode == "mean":
        extra = np.repeat(k.mean(axis=2, keepdims=True), extra_in, axis=2)
    elif mode == "kaiming":
        std = np.sqrt(2.0 / (h * w * (i + extra_in)))
        extra = np.random.default_rng(0).normal(
            0.0, std, (h, w, extra_in, o)).astype(k.dtype)
    else:
        raise ValueError(f"unknown inflation mode {mode!r}")
    out = np.concatenate([k, extra], axis=2).transpose(3, 2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(out))


def load_torch_checkpoint(path: str) -> Dict[str, object]:
    """The state_dict of a reference checkpoint (.pth / .tar): a raw
    state_dict or one under 'state_dict', 'model' or 'net'; 'module.'
    prefixes stripped. Loaded with ``weights_only=True``: tensors and plain
    containers only."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model", "net"):
        if isinstance(ckpt, dict) and key in ckpt and isinstance(ckpt[key],
                                                                 dict):
            ckpt = ckpt[key]
    return {k.removeprefix("module."): v for k, v in ckpt.items()}
