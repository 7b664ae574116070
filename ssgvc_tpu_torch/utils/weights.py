"""Weight bridge: flax-layout parameter trees (nested dicts of numpy arrays,
as the JAX package's ``init`` and checkpoints hold them) to the port's
``state_dict``, and back.

  * ``kernel`` (HWIO, depthwise (3, 3, 1, C) included) -> ``weight`` (OIHW)
  * every other leaf (biases, per-QP tables (Q, C), Bitparm h/b/a, z_gain)
    passes through unchanged
  * path components join with "." : ('encoder', 'conv2_0', 'dc_0', 'kernel')
    -> 'encoder.conv2_0.dc_0.weight'

Given a model, every name and shape is checked: a missing or an unexpected
key raises.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

FlatParams = Dict[Tuple[str, ...], np.ndarray]


def flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> FlatParams:
    out: FlatParams = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def unflatten(flat: FlatParams) -> dict:
    tree: dict = {}
    for path, arr in flat.items():
        node = tree
        for comp in path[:-1]:
            node = node.setdefault(comp, {})
        node[path[-1]] = arr
    return tree


def check_state_dict(sd: Mapping[str, torch.Tensor],
                     expected: Mapping[str, torch.Tensor]) -> None:
    """Raise on a missing key, an unexpected key or a shape mismatch."""
    missing = sorted(set(expected) - set(sd))
    unexpected = sorted(set(sd) - set(expected))
    if missing or unexpected:
        raise KeyError(f"state_dict mismatch: {len(missing)} missing "
                       f"{missing[:5]}, {len(unexpected)} unexpected "
                       f"{unexpected[:5]}")
    for k, v in expected.items():
        if tuple(sd[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: got {tuple(sd[k].shape)}"
                             f", model has {tuple(v.shape)}")


def params_from_flax(tree: Mapping, model: torch.nn.Module = None
                     ) -> Dict[str, torch.Tensor]:
    """Flax params tree -> the port's state_dict (fp32 CPU tensors). With
    ``model``, checks every key and shape against ``model.state_dict()``."""
    sd = {}
    for path, arr in flatten(tree).items():
        arr = np.asarray(arr, dtype=np.float32)
        if path[-1] == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"{'/'.join(path)}: expected an HWIO kernel, "
                                 f"got shape {arr.shape}")
            arr = arr.transpose(3, 2, 0, 1)
            path = path[:-1] + ("weight",)
        sd[".".join(path)] = torch.from_numpy(np.ascontiguousarray(arr))
    if model is not None:
        check_state_dict(sd, model.state_dict())
    return sd


def flax_from_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`params_from_flax`: a nested dict of numpy
    arrays in flax layouts."""
    flat: FlatParams = {}
    for key, v in sd.items():
        arr = v.detach().float().cpu().numpy()
        path = tuple(key.split("."))
        if path[-1] == "weight" and arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
            path = path[:-1] + ("kernel",)
        flat[path] = np.ascontiguousarray(arr)
    return unflatten(flat)


def load_flax_params(model: torch.nn.Module, tree: Mapping
                     ) -> torch.nn.Module:
    """Check and load a flax params tree into ``model``, in place."""
    model.load_state_dict(params_from_flax(tree, model), strict=True)
    return model
