"""Numerical forensics for the port: the JAX package's ``utils/debug.py``
with PyTorch's idiom inside.

  * ``finite_check``: a guard that warns when a tensor holds a non-finite
    value and passes the tensor through;
  * ``tree_norm`` / ``tree_stats``: the global and per-parameter norms of
    weights or gradients;
  * ``dump_bad_batch``: the failing batch and scalar metrics as an ``.npz``;
  * ``DebugProbe``: a host-side guard around the step outputs;
  * ``layer_forensics``: every submodule's output statistics over one
    forward, through forward hooks;
  * ``cpu_cross_check``: a function run as given and again on CPU copies of
    its arguments, its outputs compared.

A "tree" is what the port holds: an ``nn.Module`` (its ``state_dict``), a
``state_dict`` or any flat mapping of dotted names to tensors (the gradients
of ``named_parameters``), or a nested dict of arrays. Statistics name each
weight by its flax path (``utils/weights.flax_from_state_dict``: conv
weights as HWIO ``kernel`` leaves), so they compare with the JAX package's
key by key.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from .weights import flatten, flax_from_state_dict


def _host(x) -> np.ndarray:
    """A tensor or array-like as a numpy array (bfloat16 as float32, which
    numpy lacks)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def _is_state_dict(tree) -> bool:
    return (isinstance(tree, Mapping) and len(tree) > 0
            and all(isinstance(v, torch.Tensor) for v in tree.values()))


def named_leaves(tree) -> Dict[str, object]:
    """``tree`` as {flax path ("/"-joined): leaf}, in the tree's own
    order."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if _is_state_dict(tree):
        tree = flax_from_state_dict(tree)
    if isinstance(tree, Mapping):
        return {"/".join(map(str, k)): v for k, v in flatten(tree).items()}
    return {str(i): v for i, v in enumerate(tree)}


def tensor_leaves(tree):
    """The tensors or arrays of ``tree``, as they are (no copy)."""
    if isinstance(tree, nn.Module):
        return list(tree.state_dict().values())
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(v)]
    return [tree]


def finite_check(x: torch.Tensor, tag: str, enabled: bool = True
                 ) -> torch.Tensor:
    """Print a warning when ``x`` holds a non-finite value; returns ``x``.
    The verdict is read on the host, so on the card each call synchronises
    with the device."""
    if not enabled:
        return x
    if not bool(torch.isfinite(x).all()):
        v = x.detach().float()
        v = v[~torch.isnan(v)]
        mn, mx = ((v.min(), v.max()) if v.numel() else
                  (torch.tensor(float("nan")),) * 2)
        print("[NaNGuard] non-finite activations after " + tag +
              f" (min={np.float32(mn.item())}, max={np.float32(mx.item())})")
    return x


def tree_norm(tree) -> float:
    """Global L2 norm over ``tree``: each leaf's sum of squares in fp32, the
    sum of those on the host."""
    sq = sum(float(torch.sum(torch.square(torch.as_tensor(t).float())))
             for t in tensor_leaves(tree))
    return float(np.sqrt(sq))


def tree_stats(tree, top_k: int = 10) -> Dict[str, Dict[str, float]]:
    """Per-leaf {norm, max_abs, nonfinite}, by flax path, sorted by norm."""
    stats = {}
    for path, leaf in named_leaves(tree).items():
        arr = np.asarray(_host(leaf), np.float32)
        stats[path] = {
            "norm": float(np.linalg.norm(arr)),
            "max_abs": float(np.abs(arr).max()) if arr.size else 0.0,
            "nonfinite": int((~np.isfinite(arr)).sum()),
        }
    return dict(sorted(stats.items(), key=lambda kv: -kv[1]["norm"])[:top_k])


def dump_bad_batch(save_dir: str, batch: Dict, metrics: Dict,
                   step: int) -> str:
    """Serialize the failing batch and its scalar metrics for offline repro
    (``bad_batch_step{step}.npz``: the batch's keys, then ``metric_<k>``)."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"bad_batch_step{step}.npz")
    arrays = {k: _host(v) for k, v in batch.items()}
    arrays.update({f"metric_{k}": np.asarray(float(v))
                   for k, v in metrics.items() if np.ndim(_host(v)) == 0})
    np.savez_compressed(path, **arrays)
    return path


class DebugProbe:
    """Host-side training guard: detects non-finite metrics, dumps
    batches. Per-stage guards are ``finite_check`` in the caller; this
    probe watches the step outputs."""

    def __init__(self, enabled: bool = False, save_dir: str = "./out/debug",
                 log_every: int = 1, save_bad_batch: bool = True):
        self.enabled = enabled
        self.save_dir = save_dir
        self.log_every = log_every
        self.save_bad = save_bad_batch
        self.step = 0

    def after_step(self, batch: Dict, metrics: Dict, grads=None) -> bool:
        """True when every scalar metric is finite. On failure, prints the
        largest gradients, dumps the batch (if configured) and returns
        False."""
        if not self.enabled:
            return True
        self.step += 1
        bad = [k for k, v in metrics.items()
               if np.ndim(_host(v)) == 0 and not np.isfinite(float(v))]
        if bad:
            print(f"[DebugProbe] non-finite metrics at step {self.step}: {bad}")
            if grads is not None:
                for name, st in tree_stats(grads, top_k=5).items():
                    print(f"[DebugProbe]   grad {name}: {st}")
            if self.save_bad:
                path = dump_bad_batch(self.save_dir, batch, metrics, self.step)
                print(f"[DebugProbe] batch dumped to {path}")
            return False
        if self.step % self.log_every == 0 and grads is not None:
            print(f"[DebugProbe] step {self.step} grad_norm="
                  f"{tree_norm(grads):.3e}")
        return True


def layer_forensics(model: nn.Module, *args, top_k: int = 20,
                    **kwargs) -> Dict[str, Dict[str, float]]:
    """Per-module activation forensics: one ``model(*args, **kwargs)``
    under ``no_grad`` with a forward hook on every module. Returns {path:
    {shape, dtype, norm, max_abs, nonfinite}}, sorted by norm, the path as
    flax's ``capture_intermediates`` names it ("encoder/conv2_0/__call__",
    "__call__" for ``model`` itself). A module called more than once
    reports its first call whose output is a tensor; one that returns a
    tuple or a dict every time reports nothing, as in the JAX package. A
    module run other than through its ``__call__`` (a block inside a
    chained launch, a conv whose weights a kernel reads) reports nothing
    either."""
    outputs: Dict[str, torch.Tensor] = {}

    def hook(path):
        def fn(module, inputs, out):
            if path not in outputs and isinstance(out, torch.Tensor):
                outputs[path] = out.detach()
        return fn

    handles = [m.register_forward_hook(
        hook("/".join(name.split(".") + ["__call__"]) if name else
             "__call__")) for name, m in model.named_modules()]
    try:
        with torch.no_grad():
            model(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    stats = {}
    for path, out in outputs.items():
        arr = np.asarray(_host(out), np.float32)
        stats[path] = {
            "shape": tuple(arr.shape),
            "dtype": _dtype_name(out),
            "norm": float(np.linalg.norm(arr)),
            "max_abs": float(np.abs(arr).max()) if arr.size else 0.0,
            "nonfinite": int((~np.isfinite(arr)).sum()),
        }
    return dict(sorted(stats.items(), key=lambda kv: -kv[1]["norm"])[:top_k])


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if isinstance(x, nn.Module):
        return copy.deepcopy(x).cpu()
    if isinstance(x, Mapping):
        return type(x)((k, _to_cpu(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def keyed_leaves(tree, prefix: str = ""):
    """(key, leaf) pairs of a nested output, keyed as
    ``jax.tree_util.keystr`` keys the same structure: dicts in sorted key
    order as ``[<repr of key>]``, sequences as ``[i]``; None is no leaf."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        return [kv for k in sorted(tree)
                for kv in keyed_leaves(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in keyed_leaves(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def cpu_cross_check(fn, *args, atol: float = 1e-4) -> Dict[str, float]:
    """Run ``fn(*args)`` as given, then on CPU copies of the arguments
    (every tensor, and every ``nn.Module`` deep-copied, inside dicts, lists
    and tuples too), and return each output's max |diff| keyed as
    ``jax.tree_util.keystr`` keys it ("['dpb']['frame']"). On the CPU the
    port runs its kernels' plain versions, so with arguments on the card
    this holds the kernels against them end to end."""
    out_default = fn(*args)
    out_cpu = fn(*_to_cpu(args))
    diffs = {}
    for (name, a), (_, b) in zip(keyed_leaves(out_default),
                                 keyed_leaves(out_cpu)):
        d = float(np.max(np.abs(np.asarray(_host(a), np.float32)
                                - np.asarray(_host(b), np.float32))))
        diffs[name] = d
        if d > atol:
            print(f"[cpu_cross_check] {name}: max|diff|={d:.3e} > {atol}")
    return diffs
