"""Checkpoints of the port, and the import of pretrained weights.

A checkpoint is one ``torch.save`` file of plain tensors, ints and dicts,
loadable with ``weights_only=True``. It holds what the JAX package's
``TrainState`` holds:

  * ``params_p``, ``params_i``: the DMC's and the DMCI's state_dicts;
  * ``opt_state``: ``TrainOptimizer.state_dict()`` (the inner optimizer's
    state, the update and micro-step counts, the accumulated gradients);
  * ``step``, ``alm_mu``, ``alm_h_accum``, ``alm_h_count``.

This is the port's own format. The JAX package writes orbax directories,
and reading them needs JAX, so the port reads neither orbax nor JAX
checkpoints; weights cross between the packages as flax trees
(``utils/weights.py``) or as reference state dicts (``load_pretrained``).

``CheckpointManager`` keeps ``last`` and the ``top_k`` best checkpoints by
``val/loss``; ``load_pretrained`` imports reference DCVC-RT checkpoints
(``utils/torch_import.py``) or a port checkpoint's DMCI.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from ..training.trainer import TrainState
from .torch_import import DEFAULT_OK_LEAVES

SCALARS = ("alm_mu", "alm_h_accum", "alm_h_count")


def _cpu(tree):
    """Copies of every tensor in ``tree`` on the CPU."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def train_checkpoint(trainer, state: TrainState) -> Dict:
    """The checkpoint of ``trainer`` (its models and optimizer) at
    ``state``, as CPU copies."""
    return _cpu({"params_p": trainer.dmc.state_dict(),
                 "params_i": trainer.dmci.state_dict(),
                 "opt_state": trainer.tx.state_dict(),
                 "step": int(state.step),
                 **{k: getattr(state, k) for k in SCALARS}})


def image_checkpoint(dmci) -> Dict:
    """The image trainer's checkpoint: the DMCI's state_dict under
    ``params_i`` (what :func:`load_pretrained` imports), as CPU copies."""
    return _cpu({"params_i": dmci.state_dict()})


def save_checkpoint(path: str, ckpt: Dict) -> str:
    """Write ``ckpt`` (from :func:`train_checkpoint`) to ``path``, through a
    temporary file and a rename, so a reader never sees a partial file."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
    return path


class CheckpointManager:
    """``last`` on every save, and the ``top_k`` best checkpoints by
    ``monitor`` (``step<N>``; ``mode`` "min" or "max")."""

    def __init__(self, directory: str, monitor: str = "val/loss",
                 top_k: int = 3, mode: str = "min"):
        self.directory = directory
        self.monitor = monitor
        self.top_k = top_k
        self.mode = mode
        self._best: list = []  # [(metric, path)], best first

    def save(self, ckpt: Dict, metrics: dict, step: int) -> str:
        last = os.path.join(self.directory, "last")
        save_checkpoint(last, ckpt)
        value = metrics.get(self.monitor)
        if value is None:
            return last
        value = float(value)
        sign = 1.0 if self.mode == "min" else -1.0
        path = os.path.join(self.directory, f"step{step}")
        if (len(self._best) < self.top_k
                or sign * value < sign * self._best[-1][0]):
            save_checkpoint(path, ckpt)
            self._best.append((value, path))
            self._best.sort(key=lambda kv: sign * kv[0])
            while len(self._best) > self.top_k:
                _, drop = self._best.pop()
                os.remove(drop)
        return last

    @property
    def best_path(self):
        return self._best[0][1] if self._best else None


def _graft(template: Dict, saved: Dict, path: str, what: str) -> Dict:
    """``template``'s keys from ``saved``; a key ``saved`` lacks keeps the
    template's value if its last component is in DEFAULT_OK_LEAVES (and is
    printed), else raises KeyError. Keys only ``saved`` has are dropped."""
    out = {}
    for k, v in template.items():
        if k in saved:
            out[k] = saved[k]
        elif k.rsplit(".", 1)[-1] in DEFAULT_OK_LEAVES:
            print(f"[ckpt] {path}: no {what}/{k}; kept the model's value")
            out[k] = v
        else:
            raise KeyError(f"checkpoint {path} lacks {what}/{k!r}, which is "
                           f"not a default leaf ({sorted(DEFAULT_OK_LEAVES)})")
    return out


def restore_checkpoint(path: str, trainer=None):
    """The checkpoint at ``path``: its raw dict, or, given ``trainer`` (after
    ``init_state``, whose values fill DEFAULT_OK_LEAVES parameters the
    checkpoint lacks), loaded into the trainer's models and optimizer, with
    the TrainState returned."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    if trainer is None:
        return ck
    if trainer.tx is None:
        raise RuntimeError("restore_checkpoint: init_state first")
    missing = [k for k in ("params_p", "params_i", "opt_state", "step",
                           *SCALARS) if k not in ck]
    if missing:
        raise KeyError(f"checkpoint {path} lacks {missing}")
    trainer.dmc.load_state_dict(
        _graft(trainer.dmc.state_dict(), ck["params_p"], path, "params_p"))
    trainer.dmci.load_state_dict(
        _graft(trainer.dmci.state_dict(), ck["params_i"], path, "params_i"))
    opt = dict(ck["opt_state"])
    if opt["acc"] is not None:
        live = dict(zip(trainer.tx.names, trainer.tx.params))
        opt["acc"] = _graft({n: torch.zeros_like(p) for n, p in live.items()},
                            opt["acc"], path, "opt_state/acc")
    trainer.tx.load_state_dict(opt)
    dev = trainer.device
    return TrainState(step=int(ck["step"]),
                      **{k: ck[k].to(dev) for k in SCALARS})


def _is_port_checkpoint(obj) -> bool:
    return isinstance(obj, dict) and isinstance(obj.get("params_i"), dict)


def load_pretrained(trainer, cfg) -> TrainState:
    """A fresh TrainState (``init_state`` seeded by ``cfg.seed``) with
    pretrained weights imported: ``cfg.image_checkpoint_path`` into the
    DMCI, a reference DCVC-RT checkpoint (strict) or a port checkpoint that
    holds ``params_i``; ``cfg.video_checkpoint_path`` into the DMC, a
    reference checkpoint whose wrapper prefix is found by
    ``normalize_prefix``, parameters it lacks kept from the init. The
    optimizer is init_state's, with no state."""
    from .torch_import import (align_state_dict, convert_state_dict,
                               load_torch_checkpoint, normalize_prefix)

    state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))
    path = cfg.image_checkpoint_path
    if path and os.path.exists(path):
        raw = torch.load(path, map_location="cpu", weights_only=True)
        template = trainer.dmci.state_dict()
        if _is_port_checkpoint(raw):
            loaded = raw["params_i"]
            shapes = lambda sd: {k: tuple(v.shape) for k, v in sd.items()}
            if shapes(loaded) != shapes(template):
                raise ValueError(
                    f"DMCI params in {path} do not match the configured "
                    "model (profile or channels)")
        else:
            loaded = align_state_dict(
                convert_state_dict(load_torch_checkpoint(path)), template)
        trainer.dmci.load_state_dict(loaded)
        print(f"[ckpt] imported image model from {path}")

    path = cfg.video_checkpoint_path
    if path and os.path.exists(path):
        template = trainer.dmc.state_dict()
        sd = normalize_prefix(load_torch_checkpoint(path), template.keys())
        flat = convert_state_dict(sd)
        try:
            params_p = align_state_dict(flat, template)
        except KeyError as e:
            print(f"[ckpt] partial video import ({e}); keeping the init "
                  "for the missing params")
            params_p = {k: (flat[k] if k in flat and flat[k].shape == v.shape
                            else v) for k, v in template.items()}
        trainer.dmc.load_state_dict(params_p)
        print(f"[ckpt] imported video model from {path}")
    return state
