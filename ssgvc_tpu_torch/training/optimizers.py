"""Optimizers with optax's semantics, as the JAX package's trainer chains
them: a global-norm clip, then one optimizer per parameter label (each
with its own learning-rate schedule and weight decay), optionally behind
``optax.MultiSteps``' gradient accumulation.

  * ``adamw``: ``torch.optim.AdamW`` (decoupled decay, as ``optax.adamw``);
  * ``adam``: ``torch.optim.Adam`` with L2 added to the gradient (optax:
    ``add_decayed_weights`` before ``adam``);
  * ``lion``: :class:`Lion`, written here (``optax.lion``: b1 0.9, b2 0.99,
    decoupled decay).

:class:`TrainOptimizer` is the chain: :func:`clip_by_global_norm_` with
optax's formula g * c / ||g|| when ||g|| >= c (``clip_grad_norm_`` adds
1e-6 to the norm and is not the same), then each label's optimizer; with
``every_k`` > 1 it keeps the running mean of k micro-batches' gradients and
applies it on the k-th, with no update and no weight decay between. Given
a data-parallel ``group``, the gradient that the clip sees is the mean over
the group's ranks (``parallel.mesh.all_reduce_mean_``: one all-reduce per
flat buffer per dtype, on the accumulation boundary), what XLA's psum gives
the JAX step: the ranks' local means of equal shards, averaged, are the
global batch's mean.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from ..parallel.mesh import all_reduce_mean_
from .schedule import warmup_cosine

LrFn = Callable[[int], float]


class Lion(torch.optim.Optimizer):
    """optax.lion: u = sign((1 - b1) g + b1 m); m <- b2 m + (1 - b2) g;
    p <- p - lr (u + weight_decay p)."""

    def __init__(self, params, lr: float = 1e-4, b1: float = 0.9,
                 b2: float = 0.99, weight_decay: float = 1e-3):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p)
                mu = state["mu"]
                u = torch.sign((1.0 - b1) * g + b1 * mu)
                mu.mul_(b2).add_((1.0 - b2) * g)
                p.sub_(group["lr"] * (u + group["weight_decay"] * p))


def make_optimizer(name: str, params, lr: float,
                   weight_decay: float = 0.01) -> torch.optim.Optimizer:
    """'adamw' | 'adam' | 'lion' over ``params`` (tensors or param
    groups), with optax's semantics."""
    name = name.lower()
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay)
    if name == "adam":
        # L2 in the gradient, as optax.add_decayed_weights before adam
        return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)
    if name == "lion":
        return Lion(params, lr=lr, weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {name!r}")


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element's square, in fp32."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: every g becomes (g / ||g||) *
    max_norm when ||g|| >= max_norm. Returns ||g|| before the clip."""
    norm = global_norm(grads)
    if not bool(norm < max_norm):
        for g in grads:
            g.copy_((g / norm.to(g.dtype)) * max_norm)
    return norm


def aux_label(path) -> str:
    """'aux' for bit-estimator params, 'main' otherwise."""
    return "aux" if "bit_estimator" in "/".join(map(str, path)) else "main"


class TrainOptimizer:
    """clip -> per-label optimizers [-> every-k accumulation], stepping the
    parameters' ``.grad``.

    ``named_params``: (name, parameter) pairs; ``label_fn(path)`` labels
    each by its dotted name split into a path; ``groups`` maps a label to
    (lr schedule of the applied-update count, weight decay). A label
    missing from ``groups`` is frozen: its gradient counts in the clip's
    norm, but it is never updated (optax.set_to_zero). ``group``: the
    data-parallel process group whose ranks' gradients are averaged before
    the clip (None: one device).
    """

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 label_fn: Callable, groups: Dict[str, Tuple[LrFn, float]],
                 optimizer_type: str = "adamw",
                 grad_clip: Optional[float] = 5.0, every_k: int = 1,
                 group=None):
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.labels = [label_fn(tuple(n.split("."))) for n, _ in named]
        by_label: Dict[str, List[torch.Tensor]] = {}
        for p, lab in zip(self.params, self.labels):
            if lab in groups:
                by_label.setdefault(lab, []).append(p)
        self.lr_fns = {lab: groups[lab][0] for lab in by_label}
        self.optimizer = make_optimizer(
            optimizer_type,
            [dict(params=ps, lr=self.lr_fns[lab](0),
                  weight_decay=groups[lab][1], label=lab)
             for lab, ps in by_label.items()],
            lr=0.0)
        self.grad_clip = grad_clip
        self.every_k = max(int(every_k or 1), 1)
        self.group = group
        self.count = 0          # applied updates
        self.mini_step = 0      # micro-batches accumulated since the last
        self._acc: Optional[List[torch.Tensor]] = None

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> bool:
        """Take this micro-batch's gradients (``.grad``; None counts as
        zero). Returns True when the parameters were updated."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.every_k > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(p) for p in self.params]
            n = self.mini_step
            for a, g in zip(self._acc, grads):
                a.add_((g - a) / (n + 1))      # the running mean (Welford)
            self.mini_step = (n + 1) % self.every_k
            if self.mini_step:
                return False
            grads = [a.clone() for a in self._acc]
            for a in self._acc:
                a.zero_()
        all_reduce_mean_(grads, self.group)
        if self.grad_clip is not None:
            clip_by_global_norm_(grads, self.grad_clip)
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_fns[group["label"]](self.count)
        self.optimizer.step()
        self.count += 1
        return True

    def state_dict(self) -> Dict:
        """Everything a resume needs, keyed by parameter name: the applied
        update count, the micro-step count, the accumulated gradient mean
        (``acc``: None before the first accumulated micro-batch) and each
        parameter's inner-optimizer state (none before its first update).
        The tensors are the live ones, not copies."""
        order = self._inner_order()
        return {"count": self.count, "mini_step": self.mini_step,
                "acc": (None if self._acc is None
                        else dict(zip(self.names, self._acc))),
                "state": {order[i]: s for i, s in
                          self.optimizer.state_dict()["state"].items()}}

    def load_state_dict(self, sd: Dict) -> None:
        """The inverse of :meth:`state_dict`: the inner state of exactly
        the parameters ``sd`` names (others start afresh), on each
        parameter's device."""
        missing = [n for n in self.names
                   if sd["acc"] is not None and n not in sd["acc"]]
        if missing:
            raise KeyError(f"optimizer state lacks the accumulated gradient "
                           f"of {missing[:5]}")
        self.count = int(sd["count"])
        self.mini_step = int(sd["mini_step"])
        self._acc = (None if sd["acc"] is None else
                     [sd["acc"][n].to(p.device, p.dtype).clone()
                      for n, p in zip(self.names, self.params)])
        inner = self.optimizer.state_dict()
        inner["state"] = {i: sd["state"][n]
                          for i, n in enumerate(self._inner_order())
                          if n in sd["state"]}
        self.optimizer.load_state_dict(inner)

    def _inner_order(self) -> List[str]:
        """Parameter names in the order the inner optimizer's state_dict
        numbers them (its groups', not ``self.params``')."""
        name_of = {id(p): n for n, p in zip(self.names, self.params)}
        return [name_of[id(p)] for g in self.optimizer.param_groups
                for p in g["params"]]


def create_optimizers(named_params, optimizer_type: str = "adamw",
                      base_lr: float = 1e-4, min_lr: float = 1e-5,
                      aux_lr: float = 5e-4, weight_decay: float = 0.01,
                      warmup_iters: int = 0, total_iters: int = 10000,
                      grad_clip: float = 5.0,
                      label_fn: Optional[Callable] = None,
                      group=None) -> TrainOptimizer:
    """The main / aux split: warmup-cosine on 'main', the fixed ``aux_lr``
    on 'aux', the global-norm clip in front; ``group`` as
    :class:`TrainOptimizer`'s."""
    sched = warmup_cosine(base_lr, min_lr, warmup_iters, total_iters)
    return TrainOptimizer(
        named_params, label_fn or aux_label,
        {"main": (sched, weight_decay),
         "aux": (lambda _: aux_lr, weight_decay)},
        optimizer_type, grad_clip, group=group)
