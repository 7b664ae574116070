"""Process groups, the device mesh and the collectives of data-parallel
training: the JAX package's ``parallel/mesh.py`` over ``torch.distributed``.

The codec is a small convnet, so training scales by pure data parallelism,
as the reference's Lightning DDP did: one process per card, parameters
replicated, each rank a disjoint shard of the batch, the gradient averaged
over the ranks. Where XLA inserts that all-reduce into a jitted step, the
port's ``training/optimizers.TrainOptimizer`` calls :func:`all_reduce_mean_`
on the accumulation boundary, before the clip.

A :class:`Mesh` names its axes as the JAX mesh does ("data", or "data" x
"spatial") and holds one process group per axis, from
``torch.distributed.device_mesh.init_device_mesh`` where a process group
exists. Without one, a world-1 mesh needs no launcher: its groups are None
and every collective here does nothing.

The JAX module's ``batch_sharding`` and ``replicated`` return
``NamedSharding`` specs for a global array. They have no counterpart: a
rank holds its batch shard and its replica as plain tensors, so
:func:`shard_batch` moves the rank's own batch to its device and
:func:`replicate` broadcasts rank 0's tensors.

Gloo moves CPU tensors only for some collectives (send and receive among
them), so with a gloo group every collective here stages a CUDA tensor
through host memory; with NCCL the tensors stay on the card. The backend is
read from the group.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["maybe_init_distributed", "local_rank", "Mesh", "make_mesh",
           "shard_batch", "replicate", "all_reduce_sum_", "all_reduce_max_",
           "all_reduce_mean_",
           "group_sum", "all_gather_cat", "broadcast_", "mean_metrics",
           "group_size", "group_rank"]


def maybe_init_distributed(device=None) -> bool:
    """Join the process group of a multi-process launch; True when one is
    initialised (now or before), False for a single process.

    Triggers, as the JAX function's: ``SSGVC_DIST=1``, torchrun's env
    (``WORLD_SIZE`` > 1 with ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``) or SLURM's (``SLURM_NTASKS`` > 1, ``SLURM_PROCID``,
    ``SLURM_LOCALID``; the job exports ``MASTER_ADDR`` / ``MASTER_PORT``).
    ``device`` (default "cuda") picks the backend: NCCL for the card, after
    ``torch.cuda.set_device(LOCAL_RANK)``, gloo for "cpu". Idempotent. A
    rank that cannot join raises."""
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ
    world = int(env.get("WORLD_SIZE", env.get("SLURM_NTASKS", "1")))
    if env.get("SSGVC_DIST") != "1" and world <= 1:
        return False
    rank = int(env.get("RANK", env.get("SLURM_PROCID", "0")))
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        torch.cuda.set_device(local_rank() if device.index is None
                              else device.index)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=rank)
    return True


def local_rank() -> int:
    """This process's rank on its host (torchrun's ``LOCAL_RANK``, SLURM's
    ``SLURM_LOCALID``); 0 for a single process."""
    env = os.environ
    return int(env.get("LOCAL_RANK", env.get("SLURM_LOCALID", "0")))


class Mesh:
    """Named axes over the ranks, in row-major order (rank = data index x
    spatial size + spatial index), with one process group per axis (None
    on a world-1 mesh without a process group) and the rank's device."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 device: torch.device, device_mesh=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.device = device
        self.device_mesh = device_mesh

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def group(self, axis: str):
        """The process group along ``axis``; None without a process
        group."""
        self._check(axis)
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        self._check(axis)
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def _check(self, axis: str) -> None:
        if axis not in self.shape:
            raise KeyError(f"mesh has axes {self.axis_names}, not {axis!r}")

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",), spatial: int = 1,
              device=None) -> Mesh:
    """The mesh over every rank of the process group (after
    :func:`maybe_init_distributed`), one device a rank.

    1-D (default): pure data parallelism. 2-D with ``axis_names=("data",
    "spatial")`` and ``spatial=M``: N/M groups of streams, each stream's
    frame row-sharded M ways (``parallel/spatial.py``). ``n_devices``, when
    given, must be the rank count: a rank is a process, so the mesh cannot
    leave ranks out as the JAX mesh leaves devices out. Without a process
    group only n <= 1 is possible. ``device`` (default "cuda", the card of
    ``torch.cuda.current_device()`` under a process group) is the rank's
    device."""
    maybe_init_distributed(device)
    device = torch.device("cuda" if device is None else device)
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    if n_devices is not None and n_devices > 0 and n_devices != world:
        if n_devices > world:
            how = ("the process group has" if grouped else
                   "no process group is initialised (launch one process "
                   "per device with torchrun, or set SSGVC_DIST=1 with "
                   "its env), so")
            raise ValueError(
                f"make_mesh: {n_devices} devices requested but only {world} "
                f"visible: {how} {world} rank(s). Lower num_devices, or "
                f"launch {n_devices} processes.")
        raise ValueError(
            f"make_mesh: {n_devices} devices requested but the process "
            f"group has {world} ranks; a rank is one device, so num_devices "
            f"must equal the rank count")
    if len(axis_names) == 1:
        shape: Tuple[int, ...] = (world,)
    elif len(axis_names) == 2:
        if spatial <= 0 or world % spatial:
            raise ValueError(f"make_mesh: spatial={spatial} must divide the "
                             f"device count {world}")
        shape = (world // spatial, spatial)
    else:
        raise NotImplementedError("1-D data or 2-D data x spatial meshes")
    if not grouped:
        return Mesh(axis_names, shape, device)
    from torch.distributed.device_mesh import init_device_mesh

    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    # the groups carry the collectives; the tensors stay on the rank's
    # device whatever the mesh's device type says
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(axis_names, shape, device,
                init_device_mesh(kind, shape, mesh_dim_names=tuple(
                    axis_names)))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _tree_map(lambda t: out.append(t) if torch.is_tensor(t) else None, tree)
    return out


def shard_batch(mesh: Mesh, batch):
    """The rank's own batch (tensors or numpy arrays, any nesting of dicts,
    lists and tuples) as tensors on the mesh's device. As the JAX
    function's multi-process branch, each rank passes its local shard (the
    data module's rank stride); a single process passes the whole batch."""
    return _tree_map(lambda x: torch.as_tensor(x).to(mesh.device), batch)


def replicate(mesh: Mesh, tree):
    """Rank 0's values in every tensor of ``tree`` (a module, whose
    parameters and buffers are taken, or a nested dict / list of
    tensors), broadcast over the data group in place; returns ``tree``."""
    if isinstance(tree, torch.nn.Module):
        tensors = [t.data for t in tree.parameters()] + list(tree.buffers())
    else:
        tensors = _leaves(tree)
    broadcast_(tensors, mesh.group("data"))
    return tree


# ----------------------------------------------------------- collectives --

def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(group, t: torch.Tensor) -> bool:
    """Whether ``t`` goes through host memory for ``group``'s backend."""
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _flat_by_dtype(tensors: Sequence[torch.Tensor]
                   ) -> Dict[torch.dtype, List[int]]:
    by: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by.setdefault(t.dtype, []).append(i)
    return by


@torch.no_grad()
def _flat_collective(tensors: Sequence[torch.Tensor], group, op) -> None:
    """``op(flat, group)`` on one flat buffer per dtype of ``tensors``,
    written back in place."""
    for idx in _flat_by_dtype(tensors).values():
        parts = [tensors[i] for i in idx]
        flat = torch.cat([p.reshape(-1) for p in parts])
        staged = _staged(group, flat)
        buf = flat.cpu() if staged else flat
        op(buf, group)
        if staged:
            flat.copy_(buf)
        off = 0
        for p in parts:
            n = p.numel()
            p.copy_(flat[off:off + n].view_as(p))
            off += n


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group) -> None:
    """Each tensor summed over ``group`` in place: one all-reduce per flat
    buffer per dtype. Nothing happens for a None group."""
    if group is None or not tensors:
        return
    _flat_collective(tensors, group,
                     lambda buf, g: dist.all_reduce(buf, group=g))


def all_reduce_max_(tensors: Sequence[torch.Tensor], group) -> None:
    """Each tensor maxed over ``group`` in place, as
    :func:`all_reduce_sum_` sums."""
    if group is None or not tensors:
        return
    _flat_collective(tensors, group, lambda buf, g: dist.all_reduce(
        buf, op=dist.ReduceOp.MAX, group=g))


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group) -> None:
    """Each tensor averaged over ``group`` in place (the sum of one
    all-reduce per flat buffer per dtype, divided by the group's size)."""
    if group is None or not tensors:
        return
    n = group_size(group)
    all_reduce_sum_(tensors, group)
    for t in tensors:
        t.div_(n)


def broadcast_(tensors: Sequence[torch.Tensor], group) -> None:
    """Each tensor set to the group's rank 0's in place: one broadcast per
    flat buffer per dtype."""
    if group is None or not tensors:
        return
    src = dist.get_global_rank(group, 0)
    _flat_collective(tensors, group,
                     lambda buf, g: dist.broadcast(buf, src, group=g))


class _GroupSum(torch.autograd.Function):
    """The sum over a group, with the sum over the group as its backward:
    every rank that takes f(sum) gets d f / d x_r scaled by the group's
    size, which the gradient's mean over the ranks divides back out."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.detach().clone()
        all_reduce_sum_([out], group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        all_reduce_sum_([grad], ctx.group)
        return grad, None


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, differentiable (:class:`_GroupSum`);
    ``x`` itself for a None group."""
    if group is None:
        return x
    return _GroupSum.apply(x, group)


@torch.no_grad()
def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in rank
    order; ``t`` itself for a None group."""
    if group is None:
        return t
    src = t.contiguous()
    staged = _staged(group, src)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(group_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def mean_metrics(metrics: Dict[str, torch.Tensor], group
                 ) -> Dict[str, torch.Tensor]:
    """The 0-d tensors of ``metrics`` averaged over ``group`` with one
    all-reduce, as fp32 detached tensors in the same key order."""
    if group is None:
        return metrics
    keys = list(metrics)
    dev = next(iter(metrics.values())).device
    vals = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32,
                                        device=dev).detach().reshape(())
                        for k in keys])
    all_reduce_mean_([vals], group)
    return {k: vals[i] for i, k in enumerate(keys)}
