"""Row (H) sharding of one stream's P-frame over ranks: the JAX package's
``parallel/spatial.py`` (``jit_spatial_pframe``) without an SPMD
partitioner.

The data mesh (``parallel/mesh.py``) scales throughput: independent streams
per rank. This module scales latency for one stream: the frame's rows are
split over the ranks of a group, every op runs on the rank's slab, and only
halo rows, a few boundary rows and the frame's reductions cross between
ranks. Under JAX, XLA's partitioner inserts those exchanges. Here the
layers do it themselves: while a :func:`row_shard` context is active, an op
with vertical reach k takes k rows from each neighbour slab, runs on the
taller slab and crops its output by k. At the true image edge there is no
neighbour and the op's own padding stands, so the result is the unsharded
one: every other op is per pixel. The ops with reach:

  * ``layers/blocks.Conv`` with a kernel > 1, on the float and the int8
    route (the 3x3 stride-2 convs of ``Encoder.down`` / ``SFT.down``, which
    need only the row above a slab, the 3x3 conv of ``Decoder.up``,
    ``MaskFiLM.net_0``, the mask predictor's 3x3s); the 2x2 stride-2 convs
    of the hyper encoder have no reach on slabs of even rows;
  * ``layers/blocks.DepthConvBlock``: the dw3x3 inside the ``dcb`` kernel,
    one row each side (or of the int8 composition's dw3x3);
  * ``layers/blocks.run_chain``: N rows each side for a chain of N blocks;
  * ``models/dmc.MaskPredictor`` (``mask_prop``): the antialiased bilinear
    downscale by f takes f rows a side, the upscale one low-resolution row.

The layers consult the context through :func:`halo` and :func:`crop`,
which do nothing without one: with no context the layers run exactly as
they do unsharded, the same launches and the same outputs.

Global quantities: the bits' sum of ``models/common.bpp_from_bits`` is the
frame's (:func:`frame_sum`), ``DMC.forward`` divides by the frame's pixels
(:func:`frame_rows`), and the int8 route's mode-1 abs-max is the global
tensor's (:func:`frame_max`): over the row group and, under a data mesh,
over the batch group too, as ``jnp.max`` reduces an array sharded under
``jit``. A :func:`batch_shard` context names that batch group; the
``Trainer`` enters one with its data group.

Slabs: :func:`shard_rows` hands out even slabs of H/n rows (the JAX
package's partition). The layers run on slabs of whole :data:`SLAB_ROWS`
pixel-row units (8 packed rows with packed io), so that every scale down to
z (1/64) holds whole rows on every rank and a slab starts on an even row at
every stride-2 conv and at y's scale (1/16), where the checkerboard prior's
parity is therefore the slab's own. :func:`spatial_pframe` moves rows
between ranks once on entry, from the even partition to units
(:func:`unit_bounds`: each boundary at the unit nearest the even one, so a
rank holds the floor or the ceiling of units / ranks), and the new DPB back
on exit: 1088 rows over 8 ranks, 136 each, run on slabs of 128 rows and one
of 192 (rank 3). Where H is not whole units, the last slab ends at the
frame's bottom and holds the partial unit beside at least one whole unit:
only there does ``pad_for_y`` pad rows, as it pads the unsharded frame's
bottom (720 rows over 2 ranks: 384 and 336). Where units are fewer than
ranks, some ranks hold no rows: the forward runs on the ranks that hold
rows (their halos go between the nearest of them, the frame's sums and
maxima over them alone, :meth:`RowShard.reduce`), and the others take the
DPB's rows back on exit and the bpp by a broadcast (128 rows over 4 ranks:
64, 0, 64, 0). The one H refused is the one the JAX
package refuses: rows that do not split into even slabs of a multiple of 8
pixel rows.

Halo rows go by ``torch.distributed.batch_isend_irecv`` with the up and
down neighbours in the group, the moves' rows with each rank whose slab
overlaps the wanted one; with a gloo group a CUDA tensor's
rows are staged through host memory (gloo sends CPU tensors only), with
NCCL they move device to device. Nothing all-gathers an activation: a
rank's activation memory is its slab's plus the halos.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import (Mesh, _tree_map, all_gather_cat, all_reduce_max_,
                   all_reduce_sum_, group_rank, group_size)

__all__ = ["SLAB_ROWS", "RowSharding", "row_sharding", "RowShard",
           "row_shard", "batch_shard", "current", "halo", "crop",
           "frame_sum", "frame_max", "frame_groups", "frame_rows",
           "unit_bounds", "spatial_pframe", "shard_rows", "gather_rows"]

#: the pixel rows of the unit a rank's working slab is made of (z is 1/64)
SLAB_ROWS = 64
#: bytes of halo rows this process has sent (a counter, as the kernels'
#: launch counts)
halo_bytes = 0
#: bytes of rows this process has sent moving slabs between the even
#: partition and whole units (:func:`spatial_pframe`)
move_bytes = 0


def unit_bounds(rows: int, count: int, unit: int) -> List[int]:
    """The ``count + 1`` boundaries of ``rows`` split into slabs of whole
    ``unit`` rows, each at the unit nearest the even boundary r * rows /
    count (a half rounds up), the last at ``rows``. Where ``rows`` is not
    whole units, no boundary but the last passes the last whole unit but
    one, so the last slab that holds rows holds the partial unit beside a
    whole one (or the frame alone, below one unit). A slab is empty where
    units are fewer than ranks. Raises where the JAX package refuses a
    row shard: ``rows`` that do not split into even slabs of a multiple of
    8 pixel rows (``unit`` is :data:`SLAB_ROWS` pixel rows)."""
    pixel = rows // count * (SLAB_ROWS // unit)
    if rows % count or pixel % 8:
        raise ValueError(
            f"row shard: {rows} rows over {count} ranks: the slabs must be "
            "even and a multiple of 8 pixel rows (the JAX package's rule, "
            "H / n_devices % 8 == 0)")
    whole, part = divmod(rows, unit)
    last = max(0, whole - 1) if part else whole
    cut = lambda r: unit * min(last, (2 * r * rows + count * unit)
                               // (2 * count * unit))
    return [cut(r) for r in range(count)] + [rows]


@dataclass(frozen=True)
class RowSharding:
    """How a mesh splits NHWC tensors: H over the ``group`` (``count``
    ranks, this one ``index``), B over the ``batch_group`` (``batch_count``
    ranks, this one ``batch_index``). Groups are None on a world-1 mesh."""
    group: object
    index: int
    count: int
    batch_group: object = None
    batch_index: int = 0
    batch_count: int = 1

    def bounds(self, h: int, unit: Optional[int] = None) -> List[int]:
        """Every rank's slab boundaries of ``h`` rows: even slabs, or with
        ``unit`` whole units (:func:`unit_bounds`)."""
        if unit is not None:
            return unit_bounds(h, self.count, unit)
        if h % self.count:
            raise ValueError(f"{h} rows do not split evenly over "
                             f"{self.count} ranks")
        return [r * (h // self.count) for r in range(self.count + 1)]

    def rows(self, h: int, unit: Optional[int] = None) -> Tuple[int, int]:
        """This rank's [start, stop) of ``h`` rows (:meth:`bounds`)."""
        b = self.bounds(h, unit)
        return b[self.index], b[self.index + 1]

    def batch(self, b: int) -> Tuple[int, int]:
        """This rank's [start, stop) of a batch of ``b``."""
        if b % self.batch_count:
            raise ValueError(f"a batch of {b} does not split evenly over "
                             f"{self.batch_count} ranks")
        n = b // self.batch_count
        return self.batch_index * n, (self.batch_index + 1) * n


def row_sharding(mesh: Mesh, axis: str = "data",
                 batch_axis: Optional[str] = None) -> RowSharding:
    """NHWC activations with H (dim 1) split over ``axis``; on a 2-D data x
    spatial mesh pass ``batch_axis`` to split B (dim 0) as well."""
    kw = {}
    if batch_axis is not None:
        kw = dict(batch_group=mesh.group(batch_axis),
                  batch_index=mesh.index(batch_axis),
                  batch_count=mesh.shape[batch_axis])
    return RowSharding(mesh.group(axis), mesh.index(axis), mesh.shape[axis],
                       **kw)


def _p2p(x: torch.Tensor, group, recvs: Sequence[Tuple[int, tuple]],
         sends: Sequence[Tuple[int, torch.Tensor]],
         counter: Optional[str] = None) -> List[torch.Tensor]:
    """One batch of transfers in ``group``: receive a tensor of x's dtype
    and each ``(index, shape)`` of ``recvs``, send each ``(index,
    tensor)`` of ``sends``, adding the bytes sent to the module counter
    ``counter`` (if any). With a gloo group a CUDA tensor is staged
    through host memory. Returns the received in ``recvs``' order, on x's
    device."""
    if not (recvs or sends):
        return []
    staged = x.device.type != "cpu" and dist.get_backend(group) == "gloo"
    host = torch.device("cpu") if staged else x.device
    peer = lambda i: dist.get_global_rank(group, i)
    ops, got = [], []
    for i, shape in recvs:
        buf = torch.empty(shape, dtype=x.dtype, device=host)
        got.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, peer(i), group))
    for i, t in sends:
        if counter is not None:
            globals()[counter] += t.numel() * t.element_size()
        ops.append(dist.P2POp(dist.isend, t.contiguous().to(host), peer(i),
                              group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [t.to(x.device) for t in got]


def _rows(x: torch.Tensor, n: int) -> tuple:
    """The shape of ``n`` rows of x's layout."""
    return (x.shape[0], n) + tuple(x.shape[2:])


def _exchange(x: torch.Tensor, group, up: Optional[int], dn: Optional[int],
              recv_up: int, recv_dn: int, send_dn: int, send_up: int,
              counter: str = "halo_bytes"):
    """Receive ``recv_up`` rows from the rank ``up`` (its index in
    ``group``) and ``recv_dn`` from the rank ``dn``; send the bottom
    ``send_dn`` rows to ``dn`` and the top ``send_up`` rows to ``up``,
    adding the bytes sent to the module counter ``counter``. Returns the
    received (None where 0)."""
    recvs = [(i, _rows(x, n)) for i, n in ((up, recv_up), (dn, recv_dn))
             if n]
    sends = [(i, r) for i, r in (
        (dn, x[:, x.shape[1] - send_dn:] if send_dn else None),
        (up, x[:, :send_up] if send_up else None)) if r is not None]
    got = iter(_p2p(x, group, recvs, sends, counter))
    return (next(got) if recv_up else None, next(got) if recv_dn else None)


def _move(x: torch.Tensor, group, have: Sequence[int],
          want: Sequence[int]) -> torch.Tensor:
    """This rank's slab of the ``want`` partition, from its slab ``x`` of
    the ``have`` partition (boundaries in x's rows): each rank sends every
    other the rows of its slab that the other's wanted slab holds, and
    receives likewise, in one batch. Either slab may be empty."""
    i = group_rank(group)
    (a0, a1), (b0, b1) = have[i:i + 2], want[i:i + 2]
    recvs, sends, parts = [], [], []
    for j in range(len(have) - 1):
        lo, hi = max(b0, have[j]), min(b1, have[j + 1])
        if hi > lo:
            parts.append(x[:, lo - a0:hi - a0] if j == i else None)
            if j != i:
                recvs.append((j, _rows(x, hi - lo)))
        lo, hi = max(a0, want[j]), min(a1, want[j + 1])
        if hi > lo and j != i:
            sends.append((j, x[:, lo - a0:hi - a0]))
    got = iter(_p2p(x, group, recvs, sends, "move_bytes"))
    parts = [next(got) if t is None else t for t in parts]
    if not parts:
        return x.new_empty((x.shape[0], 0) + x.shape[2:])
    return torch.cat(parts, dim=1) if len(parts) > 1 else \
        parts[0].contiguous()


class RowShard:
    """The active row shard: the spatial ``group`` and every rank's slab
    boundaries ``bounds`` in the model input's rows (packed rows with
    packed io); this rank's slab is ``bounds[index]:bounds[index + 1]``.
    Only the ranks whose slab holds rows (``members``) run the layers: a
    halo comes from the nearest member above or below, and the frame's
    reductions go over the members."""

    def __init__(self, group, bounds: Sequence[int]):
        self.group = group
        self.index, self.count = group_rank(group), group_size(group)
        if len(bounds) != self.count + 1:
            raise ValueError(f"{len(bounds) - 1} slabs for {self.count} "
                             "ranks")
        self.bounds = list(bounds)
        self.members = [i for i in range(self.count)
                        if bounds[i + 1] > bounds[i]]
        if self.index not in self.members:
            raise ValueError(f"rank {self.index}'s slab holds no rows")
        at = self.members.index(self.index)
        self.up = self.members[at - 1] if at else None
        self.dn = (self.members[at + 1] if at + 1 < len(self.members)
                   else None)

    @property
    def local_rows(self) -> int:
        return self.bounds[self.index + 1] - self.bounds[self.index]

    @property
    def global_rows(self) -> int:
        return self.bounds[-1]

    @property
    def whole(self) -> bool:
        """Whether every rank of the group holds rows."""
        return len(self.members) == self.count

    def halo(self, x: torch.Tensor, up: int, down: int,
             zero_edges: bool = False) -> Tuple[torch.Tensor, int, int]:
        """(x with ``up`` rows of the slab above and ``down`` rows of the
        slab below, rows added above, rows added below). At the image's
        top and bottom edges nothing is added, or zero rows with
        ``zero_edges``; the neighbour's rows go by one batched send and
        receive each way."""
        has_up, has_dn = self.up is not None, self.dn is not None
        # a rank receives from both neighbours and sends to both, top and
        # bottom ranks included: their sends are what the others receive
        got_up, got_dn = _exchange(x, self.group, self.up, self.dn,
                                   up if has_up else 0,
                                   down if has_dn else 0,
                                   up if has_dn else 0,
                                   down if has_up else 0)
        if zero_edges:
            zeros = lambda n: x.new_zeros(_rows(x, n))
            got_up = zeros(up) if got_up is None and up else got_up
            got_dn = zeros(down) if got_dn is None and down else got_dn
        parts = [t for t in (got_up, x, got_dn) if t is not None]
        if len(parts) == 1:
            return x, 0, 0
        return (torch.cat(parts, dim=1),
                0 if got_up is None else got_up.shape[1],
                0 if got_dn is None else got_dn.shape[1])

    def reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``t`` summed (``op`` "sum") or maxed ("max") over the members,
        a new tensor: by one all-reduce where every rank is a member, else
        every member sends t to every other and combines them all in rank
        order, so each holds the same result."""
        out = t.detach().clone()
        if self.whole:
            (all_reduce_sum_ if op == "sum" else all_reduce_max_)(
                [out], self.group)
            return out
        others = [j for j in self.members if j != self.index]
        got = iter(_p2p(out, self.group, [(j, out.shape) for j in others],
                        [(j, out) for j in others]))
        parts = [out if j == self.index else next(got)
                 for j in self.members]
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p if op == "sum" else torch.maximum(acc, p)
        return acc


_active: Optional[RowShard] = None
_batch_group = None


def current() -> Optional[RowShard]:
    """The active row shard, or None."""
    return _active


@contextlib.contextmanager
def row_shard(group, bounds: Sequence[int]):
    """Run the layers on a row slab of a frame (:class:`RowShard`)."""
    global _active
    if _active is not None:
        raise RuntimeError("row_shard contexts do not nest")
    _active = RowShard(group, bounds)
    try:
        yield _active
    finally:
        _active = None


@contextlib.contextmanager
def batch_shard(group):
    """Tensors in the body are this rank's shard of a batch split over
    ``group`` (None: not split): :func:`frame_max` reduces over it."""
    global _batch_group
    if _batch_group is not None and group is not None:
        raise RuntimeError("batch_shard contexts do not nest")
    prev, _batch_group = _batch_group, group
    try:
        yield
    finally:
        _batch_group = prev


def halo(x: torch.Tensor, up: int, down: int, zero_edges: bool = False
         ) -> Tuple[torch.Tensor, int, int]:
    """:meth:`RowShard.halo` under the active row shard; without one
    ``(x, 0, 0)``."""
    if _active is None:
        return x, 0, 0
    return _active.halo(x, up, down, zero_edges)


def crop(y: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """``y`` without the rows a :func:`halo` added (``y`` itself when it
    added none)."""
    if not (up or down):
        return y
    return y[:, up:y.shape[1] - down].contiguous()


def frame_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the active row shard's slabs (a new tensor);
    without one ``t``."""
    if _active is None:
        return t
    return _active.reduce(t, "sum")


def frame_groups() -> List[object]:
    """The groups a tensor of the body is spread over: the active row
    shard's and the :func:`batch_shard` group, where active. A row shard
    whose slabs leave a rank without rows has no such group (its
    reductions go by :meth:`RowShard.reduce`): it raises."""
    if _active is not None and not _active.whole:
        raise RuntimeError("a row shard with empty slabs reduces over its "
                           "members, not a group")
    return [g for g in (None if _active is None else _active.group,
                        _batch_group) if g is not None]


def frame_max(t: torch.Tensor) -> torch.Tensor:
    """``t`` (a tensor of local maxima) maxed over :func:`frame_groups`
    (a new tensor); ``t`` itself over none."""
    if _active is None and _batch_group is None:
        return t
    out = t.detach().clone()
    if _active is not None:
        out = _active.reduce(out, "max")
    all_reduce_max_([out], _batch_group)
    return out


def frame_rows(h: int) -> int:
    """The frame's rows at a scale where the slab has ``h``: ``h`` without
    a row shard."""
    if _active is None:
        return h
    rows = _active.global_rows * h
    if rows % _active.local_rows:
        raise ValueError(f"a slab of {h} rows is not a whole scale of the "
                         f"input's {_active.local_rows}")
    return rows // _active.local_rows


def _scaled(bounds: Sequence[int], rows: int, base: int) -> List[int]:
    """``bounds`` of ``base`` rows at a scale of ``rows`` rows."""
    out = [b * rows for b in bounds]
    if any(b % base for b in out):
        raise ValueError(f"row shard: boundaries {list(bounds)} of {base} "
                         f"rows are not whole rows at {rows}")
    return [b // base for b in out]


def _from_holder(dpb, bpp, group, src: int, like: torch.Tensor):
    """The new DPB's slabs and the bpp on every rank of ``group`` from the
    forward's on the ranks that held rows: a rank that held none gets
    empty slabs of the DPB's layout and ``src``'s bpp (the same on every
    rank that held rows), both by broadcast from group rank ``src``;
    ``like`` gives the device."""
    meta = [None if dpb is None else (
        {k: ((v.shape[0], 0) + tuple(v.shape[2:]), v.dtype)
         for k, v in dpb.items()}, (tuple(bpp.shape), bpp.dtype))]
    root = dist.get_global_rank(group, src)
    dist.broadcast_object_list(meta, src=root, group=group)
    layout, (shape, dtype) = meta[0]
    if dpb is None:
        dpb = {k: torch.empty(s, dtype=d, device=like.device)
               for k, (s, d) in layout.items()}
        bpp = torch.empty(shape, dtype=dtype, device=like.device)
    staged = bpp.device.type != "cpu" and dist.get_backend(group) == "gloo"
    buf = bpp.detach().cpu() if staged else bpp.detach().clone()
    dist.broadcast(buf, root, group=group)
    return dpb, buf.to(like.device)


def spatial_pframe(model, mesh: Mesh, axis: str = "data",
                   batch_axis: Optional[str] = None):
    """The P-frame forward with row-sharded activations: the JAX package's
    ``jit_spatial_pframe``.

    Returns ``fn(params, frame, mask, qp, dpb) -> (new_dpb, bpp)``: frame,
    mask and the DPB's entries are this rank's even row slabs
    (:func:`shard_rows`) in the model's input domain (packed rows with
    packed io), ``params`` a state_dict (``torch.func.functional_call``) or
    None for the model's own, ``after_i=False`` and ``train=False`` as
    there. The layers run on units (:func:`unit_bounds`) on the ranks
    whose unit slab holds rows (every rank unless units are fewer than
    ranks); the new DPB comes back in the even partition. bpp is per
    sample of the rank's batch shard and the same on every rank of the
    spatial group. On a 2-D mesh pass ``axis="spatial",
    batch_axis="data"``."""
    sh = row_sharding(mesh, axis, batch_axis)
    packed = getattr(model.cfg, "packed_io", False)
    scale = model.cfg.patch_size if packed else 1
    def fn(params, frame, mask, qp, dpb):
        rows = frame.shape[1] * sh.count
        even = sh.bounds(rows)
        units = sh.bounds(rows, SLAB_ROWS // scale)
        # each DPB entry's rows in the whole frame, at its own scale
        full = {k: v.shape[1] * sh.count for k, v in dpb.items()}

        def move(t, t_rows, have, want):
            """t, this rank's slab of the ``have`` partition (of ``rows``
            input rows) at a scale of ``t_rows`` rows, as its slab of
            ``want``."""
            if sh.group is None:
                return t
            return _move(t, sh.group, _scaled(have, t_rows, rows),
                         _scaled(want, t_rows, rows))

        x, m = (move(t, rows, even, units) for t in (frame, mask))
        dpb = {k: move(v, full[k], even, units) for k, v in dpb.items()}
        holds = [i for i in range(sh.count) if units[i + 1] > units[i]]
        new = bpp = None
        if sh.index in holds:
            kw = dict(after_i=False, mask=m, train=False)
            with torch.no_grad(), row_shard(sh.group, units), \
                    batch_shard(sh.batch_group):
                if params is None:
                    out = model(x, qp, dpb, **kw)
                else:
                    out = torch.func.functional_call(model, params,
                                                     (x, qp, dpb), kw)
            new, bpp = out["dpb"], out["bpp"]
        if len(holds) < sh.count:
            new, bpp = _from_holder(new, bpp, sh.group, holds[0], frame)
        return ({k: move(v, full[k], units, even) for k, v in new.items()},
                bpp)

    return fn


def shard_rows(mesh: Mesh, tree, axis: str = "data",
               batch_axis: Optional[str] = None):
    """This rank's even row slab (and batch shard) of every full NHWC
    tensor in ``tree``, on the mesh's device."""
    sh = row_sharding(mesh, axis, batch_axis)

    def take(x):
        x = torch.as_tensor(x)
        r0, r1 = sh.rows(x.shape[1])
        b0, b1 = sh.batch(x.shape[0])
        return x[b0:b1, r0:r1].contiguous().to(mesh.device)

    return _tree_map(take, tree)


def gather_rows(mesh: Mesh, tree, axis: str = "data",
                batch_axis: Optional[str] = None):
    """The inverse of :func:`shard_rows`: every rank's even slabs (and
    batch shards) of each tensor in ``tree`` put back together, on every
    rank."""
    sh = row_sharding(mesh, axis, batch_axis)

    def join(x):
        x = all_gather_cat(x, sh.group, dim=1)
        return all_gather_cat(x, sh.batch_group, dim=0)

    return _tree_map(join, tree)
