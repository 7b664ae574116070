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
z (1/64) holds whole rows on every rank, a slab starts on an even row at
every stride-2 conv and at y's scale (1/16), where the checkerboard prior's
parity is therefore the slab's own, and ``pad_for_y`` never pads rows.
:func:`spatial_pframe` moves rows between neighbours once on entry, from
the even partition to whole units (:func:`unit_bounds`: each boundary at
the unit nearest the even one, so a rank holds the floor or the ceiling of
units / ranks), and the new DPB back on exit: 1088 rows over 8 ranks, 136
each, run on slabs of 128 rows and one of 192 (rank 3). An H that is not a
multiple of 64 pixel rows, or fewer units than ranks, raises.

Halo and boundary rows go by ``torch.distributed.batch_isend_irecv`` with
the up and down neighbours in the group; with a gloo group a CUDA tensor's
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
    count (a half rounds up): a slab holds the floor or the ceiling of
    units / count. Raises unless ``rows`` is a multiple of ``unit`` with at
    least one unit a rank."""
    if rows % unit:
        raise ValueError(
            f"row shard: {rows} rows are not whole units of {unit} rows "
            f"({SLAB_ROWS} pixel rows, so that every scale down to z "
            "(1/64) holds whole rows): H must be a multiple of "
            f"{SLAB_ROWS} pixel rows")
    units = rows // unit
    if units < count:
        raise ValueError(
            f"row shard: {units} units of {SLAB_ROWS} pixel rows over "
            f"{count} ranks; each rank needs at least one")
    return [unit * ((2 * r * units + count) // (2 * count))
            for r in range(count + 1)]


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


def _exchange(x: torch.Tensor, group, index: int, recv_up: int,
              recv_dn: int, send_dn: int, send_up: int,
              counter: str = "halo_bytes"):
    """Receive ``recv_up`` rows from the rank above (``index`` - 1 in
    ``group``) and ``recv_dn`` from the rank below; send the bottom
    ``send_dn`` rows down and the top ``send_up`` rows up, adding the bytes
    sent to the module counter ``counter``. Returns the received (None
    where 0)."""
    if not (recv_up or recv_dn or send_dn or send_up):
        return None, None
    staged = x.device.type != "cpu" and dist.get_backend(group) == "gloo"
    host = torch.device("cpu") if staged else x.device
    peer = lambda i: dist.get_global_rank(group, i)
    ops, got = [], {}
    for name, n, src in (("up", recv_up, index - 1),
                         ("dn", recv_dn, index + 1)):
        if n:
            buf = torch.empty((x.shape[0], n) + x.shape[2:], dtype=x.dtype,
                              device=host)
            got[name] = buf
            ops.append(dist.P2POp(dist.irecv, buf, peer(src), group))
    for rows, dst in ((x[:, x.shape[1] - send_dn:] if send_dn else None,
                       index + 1),
                      (x[:, :send_up] if send_up else None, index - 1)):
        if rows is not None:
            globals()[counter] += rows.numel() * rows.element_size()
            ops.append(dist.P2POp(dist.isend, rows.contiguous().to(host),
                                  peer(dst), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    back = lambda k: got[k].to(x.device) if k in got else None
    return back("up"), back("dn")


def _move(x: torch.Tensor, group, have: Sequence[int],
          want: Sequence[int]) -> torch.Tensor:
    """This rank's slab of the ``want`` partition, from its slab ``x`` of
    the ``have`` partition (boundaries in x's rows): the rows between the
    two boundaries go to or come from the neighbour. Each boundary moves by
    less than a neighbour's slab, so nothing crosses two ranks."""
    i = group_rank(group)
    (a0, a1), (b0, b1) = have[i:i + 2], want[i:i + 2]
    if (i > 0 and b0 < have[i - 1]) or (i + 2 < len(have)
                                        and b1 > have[i + 2]):
        raise ValueError(f"row shard: slab [{b0}, {b1}) reaches past the "
                         f"neighbours of [{a0}, {a1})")
    up_cut, dn_cut = max(0, b0 - a0), max(0, a1 - b1)
    got_up, got_dn = _exchange(x, group, i, max(0, a0 - b0),
                               max(0, b1 - a1), dn_cut, up_cut,
                               "move_bytes")
    keep = x[:, up_cut:x.shape[1] - dn_cut]
    parts = [t for t in (got_up, keep, got_dn) if t is not None]
    return torch.cat(parts, dim=1) if len(parts) > 1 else keep.contiguous()


class RowShard:
    """The active row shard: the spatial ``group`` and every rank's slab
    boundaries ``bounds`` in the model input's rows (packed rows with
    packed io); this rank's slab is ``bounds[index]:bounds[index + 1]``."""

    def __init__(self, group, bounds: Sequence[int]):
        self.group = group
        self.index, self.count = group_rank(group), group_size(group)
        if len(bounds) != self.count + 1:
            raise ValueError(f"{len(bounds) - 1} slabs for {self.count} "
                             "ranks")
        self.bounds = list(bounds)

    @property
    def local_rows(self) -> int:
        return self.bounds[self.index + 1] - self.bounds[self.index]

    @property
    def global_rows(self) -> int:
        return self.bounds[-1]

    def halo(self, x: torch.Tensor, up: int, down: int,
             zero_edges: bool = False) -> Tuple[torch.Tensor, int, int]:
        """(x with ``up`` rows of the slab above and ``down`` rows of the
        slab below, rows added above, rows added below). At the image's
        top and bottom edges nothing is added, or zero rows with
        ``zero_edges``; the neighbour's rows go by one batched send and
        receive each way."""
        has_up, has_dn = self.index > 0, self.index < self.count - 1
        # a rank receives from both neighbours and sends to both, top and
        # bottom ranks included: their sends are what the others receive
        got_up, got_dn = _exchange(x, self.group, self.index,
                                   up if has_up else 0,
                                   down if has_dn else 0,
                                   up if has_dn else 0,
                                   down if has_up else 0)
        if zero_edges:
            zeros = lambda n: x.new_zeros((x.shape[0], n) + x.shape[2:])
            got_up = zeros(up) if got_up is None and up else got_up
            got_dn = zeros(down) if got_dn is None and down else got_dn
        parts = [t for t in (got_up, x, got_dn) if t is not None]
        if len(parts) == 1:
            return x, 0, 0
        return (torch.cat(parts, dim=1),
                0 if got_up is None else got_up.shape[1],
                0 if got_dn is None else got_dn.shape[1])


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
    out = t.clone()
    all_reduce_sum_([out], _active.group)
    return out


def frame_groups() -> List[object]:
    """The groups a tensor of the body is spread over: the active row
    shard's and the :func:`batch_shard` group, where active."""
    return [g for g in (None if _active is None else _active.group,
                        _batch_group) if g is not None]


def frame_max(t: torch.Tensor) -> torch.Tensor:
    """``t`` (a tensor of local maxima) maxed over :func:`frame_groups`
    (a new tensor); ``t`` itself over none."""
    groups = frame_groups()
    if not groups:
        return t
    out = t.detach().clone()
    for g in groups:
        all_reduce_max_([out], g)
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


def spatial_pframe(model, mesh: Mesh, axis: str = "data",
                   batch_axis: Optional[str] = None):
    """The P-frame forward with row-sharded activations: the JAX package's
    ``jit_spatial_pframe``.

    Returns ``fn(params, frame, mask, qp, dpb) -> (new_dpb, bpp)``: frame,
    mask and the DPB's entries are this rank's even row slabs
    (:func:`shard_rows`) in the model's input domain (packed rows with
    packed io), ``params`` a state_dict (``torch.func.functional_call``) or
    None for the model's own, ``after_i=False`` and ``train=False`` as
    there. The layers run on whole units (:func:`unit_bounds`); the new DPB
    comes back in the even partition. bpp is per sample of the rank's batch
    shard and the same on every rank of the spatial group. On a 2-D mesh
    pass ``axis="spatial", batch_axis="data"``."""
    sh = row_sharding(mesh, axis, batch_axis)
    packed = getattr(model.cfg, "packed_io", False)
    scale = model.cfg.patch_size if packed else 1

    def fn(params, frame, mask, qp, dpb):
        rows = frame.shape[1] * sh.count
        even = sh.bounds(rows)
        units = sh.bounds(rows, SLAB_ROWS // scale)

        def move(t, have, want):
            """t, this rank's slab of the ``have`` partition (of ``rows``
            input rows) at its own scale, as its slab of ``want``."""
            if sh.group is None:
                return t
            # t's rows in the whole frame
            total = _scaled([rows], t.shape[1],
                            have[sh.index + 1] - have[sh.index])[0]
            return _move(t, sh.group, _scaled(have, total, rows),
                         _scaled(want, total, rows))

        frame, mask = (move(t, even, units) for t in (frame, mask))
        dpb = {k: move(v, even, units) for k, v in dpb.items()}
        kw = dict(after_i=False, mask=mask, train=False)
        with torch.no_grad(), row_shard(sh.group, units), \
                batch_shard(sh.batch_group):
            if params is None:
                out = model(frame, qp, dpb, **kw)
            else:
                out = torch.func.functional_call(model, params,
                                                 (frame, qp, dpb), kw)
        return ({k: move(v, units, even) for k, v in out["dpb"].items()},
                out["bpp"])

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
