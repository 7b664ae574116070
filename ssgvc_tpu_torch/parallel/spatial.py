"""Row (H) sharding of one stream's P-frame over ranks: the JAX package's
``parallel/spatial.py`` (``jit_spatial_pframe``) without an SPMD
partitioner.

The data mesh (``parallel/mesh.py``) scales throughput: independent streams
per rank. This module scales latency for one stream: the frame's rows are
split over the ranks of a group, every op runs on the rank's slab, and only
halo rows and the bits' sum cross between ranks. Under JAX, XLA's
partitioner inserts those exchanges. Here the layers do it themselves: while
a :func:`row_shard` context is active, an op with vertical reach k takes k
rows from each neighbour slab, runs on the taller slab and crops its output
by k. At the true image edge there is no neighbour and the op's own zero
padding stands, so the result is the unsharded one: every other op is per
pixel. The ops with reach:

  * ``layers/blocks.Conv`` with a kernel > 1 (the 3x3 stride-2 convs of
    ``Encoder.down`` / ``SFT.down``, which need only the row above a slab,
    the 3x3 conv of ``Decoder.up``, ``MaskFiLM.net_0``); the 2x2 stride-2
    convs of the hyper encoder have no reach on slabs of even rows;
  * ``layers/blocks.DepthConvBlock``: the dw3x3 inside the ``dcb`` kernel,
    one row each side;
  * ``layers/blocks.run_chain``: N rows each side for a chain of N blocks.

The layers consult the context through :func:`halo` and :func:`crop`,
which do nothing without one: with no context the layers run exactly as
they do unsharded, the same launches and the same outputs.

Global quantities: the bits' sum of ``models/common.bpp_from_bits`` is the
frame's (:func:`frame_sum`) and ``DMC.forward`` divides by the frame's
pixels (:func:`frame_rows`). ``mask_prop``'s predictor resizes the mask
with antialiasing, whose reach is not a row or two: under a row shard that
variant raises.

Slab rule: a rank holds a multiple of :data:`SLAB_ROWS` pixel rows (8 packed
rows with packed io). Every scale down to z (1/64) then holds whole rows on
every rank, a slab starts on an even row at every stride-2 conv and at y's
scale (1/16), where the checkerboard prior's parity is therefore the
slab's own, and ``pad_for_y`` never pads rows. Any other height raises.

Halo rows go by ``torch.distributed.batch_isend_irecv`` with the up and down
neighbours in the group; with a gloo group a CUDA tensor's rows are staged
through host memory (gloo sends CPU tensors only), with NCCL they move
device to device. Nothing all-gathers an activation: a rank's activation
memory is its slab's plus the halos.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import (Mesh, _tree_map, all_gather_cat, all_reduce_sum_,
                   group_rank, group_size)

__all__ = ["SLAB_ROWS", "RowSharding", "row_sharding", "RowShard",
           "row_shard", "current", "halo", "crop", "frame_sum", "frame_rows",
           "spatial_pframe", "shard_rows", "gather_rows"]

#: pixel rows of a rank's slab must be a multiple of this (z is 1/64)
SLAB_ROWS = 64
#: bytes of halo rows this process has sent (a counter, as the kernels'
#: launch counts)
halo_bytes = 0


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

    def rows(self, h: int) -> Tuple[int, int]:
        """This rank's [start, stop) of ``h`` rows."""
        if h % self.count:
            raise ValueError(f"{h} rows do not split evenly over "
                             f"{self.count} ranks")
        n = h // self.count
        return self.index * n, (self.index + 1) * n

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


class RowShard:
    """The active row shard: the spatial ``group``, and in the model
    input's rows (packed rows with packed io) this slab's ``local_rows``
    and the frame's ``global_rows``."""

    def __init__(self, group, global_rows: int, local_rows: int):
        self.group = group
        self.index, self.count = group_rank(group), group_size(group)
        self.global_rows, self.local_rows = global_rows, local_rows

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
        got_up, got_dn = self._exchange(x, up if has_up else 0,
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

    def _exchange(self, x, recv_up: int, recv_dn: int, send_dn: int,
                  send_up: int):
        """Receive ``recv_up`` rows from the rank above and ``recv_dn`` from
        the rank below; send the bottom ``send_dn`` rows down and the top
        ``send_up`` rows up. Returns the received (None where 0)."""
        group = self.group
        if not (recv_up or recv_dn or send_dn or send_up):
            return None, None
        staged = x.device.type != "cpu" and dist.get_backend(group) == "gloo"
        host = torch.device("cpu") if staged else x.device
        peer = lambda i: dist.get_global_rank(group, i)
        ops, got = [], {}
        for name, n, src in (("up", recv_up, self.index - 1),
                             ("dn", recv_dn, self.index + 1)):
            if n:
                buf = torch.empty((x.shape[0], n) + x.shape[2:],
                                  dtype=x.dtype, device=host)
                got[name] = buf
                ops.append(dist.P2POp(dist.irecv, buf, peer(src), group))
        for rows, dst in ((x[:, x.shape[1] - send_dn:] if send_dn else None,
                           self.index + 1),
                          (x[:, :send_up] if send_up else None,
                           self.index - 1)):
            if rows is not None:
                global halo_bytes
                halo_bytes += rows.numel() * rows.element_size()
                ops.append(dist.P2POp(dist.isend,
                                      rows.contiguous().to(host), peer(dst),
                                      group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        back = lambda k: got[k].to(x.device) if k in got else None
        return back("up"), back("dn")


_active: Optional[RowShard] = None


def current() -> Optional[RowShard]:
    """The active row shard, or None."""
    return _active


@contextlib.contextmanager
def row_shard(group, global_rows: int, local_rows: int):
    """Run the layers on a row slab of a frame (:class:`RowShard`)."""
    global _active
    if _active is not None:
        raise RuntimeError("row_shard contexts do not nest")
    _active = RowShard(group, global_rows, local_rows)
    try:
        yield _active
    finally:
        _active = None


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


def spatial_pframe(model, mesh: Mesh, axis: str = "data",
                   batch_axis: Optional[str] = None):
    """The P-frame forward with row-sharded activations: the JAX package's
    ``jit_spatial_pframe``.

    Returns ``fn(params, frame, mask, qp, dpb) -> (new_dpb, bpp)``: frame,
    mask and the DPB's entries are this rank's row slabs (:func:`shard_rows`)
    in the model's input domain (packed rows with packed io), ``params`` a
    state_dict (``torch.func.functional_call``) or None for the model's own,
    ``after_i=False`` and ``train=False`` as there. The new DPB stays
    row-sharded; bpp is per sample of the rank's batch shard and the same on
    every rank of the spatial group. On a 2-D mesh pass ``axis="spatial",
    batch_axis="data"``. Slabs follow the slab rule (:data:`SLAB_ROWS`)."""
    sh = row_sharding(mesh, axis, batch_axis)
    packed = getattr(model.cfg, "packed_io", False)
    scale = model.cfg.patch_size if packed else 1

    def fn(params, frame, mask, qp, dpb):
        local = frame.shape[1]
        if (local * scale) % SLAB_ROWS:
            raise ValueError(
                f"spatial_pframe: a slab of {local * scale} pixel rows; the "
                f"slab rule wants a multiple of {SLAB_ROWS} pixel rows a "
                f"rank ({SLAB_ROWS // scale} input rows), so every scale "
                "down to z (1/64) holds whole rows")
        kw = dict(after_i=False, mask=mask, train=False)
        with torch.no_grad(), row_shard(sh.group, local * sh.count, local):
            if params is None:
                out = model(frame, qp, dpb, **kw)
            else:
                out = torch.func.functional_call(model, params,
                                                 (frame, qp, dpb), kw)
        return out["dpb"], out["bpp"]

    return fn


def shard_rows(mesh: Mesh, tree, axis: str = "data",
               batch_axis: Optional[str] = None):
    """This rank's row slab (and batch shard) of every full NHWC tensor in
    ``tree``, on the mesh's device."""
    sh = row_sharding(mesh, axis, batch_axis)

    def take(x):
        x = torch.as_tensor(x)
        r0, r1 = sh.rows(x.shape[1])
        b0, b1 = sh.batch(x.shape[0])
        return x[b0:b1, r0:r1].contiguous().to(mesh.device)

    return _tree_map(take, tree)


def gather_rows(mesh: Mesh, tree, axis: str = "data",
                batch_axis: Optional[str] = None):
    """The inverse of :func:`shard_rows`: every rank's slabs (and batch
    shards) of each tensor in ``tree`` put back together, on every rank."""
    sh = row_sharding(mesh, axis, batch_axis)

    def join(x):
        x = all_gather_cat(x, sh.group, dim=1)
        return all_gather_cat(x, sh.batch_group, dim=0)

    return _tree_map(join, tree)
